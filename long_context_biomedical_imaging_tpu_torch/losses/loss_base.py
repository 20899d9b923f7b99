"""Loss registry (ref: loss/loss_base.py:15-32).

Counterpart of the JAX package's ``losses/loss_base.py``. Cross-entropy is
``F.cross_entropy`` on fp32 logits; MSE and the combined enhancement loss are
``losses/enhancement_losses.py``'s. Every loss takes ``reduction``: "mean"
over the batch, or "none", one value per sample or position.

Loss functions take channels-last model outputs and targets:
  * class:   outputs (B, num_classes) logits, targets (B,) int labels
  * seg:     outputs (B, T, H, W, C) logits, targets (B, T, H, W) int masks
  * enhance: outputs/targets (B, T, H, W, C) float images
"""

from __future__ import annotations

import torch.nn.functional as F

from .enhancement_losses import combined_enhance_loss, mse_loss


def cross_entropy_loss(outputs, targets, reduction: str = "mean"):
    """torch nn.CrossEntropyLoss on channels-last logits: outputs (B, C) or
    (B, ..., C), targets (B,) or (B, ...) class indices."""
    logits = outputs.float()
    if logits.ndim > 2:
        logits = logits.reshape(-1, logits.shape[-1])
        targets = targets.reshape(-1)
    return F.cross_entropy(logits, targets.long(), reduction=reduction)


def get_loss_func(name: str):
    """'CrossEntropy' | 'MSE' | 'CombinationEnhance' (ref: loss_base.py:15-32)."""
    if name == "CrossEntropy":
        return cross_entropy_loss
    if name == "MSE":
        return mse_loss
    if name == "CombinationEnhance":
        return combined_enhance_loss
    raise NotImplementedError(f"Unknown loss function: {name}")
