"""Classification heads (ref: model/models/class_heads.py:13-79).

Counterpart of the JAX package's ``models/class_heads.py``: both heads take
the backbone's hidden-state list and return (B, num_classes).
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import TorchDense


class ViTLinear(nn.Module):
    """The cls row (attention) or the token mean (Hyena, Mamba: no cls
    token) of the last hidden state -> Linear -> Tanh. The mean sums in
    fp32 and returns the stream dtype, as jnp.mean does for bf16."""

    def __init__(self, in_features: int, num_classes: int, use_cls_token: bool = True):
        super().__init__()
        self.use_cls_token = use_cls_token
        self.classification_head = TorchDense(in_features, num_classes)

    def forward(self, hidden_states):
        x = hidden_states[-1]                          # (B, L, C)
        x = x[:, 0] if self.use_cls_token else x.float().mean(dim=1).to(x.dtype)
        return torch.tanh(self.classification_head(x))


class SwinLinear(nn.Module):
    """Mean-pool over (D, H, W) -> Linear -> Tanh. The pool sums in fp32 and
    returns the stream dtype, as jnp.mean does for bf16."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.classification_head = TorchDense(in_features, num_classes)

    def forward(self, hidden_states):
        x = hidden_states[-1]                          # (B, D, H, W, C)
        x = x.float().mean(dim=(1, 2, 3)).to(x.dtype)
        return torch.tanh(self.classification_head(x))
