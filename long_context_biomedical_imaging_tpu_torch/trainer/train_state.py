"""Train and evaluation steps (ref: trainer/trainer_base.py:154-189).

Counterpart of ``make_train_step`` and ``make_eval_step`` in the JAX
package's ``trainer/train_state.py``. Under AMP the casts mirror the JAX step
exactly, rather than torch.autocast's per-op policy: every fp32 parameter is
cast to bf16 by a differentiable cast inside the step (:func:`amp_params`;
the fp32 parameters are the master weights), the image stays fp32 until the
backbone casts it after patch extraction, the fused kernels take LN
parameters and biases in fp32, and the output is cast to fp32 before the
loss. bf16 keeps fp32's exponent range, so there is no loss scaler.

BatchNorm layers (the UperNet head) follow the model's mode, as the JAX step
passes ``use_running_average``: the train step runs the model in ``train()``
mode, where they normalise with batch statistics and update their running
statistics in place, and the trainer evaluates in ``eval()`` mode, on the
running statistics. The running statistics are buffers, never cast by
:func:`amp_params`, so they stay fp32 as the JAX package's ``batch_stats``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import functional_call

from ..optim.optim_base import global_norm


def amp_params(model: torch.nn.Module, use_amp: bool) -> dict:
    """The parameters the forward runs with: bf16 copies of every fp32
    parameter under AMP, the parameters themselves otherwise. The cast is
    differentiable, so a train step's gradients reach the fp32 master
    weights, as the JAX step casts inside the differentiated function; the
    eval path calls this under ``torch.no_grad``."""
    params = dict(model.named_parameters())
    if not use_amp:
        return params
    return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            for k, v in params.items()}


def valid_mask(b: int, n_valid, device) -> torch.Tensor:
    """(B,) float mask of the first n_valid rows (the loader pads the tail)."""
    if n_valid is None:
        return torch.ones(b, device=device)
    return (torch.arange(b, device=device) < n_valid).float()


def make_train_step(model: torch.nn.Module, loss_func: Callable, optim_manager,
                    use_amp: bool = False, metrics_fn: Callable | None = None,
                    grad_div: int = 1):
    """train_step(micros, lr, n_valid) -> stats, one optimizer step.

    ``micros`` is a list of (images, labels) microbatches on the device: the
    accumulation group, whose gradients are summed and divided by
    ``grad_div``, the full --iters_to_accumulate even for an epoch's shorter
    tail group (the reference scales every micro-loss by 1/accum). Each
    micro-loss is the loss over its whole batch, as the JAX step computes it;
    ``n_valid`` (the group's real rows, counted from the front) masks only
    the metrics. Gradients are fp32 (the master weights'), then clipped, then
    the optimizer steps with learning rate ``lr``.

    Returns the stats vector [loss (mean over the group), *train metrics,
    global gradient norm before clipping] as fp32 on the device: nothing here
    waits for the device."""

    def train_step(micros, lr: float, n_valid=None):
        optimizer = optim_manager.optimizer
        optimizer.zero_grad(set_to_none=True)
        loss_sum, outputs = 0.0, []
        for images, labels in micros:
            out32 = functional_call(model, amp_params(model, use_amp), (images,)).float()
            loss = loss_func(out32, labels)
            (loss / grad_div).backward()
            loss_sum = loss_sum + loss.detach()
            outputs.append(out32.detach())
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        grad_norm = global_norm(grads)
        optim_manager.step(lr)
        stats = [torch.reshape(loss_sum / len(micros), (1,))]
        if metrics_fn is not None:
            output = torch.cat(outputs)
            labels = torch.cat([lb for _, lb in micros])
            stats.append(metrics_fn(output, labels, valid_mask(output.shape[0], n_valid,
                                                                output.device)))
        stats.append(grad_norm.reshape(1))
        return torch.cat([s.float() for s in stats])

    return train_step


def make_eval_step(model: torch.nn.Module, loss_func: Callable):
    """eval_step(params, images, labels, n_valid) -> (loss, fp32 output).

    ``params`` comes from :func:`amp_params`. The loss averages per-sample
    losses over the valid rows, so padding never distorts it; a sample's
    loss is the mean over its whole target (every pixel of a segmentation
    mask; an enhancement loss over that sample alone, its non-finite terms
    zeroed per sample), as the JAX step maps the loss over the samples."""

    @torch.no_grad()
    def eval_step(params, images, labels, n_valid=None):
        out32 = functional_call(model, params, (images,)).float()
        per_sample = loss_func(out32, labels, reduction="none").reshape(
            out32.shape[0], -1).mean(dim=1)
        w = valid_mask(out32.shape[0], n_valid, out32.device)
        loss = (per_sample * w).sum() / w.sum().clamp_min(1.0)
        return loss, out32

    return eval_step
