"""Enhancement losses (ref: loss/loss_functions/enhancement_losses.py:18-278).

Counterpart of the JAX package's ``losses/enhancement_losses.py``. Every
loss takes channels-last outputs and float targets of the same shape (B, T,
H, W, C) and computes in fp32. ``reduction="mean"`` gives the loss over the
whole batch, as the JAX package's; ``reduction="none"`` gives each sample's
loss over that sample alone, (B,), what the JAX eval step gets by mapping the
loss over the samples.

``combined_enhance_loss`` zeroes a term that is not finite (the reference's
Combined_Loss skips NaN terms, ref: :275-276); the trainer's stats fetch
raises on a non-finite total.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _reduce(x, batch: int, reduction: str):
    """The mean of x over everything, or per sample over its own elements."""
    if reduction == "mean":
        return x.mean()
    if reduction == "none":
        return x.reshape(batch, -1).mean(dim=1)
    raise ValueError(f"unknown reduction {reduction}")


def mse_loss(outputs, targets, complex_i: bool = False, reduction: str = "mean"):
    """Mean squared error; complex mode pairs channels 0/1 (ref: :18-58)."""
    o, t = outputs.float(), targets.float()
    if complex_i:
        d = (o[..., 0] - t[..., 0]).square() + (o[..., 1] - t[..., 1]).square()
    else:
        d = (o - t).square()
    return _reduce(d, o.shape[0], reduction)


def charbonnier_loss(outputs, targets, complex_i: bool = False, eps: float = 1e-3,
                     reduction: str = "mean"):
    """Charbonnier (smooth L1) loss (ref: :63-101)."""
    o, t = outputs.float(), targets.float()
    if complex_i:
        dr = (o[..., 0] - t[..., 0]).abs()
        di = (o[..., 1] - t[..., 1]).abs()
        loss = torch.sqrt(dr * dr + di * di + eps * eps)
    else:
        d = (o - t).abs()
        loss = torch.sqrt(d * d + eps * eps)
    return _reduce(loss, o.shape[0], reduction)


def _gaussian_and_derivatives_1d(sigma: float, halfwidth: float = 3.0,
                                 voxelsize: float = 1.0):
    """Sampled gaussian and its |.|-normalised first derivative (ref:
    :106-146), as the JAX package computes them (numpy, fp32)."""
    n = round(halfwidth * sigma / voxelsize)
    pts = (np.arange(2 * n + 1) - n) * voxelsize
    norm = 1.0 / math.sqrt(2 * math.pi * sigma * sigma)
    t = np.exp(-(pts * pts) / (2 * sigma * sigma))
    g = norm * t
    g = g / g.sum()
    d = norm * (-pts / (sigma * sigma)) * t
    d = d / np.abs(d).sum()
    return g.astype(np.float32), d.astype(np.float32)


def _sep_conv_axis(x, k1d, dim: int):
    """'same'-padded 1D correlation along ``dim`` as K shift-and-multiply-add
    passes: zero padding ((K-1)//2, K//2), no flip, taps in order, as the
    JAX package's ``_sep_conv_axis``."""
    k = k1d.shape[0]
    lo, hi = (k - 1) // 2, k // 2
    pad = [0, 0] * x.dim()
    pad[2 * (x.dim() - 1 - dim)] = lo
    pad[2 * (x.dim() - 1 - dim) + 1] = hi
    xp = F.pad(x, pad)
    length = x.shape[dim]
    y = xp.narrow(dim, 0, length) * float(k1d[0])
    for j in range(1, k):
        y = y + xp.narrow(dim, j, length) * float(k1d[j])
    return y


def gaussian_deriv3d_loss(outputs, targets, complex_i: bool = False,
                          sigmas=(0.25, 0.5, 1.0), sigmas_t=(0.25, 0.5, 0.5),
                          reduction: str = "mean"):
    """L1 agreement of 3D gaussian-derivative responses at several scales
    (ref: :204-228), on (B * C, T, H, W). The reference's dense 3D kernel is
    an outer product of three |.|-normalised 1D derivative kernels, so it
    factors exactly into three separable 1D passes, along T, H and W."""
    o, t = outputs.float(), targets.float()
    if complex_i:
        o = torch.sqrt(o[..., :1] ** 2 + o[..., 1:] ** 2)
        t = torch.sqrt(t[..., :1] ** 2 + t[..., 1:] ** 2)
    b, tt, hh, ww, c = o.shape
    o = o.permute(0, 4, 1, 2, 3).reshape(b * c, tt, hh, ww)
    t = t.permute(0, 4, 1, 2, 3).reshape(b * c, tt, hh, ww)
    total = 0.0
    for sigma, sigma_t in zip(sigmas, sigmas_t):
        _, dh = _gaussian_and_derivatives_1d(float(sigma))
        _, dt_k = _gaussian_and_derivatives_1d(float(sigma_t))
        go, gt = o, t
        for k1d, dim in ((dt_k, 1), (dh, 2), (dh, 3)):
            go = _sep_conv_axis(go, k1d, dim)
            gt = _sep_conv_axis(gt, k1d, dim)
        total = total + (go - gt).abs().mean(dim=(1, 2, 3))
    total = total / len(sigmas)                        # (B * C,)
    return _reduce(total, b, reduction)


def combined_enhance_loss(outputs, targets, complex_i: bool = False,
                          weights=(1.0, 1.0, 1.0), reduction: str = "mean"):
    """mse + charbonnier + gaussian3D, weighted, each term that is not finite
    zeroed (ref: loss_base.py:27-30, enhancement_losses.py:233-278); with
    ``reduction="none"``, per sample."""
    terms = (mse_loss(outputs, targets, complex_i, reduction=reduction),
             charbonnier_loss(outputs, targets, complex_i, reduction=reduction),
             gaussian_deriv3d_loss(outputs, targets, complex_i, reduction=reduction))
    total = 0.0
    for w, v in zip(weights, terms):
        total = total + torch.where(torch.isfinite(v), w * v, torch.zeros_like(v))
    return total
