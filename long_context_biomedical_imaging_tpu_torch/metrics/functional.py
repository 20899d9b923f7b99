"""Metric functions matching torchmetrics semantics (host-side numpy).

A copy of the JAX package's ``metrics/functional.py`` (numpy only), so that both packages
produce identical host-side data; SSIM filters with its separable gaussian one
axis at a time (the same reflect-padded result to float64 round-off, a
fraction of the work on megapixel images).

Reimplements the metric set selected by the reference
(ref: metrics/metrics_utils.py:10-28): Accuracy(top1, micro), AUROC(macro),
F1(macro, global/samplewise), PSNR and SSIM (torchmetrics defaults: data_range
inferred from the target when unset — the reference leaves it None and warns).

Inputs follow the reference post-processing conventions
(ref: metrics/metrics_base.py:156-170,248-264):
  * class binary:      preds (N,) probabilities of the positive class, labels (N,)
  * class multiclass:  preds (N, C) probabilities, labels (N,)
  * seg:               preds/labels (N, P) int labels per pixel
  * enhance:           preds/labels (N, C, [T,] H, W) float images
"""

from __future__ import annotations

import math

import numpy as np
from scipy.ndimage import convolve1d


# --------------------------------------------------------------------------- #
# Classification
# --------------------------------------------------------------------------- #

def accuracy_top1(preds: np.ndarray, labels: np.ndarray, binary: bool) -> float:
    labels = labels.astype(np.int64)
    if binary:
        hard = (preds >= 0.5).astype(np.int64)
    else:
        hard = preds.argmax(axis=-1)
    return float((hard == labels).mean())


def _binary_auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Exact rank-statistic AUROC with tie handling."""
    pos = labels == 1
    n_pos = int(pos.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.0  # torchmetrics returns 0 with a warning for single-class input
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    # average ranks for ties
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    sum_pos_ranks = ranks[pos].sum()
    return float((sum_pos_ranks - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def auroc(preds: np.ndarray, labels: np.ndarray, binary: bool) -> float:
    """Binary AUROC or macro-averaged one-vs-rest multiclass AUROC."""
    labels = labels.astype(np.int64)
    if binary:
        return _binary_auroc(preds.astype(np.float64), labels)
    vals = []
    for c in range(preds.shape[-1]):
        mask_labels = (labels == c).astype(np.int64)
        if mask_labels.sum() in (0, len(labels)):
            continue
        vals.append(_binary_auroc(preds[:, c].astype(np.float64), mask_labels))
    return float(np.mean(vals)) if vals else 0.0


def _f1_counts(hard: np.ndarray, labels: np.ndarray, c: int):
    tp = int(((hard == c) & (labels == c)).sum())
    fp = int(((hard == c) & (labels != c)).sum())
    fn = int(((hard != c) & (labels == c)).sum())
    return tp, fp, fn


def f1_score(preds: np.ndarray, labels: np.ndarray, binary: bool,
             num_classes: int, samplewise: bool = False) -> float:
    """F1 with macro averaging (ref uses average='macro'); samplewise computes
    per-sample F1 over flattened pixels then means (the Dice proxy for seg)."""
    if samplewise:
        vals = [f1_score(p[None], l[None], binary, num_classes, samplewise=False)
                for p, l in zip(preds, labels)]
        return float(np.mean(vals))

    labels = labels.reshape(-1).astype(np.int64)
    if binary:
        flat = preds.reshape(-1)
        hard = (flat >= 0.5).astype(np.int64) if flat.dtype.kind == "f" else flat.astype(np.int64)
        tp, fp, fn = _f1_counts(hard, labels, 1)
        return float(2 * tp / (2 * tp + fp + fn)) if (2 * tp + fp + fn) else 0.0
    if preds.ndim > 1 and preds.shape[-1] == num_classes and preds.dtype.kind == "f":
        hard = preds.reshape(-1, num_classes).argmax(-1)
    else:
        hard = preds.reshape(-1).astype(np.int64)
    vals = []
    for c in range(num_classes):
        tp, fp, fn = _f1_counts(hard, labels, c)
        vals.append(2 * tp / (2 * tp + fp + fn) if (2 * tp + fp + fn) else 0.0)
    return float(np.mean(vals))


# --------------------------------------------------------------------------- #
# Enhancement
# --------------------------------------------------------------------------- #

def psnr(preds: np.ndarray, target: np.ndarray, data_range: float | None = None) -> float:
    """torchmetrics PSNR: data_range defaults to target max-min over the batch."""
    preds = preds.astype(np.float64)
    target = target.astype(np.float64)
    if data_range is None:
        data_range = float(target.max() - target.min())
        if data_range == 0.0:
            data_range = 1.0
    mse = float(np.mean((preds - target) ** 2))
    if mse == 0.0:
        return float("inf")
    return float(10.0 * math.log10(data_range ** 2 / mse))


def _gaussian_kernel_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(preds: np.ndarray, target: np.ndarray, data_range: float | None = None,
         kernel_size: int = 11, sigma: float = 1.5) -> float:
    """torchmetrics SSIM (gaussian kernel, K1=.01, K2=.03). Input
    (N, C, H, W) or (N, C, D, H, W); returns batch mean."""
    preds = preds.astype(np.float64)
    target = target.astype(np.float64)
    if data_range is None:
        data_range = float(target.max() - target.min())
        if data_range == 0.0:
            data_range = 1.0
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    spatial = preds.ndim - 2
    g1 = _gaussian_kernel_1d(kernel_size, sigma)

    def filt(img):
        # the outer product of g1 over the spatial axes, one axis at a time
        for axis in range(2, img.ndim):
            img = convolve1d(img, g1, axis=axis, mode="reflect")
        return img

    mu_x = filt(preds)
    mu_y = filt(target)
    sigma_x = filt(preds * preds) - mu_x ** 2
    sigma_y = filt(target * target) - mu_y ** 2
    sigma_xy = filt(preds * target) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    ssim_map = num / den
    # torchmetrics crops the conv padding margin before averaging
    pad = kernel_size // 2
    slicer = (slice(None), slice(None)) + (slice(pad, -pad),) * spatial
    return float(ssim_map[slicer].mean())
