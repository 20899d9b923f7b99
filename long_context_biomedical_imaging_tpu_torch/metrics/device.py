"""Train metrics computed on the device inside the train step.

Counterpart of the JAX package's ``metrics/device.py`` (``auroc_device``,
``f1_samplewise_device``, ``psnr_device``, ``ssim_device``,
``make_train_metric_fn``): the step returns a small stats vector that stays
on the device, and the host fetches it every ``--stats_fetch_every`` steps
instead of the model output every step. Semantics follow
``metrics/functional.py`` (tie-averaged ranks; torchmetrics' PSNR and SSIM).
"""

from __future__ import annotations

import numpy as np
import torch

from .functional import _gaussian_kernel_1d


def _safe_div(num, den):
    return torch.where(den > 0, num / torch.where(den > 0, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _pairwise_auroc(scores, pos, neg):
    """Rank-statistic AUROC by pairwise comparison (ties count 0.5), and
    whether any positive-negative pair exists. Batches are tiny, so the B^2
    pair matrix is negligible."""
    s = scores.float()
    gt = (s[:, None] > s[None, :]).float()
    eq = (s[:, None] == s[None, :]).float()
    pair = pos[:, None] * neg[None, :]
    wins = (pair * (gt + 0.5 * eq)).sum()
    n_pairs = pos.sum() * neg.sum()
    return _safe_div(wins, n_pairs), n_pairs > 0


def auroc_device(output, labels, valid, binary: bool):
    """output (B, C) logits, labels (B,) ints, valid (B,) float mask -> scalar."""
    probs = torch.softmax(output.float(), dim=1)
    labels = labels.long()
    if binary:
        pos = (labels == 1).float() * valid
        neg = (labels != 1).float() * valid
        auc, ok = _pairwise_auroc(probs[:, -1], pos, neg)
        return torch.where(ok, auc, torch.zeros_like(auc))
    vals, oks = [], []
    for c in range(output.shape[1]):
        pos = (labels == c).float() * valid
        neg = (labels != c).float() * valid
        auc, ok = _pairwise_auroc(probs[:, c], pos, neg)
        vals.append(auc)
        oks.append(ok.float())
    vals, oks = torch.stack(vals), torch.stack(oks)
    return _safe_div((vals * oks).sum(), oks.sum())


def f1_samplewise_device(output, labels, valid, binary: bool, num_classes: int):
    """Samplewise macro F1 (the Dice proxy; ref metrics_utils.py:19-20),
    averaged over the valid samples. output (B, ..., C) logits, labels
    (B, ...) int masks, valid (B,) float mask."""
    hard = output.argmax(dim=-1).reshape(output.shape[0], -1)
    lab = labels.reshape(labels.shape[0], -1).to(hard.dtype)
    classes = [1] if binary else list(range(num_classes))
    f1s = []
    for c in classes:
        tp = ((hard == c) & (lab == c)).sum(dim=1).float()
        fp = ((hard == c) & (lab != c)).sum(dim=1).float()
        fn = ((hard != c) & (lab == c)).sum(dim=1).float()
        f1s.append(_safe_div(2 * tp, 2 * tp + fp + fn))
    per_sample = torch.stack(f1s).mean(dim=0)
    return _safe_div((per_sample * valid).sum(), valid.sum())


def _masked_data_range(target, valid):
    """torchmetrics' default data_range: max - min over the valid targets (1
    where they are all equal)."""
    m = valid.reshape((-1,) + (1,) * (target.dim() - 1)) > 0
    dr = (torch.where(m, target, float("-inf")).max()
          - torch.where(m, target, float("inf")).min())
    return torch.where(dr == 0, torch.ones_like(dr), dr)


def psnr_device(output, target, valid):
    """functional.psnr over the valid rows (equal-sized samples, so the mean
    of the per-sample mean squared errors is the batch's)."""
    o, t = output.float(), target.float()
    dr = _masked_data_range(t, valid)
    per = (o - t).square().mean(dim=tuple(range(1, o.dim())))
    mse = _safe_div((per * valid).sum(), valid.sum())
    return 10.0 * torch.log10(dr * dr / mse)


def _sep_filter_valid(x, k):
    """Separable VALID correlation of (N, *spatial) with the 1D kernel k
    along every spatial axis, as taps in order: functional.ssim's
    reflect-padded convolution followed by its margin crop."""
    size = len(k)
    for dim in range(1, x.dim()):
        length = x.shape[dim] - size + 1
        y = x.narrow(dim, 0, length) * float(k[0])
        for j in range(1, size):
            y = y + x.narrow(dim, j, length) * float(k[j])
        x = y
    return x


def ssim_device(output, target, valid, kernel_size: int = 11, sigma: float = 1.5):
    """torchmetrics SSIM (gaussian window, K1 0.01, K2 0.03), the mean over
    the valid rows. output and target in the model's layout (B, T, H, W, C),
    time squeezed when T == 1 (ref metrics_base.py:166-170)."""
    o, t = output.float(), target.float()
    dr = _masked_data_range(t, valid)
    b, c = o.shape[0], o.shape[-1]
    if o.shape[1] == 1:
        o, t = o[:, 0], t[:, 0]
    o = o.movedim(-1, 1).reshape((b * c,) + o.shape[1:-1])
    t = t.movedim(-1, 1).reshape((b * c,) + t.shape[1:-1])
    c1, c2 = (0.01 * dr) ** 2, (0.03 * dr) ** 2
    k = _gaussian_kernel_1d(kernel_size, sigma).astype(np.float32)
    mu_x, mu_y = _sep_filter_valid(o, k), _sep_filter_valid(t, k)
    sig_x = _sep_filter_valid(o * o, k) - mu_x ** 2
    sig_y = _sep_filter_valid(t * t, k) - mu_y ** 2
    sig_xy = _sep_filter_valid(o * t, k) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sig_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sig_x + sig_y + c2)
    per = (num / den).reshape(b, -1).mean(dim=1)
    return _safe_div((per * valid).sum(), valid.sum())


def make_train_metric_fn(config):
    """(names, fn): fn(output, labels, valid) -> the train metrics (without
    the loss) as a float vector on the device, ``names`` in the manager's
    order: AUROC for classification, samplewise F1 for segmentation, SSIM and
    PSNR for enhancement."""
    binary = config.no_out_channel in (1, 2)
    if config.task_type == "enhance":
        def enhance_fn(output, labels, valid):
            return torch.stack([ssim_device(output, labels, valid),
                                psnr_device(output, labels, valid)])

        return ("ssim", "psnr"), enhance_fn
    if config.task_type == "seg":
        def seg_fn(output, labels, valid):
            return f1_samplewise_device(output, labels, valid, binary,
                                        config.no_out_channel).reshape(1)

        return ("f1",), seg_fn

    def fn(output, labels, valid):
        return auroc_device(output, labels, valid, binary).reshape(1)

    return ("auroc",), fn
