"""Swin window machinery on channels-last (B, D, H, W, C) grids.

Counterpart of ``long_context_biomedical_imaging_tpu/ops/window.py``: window
partition/reverse, the window shrink, the shifted windows' region ids and the
relative-position index. Windows are flattened (B, nW) with the window index
fastest, each window's tokens row-major over (wd, wh, ww). The region ids and
the index are made in numpy, as in the JAX package, and returned as int32
tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def get_window_size(x_size, window_size, shift_size=None):
    """Shrink the window (and zero the shift) along dims where the input is no
    larger than the window."""
    use_window = list(window_size)
    use_shift = list(shift_size) if shift_size is not None else None
    for i, (xs, ws) in enumerate(zip(x_size, window_size)):
        if xs <= ws:
            use_window[i] = xs
            if use_shift is not None:
                use_shift[i] = 0
    if shift_size is None:
        return tuple(use_window)
    return tuple(use_window), tuple(use_shift)


def window_partition(x, window_size):
    """(B, D, H, W, C) -> (B * nW, wd*wh*ww, C)."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window_size
    x = x.reshape(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, c)


def window_reverse(windows, window_size, dims):
    """Inverse of :func:`window_partition`; dims = (B, D, H, W)."""
    b, d, h, w = dims
    wd, wh, ww = window_size
    x = windows.reshape(b, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d, h, w, -1)


def pad_to_window_multiple(x, window_size):
    """Zero-pad the (D, H, W) dims of (B, D, H, W, C) up to window multiples;
    returns (x, padded dims)."""
    _, d, h, w, _ = x.shape
    wd, wh, ww = window_size
    pd, ph, pw = (-d) % wd, (-h) % wh, (-w) % ww
    if pd or ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph, 0, pd))
    return x, (d + pd, h + ph, w + pw)


def _region_slices(w: int, s: int):
    """The pre-shift regions along one axis of a window w with shift s: the
    whole axis but its last window, that window up to the shifted-in part,
    and the shifted-in part (the last two merge when s == 0)."""
    if s:
        return (slice(-w), slice(-w, -s), slice(-s, None))
    return (slice(-w), slice(-w, None))


def compute_shift_regions(dims, window_size, shift_size) -> torch.Tensor:
    """Pre-shift region id per (window, token), (nW, wd*wh*ww) int32, on the
    (D, H, W) grid ``dims`` (window multiples). Two tokens of a window attend
    unmasked iff their ids match: the Swin shift mask in factored form."""
    d, h, w = dims
    wd, wh, ww = window_size
    sd, sh, sw = shift_size
    img = np.zeros((d, h, w), dtype=np.int32)
    cnt = 0
    for ds in _region_slices(wd, sd):
        for hs in _region_slices(wh, sh):
            for ws in _region_slices(ww, sw):
                img[ds, hs, ws] = cnt
                cnt += 1
    win = img.reshape(d // wd, wd, h // wh, wh, w // ww, ww)
    return torch.from_numpy(win.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww))


def relative_position_index(window_size) -> torch.Tensor:
    """(V, V) int32 index into the relative-position-bias table, whose
    (2wd-1)(2wh-1)(2ww-1) rows cover every offset between two tokens of a
    window (the standard Swin formula)."""
    wd, wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel += np.array([wd - 1, wh - 1, ww - 1])
    rel *= np.array([(2 * wh - 1) * (2 * ww - 1), 2 * ww - 1, 1])
    return torch.from_numpy(rel.sum(-1).astype(np.int32))
