"""Selective scan (the Mamba SSM recurrence) of the composed Mamba path.

Counterpart of the JAX package's ``ops/selective_scan.py``, with the
semantics of mamba-ssm's ``selective_scan_fn``:

    delta = softplus(delta + delta_bias)          (if delta_softplus)
    h[t]  = exp(delta[t] * A) * h[t-1] + delta[t] * B[t] * u[t]
    y[t]  = C[t] . h[t] + D * u[t]

Two implementations, both fp32 inside, autograd taking their backward:
  * ``selective_scan_cm`` (channel-minor, (batch, L, dim)): a plain sequential
    loop over the tokens, for the calls of up to 1024 tokens (the Swin window
    stages below the fused kernel's gate, L <= 64, and short sequences).
  * ``selective_scan_chunked`` ((batch, dim, L), as the JAX package's):
    chunks of ``chunk`` tokens in sequence, a log-depth affine scan
    (:func:`affine_scan`) inside each chunk, for full-sequence mixing at
    1024 < L. Each chunk runs under ``torch.utils.checkpoint``: its
    (batch, dim, chunk, N) fp32 discretisation and the scan's levels live
    only while that chunk computes, forward or backward. It is the plain
    version of the long-sequence kernel K7 (``ops.selective_scan_long``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def selective_scan_cm(u, delta, A, B, C, D=None, delta_bias=None, delta_softplus=True):
    """Channel-minor selective scan.

    u, delta: (batch, L, dim); A: (dim, N); B, C: (batch, L, N); D:
    (dim,) or None; delta_bias: (dim,) or None. The state (batch, N, dim)
    and every step are fp32. Returns (batch, L, dim) in u.dtype."""
    at = A.float().t()                                        # (N, dim)
    d = delta.float()
    if delta_bias is not None:
        d = d + delta_bias.float()
    if delta_softplus:
        d = F.softplus(d)
    u32, b32, c32 = u.float(), B.float(), C.float()
    bsz, length, dim = u.shape
    h = torch.zeros(bsz, at.shape[0], dim, dtype=torch.float32, device=u.device)
    ys = []
    for t in range(length):
        a = torch.exp(d[:, t, None, :] * at)
        h = a * h + (d[:, t] * u32[:, t])[:, None, :] * b32[:, t, :, None]
        ys.append((h * c32[:, t, :, None]).sum(dim=1))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + u32 * D.float()
    return y.to(u.dtype)


def affine_scan(a, b, dim: int, reverse: bool = False):
    """Inclusive scan of the affine maps h -> a h + b along ``dim`` in
    log2(length) levels (Hillis-Steele): element i becomes the composition
    of elements 0..i (of i..end with ``reverse``), combined as the JAX
    package's ``_combine``, (a_l a_r, a_r b_l + b_r) with l the earlier
    element. Returns (the products of a, the states from h = 0)."""
    if reverse:
        a, b = a.flip(dim), b.flip(dim)
    n = a.shape[dim]
    shift = 1
    while shift < n:
        a_l, b_l = a.narrow(dim, 0, n - shift), b.narrow(dim, 0, n - shift)
        a_r, b_r = a.narrow(dim, shift, n - shift), b.narrow(dim, shift, n - shift)
        b = torch.cat([b.narrow(dim, 0, shift), a_r * b_l + b_r], dim)
        a = torch.cat([a.narrow(dim, 0, shift), a_l * a_r], dim)
        shift *= 2
    if reverse:
        a, b = a.flip(dim), b.flip(dim)
    return a, b


def _discretize(u, delta, A, B, delta_bias, delta_softplus):
    """a = exp(delta A), b = delta B u, both (batch, dim, L, N) fp32, from u,
    delta (batch, dim, L), A (dim, N), B (batch, N, L)."""
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None, :, None]
    if delta_softplus:
        delta = F.softplus(delta)
    a = torch.exp(delta[..., None] * A.float()[None, :, None, :])
    b = (delta * u.float())[..., None] * B.float().transpose(1, 2)[:, None]
    return a, b


def _chunk_step(h0, u, delta, A, B, C, delta_bias, valid, delta_softplus):
    """One chunk from the state h0 (batch, dim, N): (its last state, y
    (batch, dim, chunk) without the D skip). Steps where ``valid`` is False
    (the padded tail) are the identity a = 1, b = 0."""
    a, b = _discretize(u, delta, A, B, delta_bias, delta_softplus)
    if valid is not None:
        a = torch.where(valid[:, None], a, 1.0)
        b = torch.where(valid[:, None], b, 0.0)
    cum_a, h_local = affine_scan(a, b, dim=2)
    h = h_local + cum_a * h0[:, :, None, :]
    return h[:, :, -1, :], torch.einsum("bdln,bnl->bdl", h, C.float())


def _chunked_scan_carry(u, delta, A, B, C, delta_bias, delta_softplus, chunk: int):
    """Core of the chunked scan (JAX ``_chunked_scan_carry``): y fp32 without
    the D skip, (batch, dim, L), and the state after step L - 1, (batch,
    dim, N). The tail is padded to a whole chunk with steps masked to the
    identity: a zero-padded delta is not one, since delta_bias and softplus
    turn it into a real decay."""
    bsz, dim, length = u.shape
    pad = (-length) % chunk
    if pad:
        u, delta, B, C = (F.pad(t, (0, pad)) for t in (u, delta, B, C))
    h = torch.zeros(bsz, dim, A.shape[1], dtype=torch.float32, device=u.device)
    ys = []
    for start in range(0, length + pad, chunk):
        part = [t[..., start:start + chunk] for t in (u, delta, B, C)]
        valid = None
        if start + chunk > length:
            steps = torch.arange(start, start + chunk, device=u.device)
            valid = (steps < length)[None, :, None]
        args = (h, part[0], part[1], A, part[2], part[3], delta_bias, valid, delta_softplus)
        if torch.is_grad_enabled():
            h, y = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            h, y = _chunk_step(*args)
        ys.append(y)
    return torch.cat(ys, dim=2)[..., :length], h


def selective_scan_chunked(u, delta, A, B, C, D=None, delta_bias=None, delta_softplus=True,
                           chunk: int = 2048):
    """Chunked selective scan (JAX ``selective_scan_chunked``): u, delta
    (batch, dim, L); A (dim, N); B, C (batch, N, L); D and delta_bias (dim,)
    or None. Returns (batch, dim, L) in u.dtype."""
    y, _ = _chunked_scan_carry(u, delta, A, B, C, delta_bias, delta_softplus, chunk)
    if D is not None:
        y = y + u.float() * D.float()[None, :, None]
    return y.to(u.dtype)
