"""Causal long convolution of the composed Hyena path.

Counterpart of the JAX package's ``ops/fftconv.py``: ``causal_long_conv_cm``
on channels-last (B, L, D) and its regimes, chosen by the same rules in the
same order:

  * L <= 64: L shift-and-multiply-add steps in u.dtype;
  * L * L * D * itemsize <= 256 MB: the causal Toeplitz operator as one
    channel-batched product (fp32 sums, result in u.dtype), with a custom
    backward: du from the transposed product, dk from chunk-lag products and
    per-offset diagonal sums in fp32 (the JAX package rounds those products to
    u.dtype first, a fault this port does not copy);
  * beyond that, one transpose to (B, D, L) and :func:`fft_causal_conv`, whose
    own three routes are the JAX package's: a direct depthwise convolution in
    u.dtype for L <= 512; the spectral kernel K6 (``ops/spectral_conv.py``)
    where ``spectral_supported(L)`` holds; the fp32 FFT product through
    ``torch.fft`` otherwise.

Every route but K6 is plain tensor code in the JAX package too (XLA ops
outside any Pallas kernel), so it stays plain PyTorch here on every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .spectral_conv import (spectral_causal_conv, spectral_causal_conv_plain,
                            spectral_supported)

CM_DIRECT_MAX_LEN = 64
TOEPLITZ_MAX_BYTES = 256 * 1024 * 1024
LAG_CHUNK = 128
# fft_causal_conv: up to this length a direct depthwise convolution
DIRECT_CONV_MAX_LEN = 512


def diagonal_sums(a):
    """a: (..., ch, ch) -> (..., 2ch-1); entry o + ch - 1 is the sum of the
    offset-o diagonal, sum over rows i of a[..., i, i + o] (o = col - row).

    The rows are flipped, padded with ch zero columns and read back with a
    row stride of 2ch - 1, which puts every anti-diagonal of the flipped
    block (a diagonal of the block) in one column: plain tensor ops, one
    ordered sum, no scatter."""
    ch = a.shape[-1]
    lead = a.shape[:-2]
    p = F.pad(torch.flip(a, dims=(-2,)), (0, ch)).reshape(*lead, 2 * ch * ch)
    return p[..., :ch * (2 * ch - 1)].reshape(*lead, ch, 2 * ch - 1).sum(dim=-2)


def lag_sums(s, length: int):
    """s: (n, ..., 2ch-1), per chunk distance d the diagonal sums of a block
    whose offset o stands for lag d * ch + o -> (..., length): the sum over d
    of every lag in [0, length); negative lags and lags past the end drop."""
    n, ch = s.shape[0], (s.shape[-1] + 1) // 2
    lo = F.pad(s[..., :ch], (0, 0) * (s.dim() - 1) + (0, 1))
    hi = F.pad(F.pad(s[..., ch:], (0, 1)), (0, 0) * (s.dim() - 1) + (1, 0))
    buf = (lo + hi).movedim(0, -2)                       # (..., n + 1, ch)
    buf = buf.reshape(*buf.shape[:-2], (n + 1) * ch)
    return buf[..., ch - 1:ch - 1 + length]


def toeplitz_operator(k, length: int, dtype):
    """(D, L) filter -> (D, L, L) channel-major causal Toeplitz operator,
    T[c, s, t] = k[c, t - s] for s <= t, else 0, in ``dtype``."""
    s = torch.arange(length, device=k.device)
    lag = s[None, :] - s[:, None]                        # [s, t] = t - s
    taps = k[:, lag.clamp(min=0)]
    return torch.where(lag >= 0, taps, torch.zeros((), dtype=k.dtype, device=k.device)).to(dtype)


class _ToeplitzConv(torch.autograd.Function):
    """y[b, t, c] = sum_{s <= t} k[c, t - s] u[b, s, c] as a product batched
    over channels: operands in u.dtype, fp32 sums, result in u.dtype."""

    @staticmethod
    def forward(ctx, u, k):
        ctx.save_for_backward(u, k)
        t = toeplitz_operator(k, u.shape[1], u.dtype)
        return torch.bmm(u.permute(2, 0, 1), t).permute(1, 2, 0).contiguous()

    @staticmethod
    def backward(ctx, g):
        u, k = ctx.saved_tensors
        b, length, c = u.shape
        g = g.to(u.dtype)
        t = toeplitz_operator(k, length, u.dtype)
        du = torch.bmm(g.permute(2, 0, 1), t.transpose(1, 2)).permute(1, 2, 0).contiguous()
        # dk[c, tau] = sum_{b, t} g[b, t, c] u[b, t - tau, c]: per chunk
        # distance d the (C, ch, ch) products of g chunks with the u chunks
        # d behind, in fp32, then their diagonal sums
        ch = min(LAG_CHUNK, length)
        pad = -length % ch
        n = (length + pad) // ch
        gr = F.pad(g.float(), (0, 0, 0, pad)).reshape(b, n, ch, c)
        ur = F.pad(u.float(), (0, 0, 0, pad)).reshape(b, n, ch, c)
        sums = torch.stack([
            diagonal_sums(torch.einsum("bqxc,bqyc->cyx", gr[:, d:], ur[:, :n - d]))
            for d in range(n)])
        return du, lag_sums(sums, length).to(k.dtype)


def long_conv_route(length: int) -> str:
    """The route of :func:`fft_causal_conv` for a length, as the JAX package
    chooses it: "direct", "spectral" (K6) or "fft"."""
    if length <= DIRECT_CONV_MAX_LEN:
        return "direct"
    return "spectral" if spectral_supported(length) else "fft"


def fft_causal_conv(u, k, bias=None):
    """Causal long convolution with a per-channel skip term on (B, D, L): y[t]
    = sum_{tau <= t} k[:, tau] u[t - tau] + bias * u[t], in u.dtype. k (D, L)
    and bias (D,) enter in fp32 (the direct route casts k to u.dtype)."""
    length, d = u.shape[-1], u.shape[1]
    route = long_conv_route(length)
    if route == "direct":
        # y[t] = sum_tau u[t - tau] k[tau]: the causal correlation with the
        # flipped filter, in u.dtype, as the JAX package's depthwise conv
        w = torch.flip(k, dims=(-1,)).to(u.dtype)[:, None, :]
        y32 = F.conv1d(F.pad(u, (length - 1, 0)), w, groups=d).float()
        if bias is not None:
            y32 = y32 + u.float() * bias.float()[:, None]
        return y32.to(u.dtype)
    k32 = k.float()
    b32 = None if bias is None else bias.float()
    if route == "spectral":
        return spectral_causal_conv(u, k32, b32)
    # the fp32 FFT product, differentiated by autograd: the JAX package's XLA
    # FFT route computes the same function as K6's plain version
    return spectral_causal_conv_plain(u, k32, b32)


def causal_long_conv_cm(u, k, bias=None):
    """Causal long convolution, u: (B, L, D), k: (D, L), bias: (D,) skip
    weight: y[t] = sum_{tau <= t} k[:, tau] u[t - tau] + bias * u[t]. Returns
    (B, L, D) in u.dtype."""
    length, d = u.shape[1], u.shape[2]
    if length <= CM_DIRECT_MAX_LEN:
        kt = k.to(u.dtype).t()
        y = u * kt[0]
        for tau in range(1, length):
            y = y + F.pad(u, (0, 0, tau, 0))[:, :length] * kt[tau]
        return y if bias is None else y + u * bias.to(u.dtype)
    if length * length * d * u.element_size() <= TOEPLITZ_MAX_BYTES:
        y = _ToeplitzConv.apply(u, k)
        return y if bias is None else y + u * bias.to(u.dtype)
    return fft_causal_conv(u.transpose(1, 2), k, bias).transpose(1, 2)
