"""Fused Hyena window mixer: the whole HyenaOperator body on windows of up to
512 tokens, optionally with the caller's pre-LayerNorm and residual folded in.

Counterpart of ``long_context_biomedical_imaging_tpu/ops/hyena_window.py``
(``hyena_window_mixer`` and its custom VJPs), with the same two forms:

  * K1, windows of V <= 64 tokens: the long conv as V taps. On a CUDA tensor
    the wrapper launches ``csrc/hyena_window.cu`` (forward) and
    ``csrc/hyena_window_bwd.cu`` (backward, which recomputes the forward); on
    a CPU tensor it runs :func:`hyena_window_plain`, the composed math in
    plain PyTorch, and its vector-Jacobian product
    :func:`hyena_window_bwd_plain`.
  * K3, 64 < V <= 512 with V % 64 == 0 and C <= 192 (:func:`hyena_window_supported`):
    the long conv as block-Toeplitz products over chunks of 128 (or 64)
    tokens, y_chunk[q] = sum_{d <= q} g_chunk[q - d] @ M[d] per channel. The
    n = V / chunk distinct blocks M (:func:`build_chunk_toeplitz`) are built
    outside the kernels from the filter, so the filter's gradient comes from
    dM by autograd. On a CUDA tensor the wrapper launches
    ``csrc/hyena_chunked.cu`` (forward), ``csrc/hyena_chunked_bwd.cu``
    (backward, which recomputes the forward and streams g and dvl) and
    ``csrc/hyena_dm.cu`` (dM from those streams); on a CPU tensor
    :func:`hyena_chunked_plain`, :func:`hyena_chunked_bwd_plain` and
    :func:`hyena_dm_plain`.

Any other window raises: the caller (``models/hyena.py``) routes it to the
composed path.

Precision, shared by kernels and plain versions and taken from the TPU
kernels: LayerNorm, the short convolution and the gates in fp32; the two
projections and (K3) the Toeplitz products take operands rounded to
``x.dtype`` (bf16 under AMP: g and M) and sum in fp32; (K1) the long conv
runs in fp32; the output is cast to ``x.dtype`` once, after the residual add.
The backward kernels round the operands of their products to ``x.dtype`` as
the TPU kernels do and return dw_in, dw_out (and dM) in their input's dtype,
the rest in fp32.

Widths: the kernels take any C (K3 up to 192) and every weight, tap, bias
and Toeplitz block as it is, with no padded copy. They walk the channels in
chunks of 32, load the rows at the true C (LayerNorm statistics over C,
zeros past it) and store only the true columns; their products stage the
weight slices (and K3's Toeplitz blocks) through shared memory with the
tails past C zeroed, in their own row kernels or in the shared products of
``csrc/mma_gemm.cuh``.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .cuda_build import (CudaKernel, check_cuda_operand, ptr, slot_count, slot_layout,
                         stream_handle)
from .fftconv import diagonal_sums, lag_sums
from .fused_mlp import layer_norm_f32, matmul_rounded

HYENA_WINDOW_MAX_LEN = 64
HYENA_CHUNK_MIN = 64
HYENA_CHUNKED_MAX_LEN = 512
HYENA_CHUNKED_MAX_CHANNELS = 192

HYENA_WINDOW_FWD = CudaKernel(
    "hyena_window.cu", "lcbi_hyena_window_fwd",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
HYENA_WINDOW_BWD = CudaKernel(
    "hyena_window_bwd.cu", "lcbi_hyena_window_bwd",
    [ctypes.c_void_p] * 16 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
    + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
HYENA_CHUNKED_FWD = CudaKernel(
    "hyena_chunked.cu", "lcbi_hyena_chunked_fwd",
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
HYENA_CHUNKED_BWD = CudaKernel(
    "hyena_chunked_bwd.cu", "lcbi_hyena_chunked_bwd",
    [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 5
    + [ctypes.c_void_p])
HYENA_DM = CudaKernel(
    "hyena_dm.cu", "lcbi_hyena_dm", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def hyena_window_supported(v: int, c: int) -> bool:
    """Whether a fused kernel takes windows of v tokens at c channels: K1 at
    8 <= v <= 64 with v % 8 == 0, K3 at v % 64 == 0, v <= 512 and c <= 192
    (the JAX package's gate; other windows take the composed path)."""
    if 8 <= v <= HYENA_WINDOW_MAX_LEN and v % 8 == 0:
        return True
    return (v % HYENA_CHUNK_MIN == 0 and v <= HYENA_CHUNKED_MAX_LEN
            and c <= HYENA_CHUNKED_MAX_CHANNELS)


def pick_chunk(v: int) -> int:
    """Toeplitz block edge of K3: 128 when it divides V, else 64."""
    return 128 if v % 128 == 0 else HYENA_CHUNK_MIN


def causal_depthwise_conv(x, w, b=None):
    """Causal depthwise conv over the token axis, channels last.

    x: (B, L, D); w: (D, K); b: (D,) or None. As torch Conv1d(groups=D) with
    K-1 zeros of left padding: y[t] = sum_j w[:, j] * x[t - (K-1) + j]."""
    k = w.shape[1]
    length = x.shape[1]
    y = x * w[:, k - 1]
    for m in range(1, min(k, length)):
        y[:, m:] += x[:, :length - m] * w[:, k - 1 - m]
    return y if b is None else y + b


def causal_long_conv(u, k, bias):
    """y[t] = sum_{tau <= t} k[:, tau] * u[t - tau] + bias * u[t].

    u: (B, L, D); k: (D, L) per-channel filter; bias: (D,) skip weight."""
    length = u.shape[1]
    y = u * k[:, 0]
    for tau in range(1, length):
        y[:, tau:] += u[:, :length - tau] * k[:, tau]
    return y + u * bias


def hyena_window_plain(x, w_in, b_in, w_short, b_short, k_long, b_long,
                       w_out, b_out, ln_scale=None, ln_bias=None):
    """The mixer in plain PyTorch, in the kernel's precision (see module doc).
    Arguments as :func:`hyena_window_mixer`."""
    bw, v, c = x.shape
    dt = x.dtype
    x32 = x.float()
    y = x32 if ln_scale is None else layer_norm_f32(x32, ln_scale, ln_bias)
    z = (matmul_rounded(y.reshape(bw * v, c), w_in, dt).reshape(bw, v, 3 * c)
         + b_in.float())
    z = causal_depthwise_conv(z, w_short.float(), b_short.float())
    x1, x2, g = z[..., :c], z[..., c:2 * c], z[..., 2 * c:]
    g = causal_long_conv(g * x1, k_long.float(), b_long.float()) * x2
    out = (matmul_rounded(g.reshape(bw * v, c), w_out, dt).reshape(bw, v, c)
           + b_out.float())
    if ln_scale is not None:
        out = out + x32
    return out.to(dt)


def prepare_taps(w_short, k_long, b_long):
    """The kernels' tap layout, as differentiable tensor ops (so autograd
    carries the tap gradients back to the raw filters): ws (K, 3C), the short
    filter flipped to causal tap order (tap m = w_short[:, K-1-m]: the
    composed op correlates with the flipped kernel), and kl (V, C), the long
    filter with the fftconv skip weight added to its tap 0. Both fp32 and new
    tensors, never views of the caller's."""
    ws = torch.flip(w_short.float().t(), dims=(0,)).contiguous()
    kl = k_long.float().t()
    kl = torch.cat([kl[:1] + b_long.float(), kl[1:]]).contiguous()
    return ws, kl


def _plain_on_taps(x, w_in, b_in, ws, bs, kl, w_out, b_out, ln_scale=None, ln_bias=None):
    """:func:`hyena_window_plain` on prepared taps: the flip undone, and the
    folded skip left in tap 0 of the long filter with a zero skip weight."""
    return hyena_window_plain(x, w_in, b_in, torch.flip(ws, dims=(0,)).t(), bs, kl.t(),
                              torch.zeros_like(kl[0]), w_out, b_out, ln_scale, ln_bias)


def hyena_window_bwd_plain(do, x, w_in, b_in, ws, bs, kl, w_out, b_out,
                           ln_scale=None, ln_bias=None):
    """The vector-Jacobian product of the plain mixer (on prepared taps, see
    :func:`prepare_taps`) for the output cotangent ``do``, by
    ``torch.func.vjp``: (dx, dw_in, db_in, dws, dbs, dkl, dw_out, db_out
    [, d ln_scale, d ln_bias]), each in its input's dtype. Autograd of the
    composed math, independent of the kernel's hand-derived formulas."""
    args = [x, w_in, b_in, ws, bs, kl, w_out, b_out]
    if ln_scale is not None:
        args += [ln_scale, ln_bias]
    _, vjp = torch.func.vjp(_plain_on_taps, *args)
    return vjp(do)


def _check_operands(x, w_in, b_in, ws, bs, kl, w_out, b_out, ln_scale, ln_bias):
    bw, v, c = x.shape
    if v > HYENA_WINDOW_MAX_LEN:
        raise ValueError(
            f"the V-tap kernel takes windows of at most {HYENA_WINDOW_MAX_LEN} tokens, "
            f"got {v}: longer windows go through the chunked kernel (hyena_window_mixer)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"Hyena window kernel takes fp32 or bf16, got {x.dtype}")
    if bw == 0 or c == 0 or x.numel() >= 2**31:
        raise ValueError(f"Hyena window kernel needs 0 < BW*V*C < 2^31; got BW={bw}, V={v}, "
                         f"C={c}")
    dev = x.device
    check_cuda_operand("x", x, dev, x.dtype, (bw, v, c))
    check_cuda_operand("w_in", w_in, dev, x.dtype, (c, 3 * c))
    check_cuda_operand("w_out", w_out, dev, x.dtype, (c, c))
    check_cuda_operand("w_short", ws, dev, torch.float32, (ws.shape[0], 3 * c))
    check_cuda_operand("k_long", kl, dev, torch.float32, (v, c))
    f32 = {"b_in": b_in, "b_short": bs, "b_out": b_out}
    if ln_scale is not None:
        f32.update(ln_scale=ln_scale, ln_bias=ln_bias)
    for name, t in f32.items():
        check_cuda_operand(name, t, dev, torch.float32,
                           (3 * c,) if name in ("b_in", "b_short") else (c,))


def _chunked_bwd_grads(red, layout, wgrads, c, k, w_dtype, has_ln):
    """K3's backward gradients at the true C: dw_in, db_in, dws, dbs, dw_out,
    db_out (and the LN parameters'), the projections' from the split-K
    product's [dw_in | dw_out] in w_dtype, the rest from the reduced slot
    ``red`` (offsets ``layout``) in fp32."""
    def grad(name, shape):
        return red[layout[name]:layout[name] + math.prod(shape)].view(shape)

    grads = (wgrads[:3 * c * c].view(c, 3 * c).to(w_dtype), grad("dbin", (3 * c,)),
             grad("dws", (k, 3 * c)), grad("dbs", (3 * c,)),
             wgrads[3 * c * c:].view(c, c).to(w_dtype), grad("dbo", (c,)))
    if has_ln:
        grads += (grad("dg", (c,)), grad("dbln", (c,)))
    return grads


def _fwd_cuda(x, w_in, b_in, ws, bs, kl, w_out, b_out, ln_scale, ln_bias):
    """The forward kernel on CUDA, on prepared taps, at the true C (no padded
    copies)."""
    _check_operands(x, w_in, b_in, ws, bs, kl, w_out, b_out, ln_scale, ln_bias)
    bw, v, c = x.shape
    out = torch.empty_like(x)
    HYENA_WINDOW_FWD(ptr(x), ptr(ln_scale), ptr(ln_bias), ptr(w_in), ptr(b_in), ptr(ws),
                     ptr(bs), ptr(kl), ptr(w_out), ptr(b_out), ptr(out),
                     bw, v, c, ws.shape[0], int(ln_scale is not None),
                     int(x.dtype == torch.bfloat16), stream_handle(x.device))
    return out


def hyena_window_bwd(do, x, w_in, b_in, ws, bs, kl, w_out, b_out, ln_scale=None, ln_bias=None):
    """The backward kernel on CUDA, on prepared taps (:func:`prepare_taps`;
    biases and LN parameters fp32), at the true C (no padded copies): the
    gradients of :func:`hyena_window_bwd_plain`, in the same order and
    dtypes. The kernel writes the operands of dw_in = y^T dz and dw_out = v2^T
    do as streams in x.dtype, which its library's split-K products contract
    in the same call."""
    _check_operands(x, w_in, b_in, ws, bs, kl, w_out, b_out, ln_scale, ln_bias)
    bw, v, c = x.shape
    k, n, dev = ws.shape[0], bw * v, x.device
    has_ln = ln_scale is not None
    check_cuda_operand("do", do, dev, x.dtype, (bw, v, c))
    layout, size = slot_layout([("dws", k * 3 * c), ("dbin", 3 * c), ("dbs", 3 * c),
                                ("dkl", v * c), ("dbo", c), ("dg", c), ("dbln", c)])
    slots = torch.empty(slot_count(size, dev), size, device=dev, dtype=torch.float32)
    red = torch.empty(size, device=dev, dtype=torch.float32)
    dx = torch.empty_like(x)
    ys = torch.empty(n, c, device=dev, dtype=x.dtype) if has_ln else None
    v2s = torch.empty(n, c, device=dev, dtype=x.dtype)
    dzs = torch.empty(n, 3 * c, device=dev, dtype=x.dtype)
    splits = HYENA_WINDOW_BWD.query("lcbi_hyena_window_wgrad_splits",
                                    [ctypes.c_longlong, ctypes.c_int], ctypes.c_int, n, c)
    if splits < 1:
        raise RuntimeError("lcbi_hyena_window_wgrad_splits: device query failed")
    partials = torch.empty(splits, 4 * c * c, device=dev, dtype=torch.float32)
    wgrads = torch.empty(4 * c * c, device=dev, dtype=torch.float32)
    HYENA_WINDOW_BWD(ptr(x), ptr(ln_scale), ptr(ln_bias), ptr(w_in), ptr(b_in), ptr(ws), ptr(bs),
                     ptr(kl), ptr(w_out), ptr(do), ptr(dx), ptr(ys), ptr(v2s), ptr(dzs),
                     ptr(partials), ptr(wgrads), splits, ptr(slots), ptr(red), bw, v, c, k,
                     int(has_ln), int(x.dtype == torch.bfloat16), slots.shape[0], size,
                     *(layout[name] for name in ("dbin", "dbs", "dkl", "dbo", "dg", "dbln")),
                     stream_handle(dev))

    def grad(name, shape):
        return red[layout[name]:layout[name] + math.prod(shape)].view(shape)

    grads = (dx, wgrads[:3 * c * c].view(c, 3 * c).to(x.dtype), grad("dbin", (3 * c,)),
             grad("dws", (k, 3 * c)), grad("dbs", (3 * c,)), grad("dkl", (v, c)),
             wgrads[3 * c * c:].view(c, c).to(x.dtype), grad("dbo", (c,)))
    if has_ln:
        grads += (grad("dg", (c,)), grad("dbln", (c,)))
    return grads


class _HyenaWindowMixer(torch.autograd.Function):
    """The mixer on prepared taps (fp32 taps, biases and LN parameters). The
    forward saves only its inputs; the backward recomputes the forward, in
    the kernel on CUDA and through the plain VJP on the CPU."""

    @staticmethod
    def forward(ctx, x, w_in, b_in, ws, bs, kl, w_out, b_out, ln_scale, ln_bias):
        ctx.save_for_backward(x, w_in, b_in, ws, bs, kl, w_out, b_out, ln_scale, ln_bias)
        if x.is_cuda:
            return _fwd_cuda(x, w_in, b_in, ws, bs, kl, w_out, b_out, ln_scale, ln_bias)
        return _plain_on_taps(x, w_in, b_in, ws, bs, kl, w_out, b_out, ln_scale, ln_bias)

    @staticmethod
    def backward(ctx, do):
        inputs = ctx.saved_tensors
        if do.is_cuda:
            grads = hyena_window_bwd(do.contiguous(), *inputs)
        else:
            grads = hyena_window_bwd_plain(do, *inputs)
        return tuple(grads) + (None,) * (10 - len(grads))


# --------------------------------------------------------------------------- #
# K3: 64 < V <= 512, the long conv as block-Toeplitz products over chunks
# --------------------------------------------------------------------------- #

class _ChunkToeplitz(torch.autograd.Function):
    """(V, C) prepared long taps -> (n, C, chunk, chunk) fp32 blocks,
    M[d][c, j, r] = kl[chunk * d + r - j, c] inside [0, V), else 0. The
    backward sums dM along its diagonals with tensor ops in a fixed order (no
    scatter, so the filter gradient is the same from run to run)."""

    @staticmethod
    def forward(ctx, kl, chunk):
        v = kl.shape[0]
        ctx.v = v
        lag = (chunk * torch.arange(v // chunk, device=kl.device)[:, None, None]
               + torch.arange(chunk, device=kl.device)[None, None, :]
               - torch.arange(chunk, device=kl.device)[None, :, None])
        m = kl[lag.clamp(0, v - 1)] * ((lag >= 0) & (lag < v))[..., None]
        return m.permute(0, 3, 1, 2).contiguous()

    @staticmethod
    def backward(ctx, dm):
        return lag_sums(diagonal_sums(dm.float()), ctx.v).t(), None


def build_chunk_toeplitz(kl, chunk: int):
    """The K3 Toeplitz blocks (n, C, chunk, chunk) in fp32 from the prepared
    long taps kl (V, C) (:func:`prepare_taps`, skip folded into tap 0),
    differentiable in kl. The caller casts them to the matmul dtype."""
    return _ChunkToeplitz.apply(kl, chunk)


def chunked_long_conv(g, m, dt):
    """vl[q] = sum_{d <= q} g[q - d] @ M[d] per channel, chunk by chunk: g
    (BW, V, C) and m rounded to ``dt``, fp32 sums. Returns fp32."""
    bw, v, c = g.shape
    n, chunk = m.shape[0], m.shape[-1]
    gq = g.to(dt).float().reshape(bw, n, chunk, c)
    mf = m.to(dt).float()
    vl = sum(F.pad(torch.einsum("bqjc,cjr->bqrc", gq[:, :n - d], mf[d]),
                   (0, 0, 0, 0, d, 0)) for d in range(n))
    return vl.reshape(bw, v, c)


def hyena_chunked_plain(x, w_in, b_in, ws, bs, m, w_out, b_out, ln_scale=None, ln_bias=None):
    """The K3 mixer in plain PyTorch, in the kernel's precision, on prepared
    short taps ws (K, 3C) and Toeplitz blocks m (:func:`build_chunk_toeplitz`,
    in x.dtype). Other arguments as :func:`hyena_window_mixer`."""
    bw, v, c = x.shape
    dt = x.dtype
    x32 = x.float()
    y = x32 if ln_scale is None else layer_norm_f32(x32, ln_scale, ln_bias)
    z = (matmul_rounded(y.reshape(bw * v, c), w_in, dt).reshape(bw, v, 3 * c)
         + b_in.float())
    z = causal_depthwise_conv(z, torch.flip(ws, dims=(0,)).t().float(), bs.float())
    vl = chunked_long_conv(z[..., 2 * c:] * z[..., :c], m, dt)
    out = (matmul_rounded((vl * z[..., c:2 * c]).reshape(bw * v, c), w_out, dt)
           .reshape(bw, v, c) + b_out.float())
    if ln_scale is not None:
        out = out + x32
    return out.to(dt)


def hyena_chunked_bwd_plain(do, x, w_in, b_in, ws, bs, m, w_out, b_out,
                            ln_scale=None, ln_bias=None):
    """The vector-Jacobian product of :func:`hyena_chunked_plain` for the
    output cotangent ``do``, by ``torch.func.vjp``: (dx, dw_in, db_in, dws,
    dbs, dm, dw_out, db_out [, d ln_scale, d ln_bias]), each in its input's
    dtype."""
    args = [x, w_in, b_in, ws, bs, m, w_out, b_out]
    if ln_scale is not None:
        args += [ln_scale, ln_bias]
    _, vjp = torch.func.vjp(hyena_chunked_plain, *args)
    return vjp(do)


def hyena_dm_plain(gs, dvl, chunk: int):
    """dM[d][c, j, r] = sum over windows w and chunks q >= d of
    gs[c, w, (q - d) * chunk + j] * dvl[c, w, q * chunk + r], in fp32.
    gs, dvl: (C, BW, V), the streams of the K3 backward."""
    c, bw, v = gs.shape
    n = v // chunk
    g = gs.float().reshape(c, bw, n, chunk)
    dv = dvl.float().reshape(c, bw, n, chunk)
    return torch.stack([torch.einsum("cbqj,cbqr->cjr", g[:, :, :n - d], dv[:, :, d:])
                        for d in range(n)])


def _check_chunked(x, w_in, b_in, ws, bs, m, w_out, b_out, ln_scale, ln_bias):
    bw, v, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"chunked Hyena kernel takes fp32 or bf16, got {x.dtype}")
    chunk = pick_chunk(v)
    if (not HYENA_WINDOW_MAX_LEN < v <= HYENA_CHUNKED_MAX_LEN or v % HYENA_CHUNK_MIN
            or c > HYENA_CHUNKED_MAX_CHANNELS or bw == 0 or c == 0 or x.numel() >= 2**31):
        raise ValueError(f"chunked Hyena kernel needs 64 < V <= 512, V % 64 == 0, 0 < C <= 192 "
                         f"and 0 < BW*V*C < 2^31; got BW={bw}, V={v}, C={c}")
    dev = x.device
    check_cuda_operand("x", x, dev, x.dtype, (bw, v, c))
    check_cuda_operand("w_in", w_in, dev, x.dtype, (c, 3 * c))
    check_cuda_operand("w_out", w_out, dev, x.dtype, (c, c))
    check_cuda_operand("m", m, dev, x.dtype, (v // chunk, c, chunk, chunk))
    if not 1 <= ws.shape[0] <= 16:
        raise ValueError(f"chunked Hyena kernel takes 1 to 16 short taps, got {ws.shape[0]}")
    check_cuda_operand("w_short", ws, dev, torch.float32, (ws.shape[0], 3 * c))
    f32 = {"b_in": b_in, "b_short": bs, "b_out": b_out}
    if ln_scale is not None:
        f32.update(ln_scale=ln_scale, ln_bias=ln_bias)
    for name, t in f32.items():
        check_cuda_operand(name, t, dev, torch.float32,
                           (3 * c,) if name in ("b_in", "b_short") else (c,))
    return bw, v, c, chunk


def hyena_chunked_fwd(x, w_in, b_in, ws, bs, m, w_out, b_out, ln_scale=None, ln_bias=None):
    """The K3 forward kernel on CUDA, on prepared short taps and Toeplitz
    blocks (biases and LN parameters fp32), every operand at the true C (no
    padded copies): :func:`hyena_chunked_plain`."""
    bw, v, c, chunk = _check_chunked(x, w_in, b_in, ws, bs, m, w_out, b_out, ln_scale, ln_bias)
    out = torch.empty_like(x)
    g = torch.empty(c, bw, v, device=x.device, dtype=x.dtype)      # g, then v2
    x2 = torch.empty(c, bw, v, device=x.device, dtype=torch.float32)
    HYENA_CHUNKED_FWD(ptr(x), ptr(ln_scale), ptr(ln_bias), ptr(w_in), ptr(b_in), ptr(ws),
                      ptr(bs), ptr(m), ptr(w_out), ptr(b_out), ptr(out), ptr(g), ptr(x2),
                      bw, v, c, ws.shape[0], chunk, int(ln_scale is not None),
                      int(x.dtype == torch.bfloat16), stream_handle(x.device))
    return out


def hyena_chunked_bwd_streams(do, x, w_in, b_in, ws, bs, m, w_out, b_out,
                              ln_scale=None, ln_bias=None):
    """The K3 backward kernel on CUDA: (dx, dw_in, db_in, dws, dbs, dw_out,
    db_out [, d ln_scale, d ln_bias]) and the streams (gs, dvl), each
    (C, BW, V) in x.dtype, from which :func:`hyena_dm` makes dM. The
    weights, taps and Toeplitz blocks go to the kernels as they are."""
    bw, v, c, chunk = _check_chunked(x, w_in, b_in, ws, bs, m, w_out, b_out, ln_scale, ln_bias)
    k = ws.shape[0]
    has_ln = ln_scale is not None
    check_cuda_operand("do", do, x.device, x.dtype, (bw, v, c))
    layout, size = slot_layout([("dws", k * 3 * c), ("dbin", 3 * c), ("dbs", 3 * c),
                                ("dbo", c), ("dg", c), ("dbln", c)])
    slots = torch.empty(slot_count(size, x.device), size, device=x.device, dtype=torch.float32)
    red = torch.empty(size, device=x.device, dtype=torch.float32)
    is_bf16 = int(x.dtype == torch.bfloat16)
    nbytes = HYENA_CHUNKED_BWD.query("lcbi_hyena_chunked_bwd_workspace", [ctypes.c_int] * 5,
                                     ctypes.c_size_t, bw, v, c, int(has_ln), is_bf16)
    if nbytes == 0:
        raise RuntimeError("lcbi_hyena_chunked_bwd_workspace: device query failed")
    work = torch.empty(nbytes, device=x.device, dtype=torch.uint8)
    wgrads = torch.empty(4 * c * c, device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    gs, dvl = (torch.empty(c, bw, v, device=x.device, dtype=x.dtype) for _ in range(2))
    HYENA_CHUNKED_BWD(ptr(x), ptr(ln_scale), ptr(ln_bias), ptr(w_in), ptr(b_in), ptr(ws),
                      ptr(bs), ptr(m), ptr(w_out), ptr(do), ptr(dx), ptr(gs), ptr(dvl),
                      ptr(work), ptr(wgrads), ptr(slots), ptr(red),
                      bw, v, c, k, chunk, int(has_ln), is_bf16, slots.shape[0], size,
                      *(layout[n] for n in ("dbin", "dbs", "dbo", "dg", "dbln")),
                      stream_handle(x.device))
    return (dx, *_chunked_bwd_grads(red, layout, wgrads, c, k, x.dtype, has_ln)), (gs, dvl)


def hyena_dm(gs, dvl, chunk: int):
    """dM of K3 (:func:`hyena_dm_plain`), (n, C, chunk, chunk) fp32, from the
    backward's streams: the K3 dM kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if not gs.is_cuda:
        return hyena_dm_plain(gs, dvl, chunk)
    c, bw, v = gs.shape
    if gs.dtype not in (torch.float32, torch.bfloat16) or v % chunk or chunk not in (64, 128):
        raise ValueError(f"dM kernel takes fp32 or bf16 streams with V % chunk == 0 and "
                         f"chunk 64 or 128; got {gs.dtype}, V={v}, chunk={chunk}")
    check_cuda_operand("gs", gs, gs.device, gs.dtype, (c, bw, v))
    check_cuda_operand("dvl", dvl, gs.device, gs.dtype, (c, bw, v))
    n = v // chunk
    sms = torch.cuda.get_device_properties(gs.device).multi_processor_count
    # output tiles of a (d, c) block: one 128-wide tile in bf16, 64-wide ones in fp32
    tiles = 1 if gs.dtype == torch.bfloat16 else (chunk // 64) ** 2
    splits = max(1, min(bw, 65535, -(-4 * sms // (n * c * tiles))))
    partials = torch.empty(splits, n, c, chunk, chunk, device=gs.device, dtype=torch.float32)
    dm = torch.empty(n, c, chunk, chunk, device=gs.device, dtype=torch.float32)
    HYENA_DM(ptr(gs), ptr(dvl), ptr(partials), ptr(dm), bw, v, c, chunk, splits,
             int(gs.dtype == torch.bfloat16), stream_handle(gs.device))
    return dm


def hyena_chunked_bwd(do, x, w_in, b_in, ws, bs, m, w_out, b_out, ln_scale=None, ln_bias=None):
    """The K3 backward on CUDA (backward kernel, then the dM kernel): the
    gradients of :func:`hyena_chunked_bwd_plain`, in the same order and
    dtypes."""
    grads, (gs, dvl) = hyena_chunked_bwd_streams(do, x, w_in, b_in, ws, bs, m, w_out, b_out,
                                                 ln_scale, ln_bias)
    dm = hyena_dm(gs, dvl, m.shape[-1]).to(m.dtype)
    return grads[:5] + (dm,) + grads[5:]


class _HyenaChunkedMixer(torch.autograd.Function):
    """The K3 mixer on prepared short taps and Toeplitz blocks. The forward
    saves only its inputs; the backward recomputes the forward, in the
    kernels on CUDA and through the plain VJP on the CPU."""

    @staticmethod
    def forward(ctx, x, w_in, b_in, ws, bs, m, w_out, b_out, ln_scale, ln_bias):
        ctx.save_for_backward(x, w_in, b_in, ws, bs, m, w_out, b_out, ln_scale, ln_bias)
        if x.is_cuda:
            return hyena_chunked_fwd(x, w_in, b_in, ws, bs, m, w_out, b_out, ln_scale, ln_bias)
        return hyena_chunked_plain(x, w_in, b_in, ws, bs, m, w_out, b_out, ln_scale, ln_bias)

    @staticmethod
    def backward(ctx, do):
        inputs = ctx.saved_tensors
        if do.is_cuda:
            grads = hyena_chunked_bwd(do.contiguous(), *inputs)
        else:
            grads = hyena_chunked_bwd_plain(do, *inputs)
        return tuple(grads) + (None,) * (10 - len(grads))


def hyena_window_mixer(x, w_in, b_in, w_short, b_short, k_long, b_long,
                       w_out, b_out, ln_scale=None, ln_bias=None):
    """Fused Hyena window mixer, optionally x + mixer(LN(x)).

    x: (BW, V, C) windowed tokens, fp32 or bf16: K1 at V <= 64, K3 at
    64 < V <= 512 with V % 64 == 0 and C <= 192; any other window raises
    ValueError (the caller runs the composed path).
    w_in: (C, 3C) in_proj kernel with head-major [x1 | x2 | v] column blocks;
    b_in: (3C,). w_short: (3C, K) short depthwise causal filter; b_short:
    (3C,). k_long: (C, V) implicit long filter; b_long: (C,) skip weight.
    w_out: (C, C); b_out: (C,). ln_scale/ln_bias: optional (C,) pre-LN
    params; when given the result is x + mixer(LN(x)).
    Projection weights are in x.dtype. Returns (BW, V, C) in x.dtype,
    differentiable in every argument. A CUDA tensor goes through the forward
    and backward kernels (or raises); a CPU tensor through the plain
    versions. The taps are prepared (:func:`prepare_taps`) and the biases and
    LN parameters cast to fp32 here, outside the kernels' autograd Function,
    so autograd carries those transforms' own transposes; so is K3's Toeplitz
    build, in x.dtype."""
    if x.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"no Hyena window mixer for device {x.device}")
    _, v, c = x.shape
    if v > HYENA_WINDOW_MAX_LEN and not hyena_window_supported(v, c):
        raise ValueError(f"no fused Hyena mixer for windows of {v} tokens at {c} channels; "
                         "models/hyena.py runs those on the composed path")
    ws, kl = prepare_taps(w_short, k_long, b_long)
    ln = (ln_scale.float(), ln_bias.float()) if ln_scale is not None else (None, None)
    if v <= HYENA_WINDOW_MAX_LEN:
        return _HyenaWindowMixer.apply(x, w_in, b_in.float(), ws, b_short.float(), kl, w_out,
                                       b_out.float(), *ln)
    m = build_chunk_toeplitz(kl, pick_chunk(v)).to(x.dtype)
    return _HyenaChunkedMixer.apply(x, w_in, b_in.float(), ws, b_short.float(), m, w_out,
                                    b_out.float(), *ln)
