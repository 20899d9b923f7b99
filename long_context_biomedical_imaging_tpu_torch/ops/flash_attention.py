"""Flash attention (K5): non-causal softmax attention on (BH, L, D) without
an (L, L) tensor, forward and backward.

Counterpart of ``long_context_biomedical_imaging_tpu/ops/flash_attention.py``
(``flash_attention`` and its custom VJP). On a CUDA tensor the wrapper
launches ``csrc/flash_attention.cu`` (forward: output and the base-2
log-sum-exp of each row) and, for the gradient, ``csrc/flash_attention_dq.cu``
(dq, a block per query tile) and ``csrc/flash_attention_dkv.cu`` (dk and dv, a
block per key tile), with delta = rowsum(do * o) taken by torch ops between
them as the JAX package takes it outside its kernels. On a CPU tensor it runs
:func:`flash_attention_plain` and the VJP of that,
:func:`flash_attention_bwd_plain`. The TPU kernel's single-sweep backward is a
VMEM-budget variant of the same gradients and is covered by the two kernels.

Precision, shared by the kernels and the plain version and taken from the
TPU kernel: the softmax runs in base 2, with scale * log2(e) folded into q,
which is rounded to k's dtype before q k^T; scores, softmax statistics and
sums are fp32; the probabilities are rounded to v's dtype before p v; the
backward rounds ds to k's dtype for dq and to q's for dk, contracts dk against
the unscaled q and applies the scale once at the end. The kernels take any
head dim D, as the TPU kernel does: up to 256 their tiles are set by the
least of 16, 32, 64, 128, 256 that holds D (the columns past D loading as
zeros); above it they walk D in 64-column chunks, summing the scores over
the chunks and writing the outputs a chunk at a time
(``csrc/flash_attention.cuh``). fp32 or bf16, contiguous tensors on the
card. Up to D = 256, bf16 runs on the tensor cores with register-resident
fragments and fp32 on the CUDA cores in full fp32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .cuda_build import CudaKernel, check_cuda_operand, ptr, stream_handle

LOG2E = math.log2(math.e)

FLASH_FWD = CudaKernel(
    "flash_attention.cu", "lcbi_flash_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
FLASH_BWD_DQ = CudaKernel(
    "flash_attention_dq.cu", "lcbi_flash_bwd_dq",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
    + [ctypes.c_int, ctypes.c_void_p])
FLASH_BWD_DKV = CudaKernel(
    "flash_attention_dkv.cu", "lcbi_flash_bwd_dkv",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
    + [ctypes.c_int, ctypes.c_void_p])


def flash_attention_plain(q, k, v, scale: float):
    """Block-free attention in the kernels' precision (module doc). q, k, v:
    (BH, L, D) of one dtype. Returns (o in q.dtype, lse (BH, L) fp32, the
    base-2 log-sum-exp of each row's scaled scores)."""
    qs = (q.float() * (scale * LOG2E)).to(k.dtype)
    s = qs.float() @ k.float().transpose(-1, -2)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(v.dtype).float() @ v.float()) / l
    return o.to(q.dtype), (m + torch.log2(l)).squeeze(-1)


def flash_attention_bwd_plain(do, q, k, v, scale: float):
    """(dq, dk, dv) of :func:`flash_attention_plain`'s output for the
    cotangent ``do``, by ``torch.func.vjp``, each in its input's dtype:
    autograd of the plain forward, independent of the kernels' formulas."""
    _, vjp = torch.func.vjp(lambda a, b, c: flash_attention_plain(a, b, c, scale)[0], q, k, v)
    return vjp(do)


def _check_operands(q, k, v):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention kernel takes fp32 or bf16, got {q.dtype}")
    if not q.is_cuda:
        raise ValueError(f"flash attention kernel takes CUDA tensors, got {q.device}")
    if q.dim() != 3:
        raise ValueError(f"flash attention kernel takes (BH, L, D), got {tuple(q.shape)}")
    bh, l, d = q.shape
    if d == 0 or not 0 < bh < 65536 or l == 0 or q.numel() >= 2**31:
        raise ValueError(f"flash attention kernel needs D > 0, 0 < BH < 65536, L > 0 and "
                         f"BH*L*D < 2^31; got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_operand(name, t, q.device, q.dtype, (bh, l, d))
    return bh, l, d


def flash_attention_fwd(q, k, v, scale: float):
    """The K5 forward kernel on CUDA: (o, lse) of :func:`flash_attention_plain`."""
    bh, l, d = _check_operands(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(bh, l, device=q.device, dtype=torch.float32)
    FLASH_FWD(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), bh, l, d, scale * LOG2E,
              int(q.dtype == torch.bfloat16), stream_handle(q.device))
    return o, lse


def _check_bwd_operands(do, q, k, v, lse, delta):
    bh, l, d = _check_operands(q, k, v)
    check_cuda_operand("do", do, q.device, q.dtype, (bh, l, d))
    check_cuda_operand("lse", lse, q.device, torch.float32, (bh, l))
    check_cuda_operand("delta", delta, q.device, torch.float32, (bh, l))
    return bh, l, d


def flash_attention_dq(do, q, k, v, lse, delta, scale: float):
    """The K5 dq kernel on CUDA, from the forward's lse and delta =
    rowsum(do * o) in fp32: dq of :func:`flash_attention_bwd_plain`."""
    bh, l, d = _check_bwd_operands(do, q, k, v, lse, delta)
    dq = torch.empty_like(q)
    FLASH_BWD_DQ(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq), bh, l,
                 d, scale * LOG2E, scale, int(q.dtype == torch.bfloat16),
                 stream_handle(q.device))
    return dq


def flash_attention_dkv(do, q, k, v, lse, delta, scale: float):
    """The K5 dk/dv kernel on CUDA, from the forward's lse and delta =
    rowsum(do * o) in fp32: (dk, dv) of :func:`flash_attention_bwd_plain`."""
    bh, l, d = _check_bwd_operands(do, q, k, v, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    FLASH_BWD_DKV(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dk), ptr(dv), bh,
                  l, d, scale * LOG2E, scale, int(q.dtype == torch.bfloat16),
                  stream_handle(q.device))
    return dk, dv


def flash_attention_bwd(do, q, k, v, o, lse, scale: float):
    """The K5 backward kernels on CUDA, from the forward's o and lse: (dq, dk,
    dv) of :func:`flash_attention_bwd_plain`."""
    check_cuda_operand("o", o, q.device, q.dtype, tuple(q.shape))
    delta = (do.float() * o.float()).sum(dim=-1)
    return (flash_attention_dq(do, q, k, v, lse, delta, scale),
            *flash_attention_dkv(do, q, k, v, lse, delta, scale))


class _FlashAttention(torch.autograd.Function):
    """Attention on (BH, L, D). On CUDA the forward saves o and lse for the
    backward kernels; on the CPU the backward is the plain VJP."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        if q.is_cuda:
            o, lse = flash_attention_fwd(q, k, v, scale)
            ctx.save_for_backward(q, k, v, o, lse)
            return o
        ctx.save_for_backward(q, k, v)
        return flash_attention_plain(q, k, v, scale)[0]

    @staticmethod
    def backward(ctx, do):
        if do.is_cuda:
            grads = flash_attention_bwd(do.contiguous(), *ctx.saved_tensors, ctx.scale)
        else:
            grads = flash_attention_bwd_plain(do, *ctx.saved_tensors, ctx.scale)
        return (*grads, None)


def flash_attention(q, k, v, scale: float | None = None):
    """Multi-head attention through K5. q, k, v: (B, H, L, D) of one dtype
    (fp32 or bf16); scale defaults to D ** -0.5. Returns (B, H, L, D) in
    q.dtype, differentiable in q, k and v. A CUDA tensor goes through the
    forward and backward kernels (or raises); a CPU tensor through the plain
    versions."""
    if q.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"no flash attention for device {q.device}")
    b, h, l, d = q.shape
    if scale is None:
        scale = d ** -0.5
    out = _FlashAttention.apply(*(t.reshape(b * h, l, d).contiguous() for t in (q, k, v)),
                                float(scale))
    return out.reshape(b, h, l, d)
