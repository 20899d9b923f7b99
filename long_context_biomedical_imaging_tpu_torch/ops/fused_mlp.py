"""Fused transformer MLPs: x + MLP(LayerNorm(x)) (K2) and MLP(x) (K2').

Counterpart of ``long_context_biomedical_imaging_tpu/ops/fused_mlp.py``
(``fused_ln_mlp_residual`` and ``fused_mlp``, each with its custom VJP). On
a CUDA tensor the wrappers launch the hand-written kernels
``csrc/fused_mlp.cu`` (forward) and ``csrc/fused_mlp_bwd.cu`` (backward,
which recomputes the hidden from x); K2' is the same kernels with the
LayerNorm and the residual switched off, behind their own C entry points
and launch counters. On a CPU tensor they run
:func:`fused_ln_mlp_residual_plain` / :func:`fused_mlp_plain` and their
vector-Jacobian products.

Precision, shared by kernel and plain version and taken from the TPU kernel:
LayerNorm statistics and everything between the two products in fp32; both
products take operands rounded to ``x.dtype`` (bf16 under AMP) and sum in
fp32; GELU is the tanh form under bf16 and the exact erf form in fp32
(``_gelu`` of the TPU kernel); the output is cast to ``x.dtype`` once, after
the residual add. The backward kernel rounds the operands of its products
(y, h, du, do) to ``x.dtype`` as the TPU kernel does and returns dw1, dw2 in
the weight dtype and the other gradients in fp32.

Widths: the kernels take any C and H, and the weights as they are: the
forward and the backward stage their weight slices through shared memory
with the tails past C and H masked (``csrc/mlp_common.cuh``), so no wrapper
pads or copies a weight. The backward writes the operands of its weight
gradients as streams (y, h, du in ``x.dtype``) and dy in fp32, which the
wrapper allocates (:func:`_bwd_scratch`) and its library contracts in the
same call.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_build import (CudaKernel, check_cuda_operand, ptr, slot_count, slot_layout,
                         stream_handle)

LN_EPS = 1e-6  # flax nn.LayerNorm default, as the TPU kernels

FUSED_LN_MLP_FWD = CudaKernel(
    "fused_mlp.cu", "lcbi_fused_ln_mlp_fwd",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
FUSED_LN_MLP_BWD = CudaKernel(
    "fused_mlp_bwd.cu", "lcbi_fused_ln_mlp_bwd",
    [ctypes.c_void_p] * 13 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
FUSED_MLP_FWD = CudaKernel(
    "fused_mlp.cu", "lcbi_fused_mlp_fwd", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_void_p])
FUSED_MLP_BWD = CudaKernel(
    "fused_mlp_bwd.cu", "lcbi_fused_mlp_bwd",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def layer_norm_f32(x32, scale, bias):
    """LayerNorm over the last axis of an fp32 tensor in the fast-variance
    form E[x^2] - mu^2 (the TPU kernels' _ln_fwd), eps 1e-6."""
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mu * mu
    return (x32 - mu) * torch.rsqrt(var + LN_EPS) * scale.float() + bias.float()


def fast_layernorm(x, scale, bias):
    """LayerNorm over the last axis with fp32 statistics, result in x.dtype."""
    return layer_norm_f32(x.float(), scale, bias).to(x.dtype)


def matmul_rounded(a, b, dtype):
    """a @ b with both operands rounded to ``dtype`` and an fp32 product: the
    kernels' tensor-core precision (exact products, fp32 sums)."""
    return a.to(dtype).float() @ b.to(dtype).float()


def gelu(u, dtype):
    """GELU of an fp32 tensor in the form the kernels use for ``dtype``."""
    return F.gelu(u) if dtype == torch.float32 else F.gelu(u, approximate="tanh")


def fused_ln_mlp_residual_plain(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """x + GELU(LN(x) @ w1 + b1) @ w2 + b2 in plain PyTorch, in the kernel's
    precision. x: (..., C); w1: (C, H); w2: (H, C). Returns x.shape, x.dtype."""
    dt = x.dtype
    c = x.shape[-1]
    x32 = x.reshape(-1, c).float()
    y = layer_norm_f32(x32, ln_scale, ln_bias)
    h = gelu(matmul_rounded(y, w1, dt) + b1.float(), dt)
    out = matmul_rounded(h, w2, dt) + b2.float() + x32
    return out.to(dt).reshape(x.shape)


def fused_ln_mlp_residual_bwd_plain(do, x, ln_scale, ln_bias, w1, b1, w2, b2):
    """The vector-Jacobian product of :func:`fused_ln_mlp_residual_plain` at
    its inputs for the output cotangent ``do``, by ``torch.func.vjp``:
    (dx, d ln_scale, d ln_bias, dw1, db1, dw2, db2), each in its input's
    dtype. Autograd of the composed math, independent of the kernel's
    hand-derived formulas."""
    _, vjp = torch.func.vjp(fused_ln_mlp_residual_plain, x, ln_scale, ln_bias, w1, b1, w2, b2)
    return vjp(do)


def _check_operands(x2, f32, w1, w2):
    n, c = x2.shape
    hidden = w1.shape[-1]
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused LN+MLP kernel takes fp32 or bf16, got {x2.dtype}")
    if n == 0 or c == 0 or hidden == 0 or x2.numel() >= 2**31:
        raise ValueError(f"fused LN+MLP kernel needs 0 < N*C < 2^31 and H > 0; got N={n}, "
                         f"C={c}, H={hidden}")
    dev = x2.device
    check_cuda_operand("x", x2, dev, x2.dtype, (n, c))
    check_cuda_operand("w1", w1, dev, x2.dtype, (c, hidden))
    check_cuda_operand("w2", w2, dev, x2.dtype, (hidden, c))
    for name, t, width in zip(("ln_scale", "ln_bias", "b1", "b2"), f32, (c, c, hidden, c)):
        check_cuda_operand(name, t, dev, torch.float32, (width,))


def _fwd_cuda(x2, g, b, w1, b1, w2, b2):
    _check_operands(x2, (g, b, b1, b2), w1, w2)
    n, c = x2.shape
    out = torch.empty_like(x2)
    FUSED_LN_MLP_FWD(ptr(x2), ptr(g), ptr(b), ptr(w1), ptr(b1), ptr(w2), ptr(b2), ptr(out),
                     n, c, w1.shape[1], int(x2.dtype == torch.bfloat16), stream_handle(x2.device))
    return out


def _bwd_scratch(kernel, x2, hidden, small):
    """The backward's scratch at the true widths: the streams h and du (N,
    H) in x.dtype, dy (N, C) fp32, the split-K partials of [dw1 | dw2] (as
    many splits as the library asks for) and their sum, and the slots of the
    small gradients ``small`` ((name, floats) pairs) with their sum."""
    n, c = x2.shape
    dev, dt = x2.device, x2.dtype
    splits = kernel.query("lcbi_fused_mlp_wgrad_splits", [ctypes.c_longlong] + [ctypes.c_int] * 3,
                          ctypes.c_int, n, c, hidden, int(dt == torch.bfloat16))
    if splits < 1:
        raise RuntimeError("lcbi_fused_mlp_wgrad_splits: device query failed")
    layout, size = slot_layout(small)
    f32 = dict(device=dev, dtype=torch.float32)
    return dict(hs=torch.empty(n, hidden, device=dev, dtype=dt),
                dus=torch.empty(n, hidden, device=dev, dtype=dt), dy=torch.empty(n, c, **f32),
                splits=splits, partials=torch.empty(splits, 2 * c * hidden, **f32),
                wgrads=torch.empty(2 * c * hidden, **f32), layout=layout, size=size,
                slots=torch.empty(slot_count(size, dev), size, **f32), red=torch.empty(size, **f32))


def _bwd_grads(s, c, hidden, leading=(), w_dtype=torch.float32):
    """The gradients in a backward's scratch ``s``: those named in
    ``leading`` (each (C,) fp32), then dw1 and dw2 in w_dtype, db1 and db2 in
    fp32."""
    red, layout, wg = s["red"], s["layout"], s["wgrads"]

    def small(name, width):
        return red[layout[name]:layout[name] + width]

    return (*(small(name, c) for name in leading), wg[:c * hidden].view(c, hidden).to(w_dtype),
            small("db1", hidden), wg[c * hidden:].view(hidden, c).to(w_dtype), small("db2", c))


def fused_ln_mlp_residual_bwd(do, x2, g, b, w1, b1, w2, b2):
    """The backward kernel on CUDA (x2: (N, C); g, b, b1, b2 fp32), at the
    true widths (no padded copies): the gradients of
    :func:`fused_ln_mlp_residual_bwd_plain`, in the same order and dtypes."""
    _check_operands(x2, (g, b, b1, b2), w1, w2)
    n, c = x2.shape
    hidden = w1.shape[1]
    check_cuda_operand("do", do, x2.device, x2.dtype, (n, c))
    s = _bwd_scratch(FUSED_LN_MLP_BWD, x2, hidden,
                     [("db1", hidden), ("db2", c), ("dg", c), ("dbln", c)])
    ys = torch.empty_like(x2)
    dx = torch.empty_like(x2)
    FUSED_LN_MLP_BWD(*(ptr(t) for t in (x2, g, b, w1, b1, w2, do, dx, ys, s["hs"], s["dus"],
                                        s["dy"], s["partials"])),
                     s["splits"], ptr(s["wgrads"]), ptr(s["slots"]), ptr(s["red"]), n, c, hidden,
                     int(x2.dtype == torch.bfloat16), s["slots"].shape[0], s["size"],
                     *(s["layout"][k] for k in ("db1", "db2", "dg", "dbln")),
                     stream_handle(x2.device))
    return (dx, *_bwd_grads(s, c, hidden, ("dg", "dbln"), w1.dtype))


class _FusedLnMlpResidual(torch.autograd.Function):
    """x + MLP(LN(x)) on (N, C) rows with fp32 LN parameters and biases. The
    forward saves only its inputs; the backward recomputes the hidden, in the
    kernel on CUDA and through the plain VJP on the CPU."""

    @staticmethod
    def forward(ctx, x2, g, b, w1, b1, w2, b2):
        ctx.save_for_backward(x2, g, b, w1, b1, w2, b2)
        if x2.is_cuda:
            return _fwd_cuda(x2, g, b, w1, b1, w2, b2)
        return fused_ln_mlp_residual_plain(x2, g, b, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, do):
        inputs = ctx.saved_tensors
        if do.is_cuda:
            return fused_ln_mlp_residual_bwd(do.contiguous(), *inputs)
        return fused_ln_mlp_residual_bwd_plain(do, *inputs)


def fused_ln_mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """x + MLP(LayerNorm(x)): the pre-LN transformer second half in one kernel.

    x: (..., C) fp32 or bf16; ln_scale, ln_bias, b2: (C,); w1: (C, H) and
    w2: (H, C) in x.dtype; b1: (H,). Returns x.shape in x.dtype,
    differentiable in every argument. A CUDA tensor goes through the forward
    and backward kernels (or raises); a CPU tensor through the plain versions.
    The LN parameters and biases enter the kernels as fp32, cast here."""
    if x.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"no fused LN+MLP for device {x.device}")
    c = x.shape[-1]
    out = _FusedLnMlpResidual.apply(x.reshape(-1, c), ln_scale.float(), ln_bias.float(),
                                    w1, b1.float(), w2, b2.float())
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# K2': the MLP without LayerNorm or residual (the JAX package's MLPBlock path)
# ---------------------------------------------------------------------------

def fused_mlp_plain(x, w1, b1, w2, b2):
    """GELU(x @ w1 + b1) @ w2 + b2 in plain PyTorch, in K2''s precision: both
    products take operands rounded to x.dtype and sum in fp32, the biases add
    in fp32, GELU in the form of x.dtype (tanh for bf16, erf for fp32), the
    output rounded once. x: (..., C); w1: (C, H); w2: (H, C)."""
    dt = x.dtype
    c = x.shape[-1]
    h = gelu(matmul_rounded(x.reshape(-1, c), w1, dt) + b1.float(), dt)
    out = matmul_rounded(h, w2, dt) + b2.float()
    return out.to(dt).reshape(x.shape)


def fused_mlp_bwd_plain(do, x, w1, b1, w2, b2):
    """The vector-Jacobian product of :func:`fused_mlp_plain` for ``do``, by
    ``torch.func.vjp``: (dx, dw1, db1, dw2, db2), each in its input's dtype."""
    _, vjp = torch.func.vjp(fused_mlp_plain, x, w1, b1, w2, b2)
    return vjp(do)


def _check_mlp_operands(x2, w1, b1, w2, b2):
    n, c = x2.shape
    hidden = w1.shape[-1]
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused MLP kernel takes fp32 or bf16, got {x2.dtype}")
    if n == 0 or c == 0 or hidden == 0 or x2.numel() >= 2**31:
        raise ValueError(f"fused MLP kernel needs 0 < N*C < 2^31 and H > 0; got N={n}, C={c}, "
                         f"H={hidden}")
    if not x2.is_cuda:
        raise ValueError(f"fused MLP kernels take CUDA tensors, got x on {x2.device}")
    dev = x2.device
    check_cuda_operand("x", x2, dev, x2.dtype, (n, c))
    check_cuda_operand("w1", w1, dev, x2.dtype, (c, hidden))
    check_cuda_operand("w2", w2, dev, x2.dtype, (hidden, c))
    check_cuda_operand("b1", b1, dev, torch.float32, (hidden,))
    check_cuda_operand("b2", b2, dev, torch.float32, (c,))


def fused_mlp_fwd(x2, w1, b1, w2, b2):
    """The K2' forward kernel on CUDA: x2 (N, C) and w1, w2 in x2.dtype at
    the true widths, b1, b2 fp32; the output of :func:`fused_mlp_plain`."""
    _check_mlp_operands(x2, w1, b1, w2, b2)
    n, c = x2.shape
    out = torch.empty_like(x2)
    FUSED_MLP_FWD(ptr(x2), ptr(w1), ptr(b1), ptr(w2), ptr(b2), ptr(out), n, c, w1.shape[1],
                  int(x2.dtype == torch.bfloat16), stream_handle(x2.device))
    return out


def fused_mlp_bwd(do, x2, w1, b1, w2, b2):
    """The K2' backward kernel on CUDA (operands as :func:`fused_mlp_fwd`,
    at the true widths): (dx in x2.dtype, dw1, db1, dw2, db2 in fp32),
    summed over the rows in K2's fixed order."""
    _check_mlp_operands(x2, w1, b1, w2, b2)
    n, c = x2.shape
    hidden = w1.shape[1]
    check_cuda_operand("do", do, x2.device, x2.dtype, (n, c))
    s = _bwd_scratch(FUSED_MLP_BWD, x2, hidden, [("db1", hidden), ("db2", c)])
    dx = torch.empty_like(x2)
    FUSED_MLP_BWD(*(ptr(t) for t in (x2, w1, b1, w2, do, dx, s["hs"], s["dus"], s["dy"],
                                     s["partials"])),
                  s["splits"], ptr(s["wgrads"]), ptr(s["slots"]), ptr(s["red"]), n, c, hidden,
                  int(x2.dtype == torch.bfloat16), s["slots"].shape[0], s["size"],
                  s["layout"]["db1"], s["layout"]["db2"], stream_handle(x2.device))
    return (dx, *_bwd_grads(s, c, hidden))


class _FusedMlp(torch.autograd.Function):
    """MLP(x) on (N, C) rows with fp32 biases and weights of any float dtype
    (rounded to x.dtype for the kernels, their gradients returned in their
    own dtype, as the JAX package's). The forward saves only its inputs; the
    backward recomputes the hidden, in the kernel on CUDA and through the
    plain VJP on the CPU."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2):
        ctx.save_for_backward(x2, w1, b1, w2, b2)
        if x2.is_cuda:
            return fused_mlp_fwd(x2, w1.to(x2.dtype).contiguous(), b1, w2.to(x2.dtype)
                                 .contiguous(), b2)
        return fused_mlp_plain(x2, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, do):
        x2, w1, b1, w2, b2 = ctx.saved_tensors
        if not do.is_cuda:
            return fused_mlp_bwd_plain(do, x2, w1, b1, w2, b2)
        dx, dw1, db1, dw2, db2 = fused_mlp_bwd(do.contiguous(), x2, w1.to(x2.dtype).contiguous(),
                                               b1, w2.to(x2.dtype).contiguous(), b2)
        return dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2


def fused_mlp(x, w1, b1, w2, b2):
    """GELU(x @ w1 + b1) @ w2 + b2 with the hidden kept on chip (K2').

    x: (..., C) fp32 or bf16; w1: (C, H); b1: (H,); w2: (H, C); b2: (C,).
    Returns x.shape in x.dtype, differentiable in every argument. A CUDA
    tensor goes through the K2' kernels (or raises); a CPU tensor through
    the plain versions. The biases enter as fp32, cast here."""
    if x.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"no fused MLP for device {x.device}")
    c = x.shape[-1]
    out = _FusedMlp.apply(x.reshape(-1, c).contiguous(), w1, b1.float(), w2, b2.float())
    return out.reshape(x.shape)
