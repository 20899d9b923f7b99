"""Fused MambaVision window mixer (K4): the whole MambaVisionMixer body on
windows of 16 to 64 tokens, optionally with the caller's pre-LayerNorm and
residual folded in.

Counterpart of ``long_context_biomedical_imaging_tpu/ops/mamba_window.py``
(``mamba_window_mixer`` and its custom VJPs). Per window of V tokens:

    xz = in_proj([LN](x));  s = SiLU(conv3_same(xz));  x | z = s
    dt | B | C = x_proj(x);  delta = softplus(dt_proj(dt) + 2 * dt_bias)
    h[t] = exp(delta[t] A) h[t-1] + delta[t] x[t] B[t];  y[t] = C[t] . h[t] + D x[t]
    out = [x +] out_proj([y | z])

On a CUDA tensor the wrapper launches ``csrc/mamba_window.cu`` (forward) and
``csrc/mamba_window_bwd.cu`` (backward, which recomputes the forward); on a
CPU tensor it runs :func:`mamba_window_plain`, the same chain in plain
PyTorch, and its vector-Jacobian product :func:`mamba_window_bwd_plain`.

Both take prepared operands, made by :func:`mamba_window_mixer` as the JAX
wrapper makes them, in fp32: the conv taps ``cat([wx, wz]).T`` (3, C), where
tap j applies to token t - 1 + j; ``A^T`` (N, C/2); ``2 * dt_bias`` and ``D``.
The factor 2 stays outside the autograd Function, so autograd carries it.

Precision, shared by kernels and plain version: LayerNorm, the convolution,
SiLU, softplus, the scan and the D skip in fp32; the four products (in_proj,
x_proj, dt_proj, out_proj) take operands rounded to ``x.dtype`` (bf16 under
AMP) and sum in fp32; the output is cast to ``x.dtype`` once, after the
residual add. The TPU kernel also rounds the scan's B and C to bf16 under AMP
(its 0/1 expander products); that rounding is a TPU layout device and is not
copied. The backward rounds its products' operands where the TPU kernel does
and returns the projection weights' gradients in their dtype, the rest in fp32.

The kernels take every window length of the gate (:func:`mamba_window_supported`)
at any even C, a dt rank up to 64 and a d_state N up to 16 (run at a padded
state count of 8 or 16, the padded states read as zeros; a larger N raises),
and every operand at its true C and N: the rows load at the true C
(LayerNorm statistics over C) and only the true columns are stored, and the
kernels stage their weight slices through shared memory with the tails
masked (the forward's general kernel, for fp32 and bf16 tiles too wide for
its bf16 kernel, reads them at their true widths in FMA loops), so no
operand is ever padded. Each kernel sizes its global scratch itself (the
general forward's tile moves there, wholly or in part, where it outgrows
shared memory; the backward's passes hand each other streams); the wrappers
ask the library (``lcbi_mamba_window_{fwd,bwd}_workspace``) and allocate it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .cuda_build import (CudaKernel, check_cuda_operand, ptr, slot_count, slot_layout,
                         stream_handle)
from .fused_mlp import layer_norm_f32, matmul_rounded
from .selective_scan import selective_scan_cm

MAMBA_WINDOW_MAX_LEN = 64
MAMBA_MAX_STATE = 16            # the largest d_state the kernels take

MAMBA_WINDOW_FWD = CudaKernel(
    "mamba_window.cu", "lcbi_mamba_window_fwd",
    [ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p])
MAMBA_WINDOW_BWD = CudaKernel(
    "mamba_window_bwd.cu", "lcbi_mamba_window_bwd",
    [ctypes.c_void_p] * 14 + [ctypes.c_longlong] + [ctypes.c_void_p] + [ctypes.c_int]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 6
    + [ctypes.c_void_p])


def mamba_window_supported(v: int) -> bool:
    """Whether the fused kernel takes windows of v tokens: 16 <= v <= 64 and
    v % 8 == 0 (the JAX package's gate)."""
    return 16 <= v <= MAMBA_WINDOW_MAX_LEN and v % 8 == 0


def same_conv3(xz, taps):
    """K=3 depthwise 'same' conv over the token axis of (B, V, C), zero
    padded at the window's edges: y[t] = sum_j taps[j] * xz[t - 1 + j].
    taps: (3, C)."""
    y = xz * taps[1]
    y = y + torch.nn.functional.pad(xz[:, :-1], (0, 0, 1, 0)) * taps[0]
    return y + torch.nn.functional.pad(xz[:, 1:], (0, 0, 0, 1)) * taps[2]


def prepare_operands(w_conv_x, w_conv_z, dt_bias, A, D):
    """The kernels' fp32 operands, as differentiable tensor ops: conv taps
    (3, C), 2 * dt_bias, A^T (N, C/2) and D."""
    wconv = torch.cat([w_conv_x, w_conv_z]).float().t().contiguous()
    return wconv, 2.0 * dt_bias.float(), A.float().t().contiguous(), D.float()


def mamba_window_plain(x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out,
                       ln_scale=None, ln_bias=None):
    """The mixer in plain PyTorch, in the kernels' precision (module doc), on
    prepared operands (:func:`prepare_operands`). x: (BW, V, C); w_xz,
    w_out: (C, C); w_dbl: (C/2, R + 2N); w_dt: (R, C/2); projection weights
    in x.dtype. Returns (BW, V, C) in x.dtype."""
    bw, v, c = x.shape
    dh, n, r = c // 2, at.shape[0], w_dt.shape[0]
    dt = x.dtype
    x32 = x.float()
    y = x32 if ln_scale is None else layer_norm_f32(x32, ln_scale, ln_bias)
    xz = matmul_rounded(y.reshape(bw * v, c), w_xz, dt).reshape(bw, v, c)
    u = same_conv3(xz, wconv.float())
    s = u * torch.sigmoid(u)
    xs, z = s[..., :dh], s[..., dh:]
    dbl = matmul_rounded(xs.reshape(bw * v, dh), w_dbl, dt).reshape(bw, v, -1)
    dtv = (matmul_rounded(dbl[..., :r].reshape(bw * v, r), w_dt, dt).reshape(bw, v, dh)
           + dtb2.float())
    ys = selective_scan_cm(xs, dtv, at.t(), dbl[..., r:r + n], dbl[..., r + n:], dskip)
    out = matmul_rounded(torch.cat([ys, z], dim=-1).reshape(bw * v, c), w_out,
                         dt).reshape(bw, v, c)
    if ln_scale is not None:
        out = out + x32
    return out.to(dt)


def mamba_window_bwd_plain(do, x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out,
                           ln_scale=None, ln_bias=None):
    """The vector-Jacobian product of :func:`mamba_window_plain` for the
    output cotangent ``do``, by ``torch.func.vjp``: (dx, dw_xz, dwconv,
    dw_dbl, dw_dt, d dtb2, d at, d dskip, dw_out [, d ln_scale, d ln_bias]),
    each in its input's dtype. Autograd of the plain chain, independent of
    the kernel's hand-derived formulas."""
    args = [x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out]
    if ln_scale is not None:
        args += [ln_scale, ln_bias]
    _, vjp = torch.func.vjp(mamba_window_plain, *args)
    return vjp(do)


def _check_operands(x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out, ln_scale, ln_bias):
    bw, v, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"Mamba window kernel takes fp32 or bf16, got {x.dtype}")
    if not mamba_window_supported(v) or bw == 0 or c == 0 or c % 2 or x.numel() >= 2**31:
        raise ValueError(f"Mamba window kernel needs 16 <= V <= 64, V % 8 == 0, an even C "
                         f"and 0 < BW*V*C < 2^31; got BW={bw}, V={v}, C={c}")
    n = at.shape[0]
    if not 1 <= n <= MAMBA_MAX_STATE:
        raise ValueError(f"Mamba window kernel takes a d_state of 1 to {MAMBA_MAX_STATE}, got "
                         f"{n} (a wider state is ROADMAP.md queue 2, 'Still to port')")
    dh, r = c // 2, w_dt.shape[0]
    if not 1 <= r <= 64:
        raise ValueError(f"Mamba window kernel takes a dt rank of 1 to 64, got {r}")
    dev = x.device
    check_cuda_operand("x", x, dev, x.dtype, (bw, v, c))
    check_cuda_operand("w_xz", w_xz, dev, x.dtype, (c, c))
    check_cuda_operand("w_out", w_out, dev, x.dtype, (c, c))
    check_cuda_operand("w_dbl", w_dbl, dev, x.dtype, (dh, r + 2 * n))
    check_cuda_operand("w_dt", w_dt, dev, x.dtype, (r, dh))
    check_cuda_operand("wconv", wconv, dev, torch.float32, (3, c))
    check_cuda_operand("at", at, dev, torch.float32, (n, dh))
    check_cuda_operand("dtb2", dtb2, dev, torch.float32, (dh,))
    check_cuda_operand("dskip", dskip, dev, torch.float32, (dh,))
    if ln_scale is not None:
        check_cuda_operand("ln_scale", ln_scale, dev, torch.float32, (c,))
        check_cuda_operand("ln_bias", ln_bias, dev, torch.float32, (c,))
    return bw, v, c, r, n


def _workspace_bytes(kernel, symbol, *shape) -> int:
    """Global scratch the kernel needs, from its library's own query (the
    layout lives in the CUDA source alone); raises where it cannot take the
    shape."""
    n = kernel.query(symbol, [ctypes.c_int] * len(shape), ctypes.c_longlong, *shape)
    if n < 0:
        raise ValueError(f"{symbol}: the Mamba window kernel cannot take (V, C, R, N, bf16) = "
                         f"{shape[-5:]}")
    return n


def mamba_window_fwd(x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out,
                     ln_scale=None, ln_bias=None):
    """The K4 forward kernel on CUDA, on prepared operands at the true C and
    d_state (no padded copies): the output of :func:`mamba_window_plain`."""
    bw, v, c, r, n = _check_operands(x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out,
                                     ln_scale, ln_bias)
    bf16 = int(x.dtype == torch.bfloat16)
    nbytes = _workspace_bytes(MAMBA_WINDOW_FWD, "lcbi_mamba_window_fwd_workspace",
                              bw, v, c, r, n, bf16)
    work = torch.empty(nbytes // 4, device=x.device, dtype=torch.float32) if nbytes else None
    out = torch.empty_like(x)
    MAMBA_WINDOW_FWD(ptr(x), ptr(ln_scale), ptr(ln_bias), ptr(w_xz), ptr(wconv), ptr(w_dbl),
                     ptr(w_dt), ptr(dtb2), ptr(at), ptr(dskip), ptr(w_out), ptr(out), ptr(work),
                     nbytes, bw, v, c, r, n, int(ln_scale is not None), bf16,
                     stream_handle(x.device))
    return out


def mamba_window_bwd(do, x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out,
                     ln_scale=None, ln_bias=None):
    """The K4 backward kernel on CUDA, on prepared operands at the true C (no
    padded copies): the gradients of :func:`mamba_window_bwd_plain`, in the
    same order and dtypes. Its library sizes the workspace of its passes'
    streams and split-K partials and the number of splits."""
    bw, v, c, r, n = _check_operands(x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out,
                                     ln_scale, ln_bias)
    dev = x.device
    check_cuda_operand("do", do, dev, x.dtype, (bw, v, c))
    dh, w, has_ln = c // 2, r + 2 * n, ln_scale is not None
    bf16 = int(x.dtype == torch.bfloat16)
    splits = ctypes.c_int(0)
    nbytes = MAMBA_WINDOW_BWD.query(
        "lcbi_mamba_window_bwd_workspace", [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)],
        ctypes.c_longlong, bw, v, c, r, n, int(has_ln), bf16, ctypes.byref(splits))
    if nbytes < 0:
        raise ValueError(f"lcbi_mamba_window_bwd_workspace: the Mamba window kernel cannot take "
                         f"(BW, V, C, R, N) = {(bw, v, c, r, n)}")
    layout, size = slot_layout([("dwconv", 3 * c), ("ddtb", dh), ("dat", n * dh), ("dd", dh),
                                ("dg", c), ("dbln", c)])
    f32 = dict(device=dev, dtype=torch.float32)
    slots = torch.empty(slot_count(size, dev), size, **f32)
    red = torch.empty(size, **f32)
    work = torch.empty(nbytes, device=dev, dtype=torch.uint8)
    wgrads = torch.empty(2 * c * c + r * dh + dh * w, **f32)
    dx = torch.empty_like(x)
    MAMBA_WINDOW_BWD(*(ptr(t) for t in (x, ln_scale, ln_bias, w_xz, wconv, w_dbl, w_dt, dtb2, at,
                                        dskip, w_out, do, dx, work)),
                     nbytes, ptr(wgrads), splits.value, ptr(slots), ptr(red), bw, v, c, r, n,
                     int(has_ln), bf16, slots.shape[0], size,
                     *(layout[k] for k in ("dwconv", "ddtb", "dat", "dd", "dg", "dbln")),
                     stream_handle(dev))

    return (dx, *_bwd_grads(red, layout, wgrads, c, r, n, x.dtype, has_ln))


def _bwd_grads(red, layout, wgrads, c, r, n, w_dtype, has_ln):
    """K4's backward gradients at the true C and d_state: dw_xz, dwconv,
    dw_dbl, dw_dt, d dtb2, d at, d dskip, dw_out (and the LN parameters'),
    the projections' from the split-K product's [dw_xz | dw_out | dw_dt |
    dw_dbl] in w_dtype, the rest from the reduced slot ``red`` (offsets
    ``layout``) in fp32."""
    dh, w = c // 2, r + 2 * n

    def small(name, shape):
        return red[layout[name]:layout[name] + math.prod(shape)].view(shape)

    def wgrad(at_, shape):
        return wgrads[at_:at_ + math.prod(shape)].view(shape).to(w_dtype)

    grads = (wgrad(0, (c, c)), small("dwconv", (3, c)), wgrad(2 * c * c + r * dh, (dh, w)),
             wgrad(2 * c * c, (r, dh)), small("ddtb", (dh,)), small("dat", (n, dh)),
             small("dd", (dh,)), wgrad(c * c, (c, c)))
    if has_ln:
        grads += (small("dg", (c,)), small("dbln", (c,)))
    return grads


class _MambaWindowMixer(torch.autograd.Function):
    """The mixer on prepared operands. The forward saves only its inputs;
    the backward recomputes the forward, in the kernel on CUDA and through
    the plain VJP on the CPU."""

    @staticmethod
    def forward(ctx, x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out, ln_scale, ln_bias):
        ctx.save_for_backward(x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out, ln_scale,
                              ln_bias)
        if x.is_cuda:
            return mamba_window_fwd(x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out,
                                    ln_scale, ln_bias)
        return mamba_window_plain(x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out,
                                  ln_scale, ln_bias)

    @staticmethod
    def backward(ctx, do):
        inputs = ctx.saved_tensors
        if do.is_cuda:
            grads = mamba_window_bwd(do.contiguous(), *inputs)
        else:
            grads = mamba_window_bwd_plain(do, *inputs)
        return tuple(grads) + (None,) * (11 - len(grads))


def mamba_window_mixer(x, w_xz, w_conv_x, w_conv_z, w_dbl, w_dt, dt_bias, A, D, w_out,
                       d_state: int, ln_scale=None, ln_bias=None):
    """Fused MambaVision window mixer, optionally x + mixer(LN(x)).

    x: (BW, V, C) windowed tokens, 16 <= V <= 64, V % 8 == 0, fp32 or bf16.
    w_xz: (C, C) in_proj; w_conv_x / w_conv_z: (C/2, 3) depthwise 'same'
    conv branches (no bias); w_dbl: (C/2, R + 2 * d_state) x_proj; w_dt:
    (R, C/2); dt_bias: (C/2,), applied twice (the dt_proj bias and the
    scan's delta bias); A: (C/2, d_state) negative decays; D: (C/2,) skip;
    w_out: (C, C) out_proj; projection weights in x.dtype. ln_scale/ln_bias:
    optional (C,) pre-LN parameters; with them the result is
    x + mixer(LN(x)). Returns (BW, V, C) in x.dtype, differentiable in every
    argument. A CUDA tensor goes through the K4 forward and backward kernels
    (or raises); a CPU tensor through the plain versions."""
    if x.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"no Mamba window mixer for device {x.device}")
    if A.shape[1] != d_state:
        raise ValueError(f"A has {A.shape[1]} states, d_state is {d_state}")
    wconv, dtb2, at, dskip = prepare_operands(w_conv_x, w_conv_z, dt_bias, A, D)
    ln = (ln_scale.float(), ln_bias.float()) if ln_scale is not None else (None, None)
    return _MambaWindowMixer.apply(x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out, *ln)
