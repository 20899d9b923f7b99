"""Swin window attention with the qkv and out projections fused in (K8).

Counterpart of ``long_context_biomedical_imaging_tpu/ops/window_attention.py``
(``windowed_attention_proj`` and its custom VJP). Per window of V tokens and
head h of D = C / H channels:

    qkv = x Wqkv + bqkv;  q | k | v head-major column blocks of width C
    s_h = (q_h scale) k_h^T + rel[h] + (region ids differ ? mask_value : 0)
    out = sum_h softmax(s_h) v_h Wout[hD:(h+1)D, :] + bout

On a CUDA tensor the autograd Function launches ``csrc/window_attention.cu``
(forward) and, for the gradient, ``csrc/window_attention_bwd.cu`` (dx, the
streams dqkv and o in the stream dtype, and dbqkv, dbout and drel summed over
the windows) then ``csrc/window_attention_wgrad.cu`` (dWqkv = x^T dqkv and
dWout = o^T dout, split-K partials summed in a fixed order). On a CPU tensor
it runs :func:`window_attention_plain` and the VJP of that,
:func:`window_attention_bwd_plain`. Windows of more than ``MAX_TOKENS`` take
the plain version on every device, as the JAX package takes its XLA path
there: that is the JAX package's route, not a fallback.

Precision, shared by the kernels and the plain version and taken from the TPU
kernel: the projections take operands rounded to ``x.dtype`` (bf16 under AMP)
and sum in fp32; the bias adds in fp32; the softmax runs in base 2, with
scale * log2(e) folded into q and rel and the mask pre-scaled by log2(e); q,
k, v, the probabilities and each head's o are rounded to ``x.dtype`` before
their products; the output is rounded once. The backward rounds do, ds and
dqkv likewise; dWqkv, dWout, the biases' and rel's gradients come back in
fp32 (the weights' in their own dtype).

The TPU kernel's layout devices are not copied: it fuses G windows into one
block-diagonal sequence (``pick_group``, a ``NEG_INF`` bias off the
diagonal) padded to 128 lanes, and rebuilds the region mask by a one-hot
matrix product. A CUDA block attends within each window directly and reads
window w's region ids from row w % nW of the (nW, V) table, which is the JAX
package's ``jnp.tile`` of the table over the batch.

The kernels take every window of 1 to ``MAX_TOKENS`` tokens, as the TPU
kernel does, at head dim 32, the head dim of every Swin preset; another head
dim raises ValueError. Windows of 16, 32, 48 or 64 tokens (2D windows 4x4 to
8x8) take the whole-window path, a block per tile of whole windows; every
other V (3D windows of up to 8x8x8, shrunk and ragged windows such as 7x7)
takes the general path, which writes q, k, v (and in the backward do and
each query row's softmax statistics) to device memory in scratch that the
wrappers allocate (``csrc/window_attention.cuh``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .cuda_build import (SLOT_BYTES_BUDGET, CudaKernel, check_cuda_operand, ptr, slot_count,
                         stream_handle)
from .fused_mlp import matmul_rounded

LOG2E = math.log2(math.e)
MAX_TOKENS = 512          # the JAX package's single-block ceiling; larger windows: plain
KERNEL_HEAD_DIM = 32
WHOLE_WINDOW_TOKENS = (16, 32, 48, 64)   # the whole-window path; other V: the general path

WINDOW_ATTENTION_FWD = CudaKernel(
    "window_attention.cu", "lcbi_window_attention_fwd",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
    + [ctypes.c_int, ctypes.c_void_p])
WINDOW_ATTENTION_BWD = CudaKernel(
    "window_attention_bwd.cu", "lcbi_window_attention_bwd",
    [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
WINDOW_ATTENTION_WGRAD = CudaKernel(
    "window_attention_wgrad.cu", "lcbi_window_attention_wgrad",
    [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def window_attention_plain(x, wqkv, bqkv, wout, bout, rel, heads: int, rid=None,
                           mask_value: float = -100.0, scale: float | None = None):
    """The window attention in plain PyTorch, in the kernels' precision
    (module doc). x: (BW, V, C); wqkv (C, 3C), wout (C, C) (rounded to
    x.dtype); bqkv (3C,), bout (C,) and rel (H, V, V), used in fp32; rid (nW,
    V) region ids with BW % nW == 0, or None. Returns (BW, V, C) in x.dtype."""
    bw, v, c = x.shape
    d = c // heads
    dt = x.dtype
    scale = d ** -0.5 if scale is None else scale
    qkv = matmul_rounded(x.reshape(bw * v, c), wqkv, dt) + bqkv.float()
    q, k, val = qkv.reshape(bw, v, 3, heads, d).permute(2, 0, 3, 1, 4)   # (BW, H, V, D)
    s = (q * (scale * LOG2E)).to(dt).float() @ k.to(dt).float().transpose(-1, -2)
    s = s + rel.float() * LOG2E
    if rid is not None:
        nw = rid.shape[0]
        mask = torch.where(rid[:, :, None] != rid[:, None, :], mask_value * LOG2E, 0.0).float()
        s = (s.reshape(bw // nw, nw, heads, v, v) + mask[None, :, None]).reshape(bw, heads, v, v)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = (p.to(dt).float() @ val.to(dt).float()).to(dt)
    o = o.permute(0, 2, 1, 3).reshape(bw * v, c)
    return (matmul_rounded(o, wout, dt) + bout.float()).reshape(bw, v, c).to(dt)


def window_attention_bwd_plain(do, x, wqkv, bqkv, wout, bout, rel, heads: int, rid=None,
                               mask_value: float = -100.0, scale: float | None = None):
    """The vector-Jacobian product of :func:`window_attention_plain` for the
    output cotangent ``do``, by ``torch.func.vjp``: (dx, dwqkv, dbqkv, dwout,
    dbout, drel), each in its input's dtype. Autograd of the plain chain,
    independent of the kernels' hand-derived formulas."""
    def fn(*args):
        return window_attention_plain(*args, heads, rid, mask_value, scale)

    _, vjp = torch.func.vjp(fn, x, wqkv, bqkv, wout, bout, rel)
    return vjp(do)


def _check_operands(x, wqkv, bqkv, wout, bout, rel, rid, heads):
    """Raise unless the kernels take these operands; returns (BW, V, C, nW)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K8 kernels take fp32 or bf16, got {x.dtype}")
    bw, v, c = x.shape
    if heads <= 0 or c != heads * KERNEL_HEAD_DIM:
        raise ValueError(f"K8 kernels take a head dim of {KERNEL_HEAD_DIM} (C = 32 H, every "
                         f"Swin preset), got C={c} with {heads} heads")
    if not 1 <= v <= MAX_TOKENS:
        raise ValueError(f"K8 kernels take windows of 1 to {MAX_TOKENS} tokens, got V={v} (a "
                         f"larger window takes the plain version, as in the JAX package)")
    width = 3 * c if v in WHOLE_WINDOW_TOKENS else 4 * c   # the widest stream each path writes
    if bw == 0 or bw * v * width >= 2**31:
        raise ValueError(f"K8 kernels take 0 < BW*V*{width // c}C < 2^31, got BW={bw}, V={v}, "
                         f"C={c}")
    if not x.is_cuda:
        raise ValueError(f"K8 kernels take CUDA tensors, got x on {x.device}")
    dev = x.device
    check_cuda_operand("x", x, dev, x.dtype, (bw, v, c))
    check_cuda_operand("wqkv", wqkv, dev, x.dtype, (c, 3 * c))
    check_cuda_operand("wout", wout, dev, x.dtype, (c, c))
    check_cuda_operand("bqkv", bqkv, dev, torch.float32, (3 * c,))
    check_cuda_operand("bout", bout, dev, torch.float32, (c,))
    check_cuda_operand("rel", rel, dev, torch.float32, (heads, v, v))
    nw = 0
    if rid is not None:
        nw = rid.shape[0]
        check_cuda_operand("rid", rid, dev, torch.int32, (nw, v))
        if bw % nw:
            raise ValueError(f"{bw} windows are not a multiple of the {nw} rows of rid")
    return bw, v, c, nw


def _scales(scale: float, mask_value: float):
    return ctypes.c_float(scale * LOG2E), ctypes.c_float(mask_value * LOG2E)


def window_attention_fwd(x, wqkv, bqkv, wout, bout, rel, heads: int, rid=None,
                         mask_value: float = -100.0, scale: float = 1.0):
    """The K8 forward kernel on CUDA: the output of :func:`window_attention_plain`
    for operands as :func:`windowed_attention_proj` prepares them."""
    bw, v, c, nw = _check_operands(x, wqkv, bqkv, wout, bout, rel, rid, heads)
    out = torch.empty_like(x)
    obuf = torch.empty_like(x)       # each head's o, read back by the out projection
    qkv = (None if v in WHOLE_WINDOW_TOKENS
           else torch.empty(bw * v, 3 * c, device=x.device, dtype=x.dtype))
    WINDOW_ATTENTION_FWD(ptr(x), ptr(wqkv), ptr(bqkv), ptr(wout), ptr(bout), ptr(rel), ptr(rid),
                         ptr(obuf), ptr(qkv), ptr(out), bw, v, c, heads, nw,
                         *_scales(scale, mask_value), int(x.dtype == torch.bfloat16),
                         stream_handle(x.device))
    return out


def window_attention_bwd_streams(do, x, wqkv, bqkv, wout, bout, rel, heads: int, rid=None,
                                 mask_value: float = -100.0, scale: float = 1.0):
    """The K8 backward kernel on CUDA: (dx, dqkv (BW V, 3C) and o (BW V, C) in
    x.dtype, dbqkv, dbout, drel in fp32); dqkv and o are the operands of the
    weight gradients (:func:`window_attention_wgrad`)."""
    bw, v, c, nw = _check_operands(x, wqkv, bqkv, wout, bout, rel, rid, heads)
    check_cuda_operand("do", do, x.device, x.dtype, (bw, v, c))
    n, dev = bw * v, x.device
    red = torch.empty(4 * c + heads * v * v, device=dev, dtype=torch.float32)
    dx = torch.empty_like(x)
    dqkv = torch.empty(n, 3 * c, device=dev, dtype=x.dtype)
    o = torch.empty(n, c, device=dev, dtype=x.dtype)
    qkvu = dob = stats = kslots = ksums = None
    max_gw = 1
    if v in WHOLE_WINDOW_TOKENS:
        size = red.numel()
    else:
        # the general path: the row kernel's slots hold its dq and dout column
        # sums; the key-tile kernel's, drel over a range of windows (kslots)
        # and its dk and dv column sums (ksums)
        size = 2 * c
        qkvu = torch.empty(n, 4 * c, device=dev, dtype=x.dtype)
        dob = torch.empty(n, c, device=dev, dtype=x.dtype)
        stats = torch.empty(3 * bw * heads * v, device=dev, dtype=torch.float32)
        budget = max(1, SLOT_BYTES_BUDGET // (4 * heads * v * v))
        key_tiles = ctypes.c_int(0)
        max_gw = WINDOW_ATTENTION_BWD.query(
            "lcbi_window_attention_key_ranges", [ctypes.c_int] * 5 + [ctypes.c_void_p],
            ctypes.c_int, bw, v, heads, budget, int(x.dtype == torch.bfloat16),
            ctypes.cast(ctypes.byref(key_tiles), ctypes.c_void_p))
        if max_gw < 1:
            raise RuntimeError("lcbi_window_attention_key_ranges: device query failed")
        kslots = torch.empty(max_gw, heads * v * v, device=dev, dtype=torch.float32)
        ksums = torch.empty(max_gw * key_tiles.value, 2 * c, device=dev, dtype=torch.float32)
    n_slots = slot_count(size, dev)
    slots = torch.empty(n_slots, size, device=dev, dtype=torch.float32)
    WINDOW_ATTENTION_BWD(ptr(x), ptr(wqkv), ptr(bqkv), ptr(wout), ptr(rel), ptr(rid), ptr(do),
                         ptr(dx), ptr(dqkv), ptr(o), ptr(slots), ptr(red), ptr(qkvu), ptr(dob),
                         ptr(stats), ptr(kslots), ptr(ksums), bw, v, c, heads, nw,
                         ctypes.c_float(scale), *_scales(scale, mask_value), n_slots, max_gw,
                         int(x.dtype == torch.bfloat16), stream_handle(dev))
    return dx, dqkv, o, red[:3 * c], red[3 * c:4 * c], red[4 * c:].view(heads, v, v)


def wgrad_splits(n: int, c: int, device) -> int:
    """Row splits of the weight-gradient kernel: enough blocks for four per SM
    over its 64 x 64 output tiles, each split at least 512 rows."""
    tiles = -(-c // 64) * (-(-3 * c // 64) + -(-c // 64))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-4 * sms // tiles), n // 512, 65535))


def window_attention_wgrad(x, dqkv, o, do):
    """The K8 weight-gradient kernel on CUDA: (x^T dqkv (C, 3C), o^T do (C,
    C)) in fp32, over the N = BW V rows of x, o, do (BW, V, C) or (N, C) and
    dqkv (N, 3C), all in one dtype."""
    c = x.shape[-1]
    n = x.numel() // c
    if x.dtype not in (torch.float32, torch.bfloat16) or c % 32 or n == 0:
        raise ValueError(f"K8 weight-gradient kernel takes fp32 or bf16 with C % 32 == 0, got "
                         f"{x.dtype}, C={c}")
    if not x.is_cuda:
        raise ValueError(f"K8 kernels take CUDA tensors, got x on {x.device}")
    dev = x.device
    for name, t, width in (("x", x, c), ("dqkv", dqkv, 3 * c), ("o", o, c), ("do", do, c)):
        check_cuda_operand(name, t, dev, x.dtype, (*t.shape[:-1], width))
        if t.numel() != n * width:
            raise ValueError(f"{name} has {t.numel() // width} rows, x has {n}")
    splits = wgrad_splits(n, c, dev)
    partials = torch.empty(splits, 4 * c * c, device=dev, dtype=torch.float32)
    out = torch.empty(4 * c * c, device=dev, dtype=torch.float32)
    WINDOW_ATTENTION_WGRAD(ptr(x), ptr(dqkv), ptr(o), ptr(do), ptr(partials), ptr(out), n, c,
                           splits, int(x.dtype == torch.bfloat16), stream_handle(dev))
    return out[:3 * c * c].view(c, 3 * c), out[3 * c * c:].view(c, c)


def window_attention_bwd(do, x, wqkv, bqkv, wout, bout, rel, heads: int, rid=None,
                         mask_value: float = -100.0, scale: float = 1.0):
    """The K8 backward on CUDA (the backward kernel, then the weight-gradient
    kernel): the gradients of :func:`window_attention_bwd_plain`, in the same
    order and dtypes."""
    dx, dqkv, o, dbqkv, dbout, drel = window_attention_bwd_streams(
        do, x, wqkv, bqkv, wout, bout, rel, heads, rid, mask_value, scale)
    dwqkv, dwout = window_attention_wgrad(x, dqkv, o, do)
    return dx, dwqkv.to(wqkv.dtype), dbqkv, dwout.to(wout.dtype), dbout, drel


class _WindowAttention(torch.autograd.Function):
    """The window attention on prepared operands. The forward saves only its
    inputs; the backward recomputes the softmax, in the kernels on CUDA and
    through the plain VJP on the CPU."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wout, bout, rel, rid, heads, mask_value, scale):
        ctx.save_for_backward(x, wqkv, bqkv, wout, bout, rel, rid)
        ctx.conf = (heads, mask_value, scale)
        if x.is_cuda:
            return window_attention_fwd(x, wqkv, bqkv, wout, bout, rel, heads, rid, mask_value,
                                        scale)
        return window_attention_plain(x, wqkv, bqkv, wout, bout, rel, heads, rid, mask_value,
                                      scale)

    @staticmethod
    def backward(ctx, do):
        x, wqkv, bqkv, wout, bout, rel, rid = ctx.saved_tensors
        heads, mask_value, scale = ctx.conf
        args = (x, wqkv, bqkv, wout, bout, rel, heads, rid, mask_value, scale)
        if do.is_cuda:
            grads = window_attention_bwd(do.contiguous(), *args)
        else:
            grads = window_attention_bwd_plain(do, *args)
        return tuple(grads) + (None,) * 4


def windowed_attention_proj(x, wqkv, bqkv, wout, bout, rel, heads: int, rid=None,
                            mask_value: float = -100.0, scale: float | None = None):
    """Per-window attention with fused qkv and out projections.

    x: (BW, V, C) windowed tokens; wqkv (C, 3C); bqkv (3C,) or None; wout (C,
    C); bout (C,) or None; rel (H, V, V) relative-position bias (its gradient
    flows); heads H with C % H == 0; rid: (nW, V) integer pre-shift region ids
    with BW % nW == 0 (window w reads row w % nW), or None: tokens of another
    region get ``mask_value`` added to their score (the Swin shift mask).

    The weights are rounded to x.dtype and the biases and rel cast to fp32
    here, outside the kernels, so autograd carries those casts. Windows of at
    most MAX_TOKENS tokens take K8 (module doc), larger ones the plain version
    on every device. Returns (BW, V, C) in x.dtype."""
    bw, v, c = x.shape
    if c % heads:
        raise ValueError(f"C={c} is not a multiple of {heads} heads")
    scale = (c // heads) ** -0.5 if scale is None else float(scale)
    bqkv = (torch.zeros(3 * c, device=x.device) if bqkv is None else bqkv).float()
    bout = (torch.zeros(c, device=x.device) if bout is None else bout).float()
    wqkv, wout, rel = wqkv.to(x.dtype), wout.to(x.dtype), rel.float()
    if rid is not None:
        rid = rid.to(x.device, torch.int32)
        if bw % rid.shape[0]:
            raise ValueError(f"{bw} windows are not a multiple of the {rid.shape[0]} rows of rid")
    if v > MAX_TOKENS:
        return window_attention_plain(x, wqkv, bqkv, wout, bout, rel, heads, rid, mask_value,
                                      scale)
    return _WindowAttention.apply(x.contiguous(), wqkv.contiguous(), bqkv.contiguous(),
                                  wout.contiguous(), bout.contiguous(), rel.contiguous(),
                                  None if rid is None else rid.contiguous(), heads,
                                  float(mask_value), scale)
