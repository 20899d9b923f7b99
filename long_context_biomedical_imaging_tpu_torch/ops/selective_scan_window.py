"""Windowed selective scan (K9): the Mamba scan over many short windows (L <=
64 tokens), forward and backward.

Counterpart of ``long_context_biomedical_imaging_tpu/ops/selective_scan_pallas.py``
(``selective_scan_pallas`` and its custom VJP ``_scan_core``). The Mamba
mixer takes it where the fused window mixer K4 does not: Swin windows whose
token count is not a multiple of 8 or is under 16 (a 7x7 window: 49
tokens), and windows in calls too small for K4 (:func:`window_scan_supported`:
on CPU tensors the JAX package's gate, at least 2048 windows; on CUDA tensors
at least WINDOW_SCAN_MIN_BATCH_CUDA, the card's own crossover against
``selective_scan_cm``).

The wrapper keeps the JAX package's semantics: the scan core takes fp32 u,
delta + delta_bias, A^T, B and C and returns fp32 y; the D skip ``y + u D``
is added in fp32 outside the core and the result is cast once to u.dtype;
autograd carries the gradients of D and delta_bias around the core. On CUDA
tensors the core launches the hand-written kernels
(:func:`window_scan_fwd`, :func:`window_scan_bwd`:
``csrc/selective_scan_window.cu``, ``selective_scan_window_bwd.cu``), which
raise on what they do not take; on CPU tensors it runs their plain versions
(``window_scan_*_plain``), the sequential scan of ``ops.selective_scan``
(``selective_scan_cm``, the JAX package's own XLA route for the same calls)
and its VJP by autograd.

Precision: everything inside is fp32; the kernels compute exp(delta A) as
exp2(delta A log2 e) and softplus as JAX's logaddexp(v, 0), the plain
version ``torch.exp`` and ``F.softplus`` (exact to 2e-9 past its threshold
of 20): both agree within fp32 round-off. The kernels take any d_state from 1
to WINDOW_SCAN_STATE (16; the MambaVisionMixer's is 8) and refuse more; the
plain versions take any.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, check_cuda_operand, ptr, stream_handle
from .selective_scan import selective_scan_cm

# the JAX package's gate (selective_scan_pallas.py PALLAS_SCAN_*); its window
# floor is the crossover measured on a TPU, and the CPU route keeps it
WINDOW_SCAN_MAX_LEN = 64
WINDOW_SCAN_MAX_ND = 8192
WINDOW_SCAN_MIN_BATCH = 2048
# the floor on CUDA tensors: the kernels' forward and backward beat
# selective_scan_cm's forward and autograd backward (a launch or more per
# token each way) at every window count timed on an H100, down to one window
# (PERF.md, chip_smoke.py phase 37's crossover)
WINDOW_SCAN_MIN_BATCH_CUDA = 1
WINDOW_SCAN_STATE = 16       # the kernels' largest d_state

WINDOW_SCAN_FWD = CudaKernel(
    "selective_scan_window.cu", "lcbi_window_scan_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
WINDOW_SCAN_BWD = CudaKernel(
    "selective_scan_window_bwd.cu", "lcbi_window_scan_bwd",
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def window_scan_supported(length: int, n: int, d: int, batch: int | None = None,
                          cuda: bool = False) -> bool:
    """The gate of the windowed scan: L <= 64, n * d <= 8192 and, where the
    call's window count is given, at least WINDOW_SCAN_MIN_BATCH_CUDA windows
    for a call on CUDA tensors, else the JAX package's 2048."""
    ok = length <= WINDOW_SCAN_MAX_LEN and n * d <= WINDOW_SCAN_MAX_ND
    if batch is not None:
        ok = ok and batch >= (WINDOW_SCAN_MIN_BATCH_CUDA if cuda else WINDOW_SCAN_MIN_BATCH)
    return ok


def _check_limits(length: int, n: int, d: int) -> None:
    if length > WINDOW_SCAN_MAX_LEN:
        raise ValueError(f"the windowed scan takes L <= {WINDOW_SCAN_MAX_LEN}, got {length}")
    if n * d > WINDOW_SCAN_MAX_ND:
        raise ValueError(f"the windowed scan takes N * d <= {WINDOW_SCAN_MAX_ND}, got "
                         f"{n} * {d} = {n * d}")


# ---------------------------------------------------------------------------
# The core: plain versions (CPU) and kernels (CUDA)
# ---------------------------------------------------------------------------

def window_scan_fwd_plain(u, delta, at, B, C, softplus=True):
    """y (BW, L, D) fp32 of the scan core from fp32 u, delta (BW, L, D), at =
    A^T (N, D) and B, C (BW, L, N): ``selective_scan_cm`` without its D
    skip and bias."""
    return selective_scan_cm(u, delta, at.t(), B, C, delta_softplus=softplus)


def window_scan_bwd_plain(u, delta, at, B, C, g, softplus=True):
    """(du, ddelta, dat, dB, dC) of the core for the cotangent g of y: the
    VJP of :func:`window_scan_fwd_plain`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (u, delta, at, B, C)]
        y = window_scan_fwd_plain(*leaves, softplus=softplus)
        return torch.autograd.grad(y, leaves, g)


def _check(at, seqs, states):
    """Raise unless the kernels take these operands: at (N, D), N from 1 to
    WINDOW_SCAN_STATE; seqs {name: (BW, L, D)}, states {name: (BW, L, N)};
    all contiguous fp32 tensors on one CUDA device. Returns (BW, L, D)."""
    first = next(iter(seqs.values()))
    if not first.is_cuda:
        raise ValueError(f"the windowed-scan kernels take CUDA tensors, got {first.device}")
    n = at.shape[0]
    if not 1 <= n <= WINDOW_SCAN_STATE:
        raise ValueError(f"the windowed-scan kernels take d_state <= {WINDOW_SCAN_STATE}, "
                         f"got {n}")
    if first.dim() != 3:
        raise ValueError(f"the sequences must be (BW, L, D), got {tuple(first.shape)}")
    bw, length, d = first.shape
    _check_limits(length, n, d)
    if bw * length * d >= 2**31:
        raise ValueError(f"the windowed-scan kernels need BW * L * D < 2^31, got "
                         f"{tuple(first.shape)}")
    for group, shape in ((seqs, (bw, length, d)), (states, (bw, length, n)),
                         ({"at": at}, (n, d))):
        for name, t in group.items():
            check_cuda_operand(name, t, first.device, torch.float32, shape)
    return bw, length, d


def window_scan_fwd(u, delta, at, B, C, softplus=True):
    """The K9 forward kernel (``csrc/selective_scan_window.cu``, K7's streamed
    pass with zero carries, a window a row): :func:`window_scan_fwd_plain` on
    CUDA tensors."""
    bw, length, d = _check(at, {"u": u, "delta": delta}, {"B": B, "C": C})
    y = torch.empty_like(u)
    WINDOW_SCAN_FWD(ptr(u), ptr(delta), ptr(at), ptr(B), ptr(C), ptr(y), bw, length, d,
                    at.shape[0], int(softplus), stream_handle(u.device))
    return y


def window_scan_bwd(u, delta, at, B, C, g, softplus=True):
    """The K9 backward kernel (``csrc/selective_scan_window_bwd.cu``):
    :func:`window_scan_bwd_plain` on CUDA tensors. Its blocks sum dA over
    their windows into their own fp32 slots, and dB, dC over a window's
    channel tiles into per-tile partials, each summed in a fixed order at the
    end."""
    bw, length, d = _check(at, {"u": u, "delta": delta, "g": g}, {"B": B, "C": C})
    n = at.shape[0]
    n_slots = WINDOW_SCAN_BWD.query("lcbi_window_scan_bwd_slots", [ctypes.c_int] * 5,
                                    ctypes.c_longlong, bw, length, d, n, int(softplus))
    n_parts = WINDOW_SCAN_BWD.query("lcbi_window_scan_bwd_parts", [ctypes.c_int] * 4,
                                    ctypes.c_longlong, bw, length, d, n)
    if n_slots < 1 or n_parts < 0:
        raise ValueError(f"the windowed-scan backward kernel cannot take (BW, L, D, N) = "
                         f"{(bw, length, d, n)}")
    du, dd = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    slots = torch.empty(n_slots, n * d, device=u.device, dtype=torch.float32)
    parts = torch.empty(n_parts, device=u.device, dtype=torch.float32) if n_parts else None
    dat = torch.empty_like(at)
    WINDOW_SCAN_BWD(ptr(u), ptr(delta), ptr(at), ptr(B), ptr(C), ptr(g), ptr(du), ptr(dd),
                    ptr(dB), ptr(dC), ptr(slots), ptr(parts), ptr(dat), bw, length, d, n,
                    int(softplus), n_slots, stream_handle(u.device))
    return du, dd, dat, dB, dC


class _WindowScan(torch.autograd.Function):
    """y of the scan core (no D skip; delta with its bias added) on fp32
    (BW, L, D) operands (JAX ``_scan_core``): the kernels on CUDA tensors,
    their plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, u, delta, at, B, C, softplus):
        ctx.softplus = softplus
        ctx.save_for_backward(u, delta, at, B, C)
        fwd = window_scan_fwd if u.is_cuda else window_scan_fwd_plain
        return fwd(u, delta, at, B, C, softplus)

    @staticmethod
    def backward(ctx, g):
        u, delta, at, B, C = ctx.saved_tensors
        bwd = window_scan_bwd if u.is_cuda else window_scan_bwd_plain
        return (*bwd(u, delta, at, B, C, g.float().contiguous(), ctx.softplus), None)


def selective_scan_window(u, delta, A, B, C, D=None, delta_bias=None, delta_softplus=True):
    """Channel-minor windowed selective scan through K9: u, delta (BW, L, d),
    L <= 64; A (d, N), N * d <= 8192; B, C (BW, L, N); D and delta_bias (d,)
    or None. Returns (BW, L, d) in u.dtype, differentiable in every argument
    (JAX ``selective_scan_pallas``)."""
    if u.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"no windowed scan for device {u.device}")
    _check_limits(u.shape[1], A.shape[1], A.shape[0])
    u32 = u.float().contiguous()
    d32 = delta.float()
    if delta_bias is not None:
        d32 = d32 + delta_bias.float()
    y = _WindowScan.apply(u32, d32.contiguous(), A.float().t().contiguous(),
                          B.float().contiguous(), C.float().contiguous(), bool(delta_softplus))
    if D is not None:
        y = y + u32 * D.float()
    return y.to(u.dtype)


# K9's plain version: the same function by the sequential scan, with the same
# arguments, layout and rounding point (fp32 inside, the D skip in fp32, one
# cast to u.dtype); the yardstick the kernels are held against on the card
selective_scan_window_plain = selective_scan_cm
