"""Long-sequence selective scan (K7): the full-sequence Mamba scan of the ViT
mixer at L >= 2048 tokens, forward and backward.

Counterpart of ``long_context_biomedical_imaging_tpu/ops/selective_scan_long.py``
(``selective_scan_long`` and its custom VJP). The sequence is cut into
segments of SEG = 64 tokens, each segment of each batch row a *row*. The
recurrence h_t = a_t h_{t-1} + b_t is linear in the carried state, so the
segments' order factors out:

  forward   h_last(s, H) = h_last(s, 0) + P_s H,   P_s = prod_t a_t over s
  backward  dh_start(s, T) = dh_start(s, 0) + P_s T

Each direction is (1) one pass over all rows at once from zero carries,
giving each segment's boundary values, (2) a scan over the segments'
(P_s, boundary) pairs, the stitch, and (3) one pass seeded with the true
carries, giving the outputs. The forward runs the
forward kernel twice (from zero carries, writing the carries out; then
seeded, writing y alone); the backward
runs the carry kernel (dh at each segment's start from a zero tail), the
reverse stitch, and the backward kernel (du, ddelta, dB, dC and dA, the
h history recomputed from each segment's true start carry).

On CUDA tensors each pass and each stitch launches its hand-written kernel
(:func:`long_scan_fwd`, :func:`long_scan_carry_bwd`, :func:`long_scan_bwd`,
:func:`long_scan_stitch`: ``csrc/selective_scan_long.cu``,
``selective_scan_long_carry_bwd.cu``, ``selective_scan_long_bwd.cu``,
``selective_scan_long_stitch.cu``), which raises on what it does not take; on
CPU tensors it runs its plain PyTorch version (``long_scan_*_plain``; the
stitches :func:`_stitch_fwd` and :func:`_stitch_bwd`, a log-depth
``affine_scan``), so the CPU runs the same passes and stitches, as the JAX
package runs its kernels in interpret mode there. The stitch kernel walks the
segments in a fixed order of spans (:func:`long_scan_stitch_plain` is that
order in torch ops), so two launches give the same bits.
:func:`selective_scan_long_plain`, the chunked scan of ``ops.selective_scan``,
computes the same function by another algorithm: it is the yardstick the
kernels are held against on the card.

Precision: everything is fp32 (u, delta, B and C are cast at the boundary,
as the JAX package casts them); the kernels compute exp(delta A) as
exp2(delta A log2 e) and softplus as max(v, 0) + log1p(exp(-|v|)) (JAX's
``logaddexp(v, 0)``), the plain versions ``torch.exp`` and ``F.softplus``:
both agree within fp32 round-off. delta goes through softplus unless the
caller passes ``delta_softplus=False``, as in the JAX package. The kernels
take any d_state from 1 to LONG_SCAN_STATE (16; the MambaVisionMixer's is
8) and refuse more; the plain versions take any.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_build import CudaKernel, check_cuda_operand, ptr, slot_count, stream_handle
from .selective_scan import affine_scan, selective_scan_chunked

SEG = 64                     # tokens per segment row (the TPU kernel's)
LONG_SCAN_MIN_LEN = 2048     # the gate of the JAX package (long_scan_supported)
LONG_SCAN_MAX_ND = 8192
LONG_SCAN_STATE = 16         # the kernels' largest d_state

LONG_SCAN_FWD = CudaKernel(
    "selective_scan_long.cu", "lcbi_long_scan_fwd",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
LONG_SCAN_CARRY_BWD = CudaKernel(
    "selective_scan_long_carry_bwd.cu", "lcbi_long_scan_carry_bwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
LONG_SCAN_BWD = CudaKernel(
    "selective_scan_long_bwd.cu", "lcbi_long_scan_bwd",
    [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
LONG_SCAN_STITCH = CudaKernel(
    "selective_scan_long_stitch.cu", "lcbi_long_scan_stitch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
STITCH_MIN_SPAN = 32         # the stitch kernel's spans: at least 32 segments,
STITCH_SPANS = 128           # at most 128 spans a batch row


def long_scan_supported(length: int, n: int, d: int) -> bool:
    """The JAX package's gate of the long-sequence kernel: L >= 2048 and
    n * d <= 8192."""
    return length >= LONG_SCAN_MIN_LEN and n * d <= LONG_SCAN_MAX_ND


# ---------------------------------------------------------------------------
# Segments and the stitch
# ---------------------------------------------------------------------------

def _segment(x):
    """(b, L, k) -> (b * nseg, SEG, k), the tail zero-padded; and nseg."""
    b, length, k = x.shape
    pad = (-length) % SEG
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    return x.reshape(-1, SEG, k), (length + pad) // SEG


def _unsegment(x, b, length):
    """(b * nseg, SEG, k) -> (b, L, k)."""
    return x.reshape(b, -1, x.shape[-1])[:, :length]


def _valid(b, length, device):
    """(rows, SEG) bool: which steps of each row are real tokens."""
    nseg = -(-length // SEG)
    return (torch.arange(nseg * SEG, device=device) < length).reshape(1, nseg, SEG).expand(
        b, nseg, SEG).reshape(b * nseg, SEG)


def _stitch_fwd(hl, ap, b, nseg):
    """Each segment's zero-carry final state hl and decay product ap (rows,
    N, D) -> the true initial carries: hstart[s] = ap[s-1] hstart[s-1] +
    hl[s-1] within each batch row, hstart[0] = 0."""
    shape = hl.shape
    _, h_in = affine_scan(ap.reshape(b, nseg, -1), hl.reshape(b, nseg, -1), dim=1)
    return F.pad(h_in[:, :-1], (0, 0, 1, 0)).reshape(shape)


def _stitch_bwd(dh0, ap, b, nseg):
    """Each segment's dh at its start from a zero tail, dh0 (rows, N, D), ->
    the true cotangent of each segment's final state: dh_tail[s] = dh0[s+1]
    + ap[s+1] dh_tail[s+1] within each batch row, the last one 0."""
    shape = dh0.shape
    _, t_in = affine_scan(ap.reshape(b, nseg, -1), dh0.reshape(b, nseg, -1), dim=1,
                          reverse=True)
    return F.pad(t_in[:, 1:], (0, 0, 0, 1)).reshape(shape)


def _stitch(x, ap, b, nseg, reverse=False):
    """The CPU path's stitch: :func:`_stitch_bwd` with ``reverse``, else
    :func:`_stitch_fwd`."""
    return (_stitch_bwd if reverse else _stitch_fwd)(x, ap, b, nseg)


def long_scan_stitch_plain(x, ap, b, nseg, reverse=False):
    """The stitch kernel's function in its order: within each batch row, the
    exclusive affine scan out[s] = X_s, X_{s+1} = ap[s] X_s + x[s], X_0 = 0,
    over the segments in walk order (descending with ``reverse``), element
    by element; x, ap (b * nseg, N, D). The walk is cut into spans of
    max(32, ceil(nseg / 128)) segments: each span's map composed from a zero
    start, the spans walked in order for their starts, then each span again
    from its start. Equals :func:`_stitch_fwd` (:func:`_stitch_bwd` with
    ``reverse``) up to rounding; the kernel rounds each a X + x once."""
    shape = x.shape
    xs, aps = x.reshape(b, nseg, -1), ap.reshape(b, nseg, -1)
    if reverse:
        xs, aps = xs.flip(1), aps.flip(1)
    span = max(STITCH_MIN_SPAN, -(-nseg // STITCH_SPANS))
    nspan = -(-nseg // span)
    pad = nspan * span - nseg  # identity maps past the last segment
    xs = F.pad(xs, (0, 0, 0, pad)).reshape(b, nspan, span, -1)
    aps = F.pad(aps, (0, 0, 0, pad), value=1.0).reshape(b, nspan, span, -1)
    big_a, big_h = torch.ones_like(xs[:, :, 0]), torch.zeros_like(xs[:, :, 0])
    for k in range(span):
        big_h = aps[:, :, k] * big_h + xs[:, :, k]
        big_a = big_a * aps[:, :, k]
    starts, carry = [], torch.zeros_like(big_h[:, 0])
    for sp in range(nspan):
        starts.append(carry)
        carry = big_a[:, sp] * carry + big_h[:, sp]
    carry = torch.stack(starts, dim=1)
    out = torch.empty_like(xs)
    for k in range(span):
        out[:, :, k] = carry
        carry = aps[:, :, k] * carry + xs[:, :, k]
    out = out.reshape(b, nspan * span, -1)[:, :nseg]
    return (out.flip(1) if reverse else out).reshape(shape)


# ---------------------------------------------------------------------------
# The three passes: plain versions (CPU) and kernels (CUDA)
# ---------------------------------------------------------------------------

def _delta(d, softplus):
    return F.softplus(d) if softplus else d


def _scan_rows_plain(u, delta, at, B, C, h0, emit_y, softplus=True):
    """One pass over every segment row from the carries h0 (rows, N, D; None
    for zeros): y (b, L, D), None without ``emit_y``; each row's final state
    and decay product (rows, N, D), all fp32. Steps past L are the identity."""
    b, length, _ = u.shape
    us, _ = _segment(u)
    ds, _ = _segment(delta)
    bs, _ = _segment(B)
    cs, _ = _segment(C)
    valid = _valid(b, length, u.device)
    h = torch.zeros(us.shape[0], *at.shape, device=u.device) if h0 is None else h0
    p = torch.ones_like(h)
    ys = []
    for t in range(SEG):
        d = _delta(ds[:, t], softplus)
        a = torch.where(valid[:, t, None, None], torch.exp(d[:, None, :] * at), 1.0)
        h = a * h + (d * us[:, t])[:, None, :] * bs[:, t, :, None]
        p = p * a
        if emit_y:
            ys.append((h * cs[:, t, :, None]).sum(dim=1))
    return (_unsegment(torch.stack(ys, dim=1), b, length) if emit_y else None), h, p


def long_scan_fwd_plain(u, delta, at, B, C, h0=None, emit_y=True, softplus=True):
    """One pass over every segment row from the carries h0 (rows, N, D; None
    for zeros): with ``emit_y`` (y (b, L, D), None, None), else (None, hl,
    ap), each row's final state and decay product (rows, N, D); all fp32.
    u, delta (b, L, D), delta before softplus (with ``softplus``); at = A^T
    (N, D); B, C (b, L, N). Steps past L are the identity."""
    y, hl, ap = _scan_rows_plain(u, delta, at, B, C, h0, emit_y, softplus)
    return (y, None, None) if emit_y else (None, hl, ap)


def long_scan_carry_bwd_plain(delta, at, C, g, softplus=True):
    """Each row's dh at its start from a zero tail (rows, N, D): the reverse
    chain dh_{t-1} = a_t (dh_t + C_t g_t) over the row."""
    ds, _ = _segment(delta)
    cs, _ = _segment(C)
    gs, _ = _segment(g)
    dh = torch.zeros(ds.shape[0], *at.shape, device=delta.device)
    for t in reversed(range(SEG)):
        a = torch.exp(_delta(ds[:, t], softplus)[:, None, :] * at)
        dh = a * (dh + cs[:, t, :, None] * gs[:, t, None, :])
    return dh


def long_scan_bwd_plain(u, delta, at, B, C, g, h0, dht, softplus=True):
    """(du, ddelta, dat, dB, dC) of the seeded pass for the cotangents g of y
    and dht of each row's final state: the VJP of the pass's (y, hl)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (u, delta, at, B, C)]
        y, hl, _ = _scan_rows_plain(*leaves, h0, True, softplus)
        return torch.autograd.grad((y, hl), leaves, (g, dht))


def _check(at, seqs, states, carries=()):
    """Raise unless the kernels take these operands: at (N, D), N from 1 to
    LONG_SCAN_STATE; seqs {name: (b, L, D)}, states {name: (b, L, N)},
    carries {name: (rows, N, D)}; all contiguous fp32 tensors on one CUDA
    device. Returns (b, L, D)."""
    n = at.shape[0]
    if not 1 <= n <= LONG_SCAN_STATE:
        raise ValueError(f"the long-scan kernels take d_state <= {LONG_SCAN_STATE}, got {n}")
    first = next(iter(seqs.values()))
    if not first.is_cuda:
        raise ValueError(f"the long-scan kernels take CUDA tensors, got {first.device}")
    if first.dim() != 3:
        raise ValueError(f"the sequences must be (b, L, D), got {tuple(first.shape)}")
    b, length, d = first.shape
    if b * length * max(d, n) >= 2**31:
        raise ValueError(f"the long-scan kernels need b * L * D < 2^31, got {tuple(first.shape)}")
    rows = b * -(-length // SEG)
    for group, shape in ((seqs, (b, length, d)), (states, (b, length, n)), ({"at": at}, (n, d)),
                         (dict(carries), (rows, n, d))):
        for name, t in group.items():
            check_cuda_operand(name, t, first.device, torch.float32, shape)
    return b, length, d


def _carries(u, n, d):
    return torch.empty(u.shape[0] * -(-u.shape[1] // SEG), n, d, device=u.device,
                       dtype=torch.float32)


def long_scan_fwd(u, delta, at, B, C, h0=None, emit_y=True, softplus=True):
    """The K7 forward kernel (``csrc/selective_scan_long.cu``):
    :func:`long_scan_fwd_plain` on CUDA tensors."""
    b, length, d = _check(at, {"u": u, "delta": delta}, {"B": B, "C": C},
                          {} if h0 is None else {"h0": h0})
    n = at.shape[0]
    if emit_y:
        y, hl, ap = torch.empty_like(u), None, None
    else:
        y, hl, ap = None, _carries(u, n, d), _carries(u, n, d)
    LONG_SCAN_FWD(ptr(u), ptr(delta), ptr(at), ptr(B), ptr(C), ptr(h0), ptr(y), ptr(hl), ptr(ap),
                  b, length, d, n, int(softplus), stream_handle(u.device))
    return y, hl, ap


def long_scan_carry_bwd(delta, at, C, g, softplus=True):
    """The K7 carry-backward kernel (``csrc/selective_scan_long_carry_bwd.cu``):
    :func:`long_scan_carry_bwd_plain` on CUDA tensors."""
    b, length, d = _check(at, {"delta": delta, "g": g}, {"C": C})
    n = at.shape[0]
    dh0 = _carries(delta, n, d)
    LONG_SCAN_CARRY_BWD(ptr(delta), ptr(at), ptr(C), ptr(g), ptr(dh0), b, length, d, n,
                        int(softplus), stream_handle(delta.device))
    return dh0


def long_scan_bwd(u, delta, at, B, C, g, h0, dht, softplus=True):
    """The K7 backward kernel (``csrc/selective_scan_long_bwd.cu``):
    :func:`long_scan_bwd_plain` on CUDA tensors. Its blocks sum dA over their
    rows into their own fp32 slots, and dB, dC over a row's channel tiles
    into per-tile partials, each summed in a fixed order at the end."""
    b, length, d = _check(at, {"u": u, "delta": delta, "g": g}, {"B": B, "C": C},
                          {"h0": h0, "dht": dht})
    n = at.shape[0]
    du, dd = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    n_slots = slot_count(n * d, u.device)
    slots = torch.empty(n_slots, n * d, device=u.device, dtype=torch.float32)
    n_parts = LONG_SCAN_BWD.query("lcbi_long_scan_bwd_parts", [ctypes.c_int] * 4,
                                  ctypes.c_longlong, b, length, d, n)
    if n_parts < 0:
        raise ValueError(f"the long-scan backward kernel cannot take (b, L, D, N) = "
                         f"{(b, length, d, n)}")
    parts = torch.empty(n_parts, device=u.device, dtype=torch.float32) if n_parts else None
    dat = torch.empty_like(at)
    LONG_SCAN_BWD(ptr(u), ptr(delta), ptr(at), ptr(B), ptr(C), ptr(g), ptr(h0), ptr(dht),
                  ptr(du), ptr(dd), ptr(dB), ptr(dC), ptr(slots), ptr(parts), ptr(dat), b, length,
                  d, n, int(softplus), n_slots, stream_handle(u.device))
    return du, dd, dat, dB, dC


def long_scan_stitch(x, ap, b, nseg, reverse=False):
    """The K7 stitch kernel (``csrc/selective_scan_long_stitch.cu``):
    :func:`long_scan_stitch_plain` on CUDA tensors x, ap (b * nseg, N, D)."""
    if not x.is_cuda:
        raise ValueError(f"the long-scan stitch kernel takes CUDA tensors, got {x.device}")
    if x.dim() != 3 or x.shape[0] != b * nseg or x.numel() >= 2**31:
        raise ValueError(f"the carries must be (b * nseg, N, D) = ({b} * {nseg}, N, D), got "
                         f"{tuple(x.shape)}")
    for name, t in (("x", x), ("ap", ap)):
        check_cuda_operand(name, t, x.device, torch.float32, x.shape)
    out = torch.empty_like(x)
    LONG_SCAN_STITCH(ptr(x), ptr(ap), ptr(out), b, nseg, x.shape[1] * x.shape[2], int(reverse),
                     stream_handle(x.device))
    return out


def _passes(u):
    """The three passes and the stitch for u's device: the kernels on CUDA,
    the plain versions (the stitch by ``affine_scan``) on the CPU."""
    if u.is_cuda:
        return long_scan_fwd, long_scan_carry_bwd, long_scan_bwd, long_scan_stitch
    return long_scan_fwd_plain, long_scan_carry_bwd_plain, long_scan_bwd_plain, _stitch


class _LongScan(torch.autograd.Function):
    """y of the scan (no D skip; delta with its bias added, before softplus
    with ``softplus``) on fp32 (b, L, D) operands. Forward: the zero-carry
    pass, the stitch, the seeded pass (JAX ``_fwd_impl``). Backward: the
    carry pass, the reverse stitch, the backward pass (JAX
    ``_long_bwd_rule``). On CUDA tensors the stitches are kernels too: no
    torch op runs between the passes."""

    @staticmethod
    def forward(ctx, u, delta, at, B, C, softplus):
        fwd, _, _, stitch = _passes(u)
        b, length, _ = u.shape
        nseg = -(-length // SEG)
        _, hl, ap = fwd(u, delta, at, B, C, None, emit_y=False, softplus=softplus)
        hstart = stitch(hl, ap, b, nseg)
        y, _, _ = fwd(u, delta, at, B, C, hstart, softplus=softplus)
        ctx.softplus = softplus
        ctx.save_for_backward(u, delta, at, B, C, hstart, ap)
        return y

    @staticmethod
    def backward(ctx, g):
        u, delta, at, B, C, hstart, ap = ctx.saved_tensors
        _, carry_bwd, bwd, stitch = _passes(u)
        g = g.float().contiguous()
        b, length, _ = u.shape
        dh0 = carry_bwd(delta, at, C, g, softplus=ctx.softplus)
        dht = stitch(dh0, ap, b, -(-length // SEG), reverse=True)
        return (*bwd(u, delta, at, B, C, g, hstart, dht, softplus=ctx.softplus), None)


def selective_scan_long(u, delta, A, B, C, D=None, delta_bias=None, delta_softplus=True):
    """Channel-minor long-sequence selective scan through K7: u, delta (b,
    L, d); A (d, N); B, C (b, L, N); D and delta_bias (d,) or None. Returns
    (b, L, d) in u.dtype, differentiable in every argument. delta_bias and
    the D skip stay outside the autograd Function (as in the JAX package's
    ``_long_core``), so autograd carries their gradients."""
    if u.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"no long scan for device {u.device}")
    u32 = u.float().contiguous()
    d32 = delta.float()
    if delta_bias is not None:
        d32 = d32 + delta_bias.float()
    y = _LongScan.apply(u32, d32.contiguous(), A.float().t().contiguous(),
                        B.float().contiguous(), C.float().contiguous(), bool(delta_softplus))
    if D is not None:
        y = y + u32 * D.float()
    return y.to(u.dtype)


def selective_scan_long_plain(u, delta, A, B, C, D=None, delta_bias=None, delta_softplus=True):
    """K7's plain version: the same function as :func:`selective_scan_long`
    (same arguments and layout) by the chunked scan of ``ops.selective_scan``."""
    y = selective_scan_chunked(u.transpose(1, 2), delta.transpose(1, 2), A, B.transpose(1, 2),
                               C.transpose(1, 2), D, delta_bias, delta_softplus)
    return y.transpose(1, 2)
