"""Spectral causal convolution (K6): the full-sequence Hyena long conv on
(B, D, L) for 8192 <= L <= 131072, forward and backward.

Counterpart of ``long_context_biomedical_imaging_tpu/ops/spectral_conv.py``
(``spectral_causal_conv`` and its custom VJP): y[b, d, t] = sum_{tau <= t}
k[d, tau] u[b, d, t - tau] + bias[d] u[b, d, t], in u's dtype. On a CUDA
tensor :func:`spectral_causal_conv` launches ``csrc/spectral_conv.cu`` (the
convolution; with ``conj`` the correlation that gives du) and, for the
gradient, ``csrc/spectral_conv_dk.cu`` (dk, summed over the batch in a fixed
order); dbias is dk's lag 0, as in the TPU kernel's backward. The forward
keeps the filter's spectrum, (D, L) complex fp32, for the du call of the
backward, so the filter is transformed once per layer. On a CPU tensor it
runs :func:`spectral_causal_conv_plain` and its ``torch.func.vjp``.

The TPU kernel computes its DFTs as bf16 matrix products (a TPU has a matrix
unit and no FFT), 1e-3 to 1e-2 from an fp32 FFT by its own account. This port
computes the same function as an fp32 FFT, on the card and in the plain
version alike: the kernels' four-step FFT and the plain version's
``torch.fft`` agree to fp32 round-off, and both round the result once to u's
dtype.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, check_cuda_operand, ptr, stream_handle

# Dispatch floor and ceiling of the TPU kernel (spectral_supported).
SPECTRAL_MIN_LEN = 8192
SPECTRAL_MAX_LEN = 131072

SPECTRAL_CONV = CudaKernel(
    "spectral_conv.cu", "lcbi_spectral_conv",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
SPECTRAL_CONV_DK = CudaKernel(
    "spectral_conv_dk.cu", "lcbi_spectral_conv_dk",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _split(n: int):
    """n = n1*n2 with n1 = 2^ceil(e/2) >= n2; None if not a power of two."""
    if n <= 0 or n & (n - 1):
        return None
    e = n.bit_length() - 1
    n1 = 1 << ((e + 1) // 2)
    return n1, n // n1


def spectral_supported(length: int) -> bool:
    return (SPECTRAL_MIN_LEN <= length <= SPECTRAL_MAX_LEN
            and _split(2 * length) is not None)


def spectral_causal_conv_plain(u, k, bias=None):
    """The causal convolution as a zero-padded fp32 ``torch.fft`` product plus
    bias * u in fp32, rounded once to u's dtype. u (B, D, L); k (D, L); bias
    (D,) or None."""
    length = u.shape[-1]
    n = 2 * length
    u32 = u.float()
    spec = torch.fft.rfft(u32, n=n) * torch.fft.rfft(k.float(), n=n)
    y = torch.fft.irfft(spec, n=n)[..., :length]
    if bias is not None:
        y = y + u32 * bias.float()[:, None]
    return y.to(u.dtype)


def spectral_causal_conv_bwd_plain(g, u, k, bias=None):
    """(du, dk, dbias) of :func:`spectral_causal_conv_plain` for the cotangent
    g, by ``torch.func.vjp``, each in its input's dtype (dbias None without a
    bias)."""
    if bias is None:
        _, vjp = torch.func.vjp(lambda a, b: spectral_causal_conv_plain(a, b), u, k)
        return (*vjp(g), None)
    _, vjp = torch.func.vjp(spectral_causal_conv_plain, u, k, bias)
    return vjp(g)


def _check_stream(u):
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"spectral conv kernel takes fp32 or bf16, got {u.dtype}")
    if not u.is_cuda:
        raise ValueError(f"spectral conv kernel takes CUDA tensors, got {u.device}")
    if u.dim() != 3:
        raise ValueError(f"spectral conv kernel takes (B, D, L), got {tuple(u.shape)}")
    b, d, length = u.shape
    if not spectral_supported(length) or b * d >= 2**31:
        raise ValueError(f"spectral conv kernel needs {SPECTRAL_MIN_LEN} <= L <= "
                         f"{SPECTRAL_MAX_LEN}, L a power of two and B*D < 2^31; got "
                         f"{tuple(u.shape)}")
    check_cuda_operand("u", u, u.device, u.dtype, (b, d, length))
    return b, d, length


def _workspace(kernel, symbol, b, d, length, device):
    nbytes = kernel.query(symbol, [ctypes.c_int] * 3, ctypes.c_size_t, b, d, length)
    return torch.empty(nbytes // 4, device=device, dtype=torch.float32)


def spectral_conv_fwd(u, k, bias=None, conj: bool = False, kspec=None):
    """The K6 convolution kernel on CUDA: :func:`spectral_causal_conv_plain`
    of (u, k, bias); with ``conj`` the correlation y[t] = sum_tau k[tau]
    u[t + tau] + bias u[t], which is du for the cotangent u. u (B, D, L) fp32
    or bf16, k (D, L) fp32, bias (D,) fp32 or None. Returns (y, kspec): y
    (B, D, L) in u.dtype, and the filter's spectrum as the kernel lays it out
    (L complex fp32 values per channel), which a later call takes as
    ``kspec`` with k None instead of transforming the filter again."""
    b, d, length = _check_stream(u)
    if (k is None) == (kspec is None):
        raise ValueError("spectral conv kernel takes one of the filter k and its spectrum "
                         "kspec")
    if k is not None:
        check_cuda_operand("k", k, u.device, torch.float32, (d, length))
        nbytes = SPECTRAL_CONV.query("lcbi_spectral_conv_spectrum_bytes", [ctypes.c_int] * 2,
                                     ctypes.c_size_t, d, length)
        kspec = torch.empty(nbytes // 4, device=u.device, dtype=torch.float32)
    check_cuda_operand("kspec", kspec, u.device, torch.float32, (2 * d * length,))
    if bias is not None:
        check_cuda_operand("bias", bias, u.device, torch.float32, (d,))
    work = _workspace(SPECTRAL_CONV, "lcbi_spectral_conv_workspace", b, d, length, u.device)
    y = torch.empty_like(u)
    SPECTRAL_CONV(ptr(u), ptr(k), ptr(kspec), ptr(bias), ptr(y), ptr(work), b, d, length,
                  int(conj), int(u.dtype == torch.bfloat16), stream_handle(u.device))
    return y, kspec


def spectral_conv_dk(g, u):
    """The K6 filter-gradient kernel on CUDA: dk[d, tau] = sum_b sum_t g[b, d,
    t] u[b, d, t - tau], (D, L) fp32, the batch summed in a fixed order. g and
    u: (B, D, L) of one dtype, fp32 or bf16."""
    b, d, length = _check_stream(u)
    check_cuda_operand("g", g, u.device, u.dtype, (b, d, length))
    work = _workspace(SPECTRAL_CONV_DK, "lcbi_spectral_conv_dk_workspace", b, d, length,
                      u.device)
    dk = torch.empty(d, length, device=u.device, dtype=torch.float32)
    SPECTRAL_CONV_DK(ptr(g), ptr(u), ptr(dk), ptr(work), b, d, length,
                     int(u.dtype == torch.bfloat16), stream_handle(u.device))
    return dk


class _SpectralConv(torch.autograd.Function):
    """The causal convolution on (B, D, L). The backward is the TPU kernel's
    (_spec_bwd): du from the conv kernel with the conjugate filter spectrum
    (the forward's, kept) plus bias * g, dk from the dk kernel, dbias =
    dk[:, 0]. On the CPU both directions are the plain version's."""

    @staticmethod
    def forward(ctx, u, k, bias):
        if not u.is_cuda:
            ctx.save_for_backward(u, k, bias, None)
            return spectral_causal_conv_plain(u, k, bias)
        y, kspec = spectral_conv_fwd(u, k, bias)
        ctx.save_for_backward(u, k, bias, kspec)
        return y

    @staticmethod
    def backward(ctx, g):
        u, k, bias, kspec = ctx.saved_tensors
        g = g.to(u.dtype).contiguous()
        if not g.is_cuda:
            return spectral_causal_conv_bwd_plain(g, u, k, bias)
        du, _ = spectral_conv_fwd(g, None, bias, conj=True, kspec=kspec)
        dk = spectral_conv_dk(g, u)
        return du, dk, None if bias is None else dk[:, 0].clone()


def spectral_causal_conv(u, k, bias=None):
    """y = causal(k * u) + bias * u through K6: u (B, D, L) fp32 or bf16 at a
    length :func:`spectral_supported` takes, k (D, L) fp32, bias (D,) fp32 or
    None; (B, D, L) in u.dtype, differentiable in all three. A CUDA tensor goes
    through the kernels (or raises), a CPU tensor through the plain
    versions."""
    if u.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"no spectral conv for device {u.device}")
    return _SpectralConv.apply(u.contiguous(), k.contiguous(),
                               None if bias is None else bias.contiguous())
