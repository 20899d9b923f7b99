"""PyTorch port, the composed Hyena path against the JAX package on the CPU:
the causal depthwise short conv (``ops/conv.py``) and the causal long conv
(``ops/fftconv.py``) in its three regimes, forward and gradients, from the
same numpy inputs. Tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_biomedical_imaging_tpu.ops import conv as jconv
from long_context_biomedical_imaging_tpu.ops import fftconv as jfft
from long_context_biomedical_imaging_tpu_torch.ops import conv as tconv
from long_context_biomedical_imaging_tpu_torch.ops import fftconv as tfft

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _mk(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _both(fn_j, fn_t, arrays, dtype, do):
    """Forward and the gradients of sum(out * do) in every argument, JAX and
    port, from the same numpy arrays cast to ``dtype`` (the first argument
    only; filters stay fp32 as the model passes them)."""
    jd, td = _DT[dtype]
    ja = [jnp.asarray(arrays[0]).astype(jd)] + [jnp.asarray(a) for a in arrays[1:]]
    ta = [torch.from_numpy(arrays[0]).to(td).requires_grad_(True)] + [
        torch.from_numpy(a).requires_grad_(True) for a in arrays[1:]]
    jout, jvjp = jax.vjp(fn_j, *ja)
    jgrads = jvjp(jnp.asarray(do).astype(jout.dtype))
    tout = fn_t(*ta)
    tout.backward(torch.from_numpy(do).to(tout.dtype))
    f = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    return (f(jout), [f(g) for g in jgrads], tout.detach().float().numpy(),
            [t.grad.float().numpy() for t in ta], tout.dtype)


def _close(got, ref, rel, name):
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-6),
                               err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length,c", [(16, 256), (256, 256), (512, 128)])
def test_depthwise_conv1d_cm_matches_jax(rng, length, c, dtype):
    """Causal 5-tap depthwise conv in the input dtype: forward and dx, dw,
    db. fp32: 1e-6 of max (the same five products, summed in the same
    order). bf16: every step rounds to bf16 on both sides, but XLA may keep
    fp32 between fused steps, so 1e-2 of max (one bf16 ulp is 7.8e-3)."""
    x, w, b = _mk(rng, (2, length, c)), _mk(rng, (c, 5), 0.4), _mk(rng, (c,), 0.4)
    do = _mk(rng, (2, length, c))
    jo, jg, to, tg, tdt = _both(
        lambda x, w, b: jconv.depthwise_conv1d_cm(x, w, b, padding="causal"),
        lambda x, w, b: tconv.depthwise_conv1d_cm(x, w, b),
        [x, w, b], dtype, do)
    assert tdt == _DT[dtype][1] and to.shape == (2, length, c)
    rel = 1e-6 if dtype == "float32" else 1e-2
    _close(to, jo, rel, "out")
    for name, g, r in zip(("dx", "dw", "db"), tg, jg):
        _close(g, r, rel if dtype == "float32" else 3e-2, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length,c", [(16, 256), (256, 256), (512, 128)])
def test_causal_long_conv_cm_matches_jax(rng, length, c, dtype):
    """The long conv with its skip term in the direct (L = 16) and Toeplitz
    (L = 256, 512) regimes; L*L*C*itemsize stays <= 256 MB, so both packages
    take the same regime. Forward and du, dk, dbias. fp32: 1e-5 of max
    (summation order over up to 512 taps). bf16: forward and du 1e-2 of max
    (a bf16 ulp; the direct form rounds every step); dk and dbias are held in
    fp32 only, where the JAX package's Toeplitz backward is exact: in bf16 it
    rounds its fp32 lag products to bf16 before the diagonal sums
    (ops/fftconv.py:401), which this port does not copy."""
    u, k, bias = _mk(rng, (2, length, c)), _mk(rng, (c, length), 0.2), _mk(rng, (c,), 0.5)
    do = _mk(rng, (2, length, c))
    jo, jg, to, tg, tdt = _both(jfft.causal_long_conv_cm, tfft.causal_long_conv_cm,
                                [u, k, bias], dtype, do)
    assert tdt == _DT[dtype][1] and to.shape == (2, length, c)
    fp32 = dtype == "float32"
    _close(to, jo, 1e-5 if fp32 else 1e-2, "out")
    _close(tg[0], jg[0], 1e-5 if fp32 else 2e-2, "du")
    if fp32:
        _close(tg[1], jg[1], 1e-5, "dk")
        _close(tg[2], jg[2], 1e-5, "dbias")


def test_causal_long_conv_cm_fft_regime_matches_jax(rng):
    """Past the Toeplitz ceiling both packages transpose to (B, D, L) and call
    fft_causal_conv, which at L <= 512 runs a direct depthwise convolution in
    u's dtype with the skip term summed in fp32. fp32 at (L, C) = (512, 384),
    the emb stage-2 window (L*L*C*4 = 402 MB): forward and every gradient
    within 1e-5 of max (sum order). bf16 at (512, 1024), a Swin-base 3D
    window (L*L*C*2 = 537 MB): both convolve in bf16 and round once, the
    forward, du and dk within 1e-2 of max (a bf16 ulp), dbias, an fp32 sum
    of g * u, within 1e-5."""
    for (length, c), dtype in (((512, 384), "float32"), ((512, 1024), "bfloat16")):
        u, k, bias = _mk(rng, (1, length, c)), _mk(rng, (c, length), 0.2), _mk(rng, (c,), 0.5)
        assert length * length * c * (4 if dtype == "float32" else 2) > tfft.TOEPLITZ_MAX_BYTES
        assert tfft.long_conv_route(length) == "direct"
        do = _mk(rng, (1, length, c))
        jo, jg, to, tg, tdt = _both(jfft.causal_long_conv_cm, tfft.causal_long_conv_cm,
                                    [u, k, bias], dtype, do)
        assert tdt == _DT[dtype][1]
        rel = 1e-5 if dtype == "float32" else 1e-2
        _close(to, jo, rel, "out")
        for name, g, r in zip(("du", "dk", "dbias"), tg, jg):
            _close(g, r, 1e-5 if name == "dbias" else rel, name)


@pytest.mark.parametrize("ch", [4, 8])
def test_diagonal_and_lag_sums(rng, ch):
    """The filter-gradient reductions against loops in float64: the per-offset
    diagonal sums of a block and their placement by chunk distance, exact
    up to fp32 summation (1e-5)."""
    n, c = 3, 2
    a = _mk(rng, (n, c, ch, ch))
    s = tfft.diagonal_sums(torch.from_numpy(a)).numpy()
    ref = np.zeros((n, c, 2 * ch - 1))
    for i in range(ch):
        for j in range(ch):
            ref[:, :, j - i + ch - 1] += a[:, :, i, j]
    np.testing.assert_allclose(s, ref, rtol=0, atol=1e-5)
    length = n * ch - 1
    lags = tfft.lag_sums(torch.from_numpy(s), length).numpy()
    want = np.zeros((c, length))
    for d in range(n):
        for o in range(-(ch - 1), ch):
            if 0 <= d * ch + o < length:
                want[:, d * ch + o] += ref[d, :, o + ch - 1]
    np.testing.assert_allclose(lags, want, rtol=0, atol=1e-5)
