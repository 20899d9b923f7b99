"""PyTorch port, the Mamba mixer against the JAX package on the CPU.

* The composed path's pieces: the 'same' depthwise conv and
  ``selective_scan_cm``, forward and gradients.
* K4, the fused Mamba window mixer (its plain version and the VJP of it, as
  the wrapper runs them on the CPU) against the JAX ``mamba_window_mixer``
  with its Pallas kernels in interpret mode, with and without the folded LN,
  fp32 and bf16; the gate.
* ``MambaVisionMixer`` on both routes (the composed path below 1024 windows,
  K4 from 1024) from the same parameters through ``params_from_jax``.

The same numpy inputs (made from a seed) go to both packages; tolerances are
stated per test.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_biomedical_imaging_tpu.models.mamba import MambaVisionMixer as JaxMixer
from long_context_biomedical_imaging_tpu.ops import mamba_window as jmw
from long_context_biomedical_imaging_tpu.ops.conv import depthwise_conv1d_cm as jax_conv
from long_context_biomedical_imaging_tpu.ops.selective_scan import selective_scan_cm as jax_scan
from long_context_biomedical_imaging_tpu_torch.models.mamba import MambaVisionMixer
from long_context_biomedical_imaging_tpu_torch.ops import mamba_window as tmw
from long_context_biomedical_imaging_tpu_torch.ops.conv import depthwise_conv1d_cm
from long_context_biomedical_imaging_tpu_torch.ops.selective_scan import selective_scan_cm
from long_context_biomedical_imaging_tpu_torch.utils.convert import params_from_jax
from test_torch_models import _random_params
from test_torch_ops import _mk

MIXER_NAMES = ["x", "w_xz", "w_conv_x", "w_conv_z", "w_dbl", "w_dt", "dt_bias", "A", "D",
               "w_out", "ln_scale", "ln_bias"]


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _vjp_both(jfn, tfn, arrays, do, bf_idx=(), dtype="float32"):
    """Output and the gradient of every argument of a JAX and a torch
    function on the same numpy arrays (those in bf_idx cast to dtype)."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ja = [jnp.asarray(a).astype(jd) if i in bf_idx else jnp.asarray(a)
          for i, a in enumerate(arrays)]
    jout, jvjp = jax.vjp(jfn, *ja)
    jgrads = jvjp(jnp.asarray(do).astype(jout.dtype))
    leaves = [torch.from_numpy(a).to(td if i in bf_idx else torch.float32).requires_grad_(True)
              for i, a in enumerate(arrays)]
    out = tfn(*leaves)
    out.backward(torch.from_numpy(do).to(out.dtype))
    return jout, jgrads, out, leaves


def _assert_close(got, ref, tol, name=""):
    ref = _f32(ref)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-6), err_msg=name)


@pytest.mark.parametrize("padding", ["same", "causal"])
def test_depthwise_conv_matches_jax(rng, padding):
    """The composed paths' depthwise conv, K = 3 ('same', Mamba) and K = 5
    (causal, Hyena), forward and gradients, fp32: 1e-6 of max (the same
    shift-and-add steps)."""
    k = 3 if padding == "same" else 5
    x, w, b = _mk(rng, (2, 16, 8), 1.0), _mk(rng, (8, k)), _mk(rng, (8,))
    do = _mk(rng, (2, 16, 8), 1.0)
    jout, jgrads, out, leaves = _vjp_both(lambda x, w, b: jax_conv(x, w, b, padding),
                                          lambda x, w, b: depthwise_conv1d_cm(x, w, b, padding),
                                          [x, w, b], do)
    _assert_close(out, jout, 1e-6)
    for name, t, g in zip("xwb", leaves, jgrads):
        _assert_close(t.grad, g, 1e-6, name)


@pytest.mark.parametrize("with_d", [False, True])
def test_selective_scan_cm_matches_jax(rng, with_d):
    """The composed path's scan with the delta bias and softplus (and the D
    skip), fp32 forward and every gradient: 1e-5 of max (the same sequential
    fp32 recurrence; exp and softplus round differently)."""
    b, length, dim, n = 3, 16, 12, 4
    arrays = [_mk(rng, (b, length, dim), 1.0), _mk(rng, (b, length, dim), 0.5),
              -np.exp(_mk(rng, (dim, n))), _mk(rng, (b, length, n), 1.0),
              _mk(rng, (b, length, n), 1.0), _mk(rng, (dim,), 0.1), _mk(rng, (dim,), 1.0)]
    do = _mk(rng, (b, length, dim), 1.0)

    def jfn(u, d, a, bb, cc, bias, dd):
        return jax_scan(u, d, a, bb, cc, dd if with_d else None, delta_bias=bias)

    def tfn(u, d, a, bb, cc, bias, dd):
        return selective_scan_cm(u, d, a, bb, cc, dd if with_d else None, delta_bias=bias)

    jout, jgrads, out, leaves = _vjp_both(jfn, tfn, arrays, do)
    _assert_close(out, jout, 1e-5)
    for name, t, g in zip(["u", "delta", "A", "B", "C", "delta_bias", "D"], leaves, jgrads):
        if name == "D" and not with_d:
            assert t.grad is None
            continue
        _assert_close(t.grad, g, 1e-5, name)


def _mixer_inputs(rng, bw, v, c, n, r):
    dh = c // 2
    x = _mk(rng, (bw, v, c), 1.0)
    weights = [_mk(rng, (c, c)), _mk(rng, (dh, 3)), _mk(rng, (dh, 3)),
               _mk(rng, (dh, r + 2 * n)), _mk(rng, (r, dh)), _mk(rng, (dh,), 0.1),
               -np.exp(_mk(rng, (dh, n))), _mk(rng, (dh,), 1.0), _mk(rng, (c, c))]
    ln = [_mk(rng, (c,), 1.0) + 1.0, _mk(rng, (c,), 0.2)]
    return x, weights, ln


@pytest.mark.parametrize(
    "with_ln,dtype,n", [(False, "float32", 4), (True, "float32", 4), (False, "bfloat16", 4),
                        (True, "bfloat16", 4), (True, "float32", 16)],
    ids=["False-float32", "True-float32", "False-bfloat16", "True-bfloat16",
         "True-float32-d_state16"])
def test_mamba_window_mixer_matches_jax(rng, with_ln, dtype, n):
    """K4 at the JAX test's size (BW 16, V 16, C 24, N 4), and at d_state 16
    (BW 2, V 16, C 32, the widest state the port's kernels take): the port's
    mixer (plain version and its VJP on the CPU) against the JAX mixer's
    Pallas kernels in interpret mode, forward and the gradient of every
    argument. fp32: 1e-4 of max. bf16 (x and the four projection weights in
    bf16): 2e-2 of max (the TPU kernel also rounds the scan's B and C to bf16
    and sums in another order; the VJP rounds cotangents at other points)."""
    bw, v, c, r = (16, 16, 24, 3) if n == 4 else (2, 16, 32, 2)
    x, w, ln = _mixer_inputs(rng, bw, v, c, n, r)
    do = _mk(rng, (bw, v, c), 1.0)

    def jfn(x, *a):
        rest = dict(ln_scale=a[9], ln_bias=a[10]) if with_ln else {}
        return jmw.mamba_window_mixer(x, *a[:9], d_state=n, **rest)

    def tfn(x, *a):
        rest = dict(ln_scale=a[9], ln_bias=a[10]) if with_ln else {}
        return tmw.mamba_window_mixer(x, *a[:9], d_state=n, **rest)

    arrays = [x] + w + (ln if with_ln else [])
    jout, jgrads, out, leaves = _vjp_both(jfn, tfn, arrays, do,
                                          bf_idx={0, 1, 4, 5, 9} if dtype == "bfloat16" else (),
                                          dtype=dtype)
    assert out.dtype == leaves[0].dtype and out.shape == (bw, v, c)
    tol = 1e-4 if dtype == "float32" else 2e-2
    _assert_close(out, jout, tol)
    for name, t, g in zip(MIXER_NAMES, leaves, jgrads):
        assert t.grad is not None and t.grad.dtype == t.dtype, name
        _assert_close(t.grad, g, tol, name)


@pytest.mark.parametrize("v", [8, 16, 24, 40, 64, 72, 512])
def test_mamba_gate_matches_jax(v):
    assert tmw.mamba_window_supported(v) == jmw.mamba_window_supported(v)


def test_plain_backward_is_the_vjp_of_the_plain_forward(rng):
    """mamba_window_bwd_plain (the yardstick of the backward kernel) gives
    what autograd of mamba_window_plain gives, on prepared operands."""
    bw, v, c, n, r = 2, 16, 32, 8, 2
    x, w, ln = _mixer_inputs(rng, bw, v, c, n, r)
    wconv, dtb2, at, dskip = tmw.prepare_operands(*(torch.from_numpy(a) for a in
                                                    (w[1], w[2], w[5], w[6], w[7])))
    args = [torch.from_numpy(x), torch.from_numpy(w[0]), wconv, torch.from_numpy(w[3]),
            torch.from_numpy(w[4]), dtb2, at, dskip, torch.from_numpy(w[8])]
    args += [torch.from_numpy(a) for a in ln]
    do = torch.from_numpy(_mk(rng, (bw, v, c), 1.0))
    leaves = [a.clone().requires_grad_(True) for a in args]
    tmw.mamba_window_plain(*leaves).backward(do)
    for t, g in zip(leaves, tmw.mamba_window_bwd_plain(do, *args)):
        torch.testing.assert_close(g, t.grad, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# MambaVisionMixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,amp", [(4, False), (1024, False), (1024, True)])
def test_mamba_vision_mixer_matches_jax(b, amp):
    """The mixer with the folded pre-LN, as a Swin block calls it, from the
    same parameters: at b = 4 windows both packages run the composed path
    (selective_scan_cm), at b = 1024 both the fused K4. fp32: 1e-4 of max;
    bf16 (AMP: parameters and stream in bf16): 2e-2 of max."""
    v, c = 16, 32
    rng = np.random.default_rng(b)
    jm = JaxMixer(d_model=c)
    shapes = flax.serialization.to_state_dict(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, v, c)))["params"]))
    params = _random_params(shapes, rng)
    port = MambaVisionMixer(c)
    port.load_state_dict(params_from_jax(params), strict=True)
    u = _mk(rng, (b, v, c), 1.0)
    s, bias = _mk(rng, (c,), 0.2) + 1.0, _mk(rng, (c,), 0.2)
    jd, td = (jnp.bfloat16, torch.bfloat16) if amp else (jnp.float32, torch.float32)
    ref = jm.apply({"params": jax.tree.map(lambda a: jnp.asarray(a).astype(jd), params)},
                   jnp.asarray(u).astype(jd),
                   ln_params=(jnp.asarray(s).astype(jd), jnp.asarray(bias).astype(jd)))
    with torch.no_grad():
        out = port.to(td)(torch.from_numpy(u).to(td),
                          ln_params=(torch.from_numpy(s).to(td), torch.from_numpy(bias).to(td)))
    assert out.dtype == td and out.shape == (b, v, c)
    _assert_close(out, ref, 2e-2 if amp else 1e-4)
