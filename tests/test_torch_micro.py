"""PyTorch port, the micro path (2D Swin + Mamba + UperNet2D enhancement,
CombinationEnhance) and its windowed scan K9 against the JAX package on the
CPU.

* ``selective_scan_window`` (K9's autograd Function on CPU tensors: its plain
  forward and backward) and its plain version against the JAX package's
  Pallas ``selective_scan_pallas`` in interpret mode: y and the gradients of
  u, delta, A, B, C, D and delta_bias at L = 4, 9, 49 and 64 and d = 130 (two
  TPU channel chunks), fp32 and with a bf16 stream; the refusals.
* The Mamba mixer's scan routes as the JAX package routes them: K9 for
  49-token windows in calls of 2048 windows, K4 for 16-token windows in
  calls of 1024, ``selective_scan_cm`` for 49-token windows below 2048.
* The enhancement losses (MSE, Charbonnier, the separable gaussian
  derivative loss, the combined loss with its non-finite terms zeroed), per
  batch and per sample, at T = 1 and T = 8, forward and gradient.
* PSNR and SSIM, on the host and on the device, the enhance train metrics
  and the metric manager.
* A tiny micro_w7 model (embed 32, depths 1/1/1/1, patch 2, window 7 on a
  64x64 image, whose token grids 7 does not divide) from converted JAX
  parameters, with the windowed-scan gate forced in both packages: the
  UperNet2D output and one train step's loss and gradients under
  CombinationEnhance.
* Tiny micro runs through ``run_torch.main``, with ``projects/run_micro.sh``'s
  flags at window 7 and as shipped (window 4), each with an inference-only
  rerun that reproduces its SSIM and PSNR.

The same numpy inputs (made from a seed) go to both packages; tolerances are
stated per test.
"""

import os
import re
import sys
import types

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from long_context_biomedical_imaging_tpu.losses import enhancement_losses as jloss
from long_context_biomedical_imaging_tpu.metrics import device as jdev
from long_context_biomedical_imaging_tpu.metrics import functional as jfunc
from long_context_biomedical_imaging_tpu.models import build_model as jax_build_model
from long_context_biomedical_imaging_tpu.models import mamba as jmamba
from long_context_biomedical_imaging_tpu.ops import selective_scan_pallas as jpallas
from long_context_biomedical_imaging_tpu.setup import parse_config as jax_parse_config
from long_context_biomedical_imaging_tpu.setup.config import check_args as jax_check_args
from long_context_biomedical_imaging_tpu_torch.losses import enhancement_losses as tloss
from long_context_biomedical_imaging_tpu_torch.losses import get_loss_func
from long_context_biomedical_imaging_tpu_torch.metrics import device as tdev
from long_context_biomedical_imaging_tpu_torch.metrics import functional as tfunc
from long_context_biomedical_imaging_tpu_torch.models import build_model
from long_context_biomedical_imaging_tpu_torch.models import mamba as tmamba
from long_context_biomedical_imaging_tpu_torch.ops import selective_scan_window as twin
from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
from long_context_biomedical_imaging_tpu_torch.trainer import amp_params
from long_context_biomedical_imaging_tpu_torch.utils.convert import params_from_jax
from test_torch_models import _random_params
from test_torch_vessel import _close, _DropoutOff, _no_dropout, _random_batch_stats

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from chip_smoke import project_flags  # noqa: E402
from run_torch import main  # noqa: E402

SCAN_ARGS = ("y", "u", "delta", "A", "B", "C", "D", "delta_bias")
# of each output's max|reference|: fp32, sum order and the exp2 / exp forms;
# bf16 stream, the output and the stream gradients rounded once to bf16 on
# both sides (a bf16 ulp is 3.9e-3 relative)
SCAN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the tiny micro_w7 model: 64x64, patch 2: token grids 32, 16, 8 and 4 (7
# divides none, so every block pads; the last stage's window shrinks to 4)
TINYM_ARGV = ["--task_type=enhance", "--encoder_name=Swin", "--decoder_name=UperNet2D",
              "--height=64", "--width=64", "--no_in_channel=1", "--no_out_channel=1",
              "--seed=3", "--Swin.size=custom", "--Swin.embed_dim=32",
              "--Swin.depths", "1", "1", "1", "1", "--Swin.num_heads", "2", "2", "2", "2",
              "--Swin.patch_size", "2", "--Swin.window_size", "7",
              "--Swin.use_hyena", "False", "--Swin.use_mamba", "True",
              "--loss_func=CombinationEnhance", "--exact_metrics=False"]
XM = (4, 1, 64, 64, 1)
MODEL_GRAD_TOL = 1e-4


# ---------------------------------------------------------------------------
# K9, the windowed scan
# ---------------------------------------------------------------------------

def _scan_inputs(seed, bw, length, d, n=8):
    """u, delta, A, B, C, D, delta_bias and a cotangent, numpy fp32; A as
    A_log's init (-(1..n) per channel) times noise."""
    rng = np.random.default_rng(seed)
    a = -np.arange(1, n + 1) * np.exp(0.3 * rng.normal(size=(d, n)))
    arrs = [rng.normal(size=(bw, length, d)), rng.normal(size=(bw, length, d)), a,
            rng.normal(size=(bw, length, n)), rng.normal(size=(bw, length, n)),
            rng.normal(size=d), rng.normal(size=d), rng.normal(size=(bw, length, d))]
    return [x.astype(np.float32) for x in arrs]


def _torch_vjp(fn, arrs, dtype):
    """fn's output and its gradients for the cotangent arrs[-1] through
    torch.autograd, as fp32 numpy; u, delta, B, C and the cotangent in
    dtype."""
    leaves = [torch.from_numpy(a).to(dtype if i in (0, 1, 3, 4) else torch.float32)
              .requires_grad_(True) for i, a in enumerate(arrs[:-1])]
    y = fn(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(arrs[-1]).to(dtype))
    return [t.detach().float().numpy() for t in (y, *grads)]


def _jax_vjp(fn, arrs, dtype):
    xs = [jnp.asarray(a).astype(dtype if i in (0, 1, 3, 4) else jnp.float32)
          for i, a in enumerate(arrs[:-1])]
    y, vjp = jax.vjp(fn, *xs)
    return [np.asarray(t.astype(jnp.float32)) for t in (y, *vjp(jnp.asarray(arrs[-1]).astype(
        dtype)))]


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,length,d", [(24, 4, 8), (16, 9, 12), (10, 49, 16), (6, 64, 130)])
def test_window_scan_matches_jax(bw, length, d, dname):
    """K9's autograd Function on CPU tensors (its plain forward and
    backward; no kernel launches) and its plain version (selective_scan_cm)
    against the JAX package's Pallas selective_scan_pallas in interpret
    mode: y and the gradients of all seven inputs, at L = 4, 9, 49 (the 7x7
    window) and 64, and d = 130 (two TPU channel chunks), within
    SCAN_TOL of each output's max|reference|."""
    arrs = _scan_inputs(length * 1000 + d, bw, length, d)
    tdt = getattr(torch, dname)
    before = (twin.WINDOW_SCAN_FWD.launches, twin.WINDOW_SCAN_BWD.launches)
    got = _torch_vjp(twin.selective_scan_window, arrs, tdt)
    plain = _torch_vjp(twin.selective_scan_window_plain, arrs, tdt)
    assert (twin.WINDOW_SCAN_FWD.launches, twin.WINDOW_SCAN_BWD.launches) == before
    ref = _jax_vjp(jpallas.selective_scan_pallas, arrs, getattr(jnp, dname))
    for out in (got, plain):
        for name, a, r in zip(SCAN_ARGS, out, ref):
            _close(a, r, SCAN_TOL[dname], name)


def test_window_scan_function_passes_match_plain_vjp():
    """The Function's two passes, each against its plain definition: the
    forward is selective_scan_cm without its D skip and bias, the backward
    its VJP; without softplus as well. fp32, within 1e-6 of max."""
    u, delta, a, bm, cm, _, _, g = (torch.from_numpy(x) for x in _scan_inputs(5, 12, 49, 20))
    at = a.t().contiguous()
    for softplus in (True, False):
        d = delta if softplus else torch.nn.functional.softplus(delta)
        y = twin.window_scan_fwd_plain(u, d, at, bm, cm, softplus)
        ref = twin.selective_scan_window_plain(u, d, a, bm, cm, delta_softplus=softplus)
        torch.testing.assert_close(y, ref, rtol=0, atol=1e-6 * ref.abs().max().item())
        leaves = [t.clone().requires_grad_(True) for t in (u, d, at, bm, cm)]
        out = twin._WindowScan.apply(*leaves, softplus)
        got = torch.autograd.grad(out, leaves, g)
        want = twin.window_scan_bwd_plain(u, d, at, bm, cm, g, softplus)
        for x, w in zip(got, want):
            torch.testing.assert_close(x, w, rtol=0, atol=1e-6 * w.abs().max().item())


def test_window_scan_refuses():
    """The public op refuses L > 64 and N * d > 8192 on every device
    (ValueError naming the limit); the kernels' wrappers take CUDA tensors
    only (ValueError naming CUDA)."""
    bc = torch.zeros(4, 65, 8)
    with pytest.raises(ValueError, match="L <= 64"):
        twin.selective_scan_window(torch.zeros(4, 65, 16), torch.zeros(4, 65, 16),
                                   -torch.ones(16, 8), bc, bc)
    bc = torch.zeros(4, 49, 8)
    with pytest.raises(ValueError, match="8192"):
        twin.selective_scan_window(torch.zeros(4, 49, 1025), torch.zeros(4, 49, 1025),
                                   -torch.ones(1025, 8), bc, bc)
    u, at = torch.zeros(4, 49, 16), torch.zeros(8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        twin.window_scan_fwd(u, u, at, bc, bc)
    with pytest.raises(ValueError, match="CUDA"):
        twin.window_scan_bwd(u, u, at, bc, bc, u)


# ---------------------------------------------------------------------------
# The Mamba mixer's routes
# ---------------------------------------------------------------------------

def test_mamba_routes_as_jax(monkeypatch):
    """The mixer's route by window count and length, spied on in both
    packages: 49-token windows in a call of 2048 windows take K9 (the
    port's selective_scan_window, JAX's selective_scan_pallas), 16-token
    windows in a call of 1024 the fused K4 mixer, 49-token windows in a call
    of 2047 selective_scan_cm; with the windowed-scan gates forced off the
    2048-window call takes selective_scan_cm in both, and the port's output
    is the same within 1e-5 of max. The JAX side is traced, not run
    (jax.eval_shape). The gates agree on a table of shapes."""
    for args in ((49, 8, 48, 21904), (49, 8, 96, 5476), (49, 8, 192, 1444), (64, 8, 1024, 2048),
                 (64, 8, 1025, 4096), (65, 8, 8, 4096), (9, 8, 48, 2047), (4, 8, 16, None)):
        assert (twin.window_scan_supported(*args[:3], batch=args[3])
                == jpallas.pallas_scan_supported(*args[:3], batch=args[3])), args
    jm = jmamba.MambaVisionMixer(d_model=16, d_state=8, d_conv=3, expand=1)
    jparams = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16)))
    calls = {"jax": [], "torch": []}
    for pkg, mod, names in (("jax", jmamba, ("selective_scan_pallas", "selective_scan_cm",
                                              "mamba_window_mixer")),
                            ("torch", tmamba, ("selective_scan_window", "selective_scan_cm",
                                               "mamba_window_mixer"))):
        for name in names:
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=real, _p=pkg, **k:
                                calls[_p].append(_n) or _f(*a, **k))
    gen = torch.Generator().manual_seed(0)
    mixer = tmamba.MambaVisionMixer(16, d_state=8, d_conv=3, expand=1)
    mixer.init_params(gen)
    cases = [(2048, 49), (1024, 16), (2047, 49)]
    with torch.no_grad():
        for bw, length in cases:
            mixer(torch.randn(bw, length, 16, generator=gen))
            jax.eval_shape(lambda x: jm.apply(jparams, x), jnp.zeros((bw, length, 16)))
        expected = ["selective_scan_window", "mamba_window_mixer", "selective_scan_cm"]
        assert calls["torch"] == expected
        assert calls["jax"] == ["selective_scan_pallas", "mamba_window_mixer",
                                "selective_scan_cm"]
        x = torch.randn(2048, 49, 16, generator=gen)
        ref = mixer(x)
        monkeypatch.setattr(tmamba, "_window_scan_supported", lambda *a, **k: False)
        monkeypatch.setattr(jmamba, "pallas_scan_supported", lambda *a, **k: False)
        forced = mixer(x)
        jax.eval_shape(lambda x: jm.apply(jparams, x), jnp.zeros((2048, 49, 16)))
    assert calls["torch"][3:] == ["selective_scan_window", "selective_scan_cm"]
    assert calls["jax"][3:] == ["selective_scan_cm"]
    torch.testing.assert_close(forced, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


# ---------------------------------------------------------------------------
# The enhancement losses
# ---------------------------------------------------------------------------

_TERMS = {"mse": (tloss.mse_loss, jloss.mse_loss),
          "charbonnier": (tloss.charbonnier_loss, jloss.charbonnier_loss),
          "gaussian_deriv3d": (tloss.gaussian_deriv3d_loss, jloss.gaussian_deriv3d_loss),
          "combined": (tloss.combined_enhance_loss, jloss.combined_enhance_loss)}


def _loss_pair(term, time, channels, complex_i, seed):
    rng = np.random.default_rng(seed)
    shape = (3, time, 24, 20, channels)
    o = rng.normal(size=shape).astype(np.float32)
    t = (0.7 * o + 0.5 * rng.normal(size=shape)).astype(np.float32)
    return _TERMS[term], o, t, complex_i


def _loss_and_grad(tfn, jfn, o, t, complex_i):
    """(port loss, port d loss / d outputs, JAX loss, JAX gradient) per
    batch, and the per-sample losses of both (JAX: the loss mapped over the
    samples, as its eval step maps it)."""
    ot = torch.from_numpy(o).requires_grad_(True)
    loss = tfn(ot, torch.from_numpy(t), complex_i)
    (grad,) = torch.autograd.grad(loss, ot)
    jl, jg = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(t), complex_i))(jnp.asarray(o))
    per = tfn(torch.from_numpy(o), torch.from_numpy(t), complex_i, reduction="none")
    jper = jax.vmap(lambda a, b: jfn(a[None], b[None], complex_i))(jnp.asarray(o), jnp.asarray(t))
    return (loss.item(), grad.numpy(), float(jl), np.asarray(jg), per.numpy(), np.asarray(jper))


@pytest.mark.parametrize("time", [1, 8])
@pytest.mark.parametrize("term", sorted(_TERMS))
def test_enhancement_losses_match_jax(term, time):
    """Each term and the combined loss against the JAX package's, at T = 1
    (micro) and T = 8 (the gaussian loss's time axis in play), with one
    channel and with two in complex mode: the batch loss within 1e-5
    (relative), its gradient within 1e-5 of max, the per-sample losses
    within 1e-5 (relative)."""
    for channels, complex_i in ((1, False), (2, True)):
        (tfn, jfn), o, t, cx = _loss_pair(term, time, channels, complex_i, 7 + time)
        loss, grad, jl, jg, per, jper = _loss_and_grad(tfn, jfn, o, t, cx)
        np.testing.assert_allclose(loss, jl, rtol=1e-5)
        _close(grad, jg, 1e-5, term)
        assert per.shape == (3,)
        np.testing.assert_allclose(per, jper, rtol=1e-5)


@pytest.mark.parametrize("time", [1, 8])
def test_combined_loss_zeroes_non_finite_terms_as_jax(time):
    """Outputs of 1e20 in one sample overflow the squared terms (MSE and
    Charbonnier are infinite) while the gaussian term stays finite: the
    combined loss keeps the finite term alone, per batch and in that sample,
    and its gradient is finite, as the JAX package's (1e-5). A NaN output
    makes every term NaN: the combined loss is 0 in both packages and the
    gradients are NaN at the same places."""
    (tfn, jfn), o, t, _ = _loss_pair("combined", time, 1, False, 3)
    o[1] *= 1e20
    loss, grad, jl, jg, per, jper = _loss_and_grad(tfn, jfn, o, t, False)
    g_only = tloss.gaussian_deriv3d_loss(torch.from_numpy(o), torch.from_numpy(t)).item()
    assert np.isfinite(loss) and abs(loss - g_only) <= 1e-6 * abs(g_only)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert np.isfinite(grad).all()
    _close(grad, jg, 1e-5)
    np.testing.assert_allclose(per, jper, rtol=1e-5)
    o[0, 0, 3, 4, 0] = np.nan
    loss, grad, jl, jg, per, jper = _loss_and_grad(tfn, jfn, o, t, False)
    assert loss == float(jl) == 0.0
    np.testing.assert_array_equal(np.isnan(grad), np.isnan(jg))
    np.testing.assert_allclose(per, jper, rtol=1e-5)
    assert per[0] == 0.0


def test_get_loss_func_returns_the_enhancement_losses():
    """MSE and CombinationEnhance are the registry's, as the JAX package's;
    an unknown name raises."""
    rng = np.random.default_rng(0)
    o, t = (rng.normal(size=(2, 1, 8, 8, 1)).astype(np.float32) for _ in range(2))
    assert get_loss_func("CombinationEnhance") is tloss.combined_enhance_loss
    np.testing.assert_allclose(get_loss_func("MSE")(torch.from_numpy(o), torch.from_numpy(t))
                               .item(), float(jloss.mse_loss(o, t)), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        get_loss_func("L1")


# ---------------------------------------------------------------------------
# PSNR and SSIM
# ---------------------------------------------------------------------------

def _images(seed, shape):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=shape).astype(np.float32)
    return (t + 0.4 * rng.normal(size=shape)).astype(np.float32), t


@pytest.mark.parametrize("shape", [(3, 1, 30, 27, 1), (2, 12, 14, 16, 1), (2, 1, 20, 20, 2)])
def test_psnr_ssim_match_jax(shape):
    """The host PSNR and SSIM (torchmetrics semantics: data_range from the
    target, a gaussian window of 11, sigma 1.5, reflect padding, the margin
    cropped) on the manager's (B, C, [T,] H, W) layout, within 1e-12
    (float64; the port filters one axis at a time); and their device forms
    over the valid rows of the model's (B, T, H, W, C) layout, directly and
    through the enhance train metric function, within 1e-5 (fp32)."""
    o, t = _images(sum(shape), shape)
    om, tm = np.moveaxis(o, -1, 1), np.moveaxis(t, -1, 1)
    if shape[1] == 1:
        om, tm = om[:, :, 0], tm[:, :, 0]
    for name in ("psnr", "ssim"):
        np.testing.assert_allclose(getattr(tfunc, name)(om, tm), getattr(jfunc, name)(om, tm),
                                   rtol=1e-12)
    valid = np.array([1] * (shape[0] - 1) + [0], np.float32)
    args = (torch.from_numpy(o), torch.from_numpy(t), torch.from_numpy(valid))
    jargs = (jnp.asarray(o), jnp.asarray(t), jnp.asarray(valid))
    for name in ("psnr_device", "ssim_device"):
        np.testing.assert_allclose(getattr(tdev, name)(*args).item(),
                                   float(getattr(jdev, name)(*jargs)), rtol=1e-5)
    argv = ["--task_type=enhance", "--no_out_channel=1", "--exact_metrics=False"]
    names, fn = tdev.make_train_metric_fn(check_args(parse_config(argv)))
    jnames, jfn = jdev.make_train_metric_fn(jax_check_args(jax_parse_config(argv)))
    assert names == jnames == ("ssim", "psnr")
    np.testing.assert_allclose(fn(*args).numpy(), np.asarray(jfn(*jargs[:2], shape[0] - 1)),
                               rtol=1e-5)


def test_enhance_metric_manager_matches_jax(tmp_path):
    """The enhance metric manager over two eval batches: loss, SSIM and PSNR
    averaged as the JAX manager averages them, and the saved (C, H, W)
    predictions equal."""
    from long_context_biomedical_imaging_tpu.metrics.manager import MetricManager as JaxManager
    from long_context_biomedical_imaging_tpu_torch.metrics import MetricManager

    argv = ["--task_type=enhance", "--no_out_channel=1", "--exact_metrics=False",
            f"--log_dir={tmp_path}", "--run_name=r"]
    managers = {}
    for name, cls, cfg in (("jax", JaxManager, jax_check_args(jax_parse_config(argv))),
                           ("torch", MetricManager, check_args(parse_config(argv)))):
        cfg.log_dir_run = str(tmp_path / name)
        m = cls(cfg)
        (m.setup_wandb_and_metrics if name == "jax" else m.setup_metrics)()
        m.on_eval_epoch_start()
        managers[name] = m
    batches = [(0.7, *_images(1, (4, 1, 24, 22, 1)), [f"a{i}" for i in range(4)]),
               (0.4, *_images(2, (2, 1, 24, 22, 1)), ["b0", "b1"])]
    for loss, out, lab, ids in batches:
        for m in managers.values():
            m.on_eval_step_end(loss, out, lab, ids, save_samples=True, split="test")
    got = managers["torch"].on_eval_epoch_end(None, 0, "test", final_eval=True)
    ref = managers["jax"].on_eval_epoch_end(None, 0, "test", final_eval=True)
    assert list(got) == list(ref) == ["loss", "ssim", "psnr"]
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12)
    for sid in ("a0", "b1"):
        saved = np.load(tmp_path / "torch" / "saved_samples" / "test" / f"{sid}_output.npy")
        assert saved.shape == (1, 24, 22)
        np.testing.assert_array_equal(
            saved, np.load(tmp_path / "jax" / "saved_samples" / "test" / f"{sid}_output.npy"))


def test_enhance_eval_loss_is_per_sample_over_valid_rows():
    """The eval step's CombinationEnhance loss: each sample's loss over that
    sample alone, averaged over the valid rows, as the JAX eval step maps the
    loss over the samples (1e-6 relative); float targets pass unchanged."""
    from long_context_biomedical_imaging_tpu.losses import get_loss_func as jax_get_loss_func
    from long_context_biomedical_imaging_tpu.trainer.train_state import (
        make_eval_step as jax_make_eval_step)
    from long_context_biomedical_imaging_tpu_torch.trainer import make_eval_step

    out, lab = _images(4, (5, 1, 16, 18, 1))
    identity = types.SimpleNamespace(apply=lambda variables, x, **kw: x)
    jstep = jax_make_eval_step(identity, jax_get_loss_func("CombinationEnhance"))
    state = types.SimpleNamespace(params={}, batch_stats={})
    tstep = make_eval_step(torch.nn.Identity(), get_loss_func("CombinationEnhance"))
    for n_valid in (5, 3):
        ref, _ = jstep(state, jnp.asarray(out), jnp.asarray(lab), n_valid)
        got, o = tstep({}, torch.from_numpy(out), torch.from_numpy(lab), n_valid)
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
        assert o.shape == out.shape


# ---------------------------------------------------------------------------
# The tiny micro_w7 model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tinym():
    """(JAX model, params, batch_stats) of the tiny micro_w7 geometry."""
    rng = np.random.default_rng(12)
    jm = jax_build_model(jax_check_args(jax_parse_config(TINYM_ARGV)))
    shapes = flax.serialization.to_state_dict(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros(XM), deterministic=True)))
    return (jm, _random_params(shapes["params"], rng),
            _random_batch_stats(shapes["batch_stats"], rng))


def _port_model(argv, params, bs):
    model = build_model(check_args(parse_config(argv)))
    model.load_state_dict(params_from_jax({"params": params, "batch_stats": bs}), strict=True)
    return _no_dropout(model)


@pytest.fixture
def forced_k9(monkeypatch):
    """The windowed-scan gate forced open in both packages (the tiny model's
    calls have fewer than 2048 windows), the port's K9 calls recorded."""
    monkeypatch.setattr(jmamba, "pallas_scan_supported",
                        lambda length, n, d, batch=None: jpallas.pallas_scan_supported(length, n, d))
    monkeypatch.setattr(tmamba, "_window_scan_supported",
                        lambda length, n, d, batch=None: twin.window_scan_supported(length, n, d))
    calls, real = [], tmamba.selective_scan_window
    monkeypatch.setattr(tmamba, "selective_scan_window",
                        lambda *a, **k: calls.append(tuple(a[0].shape)) or real(*a, **k))
    return calls


# each stage's K9 call at batch 4: (windows, tokens, d_half); stage 3's 4x4
# grid shrinks the window to 4
TINYM_K9_CALLS = [(100, 49, 16), (36, 49, 32), (16, 49, 64), (4, 16, 128)]


def test_tiny_micro_forward_matches_jax(tinym, forced_k9):
    """The eval forward (running statistics) of the whole tiny micro_w7
    model, each block through the per-block pad path and K9 (the JAX
    package's in interpret mode): the UperNet2D output (B, 1, H, W, 1), fp32,
    within 1e-4 of max; the converted tree loads strictly."""
    jm, params, bs = tinym
    x = np.random.default_rng(13).normal(size=XM).astype(np.float32)
    ref = jax.jit(lambda p, x: jm.apply({"params": p, "batch_stats": bs}, x, deterministic=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    model = _port_model(TINYM_ARGV, params, bs).eval()
    with torch.no_grad():
        out = functional_call(model, amp_params(model, False), (torch.from_numpy(x),))
    assert forced_k9 == TINYM_K9_CALLS
    assert out.shape == XM
    _close(out, ref, 1e-4)


def test_tiny_micro_train_step_matches_jax(tinym, forced_k9):
    """One fp32 train step of the tiny micro_w7 model under CombinationEnhance
    against the JAX make_train_step, K9 forced in both (the JAX package's in
    interpret mode), dropout off, BatchNorm on batch statistics, batch 4 (at
    batch 2 the bin-1 BatchNorm's two values per channel leave fp32 gradients
    0.5 of max from float64's in either package): the loss to 1e-5 (relative)
    and every parameter's gradient within MODEL_GRAD_TOL of its max|g|."""
    from long_context_biomedical_imaging_tpu.losses import get_loss_func as jax_get_loss_func
    from long_context_biomedical_imaging_tpu.trainer.train_state import (
        create_train_state, make_train_step as jax_make_train_step)
    from long_context_biomedical_imaging_tpu_torch.optim import OptimManager
    from long_context_biomedical_imaging_tpu_torch.trainer import make_train_step
    from test_torch_train import _keep_grads

    jm, params, bs = tinym
    x, y = _images(14, XM)
    # images that differ in scale and offset: PSP's bin-1 BatchNorm
    # normalises 4 pooled values per channel with the fast variance, which
    # fp32 rounding moves far where they nearly agree (tests/test_torch_vessel.py)
    x = (x * np.float32([0.5, 1.0, 1.5, 2.0]).reshape(4, 1, 1, 1, 1)
         + np.float32([-1.0, -0.3, 0.3, 1.0]).reshape(4, 1, 1, 1, 1))
    state = create_train_state(jm, {"params": jax.tree.map(jnp.asarray, params),
                                    "batch_stats": jax.tree.map(jnp.asarray, bs)}, _keep_grads())
    step = jax.jit(jax_make_train_step(_DropoutOff(jm), jax_get_loss_func("CombinationEnhance"),
                                       _keep_grads(), use_amp=False, return_output=False))
    new, jl, _ = step(state, jnp.asarray(x), jnp.asarray(y), 0.0, jax.random.PRNGKey(0))
    jgrads = {k: v.float().numpy() for k, v in params_from_jax(jax.tree.map(
        np.asarray, flax.serialization.to_state_dict(new.opt_state))).items()}

    argv = TINYM_ARGV + ["--optim_type=sgd"]
    model = _port_model(argv, params, bs).train()
    optim = OptimManager(check_args(parse_config(argv)), num_train_samples=4)
    optim.build(model.parameters())
    stats = make_train_step(model, get_loss_func("CombinationEnhance"), optim)(
        [(torch.from_numpy(x), torch.from_numpy(y))], 0.0, 4)
    assert forced_k9 == TINYM_K9_CALLS
    np.testing.assert_allclose(stats[0].item(), float(jl), rtol=1e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        assert g is not None and g.dtype == torch.float32, k
        _close(g, jgrads[k], MODEL_GRAD_TOL, k)


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def make_enhance_images(root, n, size=64, seed=0):
    """n subjects of size x size float32 images (<id>_input.npy) and their
    clean targets (<id>_output.npy, the input less its noise), and a split
    CSV of n - 4 train, 2 val and 2 test subjects."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    ids = [f"img{i:03d}" for i in range(n)]
    for sid in ids:
        os.makedirs(os.path.join(root, sid), exist_ok=True)
        clean = np.cumsum(rng.normal(size=(size, size)), axis=1).astype(np.float32) / 8
        np.save(os.path.join(root, sid, f"{sid}_output.npy"), clean)
        np.save(os.path.join(root, sid, f"{sid}_input.npy"),
                (clean + 0.3 * rng.normal(size=clean.shape)).astype(np.float32))
    pd.DataFrame({"SubjectID": ids, "Split": ["train"] * (n - 4) + ["val"] * 2 + ["test"] * 2}
                 ).to_csv(os.path.join(root, "split.csv"), index=False)


def _micro_args(tmp_path, run_name, window):
    """projects/run_micro.sh's own flags at a tiny geometry (64x64, embed
    16, depths 1/1/1/1, 2 epochs, --debug) with the given window."""
    return project_flags("run_micro.sh") + [
        f"--run_name={run_name}", f"--log_dir={tmp_path}/logs", f"--data_dir={tmp_path}/data",
        f"--split_csv_path={tmp_path}/data/split.csv", "--device=cpu", "--num_workers=2",
        "--prefetch_factor=2", "--num_epochs=2", "--checkpoint_frequency=1", "--debug",
        "--height=64", "--width=64", "--Swin.size=custom", "--Swin.embed_dim=16",
        "--Swin.depths", "1", "1", "1", "1", "--Swin.num_heads", "2", "2", "2", "2",
        "--Swin.window_size", str(window)]


@pytest.mark.parametrize("window", [7, 4], ids=["micro_w7", "micro"])
def test_run_torch_trains_micro_and_reruns_inference_only(tmp_path, window):
    """run_torch.main with the flags of projects/run_micro.sh (enhance,
    UperNet2D, CombinationEnhance, bf16 AMP, batch 4) at a tiny geometry,
    with window 7 and as shipped (window 4): 2 epochs of 2 steps, the
    checkpoint streams, loss, SSIM and PSNR in the metrics files; an
    inference-only rerun reproduces the test metrics and saves each test
    subject's (1, H, W) image."""
    make_enhance_images(f"{tmp_path}/data", n=12)
    argv = _micro_args(tmp_path, "micro", window)
    assert "--task_type=enhance" in argv and "--loss_func=CombinationEnhance" in argv
    assert main(argv) == 0
    run_dir = f"{tmp_path}/logs/micro"
    assert sorted(os.listdir(f"{run_dir}/models")) == [
        "model_best_checkpoint", "model_epoch_0", "model_epoch_1", "model_last_epoch"]
    log = open(f"{run_dir}/run.log").read()
    assert re.findall(r"epoch (\d) train: (\d) steps", log) == [("0", "2"), ("1", "2")]
    losses = re.findall(r"epoch \d train: \{'loss': [-\d.e]+, 'ssim': [-\d.e]+, 'psnr'", log)
    assert len(losses) == 2
    test = open(f"{run_dir}/test_metrics.txt").read()
    metrics = {k: float(v) for k, v in (line.split(": ") for line in test.strip().splitlines())}
    assert list(metrics) == ["loss", "ssim", "psnr"]
    assert all(np.isfinite(v) for v in metrics.values()) and -1.0 <= metrics["ssim"] <= 1.0
    assert main(["--inference_only=True", f"--inference_dir={run_dir}",
                 f"--inference_log_dir={tmp_path}/logs", "--inference_run_name=inf"]) == 0
    assert open(f"{tmp_path}/logs/inf/test_metrics.txt").read() == test
    saved = sorted(os.listdir(f"{tmp_path}/logs/inf/saved_samples/test"))
    assert saved == ["img010_output.npy", "img011_output.npy"]
    image = np.load(f"{tmp_path}/logs/inf/saved_samples/test/{saved[0]}")
    assert image.shape == (1, 64, 64) and image.dtype == np.float32 and np.isfinite(image).all()
