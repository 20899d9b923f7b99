"""PyTorch port, the vit65k_mamba path (ViT + full-sequence Mamba + mean-pool
ViTLinear) against the JAX package on the CPU.

* The chunked scan (``selective_scan_chunked``, K7's plain version) against
  the JAX package's, forward and every gradient.
* K7's autograd Function on CPU tensors (the three passes' plain versions
  and the stitches) and ``selective_scan_long_plain`` against the JAX
  package's Pallas ``selective_scan_long`` in interpret mode and its exact
  ``selective_scan_reference``, at d_state 1 to 16 and with
  delta_softplus=False; the kernels' wrappers refuse CPU tensors and
  d_state past 16.
* The Mamba mixer's scan routes by length (``selective_scan_cm``, the
  chunked scan, K7), chosen as the JAX package chooses them.
* A tiny ViT-mamba (2 layers, hidden 32, 4,096 tokens) from converted JAX
  parameters: hidden states, logits and one train step's gradients against
  the JAX package on its CPU route (the chunked scan) and with its long-scan
  gate forced (K7 in interpret mode); a tiny ViT-mamba run through
  ``run_torch.main`` with an inference-only rerun.

The same numpy inputs (made from a seed) go to both packages. Tolerances,
fp32 throughout unless a test says otherwise: a forward within 1e-4 of its
max|reference|, gradients within rtol 1e-3 / atol 5e-4 (the JAX package's
own long-scan test), whole-model gradients within 1e-4 of each parameter's
max|reference| (sum order over 4,096 tokens and two blocks).
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from long_context_biomedical_imaging_tpu.models import mamba as jmamba
from long_context_biomedical_imaging_tpu.ops import selective_scan_long as jlong
from long_context_biomedical_imaging_tpu.ops.selective_scan import (selective_scan_chunked as
                                                                    jax_chunked,
                                                                    selective_scan_reference)
from long_context_biomedical_imaging_tpu_torch.models import build_model
from long_context_biomedical_imaging_tpu_torch.models import mamba as tmamba
from long_context_biomedical_imaging_tpu_torch.ops import selective_scan as tscan
from long_context_biomedical_imaging_tpu_torch.ops import selective_scan_long as tlong
from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
from long_context_biomedical_imaging_tpu_torch.trainer import amp_params
from long_context_biomedical_imaging_tpu_torch.utils.convert import params_from_jax
from test_torch_vit import _close, _jax_params, _port_model
from test_torch_vit_hyena import _jax_step, _port_step

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from run_torch import main  # noqa: E402

# 128x128 with patch 2: 4,096 tokens, K7's route (d_half 16, N 8)
MAMBA_ARGV = ["--task_type=class", "--encoder_name=ViT", "--decoder_name=ViTLinear",
              "--height=128", "--width=128", "--no_in_channel=1", "--no_out_channel=2",
              "--seed=3", "--ViT.size=custom", "--ViT.hidden_size=32", "--ViT.mlp_dim=64",
              "--ViT.num_layers=2", "--ViT.num_heads=2", "--ViT.patch_size", "2",
              "--ViT.use_mamba=True"]
FWD_TOL, GRAD_RTOL, GRAD_ATOL, MODEL_GRAD_TOL = 1e-4, 1e-3, 5e-4, 1e-4
SCAN_ARGS = ("u", "delta", "A", "B", "C", "D", "delta_bias")


def _launches():
    return tuple(k.launches for k in (tlong.LONG_SCAN_FWD, tlong.LONG_SCAN_CARRY_BWD,
                                      tlong.LONG_SCAN_BWD, tlong.LONG_SCAN_STITCH))


def _scan_inputs(rng, b, length, d, n, channel_minor):
    """u, delta, A, B, C, D, delta_bias and a cotangent, numpy fp32; (b, L,
    d) and (b, L, n) channel-minor, else (b, d, L) and (b, n, L)."""
    seq = (b, length, d) if channel_minor else (b, d, length)
    st = (b, length, n) if channel_minor else (b, n, length)
    arrs = [rng.normal(size=seq), rng.normal(size=seq), -np.exp(rng.normal(size=(d, n))),
            rng.normal(size=st), rng.normal(size=st), rng.normal(size=d), rng.normal(size=d),
            rng.normal(size=seq)]
    return [a.astype(np.float32) for a in arrs]


def _torch_vjp(fn, arrs):
    """fn's output and its VJP for the cotangent arrs[-1], as numpy, by
    torch.autograd (torch.func.vjp does not take the saved-tensor hooks of
    the chunked scan's torch.utils.checkpoint)."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs[:-1]]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(arrs[-1]))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def _jax_vjp(fn, arrs):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrs[:-1]))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(arrs[-1]))]


def _check_scan(got, ref):
    _close(got[0], ref[0], FWD_TOL, "y")
    for name, a, r in zip(SCAN_ARGS, got[1:], ref[1:]):
        np.testing.assert_allclose(a, r, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# The chunked scan and K7's plain passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,length,d,n,chunk", [(2, 300, 6, 4, 128), (2, 600, 160, 8, 256)])
def test_selective_scan_chunked_matches_jax(b, length, d, n, chunk):
    """The chunked scan on (b, d, L) against the JAX package's at a ragged L
    (the tail chunk masked to the identity), b = 2, and n * d = 1280, over
    one TPU channel chunk: y and the gradients of u, delta, A, B, C, D and
    delta_bias, through torch.autograd and jax.vjp."""
    arrs = _scan_inputs(np.random.default_rng(length), b, length, d, n, channel_minor=False)
    got = _torch_vjp(lambda *a: tscan.selective_scan_chunked(*a, chunk=chunk), arrs)
    ref = _jax_vjp(lambda *a: jax_chunked(*a, chunk=chunk), arrs)
    _check_scan(got, ref)


def test_affine_scan_matches_sequential_recurrence():
    """The log-depth affine scan equals the sequential recurrence h_i = a_i
    h_{i-1} + b_i (and its reverse) at a length that is not a power of two,
    with the products of a; within 1e-6 of max."""
    gen = torch.Generator().manual_seed(0)
    a = torch.rand(3, 37, 5, generator=gen) + 0.2
    b = torch.randn(3, 37, 5, generator=gen)
    for reverse in (False, True):
        pa, hs = tscan.affine_scan(a, b, dim=1, reverse=reverse)
        h, p = torch.zeros(3, 5), torch.ones(3, 5)
        order = reversed(range(37)) if reverse else range(37)
        for i in order:
            h, p = a[:, i] * h + b[:, i], p * a[:, i]
            torch.testing.assert_close(hs[:, i], h, rtol=0, atol=1e-6 * h.abs().max().item())
            torch.testing.assert_close(pa[:, i], p, rtol=1e-6, atol=0)


@pytest.mark.parametrize("b,length,d,n,softplus,interpret", [
    pytest.param(2, 136, 12, 4, True, True, id="2-136-12-4"),
    pytest.param(3, 200, 160, 8, True, True, id="3-200-160-8"),
    pytest.param(1, 72, 12, 1, True, True, id="1-72-12-1"),
    pytest.param(1, 72, 12, 16, True, True, id="1-72-12-16"),
    pytest.param(2, 72, 12, 8, False, True, id="2-72-12-8-no_softplus"),
    pytest.param(2, 64 * 37 + 5, 8, 4, True, False, id="2-2373-8-4-38_segments")])
def test_long_scan_matches_jax(b, length, d, n, softplus, interpret):
    """K7 on CPU tensors (its autograd Function: the zero-carry pass, the
    stitch, the seeded pass, the carry pass, the reverse stitch and the
    backward pass, each pass's plain version; no kernel launches) and
    selective_scan_long_plain (the chunked scan) against the JAX package's
    Pallas selective_scan_long in interpret mode and its exact
    selective_scan_reference: y and every gradient, at ragged lengths (136
    = 2 x 64 + 8; 200; 72), b = 2 and 3 (the carries stay within their batch
    row), N = 1, 4, 8 and 16, n * d = 1280, over one TPU channel chunk, and
    with delta_softplus=False (delta and its bias made positive, as softplus
    would make them, or the decays grow past fp32); and at 38 segments a
    batch row (L = 64 x 37 + 5), past the stitch kernel's first span of 32,
    against selective_scan_reference alone (the interpret-mode kernel is
    slow at that length)."""
    arrs = _scan_inputs(np.random.default_rng(length), b, length, d, n, channel_minor=True)
    if not softplus:
        arrs[1] = np.logaddexp(arrs[1], 0).astype(np.float32)
        arrs[6] = np.abs(arrs[6])

    def reference(u, delta, A, B, C, D, db):
        return selective_scan_reference(
            u.transpose(0, 2, 1), delta.transpose(0, 2, 1), A, B.transpose(0, 2, 1),
            C.transpose(0, 2, 1), D, db, delta_softplus=softplus).transpose(0, 2, 1)

    def bind(fn):
        return lambda *a: fn(*a, delta_softplus=softplus)

    before = _launches()
    got = _torch_vjp(bind(tlong.selective_scan_long), arrs)
    plain = _torch_vjp(bind(tlong.selective_scan_long_plain), arrs)
    assert _launches() == before
    refs = [_jax_vjp(bind(jlong.selective_scan_long), arrs)] if interpret else []
    for ref in refs + [_jax_vjp(reference, arrs)]:
        _check_scan(got, ref)
        _check_scan(plain, ref)


def test_long_scan_passes_are_the_kernels_contract():
    """The plain forward pass from the stitched carries equals one pass over
    the whole sequence (a single segment per batch row has no carry), and
    the zero-carry pass leaves every segment's final state and decay
    product as the whole-sequence recurrence gives them from a zero state;
    steps past L are the identity. fp32, within 1e-5 of max."""
    rng = np.random.default_rng(5)
    u, delta, A, B, C = (torch.from_numpy(a) for a in _scan_inputs(
        rng, 2, 150, 6, 8, channel_minor=True)[:5])
    at = A.t().contiguous()
    _, hl, ap = tlong.long_scan_fwd_plain(u, delta, at, B, C, emit_y=False)
    assert hl.shape == ap.shape == (2 * 3, 8, 6)
    d = torch.nn.functional.softplus(delta)
    for row in range(6):
        bi, seg = divmod(row, 3)
        h, p = torch.zeros(8, 6), torch.ones(8, 6)
        for t in range(seg * 64, min(150, seg * 64 + 64)):
            a = torch.exp(d[bi, t] * at)
            h, p = a * h + d[bi, t] * u[bi, t] * B[bi, t, :, None], p * a
        torch.testing.assert_close(hl[row], h, rtol=0, atol=1e-5 * h.abs().max().item())
        torch.testing.assert_close(ap[row], p, rtol=1e-5, atol=0)
    hstart = tlong._stitch_fwd(hl, ap, 2, 3)
    assert hstart[0].abs().max() == 0 and hstart[3].abs().max() == 0
    y, hl_y, ap_y = tlong.long_scan_fwd_plain(u, delta, at, B, C, hstart)
    assert hl_y is None and ap_y is None
    ref = tscan.selective_scan_cm(u, delta, A, B, C)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("nseg", [1, 31, 33, 70])
def test_long_scan_stitch_plain_matches_affine_scan_and_jax(nseg, reverse):
    """The stitch kernel's plain contract (long_scan_stitch_plain: the
    exclusive affine scan over the segments in spans of 32, their aggregates
    walked in order, then each span from its start) against the CPU path's
    log-depth affine_scan stitch (_stitch_fwd, _stitch_bwd with reverse)
    and the JAX package's _stitch_fwd / _stitch_bwd (jax.lax.associative_scan,
    in their (n_j, b * nseg, nd) layout) at b = 3 and nseg = 1 (all zero),
    31 (one span), 33 and 70 (two and three), both directions, within 1e-5
    of max."""
    rng = np.random.default_rng(nseg)
    b, n, d = 3, 4, 5
    x = rng.normal(size=(b * nseg, n, d)).astype(np.float32)
    ap = rng.uniform(0.05, 1.0, size=(b * nseg, n, d)).astype(np.float32)
    got = tlong.long_scan_stitch_plain(torch.from_numpy(x), torch.from_numpy(ap), b, nseg,
                                       reverse).numpy()
    ref = tlong._stitch(torch.from_numpy(x), torch.from_numpy(ap), b, nseg, reverse).numpy()
    jfn = jlong._stitch_bwd if reverse else jlong._stitch_fwd
    jref = np.asarray(jfn(jnp.asarray(x.reshape(1, b * nseg, n * d)),
                          jnp.asarray(ap.reshape(1, b * nseg, n * d)), b, nseg)).reshape(x.shape)
    assert got.shape == x.shape
    if nseg == 1:
        assert not got.any() and not ref.any() and not jref.any()
        return
    for r in (ref, jref):
        np.testing.assert_allclose(got, r, rtol=0, atol=1e-5 * np.abs(r).max())


def test_long_scan_kernels_refuse():
    """The kernels' wrappers take CUDA tensors only (ValueError naming CUDA;
    the stitch kernel's too)
    and d_state at most 16 (ValueError naming the limit, before the device
    is looked at); the public op takes delta_softplus=False on CPU tensors
    and gives the plain version's y within 1e-5 of its max (parity with JAX
    in test_long_scan_matches_jax)."""
    u = torch.zeros(1, 2048, 16)
    bc = torch.zeros(1, 2048, 8)
    at = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tlong.long_scan_fwd(u, u, at, bc, bc)
    with pytest.raises(ValueError, match="CUDA"):
        tlong.long_scan_carry_bwd(u, at, bc, u)
    carries = torch.zeros(32, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tlong.long_scan_stitch(carries, carries, 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tlong.long_scan_stitch(carries, carries, 1, 32, reverse=True)
    bc17 = torch.zeros(1, 2048, 17)
    with pytest.raises(ValueError, match="d_state <= 16"):
        tlong.long_scan_fwd(u, u, torch.zeros(17, 16), bc17, bc17)
    with pytest.raises(ValueError, match="d_state <= 16"):
        tlong.long_scan_bwd(u, u, torch.zeros(32, 16), bc, bc, u, None, None)
    gen = torch.Generator().manual_seed(6)
    x, d = torch.randn(2, 130, 16, generator=gen), torch.rand(2, 130, 16, generator=gen)
    a, b, c = -torch.rand(16, 8, generator=gen), *torch.randn(2, 2, 130, 8, generator=gen)
    y = tlong.selective_scan_long(x, d, a, b, c, delta_softplus=False)
    ref = tlong.selective_scan_long_plain(x, d, a, b, c, delta_softplus=False)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


# ---------------------------------------------------------------------------
# The Mamba mixer's routes
# ---------------------------------------------------------------------------

def test_mamba_scan_routes_as_jax(monkeypatch):
    """The composed mixer's scan by length, as the JAX package routes it on
    the card: selective_scan_cm up to 1024 tokens, the chunked scan
    (selective_scan_long_plain) at 1536 (1024 < L < 2048), K7 from 2048
    (the gate, spied on, is the JAX package's long_scan_supported); with the gate forced off, 2048 takes the
    chunked scan and gives the same output within 1e-5 of max."""
    calls, gate = [], []
    for name in ("selective_scan_cm", "selective_scan_long_plain", "selective_scan_long"):
        real = getattr(tmamba, name)
        monkeypatch.setattr(tmamba, name,
                            lambda *a, _n=name, _f=real, **k: calls.append(_n) or _f(*a, **k))
    monkeypatch.setattr(tmamba, "_long_scan_supported",
                        lambda *a: gate.append(a) or tlong.long_scan_supported(*a))
    for args in ((2048, 8, 1024), (2048, 8, 1025), (2047, 8, 16), (65536, 8, 192)):
        assert tlong.long_scan_supported(*args) == jlong.long_scan_supported(*args), args
    gen = torch.Generator().manual_seed(0)
    mixer = tmamba.MambaVisionMixer(16, d_state=8, d_conv=3, expand=1)
    mixer.init_params(gen)
    outs = {}
    with torch.no_grad():
        for length in (1024, 1536, 2048):
            outs[length] = mixer(torch.randn(1, length, 16, generator=gen))
        assert calls == ["selective_scan_cm", "selective_scan_long_plain", "selective_scan_long"]
        assert gate == [(1536, 8, 8), (2048, 8, 8)]
        monkeypatch.setattr(tmamba, "_long_scan_supported", lambda *a: False)
        x = torch.randn(2, 2048, 16, generator=gen)
        forced = mixer(x)
        monkeypatch.setattr(tmamba, "_long_scan_supported", tlong.long_scan_supported)
        ref = mixer(x)
    assert calls[3:] == ["selective_scan_long_plain", "selective_scan_long"]
    torch.testing.assert_close(forced, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


# ---------------------------------------------------------------------------
# The tiny ViT-mamba
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_mamba():
    """(JAX model, JAX params as numpy) of the 128x128 geometry: 4,096
    tokens, no cls token."""
    return _jax_params(MAMBA_ARGV, (1, 1, 128, 128, 1), 31)


def test_params_from_jax_maps_every_vit_mamba_leaf(tiny_mamba):
    """Every JAX leaf of the ViT-mamba tree lands on a port parameter of its
    shape and none is left over (a strict load): each block's norm1, the
    Mamba mixer's projections, conv taps, A_log and D, the fused MLP, the
    final norm, the head; no position embedding, no cls token, no qkv."""
    _, params = tiny_mamba
    state_dict = params_from_jax(params)
    port = dict(build_model(check_args(parse_config(MAMBA_ARGV))).state_dict())
    assert set(state_dict) == set(port)
    for k, v in state_dict.items():
        assert tuple(v.shape) == tuple(port[k].shape), k
    for key in ("encoder.block_1.attn.mamba.in_proj_kernel",
                "encoder.block_0.attn.mamba.conv1d_x_kernel",
                "encoder.block_0.attn.mamba.x_proj_kernel",
                "encoder.block_0.attn.mamba.dt_proj_bias", "encoder.block_1.attn.mamba.A_log",
                "encoder.block_1.attn.mamba.D", "encoder.block_1.mlp.fc1_kernel",
                "decoder.classification_head.bias"):
        assert key in state_dict, key
    assert not any("position_embeddings" in k or "cls_token" in k or ".qkv." in k
                   for k in state_dict)


@pytest.mark.parametrize("amp,tol", [(False, 1e-4), (True, 3e-2)])
def test_tiny_vit_mamba_forward_matches_jax(tiny_mamba, amp, tol):
    """At 4,096 tokens (the port's scan takes K7, its plain passes on the
    CPU; the JAX package's its CPU route, the chunked scan): the hidden-state
    list (fp32, 1e-4 of max) and the logits, fp32 to 1e-4 of max, bf16 AMP
    to 3e-2 (a bf16 ulp flipped by a different fp32 sum propagates through
    the blocks)."""
    jm, params = tiny_mamba
    x = np.random.default_rng(32).normal(size=(1, 1, 128, 128, 1)).astype(np.float32)
    model = _port_model(MAMBA_ARGV + (["--use_amp"] if amp else []), params)
    if not amp:
        ref_h = jm.encoder.apply({"params": params["encoder"]}, jnp.asarray(x))
        with torch.no_grad():
            got_h = model.encoder(torch.from_numpy(x))
        assert len(got_h) == len(ref_h) == 4 and tuple(got_h[-1].shape) == (1, 4096, 32)
        for i, (a, b) in enumerate(zip(got_h, ref_h)):
            _close(a, b, 1e-4, f"h{i}")
    dt = jnp.bfloat16 if amp else jnp.float32
    ref = jm.apply({"params": jax.tree.map(lambda a: jnp.asarray(a).astype(dt), params)},
                   jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        out = functional_call(model, amp_params(model, amp), (torch.from_numpy(x),))
    assert out.shape == (1, 2) and out.dtype == (torch.bfloat16 if amp else torch.float32)
    _close(out, ref, tol)


@pytest.mark.parametrize("jax_long", [False, True])
def test_tiny_vit_mamba_train_step_matches_jax(tiny_mamba, monkeypatch, jax_long):
    """One fp32 train step at 4,096 tokens from the same weights and batch:
    the loss within 1e-5 (relative) and every parameter's gradient within
    1e-4 of its max|g|, against the JAX package on its CPU route (the chunked
    scan) and with its long-scan gate forced on (K7's Pallas kernels in
    interpret mode). The port's scan runs K7's passes (plain on the CPU)."""
    jm, params = tiny_mamba
    if jax_long:
        monkeypatch.setattr(jmamba, "_use_long_scan", jlong.long_scan_supported)
    x = np.random.default_rng(33).normal(size=(1, 1, 128, 128, 1)).astype(np.float32)
    y = np.array([1], np.int32)
    calls = []
    real = tmamba.selective_scan_long
    monkeypatch.setattr(tmamba, "selective_scan_long",
                        lambda *a, **k: calls.append(tuple(a[0].shape)) or real(*a, **k))
    jloss, jgrads = _jax_step(jm, params, x, y, False)
    loss, grads = _port_step(MAMBA_ARGV, params, x, y, False)
    assert calls == [(1, 4096, 16)] * 2
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=0)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        assert g is not None and g.dtype == torch.float32, k
        _close(g, jgrads[k], MODEL_GRAD_TOL, k)


def test_run_torch_trains_vit_mamba_and_reruns_inference_only(tmp_path):
    """run_torch.main with the vit65k_mamba flags (projects/run_ptx.sh with
    the ViT-mamba encoder, ViTLinear and batch 1) at a tiny geometry (64x64,
    patch 1: 4,096 tokens, K7's route; hidden 32): 2 epochs of 3 steps
    (--debug), the checkpoint streams, the classification metrics; an
    inference-only rerun reproduces the test metrics."""
    from test_torch_e2e import make_dataset

    make_dataset(f"{tmp_path}/data", n=8, size=64)
    geometry = ("--height=128", "--width=128", "--ViT.patch_size", "2")
    argv = ["--run_name=mb", f"--log_dir={tmp_path}/logs", f"--data_dir={tmp_path}/data",
            "--exact_metrics=True", "--time=1", "--batch_size=1", "--seed=1", "--device=cpu",
            "--affine_aug=True", "--brightness_aug=True", "--gaussian_blur_aug=False",
            "--train_model=True", "--num_epochs=2", "--num_workers=2", "--prefetch_factor=2",
            "--loss_func=CrossEntropy", "--use_amp", "--optim_type=adam", "--optim.lr=1e-5",
            "--optim.beta1=0.9", "--optim.beta2=0.99", "--scheduler_type=OneCycleLR",
            "--checkpoint_frequency=1", "--debug",
            *[a for a in MAMBA_ARGV if a not in geometry],
            "--height=64", "--width=64", "--ViT.patch_size", "1"]
    assert main(argv) == 0
    run_dir = f"{tmp_path}/logs/mb"
    assert sorted(os.listdir(f"{run_dir}/models")) == [
        "model_best_checkpoint", "model_epoch_0", "model_epoch_1", "model_last_epoch"]
    log = open(f"{run_dir}/run.log").read()
    assert re.findall(r"epoch (\d) train: (\d) steps", log) == [("0", "3"), ("1", "3")]
    test = open(f"{run_dir}/test_metrics.txt").read()
    metrics = dict(line.split(": ") for line in test.strip().splitlines())
    assert set(metrics) == {"loss", "acc_1", "auroc", "f1"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert main(["--inference_only=True", f"--inference_dir={run_dir}",
                 f"--inference_log_dir={tmp_path}/logs", "--inference_run_name=inf"]) == 0
    assert open(f"{tmp_path}/logs/inf/test_metrics.txt").read() == test
