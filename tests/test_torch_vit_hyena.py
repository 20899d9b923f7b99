"""PyTorch port, the vit65k_hyena path (ViT + full-sequence Hyena + mean-pool
ViTLinear) against the JAX package on the CPU.

* K6's plain version (forward and every gradient, through the port's
  ``spectral_causal_conv`` and its autograd Function) against the JAX
  package's Pallas ``spectral_causal_conv`` in interpret mode, and against
  its exact function (``_fft_conv_core`` plus the skip term).
* ``fft_causal_conv``'s routes (direct, spectral, FFT), chosen as the JAX
  package chooses them, by length; on a CPU tensor the spectral route takes
  K6's plain version and the kernels' wrappers refuse.
* ``PatchEmbeddingBlock`` without a position embedding.
* A tiny ViT-hyena (2 layers, hidden 32, 2 heads, MLP 64): at 4,096 tokens
  (both packages take the fp32 FFT route) the hidden states, the logits in
  fp32 and under AMP and one train step's loss and gradients; at 8,192
  tokens (the JAX package runs K6 in interpret mode) the logits and
  gradients at K6's limits.
* A tiny ViT-hyena run through ``run_torch.main`` with checkpoints and an
  inference-only rerun, and the Swin checkpointing flag's gradients.

The same numpy inputs (made from a seed) go to both packages; tolerances are
stated per test.
"""

import os
import re
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from long_context_biomedical_imaging_tpu.models.layers import (
    PatchEmbeddingBlock as JaxPatchEmbeddingBlock)
from long_context_biomedical_imaging_tpu.ops import fftconv as jfft
from long_context_biomedical_imaging_tpu.ops import spectral_conv as jspec
from long_context_biomedical_imaging_tpu_torch.models import build_model
from long_context_biomedical_imaging_tpu_torch.models.layers import PatchEmbeddingBlock
from long_context_biomedical_imaging_tpu_torch.ops import fftconv as tfft
from long_context_biomedical_imaging_tpu_torch.ops import spectral_conv as tspec
from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
from long_context_biomedical_imaging_tpu_torch.trainer import amp_params
from long_context_biomedical_imaging_tpu_torch.utils.convert import params_from_jax
from test_torch_models import _random_params
from test_torch_vit import _close, _jax_params, _port_model

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from run_torch import main  # noqa: E402

# 256x256 with patch 4: 4,096 tokens, below K6's floor
HYENA_ARGV = ["--task_type=class", "--encoder_name=ViT", "--decoder_name=ViTLinear",
              "--height=256", "--width=256", "--no_in_channel=1", "--no_out_channel=2",
              "--seed=3", "--ViT.size=custom", "--ViT.hidden_size=32", "--ViT.mlp_dim=64",
              "--ViT.num_layers=2", "--ViT.num_heads=2", "--ViT.patch_size", "4",
              "--ViT.use_hyena=True"]
# 256x512: 8,192 tokens, K6's lowest length
SPECTRAL_ARGV = [a for a in HYENA_ARGV if a != "--width=256"] + ["--width=512"]
# K6's limits against the TPU kernel's bf16 DFT products (the JAX package's
# own, tests/test_ops.py): forward within 2e-2 of max, gradients by cosine and
# relative L2
K6_FWD_TOL, K6_COS, K6_REL_L2 = 2e-2, 0.995, 0.08


def _launches():
    return tspec.SPECTRAL_CONV.launches, tspec.SPECTRAL_CONV_DK.launches


def _cos_rel(got, ref):
    got, ref = np.asarray(got, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    cos = got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref))
    return cos, np.linalg.norm(got - ref) / np.linalg.norm(ref)


# ---------------------------------------------------------------------------
# K6's plain version and the long-conv routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape", [(3, 4, 1024), (1, 4, 8192)])
def test_spectral_conv_plain_matches_jax(rng, shape, with_bias):
    """The port's spectral_causal_conv on CPU tensors (the plain version and
    its VJP through the autograd Function; no kernel launches) against the
    JAX package's Pallas kernel in interpret mode (an odd batch, and K6's
    lowest length), forward and du, dk, dbias: the forward within 2e-2 of
    max, each gradient with cosine > 0.995 and relative L2 < 0.08 (the TPU
    kernel's bf16 DFT products, 1e-3 to 1e-2 from an fp32 FFT by its own
    account).
    Against the exact function, JAX's _fft_conv_core plus bias * u and its
    VJP: 1e-5 of max (fp32 FFT round-off)."""
    b, d, length = shape
    u = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(d, length)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=d) * 0.5).astype(np.float32) if with_bias else None
    g = rng.normal(size=shape).astype(np.float32)
    jargs = [jnp.asarray(u), jnp.asarray(k)] + ([jnp.asarray(bias)] if with_bias else [])

    def exact(u, k, *bias):
        y = jfft._fft_conv_core(u, k)
        return y + u * bias[0][:, None] if bias else y

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (u, k, bias) if a is not None]
    before = _launches()
    out = tspec.spectral_causal_conv(leaves[0], leaves[1], leaves[2] if with_bias else None)
    out.backward(torch.from_numpy(g))
    assert _launches() == before
    got = [out.detach().numpy()] + [t.grad.numpy() for t in leaves]
    for fn, exact_ref in (((lambda *a: jspec.spectral_causal_conv(*a, None)) if not with_bias
                           else jspec.spectral_causal_conv, False), (exact, True)):
        ref, vjp = jax.vjp(fn, *jargs)
        refs = [np.asarray(ref)] + [np.asarray(r) for r in vjp(jnp.asarray(g))]
        for name, a, r in zip(("y", "du", "dk", "dbias"), got, refs):
            if exact_ref:
                _close(a, r, 1e-5, name)
            elif name == "y":
                _close(a, r, K6_FWD_TOL, name)
            else:
                cos, rel = _cos_rel(a, r)
                assert cos > K6_COS and rel < K6_REL_L2, (name, cos, rel)


def test_long_conv_routes_as_jax(monkeypatch):
    """fft_causal_conv's route by length is the JAX package's: direct up to
    512 tokens, K6 where spectral_supported holds (8192 <= L <= 131072, L a
    power of two), the fp32 FFT otherwise; the gate and its constants are
    the JAX package's. A CPU tensor at L = 8192 takes K6's plain version
    (in every dtype, without a launch), and the kernels' wrappers refuse a
    CPU tensor (ValueError) and fp16 (TypeError)."""
    assert (tspec.SPECTRAL_MIN_LEN, tspec.SPECTRAL_MAX_LEN, tfft.DIRECT_CONV_MAX_LEN) == (
        jspec.SPECTRAL_MIN_LEN, jspec.SPECTRAL_MAX_LEN, jfft._DIRECT_CONV_MAX_LEN)
    for length in (1, 64, 512, 513, 1024, 4096, 8191, 8192, 12288, 16384, 65536, 98304,
                   131072, 262144):
        want = ("direct" if length <= jfft._DIRECT_CONV_MAX_LEN
                else "spectral" if jspec.spectral_supported(length) else "fft")
        assert tfft.long_conv_route(length) == want, length
        assert tspec.spectral_supported(length) == jspec.spectral_supported(length), length
    calls = []
    real = tspec.spectral_causal_conv_plain
    monkeypatch.setattr(tspec, "spectral_causal_conv_plain",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.randn(1, 2, 8192, generator=gen).to(dtype)
        k, bias = torch.randn(2, 8192, generator=gen), torch.randn(2, generator=gen)
        before = _launches()
        y = tfft.fft_causal_conv(u, k, bias)
        assert _launches() == before and y.dtype == dtype
        torch.testing.assert_close(y, real(u, k, bias), rtol=0, atol=0)
        with pytest.raises(ValueError, match="CUDA"):
            tspec.spectral_conv_fwd(u, k, bias)
        with pytest.raises(ValueError, match="CUDA"):
            tspec.spectral_conv_dk(u, u)
    assert calls == [torch.float32, torch.bfloat16]
    with pytest.raises(TypeError):
        tspec.spectral_conv_fwd(u.half(), k, bias)


@pytest.mark.parametrize("length", [512, 1024])
def test_fft_causal_conv_matches_jax(rng, length):
    """fft_causal_conv on (B, D, L) in fp32 against the JAX package's, on the
    direct route (512) and the fp32 FFT route (1024: the JAX package's
    matmul FFT, the port's torch.fft): forward and du, dk, dbias within 1e-5
    of max (fp32 sum order and FFT round-off)."""
    u = rng.normal(size=(2, 8, length)).astype(np.float32)
    k = (rng.normal(size=(8, length)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=8) * 0.5).astype(np.float32)
    g = rng.normal(size=(2, 8, length)).astype(np.float32)
    ref, vjp = jax.vjp(jfft.fft_causal_conv, *(jnp.asarray(a) for a in (u, k, bias)))
    refs = [ref] + list(vjp(jnp.asarray(g)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (u, k, bias)]
    out = tfft.fft_causal_conv(*leaves)
    out.backward(torch.from_numpy(g))
    for name, a, r in zip(("y", "du", "dk", "dbias"), [out] + [t.grad for t in leaves], refs):
        _close(a, r, 1e-5, name)


def test_patch_embedding_block_without_position_embedding_matches_jax(rng):
    """pos_embed_type="none" (the Hyena and Mamba ViTs): neither tree has a
    position embedding, and the tokens are the patch projection alone, to
    1e-6 of max."""
    x = rng.normal(size=(2, 32, 24, 2)).astype(np.float32)
    jm = JaxPatchEmbeddingBlock(img_size=(32, 24), patch_size=(4, 4), hidden_size=48,
                                pos_embed_type="none")
    shapes = flax.serialization.to_state_dict(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"])
    params = _random_params(shapes, np.random.default_rng(1))
    ref = jm.apply({"params": params}, jnp.asarray(x))
    port = PatchEmbeddingBlock((32, 24), (4, 4), 2, 48, pos_embed_type="none")
    assert "position_embeddings" not in dict(port.named_parameters())
    port.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.shape == (2, 48, 48)
    _close(out, ref, 1e-6)
    with pytest.raises(ValueError):
        PatchEmbeddingBlock((32, 24), (4, 4), 2, 48, pos_embed_type="sincos")


# ---------------------------------------------------------------------------
# The tiny ViT-hyena
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_hyena():
    """(JAX model, JAX params as numpy) of the 256x256 geometry: 4,096
    tokens, no cls token."""
    return _jax_params(HYENA_ARGV, (1, 1, 256, 256, 1), 21)


def test_params_from_jax_maps_every_vit_hyena_leaf(tiny_hyena):
    """Every JAX leaf of the ViT-hyena tree lands on a port parameter of its
    shape and none is left over (a strict load): each block's norm1, Hyena
    projections, short filter and implicit filter MLP, the fused MLP, the
    final norm, the head; no position embedding and no cls token."""
    _, params = tiny_hyena
    state_dict = params_from_jax(params)
    port = dict(build_model(check_args(parse_config(HYENA_ARGV))).state_dict())
    assert set(state_dict) == set(port)
    for k, v in state_dict.items():
        assert tuple(v.shape) == tuple(port[k].shape), k
    for key in ("encoder.block_1.attn.hyena.in_proj_kernel",
                "encoder.block_1.attn.hyena.short_filter_kernel",
                "encoder.block_0.attn.hyena.filter_fn.z",
                "encoder.block_0.attn.hyena.filter_fn.bias",
                "encoder.block_0.attn.hyena.filter_fn.linears_in.kernel",
                "encoder.block_0.attn.hyena.filter_fn.linear_out.kernel",
                "encoder.block_1.mlp.fc1_kernel", "decoder.classification_head.bias"):
        assert key in state_dict, key
    assert not any("position_embeddings" in k or "cls_token" in k or ".qkv." in k
                   for k in state_dict)


@pytest.mark.parametrize("amp,tol", [(False, 1e-4), (True, 3e-2)])
def test_tiny_vit_hyena_forward_matches_jax(tiny_hyena, amp, tol):
    """At 4,096 tokens (both packages' long convs take the fp32 FFT route):
    the hidden-state list (fp32, 1e-4 of max) and the logits, fp32 to 1e-4
    of max (sum order), bf16 AMP to 3e-2 (a bf16 ulp flipped by a different
    fp32 sum propagates through the blocks)."""
    jm, params = tiny_hyena
    x = np.random.default_rng(22).normal(size=(1, 1, 256, 256, 1)).astype(np.float32)
    model = _port_model(HYENA_ARGV + (["--use_amp"] if amp else []), params)
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


def _jax_step(jm, params, x, y, amp):
    """One JAX train step: (loss, port-named numpy gradients)."""
    from long_context_biomedical_imaging_tpu.losses import get_loss_func as jax_get_loss_func
    from long_context_biomedical_imaging_tpu.trainer.train_state import (
        create_train_state, make_train_step as jax_make_train_step)
    from test_torch_train import _keep_grads

    state = create_train_state(jm, {"params": jax.tree.map(jnp.asarray, params)}, _keep_grads())
    step = jax.jit(jax_make_train_step(jm, jax_get_loss_func("CrossEntropy"), _keep_grads(),
                                       use_amp=amp, return_output=False))
    new, loss, _ = step(state, jnp.asarray(x), jnp.asarray(y), 0.0, jax.random.PRNGKey(0))
    grads = params_from_jax(jax.tree.map(np.asarray, flax.serialization.to_state_dict(
        new.opt_state)))
    return float(loss), {k: v.float().numpy() for k, v in grads.items()}


def _port_step(argv, params, x, y, amp):
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.optim import OptimManager
    from long_context_biomedical_imaging_tpu_torch.trainer import make_train_step

    argv = argv + ["--optim_type=sgd"] + (["--use_amp"] if amp else [])
    model = _port_model(argv, params)
    optim = OptimManager(check_args(parse_config(argv)), num_train_samples=1)
    optim.build(model.parameters())
    stats = make_train_step(model, cross_entropy_loss, optim, use_amp=amp)(
        [(torch.from_numpy(x), torch.from_numpy(y).long())], 0.0, 1)
    return stats[0].item(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("amp,loss_tol,tol", [(False, 1e-5, 1e-4), (True, 3e-3, 1e-1)])
def test_tiny_vit_hyena_train_step_matches_jax(tiny_hyena, amp, loss_tol, tol):
    """One train step at 4,096 tokens from the same weights and batch: the
    loss within loss_tol (relative) and every parameter's gradient within
    tol of its max|g|. fp32: 1e-4 (sum order, forward and backward); bf16
    AMP: 1e-1 per parameter, as the ViT and Swin models are held (a bf16 ulp
    flipped by a different fp32 sum propagates)."""
    jm, params = tiny_hyena
    x = np.random.default_rng(23).normal(size=(1, 1, 256, 256, 1)).astype(np.float32)
    y = np.array([1], np.int32)
    jloss, jgrads = _jax_step(jm, params, x, y, amp)
    loss, grads = _port_step(HYENA_ARGV, params, x, y, amp)
    np.testing.assert_allclose(loss, jloss, rtol=loss_tol, atol=0)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        assert g is not None and g.dtype == torch.float32, k
        _close(g, jgrads[k], tol, k)


def test_tiny_vit_hyena_at_8192_tokens_takes_k6(monkeypatch):
    """At 8,192 tokens the long conv of each block takes K6 on both sides:
    the JAX package's Pallas kernel in interpret mode, the port's K6 wrapper
    (its plain version on the CPU; two calls forward). The logits within
    K6's forward limit (2e-2 of max) and one fp32 train step's loss within
    1e-3 (relative); every parameter's gradient with cosine > 0.995 and
    relative L2 < 0.08 of the JAX package's (K6's gradient limits)."""
    jm, params = _jax_params(SPECTRAL_ARGV, (1, 1, 256, 512, 1), 24)
    x = np.random.default_rng(25).normal(size=(1, 1, 256, 512, 1)).astype(np.float32)
    y = np.array([0], np.int32)
    calls = []
    real = tspec.spectral_causal_conv
    monkeypatch.setattr(tfft, "spectral_causal_conv",
                        lambda *a: calls.append(tuple(a[0].shape)) or real(*a))
    model = _port_model(SPECTRAL_ARGV, params)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert calls == [(1, 32, 8192)] * 2
    _close(out, jm.apply({"params": params}, jnp.asarray(x), deterministic=True), K6_FWD_TOL)
    jloss, jgrads = _jax_step(jm, params, x, y, False)
    loss, grads = _port_step(SPECTRAL_ARGV, params, x, y, False)
    np.testing.assert_allclose(loss, jloss, rtol=1e-3, atol=0)
    for k, g in grads.items():
        cos, rel = _cos_rel(g.numpy(), jgrads[k])
        assert cos > K6_COS and rel < K6_REL_L2, (k, cos, rel)


# ---------------------------------------------------------------------------
# The entry point, and Swin checkpointing
# ---------------------------------------------------------------------------

def test_run_torch_trains_vit_hyena_and_reruns_inference_only(tmp_path):
    """run_torch.main with the vit65k_hyena flags (projects/run_ptx.sh with
    the ViT-hyena encoder, ViTLinear and batch 1) at a tiny geometry (32x32,
    patch 4, hidden 32): 2 epochs of 3 steps (--debug), the checkpoint
    streams, the classification metrics; an inference-only rerun reproduces
    the test metrics."""
    from test_torch_e2e import make_dataset

    make_dataset(f"{tmp_path}/data", n=8, size=32)
    argv = [f"--run_name=hy", f"--log_dir={tmp_path}/logs", f"--data_dir={tmp_path}/data",
            "--exact_metrics=True", "--time=1", "--batch_size=1", "--seed=1", "--device=cpu",
            "--affine_aug=True", "--brightness_aug=True", "--gaussian_blur_aug=False",
            "--train_model=True", "--num_epochs=2", "--num_workers=2", "--prefetch_factor=2",
            "--loss_func=CrossEntropy", "--use_amp", "--optim_type=adam", "--optim.lr=1e-5",
            "--optim.beta1=0.9", "--optim.beta2=0.99", "--scheduler_type=OneCycleLR",
            "--checkpoint_frequency=1", "--debug",
            *[a for a in HYENA_ARGV if a not in ("--height=256", "--width=256")],
            "--height=32", "--width=32"]
    assert main(argv) == 0
    run_dir = f"{tmp_path}/logs/hy"
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


@pytest.mark.parametrize("amp", [False, True])
def test_swin_checkpointing_keeps_loss_and_gradients(amp):
    """--Swin.use_checkpoint=True recomputes each Swin block in the backward
    (the JAX package remats them): a tiny Swin-Hyena's loss and every
    gradient equal the unwrapped model's to 1e-6 of max, in fp32 and through
    the AMP cast, and the recompute runs the block's forward a second time."""
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss

    argv = ["--task_type=class", "--encoder_name=Swin", "--decoder_name=SwinLinear",
            "--height=64", "--width=64", "--no_out_channel=2", "--seed=3",
            "--Swin.size=custom", "--Swin.embed_dim=16", "--Swin.depths", "2", "1", "1", "1",
            "--Swin.num_heads", "2", "2", "2", "2", "--Swin.patch_size", "2",
            "--Swin.window_size", "4", "--Swin.use_hyena", "True"] + (["--use_amp"] if amp else [])
    x = torch.randn(2, 1, 64, 64, 1, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([0, 1])
    results = []
    for flag in ("False", "True"):
        model = build_model(check_args(parse_config(argv + [f"--Swin.use_checkpoint={flag}"])))
        assert model.encoder.layer_0.use_checkpoint == (flag == "True")
        runs = []
        block = model.encoder.layer_0.block_0
        handle = block.register_forward_pre_hook(lambda *_: runs.append(1))
        loss = cross_entropy_loss(functional_call(model, amp_params(model, amp), (x,)).float(), y)
        loss.backward()
        handle.remove()
        assert len(runs) == (2 if flag == "True" else 1)
        results.append((loss.item(), {k: p.grad for k, p in model.named_parameters()}))
    (loss0, g0), (loss1, g1) = results
    assert abs(loss1 - loss0) <= 1e-6 * abs(loss0)
    for k, g in g0.items():
        _close(g1[k], g.numpy(), 1e-6, k)
