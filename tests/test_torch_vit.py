"""PyTorch port, the vit16k path (ViT + full-sequence attention + ViTLinear)
against the JAX package on the CPU.

* K5's plain version (forward and every gradient, through the port's
  ``flash_attention`` and its autograd Function) against the JAX package's
  Pallas ``flash_attention`` in interpret mode with small blocks, at ragged
  lengths; ``multi_head_attention``'s route (plain below 1024 tokens, K5's
  wrapper from 1024).
* ``PatchEmbeddingBlock``, the ViT's flax LayerNorm, ``ViTLinear``.
* A tiny ViT + ViTLinear (2 layers, hidden 64, 4 heads, 32x32 with patch 4):
  the backbone's hidden-state list, the logits in fp32 and under AMP, once
  more at 1,025 tokens (128x128), where both models take the flash route,
  and one train step's gradients against the JAX ``make_train_step``.
* ``params_from_jax`` on the ViT tree, and a tiny ViT run through
  ``run_torch.main`` with checkpoints and an inference-only rerun.

The same numpy inputs (made from a seed) go to both packages; tolerances are
stated per test.
"""

import os
import re
import sys

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from long_context_biomedical_imaging_tpu.models import build_model as jax_build_model
from long_context_biomedical_imaging_tpu.models.class_heads import ViTLinear as JaxViTLinear
from long_context_biomedical_imaging_tpu.models.layers import (
    PatchEmbeddingBlock as JaxPatchEmbeddingBlock)
from long_context_biomedical_imaging_tpu.ops import attention as jattention
from long_context_biomedical_imaging_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention)
from long_context_biomedical_imaging_tpu.setup import parse_config as jax_parse_config
from long_context_biomedical_imaging_tpu.setup.config import check_args as jax_check_args
from long_context_biomedical_imaging_tpu_torch.models import build_model
from long_context_biomedical_imaging_tpu_torch.models.class_heads import ViTLinear
from long_context_biomedical_imaging_tpu_torch.models.layers import (FlaxLayerNorm,
                                                                     PatchEmbeddingBlock)
from long_context_biomedical_imaging_tpu_torch.ops import attention as tattention
from long_context_biomedical_imaging_tpu_torch.ops import flash_attention as tfa
from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
from long_context_biomedical_imaging_tpu_torch.trainer import amp_params
from long_context_biomedical_imaging_tpu_torch.utils.convert import params_from_jax
from test_torch_models import _random_params

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from run_torch import main  # noqa: E402

TINY_VIT_ARGV = ["--task_type=class", "--encoder_name=ViT", "--decoder_name=ViTLinear",
                 "--height=32", "--width=32", "--no_in_channel=1", "--no_out_channel=2",
                 "--seed=3", "--ViT.size=custom", "--ViT.hidden_size=64",
                 "--ViT.mlp_dim=128", "--ViT.num_layers=2", "--ViT.num_heads=4",
                 "--ViT.patch_size", "4"]
# the same model on 128x128: 1,024 patch tokens and the cls token
LONG_VIT_ARGV = [a for a in TINY_VIT_ARGV if a not in ("--height=32", "--width=32")] + [
    "--height=128", "--width=128"]


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, ref, tol, name=""):
    """got within tol of max|ref| (absolute) of ref."""
    ref = _f32(ref)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-8),
                               err_msg=name)


# ---------------------------------------------------------------------------
# K5's plain version and the attention route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16, 48, 64])
@pytest.mark.parametrize("l", [200, 257])
def test_flash_attention_plain_matches_jax(rng, l, d, dtype):
    """The port's flash_attention on CPU tensors (the plain version and, for
    the gradients, its autograd Function's plain VJP) against the JAX
    package's Pallas flash attention in interpret mode with blocks of 64
    queries and 128 keys, so the last key block is ragged (200 = 128 + 72,
    257 = 2 * 128 + 1): the output and dq, dk, dv for one cotangent. fp32:
    1e-5 of max (the online softmax's sum order); bf16: 2e-2 of max (a bf16
    ulp: both round p to bf16, relative to the running max on the JAX side
    and to the row max here). Head dims 8 and 48, which the kernels run on
    16- and 64-wide tiles, as 16 and 64. No kernel launches on the CPU."""
    b, h = 1, 2
    arrs = [rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(4)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v, do = (jnp.asarray(a).astype(jdt) for a in arrs)
    ref, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(q, k, v, block_q=64, block_k=128),
                       q, k, v)
    jgrads = vjp(do)

    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in arrs[:3]]
    launches = (tfa.FLASH_FWD.launches, tfa.FLASH_BWD_DQ.launches, tfa.FLASH_BWD_DKV.launches)
    out = tfa.flash_attention(*leaves)
    out.backward(torch.from_numpy(arrs[3]).to(tdt))
    assert launches == (tfa.FLASH_FWD.launches, tfa.FLASH_BWD_DQ.launches,
                        tfa.FLASH_BWD_DKV.launches)
    assert out.dtype == tdt and all(t.grad.dtype == tdt for t in leaves)
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(out, ref, tol, "o")
    for name, t, g in zip(("dq", "dk", "dv"), leaves, jgrads):
        _close(t.grad, g, tol, name)


@pytest.mark.parametrize("l,flash", [(1023, False), (1025, True)])
def test_multi_head_attention_routes_as_jax(rng, monkeypatch, l, flash):
    """Below 1024 query tokens multi_head_attention runs the plain attention,
    from 1024 (without a bias) K5's wrapper, as the JAX package routes it;
    either way the output matches the JAX package's multi_head_attention
    (its plain attention at 1,023 tokens, its flash kernel in interpret mode
    at 1,025) to 1e-5 of max."""
    calls = []
    real = tattention.flash_attention
    monkeypatch.setattr(tattention, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = (rng.normal(size=(1, 2, l, 16)).astype(np.float32) for _ in range(3))
    out = tattention.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert len(calls) == int(flash)
    ref = jattention.multi_head_attention(*(jnp.asarray(a) for a in (q, k, v)))
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_reference_matches_jax(rng, dtype):
    """The plain attention with an additive bias: fp32 scores and softmax,
    p rounded to v's dtype, the result in v's dtype; fp32 to 1e-6 of max,
    bf16 to a bf16 ulp (2e-2 of max)."""
    q, k, v = (rng.normal(size=(2, 3, 40, 8)).astype(np.float32) for _ in range(3))
    bias = rng.normal(size=(3, 40, 40)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jattention.attention_reference(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                                         bias=jnp.asarray(bias))
    out = tattention.attention_reference(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                         bias=torch.from_numpy(bias))
    assert out.dtype == tdt
    _close(out, ref, 1e-6 if dtype == "float32" else 2e-2)


# ---------------------------------------------------------------------------
# Layers and head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patch_embedding_block_matches_jax(rng, dtype):
    """PatchEmbeddingBlock: patches cast to the compute dtype after
    extraction, projected, flattened row-major, plus the position embedding
    cast to that dtype; fp32 to 1e-6 of max, bf16 to 1e-2 (the same
    roundings; sum order of the projection). Its own initialisation draws
    the position embedding as flax's trunc_normal(0.02): within 2 * 0.02 /
    0.8796 and with a standard deviation near 0.02."""
    x = rng.normal(size=(2, 32, 24, 2)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    jm = JaxPatchEmbeddingBlock(img_size=(32, 24), patch_size=(4, 4), hidden_size=48, dtype=jdt)
    shapes = flax.serialization.to_state_dict(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"])
    params = _random_params(shapes, np.random.default_rng(1))
    cast = (lambda a: jnp.asarray(a).astype(jdt)) if jdt is not None else jnp.asarray
    ref = jm.apply({"params": jax.tree.map(cast, params)}, jnp.asarray(x))

    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    port = PatchEmbeddingBlock((32, 24), (4, 4), 2, 48, dtype=tdt)
    port.load_state_dict(params_from_jax(params), strict=True)
    if tdt is not None:
        port = port.to(tdt)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.shape == (2, 48, 48) and out.dtype == (tdt or torch.float32)
    _close(out, ref, 1e-6 if tdt is None else 1e-2)

    from long_context_biomedical_imaging_tpu_torch.models import init_weights

    pos = init_weights(PatchEmbeddingBlock((64, 64), (2, 2), 1, 64),
                       torch.Generator().manual_seed(0)).position_embeddings
    assert pos.abs().max().item() <= 2 * 0.02 / 0.87962566103423978 + 1e-7
    assert abs(pos.std().item() - 0.02) < 0.002


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flax_layer_norm_matches_jax(rng, dtype):
    """FlaxLayerNorm against flax nn.LayerNorm (the ViT's norm1 and final
    norm): the fast variance in fp32, eps 1e-6, the result in the promoted
    dtype of x and the parameters. Inputs with a large mean make the fast
    variance differ from the two-pass one. fp32 to 1e-6 of max; bf16 (x and
    parameters in bf16, as under AMP) to a bf16 ulp."""
    x = (rng.normal(size=(4, 7, 96)) * 2.0 + 3.0).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=96)).astype(np.float32)
    bias = (0.3 * rng.normal(size=96)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = fnn.LayerNorm().apply({"params": {"scale": jnp.asarray(scale).astype(jdt),
                                            "bias": jnp.asarray(bias).astype(jdt)}},
                                jnp.asarray(x).astype(jdt))
    ln = FlaxLayerNorm(96)
    ln.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        out = ln.to(tdt)(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt and ref.dtype == jdt
    _close(out, ref, 1e-6 if dtype == "float32" else 8e-3)


@pytest.mark.parametrize("use_cls_token", [True, False])
def test_vit_linear_matches_jax(rng, use_cls_token):
    """ViTLinear: the cls row (attention) or the token mean (Hyena, Mamba),
    Linear, Tanh; 1e-6 of max."""
    h = rng.normal(size=(3, 9, 32)).astype(np.float32)
    jm = JaxViTLinear(num_classes=2, use_cls_token=use_cls_token)
    shapes = flax.serialization.to_state_dict(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), [jnp.asarray(h)]))["params"])
    params = _random_params(shapes, np.random.default_rng(2))
    ref = jm.apply({"params": params}, [jnp.asarray(h)])
    port = ViTLinear(32, 2, use_cls_token=use_cls_token)
    port.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        out = port([torch.from_numpy(h)])
    _close(out, ref, 1e-6)


# ---------------------------------------------------------------------------
# The tiny ViT
# ---------------------------------------------------------------------------

def _jax_params(argv, x_shape, seed):
    jm = jax_build_model(jax_check_args(jax_parse_config(argv)))
    shapes = flax.serialization.to_state_dict(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros(x_shape), deterministic=True))[
            "params"])
    return jm, _random_params(shapes, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def tiny_vit():
    """(JAX model, JAX params as numpy) of the 32x32 geometry: 64 tokens and
    the cls token, the plain attention on both sides."""
    return _jax_params(TINY_VIT_ARGV, (2, 1, 32, 32, 1), 11)


def _port_model(argv, params):
    model = build_model(check_args(parse_config(argv)))
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def test_params_from_jax_maps_every_vit_leaf(tiny_vit):
    """Every JAX leaf of the ViT tree lands on a port parameter of its shape,
    and none is left over: the patch projection and position embedding, the
    cls token, each block's norm1, qkv (TorchDense_0, no bias), out
    projection (TorchDense_1) and fused MLP, the final norm, the head."""
    _, params = tiny_vit
    state_dict = params_from_jax(params)
    port = dict(build_model(check_args(parse_config(TINY_VIT_ARGV))).state_dict())
    assert set(state_dict) == set(port)
    for k, v in state_dict.items():
        assert tuple(v.shape) == tuple(port[k].shape), k
    for key in ("encoder.patch_embedding.kernel", "encoder.patch_embedding.position_embeddings",
                "encoder.cls_token", "encoder.block_1.norm1.scale",
                "encoder.block_1.attn.qkv.kernel", "encoder.block_1.attn.proj.bias",
                "encoder.block_1.mlp.fc2_kernel", "encoder.norm.bias",
                "decoder.classification_head.kernel"):
        assert key in state_dict, key
    assert "encoder.block_0.attn.qkv.bias" not in state_dict


def test_vit_backbone_hidden_states_match_jax(tiny_vit):
    """The backbone's hidden-state list: [input (B, H, W, C), h1, h2, final
    norm], N + 2 tensors of the JAX package's shapes, each to 1e-5 of max
    (fp32 sum order)."""
    jm, params = tiny_vit
    x = np.random.default_rng(12).normal(size=(2, 1, 32, 32, 1)).astype(np.float32)
    ref = jm.encoder.apply({"params": params["encoder"]}, jnp.asarray(x))
    model = _port_model(TINY_VIT_ARGV, params)
    with torch.no_grad():
        got = model.encoder(torch.from_numpy(x))
    assert len(got) == len(ref) == 4
    assert tuple(got[0].shape) == (2, 32, 32, 1) and tuple(got[-1].shape) == (2, 65, 64)
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, 1e-5, f"h{i}")


@pytest.mark.parametrize("amp,tol", [(False, 1e-4), (True, 3e-2)])
def test_tiny_vit_forward_matches_jax(tiny_vit, amp, tol):
    """The logits of the whole model. fp32: 1e-4 of max (sum order); bf16
    AMP: 3e-2 of max (a bf16 ulp flipped by a different fp32 sum
    propagates through the blocks)."""
    jm, params = tiny_vit
    x = np.random.default_rng(13).normal(size=(2, 1, 32, 32, 1)).astype(np.float32)
    dt = jnp.bfloat16 if amp else jnp.float32
    ref = jm.apply({"params": jax.tree.map(lambda a: jnp.asarray(a).astype(dt), params)},
                   jnp.asarray(x), deterministic=True)
    model = _port_model(TINY_VIT_ARGV + (["--use_amp"] if amp else []), params)
    with torch.no_grad():
        out = functional_call(model, amp_params(model, amp), (torch.from_numpy(x),))
    assert out.shape == (2, 2) and out.dtype == (torch.bfloat16 if amp else torch.float32)
    _close(out, ref, tol)


def test_tiny_vit_at_1025_tokens_takes_the_flash_route(monkeypatch):
    """The tiny ViT on 128x128 images: 1,024 patch tokens and the cls token,
    so each block's attention takes the flash route on both sides (the JAX
    package's Pallas kernel in interpret mode; the port's K5 wrapper, the
    plain version on the CPU). Hidden states to 1e-4 of max, logits to 1e-4
    (fp32)."""
    jm, params = _jax_params(LONG_VIT_ARGV, (1, 1, 128, 128, 1), 14)
    x = np.random.default_rng(15).normal(size=(1, 1, 128, 128, 1)).astype(np.float32)
    ref_h = jm.encoder.apply({"params": params["encoder"]}, jnp.asarray(x))
    ref = jm.apply({"params": params}, jnp.asarray(x), deterministic=True)
    calls = []
    real = tattention.flash_attention
    monkeypatch.setattr(tattention, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    model = _port_model(LONG_VIT_ARGV, params)
    with torch.no_grad():
        got_h = model.encoder(torch.from_numpy(x))
        out = model(torch.from_numpy(x))
    assert calls == [(1, 4, 1025, 16)] * 4
    for i, (a, b) in enumerate(zip(got_h, ref_h)):
        _close(a, b, 1e-4, f"h{i}")
    _close(out, ref, 1e-4)


@pytest.fixture(scope="module")
def tiny_vit_steps(tiny_vit):
    """One JAX train step of the tiny ViT, fp32 and bf16 AMP, from the same
    weights and batch: {amp: (loss, port-named numpy gradients)}, and the
    batch."""
    from long_context_biomedical_imaging_tpu.losses import get_loss_func as jax_get_loss_func
    from long_context_biomedical_imaging_tpu.trainer.train_state import (
        create_train_state, make_train_step as jax_make_train_step)
    from test_torch_train import _keep_grads

    jm, params = tiny_vit
    x = np.random.default_rng(16).normal(size=(2, 1, 32, 32, 1)).astype(np.float32)
    y = np.array([0, 1], np.int32)
    steps = {}
    for amp in (False, True):
        state = create_train_state(jm, {"params": jax.tree.map(jnp.asarray, params)},
                                   _keep_grads())
        step = jax.jit(jax_make_train_step(jm, jax_get_loss_func("CrossEntropy"), _keep_grads(),
                                           use_amp=amp, return_output=False))
        new, loss, _ = step(state, jnp.asarray(x), jnp.asarray(y), 0.0, jax.random.PRNGKey(0))
        grads = params_from_jax(jax.tree.map(np.asarray, flax.serialization.to_state_dict(
            new.opt_state)))
        steps[amp] = (float(loss), {k: v.float().numpy() for k, v in grads.items()})
    return steps, x, y


@pytest.mark.parametrize("amp,loss_tol,tol", [(False, 1e-5, 1e-4), (True, 3e-3, 1e-1)])
def test_tiny_vit_train_step_matches_jax(tiny_vit, tiny_vit_steps, amp, loss_tol, tol):
    """One train step of the tiny ViT from the same weights and batch: the
    loss within loss_tol (relative) and every parameter's gradient within
    tol of its max|g|. fp32: 1e-4 (sum order, forward and backward); bf16
    AMP: 1e-1, as tests/test_torch_train.py holds the Swin model (both sides
    round the same operands, but a bf16 ulp flipped by a different fp32 sum
    propagates, and the plain backwards round their cotangents at other
    points than the TPU kernels)."""
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.optim import OptimManager
    from long_context_biomedical_imaging_tpu_torch.trainer import make_train_step

    _, params = tiny_vit
    steps, x, y = tiny_vit_steps
    jloss, jgrads = steps[amp]
    argv = TINY_VIT_ARGV + ["--optim_type=sgd"] + (["--use_amp"] if amp else [])
    model = _port_model(argv, params)
    optim = OptimManager(check_args(parse_config(argv)), num_train_samples=2)
    optim.build(model.parameters())
    stats = make_train_step(model, cross_entropy_loss, optim, use_amp=amp)(
        [(torch.from_numpy(x), torch.from_numpy(y).long())], 0.0, 2)
    np.testing.assert_allclose(stats[0].item(), jloss, rtol=loss_tol, atol=0)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        assert g is not None and g.dtype == torch.float32, k
        _close(g, jgrads[k], tol, k)


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def _vit_args(tmp_path, run_name, *extra):
    """The vit16k flags (projects/run_ptx.sh with the ViT encoder, ViTLinear
    and batch 2) at the tiny geometry, on the CPU."""
    return [f"--run_name={run_name}", f"--log_dir={tmp_path}/logs",
            f"--data_dir={tmp_path}/data", "--exact_metrics=True", "--time=1",
            "--batch_size=2", "--seed=1", "--device=cpu", "--affine_aug=True",
            "--brightness_aug=True", "--gaussian_blur_aug=False", "--train_model=True",
            "--num_epochs=2", "--num_workers=2", "--prefetch_factor=2",
            "--loss_func=CrossEntropy", "--use_amp", "--optim_type=adam", "--optim.lr=1e-5",
            "--optim.beta1=0.9", "--optim.beta2=0.99", "--scheduler_type=OneCycleLR",
            "--checkpoint_frequency=1", *TINY_VIT_ARGV, *extra]


def test_run_torch_trains_vit_and_reruns_inference_only(tmp_path):
    """run_torch.main with the vit16k flags at the tiny geometry: 2 epochs
    of 2 steps (4 of the 8 subjects train, at batch 2), the checkpoint
    streams, the classification metrics; an inference-only rerun reproduces
    the test metrics."""
    from test_torch_e2e import make_dataset

    make_dataset(f"{tmp_path}/data", n=8, size=32)
    assert main(_vit_args(tmp_path, "vit")) == 0
    run_dir = f"{tmp_path}/logs/vit"
    assert sorted(os.listdir(f"{run_dir}/models")) == [
        "model_best_checkpoint", "model_epoch_0", "model_epoch_1", "model_last_epoch"]
    log = open(f"{run_dir}/run.log").read()
    assert re.findall(r"epoch (\d) train: (\d) steps", log) == [("0", "2"), ("1", "2")]
    test = open(f"{run_dir}/test_metrics.txt").read()
    metrics = dict(line.split(": ") for line in test.strip().splitlines())
    assert set(metrics) == {"loss", "acc_1", "auroc", "f1"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert main(["--inference_only=True", f"--inference_dir={run_dir}",
                 f"--inference_log_dir={tmp_path}/logs", "--inference_run_name=inf"]) == 0
    assert open(f"{tmp_path}/logs/inf/test_metrics.txt").read() == test
