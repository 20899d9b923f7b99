"""PyTorch port, the emb_attn path (3D Swin with window attention) and K2'
against the JAX package on the CPU.

* ``ops/window_attention.py``: ``windowed_attention_proj`` (the K8 autograd
  Function, its plain passes on CPU tensors) and all six gradients against
  JAX's, whose Pallas kernel runs in interpret mode, at the windows K8's
  general path takes: V = 49 (a 7x7 window), 256 (emb_attn's shrunk last
  stage), 343 (7x7x7) and 512 (8x8x8), with and without region ids.
* ``MLPBlock`` and ``ops.fused_mlp`` (K2'): forward and four gradients
  against JAX's ``MLPBlock`` (its fused Pallas kernel in interpret mode),
  fp32 and bf16, through the parameter conversion.
* A tiny 3D Swin-attention model (embed 64, heads 2/4 so D = 32, depths
  2/2, patch 2, window 8 on a 16x32x32 volume: stage 0 runs 512-token
  windows, shifted on its odd block; stage 1 shrinks them to 4x8x8 = 256):
  hidden states, logits and one train step's gradients.
* A tiny emb_attn-style run through ``run_torch.main`` with an
  ``--inference_only`` rerun.

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

from long_context_biomedical_imaging_tpu.losses import get_loss_func as jax_get_loss_func
from long_context_biomedical_imaging_tpu.models.layers import MLPBlock as JaxMLPBlock
from long_context_biomedical_imaging_tpu.trainer.train_state import (
    create_train_state, make_train_step as jax_make_train_step)
from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
from long_context_biomedical_imaging_tpu_torch.models import MLPBlock, build_model
from long_context_biomedical_imaging_tpu_torch.ops import fused_mlp as tfm
from long_context_biomedical_imaging_tpu_torch.ops.window import get_window_size
from long_context_biomedical_imaging_tpu_torch.optim import OptimManager
from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
from long_context_biomedical_imaging_tpu_torch.trainer import make_train_step
from long_context_biomedical_imaging_tpu_torch.utils.convert import params_from_jax
from test_torch_emb import _emb_args, make_volumes
from test_torch_swin_attn import (NAMES, _attn_inputs, _forward_both, _hold, _jax_attention,
                                  _jax_params, _port_attention, _rel_err)
from test_torch_train import _keep_grads

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from run_torch import main  # noqa: E402


# ---------------------------------------------------------------------------
# windowed_attention_proj at the general path's windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,rid,dtype", [
    (v, rid, "float32") for v in (49, 256, 343, 512) for rid in (True, False)]
    + [(v, True, "bfloat16") for v in (49, 256, 343, 512)], ids=lambda a: str(a))
def test_window_attention_general_windows_match_jax(v, rid, dtype):
    """The output and all six gradients against JAX's Pallas kernel
    (interpret mode; 49 tokens group four windows into 256 lanes, 343 pad to
    384), fp32 with and without region ids, bf16 with them (the shifted
    blocks' call). fp32: within 1e-5 of each one's max|ref| (fp32 sum
    order). bf16 (x and the weights in bf16, biases and rel fp32): the
    output within 2e-2
    of its max (a bf16 ulp, rounded at the same points), each gradient
    within 3e-2 (the plain VJP rounds its cotangents where autograd of the
    rounded forward does, JAX's kernel where the TPU kernel does)."""
    bw, c, heads = (4, 64, 2) if v < 256 else (2, 64, 2)
    args, r, g = _attn_inputs(np.random.default_rng(v + 7 * rid), bw, v, c, heads,
                              (2 if rid else None))
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    jout, jgrads = _jax_attention(args, r, g, heads, jd)
    out, grads = _port_attention(args, r, g, heads, td)
    assert out.dtype == td
    tols = (1e-5, 1e-5) if dtype == "float32" else (2e-2, 3e-2)
    assert _rel_err(out, jout) <= tols[0], "out"
    for name, a, b in zip(NAMES[1:], grads, jgrads):
        assert _rel_err(a, b) <= tols[1], name


# ---------------------------------------------------------------------------
# MLPBlock and K2'
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_block_matches_jax(dtype):
    """MLPBlock (eval, so K2''s path; its plain version on the CPU) against
    JAX's MLPBlock (its fused Pallas kernel in interpret mode) with the same
    parameters through the conversion: the output and the gradients of x and
    the four parameters. fp32 within 1e-5 of max (JAX's erf is a rational
    approximation within 1.5e-7); bf16 (x in bf16, the parameters fp32 as
    under a bf16 stream with fp32 masters) the output within 2e-2 of max, the
    gradients within 3e-2 (GELU's tanh form on both sides; rounding of the
    cotangents at other points)."""
    rng = np.random.default_rng(30)
    c, hidden = 64, 256
    x = rng.normal(size=(3, 37, c)).astype(np.float32)
    g = rng.normal(size=(3, 37, c)).astype(np.float32)
    jm = JaxMLPBlock(hidden_size=c, mlp_dim=hidden)
    params = jax.tree.map(np.asarray, flax.serialization.to_state_dict(
        jm.init(jax.random.PRNGKey(1), jnp.zeros((1, c)))["params"]))
    assert set(params) == {"fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias"}
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))

    def fn(p, xx):
        return jm.apply({"params": p}, xx, deterministic=True)

    jout, vjp = jax.vjp(fn, jax.tree.map(jnp.asarray, params), jnp.asarray(x).astype(jd))
    jp, jx = vjp(jnp.asarray(g).astype(jd))

    block = MLPBlock(c, hidden)
    block.load_state_dict(params_from_jax({"params": params}), strict=True)
    block.eval()
    xt = torch.from_numpy(x).to(td).requires_grad_()
    out = block(xt)
    out.backward(torch.from_numpy(g).to(td))
    assert out.dtype == td and out.shape == xt.shape
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert _rel_err(out, jout) <= (1e-5 if dtype == "float32" else 2e-2), "out"
    assert _rel_err(xt.grad, jx) <= tol, "x"
    for name, p in block.named_parameters():
        assert p.grad.dtype == torch.float32
        assert _rel_err(p.grad, jp[name]) <= tol, name


def test_mlp_block_dropout_takes_the_composed_path():
    """With dropout in training mode: the composed path (no K2' Function),
    keep masks from the caller's generator, repeatable from its seed; in eval
    mode, or with a rate of 0, the K2' Function whose CPU forward is
    fused_mlp_plain bit for bit; no generator in training mode raises."""
    gen = torch.Generator().manual_seed(0)
    block = MLPBlock(32, 128, dropout_rate=0.5)
    for p in block.parameters():
        torch.nn.init.uniform_(p, -0.2, 0.2, generator=gen)
    x = torch.randn(4, 9, 32, generator=gen)
    calls = []
    apply = tfm._FusedMlp.apply
    tfm._FusedMlp.apply = lambda *a: calls.append(a) or apply(*a)
    try:
        block.train()
        a = block(x, torch.Generator().manual_seed(5))
        b = block(x, torch.Generator().manual_seed(5))
        assert not calls and torch.equal(a, b)
        with pytest.raises(ValueError, match="generator"):
            block(x)
        block.eval()
        out = block(x)
        assert len(calls) == 1
    finally:
        tfm._FusedMlp.apply = apply
    ref = tfm.fused_mlp_plain(x, block.fc1_kernel, block.fc1_bias, block.fc2_kernel,
                              block.fc2_bias)
    assert torch.equal(out, ref) and not torch.equal(a, out)


# ---------------------------------------------------------------------------
# The tiny 3D Swin-attention model
# ---------------------------------------------------------------------------

ATTN3D_ARGV = ["--task_type=class", "--encoder_name=Swin", "--decoder_name=SwinLinear",
               "--height=32", "--width=32", "--time=16", "--no_out_channel=2", "--seed=3",
               "--Swin.size=custom", "--Swin.embed_dim=64", "--Swin.depths", "2", "2",
               "--Swin.num_heads", "2", "4", "--Swin.patch_size", "2", "--Swin.window_size", "8",
               "--Swin.use_hyena", "False", "--Swin.use_mamba", "False"]
ATTN3D_SHAPE = (1, 16, 32, 32, 1)


def test_swin_attention_3d_model_matches_jax():
    """Hidden states (input, patch embed, two stages) and logits within 1e-4
    of max (fp32 sum order through two stages). Token grids 8x16x16 (8x8x8
    windows, V = 512, the odd block shifted by (0, 4, 4)) and 4x8x8 (the
    window shrunk to the grid: V = 256, no shift)."""
    ref, got, model = _forward_both(ATTN3D_ARGV, ATTN3D_SHAPE, 41)
    blocks = model.encoder.layer_0.block_1, model.encoder.layer_1.block_1
    assert blocks[0].attn.mixer_name == "attention"
    assert [get_window_size(grid, (8, 8, 8), b.shift_size) for grid, b in
            zip(((8, 16, 16), (4, 8, 8)), blocks)] == [((8, 8, 8), (0, 4, 4)),
                                                       ((4, 8, 8), (0, 0, 0))]
    assert blocks[0].attn.relative_position_bias_table.shape == (15 * 15 * 15, 2)
    assert blocks[1].attn.relative_position_bias_table.shape == (7 * 15 * 15, 4)
    _hold(ref, got, 1e-4)


def test_swin_attention_3d_train_step_matches_jax():
    """One fp32 train step of the tiny 3D model: the loss within 1e-5
    (relative) and every parameter's gradient, both stages' 3D
    relative-position tables included, within 1e-4 of its max|g| (fp32 sum
    order, forward and backward)."""
    jm, params = _jax_params(ATTN3D_ARGV, ATTN3D_SHAPE, 42)
    x = np.random.default_rng(43).normal(size=(2,) + ATTN3D_SHAPE[1:]).astype(np.float32)
    y = np.array([0, 1], np.int32)
    state = create_train_state(jm, {"params": jax.tree.map(jnp.asarray, params)}, _keep_grads())
    step = jax.jit(jax_make_train_step(jm, jax_get_loss_func("CrossEntropy"), _keep_grads(),
                                       use_amp=False, return_output=False))
    new_state, jloss, _ = step(state, jnp.asarray(x), jnp.asarray(y), 0.0, jax.random.PRNGKey(0))
    jgrads = params_from_jax(jax.tree.map(np.asarray, flax.serialization.to_state_dict(
        new_state.opt_state)))

    cfg = check_args(parse_config(ATTN3D_ARGV + ["--optim_type=sgd"]))
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    optim = OptimManager(cfg, num_train_samples=2)
    optim.build(model.parameters())
    stats = make_train_step(model, cross_entropy_loss, optim, use_amp=False)(
        [(torch.from_numpy(x), torch.from_numpy(y).long())], 0.0, 2)
    np.testing.assert_allclose(stats[0].item(), float(jloss), rtol=1e-5, atol=0)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    assert sum(k.endswith("relative_position_bias_table") for k in grads) == 4
    for k, gr in grads.items():
        ref = jgrads[k].float().numpy()
        np.testing.assert_allclose(gr.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-8), err_msg=k)


def test_run_torch_trains_emb_attn_style_and_reruns_inference_only(tmp_path):
    """run_torch.main with the emb flags and the CLI's default mixer (window
    attention) at a tiny 3D geometry (--time=16, embed 32, one head per 32
    channels): windows of 512, 256, 32 and 4 tokens. It trains 2 epochs of 2
    steps, writes the checkpoints, and an inference-only rerun reproduces the
    test metrics."""
    make_volumes(f"{tmp_path}/data", n=8)
    argv = _emb_args(tmp_path, "emb_attn", "--Swin.use_hyena", "False", "--Swin.use_mamba",
                     "False", "--Swin.embed_dim=32", "--Swin.num_heads", "1", "2", "4", "8")
    assert main(argv) == 0
    run_dir = f"{tmp_path}/logs/emb_attn"
    log = open(f"{run_dir}/run.log").read()
    assert re.findall(r"epoch (\d) train: (\d) steps", log) == [("0", "2"), ("1", "2")]
    state = torch.load(f"{run_dir}/models/model_best_checkpoint/state.pt", weights_only=True)
    assert state["params"]["encoder.layer_0.block_0.attn.relative_position_bias_table"].shape \
        == (15 * 15 * 15, 1)
    test = open(f"{run_dir}/test_metrics.txt").read()
    assert main(["--inference_only=True", f"--inference_dir={run_dir}",
                 f"--inference_log_dir={tmp_path}/logs", "--inference_run_name=inf"]) == 0
    assert open(f"{tmp_path}/logs/inf/test_metrics.txt").read() == test
