"""PyTorch port, the Swin attention path (ptx_attn) against the JAX package on
the CPU.

* ``ops/window.py``: ``relative_position_index`` and ``compute_shift_regions``
  for 2D and 3D windows, shrunk windows included, bit-exact.
* ``ops/window_attention.py``: ``windowed_attention_proj`` (the K8 autograd
  Function, its plain passes on CPU tensors) and all six gradients against
  JAX's, whose Pallas kernel runs in interpret mode, with and without region
  ids, at V = 16 and 64, fp32 and bf16; one V > 512 call on JAX's XLA route;
  the kernel wrappers' refusals (the general path's windows are held in
  ``tests/test_torch_emb_attn.py``).
* A tiny Swin-attention model from converted JAX parameters (embed 64, heads
  2/4 so D = 32, depths 2/2, patch 2, window 4 on 32x32: both stages shift):
  hidden states, SwinLinear logits and one train step's gradients.
* The per-block pad path: the same model on 40x40 with window 8 (token grids
  20 and 10 padded to 24 and 16), and the Hyena and Mamba mixers on that
  grid, which now take the per-block path as JAX's do.
* A tiny Swin-attention run through ``run_torch.main`` with an
  ``--inference_only`` rerun.

The same numpy inputs (made from a seed) go to both packages; tolerances are
stated per test.
"""

import os
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_biomedical_imaging_tpu.losses import get_loss_func as jax_get_loss_func
from long_context_biomedical_imaging_tpu.models import build_model as jax_build_model
from long_context_biomedical_imaging_tpu.ops import window as jwin
from long_context_biomedical_imaging_tpu.ops.window_attention import (
    windowed_attention_proj as jax_window_attention)
from long_context_biomedical_imaging_tpu.setup import parse_config as jax_parse_config
from long_context_biomedical_imaging_tpu.setup.config import check_args as jax_check_args
from long_context_biomedical_imaging_tpu.trainer.train_state import (
    create_train_state, make_train_step as jax_make_train_step)
from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
from long_context_biomedical_imaging_tpu_torch.models import build_model
from long_context_biomedical_imaging_tpu_torch.ops import window as twin
from long_context_biomedical_imaging_tpu_torch.ops import window_attention as twa
from long_context_biomedical_imaging_tpu_torch.optim import OptimManager
from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
from long_context_biomedical_imaging_tpu_torch.trainer import amp_params, make_train_step
from long_context_biomedical_imaging_tpu_torch.utils.convert import params_from_jax
from test_torch_e2e import make_dataset
from test_torch_models import _random_params
from test_torch_train import _keep_grads

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from run_torch import main  # noqa: E402


# ---------------------------------------------------------------------------
# Window ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,window,shift", [
    ((1, 16, 16), (1, 4, 4), (0, 2, 2)),      # ptx stage, shifted
    ((1, 24, 24), (1, 8, 8), (0, 4, 4)),      # vessel window, padded grid
    ((8, 16, 16), (4, 4, 4), (2, 2, 2)),      # 3D
    ((1, 8, 8), (1, 4, 4), (0, 0, 0)),        # no shift
    ((4, 6, 8), (2, 3, 4), (1, 1, 0)),        # mixed
    ((1, 5, 5), (1, 5, 5), (0, 0, 0)),        # a window shrunk to the grid
], ids=["2d", "2d_w8", "3d", "unshifted", "mixed", "shrunk"])
def test_window_ops_match_jax(dims, window, shift):
    """Region ids and the relative-position index, bit for bit and dtype
    (int32)."""
    ref = np.asarray(jwin.compute_shift_regions(dims, window, shift))
    got = twin.compute_shift_regions(dims, window, shift).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    ref = np.asarray(jwin.relative_position_index(window))
    got = twin.relative_position_index(window).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_window_size_shrinks_like_jax():
    """get_window_size: the window shrinks to the grid and its shift goes to 0."""
    for grid in [(1, 2, 8), (1, 8, 8), (3, 16, 4)]:
        assert twin.get_window_size(grid, (2, 4, 4), (1, 2, 2)) == \
            jwin.get_window_size(grid, (2, 4, 4), (1, 2, 2))


# ---------------------------------------------------------------------------
# windowed_attention_proj
# ---------------------------------------------------------------------------

def _attn_inputs(rng, bw, v, c, heads, nw):
    x = rng.normal(size=(bw, v, c)).astype(np.float32)
    w = [(rng.normal(size=(c, 3 * c)) * 0.2).astype(np.float32),
         (rng.normal(size=(3 * c,)) * 0.1).astype(np.float32),
         (rng.normal(size=(c, c)) * 0.2).astype(np.float32),
         (rng.normal(size=(c,)) * 0.1).astype(np.float32),
         (rng.normal(size=(heads, v, v)) * 0.5).astype(np.float32)]
    rid = None if nw is None else rng.integers(0, 4, size=(nw, v)).astype(np.int32)
    g = rng.normal(size=(bw, v, c)).astype(np.float32)
    return [x] + w, rid, g


def _jax_attention(args, rid, g, heads, dtype):
    """JAX's output and six gradients (Pallas in interpret mode up to 512
    tokens), rid tiled over the batch as JAX's WindowAttention tiles it."""
    bw = args[0].shape[0]

    def fn(x, *w):
        r = None if rid is None else jnp.tile(jnp.asarray(rid), (bw // rid.shape[0], 1))
        return jax_window_attention(x, *w, heads=heads, rid=r)

    prim = [jnp.asarray(args[0]).astype(dtype), jnp.asarray(args[1]).astype(dtype),
            *map(jnp.asarray, args[2:])]
    out, vjp = jax.vjp(fn, *prim)
    grads = vjp(jnp.asarray(g).astype(dtype))
    return out, grads


def _port_attention(args, rid, g, heads, dtype):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    xs, wq = ts[0].to(dtype), ts[1].to(dtype)
    out = twa.windowed_attention_proj(xs, wq, ts[2], ts[3], ts[4], ts[5], heads,
                                      rid=None if rid is None else torch.from_numpy(rid))
    out.backward(torch.from_numpy(g).to(dtype))
    return out, [t.grad for t in ts]


def _rel_err(got, ref):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


NAMES = ("out", "x", "wqkv", "bqkv", "wout", "bout", "rel")


@pytest.mark.parametrize("bw,v,c,heads,nw", [
    (8, 16, 64, 2, 4), (6, 16, 64, 2, None), (3, 64, 64, 2, 3), (2, 64, 32, 1, None)],
    ids=["v16_rid", "v16", "v64_rid", "v64"])
def test_window_attention_matches_jax(bw, v, c, heads, nw):
    """fp32: the output and all six gradients within 1e-5 of each one's
    max|ref| (fp32 sum order; the JAX kernel sums over a 128-lane
    block-diagonal group, the port within each window)."""
    args, rid, g = _attn_inputs(np.random.default_rng(v + bw), bw, v, c, heads, nw)
    jout, jgrads = _jax_attention(args, rid, g, heads, jnp.float32)
    out, grads = _port_attention(args, rid, g, heads, torch.float32)
    for name, a, b in zip(NAMES, [out] + grads, [jout] + list(jgrads)):
        assert _rel_err(a, b) <= 1e-5, name


def test_window_attention_bf16_matches_jax():
    """bf16 stream (x and the weights in bf16, biases and rel fp32), with
    region ids: the output within 2e-2 of max|out| (a bf16 ulp, rounded at
    the same points), each gradient within 3e-2 of its max (the port's
    plain VJP rounds its cotangents where autograd of the rounded forward
    does, JAX's kernel where the TPU kernel does)."""
    args, rid, g = _attn_inputs(np.random.default_rng(5), 8, 16, 64, 2, 4)
    jout, jgrads = _jax_attention(args, rid, g, 2, jnp.bfloat16)
    out, grads = _port_attention(args, rid, g, 2, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert _rel_err(out, jout) <= 2e-2
    for name, a, b in zip(NAMES[1:], grads, jgrads):
        assert _rel_err(a, b) <= 3e-2, name


def test_window_attention_past_max_tokens_takes_the_plain_version():
    """V = 576 > MAX_TOKENS: JAX's XLA route and the port's plain version on
    every device, fp32 within 1e-5 of max, output and gradients; the K8
    Function is not entered."""
    args, rid, g = _attn_inputs(np.random.default_rng(3), 2, 576, 64, 2, 1)
    jout, jgrads = _jax_attention(args, rid, g, 2, jnp.float32)
    calls = []
    apply = twa._WindowAttention.apply
    twa._WindowAttention.apply = lambda *a: calls.append(a) or apply(*a)
    try:
        out, grads = _port_attention(args, rid, g, 2, torch.float32)
    finally:
        twa._WindowAttention.apply = apply
    assert not calls
    for name, a, b in zip(NAMES, [out] + grads, [jout] + list(jgrads)):
        assert _rel_err(a, b) <= 1e-5, name


def test_window_attention_function_runs_its_plain_passes_on_cpu():
    """The K8 Function on CPU tensors: its forward is window_attention_plain
    and its backward window_attention_bwd_plain, bit for bit, each gradient
    in its input's dtype."""
    args, rid, g = _attn_inputs(np.random.default_rng(4), 4, 16, 64, 2, 2)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    r = torch.from_numpy(rid)
    scale = 32 ** -0.5
    out = twa._WindowAttention.apply(*ts, r, 2, -100.0, scale)
    out.backward(torch.from_numpy(g))
    plain = twa.window_attention_plain(*[t.detach() for t in ts], 2, r, -100.0, scale)
    ref = twa.window_attention_bwd_plain(torch.from_numpy(g), *[t.detach() for t in ts], 2, r,
                                         -100.0, scale)
    assert torch.equal(out.detach(), plain)
    for t, gr in zip(ts, ref):
        assert t.grad.dtype == t.dtype and torch.equal(t.grad, gr)


def test_window_attention_kernel_wrappers_refuse():
    """The kernel wrappers raise rather than fall back: a head dim other
    than 32 (ValueError), windows outside 1 to MAX_TOKENS tokens (V = 0 and
    513, ValueError: a larger window takes the plain version before the
    kernels, as in the JAX package), a CPU tensor (ValueError) at every
    window the kernels take (V = 8, 16, 128 among them), fp16 (TypeError)."""
    def call(bw, v, c, heads, dtype=torch.float32):
        args, _, _ = _attn_inputs(np.random.default_rng(0), bw, v, c, heads, None)
        t = [torch.from_numpy(a) for a in args]
        twa.window_attention_fwd(t[0].to(dtype), t[1].to(dtype), t[2], t[3].to(dtype), t[4],
                                 t[5], heads)

    with pytest.raises(ValueError, match="head dim of 32"):
        call(2, 16, 64, 4)
    for v in (0, twa.MAX_TOKENS + 1):
        with pytest.raises(ValueError, match="windows of 1 to 512"):
            call(2, v, 64, 2)
    for v in (8, 16, 128):
        with pytest.raises(ValueError, match="CUDA"):
            call(2, v, 64, 2)
    with pytest.raises(TypeError):
        call(2, 16, 64, 2, torch.float16)


# ---------------------------------------------------------------------------
# The tiny Swin-attention model
# ---------------------------------------------------------------------------

def _swin_argv(size, window, mixer="attention"):
    return ["--task_type=class", "--encoder_name=Swin", "--decoder_name=SwinLinear",
            f"--height={size}", f"--width={size}", "--no_out_channel=2", "--seed=3",
            "--Swin.size=custom", "--Swin.embed_dim=64", "--Swin.depths", "2", "2",
            "--Swin.num_heads", "2", "4", "--Swin.patch_size", "2",
            "--Swin.window_size", str(window), "--Swin.use_hyena", str(mixer == "hyena"),
            "--Swin.use_mamba", str(mixer == "mamba")]


ATTN_ARGV = _swin_argv(32, 4)
PAD_ARGV = _swin_argv(40, 8)


def _jax_params(argv, shape, seed):
    jm = jax_build_model(jax_check_args(jax_parse_config(argv)))
    shapes = flax.serialization.to_state_dict(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros(shape), deterministic=True))["params"])
    return jm, _random_params(shapes, np.random.default_rng(seed))


def _forward_both(argv, shape, seed, amp=False):
    """(JAX hidden states and logits, the port's) from one parameter draw."""
    jm, params = _jax_params(argv, shape, seed)
    x = np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)
    dt = jnp.bfloat16 if amp else jnp.float32
    p = jax.tree.map(lambda a: jnp.asarray(a).astype(dt), params)
    hidden, logits = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, method=lambda m, x: (lambda hs: (hs, m.decoder(hs)))(m.encoder(x))))(
        p, jnp.asarray(x))
    model = build_model(check_args(parse_config(argv + (["--use_amp"] if amp else []))))
    model.load_state_dict(params_from_jax(params), strict=True)
    pp = amp_params(model.eval(), amp)
    enc = {k[len("encoder."):]: v for k, v in pp.items() if k.startswith("encoder.")}
    with torch.no_grad():
        th = torch.func.functional_call(model.encoder, enc, (torch.from_numpy(x),))
        tl = torch.func.functional_call(model, pp, (torch.from_numpy(x),))
    return list(hidden) + [logits], list(th) + [tl], model


def _hold(ref, got, tol):
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        a = np.asarray(a.astype(jnp.float32))
        b = b.float().numpy()
        assert a.shape == b.shape, (i, a.shape, b.shape)
        # the logits are tanh outputs: held on the scale of their range, 1
        scale = max(np.abs(a).max(), 1.0 if i == len(ref) - 1 else 1e-8)
        np.testing.assert_allclose(b, a, rtol=0, atol=tol * scale, err_msg=f"output {i}")


@pytest.mark.parametrize("argv,shape,amp,tol", [
    (ATTN_ARGV, (2, 1, 32, 32, 1), False, 1e-4),
    (ATTN_ARGV, (2, 1, 32, 32, 1), True, 2e-2),
    (PAD_ARGV, (2, 1, 40, 40, 1), False, 1e-4)], ids=["w4", "w4_amp", "w8_pad"])
def test_swin_attention_model_matches_jax(argv, shape, amp, tol):
    """Hidden states (input, patch embed, two stages) and logits. fp32:
    1e-4 of max (sum order through two stages); bf16 AMP: 2e-2 of max (a
    bf16 ulp flipped by a different fp32 sum propagates). w4: 16x16 and 8x8
    token grids in 4x4 windows, odd blocks shifted by 2. w8_pad: 20x20 and
    10x10 grids padded to 24 and 16 for 8x8 windows (V = 64), shifted by 4."""
    ref, got, model = _forward_both(argv, shape, 21, amp)
    attn = model.encoder.layer_0.block_1.attn
    assert attn.mixer_name == "attention" and attn.qkv_bias_p is not None
    assert model.encoder.layer_0.block_1.shift_size[1:] == ((2, 2) if argv is ATTN_ARGV
                                                            else (4, 4))
    _hold(ref, got, tol)


@pytest.mark.parametrize("mixer", ["hyena", "mamba"])
def test_hyena_and_mamba_take_the_per_block_path_on_a_padded_grid(mixer):
    """Hyena and Mamba on a token grid the window does not divide (40x40,
    window 8: grids 20 and 10) take the per-block path with no shift, as
    JAX's do: norm1 as a flax LayerNorm, the normed tensor zero-padded, the
    mixer without its folded LN. Hidden states and logits within 1e-4 of
    max (fp32)."""
    ref, got, model = _forward_both(_swin_argv(40, 8, mixer), (2, 1, 40, 40, 1), 23)
    block = model.encoder.layer_0.block_1
    assert not block.windowed and block.shift_size == (0, 0, 0)
    assert block.attn.mixer_name == mixer and hasattr(block, "norm1")
    _hold(ref, got, 1e-4)


@pytest.mark.parametrize("argv,size", [(ATTN_ARGV, 32), (PAD_ARGV, 40)], ids=["w4", "w8_pad"])
def test_swin_attention_train_step_matches_jax(argv, size):
    """One fp32 train step of the tiny Swin-attention model (w4: window 4,
    both stages shifted; w8_pad: window 8 on grids padded to window
    multiples): the loss within 1e-5 (relative) and every parameter's
    gradient, the relative-position tables' included, within 1e-4 of its
    max|g| (fp32 sum order, forward and backward)."""
    jm, params = _jax_params(argv, (2, 1, size, size, 1), 25)
    rng = np.random.default_rng(26)
    x = rng.normal(size=(2, 1, size, size, 1)).astype(np.float32)
    y = np.array([0, 1], np.int32)
    state = create_train_state(jm, {"params": jax.tree.map(jnp.asarray, params)}, _keep_grads())
    step = jax.jit(jax_make_train_step(jm, jax_get_loss_func("CrossEntropy"), _keep_grads(),
                                       use_amp=False, return_output=False))
    new_state, jloss, _ = step(state, jnp.asarray(x), jnp.asarray(y), 0.0, jax.random.PRNGKey(0))
    jgrads = params_from_jax(jax.tree.map(np.asarray, flax.serialization.to_state_dict(
        new_state.opt_state)))

    cfg = check_args(parse_config(argv + ["--optim_type=sgd"]))
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    optim = OptimManager(cfg, num_train_samples=2)
    optim.build(model.parameters())
    stats = make_train_step(model, cross_entropy_loss, optim, use_amp=False)(
        [(torch.from_numpy(x), torch.from_numpy(y).long())], 0.0, 2)
    np.testing.assert_allclose(stats[0].item(), float(jloss), rtol=1e-5, atol=0)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    assert any(k.endswith("relative_position_bias_table") for k in grads)
    for k, g in grads.items():
        ref = jgrads[k].float().numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-8), err_msg=k)


def test_swin_attention_checkpointing_keeps_gradients():
    """--Swin.use_checkpoint on the per-block path: the block takes its
    region ids through torch.utils.checkpoint, and the loss and every
    gradient equal the plain run's (the recompute repeats the same ops)."""
    x = torch.from_numpy(np.random.default_rng(27).normal(size=(2, 1, 32, 32, 1))
                         .astype(np.float32))
    y = torch.tensor([0, 1])
    grads = []
    for flag in ("False", "True"):
        model = build_model(check_args(parse_config(ATTN_ARGV + ["--Swin.use_checkpoint", flag])))
        cross_entropy_loss(model(x), y).backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=0, atol=0)


def test_run_torch_trains_swin_attention_and_reruns_inference_only(tmp_path):
    """A tiny ptx_attn-style run (Swin with window attention, the CLI's
    default mixer): training with checkpoints, then --inference_only on the
    run reproduces its test metrics."""
    make_dataset(f"{tmp_path}/data", n=10, size=32)
    argv = [f"--log_dir={tmp_path}/logs", "--run_name=attn", f"--data_dir={tmp_path}/data",
            "--time=1", "--batch_size=2", "--no_in_channel=1", "--device=cpu",
            "--num_workers=2", "--prefetch_factor=2", "--loss_func=CrossEntropy",
            "--train_model=True", "--use_amp", "--optim_type=adam", "--optim.lr=1e-3",
            "--num_epochs=1", "--checkpoint_frequency=1", "--debug"] + ATTN_ARGV
    assert main(argv) == 0
    run_dir = f"{tmp_path}/logs/attn"
    assert os.path.exists(f"{run_dir}/models/model_best_checkpoint/state.pt")
    state = torch.load(f"{run_dir}/models/model_best_checkpoint/state.pt", weights_only=True)
    assert "encoder.layer_1.block_1.attn.relative_position_bias_table" in state["params"]
    assert main(["--inference_only=True", f"--inference_dir={run_dir}",
                 f"--inference_log_dir={tmp_path}/logs", "--inference_run_name=inf"]) == 0
    read = lambda p: open(p).read()  # noqa: E731
    assert read(f"{tmp_path}/logs/inf/test_metrics.txt") == read(f"{run_dir}/test_metrics.txt")
