"""PyTorch port, the Swin and ViT size presets whose widths are not
multiples of the kernels' tiles (head dims other than 32, channel counts
that are not multiples of 32, hidden widths that are not multiples of 64),
against the JAX package on the CPU.

* ``--Swin.size unetr`` (embed 48, heads 3/6/12/24: C = 48 at stage 0 and
  a head dim of 16 at every stage), 2D, patch 2, window 4 on 32x32, the
  preset's depths 2/2/2/2 (stage 3's 2x2 grid shrinks its window), with each
  mixer: attention (K8 at D = 16), Hyena (K1 at C = 48) and Mamba.
* ``--Swin.size custom --Swin.embed_dim 24`` with attention: C = 24 and 48,
  heads 3/6, so D = 8, and the MLP's hidden width 96 (K2 at C = 24, H = 96).
* ``--Swin.size custom`` with attention at head dims past 64: embed 96 and
  192 with heads 1/2 (D = 96 and 192 at both stages; K8's general path).
* ``--ViT.size custom`` at D = 48 (hidden 96, 2 heads) and D = 320 (hidden
  320, one head, one layer: past K5's widest padded head dim) on 128x128
  with patch 4: 1,024 patch tokens and the cls token, so every block's
  attention takes the flash route on both sides (JAX's Pallas kernel in
  interpret mode).

On the CPU every wrapper runs its kernel's plain version; the JAX side runs
its Pallas kernels in interpret mode where its gates send these widths to
them. Forward hidden states and logits, and one fp32 train step's loss and
every parameter's gradient, from one parameter draw converted to both. The
same models run on the card in ``chip_smoke.py`` (phase 47) and the widened
kernels against their plain versions in ``tests/test_torch_cuda.py``.

The weight layouts that K2, K1/K3 and K4's wrappers build for the kernels'
padded tiles, and the gradient cuts back from them, are checked here on the
CPU against the true blocks (the library's width query stood in for).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_biomedical_imaging_tpu.losses import get_loss_func as jax_get_loss_func
from long_context_biomedical_imaging_tpu.trainer.train_state import (
    create_train_state, make_train_step as jax_make_train_step)
from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
from long_context_biomedical_imaging_tpu_torch.models import build_model
from long_context_biomedical_imaging_tpu_torch.ops import attention as tattention
from long_context_biomedical_imaging_tpu_torch.optim import OptimManager
from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
from long_context_biomedical_imaging_tpu_torch.trainer import make_train_step
from long_context_biomedical_imaging_tpu_torch.utils.convert import params_from_jax
from test_torch_swin_attn import _forward_both, _hold, _jax_params
from test_torch_train import _keep_grads


def _swin_argv(size_flags, mixer):
    return (["--task_type=class", "--encoder_name=Swin", "--decoder_name=SwinLinear",
             "--height=32", "--width=32", "--no_out_channel=2", "--seed=3",
             "--Swin.patch_size", "2", "--Swin.window_size", "4",
             "--Swin.use_hyena", str(mixer == "hyena"), "--Swin.use_mamba", str(mixer == "mamba")]
            + size_flags)


UNETR = ["--Swin.size=unetr"]
CUSTOM_24 = ["--Swin.size=custom", "--Swin.embed_dim=24", "--Swin.depths", "2", "2",
             "--Swin.num_heads", "3", "6"]
# head dims past 64, as ``--Swin.size custom --Swin.embed_dim 96 --Swin.num_heads 1 2 4 8``
# gives at every stage (D = 96), and D = 192: one and two heads on two stages
CUSTOM_96 = ["--Swin.size=custom", "--Swin.embed_dim=96", "--Swin.depths", "2", "2",
             "--Swin.num_heads", "1", "2"]
CUSTOM_192 = ["--Swin.size=custom", "--Swin.embed_dim=192", "--Swin.depths", "2", "2",
              "--Swin.num_heads", "1", "2"]
# (argv, stage-0 channels, head dim) of each case
SWIN_CASES = {
    "unetr_attention": (_swin_argv(UNETR, "attention"), 48, 16),
    "unetr_hyena": (_swin_argv(UNETR, "hyena"), 48, 16),
    "unetr_mamba": (_swin_argv(UNETR, "mamba"), 48, 16),
    "custom24_attention": (_swin_argv(CUSTOM_24, "attention"), 24, 8),
    "custom96_attention": (_swin_argv(CUSTOM_96, "attention"), 96, 96),
    "custom192_attention": (_swin_argv(CUSTOM_192, "attention"), 192, 192),
}
VIT_D48 = ["--task_type=class", "--encoder_name=ViT", "--decoder_name=ViTLinear",
           "--height=128", "--width=128", "--no_in_channel=1", "--no_out_channel=2", "--seed=3",
           "--ViT.size=custom", "--ViT.hidden_size=96", "--ViT.mlp_dim=192",
           "--ViT.num_layers=2", "--ViT.num_heads=2", "--ViT.patch_size", "4"]
# D = 320, past the widest padded head dim of K5's tiles (256): one head, one layer
VIT_D320 = ["--task_type=class", "--encoder_name=ViT", "--decoder_name=ViTLinear",
            "--height=128", "--width=128", "--no_in_channel=1", "--no_out_channel=2", "--seed=3",
            "--ViT.size=custom", "--ViT.hidden_size=320", "--ViT.mlp_dim=320",
            "--ViT.num_layers=1", "--ViT.num_heads=1", "--ViT.patch_size", "4"]


@pytest.mark.parametrize("case", list(SWIN_CASES))
def test_swin_width_forward_matches_jax(case):
    """Hidden states (input, patch embed, every stage) and SwinLinear logits
    within 1e-4 of max (fp32 sum order through the stages), at the case's
    stage-0 width and head dim."""
    argv, c0, d = SWIN_CASES[case]
    ref, got, model = _forward_both(argv, (2, 1, 32, 32, 1), 41)
    block = model.encoder.layer_0.block_0
    assert block.attn.mixer_name == case.split("_")[1]
    assert block.attn.dim == c0 and c0 // block.attn.num_heads == d
    _hold(ref, got, 1e-4)


@pytest.mark.parametrize("case", list(SWIN_CASES))
def test_swin_width_train_step_matches_jax(case):
    """One fp32 train step (cross-entropy, SGD) from the same weights and
    batch: the loss within 1e-5 (relative) and every parameter's gradient
    within 1e-4 of its max|g| (fp32 sum order, forward and backward)."""
    argv = SWIN_CASES[case][0]
    jm, params = _jax_params(argv, (2, 1, 32, 32, 1), 43)
    rng = np.random.default_rng(44)
    x = rng.normal(size=(2, 1, 32, 32, 1)).astype(np.float32)
    y = np.array([1, 0], np.int32)
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
    for k, g in grads.items():
        ref = jgrads[k].float().numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-8), err_msg=k)


def test_vit_head_dim_48_takes_the_flash_route(monkeypatch):
    """A custom ViT at D = 48 on 1,025 tokens: every block's attention takes
    the flash route on both sides (the port's K5 wrapper, whose kernels run
    D = 48 on 64-wide tiles; JAX's Pallas kernel in interpret mode). Hidden
    states and logits within 1e-4 of max (fp32)."""
    _vit_flash_route(monkeypatch, VIT_D48, [(1, 2, 1025, 48)] * 4, 45)


def test_vit_head_dim_320_takes_the_flash_route(monkeypatch):
    """A custom ViT at D = 320 (hidden 320, one head, one layer) on 1,025
    tokens: the attention takes the flash route on both sides (the port's K5
    wrapper, whose kernels walk D in 64-column chunks past 256; JAX's Pallas
    kernel in interpret mode, which has no head-dim limit). Hidden states and
    logits within 1e-4 of max (fp32)."""
    _vit_flash_route(monkeypatch, VIT_D320, [(1, 1, 1025, 320)] * 2, 47)


def _vit_flash_route(monkeypatch, argv, expected_calls, seed):
    jm, params = _jax_params(argv, (1, 1, 128, 128, 1), seed)
    x = np.random.default_rng(seed + 1).normal(size=(1, 1, 128, 128, 1)).astype(np.float32)
    ref_h = jm.encoder.apply({"params": params["encoder"]}, jnp.asarray(x))
    ref = jm.apply({"params": params}, jnp.asarray(x), deterministic=True)
    calls = []
    real = tattention.flash_attention
    monkeypatch.setattr(tattention, "flash_attention",
                        lambda *a, **kw: calls.append(tuple(a[0].shape)) or real(*a, **kw))
    model = build_model(check_args(parse_config(argv)))
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got_h = model.encoder(torch.from_numpy(x))
        out = model(torch.from_numpy(x))
    assert calls == expected_calls
    assert len(got_h) == len(ref_h)
    for i, (a, b) in enumerate(zip(got_h, ref_h)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=f"h{i}")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4 * max(np.abs(np.asarray(ref)).max(), 1.0))


# --------------------------------------------------------------------------- #
# The kernels take their weights at their true widths (no padded copy): the
# backwards' gradients come out of their weight-gradient products and the
# small gradients' reduced slot as they are (built on the CPU; the kernels
# write them on the card)
# --------------------------------------------------------------------------- #

def _slots(named):
    """(reduced slot holding each (name, tensor) flat, its layout)."""
    from long_context_biomedical_imaging_tpu_torch.ops.cuda_build import slot_layout

    layout, size = slot_layout([(n, t.numel()) for n, t in named])
    red = torch.full((size,), float("nan"))
    for n, t in named:
        red[layout[n]:layout[n] + t.numel()] = t.reshape(-1)
    return red, layout


@pytest.mark.parametrize("c, hidden", [(24, 96), (48, 192), (64, 256)])
def test_mlp_weight_layout_round_trips(c, hidden):
    """K2's kernels take the weights at their true widths (no padded copy):
    the backward's gradients come out of [dw1 | dw2] and the small
    gradients' reduced slot as they are."""
    from long_context_biomedical_imaging_tpu_torch.ops import fused_mlp

    g = torch.Generator().manual_seed(c)
    w1, b1, w2, b2 = (torch.randn(s, generator=g) for s in ((c, hidden), (hidden,),
                                                            (hidden, c), (c,)))
    assert not hasattr(fused_mlp, "_padded_weights")
    red, layout = _slots([("db1", b1), ("db2", b2)])
    scratch = {"red": red, "layout": layout, "wgrads": torch.cat([w1.reshape(-1), w2.reshape(-1)])}
    for got, want in zip(fused_mlp._bwd_grads(scratch, c, hidden), (w1, b1, w2, b2)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("c", [24, 48, 64])
def test_hyena_operand_layout_round_trips(c):
    """K1's and K3's kernels take their weights, taps, biases and Toeplitz
    blocks at the true C: no padding helper is left, and K3's backward
    gradients come out of [dw_in | dw_out] and the small gradients' reduced
    slot as they are."""
    from long_context_biomedical_imaging_tpu_torch.ops import cuda_build, hyena_window

    k = 5
    g = torch.Generator().manual_seed(c)
    w_in, b_in, ws, bs, w_out, b_out = (torch.randn(s, generator=g) for s in (
        (c, 3 * c), (3 * c,), (k, 3 * c), (3 * c,), (c, c), (c,)))
    assert not hasattr(hyena_window, "_padded_operands")
    assert not any(hasattr(cuda_build, n) for n in ("padded_width", "pad_channel_blocks",
                                                    "pad_blocks"))
    red, layout = _slots([("dws", ws), ("dbin", b_in), ("dbs", bs), ("dbo", b_out)])
    wgrads = torch.cat([w_in.reshape(-1), w_out.reshape(-1)])
    got = hyena_window._chunked_bwd_grads(red, layout, wgrads, c, k, torch.float32, False)
    for a, b in zip(got, (w_in, b_in, ws, bs, w_out, b_out)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("c", [24, 48, 64])
def test_mamba_operand_layout_round_trips(c):
    """K4's kernels take every operand at the true C and d_state: no padding
    helper is left, and the backward's gradients come out of [dw_xz | dw_out
    | dw_dt | dw_dbl] (in the weights' dtype) and the small gradients'
    reduced slot (with the LN parameters') as they are, at a d_state that is
    no padded state count."""
    from long_context_biomedical_imaging_tpu_torch.ops import mamba_window

    dh, r, n = c // 2, -(-c // 16), 5
    g = torch.Generator().manual_seed(c)
    shapes = {"w_xz": (c, c), "wconv": (3, c), "w_dbl": (dh, r + 2 * n), "w_dt": (r, dh),
              "dtb2": (dh,), "at": (n, dh), "dskip": (dh,), "w_out": (c, c), "dg": (c,),
              "dbln": (c,)}
    ops = {name: torch.randn(s, generator=g) for name, s in shapes.items()}
    assert not any(hasattr(mamba_window, h) for h in ("_padded_operands", "_padded_states"))
    red, layout = _slots([("dwconv", ops["wconv"]), ("ddtb", ops["dtb2"]), ("dat", ops["at"]),
                          ("dd", ops["dskip"]), ("dg", ops["dg"]), ("dbln", ops["dbln"])])
    wgrads = torch.cat([ops[k].reshape(-1) for k in ("w_xz", "w_out", "w_dt", "w_dbl")])
    got = mamba_window._bwd_grads(red, layout, wgrads, c, r, n, torch.bfloat16, True)
    assert len(got) == len(shapes)
    for name, t in zip(shapes, got):
        dtype = torch.bfloat16 if name in ("w_xz", "w_dbl", "w_dt", "w_out") else torch.float32
        assert t.dtype == dtype and torch.equal(t, ops[name].to(dtype)), name