"""Swin backbone with a swappable window mixer: attention, Hyena or Mamba.

Counterpart of the JAX package's ``models/swin.py`` (ref:
model/models/backbone_swin.py:44-911). Layout is channels-last
(B, D, H, W, C); 2D models keep D == 1 with depth factors 1.

Contract kept from the JAX package:
  * 4 stages of blocks, each followed by PatchMergingV2 (2x down, 2x channels:
    (2,2,2) neighbourhoods in 3D);
  * the window shrinks to the token grid where the grid is smaller
    (``get_window_size``), and the shift along that dim goes to 0;
  * the mixer is window attention by default, Hyena (``--Swin.use_hyena``)
    or Mamba (``--Swin.use_mamba``; setup refuses both at once);
  * window attention (``WindowAttention``): the relative-position bias
    table (trunc_normal(0.02), gathered by ``relative_position_index``),
    the fused qkv and out projections (``ops.windowed_attention_proj``, K8),
    cyclic shifts of window // 2 on odd blocks with the region ids of
    ``compute_shift_regions`` as the mask;
  * per-block path (attention, and Hyena or Mamba on a grid the window does
    not divide): x + reverse(mixer(partition(roll(pad(norm1(x)))))), with
    ``norm1`` a flax LayerNorm and the normed tensor zero-padded to window
    multiples, then x + MLP(LN(x)) in K2 on the flattened tokens;
  * stage-level windowed path (Hyena or Mamba on a grid the window divides;
    no shift): the stage partitions once, runs all its blocks on (B*nW, V, C)
    windows with the pre-LN and residual folded into the mixer, and
    reverses once. Hyena routes as the JAX package's ``models/hyena.py`` (K1
    up to 64 tokens, K3 up to 512 at C <= 192, the composed path otherwise),
    Mamba as ``models/mamba.py`` (K4 for 16 to 64 tokens in calls of at least
    1024 windows, the composed path otherwise);
  * returns [input, x0_out..x4_out], each but the input through a
    parameterless LayerNorm;
  * ``--Swin.use_checkpoint`` recomputes each block's activations in the
    backward (``torch.utils.checkpoint``), as the JAX package remats each
    block: the same gradients, less memory, and a second launch of each
    forward kernel per block in a train step.

Which path a stage takes, and the size of an attention block's bias table,
depend on the stage's token grid, which the JAX package reads from its input
while it creates the parameters. The port creates them before any input:
``SwinBackbone`` takes the input's spatial size ``img_size`` and derives each
stage's grid. A stage raises ValueError on an input whose grid takes another
path or another table than it was built for.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.window import (compute_shift_regions, get_window_size, pad_to_window_multiple,
                          relative_position_index, window_partition, window_reverse)
from ..ops.window_attention import windowed_attention_proj
from .hyena import HyenaOperator
from .layers import (FlaxLayerNorm, LayerNormAmp, LNMLPResidual, PatchEmbed, TorchDense,
                     parameterless_layer_norm, trunc_normal_init_, uniform_fan_in_)
from .mamba import MambaVisionMixer

HYENA_L_MAX = 66000  # ref: backbone_swin.py:317


class _TableGather(torch.autograd.Function):
    """rel = table[index] for a flat index: an exact gather forward; the
    backward sums each table row's cotangents in fp32 over its positions,
    listed in ``positions`` (T, n) in ascending order and padded with V*V, a
    zero row: a gather and a sum over a fixed axis, the same from run to run
    (the scatter-add of ``index_select``'s backward uses atomics on CUDA)."""

    @staticmethod
    def forward(ctx, table, index, positions):
        ctx.save_for_backward(positions)
        ctx.dtype = table.dtype
        return table[index]

    @staticmethod
    def backward(ctx, grad):
        (positions,) = ctx.saved_tensors
        padded = torch.cat([grad.float(), grad.new_zeros(1, grad.shape[1], dtype=torch.float32)])
        return padded[positions].sum(dim=1).to(ctx.dtype), None, None


def table_positions(index: np.ndarray, rows: int) -> np.ndarray:
    """(rows, n) int64: the positions of each table row in the flat index, in
    ascending order, padded with len(index); n the most any row has."""
    order = np.argsort(index, kind="stable")
    counts = np.bincount(index, minlength=rows)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    positions = np.full((rows, max(int(counts.max()), 1)), index.size, np.int64)
    rank = np.arange(index.size) - starts[index[order]]
    positions[index[order], rank] = order
    return positions


class WindowAttention(nn.Module):
    """The window mixer of a block on (B*nW, V, C) windows: Hyena or Mamba as
    the submodule ``hyena`` or ``mamba`` (the JAX scope names), else window
    attention with the JAX package's parameters ``relative_position_bias_table``
    ((2wd-1)(2wh-1)(2ww-1), H), ``qkv_kernel`` (C, 3C), ``qkv_bias_p`` (3C,;
    the JAX module's ``qkv_bias``, which every model leaves True),
    ``proj_kernel`` (C, C) and ``proj_bias`` (C,), for the (shrunk)
    ``window_size``."""

    def __init__(self, dim: int, num_heads: int, use_hyena: bool = False,
                 use_mamba: bool = False, window_size: Sequence[int] | None = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        if use_hyena:
            self.hyena = HyenaOperator(d_model=dim, l_max=HYENA_L_MAX, filter_order=64,
                                       num_heads=num_heads, short_filter_order=5)
            self.mixer_name = "hyena"
            return
        if use_mamba:
            self.mamba = MambaVisionMixer(d_model=dim, d_state=8, d_conv=3, expand=1)
            self.mixer_name = "mamba"
            return
        if window_size is None:
            raise ValueError("window attention needs the window size")
        self.mixer_name = "attention"
        self.window_size = tuple(window_size)
        wd, wh, ww = self.window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        self.qkv_kernel = nn.Parameter(torch.empty(dim, 3 * dim))
        self.qkv_bias_p = nn.Parameter(torch.empty(3 * dim))
        self.proj_kernel = nn.Parameter(torch.empty(dim, dim))
        self.proj_bias = nn.Parameter(torch.empty(dim))
        index = relative_position_index(self.window_size).reshape(-1).long()
        self._index = index
        self._positions = torch.from_numpy(table_positions(
            index.numpy(), self.relative_position_bias_table.shape[0]))
        self._on_device = {}

    def init_params(self, gen):
        """The JAX initialisers: trunc_normal(0.02) for the table, torch
        Linear's U(+-1/sqrt(C)) for the projections and their biases."""
        if self.mixer_name != "attention":
            return
        trunc_normal_init_(self.relative_position_bias_table, 0.02, gen)
        uniform_fan_in_(self.qkv_kernel, self.dim, gen)
        uniform_fan_in_(self.qkv_bias_p, self.dim, gen)
        uniform_fan_in_(self.proj_kernel, self.dim, gen)
        uniform_fan_in_(self.proj_bias, self.dim, gen)

    def relative_bias(self):
        """(H, V, V) relative-position bias in the table's dtype."""
        table = self.relative_position_bias_table
        key = str(table.device)
        if key not in self._on_device:
            self._on_device[key] = (self._index.to(table.device),
                                    self._positions.to(table.device))
        index, positions = self._on_device[key]
        v = int(np.prod(self.window_size))
        rel = _TableGather.apply(table, index, positions)
        return rel.reshape(v, v, self.num_heads).permute(2, 0, 1)

    def forward(self, x, rid=None, ln_params=None):
        """x: (B*nW, V, C). Hyena or Mamba: x + mixer(LN(x)) with ln_params =
        (scale, bias) of the caller's pre-LN, mixer(x) without. Attention
        (no ln_params): with rid, (nW, V) region ids of the shifted windows."""
        if self.mixer_name != "attention":
            return getattr(self, self.mixer_name)(x, ln_params=ln_params)
        assert ln_params is None, "the pre-LN folds into the Hyena and Mamba mixers only"
        v = int(np.prod(self.window_size))
        if x.shape[1] != v:
            raise ValueError(f"windows of {x.shape[1]} tokens, but this block's bias table is "
                             f"for the window {self.window_size}: build the model for the "
                             "input's size (SwinBackbone img_size)")
        return windowed_attention_proj(x, self.qkv_kernel, self.qkv_bias_p, self.proj_kernel,
                                       self.proj_bias, self.relative_bias(), self.num_heads,
                                       rid=rid)


class PatchMergingV2(nn.Module):
    """2x downsample, channels x2 (ref: backbone_swin.py:540-585): (2,2,2)
    neighbourhoods in 3D, (1,2,2) in 2D, concatenated i-major then j, k."""

    def __init__(self, dim: int, spatial_dims: int = 3):
        super().__init__()
        self.md = 2 if spatial_dims == 3 else 1
        self.norm = LayerNormAmp(self.md * 4 * dim)
        self.reduction = TorchDense(self.md * 4 * dim, 2 * dim, use_bias=False)

    def forward(self, x):
        b, d, h, w, c = x.shape
        md = self.md
        pad_d, pad_h, pad_w = d % md, h % 2, w % 2
        if pad_d or pad_h or pad_w:
            x = nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h, 0, pad_d))
        dp, hp, wp = d + pad_d, h + pad_h, w + pad_w
        x = x.reshape(b, dp // md, md, hp // 2, 2, wp // 2, 2, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
        x = x.reshape(b, dp // md, hp // 2, wp // 2, md * 4 * c)
        return self.reduction(self.norm(x))


class SwinTransformerBlock(nn.Module):
    """One Swin block (ref: backbone_swin.py:370-537). With ``windowed``, on
    a stage's (B*nW, V, C) windows: x + Mixer(LN1(x)) with the pre-LN
    (``norm1_scale``, ``norm1_bias``) folded into the Hyena or Mamba mixer,
    then x + MLP(LN2(x)). Otherwise on the (B, D, H, W, C) grid, the
    per-block path (module doc), shifted by ``shift_size`` (before the
    window shrink) with the stage's region ids. ``attn_window`` is the
    window, shrunk to the stage's grid, that sizes the attention's bias
    table."""

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int],
                 shift_size: Sequence[int], attn_window: Sequence[int], mlp_ratio: float = 4.0,
                 use_hyena: bool = False, use_mamba: bool = False, windowed: bool = False):
        super().__init__()
        self.window_size, self.shift_size = tuple(window_size), tuple(shift_size)
        self.windowed = windowed
        if windowed:
            self.norm1_scale = nn.Parameter(torch.empty(dim))
            self.norm1_bias = nn.Parameter(torch.empty(dim))
        else:
            self.norm1 = FlaxLayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, use_hyena, use_mamba, attn_window)
        self.mlp = LNMLPResidual(dim, int(dim * mlp_ratio))

    def init_params(self, gen):
        if self.windowed:
            nn.init.ones_(self.norm1_scale)
            nn.init.zeros_(self.norm1_bias)

    def forward(self, x, rid=None):
        if self.windowed:
            bw, v, c = x.shape
            x = self.attn(x, ln_params=(self.norm1_scale, self.norm1_bias))
            return self.mlp(x.reshape(-1, c)).reshape(bw, v, c)
        b, d, h, w, c = x.shape
        window, shift = get_window_size((d, h, w), self.window_size, self.shift_size)
        y, (dp, hp, wp) = pad_to_window_multiple(self.norm1(x), window)
        shifted = any(s > 0 for s in shift)
        if shifted:
            y = torch.roll(y, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
        y = self.attn(window_partition(y, window), rid if shifted else None)
        y = window_reverse(y, window, (b, dp, hp, wp))
        if shifted:
            y = torch.roll(y, shifts=shift, dims=(1, 2, 3))
        x = x + y[:, :d, :h, :w]
        return self.mlp(x.reshape(-1, c)).reshape(b, d, h, w, c)


def run_checkpointed(block: nn.Module, x, *args):
    """block(x, *args) with its activations recomputed in the backward
    (non-reentrant ``torch.utils.checkpoint``). The block's parameters enter
    as explicit inputs, so the recompute runs on the tensors the forward ran
    on (under ``functional_call`` the AMP casts, not the module's own fp32
    parameters) and their gradients flow through them."""
    names, tensors = zip(*block.named_parameters())
    n = len(args)

    def run(inp, *rest):
        return torch.func.functional_call(block, dict(zip(names, rest[n:])),
                                          (inp, *rest[:n]))

    return checkpoint(run, x, *args, *tensors, use_reentrant=False)


class BasicLayer(nn.Module):
    """One stage: ``depth`` blocks, then PatchMergingV2 (ref:
    backbone_swin.py:630-733). ``grid`` is the stage's (D, H, W) token grid:
    Hyena and Mamba on a grid the window divides take the stage-level
    windowed path, everything else the per-block path, shifted by
    window // 2 on odd attention blocks.
    With ``use_checkpoint`` each block runs through :func:`run_checkpointed`
    while gradients are recorded."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: Sequence[int],
                 grid: Sequence[int], spatial_dims: int = 3, mlp_ratio: float = 4.0,
                 use_hyena: bool = False, use_mamba: bool = False,
                 use_checkpoint: bool = False):
        super().__init__()
        self.window_size = tuple(window_size)
        self.depth = depth
        self.use_checkpoint = use_checkpoint
        mixer = use_hyena or use_mamba
        self.base_shift = (0, 0, 0) if mixer else tuple(s // 2 for s in self.window_size)
        attn_window = get_window_size(tuple(grid), self.window_size)
        self.windowed = mixer and all(g % ws == 0 for g, ws in zip(grid, attn_window))
        for i in range(depth):
            shift = (0, 0, 0) if self.windowed or i % 2 == 0 else self.base_shift
            self.add_module(f"block_{i}", SwinTransformerBlock(
                dim, num_heads, self.window_size, shift, attn_window, mlp_ratio, use_hyena,
                use_mamba, self.windowed))
        self.downsample = PatchMergingV2(dim, spatial_dims)
        self._regions = {}

    def regions(self, dims, window, shift, device):
        """(nW, V) int32 region ids of the shifted windows on the padded grid
        ``dims``, kept per grid and device."""
        key = (dims, window, shift, str(device))
        if key not in self._regions:
            self._regions[key] = compute_shift_regions(dims, window, shift).to(device)
        return self._regions[key]

    def forward(self, x):
        b, d, h, w, _ = x.shape
        remat = self.use_checkpoint and torch.is_grad_enabled()
        blocks = [getattr(self, f"block_{i}") for i in range(self.depth)]
        if self.windowed:
            window = get_window_size((d, h, w), self.window_size)
            if any(s % ws for s, ws in zip((d, h, w), window)):
                raise ValueError(f"token grid {(d, h, w)} is not a multiple of the window "
                                 f"{window}, but this stage was built for one that is: build "
                                 "the model for the input's size (SwinBackbone img_size)")
            xw = window_partition(x, window)
            for block in blocks:
                xw = run_checkpointed(block, xw) if remat else block(xw)
            return self.downsample(window_reverse(xw, window, (b, d, h, w)))
        window, shift = get_window_size((d, h, w), self.window_size, self.base_shift)
        rid = None
        if any(s > 0 for s in shift):
            dims = tuple(-(-n // ws) * ws for n, ws in zip((d, h, w), window))
            rid = self.regions(dims, window, shift, x.device)
        for block in blocks:
            x = run_checkpointed(block, x, rid) if remat else block(x, rid)
        return self.downsample(x)


def stage_grids(grid: Sequence[int], num_stages: int, spatial_dims: int) -> list[tuple]:
    """The (D, H, W) token grid of each stage from the patch grid: each
    PatchMergingV2 halves H and W (and D in 3D), rounding up."""
    md = 2 if spatial_dims == 3 else 1
    grids = [tuple(grid)]
    for _ in range(num_stages - 1):
        d, h, w = grids[-1]
        grids.append((-(-d // md), -(-h // 2), -(-w // 2)))
    return grids


class SwinBackbone(nn.Module):
    """Swin encoder returning [input, x0_out..x4_out]
    (ref: backbone_swin.py:735-911). x: (B, T, H, W, C). ``img_size``: the
    input's (H, W) in 2D or (T, H, W) in 3D, from which each stage's grid
    follows."""

    def __init__(self, patch_size: Sequence[int], window_size: Sequence[int],
                 in_channels: int, img_size: Sequence[int], embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), mlp_ratio: float = 4.0,
                 use_hyena: bool = False, use_mamba: bool = False,
                 embed_dtype: torch.dtype | None = None, use_checkpoint: bool = False):
        super().__init__()
        spatial_dims = 2 if len(patch_size) == 2 else 3
        patch = ((1,) + tuple(patch_size)) if spatial_dims == 2 else tuple(patch_size)
        window = ((1,) + tuple(window_size)) if spatial_dims == 2 else tuple(window_size)
        self.num_layers = len(depths)
        self.patch_embed = PatchEmbed(patch, in_channels, embed_dim, dtype=embed_dtype)
        full = ((1,) + tuple(img_size)) if spatial_dims == 2 else tuple(img_size)
        grids = stage_grids([n // p for n, p in zip(full, patch)], self.num_layers, spatial_dims)
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            self.add_module(f"layer_{i}", BasicLayer(
                int(embed_dim * 2 ** i), depth, heads, window, grids[i], spatial_dims,
                mlp_ratio, use_hyena, use_mamba, use_checkpoint))

    def forward(self, x):
        hidden_states = [x]
        x = self.patch_embed(x)
        hidden_states.append(parameterless_layer_norm(x))
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
            hidden_states.append(parameterless_layer_norm(x))
        return hidden_states


def swin_size_presets(size: str, cfg=None):
    """Size presets (ref: backbone_swin.py:56-102)."""
    presets = {
        "unetr": dict(embed_dim=48, depths=[2, 2, 2, 2], num_heads=[3, 6, 12, 24]),
        "tiny": dict(embed_dim=96, depths=[2, 2, 6, 2], num_heads=[3, 6, 12, 24]),
        "small": dict(embed_dim=96, depths=[2, 2, 18, 2], num_heads=[3, 6, 12, 24]),
        "base": dict(embed_dim=128, depths=[2, 2, 18, 2], num_heads=[4, 8, 16, 32]),
        "large": dict(embed_dim=192, depths=[2, 2, 18, 2], num_heads=[6, 12, 24, 48]),
    }
    if size in presets:
        return presets[size]
    if size == "custom":
        return dict(embed_dim=cfg.embed_dim, depths=list(cfg.depths),
                    num_heads=list(cfg.num_heads))
    raise ValueError(f"Unknown Swin size {size}")


def build_swin(config, input_feature_channels: int):
    """Config -> (module, output feature channels) (ref: backbone_swin.py:44-131),
    for inputs of the config's size: (height, width), or (time, height, width)
    in 3D."""
    preset = swin_size_presets(config.Swin.size, config.Swin)
    config.Swin.embed_dim = preset["embed_dim"]
    config.Swin.depths = list(preset["depths"])
    config.Swin.num_heads = list(preset["num_heads"])

    patch = config.Swin.patch_size
    window = config.Swin.window_size
    if config.time == 1:
        patch = patch[1:] if len(patch) == 3 else patch
        window = window[1:] if len(window) == 3 else window

    model = SwinBackbone(
        patch_size=tuple(patch), window_size=tuple(window),
        in_channels=input_feature_channels,
        img_size=((config.height, config.width) if config.time == 1
                  else (config.time, config.height, config.width)),
        embed_dim=preset["embed_dim"],
        depths=tuple(preset["depths"]), num_heads=tuple(preset["num_heads"]),
        use_hyena=bool(config.Swin.use_hyena), use_mamba=bool(config.Swin.use_mamba),
        embed_dtype=torch.bfloat16 if config.get("use_amp") else None,
        use_checkpoint=bool(config.Swin.get("use_checkpoint", False)))

    e, nl = preset["embed_dim"], len(preset["depths"])
    out_channels = [e * 2 ** (nl - i) for i in range(nl, 0, -1)] + [e * 2 ** nl]
    return model, out_channels
