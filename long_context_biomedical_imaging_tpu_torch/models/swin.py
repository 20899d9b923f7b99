"""Swin backbone with the Hyena or Mamba window mixer, stage-level windowed layout.

Counterpart of the JAX package's ``models/swin.py`` for Hyena Swin models
(ref: model/models/backbone_swin.py:44-911). Layout is channels-last
(B, D, H, W, C); 2D models keep D == 1 with depth factors 1.

Contract kept from the JAX package:
  * 4 stages of blocks, each followed by PatchMergingV2 (2x down, 2x channels:
    (2,2,2) neighbourhoods in 3D);
  * the window shrinks to the token grid where the grid is smaller
    (``get_window_size``); Hyena runs per window with no shift, so a stage
    partitions once, runs all its blocks on (B*nW, V, C) windows, and
    reverses once;
  * each block is x + Mixer(LN(x)) and x + MLP(LN(x)) with the pre-LN and
    residual folded in; the mixer is Hyena (``--Swin.use_hyena``) or Mamba
    (``--Swin.use_mamba``; setup refuses both at once), each routed as
    the JAX package routes it (``models/hyena.py``: K1 up to 64 tokens, K3 up
    to 512 tokens at C <= 192, the composed path otherwise;
    ``models/mamba.py``: K4 for 16 to 64 tokens in calls of at least 1024
    windows, the composed path otherwise);
  * returns [input, x0_out..x4_out], each but the input through a
    parameterless LayerNorm;
  * ``--Swin.use_checkpoint`` recomputes each block's activations in the
    backward (``torch.utils.checkpoint``), as the JAX package remats each
    block: the same gradients, less memory, and a second launch of each
    forward kernel per block in a train step.

Not ported here: window attention (its slice raises at setup), and the
per-block path the JAX package takes when windows do not divide the token
grid (raises NotImplementedError).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.window import get_window_size, window_partition, window_reverse
from .hyena import HyenaOperator
from .layers import (LayerNormAmp, LNMLPResidual, PatchEmbed, TorchDense,
                     parameterless_layer_norm)
from .mamba import MambaVisionMixer

HYENA_L_MAX = 66000  # ref: backbone_swin.py:317


class WindowAttention(nn.Module):
    """Holds the window mixer, as ``hyena`` or ``mamba`` (the JAX scope
    names); window attention is not ported."""

    def __init__(self, dim: int, num_heads: int, use_hyena: bool = True,
                 use_mamba: bool = False):
        super().__init__()
        if use_hyena:
            self.hyena = HyenaOperator(d_model=dim, l_max=HYENA_L_MAX, filter_order=64,
                                       num_heads=num_heads, short_filter_order=5)
        elif use_mamba:
            self.mamba = MambaVisionMixer(d_model=dim, d_state=8, d_conv=3, expand=1)
        else:
            raise NotImplementedError("Swin window attention is not ported")
        self.mixer_name = "hyena" if use_hyena else "mamba"

    def forward(self, x, ln_params):
        return getattr(self, self.mixer_name)(x, ln_params=ln_params)


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
    """One Swin block on windowed tokens (B*nW, V, C): x + Mixer(LN1(x)),
    then x + MLP(LN2(x)) (ref: backbone_swin.py:370-537)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 use_hyena: bool = True, use_mamba: bool = False):
        super().__init__()
        self.norm1_scale = nn.Parameter(torch.empty(dim))
        self.norm1_bias = nn.Parameter(torch.empty(dim))
        self.attn = WindowAttention(dim, num_heads, use_hyena, use_mamba)
        self.mlp = LNMLPResidual(dim, int(dim * mlp_ratio))

    def init_params(self, gen):
        nn.init.ones_(self.norm1_scale)
        nn.init.zeros_(self.norm1_bias)

    def forward(self, x):
        bw, v, c = x.shape
        x = self.attn(x, ln_params=(self.norm1_scale, self.norm1_bias))
        return self.mlp(x.reshape(-1, c)).reshape(bw, v, c)


def run_checkpointed(block: nn.Module, x):
    """block(x) with its activations recomputed in the backward
    (non-reentrant ``torch.utils.checkpoint``). The block's parameters enter
    as explicit inputs, so the recompute runs on the tensors the forward ran
    on (under ``functional_call`` the AMP casts, not the module's own fp32
    parameters) and their gradients flow through them."""
    names, tensors = zip(*block.named_parameters())

    def run(inp, *params):
        return torch.func.functional_call(block, dict(zip(names, params)), (inp,))

    return checkpoint(run, x, *tensors, use_reentrant=False)


class BasicLayer(nn.Module):
    """One stage: ``depth`` blocks on a once-partitioned window layout, then
    PatchMergingV2 (ref: backbone_swin.py:630-733). With ``use_checkpoint``
    each block runs through :func:`run_checkpointed` while gradients are
    recorded."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: Sequence[int],
                 spatial_dims: int = 3, mlp_ratio: float = 4.0, use_hyena: bool = True,
                 use_mamba: bool = False, use_checkpoint: bool = False):
        super().__init__()
        self.window_size = tuple(window_size)
        self.depth = depth
        self.use_checkpoint = use_checkpoint
        for i in range(depth):
            self.add_module(f"block_{i}", SwinTransformerBlock(dim, num_heads, mlp_ratio,
                                                               use_hyena, use_mamba))
        self.downsample = PatchMergingV2(dim, spatial_dims)

    def forward(self, x):
        b, d, h, w, _ = x.shape
        window = get_window_size((d, h, w), self.window_size)
        if any(s % ws for s, ws in zip((d, h, w), window)):
            raise NotImplementedError(
                f"token grid {(d, h, w)} is not a multiple of the window {window}: "
                "the per-block padded mixer path is not ported")
        xw = window_partition(x, window)
        remat = self.use_checkpoint and torch.is_grad_enabled()
        for i in range(self.depth):
            block = getattr(self, f"block_{i}")
            xw = run_checkpointed(block, xw) if remat else block(xw)
        return self.downsample(window_reverse(xw, window, (b, d, h, w)))


class SwinBackbone(nn.Module):
    """Swin encoder returning [input, x0_out..x4_out]
    (ref: backbone_swin.py:735-911). x: (B, T, H, W, C)."""

    def __init__(self, patch_size: Sequence[int], window_size: Sequence[int],
                 in_channels: int, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), mlp_ratio: float = 4.0,
                 use_hyena: bool = True, use_mamba: bool = False,
                 embed_dtype: torch.dtype | None = None, use_checkpoint: bool = False):
        super().__init__()
        spatial_dims = 2 if len(patch_size) == 2 else 3
        patch = ((1,) + tuple(patch_size)) if spatial_dims == 2 else tuple(patch_size)
        window = ((1,) + tuple(window_size)) if spatial_dims == 2 else tuple(window_size)
        self.num_layers = len(depths)
        self.patch_embed = PatchEmbed(patch, in_channels, embed_dim, dtype=embed_dtype)
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            self.add_module(f"layer_{i}", BasicLayer(int(embed_dim * 2 ** i), depth, heads,
                                                     window, spatial_dims, mlp_ratio,
                                                     use_hyena, use_mamba, use_checkpoint))

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
    """Config -> (module, output feature channels) (ref: backbone_swin.py:44-131).
    The Hyena and Mamba mixers are ported (``model_base.check_ported``)."""
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
        in_channels=input_feature_channels, embed_dim=preset["embed_dim"],
        depths=tuple(preset["depths"]), num_heads=tuple(preset["num_heads"]),
        use_hyena=bool(config.Swin.use_hyena), use_mamba=bool(config.Swin.use_mamba),
        embed_dtype=torch.bfloat16 if config.get("use_amp") else None,
        use_checkpoint=bool(config.Swin.get("use_checkpoint", False)))

    e, nl = preset["embed_dim"], len(preset["depths"])
    out_channels = [e * 2 ** (nl - i) for i in range(nl, 0, -1)] + [e * 2 ** nl]
    return model, out_channels
