"""ViT backbone with a full-sequence token mixer: softmax attention, Hyena or
Mamba.

Counterpart of the JAX package's ``models/vit.py`` (ref:
model/models/backbone_vit.py:45-397): channels-last input (B, T, H, W, C),
pre-LN blocks x += Mixer(LN(x)); x += MLP(LN(x)), the second half in K2
(``LNMLPResidual``) on (B*L, C) rows. The attention goes through
``ops.multi_head_attention`` (K5 from 1024 tokens); the Hyena mixer is the
``HyenaOperator`` over the whole sequence, whose long convolution takes K6
(``ops.spectral_conv``) at 8192 <= L <= 131072 with L a power of two; the
Mamba mixer is the ``MambaVisionMixer`` (d_state 8, 3-tap conv, expand 1)
over the whole sequence, whose scan takes K7 (``ops.selective_scan_long``)
from 2048 tokens. Returns the JAX package's hidden-state list [input,
h1..hN, final norm] (N + 2 tensors).

Contract kept from the JAX package:
  * size presets small (384/1536/12/6), base (768/3072/12/12), custom;
  * attention: a learnable position embedding and, for classification, a
    zero-init cls token prepended to the tokens; Hyena (and Mamba): neither;
  * output_feature_channels = [hidden] * (num_layers + 1).

Not ported here: the sequence-parallel padding of the token axis (the
sequence-parallel slice).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.attention import multi_head_attention
from .hyena import HyenaOperator
from .layers import FlaxLayerNorm, LNMLPResidual, PatchEmbeddingBlock, TorchDense
from .mamba import MambaVisionMixer

HYENA_L_MAX = 66000  # ref: backbone_vit.py:172


class SABlock(nn.Module):
    """Token mixer. Softmax multi-head attention: qkv (C -> 3C, no bias, as
    every ViT of the JAX package builds it) split as (B, L, 3, heads,
    head_dim), the out projection C -> C. With ``use_hyena`` the Hyena
    operator over the whole sequence instead, as the submodule ``hyena``;
    with ``use_mamba`` the Mamba mixer, as the submodule ``mamba``."""

    def __init__(self, hidden_size: int, num_heads: int, use_hyena: bool = False,
                 use_mamba: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.hyena = (HyenaOperator(d_model=hidden_size, l_max=HYENA_L_MAX, filter_order=64,
                                    num_heads=num_heads, short_filter_order=5)
                      if use_hyena else None)
        self.mamba = (MambaVisionMixer(hidden_size, d_state=8, d_conv=3, expand=1)
                      if use_mamba else None)
        if use_hyena or use_mamba:
            return
        self.qkv = TorchDense(hidden_size, 3 * hidden_size, use_bias=False)
        self.proj = TorchDense(hidden_size, hidden_size)

    def forward(self, x):
        if self.hyena is not None:
            return self.hyena(x)
        if self.mamba is not None:
            return self.mamba(x)
        b, l, c = x.shape
        qkv = self.qkv(x).reshape(b, l, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                      # each (b, h, l, hd)
        out = multi_head_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, l, c))


class TransformerBlock(nn.Module):
    """Pre-LN block: x += SABlock(LN(x)); x += MLP(LN(x)), the second half
    in one kernel on (B*L, C) rows."""

    def __init__(self, hidden_size: int, mlp_dim: int, num_heads: int, use_hyena: bool = False,
                 use_mamba: bool = False):
        super().__init__()
        self.norm1 = FlaxLayerNorm(hidden_size)
        self.attn = SABlock(hidden_size, num_heads, use_hyena, use_mamba)
        self.mlp = LNMLPResidual(hidden_size, mlp_dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        b, l, c = x.shape
        return self.mlp(x.reshape(-1, c)).reshape(b, l, c)


class ViTBackbone(nn.Module):
    """The ViT encoder returning the hidden-state list."""

    def __init__(self, img_size: Sequence[int], patch_size: Sequence[int], in_channels: int,
                 hidden_size: int = 768, mlp_dim: int = 3072, num_layers: int = 12,
                 num_heads: int = 12, use_hyena: bool = False, use_mamba: bool = False,
                 classification: bool = False, embed_dtype: torch.dtype | None = None):
        super().__init__()
        self.spatial_2d = len(img_size) == 2
        self.num_layers = num_layers
        use_alt = use_hyena or use_mamba
        self.patch_embedding = PatchEmbeddingBlock(
            img_size, patch_size, in_channels, hidden_size,
            pos_embed_type="none" if use_alt else "learnable", dtype=embed_dtype)
        self.cls_token = (nn.Parameter(torch.empty(1, 1, hidden_size))
                          if classification and not use_alt else None)
        for i in range(num_layers):
            setattr(self, f"block_{i}", TransformerBlock(hidden_size, mlp_dim, num_heads,
                                                         use_hyena, use_mamba))
        self.norm = FlaxLayerNorm(hidden_size)

    def init_params(self, gen):
        if self.cls_token is not None:
            nn.init.zeros_(self.cls_token)

    def forward(self, x):
        """x: (B, T, H, W, C); for 2D models T == 1 and is dropped."""
        if self.spatial_2d:
            x = x[:, 0]
        hidden_states = [x]
        tokens = self.patch_embedding(x)
        if self.cls_token is not None:
            tokens = torch.cat([self.cls_token.expand(tokens.shape[0], 1, -1), tokens], dim=1)
        for i in range(self.num_layers):
            tokens = getattr(self, f"block_{i}")(tokens)
            hidden_states.append(tokens)
        hidden_states.append(self.norm(tokens))
        return hidden_states


def vit_size_presets(size: str, cfg=None) -> dict:
    """Size presets (ref: backbone_vit.py:56-89)."""
    if size == "small":
        return dict(hidden_size=384, mlp_dim=1536, num_layers=12, num_heads=6)
    if size == "base":
        return dict(hidden_size=768, mlp_dim=3072, num_layers=12, num_heads=12)
    if size == "custom":
        return dict(hidden_size=cfg.hidden_size, mlp_dim=cfg.mlp_dim,
                    num_layers=cfg.num_layers, num_heads=cfg.num_heads)
    raise ValueError(f"Unknown ViT size {size}")


def build_vit(config, input_feature_channels: int):
    """Config -> (module, output_feature_channels); writes the preset's
    widths back into config.ViT, as the JAX package does."""
    preset = vit_size_presets(config.ViT.size, config.ViT)
    for key, value in preset.items():
        setattr(config.ViT, key, value)
    patch = list(config.ViT.patch_size)
    if config.time == 1:
        img_size = [config.height, config.width]
        patch = patch[1:] if len(patch) == 3 else patch
    else:
        img_size = [config.time, config.height, config.width]
    model = ViTBackbone(img_size, patch, input_feature_channels,
                        use_hyena=config.ViT.use_hyena, use_mamba=config.ViT.use_mamba,
                        classification=config.task_type == "class",
                        embed_dtype=torch.bfloat16 if config.get("use_amp") else None, **preset)
    return model, [preset["hidden_size"]] * (preset["num_layers"] + 1)
