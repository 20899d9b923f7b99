"""Encoder-decoder composition from config (ref: model/model_base.py:18-83).

Counterpart of the JAX package's ``models/model_base.py``. ``build_model``
returns ``decoder(encoder(x))`` on channels-last (B, T, H, W, C) input, with
parameters initialised from an explicit ``torch.Generator``. The port builds
Swin (window attention, Hyena or Mamba mixer) with SwinLinear for
classification or UperNet2D for segmentation and enhancement, and the ViT
(softmax attention, Hyena or Mamba) with ViTLinear, which reads the cls token
after attention and mean-pools the tokens after Hyena or Mamba;
:func:`check_ported` raises NotImplementedError for everything else, naming
the slice that ports it. UperNet's BatchNorm layers train on batch statistics
in ``model.train()`` and use their running statistics in ``model.eval()``, as
the JAX step's ``use_running_average``.
"""

from __future__ import annotations

import torch
from torch import nn

from .class_heads import SwinLinear, ViTLinear
from .layers import init_weights
from .seg_heads import UperNet
from .swin import build_swin
from .vit import build_vit

_LATER = {
    "Identity": "the UNETR heads slice",
    "UperNet3D": "the abct slice",
    "SwinUNETR": "the UNETR heads slice",
    "ViTUNETR": "the UNETR heads slice",
}


def check_ported(config) -> None:
    """Raise NotImplementedError unless the port can build this model."""
    for name in (config.encoder_name, config.decoder_name):
        if name in _LATER:
            raise NotImplementedError(
                f"{name} is not ported yet: it comes with {_LATER[name]} "
                "(ROADMAP.md queue 1)")
    if config.task_type == "enhance" and config.decoder_name != "UperNet2D":
        raise NotImplementedError(
            f"enhance with {config.decoder_name}: the port's enhancement head is UperNet2D "
            "(the UNETR heads slice brings SwinUNETR and ViTUNETR, ROADMAP.md queue 1)")
    if config.encoder_name == "ViT":
        if config.decoder_name != "ViTLinear":
            raise NotImplementedError(
                f"{config.decoder_name} on the ViT encoder: the port's ViT runs with "
                "ViTLinear (UperNet2D on ViT features is ROADMAP.md queue 1)")
        return
    if config.decoder_name == "ViTLinear":
        raise ValueError("ViTLinear head requires the ViT encoder")
    if config.decoder_name == "UperNet2D" and config.time != 1:
        raise NotImplementedError(
            "UperNet2D on 3D input: the 3D head comes with the abct slice (ROADMAP.md queue 1)")


class EncoderDecoderModel(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def forward(self, x):
        return self.decoder(self.encoder(x))


def build_model(config) -> EncoderDecoderModel:
    """Resolve encoder/decoder from config and initialise the parameters from
    a ``torch.Generator`` seeded from --seed (0 when unset)."""
    check_ported(config)
    if config.encoder_name == "ViT":
        encoder, feature_channels = build_vit(config, config.no_in_channel)
        decoder = ViTLinear(feature_channels[-1], config.no_out_channel,
                            use_cls_token=not (config.ViT.use_hyena or config.ViT.use_mamba))
    else:
        encoder, feature_channels = build_swin(config, config.no_in_channel)
        if config.decoder_name == "UperNet2D":
            decoder = UperNet(config.no_out_channel, feature_channels,
                              (config.height, config.width))
        else:
            decoder = SwinLinear(feature_channels[-1], config.no_out_channel)
    model = EncoderDecoderModel(encoder, decoder)
    return init_weights(model, torch.Generator().manual_seed(config.seed or 0))
