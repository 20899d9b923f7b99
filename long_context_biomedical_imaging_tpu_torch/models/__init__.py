from .class_heads import SwinLinear, ViTLinear
from .hyena import HyenaFilter, HyenaOperator
from .layers import (FlaxLayerNorm, LayerNormAmp, LNMLPResidual, MLPBlock, PatchEmbed,
                     PatchEmbeddingBlock, TorchDense, extract_patches, init_weights,
                     parameterless_layer_norm)
from .model_base import EncoderDecoderModel, build_model
from .swin import (BasicLayer, PatchMergingV2, SwinBackbone, SwinTransformerBlock,
                   WindowAttention, build_swin)
from .vit import SABlock, TransformerBlock, ViTBackbone, build_vit, vit_size_presets

__all__ = [
    "SwinLinear", "ViTLinear", "HyenaFilter", "HyenaOperator", "FlaxLayerNorm",
    "LayerNormAmp", "LNMLPResidual", "MLPBlock", "PatchEmbed", "PatchEmbeddingBlock", "TorchDense",
    "extract_patches", "init_weights", "parameterless_layer_norm", "EncoderDecoderModel",
    "build_model", "BasicLayer", "PatchMergingV2", "SwinBackbone", "SwinTransformerBlock",
    "WindowAttention", "build_swin",
    "SABlock", "TransformerBlock", "ViTBackbone", "build_vit", "vit_size_presets",
]
