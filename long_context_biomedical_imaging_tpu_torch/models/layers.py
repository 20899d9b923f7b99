"""Shared model blocks: Dense, patch embeddings, the MLPs, LayerNorms.

Counterpart of the JAX package's ``models/layers.py``. Parameters keep the
JAX names and layouts (Dense kernels are (in, out)), so a JAX parameter tree
converts by flattening and renaming alone (``utils/convert.py``).

Initialisers mirror torch's defaults as the JAX package does: Linear and
Conv weights and Linear biases U(+-1/sqrt(fan_in)), LayerNorm ones/zeros.
Every module here draws from an explicit ``torch.Generator`` in
``init_params``; :func:`init_weights` walks a model in registration order.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.fused_mlp import fused_ln_mlp_residual, fused_mlp


def uniform_fan_in_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """torch's Linear/Conv default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


def init_weights(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Initialise every parameter of ``model`` from ``gen``, module by module
    in registration order."""
    for m in model.modules():
        if hasattr(m, "init_params"):
            m.init_params(gen)
    return model


class TorchDense(nn.Module):
    """y = x @ kernel + bias, kernel (in, out): flax Dense with torch
    nn.Linear's default initialisation."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None

    def init_params(self, gen):
        fan_in = self.kernel.shape[0]
        uniform_fan_in_(self.kernel, fan_in, gen)
        if self.bias is not None:
            uniform_fan_in_(self.bias, fan_in, gen)

    def forward(self, x):
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


def extract_patches(x, patch_size):
    """(B, *spatial, C) -> (B, *spatial/p, prod(p)*C) by reshape/transpose."""
    b = x.shape[0]
    spatial = x.shape[1:-1]
    c = x.shape[-1]
    assert len(spatial) == len(patch_size)
    new_shape = [b]
    for s, p in zip(spatial, patch_size):
        if s % p != 0:
            raise ValueError(f"spatial {tuple(spatial)} not divisible by patch {patch_size}")
        new_shape += [s // p, p]
    x = x.reshape(*new_shape, c)
    rank = len(spatial)
    # (B, s0', p0, s1', p1, ..., C) -> (B, s0', s1', ..., p0, p1, ..., C)
    perm = ([0] + [1 + 2 * i for i in range(rank)]
            + [2 + 2 * i for i in range(rank)] + [1 + 2 * rank])
    x = x.permute(*perm)
    return x.reshape(b, *[s // p for s, p in zip(spatial, patch_size)],
                     c * math.prod(patch_size))


class PatchEmbed(nn.Module):
    """Swin patchify: patch projection on the spatial grid, (B,*s,C) ->
    (B,*s/p,E). ``dtype`` (bf16 under AMP) is applied after patch extraction,
    where the feature axis is prod(p)*C wide."""

    def __init__(self, patch_size: Sequence[int], in_channels: int, embed_dim: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.dtype = dtype
        feat = in_channels * math.prod(self.patch_size)
        self.kernel = nn.Parameter(torch.empty(feat, embed_dim))
        self.bias = nn.Parameter(torch.empty(embed_dim))

    def init_params(self, gen):
        uniform_fan_in_(self.kernel, self.kernel.shape[0], gen)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x = extract_patches(x, self.patch_size)
        if self.dtype is not None:
            x = x.to(self.dtype)
        return x @ self.kernel + self.bias


def trunc_normal_init_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """flax's truncated_normal(stddev=std): a standard normal truncated to
    [-2, 2], scaled by std over that truncated normal's own std."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.mul_(std / 0.87962566103423978)


class PatchEmbeddingBlock(PatchEmbed):
    """ViT patchify (B, *spatial, C) -> tokens (B, L, E), row-major over the
    patch grid, plus, with ``pos_embed_type="learnable"``, a learnable
    position embedding (trunc_normal(0.02), shape (1, L, E), cast to the
    tokens' dtype before the add); ``"none"`` (the Hyena and Mamba ViTs) has
    no such parameter, as in the JAX tree. ``dtype`` (bf16 under AMP)
    applies after patch extraction, as in PatchEmbed."""

    def __init__(self, img_size: Sequence[int], patch_size: Sequence[int], in_channels: int,
                 hidden_size: int, pos_embed_type: str = "learnable",
                 dtype: torch.dtype | None = None):
        super().__init__(patch_size, in_channels, hidden_size, dtype)
        for i, p in zip(img_size, patch_size):
            if i % p:
                raise ValueError(f"img_size {tuple(img_size)} not divisible by patch "
                                 f"{tuple(patch_size)}")
        if pos_embed_type not in ("learnable", "none"):
            raise ValueError(f"unknown pos_embed_type {pos_embed_type}")
        n_patches = math.prod(i // p for i, p in zip(img_size, patch_size))
        self.position_embeddings = (nn.Parameter(torch.empty(1, n_patches, hidden_size))
                                    if pos_embed_type == "learnable" else None)

    def init_params(self, gen):
        super().init_params(gen)
        if self.position_embeddings is not None:
            trunc_normal_init_(self.position_embeddings, 0.02, gen)

    def forward(self, x):
        x = super().forward(x)
        x = x.reshape(x.shape[0], -1, x.shape[-1])
        if self.position_embeddings is None:
            return x
        return x + self.position_embeddings.to(x.dtype)


class MLPBlock(nn.Module):
    """Transformer MLP: Dense -> GELU -> dropout -> Dense -> dropout (MONAI's
    MLPBlock), with the JAX package's parameters fc1_kernel (C, H), fc1_bias,
    fc2_kernel (H, C), fc2_bias and their torch nn.Linear initialisation.
    With ``dropout_rate`` 0 or in eval mode it runs K2' (``ops.fused_mlp``),
    as the JAX package runs its fused kernel; otherwise the composed path:
    Linear, exact GELU, dropout, Linear, dropout, with keep masks drawn from
    the ``generator`` the caller passes (the JAX package's from its dropout
    rng: the two draw different masks). x: (..., C)."""

    def __init__(self, hidden_size: int, mlp_dim: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.fc1_kernel = nn.Parameter(torch.empty(hidden_size, mlp_dim))
        self.fc1_bias = nn.Parameter(torch.empty(mlp_dim))
        self.fc2_kernel = nn.Parameter(torch.empty(mlp_dim, hidden_size))
        self.fc2_bias = nn.Parameter(torch.empty(hidden_size))

    def init_params(self, gen):
        hidden, mlp_dim = self.fc1_kernel.shape
        uniform_fan_in_(self.fc1_kernel, hidden, gen)
        uniform_fan_in_(self.fc1_bias, hidden, gen)
        uniform_fan_in_(self.fc2_kernel, mlp_dim, gen)
        uniform_fan_in_(self.fc2_bias, mlp_dim, gen)

    def _dropout(self, h, generator):
        keep = 1.0 - self.dropout_rate
        mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
        return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))

    def forward(self, x, generator: torch.Generator | None = None):
        if self.dropout_rate == 0.0 or not self.training:
            return fused_mlp(x, self.fc1_kernel, self.fc1_bias, self.fc2_kernel, self.fc2_bias)
        if generator is None:
            raise ValueError("MLPBlock draws its dropout masks from an explicit generator")
        c = x.shape[-1]
        h = x.reshape(-1, c) @ self.fc1_kernel.to(x.dtype) + self.fc1_bias.to(x.dtype)
        h = self._dropout(nn.functional.gelu(h), generator)
        out = h @ self.fc2_kernel.to(x.dtype) + self.fc2_bias.to(x.dtype)
        return self._dropout(out, generator).reshape(x.shape)


class LNMLPResidual(nn.Module):
    """x + MLP(LayerNorm(x)), the pre-LN transformer second half, in one
    kernel (``ops.fused_ln_mlp_residual``). x: (N, C)."""

    def __init__(self, hidden_size: int, mlp_dim: int):
        super().__init__()
        self.ln_scale = nn.Parameter(torch.empty(hidden_size))
        self.ln_bias = nn.Parameter(torch.empty(hidden_size))
        self.fc1_kernel = nn.Parameter(torch.empty(hidden_size, mlp_dim))
        self.fc1_bias = nn.Parameter(torch.empty(mlp_dim))
        self.fc2_kernel = nn.Parameter(torch.empty(mlp_dim, hidden_size))
        self.fc2_bias = nn.Parameter(torch.empty(hidden_size))

    def init_params(self, gen):
        nn.init.ones_(self.ln_scale)
        nn.init.zeros_(self.ln_bias)
        hidden, mlp_dim = self.fc1_kernel.shape
        uniform_fan_in_(self.fc1_kernel, hidden, gen)
        uniform_fan_in_(self.fc1_bias, hidden, gen)
        uniform_fan_in_(self.fc2_kernel, mlp_dim, gen)
        uniform_fan_in_(self.fc2_bias, mlp_dim, gen)

    def forward(self, x):
        return fused_ln_mlp_residual(x, self.ln_scale, self.ln_bias, self.fc1_kernel,
                                     self.fc1_bias, self.fc2_kernel, self.fc2_bias)


def parameterless_layer_norm(x, eps: float = 1e-5):
    """LayerNorm over the channel axis without affine, fp32 statistics,
    result in x.dtype (ref: backbone_swin.py:866-879 proj_out)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class LayerNormAmp(nn.Module):
    """LayerNorm (scale/bias, eps 1e-6) with fp32 statistics whose result
    keeps the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def init_params(self, gen):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


class FlaxLayerNorm(nn.Module):
    """flax's nn.LayerNorm (scale/bias, eps 1e-6), which the ViT uses: fp32
    statistics in the fast form var = max(E[x^2] - mu^2, 0), y = (x - mu) *
    (rsqrt(var + eps) * scale) + bias in fp32, the result in the promoted
    dtype of x and the parameters (bf16 under AMP, where both are bf16).
    LayerNormAmp differs in its variance (two-pass) and its result dtype
    (always x's)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def init_params(self, gen):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = ((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
        y = (x32 - mu) * (torch.rsqrt(var + self.eps) * self.scale.float()) + self.bias.float()
        return y.to(torch.promote_types(x.dtype, self.scale.dtype))


class ConvNd(nn.Module):
    """2D convolution on channels-last (B, H, W, C) tensors with the JAX
    package's ConvNd parameters (kernel (kh, kw, Cin, Cout), bias (Cout,))
    and torch's Conv default initialisation, U(+-1/sqrt(Cin * kh * kw)).
    'same' padding for odd kernels; computes in the input's dtype, as flax's
    Conv under AMP. The 3D form comes with the abct slice."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True):
        super().__init__()
        if kernel_size % 2 == 0:
            raise NotImplementedError("even ConvNd kernels are not ported")
        self.kernel = nn.Parameter(torch.empty(kernel_size, kernel_size, in_features, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def init_params(self, gen):
        fan_in = math.prod(self.kernel.shape[:-1])
        uniform_fan_in_(self.kernel, fan_in, gen)
        if self.bias is not None:
            uniform_fan_in_(self.bias, fan_in, gen)

    def forward(self, x):
        return conv2d_cl(x, self.kernel, self.bias)


def conv2d_cl(x, kernel, bias=None):
    """'same' conv of channels-last x (B, H, W, Cin) with an HWIO kernel (k,
    k, Cin, Cout) of odd k, in x.dtype; returns (B, H, W, Cout)."""
    k = kernel.shape[0]
    y = nn.functional.conv2d(x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(3, 2, 0, 1),
                             padding=(k - 1) // 2)
    y = y.permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(y.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the channel (last) axis with flax's semantics
    (momentum 0.9, epsilon 1e-5): in training, the batch's fp32 mean and its
    biased variance in the fast form E[x^2] - E[x]^2 (clamped at 0), with
    the running statistics updated as 0.9 * running + 0.1 * batch on that
    biased variance (torch's BatchNorm would take the unbiased one); in
    evaluation, the running statistics. Normalises in fp32; the result takes
    the promoted dtype of x and the parameters (bf16 under AMP), and the
    running statistics stay fp32 (the JAX package's batch_stats)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def init_params(self, gen):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x32 = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x32.mean(dim=axes)
            var = ((x32 * x32).mean(dim=axes) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.scale.float()) + self.bias.float()
        return y.to(torch.promote_types(x.dtype, self.scale.dtype))
