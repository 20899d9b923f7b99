"""Hyena operator on windows: gated causal long convolution as a token mixer.

Counterpart of the JAX package's ``models/hyena.py`` (ref: hyena.py:219-360
HyenaOperator, :117-199 Filter). The implicit filter is a small Sin-MLP over a
fixed positional embedding, evaluated for the first L points of the l_max
grid. Windows a fused kernel takes (``ops.hyena_window_supported``: K1 at
8 <= L <= 64, K3 at 64 < L <= 512 with C <= 192) run the mixer body in one
kernel (``ops.hyena_window_mixer``); every other window runs the composed
path in the stream dtype, as the JAX package routes them: in_proj, the causal
depthwise short conv (``ops.conv``), the pre-gate, the causal long conv
(``ops.fftconv``), the post-gate and out_proj. The full-sequence ViT call
(65,536 tokens at vit65k_hyena) takes the composed path too, its long
convolution the spectral kernel K6.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.conv import depthwise_conv1d_cm
from ..ops.fftconv import causal_long_conv_cm
from ..ops.fused_mlp import fast_layernorm
from ..ops.hyena_window import hyena_window_mixer, hyena_window_supported
from .layers import TorchDense, uniform_fan_in_


def _positional_embedding_init(emb_dim: int, seq_len: int) -> np.ndarray:
    """Initial z: [t, Re exp(-i f w), Im exp(-i f w)] on the l_max grid
    (ref: hyena.py:67-85)."""
    t = np.linspace(0, 1, seq_len)[None, :, None].astype(np.float32)
    bands = (emb_dim - 1) // 2
    t_rescaled = np.linspace(0, seq_len - 1, seq_len)[None, :, None].astype(np.float32)
    w = 2 * math.pi * t_rescaled / seq_len
    f = np.linspace(1e-4, bands - 1, bands)[None, None].astype(np.float32)
    z = np.exp(-1j * f * w)
    return np.concatenate([t, z.real.astype(np.float32), z.imag.astype(np.float32)],
                          axis=-1)  # (1, seq_len, emb_dim)


class HyenaFilter(nn.Module):
    """Implicit long filter: positional embedding z -> Sin-MLP -> exponential
    decay. ``forward(L)`` returns k of shape (L, d_model); under AMP the MLP
    runs in bf16 and the fp32 decay promotes k to fp32, as in the JAX package."""

    def __init__(self, d_model: int, emb_dim: int = 3, order: int = 64,
                 seq_len: int = 1024, w: float = 1.0, num_inner_mlps: int = 2,
                 fast_decay_pct: float = 0.3, slow_decay_pct: float = 1.5,
                 target: float = 1e-2, shift: float = 0.0):
        super().__init__()
        assert emb_dim % 2 == 1 and emb_dim >= 3
        self.d_model, self.emb_dim, self.seq_len, self.w = d_model, emb_dim, seq_len, w
        self.num_inner_mlps = num_inner_mlps
        self.fast_decay_pct, self.slow_decay_pct = fast_decay_pct, slow_decay_pct
        self.target, self.shift = target, shift
        self.z = nn.Parameter(torch.empty(1, seq_len, emb_dim))
        # fftconv skip weight (ref: hyena.py:156 `self.bias = Parameter(randn(d))`)
        self.bias = nn.Parameter(torch.empty(d_model))
        for i in range(num_inner_mlps + 1):
            self.register_parameter(f"sin_freq_{i}", nn.Parameter(torch.empty(1, order)))
        self.linears_in = TorchDense(emb_dim, order)
        for i in range(num_inner_mlps):
            self.add_module(f"linears_mid_{i}", TorchDense(order, order))
        self.linear_out = TorchDense(order, d_model, use_bias=False)
        self._decay = {}

    def init_params(self, gen):
        with torch.no_grad():
            self.z.copy_(torch.from_numpy(_positional_embedding_init(self.emb_dim,
                                                                     self.seq_len)))
            self.bias.normal_(0.0, 1.0, generator=gen)
            for i in range(self.num_inner_mlps + 1):
                getattr(self, f"sin_freq_{i}").fill_(self.w)

    def modulation_decay(self, length: int, device) -> torch.Tensor:
        """(L, d_model) fp32 exponential decay, made in numpy as in the JAX
        package and kept per (L, device)."""
        key = (length, str(device))
        if key not in self._decay:
            max_decay = math.log(self.target) / self.fast_decay_pct
            min_decay = math.log(self.target) / self.slow_decay_pct
            deltas = np.linspace(min_decay, max_decay, self.d_model).astype(np.float32)
            t = np.linspace(0, 1, self.seq_len)[:length, None].astype(np.float32)
            decay = np.exp(-t * np.abs(deltas)[None, :])
            self._decay[key] = torch.from_numpy(decay).to(device)
        return self._decay[key]

    def forward(self, length: int) -> torch.Tensor:
        h = self.z[0, :length]
        h = torch.sin(self.sin_freq_0 * self.linears_in(h))
        for i in range(self.num_inner_mlps):
            h = torch.sin(getattr(self, f"sin_freq_{i + 1}")
                          * getattr(self, f"linears_mid_{i}")(h))
        h = self.linear_out(h)
        return h * (self.modulation_decay(length, h.device) + self.shift)


class HyenaOperator(nn.Module):
    """Gated causal long-convolution mixer on (B, L, d_model) windows. The
    head_dim filter is shared across heads, tiled head-major over channels;
    in_proj emits head-major [x1 | x2 | v] column blocks."""

    def __init__(self, d_model: int, l_max: int, filter_order: int = 64,
                 num_heads: int = 1, short_filter_order: int = 5):
        super().__init__()
        self.d_model, self.l_max, self.num_heads = d_model, l_max, num_heads
        width = 3 * d_model
        self.in_proj_kernel = nn.Parameter(torch.empty(d_model, width))
        self.in_proj_bias = nn.Parameter(torch.empty(width))
        self.out_proj_kernel = nn.Parameter(torch.empty(d_model, d_model))
        self.out_proj_bias = nn.Parameter(torch.empty(d_model))
        self.short_filter_kernel = nn.Parameter(torch.empty(width, short_filter_order))
        self.short_filter_bias = nn.Parameter(torch.empty(width))
        self.filter_fn = HyenaFilter(d_model // num_heads, order=filter_order, seq_len=l_max)

    def init_params(self, gen):
        d, k = self.d_model, self.short_filter_kernel.shape[1]
        uniform_fan_in_(self.in_proj_kernel, d, gen)
        uniform_fan_in_(self.in_proj_bias, d, gen)
        uniform_fan_in_(self.out_proj_kernel, d, gen)
        uniform_fan_in_(self.out_proj_bias, d, gen)
        # torch depthwise Conv1d defaults: fan_in = K (groups = channels)
        uniform_fan_in_(self.short_filter_kernel, k, gen)
        uniform_fan_in_(self.short_filter_bias, k, gen)

    def _composed(self, y, k_full, bias_full):
        """The mixer body from tensor ops in y.dtype (ref: models/hyena.py
        composed): in_proj -> causal short conv -> v * x1 -> causal long conv
        with the skip -> * x2 -> out_proj."""
        b, length, d = y.shape
        z = (y.reshape(b * length, d) @ self.in_proj_kernel.to(y.dtype)
             + self.in_proj_bias.to(y.dtype)).reshape(b, length, 3 * d)
        z = depthwise_conv1d_cm(z, self.short_filter_kernel, self.short_filter_bias)
        v = causal_long_conv_cm(z[..., 2 * d:] * z[..., :d], k_full, bias_full)
        v = v * z[..., d:2 * d]
        return (v.reshape(b * length, d) @ self.out_proj_kernel.to(y.dtype)
                + self.out_proj_bias.to(y.dtype)).reshape(b, length, d)

    def forward(self, u, ln_params=None):
        """u: (B, L, d_model). With ln_params = (scale, bias) of the caller's
        pre-LN, returns u + mixer(LN(u))."""
        _, length, d = u.shape
        assert d == self.d_model, (d, self.d_model)
        assert length <= self.l_max, f"Input length {length} exceeds maximum {self.l_max}"
        k = self.filter_fn(length)                                # (L, head_dim)
        k_full = k.t().repeat(self.num_heads, 1)                  # (d, L)
        bias_full = self.filter_fn.bias.repeat(self.num_heads)    # (d,)
        if hyena_window_supported(length, d):
            ln_scale, ln_bias = ln_params if ln_params is not None else (None, None)
            return hyena_window_mixer(u, self.in_proj_kernel, self.in_proj_bias,
                                      self.short_filter_kernel, self.short_filter_bias,
                                      k_full, bias_full, self.out_proj_kernel,
                                      self.out_proj_bias, ln_scale=ln_scale, ln_bias=ln_bias)
        if ln_params is None:
            return self._composed(u, k_full, bias_full)
        return u + self._composed(fast_layernorm(u, *ln_params), k_full, bias_full)
