"""MambaVision-style window mixer.

Counterpart of the JAX package's ``models/mamba.py`` (ref:
model/models/mamba.py:30-139). Input and output are (B, L, d_model) windows.

Behaviour kept from the reference, as the JAX package keeps it:
  * conv1d_x / conv1d_z have no bias (``bias=conv_bias//2`` is 0);
  * dt_proj's bias is applied inside the linear AND again as the scan's
    ``delta_bias``: delta = softplus(W dt + 2 b);
  * A_log and D share the optimizer's single parameter group.

Routing, as the JAX package routes it (without its sequence-parallel scan,
whose slice comes last): windows of 16 to 64 tokens (V % 8 == 0) in calls
of at least 1024 windows go through the fused K4 mixer
(``ops.mamba_window``), every other call through the composed path in the
stream dtype (in_proj, the 'same' depthwise conv, SiLU, x_proj, dt_proj, the
scan and out_proj). The composed path's scan, in the JAX package's order, is
the windowed scan K9 (``ops.selective_scan_window``) where its gate holds (L
<= 64, N * d <= 8192, at least 2048 windows: Swin windows K4 does not take,
such as 7x7), ``selective_scan_cm`` up to 1024 tokens, the long-sequence scan
K7 (``ops.selective_scan_long``) where its gate holds (L >= 2048, N * d <=
8192: the ViT's full-sequence mixing), and the chunked scan otherwise (1024
< L < 2048, ``selective_scan_long_plain``), the JAX package's own route
there. K7 and K9 launch their kernels on the card and run their plain
versions on the CPU.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.conv import depthwise_conv1d_cm
from ..ops.fused_mlp import fast_layernorm
from ..ops.mamba_window import mamba_window_mixer, mamba_window_supported
from ..ops.selective_scan import selective_scan_cm
from ..ops.selective_scan_long import (long_scan_supported, selective_scan_long,
                                       selective_scan_long_plain)
from ..ops.selective_scan_window import selective_scan_window, window_scan_supported
from .layers import uniform_fan_in_

MAMBA_WINDOW_MIN_CALL = 1024    # windows per call from which K4 runs (JAX gate)
SCAN_CM_MAX_LEN = 1024          # the sequential scan's longest call (JAX route)

# module-level aliases so that tests can spy on or force this module's gates alone
_long_scan_supported = long_scan_supported
_window_scan_supported = window_scan_supported


class MambaVisionMixer(nn.Module):
    """Selective-scan token mixer with a non-SSM gate branch. Parameters
    keep the JAX names and layouts (kernels (in, out), conv (C/2, K))."""

    def __init__(self, d_model: int, d_state: int = 8, d_conv: int = 3, expand: int = 1,
                 dt_rank: int | None = None):
        super().__init__()
        self.d_model, self.d_state, self.d_conv, self.expand = d_model, d_state, d_conv, expand
        d_inner = int(expand * d_model)
        d_half = d_inner // 2
        self.dt_rank = dt_rank or math.ceil(d_model / 16)
        self.in_proj_kernel = nn.Parameter(torch.empty(d_model, d_inner))
        self.conv1d_x_kernel = nn.Parameter(torch.empty(d_half, d_conv))
        self.conv1d_z_kernel = nn.Parameter(torch.empty(d_half, d_conv))
        self.x_proj_kernel = nn.Parameter(torch.empty(d_half, self.dt_rank + 2 * d_state))
        self.dt_proj_kernel = nn.Parameter(torch.empty(self.dt_rank, d_half))
        self.dt_proj_bias = nn.Parameter(torch.empty(d_half))
        self.out_proj_kernel = nn.Parameter(torch.empty(d_inner, d_model))
        self.A_log = nn.Parameter(torch.empty(d_half, d_state))
        self.D = nn.Parameter(torch.empty(d_half))

    def init_params(self, gen, dt_min: float = 0.001, dt_max: float = 0.1,
                    dt_init_floor: float = 1e-4):
        """The JAX package's inits (ref: mamba.py:40-103): torch Linear and
        depthwise Conv1d defaults, dt_proj U(+-dt_rank^-0.5), its bias the
        inverse softplus of a log-uniform dt in [dt_min, dt_max], A_log =
        log(1..N) per channel, D = 1."""
        uniform_fan_in_(self.in_proj_kernel, self.d_model, gen)
        uniform_fan_in_(self.conv1d_x_kernel, self.d_conv, gen)
        uniform_fan_in_(self.conv1d_z_kernel, self.d_conv, gen)
        uniform_fan_in_(self.x_proj_kernel, self.x_proj_kernel.shape[0], gen)
        uniform_fan_in_(self.dt_proj_kernel, self.dt_rank, gen)
        with torch.no_grad():
            u = torch.rand(self.dt_proj_bias.shape, generator=gen)
            dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
            dt = dt.clamp(min=dt_init_floor)
            self.dt_proj_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            self.A_log.copy_(torch.log(torch.arange(1, self.d_state + 1, dtype=torch.float32))
                             .expand(self.A_log.shape))
            self.D.fill_(1.0)
        uniform_fan_in_(self.out_proj_kernel, self.out_proj_kernel.shape[0], gen)

    def forward(self, hidden_states, ln_params=None):
        """hidden_states: (b, l, d_model). With ln_params = (scale, bias) of
        the caller's pre-LN, returns x + mixer(LN(x))."""
        b, length, _ = hidden_states.shape
        # A from the parameter as the forward receives it (bf16 under AMP),
        # computed in fp32, as the JAX package computes it
        A = -torch.exp(self.A_log.float())
        if (self.expand == 1 and self.d_conv == 3 and mamba_window_supported(length)
                and b >= MAMBA_WINDOW_MIN_CALL):
            ln = dict(ln_scale=ln_params[0], ln_bias=ln_params[1]) if ln_params else {}
            return mamba_window_mixer(hidden_states, self.in_proj_kernel, self.conv1d_x_kernel,
                                      self.conv1d_z_kernel, self.x_proj_kernel,
                                      self.dt_proj_kernel, self.dt_proj_bias, A, self.D,
                                      self.out_proj_kernel, d_state=self.d_state, **ln)
        if ln_params is None:
            return self._composed(hidden_states, A)
        return hidden_states + self._composed(fast_layernorm(hidden_states, *ln_params), A)

    def _composed(self, u, A):
        """The mixer body from tensor ops in u.dtype (JAX mamba.py:143-198)."""
        b, length, d = u.shape
        d_inner = self.in_proj_kernel.shape[1]
        d_half, r, n = d_inner // 2, self.dt_rank, self.d_state
        xz = (u.reshape(b * length, d) @ self.in_proj_kernel.to(u.dtype)).reshape(b, length,
                                                                                  d_inner)
        xz = F.silu(depthwise_conv1d_cm(
            xz, torch.cat([self.conv1d_x_kernel, self.conv1d_z_kernel]), None, "same"))
        x, z = xz[..., :d_half], xz[..., d_half:]
        x_dbl = (x.reshape(b * length, d_half) @ self.x_proj_kernel.to(x.dtype)).reshape(
            b, length, r + 2 * n)
        dt = x_dbl[..., :r] @ self.dt_proj_kernel + self.dt_proj_bias
        bm, cm = x_dbl[..., r:r + n], x_dbl[..., r + n:]
        # dt_proj's bias is added twice on purpose (the reference's quirk)
        if _window_scan_supported(length, n, d_half, batch=b):
            y = selective_scan_window(x, dt, A, bm, cm, self.D, delta_bias=self.dt_proj_bias)
        elif length <= SCAN_CM_MAX_LEN:
            y = selective_scan_cm(x, dt, A, bm, cm, self.D, delta_bias=self.dt_proj_bias)
        elif _long_scan_supported(length, n, d_half):
            y = selective_scan_long(x, dt, A, bm, cm, self.D, delta_bias=self.dt_proj_bias)
        else:
            y = selective_scan_long_plain(x, dt, A, bm, cm, self.D, delta_bias=self.dt_proj_bias)
        y = torch.cat([y, z], dim=-1)
        return (y.reshape(b * length, d_inner) @ self.out_proj_kernel.to(y.dtype)).reshape(
            b, length, d)
