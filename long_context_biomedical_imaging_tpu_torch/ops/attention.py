"""Softmax multi-head attention: the plain version and the flash-kernel route.

Counterpart of ``long_context_biomedical_imaging_tpu/ops/attention.py``
(``attention_reference`` and ``multi_head_attention``). Long bias-free
sequences (the full-sequence ViT) go to K5 (:func:`flash_attention`), where
an (L, L) score tensor would not fit; shorter ones, or any with an additive
bias, to the plain version. The sequence-parallel routes (ring attention,
``sp_flash_attention``) come with the sequence-parallel slice: the port's
setup refuses ``--model_parallel > 1``.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention

# Below this many query tokens the JAX package runs the plain attention.
FLASH_MIN_SEQ = 1024


def attention_reference(q, k, v, bias=None, scale=None):
    """Plain O(L^2) attention. q, k, v: (..., H, L, D); bias broadcastable to
    (..., H, L, L). Scores and softmax in fp32 (exact products of the inputs,
    fp32 sums); the probabilities are rounded to v's dtype before p v, whose
    result is in v's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1)
    return (p.to(v.dtype).float() @ v.float()).to(v.dtype)


def multi_head_attention(q, k, v, bias=None, scale=None):
    """Attention on (..., H, L, D): K5 for at least FLASH_MIN_SEQ query
    tokens without a bias, the plain version otherwise, as the JAX package
    routes it."""
    if bias is None and q.shape[-2] >= FLASH_MIN_SEQ:
        lead = q.shape[:-3]
        out = flash_attention(*(t.reshape(-1, *t.shape[-3:]) for t in (q, k, v)), scale=scale)
        return out.reshape(*lead, *out.shape[-3:])
    return attention_reference(q, k, v, bias=bias, scale=scale)
