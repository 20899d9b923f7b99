"""Convert a parameter tree of the JAX package to a port state_dict.

The port's modules keep the JAX parameter names and layouts (Dense kernels
stay (in, out), in_proj stays (C, 3C) with head-major [x1 | x2 | v] blocks),
so conversion is a flatten and a few renames, with no transposes:

  * flax's inner ``Dense_0`` scope of a Dense wrapper is dropped
    (``.../linears_in/Dense_0/kernel`` -> ``...linears_in.kernel``);
  * so is the inner ``Conv_0`` scope of a ConvNd (conv kernels stay HWIO:
    ``.../conv1x1_0/Conv_0/kernel`` -> ``...conv1x1_0.kernel``);
  * flax's auto-named ``TorchDense_<i>`` scopes get the port's names, by
    their parent scope: PatchMergingV2's (``downsample``) is ``reduction``,
    the ViT attention's (``attn``) are ``qkv`` and ``proj``.

The JAX ``batch_stats`` collection (BatchNorm ``mean`` / ``var``) maps the
same way onto the port's BatchNorm buffers of those names. Load the result
with ``model.load_state_dict(state_dict, strict=True)``: strict loading fails
on any leaf or buffer either side lacks.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

# (parent scope, scope) -> the port's name
_RENAME = {("downsample", "TorchDense_0"): "reduction",
           ("attn", "TorchDense_0"): "qkv", ("attn", "TorchDense_1"): "proj"}
_DROP = {"Dense_0", "Conv_0"}


def port_key(path) -> str:
    """JAX tree path (tuple of names) -> port state_dict key."""
    return ".".join(_RENAME.get((path[i - 1] if i else None, p), p)
                    for i, p in enumerate(path) if p not in _DROP)


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """tree: the JAX model's ``params`` as nested dicts of numpy arrays
    (``flax.serialization.to_state_dict`` then ``np.asarray`` on the leaves),
    with or without the outer ``{"params": ...}``, or the whole variables
    ``{"params": ..., "batch_stats": ...}``. Returns a state_dict of CPU
    tensors in the leaves' dtypes."""
    batch_stats = tree.get("batch_stats")
    if "params" in tree:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for name, child in node.items():
                walk(child, path + (str(name),))
            return
        key = port_key(path)
        if key in out:
            raise ValueError(f"two JAX leaves map to {key}")
        out[key] = torch.from_numpy(np.array(node, copy=True))

    walk(tree, ())
    if batch_stats is not None:
        walk(batch_stats, ())
    return out
