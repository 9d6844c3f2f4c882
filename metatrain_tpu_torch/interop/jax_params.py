"""Parameters and checkpoints of the JAX package, read without JAX.

- :func:`flax_to_state_dict` maps a flax parameter tree (nested dicts of
  numpy arrays) onto the port's ``state_dict``: ``nn.Dense`` ``kernel``
  (in, out) becomes ``weight`` (out, in); ``nn.Embed`` ``embedding``
  becomes ``weight``; ``nn.RMSNorm``/``nn.LayerNorm`` ``scale`` becomes
  ``weight``; raw leaves (the fused layer's ``w_qkv`` ...) keep their name
  and their (in, out) layout.
- :func:`state_dict_to_flax` is its inverse: the port's parameters as
  the flax tree the JAX package stores in a checkpoint.
- :func:`load_checkpoint_file` (from ``utils/io.py``) reads the JAX
  package's checkpoint pickle without importing JAX.
- :func:`pet_from_checkpoint` builds the port's PET with the checkpoint's
  weights, composition weights and scales, from a checkpoint of any
  version (1 to 3), through ``utils.io.model_from_checkpoint``.
- :func:`int8_calib_from_jax` and :func:`int8_calib_to_jax` carry the
  W8A8 calibrations between the JAX package's registry (``_INT8_CALIB``,
  keyed by the layer's scope path) and the port's fused layers.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..utils.io import load_checkpoint_file

_DENSE = {"kernel", "bias"}
_NORM = {"scale", "bias"}


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax tree (optionally under a top-level ``params`` key) -> state_dict."""
    tree = params["params"] if set(params) == {"params"} else params
    out: Dict[str, torch.Tensor] = {}

    def tensor(x):
        return torch.from_numpy(np.array(x))

    def walk(node: Dict[str, Any], prefix: str) -> None:
        for key, value in node.items():
            name = prefix + key
            if not isinstance(value, dict):
                out[name] = tensor(value)
            elif "kernel" in value and set(value) <= _DENSE:
                out[name + ".weight"] = tensor(value["kernel"]).T.contiguous()
                if "bias" in value:
                    out[name + ".bias"] = tensor(value["bias"])
            elif set(value) == {"embedding"}:
                out[name + ".weight"] = tensor(value["embedding"])
            elif "scale" in value and set(value) <= _NORM:
                out[name + ".weight"] = tensor(value["scale"])
                if "bias" in value:
                    out[name + ".bias"] = tensor(value["bias"])
            else:
                walk(value, name + ".")

    walk(tree, "")
    return out


def state_dict_to_flax(module: nn.Module) -> Dict[str, Any]:
    """The flax parameter tree holding ``module``'s weights, as numpy
    arrays under a top-level ``params`` key (the inverse of
    :func:`flax_to_state_dict`)."""
    from ..models.pet.modules import RMSNorm

    tree: Dict[str, Any] = {}
    for name, p in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        value = p.detach().cpu().numpy().copy()
        if isinstance(owner, nn.Linear):
            path, key = owner_name.split("."), "kernel" if leaf == "weight" else "bias"
            value = value.T.copy() if leaf == "weight" else value
        elif isinstance(owner, nn.Embedding):
            path, key = owner_name.split("."), "embedding"
        elif isinstance(owner, (nn.LayerNorm, RMSNorm)):
            path, key = owner_name.split("."), "scale" if leaf == "weight" else "bias"
        else:
            path, key = name.split(".")[:-1], leaf
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[key] = value
    return {"params": tree}


def pet_from_checkpoint(checkpoint, compute_dtype=torch.float32,
                        device="cuda", plain: bool = False, fused_gnn: bool = False,
                        int8_static: bool = False, int8_scores: bool = False):
    """The port's PET from a PET checkpoint (dict or path) of version 1, 2
    or 3, on ``device`` (the card unless the caller asks otherwise);
    ``plain``, ``fused_gnn``, ``int8_static`` and ``int8_scores`` as for
    ``PET`` (a W8A8 model still needs ``calibrate_int8`` or
    :func:`int8_calib_from_jax`). The loader of ``utils.io.model_from_checkpoint``."""
    from ..utils.io import model_from_checkpoint

    if not isinstance(checkpoint, dict):
        checkpoint = load_checkpoint_file(checkpoint)
    if checkpoint.get("architecture_name") != "pet":
        raise ValueError(f"not a PET checkpoint: {checkpoint.get('architecture_name')!r}")
    return model_from_checkpoint(checkpoint, context="export", device=device,
                                 compute_dtype=compute_dtype, plain=plain, fused_gnn=fused_gnn,
                                 int8_static=int8_static, int8_scores=int8_scores)


def int8_calib_from_jax(model, registry: Dict[str, Any]) -> int:
    """Set the port's W8A8 calibrations from the JAX package's registry
    (``fused_layer._INT8_CALIB``: scope path -> ``Int8Calib``, or any
    sequence of its 10 floats). The scope path ``backbone/gnn_layer_0/
    layer_1`` names the fused layer ``backbone.gnn_layer_0.layer_1`` of
    ``model`` (a PET), as the parameter names map. Returns the number of
    layers set; raises ``KeyError`` for a path that names no fused layer."""
    from ..ops.kernels.fused_layer import Int8Calib

    layers = model.fused_layers()
    for key, calib in registry.items():
        name = key.replace("/", ".")
        if name not in layers:
            raise KeyError(f"the calibration {key!r} names no fused layer of the model")
        layers[name].int8_calib = Int8Calib(*(float(x) for x in calib))
    return len(registry)


def int8_calib_to_jax(model) -> Dict[str, tuple]:
    """The inverse of :func:`int8_calib_from_jax`: the calibrated fused
    layers of ``model`` as the JAX package's registry, scope path -> the
    10 floats of ``Int8Calib`` in its field order."""
    return {name.replace(".", "/"): tuple(layer.int8_calib)
            for name, layer in model.fused_layers().items() if layer.int8_calib is not None}
