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
  version (1 to 3), upgraded as the JAX package's ``model_from_checkpoint``
  upgrades it.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..utils.io import load_checkpoint_file, upgrade_chain

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
                        device="cuda", plain: bool = False, fused_gnn: bool = False):
    """The port's PET from a JAX PET checkpoint (dict or path) of version 1,
    2 or 3, on ``device`` (the card unless the caller asks otherwise);
    ``plain`` and ``fused_gnn`` as for ``PET``."""
    from ..data.target_info import DatasetInfo
    from ..models.pet import PET

    if not isinstance(checkpoint, dict):
        checkpoint = load_checkpoint_file(checkpoint)
    if checkpoint.get("architecture_name") != "pet":
        raise ValueError(f"not a PET checkpoint: {checkpoint.get('architecture_name')!r}")
    checkpoint = upgrade_chain(PET, dict(checkpoint))
    model = PET(checkpoint["hypers"], DatasetInfo.from_dict(checkpoint["dataset_info"]),
                compute_dtype=compute_dtype, plain=plain, fused_gnn=fused_gnn)
    model.module.load_state_dict(flax_to_state_dict(checkpoint["params"]))
    model.composition.load_checkpoint_weights(checkpoint["composition"])
    model.scaler.load_checkpoint_scales(checkpoint["scaler"])
    model.weights_initialized = True
    return model.to(device)
