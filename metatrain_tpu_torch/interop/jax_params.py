"""Parameters and checkpoints of the JAX package, read without JAX.

- :func:`flax_to_state_dict` maps a flax parameter tree (nested dicts of
  numpy arrays) onto the port's ``state_dict``: ``nn.Dense`` ``kernel``
  (in, out) becomes ``weight`` (out, in); ``nn.Embed`` ``embedding``
  becomes ``weight``; ``nn.RMSNorm``/``nn.LayerNorm`` ``scale`` becomes
  ``weight``; raw leaves (the fused layer's ``w_qkv`` ...) keep their name
  and their (in, out) layout.
- :func:`load_checkpoint_file` reads the JAX package's checkpoint pickle
  (``metatrain_tpu/utils/io.py``), a tree of dicts and numpy arrays. The
  trainer sections may reference optax/flax classes; those load as opaque
  placeholders, so unpickling imports nothing of JAX.
- :func:`pet_from_checkpoint` builds the port's PET with the checkpoint's
  weights, composition weights and scales.
"""

from __future__ import annotations

import gzip
import pickle
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

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


class _Opaque:
    """Placeholder for any class outside numpy and the standard library."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _NumpyOnlyUnpickler(pickle.Unpickler):
    _ALLOWED = ("numpy", "builtins", "collections", "copyreg", "_codecs")

    def find_class(self, module, name):
        if module.split(".")[0] in self._ALLOWED:
            return super().find_class(module, name)
        return _Opaque


def load_checkpoint_file(path) -> Dict[str, Any]:
    """Read a (optionally gzipped) checkpoint pickle written by the JAX
    package, without importing JAX."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        return _NumpyOnlyUnpickler(f).load()


def pet_from_checkpoint(checkpoint, compute_dtype=torch.float32,
                        device="cpu", plain: bool = False):
    """The port's PET from a JAX PET checkpoint (dict or path), format v3."""
    from ..data.target_info import DatasetInfo
    from ..models.pet import PET

    if not isinstance(checkpoint, dict):
        checkpoint = load_checkpoint_file(checkpoint)
    if checkpoint.get("architecture_name") != "pet":
        raise ValueError(f"not a PET checkpoint: {checkpoint.get('architecture_name')!r}")
    if int(checkpoint.get("model_ckpt_version", 1)) != 3:
        raise NotImplementedError(
            "the port reads PET checkpoints of version 3; upgrade older ones "
            "with the JAX package first"
        )
    model = PET(checkpoint["hypers"], DatasetInfo.from_dict(checkpoint["dataset_info"]),
                compute_dtype=compute_dtype, plain=plain)
    model.module.load_state_dict(flax_to_state_dict(checkpoint["params"]))
    model.composition.load_checkpoint_weights(checkpoint["composition"])
    model.scaler.load_checkpoint_scales(checkpoint["scaler"])
    return model.to(device)
