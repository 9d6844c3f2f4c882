"""Checkpoint files: the JAX package's numpy-only pickle.

Counterpart of ``save_checkpoint_file`` / ``load_checkpoint_file`` in
``metatrain_tpu/utils/io.py``. A checkpoint is one pickle of a tree of
dicts, lists, strings, numbers and numpy arrays: torch tensors are
converted to numpy on save, so the JAX package reads a port-written file
and the port reads the JAX package's. Loading imports nothing of JAX: any
class outside numpy and the standard library (the JAX package's trainer
sections may reference optax/flax classes) loads as an opaque
placeholder. Unpickle only checkpoints this project wrote.
"""

from __future__ import annotations

import gzip
import pickle
from pathlib import Path
from typing import Any, Dict

import torch


def to_numpy_tree(tree):
    """``tree`` with every torch tensor replaced by a numpy array."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    return tree


def save_checkpoint_file(checkpoint: Dict[str, Any], path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(to_numpy_tree(checkpoint), f, protocol=pickle.HIGHEST_PROTOCOL)


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
    """Read a (optionally gzipped) checkpoint pickle."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        return _NumpyOnlyUnpickler(f).load()

