"""Checkpoint files (the JAX package's numpy-only pickle) and model loading.

Counterpart of ``metatrain_tpu/utils/io.py``: ``save_checkpoint_file`` /
``load_checkpoint_file``, the version upgrades, ``model_from_checkpoint``,
``trainer_from_checkpoint``, ``resolve_model_path`` and ``load_model``
(an exported ``.mtt`` envelope or a checkpoint, from a path or a URL).
A checkpoint is one pickle of a tree of
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
from typing import Any, Dict, Optional

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


def upgrade_chain(cls, checkpoint: Dict[str, Any], version_key: str = "model_ckpt_version"):
    """Bring ``checkpoint`` to ``cls.__checkpoint_version__`` through the
    class's ``upgrade_v{n}_v{n+1}`` steps, one version at a time; a
    checkpoint newer than the code raises."""
    current = int(checkpoint.get(version_key, 1))
    target = int(cls.__checkpoint_version__)
    if current > target:
        raise ValueError(
            f"checkpoint {version_key}={current} is newer than this version of "
            f"the code supports ({target}); please update"
        )
    while current < target:
        upgrader = getattr(cls, f"upgrade_v{current}_v{current + 1}", None)
        if upgrader is None:
            raise ValueError(f"no upgrade of {cls.__name__} checkpoints from version {current}")
        checkpoint = upgrader(checkpoint)
        current += 1
        checkpoint[version_key] = current
    return checkpoint


def _checkpoint(checkpoint_or_path) -> Dict[str, Any]:
    if isinstance(checkpoint_or_path, (str, Path)):
        return load_checkpoint_file(checkpoint_or_path)
    return checkpoint_or_path


def model_from_checkpoint(checkpoint_or_path, context: str = "restart", device="auto",
                          **options):
    """Rebuild a model from a checkpoint file or dict, upgraded to the
    code's version, on ``device`` (the card unless the caller asks
    otherwise). ``options`` go to the model's ``load_checkpoint``
    (``compute_dtype``, and PET's ``plain``, ``fused_gnn``, ...)."""
    from .architectures import import_architecture

    checkpoint = _checkpoint(checkpoint_or_path)
    model_cls = import_architecture(checkpoint["architecture_name"]).__model__
    checkpoint = upgrade_chain(model_cls, dict(checkpoint), "model_ckpt_version")
    return model_cls.load_checkpoint(checkpoint, context=context, device=device, **options)


def trainer_from_checkpoint(checkpoint_or_path, hypers: Dict[str, Any],
                            context: str = "restart"):
    """The trainer of a checkpoint (its epoch, optimizer state and best
    model), with ``hypers``."""
    from .architectures import import_architecture

    checkpoint = _checkpoint(checkpoint_or_path)
    trainer_cls = import_architecture(checkpoint["architecture_name"]).__trainer__
    checkpoint = upgrade_chain(trainer_cls, dict(checkpoint), "trainer_ckpt_version")
    return trainer_cls.load_checkpoint(checkpoint, hypers)


def _cache_dir() -> Path:
    import os

    root = os.environ.get("MTT_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "metatrain_tpu_torch"
    )
    path = Path(root)
    path.mkdir(parents=True, exist_ok=True)
    return path


def resolve_model_path(path, revision: Optional[str] = None, token: Optional[str] = None) -> str:
    """A local path for a path, a ``file://`` or ``http(s)://`` URL, or a
    HuggingFace Hub reference ``hf://<org>/<repo>/<filename>`` (revision
    ``main`` unless given); downloads go into the cache (``$MTT_CACHE_DIR``
    or ``~/.cache/metatrain_tpu_torch``). ``token`` (or ``$HF_TOKEN``) is sent as
    a Bearer header to huggingface.co."""
    import hashlib
    import os
    import urllib.request

    path = str(path)
    if path.startswith("hf://"):
        parts = path[len("hf://"):].split("/")
        if len(parts) < 3:
            raise ValueError("hf:// reference must be hf://<org>/<repo>/<filename>")
        repo_id, filename = "/".join(parts[:2]), "/".join(parts[2:])
        path = f"https://huggingface.co/{repo_id}/resolve/{revision or 'main'}/{filename}"
    if path.startswith("file://"):
        return path[len("file://"):]
    if not path.startswith(("http://", "https://")):
        return path

    digest = hashlib.sha256(path.encode()).hexdigest()[:16]
    target = _cache_dir() / f"{digest}_{Path(path).name}"
    if target.exists():
        return str(target)
    request = urllib.request.Request(path)
    token = token or os.environ.get("HF_TOKEN")
    if token and "huggingface.co" in path:
        request.add_header("Authorization", f"Bearer {token}")
    with urllib.request.urlopen(request) as response, open(target, "wb") as f:
        f.write(response.read())
    return str(target)


def load_model(path, context: str = "export", device="auto", **options):
    """A model from an exported ``.mtt`` envelope (either package's) or a
    checkpoint, from a path, URL or HF-Hub reference, on ``device`` (the
    card unless the caller asks otherwise); the network in float32 unless
    ``compute_dtype`` says otherwise."""
    data = load_checkpoint_file(resolve_model_path(path))
    if isinstance(data, dict) and data.get("exported"):
        data = data["checkpoint"]
    return model_from_checkpoint(data, context=context, device=device, **options)
