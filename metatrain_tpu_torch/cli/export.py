"""``export``: a checkpoint as a standalone exported model (``.mtt``).

Counterpart of ``metatrain_tpu/cli/export.py``. The exported file is the
JAX package's envelope: the model checkpoint (the best weights where the
trainer tracked them) with capability metadata, ``exported: True`` and
``format_version: 1``, written through the numpy-only
``utils.io.save_checkpoint_file``, so a ``.mtt`` of either package loads
in the other (``utils.io.load_model``, ``calculator.Calculator``).

``compiled_force_call`` stays empty: the JAX package fills it with
StableHLO programs (``jax.export``) only when asked for buckets; the port
has no compiled force call yet (it would be ``torch.export`` of the
kernels as custom ops) and ignores the programs of a JAX envelope.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.io import (
    load_checkpoint_file,
    load_model,
    model_from_checkpoint,
    resolve_model_path,
    save_checkpoint_file,
)
from ..utils.logging import ROOT_LOGGER

logger = logging.getLogger(ROOT_LOGGER + ".export")


def export_model_object(model, trainer=None, output_path: str = "model.mtt",
                        metadata: Optional[Dict[str, Any]] = None) -> None:
    """Export a live model (the best weights if the trainer tracked them)."""
    checkpoint = model.get_checkpoint()
    if trainer is not None and getattr(trainer, "best_params", None) is not None:
        checkpoint["params"] = trainer.best_params
    envelope = {
        "exported": True,
        "format_version": 1,
        "checkpoint": checkpoint,
        "compiled_force_call": {},
        "metadata": {
            **(getattr(type(model), "__default_metadata__", {}) or {}),
            **(metadata or {}),
        },
        "capabilities": {
            "outputs": sorted(model.supported_outputs().keys()),
            "atomic_types": list(model.atomic_types),
            "interaction_range": model.requested_neighbor_cutoff(),
            "length_unit": model.dataset_info.length_unit,
        },
    }
    save_checkpoint_file(envelope, output_path)


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    else:
        yield tree


def export_model(checkpoint_path: str, output_path: str = "model.mtt",
                 metadata: Optional[Dict[str, Any]] = None, revision: Optional[str] = None,
                 hf_token: Optional[str] = None) -> None:
    """Export from a checkpoint file, URL or HF-Hub reference (upgraded to
    the code's version; its best weights where it has them). The model is
    rebuilt on the CPU, in float64 where the weights are float64, so the
    exported weights are the checkpoint's bit for bit."""
    from ..interop.jax_params import flax_to_state_dict

    checkpoint_path = resolve_model_path(checkpoint_path, revision=revision, token=hf_token)
    raw = load_checkpoint_file(checkpoint_path)
    best = raw.get("best_params")
    params = raw["params"] if best is None else best
    f64 = any(np.asarray(leaf).dtype == np.float64 for leaf in _leaves(params))
    model = model_from_checkpoint(raw, context="export", device="cpu",
                                  compute_dtype=torch.float64 if f64 else torch.float32)
    if best is not None:
        model.module.load_state_dict(flax_to_state_dict(best))
    export_model_object(model, None, output_path, metadata)
    logger.info("Exported %s -> %s", checkpoint_path, output_path)


def load_exported_model(path: str, device="auto", **options):
    """An exported ``.mtt`` model (or a plain checkpoint) on ``device``."""
    return load_model(path, context="export", device=device, **options)
