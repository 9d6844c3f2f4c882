"""Per-atom averaging of per-system targets and predictions.

Counterpart of ``metatrain_tpu/ops/segment.py`` (``divide_by_num_atoms``,
``average_by_num_atoms``) on torch tensors.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..containers import SystemBatch, TensorBlock, TensorMap


def _is_per_atom(block: TensorBlock) -> bool:
    return "atom" in block.samples.names or "first_atom" in block.samples.names


def _divided(block: TensorBlock, safe: torch.Tensor) -> TensorBlock:
    scale = safe.reshape((-1,) + (1,) * (block.values.ndim - 1)).to(block.values.dtype)
    return TensorBlock(block.values / scale, block.samples, block.components,
                       block.properties, block.mask)


def divide_by_num_atoms(tmap: TensorMap, num_atoms: torch.Tensor) -> TensorMap:
    """Divide per-system blocks (and their per-system gradients) by the
    number of atoms; per-atom blocks and gradients are untouched."""
    # the atom count goes through float32 first, as in the JAX package
    safe = torch.clamp(num_atoms, min=1).to(torch.float32)
    blocks = []
    for block in tmap.blocks():
        if _is_per_atom(block):
            blocks.append(block)
            continue
        new = _divided(block, safe)
        for name, grad in block.gradients():
            new.add_gradient(name, grad if _is_per_atom(grad) else _divided(grad, safe))
        blocks.append(new)
    return TensorMap(tmap.keys, blocks)


def average_by_num_atoms(
    tensor_map_dict: Dict[str, TensorMap],
    batch: SystemBatch,
    per_structure_keys: Sequence[str] = (),
) -> Dict[str, TensorMap]:
    """Average per-system quantities by atom count, skipping
    ``per_structure_keys``."""
    num_atoms = batch.n_atoms_per_system
    return {
        key: tmap if key in per_structure_keys else divide_by_num_atoms(tmap, num_atoms)
        for key, tmap in tensor_map_dict.items()
    }
