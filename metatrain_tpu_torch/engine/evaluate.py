"""The autograd engine: energies -> forces and strain-trick virial.

Counterpart of ``metatrain_tpu/engine/evaluate.py``. The model runs on
positions and cells deformed by a per-system ``strain = I``
(``positions @ strain[system]``, ``cells @ strain``); one
``torch.autograd.grad`` over ``(positions, strain)`` then gives dE/dr
(the negative forces) and dE/dstrain (the negative virial). Per-system
gathers go through the batch's one-hot matrix, so every adjoint is a
product or a gather, never a scatter with atomics.

Inference (``is_training=False``) builds no graph for the gradients and
expects parameters that do not require grad (``ops.inference``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..containers import Labels, SystemBatch, TensorBlock, TensorMap
from ..data.target_info import TargetInfo

_XYZ = Labels(["xyz"], np.arange(3, dtype=np.int32).reshape(-1, 1))
_STRAIN_COMPONENTS = (
    Labels(["xyz_1"], np.arange(3, dtype=np.int32).reshape(-1, 1)),
    Labels(["xyz_2"], np.arange(3, dtype=np.int32).reshape(-1, 1)),
)


def evaluate_model(
    forward_fn: Callable[[SystemBatch, List[str]], Dict[str, TensorMap]],
    batch: SystemBatch,
    target_infos: Dict[str, TargetInfo],
    is_training: bool = False,
    outputs: Optional[List[str]] = None,
) -> Dict[str, TensorMap]:
    """Run ``forward_fn(batch, names)`` and attach the requested
    ``positions`` gradients (A, 3, 1) and ``strain`` gradients
    (S, 3, 3, 1) to the targets that ask for them."""
    names = list(outputs) if outputs is not None else list(target_infos)
    needs_pos = [n for n in names if "positions" in target_infos[n].gradients]
    needs_strain = [n for n in names if "strain" in target_infos[n].gradients]
    grad_targets = sorted(set(needs_pos) | set(needs_strain))
    if not grad_targets:
        return forward_fn(batch, names)

    S = batch.n_systems_padded
    dtype = batch.positions.dtype
    positions = batch.positions.detach().requires_grad_(True)
    strain = torch.eye(3, dtype=dtype, device=batch.device).repeat(S, 1, 1).requires_grad_(True)
    with torch.enable_grad():
        atom_strain = torch.einsum("as,scd->acd", batch.system_onehot(dtype), strain)
        pos_s = torch.einsum("ac,acd->ad", positions, atom_strain)
        cells_s = torch.einsum("scd,sde->sce", batch.cells, strain)
        predictions = forward_fn(batch.replace(positions=pos_s, cells=cells_s), names)

    for i, name in enumerate(grad_targets):
        block = predictions[name].block(0)
        if block.values.shape[-1] != 1:
            raise NotImplementedError(
                f"target '{name}' has {block.values.shape[-1]} properties; "
                "multi-property gradients are not ported yet"
            )
        seed = torch.ones_like(block.values)
        if block.mask is not None:
            seed = torch.where(block.mask.reshape((-1,) + (1,) * (seed.ndim - 1)), seed, 0.0)
        d_pos, d_strain = torch.autograd.grad(
            block.values, (positions, strain), grad_outputs=seed,
            create_graph=is_training,
            retain_graph=is_training or i + 1 < len(grad_targets),
        )
        if name in needs_pos:
            block.add_gradient("positions", TensorBlock(
                values=d_pos[:, :, None],
                samples=Labels(["system", "atom"], torch.stack([
                    batch.system_index,
                    torch.arange(batch.n_atoms_padded, device=batch.device),
                ], dim=1)),
                components=(_XYZ,),
                properties=block.properties,
                mask=batch.atom_mask,
            ))
        if name in needs_strain:
            block.add_gradient("strain", TensorBlock(
                values=d_strain[:, :, :, None],
                samples=Labels.range("sample", S),
                components=_STRAIN_COMPONENTS,
                properties=block.properties,
                mask=batch.system_mask,
            ))
    return predictions
