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

A target of P > 1 properties (an LLPR ensemble) gets each property's
gradients from a backward pass of its own, seeded with that property
alone: P passes over one retained graph, where the JAX package pulls one
vmapped backward over the property basis. ``autograd.grad`` with
``is_grads_batched=True`` would vmap the backward, and the port's
``autograd.Function``s that launch the kernels through ctypes have no
vmap rule.
"""

from __future__ import annotations

import functools
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
    forward_fn: Callable[..., Dict[str, TensorMap]],
    batch: SystemBatch,
    target_infos: Dict[str, TargetInfo],
    is_training: bool = False,
    outputs: Optional[List[str]] = None,
    selected_atoms: Optional[torch.Tensor] = None,
) -> Dict[str, TensorMap]:
    """Run ``forward_fn(batch, names)`` and attach the requested
    ``positions`` gradients (A, 3, P) and ``strain`` gradients
    (S, 3, 3, P) to the targets that ask for them. ``outputs`` may name
    outputs beyond the targets (aux outputs such as ``features``): they
    get no gradients.

    :param selected_atoms: optional (A,) boolean mask restricting the
        outputs, and so their gradients, to a subset of the atoms (passed
        on to ``forward_fn``).
    """
    names = list(outputs) if outputs is not None else list(target_infos)
    if selected_atoms is not None:
        forward_fn = functools.partial(forward_fn, selected_atoms=selected_atoms)
    gradients = {n: target_infos[n].gradients if n in target_infos else [] for n in names}
    needs_pos = [n for n in names if "positions" in gradients[n]]
    needs_strain = [n for n in names if "strain" in gradients[n]]
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

    passes = [(name, p) for name in grad_targets
              for p in range(predictions[name].block(0).values.shape[-1])]
    d_pos: Dict[str, list] = {name: [] for name in grad_targets}
    d_strain: Dict[str, list] = {name: [] for name in grad_targets}
    for i, (name, p) in enumerate(passes):
        block = predictions[name].block(0)
        seed = torch.zeros_like(block.values)
        seed[..., p] = 1.0
        if block.mask is not None:
            seed = torch.where(block.mask.reshape((-1,) + (1,) * (seed.ndim - 1)), seed, 0.0)
        g_pos, g_strain = torch.autograd.grad(
            block.values, (positions, strain), grad_outputs=seed,
            create_graph=is_training,
            retain_graph=is_training or i + 1 < len(passes),
        )
        d_pos[name].append(g_pos)
        d_strain[name].append(g_strain)

    for name in grad_targets:
        block = predictions[name].block(0)
        if name in needs_pos:
            block.add_gradient("positions", TensorBlock(
                values=torch.stack(d_pos[name], dim=-1),
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
                values=torch.stack(d_strain[name], dim=-1),
                samples=Labels.range("sample", S),
                components=_STRAIN_COMPONENTS,
                properties=block.properties,
                mask=batch.system_mask,
            ))
    return predictions
