"""Collation: host samples -> padded batches on one device.

Counterpart of ``metatrain_tpu/data/collate.py`` on the plain NEF layout.
A :class:`Batch` is one padded :class:`SystemBatch` plus padded, masked
target TensorMaps, each tensor built once per batch on the collate
function's explicit device. The padding follows the JAX package's
buckets, so both packages see the same batch shapes.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..containers import (
    Labels,
    NeighborData,
    System,
    SystemBatch,
    TensorBlock,
    TensorMap,
    batch_from_systems,
    bucket_atoms,
    bucket_neighbors,
    bucket_size,
)
from ..ops.neighbors import compute_neighbor_data
from .dataset import Sample
from .target_info import TargetInfo


@dataclasses.dataclass
class Batch:
    """One training/eval batch on a device."""

    systems: SystemBatch
    targets: Dict[str, TensorMap]
    extra_data: Dict[str, TensorMap] = dataclasses.field(default_factory=dict)


class NeighborListCache:
    """Per-system neighbor-data cache keyed on object identity.

    Entries hold a weakref to their system: a hit requires the stored
    referent to still BE the queried object, so a recycled CPython id can
    never return another structure's neighbor lists, and dead entries are
    purged so the cache stays bounded by live systems."""

    def __init__(self, cutoff: float):
        self.cutoff = cutoff
        self._cache: Dict[int, tuple] = {}  # id -> (weakref, NeighborData)
        self._queries = 0

    def __call__(self, system: System) -> NeighborData:
        key = id(system)
        entry = self._cache.get(key)
        if entry is not None and entry[0]() is system:
            return entry[1]
        data = compute_neighbor_data(system, self.cutoff)
        self._cache[key] = (weakref.ref(system), data)
        self._queries += 1
        if self._queries % 256 == 0:  # amortized purge of dead entries
            self._cache = {k: v for k, v in self._cache.items() if v[0]() is not None}
        return data


class CollateFn:
    """Build :class:`Batch` objects from dataset samples.

    :param cutoff: neighbor-list cutoff (from the model's requested NL).
    :param target_infos: target name -> TargetInfo (drives batched layout).
    :param dtype: floating dtype of the batch tensors.
    :param device: the device every tensor of a batch is built on.
    :param bucket_ratio: geometric bucket growth factor.
    :param max_neighbors: optional fixed NEF width (otherwise bucketed).
    :param transforms: host-side batch transforms applied in order (O3
        augmentation, additive-baseline removal), each
        ``(samples) -> samples``.
    :param n_atoms_padded: optional fixed atom padding (otherwise bucketed).
    :param n_systems_padded: optional fixed system padding.
    """

    def __init__(
        self,
        cutoff: float,
        target_infos: Dict[str, TargetInfo],
        dtype=torch.float32,
        device=torch.device("cpu"),
        bucket_ratio: float = 1.25,
        max_neighbors: Optional[int] = None,
        transforms: Sequence[Callable[[List[Sample]], List[Sample]]] = (),
        n_atoms_padded: Optional[int] = None,
        n_systems_padded: Optional[int] = None,
    ):
        self.cutoff = cutoff
        self.target_infos = dict(target_infos)
        self.dtype = dtype
        self.device = torch.device(device)
        self.bucket_ratio = bucket_ratio
        self.max_neighbors = max_neighbors
        self.transforms = list(transforms)
        self.n_atoms_padded = n_atoms_padded
        self.n_systems_padded = n_systems_padded
        self.nl_cache = NeighborListCache(cutoff)

    def __call__(self, samples: List[Sample]) -> Batch:
        # neighbor lists come from the ORIGINAL systems (cache hits across
        # epochs); the transforms keep the neighbor topology (rotations and
        # target-space removals leave distances alone)
        neighbor_data = [self.nl_cache(s.system) for s in samples]
        for transform in self.transforms:
            samples = transform(samples)
        systems = [s.system for s in samples]

        total_atoms = sum(len(s) for s in systems)
        A = self.n_atoms_padded or bucket_atoms(total_atoms, self.bucket_ratio)
        S = self.n_systems_padded or bucket_size(len(systems) + 1, self.bucket_ratio, minimum=2)
        m_req = max((n.max_neighbors for n in neighbor_data), default=1)
        M = self.max_neighbors or bucket_neighbors(m_req, self.bucket_ratio)

        system_batch = batch_from_systems(
            systems, neighbor_data, self.device,
            n_atoms_padded=A, n_systems_padded=S, max_neighbors=M, dtype=self.dtype,
        )
        targets = {
            name: batch_targets([s.targets[name] for s in samples], systems, A, S,
                                self.dtype, self.device)
            for name in samples[0].targets
            if name in self.target_infos
        }
        extra = {
            name: batch_targets([s.extra_data[name] for s in samples], systems, A, S,
                                self.dtype, self.device)
            for name in samples[0].extra_data
        }
        return Batch(systems=system_batch, targets=targets, extra_data=extra)


def _batch_sample_labels(sample_kind: str, systems: Sequence[System], A: int, S: int) -> Labels:
    if sample_kind == "system":
        return Labels.range("system", S)
    values = np.zeros((A, 2), dtype=np.int32)
    values[:, 0] = S - 1  # padding rows point at the padded system slot
    offset = 0
    for sys_i, system in enumerate(systems):
        n = len(system)
        values[offset : offset + n, 0] = sys_i
        values[offset : offset + n, 1] = np.arange(n)
        offset += n
    return Labels(["system", "atom"], values)


def batch_targets(
    per_system: Sequence[TensorMap],
    systems: Sequence[System],
    A: int,
    S: int,
    dtype,
    device,
) -> TensorMap:
    """Pad and stack per-system target TensorMaps into one batch TensorMap.

    Per-structure blocks become ``(S, *components, P)`` with the system
    mask; per-atom blocks become ``(A, *components, P)`` with the atom
    mask. Scalar-target gradients follow: ``positions`` -> ``(A, 3, P)``,
    ``strain`` -> ``(S, 3, 3, P)``. Padding is zero with mask False.
    """
    template = per_system[0]
    n_systems = len(systems)
    atom_counts = [len(s) for s in systems]
    offsets = np.concatenate([[0], np.cumsum(atom_counts)]).astype(np.int64)

    atom_mask = np.zeros((A,), dtype=bool)
    atom_mask[: offsets[-1]] = True
    system_mask = np.zeros((S,), dtype=bool)
    system_mask[:n_systems] = True

    def dev(x, dt=None):
        return torch.as_tensor(x, dtype=dt, device=device)

    blocks = []
    for key_idx in range(len(template)):
        block_template = template.blocks()[key_idx]
        per_atom = "atom" in block_template.samples.names
        comp_shape = tuple(len(c) for c in block_template.components)
        n_props = len(block_template.properties)
        if per_atom:
            values = np.zeros((A,) + comp_shape + (n_props,), dtype=np.float64)
            for sys_i, tmap in enumerate(per_system):
                values[offsets[sys_i] : offsets[sys_i + 1]] = np.asarray(
                    tmap.blocks()[key_idx].values
                )
            mask = atom_mask
        else:
            values = np.zeros((S,) + comp_shape + (n_props,), dtype=np.float64)
            for sys_i, tmap in enumerate(per_system):
                values[sys_i] = np.asarray(tmap.blocks()[key_idx].values)[0]
            mask = system_mask

        batched = TensorBlock(
            values=dev(values, dtype),
            samples=_batch_sample_labels("atom" if per_atom else "system", systems, A, S),
            components=block_template.components,
            properties=block_template.properties,
            mask=dev(mask),
        )
        for grad_name in block_template.gradients_list():
            grad_template = block_template.gradient(grad_name)
            g_props = len(grad_template.properties)
            if grad_name == "positions":
                g_values = np.zeros((A, 3, g_props), dtype=np.float64)
                for sys_i, tmap in enumerate(per_system):
                    g = tmap.blocks()[key_idx].gradient(grad_name)
                    g_values[offsets[sys_i] : offsets[sys_i + 1]] = np.asarray(g.values)
                g_mask = atom_mask
                g_samples = _batch_sample_labels("atom", systems, A, S)
            elif grad_name == "strain":
                g_values = np.zeros((S, 3, 3, g_props), dtype=np.float64)
                for sys_i, tmap in enumerate(per_system):
                    g = tmap.blocks()[key_idx].gradient(grad_name)
                    g_values[sys_i] = np.asarray(g.values)[0]
                g_mask = system_mask
                g_samples = _batch_sample_labels("system", systems, A, S)
            else:
                raise ValueError(f"unsupported gradient '{grad_name}'")
            batched.add_gradient(
                grad_name,
                TensorBlock(
                    values=dev(g_values, dtype),
                    samples=g_samples,
                    components=grad_template.components,
                    properties=grad_template.properties,
                    mask=dev(g_mask),
                ),
            )
        blocks.append(batched)
    return TensorMap(template.keys, blocks)
