"""Atomic systems: host records and padded device batches (NEF layout).

PyTorch counterpart of ``metatrain_tpu/containers/system.py``. The host
side (``System``, ``NeighborData``, the bucketing rules) is numpy; the
device side is :class:`SystemBatch`, a struct of torch tensors on one
explicit device. Only the plain NEF layout exists here: every atom owns
``M`` neighbor slots, ``M`` is a multiple of 16, and the last slot is
always masked (the fused transformer layer stores the center token there).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class System:
    """A single atomic configuration on the host.

    :param positions: ``(n_atoms, 3)`` float64 Cartesian positions.
    :param types: ``(n_atoms,)`` integer atomic numbers.
    :param cell: ``(3, 3)`` float64 cell matrix (rows are cell vectors);
        zero rows for non-periodic directions.
    :param pbc: ``(3,)`` booleans, one per cell vector.
    :param extra: named per-system data read with the system (the info
        fields and extra per-atom columns of an extended-xyz frame).
    """

    positions: np.ndarray
    types: np.ndarray
    cell: np.ndarray
    pbc: np.ndarray
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.positions = np.ascontiguousarray(self.positions, dtype=np.float64)
        self.types = np.ascontiguousarray(self.types, dtype=np.int32)
        self.cell = np.ascontiguousarray(self.cell, dtype=np.float64)
        self.pbc = np.ascontiguousarray(self.pbc, dtype=bool)
        if self.positions.ndim != 2 or self.positions.shape[1] != 3:
            raise ValueError(f"positions must be (n, 3), got {self.positions.shape}")
        if self.cell.shape != (3, 3):
            raise ValueError(f"cell must be (3, 3), got {self.cell.shape}")
        if len(self.types) != len(self.positions):
            raise ValueError("types and positions disagree on the number of atoms")

    def __len__(self) -> int:
        return len(self.positions)


@dataclasses.dataclass
class NeighborData:
    """Host-side NEF neighbor data for one system (see ``ops.neighbors``)."""

    indices: np.ndarray  # (n_atoms, max_nbrs) int32, padding -> own atom index
    shifts: np.ndarray  # (n_atoms, max_nbrs, 3) int32 cell shifts
    mask: np.ndarray  # (n_atoms, max_nbrs) bool
    reverse: np.ndarray  # (n_atoms, max_nbrs) int32 flat index of the j->i edge

    @property
    def max_neighbors(self) -> int:
        return int(self.indices.shape[1])


def _round_up(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple


def bucket_size(value: int, ratio: float = 1.25, minimum: int = 8) -> int:
    """Geometric bucketing: smallest ``minimum * ratio**k`` >= value."""
    if value <= minimum:
        return minimum
    size = float(minimum)
    while size < value:
        size = max(size * ratio, size + 1)
    return int(np.ceil(size))


def bucket_atoms(value: int, ratio: float = 1.25) -> int:
    """Geometric bucket for the padded atom count, a multiple of 128."""
    return _round_up(bucket_size(value, ratio, minimum=128), 128)


def bucket_neighbors(value: int, ratio: float = 1.25) -> int:
    """Geometric bucket for the NEF width M: a multiple of 16, strictly
    greater than ``value`` (the last slot is reserved for the center)."""
    m = bucket_size(max(value, 1), ratio, minimum=7)
    return _round_up(m + 1, 16)


@dataclasses.dataclass
class SystemBatch:
    """A fixed-shape padded batch of systems on one device.

    Shapes (A = padded atoms, S = padded systems, M = neighbor slots):
    ``positions`` (A, 3) float, ``types`` (A,) int32, ``atom_mask`` (A,)
    bool, ``system_index`` (A,) int64 (padding -> S - 1), ``cells``
    (S, 3, 3) float, ``pbc`` (S, 3) bool, ``system_mask`` (S,) bool,
    ``nbr_indices`` (A, M) int64 (padding -> the center atom),
    ``nbr_shifts`` (A, M, 3) int32, ``nbr_mask`` (A, M) bool,
    ``nbr_reverse`` (A, M) int64 flat index into A*M of the reversed edge
    (padding -> the slot itself).
    """

    positions: torch.Tensor
    types: torch.Tensor
    atom_mask: torch.Tensor
    system_index: torch.Tensor
    cells: torch.Tensor
    pbc: torch.Tensor
    system_mask: torch.Tensor
    nbr_indices: torch.Tensor
    nbr_shifts: torch.Tensor
    nbr_mask: torch.Tensor
    nbr_reverse: torch.Tensor

    def replace(self, **updates) -> "SystemBatch":
        return dataclasses.replace(self, **updates)

    @property
    def device(self) -> torch.device:
        return self.positions.device

    @property
    def n_atoms_padded(self) -> int:
        return int(self.positions.shape[0])

    @property
    def n_systems_padded(self) -> int:
        return int(self.cells.shape[0])

    @property
    def max_neighbors(self) -> int:
        return int(self.nbr_indices.shape[1])

    @property
    def n_atoms_per_system(self) -> torch.Tensor:
        """(S,) int64 count of real atoms in each system slot."""
        return torch.bincount(self.system_index[self.atom_mask], minlength=self.n_systems_padded)

    def system_onehot(self, dtype) -> torch.Tensor:
        """(A, S) one-hot of ``system_index``. Per-system gathers and sums
        go through this matrix so that their adjoints are products, not
        scatter-adds with atomics."""
        S = self.n_systems_padded
        return torch.nn.functional.one_hot(self.system_index, S).to(dtype)

    def edge_vectors(
        self,
        positions: Optional[torch.Tensor] = None,
        cells: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Edge vectors (A, M, 3) and distances (A, M) in NEF layout.

        Masked slots have zero vectors and distance ~0. The shift-cell
        product is an exact elementwise sum (no matrix unit that could
        round to TF32).
        """
        from ..ops.involution import nbr_gather

        pos = self.positions if positions is None else positions
        cell = self.cells if cells is None else cells
        atom_cells = torch.einsum(
            "as,scd->acd", self.system_onehot(pos.dtype), cell
        )
        shifts = self.nbr_shifts.to(pos.dtype)
        shift_contrib = (
            shifts[:, :, 0:1] * atom_cells[:, None, 0, :]
            + shifts[:, :, 1:2] * atom_cells[:, None, 1, :]
            + shifts[:, :, 2:3] * atom_cells[:, None, 2, :]
        )
        vectors = (
            nbr_gather(pos, self.nbr_indices, self.nbr_reverse)
            - pos[:, None, :]
            + shift_contrib
        )
        vectors = torch.where(self.nbr_mask[:, :, None], vectors, 0.0)
        distances = torch.sqrt(torch.sum(vectors * vectors, dim=-1) + 1e-15)
        return vectors, distances


def batch_from_systems(
    systems: Sequence[System],
    neighbors: Sequence[NeighborData],
    device: torch.device,
    n_atoms_padded: Optional[int] = None,
    n_systems_padded: Optional[int] = None,
    max_neighbors: Optional[int] = None,
    dtype=torch.float32,
    bucket_ratio: float = 1.25,
) -> SystemBatch:
    """Assemble host systems and NEF neighbor data into one padded batch
    on ``device``. Padded atoms point at a padded system slot; padded
    neighbor slots self-reference so every gather stays in bounds."""
    n_systems = len(systems)
    if n_systems == 0:
        raise ValueError("cannot batch zero systems")
    if len(neighbors) != n_systems:
        raise ValueError("need one NeighborData per system")

    total_atoms = sum(len(s) for s in systems)
    m_required = max((n.max_neighbors for n in neighbors), default=1)

    A = n_atoms_padded or bucket_atoms(total_atoms, bucket_ratio)
    S = n_systems_padded or bucket_size(n_systems + 1, bucket_ratio, minimum=2)
    M = max_neighbors or bucket_neighbors(m_required, bucket_ratio)
    if A < total_atoms:
        raise ValueError(f"n_atoms_padded={A} < total atoms {total_atoms}")
    if S < n_systems + 1:
        raise ValueError(f"n_systems_padded={S} too small for {n_systems} systems")
    if M < m_required + 1:
        raise ValueError(
            f"max_neighbors={M} must exceed the largest real neighbor "
            f"count {m_required} (the last NEF slot is reserved)"
        )
    if M % 16:
        raise ValueError(f"max_neighbors={M} must be a multiple of 16")

    positions = np.zeros((A, 3), dtype=np.float64)
    types = np.zeros((A,), dtype=np.int32)
    atom_mask = np.zeros((A,), dtype=bool)
    system_index = np.full((A,), S - 1, dtype=np.int64)
    cells = np.zeros((S, 3, 3), dtype=np.float64)
    pbc = np.zeros((S, 3), dtype=bool)
    system_mask = np.zeros((S,), dtype=bool)

    nbr_indices = np.tile(np.arange(A, dtype=np.int64)[:, None], (1, M))
    nbr_shifts = np.zeros((A, M, 3), dtype=np.int32)
    nbr_mask = np.zeros((A, M), dtype=bool)
    nbr_reverse = (
        np.arange(A, dtype=np.int64)[:, None] * M
        + np.arange(M, dtype=np.int64)[None, :]
    )

    offset = 0
    for sys_i, (system, nbr) in enumerate(zip(systems, neighbors)):
        n = len(system)
        m = nbr.max_neighbors
        sl = slice(offset, offset + n)
        positions[sl] = system.positions
        types[sl] = system.types
        atom_mask[sl] = True
        system_index[sl] = sys_i
        cells[sys_i] = system.cell
        pbc[sys_i] = system.pbc
        system_mask[sys_i] = True

        local_idx = np.where(
            nbr.mask, nbr.indices, np.arange(n, dtype=np.int32)[:, None]
        )
        nbr_indices[sl, :m] = local_idx + offset
        nbr_shifts[sl, :m, :] = np.where(nbr.mask[..., None], nbr.shifts, 0)
        nbr_mask[sl, :m] = nbr.mask
        rev_atom = nbr.reverse.astype(np.int64) // m
        rev_slot = nbr.reverse.astype(np.int64) % m
        remapped = (rev_atom + offset) * M + rev_slot
        own_flat = (
            (np.arange(n, dtype=np.int64)[:, None] + offset) * M
            + np.arange(m, dtype=np.int64)[None, :]
        )
        nbr_reverse[sl, :m] = np.where(nbr.mask, remapped, own_flat)
        offset += n

    def dev(x, dt=None):
        return torch.as_tensor(x, dtype=dt, device=device)

    return SystemBatch(
        positions=dev(positions, dtype),
        types=dev(types),
        atom_mask=dev(atom_mask),
        system_index=dev(system_index),
        cells=dev(cells, dtype),
        pbc=dev(pbc),
        system_mask=dev(system_mask),
        nbr_indices=dev(nbr_indices),
        nbr_shifts=dev(nbr_shifts),
        nbr_mask=dev(nbr_mask),
        nbr_reverse=dev(nbr_reverse),
    )
