"""Host-side neighbor lists, emitted directly in the plain NEF layout.

Counterpart of ``metatrain_tpu/ops/neighbors.py`` (uncolored path). The
pair search runs in the port's C++ cell list (``native/neighbors.cpp``, the
port's own copy of the JAX package's source), compiled with g++ into
``metatrain_tpu_torch/_build/`` at first use and loaded with ctypes.
scipy's cKDTree finds the same pairs on the host when no compiler is
available. ``BACKENDS`` counts the pair searches by the backend that ran
them (``"native"`` or ``"kdtree"``).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import logging
import subprocess
from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from .._build import PACKAGE_DIR, build_library
from ..containers.system import NeighborData, System

logger = logging.getLogger(__name__)

NATIVE_SOURCE = PACKAGE_DIR / "native" / "neighbors.cpp"

BACKENDS: collections.Counter = collections.Counter()


@functools.cache
def _native_library() -> Optional[ctypes.CDLL]:
    if not NATIVE_SOURCE.exists():
        return None
    try:
        path = build_library(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(NATIVE_SOURCE)],
            [NATIVE_SOURCE],
            "libneighbors.so",
            timeout=300,
        )
    except (RuntimeError, subprocess.SubprocessError, OSError) as err:
        logger.warning("native neighbor library build failed: %s", err)
        return None
    lib = ctypes.CDLL(str(path))
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.neighbor_pairs_cell_list.restype = ctypes.c_longlong
    lib.neighbor_pairs_cell_list.argtypes = [
        f64, ctypes.c_longlong, f64, u8, ctypes.c_double, ctypes.c_longlong,
        i32, i32, i32,
    ]
    lib.pairs_to_nef_scatter.restype = ctypes.c_longlong
    lib.pairs_to_nef_scatter.argtypes = [
        i32, i32, i32, i64, i64, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, i32, i32, u8, i32,
    ]
    return lib


def _native_pairs(positions, cell, pbc, cutoff):
    lib = _native_library()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    cell = np.ascontiguousarray(cell, dtype=np.float64)
    pbc = np.ascontiguousarray(np.asarray(pbc), dtype=np.uint8)
    n = len(positions)
    capacity = max(256, n * 128)
    for _ in range(6):  # grow on overflow
        centers = np.empty(capacity, dtype=np.int32)
        neighbors = np.empty(capacity, dtype=np.int32)
        shifts = np.empty(3 * capacity, dtype=np.int32)
        count = lib.neighbor_pairs_cell_list(
            positions, n, cell, pbc, float(cutoff), capacity,
            centers, neighbors, shifts,
        )
        if count == -2:
            raise ValueError("degenerate cell for periodic neighbor search")
        if count >= 0:
            return (
                centers[:count].astype(np.int64),
                neighbors[:count].astype(np.int64),
                shifts[: 3 * count].reshape(-1, 3).astype(np.int64),
            )
        capacity *= 4
    raise RuntimeError("neighbor pair capacity growth failed")


def _required_shift_ranges(cell: np.ndarray, pbc: np.ndarray, cutoff: float) -> np.ndarray:
    """Number of periodic images needed per cell vector to cover ``cutoff``."""
    ranges = np.zeros(3, dtype=np.int64)
    if not pbc.any():
        return ranges
    cell_eff = np.array(cell, dtype=np.float64)
    for k in range(3):
        if not pbc[k] and np.linalg.norm(cell_eff[k]) == 0.0:
            normal = np.cross(cell_eff[(k + 1) % 3], cell_eff[(k + 2) % 3])
            norm = np.linalg.norm(normal)
            cell_eff[k] = normal / norm if norm > 0 else np.eye(3)[k]
    inv = np.linalg.inv(cell_eff)
    for k in range(3):
        if pbc[k]:
            ranges[k] = int(np.ceil(cutoff / (1.0 / np.linalg.norm(inv[:, k]))))
    return ranges


def _half_list_keep(centers, neighbors, shifts):
    """Reference half-list selection: ``i < j``, or ``i == j`` with the
    shift in the positive half-space."""
    return (centers < neighbors) | (
        (centers == neighbors)
        & (
            (shifts[:, 0] > 0)
            | ((shifts[:, 0] == 0) & (shifts[:, 1] > 0))
            | ((shifts[:, 0] == 0) & (shifts[:, 1] == 0) & (shifts[:, 2] > 0))
        )
    )


def neighbor_pairs(
    positions: np.ndarray,
    cell: np.ndarray,
    pbc: np.ndarray,
    cutoff: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each pair within ``cutoff`` once: ``(centers, neighbors, shifts)``
    with ``i < j``, or ``i == j`` and the shift in the positive half-space
    (see :func:`_half_list_keep`). Self-pairs with zero shift are excluded.
    """
    if len(positions):
        result = _native_pairs(positions, cell, pbc, cutoff)
        if result is not None:
            BACKENDS["native"] += 1
            keep = _half_list_keep(*result)
            return tuple(x[keep] for x in result)
    BACKENDS["kdtree"] += 1
    return _neighbor_pairs_kdtree(positions, cell, pbc, cutoff)


def _neighbor_pairs_kdtree(positions, cell, pbc, cutoff):
    """scipy cKDTree fallback (periodic image enumeration)."""
    positions = np.asarray(positions, dtype=np.float64)
    n = len(positions)
    empty = (
        np.zeros((0,), dtype=np.int64),
        np.zeros((0,), dtype=np.int64),
        np.zeros((0, 3), dtype=np.int64),
    )
    if n == 0:
        return empty
    pbc = np.asarray(pbc, dtype=bool)
    cell = np.asarray(cell, dtype=np.float64)
    ranges = _required_shift_ranges(cell, pbc, cutoff)
    shift_grid = np.stack(
        np.meshgrid(*[np.arange(-r, r + 1) for r in ranges], indexing="ij"), axis=-1
    ).reshape(-1, 3)

    tree = cKDTree(positions)
    centers_list, neighbors_list, shifts_list = [], [], []
    for shift in shift_grid:
        if (shift == 0).all():
            pairs = tree.query_pairs(cutoff, output_type="ndarray")
            if len(pairs):
                centers_list.append(pairs[:, 0])
                neighbors_list.append(pairs[:, 1])
                shifts_list.append(np.zeros((len(pairs), 3), dtype=np.int64))
            continue
        hits = tree.query_ball_tree(cKDTree(positions + shift.astype(np.float64) @ cell), cutoff)
        i_idx = np.repeat(np.arange(n, dtype=np.int64), [len(h) for h in hits])
        if len(i_idx) == 0:
            continue
        j_idx = np.concatenate([np.asarray(h, dtype=np.int64) for h in hits])
        positive_half = (
            (shift[0] > 0)
            | ((shift[0] == 0) & (shift[1] > 0))
            | ((shift[0] == 0) & (shift[1] == 0) & (shift[2] > 0))
        )
        keep = i_idx <= j_idx if positive_half else i_idx < j_idx
        i_idx, j_idx = i_idx[keep], j_idx[keep]
        if len(i_idx) == 0:
            continue
        centers_list.append(i_idx)
        neighbors_list.append(j_idx)
        shifts_list.append(np.tile(shift, (len(i_idx), 1)))

    if not centers_list:
        return empty
    return (
        np.concatenate(centers_list),
        np.concatenate(neighbors_list),
        np.concatenate(shifts_list),
    )


def pairs_to_nef(
    centers: np.ndarray,
    neighbors: np.ndarray,
    shifts: np.ndarray,
    n_atoms: int,
    reverse_of: np.ndarray,
) -> NeighborData:
    """Scatter a flat full pair list into padded NEF arrays, with the
    reversed-edge index: for edge ``(i, slot)`` holding neighbor ``j``
    with shift ``S``, ``reverse[i, slot]`` is the flat index of the edge
    ``(j, i, -S)``.

    :param reverse_of: per-edge index of the reversed partner in the same
        pair list (known by construction for a mirrored half list).
    """
    counts = np.bincount(centers, minlength=n_atoms).astype(np.int64)
    M = max(int(counts.max()) if n_atoms and len(centers) else 0, 1)

    lib = _native_library() if len(centers) else None
    if lib is not None:
        E = len(centers)
        indices = np.empty((n_atoms, M), dtype=np.int32)
        shift_out = np.empty((n_atoms, M, 3), dtype=np.int32)
        mask = np.empty((n_atoms, M), dtype=np.uint8)
        reverse = np.empty((n_atoms, M), dtype=np.int32)
        rc = lib.pairs_to_nef_scatter(
            np.ascontiguousarray(centers, dtype=np.int32),
            np.ascontiguousarray(neighbors, dtype=np.int32),
            np.ascontiguousarray(shifts, dtype=np.int32).reshape(-1),
            np.ascontiguousarray(reverse_of, dtype=np.int64),
            np.zeros(1, dtype=np.int64),
            0, E, n_atoms, M,
            indices, shift_out.reshape(-1), mask.reshape(-1), reverse,
        )
        if rc == -1:
            raise ValueError(f"max_neighbors={M} too small for the pair list")
        if rc == 0:
            return NeighborData(indices, shift_out, mask.astype(bool), reverse)

    order = np.argsort(centers, kind="stable")
    sorted_centers = centers[order]
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    slot = np.arange(len(centers), dtype=np.int64) - starts[sorted_centers]

    indices = np.tile(np.arange(n_atoms, dtype=np.int32)[:, None], (1, M))
    shift_arr = np.zeros((n_atoms, M, 3), dtype=np.int32)
    mask = np.zeros((n_atoms, M), dtype=bool)
    indices[sorted_centers, slot] = neighbors[order].astype(np.int32)
    shift_arr[sorted_centers, slot] = shifts[order].astype(np.int32)
    mask[sorted_centers, slot] = True

    edge_flat = np.empty(len(centers), dtype=np.int64)
    edge_flat[order] = sorted_centers * M + slot
    own_flat = (
        np.arange(n_atoms, dtype=np.int64)[:, None] * M
        + np.arange(M, dtype=np.int64)[None, :]
    )
    reverse = own_flat.copy()
    reverse[sorted_centers, slot] = edge_flat[reverse_of][order]
    return NeighborData(indices, shift_arr, mask, reverse.astype(np.int32))


def compute_neighbor_data(system: System, cutoff: float) -> NeighborData:
    """Full NEF neighbor data for one system at ``cutoff``: the full list
    mirrors the half list, so each edge's reversed partner is known by
    construction (k <-> k + H)."""
    c, n, sh = neighbor_pairs(system.positions, system.cell, system.pbc, cutoff)
    H = len(c)
    reverse_of = np.concatenate(
        [np.arange(H, 2 * H, dtype=np.int64), np.arange(H, dtype=np.int64)]
    )
    return pairs_to_nef(
        np.concatenate([c, n]),
        np.concatenate([n, c]),
        np.concatenate([sh, -sh]),
        len(system),
        reverse_of,
    )


@dataclasses.dataclass
class VerletNeighborList:
    """Neighbor list with skin-distance reuse for MD-rate force calls.

    Builds at ``cutoff + skin`` and reuses the list until an atom moved
    more than ``skin / 2`` since the last rebuild. The model's cutoff
    function zeroes the extra pairs in the skin shell.
    """

    cutoff: float
    skin: float = 0.5
    _data: Optional[NeighborData] = None
    _positions0: Optional[np.ndarray] = None
    _cell0: Optional[np.ndarray] = None

    def update(self, system: System) -> NeighborData:
        if self._data is not None and self._positions0 is not None:
            if len(self._positions0) == len(system) and np.allclose(self._cell0, system.cell):
                disp = np.linalg.norm(system.positions - self._positions0, axis=1)
                if disp.max(initial=0.0) < self.skin / 2.0:
                    return self._data
        self._data = compute_neighbor_data(system, self.cutoff + self.skin)
        self._positions0 = system.positions.copy()
        self._cell0 = system.cell.copy()
        return self._data
