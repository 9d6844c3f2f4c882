"""Structural checks of a batch before evaluation (``eval --check-consistency``).

Counterpart of ``metatrain_tpu/utils/consistency.py`` on the port's
``SystemBatch``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..containers import SystemBatch


class ConsistencyError(RuntimeError):
    pass


def check_batch_consistency(batch: SystemBatch, cutoff: float) -> None:
    """Raise :class:`ConsistencyError` on a malformed batch.

    Checks: finite positions and cells; padded atoms in a padded system
    slot and real atoms in a real one; neighbor indices in range; real
    neighbor distances within the cutoff (+10 % for the Verlet skin); the
    reversed-edge map an involution.
    """
    def get(x):
        return x.detach().cpu().numpy()

    problems: List[str] = []
    positions = get(batch.positions.float())
    atom_mask = get(batch.atom_mask)
    system_mask = get(batch.system_mask)
    system_index = get(batch.system_index)
    nbr_idx = get(batch.nbr_indices)
    nbr_mask = get(batch.nbr_mask)
    reverse = get(batch.nbr_reverse)

    if not np.isfinite(positions[atom_mask]).all():
        problems.append("non-finite positions on real atoms")
    if not np.isfinite(get(batch.cells.float())[system_mask]).all():
        problems.append("non-finite cells on real systems")

    padded_atoms = ~atom_mask
    if padded_atoms.any() and system_mask[system_index[padded_atoms]].any():
        problems.append("padded atoms assigned to a real system slot")
    if atom_mask.any() and not system_mask[system_index[atom_mask]].all():
        problems.append("real atoms assigned to a padded system slot")

    A = batch.n_atoms_padded
    if nbr_idx.min(initial=0) < 0 or nbr_idx.max(initial=0) >= A:
        problems.append("neighbor indices out of range")

    _, distances = batch.edge_vectors()
    distances = get(distances.float())
    real = nbr_mask & atom_mask[:, None]
    if real.any() and distances[real].max() > 1.1 * cutoff:
        problems.append(
            f"neighbor distance {distances[real].max():.3f} exceeds "
            f"cutoff {cutoff} (+10% skin slack)"
        )

    M = batch.max_neighbors
    flat_rev = reverse.reshape(-1)
    if (flat_rev < 0).any() or (flat_rev >= A * M).any():
        problems.append("reversed-edge indices out of range")
    else:
        double = flat_rev[flat_rev].reshape(A, M)
        own = np.arange(A * M).reshape(A, M)
        if not (double[nbr_mask] == own[nbr_mask]).all():
            problems.append("reversed-edge map is not an involution")

    if problems:
        raise ConsistencyError("batch consistency check failed: " + "; ".join(problems))
