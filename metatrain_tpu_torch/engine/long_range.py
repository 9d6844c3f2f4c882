"""Learned long-range electrostatic features.

Counterpart of ``metatrain_tpu/engine/long_range.py``: charges are
predicted from the short-range node features (``charges_map``), their
electrostatic potential comes from Ewald or PME (``ops/ewald.py``) for
periodic systems and from the direct smeared sum over the neighbor list
for the others (its pairs within the model's neighbor-list cutoff), and
the potential is projected back into feature space (``project_0``, SiLU,
``project_1``). Module names follow the flax scopes, so
``interop/jax_params.py`` carries the weights both ways.

The JAX package vmaps the periodic potential over the batch's systems;
the port passes the batch's cells and ``system_index`` to the potential,
which computes each atom against its own system. Dtypes as in JAX: the
charges are predicted in the compute dtype and cast to the positions'
dtype for the potentials; the potential is cast back to the compute
dtype before the projection.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..models.pet.modules import dense
from ..ops.ewald import (
    direct_potential_nonperiodic,
    ewald_potential_periodic,
    half_space_triples,
    pme_potential_periodic,
)


class LongRangeFeaturizer(nn.Module):
    """Charges -> Ewald / PME / direct potential -> feature projection.

    ``method="ewald"`` uses the dense k-space products over the static
    half space |n_i| <= ``n_kmax``; ``method="pme"`` the FFT-mesh solver on
    a ``mesh^3`` grid. ``cutoff`` is the model's neighbor-list cutoff: the
    direct sum of non-periodic systems takes the pairs within it.
    """

    def __init__(self, d_in: int, d_out: int, dtype, cutoff: float, smearing: float = 1.4,
                 n_kmax: int = 4, method: str = "ewald", mesh: int = 32):
        super().__init__()
        self.dtype, self.cutoff = dtype, float(cutoff)
        self.smearing, self.method, self.mesh = float(smearing), str(method), int(mesh)
        self.register_buffer("k_triples", torch.as_tensor(half_space_triples(int(n_kmax))),
                             persistent=False)
        self.charges_map = nn.Linear(d_in, 1)
        self.project_0 = nn.Linear(1, d_out)
        self.project_1 = nn.Linear(d_out, d_out)

    def forward(self, node_features: torch.Tensor, bd: Dict[str, Any]) -> torch.Tensor:
        cd = self.dtype
        positions, cells = bd["positions"], bd["cells"]
        atom_mask, system_index = bd["atom_mask"], bd["system_index"]
        charges = dense(self.charges_map, node_features, cd)[:, 0].to(positions.dtype)
        charges = torch.where(atom_mask, charges, 0.0)

        # padded and non-periodic systems have singular cells: the identity
        # keeps their (discarded) periodic potential finite
        eye = torch.eye(3, dtype=cells.dtype, device=cells.device)
        singular = torch.abs(torch.linalg.det(cells)) <= 1e-10
        safe_cells = torch.where(singular[:, None, None], eye, cells)
        if self.method == "pme":
            phi_periodic = pme_potential_periodic(
                positions, charges, safe_cells, atom_mask, self.smearing, mesh=self.mesh,
                system_index=system_index)
        else:
            phi_periodic = ewald_potential_periodic(
                positions, charges, safe_cells, self.k_triples, atom_mask, self.smearing,
                system_index=system_index)
        phi_direct = direct_potential_nonperiodic(
            bd["edge_distances"], bd["nbr_indices"], bd["nbr_reverse"], bd["nbr_mask"],
            charges, self.smearing, self.cutoff)

        is_periodic = bd["pbc"].all(dim=1)[system_index]
        phi = torch.where(is_periodic, phi_periodic, phi_direct)
        phi = torch.where(atom_mask, phi, 0.0).to(cd)
        hidden = F.silu(dense(self.project_0, (charges.to(cd) * phi)[:, None], cd))
        return dense(self.project_1, hidden, cd)
