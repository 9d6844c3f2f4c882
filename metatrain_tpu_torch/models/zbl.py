"""ZBL universal screened-Coulomb repulsion, an additive energy baseline.

Counterpart of ``metatrain_tpu/models/zbl.py``: the
Ziegler-Biersack-Littmark repulsion at short range,

    E_ij = (Z_i Z_j e^2 / 4 pi eps0 r) phi(r / a) fc(r),
    phi(x) = 0.18175 e^{-3.19980 x} + 0.50986 e^{-0.94229 x}
           + 0.28022 e^{-0.40290 x} + 0.02817 e^{-0.20162 x},
    a = 0.46850 / (Z_i^0.23 + Z_j^0.23)   [Angstrom],

with a cosine switch ``fc`` over the last ``cutoff_width`` of the cutoff.
The device forward runs on the NEF layout in the batch's geometry dtype
(float32 or float64, never the network's bfloat16) and is differentiable,
so forces and virial come through the autograd engine. The host side
(numpy, float64) removes the baseline from the targets at collate time.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..containers import SystemBatch, TensorBlock, TensorMap
from ..data.dataset import Sample
from ..data.target_info import DatasetInfo

# e^2 / (4 pi eps0) in eV * Angstrom
COULOMB_EV_ANGSTROM = 14.399645478425668

_PHI_COEFFS = (0.18175, 0.50986, 0.28022, 0.02817)
_PHI_EXPONENTS = (3.19980, 0.94229, 0.40290, 0.20162)


# the target gradients ZBL's removal subtracts -> predict_host's keys
_HOST_GRADIENTS = {"positions": "position_gradient", "strain": "strain_gradient"}


def _phi(x):
    total = 0.0
    for c, e in zip(_PHI_COEFFS, _PHI_EXPONENTS):
        total = total + c * torch.exp(-e * x)
    return total


def _phi_np(x):
    return sum(c * np.exp(-e * x) for c, e in zip(_PHI_COEFFS, _PHI_EXPONENTS))


def _cosine_switch(r, cutoff: float, width: float):
    scaled = (r - (cutoff - width)) / width
    return 0.5 * (1.0 + torch.cos(math.pi * torch.clamp(scaled, 0.0, 1.0)))


class ZBL:
    """Additive ZBL model for the per-structure energy targets.

    :param cutoff: smooth truncation radius (the model's neighbor cutoff).
    :param cutoff_width: width of the switch.
    """

    def __init__(self, dataset_info: DatasetInfo, cutoff: float, cutoff_width: float = 0.5):
        self.dataset_info = dataset_info
        self.cutoff = float(cutoff)
        self.cutoff_width = float(cutoff_width)
        self.target_names = [
            name for name, info in dataset_info.targets.items()
            if info.quantity == "energy" and info.is_scalar and not info.per_atom
        ]

    # -- device forward -------------------------------------------------------

    def atomic_energies(self, batch: SystemBatch) -> torch.Tensor:
        """Per-atom ZBL energies (A,): half of each atom's pair sum."""
        _, distances = batch.edge_vectors()
        z = batch.types.to(distances.dtype)
        z_i = z[:, None]
        z_j = z[batch.nbr_indices]
        a = 0.46850 / (z_i**0.23 + z_j**0.23)
        pair_e = (
            COULOMB_EV_ANGSTROM * z_i * z_j / torch.clamp_min(distances, 1e-6)
            * _phi(distances / a)
            * _cosine_switch(distances, self.cutoff, self.cutoff_width)
        )
        pair_e = torch.where(batch.nbr_mask, pair_e, 0.0)
        return 0.5 * torch.sum(pair_e, dim=1)

    def forward(self, batch: SystemBatch, outputs: Sequence[str],
                selected_atoms: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Per-system (S, 1) energies of the requested targets it applies to,
        in the geometry dtype: the atoms of ``selected_atoms`` (an (A,)
        mask) only, where it is given."""
        names = [name for name in outputs if name in self.target_names]
        if not names:
            return {}
        amask = batch.atom_mask if selected_atoms is None else batch.atom_mask & selected_atoms
        atom_e = torch.where(amask, self.atomic_energies(batch), 0.0)
        per_system = (batch.system_onehot(atom_e.dtype).T @ atom_e)[:, None]
        return {name: per_system for name in names}

    # -- host removal ---------------------------------------------------------

    def predict_host(self, system) -> Dict[str, np.ndarray]:
        """Per-system ZBL energy, its position gradient (N, 3) and its strain
        gradient (3, 3) (float64) for the removal. Each pair once (the half
        list), with its full energy. The strain gradient is dE/dstrain, the
        sign the readers store (the negative virial, or the stress times
        the volume): the sum over pairs of r_vec (x) dE/dr_vec."""
        from ..ops.neighbors import neighbor_pairs

        centers, neighbors, shifts = neighbor_pairs(
            system.positions, system.cell, system.pbc, self.cutoff)
        if len(centers) == 0:
            return {"energy": 0.0, "position_gradient": np.zeros((len(system), 3)),
                    "strain_gradient": np.zeros((3, 3))}
        r_vec = system.positions[neighbors] - system.positions[centers] + shifts @ system.cell
        r = np.linalg.norm(r_vec, axis=1)
        z = system.types.astype(np.float64)
        zi, zj = z[centers], z[neighbors]
        a = 0.46850 / (zi**0.23 + zj**0.23)
        x = r / a
        phi = _phi_np(x)
        scaled = (r - (self.cutoff - self.cutoff_width)) / self.cutoff_width
        fc = 0.5 * (1.0 + np.cos(np.pi * np.clip(scaled, 0.0, 1.0)))
        prefactor = COULOMB_EV_ANGSTROM * zi * zj
        energy = float((prefactor / r * phi * fc).sum())

        # dE/dr of each pair, analytic
        dphi = sum(-e * c * np.exp(-e * x) for c, e in zip(_PHI_COEFFS, _PHI_EXPONENTS)) / a
        in_switch = (scaled > 0) & (scaled < 1)
        dfc = np.where(
            in_switch,
            -0.5 * np.pi / self.cutoff_width * np.sin(np.pi * np.clip(scaled, 0, 1)),
            0.0,
        )
        de_dr = prefactor * ((-phi / r**2 + dphi / r) * fc + phi / r * dfc)
        de_dvec = de_dr[:, None] * r_vec / r[:, None]  # dE/dr_vec, r_vec = r_j - r_i + shift
        grad = np.zeros((len(system), 3))
        np.add.at(grad, centers, -de_dvec)
        np.add.at(grad, neighbors, de_dvec)
        return {"energy": energy, "position_gradient": grad,
                "strain_gradient": r_vec.T @ de_dvec}

    def remove_transform(self, samples: List[Sample]) -> List[Sample]:
        """Collate transform subtracting the ZBL energies, position
        gradients and strain gradients from the host targets."""
        out = []
        for sample in samples:
            prediction = self.predict_host(sample.system)
            new_targets = dict(sample.targets)
            for name in self.target_names:
                if name not in new_targets:
                    continue
                tmap = new_targets[name]
                block = tmap.block(0)
                new_block = TensorBlock(
                    np.asarray(block.values) - prediction["energy"],
                    block.samples, block.components, block.properties, block.mask,
                )
                for gname, grad in block.gradients():
                    if gname in _HOST_GRADIENTS:
                        removed = prediction[_HOST_GRADIENTS[gname]]
                        grad = TensorBlock(
                            np.asarray(grad.values) - removed.reshape(grad.values.shape[:-1] + (1,)),
                            grad.samples, grad.components, grad.properties, grad.mask,
                        )
                    new_block.add_gradient(gname, grad)
                new_targets[name] = TensorMap(tmap.keys, [new_block])
            out.append(Sample(sample.system, new_targets, sample.extra_data))
        return out
