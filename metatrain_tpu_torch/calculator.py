"""MD-engine calculator: the PET force call, once per MD step.

Counterpart of ``metatrain_tpu/calculator.py`` (``Calculator.compute``) on
the plain NEF layout:

- Verlet-skin neighbor-list reuse: the host cell list rebuilds only when
  an atom moved more than skin / 2;
- while the list is reused, the device batch is reused too and only the
  (A, 3) positions and the cells are uploaded;
- energy, forces and virial come from one forward and one backward pass.

Serving is inference: the calculator freezes the model's parameters
(``requires_grad=False``), so the kernels compute input gradients only.

Serving with the static W8A8 layers (the JAX package's
``MTT_INT8_STATIC=1``): build the model in bfloat16 with
``int8_static=True`` (``PET(..., compute_dtype=torch.bfloat16,
int8_static=True)`` or ``pet_from_checkpoint(..., int8_static=True)``),
call its ``calibrate_int8`` once on a representative batch (or carry a
JAX calibration over with ``interop.jax_params.int8_calib_from_jax``),
then hand it to :class:`Calculator`: its force calls run K1-W8A8 and
K2-W8A8.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .containers import System, batch_from_systems, bucket_atoms, bucket_neighbors
from .data.target_info import get_energy_target_info
from .engine.evaluate import evaluate_model
from .ops.neighbors import VerletNeighborList


class Calculator:
    """Serve force calls from a model.

    :param model: an ``AtomisticNNModel`` (e.g. ``models.pet.PET``).
    :param target: energy target name (default: the model's first output).
    :param skin: Verlet skin distance for neighbor-list reuse.
    :param bucket_ratio: geometric padding ratio of the atom/neighbor counts.
    :param dtype: dtype of positions and cells on the device.
    """

    def __init__(self, model, target: Optional[str] = None, skin: float = 0.5,
                 bucket_ratio: float = 1.1, dtype=torch.float32):
        self.model = model.requires_grad_(False)
        self.device = next(model.parameters()).device
        self.target = target or next(iter(model.supported_outputs()))
        self.cutoff = model.requested_neighbor_cutoff()
        self.skin = skin
        self.bucket_ratio = bucket_ratio
        self.dtype = dtype
        self._vnl = VerletNeighborList(self.cutoff, skin)
        self._last_nbr = None
        self._last_batch = None
        self._last_types = None
        self._infos = {
            (f, s): get_energy_target_info(
                "eV", add_position_gradients=f, add_strain_gradients=s
            )
            for f in (False, True) for s in (False, True)
        }

    def compute(self, system: System, forces: bool = True, stress: bool = False) -> Dict:
        """Energy (and forces, stress, virial) of one system.

        :return: ``energy`` (float), ``forces`` ((n, 3), eV/A), ``stress``
            ((3, 3), dE/dstrain / volume) and ``virial`` ((3, 3)) as
            requested.
        """
        n = len(system)
        nbr = self._vnl.update(system)
        if (
            nbr is self._last_nbr
            and self._last_batch is not None
            and np.array_equal(self._last_types, system.types)
        ):
            A = self._last_batch.n_atoms_padded
            pos = np.zeros((A, 3))
            pos[:n] = system.positions
            cells = np.zeros((self._last_batch.n_systems_padded, 3, 3))
            cells[0] = system.cell
            batch = self._last_batch.replace(
                positions=torch.as_tensor(pos, dtype=self.dtype, device=self.device),
                cells=torch.as_tensor(cells, dtype=self.dtype, device=self.device),
            )
        else:
            batch = batch_from_systems(
                [system], [nbr], self.device,
                n_atoms_padded=bucket_atoms(n, self.bucket_ratio),
                n_systems_padded=2,
                max_neighbors=bucket_neighbors(nbr.max_neighbors, self.bucket_ratio),
                dtype=self.dtype,
            )
        self._last_nbr, self._last_batch = nbr, batch
        self._last_types = np.asarray(system.types).copy()

        info = self._infos[(forces, stress)]
        preds = evaluate_model(self.model.forward_eval, batch, {self.target: info})
        block = preds[self.target].block(0)
        result: Dict = {"energy": float(block.values[0, 0].detach())}
        if forces:
            grad = block.gradient("positions").values[:n, :, 0]
            result["forces"] = -grad.detach().double().cpu().numpy()
        if stress:
            strain_grad = block.gradient("strain").values[0, :, :, 0].detach().double().cpu().numpy()
            volume = float(abs(np.linalg.det(system.cell)))
            result["stress"] = strain_grad / volume if volume > 0 else strain_grad
            result["virial"] = -strain_grad
        return result
