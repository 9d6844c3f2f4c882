"""MD-engine calculator: the PET force call, once per MD step.

Counterpart of ``metatrain_tpu/calculator.py`` on the plain NEF layout
(the colored layout is not ported):

- a model object, or an exported ``.mtt`` / checkpoint loaded onto the
  card (``utils.io.load_model``; ``device="cpu"`` to run on the CPU);
- Verlet-skin neighbor-list reuse: the host cell list rebuilds only when
  an atom moved more than skin / 2;
- while the list is reused, the device batch is reused too and only the
  (A, 3) positions and the cells are uploaded;
- energy, forces and virial come from one forward and one backward pass
  (``_force_call``, on the device), shared by :meth:`Calculator.compute`
  and the velocity-Verlet driver :meth:`Calculator.run_md_nve`, which
  keeps positions, velocities and accelerations on the device.

Serving is inference: the calculator freezes the model's parameters
(``requires_grad=False``), so the kernels compute input gradients only.

PET's physics options serve unchanged (ZBL, long range, adaptive
cutoffs). The calculator ships no per-system extra data, as the JAX
calculator does: a PET with ``system_conditioning`` serves a neutral
singlet (charge 0, spin multiplicity 1). For another charge or spin,
evaluate a batch built with ``batch_from_systems(..., extra_keys=
model.requested_extra_system_keys())`` through ``evaluate_model``.

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

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .containers import System, SystemBatch, batch_from_systems, bucket_atoms, bucket_neighbors
from .data.target_info import get_energy_target_info
from .engine.evaluate import evaluate_model
from .ops.neighbors import VerletNeighborList


class Calculator:
    """Serve force calls from a model.

    :param model: an ``AtomisticNNModel`` (e.g. ``models.pet.PET``), or the
        path or URL of an exported ``.mtt`` model or a checkpoint.
    :param target: energy target name (default: the model's first output).
    :param skin: Verlet skin distance for neighbor-list reuse.
    :param bucket_ratio: geometric padding ratio of the atom/neighbor counts.
    :param dtype: dtype of positions and cells on the device.
    :param device: where a model given by path runs: ``"auto"`` (the
        first card; an error without one), ``"cuda:N"`` or ``"cpu"``. A
        model object stays where it is.
    """

    def __init__(self, model, target: Optional[str] = None, skin: float = 0.5,
                 bucket_ratio: float = 1.1, dtype=torch.float32, device="auto"):
        if isinstance(model, (str, Path)):
            from .utils.io import load_model

            model = load_model(model, context="export", device=device)
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

    def _force_call(self, batch: SystemBatch, forces: bool, stress: bool) -> Dict[str, torch.Tensor]:
        """The force call on the device: the energy of the batch's first
        system, dE/dr (A, 3) and dE/dstrain (3, 3) as requested. Builds no
        graph that outlives the call."""
        info = self._infos[(forces, stress)]
        preds = evaluate_model(self.model.forward_eval, batch, {self.target: info})
        block = preds[self.target].block(0)
        out = {"energy": block.values[0, 0].detach()}
        if forces:
            out["position_gradient"] = block.gradient("positions").values[:, :, 0]
        if stress:
            out["strain_gradient"] = block.gradient("strain").values[0, :, :, 0]
        return out

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

        out = self._force_call(batch, forces, stress)
        result: Dict = {"energy": float(out["energy"])}
        if forces:
            grad = out["position_gradient"][:n]
            result["forces"] = -grad.double().cpu().numpy()
        if stress:
            strain_grad = out["strain_gradient"].double().cpu().numpy()
            volume = float(abs(np.linalg.det(system.cell)))
            result["stress"] = strain_grad / volume if volume > 0 else strain_grad
            result["virial"] = -strain_grad
        return result

    def run_md_nve(self, system: System, masses: np.ndarray, timestep: float, n_steps: int,
                   check_interval: int = 10) -> System:
        """Velocity-Verlet NVE from rest (units: eV, A, amu; ``timestep`` in
        ASE time units); returns the final system.

        Positions, velocities and accelerations stay on the device in
        float32; each step takes its forces from one forward and one
        ``autograd.grad``. The steps run in chunks of ``check_interval``
        with no host round trip but one scalar per chunk: the largest
        displacement since the last list build. Past skin / 2 the host
        rebuilds the list (the slot count M grows by the buckets where the
        new list needs it). Padding atoms have mass 1 and are masked.
        """
        n = len(system)
        nbr = self._vnl.update(system)
        A = bucket_atoms(n, self.bucket_ratio)
        M = bucket_neighbors(nbr.max_neighbors, self.bucket_ratio)

        def make_batch(current, nbr_now):
            return batch_from_systems([current], [nbr_now], self.device, n_atoms_padded=A,
                                      n_systems_padded=2, max_neighbors=M, dtype=self.dtype)

        def padded(host_positions):
            pos = torch.zeros((A, 3), dtype=torch.float32, device=self.device)
            pos[:n] = torch.as_tensor(host_positions, dtype=torch.float32, device=self.device)
            return pos

        batch = make_batch(system, nbr)
        mass = torch.ones((A,), dtype=torch.float32, device=self.device)
        mass[:n] = torch.as_tensor(np.asarray(masses), dtype=torch.float32, device=self.device)
        mask = batch.atom_mask

        def accelerations(pos):
            grad = self._force_call(batch.replace(positions=pos.to(self.dtype)), True, False)
            forces = -grad["position_gradient"].float()
            return torch.where(mask[:, None], forces / mass[:, None], 0.0)

        pos = padded(system.positions)
        vel = torch.zeros_like(pos)
        acc = accelerations(pos)
        ref = pos
        done = 0
        while done < n_steps:
            k = min(check_interval, n_steps - done)
            for _ in range(k):
                pos = pos + vel * timestep + 0.5 * acc * timestep**2
                new_acc = accelerations(pos)
                vel = vel + 0.5 * (acc + new_acc) * timestep
                acc = new_acc
            done += k
            disp = torch.where(mask, torch.linalg.norm(pos - ref, dim=1), 0.0).max()
            if float(disp) > self.skin / 2.0:  # one scalar to the host per chunk
                host_pos = pos[:n].double().cpu().numpy()
                current = System(host_pos, system.types, system.cell, system.pbc)
                nbr = self._vnl.update(current)
                if nbr.max_neighbors > M - 1:
                    M = bucket_neighbors(nbr.max_neighbors, self.bucket_ratio)
                batch = make_batch(current, nbr)
                pos = ref = padded(host_pos)

        final = pos[:n].double().cpu().numpy()
        return System(final, system.types, system.cell, system.pbc)
