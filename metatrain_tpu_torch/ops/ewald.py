"""Ewald, particle-mesh Ewald and the direct sum for long-range electrostatics.

Counterpart of ``metatrain_tpu/ops/ewald.py``, on ``torch`` and
``torch.fft``. The JAX package evaluates each periodic potential for one
cell and vmaps it over the systems of a batch, masking the atoms of the
other systems; here each potential takes the batch's cells (S, 3, 3) and
``system_index`` and computes every atom against its own system only:
the same function, with the cos/sin, the spread and the gather once per
atom rather than once per system and atom. A single (3, 3) cell with no
``system_index`` is the JAX package's one-system call.

Conventions: Gaussian charge smearing ``sigma``; the potential at atom i
excludes its own self-interaction; units of e^2 / (4 pi eps0) = 1.
Everything is differentiable through positions and cells, so forces and
virial flow through the autograd engine.

PME spreads the charges with one ``index_add`` of the A x 64 spline
weights (the JAX package's 64 static scatter-adds in one), and reads the
mesh back with one gather whose adjoint is again an ``index_add``. On the
card both sum in atomic order, so PME's last bits can differ from run to
run; Ewald and the direct sum are products and row sums.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Tuple

import numpy as np
import torch


def kvectors_for_cell(cell: np.ndarray, kspace_cutoff: float) -> np.ndarray:
    """Integer reciprocal-lattice multiples with |k| <= cutoff (host).

    :param cell: (3, 3) row-vector cell.
    :param kspace_cutoff: reciprocal-space cutoff (1/length units).
    :return: (n_k, 3) integer triples (half-space, k and -k folded).
    """
    recip = 2 * np.pi * np.linalg.inv(cell).T
    b_norms = np.linalg.norm(recip, axis=1)
    n_max = np.maximum(np.ceil(kspace_cutoff / np.maximum(b_norms, 1e-10)), 1)
    triples = []
    for n1 in range(0, int(n_max[0]) + 1):
        r2 = range(-int(n_max[1]), int(n_max[1]) + 1)
        r3 = range(-int(n_max[2]), int(n_max[2]) + 1)
        for n2, n3 in itertools.product(r2, r3):
            if n1 == 0 and (n2 < 0 or (n2 == 0 and n3 <= 0)):
                continue  # half-space: use cos symmetry, skip k=0
            k = n1 * recip[0] + n2 * recip[1] + n3 * recip[2]
            if np.linalg.norm(k) <= kspace_cutoff:
                triples.append((n1, n2, n3))
    return np.asarray(triples, dtype=np.int32).reshape(-1, 3)


def half_space_triples(n_max: int) -> np.ndarray:
    """Every integer triple of the half space in the cube |n_i| <= n_max,
    k = 0 excluded (the long-range featurizer's static k set)."""
    triples = [
        (n1, n2, n3)
        for n1 in range(0, n_max + 1)
        for n2 in range(-n_max, n_max + 1)
        for n3 in range(-n_max, n_max + 1)
        if not (n1 == 0 and (n2 < 0 or (n2 == 0 and n3 <= 0)))
    ]
    return np.asarray(triples, dtype=np.int32)


def _per_system(cells: torch.Tensor, system_index: Optional[torch.Tensor], n_atoms: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(cells (S, 3, 3), system_index (A,), its (A, S) one-hot)``."""
    if cells.ndim == 2:
        cells = cells[None]
    if system_index is None:
        system_index = torch.zeros(n_atoms, dtype=torch.long, device=cells.device)
    system_index = system_index.long()
    onehot = torch.nn.functional.one_hot(system_index, cells.shape[0]).to(cells.dtype)
    return cells, system_index, onehot


def _own_system(per_system: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """(S, A, ...) -> (A, ...): each atom's row of its own system (a masked
    sum with one non-zero term, exact, with a product for adjoint)."""
    mask = onehot.T.reshape(onehot.T.shape + (1,) * (per_system.ndim - 2))
    return torch.sum(per_system * mask, dim=0)


def _inv(cells: torch.Tensor) -> torch.Tensor:
    """Inverse cells, with no device-to-host check of their rank (callers
    pass non-singular cells)."""
    return torch.linalg.inv_ex(cells)[0]


def _self_term(charges: torch.Tensor, smearing: float) -> torch.Tensor:
    return 2.0 * charges / (smearing * math.sqrt(2.0 * math.pi))


def ewald_potential_periodic(
    positions: torch.Tensor,  # (A, 3)
    charges: torch.Tensor,  # (A,)
    cells: torch.Tensor,  # (3, 3) or (S, 3, 3)
    k_triples: torch.Tensor,  # (n_k, 3) int
    atom_mask: torch.Tensor,  # (A,)
    smearing: float,
    system_index: Optional[torch.Tensor] = None,  # (A,), with (S, 3, 3) cells
) -> torch.Tensor:
    """Reciprocal-space Ewald potential at each atom, (A,):

    phi_i = (4 pi / V) sum_k exp(-sigma^2 k^2 / 2) / k^2
            * [cos(k.r_i) Re S(k) + sin(k.r_i) Im S(k)] * 2 (half space)
            - self term,

    S(k) summed over the masked atoms of i's own system.
    """
    cells, _, onehot = _per_system(cells, system_index, positions.shape[0])
    volume = torch.abs(torch.linalg.det(cells))  # (S,)
    recip = 2 * math.pi * _inv(cells).transpose(1, 2)  # (S, 3, 3)
    kvecs = k_triples.to(positions.dtype) @ recip  # (S, n_k, 3)
    k2 = torch.clamp_min(torch.sum(kvecs * kvecs, dim=2), 1e-10)
    weights = torch.exp(-0.5 * smearing**2 * k2) / k2  # (S, n_k)

    # (A, n_k) phases against the atom's own system's k-vectors
    phases = _own_system(positions @ kvecs.transpose(1, 2), onehot)
    cos_p, sin_p = torch.cos(phases), torch.sin(phases)
    masked_q = torch.where(atom_mask, charges, 0.0)
    re_s = onehot.T @ (cos_p * masked_q[:, None])  # (S, n_k)
    im_s = onehot.T @ (sin_p * masked_q[:, None])

    phi = (cos_p * (onehot @ (weights * re_s))).sum(1) + (
        sin_p * (onehot @ (weights * im_s))).sum(1)
    phi = phi * (onehot @ (4.0 * math.pi / volume)) * 2.0  # half-space doubling
    return torch.where(atom_mask, phi - _self_term(charges, smearing), 0.0)


def _bspline4(t):
    """Cardinal B-spline M4 weights at fractional offset t in [0, 1): the 4
    weights of mesh points floor(u) - 1 .. floor(u) + 2 (order-4 PME
    interpolation, Essmann et al. 1995)."""
    w0 = (1.0 - t) ** 3 / 6.0
    w1 = (4.0 - 6.0 * t * t + 3.0 * t**3) / 6.0
    w2 = (1.0 + 3.0 * t + 3.0 * t * t - 3.0 * t**3) / 6.0
    w3 = t**3 / 6.0
    return torch.stack([w0, w1, w2, w3], dim=-1)  # (..., 4)


def _bspline_deconvolution(n: int) -> np.ndarray:
    """|B(m)|^-2 deconvolution factors for order-4 cardinal B-splines on an
    n-point axis (host, exact): B(m) = sum_j M4(j+1) exp(2 pi i m j / n)."""
    m = np.arange(n)
    mvals = np.array([1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0])  # M4 at the nodes 1, 2, 3
    b = np.zeros(n, dtype=np.complex128)
    for j, val in enumerate(mvals):
        b += val * np.exp(2j * np.pi * m * j / n)
    mag2 = np.abs(b) ** 2
    # Nyquist-type modes where B ~ 0 carry no spline-representable signal
    return np.where(mag2 > 1e-10, 1.0 / np.maximum(mag2, 1e-10), 0.0)


def pme_potential_periodic(
    positions: torch.Tensor,  # (A, 3)
    charges: torch.Tensor,  # (A,)
    cells: torch.Tensor,  # (3, 3) or (S, 3, 3)
    atom_mask: torch.Tensor,  # (A,)
    smearing: float,
    mesh: int = 32,
    system_index: Optional[torch.Tensor] = None,  # (A,), with (S, 3, 3) cells
) -> torch.Tensor:
    """Smooth particle-mesh Ewald reciprocal potential, O(N + mesh^3 log):
    order-4 B-spline spreading onto one ``mesh^3`` grid per system, a 3-D
    FFT convolution with the smeared Coulomb influence function
    (B-spline-deconvolved), and B-spline back-interpolation, (A,)."""
    dtype = positions.dtype
    cells, sys_idx, onehot = _per_system(cells, system_index, positions.shape[0])
    S = cells.shape[0]
    volume = torch.abs(torch.linalg.det(cells))
    masked_q = torch.where(atom_mask, charges, 0.0)
    inv = _inv(cells)  # (S, 3, 3)

    # fractional coordinates in [0, 1) in the atom's own cell
    frac = _own_system(positions @ inv, onehot)
    frac = frac - torch.floor(frac)
    u = frac * mesh
    base = torch.floor(u).long()  # spline anchored at base-1 .. base+2
    t = u - base.to(dtype)
    w = _bspline4(t)  # (A, 3, 4)

    # the 64 mesh points of each atom: flat indices into (S * mesh^3) and
    # their weights, in the JAX package's product order
    offsets = torch.arange(4, device=positions.device) - 1
    ix, iy, iz = ((base[:, c, None] + offsets) % mesh for c in range(3))  # (A, 4) each
    flat = (((sys_idx[:, None, None, None] * mesh + ix[:, :, None, None]) * mesh
             + iy[:, None, :, None]) * mesh + iz[:, None, None, :]).reshape(-1)
    wxy = w[:, 0, :, None] * w[:, 1, None, :]  # (A, 4, 4)
    spread = (((w[:, 0] * masked_q[:, None])[:, :, None] * w[:, 1, None, :])[:, :, :, None]
              * w[:, 2, None, None, :]).reshape(-1)
    rho = torch.zeros(S * mesh**3, dtype=dtype, device=positions.device).index_add(
        0, flat, spread).view(S, mesh, mesh, mesh)

    # influence function on the half-complex grid (rfftn layout)
    recip = 2 * math.pi * inv.transpose(1, 2)  # (S, 3, 3), rows b1, b2, b3
    mx = torch.fft.fftfreq(mesh, dtype=dtype, device=positions.device) * mesh
    mz = torch.fft.rfftfreq(mesh, dtype=dtype, device=positions.device) * mesh
    kvec = (mx[None, :, None, None, None] * recip[:, None, None, None, 0]
            + mx[None, None, :, None, None] * recip[:, None, None, None, 1]
            + mz[None, None, None, :, None] * recip[:, None, None, None, 2])
    k2 = torch.sum(kvec * kvec, dim=-1)  # (S, mesh, mesh, mesh // 2 + 1)
    k2_safe = torch.clamp_min(k2, 1e-10)
    green = (4.0 * math.pi / volume)[:, None, None, None] * torch.exp(
        -0.5 * smearing**2 * k2_safe) / k2_safe
    green = torch.where(k2 > 1e-10, green, 0.0)  # zero the k = 0 (tinfoil) mode
    dec = torch.as_tensor(_bspline_deconvolution(mesh), dtype=dtype, device=positions.device)
    green = green * dec[:, None, None] * dec[None, :, None] * dec[None, None, : mesh // 2 + 1]

    rho_k = torch.fft.rfftn(rho, dim=(1, 2, 3))
    # mode sum, not the normalized inverse transform: scale by mesh^3
    phi_mesh = (torch.fft.irfftn(rho_k * green, s=(mesh, mesh, mesh), dim=(1, 2, 3))
                * mesh**3).to(dtype)

    # back-interpolate the potential to the atoms (one gather)
    weights = (wxy[:, :, :, None] * w[:, 2, None, None, :]).reshape(len(positions), 64)
    phi = torch.sum(weights * phi_mesh.reshape(-1)[flat].view(-1, 64), dim=1)
    return torch.where(atom_mask, phi - _self_term(charges, smearing), 0.0)


def direct_potential_nonperiodic(
    distances: torch.Tensor,  # (A, M) NEF distances
    nbr_indices: torch.Tensor,
    nbr_reverse: torch.Tensor,
    nbr_mask: torch.Tensor,
    charges: torch.Tensor,  # (A,)
    smearing: float,
    cutoff: float,
) -> torch.Tensor:
    """Smeared direct Coulomb sum over the listed pairs within ``cutoff``
    (the model's neighbor-list cutoff), (A,). Pairs beyond it are dropped,
    so a list that reaches further (a calculator's cutoff + skin) gives the
    sum a list at the cutoff gives. The neighbors' charges come through
    the gather-only ``nbr_gather``."""
    from .involution import nbr_gather

    q_j = nbr_gather(charges, nbr_indices, nbr_reverse)
    pair = q_j * torch.erf(distances / (smearing * math.sqrt(2.0))) / torch.clamp_min(
        distances, 1e-10)
    return torch.sum(torch.where(nbr_mask & (distances <= cutoff), pair, 0.0), dim=1)
