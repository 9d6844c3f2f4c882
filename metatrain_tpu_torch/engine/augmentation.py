"""O(3) data augmentation.

Counterpart of ``metatrain_tpu/engine/augmentation.py`` (numpy only,
drawing from the RNG in the same order, so the port's rotations are the
JAX package's). Applies a random rotation (optionally improper, i.e. with
inversion) to each system *and* its targets before collation, so
architectures that are not exactly equivariant (PET) learn the symmetry
from data. Host-side numpy transform in the collate pipeline.

Transformation rules:
- positions/cells: ``x -> x @ R^T``; per-atom Cartesian-vector extras
  (``(N, 3)`` float arrays) co-rotate;
- scalar targets: unchanged;
- Cartesian rank-1: ``v -> v @ R^T``; rank-2: ``T -> R T R^T``;
- spherical (o3_lambda, o3_sigma): real Wigner-D matrices, times
  ``(-1)^lambda`` under inversion and once more ``-1`` for ``o3_sigma =
  -1``; the product form (``o3_mu_1`` x ``o3_mu_2``) takes one D per side;
- position gradients rotate as vectors; strain gradients as rank-2.

The Wigner D solves ``Y(R u) = D Y(u)`` by least squares on 64 directions
from ``default_rng(12345)``, as the JAX package does, with the port's own
real spherical harmonics (:func:`real_spherical_harmonics`, a recurrence
with the JAX package's phase and normalisation; it needs no SciPy).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List

import numpy as np

from ..containers import System, TensorBlock, TensorMap
from ..data.dataset import Sample


def random_rotation(rng: np.random.Generator, improper: bool = False) -> np.ndarray:
    """Haar-random rotation matrix, optionally with inversion."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    if improper:
        q = -q
    return q


def real_spherical_harmonics(unit_vectors: np.ndarray, l_max: int) -> List[np.ndarray]:
    """Real spherical harmonics (float64) of unit vectors (..., 3): one
    (..., 2l + 1) array per l <= ``l_max``, m = -l..l. Orthonormal on the
    sphere, without the Condon-Shortley phase in the real form: ``Y_l0 =
    N_l0 P_l(cos t)``, ``Y_lm = sqrt(2) N_lm P_l^m(cos t) cos(m p)`` and
    ``Y_l-m = sqrt(2) N_lm P_l^m(cos t) sin(m p)`` for m > 0, with
    ``N_lm = sqrt((2l + 1) / 4 pi (l - m)! / (l + m)!)`` and ``P_l^m`` the
    associated Legendre functions without that phase (the standard
    recurrences in l and m)."""
    x, y, z = unit_vectors[..., 0], unit_vectors[..., 1], unit_vectors[..., 2]
    cos_t = np.clip(z, -1.0, 1.0)
    sin_t = np.sqrt(np.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = np.arctan2(y, x)
    # legendre[l][m] = P_l^m(cos t), 0 <= m <= l
    legendre = [[None] * (l + 1) for l in range(l_max + 1)]
    for m in range(l_max + 1):
        p_mm = np.full_like(cos_t, float(np.prod(np.arange(1, 2 * m, 2)))) * sin_t**m
        legendre[m][m] = p_mm
        if m + 1 <= l_max:
            legendre[m + 1][m] = (2 * m + 1) * cos_t * p_mm
        for l in range(m + 2, l_max + 1):
            legendre[l][m] = ((2 * l - 1) * cos_t * legendre[l - 1][m]
                              - (l + m - 1) * legendre[l - 2][m]) / (l - m)
    out = []
    for l in range(l_max + 1):
        comps = []
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                             * math.factorial(l - am) / math.factorial(l + am))
            if m == 0:
                comps.append(norm * legendre[l][0])
            elif m > 0:
                comps.append(math.sqrt(2) * norm * legendre[l][am] * np.cos(am * phi))
            else:
                comps.append(math.sqrt(2) * norm * legendre[l][am] * np.sin(am * phi))
        out.append(np.stack(comps, axis=-1))
    return out


@functools.lru_cache(maxsize=1)
def _wigner_directions() -> np.ndarray:
    v = np.random.default_rng(12345).normal(size=(64, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def real_wigner_d(rotation: np.ndarray, o3_lambda: int) -> np.ndarray:
    """Real Wigner-D matrix D with ``Y_l(R u) = D @ Y_l(u)`` for the proper
    part of ``rotation``, times ``(-1)^l`` where ``rotation`` inverts;
    the least-squares solution on 64 directions (exact up to ~1e-12)."""
    v = _wigner_directions()
    det = np.linalg.det(rotation)
    proper = rotation * det  # the inversion is the parity below
    y_v = real_spherical_harmonics(v, o3_lambda)[o3_lambda]  # (K, 2l+1)
    y_rv = real_spherical_harmonics(v @ proper.T, o3_lambda)[o3_lambda]
    d, *_ = np.linalg.lstsq(y_v, y_rv, rcond=None)
    d = d.T  # Y(Rv) = D @ Y(v)
    if det < 0:
        d = d * (-1.0) ** o3_lambda
    return d


def _irrep_d(rotation: np.ndarray, o3_lambda: int, o3_sigma: int) -> np.ndarray:
    """The D of one (o3_lambda, o3_sigma) block: ``o3_sigma = -1`` flips
    the sign under inversion."""
    d = real_wigner_d(rotation, o3_lambda)
    return -d if o3_sigma == -1 and np.linalg.det(rotation) < 0 else d


def _transform_block(
    block: TensorBlock,
    rotation: np.ndarray,
    key_tuple,
    key_names,
) -> TensorBlock:
    values = np.asarray(block.values, dtype=np.float64)
    comp_names = [c.names for c in block.components]

    if len(comp_names) == 0:
        new_values = values
    elif comp_names == [("xyz",)]:
        new_values = np.einsum("ab,sbp->sap", rotation, values)
    elif len(comp_names) == 2 and comp_names[0][0].startswith("xyz"):
        new_values = np.einsum(
            "ab,sbcp,dc->sadp", rotation, values, rotation
        )
    elif comp_names == [("o3_mu",)]:
        key = dict(zip(key_names, key_tuple))
        d = _irrep_d(rotation, int(key["o3_lambda"]), int(key["o3_sigma"]))
        new_values = np.einsum("mn,snp->smp", d, values)
    elif comp_names == [("o3_mu_1",), ("o3_mu_2",)]:
        key = dict(zip(key_names, key_tuple))
        d1 = _irrep_d(rotation, int(key["o3_lambda_1"]), int(key["o3_sigma_1"]))
        d2 = _irrep_d(rotation, int(key["o3_lambda_2"]), int(key["o3_sigma_2"]))
        new_values = np.einsum("mn,snkp,lk->smlp", d1, values, d2)
    else:
        raise ValueError(f"cannot rotate block with components {comp_names}")

    new_block = TensorBlock(
        new_values,
        block.samples,
        block.components,
        block.properties,
        block.mask,
    )
    for gname, grad in block.gradients():
        g_values = np.asarray(grad.values, dtype=np.float64)
        if gname == "positions":
            g_new = np.einsum("ab,sbp->sap", rotation, g_values)
        elif gname == "strain":
            g_new = np.einsum("ab,sbcp,dc->sadp", rotation, g_values, rotation)
        else:
            raise ValueError(f"cannot rotate gradient '{gname}'")
        new_block.add_gradient(
            gname,
            TensorBlock(
                g_new, grad.samples, grad.components, grad.properties, grad.mask
            ),
        )
    return new_block


class O3Augmenter:
    """Random O(3) augmentation collate transform.

    :param seed: RNG seed (epoch-independent stream).
    :param inversion_only: restrict to {identity, inversion} -- used for
        architectures that are rotation- but not inversion-equivariant.
    :param skip_keys: target names to leave untouched (e.g. masks).
    """

    def __init__(
        self,
        seed: int = 0,
        inversion_only: bool = False,
        skip_keys: List[str] = (),
    ):
        self.rng = np.random.default_rng(seed)
        self.inversion_only = inversion_only
        self.skip_keys = set(skip_keys)

    def __call__(self, samples: List[Sample]) -> List[Sample]:
        out = []
        for sample in samples:
            if self.inversion_only:
                rotation = np.eye(3) * (
                    -1.0 if self.rng.random() < 0.5 else 1.0
                )
            else:
                rotation = random_rotation(
                    self.rng, improper=self.rng.random() < 0.5
                )
            system = sample.system
            # per-atom Cartesian-vector extras (e.g. FlashMD momenta,
            # consumed as model INPUTS) must co-rotate with the geometry;
            # scalars and non-vector data pass through
            new_extra = {}
            for key, value in system.extra.items():
                arr = np.asarray(value)
                if (
                    arr.ndim == 2
                    and arr.shape == (len(system), 3)
                    and np.issubdtype(arr.dtype, np.floating)
                ):
                    new_extra[key] = arr @ rotation.T
                else:
                    new_extra[key] = value
            new_system = System(
                positions=system.positions @ rotation.T,
                types=system.types,
                cell=system.cell @ rotation.T,
                pbc=system.pbc,
                extra=new_extra,
            )
            new_targets: Dict[str, TensorMap] = {}
            for name, tmap in sample.targets.items():
                if name in self.skip_keys or name.endswith("_mask"):
                    new_targets[name] = tmap
                    continue
                blocks = [
                    _transform_block(
                        block, rotation, key_tuple, tmap.keys.names
                    )
                    for key_tuple, block in tmap.items()
                ]
                new_targets[name] = TensorMap(tmap.keys, blocks)
            out.append(Sample(new_system, new_targets, sample.extra_data))
        return out
