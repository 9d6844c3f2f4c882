"""O(3) data augmentation.

Counterpart of ``metatrain_tpu/engine/augmentation.py`` (a copy, numpy
only, drawing from the RNG in the same order, so the port's rotations are
the JAX package's). Applies a random rotation (optionally improper, i.e. with inversion) to
each system *and* its targets before collation, so architectures that are
not exactly equivariant (PET) learn the symmetry from data. Host-side
numpy transform in the collate pipeline, mirroring the reference design.

Transformation rules:
- positions/cells: ``x -> x @ R^T``;
- scalar targets: unchanged;
- Cartesian rank-1: ``v -> v @ R^T``; rank-2: ``T -> R T R^T``;
- spherical (o3_lambda, o3_sigma): not ported yet (the port trains
  energy targets);
- position gradients rotate as vectors; strain gradients as rank-2.
"""

from __future__ import annotations

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
    elif comp_names and comp_names[0] == ("o3_mu",):
        raise NotImplementedError("rotating spherical targets is not ported yet")
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
