"""Composition baseline: per-species least-squares ``y = sum_i w[z_i]``.

Counterpart of ``metatrain_tpu/models/composition.py``. It applies to the
invariant scalar targets (``_is_valid_target``): scalars, per structure or
per atom, with any number of properties, and spherical targets whose only
block is the (0, 1) irrep; Cartesian, other spherical and atomic-basis
targets get no baseline. Fitting accumulates the normal equations
``X^T X`` / ``X^T Y`` over the dataset on the host in float64 and solves
them (the same arithmetic as the JAX package; a per-atom target makes each
atom one sample); during training the baseline is removed from the host
targets (a collate transform) and at evaluation it is added back on the
device. As in the JAX package, the device weights are float32 and the
per-system sum is taken in float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..containers import SystemBatch, TensorBlock, TensorMap
from ..data.dataset import Sample, dataset_target_names, iter_samples
from ..data.target_info import DatasetInfo, TargetInfo

FixedWeights = Dict[str, Union[float, Dict[int, float]]]


def _is_valid_target(info: TargetInfo) -> bool:
    """Invariant scalars: scalar targets, or spherical targets whose only
    block is the (0, 1) irrep; never an atomic-basis target."""
    if info.is_atomic_basis:
        return False
    if info.is_scalar:
        return True
    if info.is_spherical:
        keys = np.asarray(info.layout.keys.values)
        return len(keys) == 1 and keys[0][0] == 0 and keys[0][1] == 1
    return False


class CompositionModel:
    """Per-species linear baseline; ``weights[target]`` is (n_types, P)."""

    __checkpoint_version__ = 1

    def __init__(self, dataset_info: DatasetInfo):
        self.dataset_info = dataset_info
        self.atomic_types = list(dataset_info.atomic_types)
        self._type_to_index = {z: i for i, z in enumerate(self.atomic_types)}
        self._lookup = np.zeros((max(self.atomic_types) + 1,), dtype=np.int64)
        self._lookup[self.atomic_types] = np.arange(len(self.atomic_types))
        self.target_infos = {name: info for name, info in dataset_info.targets.items()
                             if _is_valid_target(info)}
        self.weights: Dict[str, np.ndarray] = {
            name: np.zeros((len(self.atomic_types), len(info.layout.block(0).properties)))
            for name, info in self.target_infos.items()
        }

    def fit(self, datasets: Sequence, fixed_weights: Optional[FixedWeights] = None) -> None:
        """Least-squares fit of per-species weights on the host.

        :param fixed_weights: per-target user overrides: a scalar for all
            species or a ``{atomic_number: value}`` dict.
        """
        fixed_weights = fixed_weights or {}
        n_types = len(self.atomic_types)
        for name in self.weights:
            if name in fixed_weights:
                spec = fixed_weights[name]
                n_props = self.weights[name].shape[1]
                if isinstance(spec, dict):
                    w = np.zeros((n_types, n_props))
                    for z, value in spec.items():
                        w[self._type_to_index[int(z)]] = float(value)
                else:
                    w = np.full((n_types, n_props), float(spec))
                self.weights[name] = w
                continue

            xtx = np.zeros((n_types, n_types), dtype=np.float64)
            xty: Optional[np.ndarray] = None
            for dataset in datasets:
                if name not in dataset_target_names(dataset):
                    continue
                for sample in iter_samples(dataset):
                    system = sample.system
                    values = np.asarray(sample.targets[name].block(0).values, dtype=np.float64)
                    counts = np.zeros(n_types)
                    for z in system.types:
                        idx = self._type_to_index.get(int(z))
                        if idx is not None:
                            counts[idx] += 1.0
                    if xty is None:
                        xty = np.zeros((n_types, values.shape[-1]))
                    if self.target_infos[name].per_atom:
                        # each atom is one sample with a one-hot row
                        flat = values.reshape(len(system), -1)
                        for a, z in enumerate(system.types):
                            idx = self._type_to_index[int(z)]
                            xtx[idx, idx] += 1.0
                            xty[idx] += flat[a]
                    else:
                        xtx += np.outer(counts, counts)
                        xty += counts[:, None] * values.reshape(1, -1)
            if xty is None:
                continue
            # tiny Tikhonov term guards rank-deficient systems (e.g. a
            # species never appearing alone); exact when well-conditioned
            reg = 1e-10 * max(np.trace(xtx) / max(n_types, 1), 1.0)
            self.weights[name] = np.linalg.solve(xtx + reg * np.eye(n_types), xty)

    def load_checkpoint_weights(self, checkpoint: dict) -> None:
        """Read the ``composition`` section of a model checkpoint."""
        types = [int(z) for z in checkpoint["dataset_info"]["atomic_types"]]
        for name, w in checkpoint["weights"].items():
            if name not in self.weights:
                continue
            w = np.asarray(w, dtype=np.float64)
            for i, z in enumerate(self.atomic_types):
                if z in types:
                    self.weights[name][i] = w[types.index(z)]

    def get_checkpoint(self) -> dict:
        """The ``composition`` section of a model checkpoint (the JAX
        package's format)."""
        return {
            "architecture_name": "composition",
            "model_ckpt_version": self.__checkpoint_version__,
            "hypers": {},
            "dataset_info": self.dataset_info.to_dict(),
            "weights": {k: v.copy() for k, v in self.weights.items()},
        }

    def predict_host(self, system) -> Dict[str, np.ndarray]:
        """Per-target baseline of one host system (float64): (N, P) per
        atom for per-atom targets, else (1, P)."""
        out = {}
        for name, w in self.weights.items():
            idx = np.array([self._type_to_index.get(int(z), -1) for z in system.types])
            valid = idx >= 0
            per_atom = np.zeros((len(system), w.shape[1]))
            per_atom[valid] = w[idx[valid]]
            out[name] = (per_atom if self.target_infos[name].per_atom
                         else per_atom.sum(0, keepdims=True))
        return out

    def remove_transform(self, samples: List[Sample]) -> List[Sample]:
        """Collate transform subtracting the baseline from host targets.
        Gradient blocks are untouched: the baseline has zero position and
        strain gradients."""
        new_samples = []
        for sample in samples:
            new_targets = dict(sample.targets)
            for name, baseline in self.predict_host(sample.system).items():
                if name not in new_targets:
                    continue
                tmap = new_targets[name]
                block = tmap.block(0)
                new_block = TensorBlock(
                    np.asarray(block.values) - baseline.reshape(block.values.shape),
                    block.samples, block.components, block.properties, block.mask,
                )
                for gname, grad in block.gradients():
                    new_block.add_gradient(gname, grad)
                new_targets[name] = TensorMap(tmap.keys, [new_block])
            new_samples.append(Sample(sample.system, new_targets, sample.extra_data))
        return new_samples

    def forward(self, batch: SystemBatch, outputs: Sequence[str],
                selected_atoms: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """float32 contributions of the requested targets: (A, P) per atom
        for per-atom targets, else (S, P) per system; only the atoms of
        ``selected_atoms`` (an (A,) mask) where it is given."""
        type_index = torch.as_tensor(self._lookup, device=batch.device)[
            torch.clamp(batch.types.long(), 0, len(self._lookup) - 1)
        ]
        amask = batch.atom_mask if selected_atoms is None else batch.atom_mask & selected_atoms
        onehot = batch.system_onehot(torch.float32)
        out = {}
        for name in outputs:
            if name not in self.weights:
                continue
            w = torch.as_tensor(self.weights[name], dtype=torch.float32, device=batch.device)
            per_atom = torch.where(amask[:, None], w[type_index], 0.0)
            out[name] = per_atom if self.target_infos[name].per_atom else onehot.T @ per_atom
        return out


def train_or_load_composition_model(
    path_or_none: Optional[str],
    dataset_info: DatasetInfo,
    datasets: Sequence,
    fixed_weights: Optional[FixedWeights] = None,
) -> CompositionModel:
    """Fit a composition model, or load a pre-trained checkpoint."""
    model = CompositionModel(dataset_info)
    if path_or_none:
        from ..utils.io import load_checkpoint_file

        model.load_checkpoint_weights(load_checkpoint_file(path_or_none))
    else:
        model.fit(datasets, fixed_weights=fixed_weights)
    return model
