"""Scaler: RMS normalization of training targets.

Counterpart of ``metatrain_tpu/models/scaler.py``. Fitting (host, after
the baselines' removal) computes, per target, a per-block, per-property
full scale (the uncentered RMS of that slice; one row per atomic type for
per-atom targets) and a per-target scale (the RMS over every value);
targets are divided by the full scale in the collate pipeline and
predictions multiplied back at evaluation. Gradient blocks take the same
factor (d(sE) = s dE). The scales keep the JAX package's layout: a list
over blocks of (R, P_b) arrays, R = 1 for per-structure targets and the
number of atomic types for per-atom ones.

Unlike the JAX package, a per-atom block's rows take the scale row of the
type of the atom each row names (its ``atom`` sample), not of the atom at
the row's position: the two differ for an atomic-basis block, which holds
only the atoms of its type.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..containers import TensorBlock, TensorMap
from ..data.dataset import Sample, dataset_target_names, iter_samples
from ..data.target_info import DatasetInfo

FixedScales = Dict[str, Union[float, Dict[str, float]]]


def _block_rows(block: TensorBlock, type_rows: np.ndarray) -> np.ndarray:
    """The scale row of each sample row of a per-atom host block: the row
    of the type of the atom its ``atom`` sample names."""
    return type_rows[np.asarray(block.samples.column("atom"), dtype=np.int64)]


class Scaler:
    """``scales[target]``: one (R, P) full scale per block;
    ``per_target[target]``: (R,)."""

    __checkpoint_version__ = 2

    def __init__(self, dataset_info: DatasetInfo):
        self.dataset_info = dataset_info
        self.atomic_types = list(dataset_info.atomic_types)
        self._type_to_index = {int(z): i for i, z in enumerate(self.atomic_types)}
        self.scales: Dict[str, List[np.ndarray]] = {}
        self.per_target: Dict[str, np.ndarray] = {}
        for name, info in dataset_info.targets.items():
            R = self._rows(name)
            self.scales[name] = [np.ones((R, len(block.properties)))
                                 for block in info.layout.blocks()]
            self.per_target[name] = np.ones((R,))

    def _rows(self, name: str) -> int:
        return len(self.atomic_types) if self.dataset_info.targets[name].per_atom else 1

    def _type_rows(self, system) -> np.ndarray:
        """Each atom's scale row (the index of its type)."""
        return np.array([self._type_to_index.get(int(z), 0) for z in system.types],
                        dtype=np.int64)

    def fit(self, datasets: Sequence, fixed_scales: Optional[FixedScales] = None) -> None:
        fixed_scales = fixed_scales or {}
        for name in self.scales:
            R = self._rows(name)
            if name in fixed_scales:
                spec = fixed_scales[name]
                value = float(next(iter(spec.values())) if isinstance(spec, dict) else spec)
                self.scales[name] = [np.full_like(s, value) for s in self.scales[name]]
                self.per_target[name] = np.full((R,), value)
                continue
            sq = [np.zeros_like(s) for s in self.scales[name]]
            cnt = [np.zeros_like(s) for s in self.scales[name]]
            for dataset in datasets:
                if name not in dataset_target_names(dataset):
                    continue
                for sample in iter_samples(dataset):
                    type_rows = self._type_rows(sample.system) if R > 1 else None
                    for b, block in enumerate(sample.targets[name].blocks()):
                        values = np.asarray(block.values, dtype=np.float64)
                        if values.shape[0] == 0:
                            # atomic-basis blocks: a system can lack a
                            # block's atom type entirely
                            continue
                        P = values.shape[-1]
                        flat = values.reshape(values.shape[0], -1, P)
                        finite = np.isfinite(flat)
                        v2 = np.where(finite, flat**2, 0.0).sum(axis=1)
                        n = finite.sum(axis=1).astype(np.float64)
                        if R == 1:
                            sq[b][0] += v2.sum(0)
                            cnt[b][0] += n.sum(0)
                        else:
                            rows = _block_rows(block, type_rows)
                            np.add.at(sq[b], rows, v2)
                            np.add.at(cnt[b], rows, n)
            full = [np.where(c > 0, np.sqrt(s / np.maximum(c, 1)), 1.0) for s, c in zip(sq, cnt)]
            full = [np.where(f > 0, f, 1.0) for f in full]
            sq_all = sum(s.sum(axis=1) for s in sq)
            cnt_all = sum(c.sum(axis=1) for c in cnt)
            target_scale = np.where(cnt_all > 0, np.sqrt(sq_all / np.maximum(cnt_all, 1)), 1.0)
            self.scales[name] = full
            self.per_target[name] = np.where(target_scale > 0, target_scale, 1.0)

    def _is_multi_property(self, name: str) -> bool:
        """Several blocks or several properties (never an atom-pair target)."""
        info = self.dataset_info.targets[name]
        if info.sample_kind == "atom_pair":
            return False
        blocks = info.layout.blocks()
        return len(blocks) > 1 or any(len(b.properties) > 1 for b in blocks)

    def block_factor(self, name: str, b: int, use_per_target: bool = True,
                     use_per_property: bool = True) -> np.ndarray:
        """(R, P_b) factor of block ``b`` for the chosen decomposition: the
        full scale is the per-target scale times the per-property one."""
        full = self.scales[name][b]
        target = self.per_target[name][:, None]
        if use_per_target and use_per_property:
            return full
        if use_per_target:
            return np.broadcast_to(target, full.shape)
        if use_per_property and self._is_multi_property(name):
            return full / np.where(target > 0, target, 1.0)
        return np.ones_like(full)

    def remove_transform(self, samples: List[Sample]) -> List[Sample]:
        """Collate transform: divide host targets (and gradients) by the
        full scale."""
        new_samples = []
        for sample in samples:
            new_targets = {}
            for name, tmap in sample.targets.items():
                if name not in self.scales:
                    new_targets[name] = tmap
                    continue
                type_rows = self._type_rows(sample.system) if self._rows(name) > 1 else None
                new_targets[name] = _unscale_tensormap_host(tmap, self.scales[name], type_rows)
            new_samples.append(Sample(sample.system, new_targets, sample.extra_data))
        return new_samples

    def load_checkpoint_scales(self, checkpoint: dict) -> None:
        """Read the ``scaler`` section of a model checkpoint. Version 1 kept
        one (P,) scale shared by all blocks: it is broadcast to each block,
        and the per-target scale is its RMS (1 where that is 0)."""
        for name, blocks in checkpoint["scales"].items():
            if name not in self.scales:
                continue
            if isinstance(blocks, np.ndarray) and blocks.ndim == 1:
                self.scales[name] = [np.broadcast_to(blocks, s.shape).astype(np.float64)
                                     for s in self.scales[name]]
                self.per_target[name] = np.full(
                    self.per_target[name].shape,
                    float(np.sqrt(np.mean(np.square(blocks)))) or 1.0,
                )
            else:
                self.scales[name] = [np.asarray(x, np.float64) for x in blocks]
        for name, v in checkpoint.get("per_target", {}).items():
            if name in self.per_target:
                self.per_target[name] = np.asarray(v, np.float64)

    def get_checkpoint(self) -> dict:
        """The ``scaler`` section of a model checkpoint (the JAX package's
        format, version 2)."""
        return {
            "architecture_name": "scaler",
            "model_ckpt_version": self.__checkpoint_version__,
            "hypers": {},
            "dataset_info": self.dataset_info.to_dict(),
            "scales": {k: [s.copy() for s in v] for k, v in self.scales.items()},
            "per_target": {k: v.copy() for k, v in self.per_target.items()},
        }

    def apply_scales(self, predictions: Dict[str, TensorMap], batch=None, remove: bool = False,
                     use_per_target_scales: bool = True,
                     use_per_property_scales: bool = True) -> Dict[str, TensorMap]:
        """Multiply (``remove``: divide) predictions, values and gradients,
        by the scales of each block; per-atom targets take the row of each
        atom's type, read from ``batch``."""
        out = {}
        for name, tmap in predictions.items():
            if name not in self.scales:
                out[name] = tmap
                continue
            per_atom = self._rows(name) > 1
            if per_atom and batch is None:
                raise ValueError(f"apply_scales needs the batch for the per-atom target '{name}'")
            blocks = []
            for b, block in enumerate(tmap.blocks()):
                factor = self.block_factor(name, b, use_per_target_scales, use_per_property_scales)
                if remove:
                    factor = 1.0 / factor
                values = block.values
                if per_atom:
                    lookup = np.ones((max(self.atomic_types) + 1, factor.shape[1]))
                    for z, i in self._type_to_index.items():
                        lookup[z] = factor[i]
                    rows = torch.as_tensor(lookup, device=values.device)[
                        torch.clamp(batch.types.long(), 0, lookup.shape[0] - 1)]  # (A, P)
                else:
                    rows = torch.tensor(factor[0], device=values.device)[None]  # (1, P)

                def scaled(v, rows=rows):
                    return v * rows.reshape(rows.shape[:1] + (1,) * (v.ndim - 2)
                                            + rows.shape[1:]).to(v.dtype)

                blocks.append(block.map_values(scaled))
            out[name] = TensorMap(tmap.keys, blocks)
        return out


def _unscale_tensormap_host(tmap: TensorMap, block_scales: List[np.ndarray],
                            type_rows: Optional[np.ndarray] = None) -> TensorMap:
    """Host-side division of one target TensorMap (values and gradients)
    by its (R, P) block scales, as a product with the inverse scale, as
    the JAX package computes it. Per-atom targets (``type_rows``, each
    atom's scale row) scale each sample row by the row of its atom's type,
    and each gradient row by the row of the sample it belongs to."""
    blocks = []
    for block, factor in zip(tmap.blocks(), block_scales):
        inverse = 1.0 / factor
        if type_rows is None:
            blocks.append(block.map_values(lambda v, inv=inverse[0]: np.asarray(v) * inv))
            continue
        per_row = inverse[_block_rows(block, type_rows)]  # (n, P)

        def by_row(v, rows):
            v = np.asarray(v)
            return v * rows.reshape((len(rows),) + (1,) * (v.ndim - 2) + (rows.shape[-1],))

        new = TensorBlock(by_row(block.values, per_row), block.samples, block.components,
                          block.properties, block.mask)
        for gname, grad in block.gradients():
            sample_of = np.asarray(grad.samples.values)[:, 0]  # the target's sample row
            new.add_gradient(gname, TensorBlock(
                by_row(grad.values, per_row[sample_of]), grad.samples, grad.components,
                grad.properties, grad.mask))
        blocks.append(new)
    return TensorMap(tmap.keys, blocks)


def train_or_load_scaler(
    path_or_none: Optional[str],
    dataset_info: DatasetInfo,
    datasets: Sequence,
    fixed_scales: Optional[FixedScales] = None,
    enabled: bool = True,
) -> Scaler:
    scaler = Scaler(dataset_info)
    if path_or_none:
        from ..utils.io import load_checkpoint_file

        scaler.load_checkpoint_scales(load_checkpoint_file(path_or_none))
    elif enabled:
        scaler.fit(datasets, fixed_scales=fixed_scales)
    return scaler
