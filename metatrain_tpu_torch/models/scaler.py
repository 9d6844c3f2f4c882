"""Scaler: RMS normalization of training targets.

Counterpart of ``metatrain_tpu/models/scaler.py`` for energy targets.
Fitting (host, after composition removal) computes, per target, a
per-block, per-property full scale (the uncentered RMS of that slice) and
a per-target scale (the RMS over every value); targets are divided by the
full scale in the collate pipeline and predictions multiplied back at
evaluation. Gradient blocks take the same factor (d(sE) = s dE). The
scales keep the JAX package's layout, a list over blocks of (R, P) arrays
with R = 1 row for per-structure targets.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..containers import TensorMap
from ..data.dataset import Sample, dataset_target_names, iter_samples
from ..data.target_info import DatasetInfo

FixedScales = Dict[str, Union[float, Dict[str, float]]]


class Scaler:
    """``scales[target]``: one (1, P) full scale per block."""

    __checkpoint_version__ = 2

    def __init__(self, dataset_info: DatasetInfo):
        self.dataset_info = dataset_info
        self.scales: Dict[str, List[np.ndarray]] = {}
        self.per_target: Dict[str, np.ndarray] = {}
        for name, info in dataset_info.targets.items():
            if not info.is_energy:
                continue
            self.scales[name] = [
                np.ones((1, len(block.properties))) for block in info.layout.blocks()
            ]
            self.per_target[name] = np.ones((1,))

    def fit(self, datasets: Sequence, fixed_scales: Optional[FixedScales] = None) -> None:
        fixed_scales = fixed_scales or {}
        for name in self.scales:
            if name in fixed_scales:
                spec = fixed_scales[name]
                value = float(next(iter(spec.values())) if isinstance(spec, dict) else spec)
                self.scales[name] = [np.full_like(s, value) for s in self.scales[name]]
                self.per_target[name] = np.full((1,), value)
                continue
            sq = [np.zeros_like(s) for s in self.scales[name]]
            cnt = [np.zeros_like(s) for s in self.scales[name]]
            for dataset in datasets:
                if name not in dataset_target_names(dataset):
                    continue
                for sample in iter_samples(dataset):
                    for b, block in enumerate(sample.targets[name].blocks()):
                        values = np.asarray(block.values, dtype=np.float64)
                        if values.shape[0] == 0:
                            continue
                        P = values.shape[-1]
                        flat = values.reshape(values.shape[0], -1, P)
                        finite = np.isfinite(flat)
                        v2 = np.where(finite, flat**2, 0.0).sum(axis=1)
                        n = finite.sum(axis=1).astype(np.float64)
                        sq[b][0] += v2.sum(0)
                        cnt[b][0] += n.sum(0)
            full = [np.where(c > 0, np.sqrt(s / np.maximum(c, 1)), 1.0) for s, c in zip(sq, cnt)]
            full = [np.where(f > 0, f, 1.0) for f in full]
            sq_all = sum(s.sum(axis=1) for s in sq)
            cnt_all = sum(c.sum(axis=1) for c in cnt)
            target_scale = np.where(cnt_all > 0, np.sqrt(sq_all / np.maximum(cnt_all, 1)), 1.0)
            self.scales[name] = full
            self.per_target[name] = np.where(target_scale > 0, target_scale, 1.0)

    def remove_transform(self, samples: List[Sample]) -> List[Sample]:
        """Collate transform: divide host targets (and gradients) by the
        full scale."""
        new_samples = []
        for sample in samples:
            new_targets = {
                name: (_unscale_tensormap_host(tmap, self.scales[name])
                       if name in self.scales else tmap)
                for name, tmap in sample.targets.items()
            }
            new_samples.append(Sample(sample.system, new_targets, sample.extra_data))
        return new_samples

    def load_checkpoint_scales(self, checkpoint: dict) -> None:
        """Read the ``scaler`` section (format version 2) of a model checkpoint."""
        for name, blocks in checkpoint["scales"].items():
            if name in self.scales:
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

    def apply_scales(self, predictions: Dict[str, TensorMap]) -> Dict[str, TensorMap]:
        """Multiply predictions (values and gradients) by the full scales."""
        out = {}
        for name, tmap in predictions.items():
            if name not in self.scales:
                out[name] = tmap
                continue
            out[name] = TensorMap(tmap.keys, [
                block.map_values(lambda v, f=factor[0]: v * torch.as_tensor(
                    f, dtype=v.dtype, device=v.device))
                for block, factor in zip(tmap.blocks(), self.scales[name])
            ])
        return out


def _unscale_tensormap_host(tmap: TensorMap, block_scales: List[np.ndarray]) -> TensorMap:
    """Host-side division of one target TensorMap (values and gradients)
    by its (1, P) block scales, as a product with the inverse scale, as
    the JAX package computes it."""
    return TensorMap(tmap.keys, [
        block.map_values(lambda v, inv=1.0 / factor[0]: np.asarray(v) * inv)
        for block, factor in zip(tmap.blocks(), block_scales)
    ])


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
