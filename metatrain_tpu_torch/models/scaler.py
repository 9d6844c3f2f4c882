"""Scaler on evaluation: predictions times the fitted RMS scale.

Counterpart of ``Scaler.apply_scales`` in ``metatrain_tpu/models/scaler.py``
for energy targets (one block, one scale row): values are multiplied by
the full (per-target times per-property) scale. Fitting stays with the
JAX package; the scales come from a checkpoint.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..containers import TensorBlock, TensorMap
from ..data.target_info import DatasetInfo


class Scaler:
    """``scales[target]`` is the (P,) full scale of the target's block."""

    def __init__(self, dataset_info: DatasetInfo):
        self.scales: Dict[str, np.ndarray] = {
            name: np.ones((len(info.layout.block(0).properties),))
            for name, info in dataset_info.targets.items()
            if info.is_energy
        }

    def load_checkpoint_scales(self, checkpoint: dict) -> None:
        """Read the ``scaler`` section (format version 2) of a model checkpoint."""
        for name, blocks in checkpoint["scales"].items():
            if name in self.scales:
                self.scales[name] = np.asarray(blocks[0], dtype=np.float64)[0]

    def apply_scales(self, predictions: Dict[str, TensorMap]) -> Dict[str, TensorMap]:
        out = {}
        for name, tmap in predictions.items():
            if name not in self.scales:
                out[name] = tmap
                continue
            block = tmap.block(0)
            scale = torch.as_tensor(self.scales[name], dtype=block.values.dtype,
                                    device=block.values.device)
            out[name] = TensorMap(tmap.keys, [TensorBlock(
                block.values * scale, block.samples, block.components,
                block.properties, block.mask,
            )])
        return out
