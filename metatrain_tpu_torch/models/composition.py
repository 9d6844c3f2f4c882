"""Composition baseline on evaluation: ``E += sum_i w[species_i]``.

Counterpart of the device side of ``metatrain_tpu/models/composition.py``
(``forward``) for energy targets. As in the JAX package, the weights are
float32 on the device and the per-system sum is taken in float32 before
it is added to the prediction. Fitting stays with the JAX package; the
weights come from a checkpoint.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..containers import SystemBatch
from ..data.target_info import DatasetInfo


class CompositionModel:
    """Per-species linear baseline; ``weights[target]`` is (n_types, P)."""

    def __init__(self, dataset_info: DatasetInfo):
        self.atomic_types = list(dataset_info.atomic_types)
        self._lookup = np.zeros((max(self.atomic_types) + 1,), dtype=np.int64)
        self._lookup[self.atomic_types] = np.arange(len(self.atomic_types))
        self.weights: Dict[str, np.ndarray] = {
            name: np.zeros((len(self.atomic_types), len(info.layout.block(0).properties)))
            for name, info in dataset_info.targets.items()
            if info.is_energy
        }

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

    def forward(self, batch: SystemBatch, outputs: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Per-system (S, P) float32 contributions of the requested targets."""
        type_index = torch.as_tensor(self._lookup, device=batch.device)[
            torch.clamp(batch.types.long(), 0, len(self._lookup) - 1)
        ]
        onehot = batch.system_onehot(torch.float32)
        out = {}
        for name in outputs:
            if name not in self.weights:
                continue
            w = torch.as_tensor(self.weights[name], dtype=torch.float32, device=batch.device)
            per_atom = torch.where(batch.atom_mask[:, None], w[type_index], 0.0)
            out[name] = onehot.T @ per_atom
        return out
