"""Shared base of the port's neural-network architectures.

Counterpart of ``metatrain_tpu/models/nn_base.py``, reduced to the force
call: species lookup, per-target output shapes, assembly of the network's
per-atom predictions into per-structure energy TensorMaps, and the
evaluation-time scaler and composition baselines (energy targets only).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
from torch import nn

from ..containers import Labels, SystemBatch, TensorBlock, TensorMap
from ..data.target_info import DatasetInfo, TargetInfo
from .composition import CompositionModel
from .scaler import Scaler


def block_key_str(key_tuple) -> str:
    return "_".join(str(int(v)) for v in key_tuple)


def sum_over_atoms(values: torch.Tensor, batch: SystemBatch, amask: torch.Tensor) -> torch.Tensor:
    """Per-atom (A, P) -> per-system (S, P), masked, as a one-hot product
    (deterministic, and its adjoint is a product too)."""
    values = torch.where(amask[:, None], values, 0.0)
    return batch.system_onehot(values.dtype).T @ values


class AtomisticNNModel(nn.Module):
    """Network + baselines + TensorMap assembly.

    Subclasses set ``self.module`` (a module mapping preprocessed batch
    data and requested names to ``{target: {block key: (A, size)}}``) and
    implement :meth:`preprocess`.
    """

    def __init__(self, hypers: Dict[str, Any], dataset_info: DatasetInfo, compute_dtype):
        super().__init__()
        self.hypers = hypers
        self.dataset_info = dataset_info
        self.compute_dtype = compute_dtype
        self.atomic_types = list(dataset_info.atomic_types)
        self.target_infos: Dict[str, TargetInfo] = dict(dataset_info.targets)
        self.output_shapes: Dict[str, Dict[str, int]] = {}
        for name, info in self.target_infos.items():
            if not info.is_energy:
                raise NotImplementedError(
                    f"target '{name}': the port handles per-structure scalar "
                    "(energy) targets only"
                )
            self.output_shapes[name] = {
                block_key_str(key): len(block.properties)
                for key, block in info.layout.items()
            }
        lookup = np.zeros((max(self.atomic_types) + 1,), dtype=np.int64)
        for i, z in enumerate(self.atomic_types):
            lookup[z] = i
        self._species_lookup = lookup
        self.composition = CompositionModel(dataset_info)
        self.scaler = Scaler(dataset_info)

    def preprocess(self, batch: SystemBatch) -> Dict[str, Any]:
        raise NotImplementedError

    def species_index(self, batch: SystemBatch) -> torch.Tensor:
        lookup = torch.as_tensor(self._species_lookup, device=batch.device)
        return lookup[torch.clamp(batch.types.long(), 0, lookup.shape[0] - 1)]

    def forward(self, batch: SystemBatch, outputs: Sequence[str]) -> Dict[str, TensorMap]:
        """Training-space predictions (no scaler, no baselines)."""
        requested = tuple(n for n in outputs if n in self.output_shapes)
        unknown = [n for n in outputs if n not in self.output_shapes]
        if unknown:
            raise NotImplementedError(f"outputs {unknown} are not ported")
        raw = self.module(self.preprocess(batch), requested)
        return {name: self._assemble_target(name, raw[name], batch) for name in requested}

    def forward_eval(self, batch: SystemBatch, outputs: Sequence[str]) -> Dict[str, TensorMap]:
        """Evaluation predictions: scaler and composition baseline applied."""
        results = self.scaler.apply_scales(self.forward(batch, outputs))
        for name, contribution in self.composition.forward(batch, list(results)).items():
            block = results[name].block(0)
            block.values = block.values + contribution.to(block.values.dtype)
        return results

    def _assemble_target(self, name: str, per_block: Dict[str, torch.Tensor],
                         batch: SystemBatch) -> TensorMap:
        info = self.target_infos[name]
        blocks = []
        for key, layout_block in info.layout.items():
            flat = per_block[block_key_str(key)]
            flat = flat.to(torch.promote_types(torch.float32, flat.dtype))
            blocks.append(
                TensorBlock(
                    values=sum_over_atoms(flat, batch, batch.atom_mask),
                    samples=Labels.range("system", batch.n_systems_padded),
                    components=layout_block.components,
                    properties=layout_block.properties,
                    mask=batch.system_mask,
                )
            )
        return TensorMap(info.layout.keys, blocks)

    def supported_outputs(self) -> Dict[str, TargetInfo]:
        return dict(self.target_infos)
