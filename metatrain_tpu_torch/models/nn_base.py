"""Shared base of the port's neural-network architectures.

Counterpart of ``metatrain_tpu/models/nn_base.py``, for energy targets:
species lookup, per-target output shapes, assembly of the network's
per-atom predictions into per-structure energy TensorMaps, the
evaluation-time scaler and composition baselines, the model part of a
checkpoint in the JAX package's layout, loading one (``load_checkpoint``)
and carrying a model over to another dataset (``restart``).
"""

from __future__ import annotations

import copy
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

    ARCHITECTURE_NAME = ""
    __checkpoint_version__ = 1

    def __init__(self, hypers: Dict[str, Any], dataset_info: DatasetInfo, compute_dtype,
                 **build_options):
        super().__init__()
        # the constructor's keywords beyond the checkpoint's (PET's plain,
        # fused_gnn, ...), for a model rebuilt by restart
        self.build_options = dict(build_options)
        # False until random or checkpoint weights are in
        self.weights_initialized = False
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
        self.zbl = None  # the ZBL baseline, set by a subclass whose hypers ask for it

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
        """Evaluation predictions: scaler, composition baseline and (where
        the model has one) the ZBL baseline applied, in that order."""
        results = self.scaler.apply_scales(self.forward(batch, outputs))
        additive = [self.composition.forward(batch, list(results))]
        if self.zbl is not None:
            additive.append(self.zbl.forward(batch, list(results)))
        for contributions in additive:
            for name, contribution in contributions.items():
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

    def requested_extra_system_keys(self) -> Sequence[str]:
        """``System.extra`` entries the model reads from ``SystemBatch.extra``."""
        return ()

    def supported_outputs(self) -> Dict[str, TargetInfo]:
        return dict(self.target_infos)

    def get_checkpoint(self) -> Dict[str, Any]:
        """The model part of a checkpoint, in the JAX package's layout:
        ``metatrain_tpu.utils.io.model_from_checkpoint`` loads it."""
        from ..interop.jax_params import state_dict_to_flax

        return {
            "architecture_name": self.ARCHITECTURE_NAME,
            "model_ckpt_version": self.__checkpoint_version__,
            "hypers": copy.deepcopy(dict(self.hypers)),
            "dataset_info": self.dataset_info.to_dict(),
            "params": state_dict_to_flax(self.module),
            "composition": self.composition.get_checkpoint(),
            "scaler": self.scaler.get_checkpoint(),
        }

    @classmethod
    def load_checkpoint(cls, checkpoint: Dict[str, Any], context: str = "restart",
                        device="auto", compute_dtype=torch.float32, **build_options):
        """The model of an (upgraded) checkpoint of either package, its
        network in ``compute_dtype`` (float32 unless asked otherwise, as the
        JAX package loads it), on ``device`` (the card unless the caller
        asks otherwise). ``context`` (restart, finetune, export) changes
        nothing for these architectures."""
        from ..interop.jax_params import flax_to_state_dict
        from ..utils.devices import resolve_device

        device = resolve_device(device)
        model = cls(checkpoint["hypers"], DatasetInfo.from_dict(checkpoint["dataset_info"]),
                    compute_dtype=compute_dtype, **build_options)
        model.module.load_state_dict(flax_to_state_dict(checkpoint["params"]))
        model.composition.load_checkpoint_weights(checkpoint["composition"])
        model.scaler.load_checkpoint_scales(checkpoint["scaler"])
        model.weights_initialized = True
        return model.to(device)

    def restart(self, dataset_info: DatasetInfo) -> "AtomisticNNModel":
        """This model for training on ``dataset_info``: itself when nothing
        changes; with new targets, a model of the merged info whose new
        heads are drawn fresh (the seed from numpy's global state, which
        the train command seeds) and whose other weights are these."""
        if dataset_info == self.dataset_info:
            return self
        merged = self.dataset_info.union(dataset_info)
        if set(merged.atomic_types) != set(self.atomic_types):
            raise ValueError(
                f"{type(self).__name__} cannot be restarted with new atomic types; missing "
                f"{set(merged.atomic_types) - set(self.atomic_types)}"
            )
        device = next(self.parameters()).device
        new = type(self)(self.hypers, merged, self.compute_dtype, **self.build_options)
        new.init_weights(torch.Generator().manual_seed(int(np.random.randint(0, 2**31 - 1))))
        state = new.module.state_dict()
        for key, value in self.module.state_dict().items():
            if key in state and state[key].shape == value.shape:
                state[key] = value
        new.module.load_state_dict(state)
        new.composition.load_checkpoint_weights(self.composition.get_checkpoint())
        new.scaler.load_checkpoint_scales(self.scaler.get_checkpoint())
        return new.to(device)
