"""Shared base of the port's neural-network architectures.

Counterpart of ``metatrain_tpu/models/nn_base.py``: species lookup,
per-target output sizes (components x properties per block), assembly of
the network's per-atom predictions into target TensorMaps (per atom or
per structure, several blocks, ``atom_type`` blocks masked to their type,
``non_conservative_stress`` symmetrised and divided by the volume), the
aux outputs ``features`` and ``mtt::aux::{target}_last_layer_features``,
a selection of atoms, the evaluation-time scaler, composition and ZBL
baselines, the model part of a checkpoint in the JAX package's layout,
loading one (``load_checkpoint``) and carrying a model over to another
dataset (``restart``). The diagnostic ``mtt::feature::`` outputs are not
ported.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..containers import Labels, SystemBatch, TensorBlock, TensorMap
from ..data.target_info import DatasetInfo, TargetInfo
from .composition import CompositionModel
from .scaler import Scaler

DIAGNOSTIC_PREFIX = "mtt::feature::"


def block_key_str(key_tuple) -> str:
    return "_".join(str(int(v)) for v in key_tuple)


def last_layer_features_name(target: str) -> str:
    return f"mtt::aux::{target}_last_layer_features"


def sum_over_atoms(values: torch.Tensor, batch: SystemBatch, amask: torch.Tensor) -> torch.Tensor:
    """Per-atom (A, P) -> per-system (S, P), masked, as a one-hot product
    (deterministic, and its adjoint is a product too)."""
    values = torch.where(amask[:, None], values, 0.0)
    return batch.system_onehot(values.dtype).T @ values


def selection_mask(batch: SystemBatch, pairs) -> torch.Tensor:
    """(A,) boolean mask of the ``(system, atom slot)`` pairs in ``pairs``
    (a (K, 2) integer array, the convention of per-atom sample labels):
    the ``selected_atoms`` argument of :meth:`AtomisticNNModel.forward`."""
    mask = np.zeros(batch.n_atoms_padded, dtype=bool)
    system_index = batch.system_index.cpu().numpy()
    for sys_i, slot in np.asarray(pairs, dtype=np.int64).reshape(-1, 2):
        if 0 <= slot < mask.shape[0] and system_index[slot] == sys_i:
            mask[slot] = True
    return torch.as_tensor(mask, device=batch.device)


def atom_samples(batch: SystemBatch) -> Labels:
    """The ``(system, atom)`` sample labels of per-atom blocks."""
    return Labels(["system", "atom"], torch.stack([
        batch.system_index, torch.arange(batch.n_atoms_padded, device=batch.device)], dim=1))


def cell_volumes(cells: torch.Tensor) -> torch.Tensor:
    """|det| of (S, 3, 3) cells as the triple product (a polynomial: its
    gradient is finite on the zero cells of padded and non-periodic
    systems)."""
    return torch.abs(torch.sum(cells[:, 0] * torch.linalg.cross(cells[:, 1], cells[:, 2]), -1))


def process_stress_like(flat: torch.Tensor, batch: SystemBatch, n_props: int) -> torch.Tensor:
    """Rank-2 outputs (A, 9 P) symmetrised and divided by their system's
    cell volume, (A, 3, 3, P). A volume of zero (non-periodic and padded
    systems) counts as infinite, as in the JAX package: the output is 0
    there, with finite gradients, in every dtype."""
    t = flat.reshape(flat.shape[0], 3, 3, n_props)
    volumes = cell_volumes(batch.cells).to(t.dtype)
    empty = volumes == 0.0
    inverse = torch.where(empty, 0.0, 1.0 / torch.where(empty, 1.0, volumes))
    t = t * (batch.system_onehot(t.dtype) @ inverse)[:, None, None, None]
    return 0.5 * (t + t.transpose(1, 2))


def concat_node_edge_features(node_list, edge_list, cutoff_factors) -> torch.Tensor:
    """Per readout layer, the node features and the cutoff-weighted sum of
    the edge features, concatenated (A, F) in at least float32: the
    ``features`` output, the last-layer features and LLPR's covariances."""
    parts = []
    for node_f, edge_f in zip(node_list, edge_list):
        dtype = torch.promote_types(torch.float32, node_f.dtype)
        parts.append(node_f.to(dtype))
        parts.append(torch.sum(edge_f.to(dtype) * cutoff_factors[:, :, None].to(dtype), dim=1))
    return torch.cat(parts, dim=-1)


class AtomisticNNModel(nn.Module):
    """Network + baselines + TensorMap assembly.

    Subclasses set ``self.module`` (a module mapping preprocessed batch
    data and requested target names to ``{target: {block key: (A,
    size)}}``, ``{"_ll_features::<target>": (node list, edge list)}`` for
    each target and ``"_node_features"``/``"_edge_features"``) and
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
        # per target and block: components x properties
        self.output_shapes: Dict[str, Dict[str, int]] = {
            name: {block_key_str(key): int(np.prod([len(c) for c in block.components],
                                                   initial=1)) * len(block.properties)
                   for key, block in info.layout.items()}
            for name, info in self.target_infos.items()
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

    def forward(self, batch: SystemBatch, outputs: Sequence[str],
                selected_atoms: Optional[torch.Tensor] = None) -> Dict[str, TensorMap]:
        """Training-space predictions (no scaler, no baselines) of the
        requested targets and aux outputs: ``features`` (the per-atom
        representation) and ``mtt::aux::{target}_last_layer_features``.

        :param selected_atoms: optional (A,) boolean mask over the padded
            atom slots (:func:`selection_mask`): per-atom outputs are zero
            outside it and per-structure outputs sum the selected atoms only.
        """
        requested = [n for n in outputs if n in self.output_shapes]
        ll_requests = {}
        for name in outputs:
            if name in self.output_shapes or name == "features":
                continue
            target = name.removeprefix("mtt::aux::").removesuffix("_last_layer_features")
            if name == last_layer_features_name(target) and target in self.output_shapes:
                ll_requests[name] = target
            elif name.startswith(DIAGNOSTIC_PREFIX):
                raise NotImplementedError(f"the diagnostic outputs ({name}) are not ported")
            else:
                raise ValueError(f"unknown output {name!r}")
        amask = batch.atom_mask if selected_atoms is None else batch.atom_mask & selected_atoms
        batch_data = self.preprocess(batch)
        raw = self.module(batch_data, tuple(dict.fromkeys(requested + list(ll_requests.values()))))
        results = {name: self._assemble_target(name, raw[name], batch, amask)
                   for name in requested}
        if "features" in outputs:
            results["features"] = self._per_atom_feature_map(concat_node_edge_features(
                raw["_node_features"], raw["_edge_features"], batch_data["cutoff_factors"]),
                batch, amask)
        for name, target in ll_requests.items():
            results[name] = self._per_atom_feature_map(concat_node_edge_features(
                *raw[f"_ll_features::{target}"], batch_data["cutoff_factors"]), batch, amask)
        return results

    def _per_atom_feature_map(self, features: torch.Tensor, batch: SystemBatch,
                              amask: torch.Tensor) -> TensorMap:
        features = features.to(torch.promote_types(torch.float32, features.dtype))
        block = TensorBlock(
            values=torch.where(amask[:, None], features, 0.0),
            samples=atom_samples(batch),
            components=(),
            properties=Labels.range("property", int(features.shape[-1])),
            mask=amask,
        )
        return TensorMap(Labels.single(), [block])

    def forward_eval(self, batch: SystemBatch, outputs: Sequence[str],
                     selected_atoms: Optional[torch.Tensor] = None) -> Dict[str, TensorMap]:
        """Evaluation predictions: scaler, composition baseline and (where
        the model has one) the ZBL baseline applied, in that order."""
        results = self.scaler.apply_scales(self.forward(batch, outputs, selected_atoms), batch)
        additive = [self.composition.forward(batch, list(results), selected_atoms)]
        if self.zbl is not None:
            additive.append(self.zbl.forward(batch, list(results), selected_atoms))
        for contributions in additive:
            for name, contribution in contributions.items():
                block = results[name].block(0)
                block.values = block.values + contribution.to(block.values.dtype).reshape(
                    block.values.shape[:1] + (1,) * (block.values.ndim - contribution.ndim)
                    + contribution.shape[1:])
        return results

    def _assemble_target(self, name: str, per_block: Dict[str, torch.Tensor],
                         batch: SystemBatch, amask: Optional[torch.Tensor] = None) -> TensorMap:
        """The target's TensorMap from the network's per-atom (A, size)
        predictions of each block: per-atom blocks masked to ``amask`` (an
        ``atom_type`` block also to its type), per-structure blocks summed
        over those atoms."""
        info = self.target_infos[name]
        A, S = batch.n_atoms_padded, batch.n_systems_padded
        amask = batch.atom_mask if amask is None else amask
        type_col = (info.layout.keys.names.index("atom_type") if info.is_atomic_basis else None)
        blocks = []
        for key, layout_block in info.layout.items():
            flat = per_block[block_key_str(key)]
            flat = flat.to(torch.promote_types(torch.float32, flat.dtype))
            comp_shape = tuple(len(c) for c in layout_block.components)
            n_props = len(layout_block.properties)
            if name == "non_conservative_stress":
                flat = process_stress_like(flat, batch, n_props).reshape(A, -1)
            block_mask = amask
            if type_col is not None:
                block_mask = amask & (batch.types == int(key[type_col]))
            if info.per_atom:
                values = flat.reshape((A,) + comp_shape + (n_props,))
                values = torch.where(block_mask.reshape((A,) + (1,) * (values.ndim - 1)),
                                     values, 0.0)
                samples, mask = atom_samples(batch), block_mask
            else:
                values = sum_over_atoms(flat, batch, block_mask).reshape(
                    (S,) + comp_shape + (n_props,))
                samples, mask = Labels.range("system", S), batch.system_mask
            blocks.append(TensorBlock(values=values, samples=samples,
                                      components=layout_block.components,
                                      properties=layout_block.properties, mask=mask))
        return TensorMap(info.layout.keys, blocks)

    def last_layer_features(self, batch: SystemBatch, target_name: str) -> torch.Tensor:
        """Per-atom last-layer features (A, F) of one target."""
        batch_data = self.preprocess(batch)
        raw = self.module(batch_data, (target_name,))
        return concat_node_edge_features(*raw[f"_ll_features::{target_name}"],
                                         batch_data["cutoff_factors"])

    @property
    def last_layer_feature_size(self) -> int:
        """Width of the last-layer feature vector: per readout layer, the
        node head's and the edge head's widths."""
        return int(self.module.last_layer_feature_size)

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
