"""PET: Point Edge Transformer (PyTorch port).

Counterpart of ``metatrain_tpu/models/pet/model.py``: the PET defaults,
``preprocess`` (edge vectors through the gather-only position gather,
fixed or adaptive cutoffs and their cutoff factors, NEF species indices,
the inputs of long range and system conditioning), the network (fused or
unfused layers, feedforward or residual featurizer, long range, system
conditioning), the ``mtt::aux::cutoff_stats`` output, the ZBL baseline
and the upgrades of older checkpoints. Forces and virial come from ``engine/evaluate.py``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence

import torch

from ...containers import SystemBatch
from ...data.target_info import DatasetInfo
from ...ops.involution import nbr_gather
from ...ops.kernels.fused_layer import Int8Calib
from ..nn_base import AtomisticNNModel
from ..zbl import ZBL
from .adaptive import get_adaptive_cutoffs, get_probe_adaptive_cutoffs
from .modules import (
    FusedTransformerLayer,
    PETModule,
    cutoff_func_bump,
    cutoff_func_cosine,
    init_flax_like,
)

CUTOFF_STATS = "mtt::aux::cutoff_stats"

DEFAULT_MODEL_HYPERS: Dict[str, Any] = {
    "cutoff": 4.5,
    "num_neighbors_adaptive": None,
    "adaptive_cutoff_method": "solver",
    "cutoff_function": "Bump",
    "cutoff_width": 0.5,
    "cutoff_width_adaptive": 1.0,
    "d_pet": 128,
    "d_head": 128,
    "d_node": 256,
    "d_feedforward": 256,
    "num_heads": 8,
    "num_attention_layers": 2,
    "num_gnn_layers": 2,
    "normalization": "RMSNorm",
    "activation": "SwiGLU",
    "attention_temperature": 1.0,
    "transformer_type": "PreLN",
    "featurizer_type": "feedforward",
    "zbl": False,
    "long_range": {"enable": False, "smearing": 1.4, "n_kmax": 4, "method": "ewald", "mesh": 32},
    "system_conditioning": False,
    "max_charge": 10,
    "max_spin_multiplicity": 10,
    "remat": False,
    "fused_layers": True,
    "fused_attention": True,
}


class PET(AtomisticNNModel):
    """Point Edge Transformer.

    :param compute_dtype: float32, bfloat16 or float64 (parameters are
        float32, or float64 for float64 compute).
    :param plain: run the plain PyTorch versions of the kernels (the
        reference the kernel path is compared against).
    :param fused_gnn: run the fused layers of each GNN layer, and the node
        stream between them, as one GNN block (the JAX package's
        ``MTT_FUSED_GNN=1``; not a hyper, not saved). Unfused
        configurations ignore it.
    :param int8_static: serve the fused layers as the static W8A8 layer
        (the JAX package's ``MTT_INT8_STATIC=1``; not a hyper, not saved):
        in bfloat16 inference calls, after :meth:`calibrate_int8`.
        Training, float32 and float64 calls run the exact layer; the GNN
        block and the unfused layers ignore it.
    :param int8_scores: the fused layers' dynamic int8 scores (the JAX
        package's ``MTT_INT8_SCORES=1``; not a hyper, not saved): q and k
        quantized by one absmax scale per block of atoms for the score
        products, in bfloat16 calls of the q-side layout (M % 8 == 0, an
        even head count), inference and training alike; a W8A8 layer that
        applies wins. float32 and float64 calls, the GNN block and the
        unfused layers ignore it.
    """

    ARCHITECTURE_NAME = "pet"
    __checkpoint_version__ = 3
    # the exported envelope's metadata, as the JAX package writes it
    __default_metadata__ = {
        "references": {
            "architecture": [
                "https://arxiv.org/abs/2305.19302",  # PET
                "https://arxiv.org/abs/2504.12353",  # PET-MAD
            ]
        }
    }

    def __init__(self, hypers: Dict[str, Any], dataset_info: DatasetInfo,
                 compute_dtype=torch.float32, plain: bool = False, fused_gnn: bool = False,
                 int8_static: bool = False, int8_scores: bool = False):
        full = copy.deepcopy(DEFAULT_MODEL_HYPERS)
        full.update(hypers or {})
        super().__init__(full, dataset_info, compute_dtype, plain=plain, fused_gnn=fused_gnn,
                         int8_static=int8_static, int8_scores=int8_scores)
        hp = self.hypers
        self.cutoff = float(hp["cutoff"])
        self.cutoff_width = float(hp["cutoff_width"])
        self.cutoff_function = hp["cutoff_function"].lower()
        self.num_neighbors_adaptive = hp["num_neighbors_adaptive"]
        self.cutoff_width_adaptive = float(hp["cutoff_width_adaptive"])
        if hp["zbl"]:
            self.zbl = ZBL(dataset_info, self.cutoff, self.cutoff_width)
        self.module = PETModule(hp, len(self.atomic_types), self.output_shapes,
                                compute_dtype, plain, fused_gnn)
        if compute_dtype == torch.float64:
            self.double()  # float64 runs keep float64 weights, as JAX's x64 mode
        for name, layer in self.fused_layers().items():
            layer.path, layer.int8_static, layer.int8_scores = name, int8_static, int8_scores

    def fused_layers(self) -> Dict[str, FusedTransformerLayer]:
        """The fused layers by module name (``backbone.gnn_layer_0.layer_1``)."""
        return {name: m for name, m in self.module.named_modules()
                if isinstance(m, FusedTransformerLayer)}

    def calibrate_int8(self, batch: SystemBatch) -> int:
        """Calibrate the static W8A8 layers on ``batch`` (the JAX package's
        probe run under ``MTT_INT8_CALIBRATE=1`` and ``calibrate_from_sow``):
        one exact forward without gradients, in which every fused layer
        records the absmaxes of ``layer_probe_stats`` on its inputs; with
        the absmaxes of its float32 weights they become its ``int8_calib``.
        Returns the number of layers calibrated (0 with the GNN block, whose
        layers are not called one by one)."""
        layers = self.fused_layers()
        for layer in layers.values():
            layer.int8_probe = []
        try:
            with torch.no_grad():
                self.module(self.preprocess(batch), tuple(self.output_shapes))
            probes = {name: layer.int8_probe for name, layer in layers.items()}
        finally:
            for layer in layers.values():
                layer.int8_probe = None
        count = 0
        for name, layer in layers.items():
            if probes[name]:
                layer.int8_calib = Int8Calib.from_stats(probes[name][0].tolist(),
                                                        layer.layer_weights())
                count += 1
        return count

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from flax's initializer families, drawn from
        ``generator`` (CPU generator; the weights are then moved)."""
        device = next(self.parameters()).device
        self.to("cpu")
        init_flax_like(self.module, generator)
        self.to(device)
        self.weights_initialized = True

    @classmethod
    def upgrade_v1_v2(cls, checkpoint):
        """v1 checkpoints predate the ``fused_layers`` default flip: their
        parameters have the unfused layers' structure. Pin the hypers that
        select the layout they were saved with."""
        hypers = dict(checkpoint["hypers"])
        hypers.setdefault("fused_layers", False)
        hypers.setdefault("remat", False)
        return dict(checkpoint, hypers=hypers)

    @classmethod
    def upgrade_v2_v3(cls, checkpoint):
        """v3 records ``fused_attention``; v2 models behaved as ``True``.
        The parameters are unchanged (the scaler section upgrades itself
        when it is read)."""
        hypers = dict(checkpoint["hypers"])
        hypers.setdefault("fused_attention", True)
        return dict(checkpoint, hypers=hypers)

    def forward(self, batch: SystemBatch, outputs: Sequence[str],
                selected_atoms: Optional[torch.Tensor] = None):
        """Adds ``mtt::aux::cutoff_stats`` to the shared outputs: per atom,
        column 0 the cutoff (the adaptive one, or the uniform cutoff of a
        non-adaptive PET) and column 1 the smoothed neighbor count (the sum
        of its cutoff factors)."""
        names = [n for n in outputs if n != CUTOFF_STATS]
        results = super().forward(batch, names, selected_atoms) if names else {}
        if CUTOFF_STATS in outputs:
            amask = batch.atom_mask if selected_atoms is None else batch.atom_mask & selected_atoms
            bd = self.preprocess(batch)
            smooth_counts = torch.sum(torch.where(bd["nbr_mask"], bd["cutoff_factors"], 0.0), dim=1)
            results[CUTOFF_STATS] = self._per_atom_feature_map(
                torch.stack([bd["atomic_cutoffs"], smooth_counts], dim=1), batch, amask)
        return results

    def requested_neighbor_cutoff(self) -> float:
        return self.cutoff

    def requested_extra_system_keys(self) -> Sequence[str]:
        if self.hypers["system_conditioning"]:
            return ("charge", "spin_multiplicity")
        return ()

    def preprocess(self, batch: SystemBatch) -> Dict[str, Any]:
        """Edge vectors, distances, cutoff factors, NEF indices, and the
        inputs of long range and system conditioning (charge 0 and spin
        multiplicity 1, a neutral singlet, where the batch has none).
        Adaptive cutoffs act through the cutoff factors, with the pair
        cutoff ``0.5 (r_i + r_j)``; no edge is dropped."""
        vectors, distances = batch.edge_vectors()
        species_index = self.species_index(batch)
        if self.num_neighbors_adaptive is not None:
            adaptive = (get_probe_adaptive_cutoffs
                        if self.hypers["adaptive_cutoff_method"] == "probe"
                        else get_adaptive_cutoffs)
            atomic_cutoffs = adaptive(distances, batch.nbr_mask,
                                      float(self.num_neighbors_adaptive), self.cutoff,
                                      self.cutoff_width_adaptive)
            nbr_cutoffs = nbr_gather(atomic_cutoffs, batch.nbr_indices, batch.nbr_reverse)
            cutoff = 0.5 * (atomic_cutoffs[:, None] + nbr_cutoffs)
        else:
            atomic_cutoffs = torch.full((batch.n_atoms_padded,), self.cutoff,
                                        dtype=distances.dtype, device=distances.device)
            cutoff = self.cutoff
        if self.cutoff_function == "bump":
            cutoff_factors = cutoff_func_bump(distances, cutoff, self.cutoff_width)
        else:
            cutoff_factors = cutoff_func_cosine(distances, cutoff, self.cutoff_width)
        S = batch.n_systems_padded
        return {
            "species_index": species_index,
            "neighbor_species_index": species_index[batch.nbr_indices],
            "edge_vectors": vectors,
            "edge_distances": distances,
            "nbr_mask": batch.nbr_mask,
            "nbr_indices": batch.nbr_indices,
            "nbr_reverse": batch.nbr_reverse,
            "cutoff_factors": torch.where(batch.nbr_mask, cutoff_factors, 0.0),
            "atomic_cutoffs": atomic_cutoffs,
            "positions": batch.positions,
            "cells": batch.cells,
            "pbc": batch.pbc,
            "system_index": batch.system_index,
            "atom_mask": batch.atom_mask,
            "charge": batch.extra.get("charge", torch.zeros(S, device=batch.device)),
            "spin_multiplicity": batch.extra.get("spin_multiplicity",
                                                 torch.ones(S, device=batch.device)),
        }
