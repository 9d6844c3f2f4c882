"""PET: Point Edge Transformer (PyTorch port).

Counterpart of ``metatrain_tpu/models/pet/model.py``: the PET defaults,
``preprocess`` (edge vectors through the gather-only position gather,
cutoff factors, NEF species indices), the network (fused or unfused
layers, feedforward or residual featurizer) and the upgrades of older
checkpoints. Forces and virial come from ``engine/evaluate.py``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import torch

from ...containers import SystemBatch
from ...data.target_info import DatasetInfo
from ..nn_base import AtomisticNNModel
from .modules import PETModule, cutoff_func_bump, cutoff_func_cosine, init_flax_like

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
    """

    ARCHITECTURE_NAME = "pet"
    __checkpoint_version__ = 3

    def __init__(self, hypers: Dict[str, Any], dataset_info: DatasetInfo,
                 compute_dtype=torch.float32, plain: bool = False, fused_gnn: bool = False):
        full = copy.deepcopy(DEFAULT_MODEL_HYPERS)
        full.update(hypers or {})
        super().__init__(full, dataset_info, compute_dtype)
        hp = self.hypers
        if hp["num_neighbors_adaptive"] is not None:
            raise NotImplementedError("adaptive cutoffs are not ported yet")
        if hp["zbl"]:
            raise NotImplementedError("the ZBL baseline is not ported yet")
        self.cutoff = float(hp["cutoff"])
        self.cutoff_width = float(hp["cutoff_width"])
        self.cutoff_function = hp["cutoff_function"].lower()
        self.module = PETModule(hp, len(self.atomic_types), self.output_shapes,
                                compute_dtype, plain, fused_gnn)
        if compute_dtype == torch.float64:
            self.double()  # float64 runs keep float64 weights, as JAX's x64 mode

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

    def requested_neighbor_cutoff(self) -> float:
        return self.cutoff

    def preprocess(self, batch: SystemBatch) -> Dict[str, Any]:
        vectors, distances = batch.edge_vectors()
        species_index = self.species_index(batch)
        if self.cutoff_function == "bump":
            cutoff_factors = cutoff_func_bump(distances, self.cutoff, self.cutoff_width)
        else:
            cutoff_factors = cutoff_func_cosine(distances, self.cutoff, self.cutoff_width)
        return {
            "species_index": species_index,
            "neighbor_species_index": species_index[batch.nbr_indices],
            "edge_vectors": vectors,
            "edge_distances": distances,
            "nbr_mask": batch.nbr_mask,
            "nbr_reverse": batch.nbr_reverse,
            "cutoff_factors": torch.where(batch.nbr_mask, cutoff_factors, 0.0),
        }
