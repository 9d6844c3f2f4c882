"""Target metadata: ``TargetInfo``, ``DatasetInfo`` and the energy factory.

Counterpart of ``metatrain_tpu/data/target_info.py``, reduced to energy
targets: a target's structure is a zero-sample layout TensorMap, from
which the sample kind and the requested gradients are read.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Set

import numpy as np
import torch

from ..containers import Labels, TensorBlock, TensorMap

_VALID_GRADIENTS = ("positions", "strain")


def _empty_block(sample_names, components, properties) -> TensorBlock:
    shape = (0,) + tuple(len(c) for c in components) + (len(properties),)
    return TensorBlock(
        values=torch.zeros(shape, dtype=torch.float64),
        samples=Labels.empty(sample_names),
        components=components,
        properties=properties,
    )


class TargetInfo:
    """Information about one target, read from its zero-sample layout."""

    def __init__(self, layout: TensorMap, quantity: str = "", unit: str = ""):
        self.layout = layout
        self.quantity = quantity
        self.unit = unit or ""
        for _, block in layout.items():
            for name in block.gradients_list():
                if name not in _VALID_GRADIENTS:
                    raise ValueError(
                        f"gradient '{name}' not supported; valid: {_VALID_GRADIENTS}"
                    )

    @property
    def is_scalar(self) -> bool:
        return len(self.layout.block(0).components) == 0

    @property
    def gradients(self) -> List[str]:
        return self.layout.block(0).gradients_list() if self.is_scalar else []

    @property
    def per_atom(self) -> bool:
        return "atom" in self.layout.block(0).samples.names

    @property
    def is_energy(self) -> bool:
        """A per-structure scalar target with one block (what the energy
        engine, the composition and the scaler baselines handle)."""
        return self.is_scalar and not self.per_atom and len(self.layout) == 1

    def __repr__(self) -> str:
        return (
            f"TargetInfo(quantity='{self.quantity}', unit='{self.unit}', "
            f"per_atom={self.per_atom}, gradients={self.gradients})"
        )


def get_energy_target_info(
    unit: str = "",
    add_position_gradients: bool = False,
    add_strain_gradients: bool = False,
) -> TargetInfo:
    """TargetInfo for a per-structure energy with optional force/stress
    gradients."""
    xyz = Labels(["xyz"], np.arange(3, dtype=np.int32).reshape(-1, 1))
    properties = Labels(["energy"], np.zeros((1, 1), dtype=np.int32))
    block = _empty_block(["system"], [], properties)
    if add_position_gradients:
        block.add_gradient(
            "positions", _empty_block(["sample", "system", "atom"], [xyz], properties)
        )
    if add_strain_gradients:
        block.add_gradient(
            "strain",
            _empty_block(
                ["sample"],
                [
                    Labels(["xyz_1"], np.arange(3, dtype=np.int32).reshape(-1, 1)),
                    Labels(["xyz_2"], np.arange(3, dtype=np.int32).reshape(-1, 1)),
                ],
                properties,
            ),
        )
    return TargetInfo(TensorMap(Labels.single(), [block]), "energy", unit)


class DatasetInfo:
    """Length unit, atomic types and targets shared by a run."""

    def __init__(
        self,
        length_unit: str,
        atomic_types: Sequence[int],
        targets: Dict[str, TargetInfo],
    ):
        self.length_unit = length_unit or ""
        self.atomic_types = sorted(set(int(t) for t in atomic_types))
        self.targets = dict(targets)

    def to_dict(self) -> dict:
        """The ``dataset_info`` section of a checkpoint, in the JAX
        package's format."""
        return {
            "length_unit": self.length_unit,
            "atomic_types": self.atomic_types,
            "targets": {k: _target_info_to_dict(v) for k, v in self.targets.items()},
            "extra_data": {},
        }

    @staticmethod
    def from_dict(data: dict) -> "DatasetInfo":
        """Read the ``dataset_info`` section of a checkpoint."""
        return DatasetInfo(
            length_unit=data["length_unit"],
            atomic_types=data["atomic_types"],
            targets={
                k: _target_info_from_dict(v) for k, v in data["targets"].items()
            },
        )


def collect_atomic_types(systems: Iterable) -> Set[int]:
    types: Set[int] = set()
    for system in systems:
        types.update(int(t) for t in np.unique(system.types))
    return types


def _labels_to_dict(labels: Labels) -> dict:
    return {"names": list(labels.names), "values": np.asarray(labels.values).tolist()}


def _target_info_to_dict(info: TargetInfo) -> dict:
    def block_dict(block):
        return {
            "samples": list(block.samples.names),
            "components": [_labels_to_dict(c) for c in block.components],
            "properties": _labels_to_dict(block.properties),
        }

    return {
        "quantity": info.quantity,
        "unit": info.unit,
        "keys": _labels_to_dict(info.layout.keys),
        "blocks": [
            {**block_dict(block),
             "gradients": {name: block_dict(g) for name, g in block.gradients()}}
            for _, block in info.layout.items()
        ],
    }


def _labels_from_dict(d: dict) -> Labels:
    return Labels(
        d["names"],
        np.asarray(d["values"], dtype=np.int32).reshape(-1, len(d["names"])),
    )


def _target_info_from_dict(data: dict) -> TargetInfo:
    blocks = []
    for bd in data["blocks"]:
        block = _empty_block(
            bd["samples"],
            [_labels_from_dict(c) for c in bd["components"]],
            _labels_from_dict(bd["properties"]),
        )
        for name, gd in bd["gradients"].items():
            block.add_gradient(
                name,
                _empty_block(
                    gd["samples"],
                    [_labels_from_dict(c) for c in gd["components"]],
                    _labels_from_dict(gd["properties"]),
                ),
            )
        blocks.append(block)
    return TargetInfo(
        TensorMap(_labels_from_dict(data["keys"]), blocks),
        quantity=data["quantity"],
        unit=data["unit"],
    )
