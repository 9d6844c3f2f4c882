"""Target metadata: ``TargetInfo``, ``DatasetInfo`` and their factories.

Counterpart of ``metatrain_tpu/data/target_info.py``: a target's
structure is a zero-sample layout TensorMap, from which its kind (scalar,
Cartesian, spherical, atomic basis), its sample kind (system, atom, atom
pair) and the requested gradients are read. ``get_generic_target_info``
builds the layouts of scalar, Cartesian rank 1 and 2 and spherical
targets (one block per irrep; ``product="cartesian"`` pairs; the
atomic-basis dict form keyed by ``atom_type``).
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Set

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


def _range_labels(name: str, start: int, stop: int) -> Labels:
    return Labels([name], np.arange(start, stop, dtype=np.int32).reshape(-1, 1))


class TargetInfo:
    """Information about one target, read from its zero-sample layout.

    ``is_scalar`` (no components), ``is_spherical`` (``o3_mu`` or
    ``o3_mu_1``/``o3_mu_2`` components), ``is_cartesian`` (``xyz``
    components) and ``is_atomic_basis`` (an ``atom_type`` key column).
    """

    def __init__(self, layout: TensorMap, quantity: str = "", unit: str = ""):
        self.layout = layout
        self.quantity = quantity
        self.unit = unit or ""
        if not len(layout):
            raise ValueError("TargetInfo layout needs at least one block")
        comp_names = [c.names for c in layout.block(0).components]
        self.is_scalar = not comp_names
        self.is_spherical = any(str(n).startswith("o3_mu") for names in comp_names
                                for n in names)
        self.is_cartesian = bool(comp_names) and not self.is_spherical and all(
            names[0].startswith("xyz") for names in comp_names if names)
        self.is_atomic_basis = "atom_type" in layout.keys.names
        if comp_names and not (self.is_spherical or self.is_cartesian):
            raise ValueError(f"cannot classify target with components {comp_names}")
        for _, block in layout.items():
            for name in block.gradients_list():
                if name not in _VALID_GRADIENTS:
                    raise ValueError(
                        f"gradient '{name}' not supported; valid: {_VALID_GRADIENTS}"
                    )

    @property
    def gradients(self) -> List[str]:
        return self.layout.block(0).gradients_list() if self.is_scalar else []

    @property
    def sample_kind(self) -> str:
        names = self.layout.block(0).samples.names
        if "atom" in names:
            return "atom"
        if "first_atom" in names:
            return "atom_pair"
        return "system"

    @property
    def per_atom(self) -> bool:
        return self.sample_kind == "atom"

    @property
    def rank(self) -> int:
        return len(self.layout.block(0).components)

    def __repr__(self) -> str:
        kind = "scalar" if self.is_scalar else "cartesian" if self.is_cartesian else "spherical"
        return (
            f"TargetInfo({kind}, sample_kind={self.sample_kind}, "
            f"quantity='{self.quantity}', unit='{self.unit}', gradients={self.gradients})"
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, TargetInfo):
            return NotImplemented
        return (
            self.quantity == other.quantity
            and self.unit == other.unit
            and self.layout.keys == other.layout.keys
            and all(
                a.samples.names == b.samples.names
                and a.components == b.components
                and a.properties == b.properties
                and a.gradients_list() == b.gradients_list()
                for a, b in zip(self.layout.blocks(), other.layout.blocks())
            )
        )


def get_energy_target_info(
    unit: str = "",
    add_position_gradients: bool = False,
    add_strain_gradients: bool = False,
    per_atom: bool = False,
) -> TargetInfo:
    """TargetInfo for an energy(-like) scalar with optional force/stress
    gradients: position gradients carry an (atom, xyz) structure, strain
    gradients (xyz_1, xyz_2) components."""
    properties = Labels(["energy"], np.zeros((1, 1), dtype=np.int32))
    block = _empty_block(["system", "atom"] if per_atom else ["system"], [], properties)
    if add_position_gradients:
        block.add_gradient(
            "positions",
            _empty_block(["sample", "system", "atom"], [_range_labels("xyz", 0, 3)], properties),
        )
    if add_strain_gradients:
        block.add_gradient(
            "strain",
            _empty_block(["sample"], [_range_labels("xyz_1", 0, 3), _range_labels("xyz_2", 0, 3)],
                         properties),
        )
    return TargetInfo(TensorMap(Labels.single(), [block]), "energy", unit)


def get_generic_target_info(
    target_type: str,
    num_properties: int = 1,
    unit: str = "",
    quantity: str = "",
    per_atom: bool = False,
    rank: int = 1,
    irreps=None,
    property_name: str = "properties",
    product: Optional[str] = None,
) -> TargetInfo:
    """TargetInfo for scalar, Cartesian and spherical targets.

    :param target_type: "scalar", "cartesian" or "spherical".
    :param rank: Cartesian rank (1: ``xyz``; 2: ``xyz_1`` x ``xyz_2``).
    :param irreps: spherical targets: a list of ``{"o3_lambda": l,
        "o3_sigma": s}``, one block per irrep; an atomic-basis target
        passes ``{atom_type: [{"num": n, "o3_lambda": l, "o3_sigma": s},
        ...]}`` instead (per-atom samples, an ``atom_type`` key column,
        ``num`` multiplying the property count).
    :param product: ``"cartesian"``: a rank-2 spherical tensor in the
        uncoupled basis, one block per ordered irrep pair (keys
        ``o3_lambda_1, o3_lambda_2, o3_sigma_1, o3_sigma_2``, components
        ``o3_mu_1`` x ``o3_mu_2``, properties ``n_1`` x ``n_2``).
    """
    sample_names = ["system", "atom"] if per_atom else ["system"]
    properties = _range_labels(property_name, 0, num_properties)

    if target_type == "scalar":
        layout = TensorMap(Labels.single(), [_empty_block(sample_names, [], properties)])
    elif target_type == "cartesian":
        components = ([_range_labels("xyz", 0, 3)] if rank == 1
                      else [_range_labels(f"xyz_{i + 1}", 0, 3) for i in range(rank)])
        layout = TensorMap(Labels.single(), [_empty_block(sample_names, components, properties)])
    elif target_type == "spherical" and product == "cartesian":
        if not irreps:
            raise ValueError("spherical product targets need `irreps`")

        def pair_blocks(irrep_list, extra_key=()):
            rows, blocks = [], []
            for ir1, ir2 in itertools.product(irrep_list, irrep_list):
                l1, s1 = int(ir1["o3_lambda"]), int(ir1.get("o3_sigma", 1))
                l2, s2 = int(ir2["o3_lambda"]), int(ir2.get("o3_sigma", 1))
                n1 = int(ir1.get("num", 1)) * num_properties
                n2 = int(ir2.get("num", 1)) * num_properties
                rows.append([l1, l2, s1, s2, *extra_key])
                props = Labels(["n_1", "n_2"], np.array(
                    [[i, j] for i in range(n1) for j in range(n2)], dtype=np.int32).reshape(-1, 2))
                blocks.append(_empty_block(
                    sample_names,
                    [_range_labels("o3_mu_1", -l1, l1 + 1), _range_labels("o3_mu_2", -l2, l2 + 1)],
                    props))
            return rows, blocks

        names = ["o3_lambda_1", "o3_lambda_2", "o3_sigma_1", "o3_sigma_2"]
        if isinstance(irreps, dict):
            if not per_atom:
                raise ValueError("atomic-basis spherical targets are per-atom")
            key_rows, blocks = [], []
            for atom_type in sorted(int(t) for t in irreps):
                rows, blks = pair_blocks(_irreps_of(irreps, atom_type), (atom_type,))
                key_rows += rows
                blocks += blks
            names = names + ["atom_type"]
        else:
            key_rows, blocks = pair_blocks(list(irreps))
        layout = TensorMap(Labels(names, np.array(key_rows, dtype=np.int32)), blocks)
    elif target_type == "spherical" and isinstance(irreps, dict):
        if not per_atom:
            raise ValueError("atomic-basis spherical targets are per-atom")
        key_rows, blocks = [], []
        for atom_type in sorted(int(t) for t in irreps):
            for ir in _irreps_of(irreps, atom_type):
                lam, sig = int(ir["o3_lambda"]), int(ir.get("o3_sigma", 1))
                key_rows.append([lam, sig, atom_type])
                blocks.append(_empty_block(
                    sample_names, [_range_labels("o3_mu", -lam, lam + 1)],
                    _range_labels(property_name, 0, int(ir.get("num", 1)) * num_properties)))
        layout = TensorMap(Labels(["o3_lambda", "o3_sigma", "atom_type"],
                                  np.array(key_rows, dtype=np.int32)), blocks)
    elif target_type == "spherical":
        if not irreps:
            raise ValueError("spherical targets need `irreps`")
        keys = Labels(["o3_lambda", "o3_sigma"], np.array(
            [[ir["o3_lambda"], ir["o3_sigma"]] for ir in irreps], dtype=np.int32))
        blocks = [_empty_block(sample_names,
                               [_range_labels("o3_mu", -ir["o3_lambda"], ir["o3_lambda"] + 1)],
                               properties) for ir in irreps]
        layout = TensorMap(keys, blocks)
    else:
        raise ValueError(f"unknown target type {target_type!r}")
    return TargetInfo(layout, quantity=quantity, unit=unit)


def _irreps_of(irreps: dict, atom_type: int):
    """The irreps of ``atom_type`` in an atomic-basis dict, whose keys may
    be ints or (from JSON or YAML) strings."""
    return irreps[atom_type] if atom_type in irreps else irreps[str(atom_type)]


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

    def __eq__(self, other) -> bool:
        if not isinstance(other, DatasetInfo):
            return NotImplemented
        return (
            self.length_unit == other.length_unit
            and self.atomic_types == other.atomic_types
            and self.targets == other.targets
        )

    def union(self, other: "DatasetInfo") -> "DatasetInfo":
        """Both infos' atomic types and targets (the length units and any
        shared target must agree)."""
        if self.length_unit != other.length_unit:
            raise ValueError(
                f"length units differ: '{self.length_unit}' vs '{other.length_unit}'"
            )
        targets = dict(self.targets)
        for name, info in other.targets.items():
            if name in targets and targets[name] != info:
                raise ValueError(f"target '{name}' differs between datasets")
            targets[name] = info
        return DatasetInfo(self.length_unit, set(self.atomic_types) | set(other.atomic_types),
                           targets)

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
