"""Readers: systems and targets from files.

Counterpart of ``metatrain_tpu/data/readers/__init__.py`` (a copy: the JAX
package cannot be imported here) for the extended-xyz reader: energy
targets and generic scalar, Cartesian and spherical targets, per structure
or per atom, and any target from a metatensor ``.mts`` file (``mts.py``:
one joined TensorMap, split per system); all numeric data is float64 on
the host.

Sign conventions (as the JAX package's):

- a "forces" column is stored as the ``positions`` gradient of the energy,
  negated (gradient = -force);
- a "virial" info key is stored as the ``strain`` gradient, negated;
- a "stress" info key is stored as the ``strain`` gradient multiplied by
  the cell volume.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ...containers import Labels, System, TensorBlock, TensorMap
from ..target_info import TargetInfo, get_energy_target_info, get_generic_target_info
from .extxyz import read_xyz, write_xyz

__all__ = ["read_energy_target", "read_generic_target", "read_systems", "read_targets",
           "read_xyz", "write_xyz"]


def read_systems(path: str) -> List[System]:
    """Read all systems from a file (dispatch on extension)."""
    if path.endswith((".xyz", ".extxyz")):
        return read_xyz(path)
    raise ValueError(f"no reader for file {path!r}")


_XYZ_COMPONENTS = [Labels(["xyz"], np.arange(3, dtype=np.int32).reshape(-1, 1))]
_STRAIN_COMPONENTS = [
    Labels(["xyz_1"], np.arange(3, dtype=np.int32).reshape(-1, 1)),
    Labels(["xyz_2"], np.arange(3, dtype=np.int32).reshape(-1, 1)),
]
_ENERGY_PROPERTIES = Labels(["energy"], np.zeros((1, 1), dtype=np.int32))


def _require_extra(system: System, key: str, what: str, index: int) -> np.ndarray:
    if key not in system.extra:
        raise ValueError(
            f"{what} key {key!r} not found in system at index {index}"
        )
    return np.asarray(system.extra[key], dtype=np.float64)


def read_energy_target(
    systems: List[System],
    config: Dict[str, Any],
) -> Tuple[List[TensorMap], TargetInfo]:
    """Extract an energy target (with optional force/stress/virial gradients).

    :param systems: systems whose ``extra`` dicts hold the raw columns.
    :param config: expanded target section: keys ``key``, ``unit``,
        ``forces``/``stress``/``virial`` (dict with ``key`` or falsy).
    """
    key = config.get("key") or "energy"
    unit = config.get("unit") or ""
    forces_cfg = config.get("forces")
    stress_cfg = config.get("stress")
    virial_cfg = config.get("virial")
    if stress_cfg and virial_cfg:
        raise ValueError("cannot use both stress and virial at the same time")

    info = get_energy_target_info(
        unit=unit,
        add_position_gradients=bool(forces_cfg),
        add_strain_gradients=bool(stress_cfg or virial_cfg),
    )

    tensor_maps: List[TensorMap] = []
    for i, system in enumerate(systems):
        energy = _require_extra(system, key, "energy", i).reshape(1, 1)
        block = TensorBlock(
            values=energy,
            samples=Labels(["system"], np.array([[i]], dtype=np.int32)),
            components=[],
            properties=_ENERGY_PROPERTIES,
        )
        if forces_cfg:
            fkey = forces_cfg.get("key", "forces") if isinstance(forces_cfg, dict) else "forces"
            forces = _require_extra(system, fkey, "forces", i)
            if forces.shape != (len(system), 3):
                raise ValueError(
                    f"forces in system {i} have shape {forces.shape}, "
                    f"expected ({len(system)}, 3)"
                )
            grad = TensorBlock(
                values=(-forces).reshape(-1, 3, 1),
                samples=Labels(
                    ["sample", "system", "atom"],
                    np.stack(
                        [
                            np.zeros(len(system), dtype=np.int32),
                            np.full(len(system), i, dtype=np.int32),
                            np.arange(len(system), dtype=np.int32),
                        ],
                        axis=1,
                    ),
                ),
                components=_XYZ_COMPONENTS,
                properties=_ENERGY_PROPERTIES,
            )
            block.add_gradient("positions", grad)
        if stress_cfg or virial_cfg:
            cfg = stress_cfg or virial_cfg
            default_key = "stress" if stress_cfg else "virial"
            skey = cfg.get("key", default_key) if isinstance(cfg, dict) else default_key
            raw = _require_extra(system, skey, default_key, i).reshape(3, 3)
            if stress_cfg:
                volume = float(abs(np.linalg.det(system.cell)))
                if volume == 0.0 and not np.isnan(raw).all():
                    raise ValueError(
                        f"system {i} has zero cell volume; stress requires a cell"
                    )
                values = raw * volume
            else:
                values = -raw
            grad = TensorBlock(
                values=values.reshape(1, 3, 3, 1),
                samples=Labels(["sample"], np.array([[0]], dtype=np.int32)),
                components=_STRAIN_COMPONENTS,
                properties=_ENERGY_PROPERTIES,
            )
            block.add_gradient("strain", grad)
        tensor_maps.append(TensorMap(Labels.single(), [block]))

    return tensor_maps, info


def generic_target_info(config: Dict[str, Any]) -> TargetInfo:
    """The TargetInfo of an expanded generic target section: ``type``
    ``scalar``, ``{"cartesian": {"rank": r}}`` or ``{"spherical":
    {"irreps": [...]}}`` (a list, or the atomic-basis ``{atom_type:
    [...]}`` dict, with ``"product": "cartesian"`` for the uncoupled rank-2
    form), ``per_atom`` and ``num_subtargets``."""
    args = (int(config.get("num_subtargets", 1)), config.get("unit") or "",
            config.get("quantity") or "", bool(config.get("per_atom", False)))
    type_spec = config.get("type", "scalar")
    if type_spec == "scalar":
        return get_generic_target_info("scalar", *args)
    if isinstance(type_spec, dict) and "cartesian" in type_spec:
        return get_generic_target_info("cartesian", *args,
                                       rank=int(type_spec["cartesian"].get("rank", 1)))
    if isinstance(type_spec, dict) and "spherical" in type_spec:
        spec = type_spec["spherical"]
        return get_generic_target_info("spherical", *args, irreps=spec["irreps"],
                                       product=spec.get("product"))
    raise ValueError(f"unknown target type {type_spec!r}")


def read_generic_target(
    systems: List[System],
    config: Dict[str, Any],
) -> Tuple[List[TensorMap], TargetInfo]:
    """A generic target from the systems' ``extra`` data (extxyz ``info``
    for per-structure targets, per-atom arrays for per-atom ones): each
    sample row holds the flattened (components x properties) values of
    every block in the layout's order. An atomic-basis block (an
    ``atom_type`` key) keeps the rows of the atoms of its type, with their
    indices as its ``atom`` samples."""
    info = generic_target_info(config)
    key = config["key"]
    per_atom = info.per_atom
    type_col = (info.layout.keys.names.index("atom_type") if info.is_atomic_basis else None)
    tensor_maps: List[TensorMap] = []
    for i, system in enumerate(systems):
        n_samples = len(system) if per_atom else 1
        flat = _require_extra(system, key, f"target '{key}'", i).reshape(n_samples, -1)
        blocks, offset = [], 0
        for key_tuple, layout_block in info.layout.items():
            comp_shape = tuple(len(c) for c in layout_block.components)
            n_props = len(layout_block.properties)
            size = int(np.prod(comp_shape, initial=1)) * n_props
            chunk = flat[:, offset:offset + size]
            offset += size
            rows = np.arange(n_samples)
            if type_col is not None:
                rows = np.nonzero(np.asarray(system.types) == key_tuple[type_col])[0]
            if per_atom:
                samples = Labels(["system", "atom"], np.stack(
                    [np.full(len(rows), i, dtype=np.int32), rows.astype(np.int32)], axis=1))
            else:
                samples = Labels(["system"], np.array([[i]], dtype=np.int32))
            blocks.append(TensorBlock(
                values=chunk[rows].reshape((len(rows),) + comp_shape + (n_props,)),
                samples=samples,
                components=layout_block.components,
                properties=layout_block.properties,
            ))
        if offset != flat.shape[1]:
            raise ValueError(f"target '{key}' of system {i} has {flat.shape[1]} values per "
                             f"sample, its layout {offset}")
        tensor_maps.append(TensorMap(info.layout.keys, blocks))
    return tensor_maps, info


def read_targets(
    systems: List[System],
    target_configs: Dict[str, Dict[str, Any]],
) -> Tuple[Dict[str, List[TensorMap]], Dict[str, TargetInfo]]:
    """Read every configured target.

    Targets whose ``read_from`` differs from the systems file are read from
    that file's frames instead (frame count must match).
    """
    targets: Dict[str, List[TensorMap]] = {}
    infos: Dict[str, TargetInfo] = {}
    for name, config in target_configs.items():
        source_systems = systems
        read_from = config.get("read_from")
        is_energy = config.get("quantity", "") == "energy" or (
            name == "energy" and "type" not in config
        )
        if read_from and read_from.endswith(".mts"):
            from .mts import read_mts_target

            targets[name], infos[name] = read_mts_target(read_from, config, len(systems),
                                                         is_energy)
            continue
        if read_from:
            source_systems = read_systems(read_from)
            if len(source_systems) != len(systems):
                raise ValueError(
                    f"target '{name}' file {read_from!r} has "
                    f"{len(source_systems)} frames, expected {len(systems)}"
                )
        reader = read_energy_target if is_energy else read_generic_target
        targets[name], infos[name] = reader(source_systems, config)
    return targets, infos
