"""Readers: systems and energy targets from files.

Counterpart of ``metatrain_tpu/data/readers/__init__.py`` (a copy: the JAX
package cannot be imported here), reduced to the extended-xyz reader and
energy targets; all numeric data is float64 on the host.

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
from ..target_info import TargetInfo, get_energy_target_info
from .extxyz import read_xyz, write_xyz

__all__ = ["read_energy_target", "read_systems", "read_targets", "read_xyz", "write_xyz"]


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


def read_targets(
    systems: List[System],
    target_configs: Dict[str, Dict[str, Any]],
) -> Tuple[Dict[str, List[TensorMap]], Dict[str, TargetInfo]]:
    """Read every configured target (energy targets only in the port).

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
            raise NotImplementedError("the metatensor (.mts) target reader is not ported yet")
        if not is_energy:
            raise NotImplementedError(
                f"target '{name}': the port reads energy targets only"
            )
        if read_from:
            source_systems = read_systems(read_from)
            if len(source_systems) != len(systems):
                raise ValueError(
                    f"target '{name}' file {read_from!r} has "
                    f"{len(source_systems)} frames, expected {len(systems)}"
                )
        targets[name], infos[name] = read_energy_target(source_systems, config)
    return targets, infos
