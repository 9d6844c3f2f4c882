"""In-memory datasets and train/val/test splitting.

Counterpart of ``metatrain_tpu/data/dataset.py`` (a copy; numpy only):
``Dataset``, ``DatasetView``, ``get_dataset``, ``get_dataset_info``,
``train_val_test_split`` (the same permutation from the same seed) and
``get_stats``. ``get_dataset`` also opens the disk-backed datasets of
``data/disk.py`` (a ``.zip`` or a memmap directory), which serve their
samples one at a time through the same ``iter_samples`` and
``DatasetView``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..containers import System, TensorMap
from .readers import read_systems, read_targets
from .target_info import DatasetInfo, TargetInfo, collect_atomic_types, get_energy_target_info


@dataclasses.dataclass
class Sample:
    """One dataset entry: a system plus its target TensorMaps."""

    system: System
    targets: Dict[str, TensorMap]
    extra_data: Dict[str, TensorMap] = dataclasses.field(default_factory=dict)


class Dataset:
    """A list of systems with aligned targets.

    :param systems: host systems.
    :param targets: target name -> one TensorMap per system.
    """

    def __init__(
        self,
        systems: Sequence[System],
        targets: Dict[str, List[TensorMap]],
        extra_data: Optional[Dict[str, List[TensorMap]]] = None,
    ):
        for name, maps in targets.items():
            if len(maps) != len(systems):
                raise ValueError(
                    f"target '{name}' has {len(maps)} entries "
                    f"for {len(systems)} systems"
                )
        self.systems = list(systems)
        self.targets = {k: list(v) for k, v in targets.items()}
        self.extra_data = {k: list(v) for k, v in (extra_data or {}).items()}

    def __len__(self) -> int:
        return len(self.systems)

    def __getitem__(self, index: int) -> Sample:
        return Sample(
            system=self.systems[index],
            targets={k: v[index] for k, v in self.targets.items()},
            extra_data={k: v[index] for k, v in self.extra_data.items()},
        )

    def select(self, indices: Sequence[int]) -> "Dataset":
        indices = list(indices)
        return Dataset(
            [self.systems[i] for i in indices],
            {k: [v[i] for i in indices] for k, v in self.targets.items()},
            {k: [v[i] for i in indices] for k, v in self.extra_data.items()},
        )

    @property
    def atom_counts(self) -> np.ndarray:
        return np.array([len(s) for s in self.systems], dtype=np.int64)

    @property
    def target_names(self) -> List[str]:
        return list(self.targets)


def dataset_target_names(dataset) -> List[str]:
    """Target names of any dataset-like object WITHOUT materializing
    disk-backed targets (their ``.targets`` property reads every sample)."""
    names = getattr(dataset, "target_names", None)
    if names is not None:
        return list(names)
    return list(dataset.targets)


def iter_samples(dataset):
    """Stream samples one at a time (O(1 sample) memory on disk-backed
    datasets; the fitting passes use this instead of ``.systems`` /
    ``.targets``, which materialize everything)."""
    for i in range(len(dataset)):
        yield dataset[i]


class DatasetView:
    """Lazy index view over any dataset-like object (in-memory or
    disk-backed): keeps the base's laziness through train/val/test
    splitting (reference ``Subset`` semantics)."""

    def __init__(self, base, indices: Sequence[int]):
        self.base = base
        self.indices = np.asarray(list(indices), dtype=np.int64)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, index: int) -> Sample:
        return self.base[int(self.indices[index])]

    def select(self, indices: Sequence[int]) -> "DatasetView":
        return DatasetView(self.base, [self.indices[i] for i in indices])

    @property
    def atom_counts(self) -> np.ndarray:
        return np.asarray(self.base.atom_counts)[self.indices]

    @property
    def systems(self) -> List[System]:
        return [self[i].system for i in range(len(self))]

    @property
    def target_names(self) -> List[str]:
        return dataset_target_names(self.base)

    @property
    def targets(self) -> Dict[str, List[TensorMap]]:
        samples = [self[i] for i in range(len(self))]
        return {
            name: [s.targets[name] for s in samples]
            for name in self.target_names
        }

    @property
    def extra_data(self) -> Dict[str, List[TensorMap]]:
        base_extra = getattr(self.base, "extra_data", {})
        return {
            name: [self[i].extra_data.get(name) for i in range(len(self))]
            for name in base_extra
        }


def get_dataset(
    config: Dict[str, Any],
) -> Tuple[Dataset, Dict[str, TargetInfo]]:
    """Build a dataset from one expanded dataset config section.

    :param config: dict with ``systems: {read_from: ...}`` and
        ``targets: {name: {...}}`` (see readers); mirrors the canonical
        expanded form of the reference config
        (``utils/omegaconf.py:149-430``).
    """
    systems_cfg = config["systems"]
    if isinstance(systems_cfg, str):
        systems_cfg = {"read_from": systems_cfg}
    read_from = str(systems_cfg["read_from"])

    # disk-backed datasets carry systems AND targets in one source
    # (reference DiskDataset/MemmapDataset dispatch, get_dataset.py:12)
    disk = _open_disk_dataset(read_from, config.get("targets", {}))
    if disk is not None:
        return disk

    systems = read_systems(read_from)

    targets, target_infos = read_targets(systems, config.get("targets", {}))

    extra_data = {}
    extra_infos: Dict[str, TargetInfo] = {}
    if config.get("extra_data"):
        extra_data, extra_infos = read_targets(systems, config["extra_data"])

    dataset = Dataset(systems, targets, extra_data)
    dataset.extra_infos = extra_infos  # type: ignore[attr-defined]
    return dataset, target_infos


def _open_disk_dataset(read_from: str, target_config: Dict[str, Any]):
    """Open a ``.zip`` DiskDataset or a memmap directory (a name ending in
    ``.memmap``, or a directory holding ``ns.npy``) with its TargetInfos,
    or return None for the file formats the frame readers handle.

    These formats store per-structure scalar targets with optional
    position and strain gradients, so the target metadata comes from what
    is stored; the ``targets:`` section may restrict the names and set
    ``unit``, but a section asking for what the format cannot hold
    (``per_atom``, a ``type`` other than scalar) is an error."""
    import os

    from .disk import DiskDataset, MemmapDataset

    if read_from.endswith(".zip"):
        dataset = DiskDataset(read_from)
    elif read_from.rstrip("/").endswith(".memmap") or (
        os.path.isdir(read_from) and os.path.exists(os.path.join(read_from, "ns.npy"))
    ):
        dataset = MemmapDataset(read_from, target_names=tuple(target_config) or ("energy",))
    else:
        return None

    infos = dataset.infer_target_infos()
    if target_config:
        missing = set(target_config) - set(infos)
        if missing:
            raise ValueError(
                f"targets {sorted(missing)} not found in disk dataset {read_from!r} "
                f"(stored targets: {sorted(infos)})"
            )
        for name, cfg in target_config.items():
            cfg = cfg or {}
            if cfg.get("per_atom"):
                raise ValueError(
                    f"target '{name}': disk datasets store per-structure scalar targets; "
                    "per_atom targets are not supported by this format"
                )
            type_spec = cfg.get("type", "scalar")
            if type_spec not in (None, "scalar"):
                raise ValueError(
                    f"target '{name}': disk datasets store scalar targets; "
                    f"type {type_spec!r} is not supported by this format"
                )
            if cfg.get("unit") or cfg.get("quantity"):
                info = infos[name]
                infos[name] = get_energy_target_info(
                    cfg.get("unit") or info.unit,
                    add_position_gradients="positions" in info.gradients,
                    add_strain_gradients="strain" in info.gradients,
                )
        infos = {name: infos[name] for name in target_config}
    dataset.target_infos = infos
    return dataset, infos


def get_dataset_info(
    datasets: Sequence[Dataset],
    target_infos: Dict[str, TargetInfo],
    length_unit: str = "",
) -> DatasetInfo:
    types: set = set()
    for ds in datasets:
        types |= collect_atomic_types(
            sample.system for sample in iter_samples(ds)
        )
    return DatasetInfo(
        length_unit=length_unit, atomic_types=sorted(types), targets=target_infos
    )


def train_val_test_split(
    dataset: Dataset,
    train_fraction: Optional[float] = None,
    val_fraction: float = 0.1,
    test_fraction: float = 0.0,
    seed: int = 0,
) -> Tuple[Dataset, Dataset, Dataset]:
    """Random fraction split (reference: ``cli/train.py:337-540``)."""
    n = len(dataset)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = int(round(val_fraction * n))
    n_test = int(round(test_fraction * n))
    n_train = n - n_val - n_test if train_fraction is None else int(
        round(train_fraction * n)
    )
    if n_train + n_val + n_test > n:
        raise ValueError("split fractions exceed dataset size")
    train_idx = perm[:n_train]
    val_idx = perm[n_train : n_train + n_val]
    test_idx = perm[n_train + n_val : n_train + n_val + n_test]
    return (
        dataset.select(train_idx),
        dataset.select(val_idx),
        dataset.select(test_idx),
    )


def get_stats(dataset: Dataset, dataset_info: DatasetInfo) -> str:
    """Human-readable dataset statistics (reference ``dataset.py`` get_stats)."""
    counts = dataset.atom_counts
    lines = [
        f"Dataset with {len(dataset)} structures, "
        f"{int(counts.sum())} atoms "
        f"(min {int(counts.min(initial=0))} / "
        f"mean {counts.mean() if len(counts) else 0:.1f} / "
        f"max {int(counts.max(initial=0))} per structure)",
        f"Atomic types: {dataset_info.atomic_types}",
    ]
    # streaming moments: one pass, O(1 sample) memory on disk datasets
    names = dataset_target_names(dataset)
    acc = {name: [0.0, 0.0, 0] for name in names}  # sum, sumsq, n
    for sample in iter_samples(dataset):
        for name in names:  # every block of the target
            for block in sample.targets[name].blocks():
                values = np.asarray(block.values).reshape(-1)
                acc[name][0] += float(values.sum())
                acc[name][1] += float((values**2).sum())
                acc[name][2] += values.size
    for name in names:
        info = dataset_info.targets.get(name)
        unit = f" [{info.unit}]" if info and info.unit else ""
        total, sumsq, n = acc[name]
        mean = total / n if n else 0.0
        std = np.sqrt(max(sumsq / n - mean**2, 0.0)) if n else 0.0
        lines.append(
            f"Target '{name}'{unit}: mean {mean:.6g}, std {std:.6g}"
        )
    return "\n".join(lines)
