"""In-memory datasets and train/val/test splitting.

Counterpart of ``metatrain_tpu/data/dataset.py`` (a copy; numpy only):
``Dataset``, ``DatasetView``, ``get_dataset``, ``get_dataset_info``,
``train_val_test_split`` (the same permutation from the same seed) and
``get_stats``. Disk-backed datasets (``.zip``, memmap directories) are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..containers import System, TensorMap
from .readers import read_systems, read_targets
from .target_info import DatasetInfo, TargetInfo, collect_atomic_types


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
    """Disk-backed datasets (a ``.zip`` DiskDataset or a memmap directory)
    are not ported yet: raise for them, return None for the file formats
    the frame readers handle."""
    import os

    if read_from.endswith(".zip") or read_from.rstrip("/").endswith(".memmap") or (
        os.path.isdir(read_from) and os.path.exists(os.path.join(read_from, "ns.npy"))
    ):
        raise NotImplementedError(
            f"disk-backed datasets ({read_from!r}) are not ported yet; "
            "use an extended-xyz file"
        )
    return None


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
        for name in names:
            values = np.asarray(
                sample.targets[name].block(0).values
            ).reshape(-1)
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
