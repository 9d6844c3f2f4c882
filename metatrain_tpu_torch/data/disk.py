"""Disk-backed datasets: zip archives and binary memmaps.

Counterpart of ``metatrain_tpu/data/disk.py`` (a copy on the port's
containers; numpy only). Both datasets serve :class:`~.dataset.Sample`
objects one at a time, so a dataset of millions of structures is never
held in memory: the trainer, ``get_stats`` and ``eval`` take them through
``iter_samples`` and ``DatasetView`` as they take an in-memory one.

Zip format (``.zip``, :class:`DiskDatasetWriter` / :class:`DiskDataset`):
member ``{i}/system.npz`` holds positions, types, cell and pbc;
``{i}/{target}.npz`` the target's ``values`` (and optional
``positions_gradient`` / ``strain_gradient``); ``metadata/atom_counts.npy``
the atom counts, for length-aware batching without reading the members.
Zips of metatrain's own layout (``{i}/system.mta`` and ``{i}/{target}.mts``)
load as they are.

Memmap format (a directory, :class:`MemmapDataset` /
:func:`write_memmap_dataset`): ``ns.npy`` (int64 scalar), ``na.npy``
(int64[ns]), ``x.bin`` (float64 positions), ``a.bin`` (int32 types),
``c.bin`` (float64 cells), ``p.bin`` (bool pbc), a ``{name}.bin`` of
float64 per structure for each target, ``forces.bin`` (float64 per atom,
the energy's) and optional ``momenta.bin`` / ``masses.bin``.
"""

from __future__ import annotations

import io
import logging
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..containers import Labels, System, TensorBlock, TensorMap
from .dataset import DatasetView, Sample
from .smart_zip import SmartZip
from .target_info import TargetInfo, _empty_block, get_energy_target_info

_XYZ = Labels(["xyz"], np.arange(3, dtype=np.int32).reshape(-1, 1))
_STRAIN = [
    Labels(["xyz_1"], np.arange(3, dtype=np.int32).reshape(-1, 1)),
    Labels(["xyz_2"], np.arange(3, dtype=np.int32).reshape(-1, 1)),
]
_E_PROPS = Labels(["energy"], np.zeros((1, 1), dtype=np.int32))


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


class DiskDatasetWriter:
    """Stream systems and their targets into a zip archive."""

    def __init__(self, path: str):
        self.zipf = zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED)
        self._count = 0
        self._atom_counts: List[int] = []

    def write(self, system: System, targets: Dict[str, Dict[str, np.ndarray]]):
        """Append one system; ``targets`` maps each name to its fields
        (``values`` and optional ``positions_gradient`` /
        ``strain_gradient``)."""
        i = self._count
        self.zipf.writestr(f"{i}/system.npz", _npz_bytes(
            positions=system.positions, types=system.types, cell=system.cell, pbc=system.pbc))
        for name, fields in targets.items():
            self.zipf.writestr(f"{i}/{name}.npz", _npz_bytes(**fields))
        self._atom_counts.append(len(system))
        self._count += 1

    def close(self):
        buf = io.BytesIO()
        np.save(buf, np.asarray(self._atom_counts, dtype=np.int64))
        self.zipf.writestr("metadata/atom_counts.npy", buf.getvalue())
        self.zipf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DiskDataset:
    """Zip-backed dataset, each member read when its sample is asked for.

    The member layout is detected: this package's (``{i}/system.npz`` and
    ``{i}/{target}.npz``) or metatrain's (``{i}/system.mta`` and
    ``{i}/{target}.mts``). Members of any other name are skipped with a
    warning.

    :param target_infos: target name -> TargetInfo; by default they come
        from :meth:`infer_target_infos`.
    """

    def __init__(self, path: str, target_infos: Optional[Dict[str, TargetInfo]] = None):
        self.path = str(path)
        self.zipf = SmartZip(self.path)
        names = self.zipf.namelist()
        self._reference_layout = any(n.endswith("/system.mta") for n in names)
        suffix = ".mts" if self._reference_layout else ".npz"
        sysname = "system" + (".mta" if self._reference_layout else ".npz")
        # only ``<N>/<field><suffix>``, N an unpadded decimal, one level deep
        target_names, system_indices, skipped = set(), set(), []
        for n in names:
            if n.startswith("metadata/"):
                continue
            parts = n.split("/")
            if (len(parts) != 2 or not parts[0].isdigit() or parts[0] != str(int(parts[0]))
                    or not parts[1].endswith(suffix)):
                skipped.append(n)
                continue
            if parts[1] == sysname:
                system_indices.add(int(parts[0]))
            else:
                target_names.add(parts[1].removesuffix(suffix))
        if skipped:
            logging.getLogger(__name__).warning(
                "ignoring %d non-dataset member(s) in %s (e.g. %r)",
                len(skipped), self.path, skipped[0])
        self.target_names = sorted(target_names)
        if "metadata/atom_counts.npy" in names:
            self._atom_counts = np.load(io.BytesIO(self.zipf.read("metadata/atom_counts.npy")))
            self._len = len(self._atom_counts)
        else:  # counted from the members, the atom counts read when asked for
            self._len = len(system_indices)
            if system_indices and (min(system_indices) != 0
                                   or max(system_indices) != self._len - 1):
                raise ValueError(
                    f"{self.path}: system members are not contiguously numbered from 0")
            self._atom_counts = None
        self.target_infos = target_infos or {}

    def __len__(self) -> int:
        return self._len

    @property
    def atom_counts(self) -> np.ndarray:
        if self._atom_counts is None:
            self._atom_counts = np.asarray([len(self[i].system) for i in range(len(self))],
                                           dtype=np.int64)
        return self._atom_counts

    @property
    def systems(self) -> List[System]:
        return [self[i].system for i in range(len(self))]

    @property
    def targets(self) -> Dict[str, List[TensorMap]]:
        """Every sample's targets (reads the whole archive)."""
        return {name: [self[i].targets[name] for i in range(len(self))]
                for name in self.target_names}

    def _load_npz(self, member: str) -> Dict[str, np.ndarray]:
        with np.load(io.BytesIO(self.zipf.read(member))) as data:
            return {k: data[k] for k in data.files}

    def __getitem__(self, index: int) -> Sample:
        if self._reference_layout:
            from .readers.mts import load_mta_bytes, load_mts_bytes

            system = load_mta_bytes(self.zipf.read(f"{index}/system.mta"))
            return Sample(system, {name: load_mts_bytes(self.zipf.read(f"{index}/{name}.mts"))
                                   for name in self.target_names})
        raw = self._load_npz(f"{index}/system.npz")
        system = System(raw["positions"], raw["types"], raw["cell"], raw["pbc"])
        return Sample(system, {
            name: _fields_to_tensormap(self._load_npz(f"{index}/{name}.npz"), index, len(system))
            for name in self.target_names})

    def infer_target_infos(self) -> Dict[str, TargetInfo]:
        """TargetInfos from the first sample: an energy with the stored
        gradients, or (metatrain's layout, not an energy) the stored map's
        own layout."""
        if not len(self):
            return {}
        infos = {}
        for name, tmap in self[0].targets.items():
            block = tmap.block(0)
            if self._reference_layout and not _is_energy_layout(name, tmap):
                infos[name] = _info_from_tensormap(tmap)
            else:
                infos[name] = get_energy_target_info(
                    "eV", add_position_gradients=block.has_gradient("positions"),
                    add_strain_gradients=block.has_gradient("strain"))
        return infos

    @property
    def extra_data(self) -> Dict:
        return {}

    def select(self, indices) -> DatasetView:
        return DatasetView(self, indices)


def _is_energy_layout(name: str, tmap: TensorMap) -> bool:
    """Whether a metatrain-layout target is an energy: one per-structure
    scalar block of one property, with gradients or named ``energy``."""
    if len(tmap) != 1:
        return False
    block = tmap.block(0)
    if block.components or "atom" in block.samples.names:
        return False
    if np.asarray(block.values).shape[-1] != 1:
        return False
    return bool(block.gradients_list()) or name == "energy"


def _info_from_tensormap(tmap: TensorMap) -> TargetInfo:
    """A zero-sample TargetInfo layout with the structure of ``tmap`` (keys,
    sample names, components, properties, gradients)."""
    blocks = []
    for _, block in tmap.items():
        nb = _empty_block(block.samples.names, block.components, block.properties)
        for gname, grad in block.gradients():
            nb.add_gradient(gname, _empty_block(grad.samples.names, grad.components,
                                                grad.properties))
        blocks.append(nb)
    return TargetInfo(TensorMap(tmap.keys, blocks))


def _fields_to_tensormap(fields: Dict[str, np.ndarray], index: int, n_atoms: int) -> TensorMap:
    values = np.asarray(fields["values"], dtype=np.float64).reshape(1, -1)
    block = TensorBlock(
        values=values,
        samples=Labels(["system"], np.array([[index]], dtype=np.int32)),
        components=[],
        properties=Labels.range("energy", values.shape[-1]),
    )
    if "positions_gradient" in fields:
        grad = np.asarray(fields["positions_gradient"], dtype=np.float64)
        block.add_gradient("positions", TensorBlock(
            grad.reshape(n_atoms, 3, -1), Labels.range("atom", n_atoms), [_XYZ], _E_PROPS))
    if "strain_gradient" in fields:
        grad = np.asarray(fields["strain_gradient"], dtype=np.float64)
        block.add_gradient("strain", TensorBlock(
            grad.reshape(1, 3, 3, -1), Labels(["sample"], np.array([[0]], dtype=np.int32)),
            _STRAIN, _E_PROPS))
    return TensorMap(Labels.single(), [block])


class MemmapDataset:
    """Binary memmap dataset: each sample sliced from the memory-mapped
    files when it is asked for.

    :param directory: the dataset directory (``ns.npy``, ``na.npy``, ...).
    :param target_names: the per-structure targets to serve (those with a
        ``{name}.bin``); ``forces.bin`` belongs to the one named ``energy``,
        or to the only one.
    """

    def __init__(self, directory: str, target_names: Sequence[str] = ("energy",)):
        self.dir = Path(directory)
        self.n_structures = int(np.load(self.dir / "ns.npy"))
        self.na = np.load(self.dir / "na.npy")
        self._offsets = np.concatenate([[0], np.cumsum(self.na)])
        total = int(self._offsets[-1])

        def mapped(name, dtype, shape, optional=True):
            path = self.dir / name
            if optional and not path.exists():
                return None
            return np.memmap(path, dtype=dtype, mode="r", shape=shape)

        self.x = mapped("x.bin", np.float64, (total, 3), optional=False)
        self.a = mapped("a.bin", np.int32, (total,), optional=False)
        self.c = mapped("c.bin", np.float64, (self.n_structures, 3, 3), optional=False)
        self.p = mapped("p.bin", bool, (self.n_structures, 3))
        self.target_names = list(target_names)
        self._targets = {name: values for name in self.target_names
                         if (values := mapped(f"{name}.bin", np.float64,
                                              (self.n_structures,))) is not None}
        self.forces = mapped("forces.bin", np.float64, (total, 3))
        self.momenta = mapped("momenta.bin", np.float64, (total, 3))
        self.masses = mapped("masses.bin", np.float64, (total,))

    def __len__(self) -> int:
        return self.n_structures

    @property
    def atom_counts(self) -> np.ndarray:
        return self.na

    @property
    def systems(self) -> List[System]:
        return [self[i].system for i in range(len(self))]

    @property
    def targets(self) -> Dict[str, List[TensorMap]]:
        return {name: [self[i].targets[name] for i in range(len(self))]
                for name in self._targets}

    def __getitem__(self, index: int) -> Sample:
        a, b = int(self._offsets[index]), int(self._offsets[index + 1])
        cell = np.asarray(self.c[index])
        pbc = (np.asarray(self.p[index]) if self.p is not None
               else np.array([np.linalg.norm(cell[k]) > 0 for k in range(3)]))
        system = System(np.asarray(self.x[a:b]), np.asarray(self.a[a:b]), cell, pbc)
        if self.momenta is not None:
            system.extra["momenta"] = np.asarray(self.momenta[a:b])
        if self.masses is not None:
            system.extra["masses"] = np.asarray(self.masses[a:b])
        targets = {}
        for name, values in self._targets.items():
            fields = {"values": np.asarray([values[index]])}
            if self.forces is not None and self._forces_target(name):
                fields["positions_gradient"] = -np.asarray(self.forces[a:b])
            targets[name] = _fields_to_tensormap(fields, index, b - a)
        return Sample(system, targets)

    def _forces_target(self, name: str) -> bool:
        return name == "energy" or len(self._targets) == 1

    def infer_target_infos(self) -> Dict[str, TargetInfo]:
        return {name: get_energy_target_info(
            "eV", add_position_gradients=self.forces is not None and self._forces_target(name))
            for name in self._targets}

    @property
    def extra_data(self) -> Dict:
        return {}

    def select(self, indices) -> DatasetView:
        return DatasetView(self, indices)


def write_memmap_dataset(directory: str, systems: Sequence[System],
                         energies: Optional[np.ndarray] = None,
                         forces: Optional[Sequence[np.ndarray]] = None) -> None:
    """Write a memmap dataset directory from systems on the host, with
    an ``energy.bin`` and a ``forces.bin`` where they are given."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    np.save(directory / "ns.npy", np.asarray(len(systems), dtype=np.int64))
    np.save(directory / "na.npy", np.asarray([len(s) for s in systems], dtype=np.int64))
    np.concatenate([s.positions for s in systems]).astype(np.float64).tofile(directory / "x.bin")
    np.concatenate([s.types for s in systems]).astype(np.int32).tofile(directory / "a.bin")
    np.stack([s.cell for s in systems]).astype(np.float64).tofile(directory / "c.bin")
    np.stack([s.pbc for s in systems]).tofile(directory / "p.bin")
    if energies is not None:
        np.asarray(energies, dtype=np.float64).tofile(directory / "energy.bin")
    if forces is not None:
        np.concatenate(forces).astype(np.float64).tofile(directory / "forces.bin")
