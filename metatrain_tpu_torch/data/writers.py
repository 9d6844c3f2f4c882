"""Prediction writers, chosen by the output's suffix.

Counterpart of ``metatrain_tpu/data/writers.py``:

- ``.xyz`` / ``.extxyz``: extended xyz with the predictions as info
  fields and columns, forces as ``<target>_forces``;
- ``.npz``: one array per system, target and field, keyed
  ``<index>/<target>/<field>``;
- ``.zip``: a disk dataset (``data/disk.py``'s ``DiskDatasetWriter``),
  each target's values with its ``positions_gradient`` and
  ``strain_gradient``;
- ``.mts``: one metatensor file ``<stem>_<target>.mts`` per target, all
  systems joined with their index as the ``system`` sample;
- a path ending in ``/``: a memmap dataset directory holding the energy
  (``energy.bin``, from the one per-structure value of the only target)
  and its forces (``forces.bin``).

Per-atom outputs become per-atom arrays and per-structure outputs info
fields, each flattened per sample; a target of several blocks writes them
side by side in its layout's order (the layout the reader reads back),
where the JAX package writes the first block only. The ``.mts`` writer
refuses a target of several blocks, as the JAX package's does, and the
memmap writer refuses predictions that are not one value per structure
of one target, where the JAX package writes the first value of the first
target. An extended-xyz column name holds no ``:`` (the ``Properties``
field separates with it): a per-atom output's column takes its name with
each ``:`` as ``_`` (``mtt::charges`` -> ``mtt__charges``), where the JAX
package writes a file its reader cannot read back.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..containers import Labels, System, TensorBlock, TensorMap
from .readers.extxyz import write_xyz
from .target_info import TargetInfo


def _host(tensor: torch.Tensor) -> np.ndarray:
    tensor = tensor.detach().cpu()
    return (tensor.float() if tensor.dtype == torch.bfloat16 else tensor).numpy()


def _split_batch_predictions(batch, predictions: Dict[str, TensorMap]):
    """The batch's real systems on the host and, per system, each target's
    values and gradients."""
    sb = batch.systems
    positions, types, cells, pbc = (_host(x) for x in (sb.positions, sb.types, sb.cells, sb.pbc))
    atom_mask, system_index = _host(sb.atom_mask), _host(sb.system_index)
    real_systems = np.nonzero(_host(sb.system_mask))[0]
    atoms_of = [atom_mask & (system_index == i) for i in real_systems]
    systems = [System(positions[sel], types[sel], cells[i], pbc[i])
               for i, sel in zip(real_systems, atoms_of)]

    per_system: List[Dict[str, Dict[str, np.ndarray]]] = [{} for _ in real_systems]
    for name, tmap in predictions.items():
        block = tmap.blocks()[0]
        values = _host(block.values)
        if len(tmap) > 1:  # the blocks side by side, each flattened per sample
            values = np.concatenate([_host(b.values).reshape(len(values), -1)
                                     for b in tmap.blocks()], axis=1)
        per_atom = "atom" in block.samples.names
        gradients = {gname: _host(grad.values) for gname, grad in block.gradients()}
        for slot, (sys_i, sel) in enumerate(zip(real_systems, atoms_of)):
            entry = {"values": values[sel] if per_atom else values[sys_i]}
            if "positions" in gradients:
                entry["positions_grad"] = gradients["positions"][sel]
            if "strain" in gradients:
                entry["strain_grad"] = gradients["strain"][sys_i]
            per_system[slot][name] = entry
    return systems, per_system


def xyz_column(name: str) -> str:
    """The extended-xyz column of a per-atom output named ``name``."""
    return name.replace(":", "_")


def write_predictions(path: str,
                      batches_and_predictions: List[Tuple[object, Dict[str, TensorMap]]],
                      target_infos: Dict[str, TargetInfo]) -> None:
    """Write ``(batch, predictions)`` pairs by the suffix of ``path``:
    ``.xyz`` / ``.extxyz``, ``.npz``, ``.zip``, ``.mts`` or ``/``."""
    path = str(path)
    if path.endswith((".xyz", ".extxyz")):
        _write_xyz_predictions(path, batches_and_predictions)
    elif path.endswith(".npz"):
        _write_npz_predictions(path, batches_and_predictions)
    elif path.endswith(".zip"):
        _write_zip_predictions(path, batches_and_predictions)
    elif path.endswith(".mts"):
        _write_mts_predictions(path, batches_and_predictions, target_infos)
    elif path.endswith("/"):
        _write_memmap_predictions(path, batches_and_predictions)
    else:
        raise ValueError(f"no writer for output suffix of {path!r}")


def _systems_and_predictions(batches_and_predictions):
    """``(system, {target: entry})`` for every real system, in order."""
    for batch, predictions in batches_and_predictions:
        yield from zip(*_split_batch_predictions(batch, predictions))


def _write_zip_predictions(path, batches_and_predictions):
    from .disk import DiskDatasetWriter

    with DiskDatasetWriter(path) as writer:
        for system, preds in _systems_and_predictions(batches_and_predictions):
            fields = {}
            for name, entry in preds.items():
                record = {"values": np.asarray(entry["values"]).reshape(-1)}
                if "positions_grad" in entry:
                    record["positions_gradient"] = entry["positions_grad"]
                if "strain_grad" in entry:
                    record["strain_gradient"] = entry["strain_grad"]
                fields[name] = record
            writer.write(system, fields)


def _write_memmap_predictions(path, batches_and_predictions):
    from .disk import write_memmap_dataset

    systems, energies, forces = [], [], []
    for system, preds in _systems_and_predictions(batches_and_predictions):
        entry = next(iter(preds.values())) if len(preds) == 1 else None
        if entry is None or np.asarray(entry["values"]).size != 1:
            raise ValueError(
                f"a memmap dataset holds one per-structure energy: the predictions of "
                f"{sorted(preds)} are not one value per structure of one target; write "
                ".zip, .mts or .xyz"
            )
        systems.append(system)
        energies.append(float(np.asarray(entry["values"]).reshape(-1)[0]))
        if "positions_grad" in entry:
            forces.append(-np.asarray(entry["positions_grad"]).reshape(len(system), 3))
    write_memmap_dataset(path, systems, np.asarray(energies), forces or None)


def _write_mts_predictions(path, batches_and_predictions, target_infos):
    """One ``{stem}_{target}.mts`` per target, the systems joined with
    their index as the ``system`` sample; a gradient's ``sample`` is the
    row of its parent sample in the joined block."""
    from .readers.mts import save_mts

    acc: Dict[str, List[Tuple[int, int, Dict[str, np.ndarray]]]] = {}
    for index, (system, preds) in enumerate(_systems_and_predictions(batches_and_predictions)):
        for name, entry in preds.items():
            acc.setdefault(name, []).append((index, len(system), entry))

    stem = str(Path(path).with_suffix(""))
    e_props = Labels(["energy"], np.zeros((1, 1), dtype=np.int32))
    xyz = Labels(["xyz"], np.arange(3, dtype=np.int32).reshape(-1, 1))
    strain_comps = [Labels(["xyz_1"], np.arange(3, dtype=np.int32).reshape(-1, 1)),
                    Labels(["xyz_2"], np.arange(3, dtype=np.int32).reshape(-1, 1))]
    for name, entries in acc.items():
        info = target_infos.get(name)
        if info is not None and len(info.layout) > 1:
            raise ValueError(
                f"the .mts writer does not support multi-block targets yet (target {name!r} "
                f"has {len(info.layout)} blocks)"
            )
        layout_block = info.layout.block(0) if info is not None else None
        per_atom = bool(info.per_atom) if info is not None else False
        comps = list(layout_block.components) if layout_block is not None else []
        comp_shape = tuple(len(c) for c in comps)
        props = layout_block.properties if layout_block is not None else e_props
        values, samples = [], []
        pos_grads, pos_samples, strain_grads, strain_samples = [], [], [], []
        parent_row = 0
        for sys_i, n_atoms, entry in entries:
            n_rows = n_atoms if per_atom else 1
            values.append(np.asarray(entry["values"], dtype=np.float64).reshape(
                (n_rows,) + comp_shape + (-1,)))
            samples.extend([[sys_i, a] for a in range(n_atoms)] if per_atom else [[sys_i]])
            if "positions_grad" in entry:
                pos_grads.append(np.asarray(entry["positions_grad"], dtype=np.float64)
                                 .reshape(n_atoms, 3, -1))
                pos_samples.extend([parent_row, sys_i, a] for a in range(n_atoms))
            if "strain_grad" in entry:
                strain_grads.append(np.asarray(entry["strain_grad"], dtype=np.float64)
                                    .reshape(1, 3, 3, -1))
                strain_samples.append([parent_row])
            parent_row += n_rows
        block = TensorBlock(
            values=np.concatenate(values, axis=0),
            samples=Labels(["system", "atom"] if per_atom else ["system"],
                           np.asarray(samples, dtype=np.int32)),
            components=comps,
            properties=props,
        )
        if pos_grads:
            block.add_gradient("positions", TensorBlock(
                values=np.concatenate(pos_grads, axis=0),
                samples=Labels(["sample", "system", "atom"],
                               np.asarray(pos_samples, dtype=np.int32)),
                components=[xyz], properties=props))
        if strain_grads:
            block.add_gradient("strain", TensorBlock(
                values=np.concatenate(strain_grads, axis=0),
                samples=Labels(["sample"], np.asarray(strain_samples, dtype=np.int32)),
                components=strain_comps, properties=props))
        keys = info.layout.keys if info is not None else Labels.single()
        save_mts(TensorMap(keys, [block]), f"{stem}_{name}.mts")


def _write_xyz_predictions(path, batches_and_predictions):
    all_systems, all_info, all_arrays = [], [], []
    for system, preds in _systems_and_predictions(batches_and_predictions):
        info, arrays = {}, {}
        for name, entry in preds.items():
            values = entry["values"]
            if values.ndim >= 1 and values.shape[0] == len(system):
                arrays[xyz_column(name)] = values.reshape(len(system), -1)
            else:
                flat = values.reshape(-1)
                info[name] = flat[0] if flat.size == 1 else flat
            if "positions_grad" in entry:  # the gradient is dE/dr
                arrays[xyz_column(f"{name}_forces")] = -entry["positions_grad"].reshape(len(system), -1)
            if "strain_grad" in entry:
                info[f"{name}_strain_gradient"] = entry["strain_grad"].reshape(-1)
        all_systems.append(system)
        all_info.append(info)
        all_arrays.append(arrays)
    write_xyz(path, all_systems, per_atom_arrays=all_arrays, info=all_info)


def _write_npz_predictions(path, batches_and_predictions):
    arrays: Dict[str, np.ndarray] = {}
    for index, (_, preds) in enumerate(_systems_and_predictions(batches_and_predictions)):
        for name, entry in preds.items():
            for field, value in entry.items():
                arrays[f"{index}/{name}/{field}"] = value
    np.savez_compressed(path, **arrays)
