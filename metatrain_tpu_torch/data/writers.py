"""Prediction writers, chosen by the output's suffix.

Counterpart of ``metatrain_tpu/data/writers.py`` for ``.xyz`` /
``.extxyz`` (extended xyz with the predictions as info fields and
columns, forces as ``<target>_forces``) and ``.npz`` (one array per
system, target and field, keyed ``<index>/<target>/<field>``). Per-atom
outputs become per-atom arrays and per-structure outputs info fields,
each flattened per sample; a target of several blocks writes them side by
side in its layout's order (the layout the reader reads back), where the
JAX package writes the first block only. The ``.zip`` (disk dataset),
``.mts`` and memmap-directory (trailing ``/``) writers wait for the port
of the disk datasets and the ``.mts`` format. An extended-xyz column
name holds no ``:`` (the ``Properties`` field separates with it): a
per-atom output's column takes its name with each ``:`` as ``_``
(``mtt::charges`` -> ``mtt__charges``), where the JAX package writes a
file its reader cannot read back.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..containers import System, TensorMap
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
    ``.xyz`` / ``.extxyz`` or ``.npz``."""
    path = str(path)
    if path.endswith((".xyz", ".extxyz")):
        _write_xyz_predictions(path, batches_and_predictions)
    elif path.endswith(".npz"):
        _write_npz_predictions(path, batches_and_predictions)
    elif path.endswith((".zip", ".mts", "/")):
        raise NotImplementedError(
            f"writing {path!r} waits for the port of the disk datasets (data/disk.py, "
            "smart_zip.py) and the .mts format; write .xyz or .npz"
        )
    else:
        raise ValueError(f"no writer for output suffix of {path!r}")


def _write_xyz_predictions(path, batches_and_predictions):
    all_systems, all_info, all_arrays = [], [], []
    for batch, predictions in batches_and_predictions:
        systems, per_system = _split_batch_predictions(batch, predictions)
        for system, preds in zip(systems, per_system):
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
    index = 0
    for batch, predictions in batches_and_predictions:
        _, per_system = _split_batch_predictions(batch, predictions)
        for preds in per_system:
            for name, entry in preds.items():
                for field, value in entry.items():
                    arrays[f"{index}/{name}/{field}"] = value
            index += 1
    np.savez_compressed(path, **arrays)
