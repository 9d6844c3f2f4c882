"""The metatensor ``.mts`` and metatomic ``.mta`` formats, without their libraries.

Counterpart of ``metatrain_tpu/data/readers/mts.py`` (a copy: numpy and
``zipfile`` only). A serialized TensorMap is a stored (uncompressed) zip of
``.npy`` members::

    keys.npy                                   structured int32: Labels
    blocks/{i}/values.npy                      float64 ndarray
    blocks/{i}/samples.npy                     structured int32: Labels
    blocks/{i}/components/{j}.npy              structured int32: Labels
    blocks/{i}/properties.npy                  structured int32: Labels
    blocks/{i}/gradients/{param}/values.npy    (+ samples, components)

Gradient blocks share their parent's properties. A metatomic System
(``.mta``) is the same kind of zip with ``positions.npy``, ``cell.npy``,
``types.npy`` and ``pbc.npy``. Both packages write the same bytes for the
same map (the members in the same order, the same ``.npy`` headers), so
each reads the other's files.

``read_mts_target`` is the ``.mts`` route of the target readers: one
joined TensorMap on disk, split into one map per system.
"""

from __future__ import annotations

import io
import zipfile
from typing import Any, Dict, List, Tuple

import numpy as np

from ...containers import Labels, System, TensorBlock, TensorMap


# ---- Labels <-> structured npy ----------------------------------------------


def _labels_from_npy(buf: bytes) -> Labels:
    arr = np.load(io.BytesIO(buf))
    if arr.dtype.names is None:
        raise ValueError("labels member is not a structured array")
    names = list(arr.dtype.names)
    values = np.stack(
        [arr[n].astype(np.int32) for n in names], axis=1
    ) if len(arr) else np.zeros((0, len(names)), np.int32)
    return Labels(names, values)


def _labels_to_npy(labels: Labels) -> bytes:
    values = np.asarray(labels.values)
    dtype = np.dtype([(str(n), np.int32) for n in labels.names])
    arr = np.zeros(len(values), dtype=dtype)
    for j, n in enumerate(labels.names):
        arr[str(n)] = values[:, j].astype(np.int32)
    return _npy_bytes(arr)


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _host(values) -> np.ndarray:
    """A block's values as a host array (the port's blocks may hold tensors)."""
    if hasattr(values, "detach"):
        values = values.detach().cpu().numpy()
    return np.asarray(values)


# ---- TensorMap ---------------------------------------------------------------


def _read_block(zf: zipfile.ZipFile, prefix: str, members: set) -> TensorBlock:
    values = np.load(io.BytesIO(zf.read(f"{prefix}/values.npy")))
    samples = _labels_from_npy(zf.read(f"{prefix}/samples.npy"))
    components = []
    j = 0
    while f"{prefix}/components/{j}.npy" in members:
        components.append(_labels_from_npy(zf.read(f"{prefix}/components/{j}.npy")))
        j += 1
    if f"{prefix}/properties.npy" in members:
        properties = _labels_from_npy(zf.read(f"{prefix}/properties.npy"))
    else:  # a gradient block: the caller gives it its parent's properties
        properties = Labels.range("property", values.shape[-1])
    block = TensorBlock(
        values=np.asarray(values, dtype=np.float64),
        samples=samples,
        components=components,
        properties=properties,
    )
    grad_prefix = f"{prefix}/gradients/"
    grad_names = sorted({m[len(grad_prefix):].split("/")[0]
                         for m in members if m.startswith(grad_prefix)})
    for name in grad_names:
        grad = _read_block(zf, f"{prefix}/gradients/{name}", members)
        grad.properties = block.properties
        block.add_gradient(name, grad)
    return block


def load_mts_bytes(data: bytes) -> TensorMap:
    """Parse a serialized metatensor TensorMap."""
    zf = zipfile.ZipFile(io.BytesIO(data))
    members = set(zf.namelist())
    keys = _labels_from_npy(zf.read("keys.npy"))
    return TensorMap(keys, [_read_block(zf, f"blocks/{i}", members) for i in range(len(keys))])


def load_mts(path: str) -> TensorMap:
    """Load a metatensor ``.mts`` file."""
    with open(path, "rb") as fd:
        return load_mts_bytes(fd.read())


def _write_block(zf: zipfile.ZipFile, prefix: str, block: TensorBlock, is_gradient: bool) -> None:
    zf.writestr(f"{prefix}/values.npy",
                _npy_bytes(np.ascontiguousarray(_host(block.values), dtype=np.float64)))
    zf.writestr(f"{prefix}/samples.npy", _labels_to_npy(block.samples))
    for j, comp in enumerate(block.components):
        zf.writestr(f"{prefix}/components/{j}.npy", _labels_to_npy(comp))
    if not is_gradient:  # gradients share the parent's properties
        zf.writestr(f"{prefix}/properties.npy", _labels_to_npy(block.properties))
    for name, grad in block.gradients():
        _write_block(zf, f"{prefix}/gradients/{name}", grad, is_gradient=True)


def mts_bytes(tensor_map: TensorMap) -> bytes:
    """Serialize a TensorMap in the metatensor ``.mts`` zip format."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr("keys.npy", _labels_to_npy(tensor_map.keys))
        for i, block in enumerate(tensor_map.blocks()):
            _write_block(zf, f"blocks/{i}", block, is_gradient=False)
    return buf.getvalue()


def save_mts(tensor_map: TensorMap, path: str) -> None:
    with open(path, "wb") as fd:
        fd.write(mts_bytes(tensor_map))


# ---- System (.mta) -----------------------------------------------------------


def load_mta_bytes(data: bytes) -> System:
    """Parse a serialized metatomic System."""
    zf = zipfile.ZipFile(io.BytesIO(data))

    def load(name):
        return np.load(io.BytesIO(zf.read(name)))

    return System(
        positions=np.asarray(load("positions.npy"), dtype=np.float64),
        types=np.asarray(load("types.npy"), dtype=np.int32),
        cell=np.asarray(load("cell.npy"), dtype=np.float64),
        pbc=np.asarray(load("pbc.npy"), dtype=bool),
    )


def mta_bytes(system: System) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr("positions.npy", _npy_bytes(np.asarray(system.positions, dtype=np.float64)))
        zf.writestr("cell.npy", _npy_bytes(np.asarray(system.cell, dtype=np.float64)))
        zf.writestr("types.npy", _npy_bytes(np.asarray(system.types, dtype=np.int32)))
        zf.writestr("pbc.npy", _npy_bytes(np.asarray(system.pbc, dtype=bool)))
    return buf.getvalue()


# ---- per-system splitting (the reader contract) ------------------------------


def _select_system(block: TensorBlock, sys_id: int) -> TensorBlock:
    """The rows of ``block`` whose ``system`` sample is ``sys_id``, the id
    renumbered to 0; its gradients keep the rows whose parent row was
    kept, their ``sample`` column renumbered to the new parent rows."""
    samples = np.asarray(block.samples.values)
    col = list(block.samples.names).index("system")
    sel = np.flatnonzero(samples[:, col] == sys_id)
    new_samples = samples[sel].copy()
    new_samples[:, col] = 0
    new_block = TensorBlock(
        values=_host(block.values)[sel],
        samples=Labels(block.samples.names, new_samples),
        components=block.components,
        properties=block.properties,
    )
    old_to_new = {int(o): n for n, o in enumerate(sel)}
    for name, grad in block.gradients():
        g_samples = np.asarray(grad.samples.values)
        g_names = list(grad.samples.names)
        sample_col = g_names.index("sample")
        keep = [r for r, row in enumerate(g_samples) if int(row[sample_col]) in old_to_new]
        new_g_samples = g_samples[keep].copy()
        new_g_samples[:, sample_col] = [old_to_new[int(g_samples[r][sample_col])] for r in keep]
        if "system" in g_names:
            new_g_samples[:, g_names.index("system")] = 0
        new_block.add_gradient(name, TensorBlock(
            values=_host(grad.values)[keep],
            samples=Labels(grad.samples.names, new_g_samples),
            components=grad.components,
            properties=grad.properties,
        ))
    return new_block


def split_by_system(tensor_map: TensorMap) -> List[TensorMap]:
    """One TensorMap per value of the ``system`` sample column, in
    increasing order, each with its system id renumbered to 0 (each map
    stands alone afterwards)."""
    system_ids = sorted({int(s) for block in tensor_map.blocks()
                         for s in np.asarray(block.samples.column("system"))})
    return [TensorMap(tensor_map.keys, [_select_system(block, sys_id)
                                        for block in tensor_map.blocks()])
            for sys_id in system_ids]


def read_mts_target(path: str, config: Dict[str, Any], n_systems: int,
                    is_energy: bool) -> Tuple[List[TensorMap], "TargetInfo"]:  # noqa: F821
    """A target from a metatensor ``.mts`` file: one joined TensorMap on
    disk, split per system. Returns the per-system maps and the TargetInfo
    of the configured type (an energy's gradients from the stored ones)."""
    from ..target_info import get_energy_target_info
    from . import generic_target_info

    joined = load_mts(path)
    if is_energy:
        if len(joined) != 1:
            raise ValueError("energy TensorMaps should have exactly one block")
        block = joined.block(0)
        info = get_energy_target_info(
            config.get("unit") or "",
            add_position_gradients=block.has_gradient("positions"),
            add_strain_gradients=block.has_gradient("strain"),
        )
    else:
        first = joined.block(0)
        # the stored layout decides per_atom and the property count
        info = generic_target_info({
            **config,
            "per_atom": "atom" in first.samples.names,
            "num_subtargets": int(_host(first.values).shape[-1]),
        })
        _check_layout_compatible(joined, info.layout)

    maps = split_by_system(joined)
    if len(maps) != n_systems:
        raise ValueError(
            f"metatensor target file {path!r} holds {len(maps)} systems, expected {n_systems}"
        )
    return maps, info


def _check_layout_compatible(tensor_map: TensorMap, layout: TensorMap) -> None:
    """The stored map's keys, sample names and component counts against
    the configured layout (properties may differ)."""
    if list(tensor_map.keys.names) != list(layout.keys.names):
        raise ValueError(
            f"unexpected keys names in metatensor target: expected {list(layout.keys.names)}, "
            f"got {list(tensor_map.keys.names)}"
        )
    layout_keys = {tuple(int(v) for v in row) for row in np.asarray(layout.keys.values)}
    for row in np.asarray(tensor_map.keys.values):
        if tuple(int(v) for v in row) not in layout_keys:
            raise ValueError(
                f"unexpected key {tuple(int(v) for v in row)} in metatensor target "
                f"(allowed: {sorted(layout_keys)})"
            )
    for (key, block), (_, lblock) in zip(tensor_map.items(), layout.items()):
        if list(block.samples.names) != list(lblock.samples.names):
            raise ValueError(
                f"unexpected sample names in metatensor target block {key}: "
                f"expected {list(lblock.samples.names)}, got {list(block.samples.names)}"
            )
        if len(block.components) != len(lblock.components):
            raise ValueError(
                f"unexpected component count in metatensor target block {key}: "
                f"expected {len(lblock.components)}, got {len(block.components)}"
            )
