"""Extended-XYZ reading/writing without ASE.

A copy of ``metatrain_tpu/data/readers/extxyz.py`` (numpy only; importing
the JAX package would pull in jax). A self-contained parser for the
extended-XYZ dialect ASE writes: a ``Lattice="..."`` comment key, a
``Properties=name:T:count:...`` column spec, arbitrary ``key=value`` info
fields (energies, stress/virial, charge, ...) and per-atom columns
(positions, forces, momenta, ...). All numeric data is float64.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Sequence, TextIO, Tuple, Union

import numpy as np

from ...containers.system import System


CHEMICAL_SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
    "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr",
    "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf",
    "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po",
    "At", "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu", "Am", "Cm",
    "Bk", "Cf", "Es", "Fm", "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs",
    "Mt", "Ds", "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]
SYMBOL_TO_NUMBER = {s: i for i, s in enumerate(CHEMICAL_SYMBOLS)}

_KEY_VALUE_RE = re.compile(
    r"""(?P<key>[A-Za-z_][A-Za-z0-9_:-]*)"""
    r"""\s*=\s*"""
    r"""(?P<value>"[^"]*"|'[^']*'|[^\s]+)"""
)


def _parse_comment(comment: str) -> Dict[str, Union[str, float, bool, np.ndarray]]:
    info: Dict[str, Union[str, float, bool, np.ndarray]] = {}
    for match in _KEY_VALUE_RE.finditer(comment):
        key = match.group("key")
        raw = match.group("value")
        if raw and raw[0] in "\"'":
            raw = raw[1:-1]
        info[key] = _parse_value(raw)
    return info


def _parse_value(raw: str) -> Union[str, float, bool, np.ndarray]:
    stripped = raw.strip()
    lowered = stripped.lower()
    if lowered in ("t", "true"):
        return True
    if lowered in ("f", "false"):
        return False
    tokens = stripped.split()
    if len(tokens) > 1:
        try:
            return np.array([float(t) for t in tokens], dtype=np.float64)
        except ValueError:
            if all(t.lower() in ("t", "f", "true", "false") for t in tokens):
                return np.array([t.lower() in ("t", "true") for t in tokens])
            return stripped
    try:
        return float(stripped)
    except ValueError:
        return stripped


def _parse_properties(spec: str) -> List[Tuple[str, str, int]]:
    parts = spec.split(":")
    if len(parts) % 3 != 0:
        raise ValueError(f"malformed Properties spec: {spec!r}")
    out = []
    for i in range(0, len(parts), 3):
        out.append((parts[i], parts[i + 1], int(parts[i + 2])))
    return out


def iread_xyz(fileobj: TextIO) -> Iterator[System]:
    """Yield :class:`System` objects from an (extended-)xyz stream.

    All comment-line ``key=value`` fields land in ``system.extra`` (scalars
    and arrays), as do any per-atom columns beyond species/pos.
    """
    while True:
        line = fileobj.readline()
        if not line:
            return
        line = line.strip()
        if not line:
            continue
        n_atoms = int(line)
        comment = fileobj.readline().rstrip("\n")
        info = _parse_comment(comment)

        properties = _parse_properties(
            str(info.pop("Properties", "species:S:1:pos:R:3"))
        )

        rows = []
        for _ in range(n_atoms):
            atom_line = fileobj.readline()
            if not atom_line:
                raise EOFError("truncated xyz frame")
            rows.append(atom_line.split())

        col = 0
        columns: Dict[str, np.ndarray] = {}
        for name, kind, count in properties:
            block = [row[col : col + count] for row in rows]
            col += count
            if kind == "S":
                columns[name] = np.array([b[0] for b in block])
            elif kind == "R":
                columns[name] = np.array(block, dtype=np.float64)
                if count == 1:
                    columns[name] = columns[name][:, 0]
            elif kind == "I":
                columns[name] = np.array(block, dtype=np.int64)
                if count == 1:
                    columns[name] = columns[name][:, 0]
            elif kind == "L":
                columns[name] = np.array(
                    [[t.lower() in ("t", "true") for t in b] for b in block]
                )
                if count == 1:
                    columns[name] = columns[name][:, 0]
            else:
                raise ValueError(f"unknown property kind {kind!r}")

        if "species" in columns:
            types = np.array(
                [SYMBOL_TO_NUMBER[s] for s in columns.pop("species")], dtype=np.int32
            )
        elif "Z" in columns:
            types = np.asarray(columns.pop("Z"), dtype=np.int32)
        elif "numbers" in columns:
            types = np.asarray(columns.pop("numbers"), dtype=np.int32)
        else:
            raise ValueError("xyz frame has no species column")
        positions = columns.pop("pos")

        lattice = info.pop("Lattice", None)
        if lattice is None:
            cell = np.zeros((3, 3), dtype=np.float64)
        else:
            cell = np.asarray(lattice, dtype=np.float64).reshape(3, 3)

        pbc_raw = info.pop("pbc", None)
        if pbc_raw is None:
            pbc = np.array([bool(np.linalg.norm(cell[k]) > 0) for k in range(3)])
        elif isinstance(pbc_raw, bool):
            pbc = np.array([pbc_raw] * 3)
        else:
            pbc = np.asarray(pbc_raw, dtype=bool)

        extra: Dict[str, np.ndarray] = {}
        for key, value in info.items():
            extra[key] = np.asarray(value)
        for key, value in columns.items():
            extra[key] = value

        yield System(
            positions=positions, types=types, cell=cell, pbc=pbc, extra=extra
        )


def read_xyz(path: str, index: Optional[slice] = None) -> List[System]:
    with open(path) as f:
        systems = list(iread_xyz(f))
    if index is not None:
        systems = systems[index]
    return systems


def _format_value(value) -> str:
    if isinstance(value, (bool, np.bool_)):
        return "T" if value else "F"
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        return repr(float(value))
    arr = np.asarray(value)
    if arr.ndim == 0:
        return _format_value(arr.item())
    if arr.dtype == bool:
        return '"' + " ".join("T" if x else "F" for x in arr.ravel()) + '"'
    return '"' + " ".join(repr(float(x)) for x in arr.ravel()) + '"'


def write_xyz(
    path: str,
    systems: Sequence[System],
    per_atom_arrays: Optional[Sequence[Dict[str, np.ndarray]]] = None,
    info: Optional[Sequence[Dict[str, Union[float, np.ndarray]]]] = None,
    mode: str = "w",
) -> None:
    """Write systems as extended xyz, with optional extra columns/info."""
    with open(path, mode) as f:
        for idx, system in enumerate(systems):
            arrays = dict(per_atom_arrays[idx]) if per_atom_arrays else {}
            fields = dict(info[idx]) if info else {}

            props = ["species:S:1", "pos:R:3"]
            extra_cols: List[Tuple[str, np.ndarray]] = []
            for name, arr in arrays.items():
                arr = np.asarray(arr, dtype=np.float64)
                width = 1 if arr.ndim == 1 else arr.shape[1]
                props.append(f"{name}:R:{width}")
                extra_cols.append((name, arr.reshape(len(system), width)))

            comment_parts = []
            if np.linalg.norm(system.cell) > 0:
                comment_parts.append(f"Lattice={_format_value(system.cell.ravel())}")
            comment_parts.append(f"Properties={':'.join(props)}")
            comment_parts.append(f"pbc={_format_value(system.pbc)}")
            for key, value in fields.items():
                comment_parts.append(f"{key}={_format_value(value)}")

            f.write(f"{len(system)}\n")
            f.write(" ".join(comment_parts) + "\n")
            for i in range(len(system)):
                row = [f"{CHEMICAL_SYMBOLS[system.types[i]]:2s}"]
                row += [f"{x:.10f}" for x in system.positions[i]]
                for _, arr in extra_cols:
                    row += [f"{x:.10f}" for x in arr[i]]
                f.write(" ".join(row) + "\n")
