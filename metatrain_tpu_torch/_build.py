"""Build native libraries from the checkout's sources at first use.

Outputs go to ``metatrain_tpu_torch/_build/`` (git-ignored). A library of
one command is rebuilt when it is missing or older than one of its
sources. A library of several units keeps one object per unit
(``_build/<unit>.o``): a unit is compiled again only when the object is
missing or older than the unit or a header it includes (``#include
"..."``, followed from header to header), the stale units all at once,
one compiler process each; the library is linked again when it is older
than one of its objects. Every output is written to a temporary name and
renamed into place, so processes that build at the same time never load a
half-written file.
"""

from __future__ import annotations

import os
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR / "_build"

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def includes(unit: Path) -> set:
    """The unit and every file it includes with ``#include "..."``,
    transitively (paths relative to the including file; missing ones are
    left to the compiler)."""
    seen, todo = set(), [Path(unit).resolve()]
    while todo:
        path = todo.pop()
        if path in seen or not path.exists():
            continue
        seen.add(path)
        todo += [(path.parent / name).resolve() for name in _INCLUDE.findall(path.read_text())]
    return seen


def _stale(target: Path, inputs) -> bool:
    if not target.exists():
        return True
    built = target.stat().st_mtime
    return any(Path(s).stat().st_mtime > built for s in inputs)


def build_library(
    command: Sequence[str], sources: Sequence[Path], name: str, timeout: float,
    compile_command: Optional[Sequence[str]] = None, units: Sequence[Path] = (),
) -> Path:
    """Run ``command + [-o, <tmp>]`` unless ``_build/<name>`` is fresh.

    With ``units``, first run ``compile_command + [-c, unit, -o, <tmp>]``
    for every stale unit at once, then, if the library is older than an
    object, ``command`` with the objects appended (the link); ``sources``
    is then not read.

    :return: the path of the library. The compilers' output goes to
        ``_build/<name>.log`` (with units, each unit's last compile output
        in unit order, then the link's); a failed build raises
        ``RuntimeError`` with the end of that output.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / name
    objects = [BUILD_DIR / f"{Path(u).name}.o" for u in units]
    if units:
        stale = [(u, o) for u, o in zip(units, objects) if _stale(o, includes(u))]
        fresh = not stale and not _stale(target, objects)
    else:
        stale = []
        fresh = not _stale(target, sources)
    if fresh:
        return target
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp_objects = [str(Path(work) / o.name) for _, o in stale]
        compiles = [
            subprocess.Popen([*compile_command, "-c", str(u), "-o", tmp],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for (u, _), tmp in zip(stale, tmp_objects)
        ]
        failed = []
        for (_, obj), tmp, proc in zip(stale, tmp_objects, compiles):
            out = proc.communicate(timeout=timeout)[0]
            Path(f"{obj}.log").write_text(out)
            if proc.returncode != 0:
                failed.append(proc.returncode)
            else:
                os.replace(tmp, obj)
        outputs = [Path(f"{o}.log").read_text() for o in objects if Path(f"{o}.log").exists()]
        if not failed:
            tmp = str(Path(work) / name)
            link = [*command, *(str(o) for o in objects), "-o", tmp]
            result = subprocess.run(link, capture_output=True, text=True, timeout=timeout)
            outputs.append(result.stdout + result.stderr)
            failed = [result.returncode] if result.returncode != 0 else []
        output = "\n".join(outputs)
        (BUILD_DIR / f"{name}.log").write_text(output)
        if failed:
            raise RuntimeError(f"building {name} failed (exit {failed[0]}):\n{output[-8000:]}")
        os.replace(tmp, target)
    return target
