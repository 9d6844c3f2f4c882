"""Build native libraries from the checkout's sources at first use.

Outputs go to ``metatrain_tpu_torch/_build/`` (git-ignored). A library is
rebuilt when it is missing or older than one of its sources; each build
writes to a temporary name and renames it into place, so processes that
build at the same time never load a half-written file. A library of
several sources compiles them all at once, one compiler process per
source, and then links the objects.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR / "_build"


def build_library(
    command: Sequence[str], sources: Sequence[Path], name: str, timeout: float,
    compile_command: Optional[Sequence[str]] = None, units: Sequence[Path] = (),
) -> Path:
    """Run ``command + [-o, <tmp>]`` unless ``_build/<name>`` is fresh.

    With ``units``, first run ``compile_command + [-c, unit, -o, <obj>]``
    for every unit at once, then ``command`` with the objects appended
    (the link).

    :return: the path of the library. The compilers' output goes to
        ``_build/<name>.log``; a failed build raises ``RuntimeError`` with
        the end of that output.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / name
    newest = max(Path(s).stat().st_mtime for s in sources)
    if target.exists() and target.stat().st_mtime >= newest:
        return target
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objects = [str(Path(work) / f"{Path(u).stem}.o") for u in units]
        compiles = [
            subprocess.Popen([*compile_command, "-c", str(u), "-o", o],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for u, o in zip(units, objects)
        ]
        outputs = [p.communicate(timeout=timeout)[0] for p in compiles]
        failed = [p.returncode for p in compiles if p.returncode != 0]
        if not failed:
            tmp = str(Path(work) / name)
            result = subprocess.run([*command, *objects, "-o", tmp], capture_output=True,
                                    text=True, timeout=timeout)
            outputs.append(result.stdout + result.stderr)
            failed = [result.returncode] if result.returncode != 0 else []
        output = "\n".join(outputs)
        (BUILD_DIR / f"{name}.log").write_text(output)
        if failed:
            raise RuntimeError(f"building {name} failed (exit {failed[0]}):\n{output[-8000:]}")
        os.replace(tmp, target)
    return target
