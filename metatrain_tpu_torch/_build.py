"""Build native libraries from the checkout's sources at first use.

Outputs go to ``metatrain_tpu_torch/_build/`` (git-ignored). A library is
rebuilt when it is missing or older than one of its sources; each build
writes to a temporary name and renames it into place, so processes that
build at the same time never load a half-written file.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR / "_build"


def build_library(
    command: Sequence[str], sources: Sequence[Path], name: str, timeout: float
) -> Path:
    """Run ``command + [-o, <tmp>]`` unless ``_build/<name>`` is fresh.

    :return: the path of the library. The compiler's output goes to
        ``_build/<name>.log``; a failed build raises ``RuntimeError`` with
        the end of that output.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / name
    newest = max(Path(s).stat().st_mtime for s in sources)
    if target.exists() and target.stat().st_mtime >= newest:
        return target
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        result = subprocess.run(
            [*command, "-o", tmp], capture_output=True, text=True, timeout=timeout
        )
        output = result.stdout + result.stderr
        (BUILD_DIR / f"{name}.log").write_text(output)
        if result.returncode != 0:
            raise RuntimeError(
                f"building {name} failed (exit {result.returncode}):\n{output[-8000:]}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target
