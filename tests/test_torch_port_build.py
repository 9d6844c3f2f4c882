"""The port's native build (``metatrain_tpu_torch/_build.py``): one object
per unit, recompiled only when the unit or a header it includes changed.

A stub compiler (a small Python script) writes its ``-o`` file and logs each
call, so the tests see which units a build compiles and whether it links.
"""

import os
import sys
import textwrap
import time

import pytest

from metatrain_tpu_torch import _build
from metatrain_tpu_torch.ops.kernels import _lib

STUB = textwrap.dedent("""
    import sys
    log, args = sys.argv[1], sys.argv[2:]
    out = args[args.index("-o") + 1]
    kind = "compile " + args[args.index("-c") + 1].rsplit("/", 1)[-1] if "-c" in args else "link"
    if "FAIL" in " ".join(args):
        sys.exit(3)
    with open(log, "a") as f:
        f.write(kind + "\\n")
    with open(out, "w") as f:
        f.write(kind)
""")

SOURCES = {
    "a.cu": '#include "common.cuh"\nint a;\n',
    "b.cu": '#include "body.cuh"\nint b;\n',
    "c.cu": "int c;\n",
    "body.cuh": '#pragma once\n#include "common.cuh"\n',
    "common.cuh": "#pragma once\n",
}


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """Sources a.cu (-> common.cuh), b.cu (-> body.cuh -> common.cuh) and
    c.cu, a stub compiler and its log; ``build()`` returns the units the
    build compiled and whether it linked."""
    src = tmp_path / "csrc"
    src.mkdir()
    for name, text in SOURCES.items():
        (src / name).write_text(text)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    stub, log = tmp_path / "stub.py", tmp_path / "calls.log"
    stub.write_text(STUB)
    cmd = [sys.executable, str(stub), str(log)]
    units = [src / u for u in ("a.cu", "b.cu", "c.cu")]
    clock = {"t": time.time() - 10_000}

    def settle():
        """Every file gets one time, every output a later one."""
        for path in src.iterdir():
            os.utime(path, (clock["t"], clock["t"]))
        for path in (tmp_path / "_build").glob("*"):
            os.utime(path, (clock["t"] + 10, clock["t"] + 10))
        clock["t"] += 100

    def touch(name):
        os.utime(src / name, (clock["t"], clock["t"]))

    def build(units=units):
        log.write_text("")
        path = _build.build_library(cmd, units, "libstub.so", 60, compile_command=cmd, units=units)
        calls = log.read_text().split()
        settle()
        return path, sorted(c for c in calls if c not in ("compile", "link")), "link" in calls

    settle()
    return build, touch, src


def test_first_build_compiles_every_unit_and_links(tree):
    build, _, _ = tree
    path, compiled, linked = build()
    assert compiled == ["a.cu", "b.cu", "c.cu"] and linked
    assert path.read_text() == "link"
    assert (path.parent / "libstub.so.log").exists()


def test_up_to_date_tree_compiles_nothing(tree):
    build, _, _ = tree
    build()
    _, compiled, linked = build()
    assert compiled == [] and not linked


@pytest.mark.parametrize("touched, expected", [
    ("a.cu", ["a.cu"]),
    ("c.cu", ["c.cu"]),
    ("body.cuh", ["b.cu"]),
    ("common.cuh", ["a.cu", "b.cu"]),
])
def test_touching_a_file_recompiles_only_its_units(tree, touched, expected):
    build, touch, _ = tree
    build()
    touch(touched)
    _, compiled, linked = build()
    assert compiled == expected and linked
    _, compiled, linked = build()
    assert compiled == [] and not linked


def test_missing_library_relinks_without_compiling(tree):
    build, _, _ = tree
    path, _, _ = build()
    path.unlink()
    _, compiled, linked = build()
    assert compiled == [] and linked and path.exists()


def test_failed_unit_raises_and_keeps_the_library(tree):
    build, touch, src = tree
    path, _, _ = build()
    (src / "FAIL.cu").write_text("int f;\n")
    with pytest.raises(RuntimeError, match="libstub.so failed"):
        build([src / "a.cu", src / "FAIL.cu"])
    assert path.read_text() == "link"


def test_includes_follows_headers(tree):
    _, _, src = tree
    assert {p.name for p in _build.includes(src / "b.cu")} == {"b.cu", "body.cuh", "common.cuh"}
    assert {p.name for p in _build.includes(src / "c.cu")} == {"c.cu"}


def test_kernel_library_builds_every_cuda_source():
    """Every ``csrc/*.cu`` is a unit of the kernel library, the Hopper K1's,
    K2's, K3's and K4's among them, and each unit's headers are found in
    ``csrc``: an edit of ``layer_sm90.cuh`` recompiles all four, one of
    ``rowblock_sm90.cuh`` the Hopper K3 and K4."""
    assert sorted(_lib.SOURCES) == sorted(p.name for p in _lib.CSRC.glob("*.cu"))
    for unit in ("fused_layer_fwd_sm90.cu", "fused_layer_bwd_sm90.cu"):
        assert unit in _lib.SOURCES
        deps = {p.name for p in _build.includes(_lib.CSRC / unit)}
        assert deps == {unit, "layer_sm90.cuh", "common.cuh"}
    for unit in ("rowblock_fwd_sm90.cu", "rowblock_bwd_sm90.cu"):
        assert unit in _lib.SOURCES
        deps = {p.name for p in _build.includes(_lib.CSRC / unit)}
        assert deps == {unit, "rowblock_sm90.cuh", "layer_sm90.cuh", "common.cuh"}
    for unit, body in (("fused_layer_bwd.cu", "layer_bwd.cuh"), ("rowblock_bwd.cu", None),
                       ("rowblock_fwd.cu", None)):
        deps = {p.name for p in _build.includes(_lib.CSRC / unit)}
        assert not deps & {"layer_sm90.cuh", "rowblock_sm90.cuh"}
        assert body is None or body in deps
