"""The port stands alone and runs on the card unless asked otherwise.

- No file of the port (nor ``chip_smoke.py``) opens, compiles or imports
  anything under the JAX package's directory: its neighbor-list source is
  its own copy. Comments and docstrings may name the counterpart module,
  and ``file:line`` references to the TPU kernels a CUDA kernel replaces
  are reports, not paths that are opened.
- ``device: "auto"`` trains on the first CUDA device and raises without one.
- ``pet_from_checkpoint`` puts the model on the card unless the caller
  passes another device.
"""

import ast
import inspect
import re
from pathlib import Path

import pytest
import torch

import metatrain_tpu_torch
from conftest import make_crystal
from metatrain_tpu_torch.cli import train as ttrain
from metatrain_tpu_torch.interop.jax_params import pet_from_checkpoint
from metatrain_tpu_torch.ops import neighbors

PORT = Path(metatrain_tpu_torch.__file__).resolve().parent
ROOT = PORT.parent
JAX_PATH = re.compile(r"metatrain_tpu/")
KERNEL_REFERENCE = re.compile(r"^metatrain_tpu/\S+\.py:\d+")


def _docstrings(tree):
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                ids.add(id(body[0].value))
    return ids


def _offences(code):
    """Imports of the JAX package, and strings outside docstrings that name
    it or a path inside it (other than a kernel's ``file:line``)."""
    tree = ast.parse(code)
    docs = _docstrings(tree)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if a.name.split(".")[0] == "metatrain_tpu"]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if node.module.split(".")[0] == "metatrain_tpu":
                bad.append(node.module)
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in docs):
            v = node.value
            if v == "metatrain_tpu" or v.startswith("metatrain_tpu."):
                bad.append(v)
            elif JAX_PATH.search(v) and not KERNEL_REFERENCE.match(v):
                bad.append(v)
    return bad


def test_port_names_no_path_of_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offences = {str(f.relative_to(ROOT)): _offences(f.read_text()) for f in files}
    assert {f: b for f, b in offences.items() if b} == {}
    for source in sorted(PORT.rglob("*.c*")):  # .cu, .cuh, .cpp
        includes = [line for line in source.read_text().splitlines()
                    if line.lstrip().startswith("#include") and "metatrain_tpu/" in line]
        assert includes == [], source
    # the check itself catches a path that is opened
    assert _offences('open(ROOT / "metatrain_tpu/native/neighbors.cpp")')
    assert _offences('PACKAGE_DIR.parent / "metatrain_tpu" / "native"')
    assert _offences("from metatrain_tpu.ops import neighbors")
    assert not _offences('REPLACES = "metatrain_tpu/ops/pallas/attention.py:412"')


def test_neighbor_source_is_the_ports_own():
    assert neighbors.NATIVE_SOURCE.resolve().is_relative_to(PORT)
    assert neighbors.NATIVE_SOURCE.exists()
    system = make_crystal(n_cells=2, seed=1)
    before = dict(neighbors.BACKENDS)
    args = (system.positions, system.cell, system.pbc, 4.5)
    pairs = neighbors.neighbor_pairs(*args)
    used = {k: neighbors.BACKENDS[k] - before.get(k, 0) for k in ("native", "kdtree")}
    backend = "native" if neighbors._native_library() is not None else "kdtree"
    assert used[backend] == 1 and sum(used.values()) == 1
    ref = neighbors._neighbor_pairs_kdtree(*args)
    key = lambda p: sorted(zip(p[0].tolist(), p[1].tolist(), map(tuple, p[2].tolist())))  # noqa: E731
    assert key(pairs) == key(ref)


def test_auto_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device: "cpu"'):
        ttrain._device("auto")
    assert ttrain._device("cpu") == torch.device("cpu")
    options = {"architecture": {"name": "pet"}, "training_set": "missing.xyz", "device": "auto"}
    with pytest.raises(RuntimeError, match="no|none"):
        ttrain.train_model(options)


def test_auto_device_is_the_first_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ttrain._device("auto") == torch.device("cuda", 0)


def test_pet_from_checkpoint_defaults_to_the_card():
    assert inspect.signature(pet_from_checkpoint).parameters["device"].default == "cuda"
    path = Path(__file__).parent / "checkpoints" / "pet_model-v3_trainer-v1.ckpt.gz"
    model = pet_from_checkpoint(path, device="cpu")
    assert next(model.parameters()).device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            pet_from_checkpoint(path)
