"""The port stands alone and runs on the card unless asked otherwise.

- No file of the port (nor ``chip_smoke.py``) opens, compiles or imports
  anything under the JAX package's directory: its neighbor-list source is
  its own copy. Comments and docstrings may name the counterpart module,
  and ``file:line`` references to the TPU kernels a CUDA kernel replaces
  are reports, not paths that are opened.
- ``device: "auto"`` trains on the first CUDA device and raises without one.
- ``pet_from_checkpoint`` puts the model on the card unless the caller
  passes another device.
- The direct long-range sum of non-periodic systems takes the pairs within
  the model's cutoff: a list that reaches 0.5 A further (a calculator's
  skin) gives the same energy, forces and virial.
- ZBL's host prediction has a strain gradient (it agrees with finite
  differences of its energy under a strain), its removal subtracts it, and
  ``forward_eval`` adds it back: the removed virial plus what the served
  call adds is the virial read from the file.
"""

import ast
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import metatrain_tpu_torch
from conftest import make_crystal, make_molecule
from metatrain_tpu_torch.cli import train as ttrain
from metatrain_tpu_torch.containers import System, batch_from_systems
from metatrain_tpu_torch.data import dataset as tdataset
from metatrain_tpu_torch.data.readers.extxyz import write_xyz
from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info
from metatrain_tpu_torch.engine.evaluate import evaluate_model
from metatrain_tpu_torch.interop.jax_params import pet_from_checkpoint
from metatrain_tpu_torch.models.pet import PET
from metatrain_tpu_torch.ops import neighbors
from metatrain_tpu_torch.ops.inference import no_param_grads
from metatrain_tpu_torch.ops.neighbors import compute_neighbor_data
from metatrain_tpu_torch.utils import config as tconfig

PORT = Path(metatrain_tpu_torch.__file__).resolve().parent
ROOT = PORT.parent
JAX_PATH = re.compile(r"metatrain_tpu/")
KERNEL_REFERENCE = re.compile(r"^metatrain_tpu/\S+\.py:\d+")
C_SUFFIXES = (".cu", ".cuh", ".cpp")


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


def _c_includes_of_jax_paths(root):
    """``#include`` lines that name a path of the JAX package, per C source
    under ``root`` (the suffixes of ``C_SUFFIXES`` only: bytecode and the
    build's outputs beside the sources are not read)."""
    found = {}
    for source in sorted(p for p in root.rglob("*") if p.suffix in C_SUFFIXES):
        includes = [line for line in source.read_text().splitlines()
                    if line.lstrip().startswith("#include") and "metatrain_tpu/" in line]
        if includes:
            found[str(source.relative_to(root))] = includes
    return found


def test_port_names_no_path_of_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offences = {str(f.relative_to(ROOT)): _offences(f.read_text()) for f in files}
    assert {f: b for f, b in offences.items() if b} == {}
    assert _c_includes_of_jax_paths(PORT) == {}
    # the check itself catches a path that is opened
    assert _offences('open(ROOT / "metatrain_tpu/native/neighbors.cpp")')
    assert _offences('PACKAGE_DIR.parent / "metatrain_tpu" / "native"')
    assert _offences("from metatrain_tpu.ops import neighbors")
    assert not _offences('REPLACES = "metatrain_tpu/ops/pallas/attention.py:412"')


def test_c_include_check_catches_a_jax_path(tmp_path):
    """The C half of the check above still fails on a source that includes
    a path of the JAX package, whatever its suffix among ``C_SUFFIXES``,
    and reads no bytecode (a ``.pyc`` is not UTF-8 text)."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "own.cuh").write_text('#pragma once\n#include "common.cuh"\n')
    (tmp_path / "csrc" / "bad.cu").write_text('#include "own.cuh"\n'
                                              '  #include "../../metatrain_tpu/native/x.h"\n')
    (tmp_path / "native").mkdir()
    (tmp_path / "native" / "bad.cpp").write_text("#include <metatrain_tpu/native/neighbors.cpp>\n")
    (tmp_path / "__pycache__").mkdir()
    (tmp_path / "__pycache__" / "mod.cpython-312.pyc").write_bytes(bytes(range(256)) * 4)
    assert _c_includes_of_jax_paths(tmp_path) == {
        "csrc/bad.cu": ['  #include "../../metatrain_tpu/native/x.h"'],
        "native/bad.cpp": ["#include <metatrain_tpu/native/neighbors.cpp>"],
    }


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


# ---- the direct long-range sum's reach ------------------------------------------------

SMALL = {"cutoff": 4.0, "d_pet": 16, "d_head": 16, "d_node": 24, "d_feedforward": 16,
         "num_heads": 2, "num_gnn_layers": 2, "num_attention_layers": 1}
ENERGY = {"energy": get_energy_target_info("eV", True, True)}


def _energy_forces_virial(model, system, list_cutoff):
    nbr = compute_neighbor_data(system, list_cutoff)
    batch = batch_from_systems([system], [nbr], torch.device("cpu"), dtype=torch.float64)
    with no_param_grads(model):
        block = evaluate_model(model.forward_eval, batch, ENERGY)["energy"].block(0)
    n = len(system)
    return (block.values[0].detach().numpy(), block.gradient("positions").values[:n].numpy(),
            block.gradient("strain").values[0].numpy(), nbr.max_neighbors)


def test_direct_sum_is_the_same_with_a_longer_list():
    model = PET({**SMALL, "long_range": {"enable": True, "method": "ewald", "smearing": 1.4}},
                DatasetInfo("angstrom", [1, 6, 8], ENERGY), compute_dtype=torch.float64)
    model.init_weights(torch.Generator().manual_seed(1))
    system = make_molecule(n_atoms=12, seed=2)
    at_cutoff = _energy_forces_virial(model, system, SMALL["cutoff"])
    with_skin = _energy_forces_virial(model, system, SMALL["cutoff"] + 0.5)
    assert with_skin[3] > at_cutoff[3]  # the longer list holds more pairs
    for a, b in zip(at_cutoff[:3], with_skin[:3]):
        assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max()


# ---- ZBL's strain gradient ----------------------------------------------------------------


def _close_pair_crystal():
    crystal = make_crystal(n_cells=2, seed=4, jitter=0.1)
    crystal.positions[1] = crystal.positions[0] + np.array([0.9, 0.3, 0.1])
    return System(crystal.positions, crystal.types, crystal.cell, crystal.pbc)


def test_zbl_strain_gradient_matches_finite_differences():
    from metatrain_tpu_torch.models.zbl import ZBL

    zbl = ZBL(DatasetInfo("angstrom", [29], ENERGY), 4.5, 0.5)
    system = _close_pair_crystal()
    got = zbl.predict_host(system)["strain_gradient"]
    h = 1e-6
    expected = np.zeros((3, 3))
    for a in range(3):
        for b in range(3):
            energies = []
            for sign in (1, -1):
                strain = np.eye(3)
                strain[a, b] += sign * h
                strained = System(system.positions @ strain, system.types,
                                  system.cell @ strain, system.pbc)
                energies.append(zbl.predict_host(strained)["energy"])
            expected[a, b] = (energies[0] - energies[1]) / (2 * h)
    assert np.abs(got).max() > 1.0
    assert np.abs(got - expected).max() <= 1e-6 * np.abs(expected).max()


@pytest.mark.parametrize("form", ["virial", "stress"])
def test_zbl_removal_and_serving_give_the_virial_back(form, tmp_path):
    system = _close_pair_crystal()
    rng = np.random.default_rng(0)
    virial = rng.normal(size=(3, 3))
    path = str(tmp_path / "frame.xyz")
    write_xyz(path, [system], per_atom_arrays=[{"forces": rng.normal(size=(len(system), 3))}],
              info=[{"energy": 1.0, form: virial.reshape(-1)}])
    conf = {"systems": {"read_from": path, "length_unit": "angstrom"},
            "targets": {"energy": {"key": "energy", "unit": "eV", "forces": "on", form: "on"}}}
    data, infos = tdataset.get_dataset(tconfig.expand_dataset_config(conf))
    system = data[0].system  # as read (the file keeps 10 decimal places)
    model = PET({**SMALL, "cutoff": 4.5, "zbl": True},
                DatasetInfo("angstrom", [29], infos), compute_dtype=torch.float64)
    model.init_weights(torch.Generator().manual_seed(2))
    original = data[0].targets["energy"].block(0).gradient("strain").values[0, :, :, 0]
    removed = model.zbl.remove_transform([data[0]])[0].targets["energy"].block(0)
    removed = removed.gradient("strain").values[0, :, :, 0]
    zbl_part = model.zbl.predict_host(system)["strain_gradient"]
    np.testing.assert_allclose(removed, original - zbl_part, rtol=1e-14, atol=1e-14)
    # what serving adds to the network's strain gradient is ZBL's (the
    # scaler is 1 and the composition has none)
    nbr = compute_neighbor_data(system, model.cutoff)
    batch = batch_from_systems([system], [nbr], torch.device("cpu"), dtype=torch.float64)
    with no_param_grads(model):
        served, network = (evaluate_model(fn, batch, infos)["energy"].block(0)
                           .gradient("strain").values[0, :, :, 0].numpy()
                           for fn in (model.forward_eval, model.forward))
    added = served - network
    assert np.abs(added - zbl_part).max() <= 1e-10 * np.abs(zbl_part).max()
    np.testing.assert_allclose(removed + added, original, rtol=0,
                               atol=1e-10 * np.abs(original).max())
