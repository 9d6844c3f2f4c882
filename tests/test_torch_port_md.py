"""Port parity: the MD entry points vs the JAX package.

On the CPU, a float32 PET (tiny widths, random weights) exported by the
port as a ``.mtt``, on a periodic 32-atom Cu cell:

- ``Calculator(path, device="cpu").compute`` against the JAX package's
  ``Calculator(path, colored=False).compute``: energy, forces and stress
  to 1e-5 relative (of the largest value), both networks in float32;
- ``run_md_nve`` against the JAX package's: 20 steps of 1 fs,
  ``check_interval`` 5, a skin small enough that the list is rebuilt; the
  two call
  ``VerletNeighborList.update`` equally often (at least twice) and end
  within 1e-5 A of each other;
- the ASE adapter: without ``ase``, building it raises the JAX package's
  error; against a stub ``ase`` it returns the calculator's energy, forces
  and stress;
- a model path without a card raises unless ``device="cpu"`` is passed.
"""

import importlib
import sys
import types

import numpy as np
import pytest
import torch

import metatrain_tpu.ops.neighbors as jneighbors
import metatrain_tpu_torch.ase_calculator as ase_calculator
import metatrain_tpu_torch.ops.neighbors as tneighbors
from _torch_port_helpers import rel
from conftest import make_crystal
from metatrain_tpu.calculator import Calculator as JaxCalculator
from metatrain_tpu.containers import System as JaxSystem
from metatrain_tpu_torch.calculator import Calculator
from metatrain_tpu_torch.cli.export import export_model_object
from metatrain_tpu_torch.containers import System
from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info
from metatrain_tpu_torch.models.pet import PET

TOL = 1e-5  # float32 networks in both packages
MODEL = {"d_pet": 16, "d_node": 16, "d_head": 16, "d_feedforward": 16, "num_heads": 2,
         "num_gnn_layers": 1, "num_attention_layers": 1, "cutoff": 4.5}


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    info = DatasetInfo("angstrom", [29], {"energy": get_energy_target_info("eV", True)})
    model = PET(MODEL, info)
    model.init_weights(torch.Generator().manual_seed(3))
    model.composition.weights["energy"][:] = -3.5
    path = tmp_path_factory.mktemp("md") / "model.mtt"
    export_model_object(model, None, str(path))
    return str(path)


def _cell(seed=4):
    s = make_crystal(n_cells=2, seed=seed, jitter=0.1)
    return System(s.positions, np.full(len(s.types), 29), s.cell, s.pbc)


def _jax_system(s):
    return JaxSystem(s.positions, s.types, s.cell, s.pbc)


def test_compute_matches_jax(model_path):
    system = _cell()
    theirs = JaxCalculator(model_path, colored=False).compute(_jax_system(system), stress=True)
    ours = Calculator(model_path, device="cpu").compute(system, stress=True)
    assert abs(ours["energy"] - theirs["energy"]) <= TOL * abs(theirs["energy"])
    for key in ("forces", "stress"):
        assert ours[key].shape == np.shape(theirs[key]) and rel(ours[key], theirs[key]) < TOL


def test_run_md_nve_matches_jax(model_path, monkeypatch):
    counts = {}
    for side, cls in (("jax", jneighbors.VerletNeighborList),
                      ("port", tneighbors.VerletNeighborList)):
        def counted(self, system, *args, _update=cls.update, _side=side, **kwargs):
            counts[_side] = counts.get(_side, 0) + 1
            return _update(self, system, *args, **kwargs)

        monkeypatch.setattr(cls, "update", counted)
    system = _cell()
    masses = np.full(len(system), 63.546)
    # 1 fs in ASE time units; the random model's forces reach ~17 eV/A,
    # so the atoms move ~0.4 A and the 0.02 A skin forces rebuilds
    kwargs = {"timestep": 0.09822694788464063, "n_steps": 20, "check_interval": 5}
    theirs = JaxCalculator(model_path, skin=0.02, colored=False).run_md_nve(
        _jax_system(system), masses, **kwargs)
    ours = Calculator(model_path, skin=0.02, device="cpu").run_md_nve(system, masses, **kwargs)
    assert counts["port"] == counts["jax"] >= 2
    assert np.abs(ours.positions - theirs.positions).max() <= 1e-5
    assert np.abs(ours.positions - system.positions).max() > 0.02  # the atoms moved


def test_model_path_needs_a_card_unless_asked(model_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        Calculator(model_path)
    assert Calculator(model_path, device="cpu").device == torch.device("cpu")


def test_ase_adapter_clear_error_without_ase():
    with pytest.MonkeyPatch.context() as mp:
        for name in ("ase", "ase.calculators", "ase.calculators.calculator"):
            mp.setitem(sys.modules, name, None)  # import ase now fails
        module = importlib.reload(ase_calculator)
        assert not module._HAVE_ASE
        with pytest.raises(ImportError, match="'ase' package"):
            module.MetatrainTPUCalculator("nonexistent.mtt")
    importlib.reload(ase_calculator)


class _StubASECalculator:
    def __init__(self):
        self.results = {}

    def calculate(self, atoms=None, properties=("energy",), system_changes=()):
        self.atoms = atoms


class _StubAtoms:
    def __init__(self, system):
        self.system = system

    def get_positions(self):
        return self.system.positions

    def get_atomic_numbers(self):
        return self.system.types

    def get_cell(self):
        return self.system.cell

    def get_pbc(self):
        return self.system.pbc


def test_ase_adapter_against_a_stub(model_path):
    stub = types.ModuleType("ase.calculators.calculator")
    stub.Calculator, stub.all_changes = _StubASECalculator, ("positions",)
    system = _cell(seed=7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "ase", types.ModuleType("ase"))
        mp.setitem(sys.modules, "ase.calculators", types.ModuleType("ase.calculators"))
        mp.setitem(sys.modules, "ase.calculators.calculator", stub)
        module = importlib.reload(ase_calculator)
        assert module._HAVE_ASE
        calc = module.MetatrainTPUCalculator(model_path, device="cpu")
        calc.calculate(_StubAtoms(system), ["energy", "forces", "stress"])
    importlib.reload(ase_calculator)
    expected = Calculator(model_path, device="cpu").compute(system, stress=True)
    assert calc.results["energy"] == expected["energy"]
    np.testing.assert_array_equal(calc.results["forces"], expected["forces"])
    s = expected["stress"]
    np.testing.assert_array_equal(calc.results["stress"],
                                  [s[0, 0], s[1, 1], s[2, 2], s[1, 2], s[0, 2], s[0, 1]])
