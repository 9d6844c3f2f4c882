"""The PyTorch port's force-call slice: imports, host code, engine, init.

Checks around the parity tests of ``test_torch_port_pet.py``: the port
imports nothing of JAX, its neighbor lists equal the JAX package's (and
its cKDTree fallback equals its cell list), the gather-only adjoints are
exact, forces are the derivative of the energy,
the calculator's Verlet reuse changes nothing, random weights follow
flax's initializer families, bf16 stays within the JAX package's bf16
bounds, and configurations off the slice are refused.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_port_helpers  # noqa: F401  (one torch thread per test worker)
from conftest import make_crystal, make_molecule
from metatrain_tpu.ops.neighbors import compute_neighbor_data as jax_neighbor_data
from metatrain_tpu_torch.calculator import Calculator
from metatrain_tpu_torch.containers import System, batch_from_systems
from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info
from metatrain_tpu_torch.engine.evaluate import evaluate_model
from metatrain_tpu_torch.models.pet import PET
from metatrain_tpu_torch.models.pet.modules import lecun_normal_
from metatrain_tpu_torch.ops.inference import no_param_grads
from metatrain_tpu_torch.ops.involution import nbr_gather, permute_rows
from metatrain_tpu_torch.ops.neighbors import (
    _neighbor_pairs_kdtree,
    compute_neighbor_data,
    neighbor_pairs,
)

HYPERS = {"cutoff": 4.5, "d_pet": 32, "d_head": 32, "d_node": 48, "d_feedforward": 32,
          "num_heads": 4, "num_gnn_layers": 2, "num_attention_layers": 1}


def _port_system(system):
    return System(system.positions, system.types, system.cell, system.pbc)


def _model(types, dtype=torch.float64, hypers=HYPERS, seed=0):
    info = DatasetInfo("angstrom", types, {"energy": get_energy_target_info("eV")})
    model = PET(hypers, info, compute_dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import metatrain_tpu_torch.calculator, metatrain_tpu_torch.models.pet\n"
        "import metatrain_tpu_torch.ops.kernels.fused_layer, metatrain_tpu_torch.ops.kernels.rowblock\n"
        "import metatrain_tpu_torch.ops.kernels._lib, metatrain_tpu_torch.interop.jax_params\n"
        "import metatrain_tpu_torch.cli.train, metatrain_tpu_torch.engine.trainer\n"
        "import metatrain_tpu_torch.data.readers, metatrain_tpu_torch.utils.config\n"
        "new = set(sys.modules) - before\n"
        "banned = ('jax', 'jaxlib', 'flax', 'metatrain_tpu', 'pydantic', 'yaml')\n"
        "bad = sorted(m for m in new if m.split('.')[0] in banned)\n"
        "print(bad)\n"
        "assert not bad and 'metatrain_tpu_torch' in new\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("system", [make_molecule(), make_crystal()], ids=["molecule", "crystal"])
def test_neighbor_lists_match_jax(system):
    ref = jax_neighbor_data(system, 4.5)
    got = compute_neighbor_data(_port_system(system), 4.5)

    def edges(nbr):
        rows = []
        for i in range(len(nbr.indices)):
            for m in np.nonzero(nbr.mask[i])[0]:
                rows.append((i, int(nbr.indices[i, m]), *nbr.shifts[i, m].tolist()))
        return sorted(rows)

    assert edges(got) == edges(ref)
    # the reversal is an involution pairing (i, j, S) with (j, i, -S)
    M = got.max_neighbors
    flat_rev = got.reverse.reshape(-1)
    assert (flat_rev[flat_rev] == np.arange(flat_rev.size)).all()
    for i, m in zip(*np.nonzero(got.mask)):
        j, s = divmod(int(got.reverse[i, m]), M)
        assert got.indices[j, s] == i and (got.shifts[j, s] == -got.shifts[i, m]).all()


@pytest.mark.parametrize("system", [make_molecule(), make_crystal()], ids=["molecule", "crystal"])
def test_kdtree_fallback_matches_cell_list(system):
    def pair_set(pairs):
        centers, neighbors, shifts = pairs
        return sorted(zip(centers.tolist(), neighbors.tolist(), map(tuple, shifts.tolist())))

    args = (system.positions, system.cell, system.pbc, 4.5)
    assert pair_set(_neighbor_pairs_kdtree(*args)) == pair_set(neighbor_pairs(*args))


def test_gather_adjoints_are_exact():
    system = _port_system(make_crystal())
    nbr = compute_neighbor_data(system, 4.5)
    batch = batch_from_systems([system], [nbr], torch.device("cpu"), dtype=torch.float64)
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.normal(size=(batch.n_atoms_padded, 3))).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=tuple(batch.nbr_indices.shape) + (3,)))
    (ours,) = torch.autograd.grad(nbr_gather(pos, batch.nbr_indices, batch.nbr_reverse), pos, g)
    (ref,) = torch.autograd.grad(pos[batch.nbr_indices], pos, g)
    assert torch.allclose(ours, ref, rtol=1e-13, atol=1e-13)
    x = torch.from_numpy(rng.normal(size=(batch.nbr_reverse.numel(), 5))).requires_grad_(True)
    rev = batch.nbr_reverse.reshape(-1)
    gx = torch.from_numpy(rng.normal(size=(rev.numel(), 5)))
    (ours,) = torch.autograd.grad(permute_rows(x, rev), x, gx)
    (ref,) = torch.autograd.grad(x[rev], x, gx)
    assert torch.equal(ours, ref)


def test_forces_and_virial_are_energy_derivatives():
    system = _port_system(make_crystal(seed=2))
    model = _model([29])
    info = {"energy": get_energy_target_info("eV", True, True)}
    nbr = compute_neighbor_data(system, model.cutoff + 0.5)

    def block_at(positions, cell):
        s = System(positions, system.types, cell, system.pbc)
        b = batch_from_systems([s], [nbr], torch.device("cpu"), dtype=torch.float64)
        with no_param_grads(model):
            return evaluate_model(model.forward_eval, b, info)["energy"].block(0)

    def energy(positions, cell):
        return float(block_at(positions, cell).values[0, 0].detach())

    block = block_at(system.positions, system.cell)
    forces = -block.gradient("positions").values[:, :, 0].numpy()
    virial = -block.gradient("strain").values[0, :, :, 0].numpy()
    h = 1e-5
    for atom, axis in [(0, 0), (5, 1), (17, 2)]:
        dp = np.zeros_like(system.positions)
        dp[atom, axis] = h
        e_plus = energy(system.positions + dp, system.cell)
        e_minus = energy(system.positions - dp, system.cell)
        assert abs(-(e_plus - e_minus) / (2 * h) - forces[atom, axis]) < 1e-6 * np.abs(forces).max()
    # virial: -dE/d(strain) for a homogeneous deformation x -> x (1 + eps)
    eps = np.zeros((3, 3))
    eps[0, 1] = h
    e_plus = energy(system.positions @ (np.eye(3) + eps), system.cell @ (np.eye(3) + eps))
    e_minus = energy(system.positions @ (np.eye(3) - eps), system.cell @ (np.eye(3) - eps))
    assert abs(-(e_plus - e_minus) / (2 * h) - virial[0, 1]) < 1e-6 * np.abs(virial).max()


def test_calculator_verlet_reuse_matches_fresh_build():
    system = make_crystal(seed=1)
    model = _model([29])
    calc = Calculator(model, dtype=torch.float64)
    calc.compute(_port_system(system), forces=True, stress=True)
    first_nbr = calc._last_nbr
    moved = System(system.positions + np.random.default_rng(0).normal(0, 0.02, system.positions.shape),
                   system.types, system.cell, system.pbc)
    reused = calc.compute(moved, forces=True, stress=True)
    assert calc._last_nbr is first_nbr
    fresh = Calculator(model, dtype=torch.float64).compute(moved, forces=True, stress=True)
    assert abs(reused["energy"] - fresh["energy"]) <= 1e-12 * abs(fresh["energy"])
    for key in ("forces", "stress", "virial"):
        assert np.abs(reused[key] - fresh[key]).max() <= 1e-12 * np.abs(fresh[key]).max()
    assert all(not p.requires_grad for p in model.parameters())


def test_random_init_follows_flax_families():
    model = _model([1, 6, 8], dtype=torch.float32, seed=3)
    for name, p in model.module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        values = p.detach().double()
        if leaf.startswith("b_") or leaf == "bias":
            assert (values == 0).all(), name
        elif leaf.startswith("norm_") or "norm" in name:
            assert (values == 1).all(), name
        elif "embedder" in name:
            assert abs(values.std().item() * np.sqrt(p.shape[1]) - 1) < 0.5, name
        else:
            fan_in = p.shape[0] if name.split(".")[-1].startswith("w_") else p.shape[1]
            std = 1 / np.sqrt(fan_in)
            if p.numel() >= 512:
                assert abs(values.std().item() / std - 1) < 0.15, name
            assert values.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6, name
    # the truncated normal has flax's variance, drawn at the same size
    t = torch.empty(512, 256)
    lecun_normal_(t, 512, torch.Generator().manual_seed(0))
    flax = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (512, 256)))
    assert abs(t.std().item() / flax.std() - 1) < 0.02


def test_bf16_force_call_within_bounds():
    system = _port_system(make_crystal(n_cells=2, seed=3))
    hypers = {"cutoff": 4.5, "d_pet": 64, "d_head": 64, "d_node": 96, "d_feedforward": 64,
              "num_heads": 4, "num_attention_layers": 1, "num_gnn_layers": 2}
    ref = _model([29], torch.float32, hypers)
    low = _model([29], torch.bfloat16, hypers)
    low.module.load_state_dict(ref.module.state_dict())
    results = [Calculator(m).compute(system) for m in (ref, low)]
    f32, f16 = results[0]["forces"], results[1]["forces"]
    assert np.sqrt(np.mean((f16 - f32) ** 2)) / np.sqrt(np.mean(f32**2)) < 0.05
    assert abs(results[1]["energy"] - results[0]["energy"]) / abs(results[0]["energy"]) < 0.01


@pytest.mark.parametrize("change", [
    {"featurizer_type": "residual"}, {"fused_layers": False}, {"normalization": "LayerNorm"},
    {"long_range": {"enable": True}}, {"system_conditioning": True},
    {"num_neighbors_adaptive": 8}, {"zbl": True},
])
def test_off_slice_configurations_are_refused(change):
    info = DatasetInfo("angstrom", [1], {"energy": get_energy_target_info("eV")})
    with pytest.raises(NotImplementedError):
        PET({**HYPERS, **change}, info)
