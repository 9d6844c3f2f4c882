"""Port parity: the metatensor ``.mts`` / metatomic ``.mta`` formats vs the JAX package.

On the CPU, maps made from a numpy seed in both packages' containers:

- ``mts_bytes`` of the port equals the JAX package's byte for byte (the
  zip members' times held fixed) for an energy with position and strain
  gradients and for a per-atom spherical map of two blocks; each package
  loads the other's file to the same labels and values, bit for bit;
- ``mta_bytes`` likewise for a system;
- ``split_by_system`` and ``read_mts_target`` (an energy, and a spherical
  target from its ``type`` section) give the JAX package's maps and
  TargetInfos, and the same error for a file of the wrong system count;
- the targets' ``.mts`` route of ``read_targets``, and ``eval`` of a
  float64 model with its energy read from an ``.mts`` file, equal the
  extended-xyz route's maps and metrics.
"""

import json
import time

import numpy as np
import pytest
import torch

import metatrain_tpu.containers as jc
import metatrain_tpu.data.readers.mts as jmts
import metatrain_tpu_torch.containers as tc
import metatrain_tpu_torch.data.readers.mts as tmts
from conftest import make_crystal
from metatrain_tpu_torch.cli.eval import eval_model
from metatrain_tpu_torch.cli.export import export_model_object
from metatrain_tpu_torch.data.readers import read_targets
from metatrain_tpu_torch.data.readers.extxyz import read_xyz, write_xyz
from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info
from metatrain_tpu_torch.models.pet import PET

IRREPS = [{"o3_lambda": 0, "o3_sigma": 1}, {"o3_lambda": 2, "o3_sigma": 1}]
N_SYSTEMS, N_ATOMS = 3, 4


def _range(c, name, n):
    return c.Labels([name], np.arange(n, dtype=np.int32).reshape(-1, 1))


def energy_map(c, seed=0):
    """An energy of ``N_SYSTEMS`` systems with position and strain gradients."""
    rng = np.random.default_rng(seed)
    props = c.Labels(["energy"], np.zeros((1, 1), np.int32))
    block = c.TensorBlock(rng.normal(size=(N_SYSTEMS, 1)), _range(c, "system", N_SYSTEMS), [],
                          props)
    g_samples = [[s, s, a] for s in range(N_SYSTEMS) for a in range(N_ATOMS)]
    block.add_gradient("positions", c.TensorBlock(
        rng.normal(size=(len(g_samples), 3, 1)),
        c.Labels(["sample", "system", "atom"], np.asarray(g_samples, np.int32)),
        [_range(c, "xyz", 3)], props))
    block.add_gradient("strain", c.TensorBlock(
        rng.normal(size=(N_SYSTEMS, 3, 3, 1)), _range(c, "sample", N_SYSTEMS),
        [_range(c, "xyz_1", 3), _range(c, "xyz_2", 3)], props))
    return c.TensorMap(c.Labels.single(), [block])


def spherical_map(c, seed=1, n_props=2):
    """A per-atom spherical map of ``IRREPS``, atoms of systems 0, 1, 2
    with 4, 2 and 3 atoms."""
    rng = np.random.default_rng(seed)
    samples = np.asarray([[s, a] for s, n in enumerate((4, 2, 3)) for a in range(n)], np.int32)
    keys = c.Labels(["o3_lambda", "o3_sigma"],
                    np.asarray([[ir["o3_lambda"], ir["o3_sigma"]] for ir in IRREPS], np.int32))
    blocks = []
    for ir in IRREPS:
        n_mu = 2 * ir["o3_lambda"] + 1
        mu = c.Labels(["o3_mu"], np.arange(-ir["o3_lambda"], ir["o3_lambda"] + 1,
                                           dtype=np.int32).reshape(-1, 1))
        blocks.append(c.TensorBlock(rng.normal(size=(len(samples), n_mu, n_props)),
                                    c.Labels(["system", "atom"], samples), [mu],
                                    _range(c, "properties", n_props)))
    return c.TensorMap(keys, blocks)


MAPS = {"energy": energy_map, "spherical": spherical_map}


def assert_same_map(ours, theirs):
    """Keys, labels, values and gradients equal, bit for bit."""
    assert ours.keys.names == theirs.keys.names
    assert np.array_equal(np.asarray(ours.keys.values), np.asarray(theirs.keys.values))
    assert len(ours) == len(theirs)
    for a, b in zip(ours.blocks(), theirs.blocks()):
        assert_same_block(a, b)


def assert_same_block(a, b):
    va, vb = np.asarray(a.values), np.asarray(b.values)
    assert va.dtype == vb.dtype and va.shape == vb.shape and np.array_equal(va, vb)
    for la, lb in [(a.samples, b.samples), (a.properties, b.properties),
                   *zip(a.components, b.components)]:
        assert la.names == lb.names
        assert np.array_equal(np.asarray(la.values), np.asarray(lb.values))
    assert len(a.components) == len(b.components)
    assert a.gradients_list() == b.gradients_list()
    for name in a.gradients_list():
        assert_same_block(a.gradient(name), b.gradient(name))


@pytest.fixture
def frozen_clock(monkeypatch):
    """Every zip member stamped with one time, so two writers' bytes compare."""
    monkeypatch.setattr(time, "time", lambda: 1.6e9)


@pytest.mark.parametrize("kind", sorted(MAPS))
def test_mts_bytes_equal_jax_and_load_across(kind, frozen_clock, tmp_path):
    ours, theirs = MAPS[kind](tc), MAPS[kind](jc)
    data = tmts.mts_bytes(ours)
    assert data == jmts.mts_bytes(theirs)
    tmts.save_mts(ours, str(tmp_path / "port.mts"))
    jmts.save_mts(theirs, str(tmp_path / "jax.mts"))
    assert_same_map(tmts.load_mts(str(tmp_path / "jax.mts")), theirs)
    assert_same_map(jmts.load_mts(str(tmp_path / "port.mts")), ours)
    assert_same_map(tmts.load_mts_bytes(data), ours)


def test_mta_bytes_equal_jax(frozen_clock):
    s = make_crystal(n_cells=2, seed=3, jitter=0.1)
    ours = tc.System(s.positions, s.types, s.cell, s.pbc)
    data = tmts.mta_bytes(ours)
    assert data == jmts.mta_bytes(jc.System(s.positions, s.types, s.cell, s.pbc))
    theirs = jmts.load_mta_bytes(data)
    back = tmts.load_mta_bytes(data)
    for field in ("positions", "types", "cell", "pbc"):
        a, b = getattr(back, field), getattr(theirs, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("kind", sorted(MAPS))
def test_split_by_system_matches_jax(kind):
    ours = tmts.split_by_system(MAPS[kind](tc))
    theirs = jmts.split_by_system(MAPS[kind](jc))
    assert len(ours) == len(theirs) == N_SYSTEMS
    for a, b in zip(ours, theirs):
        assert_same_map(a, b)
        assert set(np.asarray(a.block(0).samples.column("system"))) == {0}


CONFIGS = {
    "energy": ({"unit": "eV", "quantity": "energy"}, True),
    "spherical": ({"type": {"spherical": {"irreps": IRREPS}}, "unit": "", "quantity": ""}, False),
}


def _layout_signature(info):
    """A TargetInfo's layout as plain data: keys, and per block the sample
    names, components, properties and gradients."""
    blocks = []
    for block in info.layout.blocks():
        blocks.append((block.samples.names,
                       [(c.names, np.asarray(c.values).tolist()) for c in block.components],
                       (block.properties.names, np.asarray(block.properties.values).tolist()),
                       block.gradients_list()))
    return (info.layout.keys.names, np.asarray(info.layout.keys.values).tolist(), blocks,
            info.quantity, info.unit, info.per_atom)


@pytest.mark.parametrize("kind", sorted(MAPS))
def test_read_mts_target_matches_jax(kind, tmp_path):
    path = str(tmp_path / f"{kind}.mts")
    tmts.save_mts(MAPS[kind](tc), path)
    config, is_energy = CONFIGS[kind]
    ours, our_info = tmts.read_mts_target(path, dict(config), N_SYSTEMS, is_energy)
    theirs, their_info = jmts.read_mts_target(path, dict(config), N_SYSTEMS, is_energy)
    assert len(ours) == len(theirs) == N_SYSTEMS
    for a, b in zip(ours, theirs):
        assert_same_map(a, b)
    assert _layout_signature(our_info) == _layout_signature(their_info)

    # the wrong system count: the same error in both
    with pytest.raises(ValueError) as our_err:
        tmts.read_mts_target(path, dict(config), 7, is_energy)
    with pytest.raises(ValueError) as their_err:
        jmts.read_mts_target(path, dict(config), 7, is_energy)
    assert str(our_err.value) == str(their_err.value) and "expected 7" in str(our_err.value)


def test_mts_layout_checks_match_jax(tmp_path):
    """A spherical file read as the wrong type fails in both, with the
    same message."""
    path = str(tmp_path / "spherical.mts")
    tmts.save_mts(spherical_map(tc), path)
    config = {"type": {"cartesian": {"rank": 1}}}
    with pytest.raises(ValueError) as ours:
        tmts.read_mts_target(path, dict(config), N_SYSTEMS, False)
    with pytest.raises(ValueError) as theirs:
        jmts.read_mts_target(path, dict(config), N_SYSTEMS, False)
    assert str(ours.value) == str(theirs.value)


def _labelled_frames(n=3):
    frames = []
    for i in range(n):
        s = make_crystal(n_cells=2, seed=20 + i, jitter=0.1)
        frames.append(tc.System(s.positions, np.full(len(s.types), 29), s.cell, s.pbc))
    rng = np.random.default_rng(7)
    energies = [float(e) for e in rng.normal(size=n)]
    forces = [rng.normal(size=(len(f), 3)) for f in frames]
    return frames, energies, forces


def _joined_energy(energies, forces):
    """The frames' energy and forces as one joined map (gradient = -forces)."""
    props = tc.Labels(["energy"], np.zeros((1, 1), np.int32))
    block = tc.TensorBlock(np.asarray(energies).reshape(-1, 1),
                           _range(tc, "system", len(energies)), [], props)
    g_samples = [[s, s, a] for s, f in enumerate(forces) for a in range(len(f))]
    block.add_gradient("positions", tc.TensorBlock(
        -np.concatenate(forces).reshape(-1, 3, 1),
        tc.Labels(["sample", "system", "atom"], np.asarray(g_samples, np.int32)),
        [_range(tc, "xyz", 3)], props))
    return tc.TensorMap(tc.Labels.single(), [block])


def test_mts_route_equals_the_xyz_route(tmp_path):
    """``read_targets`` of an energy from an ``.mts`` file gives the maps
    of the same energy and forces read from extended xyz, and ``eval`` of
    a float64 model gives the same metrics from either."""
    frames, energies, forces = _labelled_frames()
    xyz = str(tmp_path / "frames.xyz")
    write_xyz(xyz, frames, per_atom_arrays=[{"forces": f} for f in forces],
              info=[{"energy": e} for e in energies])
    read_back = read_xyz(xyz)  # the forces as the text holds them
    forces = [s.extra["forces"] for s in read_back]
    mts = str(tmp_path / "energy.mts")
    tmts.save_mts(_joined_energy(energies, forces), mts)

    xyz_cfg = {"key": "energy", "unit": "eV", "quantity": "energy", "forces": {"key": "forces"}}
    ours, info = read_targets(read_back, {"energy": {"read_from": mts, "unit": "eV",
                                                     "quantity": "energy"}})
    ref, ref_info = read_targets(read_back, {"energy": xyz_cfg})
    assert info["energy"].gradients == ref_info["energy"].gradients == ["positions"]
    for a, b in zip(ours["energy"], ref["energy"]):
        va, vb = a.block(0), b.block(0)
        assert np.array_equal(va.values, vb.values)
        assert np.array_equal(va.gradient("positions").values, vb.gradient("positions").values)

    info = DatasetInfo("angstrom", [29], {"energy": get_energy_target_info("eV", True)})
    model = PET({"d_pet": 16, "d_node": 16, "d_head": 16, "d_feedforward": 16, "num_heads": 2,
                 "num_gnn_layers": 1, "num_attention_layers": 1, "cutoff": 4.5}, info,
                compute_dtype=torch.float64)
    model.init_weights(torch.Generator().manual_seed(2))
    path = str(tmp_path / "model.mtt")
    export_model_object(model, None, path)
    section = {"systems": {"read_from": xyz, "length_unit": "angstrom"}}
    via_xyz = eval_model(path, {**section, "targets": {"energy": {
        "key": "energy", "unit": "eV", "forces": "on"}}}, device="cpu",
        compute_dtype=torch.float64)
    via_mts = eval_model(path, {**section, "targets": {"energy": {
        "read_from": mts, "unit": "eV"}}}, device="cpu", compute_dtype=torch.float64)
    assert sorted(via_mts) == sorted(via_xyz) and any("forces" in k for k in via_xyz)
    for key in via_xyz:
        assert abs(via_mts[key] - via_xyz[key]) <= 1e-12 * abs(via_xyz[key]), key
    json.dumps(via_mts)  # plain floats
