"""Port parity: PET's physics options through the whole force call and training.

float64 on the CPU. ZBL, long range (Ewald, PME, and the direct sum for
the non-periodic system), adaptive cutoffs (solver and probe) and
charge/spin conditioning, together, with the fused and the unfused layers,
the GNN block, the residual featurizer and the cosine cutoff function,
on one batch that holds a periodic crystal, a molecule and padded systems:

- energy, forces and virial against the JAX package, with the same
  weights (the conditioning gate drawn, or it would hide the option),
  to 1e-10; with the solver's adaptive cutoffs to 1e-7 (the solver's last
  bisection bracket, ``test_torch_port_physics_ops.py``);
- forces are finite on that batch in float32 and bfloat16, and the
  conditioning changes the energy;
- one training step's loss and parameter gradients (ZBL + long range +
  conditioning, charge and spin in the frames, ZBL's removal in the
  collate) against JAX's; ``train_model`` and ``eval`` build their batches
  with the model's extra keys and remove ZBL after composition;
- checkpoints and ``.mtt`` envelopes in both directions;
- the calculator serves a conditioned model as a neutral singlet.
"""

import copy
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    flax_tree,
    jax_energy_forces_virial,
    neighbors_and_batches,
    port_energy_forces_virial,
    rel,
)
from conftest import make_crystal, make_molecule
from metatrain_tpu.containers import NeighborData as JaxNeighborData
from metatrain_tpu.containers import batch_from_systems as jax_batch_from_systems
from metatrain_tpu.data import collate as jcollate
from metatrain_tpu.data import dataset as jdataset
from metatrain_tpu.data.target_info import DatasetInfo as JaxDatasetInfo
from metatrain_tpu.data.target_info import get_energy_target_info as jax_energy_info
from metatrain_tpu.engine import loss as jloss
from metatrain_tpu.engine import trainer as jtrainer
from metatrain_tpu.models.pet import PET as JaxPET
from metatrain_tpu.utils import config as jconfig
from metatrain_tpu.utils import io as jio
from metatrain_tpu_torch.calculator import Calculator
from metatrain_tpu_torch.cli.export import export_model_object
from metatrain_tpu_torch.cli.train import train_model
from metatrain_tpu_torch.containers import System, batch_from_systems
from metatrain_tpu_torch.data import collate as tcollate
from metatrain_tpu_torch.data import dataset as tdataset
from metatrain_tpu_torch.data.readers.extxyz import write_xyz
from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info
from metatrain_tpu_torch.engine import loss as tloss
from metatrain_tpu_torch.engine import trainer as ttrainer
from metatrain_tpu_torch.interop.jax_params import (
    flax_to_state_dict,
    pet_from_checkpoint,
    state_dict_to_flax,
)
from metatrain_tpu_torch.models.pet import PET
from metatrain_tpu_torch.ops.neighbors import compute_neighbor_data, neighbor_pairs
from metatrain_tpu_torch.utils import config as tconfig
from metatrain_tpu_torch.utils import io as tio

CUTOFF = 4.5
SMALL = {"cutoff": CUTOFF, "d_pet": 16, "d_head": 16, "d_node": 24, "d_feedforward": 16,
         "num_heads": 2, "num_gnn_layers": 2, "num_attention_layers": 1}
ALL = {"zbl": True, "system_conditioning": True, "max_charge": 3, "max_spin_multiplicity": 4,
       "long_range": {"enable": True, "method": "ewald", "n_kmax": 2, "smearing": 1.4}}
PME = {"enable": True, "method": "pme", "mesh": 12, "smearing": 1.4}
UNFUSED = {"fused_layers": False, "normalization": "LayerNorm", "activation": "SiLU",
           "transformer_type": "PostLN", "featurizer_type": "residual"}
CASES = {
    "fused": (ALL, {}, 1e-10),
    "unfused-residual-pme-probe": (
        {**ALL, **UNFUSED, "long_range": PME, "num_neighbors_adaptive": 6,
         "adaptive_cutoff_method": "probe"}, {}, 1e-10),
    "gnn-block": (ALL, {"fused_gnn": True}, 1e-10),
    # the solver's last bisection bracket (test_torch_port_physics_ops.py)
    "solver-cosine": ({**ALL, "num_neighbors_adaptive": 6, "cutoff_function": "Cosine",
                       "fused_layers": False}, {}, 1e-7),
}
TYPES = [1, 6, 8, 29]
CHARGES = ((1, 2), (-1, 3))  # (charge, spin multiplicity) of the crystal and the molecule


def _systems():
    crystal = make_crystal(n_cells=2, seed=2, jitter=0.1)
    molecule = make_molecule(n_atoms=8, seed=3)
    for s, (q, spin) in zip((crystal, molecule), CHARGES):
        s.extra.update(charge=np.asarray(q), spin_multiplicity=np.asarray(spin))
    return [crystal, molecule]


def _batches(systems, extra_keys=("charge", "spin_multiplicity")):
    """One JAX and one port batch of ``systems`` (float64), padded atoms and
    padded systems included."""
    port = [System(s.positions, s.types, s.cell, s.pbc, dict(s.extra)) for s in systems]
    nbrs = [compute_neighbor_data(s, CUTOFF) for s in port]
    j = jax_batch_from_systems(
        systems, [JaxNeighborData(n.indices, n.shifts, n.mask, n.reverse) for n in nbrs],
        dtype=jnp.float64, extra_keys=extra_keys)
    b = batch_from_systems(port, nbrs, torch.device("cpu"), dtype=torch.float64,
                           extra_keys=extra_keys)
    assert b.n_systems_padded > len(systems) and b.n_atoms_padded > sum(map(len, systems))
    return j, b


def _infos():
    return (JaxDatasetInfo("angstrom", TYPES, {"energy": jax_energy_info("eV", True, True)}),
            DatasetInfo("angstrom", TYPES, {"energy": get_energy_target_info("eV", True, True)}))


def _draw_gate(model, seed=1):
    """The conditioning gate starts at zero: draw it, or conditioning acts
    on nothing."""
    gate = model.module.system_conditioning.gate
    with torch.no_grad():
        gate.weight.copy_(torch.randn(gate.weight.shape, generator=torch.Generator().manual_seed(
            seed), dtype=torch.float64) * 0.5)


def _port_model(hypers, dtype=torch.float64, seed=0, **options):
    _, info = _infos()
    model = PET({**SMALL, **hypers}, info, compute_dtype=dtype, **options)
    model.init_weights(torch.Generator().manual_seed(seed))
    if hypers.get("system_conditioning"):
        _draw_gate(model)
    return model


@pytest.mark.parametrize("case", list(CASES))
def test_force_call_matches_jax(case):
    hypers, options, bound = CASES[case]
    port = _port_model(hypers, **options)
    params = flax_tree(port.module)
    port.module.load_state_dict(flax_to_state_dict(params))
    jax_info, info = _infos()
    jax_model = JaxPET({**SMALL, **hypers}, jax_info, compute_dtype=jnp.float64)
    jax_batch, batch = _batches(_systems())
    expected = jax_energy_forces_virial(jax_model, params, jax_batch, dict(jax_info.targets))
    got = port_energy_forces_virial(port, batch, dict(info.targets))
    for g, e in zip(got, expected):
        assert g.shape == e.shape
        assert rel(g, e) <= bound
    assert np.abs(expected[1]).max() > 0 and np.abs(expected[2]).max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forces_finite_with_padding(dtype):
    """Padded slots have distance ~0 and padded systems zero cells: no inf
    or NaN may reach the forces through the discarded branches."""
    hypers = {**ALL, "num_neighbors_adaptive": 6}
    model = _port_model(hypers, dtype=dtype)
    _, batch = _batches(_systems())
    batch = batch.replace(positions=batch.positions.float(), cells=batch.cells.float())
    _, info = _infos()
    energy, forces, virial = port_energy_forces_virial(model, batch, dict(info.targets))
    assert np.isfinite(energy).all() and np.isfinite(forces).all() and np.isfinite(virial).all()
    assert np.abs(forces).max() > 0
    # the conditioning acts: another charge and spin give another energy
    neutral = batch.replace(extra={})
    assert not np.allclose(port_energy_forces_virial(model, neutral, dict(info.targets))[0][:2],
                           energy[:2])


def test_calculator_serves_a_neutral_singlet():
    """The calculator ships no charge or spin (as the JAX calculator): its
    batch runs as charge 0, spin multiplicity 1. Its batch is its own (the
    Verlet list reaches cutoff + skin, and the direct sum every listed
    pair), so the comparisons run on it."""
    model = _port_model(ALL)
    system = make_molecule(n_atoms=8, seed=3)
    calc = Calculator(model, dtype=torch.float64)
    served = calc.compute(system, forces=True)
    batch = calc._last_batch
    assert not batch.extra
    _, info = _infos()
    S = batch.n_systems_padded
    results = [port_energy_forces_virial(model, batch.replace(extra={
        "charge": torch.full((S,), q, dtype=torch.float64),
        "spin_multiplicity": torch.full((S,), spin, dtype=torch.float64)}), dict(info.targets))
        for q, spin in ((0, 1), (1, 2))]
    assert served["energy"] == float(results[0][0][0, 0])
    np.testing.assert_array_equal(served["forces"], -results[0][1][: len(system), :, 0])
    assert abs(float(results[1][0][0, 0]) - served["energy"]) > 1e-6


# ---- training -----------------------------------------------------------------------

TRAIN_HYPERS = {**SMALL, **ALL}
LOSS = {"energy": {"type": "mse", "weight": 1.0, "gradients": {"positions": {"weight": 10.0}}}}


def _lennard_jones(system, epsilon=0.4093, sigma=2.338):
    c, n, s = neighbor_pairs(system.positions, system.cell, system.pbc, CUTOFF)
    r_vec = system.positions[n] - system.positions[c] + s @ system.cell
    r = np.linalg.norm(r_vec, axis=1)
    x6 = (sigma / r) ** 6
    de_dr = 4 * epsilon * (-12 * x6**2 + 6 * x6) / r
    forces = np.zeros_like(system.positions)
    np.add.at(forces, c, de_dr[:, None] * r_vec / r[:, None])
    np.add.at(forces, n, -de_dr[:, None] * r_vec / r[:, None])
    return float((4 * epsilon * (x6**2 - x6)).sum()), forces


@pytest.fixture(scope="module")
def charged_frames(tmp_path_factory):
    """Four Cu frames, LJ-labelled, each with its own charge and spin."""
    systems = []
    for i in range(4):
        s = make_crystal(n_cells=2, seed=20 + i, jitter=0.1)
        systems.append(System(s.positions, np.full(len(s), 29), s.cell, s.pbc))
    labels = [_lennard_jones(s) for s in systems]
    path = str(tmp_path_factory.mktemp("charged") / "cu.xyz")
    write_xyz(path, systems, per_atom_arrays=[{"forces": f} for _, f in labels],
              info=[{"energy": e, "charge": i - 1, "spin_multiplicity": i + 1}
                    for i, (e, _) in enumerate(labels)])
    return path


def _dataset_conf(path):
    return {"systems": {"read_from": path, "length_unit": "angstrom"},
            "targets": {"energy": {"key": "energy", "unit": "eV", "forces": "on"}}}


def test_train_step_matches_jax(charged_frames):
    t_data, t_infos = tdataset.get_dataset(tconfig.expand_dataset_config(
        _dataset_conf(charged_frames)))
    j_data, j_infos = jdataset.get_dataset(jconfig.expand_dataset_config(
        _dataset_conf(charged_frames)))
    t_info = tdataset.get_dataset_info([t_data], t_infos, "angstrom")
    j_info = jdataset.get_dataset_info([j_data], j_infos, "angstrom")
    port = PET(TRAIN_HYPERS, t_info, compute_dtype=torch.float64)
    port.init_weights(torch.Generator().manual_seed(3))
    _draw_gate(port)
    params = jax.tree.map(jnp.asarray, state_dict_to_flax(port.module))
    jax_model = JaxPET(TRAIN_HYPERS, j_info, compute_dtype=jnp.float64)
    keys = port.requested_extra_system_keys()
    assert tuple(keys) == tuple(jax_model.requested_extra_system_keys())

    samples = [1, 2]
    t_batch = tcollate.CollateFn(CUTOFF, t_infos, dtype=torch.float64, extra_system_keys=keys,
                                 transforms=[port.zbl.remove_transform])([t_data[i] for i in samples])
    j_batch = jcollate.CollateFn(CUTOFF, j_infos, dtype=jnp.float64, extra_system_keys=keys,
                                 transforms=[jax_model.zbl.remove_transform])(
        [j_data[i] for i in samples])
    np.testing.assert_allclose(t_batch.targets["energy"].block(0).values.numpy(),
                               np.asarray(j_batch.targets["energy"].block(0).values), rtol=1e-12)

    def j_loss(p):
        return jtrainer._compute_loss_and_errors(
            jax_model.forward, jloss.LossAggregator(j_infos, LOSS), j_infos, [],
            {"energy": (jnp.ones((1,)),)}, p, j_batch)

    (j_value, _), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    loss, _ = ttrainer._compute_loss_and_errors(
        port, tloss.LossAggregator(t_infos, LOSS), t_infos, [],
        {"energy": [torch.ones(1, dtype=torch.float64)]}, t_batch, is_training=True)
    loss.backward()
    assert abs(float(loss.detach()) - float(j_value)) <= 1e-10 * abs(float(j_value))
    grads = copy.deepcopy(port.module)
    with torch.no_grad():
        for p, q in zip(port.module.parameters(), grads.parameters()):
            q.copy_(p.grad)
    ours, theirs = _flat(state_dict_to_flax(grads)), _flat(j_grads)
    assert sorted(ours) == sorted(theirs)
    assert np.abs(theirs["/params/system_conditioning/gate/kernel"]).max() > 0
    assert np.abs(theirs["/params/long_range/charges_map/kernel"]).max() > 0
    for key in theirs:
        if np.abs(theirs[key]).max() == 0:
            assert np.abs(ours[key]).max() == 0, key
        else:
            assert rel(ours[key], theirs[key]) < 1e-10, key


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def test_trainer_and_eval_wire_the_options(charged_frames, tmp_path, monkeypatch):
    """``train_model`` builds its training and validation batches with the
    model's extra keys and removes ZBL after composition (as the JAX
    trainer), and ``eval`` ships the same keys; the run logs finite losses."""
    from metatrain_tpu_torch.cli import eval as teval

    built = []

    class Recording(tcollate.CollateFn):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(ttrainer, "CollateFn", Recording)
    monkeypatch.setattr(teval, "CollateFn", Recording)
    options = {"seed": 0, "base_precision": 64, "device": "cpu",
               "architecture": {"name": "pet", "model": dict(TRAIN_HYPERS), "training": {
                   "num_epochs": 1, "batch_size": 2, "data_parallel": False, "loss": LOSS}},
               "training_set": _dataset_conf(charged_frames), "validation_set": 0.25,
               "test_set": 0.0}
    model, _ = train_model(options, output_dir=str(tmp_path), checkpoint_dir=str(tmp_path))
    train_collate, val_collate = built[:2]
    for collate in (train_collate, val_collate):
        assert collate.extra_system_keys == ("charge", "spin_multiplicity")
        owners = [getattr(t, "__self__", None) for t in collate.transforms]
        assert owners.index(model.zbl) == owners.index(model.composition) + 1
    with open(tmp_path / "train.csv") as f:
        rows = list(csv.DictReader(f))
    assert rows and all(np.isfinite(float(r[k])) for r in rows for k in ("train loss", "val loss"))
    dataset, _ = tdataset.get_dataset(tconfig.expand_dataset_config(_dataset_conf(charged_frames)))
    teval.evaluate_datasets(model, dataset, model.dataset_info, batch_size=2)
    assert built[-1].extra_system_keys == ("charge", "spin_multiplicity")


# ---- checkpoints and envelopes -------------------------------------------------------


@pytest.fixture(scope="module")
def round_trip_reference():
    """A port model with every option and the JAX package's force call of
    the model it reads from the port's checkpoint, in float64."""
    port = _port_model({**ALL, "num_neighbors_adaptive": 6, "adaptive_cutoff_method": "probe"})
    port.composition.weights["energy"][:] = -1.5
    loaded = jio.model_from_checkpoint(port.get_checkpoint(), context="export")
    jax_model = JaxPET(loaded.hypers, loaded.dataset_info, compute_dtype=jnp.float64)
    jax_model.composition, jax_model.scaler = loaded.composition, loaded.scaler
    jax_model.params = loaded.params
    system = make_molecule(n_atoms=8, seed=6)
    jax_info, info = _infos()
    jax_batch, batch = neighbors_and_batches(system, CUTOFF)
    expected = jax_energy_forces_virial(jax_model, loaded.params, jax_batch, dict(jax_info.targets))
    for g, e in zip(port_energy_forces_virial(port, batch, dict(info.targets)), expected):
        assert rel(g, e) < 1e-10
    return port, jax_model, batch, expected


@pytest.mark.parametrize("form", ["checkpoint", "mtt"])
def test_round_trips_both_ways(form, round_trip_reference, tmp_path):
    """The port's checkpoint or envelope read by the JAX package (the
    options' hypers and every weight bit for bit), and the JAX package's
    read back by the port (the same force call)."""
    port, jax_model, batch, expected = round_trip_reference
    if form == "checkpoint":
        theirs = jio.model_from_checkpoint(port.get_checkpoint(), context="export")
        back = pet_from_checkpoint(jax_model.get_checkpoint(), compute_dtype=torch.float64,
                                   device="cpu")
    else:
        from metatrain_tpu.cli.export import export_model_object as jax_export

        export_model_object(port, None, str(tmp_path / "port.mtt"))
        theirs = jio.load_model(str(tmp_path / "port.mtt"))
        jax_export(jax_model, None, str(tmp_path / "jax.mtt"))
        back = tio.load_model(str(tmp_path / "jax.mtt"), device="cpu", compute_dtype=torch.float64)
    for key in ("zbl", "long_range", "num_neighbors_adaptive", "adaptive_cutoff_method",
                "system_conditioning", "max_charge", "max_spin_multiplicity"):
        assert theirs.hypers[key] == port.hypers[key], key
    ours = _flat(state_dict_to_flax(port.module))
    assert sorted(_flat(theirs.params)) == sorted(ours)
    for key, value in _flat(theirs.params).items():
        np.testing.assert_array_equal(value, ours[key])
    assert back.zbl is not None and back.module.long_range is not None
    _, info = _infos()
    for g, e in zip(port_energy_forces_virial(back, batch, dict(info.targets)), expected):
        assert rel(g, e) < 1e-10
