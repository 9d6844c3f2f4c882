"""Port parity: PET training with forces vs the JAX package.

float64 on the CPU, on single-species Cu frames (32 atoms, FCC with
jitter) labelled with a Lennard-Jones energy and its analytic forces:

- the extended-xyz writer and reader agree with the JAX package's;
- options expand, and malformed options fail, as in the JAX package;
- the training batches (the split, the shuffles and the O3 rotations) are
  the JAX package's for the same seed;
- ``evaluate_model(is_training=True)`` on a batch with padded atoms and
  systems: energy, forces, virial and the weight gradient of a function of
  all three, to 1e-10;
- one training step's loss and parameter gradients equal JAX's
  ``_compute_loss_and_errors`` under ``jax.value_and_grad`` (the body of
  ``_make_train_step``) to 1e-10;
- a whole ``train_model`` run (tiny PET, 2 epochs, batch 2) logs the same
  losses and metrics to 1e-10 and ends at the same parameters to 1e-9;
- the port's checkpoint loads in the JAX package and gives the port's
  energy, forces and virial to 1e-10.

The JAX ``train_model`` builds PET with a float32 network and flax keeps
``Dense`` weights in float32; for a float64 comparison the JAX side runs
its network in float64 and its parameters are cast to float64 when they
are initialized. Both packages then start from the same weights: the port
loads the JAX initialization through the converter. Single-species data
also keeps clear of the JAX package's metric unscaling by row 0 of the
per-type scales (ROADMAP, faults in the reference).
"""

import copy
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
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
from metatrain_tpu.data.readers.extxyz import read_xyz as jax_read_xyz
from metatrain_tpu.data.target_info import DatasetInfo as JaxDatasetInfo
from metatrain_tpu.data.target_info import get_energy_target_info as jax_energy_info
from metatrain_tpu.data.readers.extxyz import write_xyz as jax_write_xyz
from metatrain_tpu.data.samplers import PrefetchingLoader as JaxPrefetchingLoader
from metatrain_tpu.engine import loss as jloss
from metatrain_tpu.engine.evaluate import evaluate_model as jax_evaluate_model
from metatrain_tpu.engine import trainer as jtrainer
from metatrain_tpu.engine.augmentation import O3Augmenter as JaxO3Augmenter
from metatrain_tpu.models.pet import PET as JaxPET
from metatrain_tpu.utils import config as jconfig
from metatrain_tpu.utils.io import model_from_checkpoint
from metatrain_tpu_torch.cli.train import train_model
from metatrain_tpu_torch.containers import System, batch_from_systems
from metatrain_tpu_torch.data import collate as tcollate
from metatrain_tpu_torch.data import dataset as tdataset
from metatrain_tpu_torch.data.readers.extxyz import read_xyz, write_xyz
from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info
from metatrain_tpu_torch.data.samplers import PrefetchingLoader
from metatrain_tpu_torch.engine import loss as tloss
from metatrain_tpu_torch.engine import trainer as ttrainer
from metatrain_tpu_torch.engine.augmentation import O3Augmenter
from metatrain_tpu_torch.engine.evaluate import evaluate_model
from metatrain_tpu_torch.interop.jax_params import (
    flax_to_state_dict,
    load_checkpoint_file,
    pet_from_checkpoint,
    state_dict_to_flax,
)
from metatrain_tpu_torch.models.pet import PET
from metatrain_tpu_torch.ops.neighbors import compute_neighbor_data, neighbor_pairs
from metatrain_tpu_torch.utils import config as tconfig

CUTOFF = 4.5
MODEL = {"d_pet": 16, "d_node": 16, "d_head": 16, "d_feedforward": 16, "num_heads": 2,
         "num_gnn_layers": 2, "num_attention_layers": 1, "cutoff": CUTOFF}
LOSS = {"energy": {"type": "mse", "weight": 1.0, "gradients": {"positions": {"weight": 10.0}}}}
TRAINING = {"num_epochs": 2, "batch_size": 2, "learning_rate": 1e-2, "data_parallel": False,
            "loss": LOSS}


def lennard_jones(system, epsilon=0.4093, sigma=2.338, cutoff=CUTOFF):
    """Cu Lennard-Jones energy and analytic forces over each pair once."""
    c, n, s = neighbor_pairs(system.positions, system.cell, system.pbc, cutoff)
    r_vec = system.positions[n] - system.positions[c] + s @ system.cell
    r = np.linalg.norm(r_vec, axis=1)
    x6 = (sigma / r) ** 6
    de_dr = 4 * epsilon * (-12 * x6**2 + 6 * x6) / r
    forces = np.zeros_like(system.positions)
    np.add.at(forces, c, de_dr[:, None] * r_vec / r[:, None])
    np.add.at(forces, n, -de_dr[:, None] * r_vec / r[:, None])
    return float((4 * epsilon * (x6**2 - x6)).sum()), forces


def _frames(n=6):
    systems = []
    for i in range(n):
        s = make_crystal(n_cells=2, seed=i, jitter=0.1)
        systems.append(System(s.positions, np.full(len(s.types), 29), s.cell, s.pbc))
    return systems


@pytest.fixture(scope="module")
def dataset_file(tmp_path_factory):
    systems = _frames()
    labels = [lennard_jones(s) for s in systems]
    path = str(tmp_path_factory.mktemp("data") / "cu.xyz")
    write_xyz(path, systems, per_atom_arrays=[{"forces": f} for _, f in labels],
              info=[{"energy": e} for e, _ in labels])
    return path


def _options(path, **training):
    return {
        "seed": 0, "base_precision": 64, "device": "cpu",
        "architecture": {"name": "pet", "model": dict(MODEL), "training": {**TRAINING, **training}},
        "training_set": {"systems": {"read_from": path, "length_unit": "angstrom"},
                         "targets": {"energy": {"key": "energy", "unit": "eV", "forces": "on"}}},
        "validation_set": 0.25, "test_set": 0.0,
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def _rel_l2(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def test_xyz_round_trip_matches_jax(dataset_file, tmp_path):
    systems = _frames()
    ours, theirs = read_xyz(dataset_file), jax_read_xyz(dataset_file)
    assert len(ours) == len(theirs) == len(systems)
    for s, o, t in zip(systems, ours, theirs):
        np.testing.assert_allclose(o.positions, s.positions, rtol=0, atol=1e-10)
        for field in ("positions", "types", "cell", "pbc"):
            np.testing.assert_array_equal(getattr(o, field), getattr(t, field))
        assert sorted(o.extra) == sorted(t.extra) == ["energy", "forces"]
        for key in o.extra:
            np.testing.assert_array_equal(o.extra[key], t.extra[key])
    # the writers agree byte for byte
    path = str(tmp_path / "jax.xyz")
    jax_write_xyz(path, theirs, per_atom_arrays=[{"forces": t.extra["forces"]} for t in theirs],
                  info=[{"energy": t.extra["energy"]} for t in theirs])
    with open(path) as f, open(dataset_file) as g:
        assert f.read() == g.read()


_PET = {"name": "pet"}


@pytest.mark.parametrize("options", [
    {"architecture": {"name": "pet", "training": {"batch_size": 2}}, "training_set": "data.xyz",
     "validation_set": 0.2},
    {"architecture": _PET, "training_set": {
        "systems": "data.xyz", "targets": {"energy": {"forces": "on", "stress": False}}}},
], ids=["shorthand", "forces-on"])
def test_options_expand_as_jax(options):
    ours, theirs = tconfig.validate_base_options(options), jconfig.validate_base_options(options)
    assert ours == theirs
    hypers = {"model": {"d_pet": 8}, "training": {"batch_size": 2}}
    assert (tconfig.merge_architecture_hypers("pet", hypers)
            == jconfig.merge_architecture_hypers("pet", hypers))


@pytest.mark.parametrize("options", [
    {"architecture": _PET, "training_set": "x", "base_precision": 8},
    {"architecture": _PET, "training_set": "x", "validation_set": 1.5},
    {"architecture": _PET, "training_set": "x", "bogus": 1},
    {"architecture": _PET},
    {"architecture": {"name": "nope"}, "training_set": "x"},
], ids=["precision", "fraction", "extra-key", "no-training-set", "unknown-architecture"])
def test_invalid_options_raise_as_jax(options):
    with pytest.raises(jconfig.MetatrainConfigError) as theirs:
        jconfig.validate_base_options(options)
    with pytest.raises(tconfig.MetatrainConfigError) as ours:
        tconfig.validate_base_options(options)
    if options["architecture"] is _PET:  # the port knows fewer architectures
        assert str(ours.value) == str(theirs.value)


def test_unknown_hyperparameter_raises_as_jax():
    hypers = {"model": {"d_pett": 8}}
    with pytest.raises(jconfig.MetatrainConfigError) as theirs:
        jconfig.merge_architecture_hypers("pet", hypers)
    with pytest.raises(tconfig.MetatrainConfigError) as ours:
        tconfig.merge_architecture_hypers("pet", hypers)
    assert str(ours.value) == str(theirs.value)


def _train_loaders(path):
    """The training loader of each package over the same split, with the
    O3 augmentation, as the trainers build them."""
    hp = {"max_atoms_per_batch": None, "batch_size": 2, "seed": 0}
    loaders = []
    for cfg, ds, col, tr, aug, pref, kw in (
        (tconfig, tdataset, tcollate, ttrainer, O3Augmenter, PrefetchingLoader,
         {"dtype": torch.float64}),
        (jconfig, jdataset, jcollate, jtrainer, JaxO3Augmenter, JaxPrefetchingLoader,
         {"dtype": jnp.float64}),
    ):
        conf = cfg.expand_dataset_config(_options(path)["training_set"])
        dataset, infos = ds.get_dataset(conf)
        train, _, _ = ds.train_val_test_split(dataset, val_fraction=0.25, test_fraction=0.0, seed=0)
        collate = col.CollateFn(CUTOFF, infos, transforms=[aug(seed=0)], **kw)
        loaders.append(pref(tr._build_loader([train], collate, hp, shuffle=True)))
    return loaders


def test_batches_and_rotations_match_jax(dataset_file):
    ours, theirs = _train_loaders(dataset_file)
    assert len(ours) == len(theirs) == 2
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        n = 0
        for o, t in zip(ours, theirs):
            n += 1
            for field in ("positions", "cells", "types", "atom_mask", "nbr_indices", "nbr_mask"):
                np.testing.assert_array_equal(getattr(o.systems, field).numpy(),
                                              np.asarray(getattr(t.systems, field)))
            ob, tb = o.targets["energy"].block(0), t.targets["energy"].block(0)
            np.testing.assert_array_equal(ob.values.numpy(), np.asarray(tb.values))
            np.testing.assert_array_equal(ob.gradient("positions").values.numpy(),
                                          np.asarray(tb.gradient("positions").values))
        assert n == 2


def test_train_step_loss_and_gradients_match_jax(dataset_file):
    t_conf = tconfig.expand_dataset_config(_options(dataset_file)["training_set"])
    j_conf = jconfig.expand_dataset_config(_options(dataset_file)["training_set"])
    t_data, t_infos = tdataset.get_dataset(t_conf)
    j_data, j_infos = jdataset.get_dataset(j_conf)
    t_info = tdataset.get_dataset_info([t_data], t_infos, "angstrom")
    j_info = jdataset.get_dataset_info([j_data], j_infos, "angstrom")

    jax_model = JaxPET(MODEL, j_info, compute_dtype=jnp.float64)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                          jax_model.init_params(jax.random.PRNGKey(3)))
    port = PET(MODEL, t_info, compute_dtype=torch.float64)
    port.module.load_state_dict(flax_to_state_dict(jax.device_get(params)))

    samples = [0, 3]
    t_batch = tcollate.CollateFn(CUTOFF, t_infos, dtype=torch.float64)(
        [t_data[i] for i in samples])
    j_batch = jcollate.CollateFn(CUTOFF, j_infos, dtype=jnp.float64)([j_data[i] for i in samples])
    scales = {"energy": (jnp.ones((1,)),)}

    def j_loss(p):
        return jtrainer._compute_loss_and_errors(
            jax_model.forward, jloss.LossAggregator(j_infos, LOSS), j_infos, [], scales, p, j_batch)

    (j_value, j_errors), j_grads = jax.value_and_grad(j_loss, has_aux=True)(params)

    loss, errors = ttrainer._compute_loss_and_errors(
        port, tloss.LossAggregator(t_infos, LOSS), t_infos, [],
        {"energy": [torch.ones(1, dtype=torch.float64)]}, t_batch, is_training=True)
    loss.backward()
    assert abs(float(loss.detach()) - float(j_value)) <= 1e-10 * abs(float(j_value))
    assert sorted(errors) == sorted(j_errors)
    for key, sums in j_errors.items():
        for ours, theirs in zip(errors[key], sums):  # (sum_sq, sum_abs, count)
            assert rel(ours.numpy(), theirs) < 1e-10, key

    grad_module = copy.deepcopy(port.module)
    with torch.no_grad():
        for p, q in zip(port.module.parameters(), grad_module.parameters()):
            q.copy_(p.grad)
    ours, theirs = _flat(state_dict_to_flax(grad_module)), _flat(j_grads)
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        if np.abs(theirs[key]).max() == 0:
            assert np.abs(ours[key]).max() == 0, key
        else:
            assert rel(ours[key], theirs[key]) < 1e-10, key


def test_evaluate_training_matches_jax():
    """``evaluate_model(is_training=True)`` on a batch with padded atoms and
    systems: the predictions and the gradient, with respect to the weights,
    of a masked function of energy, forces and virial."""
    systems = [make_crystal(n_cells=2, seed=5, jitter=0.1), make_molecule(n_atoms=8, types=(29,))]
    systems[0].types[:] = 29
    jax_info = JaxDatasetInfo("angstrom", [29], {"energy": jax_energy_info("eV", True, True)})
    info = DatasetInfo("angstrom", [29], {"energy": get_energy_target_info("eV", True, True)})
    port = PET(MODEL, info, compute_dtype=torch.float64)
    port.init_weights(torch.Generator().manual_seed(4))
    params = jax.tree.map(jnp.asarray, state_dict_to_flax(port.module))
    jax_model = JaxPET(MODEL, jax_info, compute_dtype=jnp.float64)

    port_systems = [System(s.positions, s.types, s.cell, s.pbc) for s in systems]
    nbrs = [compute_neighbor_data(s, CUTOFF) for s in port_systems]
    j_batch = jax_batch_from_systems(
        systems, [JaxNeighborData(n.indices, n.shifts, n.mask, n.reverse) for n in nbrs],
        dtype=jnp.float64)
    batch = batch_from_systems(port_systems, nbrs, torch.device("cpu"), dtype=torch.float64)
    assert batch.n_atoms_padded > 40 and batch.n_systems_padded > 2  # padded atoms and systems

    def objective(block, where, xp):
        """Energy, forces and virial at their real rows, and a scalar of all three."""
        parts = (block.values, block.gradient("positions").values, block.gradient("strain").values)
        masks = (block.mask, block.gradient("positions").mask, block.gradient("strain").mask)
        real = [where(m.reshape(m.shape + (1,) * (v.ndim - 1)), v, 0.0)
                for v, m in zip(parts, masks)]
        return real, sum(w * xp.sum(v * v) for w, v in zip((1.0, 10.0, 0.1), real))

    def j_objective(p):
        block = jax_evaluate_model(jax_model.forward, p, j_batch, dict(jax_info.targets),
                                   is_training=True)["energy"].block(0)
        real, value = objective(block, jnp.where, jnp)
        return value, real

    (j_value, j_real), j_grads = jax.value_and_grad(j_objective, has_aux=True)(params)
    block = evaluate_model(port.forward, batch, dict(info.targets),
                           is_training=True)["energy"].block(0)
    real, value = objective(block, torch.where, torch)
    value.backward()
    for ours, theirs in zip(real, j_real):
        assert rel(ours.detach().numpy(), theirs) < 1e-10
    assert abs(value.item() - float(j_value)) <= 1e-10 * abs(float(j_value))
    grad_module = copy.deepcopy(port.module)
    with torch.no_grad():
        for p, q in zip(port.module.parameters(), grad_module.parameters()):
            q.copy_(p.grad)
    ours, theirs = _flat(state_dict_to_flax(grad_module)), _flat(j_grads)
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        if np.abs(theirs[key]).max() == 0:
            assert np.abs(ours[key]).max() == 0, key
        else:
            assert rel(ours[key], theirs[key]) < 1e-10, key


@pytest.fixture(scope="module")
def trained(dataset_file, tmp_path_factory):
    """One ``train_model`` run in each package from the same weights."""
    root = tmp_path_factory.mktemp("train")
    captured = {}
    init_params = JaxPET.init_params

    def init_params_f64(self, key):
        init_params(self, key)
        self.params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), self.params)
        captured["params"] = jax.device_get(self.params)
        return self.params

    def init_weights_from_jax(self, generator):
        self.module.load_state_dict(flax_to_state_dict(captured["params"]))
        self.weights_initialized = True

    with pytest.MonkeyPatch.context() as mp:
        import metatrain_tpu.cli.eval as jeval
        import metatrain_tpu.cli.export as jexport
        from metatrain_tpu.cli.train import train_model as jax_train_model

        mp.setattr(JaxPET.__init__, "__defaults__", (jnp.float64,))
        mp.setattr(JaxPET, "init_params", init_params_f64)
        # export and the final evaluation are not part of the port's slice
        mp.setattr(jexport, "export_model_object", lambda *args, **kwargs: None)
        mp.setattr(jeval, "evaluate_datasets", lambda *args, **kwargs: {})
        jax_train_model(_options(dataset_file), output_dir=str(root / "jax"),
                        checkpoint_dir=str(root / "jax"))
        mp.setattr(PET, "init_weights", init_weights_from_jax)
        model, _ = train_model(_options(dataset_file), output_dir=str(root / "port"),
                               checkpoint_dir=str(root / "port"))
    return root, model, captured["params"]


def test_train_model_matches_jax(trained):
    root, _, initial = trained
    logs = []
    for side in ("jax", "port"):
        with open(root / side / "train.csv") as f:
            logs.append(list(csv.DictReader(f)))
    assert len(logs[0]) == len(logs[1]) == TRAINING["num_epochs"]
    for theirs, ours in zip(*logs):
        assert sorted(theirs) == sorted(ours)
        for key in theirs:
            if key == "epoch time (s)":
                continue
            t, o = float(theirs[key]), float(ours[key])
            assert abs(o - t) <= 1e-10 * max(abs(t), 1e-300), key
    assert float(logs[0][1]["learning_rate"]) > 0

    jax_ckpt = load_checkpoint_file(root / "jax" / "model.ckpt")
    port_ckpt = load_checkpoint_file(root / "port" / "model.ckpt")
    assert port_ckpt["epoch"] == jax_ckpt["epoch"] == TRAINING["num_epochs"]
    assert port_ckpt["best_epoch"] == jax_ckpt["best_epoch"]
    for part in ("params", "best_params"):
        ours, theirs = _flat(port_ckpt[part]), _flat(jax_ckpt[part])
        assert sorted(ours) == sorted(theirs)
        for key in theirs:
            assert _rel_l2(ours[key], theirs[key]) < 1e-9, (part, key)
    start = _flat(initial)
    moved = [np.concatenate([tree[key].ravel() for key in sorted(start)]) for tree in (ours, start)]
    assert _rel_l2(*moved) > 1e-3  # the weights moved
    np.testing.assert_allclose(port_ckpt["composition"]["weights"]["energy"],
                               jax_ckpt["composition"]["weights"]["energy"], rtol=1e-12)
    for key in ("scales", "per_target"):
        np.testing.assert_allclose(np.asarray(port_ckpt["scaler"][key]["energy"]),
                                   np.asarray(jax_ckpt["scaler"][key]["energy"]), rtol=1e-12)


def test_port_checkpoint_evaluates_in_jax(trained):
    root, model, _ = trained
    checkpoint = load_checkpoint_file(root / "port" / "model.ckpt")
    loaded = model_from_checkpoint(copy.deepcopy(checkpoint), context="export")
    jax_model = JaxPET(loaded.hypers, loaded.dataset_info, compute_dtype=jnp.float64)
    jax_model.composition, jax_model.scaler = loaded.composition, loaded.scaler
    port = pet_from_checkpoint(checkpoint, compute_dtype=torch.float64, device="cpu")

    system = make_crystal(n_cells=2, seed=11, jitter=0.1)
    system.types[:] = 29
    jax_batch, batch = neighbors_and_batches(system, port.cutoff)
    # energy with forces and virial, whatever the training targets were
    infos = {"energy": get_energy_target_info("eV", True, True)}
    expected = jax_energy_forces_virial(jax_model, loaded.params, jax_batch,
                                        {"energy": jax_energy_info("eV", True, True)})
    got = port_energy_forces_virial(port, batch, infos)
    trained_model = port_energy_forces_virial(model, batch, infos)
    for g, t, e in zip(got, trained_model, expected):
        assert rel(g, e) < 1e-10
        np.testing.assert_array_equal(g, t)
    assert np.abs(expected[1]).max() > 0 and np.abs(expected[2]).max() > 0
