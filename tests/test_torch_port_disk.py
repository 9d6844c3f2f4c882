"""Port parity: the disk-backed datasets and prediction writers vs the JAX package.

On the CPU, the Lennard-Jones-labelled Cu frames of
``test_torch_port_train.py`` (32 atoms each), float64:

- ``SmartZip`` reads stored and deflated archives, and one of more than
  65,535 members (the zip64 end records), as ``zipfile`` and the JAX
  package's ``SmartZip`` do; it parses a zip64 extra field as JAX's does,
  refuses a corrupted member by its CRC-32, and pickles;
- a ``.zip`` written by either package's ``DiskDatasetWriter`` (and one of
  metatrain's ``.mta``/``.mts`` layout), and a memmap directory written by
  either package's ``write_memmap_dataset``, read in the port as samples
  whose arrays equal the JAX package's bit for bit, with the same
  ``infer_target_infos``; ``get_dataset`` opens them with the same
  TargetInfos and the same refusals of ``per_atom`` and non-scalar
  ``type`` targets;
- ``eval`` of a float64 model with ``-o`` ``.zip``, ``.mts`` and a
  trailing ``/``: the JAX package's readers read back the values of the
  port's ``.xyz`` predictions (energies bit for bit, forces to the text's
  1e-10);
- one ``train_model`` epoch from a ``.zip`` in each package from the same
  weights: the logged losses and metrics to 1e-10, the final weights to
  1e-9 (relative L2 per tensor), as ``test_torch_port_train.py``'s run.
"""

import csv
import pickle
import struct
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metatrain_tpu.containers as jc
import metatrain_tpu.data.dataset as jdataset
import metatrain_tpu.data.disk as jdisk
import metatrain_tpu.data.readers.mts as jmts
import metatrain_tpu.data.smart_zip as jzip
import metatrain_tpu_torch.containers as tc
import metatrain_tpu_torch.data.dataset as tdataset
import metatrain_tpu_torch.data.disk as tdisk
import metatrain_tpu_torch.data.readers.mts as tmts
import metatrain_tpu_torch.data.smart_zip as tzip
from metatrain_tpu.models.pet import PET as JaxPET
from metatrain_tpu_torch.cli.eval import eval_model
from metatrain_tpu_torch.cli.export import export_model_object
from metatrain_tpu_torch.cli.train import train_model
from metatrain_tpu_torch.data.readers.extxyz import read_xyz, write_xyz
from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info
from metatrain_tpu_torch.interop.jax_params import flax_to_state_dict, load_checkpoint_file
from metatrain_tpu_torch.models.pet import PET
from test_torch_port_mts import _layout_signature, assert_same_map
from test_torch_port_train import MODEL, TRAINING, _flat, _frames, _rel_l2, lennard_jones


# ---- SmartZip ----------------------------------------------------------------


def _make_zip(path, n=200, compression=zipfile.ZIP_STORED):
    rng = np.random.default_rng(0)
    payloads = {}
    with zipfile.ZipFile(path, "w", compression=compression) as z:
        for i in range(n):
            name = f"dir{i % 7}/member_{i}.bin"
            payloads[name] = rng.integers(0, 256, size=rng.integers(1, 400)).astype(
                np.uint8).tobytes()
            z.writestr(name, payloads[name])
    return payloads


@pytest.mark.parametrize("compression", [zipfile.ZIP_STORED, zipfile.ZIP_DEFLATED],
                         ids=["stored", "deflated"])
def test_smart_zip_reads_as_zipfile_and_jax(tmp_path, compression):
    path = str(tmp_path / "data.zip")
    payloads = _make_zip(path, compression=compression)
    ours, theirs = tzip.SmartZip(path), jzip.SmartZip(path)
    with zipfile.ZipFile(path) as z:
        assert ours.namelist() == theirs.namelist() == z.namelist()
        for i, name in enumerate(z.namelist()):
            assert ours.read(name) == ours.read(i) == theirs.read(name) == z.read(name)
    assert len(ours) == len(payloads)


def test_smart_zip_zip64(tmp_path):
    """More members than the 16-bit count holds: the zip64 end records."""
    path = str(tmp_path / "many.zip")
    n = 0x10000 + 3
    with zipfile.ZipFile(path, "w") as z:
        for i in range(n):
            z.writestr(f"{i}", struct.pack("<I", i))
    ours, theirs = tzip.SmartZip(path), jzip.SmartZip(path)
    assert len(ours) == len(theirs) == n
    assert ours.namelist() == theirs.namelist()
    for i in (0, 0xFFFF, n - 1):
        assert ours.read(str(i)) == theirs.read(str(i)) == struct.pack("<I", i)
    # a zip64 extra field: each 0xFFFFFFFF field read from it, in order
    extra = struct.pack("<HH", 0x5455, 1) + b"\0" + struct.pack("<HHQQQ", 1, 24, 7, 8, 9)
    args = (extra, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF)
    assert tzip._parse_zip64_extra(*args) == jzip._parse_zip64_extra(*args) == (8, 7, 9)
    args = (struct.pack("<HHQ", 1, 8, 11), 5, 6, 0xFFFFFFFF)
    assert tzip._parse_zip64_extra(*args) == jzip._parse_zip64_extra(*args) == (5, 6, 11)


def test_smart_zip_detects_corruption_and_pickles(tmp_path):
    path = tmp_path / "data.zip"
    payloads = _make_zip(path, n=20)
    sz = tzip.SmartZip(str(path))
    assert sz.read(0)  # opens this process's handle
    clone = pickle.loads(pickle.dumps(sz))
    name = sorted(payloads)[3]
    assert clone.read(name) == payloads[name]

    offset = int(sz._header_offsets[0]) + 30 + len(sz._name_at(0))
    raw = bytearray(path.read_bytes())
    raw[offset] ^= 0xFF
    path.write_bytes(bytes(raw))
    for module in (tzip, jzip):
        with pytest.raises(module.BadZip, match="CRC"):
            module.SmartZip(str(path)).read(0)
    with pytest.raises(tzip.BadZip, match="end-of-central-directory"):
        (tmp_path / "not.zip").write_bytes(b"not a zip" * 10)
        tzip.SmartZip(str(tmp_path / "not.zip"))


# ---- disk datasets -------------------------------------------------------------


@pytest.fixture(scope="module")
def labelled():
    """Frames with energy, forces and a strain gradient, as numpy."""
    frames = _frames()
    labels = [lennard_jones(s) for s in frames]
    rng = np.random.default_rng(4)
    strains = [rng.normal(size=(3, 3)) for _ in frames]
    return frames, [e for e, _ in labels], [f for _, f in labels], strains


def _write_zip(module, containers, path, labelled):
    frames, energies, forces, strains = labelled
    with module.DiskDatasetWriter(path) as writer:
        for s, e, f, st in zip(frames, energies, forces, strains):
            writer.write(containers.System(s.positions, s.types, s.cell, s.pbc), {
                "energy": {"values": np.asarray([e]), "positions_gradient": -f,
                           "strain_gradient": st},
                "dipole_norm": {"values": np.asarray([e * 0.5])}})


def _write_reference_layout(path, labelled):
    """A zip of metatrain's own layout: ``{i}/system.mta`` and
    ``{i}/{target}.mts``, written with the JAX package's containers."""
    frames, energies, forces, _ = labelled
    with zipfile.ZipFile(path, "w") as z:
        for i, (s, e, f) in enumerate(zip(frames, energies, forces)):
            z.writestr(f"{i}/system.mta", jmts.mta_bytes(jc.System(s.positions, s.types,
                                                                   s.cell, s.pbc)))
            props = jc.Labels(["energy"], np.zeros((1, 1), np.int32))
            block = jc.TensorBlock(np.asarray([[e]]), jc.Labels(["system"], np.array([[i]])), [],
                                   props)
            block.add_gradient("positions", jc.TensorBlock(
                -f.reshape(-1, 3, 1),
                jc.Labels(["sample", "system", "atom"], np.stack(
                    [np.zeros(len(s)), np.full(len(s), i), np.arange(len(s))], 1)),
                [jc.Labels(["xyz"], np.arange(3).reshape(-1, 1))], props))
            z.writestr(f"{i}/energy.mts", jmts.mts_bytes(jc.TensorMap(jc.Labels.single(),
                                                                      [block])))
            vec = jc.TensorBlock(np.arange(3.0 * len(s)).reshape(len(s), 3, 1) + i,
                                 jc.Labels(["system", "atom"], np.stack(
                                     [np.full(len(s), i), np.arange(len(s))], 1)),
                                 [jc.Labels(["xyz"], np.arange(3).reshape(-1, 1))],
                                 jc.Labels(["dipole"], np.zeros((1, 1))))
            z.writestr(f"{i}/mtt::local_dipole.mts",
                       jmts.mts_bytes(jc.TensorMap(jc.Labels.single(), [vec])))


def _assert_samples_equal(ours, theirs):
    assert len(ours) == len(theirs)
    assert np.array_equal(ours.atom_counts, theirs.atom_counts)
    for i in range(len(theirs)):
        a, b = ours[i], theirs[i]
        for field in ("positions", "types", "cell", "pbc"):
            x, y = getattr(a.system, field), getattr(b.system, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), field
        assert sorted(a.targets) == sorted(b.targets)
        for name in b.targets:
            assert_same_map(a.targets[name], b.targets[name])


def _info_signature(infos):
    return {name: _layout_signature(info) for name, info in infos.items()}


def _open(kind, path):
    """The dataset at ``path`` in the port and in the JAX package."""
    if kind == "memmap":
        return tdisk.MemmapDataset(path), jdisk.MemmapDataset(path)
    return tdisk.DiskDataset(path), jdisk.DiskDataset(path)


@pytest.mark.parametrize("writer", ["jax", "port", "reference"])
def test_zip_dataset_reads_as_jax(writer, labelled, tmp_path):
    path = str(tmp_path / "data.zip")
    if writer == "reference":
        _write_reference_layout(path, labelled)
    else:
        module, containers = (jdisk, jc) if writer == "jax" else (tdisk, tc)
        _write_zip(module, containers, path, labelled)
    ours, theirs = _open("zip", path)
    assert ours.target_names == theirs.target_names
    _assert_samples_equal(ours, theirs)
    assert _info_signature(ours.infer_target_infos()) == _info_signature(
        theirs.infer_target_infos())
    view = ours.select([4, 1])
    assert isinstance(view, tdataset.DatasetView) and len(view) == 2
    assert np.array_equal(view[0].system.positions, theirs[4].system.positions)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_memmap_dataset_reads_as_jax(writer, labelled, tmp_path):
    frames, energies, forces, _ = labelled
    path = str(tmp_path / "data.memmap")
    module, containers = (jdisk, jc) if writer == "jax" else (tdisk, tc)
    module.write_memmap_dataset(
        path, [containers.System(s.positions, s.types, s.cell, s.pbc) for s in frames],
        np.asarray(energies), forces)
    ours, theirs = _open("memmap", path)
    _assert_samples_equal(ours, theirs)
    assert _info_signature(ours.infer_target_infos()) == _info_signature(
        theirs.infer_target_infos())
    other = "jax" if writer == "port" else "port"
    copy = str(tmp_path / f"{other}.memmap")  # the other writer's files, byte for byte
    (jdisk if other == "jax" else tdisk).write_memmap_dataset(
        copy, [(jc if other == "jax" else tc).System(s.positions, s.types, s.cell, s.pbc)
               for s in frames], np.asarray(energies), forces)
    for name in ("ns.npy", "na.npy", "x.bin", "a.bin", "c.bin", "p.bin", "energy.bin",
                 "forces.bin"):
        assert (tmp_path / "data.memmap" / name).read_bytes() == (
            tmp_path / f"{other}.memmap" / name).read_bytes(), name


@pytest.mark.parametrize("targets", [
    {},
    {"energy": {"unit": "kcal/mol"}},
    {"energy": {"per_atom": True}},
    {"energy": {"type": {"cartesian": {"rank": 1}}}},
    {"missing": {}},
], ids=["inferred", "unit", "per-atom", "cartesian", "missing"])
@pytest.mark.parametrize("kind", ["zip", "memmap"])
def test_get_dataset_opens_disk_datasets_as_jax(kind, targets, labelled, tmp_path):
    frames, energies, forces, _ = labelled
    if kind == "zip":
        path = str(tmp_path / "data.zip")
        _write_zip(tdisk, tc, path, labelled)
    else:
        path = str(tmp_path / "data.memmap")
        tdisk.write_memmap_dataset(path, frames, np.asarray(energies), forces)
    config = {"systems": {"read_from": path}, "targets": targets}
    try:
        theirs = jdataset.get_dataset(config)
    except ValueError as err:
        with pytest.raises(ValueError) as ours:
            tdataset.get_dataset(config)
        assert str(ours.value) == str(err)
        return
    ours = tdataset.get_dataset(config)
    assert _info_signature(ours[1]) == _info_signature(theirs[1])
    assert ours[0].target_infos is ours[1]
    _assert_samples_equal(ours[0], theirs[0])


# ---- the writers -------------------------------------------------------------------


@pytest.fixture(scope="module")
def predictions(labelled, tmp_path_factory):
    """``eval`` of a float64 model with forces and virial, written to
    ``.xyz``, ``.zip``, ``.mts`` and a memmap directory."""
    root = tmp_path_factory.mktemp("preds")
    frames, energies, forces, _ = labelled
    data = str(root / "frames.xyz")
    write_xyz(data, frames, per_atom_arrays=[{"forces": f} for f in forces],
              info=[{"energy": e} for e in energies])
    info = DatasetInfo("angstrom", [29], {"energy": get_energy_target_info("eV", True, True)})
    model = PET(dict(MODEL, num_gnn_layers=1), info, compute_dtype=torch.float64)
    model.init_weights(torch.Generator().manual_seed(6))
    model.composition.weights["energy"][:] = -3.5
    path = str(root / "model.mtt")
    export_model_object(model, None, path)
    options = {"systems": {"read_from": data, "length_unit": "angstrom"},
               "targets": {"energy": {"key": "energy", "unit": "eV", "forces": "on"}}}
    for out in ("preds.xyz", "preds.zip", "preds.mts", "preds/"):
        eval_model(path, options, output_path=f"{root}/{out}", batch_size=4, device="cpu",
                   compute_dtype=torch.float64)
    return root


def _xyz_predictions(root):
    frames = read_xyz(str(root / "preds.xyz"))
    return ([float(f.extra["energy"]) for f in frames], [f.extra["energy_forces"] for f in frames],
            frames)


@pytest.mark.parametrize("suffix", ["zip", "mts", "memmap"])
def test_writers_read_back_in_jax(suffix, predictions):
    energies, forces, frames = _xyz_predictions(predictions)
    if suffix == "mts":
        tmap = jmts.load_mts(str(predictions / "preds_energy.mts"))
        block = tmap.block(0)
        got_e = list(np.asarray(block.values)[:, 0])
        grads = np.asarray(block.gradient("positions").values)[:, :, 0]
        offsets = np.cumsum([0] + [len(f) for f in frames])
        got_f = [-grads[a:b] for a, b in zip(offsets[:-1], offsets[1:])]
        assert np.asarray(block.samples.values)[:, 0].tolist() == list(range(len(frames)))
        assert block.gradients_list() == ["positions", "strain"]
        assert_same_map(tmts.load_mts(str(predictions / "preds_energy.mts")), tmap)
    else:
        dataset = (jdisk.DiskDataset(str(predictions / "preds.zip")) if suffix == "zip"
                   else jdisk.MemmapDataset(str(predictions / "preds")))
        assert len(dataset) == len(frames)
        got_e, got_f = [], []
        for i in range(len(dataset)):
            sample = dataset[i]
            assert np.abs(sample.system.positions - frames[i].positions).max() <= 5.1e-11
            block = sample.targets["energy"].block(0)
            got_e.append(float(np.asarray(block.values)[0, 0]))
            got_f.append(-np.asarray(block.gradient("positions").values)[:, :, 0])
            if suffix == "zip":
                assert block.gradients_list() == ["positions", "strain"]
    assert got_e == energies  # the xyz holds repr(float): bit for bit
    for g, f in zip(got_f, forces):
        assert g.shape == f.shape and np.abs(g - f).max() <= 5.1e-11  # "%.10f" columns


@pytest.mark.parametrize("preds", [
    {"energy": {"values": np.zeros(2)}},
    {"energy": {"values": np.zeros(1)}, "other": {"values": np.zeros(1)}},
], ids=["two-values", "two-targets"])
def test_memmap_writer_refuses_what_it_cannot_hold(preds, tmp_path, monkeypatch):
    """The memmap format holds one energy per structure: anything else is
    refused, not cut to its first value."""
    import metatrain_tpu_torch.data.writers as writers

    system = tc.System(np.zeros((2, 3)), np.ones(2), np.eye(3), np.ones(3, bool))
    monkeypatch.setattr(writers, "_split_batch_predictions",
                        lambda batch, predictions: ([system], [preds]))
    with pytest.raises(ValueError, match="one value per structure of one target"):
        writers.write_predictions(str(tmp_path / "out") + "/", [(None, {})], {})


# ---- training from a .zip -------------------------------------------------------


@pytest.fixture(scope="module")
def trained_from_zip(labelled, tmp_path_factory):
    """One ``train_model`` epoch from a ``.zip`` in each package, from the
    same float64 weights (the port takes the JAX initialization through
    ``interop.jax_params``)."""
    root = tmp_path_factory.mktemp("zip_train")
    frames, energies, forces, _ = labelled
    path = str(root / "frames.zip")
    with tdisk.DiskDatasetWriter(path) as writer:
        for s, e, f in zip(frames, energies, forces):
            writer.write(s, {"energy": {"values": np.asarray([e]), "positions_gradient": -f}})
    options = {
        "seed": 0, "base_precision": 64, "device": "cpu",
        "architecture": {"name": "pet", "model": dict(MODEL),
                         "training": dict(TRAINING, num_epochs=1)},
        "training_set": {"systems": {"read_from": path, "length_unit": "angstrom"},
                         "targets": {"energy": {"key": "energy", "unit": "eV", "forces": "on"}}},
        "validation_set": 0.25, "test_set": 0.0,
    }
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
        mp.setattr(jexport, "export_model_object", lambda *args, **kwargs: None)
        mp.setattr(jeval, "evaluate_datasets", lambda *args, **kwargs: {})
        jax_train_model(options, output_dir=str(root / "jax"), checkpoint_dir=str(root / "jax"))
        mp.setattr(PET, "init_weights", init_weights_from_jax)
        train_model(options, output_dir=str(root / "port"), checkpoint_dir=str(root / "port"))
    return root, captured["params"]


def test_train_from_zip_matches_jax(trained_from_zip):
    root, initial = trained_from_zip
    logs = []
    for side in ("jax", "port"):
        with open(root / side / "train.csv") as f:
            logs.append(list(csv.DictReader(f)))
    assert len(logs[0]) == len(logs[1]) == 1
    theirs, ours = logs[0][0], logs[1][0]
    assert sorted(theirs) == sorted(ours) and "train loss" in ours
    for key in theirs:
        if key != "epoch time (s)":
            t, o = float(theirs[key]), float(ours[key])
            assert abs(o - t) <= 1e-10 * max(abs(t), 1e-300), key
    jax_ckpt = load_checkpoint_file(root / "jax" / "model.ckpt")
    port_ckpt = load_checkpoint_file(root / "port" / "model.ckpt")
    ours, theirs = _flat(port_ckpt["params"]), _flat(jax_ckpt["params"])
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        assert _rel_l2(ours[key], theirs[key]) < 1e-9, key
    start = _flat(initial)
    moved = [np.concatenate([tree[key].ravel() for key in sorted(start)]) for tree in (ours, start)]
    assert _rel_l2(*moved) > 1e-4  # the weights moved
