"""Port parity: the command line (``train``/``eval``/``export``) vs the JAX package.

On the CPU, tiny PET, the 6 Lennard-Jones-labelled Cu frames of
``test_torch_port_train.py``, options written as JSON:

- ``main(["train", ...])`` of each package, in float64 from the same
  initial weights (the port's, handed to the JAX model as
  ``test_torch_port_train.py`` hands JAX's to the port): ``model.ckpt``'s
  parameters and best parameters to 1e-9 relative L2 per tensor, and a
  ``model.mtt`` with the JAX package's envelope keys;
- ``--restart auto`` with ``-r architecture.training.num_epochs=2`` after
  that one-epoch run, and a run finetuned from it (``finetune.read_from``),
  in both packages: final parameters to 1e-9;
- ``export`` of a JAX checkpoint: the port's envelope has JAX's
  parameters bit for bit; each package loads the other's ``.mtt`` and
  the two give the same energy, forces and virial to 1e-10 in float64;
  ``load_model`` from a ``file://`` URL and the ``hf://`` URL builder;
- ``eval`` of a float32 ``.mtt`` in both packages: the metrics, and the
  energies and forces written to ``.xyz`` and ``.npz``, to 1e-5 relative
  (of the largest value);
- ``load_options`` of a JSON file with PyYAML blocked equals PyYAML's
  reading; the restart left unported raises and says why;
- ``eval`` with ``-o`` ``.zip``, ``.mts`` and a trailing ``/``: the port's
  predictions and the JAX package's, both read with the JAX package's
  readers, agree to 1e-5 relative as the ``.xyz`` ones do.
"""

import copy
import glob
import json
import os
import sys
from pathlib import Path

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
from conftest import make_crystal
from metatrain_tpu.data.target_info import get_energy_target_info as jax_energy_info
from metatrain_tpu.models.pet import PET as JaxPET
from metatrain_tpu.utils import config as jconfig
from metatrain_tpu.utils import io as jio
from metatrain_tpu_torch.cli.eval import eval_model
from metatrain_tpu_torch.cli.export import export_model_object
from metatrain_tpu_torch.containers import System
from metatrain_tpu_torch.data.readers.extxyz import read_xyz, write_xyz
from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info
from metatrain_tpu_torch.interop.jax_params import state_dict_to_flax
from metatrain_tpu_torch.models.pet import PET
from metatrain_tpu_torch.utils import config as tconfig
from metatrain_tpu_torch.utils import io as tio
from test_torch_port_train import LOSS, MODEL, lennard_jones

import metatrain_tpu.__main__ as jmain
import metatrain_tpu_torch.__main__ as tmain

# one GNN layer: each JAX training run is mostly its compile
CLI_MODEL = dict(MODEL, num_gnn_layers=1)
PARAM_TOL = 1e-9  # test_torch_port_train.py's, float64 training runs
EVAL_TOL = 1e-5  # float32 networks in both packages


def _frames(n=6):
    systems = []
    for i in range(n):
        s = make_crystal(n_cells=2, seed=i, jitter=0.1)
        systems.append(System(s.positions, np.full(len(s.types), 29), s.cell, s.pbc))
    return systems


def _dataset(path):
    return {"systems": {"read_from": str(path), "length_unit": "angstrom"},
            "targets": {"energy": {"key": "energy", "unit": "eV", "forces": "on"}}}


def _options(path, **training):
    return {
        "seed": 0, "base_precision": 64, "device": "cpu",
        "architecture": {"name": "pet", "model": dict(CLI_MODEL), "training": {
            "num_epochs": 1, "batch_size": 2, "learning_rate": 1e-2, "data_parallel": False,
            "loss": LOSS, **training}},
        "training_set": _dataset(path), "validation_set": 0.25, "test_set": 0.0,
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_params_close(ours, theirs, tol=PARAM_TOL):
    ours, theirs = _flat(ours), _flat(theirs)
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        a, b = ours[key].astype(np.float64), theirs[key].astype(np.float64)
        assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b), key


@pytest.fixture(scope="module")
def data_file(tmp_path_factory):
    systems = _frames()
    labels = [lennard_jones(s) for s in systems]
    path = tmp_path_factory.mktemp("data") / "cu.xyz"
    write_xyz(str(path), systems, per_atom_arrays=[{"forces": f} for _, f in labels],
              info=[{"energy": e} for e, _ in labels])
    return path


@pytest.fixture(scope="module")
def runs(data_file, tmp_path_factory):
    """In each package: ``train`` (1 epoch), ``train --restart auto`` (to 2
    epochs) and ``train`` finetuned from the first run's checkpoint, each
    through its ``main``; the checkpoints of the three runs."""
    root = tmp_path_factory.mktemp("cli")

    def init_params_from_port(self, key):
        """The JAX model starts from the port's float64 initialization for
        the run's seed (0), which the port's run draws too."""
        port = PET(self.hypers, DatasetInfo.from_dict(self.dataset_info.to_dict()),
                   compute_dtype=torch.float64)
        port.init_weights(torch.Generator().manual_seed(0))
        self.params = jax.tree.map(jnp.asarray, state_dict_to_flax(port.module))
        return self.params

    out = {}
    cwd = os.getcwd()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPET.__init__, "__defaults__", (jnp.float64,))
        mp.setattr(JaxPET, "init_params", init_params_from_port)
        for side, main in (("jax", jmain.main), ("port", tmain.main)):
            work = root / side
            work.mkdir()
            os.chdir(work)
            try:
                Path("options.json").write_text(json.dumps(_options(data_file)))
                assert main(["train", "options.json"]) == 0
                first = work / "first.ckpt"
                first.write_bytes(Path(glob.glob("outputs/*/*/model.ckpt")[0]).read_bytes())
                (work / "first.mtt").write_bytes((work / "model.mtt").read_bytes())
                assert main(["train", "options.json", "--restart", "auto",
                             "-r", "architecture.training.num_epochs=2"]) == 0
                restarted = max(glob.glob("outputs/*/*/model.ckpt"), key=os.path.getmtime)
                (work / "restarted.ckpt").write_bytes(Path(restarted).read_bytes())
                Path("finetune.json").write_text(json.dumps(_options(
                    data_file, finetune={"read_from": str(first), "method": "full"})))
                assert main(["train", "finetune.json", "-o", "finetuned.mtt"]) == 0
                finetuned = max(glob.glob("outputs/*/*/model.ckpt"), key=os.path.getmtime)
                (work / "finetuned.ckpt").write_bytes(Path(finetuned).read_bytes())
            finally:
                os.chdir(cwd)
            out[side] = work
    return out


def test_train_matches_jax(runs):
    theirs = jio.load_checkpoint_file(runs["jax"] / "first.ckpt")
    ours = tio.load_checkpoint_file(runs["port"] / "first.ckpt")
    assert ours["epoch"] == theirs["epoch"] == 1
    for part in ("params", "best_params"):
        _assert_params_close(ours[part], theirs[part])
    # the final evaluation ran and logged finite metrics
    log = next((runs["port"] / "outputs").glob("*/*/train.log")).read_text()
    assert "validation energy RMSE (per atom)" in log and "train forces MAE" in log


def test_mtt_has_the_jax_envelope(runs):
    theirs = jio.load_checkpoint_file(runs["jax"] / "first.mtt")
    ours = tio.load_checkpoint_file(runs["port"] / "first.mtt")
    assert sorted(ours) == sorted(theirs)
    assert ours["exported"] is True and ours["format_version"] == theirs["format_version"] == 1
    assert ours["compiled_force_call"] == theirs["compiled_force_call"] == {}
    assert ours["metadata"] == theirs["metadata"]
    assert ours["capabilities"] == theirs["capabilities"]
    assert sorted(ours["checkpoint"]) == sorted(theirs["checkpoint"])
    # the exported weights are the best ones
    best = tio.load_checkpoint_file(runs["port"] / "first.ckpt")["best_params"]
    _assert_params_close(ours["checkpoint"]["params"], best, tol=0.0)
    _assert_params_close(ours["checkpoint"]["params"], theirs["checkpoint"]["params"])


@pytest.mark.parametrize("run", ["restarted", "finetuned"])
def test_restart_and_finetune_match_jax(runs, run):
    theirs = jio.load_checkpoint_file(runs["jax"] / f"{run}.ckpt")
    ours = tio.load_checkpoint_file(runs["port"] / f"{run}.ckpt")
    assert ours["epoch"] == theirs["epoch"] == (2 if run == "restarted" else 1)
    _assert_params_close(ours["params"], theirs["params"])
    first = tio.load_checkpoint_file(runs["port"] / "first.ckpt")
    moved = [np.concatenate([v.ravel() for _, v in sorted(_flat(c["params"]).items())])
             for c in (ours, first)]
    assert np.linalg.norm(moved[0] - moved[1]) > 1e-6 * np.linalg.norm(moved[1])


def test_restart_from_optax_state_raises(runs, data_file):
    from metatrain_tpu_torch.cli.train import train_model

    with pytest.raises(ValueError, match="optax"):
        train_model(_options(data_file), checkpoint_dir=str(runs["port"] / "optax"),
                    restart_from=str(runs["jax"] / "first.ckpt"))


def test_export_matches_jax_and_loads_across(runs, tmp_path):
    ckpt = str(runs["jax"] / "first.ckpt")
    assert jmain.main(["export", ckpt, "-o", str(tmp_path / "jax.mtt")]) == 0
    assert tmain.main(["export", ckpt, "-o", str(tmp_path / "port.mtt")]) == 0
    theirs = jio.load_checkpoint_file(tmp_path / "jax.mtt")
    ours = tio.load_checkpoint_file(tmp_path / "port.mtt")
    assert sorted(ours) == sorted(theirs)
    for key, value in _flat(theirs["checkpoint"]["params"]).items():
        mine = _flat(ours["checkpoint"]["params"])[key]
        assert mine.dtype == value.dtype and np.array_equal(mine, value), key

    # each package loads the other's envelope; same function in float64
    port = tio.load_model(f"file://{tmp_path / 'jax.mtt'}", device="cpu",
                          compute_dtype=torch.float64)
    loaded = jio.load_model(str(tmp_path / "port.mtt"))
    jax_model = JaxPET(loaded.hypers, loaded.dataset_info, compute_dtype=jnp.float64)
    jax_model.composition, jax_model.scaler = loaded.composition, loaded.scaler
    _assert_params_close(state_dict_to_flax(port.module), loaded.params, tol=0.0)
    system = make_crystal(n_cells=2, seed=11, jitter=0.1)
    system.types[:] = 29
    jax_batch, batch = neighbors_and_batches(system, port.cutoff)
    expected = jax_energy_forces_virial(jax_model, loaded.params, jax_batch,
                                        {"energy": jax_energy_info("eV", True, True)})
    got = port_energy_forces_virial(port, batch,
                                    {"energy": get_energy_target_info("eV", True, True)})
    for g, e in zip(got, expected):
        assert rel(g, e) < 1e-10


def test_resolve_hf_reference_builds_url(monkeypatch, tmp_path):
    captured = {}

    class FakeResponse:
        def read(self):
            return b"payload"

        def __enter__(self):
            return self

        def __exit__(self, *args):
            return False

    def fake_urlopen(request):
        captured["url"] = request.full_url
        captured["auth"] = request.get_header("Authorization")
        return FakeResponse()

    import urllib.request

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    monkeypatch.setenv("MTT_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("HF_TOKEN", "tok123")
    local = tio.resolve_model_path("hf://some-org/some-repo/model.mtt")
    assert captured["url"] == "https://huggingface.co/some-org/some-repo/resolve/main/model.mtt"
    assert captured["auth"] == "Bearer tok123"
    assert Path(local).read_bytes() == b"payload"
    tio.resolve_model_path("hf://some-org/some-repo/other.mtt", revision="v2", token="tok456")
    assert captured["url"] == "https://huggingface.co/some-org/some-repo/resolve/v2/other.mtt"
    assert captured["auth"] == "Bearer tok456"
    with pytest.raises(ValueError, match="hf://"):
        tio.resolve_model_path("hf://only-org/model.mtt")


@pytest.fixture(scope="module")
def float32_mtt(tmp_path_factory):
    """A float32 PET with forces in its target, random weights and a
    composition baseline, exported by the port."""
    info = DatasetInfo("angstrom", [29], {"energy": get_energy_target_info("eV", True)})
    model = PET(CLI_MODEL, info)
    model.init_weights(torch.Generator().manual_seed(5))
    model.composition.weights["energy"][:] = -3.5
    path = tmp_path_factory.mktemp("f32") / "model.mtt"
    export_model_object(model, None, str(path))
    return path


def _read_predictions(path):
    if str(path).endswith(".npz"):
        data = np.load(path)
        n = len({key.split("/")[0] for key in data})
        return (np.array([float(data[f"{i}/energy/values"].ravel()[0]) for i in range(n)]),
                np.concatenate([-data[f"{i}/energy/positions_grad"][:, :, 0] for i in range(n)]))
    frames = read_xyz(str(path))
    return (np.array([float(f.extra["energy"]) for f in frames]),
            np.concatenate([f.extra["energy_forces"] for f in frames]))


@pytest.mark.parametrize("suffix", [".xyz", ".npz"])
def test_eval_matches_jax(float32_mtt, data_file, tmp_path, suffix):
    from metatrain_tpu.cli.eval import eval_model as jax_eval_model

    options = _dataset(data_file)
    theirs = jax_eval_model(str(float32_mtt), copy.deepcopy(options), batch_size=4,
                            output_path=str(tmp_path / f"jax{suffix}"))
    ours = eval_model(str(float32_mtt), copy.deepcopy(options), batch_size=4, device="cpu",
                      check_consistency=True, output_path=str(tmp_path / f"port{suffix}"))
    assert sorted(ours) == sorted(theirs) and len(ours) == 4
    for key in theirs:
        assert abs(ours[key] - theirs[key]) <= EVAL_TOL * abs(theirs[key]), key
    for o, t in zip(_read_predictions(tmp_path / f"port{suffix}"),
                    _read_predictions(tmp_path / f"jax{suffix}")):
        assert o.shape == t.shape and rel(o, t) < EVAL_TOL


def test_eval_needs_a_card_unless_asked_and_profiles(float32_mtt, data_file, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "eval.json").write_text(json.dumps(_dataset(data_file)))
    with pytest.raises(RuntimeError, match="cpu"):
        tmain.main(["eval", str(float32_mtt), "eval.json"])
    assert "RuntimeError" in (tmp_path / "error.log").read_text()
    assert tmain.main(["eval", str(float32_mtt), "eval.json", "--device", "cpu",
                       "--profile", "trace"]) == 0
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)  # the ops traced


def test_load_options_reads_json_without_yaml(data_file, tmp_path, monkeypatch):
    options = _options(data_file)
    options["architecture"]["training"]["log_interval"] = "${architecture.training.num_epochs}"
    path = tmp_path / "options.json"
    path.write_text(json.dumps(options, indent=2))
    theirs = jconfig.load_options(path)  # through PyYAML
    monkeypatch.setitem(sys.modules, "yaml", None)  # any import of yaml now fails
    assert tconfig.load_options(path) == theirs
    assert theirs["architecture"]["training"]["log_interval"] == 1
    # overrides: a JSON value needs no PyYAML; anything else says it does
    assert tmain._apply_overrides({}, ["a.b=2", 'c="cpu"', "d=[1, 2]"]) == {
        "a": {"b": 2}, "c": "cpu", "d": [1, 2]}
    with pytest.raises(tconfig.MetatrainConfigError, match="PyYAML"):
        tmain._apply_overrides({}, ["device=cpu"])
    yaml_file = tmp_path / "options.yaml"
    yaml_file.write_text("seed: 0\narchitecture:\n  name: pet\n")
    with pytest.raises(tconfig.MetatrainConfigError, match="PyYAML"):
        tconfig.load_options(yaml_file)


def _read_disk_predictions(path):
    """Energies and forces of ``.zip`` / ``.mts`` / memmap predictions, read
    with the JAX package's readers."""
    import metatrain_tpu.data.disk as jdisk
    import metatrain_tpu.data.readers.mts as jmts

    if path.endswith(".mts"):
        block = jmts.load_mts(path.replace(".mts", "_energy.mts")).block(0)
        return (np.asarray(block.values)[:, 0],
                -np.asarray(block.gradient("positions").values)[:, :, 0])
    dataset = jdisk.DiskDataset(path) if path.endswith(".zip") else jdisk.MemmapDataset(path)
    blocks = [dataset[i].targets["energy"].block(0) for i in range(len(dataset))]
    return (np.array([float(np.asarray(b.values)[0, 0]) for b in blocks]),
            np.concatenate([-np.asarray(b.gradient("positions").values)[:, :, 0]
                            for b in blocks]))


@pytest.mark.parametrize("suffix", ["preds.zip", "preds.mts", "preds/"])
def test_unported_writers_name_what_they_wait_for(float32_mtt, data_file, tmp_path, suffix):
    """The ``.zip``, ``.mts`` and memmap writers, through ``eval``: the
    port's and the JAX package's predictions of the same float32 ``.mtt``,
    both read with the JAX package's readers, agree as ``.xyz`` ones do."""
    from metatrain_tpu.cli.eval import eval_model as jax_eval_model

    options = _dataset(data_file)
    jax_eval_model(str(float32_mtt), copy.deepcopy(options), batch_size=4,
                   output_path=f"{tmp_path}/jax_{suffix}")
    eval_model(str(float32_mtt), copy.deepcopy(options), batch_size=4, device="cpu",
               output_path=f"{tmp_path}/port_{suffix}")
    ours = _read_disk_predictions(f"{tmp_path}/port_{suffix}")
    theirs = _read_disk_predictions(f"{tmp_path}/jax_{suffix}")
    assert len(ours[0]) == len(read_xyz(str(data_file)))
    for o, t in zip(ours, theirs):
        assert o.shape == t.shape and rel(o, t) < EVAL_TOL


def test_restart_onto_new_targets_and_types():
    """``restart`` keeps a model for its own dataset, adds fresh heads for a
    new target (the other weights carried over) and refuses new types."""
    info = DatasetInfo("angstrom", [29], {"energy": get_energy_target_info("eV", True)})
    model = PET(CLI_MODEL, info, fused_gnn=True)
    model.init_weights(torch.Generator().manual_seed(1))
    assert model.restart(DatasetInfo("angstrom", [29], dict(info.targets))) is model
    wider = DatasetInfo("angstrom", [29], {"energy2": get_energy_target_info("eV")})
    new = model.restart(wider)
    assert sorted(new.supported_outputs()) == ["energy", "energy2"]
    assert new.build_options == model.build_options
    old, merged = model.module.state_dict(), new.module.state_dict()
    assert [k for k in merged if k not in old] and all("energy2" in k for k in merged
                                                        if k not in old)
    for key, value in old.items():
        assert torch.equal(merged[key], value), key
    with pytest.raises(ValueError, match="new atomic types"):
        model.restart(DatasetInfo("angstrom", [1, 29], dict(info.targets)))
