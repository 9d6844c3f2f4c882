"""Port parity: PET's unfused layers, the residual featurizer and the older
checkpoints vs the JAX package.

float64 on the CPU. The JAX package runs its plain references (on the CPU
its unfused layers take ``reference_window_attention``); the port runs the
window attention and permute ``autograd.Function``s, which take their plain
versions for CPU tensors.

- The force call (energy, forces, virial) to 1e-10 on a molecule and a
  crystal, in four configurations: RMSNorm/SwiGLU/PreLN, LayerNorm/SiLU/
  PostLN, the residual featurizer, and ``d_node == d_pet`` (no expansion).
- The frozen v1 and v2 checkpoints, read by the port's ``pet_from_checkpoint``
  (upgraded as the JAX package upgrades them) and by the JAX package's
  ``model_from_checkpoint``, to 1e-10.
- One training step's loss and parameter gradients of the unfused model
  equal JAX's ``_compute_loss_and_errors`` under ``jax.value_and_grad`` to
  1e-10.
- The port's checkpoint of an unfused model loads in the JAX package and
  gives the port's energy, forces and virial to 1e-10.
"""

import copy
import gzip
import pickle
from pathlib import Path

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
from test_torch_port_train import _flat, _frames, lennard_jones
from metatrain_tpu.data import collate as jcollate
from metatrain_tpu.data import dataset as jdataset
from metatrain_tpu.data.target_info import DatasetInfo as JaxDatasetInfo
from metatrain_tpu.data.target_info import get_energy_target_info as jax_energy_info
from metatrain_tpu.engine import loss as jloss
from metatrain_tpu.engine import trainer as jtrainer
from metatrain_tpu.models.pet import PET as JaxPET
from metatrain_tpu.utils import config as jconfig
from metatrain_tpu.utils.io import model_from_checkpoint
from metatrain_tpu_torch.data import collate as tcollate
from metatrain_tpu_torch.data import dataset as tdataset
from metatrain_tpu_torch.data.readers.extxyz import write_xyz
from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info
from metatrain_tpu_torch.engine import loss as tloss
from metatrain_tpu_torch.engine import trainer as ttrainer
from metatrain_tpu_torch.interop.jax_params import (
    flax_to_state_dict,
    load_checkpoint_file,
    pet_from_checkpoint,
    state_dict_to_flax,
)
from metatrain_tpu_torch.models.pet import PET
from metatrain_tpu_torch.models.pet.modules import TransformerLayer
from metatrain_tpu_torch.utils import config as tconfig

HYPERS = {"cutoff": 4.5, "d_pet": 16, "d_head": 16, "d_node": 24, "d_feedforward": 16,
          "num_heads": 2, "num_gnn_layers": 2, "num_attention_layers": 2, "fused_layers": False}
CONFIGS = {
    "rmsnorm-swiglu-preln": {},
    "layernorm-silu-postln": {"normalization": "LayerNorm", "activation": "SiLU",
                              "transformer_type": "PostLN"},
    "residual": {"featurizer_type": "residual"},
    "no-expansion": {"d_node": 16},
}
CHECKPOINTS = Path(__file__).parent / "checkpoints"


def _infos(types):
    jax_info = JaxDatasetInfo("angstrom", types, {"energy": jax_energy_info("eV", True, True)})
    info = DatasetInfo("angstrom", types, {"energy": get_energy_target_info("eV", True, True)})
    return jax_info, info


def _random_pet(hypers, info, seed=0):
    port = PET(hypers, info, compute_dtype=torch.float64)
    port.init_weights(torch.Generator().manual_seed(seed))
    # the weights go through the converter they will come from
    params = flax_tree(port.module)
    port.module.load_state_dict(flax_to_state_dict(params))
    return port, params


@pytest.mark.parametrize("system", [make_molecule(), make_crystal()], ids=["molecule", "crystal"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_unfused_force_call_matches_jax(config, system):
    hypers = {**HYPERS, **CONFIGS[config]}
    types = sorted({int(t) for t in system.types})
    jax_info, info = _infos(types)
    port, params = _random_pet(hypers, info)
    assert isinstance(port.module.backbone.gnn_layer_0.layer_0, TransformerLayer)
    jax_model = JaxPET(hypers, jax_info, compute_dtype=jnp.float64)

    jax_batch, batch = neighbors_and_batches(system, port.cutoff)
    expected = jax_energy_forces_virial(jax_model, params, jax_batch, dict(jax_info.targets))
    got = port_energy_forces_virial(port, batch, dict(info.targets))
    for g, e in zip(got, expected):
        assert g.shape == e.shape
        assert rel(g, e) < 1e-10
    assert np.abs(expected[1]).max() > 0 and np.abs(expected[2]).max() > 0


@pytest.mark.parametrize("version", [1, 2])
def test_old_checkpoint_force_call_matches_jax(version):
    path = CHECKPOINTS / f"pet_model-v{version}_trainer-v1.ckpt.gz"
    checkpoint = load_checkpoint_file(path)
    port = pet_from_checkpoint(copy.deepcopy(checkpoint), compute_dtype=torch.float64,
                               device="cpu")
    with gzip.open(path, "rb") as f:
        loaded = model_from_checkpoint(pickle.load(f), context="export")
    assert port.hypers["fused_layers"] == loaded.hypers["fused_layers"] == (version == 2)
    assert port.hypers["fused_attention"] is True
    jax_model = JaxPET(loaded.hypers, loaded.dataset_info, compute_dtype=jnp.float64)
    jax_model.composition, jax_model.scaler = loaded.composition, loaded.scaler
    # the scaler's version-1 scale is broadcast to the blocks, as in JAX
    np.testing.assert_array_equal(port.scaler.scales["energy"][0],
                                  loaded.scaler.scales["energy"][0])
    np.testing.assert_array_equal(port.scaler.per_target["energy"],
                                  loaded.scaler.per_target["energy"])

    system = make_molecule(n_atoms=10, seed=4)
    _, info = _infos(loaded.dataset_info.atomic_types)
    jax_batch, batch = neighbors_and_batches(system, port.cutoff)
    expected = jax_energy_forces_virial(jax_model, loaded.params, jax_batch,
                                        {"energy": jax_energy_info("eV", True, True)})
    got = port_energy_forces_virial(port, batch, dict(info.targets))
    for g, e in zip(got, expected):
        assert rel(g, e) < 1e-10
    assert port.scaler.scales["energy"][0] != 1.0


def test_too_new_checkpoint_is_refused():
    checkpoint = load_checkpoint_file(CHECKPOINTS / "pet_model-v3_trainer-v1.ckpt.gz")
    checkpoint["model_ckpt_version"] = 4
    with pytest.raises(ValueError, match="newer"):
        pet_from_checkpoint(checkpoint, device="cpu")


@pytest.fixture(scope="module")
def dataset_file(tmp_path_factory):
    systems = _frames(4)
    labels = [lennard_jones(s) for s in systems]
    path = str(tmp_path_factory.mktemp("data") / "cu.xyz")
    write_xyz(path, systems, per_atom_arrays=[{"forces": f} for _, f in labels],
              info=[{"energy": e} for e, _ in labels])
    return path


LOSS = {"energy": {"type": "mse", "weight": 1.0, "gradients": {"positions": {"weight": 10.0}}}}


def test_unfused_train_step_matches_jax(dataset_file):
    hypers = {**HYPERS, "num_attention_layers": 1}
    section = {"systems": {"read_from": dataset_file, "length_unit": "angstrom"},
               "targets": {"energy": {"key": "energy", "unit": "eV", "forces": "on"}}}
    t_data, t_infos = tdataset.get_dataset(tconfig.expand_dataset_config(section))
    j_data, j_infos = jdataset.get_dataset(jconfig.expand_dataset_config(section))
    t_info = tdataset.get_dataset_info([t_data], t_infos, "angstrom")
    j_info = jdataset.get_dataset_info([j_data], j_infos, "angstrom")

    jax_model = JaxPET(hypers, j_info, compute_dtype=jnp.float64)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                          jax_model.init_params(jax.random.PRNGKey(3)))
    port = PET(hypers, t_info, compute_dtype=torch.float64)
    port.module.load_state_dict(flax_to_state_dict(jax.device_get(params)))

    samples = [0, 3]
    t_batch = tcollate.CollateFn(4.5, t_infos, dtype=torch.float64)([t_data[i] for i in samples])
    j_batch = jcollate.CollateFn(4.5, j_infos, dtype=jnp.float64)([j_data[i] for i in samples])

    def j_loss(p):
        return jtrainer._compute_loss_and_errors(
            jax_model.forward, jloss.LossAggregator(j_infos, LOSS), j_infos, [],
            {"energy": (jnp.ones((1,)),)}, p, j_batch)

    (j_value, _), j_grads = jax.value_and_grad(j_loss, has_aux=True)(params)
    loss, _ = ttrainer._compute_loss_and_errors(
        port, tloss.LossAggregator(t_infos, LOSS), t_infos, [],
        {"energy": [torch.ones(1, dtype=torch.float64)]}, t_batch, is_training=True)
    loss.backward()
    assert abs(float(loss.detach()) - float(j_value)) <= 1e-10 * abs(float(j_value))

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


def test_port_unfused_checkpoint_evaluates_in_jax():
    hypers = {**HYPERS, **CONFIGS["layernorm-silu-postln"], "featurizer_type": "residual"}
    system = make_crystal(n_cells=2, seed=7, jitter=0.1)
    types = sorted({int(t) for t in system.types})
    jax_info, info = _infos(types)
    port, _ = _random_pet(hypers, info, seed=5)
    port.composition.weights["energy"][:] = 0.25
    checkpoint = port.get_checkpoint()
    loaded = model_from_checkpoint(copy.deepcopy(checkpoint), context="export")
    jax_model = JaxPET(loaded.hypers, loaded.dataset_info, compute_dtype=jnp.float64)
    jax_model.composition, jax_model.scaler = loaded.composition, loaded.scaler
    reloaded = pet_from_checkpoint(checkpoint, compute_dtype=torch.float64, device="cpu")

    jax_batch, batch = neighbors_and_batches(system, port.cutoff)
    expected = jax_energy_forces_virial(jax_model, loaded.params, jax_batch,
                                        dict(jax_info.targets))
    for model in (port, reloaded):
        got = port_energy_forces_virial(model, batch, dict(info.targets))
        for g, e in zip(got, expected):
            assert rel(g, e) < 1e-10
