"""Port parity: the PET force call (energy, forces, virial) vs the JAX package.

float64 on the CPU: the JAX package runs its plain references
(``PET.forward_eval`` through ``evaluate_model``), the port runs its
kernels' ``autograd.Function``s, which take their plain versions for CPU
tensors. The same weights go to both: a random-init model (molecule and
periodic crystal), converted through ``interop.jax_params``, and the
frozen v3 PET checkpoint (composition and scaler included), read by the
JAX package's loader and by the port's own converter. Energy, forces and
virial agree to 1e-10 relative.
"""

import gzip
import pickle
from pathlib import Path

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
from metatrain_tpu.data.target_info import DatasetInfo as JaxDatasetInfo
from metatrain_tpu.data.target_info import get_energy_target_info as jax_energy_info
from metatrain_tpu.models.pet import PET as JaxPET
from metatrain_tpu.utils.io import model_from_checkpoint
from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info
from metatrain_tpu_torch.interop.jax_params import (
    flax_to_state_dict,
    load_checkpoint_file,
    pet_from_checkpoint,
)
from metatrain_tpu_torch.models.pet import PET

HYPERS = {"cutoff": 4.5, "d_pet": 32, "d_head": 32, "d_node": 48, "d_feedforward": 32,
          "num_heads": 4, "num_gnn_layers": 2, "num_attention_layers": 2}
CHECKPOINT = Path(__file__).parent / "checkpoints" / "pet_model-v3_trainer-v1.ckpt.gz"


def _infos(types):
    jax_info = JaxDatasetInfo("angstrom", types, {"energy": jax_energy_info("eV", True, True)})
    info = DatasetInfo("angstrom", types, {"energy": get_energy_target_info("eV", True, True)})
    return jax_info, info


@pytest.mark.parametrize("system", [make_molecule(), make_crystal()], ids=["molecule", "crystal"])
def test_random_init_force_call_matches_jax(system):
    types = sorted({int(t) for t in system.types})
    jax_info, info = _infos(types)
    port = PET(HYPERS, info, compute_dtype=torch.float64)
    port.init_weights(torch.Generator().manual_seed(0))
    params = flax_tree(port.module)
    # the port's weights go through the converter they will come from
    port.module.load_state_dict(flax_to_state_dict(params))
    jax_model = JaxPET(HYPERS, jax_info, compute_dtype=jnp.float64)

    jax_batch, batch = neighbors_and_batches(system, port.cutoff)
    expected = jax_energy_forces_virial(jax_model, params, jax_batch, dict(jax_info.targets))
    got = port_energy_forces_virial(port, batch, dict(info.targets))
    for g, e in zip(got, expected):
        assert g.shape == e.shape
        assert rel(g, e) < 1e-10
    assert np.abs(expected[1]).max() > 0 and np.abs(expected[2]).max() > 0


def test_v3_checkpoint_force_call_matches_jax():
    checkpoint = load_checkpoint_file(CHECKPOINT)
    port = pet_from_checkpoint(checkpoint, compute_dtype=torch.float64, device="cpu")

    with gzip.open(CHECKPOINT, "rb") as f:
        loaded = model_from_checkpoint(pickle.load(f), context="export")
    jax_model = JaxPET(loaded.hypers, loaded.dataset_info, compute_dtype=jnp.float64)
    jax_model.composition, jax_model.scaler = loaded.composition, loaded.scaler

    system = make_molecule(n_atoms=10, seed=4)
    _, info = _infos(loaded.dataset_info.atomic_types)
    jax_info = {"energy": jax_energy_info("eV", True, True)}
    jax_batch, batch = neighbors_and_batches(system, port.cutoff)
    expected = jax_energy_forces_virial(jax_model, loaded.params, jax_batch, jax_info)
    got = port_energy_forces_virial(port, batch, dict(info.targets))
    for g, e in zip(got, expected):
        assert rel(g, e) < 1e-10
    # the baselines are live: composition weights and a non-unit scale
    assert port.scaler.scales["energy"][0] != 1.0
    assert np.abs(port.composition.weights["energy"]).max() > 0
