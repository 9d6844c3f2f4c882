"""Shared helpers of the PyTorch-port parity tests (``test_torch_port_*``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from metatrain_tpu.containers import NeighborData as JaxNeighborData
from metatrain_tpu.containers import batch_from_systems as jax_batch_from_systems
from metatrain_tpu.engine.evaluate import evaluate_model as jax_evaluate_model
from metatrain_tpu_torch.containers import System, batch_from_systems
from metatrain_tpu_torch.engine.evaluate import evaluate_model
from metatrain_tpu_torch.models.pet.modules import RMSNorm
from metatrain_tpu_torch.ops.inference import no_param_grads
from metatrain_tpu_torch.ops.neighbors import compute_neighbor_data

# The suite runs in several worker processes on one host; torch's default of
# one thread per core in each of them oversubscribes the cores many times
# over and slows these small CPU problems tenfold.
torch.set_num_threads(1)


def flax_tree(module: torch.nn.Module) -> dict:
    """The flax parameter tree holding ``module``'s weights (the inverse of
    ``interop.jax_params.flax_to_state_dict``)."""
    tree: dict = {}
    for name, p in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        value = p.detach().numpy().copy()
        if isinstance(owner, torch.nn.Linear):
            path, key = owner_name.split("."), "kernel" if leaf == "weight" else "bias"
            value = value.T.copy() if leaf == "weight" else value
        elif isinstance(owner, torch.nn.Embedding):
            path, key = owner_name.split("."), "embedding"
        elif isinstance(owner, (torch.nn.LayerNorm, RMSNorm)):
            path, key = owner_name.split("."), "scale" if leaf == "weight" else "bias"
        else:
            path, key = name.split(".")[:-1], leaf
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[key] = value
    return {"params": tree}


def neighbors_and_batches(system, cutoff):
    """Port NEF data for ``system`` and the same arrays as a JAX batch and a
    port batch (both float64)."""
    port_system = System(system.positions, system.types, system.cell, system.pbc)
    nbr = compute_neighbor_data(port_system, cutoff)
    jax_nbr = JaxNeighborData(nbr.indices, nbr.shifts, nbr.mask, nbr.reverse)
    jax_batch = jax_batch_from_systems([system], [jax_nbr], dtype=jnp.float64)
    batch = batch_from_systems([port_system], [nbr], torch.device("cpu"), dtype=torch.float64)
    return jax_batch, batch


def jax_energy_forces_virial(model, params, batch, target_infos):
    def run(p, b):
        block = jax_evaluate_model(
            model.forward_eval, p, b, target_infos, is_training=False
        )["energy"].block(0)
        return (block.values, block.gradient("positions").values,
                block.gradient("strain").values)

    return [np.asarray(x) for x in jax.jit(run)(params, batch)]


def port_energy_forces_virial(model, batch, target_infos):
    with no_param_grads(model):
        block = evaluate_model(model.forward_eval, batch, target_infos)["energy"].block(0)
    return [x.detach().numpy() for x in (
        block.values, block.gradient("positions").values, block.gradient("strain").values
    )]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()
