"""Port parity of PET's physics options, module by module, vs the JAX package.

float64 on the CPU, the same inputs (numpy, from a seed) through the JAX
function and its port:

- ``batch_from_systems(extra_keys=)`` and ``CollateFn(extra_system_keys=)``;
- ``ops/ewald``: ``kvectors_for_cell``, the Ewald, PME and direct
  potentials and their gradients through positions and cell, on a
  triclinic periodic cell and a molecule, and the port's batched form
  (each atom against its own system's cell) against JAX's one call per
  system;
- ``models/pet/adaptive``: both methods' cutoffs and their gradients
  through the distances;
- ZBL: the device energies and their gradient, ``predict_host`` and
  ``remove_transform``;
- ``SystemConditioningEmbedding`` with varied charges and spins and a
  drawn gate (the gate starts at zero, which would hide everything).

Tolerance 1e-12 relative, except the solver's gradient (see
``test_adaptive_cutoffs_match_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import neighbors_and_batches, rel
from conftest import make_crystal, make_molecule
from metatrain_tpu.containers import NeighborData as JaxNeighborData
from metatrain_tpu.containers import batch_from_systems as jax_batch_from_systems
from metatrain_tpu.data import collate as jcollate
from metatrain_tpu.data import dataset as jdataset
from metatrain_tpu.data.target_info import DatasetInfo as JaxDatasetInfo
from metatrain_tpu.data.target_info import get_energy_target_info as jax_energy_info
from metatrain_tpu.models import zbl as jzbl
from metatrain_tpu.models.pet import adaptive as jadaptive
from metatrain_tpu.models.pet.modules import SystemConditioningEmbedding as JaxConditioning
from metatrain_tpu.ops import ewald as jewald
from metatrain_tpu.utils import config as jconfig
from metatrain_tpu_torch.containers import System, batch_from_systems
from metatrain_tpu_torch.data import collate as tcollate
from metatrain_tpu_torch.data import dataset as tdataset
from metatrain_tpu_torch.data.readers.extxyz import write_xyz
from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info
from metatrain_tpu_torch.interop.jax_params import state_dict_to_flax
from metatrain_tpu_torch.models import zbl as tzbl
from metatrain_tpu_torch.models.pet import adaptive as tadaptive
from metatrain_tpu_torch.models.pet.modules import SystemConditioningEmbedding, init_flax_like
from metatrain_tpu_torch.ops import ewald as tewald
from metatrain_tpu_torch.ops.neighbors import compute_neighbor_data
from metatrain_tpu_torch.utils import config as tconfig

SMEARING = 1.4


def _triclinic(seed=0, n=12):
    """A periodic system in a sheared cell, two species."""
    rng = np.random.default_rng(seed)
    cell = np.array([[6.0, 0.0, 0.0], [1.2, 5.5, 0.0], [-0.7, 0.9, 6.3]])
    positions = rng.uniform(0, 1, size=(n, 3)) @ cell
    return System(positions, rng.choice([8, 29], size=n), cell, np.ones(3, dtype=bool))


def _grads_jax(fn, *args):
    """Value and gradient in every argument of ``sum(fn(*args) * w)``."""
    shape = jax.eval_shape(fn, *args).shape
    w = np.random.default_rng(7).normal(size=shape)

    def run(*a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(jnp.asarray(w))

    out, grads = jax.jit(run)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads], w


def _grads_torch(fn, args, w):
    args = [torch.as_tensor(np.asarray(a)).requires_grad_(True) for a in args]
    out = fn(*args)
    (out * torch.as_tensor(w)).sum().backward()
    return out.detach().numpy(), [a.grad.numpy() for a in args]


def _close(ours, theirs, bound=1e-12):
    assert np.shape(ours) == np.shape(theirs)
    assert rel(ours, theirs) <= bound


# ---- per-system extra data ------------------------------------------------


def test_extra_keys_batch_as_jax():
    systems = [make_molecule(n_atoms=5, seed=s) for s in (1, 2)]
    for s, (q, spin) in zip(systems, ((1, 2), (-2, 3))):
        s.extra.update(charge=np.asarray(q), spin_multiplicity=np.asarray(spin),
                       velocities=np.arange(3 * len(s), dtype=float).reshape(-1, 3))
    port = [System(s.positions, s.types, s.cell, s.pbc, dict(s.extra)) for s in systems]
    nbrs = [compute_neighbor_data(s, 4.0) for s in port]
    keys = ("charge", "spin_multiplicity", "velocities")
    j = jax_batch_from_systems(
        systems, [JaxNeighborData(n.indices, n.shifts, n.mask, n.reverse) for n in nbrs],
        extra_keys=keys, dtype=jnp.float64)
    b = batch_from_systems(port, nbrs, torch.device("cpu"), dtype=torch.float64, extra_keys=keys)
    assert sorted(b.extra) == sorted(j.extra) == sorted(keys)
    for key in keys:
        np.testing.assert_array_equal(b.extra[key].numpy(), np.asarray(j.extra[key]))
    assert b.extra["charge"].shape == (b.n_systems_padded,)
    assert b.extra["velocities"].shape == (b.n_atoms_padded, 3)
    assert b.extra["charge"][2:].abs().sum() == 0  # padded systems get 0
    with pytest.raises(KeyError):
        batch_from_systems(port, nbrs, torch.device("cpu"), extra_keys=("missing",))


def test_collate_ships_extra_keys_as_jax(tmp_path):
    systems = [_triclinic(seed=s) for s in range(3)]
    path = str(tmp_path / "frames.xyz")
    write_xyz(path, systems, info=[{"energy": float(i), "charge": i - 1, "spin_multiplicity": i + 1}
                                   for i in range(3)])
    conf = {"systems": {"read_from": path, "length_unit": "angstrom"},
            "targets": {"energy": {"key": "energy", "unit": "eV", "forces": False}}}
    t_data, t_infos = tdataset.get_dataset(tconfig.expand_dataset_config(conf))
    j_data, j_infos = jdataset.get_dataset(jconfig.expand_dataset_config(conf))
    keys = ("charge", "spin_multiplicity")
    t_batch = tcollate.CollateFn(4.0, t_infos, dtype=torch.float64, extra_system_keys=keys)(
        [t_data[i] for i in range(3)])
    j_batch = jcollate.CollateFn(4.0, j_infos, dtype=jnp.float64, extra_system_keys=keys)(
        [j_data[i] for i in range(3)])
    for key in keys:
        np.testing.assert_array_equal(t_batch.systems.extra[key].numpy(),
                                      np.asarray(j_batch.systems.extra[key]))
    assert t_batch.systems.extra["charge"][:3].tolist() == [-1, 0, 1]


# ---- ops/ewald ---------------------------------------------------------------


def test_kvectors_for_cell_match_jax():
    cell = _triclinic().cell
    np.testing.assert_array_equal(tewald.kvectors_for_cell(cell, 3.0),
                                  jewald.kvectors_for_cell(cell, 3.0))
    from metatrain_tpu.engine.long_range import _static_half_space_triples

    np.testing.assert_array_equal(tewald.half_space_triples(3), _static_half_space_triples(3))


def _charges(n, seed=3):
    return np.random.default_rng(seed).normal(size=n)


@pytest.mark.parametrize("method", ["ewald", "pme"])
def test_periodic_potentials_match_jax(method):
    """Potential and its gradient in positions, charges and cell; one padded
    atom (masked) in the input."""
    system = _triclinic()
    n = len(system)
    positions = np.concatenate([system.positions, np.zeros((1, 3))])
    charges = np.concatenate([_charges(n), [0.0]])
    mask = np.arange(n + 1) < n
    if method == "ewald":
        triples = tewald.half_space_triples(3)

        def jfn(p, q, c):
            return jewald.ewald_potential_periodic(p, q, c, jnp.asarray(triples),
                                                   jnp.asarray(mask), SMEARING)

        def tfn(p, q, c):
            return tewald.ewald_potential_periodic(p, q, c, torch.as_tensor(triples),
                                                   torch.as_tensor(mask), SMEARING)
    else:
        def jfn(p, q, c):
            return jewald.pme_potential_periodic(p, q, c, jnp.asarray(mask), SMEARING, mesh=16)

        def tfn(p, q, c):
            return tewald.pme_potential_periodic(p, q, c, torch.as_tensor(mask), SMEARING, mesh=16)

    args = (positions, charges, system.cell)
    expected, j_grads, w = _grads_jax(jfn, *map(jnp.asarray, args))
    got, t_grads = _grads_torch(tfn, args, w)
    _close(got, expected)
    assert np.abs(expected).max() > 0.1
    for ours, theirs in zip(t_grads, j_grads):
        _close(ours, theirs)


def test_direct_potential_matches_jax():
    system = make_molecule(n_atoms=10, seed=5)
    jax_batch, batch = neighbors_and_batches(system, 4.0)
    charges = _charges(batch.n_atoms_padded) * batch.atom_mask.numpy()
    _, j_dist = jax_batch.edge_vectors()

    def jfn(q):
        return jewald.direct_potential_nonperiodic(j_dist, jax_batch.nbr_indices,
                                                   jax_batch.nbr_mask, q, SMEARING)

    def tfn(q):
        _, dist = batch.edge_vectors()
        return tewald.direct_potential_nonperiodic(dist, batch.nbr_indices, batch.nbr_reverse,
                                                   batch.nbr_mask, q, SMEARING, 4.0)

    expected, j_grads, w = _grads_jax(jfn, jnp.asarray(charges))
    got, t_grads = _grads_torch(tfn, [charges], w)
    _close(got, expected)
    _close(t_grads[0], j_grads[0])


@pytest.mark.parametrize("method", ["ewald", "pme"])
def test_batched_potentials_equal_one_call_per_system(method):
    """The port's (S, 3, 3) form against the JAX package's one call per
    system masked to its atoms (its featurizer's vmap), a padded system
    with the identity cell included."""
    systems = [_triclinic(seed=1, n=9), _triclinic(seed=2, n=7)]
    systems[1].cell = systems[1].cell * 1.1
    positions = np.concatenate([s.positions for s in systems] + [np.zeros((2, 3))])
    system_index = np.array([0] * 9 + [1] * 7 + [2] * 2)
    cells = np.stack([systems[0].cell, systems[1].cell, np.eye(3)])
    charges = _charges(len(positions))
    mask = system_index < 2
    triples = tewald.half_space_triples(2)
    expected = np.zeros(len(positions))
    for s in range(3):
        in_system = jnp.asarray((system_index == s) & mask)
        if method == "ewald":
            phi = jewald.ewald_potential_periodic(positions, charges, cells[s],
                                                  jnp.asarray(triples), in_system, SMEARING)
        else:
            phi = jewald.pme_potential_periodic(positions, charges, cells[s], in_system,
                                                SMEARING, mesh=12)
        expected += np.asarray(phi) * (system_index == s)
    t = torch.as_tensor
    if method == "ewald":
        got = tewald.ewald_potential_periodic(t(positions), t(charges), t(cells), t(triples),
                                              t(mask), SMEARING, system_index=t(system_index))
    else:
        got = tewald.pme_potential_periodic(t(positions), t(charges), t(cells), t(mask),
                                            SMEARING, mesh=12, system_index=t(system_index))
    _close(got.numpy(), expected)


# ---- adaptive cutoffs ----------------------------------------------------------


@pytest.mark.parametrize("method", ["solver", "probe"])
@pytest.mark.parametrize("system", [make_molecule(n_atoms=12), make_crystal()],
                         ids=["molecule", "crystal"])
def test_adaptive_cutoffs_match_jax(method, system):
    """The cutoffs to 1e-12 and their gradient through the distances. The
    solver's gradient to 1e-7: its 30 fixed iterations end in bisection
    where a Newton step leaves the bracket, whose last width is ~1e-8 A, and
    JAX's compiled loop and the port's eager loop round differently there,
    so they stop at different points of it. The implicit-function step
    removes that difference from the cutoff to second order, but not from
    its gradient (first order)."""
    _, batch = neighbors_and_batches(system, 4.5)
    _, distances = batch.edge_vectors()
    mask = batch.nbr_mask
    jfn, tfn = {"solver": (jadaptive.get_adaptive_cutoffs, tadaptive.get_adaptive_cutoffs),
                "probe": (jadaptive.get_probe_adaptive_cutoffs,
                          tadaptive.get_probe_adaptive_cutoffs)}[method]
    expected, (j_grad,), w = _grads_jax(
        lambda d: jfn(d, jnp.asarray(mask.numpy()), 8.0, 4.5, 1.0), jnp.asarray(distances.numpy()))
    got, (t_grad,) = _grads_torch(lambda d: tfn(d, mask, 8.0, 4.5, 1.0), [distances], w)
    _close(got, expected)
    real = batch.atom_mask.numpy()
    assert 0.5 <= got[real].min() and got[real].max() <= 4.5 + 1e-12
    assert np.ptp(got[real]) > 0.01  # the cutoffs adapt
    _close(t_grad, j_grad, 1e-7 if method == "solver" else 1e-12)


# ---- ZBL -------------------------------------------------------------------------


def _zbl_pair(cutoff=4.5):
    types = [8, 29]
    j = jzbl.ZBL(JaxDatasetInfo("angstrom", types, {"energy": jax_energy_info("eV", True, True)}),
                 cutoff, 0.5)
    t = tzbl.ZBL(DatasetInfo("angstrom", types, {"energy": get_energy_target_info("eV", True,
                                                                                  True)}),
                 cutoff, 0.5)
    return j, t


def test_zbl_device_energies_match_jax():
    system = _triclinic()
    system.positions[1] = system.positions[0] + np.array([0.9, 0.3, 0.1])  # a close pair
    j, t = _zbl_pair()
    jax_batch, batch = neighbors_and_batches(system, 4.5)
    expected = np.asarray(j.atomic_energies(jax_batch))
    _close(t.atomic_energies(batch).numpy(), expected)
    assert np.abs(expected).max() > 1.0

    def j_energy(pos):
        return jnp.sum(j.forward(jax_batch.replace(positions=pos), ["energy"])["energy"]
                       .block(0).values)

    def t_energy(pos):
        return t.forward(batch.replace(positions=pos), ["energy"])["energy"].sum()

    e, g = jax.value_and_grad(j_energy)(jax_batch.positions)
    pos = batch.positions.clone().requires_grad_(True)
    value = t_energy(pos)
    value.backward()
    _close(value.item(), float(e))
    _close(pos.grad.numpy(), np.asarray(g))
    # the host evaluation and its analytic gradient
    jh, th = j.predict_host(system), t.predict_host(system)
    _close(th["energy"], jh["energy"])
    _close(th["position_gradient"], jh["position_gradient"])
    _close(th["energy"], value.item())
    _close(th["position_gradient"], pos.grad.numpy()[: len(system)])


def test_zbl_remove_transform_matches_jax(tmp_path):
    systems = [_triclinic(seed=s) for s in range(2)]
    path = str(tmp_path / "frames.xyz")
    rng = np.random.default_rng(0)
    write_xyz(path, systems, per_atom_arrays=[{"forces": rng.normal(size=(len(s), 3))}
                                              for s in systems],
              info=[{"energy": float(i)} for i in range(2)])
    conf = {"systems": {"read_from": path, "length_unit": "angstrom"},
            "targets": {"energy": {"key": "energy", "unit": "eV", "forces": "on"}}}
    t_data, _ = tdataset.get_dataset(tconfig.expand_dataset_config(conf))
    j_data, _ = jdataset.get_dataset(jconfig.expand_dataset_config(conf))
    j, t = _zbl_pair()
    ours = t.remove_transform([t_data[i] for i in range(2)])
    theirs = j.remove_transform([j_data[i] for i in range(2)])
    for o, th, before in zip(ours, theirs, [t_data[i] for i in range(2)]):
        ob, tb = o.targets["energy"].block(0), th.targets["energy"].block(0)
        _close(np.asarray(ob.values), np.asarray(tb.values))
        _close(np.asarray(ob.gradient("positions").values),
               np.asarray(tb.gradient("positions").values))
        assert not np.allclose(np.asarray(ob.values), np.asarray(before.targets["energy"]
                                                                 .block(0).values))


# ---- system conditioning -----------------------------------------------------------


def test_system_conditioning_matches_jax():
    module = SystemConditioningEmbedding(12, max_charge=3, max_spin_multiplicity=4).double()
    init_flax_like(module, torch.Generator().manual_seed(0))
    assert (module.gate.weight == 0).all()  # zero-initialised, as flax's kernel_init
    with torch.no_grad():  # drawn, or the module would output zeros
        module.gate.weight.normal_(0.0, 0.5, generator=torch.Generator().manual_seed(1))
        module.gate.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(2))
    charge = np.array([-5.0, -1.0, 0.0, 2.7, 4.0, 1.0])  # clipped and truncated as in JAX
    spin = np.array([0.0, 1.0, 2.0, 3.0, 9.0, 4.0])
    system_index = np.array([0, 0, 1, 2, 3, 4, 5, 5, 1, 0])
    jax_module = JaxConditioning(d_out=12, max_charge=3, max_spin_multiplicity=4,
                                 dtype=jnp.float64)
    expected = np.asarray(jax_module.apply(state_dict_to_flax(module), jnp.asarray(charge),
                                           jnp.asarray(spin), jnp.asarray(system_index)))
    got = module(torch.as_tensor(charge), torch.as_tensor(spin), torch.as_tensor(system_index),
                 torch.float64)
    _close(got.detach().numpy(), expected)
    rows = got.detach().numpy()[[0, 2, 3, 4, 5, 6]]
    assert len({tuple(np.round(r, 12)) for r in rows}) == 6  # every system its own row
