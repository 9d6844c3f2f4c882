"""Port parity: the fused GNN block (plain versions of its kernels, its
``autograd.Function`` and PET with ``fused_gnn=True``) vs the JAX package.

The same inputs, made with numpy from a seed, go through the JAX
package's GNN block (``_gnn_block_math`` / ``_gnn_block_bwd_math``, and
``fused_gnn_block``, whose Pallas kernels run in interpret mode on the
CPU) and through the port's ``gnn_block_math`` / ``gnn_block_bwd_math``
and ``fused_gnn_block``, which take the plain versions for CPU tensors.
Expanded (node width N != D) and not are cases of each test.

- float64: the block's plain versions to 1e-12 relative (input and
  weight gradients against ``jax.vjp`` of ``_gnn_block_math``; against
  the hand-written ``_gnn_block_bwd_math`` at float32's 1e-6 where it
  rounds: d_cf and the weight gradients). PET with ``fused_gnn=True``
  against the JAX per-layer path to 1e-10 in energy, forces and virial
  (the JAX module takes its block only in float32/bfloat16).
- float32: ``fused_gnn_block`` values, first-order gradients and
  grad-of-grad against JAX's ``fused_gnn_block`` to 1e-5 relative RMS; PET
  with ``fused_gnn=True`` against the JAX PET under
  ``MTT_FUSED_GNN=force``, energy and forces to 1e-5.
- One training step of PET with ``fused_gnn=True`` equals the port's
  per-layer path in float64 (loss and gradients to 1e-10), and the flat
  weights the port gathers are those the JAX module hands its block.
"""

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
from test_torch_port_train import _frames, lennard_jones
from metatrain_tpu.containers import NeighborData as JaxNeighborData
from metatrain_tpu.containers import batch_from_systems as jax_batch_from_systems
from metatrain_tpu.data.target_info import DatasetInfo as JaxDatasetInfo
from metatrain_tpu.data.target_info import get_energy_target_info as jax_energy_info
from metatrain_tpu.models.pet import PET as JaxPET
from metatrain_tpu.ops.pallas import fused_layer as jfl
from metatrain_tpu_torch.containers import System, batch_from_systems
from metatrain_tpu_torch.data import collate as tcollate
from metatrain_tpu_torch.data import dataset as tdataset
from metatrain_tpu_torch.data.readers.extxyz import write_xyz
from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info
from metatrain_tpu_torch.engine import loss as tloss
from metatrain_tpu_torch.engine import trainer as ttrainer
from metatrain_tpu_torch.interop.jax_params import flax_to_state_dict
from metatrain_tpu_torch.models.pet import PET
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import gnn_block as tgb
from metatrain_tpu_torch.ops.neighbors import compute_neighbor_data
from metatrain_tpu_torch.utils import config as tconfig

A, M, D, H, F, N, L = 11, 16, 32, 4, 48, 96, 2
CHUNK = 4  # does not divide A: the replay's last chunk is short
SCALE = 1.0 / np.sqrt(D // H)
JAX_F32 = 1e-6  # where the JAX hand-written backward rounds to float32
EXPANDED = pytest.mark.parametrize("expanded", [True, False], ids=["expanded", "plain-node"])


def _case(dtype, expanded, seed):
    """(edges, node, cf, flat weights, g_edge, g_node) as numpy arrays."""
    rng = np.random.default_rng(seed)

    def lecun(i, o):
        return rng.normal(size=(i, o)) / np.sqrt(i)

    def vec(n, base=0.0):
        return base + 0.1 * rng.normal(size=n)

    flat = []
    for _ in range(L):
        flat += [vec(D, 1.0), lecun(D, 3 * D), vec(3 * D), lecun(D, D), vec(D), vec(D, 1.0),
                 lecun(D, 2 * F), vec(2 * F), lecun(F, D), vec(D)]
    if expanded:
        for _ in range(L):
            flat += [lecun(N, D), vec(D), lecun(D, N), vec(N), vec(N, 1.0), lecun(N, 4 * N),
                     vec(4 * N), lecun(2 * N, N), vec(N)]
    nn = N if expanded else D
    n_real = rng.integers(M // 2, M - 1, size=(A, 1))
    cf = rng.uniform(0.05, 1.0, size=(A, M)) * (np.arange(M)[None] < n_real)
    cf[:, M - 1] = 1.0
    arrays = [rng.normal(size=(A, M, D)), rng.normal(size=(A, nn)), cf,
              [w.astype(dtype) for w in flat], rng.normal(size=(A, M, D)),
              rng.normal(size=(A, nn))]
    return [a if isinstance(a, list) else a.astype(dtype) for a in arrays]


def _jax_split(flat, expanded):
    return jfl._unflatten_gnn_weights([jnp.asarray(w) for w in flat], L, expanded)


def _torch_split(flat, expanded):
    return tgb.unflatten_gnn_weights([torch.from_numpy(w) for w in flat], L, expanded)


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b**2)) or 1.0)


@EXPANDED
def test_block_math_matches_jax(expanded):
    edges, node, cf, flat, g_edge, g_node = _case(np.float64, expanded, seed=0)
    j_lw, j_cw = _jax_split(flat, expanded)
    t_lw, t_cw = _torch_split(flat, expanded)
    jx = [jnp.asarray(a) for a in (edges, node, cf)]
    tx = [torch.from_numpy(a) for a in (edges, node, cf)]

    j_out = jfl._gnn_block_math(*jx, j_lw, j_cw, H, SCALE, expanded)
    t_out = tgb.gnn_block_math(*tx, t_lw, t_cw, H, SCALE, expanded)
    for t, j in zip(t_out, j_out):
        assert t.shape == j.shape and rel(t, j) < 1e-12
    assert (t_out[0][:, M - 1] == 0).all()

    def j_fn(e, n, c, *ws):
        lw, cw = jfl._unflatten_gnn_weights(list(ws), L, expanded)
        return jfl._gnn_block_math(e, n, c, lw, cw, H, SCALE, expanded)

    _, vjp = jax.vjp(j_fn, *jx, *(jnp.asarray(w) for w in flat))
    j_auto = vjp((jnp.asarray(g_edge), jnp.asarray(g_node)))
    tg = (torch.from_numpy(g_edge), torch.from_numpy(g_node))
    for weight_grads in (False, True):
        j_hand = jfl._gnn_block_bwd_math(*jx, j_lw, j_cw, jnp.asarray(g_edge), jnp.asarray(g_node),
                                         H, SCALE, weight_grads, expanded)
        t_bwd = tgb.gnn_block_bwd_math(*tx, t_lw, t_cw, *tg, H, SCALE, expanded, weight_grads)
        assert len(t_bwd) == (4 if weight_grads else 3)
        for i, (t, jh, ja) in enumerate(zip(t_bwd[:3], j_hand[:3], j_auto[:3])):
            assert t.dtype == torch.float64
            assert rel(t, ja) < 1e-12, i
            assert rel(t, jh) < (JAX_F32 if i == 2 else 1e-12), i
        if weight_grads:
            dws, dcs = j_hand[3]
            j_flat = jfl._flatten_gnn_weights(dws, dcs if expanded else (), expanded)
            assert len(t_bwd[3]) == len(flat) == len(j_flat)
            for i, (t, jh, ja) in enumerate(zip(t_bwd[3], j_flat, j_auto[3:])):
                assert t.shape == flat[i].shape and t.dtype == torch.float64, i
                assert rel(t, ja) < 1e-12, i
                assert rel(t, jh) < JAX_F32, i


@EXPANDED
def test_fused_gnn_block_matches_jax_float32(expanded):
    """Values and first-order gradients of the port's Function against the
    JAX block (Pallas kernels in interpret mode)."""
    edges, node, cf, flat, _, _ = _case(np.float32, expanded, seed=1)

    def j_loss(e, n, c, ws):
        eo, no = jfl.fused_gnn_block(e, n, c, tuple(ws), H, SCALE, L, expanded)
        return jnp.sum(jnp.sin(eo)) + jnp.sum(jnp.cos(no)), (eo, no)

    j_args = (jnp.asarray(edges), jnp.asarray(node), jnp.asarray(cf),
              [jnp.asarray(w) for w in flat])
    (_, j_out), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True)(*j_args)

    tx = [torch.from_numpy(a).requires_grad_(True) for a in (edges, node, cf)]
    tw = [torch.from_numpy(w).requires_grad_(True) for w in flat]
    eo, no = tgb.fused_gnn_block(*tx, tw, H, SCALE, L, expanded)
    for t, j in zip((eo, no), j_out):
        assert _rel_rms(t.detach(), j) < 1e-5
    grads = torch.autograd.grad(torch.sum(torch.sin(eo)) + torch.sum(torch.cos(no)), tx + tw)
    j_flat = list(j_grads[:3]) + list(j_grads[3])
    assert len(grads) == len(j_flat)
    for i, (t, j) in enumerate(zip(grads, j_flat)):
        assert t.dtype == torch.float32 and _rel_rms(t, j) < 1e-5, i


def test_grad_of_grad_matches_jax_float32():
    """Second order (training with forces), as ``test_fused_gnn.py``'s
    grad-of-grad: d/d(edges, weights) of a function of the first-order
    edge gradient; the port replays its backward in chunks of 4 atoms."""
    expanded = True
    edges, node, cf, flat, _, _ = _case(np.float32, expanded, seed=2)
    jn, jc = jnp.asarray(node), jnp.asarray(cf)

    def j_force_norm(e, ws):
        def energy(ed):
            eo, no = jfl.fused_gnn_block(ed, jn, jc, tuple(ws), H, SCALE, L, expanded)
            return jnp.sum(jnp.sin(eo)) + jnp.sum(no * no)

        f = jax.grad(energy)(e)
        return jnp.sum(f * f)

    j_g = jax.grad(j_force_norm, argnums=(0, 1))(jnp.asarray(edges),
                                                 [jnp.asarray(w) for w in flat])

    te = torch.from_numpy(edges).requires_grad_(True)
    tw = [torch.from_numpy(w).requires_grad_(True) for w in flat]
    replays = _lib.REPLAYS["gnn_block"]
    eo, no = tgb.fused_gnn_block(te, torch.from_numpy(node), torch.from_numpy(cf), tw, H, SCALE,
                                 L, expanded, chunk=CHUNK)
    (f,) = torch.autograd.grad(torch.sum(torch.sin(eo)) + torch.sum(no * no), te,
                               create_graph=True)
    grads = torch.autograd.grad(torch.sum(f * f), [te] + tw)
    assert _lib.REPLAYS["gnn_block"] == replays + 1
    for i, (t, j) in enumerate(zip(grads, [j_g[0]] + list(j_g[1]))):
        assert _rel_rms(t, j) < 1e-5, i


HYPERS = {"cutoff": 4.5, "d_pet": 32, "d_head": 32, "d_node": 48, "d_feedforward": 32,
          "num_heads": 4, "num_gnn_layers": 2, "num_attention_layers": 2}
TRAIN_LOSS = {"energy": {"type": "mse", "weight": 1.0,
                         "gradients": {"positions": {"weight": 10.0}}}}
NODE_WIDTHS = pytest.mark.parametrize("d_node", [48, 32], ids=["expanded", "plain-node"])


def _infos(types):
    jax_info = JaxDatasetInfo("angstrom", types, {"energy": jax_energy_info("eV", True, True)})
    info = DatasetInfo("angstrom", types, {"energy": get_energy_target_info("eV", True, True)})
    return jax_info, info


def _random_pet(hypers, info, dtype, fused_gnn, seed=0):
    port = PET(hypers, info, compute_dtype=dtype, fused_gnn=fused_gnn)
    port.init_weights(torch.Generator().manual_seed(seed))
    params = flax_tree(port.module)
    port.module.load_state_dict(flax_to_state_dict(params))
    return port, params


@NODE_WIDTHS
@pytest.mark.parametrize("system", [make_molecule(), make_crystal()], ids=["molecule", "crystal"])
def test_pet_fused_gnn_float64_matches_jax(system, d_node):
    hypers = {**HYPERS, "d_node": d_node}
    types = sorted({int(t) for t in system.types})
    jax_info, info = _infos(types)
    port, params = _random_pet(hypers, info, torch.float64, fused_gnn=True)
    assert port.module.backbone.gnn_layer_0.fused_gnn
    jax_model = JaxPET(hypers, jax_info, compute_dtype=jnp.float64)
    jax_batch, batch = neighbors_and_batches(system, port.cutoff)
    expected = jax_energy_forces_virial(jax_model, params, jax_batch, dict(jax_info.targets))
    replays = _lib.REPLAYS["gnn_block"]
    got = port_energy_forces_virial(port, batch, dict(info.targets))
    assert _lib.REPLAYS["gnn_block"] == replays  # a force call needs no second order
    for g, e in zip(got, expected):
        assert g.shape == e.shape and rel(g, e) < 1e-10
    assert np.abs(expected[1]).max() > 0 and np.abs(expected[2]).max() > 0


def _float32_batches(system, cutoff):
    port_system = System(system.positions, system.types, system.cell, system.pbc)
    nbr = compute_neighbor_data(port_system, cutoff)
    jax_nbr = JaxNeighborData(nbr.indices, nbr.shifts, nbr.mask, nbr.reverse)
    return (jax_batch_from_systems([system], [jax_nbr], dtype=jnp.float32),
            batch_from_systems([port_system], [nbr], torch.device("cpu"), dtype=torch.float32))


@NODE_WIDTHS
def test_pet_fused_gnn_float32_matches_jax_block(monkeypatch, d_node):
    """Energy and forces of PET with ``fused_gnn=True`` against the JAX PET
    with its block forced on (``MTT_FUSED_GNN=force``; interpret mode), and
    the flat weights the port gathers against the ones the JAX module
    hands its block (``_flatten_gnn_weights`` of ``_FusedLayerParams``)."""
    hypers = {**HYPERS, "d_node": d_node}
    system = make_molecule(n_atoms=8, seed=3)
    types = sorted({int(t) for t in system.types})
    jax_info, info = _infos(types)
    port, params = _random_pet(hypers, info, torch.float32, fused_gnn=True)
    jax_model = JaxPET(hypers, jax_info, compute_dtype=jnp.float32)
    jax_batch, batch = _float32_batches(system, port.cutoff)

    handed = []
    block = jfl.fused_gnn_block

    def spy(edges, node, cf, flat_w, *args):
        handed.append([np.asarray(w) for w in flat_w])
        return block(edges, node, cf, flat_w, *args)

    monkeypatch.setenv("MTT_FUSED_GNN", "force")
    with monkeypatch.context() as m:
        m.setattr(jfl, "fused_gnn_block", spy)
        jax_model.forward(jax.tree.map(jnp.asarray, params), jax_batch, ["energy"])
    assert len(handed) == HYPERS["num_gnn_layers"]
    for i, flat_j in enumerate(handed):
        cfm = getattr(port.module.backbone, f"gnn_layer_{i}")
        layers = [getattr(cfm, f"layer_{k}") for k in range(HYPERS["num_attention_layers"])]
        lws, cws = zip(*(layer.gnn_weights() for layer in layers))
        flat_t = tgb.flatten_gnn_weights(lws, cws, d_node != HYPERS["d_pet"])
        assert len(flat_t) == len(flat_j)
        for t, j in zip(flat_t, flat_j):
            assert t.shape == j.shape
            np.testing.assert_array_equal(t.detach().numpy(), j)

    expected = jax_energy_forces_virial(jax_model, params, jax_batch, dict(jax_info.targets))
    got = port_energy_forces_virial(port, batch, dict(info.targets))
    for g, e in zip(got[:2], expected[:2]):
        assert rel(g, e) < 1e-5


def test_training_step_with_the_block_matches_per_layer(tmp_path):
    """One training step (energy + forces loss, a second derivative) in
    float64: PET with ``fused_gnn=True`` (the block's Function and its
    replay) against the port's per-layer path, same weights."""
    systems = _frames(2)
    labels = [lennard_jones(sy) for sy in systems]
    path = str(tmp_path / "cu.xyz")
    write_xyz(path, systems, per_atom_arrays=[{"forces": f} for _, f in labels],
              info=[{"energy": e} for e, _ in labels])
    section = {"systems": {"read_from": path, "length_unit": "angstrom"},
               "targets": {"energy": {"key": "energy", "unit": "eV", "forces": "on"}}}
    data, infos = tdataset.get_dataset(tconfig.expand_dataset_config(section))
    info = tdataset.get_dataset_info([data], infos, "angstrom")
    batch = tcollate.CollateFn(4.5, infos, dtype=torch.float64)([data[0], data[1]])
    hypers = {**HYPERS, "num_gnn_layers": 1}
    losses, grads = {}, {}
    for fused_gnn in (False, True):
        port, _ = _random_pet(hypers, info, torch.float64, fused_gnn=fused_gnn, seed=4)
        replays = _lib.REPLAYS["gnn_block"]
        loss, _ = ttrainer._compute_loss_and_errors(
            port, tloss.LossAggregator(infos, TRAIN_LOSS), infos, [],
            {"energy": [torch.ones(1, dtype=torch.float64)]}, batch, is_training=True)
        grads[fused_gnn] = torch.autograd.grad(loss, list(port.module.parameters()))
        losses[fused_gnn] = float(loss.detach())
        assert _lib.REPLAYS["gnn_block"] == replays + fused_gnn
    assert abs(losses[True] - losses[False]) <= 1e-10 * abs(losses[False])
    for a, b in zip(grads[True], grads[False]):
        if b.abs().max() == 0:
            assert a.abs().max() == 0
        else:
            assert rel(a, b) < 1e-10


def test_cuda_wrappers_reject_cpu_tensors_and_bad_shapes():
    edges, node, cf, flat, g_edge, g_node = _case(np.float32, True, seed=7)
    args = [torch.from_numpy(a) for a in (edges, node, cf)]
    w = [torch.from_numpy(a) for a in flat]
    with pytest.raises(ValueError, match="cuda"):
        tgb.gnn_block_fwd_cuda(*args, w, H, SCALE, L, True)
    for weight_grads in (False, True):
        with pytest.raises(ValueError, match="cuda"):
            tgb.gnn_block_bwd_cuda(*args, w, torch.from_numpy(g_edge), torch.from_numpy(g_node),
                                   H, SCALE, L, True, weight_grads)
    with pytest.raises(ValueError, match="M % 16"):
        tgb.gnn_block_fwd_cuda(args[0][:, :12], args[1], args[2][:, :12], w, H, SCALE, L, True)
    with pytest.raises(ValueError, match="do not fit"):
        tgb.gnn_block_fwd_cuda(args[0], args[1][:, :D], args[2], w, H, SCALE, L, True)
