"""Port parity: the other losses, per-block metrics, the spherical
augmentation and multi-property gradients against the JAX package.

float64 on the CPU, numpy-seeded inputs:

- every loss kind (``mse``, ``mae``, ``huber``, ``shift_agnostic_mse``,
  ``gaussian_nll``, ``crps``, ``cross_entropy``) on padded blocks with NaN
  targets and an extra mask, and a kind given to ``register_loss``, through
  ``LossAggregator`` with per-target and per-gradient specs, to 1e-12;
- ``batch_errors`` with and without ``separate_blocks`` on multi-block
  targets, to 1e-12;
- the port's real spherical harmonics against ``reference_real_sph``
  (SciPy), and the Wigner D and ``_transform_block`` of every block kind
  against JAX's, to 1e-12; ``O3Augmenter`` rotates a sample as JAX's does;
- the position and strain gradients of a 4-property target (one backward
  pass per property) against JAX's vmapped backward, to 1e-10, and each
  against a call that seeds that property alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import flax_tree, neighbors_and_batches
from conftest import make_crystal, make_molecule
from metatrain_tpu.containers import Labels as JaxLabels
from metatrain_tpu.containers import TensorBlock as JaxTensorBlock
from metatrain_tpu.containers import TensorMap as JaxTensorMap
from metatrain_tpu.data import target_info as jti
from metatrain_tpu.data.dataset import Sample as JaxSample
from metatrain_tpu.engine import augmentation as jaug
from metatrain_tpu.engine import loss as jloss
from metatrain_tpu.engine import metrics as jmetrics
from metatrain_tpu.engine.evaluate import evaluate_model as jax_evaluate_model
from metatrain_tpu.models.pet import PET as JaxPET
from metatrain_tpu.ops.spherical import reference_real_sph
from metatrain_tpu_torch.containers import Labels, System, TensorBlock, TensorMap
from metatrain_tpu_torch.data import target_info as tti
from metatrain_tpu_torch.data.dataset import Sample
from metatrain_tpu_torch.engine import augmentation as taug
from metatrain_tpu_torch.engine import loss as tloss
from metatrain_tpu_torch.engine import metrics as tmetrics
from metatrain_tpu_torch.engine.evaluate import evaluate_model
from metatrain_tpu_torch.models.pet import PET
from metatrain_tpu_torch.ops.inference import no_param_grads

KINDS = {
    "mse": {}, "mae": {}, "huber": {"delta": 0.3}, "shift_agnostic_mse": {},
    "gaussian_nll": {}, "crps": {}, "cross_entropy": {},
}


def _pair(values, mask, components=(), n_props=None, sample_names=("system",)):
    """The same block as a port TensorBlock and a JAX one."""
    n_props = values.shape[-1] if n_props is None else n_props
    out = []
    for labels_cls, block_cls, conv in ((Labels, TensorBlock, torch.as_tensor),
                                        (JaxLabels, JaxTensorBlock, jnp.asarray)):
        comps = [labels_cls([n], np.arange(k).reshape(-1, 1)) for n, k in components]
        samples = labels_cls(list(sample_names),
                             np.arange(len(values) * len(sample_names)).reshape(len(values), -1))
        out.append(block_cls(conv(values), samples, comps, labels_cls.range("p", n_props),
                             conv(mask)))
    return out


def _maps(rng, P=4, with_gradient=True):
    """Two-block prediction and target maps (one block with components),
    padded rows, NaN targets, and a positions gradient on the first."""
    S = 5
    mask = np.array([True, True, True, False, True])
    keys = np.array([[0, 1], [1, 1]])
    pred = [rng.normal(size=(S, P)), rng.normal(size=(S, 3, P))]
    tgt = [rng.normal(size=(S, P)), rng.normal(size=(S, 3, P))]
    tgt[0][1, 2] = np.nan
    tgt[1][4, 0, :] = np.nan
    maps = {}
    for side, arrays in (("pred", pred), ("tgt", tgt)):
        b0 = _pair(arrays[0], mask)
        b1 = _pair(arrays[1], mask, components=[("o3_mu", 3)])
        if with_gradient:
            g = rng.normal(size=(7, 3, P))
            gmask = np.array([True] * 6 + [False])
            gp, gj = _pair(g, gmask, [("xyz", 3)], sample_names=("system", "atom"))
            b0[0].add_gradient("positions", gp)
            b0[1].add_gradient("positions", gj)
        maps[side] = (TensorMap(Labels(["o3_lambda", "o3_sigma"], keys), [b0[0], b1[0]]),
                      JaxTensorMap(JaxLabels(["o3_lambda", "o3_sigma"], keys), [b0[1], b1[1]]))
    return maps


def _infos(P=4):
    out = []
    for pkg in (tti, jti):
        info = pkg.get_generic_target_info("scalar", num_properties=P)
        out.append(info)
    return out


def _close(ours, theirs, bound=1e-12):
    ours, theirs = float(ours), float(theirs)
    assert abs(ours - theirs) <= bound * max(abs(theirs), 1e-300), (ours, theirs)


@pytest.mark.parametrize("kind", list(KINDS))
def test_loss_kinds_match_jax(kind):
    rng = np.random.default_rng(1)
    maps = _maps(rng, with_gradient=False)
    extra_p, extra_j = _pair(rng.uniform(size=(5, 4)) > 0.2, np.ones(5, bool))
    for b in range(2):
        (pp, pj), (tp, tj) = [(maps[s][0].blocks()[b], maps[s][1].blocks()[b])
                              for s in ("pred", "tgt")]
        mask_p, mask_j = (extra_p, extra_j) if b == 0 else (None, None)
        ours = tloss.block_loss_terms(kind, pp, tp, mask_p, **KINDS[kind])
        theirs = jloss.block_loss_terms(kind, pj, tj, mask_j, **KINDS[kind])
        for o, t in zip(ours, theirs):
            _close(o, t)
        assert float(theirs[1]) > 0


def test_aggregator_with_registered_kind_matches_jax():
    """Per-target and per-gradient specs over a two-block target, one term
    of a registered kind (a weighted quartic)."""
    def quartic(pred, tgt, valid, power=4):
        lib = torch if isinstance(pred, torch.Tensor) else jnp
        diff = lib.where(valid, pred - lib.nan_to_num(tgt), 0.0)
        return lib.sum(diff**power), lib.sum(valid.astype(float) if lib is jnp
                                             else valid.to(diff.dtype))

    tloss.register_loss("quartic", quartic)
    jloss.register_loss("quartic", quartic)
    rng = np.random.default_rng(2)
    maps = _maps(rng)
    spec = {"t": {"type": "crps", "weight": 0.7,
                  "gradients": {"positions": {"type": "quartic", "weight": 2.0, "power": 2}}}}
    t_info, j_info = _infos()
    for info, pkg in ((t_info, tti), (j_info, jti)):
        info.layout.block(0).add_gradient("positions", pkg._empty_block(
            ["sample", "system", "atom"], [info.layout.block(0).properties],
            info.layout.block(0).properties))
    ours = tloss.LossAggregator({"t": t_info}, spec)
    theirs = jloss.LossAggregator({"t": j_info}, spec)
    assert ours.metadata == theirs.metadata
    _close(ours({"t": maps["pred"][0]}, {"t": maps["tgt"][0]}),
           theirs({"t": maps["pred"][1]}, {"t": maps["tgt"][1]}))
    for name, term in ours.terms.items():
        _close(term.compute({"t": maps["pred"][0]}, {"t": maps["tgt"][0]}),
               theirs.terms[name].compute({"t": maps["pred"][1]}, {"t": maps["tgt"][1]}))


@pytest.mark.parametrize("separate_blocks", [False, True])
def test_batch_errors_per_block_match_jax(separate_blocks):
    rng = np.random.default_rng(3)
    maps = _maps(rng)
    ours = tmetrics.batch_errors({"t": maps["pred"][0]}, {"t": maps["tgt"][0]},
                                 separate_blocks=separate_blocks)
    theirs = jmetrics.batch_errors({"t": maps["pred"][1]}, {"t": maps["tgt"][1]},
                                   separate_blocks=separate_blocks)
    assert sorted(ours) == sorted(theirs)
    assert len(ours) == (3 if separate_blocks else 2)
    for key in theirs:
        for o, t in zip(ours[key], theirs[key]):
            _close(o, t)
    acc = tmetrics.ErrorAccumulator(separate_blocks)
    acc.update_from_errors(ours)
    jacc = jmetrics.ErrorAccumulator(separate_blocks)
    jacc.update_from_errors(theirs)
    assert acc.finalize() == pytest.approx(jacc.finalize(), rel=1e-12)


# ---- spherical harmonics and the augmentation ------------------------------------------------


def test_real_spherical_harmonics_match_scipy():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(200, 3))
    v = np.concatenate([v / np.linalg.norm(v, axis=1, keepdims=True),
                        [[0, 0, 1.0], [0, 0, -1.0], [1.0, 0, 0], [0, -1.0, 0]]])
    for ours, theirs in zip(taug.real_spherical_harmonics(v, 6), reference_real_sph(v, 6)):
        assert ours.shape == theirs.shape
        assert np.abs(ours - theirs).max() <= 1e-12


def _rotations():
    rng = np.random.default_rng(5)
    return [taug.random_rotation(rng, improper=i % 2 == 1) for i in range(4)]


@pytest.mark.parametrize("o3_lambda", [0, 1, 2, 3, 4])
def test_wigner_d_matches_jax(o3_lambda):
    for rotation in _rotations():
        ours = taug.real_wigner_d(rotation, o3_lambda)
        np.testing.assert_allclose(ours, jaug.real_wigner_d(rotation, o3_lambda), rtol=0,
                                   atol=1e-12)
        # orthogonal, and Y(R u) = D Y(u), for an improper R too (Y(-u) =
        # (-1)^l Y(u) is D's parity factor)
        np.testing.assert_allclose(ours @ ours.T, np.eye(2 * o3_lambda + 1), atol=1e-12)
        u = np.array([[0.3, -0.5, 0.8]]) / np.linalg.norm([0.3, -0.5, 0.8])
        y = taug.real_spherical_harmonics(u, o3_lambda)[o3_lambda][0]
        y_rot = taug.real_spherical_harmonics(u @ rotation.T, o3_lambda)[o3_lambda][0]
        np.testing.assert_allclose(y_rot, ours @ y, atol=1e-12)


BLOCKS = {  # components, key names, key
    "scalar": ([], ["_"], (0,)),
    "cartesian_1": ([("xyz", 3)], ["_"], (0,)),
    "cartesian_2": ([("xyz_1", 3), ("xyz_2", 3)], ["_"], (0,)),
    "spherical_2": ([("o3_mu", 5)], ["o3_lambda", "o3_sigma"], (2, 1)),
    "spherical_1_odd": ([("o3_mu", 3)], ["o3_lambda", "o3_sigma"], (1, -1)),
    "atomic_basis_3": ([("o3_mu", 7)], ["o3_lambda", "o3_sigma", "atom_type"], (3, 1, 8)),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_transform_block_matches_jax(name):
    components, key_names, key = BLOCKS[name]
    rng = np.random.default_rng(6)
    shape = (4,) + tuple(k for _, k in components) + (2,)
    values = rng.normal(size=shape)
    (port, jx) = _pair(values, np.ones(4, bool), components)
    if name == "scalar":
        g = rng.normal(size=(4, 3, 2))
        s = rng.normal(size=(4, 3, 3, 2))
        for (gp, gj), gname in ((_pair(g, np.ones(4, bool), [("xyz", 3)]), "positions"),
                                (_pair(s, np.ones(4, bool), [("xyz_1", 3), ("xyz_2", 3)]),
                                 "strain")):
            port.add_gradient(gname, gp)
            jx.add_gradient(gname, gj)
    for rotation in _rotations():
        ours = taug._transform_block(port, rotation, key, key_names)
        theirs = jaug._transform_block(jx, rotation, key, key_names)
        np.testing.assert_allclose(np.asarray(ours.values), np.asarray(theirs.values), rtol=0,
                                   atol=1e-12 * np.abs(values).max())
        for gname, grad in theirs.gradients():
            np.testing.assert_allclose(np.asarray(ours.gradient(gname).values),
                                       np.asarray(grad.values), rtol=0, atol=1e-12)


def test_product_blocks_rotate_by_both_sides():
    """The uncoupled rank-2 form (``o3_mu_1`` x ``o3_mu_2``; the JAX package
    rotates no such block): D_1 V D_2^T, each D with its own sigma."""
    rng = np.random.default_rng(7)
    values = rng.normal(size=(2, 3, 5, 1))
    block, _ = _pair(values, np.ones(2, bool), [("o3_mu_1", 3), ("o3_mu_2", 5)])
    names = ["o3_lambda_1", "o3_lambda_2", "o3_sigma_1", "o3_sigma_2"]
    for rotation in _rotations():
        out = taug._transform_block(block, rotation, (1, 2, -1, 1), names)
        # o3_sigma_1 = -1: one more sign under an inversion (det -1)
        d1 = taug.real_wigner_d(rotation, 1) * np.linalg.det(rotation)
        d2 = taug.real_wigner_d(rotation, 2)
        expected = np.einsum("mn,snkp,lk->smlp", d1, values, d2)
        np.testing.assert_allclose(out.values, expected, atol=1e-12)


def test_augmenter_rotates_as_jax():
    crystal = make_crystal(n_cells=2, seed=1, jitter=0.1)
    rng = np.random.default_rng(8)
    extra = {"momenta": rng.normal(size=(len(crystal), 3))}
    samples = []
    for labels_cls, block_cls, map_cls, sample_cls, system in (
            (Labels, TensorBlock, TensorMap, Sample,
             System(crystal.positions, crystal.types, crystal.cell, crystal.pbc, dict(extra))),
            (JaxLabels, JaxTensorBlock, JaxTensorMap, JaxSample, crystal)):
        system.extra.update(extra)
        comps = [labels_cls(["o3_mu"], np.arange(5).reshape(-1, 1))]
        block = block_cls(np.arange(10.0).reshape(1, 5, 2), labels_cls(["system"], np.zeros((1, 1))),
                          comps, labels_cls.range("p", 2))
        tmap = map_cls(labels_cls(["o3_lambda", "o3_sigma"], np.array([[2, 1]])), [block])
        samples.append(sample_cls(system, {"polar": tmap}, {}))
    ours = taug.O3Augmenter(seed=3)([samples[0]])[0]
    theirs = jaug.O3Augmenter(seed=3)([samples[1]])[0]
    np.testing.assert_allclose(ours.system.positions, theirs.system.positions, atol=1e-12)
    np.testing.assert_allclose(ours.system.extra["momenta"], theirs.system.extra["momenta"],
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(ours.targets["polar"].block(0).values),
                               np.asarray(theirs.targets["polar"].block(0).values), atol=1e-12)


# ---- multi-property gradients -----------------------------------------------------------------

SMALL = {"cutoff": 4.5, "d_pet": 16, "d_head": 16, "d_node": 24, "d_feedforward": 16,
         "num_heads": 2, "num_gnn_layers": 2, "num_attention_layers": 1}


def _ensemble_info(pkg, labels_cls, P=4):
    info = pkg.get_generic_target_info("scalar", num_properties=P, quantity="energy", unit="eV")
    block = info.layout.block(0)
    block.add_gradient("positions", pkg._empty_block(
        ["sample", "system", "atom"], [labels_cls(["xyz"], np.arange(3).reshape(-1, 1))],
        block.properties))
    block.add_gradient("strain", pkg._empty_block(
        ["sample"], [labels_cls(["xyz_1"], np.arange(3).reshape(-1, 1)),
                     labels_cls(["xyz_2"], np.arange(3).reshape(-1, 1))], block.properties))
    return info


@pytest.mark.parametrize("is_training", [False, True])
def test_multi_property_gradients_match_jax(is_training):
    t_info = tti.DatasetInfo("angstrom", [1, 6, 8], {"ens": _ensemble_info(tti, Labels)})
    j_info = jti.DatasetInfo("angstrom", [1, 6, 8], {"ens": _ensemble_info(jti, JaxLabels)})
    port = PET(SMALL, t_info, compute_dtype=torch.float64)
    port.init_weights(torch.Generator().manual_seed(2))
    params = flax_tree(port.module)
    jax_model = JaxPET(SMALL, j_info, compute_dtype=jnp.float64)
    system = make_molecule(n_atoms=9, seed=4)
    jax_batch, batch = neighbors_and_batches(system, 4.5)

    def run(p, b):
        block = jax_evaluate_model(jax_model.forward, p, b, dict(j_info.targets),
                                   is_training=False)["ens"].block(0)
        return block.gradient("positions").values, block.gradient("strain").values

    theirs = [np.asarray(x) for x in jax.jit(run)(params, jax_batch)]
    if is_training:  # the gradients carry a graph back to the weights
        block = evaluate_model(port.forward, batch, dict(t_info.targets),
                               is_training=True)["ens"].block(0)
        assert block.gradient("positions").values.requires_grad
    else:
        with no_param_grads(port):
            block = evaluate_model(port.forward, batch, dict(t_info.targets))["ens"].block(0)
    ours = [block.gradient(g).values.detach().numpy() for g in ("positions", "strain")]
    for o, t in zip(ours, theirs):
        assert o.shape == t.shape and o.shape[-1] == 4
        assert np.abs(o - t).max() <= 1e-10 * np.abs(t).max()
    # each member equals a call that seeds that member alone
    for p in range(4):
        info = tti.get_energy_target_info("eV", True, True)

        def member(b, names, p=p):
            out = port.forward(b, ["ens"])["ens"]
            blk = out.block(0)
            return {"m": TensorMap(out.keys, [TensorBlock(blk.values[:, p:p + 1], blk.samples,
                                                          [], info.layout.block(0).properties,
                                                          blk.mask)])}

        with no_param_grads(port):
            alone = evaluate_model(member, batch, {"m": info})["m"].block(0)
        assert np.abs(alone.gradient("positions").values[..., 0].numpy()
                      - ours[0][..., p]).max() <= 1e-12 * np.abs(ours[0]).max()
