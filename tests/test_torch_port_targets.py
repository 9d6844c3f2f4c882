"""Port parity: generic targets on PET against the JAX package.

float64 on the CPU, a tiny PET (2 GNN x 1 attention layer, narrow widths)
and numpy-seeded systems (a Cu crystal, an H/C/O molecule and padded atoms
and systems in one batch):

- ``TargetInfo`` of every layout (scalar, per-atom, several properties,
  Cartesian rank 1 and 2, spherical irreps, the product form and the
  atomic-basis dict) classifies and serialises as JAX's, and its dict
  round-trips, to and from the JAX package's;
- the extended-xyz reader of generic targets (``info`` fields and per-atom
  arrays) and the collate give JAX's TensorMaps; an atomic-basis block
  keeps the atoms of its type;
- ``forward`` and ``forward_eval`` (scaler, then composition) of every
  target type, with a multi-property target's position gradients, to
  1e-12; the aux outputs (``features``, last-layer features), a selection
  of atoms and ``mtt::aux::cutoff_stats`` (uniform and adaptive);
- the composition and scaler fits over generic targets;
- a checkpoint and an ``.mtt`` envelope with generic targets, read both
  ways, give the same predictions;
- one ``train_model`` epoch on generic targets (per-target losses of
  several kinds, O3 augmentation of Cartesian and spherical targets)
  logs JAX's losses and metrics and ends at JAX's weights.
"""

import copy
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import flax_tree
from conftest import make_crystal, make_molecule
from metatrain_tpu.containers import Labels as JaxLabels
from metatrain_tpu.containers import NeighborData as JaxNeighborData
from metatrain_tpu.containers import batch_from_systems as jax_batch_from_systems
from metatrain_tpu.data import collate as jcollate
from metatrain_tpu.data import dataset as jdataset
from metatrain_tpu.data import target_info as jti
from metatrain_tpu.engine import trainer as jtrainer
from metatrain_tpu.engine.evaluate import evaluate_model as jax_evaluate_model
from metatrain_tpu.models import composition as jcomposition
from metatrain_tpu.models import nn_base as jnn_base
from metatrain_tpu.models import scaler as jscaler
from metatrain_tpu.models.pet import PET as JaxPET
from metatrain_tpu.utils import config as jconfig
from metatrain_tpu.utils import io as jio
from metatrain_tpu_torch.cli.export import export_model_object
from metatrain_tpu_torch.cli.train import train_model
from metatrain_tpu_torch.containers import Labels, System, batch_from_systems
from metatrain_tpu_torch.data import collate as tcollate
from metatrain_tpu_torch.data import dataset as tdataset
from metatrain_tpu_torch.data import target_info as tti
from metatrain_tpu_torch.data.readers.extxyz import write_xyz
from metatrain_tpu_torch.engine import trainer as ttrainer
from metatrain_tpu_torch.engine.evaluate import evaluate_model
from metatrain_tpu_torch.interop.jax_params import (
    flax_to_state_dict,
    load_checkpoint_file,
    pet_from_checkpoint,
    state_dict_to_flax,
)
from metatrain_tpu_torch.models import composition as tcomposition
from metatrain_tpu_torch.models import nn_base as tnn_base
from metatrain_tpu_torch.models import scaler as tscaler
from metatrain_tpu_torch.models.pet import PET
from metatrain_tpu_torch.ops.inference import no_param_grads
from metatrain_tpu_torch.ops.neighbors import compute_neighbor_data
from metatrain_tpu_torch.utils import config as tconfig
from metatrain_tpu_torch.utils import io as tio

CUTOFF = 4.5
SMALL = {"cutoff": CUTOFF, "d_pet": 16, "d_head": 16, "d_node": 24, "d_feedforward": 16,
         "num_heads": 2, "num_gnn_layers": 2, "num_attention_layers": 1}
TYPES = [1, 6, 8, 29]
BASIS = {1: [{"o3_lambda": 0, "o3_sigma": 1, "num": 2}],
         6: [{"o3_lambda": 0, "o3_sigma": 1}, {"o3_lambda": 1, "o3_sigma": 1}],
         8: [{"o3_lambda": 1, "o3_sigma": -1}],
         29: [{"o3_lambda": 0, "o3_sigma": 1}, {"o3_lambda": 2, "o3_sigma": 1}]}
IRREPS = [{"o3_lambda": 0, "o3_sigma": 1}, {"o3_lambda": 2, "o3_sigma": 1}]
PAIR_IRREPS = [{"o3_lambda": 0, "o3_sigma": 1}, {"o3_lambda": 1, "o3_sigma": -1}]
# name -> (factory arguments, with a positions gradient)
LAYOUTS = {
    "scalar": (("scalar",), {}),
    "per_atom_scalar": (("scalar",), {"per_atom": True, "num_properties": 2}),
    "ensemble": (("scalar",), {"num_properties": 3, "quantity": "energy", "unit": "eV"}),
    "cartesian_1": (("cartesian",), {"rank": 1}),
    "cartesian_2_atom": (("cartesian",), {"rank": 2, "per_atom": True, "num_properties": 2}),
    "spherical": (("spherical",), {"irreps": IRREPS}),
    "spherical_atom": (("spherical",), {"irreps": IRREPS, "per_atom": True}),
    "invariant_spherical": (("spherical",), {"irreps": IRREPS[:1], "num_properties": 2}),
    "product": (("spherical",), {"irreps": PAIR_IRREPS, "product": "cartesian"}),
    "atomic_basis": (("spherical",), {"irreps": BASIS, "per_atom": True}),
    "atomic_basis_product": (("spherical",), {"irreps": {1: PAIR_IRREPS[:1], 8: PAIR_IRREPS},
                                              "per_atom": True, "product": "cartesian"}),
    "non_conservative_stress": (("cartesian",), {"rank": 2}),
}
MODEL_TARGETS = ["scalar", "per_atom_scalar", "ensemble", "cartesian_1", "cartesian_2_atom",
                 "spherical", "invariant_spherical", "product", "atomic_basis",
                 "non_conservative_stress"]


def _info(pkg, name):
    args, kwargs = LAYOUTS[name]
    info = pkg.get_generic_target_info(*args, **kwargs)
    if name == "ensemble":  # per-member position gradients (the LLPR ensemble's layout)
        block = info.layout.block(0)
        labels = Labels if pkg is tti else JaxLabels
        block.add_gradient("positions", pkg._empty_block(
            ["sample", "system", "atom"], [labels(["xyz"], np.arange(3).reshape(-1, 1))],
            block.properties))
    return info


def _dataset_infos(names=MODEL_TARGETS, energy=True):
    """The JAX and the port DatasetInfo of ``names`` (and an energy with
    forces and virial)."""
    out = []
    for pkg in (jti, tti):
        targets = {f"mtt::{n}" if n != "non_conservative_stress" else n: _info(pkg, n)
                   for n in names}
        if energy:
            targets["energy"] = pkg.get_energy_target_info("eV", True, True)
        out.append(pkg.DatasetInfo("angstrom", TYPES, targets))
    return out


def _dict(info):
    return jti._target_info_to_dict(info) if isinstance(info, jti.TargetInfo) \
        else tti._target_info_to_dict(info)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_target_info_matches_jax(name):
    theirs, ours = _info(jti, name), _info(tti, name)
    for flag in ("is_scalar", "is_cartesian", "is_spherical", "is_atomic_basis", "sample_kind",
                 "per_atom", "rank", "gradients"):
        assert getattr(ours, flag) == getattr(theirs, flag), flag
    assert _dict(ours) == _dict(theirs)
    assert tti._target_info_from_dict(_dict(theirs)) == ours
    assert jti._target_info_from_dict(_dict(ours)) == theirs
    j_info, t_info = _dataset_infos([name])
    assert tti.DatasetInfo.from_dict(j_info.to_dict()) == t_info
    assert jti.DatasetInfo.from_dict(t_info.to_dict()) == j_info


# ---- the reader and the collate ------------------------------------------------------------

# target name -> (its config's type, per_atom, num_subtargets, values per sample)
READ = {
    "mtt::charges": ("scalar", True, 1, 1),
    "mtt::ensemble": ("scalar", False, 3, 3),
    "mtt::dipole": ({"cartesian": {"rank": 1}}, False, 1, 3),
    "mtt::stress2": ({"cartesian": {"rank": 2}}, True, 2, 18),
    "mtt::polar": ({"spherical": {"irreps": IRREPS}}, False, 1, 6),
    "mtt::polar_atom": ({"spherical": {"irreps": IRREPS}}, True, 2, 12),
}


def _systems():
    crystal = make_crystal(n_cells=2, seed=2, jitter=0.1)
    molecule = make_molecule(n_atoms=8, seed=3)
    return [crystal, molecule]


@pytest.fixture(scope="module")
def generic_frames(tmp_path_factory):
    """Four frames (two crystals, two molecules) with every target of
    ``READ`` from a seeded generator."""
    rng = np.random.default_rng(7)
    systems = [make_crystal(n_cells=2, seed=i, jitter=0.1) for i in range(2)]
    systems += [make_molecule(n_atoms=6 + i, seed=10 + i) for i in range(2)]
    systems = [System(s.positions, s.types, s.cell, s.pbc) for s in systems]
    info, arrays = [], []
    for s in systems:
        i, a = {"energy": float(rng.normal())}, {"forces": rng.normal(size=(len(s), 3))}
        for name, (_, per_atom, _, width) in READ.items():
            if per_atom:
                a[_key(name)] = rng.normal(size=(len(s), width))
            else:
                i[_key(name)] = rng.normal(size=width) if width > 1 else float(rng.normal())
        info.append(i)
        arrays.append(a)
    path = str(tmp_path_factory.mktemp("generic") / "frames.xyz")
    write_xyz(path, systems, per_atom_arrays=arrays, info=info)
    return path


def _key(name):
    """The file's column or info key of a target (extxyz keys hold no ':')."""
    return name.removeprefix("mtt::")


def _read_conf(path, names=tuple(READ)):
    targets = {"energy": {"key": "energy", "unit": "eV", "forces": "on"}}
    for name in names:
        kind, per_atom, n, _ = READ[name]
        targets[name] = {"key": _key(name), "type": kind, "per_atom": per_atom, "num_subtargets": n}
    return {"systems": {"read_from": path, "length_unit": "angstrom"}, "targets": targets}


def _host(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_labels(a, b):
    return a.names == b.names and np.array_equal(_host(a.values), _host(b.values))


def _assert_maps_equal(ours, theirs):
    assert _same_labels(ours.keys, theirs.keys)
    for ob, tb in zip(ours.blocks(), theirs.blocks()):
        assert _same_labels(ob.samples, tb.samples) and _same_labels(ob.properties, tb.properties)
        assert len(ob.components) == len(tb.components)
        assert all(_same_labels(a, b) for a, b in zip(ob.components, tb.components))
        np.testing.assert_array_equal(_host(ob.values), _host(tb.values))
        if tb.mask is not None:
            np.testing.assert_array_equal(_host(ob.mask), _host(tb.mask))


def test_reader_and_collate_match_jax(generic_frames):
    conf = _read_conf(generic_frames)
    t_data, t_infos = tdataset.get_dataset(tconfig.expand_dataset_config(conf))
    j_data, j_infos = jdataset.get_dataset(jconfig.expand_dataset_config(conf))
    assert sorted(t_infos) == sorted(j_infos)
    for name in READ:
        assert _dict(t_infos[name]) == _dict(j_infos[name])
        for i in range(len(j_data)):
            _assert_maps_equal(t_data[i].targets[name], j_data[i].targets[name])
    t_batch = tcollate.CollateFn(CUTOFF, t_infos, dtype=torch.float64)([t_data[i]
                                                                         for i in range(4)])
    j_batch = jcollate.CollateFn(CUTOFF, j_infos, dtype=jnp.float64)([j_data[i]
                                                                       for i in range(4)])
    for name in READ:
        _assert_maps_equal(t_batch.targets[name], j_batch.targets[name])
    stats = tdataset.get_stats(t_data, tdataset.get_dataset_info([t_data], t_infos, "angstrom"))
    assert "mtt::polar" in stats


def test_atomic_basis_reader_keeps_the_atoms_of_each_type(tmp_path):
    """An atomic-basis block holds the atoms of its type (the JAX reader
    keeps every atom in every block); the collate scatters them to their
    slots and masks the rest."""
    systems = [System(s.positions, s.types, s.cell, s.pbc) for s in _systems()]
    info = tti.get_generic_target_info("spherical", irreps=BASIS, per_atom=True)
    width = sum(int(np.prod([len(c) for c in b.components])) * len(b.properties)
                for b in info.layout.blocks())
    rng = np.random.default_rng(0)
    values = [rng.normal(size=(len(s), width)) for s in systems]
    path = str(tmp_path / "basis.xyz")
    write_xyz(path, systems, per_atom_arrays=[{"basis": v} for v in values])
    conf = {"systems": {"read_from": path, "length_unit": "angstrom"},
            "targets": {"basis": {"key": "basis", "type": {"spherical": {"irreps": BASIS}},
                                  "per_atom": True}}}
    data, infos = tdataset.get_dataset(tconfig.expand_dataset_config(conf))
    assert infos["basis"] == info
    batch = tcollate.CollateFn(CUTOFF, infos, dtype=torch.float64)([data[0], data[1]])
    types = np.concatenate([s.types for s in systems])
    offset = 0
    for (lam, sigma, z), block in zip(info.layout.keys.as_tuples(), info.layout.blocks()):
        size = (2 * lam + 1) * len(block.properties)
        tmap = batch.targets["basis"]
        batched = tmap.block(o3_lambda=lam, o3_sigma=sigma, atom_type=z)
        mask = batched.mask.numpy()
        np.testing.assert_array_equal(mask[: len(types)], types == z)
        assert not mask[len(types):].any()
        expected = np.concatenate(values)[types == z, offset:offset + size]
        # the file keeps 10 decimal places
        np.testing.assert_allclose(batched.values.numpy()[mask].reshape(len(expected), -1),
                                   expected, rtol=0, atol=1e-10)
        offset += size


# ---- the model -----------------------------------------------------------------------------


def _batches(systems):
    port = [System(s.positions, s.types, s.cell, s.pbc) for s in systems]
    nbrs = [compute_neighbor_data(s, CUTOFF) for s in port]
    j = jax_batch_from_systems(
        systems, [JaxNeighborData(n.indices, n.shifts, n.mask, n.reverse) for n in nbrs],
        dtype=jnp.float64)
    b = batch_from_systems(port, nbrs, torch.device("cpu"), dtype=torch.float64)
    assert b.n_systems_padded > len(systems) and b.n_atoms_padded > sum(map(len, systems))
    return j, b


def _baselines(model_pair, infos, seed=4):
    """The same random composition weights and scales (per block, per
    type and per property) in the JAX and the port model."""
    rng = np.random.default_rng(seed)
    jax_model, port = model_pair
    for name in infos.targets:
        if name in port.composition.weights:
            w = rng.normal(size=port.composition.weights[name].shape)
            port.composition.weights[name] = w
            jax_model.composition.weights[name] = w.copy()
        scales = [rng.uniform(0.5, 2.0, size=s.shape) for s in port.scaler.scales[name]]
        port.scaler.scales[name] = scales
        jax_model.scaler.scales[name] = [s.copy() for s in scales]


def _models(hypers=None, names=MODEL_TARGETS, baselines=True, **options):
    j_info, t_info = _dataset_infos(names)
    hypers = {**SMALL, **(hypers or {})}
    port = PET(hypers, t_info, compute_dtype=torch.float64, **options)
    port.init_weights(torch.Generator().manual_seed(0))
    params = flax_tree(port.module)
    jax_model = JaxPET(hypers, j_info, compute_dtype=jnp.float64)
    if baselines:
        _baselines((jax_model, port), t_info)
    return jax_model, port, params, j_info, t_info


def _flat_maps(maps, host=_host):
    """``{output/block/field: array}`` of a dict of TensorMaps (JAX arrays
    as they are, inside a trace)."""
    out = {}
    for name, tmap in maps.items():
        for b, block in enumerate(tmap.blocks()):
            out[f"{name}/{b}/values"] = host(block.values)
            if block.mask is not None:
                out[f"{name}/{b}/mask"] = host(block.mask)
            for gname, grad in block.gradients():
                out[f"{name}/{b}/{gname}"] = host(grad.values)
    return out


def _traced(x):
    return x


def _compare(ours, theirs, bound):
    assert sorted(ours) == sorted(theirs)
    for key, expected in theirs.items():
        got = ours[key]
        assert got.shape == expected.shape, key
        if expected.dtype == bool:
            np.testing.assert_array_equal(got, expected, err_msg=key)
            continue
        scale = max(np.abs(expected).max(), 1e-300)
        assert np.abs(got - expected).max() <= bound * scale, key


def _predict_both(jax_model, port, params, j_info, t_info, method="forward_eval", outputs=None,
                  selected=None):
    """Every target with its gradients through both engines, or the plain
    forward of ``outputs`` (aux outputs included)."""
    j_batch, batch = _batches(_systems())
    if outputs is None:
        def run(p, b, sel):
            return _flat_maps(jax_evaluate_model(getattr(jax_model, method), p, b,
                                                 dict(j_info.targets), is_training=False,
                                                 selected_atoms=sel), _traced)

        j_sel = None if selected is None else jnn_base.selection_mask(j_batch, selected)
        theirs = jax.jit(run)(params, j_batch, j_sel)
        sel = None if selected is None else tnn_base.selection_mask(batch, selected)
        with no_param_grads(port):
            ours = _flat_maps(evaluate_model(getattr(port, method), batch,
                                             dict(t_info.targets), selected_atoms=sel))
    else:
        theirs = jax.jit(lambda p, b: _flat_maps(getattr(jax_model, method)(p, b, outputs),
                                                 _traced))(params, j_batch)
        with torch.no_grad():
            ours = _flat_maps(getattr(port, method)(batch, outputs))
    theirs = {k: np.asarray(v) for k, v in theirs.items()}
    key = "mtt::invariant_spherical/0/values"
    if method == "forward_eval" and key in theirs:
        # the JAX package adds the (S, P) composition of an invariant
        # spherical target to its (S, 1, P) block, which broadcasts to
        # (S, S, P): its diagonal is the sum (ROADMAP, faults in the reference)
        S = theirs[key].shape[0]
        assert theirs[key].shape == (S, S, 2)
        theirs[key] = theirs[key][np.arange(S), np.arange(S)][:, None, :]
    return ours, theirs


@pytest.mark.parametrize("method", ["forward", "forward_eval"])
def test_every_target_type_matches_jax(method):
    jax_model, port, params, j_info, t_info = _models()
    ours, theirs = _predict_both(jax_model, port, params, j_info, t_info, method)
    _compare(ours, theirs, 1e-12)
    # the multi-property gradients and the volume branch acted
    assert ours["mtt::ensemble/0/positions"].shape[-1] == 3
    stress = ours["non_conservative_stress/0/values"]
    assert np.abs(stress[0]).max() > 0 and np.abs(stress[1]).max() == 0


def test_selected_atoms_match_jax():
    jax_model, port, params, j_info, t_info = _models()
    pairs = [[0, 1], [0, 5], [1, 33], [1, 36], [1, 2]]  # (system, atom slot)
    ours, theirs = _predict_both(jax_model, port, params, j_info, t_info, selected=pairs)
    _compare(ours, theirs, 1e-12)
    mask = ours["mtt::per_atom_scalar/0/mask"]
    assert mask.sum() == 4  # slot 2 is not an atom of system 1
    assert np.abs(ours["mtt::per_atom_scalar/0/values"][~mask]).max() == 0


@pytest.mark.parametrize("hypers", [
    {},
    {"num_neighbors_adaptive": 6, "adaptive_cutoff_method": "probe",
     "featurizer_type": "residual", "fused_layers": False},
], ids=["uniform", "adaptive-residual"])
def test_aux_outputs_match_jax(hypers):
    jax_model, port, params, j_info, t_info = _models(hypers, names=["scalar", "cartesian_1"])
    outputs = ["mtt::scalar", "features", "mtt::aux::mtt::cartesian_1_last_layer_features",
               "mtt::aux::cutoff_stats"]
    ours, theirs = _predict_both(jax_model, port, params, j_info, t_info, "forward", outputs)
    _compare(ours, theirs, 1e-10)
    features = ours["mtt::aux::mtt::cartesian_1_last_layer_features/0/values"]
    assert features.shape[1] == port.last_layer_feature_size
    j_batch, batch = _batches(_systems())
    with torch.no_grad():
        direct = port.last_layer_features(batch, "mtt::cartesian_1").numpy()
    np.testing.assert_array_equal(direct[batch.atom_mask.numpy()],
                                  features[batch.atom_mask.numpy()])
    cutoffs = ours["mtt::aux::cutoff_stats/0/values"][batch.atom_mask.numpy(), 0]
    if hypers:
        assert cutoffs.min() < CUTOFF - 0.1
    else:
        np.testing.assert_array_equal(cutoffs, CUTOFF)
    with pytest.raises(NotImplementedError, match="diagnostic"):
        port.forward(batch, ["mtt::feature::backbone.gnn_layer_0"])


def test_composition_and_scaler_fits_match_jax(generic_frames):
    conf = _read_conf(generic_frames)
    t_data, t_infos = tdataset.get_dataset(tconfig.expand_dataset_config(conf))
    j_data, j_infos = jdataset.get_dataset(jconfig.expand_dataset_config(conf))
    t_info = tdataset.get_dataset_info([t_data], t_infos, "angstrom")
    j_info = jdataset.get_dataset_info([j_data], j_infos, "angstrom")
    assert t_info.atomic_types == j_info.atomic_types == TYPES
    ours, theirs = tcomposition.CompositionModel(t_info), jcomposition.CompositionModel({}, j_info)
    ours.fit([t_data])
    theirs.fit([j_data])
    assert sorted(ours.weights) == sorted(theirs.weights) == [
        "energy", "mtt::charges", "mtt::ensemble"]
    for name, w in theirs.weights.items():
        np.testing.assert_allclose(ours.weights[name], w, rtol=1e-12, atol=1e-14)
    t_removed = ttrainer._RemovedView(t_data, [ours.remove_transform])
    j_removed = jtrainer._RemovedView(j_data, [theirs.remove_transform])
    t_scaler, j_scaler = tscaler.Scaler(t_info), jscaler.Scaler({}, j_info)
    t_scaler.fit([t_removed])
    j_scaler.fit([j_removed])
    for name in j_scaler.scales:
        for a, b in zip(t_scaler.scales[name], j_scaler.scales[name]):
            np.testing.assert_allclose(a, b, rtol=1e-12)
        np.testing.assert_allclose(t_scaler.per_target[name], j_scaler.per_target[name],
                                   rtol=1e-12)
    # per-type rows of the per-atom targets, per-property of the ensemble
    assert len(np.unique(t_scaler.scales["mtt::charges"][0])) == 4
    assert len(np.unique(t_scaler.scales["mtt::ensemble"][0])) == 3
    t_samples = [t_removed[i] for i in range(len(t_data))]
    j_samples = [j_removed[i] for i in range(len(j_data))]
    for t_sample, j_sample in zip(t_scaler.remove_transform(t_samples),
                                  j_scaler.remove_transform(j_samples)):
        for name in READ:
            for ob, tb in zip(t_sample.targets[name].blocks(), j_sample.targets[name].blocks()):
                np.testing.assert_allclose(_host(ob.values), _host(tb.values), rtol=1e-14)


@pytest.mark.parametrize("per_target,per_property,remove", [
    (True, True, False), (True, False, False), (False, True, False), (False, False, False),
    (True, True, True)])
def test_scaler_decompositions_match_jax(generic_frames, per_target, per_property, remove):
    """``apply_scales`` with the per-target and per-property parts of the
    scales on or off, and removing them, on a collated batch of every
    generic target (per-type rows for the per-atom ones)."""
    conf = _read_conf(generic_frames)
    t_data, t_infos = tdataset.get_dataset(tconfig.expand_dataset_config(conf))
    j_data, j_infos = jdataset.get_dataset(jconfig.expand_dataset_config(conf))
    t_scaler = tscaler.Scaler(tdataset.get_dataset_info([t_data], t_infos, "angstrom"))
    j_scaler = jscaler.Scaler({}, jdataset.get_dataset_info([j_data], j_infos, "angstrom"))
    t_scaler.fit([t_data])
    j_scaler.fit([j_data])
    t_batch = tcollate.CollateFn(CUTOFF, t_infos, dtype=torch.float64)([t_data[i] for i in range(4)])
    j_batch = jcollate.CollateFn(CUTOFF, j_infos, dtype=jnp.float64)([j_data[i] for i in range(4)])
    flags = {"remove": remove, "use_per_target_scales": per_target,
             "use_per_property_scales": per_property}
    ours = _flat_maps(t_scaler.apply_scales(t_batch.targets, t_batch.systems, **flags))
    theirs = _flat_maps(j_scaler.apply_scales(j_batch.targets, j_batch.systems, **flags))
    _compare(ours, {k: np.asarray(v) for k, v in theirs.items()}, 1e-14)


def test_scaler_maps_atomic_basis_rows_by_atom():
    """An atomic-basis block's rows take the scale of their atoms' type
    (the JAX package maps them by position)."""
    _, t_info = _dataset_infos(["atomic_basis"], energy=False)
    scaler = tscaler.Scaler(t_info)
    name = "mtt::atomic_basis"
    scaler.scales[name] = [np.arange(1, 5, dtype=float)[:, None] * np.ones(s.shape[1])
                           for s in scaler.scales[name]]
    system = make_molecule(n_atoms=8, seed=3)
    layout = t_info.targets[name].layout
    b = layout.keys.position([1, -1, 8])  # O atoms only
    oxygen = np.nonzero(system.types == 8)[0]
    blocks = [tti._empty_block(["system", "atom"], blk.components, blk.properties)
              for blk in layout.blocks()]
    values = np.ones((len(oxygen), 3, 1))
    blocks[b] = tti.TensorBlock(values, Labels(["system", "atom"], np.stack(
        [np.zeros_like(oxygen), oxygen], axis=1)), layout.blocks()[b].components,
        layout.blocks()[b].properties)
    sample = tdataset.Sample(system, {name: tti.TensorMap(layout.keys, blocks)}, {})
    out = scaler.remove_transform([sample])[0].targets[name].blocks()[b]
    np.testing.assert_array_equal(out.values, values / 3.0)  # type 8 is row 2 (scale 3)


@pytest.fixture(scope="module")
def checkpoint_reference():
    jax_model, port, params, j_info, t_info = _models()
    loaded = jio.model_from_checkpoint(port.get_checkpoint(), context="export")
    theirs_model = JaxPET(loaded.hypers, loaded.dataset_info, compute_dtype=jnp.float64)
    theirs_model.composition, theirs_model.scaler = loaded.composition, loaded.scaler
    theirs_model.params = loaded.params
    ours, theirs = _predict_both(theirs_model, port, loaded.params, loaded.dataset_info, t_info)
    _compare(ours, theirs, 1e-12)
    return port, theirs_model, ours, t_info


@pytest.mark.parametrize("form", ["checkpoint", "mtt"])
def test_generic_checkpoints_load_both_ways(form, checkpoint_reference, tmp_path):
    port, jax_model, expected, t_info = checkpoint_reference
    if form == "checkpoint":
        back = pet_from_checkpoint(jax_model.get_checkpoint(), compute_dtype=torch.float64,
                                   device="cpu")
    else:
        from metatrain_tpu.cli.export import export_model_object as jax_export

        jax_export(jax_model, None, str(tmp_path / "jax.mtt"))
        back = tio.load_model(str(tmp_path / "jax.mtt"), device="cpu",
                              compute_dtype=torch.float64)
        export_model_object(port, None, str(tmp_path / "port.mtt"))
        theirs = jio.load_model(str(tmp_path / "port.mtt"))
        assert jti.DatasetInfo.from_dict(theirs.dataset_info.to_dict()) == jax_model.dataset_info
    assert back.dataset_info == t_info
    _, batch = _batches(_systems())
    with no_param_grads(back):
        ours = _flat_maps(evaluate_model(back.forward_eval, batch, dict(t_info.targets)))
    _compare(ours, expected, 1e-12)


# ---- training ------------------------------------------------------------------------------

TRAIN_TARGETS = ("mtt::charges", "mtt::dipole", "mtt::polar", "mtt::ensemble")
TRAIN_LOSS = {
    "energy": {"type": "mse", "weight": 1.0, "gradients": {"positions": {"weight": 10.0}}},
    "mtt::charges": {"type": "huber", "delta": 0.5},
    "mtt::dipole": "mae",
    "mtt::polar": {"type": "shift_agnostic_mse", "weight": 0.5},
    "mtt::ensemble": "mse",
}


@pytest.fixture(scope="module")
def cu_generic_frames(tmp_path_factory):
    """Four single-species Cu frames with generic labels from a seeded
    generator (one species keeps clear of the JAX package's metric
    unscaling by the first type's row)."""
    rng = np.random.default_rng(5)
    systems = []
    for i in range(4):
        s = make_crystal(n_cells=2, seed=30 + i, jitter=0.1)
        systems.append(System(s.positions, np.full(len(s), 29), s.cell, s.pbc))
    info = [{"energy": float(rng.normal()), "dipole": rng.normal(size=3),
             "polar": rng.normal(size=6), "ensemble": rng.normal(size=3)} for _ in systems]
    arrays = [{"forces": rng.normal(size=(len(s), 3)), "charges": rng.normal(size=(len(s), 1))}
              for s in systems]
    path = str(tmp_path_factory.mktemp("cu_generic") / "cu.xyz")
    write_xyz(path, systems, per_atom_arrays=arrays, info=info)
    return path


def _train_options(path):
    conf = _read_conf(path, [n for n in TRAIN_TARGETS])
    return {
        "seed": 0, "base_precision": 64, "device": "cpu",
        "architecture": {"name": "pet", "model": dict(SMALL), "training": {
            "num_epochs": 1, "batch_size": 2, "learning_rate": 1e-2, "data_parallel": False,
            "loss": TRAIN_LOSS}},
        "training_set": conf, "validation_set": 0.25, "test_set": 0.0,
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def test_train_model_on_generic_targets_matches_jax(cu_generic_frames, tmp_path):
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
        options = _train_options(cu_generic_frames)
        jax_train_model(copy.deepcopy(options), output_dir=str(tmp_path / "jax"),
                        checkpoint_dir=str(tmp_path / "jax"))
        mp.setattr(PET, "init_weights", init_weights_from_jax)
        train_model(copy.deepcopy(options), output_dir=str(tmp_path / "port"),
                    checkpoint_dir=str(tmp_path / "port"))
    logs = []
    for side in ("jax", "port"):
        with open(tmp_path / side / "train.csv") as f:
            logs.append(list(csv.DictReader(f)))
    (theirs,), (ours,) = logs
    assert sorted(theirs) == sorted(ours)
    assert any("polar" in key for key in ours)
    for key in theirs:
        if key != "epoch time (s)":
            t, o = float(theirs[key]), float(ours[key])
            assert abs(o - t) <= 1e-10 * max(abs(t), 1e-300), key
    jax_ckpt = load_checkpoint_file(tmp_path / "jax" / "model.ckpt")
    port_ckpt = load_checkpoint_file(tmp_path / "port" / "model.ckpt")
    ours, theirs = _flat(port_ckpt["params"]), _flat(jax_ckpt["params"])
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        diff = np.linalg.norm(ours[key] - theirs[key])
        assert diff <= 1e-10 * max(np.linalg.norm(theirs[key]), 1e-300), key
    start = _flat(captured["params"])
    assert any(np.abs(theirs[k] - start[k]).max() > 1e-4 for k in start if "mtt__polar" in k)
    for name in TRAIN_TARGETS:
        for a, b in zip(port_ckpt["scaler"]["scales"][name], jax_ckpt["scaler"]["scales"][name]):
            np.testing.assert_allclose(a, b, rtol=1e-12)


def test_restart_and_finetune_on_generic_targets(cu_generic_frames, tmp_path):
    """``train_model`` restarts from its generic-target checkpoint (the
    trainer's epoch and the weights carried on) and finetunes it onto a
    dataset with one more target (a fresh head, the other weights kept)."""
    def options(targets, **training):
        out = _train_options(cu_generic_frames)
        out["training_set"] = _read_conf(cu_generic_frames, targets)
        out["architecture"]["training"].update(
            loss="mse", num_epochs=training.pop("num_epochs", 1), **training)
        return out

    first = tmp_path / "first"
    model, _ = train_model(options(["mtt::charges", "mtt::dipole"]), output_dir=str(first),
                           checkpoint_dir=str(first))
    ckpt = load_checkpoint_file(first / "model.ckpt")
    assert sorted(ckpt["dataset_info"]["targets"]) == ["energy", "mtt::charges", "mtt::dipole"]
    restarted = tmp_path / "restarted"
    train_model(options(["mtt::charges", "mtt::dipole"], num_epochs=2),
                output_dir=str(restarted), checkpoint_dir=str(restarted),
                restart_from=str(first / "model.ckpt"))
    again = load_checkpoint_file(restarted / "model.ckpt")
    assert again["epoch"] == 2
    finetuned = tmp_path / "finetuned"
    new, _ = train_model(options(["mtt::charges", "mtt::dipole", "mtt::polar"], finetune={
        "read_from": str(first / "model.ckpt"), "method": "full"}),
        output_dir=str(finetuned), checkpoint_dir=str(finetuned))
    assert "mtt::polar" in new.dataset_info.targets
    assert new.dataset_info.targets["mtt::polar"].is_spherical
    old = _flat(ckpt["params"])
    tuned = _flat(load_checkpoint_file(finetuned / "model.ckpt")["params"])
    assert any("mtt__polar" in key for key in tuned)
    assert set(old) < set(tuned)
