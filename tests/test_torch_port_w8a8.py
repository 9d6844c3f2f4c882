"""Port parity: the static W8A8 layer (plain versions of K1-W8A8 and K2-W8A8),
its calibration and PET served with it, vs the JAX package.

The same inputs, made with numpy from a seed, go through the JAX package's
W8A8 functions (``_layer_math``/``_layer_bwd_math`` with ``w8a8``, the
interpret-mode ``fused_transformer_layer`` with a calibration, the
``MTT_INT8_CALIBRATE=1`` probe with ``calibrate_from_sow``) and through the
port's. In float32 the layer agrees to 1e-5 relative RMS (the quantized
operands in all but a few entries, which differ by one step: the
dequantization's float rounding may fall on the other side of a rounding
tie); in bfloat16 to 2e-2 (the frameworks round at the same points, and sum
in another order). PET served with W8A8 in bfloat16 stays within the JAX
package's own W8A8 bounds (``tests/test_w8a8.py``) of the exact float32
model.
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
)
from conftest import make_crystal
from metatrain_tpu.data.target_info import DatasetInfo as JaxDatasetInfo
from metatrain_tpu.data.target_info import get_energy_target_info as jax_energy_info
from metatrain_tpu.models.pet import PET as JaxPET
from metatrain_tpu.ops.inference import no_param_grads as jax_no_param_grads
from metatrain_tpu.ops.pallas import fused_layer as jfl
from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info
from metatrain_tpu_torch.interop.jax_params import int8_calib_from_jax, int8_calib_to_jax
from metatrain_tpu_torch.models.pet import PET
from metatrain_tpu_torch.ops.inference import no_param_grads
from metatrain_tpu_torch.ops.kernels import fused_layer as tfl

A, M, D, H, F = 9, 16, 128, 8, 64
SCALE = 1.0 / np.sqrt(D // H)
PET_HYPERS = {"cutoff": 4.5, "d_pet": 32, "d_head": 32, "d_node": 48, "d_feedforward": 32,
              "num_heads": 4, "num_gnn_layers": 2, "num_attention_layers": 2}


def rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.mean((a - b) ** 2) / np.mean(b**2))


def _case(seed, dtype=np.float32):
    """Weights (float32, as parameters are), inputs and cotangents in
    ``dtype``, cutoff weights ragged with the center's at 1."""
    rng = np.random.default_rng(seed)

    def lecun(i, o):
        return rng.normal(size=(i, o)) / np.sqrt(i)

    weights = [
        1 + 0.1 * rng.normal(size=D), lecun(D, 3 * D), 0.1 * rng.normal(size=3 * D),
        lecun(D, D), 0.1 * rng.normal(size=D), 1 + 0.1 * rng.normal(size=D),
        lecun(D, 2 * F), 0.1 * rng.normal(size=2 * F), lecun(F, D), 0.1 * rng.normal(size=D),
    ]
    n_real = rng.integers(M // 2, M - 1, size=(A, 1))
    cf = rng.uniform(0.05, 1.0, size=(A, M)) * (np.arange(M)[None] < n_real)
    cf[:, M - 1] = 1.0
    arrays = [rng.normal(size=s) for s in ((A, M, D), (A, D), (A, M, D), (A, D))]
    edges, center, g_edge, g_center = (x.astype(np.float32).astype(dtype) for x in arrays)
    return (edges, center, cf.astype(np.float32), [x.astype(np.float32) for x in weights],
            g_edge, g_center)


def _jax(x, dtype=None):
    return jnp.asarray(x, dtype)


def _torch(x, dtype=None):
    t = torch.from_numpy(np.asarray(x, np.float32))
    return t if dtype is None else t.to(dtype)


def _jax_calib(edges, center, cf, jw):
    """The JAX package's calibration of one layer: its probe and the weight
    absmaxes, as ``calibrate_from_sow`` forms them."""
    stats = np.asarray(jfl.layer_probe_stats(edges, center, cf, jw, H, SCALE), np.float64)
    wq = np.asarray(jw.w_qkv, np.float64)

    def am(x):
        return float(np.max(np.abs(np.asarray(x, np.float64))))

    return jfl.Int8Calib(*(float(x) for x in stats), am(wq[:, :D]), am(wq[:, D:2 * D]),
                         am(wq[:, 2 * D:]), am(jw.w_in), am(jw.w_ffn_out))


def _jax_operands(edges, center, cf, jw, calib, wi8):
    """JAX's quantized operands (normed, q, k, h_norm, ffn_h), replayed from
    the W8A8 branch of ``_layer_math`` with its own helpers."""
    f32 = jnp.float32
    cd = edges.dtype
    wc = jfl.LayerWeights(*(x.astype(cd) for x in jw))
    wq, wk, wv, w_in, _ = wi8
    tokens = edges.at[:, M - 1].set(center)
    normed = jfl._rms_norm_q(tokens, wc.norm_attn, calib.normed).reshape(A * M, D)
    b = wc.b_qkv.astype(f32)
    q_f = jfl._dot_i8(normed, wq, jfl._deq(calib.normed, calib.w_q), b[:D])
    k_f = jfl._dot_i8(normed, wk, jfl._deq(calib.normed, calib.w_k), b[D:2 * D])
    v = jfl._dot_i8(normed, wv, jfl._deq(calib.normed, calib.w_v), b[2 * D:])
    q_i8 = jfl._qs_static(q_f, calib.q).reshape(A, M, D)
    k_i8 = jfl._qs_static(k_f, calib.k).reshape(A, M, D)
    scores = jax.lax.dot_general(
        q_i8, jfl._expand_heads_i8(k_i8, H, D // H), (((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    ).astype(f32) * (jfl._deq(calib.q, calib.k) * SCALE)
    attn = jfl._qside_tail(scores, v.astype(cd).reshape(A, M, D), cf, H, f32, cd)
    res = tokens + jfl._matmul_bias(attn.reshape(A * M, D), wc.w_out, wc.b_out, cd).reshape(
        A, M, D)
    h_norm = jfl._rms_norm_q(res, wc.norm_mlp, calib.h_norm).reshape(A * M, D)
    vg = jfl._dot_i8(h_norm, w_in, jfl._deq(calib.h_norm, calib.w_in), wc.b_in.astype(f32))
    ffn_h = jfl._qs_static(vg[:, :F] * jax.nn.sigmoid(vg[:, F:]), calib.ffn_h)
    return [normed, q_i8, k_i8, h_norm, ffn_h]


def test_quantize_layer_weights_bitwise_equal_to_jax():
    edges, center, cf, w, _, _ = _case(0)
    jw = jfl.LayerWeights(*map(_jax, w))
    calib = _jax_calib(_jax(edges), _jax(center), _jax(cf), jw)
    port = tfl.quantize_layer_weights(tfl.LayerWeights(*map(_torch, w)), calib)
    for t, j in zip(port, jfl.quantize_layer_weights(jw, calib)):
        assert t.dtype == torch.int8
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # round half to even and the clamp, where x * 127 / absmax is exact
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 200.0, -300.0], np.float32)
    expected = np.asarray(jfl._qs_static(_jax(x), 127.0))
    np.testing.assert_array_equal(tfl.qs_static(_torch(x), 127.0).numpy(), expected)
    np.testing.assert_array_equal(expected, [0, 2, 2, 0, -2, 126, 127, -127])


def test_probe_stats_match_jax():
    edges, center, cf, w, _, _ = _case(1)
    j = jfl.layer_probe_stats(_jax(edges), _jax(center), _jax(cf),
                              jfl.LayerWeights(*map(_jax, w)), H, SCALE)
    t = tfl.layer_probe_stats(_torch(edges), _torch(center), _torch(cf),
                              tfl.LayerWeights(*map(_torch, w)), H, SCALE)
    assert t.dtype == torch.float32 and t.shape == (5,)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


@pytest.mark.parametrize("seed", [2, 3])
def test_w8a8_float32_matches_jax(seed):
    """Forward, straight-through backward and the quantized operands."""
    edges, center, cf, w, g_edge, g_center = _case(seed)
    jw = jfl.LayerWeights(*map(_jax, w))
    je, jc, jcf = _jax(edges), _jax(center), _jax(cf)
    calib = _jax_calib(je, jc, jcf, jw)
    jwi8 = jfl.quantize_layer_weights(jw, calib)
    tw = tfl.LayerWeights(*map(_torch, w))
    w8a8 = (tfl.Int8Calib(*calib), tfl.quantize_layer_weights(tw, calib))
    te, tc, tcf = _torch(edges), _torch(center), _torch(cf)

    j_fwd = jfl._layer_math(je, jc, jcf, jw, H, SCALE, w8a8=(calib, jwi8))
    t_fwd = tfl.layer_math(te, tc, tcf, tw, H, SCALE, w8a8=w8a8)
    for t, j in zip(t_fwd, j_fwd):
        assert rel_rms(t, j) < 1e-5
    j_bwd = jfl._layer_bwd_math(je, jc, jcf, jw, _jax(g_edge), _jax(g_center), H, SCALE,
                                weight_grads=False, w8a8=(calib, jwi8))
    t_bwd = tfl.layer_bwd_math(te, tc, tcf, tw, _torch(g_edge), _torch(g_center), H, SCALE,
                               w8a8=w8a8)
    for t, j in zip(t_bwd, j_bwd[:3]):
        assert rel_rms(t, j) < 1e-5
    assert (t_bwd[0][:, M - 1] == 0).all() and (t_fwd[0][:, M - 1] == 0).all()

    t_ops = tfl._layer_forward(te, tc, tcf, tw, H, SCALE, w8a8)[2]
    j_ops = _jax_operands(je, jc, jcf, jw, calib, jwi8)
    total = differ = 0
    for t, j in zip(t_ops, j_ops):
        diff = np.abs(t.numpy().astype(np.int32).reshape(-1) - np.asarray(j, np.int32).reshape(-1))
        assert diff.max() <= 1
        total, differ = total + diff.size, differ + int((diff > 0).sum())
    assert differ <= 1e-3 * total, f"{differ} of {total} quantized operands differ by one"


def test_w8a8_bfloat16_matches_jax_interpret_kernel():
    """The port's Function (plain versions on the CPU) vs JAX's Pallas
    kernels with a calibration in interpret mode, forward and the input
    gradients under ``no_param_grads``; both differ from the exact layer."""
    edges, center, cf, w, g_edge, g_center = _case(4, jnp.bfloat16)
    jw = jfl.LayerWeights(*map(_jax, w))
    je, jc, jcf = _jax(edges, jnp.bfloat16), _jax(center, jnp.bfloat16), _jax(cf)
    calib = _jax_calib(je, jc, jcf, jw)
    cot = (_jax(g_edge, jnp.bfloat16), _jax(g_center, jnp.bfloat16))
    with jax_no_param_grads():
        j_out, vjp = jax.vjp(
            lambda e, c, f: jfl.fused_transformer_layer(e, c, f, jw, H, SCALE, calib), je, jc, jcf)
        j_grads = vjp(cot)

    tw = tfl.LayerWeights(*map(_torch, w))
    x = [_torch(edges, torch.bfloat16).requires_grad_(True),
         _torch(center, torch.bfloat16).requires_grad_(True), _torch(cf).requires_grad_(True)]
    assert tfl.w8a8_applicable(x[0], tw, H, tfl.Int8Calib(*calib))
    t_out = tfl.w8a8_transformer_layer(*x, tw, H, SCALE, tfl.Int8Calib(*calib))
    t_grads = torch.autograd.grad(t_out, x, (_torch(g_edge, torch.bfloat16),
                                             _torch(g_center, torch.bfloat16)))
    for t, j in zip((*t_out, *t_grads), (*j_out, *j_grads)):
        assert rel_rms(t.detach().float(), np.asarray(j, np.float32)) < 2e-2
    exact = tfl.layer_math(*(t.detach() for t in x), tw, H, SCALE)
    assert rel_rms(t_out[0].detach().float(), exact[0].float()) > 1e-3


def _pet_setup(dtype=torch.float32, **kwargs):
    system = make_crystal()
    jax_info = JaxDatasetInfo("angstrom", [29], {"energy": jax_energy_info("eV", True, True)})
    info = DatasetInfo("angstrom", [29], {"energy": get_energy_target_info("eV", True, True)})
    seed_model = PET(PET_HYPERS, info)
    seed_model.init_weights(torch.Generator().manual_seed(0))
    state = seed_model.module.state_dict()

    def port(dtype, **kw):
        model = PET(PET_HYPERS, info, compute_dtype=dtype, **kw)
        model.module.load_state_dict(state)
        return model

    jax_batch, batch = neighbors_and_batches(system, seed_model.cutoff)
    return port, flax_tree(seed_model.module), jax_info, info, jax_batch, batch


def test_calibrate_int8_matches_jax_sow(monkeypatch):
    """``PET.calibrate_int8`` gives each layer the calibration of JAX's
    probe run with ``calibrate_from_sow``; carried across with
    ``int8_calib_from_jax``, both serve the same energies and forces."""
    port, params, jax_info, info, jax_batch, batch = _pet_setup()
    jax_model = JaxPET(PET_HYPERS, jax_info, compute_dtype=jnp.float32)
    monkeypatch.setenv("MTT_INT8_CALIBRATE", "1")
    _, state = jax_model.module.apply(params, jax_model.preprocess(jax_batch), ("energy",),
                                      mutable=["intermediates"])
    monkeypatch.delenv("MTT_INT8_CALIBRATE")
    jfl.clear_int8_calib()
    try:
        n_jax = jfl.calibrate_from_sow(jax.device_get(state["intermediates"]),
                                       jax.device_get(params["params"]))
        registry = dict(jfl._INT8_CALIB)
    finally:
        jfl.clear_int8_calib()

    model = port(torch.float32)
    assert model.calibrate_int8(batch) == n_jax == 4
    ported = int8_calib_to_jax(model)
    assert sorted(ported) == sorted(registry)
    for key, calib in registry.items():
        np.testing.assert_allclose(ported[key], tuple(calib), rtol=1e-5, err_msg=key)

    # both calibrations serve the same energies; the forces move by a few
    # 1e-3 when a scale moves by one float32 step, since quantized values
    # on a rounding boundary flip (the W8A8 forces are 1e-2 off the exact
    # bfloat16 ones at these weights)
    results = []
    for calibs in (registry, ported):
        served = port(torch.bfloat16, int8_static=True)
        assert int8_calib_from_jax(served, calibs) == 4
        assert int8_calib_to_jax(served) == {k: tuple(v) for k, v in calibs.items()}
        results.append(port_energy_forces_virial(served, batch, dict(info.targets)))
    (e_jax, f_jax, _), (e_port, f_port, _) = results
    assert rel_rms(e_port, e_jax) < 1e-4
    assert rel_rms(f_port, f_jax) < 2e-2


def test_pet_w8a8_bfloat16_close_to_exact_float32_jax():
    """The port's bfloat16 W8A8 PET on the CPU against the exact float32 JAX
    model: energy within 5 %, forces within 8 % (the JAX package's W8A8
    bounds), and not the exact bfloat16 result."""
    port, params, jax_info, info, jax_batch, batch = _pet_setup()
    jax_model = JaxPET(PET_HYPERS, jax_info, compute_dtype=jnp.float32)
    e_ref, f_ref, _ = jax_energy_forces_virial(jax_model, params, jax_batch,
                                               dict(jax_info.targets))
    served = port(torch.bfloat16, int8_static=True)
    assert served.calibrate_int8(batch) == 4
    e, f, v = port_energy_forces_virial(served, batch, dict(info.targets))
    assert np.isfinite(e).all() and np.isfinite(f).all() and np.isfinite(v).all()
    n = int(batch.atom_mask.sum())
    assert abs(e[0, 0] - e_ref[0, 0]) < 0.05 * abs(e_ref[0, 0])
    assert rel_rms(f[:n], f_ref[:n]) < 0.08
    e16, f16, _ = port_energy_forces_virial(port(torch.bfloat16), batch, dict(info.targets))
    assert rel_rms(f[:n], f16[:n]) > 1e-3


@pytest.mark.parametrize("case", ["uncalibrated", "weight_grads", "float32", "fused_gnn"])
def test_w8a8_gates(case):
    """JAX's gate: no calibration raises; a weight that requires grad and
    float32 compute run the exact layer; the GNN block ignores int8."""
    port, _, _, info, _, batch = _pet_setup()
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    kw = {"fused_gnn": True} if case == "fused_gnn" else {}
    served = port(dtype, int8_static=True, **kw)
    exact = port(dtype, **kw)

    def energy(model):
        return model.forward(batch, ["energy"])["energy"].block(0).values.detach()

    if case == "uncalibrated":
        with no_param_grads(served), pytest.raises(RuntimeError, match="calibrate_int8"):
            energy(served)
        return
    assert served.calibrate_int8(batch) == (0 if case == "fused_gnn" else 4)
    if case == "weight_grads":
        torch.testing.assert_close(energy(served), energy(exact), rtol=0, atol=0)
        return
    with no_param_grads(served), no_param_grads(exact):
        torch.testing.assert_close(energy(served), energy(exact), rtol=0, atol=0)


def test_w8a8_kernel_wrappers_raise_off_the_card():
    """The W8A8 wrappers launch or raise: float32 is refused, CPU tensors
    never fall back to the plain version; the backward has no weight
    gradients."""
    edges, center, cf, w, g_edge, g_center = _case(5)
    tw = tfl.LayerWeights(*map(_torch, w))
    calib = tfl.Int8Calib.from_stats(
        tfl.layer_probe_stats(_torch(edges), _torch(center), _torch(cf), tw, H, SCALE).tolist(), tw)
    w8a8 = (calib, tfl.quantize_layer_weights(tw, calib))
    args = [_torch(edges), _torch(center), _torch(cf), tw]
    with pytest.raises(TypeError, match="bfloat16"):
        tfl.fused_layer_fwd_cuda(*args, H, SCALE, w8a8=w8a8)
    b16 = [a.to(torch.bfloat16) for a in args[:2]] + args[2:]
    with pytest.raises(ValueError, match="cuda"):
        tfl.fused_layer_fwd_cuda(*b16, H, SCALE, w8a8=w8a8)
    g16 = [_torch(g_edge, torch.bfloat16), _torch(g_center, torch.bfloat16)]
    with pytest.raises(ValueError, match="cuda"):
        tfl.fused_layer_bwd_cuda(*b16, *g16, H, SCALE, w8a8=w8a8)
    with pytest.raises(ValueError, match="inference only"):
        tfl.layer_bwd_math(*b16, *g16, H, SCALE, weight_grads=True, w8a8=w8a8)
