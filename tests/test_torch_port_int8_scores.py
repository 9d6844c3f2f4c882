"""Port parity: PET's dynamic int8 scores (plain versions of the absmax pass,
K1-int8, K2-int8 and K2-dW-int8) vs the JAX package's ``MTT_INT8_SCORES=1``.

The same inputs, made with numpy from a seed, go through the JAX package's
``_layer_math`` / ``_layer_bwd_math`` with ``int8=True`` (its plain
references), its interpret-mode kernels (``_forward_impl``, ``_make_bwd_op``)
and through the port's. The port computes the per-block scales once per
layer call from the forward's blocks (``int8_block_scales``), a partial
last block taking the padding atoms' ``|b_q|`` and ``|b_k|`` as JAX's
padded block does. In float32, on one padded block built as
``_forward_impl`` pads it, every quantized q and k equals JAX's and the
outputs agree to 1e-6 relative RMS (the scores are the same integers; the
rest differs by float rounding); in bfloat16 to 1e-2.
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
from metatrain_tpu.ops.pallas import fused_layer as jfl
from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info
from metatrain_tpu_torch.engine.evaluate import evaluate_model
from metatrain_tpu_torch.models.pet import PET
from metatrain_tpu_torch.ops.inference import no_param_grads
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import fused_layer as tfl

D, H, F = 64, 4, 64
SCALE = 1.0 / np.sqrt(D // H)
PET_HYPERS = {"cutoff": 4.5, "d_pet": 32, "d_head": 32, "d_node": 48, "d_feedforward": 32,
              "num_heads": 4, "num_gnn_layers": 2, "num_attention_layers": 2}


def rel_rms(a, b):
    """Relative RMS of a - b; where b is all zeros (a weight the backward
    does not read, such as b_ffn_out), the RMS of a."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ref = np.mean(b**2)
    return np.sqrt(np.mean((a - b) ** 2) / (ref if ref > 0 else 1.0))


def _weights(rng):
    def lecun(i, o):
        return rng.normal(size=(i, o)) / np.sqrt(i)

    w = [1 + 0.1 * rng.normal(size=D), lecun(D, 3 * D), 0.1 * rng.normal(size=3 * D),
         lecun(D, D), 0.1 * rng.normal(size=D), 1 + 0.1 * rng.normal(size=D),
         lecun(D, 2 * F), 0.1 * rng.normal(size=2 * F), lecun(F, D), 0.1 * rng.normal(size=D)]
    return [x.astype(np.float32) for x in w]


def _atoms(rng, A, M):
    """edges, center, cf (ragged real neighbors, the center's at 1) and the
    cotangents of A real atoms, float32."""
    n_real = rng.integers(M // 2, M - 1, size=(A, 1))
    cf = rng.uniform(0.05, 1.0, size=(A, M)) * (np.arange(M)[None] < n_real)
    cf[:, M - 1] = 1.0
    arrays = [rng.normal(size=s) for s in ((A, M, D), (A, D), (A, M, D), (A, D))]
    edges, center, g_edge, g_center = (x.astype(np.float32) for x in arrays)
    return edges, center, cf.astype(np.float32), g_edge, g_center


def _padded_block(seed, A, BA, M):
    """One block of BA atoms: A real ones, then padding atoms with zero
    tokens and cotangents and cf 1, as the JAX package's ``_forward_impl``
    pads a partial last block."""
    rng = np.random.default_rng(seed)
    w = _weights(rng)
    real = _atoms(rng, A, M)
    pad = BA - A
    fills = (0.0, 0.0, 1.0, 0.0, 0.0)
    block = [np.concatenate([x, np.full((pad,) + x.shape[1:], v, np.float32)])
             for x, v in zip(real, fills)]
    return w, real, block


def _jax(x, dtype=None):
    return jnp.asarray(x, dtype)


def _torch(x, dtype=None):
    t = torch.from_numpy(np.array(x, np.float32))
    return t if dtype is None else t.to(dtype)


def _jax_qk(edges, center, jw):
    """JAX's q and k of the exact forward (the operands ``_qside_scores``
    quantizes), float32."""
    BA, M, _ = edges.shape
    tokens = edges.at[:, M - 1].set(center)
    normed = jfl._rms_norm(tokens, jw.norm_attn)
    qkv = jfl._matmul_bias(normed.reshape(BA * M, D), jw.w_qkv, jw.b_qkv, edges.dtype)
    qkv = qkv.reshape(BA, M, 3 * D)
    return qkv[:, :, :D], qkv[:, :, D:2 * D]


@pytest.mark.parametrize("seed", [0, 1])
def test_float32_forward_matches_jax_on_a_padded_block(seed):
    """(a) The absmax pass's plain version on the real atoms equals JAX's
    absmax over the padded block; every quantized q and k is JAX's; the
    outputs agree to 1e-6."""
    A, BA, M = 5, 8, 64
    w, real, block = _padded_block(seed, A, BA, M)
    jw, tw = jfl.LayerWeights(*map(_jax, w)), tfl.LayerWeights(*map(_torch, w))
    je, jc, jcf = (_jax(x) for x in block[:3])
    te, tc, tcf = (_torch(x) for x in real[:3])

    assert tfl.int8_block_atoms(M) == BA
    blocks = tfl.int8_block_scales(te, tc, tw)
    assert blocks.shape == (1, 2) and blocks.dtype == torch.float32
    # the padded block itself gives the same scales: the fold of |b_q|, |b_k|
    torch.testing.assert_close(tfl.int8_block_scales(_torch(block[0]), _torch(block[1]), tw),
                               blocks, rtol=0, atol=0)
    jq, jk = _jax_qk(je, jc, jw)
    (jq_i8, jsq), (jk_i8, jsk) = jfl._quantize_i8(jq), jfl._quantize_i8(jk)
    np.testing.assert_allclose(blocks[0].numpy(), [float(jsq), float(jsk)], rtol=1e-6)

    scales = tfl.int8_atom_scales(blocks, A, BA)
    q, k = tfl._exact_qk(te, tc, tw)
    tq = tfl.quantize_i8(q, scales[:, 0, None, None])
    tk = tfl.quantize_i8(k, scales[:, 1, None, None])
    assert int((tq.numpy() != np.asarray(jq_i8)[:A]).sum()) == 0
    assert int((tk.numpy() != np.asarray(jk_i8)[:A]).sum()) == 0
    # the quantizer alone, on JAX's own operand and scale: bitwise
    np.testing.assert_array_equal(tfl.quantize_i8(_torch(jq), float(jsq)).numpy(),
                                  np.asarray(jq_i8, np.float32))

    j_out = jfl._layer_math(je, jc, jcf, jw, H, SCALE, int8=True)
    t_out = tfl.layer_math(te, tc, tcf, tw, H, SCALE, int8_scales=scales)
    for t, j in zip(t_out, j_out):
        assert rel_rms(t, np.asarray(j)[:A]) < 1e-6
    exact = tfl.layer_math(te, tc, tcf, tw, H, SCALE)
    assert rel_rms(t_out[0], exact[0]) > 1e-4  # quantization ran


@pytest.mark.parametrize("weight_grads", [False, True])
def test_float32_backward_matches_jax_on_a_padded_block(weight_grads):
    """(b) ``layer_bwd_math`` with the scales vs ``_layer_bwd_math(int8=True)``
    on the padded block (the padding atoms' zero cotangents add nothing to
    the weight gradients), 1e-6."""
    A, BA, M = 5, 8, 64
    w, real, block = _padded_block(2, A, BA, M)
    jw, tw = jfl.LayerWeights(*map(_jax, w)), tfl.LayerWeights(*map(_torch, w))
    te, tc, tcf, tge, tgc = (_torch(x) for x in real)
    scales = tfl.int8_atom_scales(tfl.int8_block_scales(te, tc, tw), A, BA)
    j = jfl._layer_bwd_math(*(_jax(x) for x in block[:3]), jw, *(_jax(x) for x in block[3:]),
                            H, SCALE, weight_grads, int8=True)
    t = tfl.layer_bwd_math(te, tc, tcf, tw, tge, tgc, H, SCALE, weight_grads, int8_scales=scales)
    for a, b in zip(t[:3], j[:3]):
        assert rel_rms(a, np.asarray(b)[:A]) < 1e-6
    assert (t[0][:, M - 1] == 0).all()
    if weight_grads:
        for a, b in zip(t[3], j[3]):
            assert rel_rms(a, b) < 1e-6


def test_chunked_replay_matches_jax_straight_through_vjp():
    """(c) The port's chunked replay with the forward's scales (sliced per
    atom, chunks of 3) vs ``jax.vjp`` of ``_layer_bwd_math(int8=True,
    straight_through=True)`` on one block, float32, 1e-5."""
    A, M = 8, 64
    rng = np.random.default_rng(3)
    w = _weights(rng)
    inputs = _atoms(rng, A, M)
    cts = [rng.normal(size=s).astype(np.float32) for s in ((A, M, D), (A, D), (A, M))]
    ct_dw = [rng.normal(size=x.shape).astype(np.float32) for x in w]
    jw = jfl.LayerWeights(*map(_jax, w))

    def f(edges, center, cf, weights, g_edge, g_center):
        return jfl._layer_bwd_math(edges, center, cf, weights, g_edge, g_center, H, SCALE, True,
                                   int8=True, straight_through=True)

    jx = [_jax(x) for x in inputs]
    _, vjp = jax.vjp(f, *jx[:3], jw, *jx[3:])
    j_grads = vjp((*map(_jax, cts), jfl.LayerWeights(*map(_jax, ct_dw))))

    tw = tfl.LayerWeights(*map(_torch, w))
    tx = [_torch(x) for x in inputs]
    scales = tfl.int8_atom_scales(tfl.int8_block_scales(tx[0], tx[1], tw), A, 8)
    d_rows, d_w = tfl.replay_layer_bwd(tx, tw, [_torch(c) for c in cts],
                                       [_torch(c) for c in ct_dw], H, SCALE, 3, scales)
    # JAX's cotangent order: edges, center, cf, weights, g_edge, g_center
    for t, jg in zip(d_rows, (*j_grads[:3], *j_grads[4:])):
        assert rel_rms(t, jg) < 1e-5
    for t, jg in zip(d_w, j_grads[3]):
        assert rel_rms(t, jg) < 1e-5


@pytest.mark.parametrize("M, A", [(64, 9), (48, 9)])
def test_bfloat16_function_matches_jax_interpret_kernels(monkeypatch, M, A):
    """(d) The port's Function with ``int8_scores`` (plain versions on the
    CPU) vs JAX's interpret-mode ``_forward_impl`` and ``_make_bwd_op(...,
    int8=True)`` under ``MTT_QSIDE=1`` and ``MTT_INT8_SCORES=1``: at M = 64,
    9 atoms make two blocks of 8, the second padded; at M = 48 one block of
    128 (``MTT_FUSED_BA_BWD=128`` gives JAX's backward the forward's
    blocks). Forward, input and weight gradients within 1e-2."""
    monkeypatch.setenv("MTT_QSIDE", "1")
    monkeypatch.setenv("MTT_INT8_SCORES", "1")
    if M == 48:
        monkeypatch.setenv("MTT_FUSED_BA_BWD", "128")
    rng = np.random.default_rng(4)
    w = _weights(rng)
    edges, center, cf, g_edge, g_center = _atoms(rng, A, M)
    bf = jnp.bfloat16
    jw = jfl.LayerWeights(*map(_jax, w))
    je, jc, jcf = _jax(edges, bf), _jax(center, bf), _jax(cf)
    jge, jgc = _jax(g_edge, bf), _jax(g_center, bf)
    j_out = jfl._forward_impl(je, jc, jcf, jw, H, SCALE)
    j_bwd = jfl._make_bwd_op(H, SCALE, weight_grads=True, int8=True)(je, jc, jcf, jw, jge, jgc)
    j_in = jfl._make_bwd_op(H, SCALE, weight_grads=False, int8=True)(je, jc, jcf, jw, jge, jgc)

    tw = tfl.LayerWeights(*(_torch(x).requires_grad_(True) for x in w))
    x = [_torch(edges, torch.bfloat16).requires_grad_(True),
         _torch(center, torch.bfloat16).requires_grad_(True), _torch(cf).requires_grad_(True)]
    assert tfl.int8_scores_applicable(x[0], H)
    t_out = tfl.fused_transformer_layer(*x, tw, H, SCALE, int8_scores=True)
    cot = (_torch(g_edge, torch.bfloat16), _torch(g_center, torch.bfloat16))
    t_grads = torch.autograd.grad(t_out, x + list(tw), cot)
    for t, j in zip((*t_out, *t_grads[:3]), (*j_out, *j_bwd[:3])):
        assert rel_rms(t.detach().float(), np.asarray(j, np.float32)) < 1e-2
    for t, j in zip(t_grads[3:], j_bwd[3]):
        assert rel_rms(t.float(), np.asarray(j, np.float32)) < 1e-2
    # the input-gradient variant (K2-int8's plain version) gives the same
    xd = [t.detach() for t in x]
    wd = tfl.LayerWeights(*(t.detach() for t in tw))
    scales = tfl.int8_scales_for(xd[0], xd[1], wd, H)
    t_in = tfl.layer_bwd_math(*xd, wd, *cot, H, SCALE, int8_scales=scales)
    for t, j in zip(t_in, j_in[:3]):
        assert rel_rms(t.float(), np.asarray(j, np.float32)) < 1e-2
    exact = tfl.layer_math(*xd, wd, H, SCALE)
    assert rel_rms(t_out[0].detach().float(), exact[0].float()) > 1e-3


def _pet_setup():
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


def test_pet_int8_scores_force_call_vs_jax(monkeypatch):
    """(e) A tiny PET's bfloat16 force call with ``int8_scores=True,
    plain=True`` vs JAX's PET under ``MTT_INT8_SCORES=1``, which on the CPU
    runs the exact layer (a divergence the port records: its plain twin
    quantizes): energy within 2 %, forces within 8 %, and not the port's
    exact bfloat16 result. The kernel path's Function on the CPU (twins
    again) agrees with the plain path."""
    port, params, jax_info, info, jax_batch, batch = _pet_setup()
    monkeypatch.setenv("MTT_INT8_SCORES", "1")
    jax_model = JaxPET(PET_HYPERS, jax_info, compute_dtype=jnp.bfloat16)
    e_ref, f_ref, _ = jax_energy_forces_virial(jax_model, params, jax_batch,
                                               dict(jax_info.targets))
    targets = dict(info.targets)
    e, f, v = port_energy_forces_virial(port(torch.bfloat16, plain=True, int8_scores=True), batch,
                                        targets)
    assert np.isfinite(e).all() and np.isfinite(f).all() and np.isfinite(v).all()
    n = int(batch.atom_mask.sum())
    assert abs(e[0, 0] - e_ref[0, 0]) < 0.02 * abs(e_ref[0, 0])
    assert rel_rms(f[:n], f_ref[:n]) < 0.08
    _, f16, _ = port_energy_forces_virial(port(torch.bfloat16, plain=True), batch, targets)
    assert rel_rms(f[:n], f16[:n]) > 1e-4
    e_fn, f_fn, _ = port_energy_forces_virial(port(torch.bfloat16, int8_scores=True), batch,
                                              targets)
    assert rel_rms(e_fn, e) < 1e-3 and rel_rms(f_fn[:n], f[:n]) < 2e-2


@pytest.mark.parametrize("case", ["float32", "float64", "fused_gnn", "unfused", "w8a8_wins"])
def test_int8_scores_gate(case):
    """(f) Ignored in float32 and float64, with the GNN block and with the
    unfused layers (energies equal the exact model's, bit for bit); a
    calibrated W8A8 layer wins over it."""
    port, _, _, info, _, batch = _pet_setup()
    dtype = {"float32": torch.float32, "float64": torch.float64}.get(case, torch.bfloat16)
    kw = {"fused_gnn": {"fused_gnn": True}, "w8a8_wins": {"int8_static": True}}.get(case, {})
    if case == "unfused":
        hypers = dict(PET_HYPERS, fused_layers=False)
        served = PET(hypers, info, compute_dtype=dtype, int8_scores=True)
        served.init_weights(torch.Generator().manual_seed(1))
        exact = PET(hypers, info, compute_dtype=dtype)
        exact.module.load_state_dict(served.module.state_dict())
    else:
        served = port(dtype, int8_scores=True, **kw)
        exact = port(dtype, **kw)
    if case == "w8a8_wins":
        assert served.calibrate_int8(batch) == exact.calibrate_int8(batch) == 4

    def energy(model):
        with no_param_grads(model):
            return model.forward(batch, ["energy"])["energy"].block(0).values.detach()

    torch.testing.assert_close(energy(served), energy(exact), rtol=0, atol=0)


def test_int8_scores_train_in_bfloat16():
    """The int8 scores hold in training too (JAX's ``_fused_bwd`` keeps them
    with weight gradients): a bfloat16 loss with forces differs from the
    exact model's, its gradients are finite, and the second-order replay
    ran with the scales."""
    port, _, _, info, _, batch = _pet_setup()
    grads = []
    for int8 in (True, False):
        model = port(torch.bfloat16, int8_scores=int8)
        _lib.REPLAYS.clear()
        block = evaluate_model(model.forward_eval, batch, dict(info.targets),
                               is_training=True)["energy"].block(0)
        loss = ((block.values.float() ** 2).sum()
                + (block.gradient("positions").values.float() ** 2).sum())
        params = [p for p in model.parameters() if p.requires_grad]
        grads.append(torch.autograd.grad(loss, params, allow_unused=True))
        assert _lib.REPLAYS["fused_layer"] == 4
    flat = [torch.cat([g.flatten() for g in gs if g is not None]) for gs in grads]
    assert torch.isfinite(flat[0]).all()
    assert ((flat[0] - flat[1]).norm() / flat[1].norm()).item() > 1e-4


def test_int8_kernel_wrappers_raise_off_the_card():
    """The int8-score wrappers launch or raise: float32 is refused, CPU
    tensors never fall back to the plain versions."""
    A, M = 4, 64
    rng = np.random.default_rng(5)
    w = tfl.LayerWeights(*map(_torch, _weights(rng)))
    edges, center, cf, g_edge, g_center = (_torch(x) for x in _atoms(rng, A, M))
    scales = tfl.int8_atom_scales(tfl.int8_block_scales(edges, center, w), A, 8)
    with pytest.raises(TypeError, match="bfloat16"):
        tfl.fused_layer_fwd_cuda(edges, center, cf, w, H, SCALE, int8_scales=scales)
    with pytest.raises(TypeError, match="bfloat16"):
        tfl.int8_absmax_cuda(edges, center, w)
    b16 = [edges.to(torch.bfloat16), center.to(torch.bfloat16)]
    with pytest.raises(ValueError, match="cuda"):
        tfl.fused_layer_fwd_cuda(*b16, cf, w, H, SCALE, int8_scales=scales)
    with pytest.raises(ValueError, match="cuda"):
        tfl.int8_absmax_cuda(*b16, w)
    g16 = [g_edge.to(torch.bfloat16), g_center.to(torch.bfloat16)]
    for weight_grads in (False, True):
        with pytest.raises(ValueError, match="cuda"):
            tfl.fused_layer_bwd_cuda(*b16, cf, w, *g16, H, SCALE, weight_grads,
                                     int8_scales=scales)
