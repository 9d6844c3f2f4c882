"""The Hopper float32 GNN block: which calls take it, the float32
node-stream kernels' shared-memory plan and C entry points, the
weight-gradient launch sequence against the block's plain version and the
JAX package, and the CPU path beside it.

The kernels run only on the card (``chip_smoke.py`` holds the block and
``csrc/gnn_node_f32_sm90.cu`` against their plain versions there). Here:

- the dispatch rule ``_lib.gnn_sm90_takes``: float32 at the Hopper K1/K2
  shapes with or without weight gradients, with the node expansion at
  d_node 128 or 256; bfloat16 with weight gradients stays general;
- the float32 node kernels' plan ``_lib.gnn_node_f32_sm90_smem`` (the C
  side's rooms, mirrored) fits the 232,448 bytes a block may have in every
  mode at every width the rule takes, and their C entries take the
  parameters ``_lib`` binds;
- the decomposition with weight gradients: ``block_backward(...,
  weight_grads=True)`` on the plain pieces (``layer_bwd_math`` with its
  weight gradients, ``node_stream_bwd_dw_math`` and ``node_stream_dw_math``,
  which sums the node products in the second pass's slice order) is
  ``gnn_block_bwd_math(..., weight_grads=True)`` in float64, and the JAX
  package's ``_gnn_block_bwd_math`` and ``jax.vjp``, for 1 to 3 layers with
  and without the expansion;
- one function: the float32 forward with weight gradients and the
  weight-gradient backward's recompute run ``block_forward`` with the same
  pieces;
- CPU tensors still run the plain versions, and the CUDA wrappers refuse
  them.

JAX's functions are called directly (no Pallas kernel), in float64.
"""

import ctypes
import importlib.util
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatrain_tpu.ops.pallas import fused_layer as jfl
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import gnn_block as tgb

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("dtype, M, D, N, expanded, weight_grads, takes", [
    (F32, 64, 128, 256, True, False, True),     # the f32 G call
    (F32, 64, 128, 256, True, True, True),      # the f32 G step
    (F32, 48, 128, 256, True, True, True),
    (F32, 16, 128, 256, True, False, True),
    (F32, 64, 128, 128, True, True, True),      # d_node 128
    (F32, 64, 128, 128, False, True, True),     # no expansion: K1 / K2-dW only
    (F32, 64, 128, 384, True, False, False),    # d_node 384: no plan fits
    (F32, 64, 128, 192, True, True, False),
    (F32, 96, 128, 256, True, True, False),     # M = 96
    (F32, 64, 256, 256, False, True, False),    # d_pet 256
    (BF16, 64, 128, 256, True, False, True),    # the bf16 G call
    (BF16, 64, 128, 256, True, True, False),    # the exact bf16 step stays general
    (BF16, 64, 128, 128, False, True, False),
])
def test_dispatch_rule(dtype, M, D, N, expanded, weight_grads, takes):
    H, F = D // 16, 2 * D
    assert _lib.gnn_sm90_takes(dtype, M, D, H, F, N, expanded, weight_grads) is takes
    if takes and dtype == F32:
        # each attention layer on the Hopper float32 K1 and K2 / K2-dW's
        # float32 first pass
        assert _lib.k1_f32_sm90_takes(dtype, M, D, H, F)
        assert _lib.k2_f32_sm90_takes(dtype, M, D, H, F, weight_grads)
        assert _lib.k2dw_sm90_takes(dtype, M, D, H, F)
        assert not expanded or _lib.gnn_node_f32_sm90_smem(N, D, True) > 0


def test_node_f32_smem_fits_every_width_it_takes():
    taken = []
    for N in range(64, 1025, 64):
        fwd, bwd = (_lib.gnn_node_f32_sm90_smem(N, 128, b) for b in (False, True))
        assert (fwd > 0) is (bwd > 0) is _lib.gnn_node_f32_sm90_shape(N, 128)
        if fwd:
            taken.append(N)
            # the backward's bytes hold both of its modes
            assert fwd < bwd <= _lib.MAX_SHARED_BYTES
    assert taken == [128, 256]
    # the rooms at d_node 256: ring, cattn, n_mid, hn, the h tile, r2
    assert _lib.gnn_node_f32_sm90_smem(256, 128, False) == 4 * (
        3 * 128 * 16 + 64 * 132 + 2 * 64 * 260 + 64 * 132 + 64) == 225536
    # ring, U (d_center / n_mid / d_v | d_g / cattn), HN, DN, r2, sum scratch
    assert _lib.gnn_node_f32_sm90_smem(256, 128, True) == 4 * (
        3 * 128 * 16 + 2 * 64 * 132 + 2 * 64 * 260 + 64 + 4 * 128) == 227584
    # the bf16 pair's layout in float32 would not fit
    assert 4 * (3 * 128 * 16 + 2 * 64 * 132 + 3 * 64 * 260 + 2 * 64 * 132 + 5 * 64) > (
        _lib.MAX_SHARED_BYTES)
    assert _lib.gnn_node_f32_sm90_smem(256, 256, True) == 0


def test_node_f32_smem_mirrors_the_c_plan():
    """The C source's room sizes (``Geo``) are the Python mirror's."""
    text = (_lib.CSRC / "gnn_node_f32_sm90.cu").read_text()
    assert "kFwdFloats = kRingFloats + kTileT + 2 * kTileN + kTileT + kRows;" in text
    assert "kBwdFloats = kRingFloats + kU + 2 * kTileN + kRows + 4 * kCN;" in text
    assert "kU = 2 * kTileT > kTileN ? 2 * kTileT : kTileN;" in text
    assert "constexpr int LT = kCN + 4;" in text and "LN = N + 4;" in text


_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _params(source: str, name: str):
    """The ctypes types of the parameters of ``extern "C" ... name(...)``."""
    m = re.search(r'extern "C" [\w ]+?\b' + name + r"\(([^)]*)\)", source)
    assert m, name
    types = []
    for param in m.group(1).split(","):
        param = " ".join(param.replace("const", "").split())
        types.append(ctypes.c_void_p if "*" in param else _TYPES[param.rsplit(" ", 1)[0]])
    return types


def test_node_f32_entry_points_take_the_bound_parameters():
    text = (_lib.CSRC / "gnn_node_f32_sm90.cu").read_text()
    names = re.findall(r'extern "C" [\w ]+?\b(mtt_\w+)\(', text)
    assert sorted(names) == ["mtt_gnn_node_bwd_f32_sm90", "mtt_gnn_node_dw_f32_sm90",
                             "mtt_gnn_node_f32_sm90_ok", "mtt_gnn_node_f32_sm90_smem",
                             "mtt_gnn_node_fwd_f32_sm90"]
    assert "gnn_node_f32_sm90.cu" in _lib.SOURCES
    for name in names:
        assert _params(text, name) == _lib._SIGNATURES[name], name
    # the forward takes the bf16 pair's arguments (one wrapper)
    assert _lib._SIGNATURES["mtt_gnn_node_fwd_f32_sm90"] == _lib._SIGNATURES[
        "mtt_gnn_node_fwd_sm90"]


# the decomposition at the small widths of test_torch_port_gnn_block.py
A, M, D, H, F, N = 11, 16, 32, 4, 48, 96
SCALE = 1.0 / math.sqrt(D // H)
JAX_F32 = 1e-6  # where the JAX hand-written backward rounds to float32 (d_cf, dW)


def _case(L, expanded, seed, atoms=A):
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
    n_real = rng.integers(M // 2, M - 1, size=(atoms, 1))
    cf = rng.uniform(0.05, 1.0, size=(atoms, M)) * (np.arange(M)[None] < n_real)
    cf[:, M - 1] = 1.0
    arrays = [rng.normal(size=(atoms, M, D)), rng.normal(size=(atoms, nn)), cf,
              rng.normal(size=(atoms, M, D)), rng.normal(size=(atoms, nn))]
    return arrays, flat


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("expanded", [True, False], ids=["expanded", "plain-node"])
def test_weight_gradient_sequence_is_the_block_float64(L, expanded):
    (edges, node, cf, g_edge, g_node), flat = _case(L, expanded, seed=20 + L)
    tx = [torch.from_numpy(a) for a in (edges, node, cf)]
    tg = [torch.from_numpy(a) for a in (g_edge, g_node)]
    lw, cw = tgb.unflatten_gnn_weights([torch.from_numpy(w) for w in flat], L, expanded)
    out = tgb.block_backward(*tx, lw, cw, *tg, expanded, tgb.plain_pieces(H, SCALE),
                             weight_grads=True)
    plain = tgb.gnn_block_bwd_math(*tx, lw, cw, *tg, H, SCALE, expanded, True)
    assert len(out) == 4 and len(out[3]) == len(plain[3]) == len(flat)
    for a, b in zip(out[:3], plain[:3]):
        assert a.dtype == F64 and torch.equal(a, b)
    n_layer = L * len(tgb.LayerWeights._fields)
    for i, (a, b) in enumerate(zip(out[3], plain[3])):
        assert a.shape == b.shape == flat[i].shape and a.dtype == F64, i
        if i < n_layer:  # the layers' from the same layer_bwd_math
            assert torch.equal(a, b), i
        else:  # the node weights' in the second pass's order
            assert _rel(a, b) < 1e-12, i

    jx = [jnp.asarray(a) for a in (edges, node, cf)]
    j_lw, j_cw = jfl._unflatten_gnn_weights([jnp.asarray(w) for w in flat], L, expanded)
    j_hand = jfl._gnn_block_bwd_math(*jx, j_lw, j_cw, jnp.asarray(g_edge), jnp.asarray(g_node), H,
                                     SCALE, True, expanded)

    def j_fn(e, n, c, *ws):
        lws, cws = jfl._unflatten_gnn_weights(list(ws), L, expanded)
        return jfl._gnn_block_math(e, n, c, lws, cws, H, SCALE, expanded)

    _, vjp = jax.vjp(j_fn, *jx, *(jnp.asarray(w) for w in flat))
    j_auto = vjp((jnp.asarray(g_edge), jnp.asarray(g_node)))
    for i, (t, jh, ja) in enumerate(zip(out[:3], j_hand[:3], j_auto[:3])):
        assert _rel(t, ja) < 1e-12, i
        assert _rel(t, jh) < (JAX_F32 if i == 2 else 1e-12), i
    dws, dcs = j_hand[3]
    j_flat = jfl._flatten_gnn_weights(dws, dcs if expanded else (), expanded)
    for i, (t, jh, ja) in enumerate(zip(out[3], j_flat, j_auto[3:])):
        assert _rel(t, ja) < 1e-12, i
        assert _rel(t, jh) < JAX_F32, i  # its weight gradients come back in float32


def test_node_products_sum_in_slice_order():
    """At 600 atoms (10 tiles of 64, 2 slices of 320 rows on 132 SMs)
    ``node_stream_dw_math`` cuts its sums where the second pass does, and
    still gives the block's node weight gradients; the spill mode's
    outputs are the input-gradient mode's, bit for bit."""
    L, atoms = 2, 600
    tiles = _lib.gnn_node_dw_tiles(N, D)
    assert _lib.dw_slices(atoms, tiles, 132) == (320, 2)
    (edges, node, cf, g_edge, g_node), flat = _case(L, True, seed=7, atoms=atoms)
    tx = [torch.from_numpy(a) for a in (edges, node, cf)]
    tg = [torch.from_numpy(a) for a in (g_edge, g_node)]
    lw, cw = tgb.unflatten_gnn_weights([torch.from_numpy(w) for w in flat], L, True)
    trace = []
    out = tgb.block_backward(*tx, lw, cw, *tg, True, tgb.plain_pieces(H, SCALE), trace, True)
    plain = tgb.gnn_block_bwd_math(*tx, lw, cw, *tg, H, SCALE, True, True)
    n_layer = L * len(tgb.LayerWeights._fields)
    for a, b in zip(out[3][n_layer:], plain[3][n_layer:]):
        assert _rel(a, b) < 1e-12
    # the last layer's update: the spill mode against the input-gradient mode
    e_in, n_in, center, cattn = trace[-1]
    dn = torch.from_numpy(g_node)
    (d_cattn, d_nmid), ops = tgb.node_stream_bwd_dw_math(n_in, cattn, dn, None, None, cw[-1])
    ref = tgb.node_stream_bwd_math(n_in, cattn, dn, None, None, cw[-1])
    assert torch.equal(d_cattn, ref[0]) and torch.equal(d_nmid, ref[1])
    assert torch.equal(ops.d_nmid, d_nmid) and torch.equal(ops.d_n, dn)
    assert [tuple(x.shape) for x in ops] == [(atoms, N), (atoms, 2 * N), (atoms, 4 * N),
                                           (atoms, N), (atoms, N), (atoms, N)]
    # the slices' sums are the whole rows' sums, reassociated
    d_center = torch.from_numpy(np.random.default_rng(1).normal(size=(atoms, D)))
    got = tgb.node_stream_dw_math(n_in, cattn, d_center, ops)
    want = tgb.CenterWeights(n_in.T @ d_center, d_center.sum(0), cattn.T @ ops.d_nmid,
                             ops.d_nmid.sum(0), ops.norm_rows.sum(0), ops.hn.T @ ops.d_vg,
                             ops.d_vg.sum(0), ops.h.T @ ops.d_n, ops.d_n.sum(0))
    for x, y in zip(got, want):
        assert x.shape == y.shape and _rel(x, y) < 1e-13


def _cpu_cuda_calls(monkeypatch, dtype):
    """Run ``gnn_block_fwd_cuda`` (with weight gradients) and
    ``gnn_block_bwd_cuda`` (their variant) on CPU tensors with the device
    checks lifted, recording each ``block_forward`` call's pieces (the K1
    kernel its ``k1`` launches) and node weights; no kernel runs."""
    M_, D_, H_, F_, N_, L = 64, 128, 8, 256, 256, 2
    rng = np.random.default_rng(4)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape) / np.sqrt(shape[0])).to(dtype)

    flat = []
    for _ in range(L):
        flat += [t(D_), t(D_, 3 * D_), t(3 * D_), t(D_, D_), t(D_), t(D_), t(D_, 2 * F_),
                 t(2 * F_), t(F_, D_), t(D_)]
    for _ in range(L):
        flat += [t(N_, D_), t(D_), t(D_, N_), t(N_), t(N_), t(N_, 4 * N_), t(4 * N_),
                 t(2 * N_, N_), t(N_)]
    edges, node, g_edge, g_node = t(3, M_, D_), t(3, N_), t(3, M_, D_), t(3, N_)
    cf = torch.ones(3, M_)
    calls = []

    class Stop(Exception):
        pass

    def spy(e, n, c, lws, node_ws, expanded, pieces, trace=None, final=True):
        launched = []
        monkeypatch.setattr(tgb, "_k1_sm90", lambda *args: launched.append(args[-1]) or Stop)
        pieces.k1(e, n, c, lws[0])
        calls.append((pieces, node_ws, launched[0], final))
        raise Stop

    monkeypatch.setattr(_lib, "require", lambda *args: None)
    monkeypatch.setattr(tgb, "block_forward", spy)
    for run in (
        lambda: tgb.gnn_block_fwd_cuda(edges, node, cf, flat, H_, 0.25, L, True,
                                       weight_grads=True),
        lambda: tgb.gnn_block_bwd_cuda(edges, node, cf, flat, g_edge, g_node, H_, 0.25, L, True,
                                       True),
    ):
        with pytest.raises(Stop):
            run()
    return calls


def test_one_function_forward_and_recompute(monkeypatch):
    """The float32 forward with weight gradients (the G step's energy) and
    the weight-gradient backward's recompute (its forces) both run
    ``block_forward`` on the Hopper float32 K1 and the float32 node kernels,
    with the same node weights; so the forces differentiate the energy's
    own function."""
    calls = _cpu_cuda_calls(monkeypatch, F32)
    assert len(calls) == 2
    (fwd_pieces, fwd_ws, fwd_k1, fwd_final), (bwd_pieces, bwd_ws, bwd_k1, bwd_final) = calls
    assert fwd_k1 == bwd_k1 == "fused_layer_fwd_f32_sm90"
    assert fwd_final and not bwd_final  # the recompute skips the last update alone
    for pieces in (fwd_pieces, bwd_pieces):
        assert pieces.node_fwd is tgb.gnn_node_fwd_cuda
        assert pieces.node_bwd_dw is tgb.gnn_node_bwd_dw_cuda
        assert pieces.node_dw is tgb.gnn_node_dw_cuda
    for a, b in zip(fwd_ws, bwd_ws):
        for x, y in zip(a, b):
            assert x.dtype == F32 and torch.equal(x, y)


def test_bf16_weight_gradients_stay_general(monkeypatch):
    """bfloat16 with a weight requiring grad keeps the general block: the
    Hopper sequence is never entered."""
    assert not _lib.gnn_sm90_takes(BF16, 64, 128, 8, 256, 256, True, True)
    monkeypatch.setattr(_lib, "library", lambda: (_ for _ in ()).throw(LookupError("general")))
    with pytest.raises(LookupError, match="general"):
        _cpu_cuda_calls(monkeypatch, BF16)


def test_cpu_tensors_run_the_plain_block_and_the_wrappers_refuse_them():
    """At a shape the rule takes, the float32 block on CPU tensors with its
    weights requiring grad is ``gnn_block_math`` (its gradients
    ``gnn_block_bwd_math`` with the weight gradients), bit for bit; the
    CUDA wrappers refuse CPU tensors."""
    M_, D_, H_, F_, N_, L = 64, 128, 8, 256, 256, 2
    assert _lib.gnn_sm90_takes(F32, M_, D_, H_, F_, N_, True, True)
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape) / np.sqrt(shape[0])).float()

    flat = []
    for _ in range(L):
        flat += [t(D_), t(D_, 3 * D_), t(3 * D_), t(D_, D_), t(D_), t(D_), t(D_, 2 * F_),
                 t(2 * F_), t(F_, D_), t(D_)]
    for _ in range(L):
        flat += [t(N_, D_), t(D_), t(D_, N_), t(N_), t(N_), t(N_, 4 * N_), t(4 * N_),
                 t(2 * N_, N_), t(N_)]
    edges, node, g_edge, g_node = t(2, M_, D_), t(2, N_), t(2, M_, D_), t(2, N_)
    cf = torch.ones(2, M_)
    ws = [w.clone().requires_grad_(True) for w in flat]
    e = edges.clone().requires_grad_(True)
    out = tgb.fused_gnn_block(e, node, cf, ws, H_, 0.25, L, True)
    lw, cw = tgb.unflatten_gnn_weights(flat, L, True)
    for a, b in zip(out, tgb.gnn_block_math(edges, node, cf, lw, cw, H_, 0.25, True)):
        assert torch.equal(a.detach(), b)
    grads = torch.autograd.grad(out, [e] + ws, (g_edge, g_node))
    plain = tgb.gnn_block_bwd_math(edges, node, cf, lw, cw, g_edge, g_node, H_, 0.25, True, True)
    assert torch.equal(grads[0], plain[0])
    for a, b in zip(grads[1:], plain[3]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="cuda"):
        tgb.gnn_block_fwd_cuda(edges, node, cf, flat, H_, 0.25, L, True, weight_grads=True)
    with pytest.raises(ValueError, match="cuda"):
        tgb.gnn_block_bwd_cuda(edges, node, cf, flat, g_edge, g_node, H_, 0.25, L, True, True)
    nw = tgb.node_sm90_weights(cw[0], F32)
    assert all(x.dtype == F32 for x in nw)
    cattn = t(2, D_)
    with pytest.raises(ValueError, match="cuda"):
        tgb.gnn_node_fwd_cuda(node, cattn, nw, nw)
    with pytest.raises(ValueError, match="cuda"):
        tgb.gnn_node_bwd_cuda(node, cattn, g_node, cattn, nw, nw)
    with pytest.raises(ValueError, match="cuda"):
        tgb.gnn_node_bwd_dw_cuda(node, cattn, g_node, None, None, nw)
    spill = tgb.NodeSpill(node, t(2, 2 * N_), t(2, 4 * N_), node, node, t(1, D_ + 7 * N_))
    with pytest.raises(ValueError, match="cuda"):
        tgb.gnn_node_dw_cuda(node, cattn, cattn, spill)
    wide = tgb.node_sm90_weights(tgb.CenterWeights(
        t(384, D_), t(D_), t(D_, 384), t(384), t(384), t(384, 4 * 384), t(4 * 384),
        t(2 * 384, 384), t(384)), F32)
    with pytest.raises(ValueError, match="N = 128 or 256"):
        tgb.gnn_node_fwd_cuda(t(2, 384), cattn, wide, None)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_expects_the_f32_hopper_block():
    """``chip_smoke.py``'s launch tables at PET's defaults (two blocks of two
    layers, d_node 256): the f32 G call launches the Hopper float32 K1 8
    times, K2 4, the float32 node kernels 10 and 6; the f32 G step (two
    weight-gradient backwards a block: the forces' and the loss's) K1 12,
    K2-dW 8, the node forward 14, the spill mode 12 and its products 8; and
    neither the general block. The kernel line holds the new entries."""
    cs = _chip_smoke()
    L, blocks = 2, 2
    assert cs.GNN_F32_PER_CALL == {
        "fused_layer_fwd_f32_sm90": blocks * 2 * L, "fused_layer_bwd_f32_sm90": blocks * L,
        "gnn_node_fwd_f32_sm90": blocks * ((L + 1) + L), "gnn_node_bwd_f32_sm90": blocks * (L + 1)}
    bwd_dw = 2 * blocks  # first backwards a step
    assert cs.GNN_F32_PER_STEP == {
        "fused_layer_fwd_f32_sm90": blocks * L + bwd_dw * L,
        "fused_layer_bwd_dw_f32_sm90": bwd_dw * L, "layer_dw_product": bwd_dw * L,
        "gnn_node_fwd_f32_sm90": blocks * (L + 1) + bwd_dw * L,
        "gnn_node_bwd_dw_f32_sm90": bwd_dw * (L + 1), "gnn_node_dw_product": bwd_dw * L}
    for name in cs.GNN_GENERAL:
        assert name not in cs.GNN_F32_PER_CALL and name not in cs.GNN_F32_PER_STEP
    for name in ("gnn_block_fwd_f32_sm90", "gnn_block_bwd_f32_sm90", "gnn_block_bwd_dw_f32_sm90",
                 "gnn_node_fwd_f32_sm90", "gnn_node_bwd_f32_sm90", "gnn_node_bwd_dw_f32_sm90"):
        assert name in cs.SOURCES
    assert cs.N_ENTRIES == 53
