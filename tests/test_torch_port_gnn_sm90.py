"""The Hopper GNN block: which calls take it, the node-stream kernels'
shared-memory budget and weight arrangement, the launch sequence against
the block's plain versions and the JAX package, and the margin its bf16
roundings spend.

The kernels run only on the card (``chip_smoke.py`` holds the block and
``csrc/gnn_node_sm90.cu`` against their plain versions there). Here:

- the dispatch rule ``_lib.gnn_sm90_takes``: bfloat16 at the Hopper K1/K2
  shapes with no weight requiring grad, with the node expansion at d_node
  128 or 256;
- the node-stream kernels' budget ``_lib.gnn_node_sm90_smem`` (the C
  side's layout, mirrored) fits the 232,448 bytes a block may have at
  every width the rule takes, and their C entries take the parameters
  ``_lib`` binds;
- the wrapper's weight arrangement (``NodeWeights``: transposes and the
  value/gate interleave in blocks of 128) holds every weight once;
- the decomposition: the launch sequence (``block_forward`` /
  ``block_backward``) run on the plain pieces (``layer_math``,
  ``layer_bwd_math``, ``node_stream_{fwd,bwd}_math``) is
  ``gnn_block_math`` / ``gnn_block_bwd_math`` bit for bit, and the JAX
  package's ``_gnn_block_math`` / ``_gnn_block_bwd_math`` (and
  ``jax.vjp``) to 1e-12 in float64, for 1 to 3 layers with and without the
  expansion;
- one function: the backward's recompute is the forward's sequence;
- rounding the softmax weights (and the Hopper K2's attention operands) to
  bf16 through the block's layers moves its outputs by less than the 2e-2
  relative RMS that ``chip_smoke.py`` allows, at the served widths;
- CPU tensors still run the plain versions, and the CUDA wrappers still
  refuse them.
"""

import ctypes
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_k1_sm90 import _fwd_rounded
from test_torch_port_k2_sm90 import _bwd_rounded
from metatrain_tpu.ops.pallas import fused_layer as jfl
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import gnn_block as tgb

BF16 = torch.bfloat16
F32 = torch.float32


@pytest.mark.parametrize("dtype, M, D, H, F, N, expanded, weight_grads, takes", [
    (BF16, 64, 128, 8, 256, 256, True, False, True),    # PET's defaults, served
    (BF16, 48, 128, 8, 256, 256, True, False, True),
    (BF16, 16, 128, 8, 256, 256, True, False, True),
    (BF16, 64, 128, 8, 256, 128, True, False, True),    # d_node 128, expanded
    (BF16, 64, 128, 8, 256, 128, False, False, True),   # no expansion: no node stream
    (BF16, 64, 128, 8, 512, 256, True, False, True),
    (BF16, 64, 128, 8, 256, 256, True, True, False),    # training: a weight requires grad
    (F32, 64, 128, 8, 256, 256, True, False, True),     # the f32 block (the Hopper f32 pair)
    (BF16, 96, 128, 8, 256, 256, True, False, False),   # M = 96
    (BF16, 64, 256, 8, 512, 256, False, False, False),  # d_pet 256
    (BF16, 64, 128, 8, 256, 384, True, False, False),   # d_node 384
    (BF16, 64, 128, 8, 256, 192, True, False, False),   # d_node % 128
    (BF16, 64, 128, 8, 256, 512, True, False, False),   # d_node 512
    (BF16, 64, 128, 16, 256, 256, True, False, False),  # heads of 8
])
def test_dispatch_rule(dtype, M, D, H, F, N, expanded, weight_grads, takes):
    assert _lib.gnn_sm90_takes(dtype, M, D, H, F, N, expanded, weight_grads) is takes
    if takes and dtype == BF16:
        # each attention layer on the Hopper K1 and K2
        assert _lib.k1_sm90_takes(dtype, M, D, H, F) and _lib.k2_sm90_takes(dtype, M, D, H, F)
        assert not expanded or _lib.gnn_node_sm90_smem(N, D, True) > 0
    elif takes:
        # on the Hopper float32 K1 and K2 (test_torch_port_gnn_f32_sm90.py)
        assert _lib.k1_f32_sm90_takes(dtype, M, D, H, F) and _lib.k2_f32_sm90_takes(
            dtype, M, D, H, F)
        assert not expanded or _lib.gnn_node_f32_sm90_smem(N, D, True) > 0


def test_node_smem_fits_every_width_it_takes():
    taken = []
    for N in range(64, 1025, 64):
        fwd, bwd = (_lib.gnn_node_sm90_smem(N, 128, b) for b in (False, True))
        assert (fwd > 0) is (bwd > 0) is _lib.gnn_node_sm90_shape(N, 128)
        if fwd:
            taken.append(N)
            assert fwd < bwd <= _lib.MAX_SHARED_BYTES
    assert taken == [128, 256]
    # the ring, the tiles and the row scratch at d_node 256
    assert _lib.gnn_node_sm90_smem(256, 128, False) == 151808
    assert _lib.gnn_node_sm90_smem(256, 128, True) == 221440
    assert _lib.gnn_node_sm90_smem(256, 256, True) == 0


_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _params(source: str, name: str):
    """The ctypes types of the parameters of ``extern "C" ... name(...)``."""
    m = re.search(r'extern "C" [\w ]+?\b' + name + r"\(([^)]*)\)", source)
    assert m, name
    types = []
    for param in m.group(1).split(","):
        param = " ".join(param.replace("const", "").split())
        if "*" in param:
            assert param.split("*")[0].strip() == "void", param
            types.append(ctypes.c_void_p)
        else:
            types.append(_TYPES[param.rsplit(" ", 1)[0]])
    return types


def test_node_entry_points_take_the_bound_parameters():
    text = (_lib.CSRC / "gnn_node_sm90.cu").read_text()
    names = re.findall(r'extern "C" [\w ]+?\b(mtt_\w+)\(', text)
    assert sorted(names) == ["mtt_gnn_node_bwd_sm90", "mtt_gnn_node_fwd_sm90",
                             "mtt_gnn_node_sm90_ok", "mtt_gnn_node_sm90_smem"]
    assert "gnn_node_sm90.cu" in _lib.SOURCES
    for name in names:
        assert _params(text, name) == _lib._SIGNATURES[name], name


def _center(N, D, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)

    def lecun(i, o):
        return rng.normal(size=(i, o)) / np.sqrt(i)

    def vec(n, base=0.0):
        return base + 0.1 * rng.normal(size=n)

    arrays = (lecun(N, D), vec(D), lecun(D, N), vec(N), vec(N, 1.0), lecun(N, 4 * N), vec(4 * N),
              lecun(2 * N, N), vec(N))
    return tgb.CenterWeights(*(torch.from_numpy(a).to(dtype) for a in arrays))


@pytest.mark.parametrize("N", [128, 256])
def test_node_weights_hold_every_weight_once(N):
    """The kernels' arrangement round-trips: the transposes are the weights,
    w_vg's rows 256 i .. + 127 are w_in_c's value columns 128 i .. + 127 and
    the next 128 rows the same gate columns."""
    D = 128
    cw = _center(N, D, seed=N)
    nw = tgb.node_sm90_weights(cw)
    cb = tgb.CenterWeights(*(x.to(BF16) for x in cw))
    assert all(x.dtype == BF16 and x.is_contiguous() for x in nw)
    assert nw.w_vg.shape == (4 * N, N)
    for i in range(2 * N // 128):
        assert torch.equal(nw.w_vg[256 * i:256 * i + 128], cb.w_in_c[:, 128 * i:128 * i + 128].T)
        assert torch.equal(nw.w_vg[256 * i + 128:256 * i + 256],
                           cb.w_in_c[:, 2 * N + 128 * i:2 * N + 128 * i + 128].T)
    w_in_c = nw.w_vg.reshape(2 * N // 128, 2, 128, N).transpose(0, 1).reshape(4 * N, N).T
    back = tgb.CenterWeights(nw.w_contr_t.T, nw.b_contr, nw.w_exp_t.T, nw.b_exp, nw.norm_c, w_in_c,
                             nw.b_in_c, nw.w_out_t.T, nw.b_out_c)
    for a, b in zip(back, cb):
        assert torch.equal(a, b)
    for name in ("w_contr", "w_exp", "w_in_c", "w_out_c"):
        assert torch.equal(getattr(nw, name), getattr(cb, name))


# the decomposition at the small widths of test_torch_port_gnn_block.py
A, M, D, H, F, N = 11, 16, 32, 4, 48, 96
SCALE = 1.0 / math.sqrt(D // H)


def _case(L, expanded, seed, dtype=np.float64):
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
              rng.normal(size=(A, M, D)), rng.normal(size=(A, nn))]
    return [a.astype(dtype) for a in arrays], [w.astype(dtype) for w in flat]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


LAYERS = pytest.mark.parametrize("L", [1, 2, 3])
EXPANDED = pytest.mark.parametrize("expanded", [True, False], ids=["expanded", "plain-node"])


@LAYERS
@EXPANDED
def test_launch_sequence_is_the_block_float64(L, expanded):
    (edges, node, cf, g_edge, g_node), flat = _case(L, expanded, seed=L)
    tx = [torch.from_numpy(a) for a in (edges, node, cf)]
    tg = [torch.from_numpy(a) for a in (g_edge, g_node)]
    lw, cw = tgb.unflatten_gnn_weights([torch.from_numpy(w) for w in flat], L, expanded)
    pieces = tgb.plain_pieces(H, SCALE)
    fwd = tgb.block_forward(*tx, lw, cw, expanded, pieces)
    bwd = tgb.block_backward(*tx, lw, cw, *tg, expanded, pieces)
    for a, b in zip(fwd, tgb.gnn_block_math(*tx, lw, cw, H, SCALE, expanded)):
        assert a.dtype == torch.float64 and torch.equal(a, b)
    for a, b in zip(bwd, tgb.gnn_block_bwd_math(*tx, lw, cw, *tg, H, SCALE, expanded)):
        assert a.dtype == torch.float64 and torch.equal(a, b)

    jx = [jnp.asarray(a) for a in (edges, node, cf)]
    j_lw, j_cw = jfl._unflatten_gnn_weights([jnp.asarray(w) for w in flat], L, expanded)
    for t, j in zip(fwd, jfl._gnn_block_math(*jx, j_lw, j_cw, H, SCALE, expanded)):
        assert t.shape == j.shape and _rel(t, j) < 1e-12

    def j_fn(e, n, c, *ws):
        lws, cws = jfl._unflatten_gnn_weights(list(ws), L, expanded)
        return jfl._gnn_block_math(e, n, c, lws, cws, H, SCALE, expanded)

    _, vjp = jax.vjp(j_fn, *jx, *(jnp.asarray(w) for w in flat))
    j_auto = vjp((jnp.asarray(g_edge), jnp.asarray(g_node)))[:3]
    j_hand = jfl._gnn_block_bwd_math(*jx, j_lw, j_cw, jnp.asarray(g_edge), jnp.asarray(g_node), H,
                                     SCALE, False, expanded)
    for i, (t, ja, jh) in enumerate(zip(bwd, j_auto, j_hand)):
        assert _rel(t, ja) < 1e-12, i
        # JAX's hand-written backward sums d_cf in float32
        assert _rel(t, jh) < (1e-6 if i == 2 else 1e-12), i


@LAYERS
@EXPANDED
def test_launch_sequence_is_the_block_bfloat16(L, expanded):
    """In bf16 too: the sequence rounds where the plain block rounds, so
    the plain pieces give the plain block's bits."""
    (edges, node, cf, g_edge, g_node), flat = _case(L, expanded, seed=10 + L)
    tx = [torch.from_numpy(edges).to(BF16), torch.from_numpy(node).to(BF16),
          torch.from_numpy(cf).float()]
    tg = [torch.from_numpy(a).to(BF16) for a in (g_edge, g_node)]
    lw, cw = tgb.unflatten_gnn_weights([torch.from_numpy(w).float() for w in flat], L, expanded)
    pieces = tgb.plain_pieces(H, SCALE)
    for a, b in zip(tgb.block_forward(*tx, lw, cw, expanded, pieces),
                    tgb.gnn_block_math(*tx, lw, cw, H, SCALE, expanded)):
        assert a.dtype == BF16 and torch.equal(a, b)
    out = tgb.block_backward(*tx, lw, cw, *tg, expanded, pieces)
    assert [x.dtype for x in out] == [BF16, BF16, F32]
    for a, b in zip(out, tgb.gnn_block_bwd_math(*tx, lw, cw, *tg, H, SCALE, expanded)):
        assert torch.equal(a, b)


@EXPANDED
def test_backward_recomputes_with_the_forward_sequence(monkeypatch, expanded):
    """``block_backward`` runs ``block_forward`` itself once (the last node
    update skipped), and the per-layer inputs it recomputes are the
    forward's, bit for bit."""
    L = 2
    (edges, node, cf, g_edge, g_node), flat = _case(L, expanded, seed=5, dtype=np.float32)
    tx = [torch.from_numpy(a).to(BF16) for a in (edges, node)] + [torch.from_numpy(cf)]
    tg = [torch.from_numpy(a).to(BF16) for a in (g_edge, g_node)]
    lw, cw = tgb.unflatten_gnn_weights([torch.from_numpy(w) for w in flat], L, expanded)
    pieces = tgb.plain_pieces(H, SCALE)
    fwd_trace, bwd_trace = [], []
    tgb.block_forward(*tx, lw, cw, expanded, pieces, fwd_trace)
    calls = []
    forward = tgb.block_forward

    def spy(*args, **kwargs):
        calls.append(kwargs.get("final", args[8] if len(args) > 8 else True))
        return forward(*args, **kwargs)

    monkeypatch.setattr(tgb, "block_forward", spy)
    tgb.block_backward(*tx, lw, cw, *tg, expanded, pieces, bwd_trace)
    assert calls == [False]
    assert len(fwd_trace) == len(bwd_trace) == L
    for f, b in zip(fwd_trace, bwd_trace):
        for x, y in zip(f, b):
            assert torch.equal(x, y)


@EXPANDED
def test_bf16_roundings_stay_within_the_kernel_bound(expanded):
    """The Hopper K1 rounds the softmax weights to bf16 before P V and the
    Hopper K2 rounds its attention operands (P, d_attn, dS): through the
    block's two layers at the served widths (M = 64, D = 128, 8 heads, F =
    256, d_node 256) that moves the block's outputs and input gradients by
    less than half the 2e-2 relative RMS that ``chip_smoke.py`` allows (the
    rest for the kernels' summation order)."""
    A_, M_, D_, H_, F_, L = 8, 64, 128, 8, 256, 2
    N_ = 256 if expanded else D_
    rng = np.random.default_rng(7)

    def lecun(i, o):
        return torch.from_numpy(rng.normal(size=(i, o)) / np.sqrt(i)).float()

    def vec(n, base=0.0):
        return torch.from_numpy(base + 0.1 * rng.normal(size=n)).float()

    lw = [tgb.LayerWeights(vec(D_, 1.0), lecun(D_, 3 * D_), vec(3 * D_), lecun(D_, D_), vec(D_),
                           vec(D_, 1.0), lecun(D_, 2 * F_), vec(2 * F_), lecun(F_, D_), vec(D_))
          for _ in range(L)]
    cw = [tgb.CenterWeights(lecun(N_, D_), vec(D_), lecun(D_, N_), vec(N_), vec(N_, 1.0),
                            lecun(N_, 4 * N_), vec(4 * N_), lecun(2 * N_, N_), vec(N_))
          if expanded else None for _ in range(L)]
    n_real = rng.integers(M_ // 2, M_ - 1, size=(A_, 1))
    cf = rng.uniform(0.05, 1.0, size=(A_, M_)) * (np.arange(M_)[None] < n_real)
    cf[:, M_ - 1] = 1.0
    edges, node, g_edge, g_node = (torch.from_numpy(rng.normal(size=s)).to(BF16) for s in (
        (A_, M_, D_), (A_, N_), (A_, M_, D_), (A_, N_)))
    cf = torch.from_numpy(cf).float()
    scale = 1.0 / math.sqrt(D_ // H_)
    rounded = tgb.plain_pieces(H_, scale)._replace(
        k1=lambda e, c, f, w: _fwd_rounded(e, c, f, w, H_, scale),
        k2=lambda e, c, f, w, ge, gc: _bwd_rounded(e, c, f, w, ge, gc, H_, scale))
    outs = (tgb.block_forward(edges, node, cf, lw, cw, expanded, rounded)
            + tgb.block_backward(edges, node, cf, lw, cw, g_edge, g_node, expanded, rounded))
    plain = (tgb.gnn_block_math(edges, node, cf, lw, cw, H_, scale, expanded)
             + tgb.gnn_block_bwd_math(edges, node, cf, lw, cw, g_edge, g_node, H_, scale,
                                      expanded))
    for i, (a, b) in enumerate(zip(outs, plain)):
        a, b = a.double(), b.double()
        rel = ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()
        assert 0 < rel < 1e-2, (i, rel)


def test_cpu_tensors_run_the_plain_block_and_the_wrappers_refuse_them():
    """At a shape the rule takes, the block on CPU bf16 tensors is
    ``gnn_block_math`` (its backward ``gnn_block_bwd_math``), bit for bit;
    the block's CUDA wrappers, with and without ``sm90``, and the node
    kernels' refuse CPU tensors."""
    M_, D_, H_, F_, N_, L = 64, 128, 8, 256, 256, 2
    assert _lib.gnn_sm90_takes(BF16, M_, D_, H_, F_, N_, True)
    rng = np.random.default_rng(3)

    def t(*shape, dtype=BF16):
        return torch.from_numpy(rng.normal(size=shape) / np.sqrt(shape[0])).to(dtype)

    flat = []
    for _ in range(L):
        flat += [t(D_), t(D_, 3 * D_), t(3 * D_), t(D_, D_), t(D_), t(D_), t(D_, 2 * F_),
                 t(2 * F_), t(F_, D_), t(D_)]
    for _ in range(L):
        flat += [t(N_, D_), t(D_), t(D_, N_), t(N_), t(N_), t(N_, 4 * N_), t(4 * N_), t(2 * N_, N_),
                 t(N_)]
    edges, node = t(2, M_, D_), t(2, N_)
    cf = torch.ones(2, M_)
    g_edge, g_node = t(2, M_, D_), t(2, N_)
    e = edges.clone().requires_grad_(True)
    n = node.clone().requires_grad_(True)
    out = tgb.fused_gnn_block(e, n, cf, flat, H_, 0.25, L, True)
    lw, cw = tgb.unflatten_gnn_weights(flat, L, True)
    plain = tgb.gnn_block_math(edges, node, cf, lw, cw, H_, 0.25, True)
    for a, b in zip(out, plain):
        assert torch.equal(a.detach(), b)
    grads = torch.autograd.grad(out, (e, n), (g_edge, g_node))
    plain_bwd = tgb.gnn_block_bwd_math(edges, node, cf, lw, cw, g_edge, g_node, H_, 0.25, True)
    for a, b in zip(grads, plain_bwd):
        assert torch.equal(a, b)
    for sm90 in (True, False):
        with pytest.raises(ValueError, match="cuda"):
            tgb.gnn_block_fwd_cuda(edges, node, cf, flat, H_, 0.25, L, True, sm90=sm90)
        with pytest.raises(ValueError, match="cuda"):
            tgb.gnn_block_bwd_cuda(edges, node, cf, flat, g_edge, g_node, H_, 0.25, L, True,
                                   sm90=sm90)
    nw = tgb.node_sm90_weights(cw[0])
    cattn = t(2, D_)
    with pytest.raises(ValueError, match="cuda"):
        tgb.gnn_node_fwd_cuda(node, cattn, nw, nw)
    with pytest.raises(ValueError, match="cuda"):
        tgb.gnn_node_bwd_cuda(node, cattn, g_node.float(), cattn, nw, nw)
    wide = tgb.node_sm90_weights(_center(384, D_, seed=1))
    with pytest.raises(ValueError, match="N = 128 or 256"):
        tgb.gnn_node_fwd_cuda(t(2, 384), cattn, wide, None)


def test_chip_smoke_expects_the_hopper_block():
    """``chip_smoke.py``'s launch tables: a bf16 force call of PET's
    defaults (two blocks of two layers, d_node 256) launches the Hopper K1 8
    times (the forward's and the backward's recompute), the Hopper K2 4, the
    node-stream kernels 10 and 6 times, and never the general block; the
    kernel line holds the four new entries."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    L, blocks = 2, 2
    assert cs.GNN_SM90_PER_CALL == {
        "fused_layer_fwd_sm90": blocks * 2 * L, "fused_layer_bwd_sm90": blocks * L,
        "gnn_node_fwd_sm90": blocks * ((L + 1) + L), "gnn_node_bwd_sm90": blocks * (L + 1)}
    assert set(cs.GNN_SM90_PER_CALL) <= set(cs.GNN_KERNELS)
    assert not set(cs.GNN_GENERAL) & set(cs.GNN_KERNELS)
    for name in ("gnn_block_fwd_sm90", "gnn_block_bwd_sm90", "gnn_node_fwd_sm90",
                 "gnn_node_bwd_sm90"):
        assert name in cs.SOURCES
    assert cs.N_ENTRIES == 55
