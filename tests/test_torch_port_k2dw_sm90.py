"""The two-pass K2-dW (``csrc/fused_layer_bwd_dw_sm90.cu``): its plain halves,
its plan, which calls take it, and the CPU path beside it.

The kernels run only on the card (``chip_smoke.py`` holds them against
``layer_bwd_math`` there). Here:

- the first pass's plain version ``layer_dw_operands`` and the second's
  ``dw_from_operands``, summed in the kernels' chunk and slice order, give
  ``layer_bwd_math(..., weight_grads=True)``'s weight gradients and the JAX
  package's: 1e-12 relative in float64 (against ``jax.vjp`` of
  ``_layer_math``; JAX's ``_layer_bwd_math(weight_grads=True)`` returns
  float32 sums, held at 1e-6), 1e-5 in float32 (the same products, summed
  in another order); with the int8 scores in float32 against JAX's on one
  block of atoms;
- the plan ``_lib.k2dw_plan`` / ``k2dw_slices`` covers every atom and every
  row exactly once, keeps the spill at most 1 GiB and depends only on the
  shape and the SM count;
- the dispatch rule ``_lib.k2dw_sm90_takes``;
- on the CPU the layer's weight gradients still come from
  ``layer_bwd_math``, and the wrappers refuse CPU tensors;
- the C entry points take the parameters ``_lib`` binds.
"""

import ctypes
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import rel
from metatrain_tpu.ops.pallas import fused_layer as jfl
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import fused_layer as tfl

BF16 = torch.bfloat16
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _inputs(A, M, D, F, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def lecun(i, o):
        return rng.normal(size=(i, o)) / np.sqrt(i)

    w = [1 + 0.1 * rng.normal(size=D), lecun(D, 3 * D), 0.1 * rng.normal(size=3 * D),
         lecun(D, D), 0.1 * rng.normal(size=D), 1 + 0.1 * rng.normal(size=D),
         lecun(D, 2 * F), 0.1 * rng.normal(size=2 * F), lecun(F, D), 0.1 * rng.normal(size=D)]
    n_real = rng.integers(M // 2, M - 1, size=(A, 1))
    cf = rng.uniform(0.05, 1.0, size=(A, M)) * (np.arange(M)[None] < n_real)
    cf[:, M - 1] = 1.0
    x = [rng.normal(size=s) for s in ((A, M, D), (A, D), (A, M, D), (A, D))]
    cast = [a.astype(dtype) for a in x]
    return cast[0], cast[1], cf.astype(dtype), [a.astype(dtype) for a in w], cast[2], cast[3]


def _plan(x, A, M, D, F, chunks, sms=132):
    """The kernels' plan for these atoms, with the spill cap set so that
    the atoms fall into ``chunks`` chunks."""
    row = (7 * D + 3 * F) * x.element_size()
    atom = M * row + 4 * _lib.dw_vector_floats(D, F)
    cap = _lib.K2DW_SPILL_CAP if chunks == 1 else atom * -(-A // chunks)
    plan = _lib.k2dw_plan(x.element_size(), A, M, D, F, sms, cap)
    assert plan.chunks == chunks
    return plan


# (dtype, A, M, D, chunks): windows of 16, 64 and 80 slots, D 128 and 256;
# A = 48 at M = 16 gives one chunk of three slices
CASES = [
    (np.float64, 6, 16, 128, 1), (np.float64, 6, 16, 128, 3), (np.float64, 48, 16, 128, 1),
    (np.float64, 3, 64, 128, 2), (np.float64, 2, 80, 128, 1), (np.float64, 3, 16, 256, 3),
    (np.float64, 2, 64, 256, 1), (np.float32, 48, 16, 128, 2), (np.float32, 3, 64, 128, 1),
    (np.float32, 2, 80, 256, 2),
]


@pytest.mark.parametrize("dtype, A, M, D, chunks", CASES)
def test_two_passes_match_the_plain_backward_and_jax(dtype, A, M, D, chunks):
    F, H = 2 * D, D // 16
    scale = 1.0 / math.sqrt(D // H)
    edges, center, cf, w, g_edge, g_center = _inputs(A, M, D, F, dtype, seed=A + M + D)
    t = [torch.from_numpy(a) for a in (edges, center, cf, g_edge, g_center)]
    tw = tfl.LayerWeights(*(torch.from_numpy(a) for a in w))
    ops = tfl.layer_dw_operands(t[0], t[1], t[2], tw, t[3], t[4], H, scale)
    assert ops.n1.shape == (A * M, D) and ops.d_vg.shape == (A * M, 2 * F)
    assert ops.vectors.shape == (A, 7 * D + 2 * F)
    plan = _plan(t[0], A, M, D, F, chunks)
    two_pass = tfl.dw_from_operands(ops, t[3], plan)
    plain = tfl.layer_bwd_math(t[0], t[1], t[2], tw, t[3], t[4], H, scale, weight_grads=True)[3]
    je, jc, jcf = (jnp.asarray(a) for a in (edges, center, cf))
    jw = jfl.LayerWeights(*(jnp.asarray(a) for a in w))
    j_hand = jfl._layer_bwd_math(je, jc, jcf, jw, jnp.asarray(g_edge), jnp.asarray(g_center), H,
                                 scale, weight_grads=True)[3]
    _, vjp = jax.vjp(lambda ww: jfl._layer_math(je, jc, jcf, ww, H, scale), jw)
    (j_auto,) = vjp((jnp.asarray(g_edge), jnp.asarray(g_center)))
    for name, a, b, jh, ja in zip(tfl.LayerWeights._fields, two_pass, plain, j_hand, j_auto):
        assert a.shape == b.shape, name
        assert rel(a, b) < TOL[dtype], name
        assert rel(a, np.asarray(jh)) < max(TOL[dtype], 1e-6), name
        if dtype == np.float64:
            assert rel(a, np.asarray(ja)) < TOL[dtype], name


@pytest.mark.parametrize("chunks", [1, 3])
def test_two_passes_with_int8_scores_match_jax(chunks):
    """float32 with the dynamic int8 scores: 8 atoms at M = 64 are one block
    of scales, as JAX's ``_layer_bwd_math(int8=True)`` takes them over its
    input."""
    A, M, D, F, H = 8, 64, 128, 256, 8
    scale = 1.0 / math.sqrt(D // H)
    edges, center, cf, w, g_edge, g_center = _inputs(A, M, D, F, np.float32, seed=7)
    assert tfl.int8_block_atoms(M) == A
    t = [torch.from_numpy(a) for a in (edges, center, cf, g_edge, g_center)]
    tw = tfl.LayerWeights(*(torch.from_numpy(a) for a in w))
    scales = tfl.int8_scales_for(t[0], t[1], tw, H)
    ops = tfl.layer_dw_operands(t[0], t[1], t[2], tw, t[3], t[4], H, scale, int8_scales=scales)
    two_pass = tfl.dw_from_operands(ops, t[3], _plan(t[0], A, M, D, F, chunks))
    plain = tfl.layer_bwd_math(t[0], t[1], t[2], tw, t[3], t[4], H, scale, weight_grads=True,
                               int8_scales=scales)[3]
    j_dw = jfl._layer_bwd_math(*(jnp.asarray(a) for a in (edges, center, cf)),
                               jfl.LayerWeights(*(jnp.asarray(a) for a in w)),
                               jnp.asarray(g_edge), jnp.asarray(g_center), H, scale,
                               weight_grads=True, int8=True)[3]
    for name, a, b, j in zip(tfl.LayerWeights._fields, two_pass, plain, j_dw):
        assert rel(a, b) < TOL[np.float32], name
        assert rel(a, np.asarray(j)) < TOL[np.float32], name


@pytest.mark.parametrize("elem, A, M, D, F, sms", [
    (4, 11392, 64, 128, 256, 132),   # the crystal, float32
    (2, 11392, 64, 128, 256, 132),   # bf16
    (4, 4096, 48, 128, 256, 132),    # a training batch
    (4, 256, 128, 256, 512, 132),    # the widest window and width
    (2, 100_003, 16, 128, 128, 114),
    (4, 7, 16, 128, 256, 132),       # few atoms: one slice
    (4, 1, 256, 256, 1024, 8),
])
def test_plan_covers_every_row_once(elem, A, M, D, F, sms):
    plan = _lib.k2dw_plan(elem, A, M, D, F, sms)
    assert plan == _lib.k2dw_plan(elem, A, M, D, F, sms)  # the shape and the SMs alone
    assert plan.spill_bytes <= 1 << 30
    assert plan.spill_bytes <= _lib.K2DW_SPILL_CAP or plan.chunk_atoms == 1
    row = (7 * D + 3 * F) * elem
    assert plan.vec_offset >= plan.chunk_atoms * M * row and plan.vec_offset % 256 == 0
    assert plan.spill_bytes == plan.vec_offset + plan.chunk_atoms * 4 * (7 * D + 2 * F)
    chunks = _lib.k2dw_chunks(plan, A)
    assert len(chunks) == plan.chunks
    atoms = [a for a0, a1 in chunks for a in range(a0, a1)]
    assert atoms == list(range(A))  # each atom once, in order
    for a0, a1 in chunks:
        R = (a1 - a0) * M
        step, n = _lib.k2dw_slices(R, D, F, sms)
        assert step % 64 == 0 and 1 <= n <= plan.max_slices
        covered = np.zeros(R, np.int64)
        for s in range(n):
            covered[s * step:min(R, (s + 1) * step)] += 1
        assert (covered == 1).all()
        assert (n - 1) * step < R  # no empty slice
        # the vector rows' slices: every atom of the chunk once
        seen = [a for s in range(n) for a in range((a1 - a0) * s // n, (a1 - a0) * (s + 1) // n)]
        assert seen == list(range(a1 - a0))


def test_plan_fills_the_card():
    """At the crystal's shape a chunk is 9 waves of pass 1, and its slices
    fill one wave of two blocks per SM."""
    plan = _lib.k2dw_plan(4, 11392, 64, 128, 256, 132)
    assert plan.chunks == 10 and plan.chunk_atoms == 9 * 132  # whole waves of pass 1
    step, n = _lib.k2dw_slices(9 * 132 * 64, 128, 256, 132)
    assert n * _lib.dw_product_tiles(128, 256) <= 2 * 132 < (n + 1) * _lib.dw_product_tiles(128, 256)
    assert _lib.dw_product_tiles(128, 256) == 10 and _lib.dw_product_tiles(256, 512) == 40


@pytest.mark.parametrize("dtype, M, D, H, F, int8, takes", [
    (torch.float32, 64, 128, 8, 256, False, True),   # the training step
    (BF16, 64, 128, 8, 256, False, True),            # the exact bf16 step
    (BF16, 64, 128, 8, 256, True, True),             # K2-dW-int8
    (torch.float32, 64, 128, 8, 256, True, False),   # int8 scores are bf16
    (torch.float32, 48, 128, 8, 256, False, True),
    (torch.float32, 16, 128, 8, 256, False, True),
    (torch.float32, 80, 128, 8, 256, False, True),   # the workspace plans
    (BF16, 96, 128, 8, 256, False, True),
    (torch.float32, 128, 128, 8, 256, False, True),
    (torch.float32, 256, 128, 8, 256, False, True),
    (BF16, 64, 256, 8, 512, False, True),            # d_pet 256
    (torch.float32, 128, 256, 8, 512, False, True),
    (torch.float32, 64, 128, 16, 256, False, True),  # heads of 8
    (torch.float32, 64, 128, 4, 256, False, True),   # heads of 32
    (torch.float32, 56, 128, 8, 256, False, False),  # M % 16
    (torch.float32, 272, 128, 8, 256, False, False),  # M > 256
    (torch.float32, 64, 96, 8, 192, False, False),   # D % 128
    (torch.float32, 64, 192, 8, 384, False, False),
    (torch.float32, 64, 128, 8, 192, False, False),  # F % 128
    (torch.float64, 64, 128, 8, 256, False, False),
])
def test_dispatch_rule(dtype, M, D, H, F, int8, takes):
    assert _lib.k2dw_sm90_takes(dtype, M, D, H, F, int8) is takes


def test_cpu_backward_runs_the_plain_version():
    """The layer's weight gradients on CPU float32 tensors at a shape the
    two-pass K2-dW takes are ``layer_bwd_math``'s, bit for bit; the
    wrappers refuse CPU tensors."""
    A, M, D, F, H = 2, 64, 128, 256, 8
    scale = 1.0 / math.sqrt(D // H)
    edges, center, cf, w, g_edge, g_center = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else [torch.from_numpy(x) for x in a]
        for a in _inputs(A, M, D, F, np.float32, seed=3))
    assert _lib.k2dw_sm90_takes(torch.float32, M, D, H, F)
    tw = [x.clone().requires_grad_(True) for x in w]
    e = edges.clone().requires_grad_(True)
    out = tfl.fused_transformer_layer(e, center, cf, tfl.LayerWeights(*tw), H, scale)
    grads = torch.autograd.grad(out, [e] + tw, (g_edge, g_center))
    plain = tfl.layer_bwd_math(edges, center, cf, tfl.LayerWeights(*w), g_edge, g_center, H,
                               scale, weight_grads=True)
    assert torch.equal(grads[0], plain[0])
    for a, b in zip(grads[1:], plain[3]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="cuda"):
        tfl.fused_layer_bwd_cuda(edges, center, cf, tfl.LayerWeights(*w), g_edge, g_center, H,
                                 scale, weight_grads=True)
    ops = tfl.layer_dw_operands(edges, center, cf, tfl.LayerWeights(*w), g_edge, g_center, H,
                                scale)
    spill, vectors = tfl.pack_dw_operands(ops)
    assert spill.shape == (A * M * (7 * D + 3 * F),) and vectors.shape == (A, 7 * D + 2 * F)
    with pytest.raises(ValueError, match="cuda"):
        tfl.layer_dw_product_cuda(spill, vectors, g_edge, sms=132)


_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _params(source: str, name: str):
    """The ctypes types of ``extern "C" ... name(...)``'s parameters in
    ``source`` as ``_lib`` binds them: ``long long*`` as a pointer to
    c_longlong, every other pointer as c_void_p."""
    m = re.search(r'extern "C" [\w ]+?\b' + name + r"\(([^)]*)\)", source)
    assert m, name
    types = []
    for param in m.group(1).split(","):
        param = " ".join(param.replace("const", "").split())
        if "*" in param:
            base = param.split("*")[0].strip()
            types.append(_lib._LP if base == "long long" else ctypes.c_void_p)
        else:
            types.append(_TYPES[param.rsplit(" ", 1)[0]])
    return types


def test_entry_points_take_the_bound_parameters():
    text = (_lib.CSRC / "fused_layer_bwd_dw_sm90.cu").read_text()
    names = re.findall(r'extern "C" [\w ]+?\b(mtt_\w+)\(', text)
    assert len(names) == 5 and "fused_layer_bwd_dw_sm90.cu" in _lib.SOURCES
    for name in names:
        assert _params(text, name) == _lib._SIGNATURES[name], name
