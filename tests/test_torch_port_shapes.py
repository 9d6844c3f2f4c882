"""The shapes the port's kernels now take: windows above M = 64, d_pet 256 and
any head width that divides D.

- The plain versions of the fused layer (K1, K2, K2-dW) agree with the JAX
  package in float64 (``_layer_math`` and ``jax.vjp`` of it) at M = 80 and
  96, at d_pet 256 and at head widths 8, 12, 24 and 64; the W8A8 plain
  versions (float32) at head widths 8 and 24.
- The kernels' shape checks accept every one of those shapes (on the CPU
  they then refuse the tensors for not being on the card).
- The layout plans (``_lib``'s mirror of ``csrc/common.cuh`` SmemPlan) fit
  under 232,448 bytes of shared memory for every M of 16..256 (step 16) and
  D of 64, 96, 128, 192 and 256, for every kernel variant, and keep the
  layouts that fitted before (M = 64, D = 128) unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatrain_tpu.ops.pallas import fused_layer as jfl
from metatrain_tpu_torch.models.pet.fused_stages import COMBINATION, COMPRESS, HEAD
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import attention as tak
from metatrain_tpu_torch.ops.kernels import fused_layer as tfl
from metatrain_tpu_torch.ops.kernels import rowblock as trb

# (M, D, H, F): the windows of A1, d_pet 256 and the head widths of A3
LAYER_SHAPES = [
    (80, 128, 8, 256), (96, 128, 8, 256), (64, 256, 8, 512),
    (32, 128, 16, 64), (32, 96, 8, 64), (32, 192, 8, 64), (32, 256, 4, 64),
]
W8A8_SHAPES = [(32, 128, 16, 256), (32, 192, 8, 384)]  # head widths 8 and 24


def rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ref = np.mean(b**2)
    return np.sqrt(np.mean((a - b) ** 2) / (ref if ref > 0 else 1.0))


def _case(M, D, F, A=2, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)

    def lecun(i, o):
        return rng.normal(size=(i, o)) / np.sqrt(i)

    w = [1 + 0.1 * rng.normal(size=D), lecun(D, 3 * D), 0.1 * rng.normal(size=3 * D),
         lecun(D, D), 0.1 * rng.normal(size=D), 1 + 0.1 * rng.normal(size=D),
         lecun(D, 2 * F), 0.1 * rng.normal(size=2 * F), lecun(F, D), 0.1 * rng.normal(size=D)]
    n_real = rng.integers(M // 2, M - 1, size=(A, 1))
    cf = rng.uniform(0.05, 1.0, size=(A, M)) * (np.arange(M)[None] < n_real)
    cf[:, M - 1] = 1.0
    arrays = [rng.normal(size=s) for s in ((A, M, D), (A, D), (A, M, D), (A, D))]
    edges, center, g_edge, g_center = (x.astype(dtype) for x in arrays)
    return ([x.astype(dtype) for x in w], edges, center, cf.astype(dtype), g_edge, g_center)


@pytest.mark.parametrize("M, D, H, F", LAYER_SHAPES)
def test_float64_layer_matches_jax(M, D, H, F):
    """(g) K1's and K2-dW's plain versions vs ``_layer_math`` and its vjp."""
    w, edges, center, cf, g_edge, g_center = _case(M, D, F)
    scale = 1.0 / np.sqrt(D // H)
    jw = jfl.LayerWeights(*map(jnp.asarray, w))
    jx = [jnp.asarray(x) for x in (edges, center, cf)]
    @jax.jit
    def forward_and_vjp(e, c, f, ww, cot):
        out, vjp = jax.vjp(lambda *a: jfl._layer_math(*a, H, scale), e, c, f, ww)
        return out, vjp(cot)

    j_out, j_grads = forward_and_vjp(*jx, jw, (jnp.asarray(g_edge), jnp.asarray(g_center)))
    tw = tfl.LayerWeights(*map(torch.from_numpy, w))
    tx = [torch.from_numpy(x) for x in (edges, center, cf)]
    t_out = tfl.layer_math(*tx, tw, H, scale)
    for t, j in zip(t_out, j_out):
        assert rel_rms(t, j) < 1e-12
    t_bwd = tfl.layer_bwd_math(*tx, tw, torch.from_numpy(g_edge), torch.from_numpy(g_center), H,
                               scale, weight_grads=True)
    for t, j in zip(t_bwd[:3], j_grads[:3]):
        assert rel_rms(t, j) < 1e-10
    for t, j in zip(t_bwd[3], j_grads[3]):
        assert rel_rms(t, j) < 1e-10


def _jax_calib(edges, center, cf, jw, H, scale, D):
    stats = np.asarray(jfl.layer_probe_stats(edges, center, cf, jw, H, scale), np.float64)
    wq = np.asarray(jw.w_qkv, np.float64)

    def am(x):
        return float(np.max(np.abs(np.asarray(x, np.float64))))

    return jfl.Int8Calib(*(float(x) for x in stats), am(wq[:, :D]), am(wq[:, D:2 * D]),
                         am(wq[:, 2 * D:]), am(jw.w_in), am(jw.w_ffn_out))


@pytest.mark.parametrize("M, D, H, F", W8A8_SHAPES)
def test_w8a8_plain_versions_match_jax_at_narrow_heads(M, D, H, F):
    """(g) The W8A8 plain versions at head widths 8 and 24 (the score tiles
    pad a head to 16), float32, 1e-5."""
    w, edges, center, cf, g_edge, g_center = _case(M, D, F, A=3, seed=1, dtype=np.float32)
    w = [x.astype(np.float32) for x in w]
    scale = 1.0 / np.sqrt(D // H)
    jw = jfl.LayerWeights(*map(jnp.asarray, w))
    jx = [jnp.asarray(x) for x in (edges, center, cf)]
    calib = _jax_calib(*jx, jw, H, scale, D)
    jwi8 = jfl.quantize_layer_weights(jw, calib)
    tw = tfl.LayerWeights(*map(torch.from_numpy, w))
    w8a8 = (tfl.Int8Calib(*calib), tfl.quantize_layer_weights(tw, calib))
    tx = [torch.from_numpy(x) for x in (edges, center, cf)]
    @jax.jit
    def reference(e, c, f, ww, wi8, ge, gc):
        return (jfl._layer_math(e, c, f, ww, H, scale, w8a8=(calib, wi8)),
                jfl._layer_bwd_math(e, c, f, ww, ge, gc, H, scale, weight_grads=False,
                                    w8a8=(calib, wi8)))

    j_fwd, j_bwd = reference(*jx, jw, jwi8, jnp.asarray(g_edge), jnp.asarray(g_center))
    t_fwd = tfl.layer_math(*tx, tw, H, scale, w8a8=w8a8)
    for t, j in zip(t_fwd, j_fwd):
        assert rel_rms(t, j) < 1e-5
    t_bwd = tfl.layer_bwd_math(*tx, tw, torch.from_numpy(g_edge), torch.from_numpy(g_center), H,
                               scale, w8a8=w8a8)
    for t, j in zip(t_bwd, j_bwd[:3]):
        assert rel_rms(t, j) < 1e-5


@pytest.mark.parametrize("M, D, H, F", LAYER_SHAPES + W8A8_SHAPES)
def test_kernel_checks_accept_the_shapes(M, D, H, F):
    """(h) ``check_layer_shapes`` (K1/K2 and the GNN block), the attention
    pair's check (head widths) and the W8A8 argument check accept the
    shapes; on the CPU the wrappers then refuse the tensors."""
    w, edges, center, cf, g_edge, g_center = _case(M, D, F, A=1, dtype=np.float32)
    tw = tfl.LayerWeights(*(torch.from_numpy(x.astype(np.float32)) for x in w))
    e16 = torch.from_numpy(edges).to(torch.bfloat16)
    assert tfl.check_layer_shapes(e16, torch.from_numpy(cf), tw, H) == (1, M, D, F)
    with pytest.raises(ValueError, match="cuda"):
        tfl.fused_layer_fwd_cuda(e16, torch.from_numpy(center).to(torch.bfloat16),
                                 torch.from_numpy(cf), tw, H, 0.25)
    q = torch.zeros(1, M + 1, D)
    with pytest.raises(ValueError, match="cuda"):
        tak.window_attention_fwd_cuda(q, q, q, torch.zeros(1, M + 1), H, 0.25)
    if D % 32 == 0 and F % 32 == 0:
        tfl.check_w8a8_shapes(D, F, H)


def test_kernel_checks_refuse_what_the_kernels_do_not_take():
    w, edges, _, cf, _, _ = _case(64, 128, 256, A=1, dtype=np.float32)
    tw = tfl.LayerWeights(*(torch.from_numpy(x.astype(np.float32)) for x in w))
    e = torch.from_numpy(edges)
    with pytest.raises(ValueError, match="M % 16"):
        tfl.check_layer_shapes(e[:, :40], torch.from_numpy(cf)[:, :40], tw, 8)
    with pytest.raises(ValueError, match="head count"):
        tfl.check_layer_shapes(e, torch.from_numpy(cf), tw, 3)
    q = torch.zeros(1, 65, 256)
    with pytest.raises(ValueError, match="at most 64"):
        tak.window_attention_fwd_cuda(q, q, q, torch.zeros(1, 65), 2, 0.25)
    with pytest.raises(ValueError, match="divisible by 32"):
        tfl.check_w8a8_shapes(80, 160, 8)


@pytest.mark.parametrize("D", [128, 256])
def test_rowblock_geometry_takes_d_pet_256(D):
    """(h) The row-block stages at their PET widths: the shape check
    accepts them and the tiles shrink where 64 rows do not fit (the
    combination at d_pet 256 takes 32 rows, forward and backward)."""
    rows = 100

    def x():
        return torch.zeros(rows, D, dtype=torch.bfloat16)

    cases = [
        (COMPRESS, (x(), x(), x()), [torch.zeros(3 * D, D), torch.zeros(D), torch.zeros(D, D),
                                     torch.zeros(D)]),
        (COMBINATION, (x(), x(), x()), [torch.zeros(2 * D), torch.zeros(2 * D),
                                        torch.zeros(2 * D, 2 * D), torch.zeros(2 * D),
                                        torch.zeros(2 * D, D), torch.zeros(D)]),
        (HEAD, (x(),), [torch.zeros(D, D), torch.zeros(D), torch.zeros(D, D), torch.zeros(D)]),
    ]
    for stage, inputs, weights in cases:
        (_, _), (w0, _, w1, _) = trb._split_weights(stage, weights)
        _, _, w_in, w_hid, w_out = trb._launch_geometry(stage, inputs, w0, w1)
        fwd = _lib.rowblock_fwd_rows(w_in, w_hid)
        assert fwd * (w_in + w_hid) * 4 <= _lib.MAX_SHARED_BYTES
        for dw in (False, True):
            tile = _lib.rowblock_bwd_rows(stage.code, w_in, w_hid, w_out, dw)
            nbytes = 4 * _lib.rowblock_bwd_floats(stage.code, w_in, w_hid, w_out, dw, tile)
            assert nbytes <= _lib.MAX_SHARED_BYTES
        if stage is COMBINATION:
            assert fwd == (64 if D == 128 else 32)
        with pytest.raises(ValueError, match="cuda"):
            trb.rowblock_fwd_cuda(stage, inputs, weights)


def _plans(M, D, H, F, N):
    """(name, shared bytes, workspace floats) of every planned kernel."""
    out = [("fused_layer_fwd (and _w8a8, _int8)", 4 * _lib.layer_fwd_plan(M, D, F).smem_floats,
            _lib.layer_fwd_plan(M, D, F).ws_floats)]
    for dw, q8, name in ((False, False, "fused_layer_bwd"), (True, False, "fused_layer_bwd_dw"),
                         (False, True, "fused_layer_bwd_w8a8 / _int8"),
                         (True, True, "fused_layer_bwd_dw_int8")):
        p = _lib.layer_bwd_plan(M, D, H, F, dw, q8)
        out.append((name, 4 * p.smem_floats, p.ws_floats))
    out.append(("gnn_block_fwd", *_lib.gnn_block_sizes(M, D, H, F, N, False, False)))
    for dw in (False, True):
        out.append((f"gnn_block_bwd{'_dw' if dw else ''}",
                    *_lib.gnn_block_sizes(M, D, H, F, N, dw, True)))
    return out


@pytest.mark.parametrize("D", [64, 96, 128, 192, 256])
def test_layout_plans_fit_in_shared_memory(D):
    """(i) Every plan fits under 232,448 bytes for M = 16..256 (step 16),
    with F = 2D, heads of 16 (and of 64), d_node = 2D; the workspace holds
    the rest of the body's floats."""
    F, N = 2 * D, 2 * D
    for M in range(16, 257, 16):
        for H in (max(D // 16, 1), max(D // 64, 1)):
            for name, nbytes, ws in _plans(M, D, H, F, N):
                assert 0 < nbytes <= _lib.MAX_SHARED_BYTES, (name, M, D, H)
                assert ws >= 0
        total = 2 * M * D + M * max(_lib.qkv_stride(D), F) + M * (M + 1) + M
        plan = _lib.layer_fwd_plan(M, D, F)
        assert plan.smem_floats + plan.ws_floats == total


def test_layout_plans_keep_the_layouts_that_fitted():
    """At M = 64, D = 128, F = 256, 8 heads, d_node 256 every buffer stays in
    shared memory, in the bytes the kernels always took; at M = 96 and at D
    = 256 q|k|v (K1) moves to the workspace first."""
    expected = {
        "fused_layer_fwd (and _w8a8, _int8)": 181760, "fused_layer_bwd": 206848,
        "fused_layer_bwd_dw": 231424, "fused_layer_bwd_w8a8 / _int8": 219904,
        "gnn_block_fwd": 195600, "gnn_block_bwd": 206848, "gnn_block_bwd_dw": 231424,
    }
    for name, nbytes, ws in _plans(64, 128, 8, 256, 256):
        if name in expected:
            assert (nbytes, ws) == (expected[name], 0), name
    for M, D in ((96, 128), (64, 256)):
        plan = _lib.layer_fwd_plan(M, D, 2 * D)
        assert plan.shared == (True, True, False, True, True)
        assert plan.ws_floats == M * _lib.qkv_stride(D)
    # M = 80 still fits K1 and, without the scratch, K2
    assert _lib.layer_fwd_plan(80, 128, 256).ws_floats == 0
    assert _lib.layer_bwd_plan(80, 128, 8, 256, False, False).shared[3] is False


def test_make_plan_claims_in_keep_order():
    plan = _lib.make_plan([10, 20, 30], keep=[2, 0, 1], cap=44)
    assert plan.shared == (True, False, True)  # 32 + 12 = 44; 20 no longer fits
    assert (plan.smem_floats, plan.ws_floats) == (44, 20)
