"""The Hopper float32 K4 and the two-pass K4-dW (``csrc/rowblock_bwd_f32_sm90.cu``):
their plain halves, the plan, which calls take them, the C entry points, the
accuracy of their 3xTF32 products and the CPU path beside them.

The kernels run only on the card (``chip_smoke.py`` holds them against the
plain versions there). Here:

- the first pass's plain version ``rowblock_dw_operands`` and the second's
  ``rowblock_dw_from_operands``, summed in the kernels' chunk, slice and
  tile order, give ``stage.bwd(..., weight_grads=True)`` and the JAX
  package's: 1e-12 relative in float64 against ``jax.vjp`` of
  ``compress_math`` / ``combination_math``, 1e-6 against JAX's hand-written
  ``compress_bwd`` / ``combination_bwd`` (float32 sums), 1e-5 in float32;
- the plan ``_lib.k4dw_plan`` covers every row once, keeps the spill under
  its cap and depends only on the shape and the SM count;
- the dispatch rule ``_lib.k4_f32_sm90_takes`` and the shared-memory budget;
- the stage's products formed as the kernel forms them (3xTF32, each staged
  chunk of 16 k summed from zero) stay within 1e-6 of float64;
- on the CPU the stages' backward is ``stage.bwd``, and the wrappers refuse
  CPU tensors;
- the C entry points take the parameters ``_lib`` binds;
- ``tools/k2_split.py`` finds the marks of the general K4-dW body and of the
  new one.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import rel
from metatrain_tpu.models.pet import fused_stages as jst
from metatrain_tpu_torch.models.pet import fused_stages as tst
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import rowblock as trb
from test_torch_port_k2dw_sm90 import _params

F32, BF16 = torch.float32, torch.bfloat16
D = 128
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _case(name, rows, dtype, seed=0):
    """numpy inputs, weights and cotangent of a stage at the served widths."""
    rng = np.random.default_rng(seed)

    def lecun(i, o):
        return rng.normal(size=(i, o)) / np.sqrt(i)

    def vec(n, base=0.0):
        return base + 0.1 * rng.normal(size=n)

    n_parts = {"compress2": 2, "compress3": 3, "combination": 3}[name]
    inputs = [rng.normal(size=(rows, D)) for _ in range(n_parts)]
    if name == "combination":
        weights = [vec(2 * D, 1.0), vec(2 * D), lecun(2 * D, 2 * D), vec(2 * D), lecun(2 * D, D), vec(D)]
    else:
        weights = [lecun(n_parts * D, D), vec(D), lecun(D, D), vec(D)]
    g = rng.normal(size=(rows, D))
    cast = lambda a: a.astype(dtype)  # noqa: E731
    return [cast(a) for a in inputs], [cast(a) for a in weights], cast(g)


def _stages(name):
    if name == "combination":
        return tst.COMBINATION, jst.combination_math, jst.combination_bwd
    return tst.COMPRESS, jst.compress_math, jst.compress_bwd


def _widths(name):
    """(stage code, w_in, w_hid) of the served widths."""
    return {"compress2": (0, 256, 128), "compress3": (0, 384, 128), "combination": (1, 256, 256)}[name]


def _plan(name, rows, chunks, sms=132):
    """The kernels' plan, its cap set so that the rows fall into ``chunks``."""
    code, w_in, w_hid = _widths(name)
    tile = 4 * (64 * _lib.k4dw_row_floats(code, w_in, w_hid) + _lib.k4dw_vector_floats(code, w_in, w_hid))
    tiles = -(-rows // 64)
    cap = _lib.K4DW_SPILL_CAP if chunks == 1 else tile * -(-tiles // chunks)
    plan = _lib.k4dw_plan(code, rows, w_in, w_hid, sms, cap)
    assert plan.chunks == chunks
    return plan


# (stage, rows, dtype, chunks): row counts that end in a partial tile, one
# chunk and several; 1,300 rows at 132 SMs are one chunk of three slices
CASES = [
    ("compress3", 200, np.float64, 1), ("compress3", 333, np.float64, 3),
    ("compress2", 200, np.float64, 2), ("combination", 200, np.float64, 1),
    ("combination", 333, np.float64, 2), ("combination", 1300, np.float64, 1),
    ("compress3", 300, np.float32, 2), ("combination", 300, np.float32, 1),
    ("compress2", 1300, np.float32, 1),
]


@pytest.mark.parametrize("name, rows, dtype, chunks", CASES)
def test_two_passes_match_the_plain_backward_and_jax(name, rows, dtype, chunks):
    inputs, weights, g = _case(name, rows, dtype, seed=rows)
    stage, j_math, j_bwd = _stages(name)
    xs, ws, tg = [torch.from_numpy(a) for a in inputs], [torch.from_numpy(a) for a in weights], \
        torch.from_numpy(g)
    ops = trb.rowblock_dw_operands(stage, xs, ws, tg)
    code, w_in, w_hid = _widths(name)
    assert ops.vectors.shape == (-(-rows // 64), _lib.k4dw_vector_floats(code, w_in, w_hid))
    assert sum(x.shape[1] for x in ops.rows) == _lib.k4dw_row_floats(code, w_in, w_hid)
    two_pass = trb.rowblock_dw_from_operands(stage, xs, tg, ops, _plan(name, rows, chunks))
    plain = stage.bwd(xs, ws, tg, weight_grads=True)
    n = 3 if stage is tst.COMBINATION else len(xs)
    for a, b in zip(ops.d_inputs, plain[:n]):
        assert torch.equal(a, b)  # the first pass's cotangents are stage.bwd's
    jx, jw, jg = [jnp.asarray(a) for a in inputs], [jnp.asarray(a) for a in weights], jnp.asarray(g)
    _, j_hand = j_bwd(jx, jw, (jg,), True)
    _, vjp = jax.vjp(lambda ww: j_math(jx, ww), jw)
    (j_auto,) = vjp((jg,))
    assert len(two_pass) == len(plain) - n == len(j_hand) == len(j_auto)
    for i, (a, b, jh, ja) in enumerate(zip(two_pass, plain[n:], j_hand, j_auto)):
        assert a.shape == b.shape, i
        assert rel(a, b) < TOL[dtype], i
        assert rel(a, np.asarray(jh)) < max(TOL[dtype], 1e-6), i
        if dtype == np.float64:
            assert rel(a, np.asarray(ja)) < TOL[dtype], i


@pytest.mark.parametrize("name, rows, sms, cap", [
    ("compress3", 729_088, 132, None),   # the crystal
    ("compress2", 729_088, 132, None),
    ("combination", 729_088, 132, None),
    ("combination", 262_144, 132, None),  # the 2 x 2,048-atom training step
    ("compress3", 100_003, 114, None),
    ("combination", 1_000, 132, None),    # few rows: one chunk, one slice
    ("combination", 100_003, 132, 3 << 20),  # chunks of fewer tiles than SMs
])
def test_plan_covers_every_row_once(name, rows, sms, cap):
    code, w_in, w_hid = _widths(name)
    kw = {} if cap is None else {"cap": cap}
    plan = _lib.k4dw_plan(code, rows, w_in, w_hid, sms, **kw)
    assert plan == _lib.k4dw_plan(code, rows, w_in, w_hid, sms, **kw)  # the shape and the SMs alone
    assert plan.spill_bytes <= (cap or _lib.K4DW_SPILL_CAP)
    tiles = -(-rows // 64)
    assert plan.chunk_tiles == tiles or plan.chunk_tiles < sms or plan.chunk_tiles % sms == 0
    row_bytes = 4 * _lib.k4dw_row_floats(code, w_in, w_hid)
    assert plan.vec_offset >= plan.chunk_tiles * 64 * row_bytes and plan.vec_offset % 256 == 0
    chunks = _lib.k4dw_chunks(plan, rows)
    assert len(chunks) == plan.chunks
    covered = np.zeros(rows, np.int64)
    tiles_seen = []
    for r0, r1 in chunks:
        assert r0 % 64 == 0  # chunks start on whole tiles
        step, n = _lib.dw_slices(r1 - r0, _lib.k4dw_product_tiles(code, w_in // 128), sms)
        assert step % 64 == 0 and 1 <= n <= plan.max_slices and (n - 1) * step < r1 - r0
        for s in range(n):
            covered[r0 + s * step:min(r1, r0 + (s + 1) * step)] += 1
        t = -(-(r1 - r0) // 64)
        tiles_seen += [r0 // 64 + u for s in range(n) for u in range(t * s // n, t * (s + 1) // n)]
    assert (covered == 1).all()
    assert tiles_seen == list(range(tiles))  # every tile's vector row once, in order


def test_plan_at_the_crystal():
    """The crystal's combination: 5 chunks of 20 waves of tiles (528 MB of
    spill each); the 3-part compress 2 of 61 waves."""
    comb = _lib.k4dw_plan(1, 729_088, 256, 256, 132)
    assert (comb.chunks, comb.chunk_tiles) == (5, 20 * 132)
    comp = _lib.k4dw_plan(0, 729_088, 384, 128, 132)
    assert (comp.chunks, comp.chunk_tiles) == (2, 61 * 132)
    assert _lib.k4dw_product_tiles(1, 3) == 6 and _lib.k4dw_product_tiles(0, 3) == 4


@pytest.mark.parametrize("dtype, stage, d_part, w_in, w_hid, w_out, dw, takes", [
    (F32, 0, 128, 384, 128, 128, False, True),   # the f32 force call's compress
    (F32, 0, 128, 384, 128, 128, True, True),    # K4-dW's first pass
    (F32, 0, 128, 256, 128, 128, False, True),   # 2 parts
    (F32, 0, 128, 256, 128, 128, True, True),
    (F32, 1, 128, 256, 256, 128, False, True),   # the combination
    (F32, 1, 128, 256, 256, 128, True, True),
    (F32, 2, 128, 128, 128, 128, False, True),   # the head: the Hopper float32 head
    (F32, 2, 128, 128, 128, 128, True, True),
    (BF16, 0, 128, 384, 128, 128, False, False),  # bf16: the Hopper K4's
    (BF16, 1, 128, 256, 256, 128, True, False),   # bf16 K4-dW: the general body
    (F32, 0, 256, 768, 256, 256, True, False),    # d_pet 256
    (F32, 1, 256, 512, 512, 256, False, False),
    (F32, 0, 128, 512, 128, 128, False, False),   # 4 parts
    (torch.float64, 1, 128, 256, 256, 128, False, False),
])
def test_dispatch_rule(dtype, stage, d_part, w_in, w_hid, w_out, dw, takes):
    assert _lib.k4_f32_sm90_takes(dtype, stage, d_part, w_in, w_hid, w_out, dw) is takes
    assert (_lib.k4_f32_sm90_smem(stage, d_part, w_in, w_hid, w_out) > 0) is \
        _lib.k4_f32_sm90_takes(F32, stage, d_part, w_in, w_hid, w_out)


def test_smem_budget_fits_wherever_the_rule_takes():
    taken = {}
    for stage in (0, 1, 2):
        for d_part in (64, 128, 256):
            for w_in in range(d_part, 4 * d_part + 1, d_part):
                for w_hid in (d_part, 2 * d_part):
                    nbytes = _lib.k4_f32_sm90_smem(stage, d_part, w_in, w_hid, d_part)
                    if nbytes:
                        assert nbytes <= _lib.MAX_SHARED_BYTES
                        taken[(stage, w_in)] = nbytes
    # the ring, the x tile, d_pre, two g tiles, rs and the sums' scratch;
    # the combination also ln_scale and ln_bias, the head the h0 tile
    assert taken == {(0, 256): 194816, (0, 384): 227584, (1, 256): 229632, (2, 128): 195840}
    # the C source states the same layout
    text = (_lib.CSRC / "rowblock_bwd_f32_sm90.cu").read_text()
    assert "227,584 at 3 parts,\n// 194,816 at 2, 229,632 for the combination" in text


def _tf32(x):
    """cvt.rna.tf32.f32 in integer operations (the kernel's tf32())."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product_3xtf32(a, b, k_chunk=16):
    """a @ b as the kernel forms it: per staged chunk of 16 k, a_lo b_hi + a_hi
    b_lo + a_hi b_hi from zero (each operand split into hi = tf32(x) and lo =
    tf32(x - hi)), the chunks' sums added in float32 in order."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], k_chunk):
        s = slice(k, k + k_chunk)
        acc = acc + ((a_lo[:, s] @ b_hi[s] + a_hi[:, s] @ b_lo[s]) + a_hi[:, s] @ b_hi[s])
    return acc


@pytest.mark.parametrize("name", ["compress3", "combination"])
def test_3xtf32_products_keep_float32_accuracy(name):
    """Each of the stage's three products at the served widths, formed as the
    kernel forms it, lies within 1e-6 relative (max |error| / max |exact|) of
    the float64 product; one TF32 product misses that by orders of
    magnitude."""
    inputs, weights, g = _case(name, 256, np.float64, seed=11)
    stage, _, _ = _stages(name)
    xs, ws = [torch.from_numpy(a) for a in inputs], [torch.from_numpy(a) for a in weights]
    _, t = (tst._combination_terms if stage is tst.COMBINATION else tst._compress_terms)(
        xs, ws, torch.from_numpy(g))
    w0, w1 = (ws[2], ws[4]) if stage is tst.COMBINATION else (ws[0], ws[2])
    x = t["xn"] if stage is tst.COMBINATION else torch.cat(xs, dim=1)
    pairs = {"pre": (x, w0), "d_h": (torch.from_numpy(g), w1.T), "d_in": (t["d_pre"], w0.T)}
    for key, (a, b) in pairs.items():
        exact = a @ b
        assert rel(_product_3xtf32(a, b).double(), exact) < 1e-6, key
        assert rel((_tf32(a) @ _tf32(b)).double(), exact) > 1e-4, key


@pytest.mark.parametrize("name", ["compress2", "compress3", "combination"])
def test_cpu_backward_runs_the_plain_version(name):
    """Through ``rowblock`` on CPU float32 tensors at the widths the kernels
    take, the input and weight gradients are ``stage.bwd``'s bit for bit;
    the wrappers refuse CPU tensors, with and without weight gradients."""
    inputs, weights, g = _case(name, 200, np.float32, seed=5)
    stage, _, _ = _stages(name)
    code, w_in, w_hid = _widths(name)
    assert _lib.k4_f32_sm90_takes(F32, code, D, w_in, w_hid, D, True)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    ws = [torch.from_numpy(a).requires_grad_(True) for a in weights]
    tg = torch.from_numpy(g)
    out = trb.rowblock(stage, xs, ws)
    grads = torch.autograd.grad(out, xs + ws, tg)
    plain = stage.bwd([x.detach() for x in xs], [w.detach() for w in ws], tg, weight_grads=True)
    for a, b in zip(grads, plain):
        assert torch.equal(a, b)
    for weight_grads in (False, True):
        with pytest.raises(ValueError, match="cuda"):
            trb.rowblock_bwd_cuda(stage, [x.detach() for x in xs], [w.detach() for w in ws], tg,
                                  weight_grads)
    ops = trb.rowblock_dw_operands(stage, [x.detach() for x in xs], [w.detach() for w in ws], tg)
    with pytest.raises(ValueError, match="cuda"):
        trb.rowblock_dw_product_cuda(stage, [x.detach() for x in xs], tg, ops, sms=132)


def test_entry_points_take_the_bound_parameters():
    text = (_lib.CSRC / "rowblock_bwd_f32_sm90.cu").read_text()
    names = re.findall(r'extern "C" [\w ]+?\b(mtt_\w+)\(', text)
    assert sorted(names) == ["mtt_rowblock_bwd_dw_f32_sm90", "mtt_rowblock_bwd_dw_f32_sm90_plan",
                             "mtt_rowblock_bwd_f32_sm90", "mtt_rowblock_bwd_f32_sm90_ok",
                             "mtt_rowblock_bwd_f32_sm90_smem", "mtt_rowblock_dw_product"]
    assert "rowblock_bwd_f32_sm90.cu" in _lib.SOURCES
    for name in names:
        assert _params(text, name) == _lib._SIGNATURES[name], name


def _split_tool():
    path = Path(trb.__file__).resolve().parents[2] / "tools" / "k2_split.py"
    spec = importlib.util.spec_from_file_location("k2_split", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("body", ["k4dw-general", "k4-f32"])
def test_phase_split_tool_finds_the_k4_marks(body):
    """``tools/k2_split.py --body k4dw-general|k4-f32`` instruments a copy of
    the body at its phase marks, each in the source once: the general body's
    compress stamps phases 0-5 and its combination 0-4 and 6-8; the new
    body's compress 0-3 and its combination 4-10."""
    tool = _split_tool()
    source, marks, phases = {"k4dw-general": ("rowblock_bwd.cu", tool.K4DW_GENERAL, tool.K4DW_GENERAL_PHASES),
                             "k4-f32": ("rowblock_bwd_f32_sm90.cu", tool.K4_F32, tool.K4_F32_PHASES)}[body]
    text = tool.instrument((_lib.CSRC / source).read_text(), marks)
    n = len(phases)
    assert [f"SPLIT({i})" in text for i in range(n + 1)] == [True] * n + [False]
    assert n <= 16
