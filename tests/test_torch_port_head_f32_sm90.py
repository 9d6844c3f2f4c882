"""The Hopper float32 head: the head stage of the Hopper float32 K3
(``csrc/rowblock_fwd_f32_sm90.cu``), K4 and the two-pass K4-dW
(``csrc/rowblock_bwd_f32_sm90.cu``), whose forward up to pre1 is
``head_pre1`` of ``csrc/rowblock_f32_sm90.cuh``.

The kernels run only on the card (``chip_smoke.py`` holds them against
``head_math`` / ``head_bwd`` there, and ``tools/sm90_front.py --kernel
rowblock --stage head`` the K3 head's pre0, h0 and pre1 against the K4
head's recompute, bit for bit). Here:

- the dispatch rule: the head at d_part = w_hid = w_out = 128 in float32,
  with and without weight gradients, the same rule for K3 and K4; not in
  bfloat16, not at d_pet 256, not at narrower heads;
- the shared-memory budgets (the C side's layout, mirrored);
- the head's four products formed as the kernels form them (3xTF32 in
  numpy, each staged chunk of 16 k summed from zero) stay within 1e-6 of
  float64;
- the first pass's plain version ``head_operands`` and the second's
  ``rowblock_dw_from_operands``, summed in the kernels' chunk, slice and tile
  order, give ``head_bwd(..., weight_grads=True)`` and the JAX package's
  (1e-12 relative in float64 against ``jax.vjp`` of ``head_math``, 1e-6
  against JAX's hand-written ``head_bwd``, whose weight gradients are float32
  sums; 1e-5 in float32), at row counts that end in a partial tile;
- on the CPU the head's forward and backward are the plain versions, which
  match the JAX package's ``head_math`` and its ``fused_rowblock``
  (interpret mode); the wrappers refuse CPU tensors;
- both float32 row-block kernels call the header's ``head_pre1``;
- the wrappers pass the head's weights and count the three head kernels;
- the tools and ``chip_smoke.py`` know the head.
"""

import ctypes
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
from metatrain_tpu.ops.pallas.rowblock import fused_rowblock
from metatrain_tpu_torch import _build
from metatrain_tpu_torch.models.pet import fused_stages as tst
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import rowblock as trb

F32, BF16 = torch.float32, torch.bfloat16
D = 128
HEAD = trb.HEAD_CODE
ROOT = Path(trb.__file__).resolve().parents[3]
TOOLS = ROOT / "metatrain_tpu_torch" / "tools"
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _case(rows, dtype, seed=0, width=D):
    """numpy x, weights (w0, b0, w1, b1) and cotangent of a head."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, width))
    weights = [rng.normal(size=(width, width)) / np.sqrt(width), 0.1 * rng.normal(size=width),
               rng.normal(size=(width, width)) / np.sqrt(width), 0.1 * rng.normal(size=width)]
    g = rng.normal(size=(rows, width))
    return x.astype(dtype), [w.astype(dtype) for w in weights], g.astype(dtype)


def _torch(x, weights, g):
    return [torch.from_numpy(x)], [torch.from_numpy(w) for w in weights], torch.from_numpy(g)


@pytest.mark.parametrize("dtype, d_part, w_in, w_hid, w_out, dw, takes", [
    (F32, 128, 128, 128, 128, False, True),   # the f32 force call's head
    (F32, 128, 128, 128, 128, True, True),    # the f32 training step's
    (BF16, 128, 128, 128, 128, False, False),  # bf16: the Hopper K3 / K4 head
    (BF16, 128, 128, 128, 128, True, False),   # bf16 training: the general body
    (F32, 256, 256, 256, 256, False, False),  # d_pet 256
    (F32, 256, 256, 256, 256, True, False),
    (F32, 64, 64, 64, 64, False, False),      # narrower heads
    (F32, 32, 32, 32, 32, True, False),
    (F32, 16, 16, 16, 16, False, False),
    (F32, 8, 8, 8, 8, False, False),
    (F32, 128, 128, 64, 128, False, False),   # another hidden width
    (torch.float64, 128, 128, 128, 128, False, False),
])
def test_dispatch_rule(dtype, d_part, w_in, w_hid, w_out, dw, takes):
    """The head's rule is the f32 K4's and the f32 K3's alike: the K3 head's
    forward is the K4 head's recompute."""
    assert _lib.k4_f32_sm90_takes(dtype, HEAD, d_part, w_in, w_hid, w_out, dw) is takes
    assert _lib.k3_f32_sm90_takes(dtype, HEAD, d_part, w_in, w_hid, w_out, dw) is takes
    for smem in (_lib.k3_f32_sm90_smem, _lib.k4_f32_sm90_smem):
        assert (smem(HEAD, d_part, w_in, w_hid, w_out) > 0) is \
            _lib.k4_f32_sm90_takes(F32, HEAD, d_part, w_in, w_hid, w_out)
    # the bf16 Hopper kernels never take what these take
    assert not (takes and (_lib.k3_sm90_takes(dtype, HEAD, d_part, w_in, w_hid, w_out, dw)
                           or _lib.k4_sm90_takes(dtype, HEAD, d_part, w_in, w_hid, w_out, dw)))


def test_smem_budgets_and_spill_widths():
    """K3 head: the ring, the x tile, the h0 tile; K4 head: the compress's
    layout at one part and the h0 tile. One block per SM each; K4-dW head
    spills d_pre0, h0, d_pre1 a row and two 128-float sums a tile, and its
    second pass forms two 128 x 128 tiles."""
    assert _lib.k3_f32_sm90_smem(HEAD, D, D, D, D) == 92160
    assert _lib.k4_f32_sm90_smem(HEAD, D, D, D, D) == 195840
    assert max(_lib.k3_f32_sm90_smem(HEAD, D, D, D, D), _lib.k4_f32_sm90_smem(HEAD, D, D, D, D)) \
        <= _lib.MAX_SHARED_BYTES
    assert "The head: 92,160" in (_lib.CSRC / "rowblock_fwd_f32_sm90.cu").read_text()
    assert "the compress's at 1 part and the h0 tile 64 x 132 x 4, 195,840" in \
        (_lib.CSRC / "rowblock_bwd_f32_sm90.cu").read_text()
    assert _lib.k4dw_row_floats(HEAD, D, D) == 3 * D
    assert _lib.k4dw_vector_floats(HEAD, D, D) == 2 * D
    assert _lib.k4dw_product_tiles(HEAD, 1) == 2


def _tf32_np(a):
    """cvt.rna.tf32.f32 in integer operations (the kernels' tf32()), numpy."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _product_3xtf32_np(a, b, k_chunk=16):
    """a @ b as the kernels form it, in numpy: per staged chunk of 16 k,
    a_lo b_hi + a_hi b_lo + a_hi b_hi from zero (each operand split into hi =
    tf32(x) and lo = tf32(x - hi)), the chunks' sums added in float32 in
    order."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    a_hi, b_hi = _tf32_np(a), _tf32_np(b)
    a_lo, b_lo = _tf32_np(a - a_hi), _tf32_np(b - b_hi)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], k_chunk):
        s = slice(k, k + k_chunk)
        acc = acc + ((a_lo[:, s] @ b_hi[s] + a_hi[:, s] @ b_lo[s]) + a_hi[:, s] @ b_hi[s])
    return acc


@pytest.mark.parametrize("product", ["pre0", "pre1", "d_h0", "d_x"])
def test_3xtf32_products_keep_float32_accuracy(product):
    """Each of the head's four products at the served widths (pre0 = x w0,
    pre1 = h0 w1, d_h0 = d_pre1 w1^T, d_x = d_pre0 w0^T), formed as the
    kernels form it, lies within 1e-6 relative (max |error| / max |exact|)
    of the float64 product; one TF32 product misses that by orders of
    magnitude."""
    x, (w0, b0, w1, b1), g = _case(256, np.float64, seed=11)
    pre0 = x @ w0 + b0
    h0 = pre0 / (1 + np.exp(-pre0))
    pre1 = h0 @ w1 + b1
    s1 = 1 / (1 + np.exp(-pre1))
    d_pre1 = g * s1 * (1 + pre1 * (1 - s1))
    s0 = 1 / (1 + np.exp(-pre0))
    d_pre0 = (d_pre1 @ w1.T) * s0 * (1 + pre0 * (1 - s0))
    a, b = {"pre0": (x, w0), "pre1": (h0, w1), "d_h0": (d_pre1, w1.T), "d_x": (d_pre0, w0.T)}[product]
    exact = a @ b
    assert rel(_product_3xtf32_np(a, b).astype(np.float64), exact) < 1e-6
    assert rel((_tf32_np(a) @ _tf32_np(b)).astype(np.float64), exact) > 1e-4


def _plan(rows, chunks, sms=132):
    """The kernels' plan for the head, its cap set so that the rows fall
    into ``chunks``."""
    tile = 4 * (64 * _lib.k4dw_row_floats(HEAD, D, D) + _lib.k4dw_vector_floats(HEAD, D, D))
    tiles = -(-rows // 64)
    cap = _lib.K4DW_SPILL_CAP if chunks == 1 else tile * -(-tiles // chunks)
    plan = _lib.k4dw_plan(HEAD, rows, D, D, sms, cap)
    assert plan.chunks == chunks
    return plan


# (rows, dtype, chunks): row counts that end in a partial tile, one chunk and
# several; 1,300 rows at 132 SMs are one chunk of several slices
@pytest.mark.parametrize("rows, dtype, chunks", [
    (200, np.float64, 1), (333, np.float64, 3), (1300, np.float64, 1), (130, np.float64, 2),
    (300, np.float32, 2), (1300, np.float32, 1), (77, np.float32, 1),
])
def test_two_passes_match_the_plain_backward_and_jax(rows, dtype, chunks):
    x, weights, g = _case(rows, dtype, seed=rows)
    xs, ws, tg = _torch(x, weights, g)
    ops = trb.rowblock_dw_operands(tst.HEAD, xs, ws, tg)
    assert ops.vectors.shape == (-(-rows // 64), _lib.k4dw_vector_floats(HEAD, D, D))
    assert [r.shape for r in ops.rows] == [(rows, D)] * 3
    assert sum(r.shape[1] for r in ops.rows) == _lib.k4dw_row_floats(HEAD, D, D)
    two_pass = trb.rowblock_dw_from_operands(tst.HEAD, xs, tg, ops, _plan(rows, chunks))
    plain = tst.head_bwd(xs, ws, tg, weight_grads=True)
    assert torch.equal(ops.d_inputs[0], plain[0])  # the first pass's cotangent is head_bwd's
    jx, jw, jg = [jnp.asarray(x)], [jnp.asarray(w) for w in weights], jnp.asarray(g)
    (j_dx,), j_hand = jst.head_bwd(jx, jw, (jg,), True)
    _, vjp = jax.vjp(lambda xx, ww: jst.head_math(xx, ww), jx, jw)
    j_auto_x, j_auto = vjp((jg,))
    assert rel(plain[0], np.asarray(j_dx)) < TOL[dtype]
    if dtype == np.float64:
        assert rel(plain[0], np.asarray(j_auto_x[0])) < TOL[dtype]
    assert len(two_pass) == len(plain) - 1 == len(j_hand) == len(j_auto) == 4
    for i, (a, b, jh, ja) in enumerate(zip(two_pass, plain[1:], j_hand, j_auto)):
        assert a.shape == b.shape == ws[i].shape, i
        assert rel(a, b) < TOL[dtype], i
        assert rel(a, np.asarray(jh)) < max(TOL[dtype], 1e-6), i
        if dtype == np.float64:
            assert rel(a, np.asarray(ja)) < TOL[dtype], i


def test_head_operands_are_the_terms_of_head_bwd():
    """``head_operands``' rows are d_pre0, h0, d_pre1 and its vector rows
    their sums' terms: the plain backward's weight gradients are their
    products and sums."""
    x, weights, g = _case(150, np.float64, seed=4)
    xs, ws, tg = _torch(x, weights, g)
    (d_x,), (d_pre0, h0, d_pre1), vec = tst.head_operands(xs, ws, tg)
    dw0, db0, dw1, db1 = tst.head_bwd(xs, ws, tg, weight_grads=True)[1:]
    assert torch.equal(dw0, xs[0].T @ d_pre0) and torch.equal(dw1, h0.T @ d_pre1)
    assert torch.equal(vec, torch.cat([d_pre0, d_pre1], dim=1))
    assert torch.equal(db0, d_pre0.sum(0)) and torch.equal(db1, d_pre1.sum(0))
    pre0 = xs[0] @ ws[0] + ws[1]
    assert torch.equal(h0, pre0 * torch.sigmoid(pre0))
    assert torch.equal(d_x, tst.head_bwd(xs, ws, tg)[0])
    assert tst.HEAD.operands is tst.head_operands


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cpu_paths_run_the_plain_versions_and_match_jax(dtype):
    """Through ``rowblock`` on CPU tensors at the widths the kernels take,
    the forward is ``head_math`` and the gradients ``head_bwd``'s bit for
    bit; the forward matches the JAX package's ``head_math``; the wrappers
    refuse CPU tensors."""
    x, weights, g = _case(200, dtype, seed=5)
    assert _lib.k4_f32_sm90_takes(F32, HEAD, D, D, D, D, True)
    xs = [torch.from_numpy(x).requires_grad_(True)]
    ws = [torch.from_numpy(w).requires_grad_(True) for w in weights]
    tg = torch.from_numpy(g)
    out = trb.rowblock(tst.HEAD, xs, ws)
    assert torch.equal(out.detach(), tst.head_math([xs[0].detach()], [w.detach() for w in ws]))
    (j_out,) = jst.head_math([jnp.asarray(x)], [jnp.asarray(w) for w in weights])
    assert rel(out.detach().numpy(), np.asarray(j_out)) < TOL[dtype]
    grads = torch.autograd.grad(out, xs + ws, tg)
    plain = tst.head_bwd([xs[0].detach()], [w.detach() for w in ws], tg, weight_grads=True)
    for a, b in zip(grads, plain):
        assert torch.equal(a, b)
    dx, dw = [xs[0].detach()], [w.detach() for w in ws]
    for weight_grads in (False, True):
        with pytest.raises(ValueError, match="cuda"):
            trb.rowblock_fwd_cuda(tst.HEAD, dx, dw, weight_grads=weight_grads)
        with pytest.raises(ValueError, match="cuda"):
            trb.rowblock_bwd_cuda(tst.HEAD, dx, dw, tg, weight_grads)
    ops = trb.rowblock_dw_operands(tst.HEAD, dx, dw, tg)
    with pytest.raises(ValueError, match="cuda"):
        trb.rowblock_dw_product_cuda(tst.HEAD, dx, tg, ops, sms=132)


def test_plain_forward_matches_jax_pallas_in_float32():
    """In float32 at the served widths the port's plain head and the JAX
    package's ``fused_rowblock`` (its Pallas kernel in interpret mode) agree
    within 1e-5 relative: the function the Hopper float32 K3 head is held to
    on the card."""
    x, weights, _ = _case(160, np.float32, seed=6)
    (j_out,) = fused_rowblock(jst.head_math, (jnp.asarray(x),), tuple(jnp.asarray(w) for w in weights))
    t_out = tst.head_math([torch.from_numpy(x)], [torch.from_numpy(w) for w in weights])
    assert t_out.dtype == F32 and t_out.shape == j_out.shape
    assert rel(t_out.numpy(), np.asarray(j_out)) < 1e-5


def test_both_f32_kernels_run_the_shared_head_forward():
    """The f32 K3 head and the f32 K4 head call the header's ``head_pre1``
    once each, with the same arguments, and keep no copy of their own; in
    the header it is the one-part compress's pre product, SiLU into the h
    tile, then the pre1 product and its bias, in that order."""
    call = "    head_pre1(ring, c, X, H, p.b0, p.b1, pre0, pre1);\n"
    for unit in ("rowblock_fwd_f32_sm90.cu", "rowblock_bwd_f32_sm90.cu"):
        deps = {p.name for p in _build.includes(_lib.CSRC / unit)}
        assert {"rowblock_f32_sm90.cuh", "tf32_sm90.cuh"} <= deps, unit
        text = (_lib.CSRC / unit).read_text()
        body = re.sub(r"//[^\n]*", "", text)
        assert body.count(call) == 1, unit
        assert len(re.findall(r"\bhead_pre1\(", body)) == 1, unit
        assert "void head_pre1(" not in body, unit
    header = (_lib.CSRC / "rowblock_f32_sm90.cuh").read_text()
    body = header[header.index("void head_pre1("):]
    body = body[:body.index("\n}\n")]
    order = re.findall(r"\b(compress_pre<1>|hidden|panel_mm<[^>]+>|add_bias)\(", body)
    assert order == ["compress_pre<1>", "hidden", "hidden", "panel_mm<W::W_HID / kCK>", "add_bias"]


def _matrix(ptr):
    return torch.from_numpy(np.ctypeslib.as_array((ctypes.c_float * (D * D)).from_address(ptr))
                            .reshape(D, D).copy())


class _FakeLibrary:
    """Records the entry points called, their arguments and copies of the
    128 x 128 weight matrices they are handed (CPU tensors stand in for the
    card's; the wrappers free their transposes after the call)."""

    MATRICES = {"mtt_rowblock_fwd_f32_sm90": (7, 9), "mtt_rowblock_bwd_f32_sm90": (8, 9, 10, 11),
                "mtt_rowblock_bwd_dw_f32_sm90": (8, 9, 10, 11)}

    def __init__(self):
        self.calls, self.matrices = {}, {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            self.matrices[name] = [_matrix(args[i]) for i in self.MATRICES.get(name, ())]
            return 1000 if name.endswith("_smem") else 0
        entry.__name__ = name
        return entry


@pytest.mark.parametrize("kind, weight_grads, counters", [
    ("fwd", False, ["rowblock_fwd_f32_sm90[head]"]),
    ("fwd", True, ["rowblock_fwd_f32_sm90[head]"]),
    ("bwd", False, ["rowblock_bwd_f32_sm90[head]"]),
    ("bwd", True, ["rowblock_bwd_dw_f32_sm90[head]", "rowblock_dw_product"]),
])
def test_wrapper_launches_the_head_kernels_it_counts(monkeypatch, kind, weight_grads, counters):
    """At the widths the rule takes, the float32 wrappers call the Hopper
    float32 head's entries and count them: K3 with w0^T and w1^T, K4 and
    K4-dW with w0^T, w1, w0, w1^T and b1 (the library and the device checks
    are stubbed)."""
    x, weights, g = _case(100, np.float32, seed=1)
    fake = _FakeLibrary()
    monkeypatch.setattr(_lib, "library", lambda: fake)
    monkeypatch.setattr(_lib, "require", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(_lib, "dw_blocks", lambda items, device: 132)
    monkeypatch.setattr(_lib, "sm_count", lambda device: 132)
    xs, ws, tg = _torch(x, weights, g)
    before = {k: _lib.LAUNCHES[k] for k in counters}
    general = ("rowblock_fwd[head]", "rowblock_bwd[head]", "rowblock_bwd_dw[head]")
    general_before = {k: _lib.LAUNCHES[k] for k in general}
    if kind == "fwd":
        out = trb.rowblock_fwd_cuda(tst.HEAD, xs, ws, weight_grads=weight_grads)
        assert out.shape == (100, D)
        args = fake.calls["mtt_rowblock_fwd_f32_sm90"]
        assert args[0] == HEAD and args[4] == 1  # one input
        for got, want in zip(fake.matrices["mtt_rowblock_fwd_f32_sm90"], (ws[0].T, ws[2].T)):
            assert torch.equal(got, want)
        assert args[8] == ws[1].data_ptr() and args[10] == ws[3].data_ptr()
    else:
        out = trb.rowblock_bwd_cuda(tst.HEAD, xs, ws, tg, weight_grads)
        assert len(out) == (5 if weight_grads else 1)
        entry = "mtt_rowblock_bwd_dw_f32_sm90" if weight_grads else "mtt_rowblock_bwd_f32_sm90"
        args = fake.calls[entry]
        assert args[0] == HEAD and args[4] == 1
        # b0, w0^T, w1, w0, w1^T, b1
        assert args[7] == ws[1].data_ptr() and args[12] == ws[3].data_ptr()
        for got, want in zip(fake.matrices[entry], (ws[0].T, ws[2], ws[0], ws[2].T)):
            assert torch.equal(got, want)
        assert args[13] == tg.data_ptr()
    for k in counters:
        assert _lib.LAUNCHES[k] == before[k] + 1, k
    assert {k: _lib.LAUNCHES[k] for k in general} == general_before


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_front_bits_tool_finds_the_head_marks():
    """``tools/sm90_front.py --kernel rowblock --stage head`` copies pre0,
    pre1 (registers) and h0 (the h tile) out of copies of the f32 K3 head and
    the f32 K4 head at one mark, the ``head_pre1`` call, which each source
    holds once: the two copies take the same values."""
    tool = _tool("sm90_front")
    texts = {}
    for key, source, marks in tool.ROWBLOCK_KERNELS["head"]:
        text = tool.instrument((tool.CSRC / source).read_text(), marks)
        assert "__device__ float* g_dump;" in text and "d_[512] = pre1[j_][2 * h_];" in text
        assert "H[m_ * Widths<kHead, 1>::LH + k_]" in text
        texts[key] = text
    assert sorted(texts) == ["k3", "k4"]
    assert [s for _, s, _ in tool.ROWBLOCK_KERNELS["head"]] == ["rowblock_fwd_f32_sm90.cu",
                                                                 "rowblock_bwd_f32_sm90.cu"]


def test_layer_times_tool_reports_the_f32_head():
    """``tools/layer_times.py`` times and digests the float32 head's K3, K4
    and K4-dW after the compress and combination (whose inputs stay those
    of trees without it), with the general bodies beside."""
    text = (TOOLS / "layer_times.py").read_text()
    assert 'digests[f"{name}[head]_f32"]' in text
    for name in ("rowblock_bwd_general", "rowblock_bwd_dw_general"):
        assert f'("{name}"' in text, name
    assert text.index('("combination", COMBINATION, 3)):\n        xs = tuple(torch.randn(rows, D, '
                      'generator=gen).to(dev) for') < text.index('digests[f"{name}[head]_f32"]')


def test_chip_smoke_expects_the_f32_heads():
    """``chip_smoke.py``'s launch tables: a f32 force call launches the f32
    K3 head and the f32 K4 head once each, a f32 step the f32 K3 head once
    and K4-dW head twice (ten second passes), and the general heads never
    at d_pet 128; the kernel line holds the three new entries."""
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.K3_F32_PER_STEP == {"rowblock_fwd_f32_sm90[compress]": 2,
                                  "rowblock_fwd_f32_sm90[combination]": 2,
                                  "rowblock_fwd_f32_sm90[head]": 1}
    assert cs.K4_F32_PER_CALL == {"rowblock_bwd_f32_sm90[compress]": 2,
                                  "rowblock_bwd_f32_sm90[combination]": 2,
                                  "rowblock_bwd_f32_sm90[head]": 1}
    assert cs.K4DW_F32_PER_STEP == {"rowblock_bwd_dw_f32_sm90[compress]": 4,
                                    "rowblock_bwd_dw_f32_sm90[combination]": 4,
                                    "rowblock_bwd_dw_f32_sm90[head]": 2, "rowblock_dw_product": 10}
    for name in ("rowblock_fwd[head]", "rowblock_bwd[head]", "rowblock_bwd_dw[head]"):
        assert name in cs.K3_F32_NEVER + cs.K4_F32_NEVER, name
    for name in ("rowblock_fwd_f32_sm90", "rowblock_bwd_f32_sm90", "rowblock_bwd_dw_f32_sm90"):
        assert name in cs.SOURCES
    assert cs.N_ENTRIES == 53
