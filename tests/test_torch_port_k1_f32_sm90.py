"""The Hopper float32 K1 (``csrc/fused_layer_fwd_f32_sm90.cu``): which calls
take it, its shared-memory budget, its C entry points, what the wrapper
hands it, the accuracy of its 3xTF32 products, the forward it shares with
the Hopper float32 K2, and the CPU path beside it.

The kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``layer_math`` there, and ``tools/sm90_front.py --dtype float32``
its attn, res and h_norm against the Hopper float32 K2's recompute, bit
for bit). Here:

- the dispatch rule ``_lib.k1_f32_sm90_takes``: float32 at D = 128, heads
  of 16, 16 <= M <= 64 with M % 16 == 0, F a multiple of 128, without
  W8A8 or the int8 scores, with or without weight gradients;
- its budget ``_lib.k1_f32_sm90_smem`` (the C side's layout, mirrored)
  fits the 232,448 bytes a block may have at every shape it takes;
- the C entry points take the parameters ``_lib`` binds, and the wrapper
  passes them (w_qkv^T, w_out^T, w_in^T and w_ffn_out^T) and counts the
  launch, with and without weight gradients;
- both float32 Hopper kernels run the forward phases of
  ``csrc/layer_f32_sm90.cuh`` in the same order;
- three TF32 products of the operands split as x = hi + lo hold each of
  K1's products at the served widths within 1e-6 relative of float64,
  where one TF32 product does not;
- on the CPU the layer's float32 forward still comes from ``layer_math``,
  which matches the JAX package's ``_layer_math`` at 1e-5, and the wrapper
  refuses CPU tensors at the shapes the kernel takes;
- ``tools/k2_split.py`` (the new body and the general one) and
  ``tools/sm90_front.py`` find their marks.
"""

import ctypes
import importlib.util
import inspect
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import rel
from metatrain_tpu.ops.pallas import fused_layer as jfl
from metatrain_tpu_torch import _build
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import fused_layer as tfl

F32, BF16 = torch.float32, torch.bfloat16
D, H, F = 128, 8, 256
TOOLS = Path(tfl.__file__).resolve().parents[2] / "tools"


@pytest.mark.parametrize("dtype, M, D_, H_, F_, dw, w8, i8, takes", [
    (F32, 64, 128, 8, 256, False, False, False, True),    # the f32 force call
    (F32, 64, 128, 8, 256, True, False, False, True),     # the f32 training step
    (F32, 48, 128, 8, 256, False, False, False, True),
    (F32, 16, 128, 8, 256, True, False, False, True),
    (F32, 32, 128, 8, 512, False, False, False, True),
    (F32, 64, 128, 8, 128, True, False, False, True),
    (BF16, 64, 128, 8, 256, False, False, False, False),  # the bf16 Hopper K1's
    (BF16, 64, 128, 8, 256, True, False, False, False),
    (BF16, 64, 128, 8, 256, False, True, False, False),   # W8A8
    (BF16, 64, 128, 8, 256, False, False, True, False),   # int8 scores
    (F32, 64, 128, 8, 256, False, True, False, False),
    (F32, 64, 128, 8, 256, True, False, True, False),
    (F32, 80, 128, 8, 256, False, False, False, False),   # M > 64
    (F32, 96, 128, 8, 256, True, False, False, False),
    (F32, 56, 128, 8, 256, False, False, False, False),   # M % 16
    (F32, 64, 256, 16, 512, False, False, False, False),  # D = 256
    (F32, 64, 128, 16, 256, False, False, False, False),  # heads of 8
    (F32, 64, 128, 4, 256, True, False, False, False),    # heads of 32
    (F32, 64, 128, 8, 192, False, False, False, False),   # F % 128
    (torch.float64, 64, 128, 8, 256, False, False, False, False),
])
def test_dispatch_rule(dtype, M, D_, H_, F_, dw, w8, i8, takes):
    # weight gradients do not enter the rule: K2-dW's float32 first pass
    # recomputes this kernel's forward bit for bit
    assert _lib.k1_f32_sm90_takes(dtype, M, D_, H_, F_, w8, i8) is takes
    # the budget depends on the shape alone, and the shapes are the float32 K2's
    assert (_lib.k1_f32_sm90_smem(M, D_, H_, F_) > 0) is _lib.k1_f32_sm90_takes(F32, M, D_, H_, F_)
    assert _lib.k1_f32_sm90_takes(F32, M, D_, H_, F_) is _lib.k2_f32_sm90_takes(F32, M, D_, H_, F_)
    # the bf16 Hopper K1 never takes what this one takes
    assert not (takes and _lib.k1_sm90_takes(dtype, M, D_, H_, F_, w8, i8, dw))


def test_smem_budget_fits_every_shape_it_takes():
    taken = 0
    for M in range(16, 257, 16):
        for F_ in range(128, 2049, 128):
            nbytes = _lib.k1_f32_sm90_smem(M, 128, 8, F_)
            if M <= 64:
                # q|k|v, the operand tile, res, the ring, cf, r1 and r2
                assert nbytes == 192256 and nbytes <= _lib.MAX_SHARED_BYTES
                taken += 1
            else:
                assert nbytes == 0
    assert taken == 4 * 16


_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _params(source: str, name: str):
    """The ctypes types of ``extern "C" ... name(...)``'s parameters in
    ``source`` as ``_lib`` binds them: every pointer as c_void_p."""
    m = re.search(r'extern "C" [\w ]+?\b' + name + r"\(([^)]*)\)", source)
    assert m, name
    types = []
    for param in m.group(1).split(","):
        param = " ".join(param.replace("const", "").split())
        types.append(ctypes.c_void_p if "*" in param else _TYPES[param.rsplit(" ", 1)[0]])
    return types


def test_entry_points_take_the_bound_parameters():
    text = (_lib.CSRC / "fused_layer_fwd_f32_sm90.cu").read_text()
    names = re.findall(r'extern "C" [\w ]+?\b(mtt_\w+)\(', text)
    assert sorted(names) == ["mtt_fused_layer_fwd_f32_sm90", "mtt_fused_layer_fwd_f32_sm90_ok",
                             "mtt_fused_layer_fwd_f32_sm90_smem"]
    assert "fused_layer_fwd_f32_sm90.cu" in _lib.SOURCES
    for name in names:
        assert _params(text, name) == _lib._SIGNATURES[name], name
    # the bf16 Hopper K1 and this one take the same arguments (one wrapper)
    assert _lib._SIGNATURES["mtt_fused_layer_fwd_f32_sm90"] == _lib._SIGNATURES[
        "mtt_fused_layer_fwd_sm90"]


def test_both_f32_kernels_run_the_shared_forward_in_order():
    """The Hopper float32 K1 and K2 include ``layer_f32_sm90.cuh`` (the build
    recompiles both when it changes) and call its phases in the same order,
    on the same buffers: K1's attn, res and h_norm are the K2 recompute's."""
    phases = r"\b(rms_rows|qkv_panels|attention_fwd|out_proj|vg_panels)\("
    calls = {}
    for unit in ("fused_layer_fwd_f32_sm90.cu", "fused_layer_bwd_f32_sm90.cu"):
        deps = {p.name for p in _build.includes(_lib.CSRC / unit)}
        assert {"layer_f32_sm90.cuh", "tf32_sm90.cuh"} <= deps, unit
        text = (_lib.CSRC / unit).read_text()
        body = text[text.index("__global__"):]
        calls[unit] = re.findall(phases, body)
    assert calls["fused_layer_fwd_f32_sm90.cu"] == [
        "rms_rows", "qkv_panels", "attention_fwd", "out_proj", "rms_rows", "vg_panels"]
    assert calls["fused_layer_bwd_f32_sm90.cu"] == calls["fused_layer_fwd_f32_sm90.cu"]
    header = (_lib.CSRC / "layer_f32_sm90.cuh").read_text()
    for name in ("rms_rows", "qkv_panels", "attention_fwd", "out_proj", "vg_panels"):
        assert re.search(r"__device__ __forceinline__ void " + name + r"\(", header), name


class _FakeLibrary:
    """Records the entry points called and copies the f32 K1's weight
    matrices out of the host pointers it is handed (CPU tensors)."""

    def __init__(self):
        self.called, self.matrices = [], None

    def __getattr__(self, name):
        def entry(*args):
            self.called.append(name)
            if name.endswith("_smem"):
                return 192256 if "f32_sm90" in name else 0
            if name == "mtt_fused_layer_fwd_f32_sm90":
                shapes = ((3 * D, D), (D, D), (2 * F, D), (D, F))
                self.matrices = [
                    torch.from_numpy(np.ctypeslib.as_array(
                        (ctypes.c_float * (r * c)).from_address(ptr)).reshape(r, c).copy())
                    for ptr, (r, c) in zip(args[9:13], shapes)]
            return 0
        entry.__name__ = name
        return entry


@pytest.mark.parametrize("weight_grads, sm90, kernel", [
    (False, True, "fused_layer_fwd_f32_sm90"),
    (True, True, "fused_layer_fwd_f32_sm90"),
    (False, False, "fused_layer_fwd"),
])
def test_wrapper_launches_the_kernel_it_counts(monkeypatch, weight_grads, sm90, kernel):
    """At a shape the rule takes, ``fused_layer_fwd_cuda`` in float32 calls
    the Hopper float32 K1's entry with w_qkv^T, w_out^T, w_in^T and
    w_ffn_out^T, with or without weight gradients, and counts it;
    ``sm90=False`` calls the general body instead (the library and the
    device checks are stubbed: CPU tensors stand in for the card's)."""
    fake = _FakeLibrary()
    monkeypatch.setattr(_lib, "library", lambda: fake)
    monkeypatch.setattr(_lib, "require", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "stream_ptr", lambda device: 0)
    edges, center, cf, w, _, _ = (
        torch.from_numpy(x).float() if isinstance(x, np.ndarray)
        else tfl.LayerWeights(*(torch.from_numpy(y).float() for y in x))
        for x in _inputs(3, 64))
    before = dict(_lib.LAUNCHES)
    tfl.fused_layer_fwd_cuda(edges, center, cf, w, H, 0.25, sm90=sm90, weight_grads=weight_grads)
    assert fake.called[-1] == f"mtt_{kernel}"
    assert _lib.LAUNCHES[kernel] == before.get(kernel, 0) + 1
    if kernel == "fused_layer_fwd_f32_sm90":
        expected = (w.w_qkv.T, w.w_out.T, w.w_in.T, w.w_ffn_out.T)
        for got, want in zip(fake.matrices, expected):
            assert torch.equal(got, want)
    else:
        assert "mtt_fused_layer_fwd_f32_sm90" not in fake.called


def _inputs(A, M, seed=0):
    """numpy inputs of one layer at the served widths (float64)."""
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
    return x[0], x[1], cf, w, x[2], x[3]


def _tf32(x):
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (the low 13 bits cleared)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product_3xtf32(a, b):
    """a @ b as the kernel forms it: a_lo b_hi + a_hi b_lo + a_hi b_hi,
    each operand split into hi = tf32(x) and lo = tf32(x - hi), summed in
    float32."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _products(M=64, A=4):
    """The (A, B) operand pairs of K1's dense products and of one head's
    attention products, from the float32 forward's intermediates at the
    served widths, as float64."""
    edges, center, cf, w, _, _ = _inputs(A, M, seed=7)
    e, c, f = (torch.from_numpy(x).float() for x in (edges, center, cf))
    wt = tfl.LayerWeights(*(torch.from_numpy(x).float() for x in w))
    _, _, (n1, q, k, h_norm, ffn_h) = tfl._layer_forward(e, c, f, wt, H, 1.0 / math.sqrt(D // H))
    wd = tfl.LayerWeights(*(x.double() for x in wt))
    rows = lambda x: x.reshape(A * M, -1).double()  # noqa: E731
    # one head of atom 0: the scores, the softmax weights P, P v, attn
    hs = slice(0, D // H)
    v = rows(n1).reshape(A, M, D)[0].matmul(wd.w_qkv[:, 2 * D:]).add(wd.b_qkv[2 * D:])[:, hs]
    q0, k0 = q[0, :, hs].double(), k[0, :, hs].double()
    s = q0 @ k0.T / math.sqrt(D // H)
    e_ = torch.exp(s - s.amax(1, keepdim=True))
    cfk = f[0].double()
    p = cfk * e_ / (e_ * cfk).sum(1, keepdim=True)
    # attn, every head: the out-projection's operand
    qkv = rows(n1) @ wd.w_qkv + wd.b_qkv
    qh, kh, vh = qkv.reshape(A, M, 3, H, D // H).unbind(2)
    sc = torch.einsum("aqhd,akhd->ahqk", qh, kh) / math.sqrt(D // H)
    ex = torch.exp(sc - sc.amax(-1, keepdim=True))
    cf_k = f.double()[:, None, None, :]
    attn = torch.einsum("ahqk,akhd->aqhd", cf_k * ex / (ex * cf_k).sum(-1, keepdim=True), vh)
    return {"qkv": (rows(n1), wd.w_qkv), "scores": (q0, k0.T), "p_v": (p, v),
            "out": (attn.reshape(A * M, D), wd.w_out), "ffn_in": (rows(h_norm), wd.w_in),
            "ffn_out": (rows(ffn_h), wd.w_ffn_out)}


def test_3xtf32_products_keep_float32_accuracy():
    """Every product of K1, formed as the kernel forms it, lies within 1e-6
    relative (max |error| / max |exact|) of the float64 product; one TF32
    product (hi b_hi alone: what ``allow_tf32`` would give) misses that by
    orders of magnitude, which is why the kernel splits."""
    pairs = _products()
    assert sorted(pairs) == ["ffn_in", "ffn_out", "out", "p_v", "qkv", "scores"]
    for name, (a, b) in pairs.items():
        exact = a @ b
        three = _product_3xtf32(a, b).double()
        one = (_tf32(a) @ _tf32(b)).double()
        assert rel(three, exact) < 1e-6, name
        assert rel(one, exact) > 1e-4, name


@pytest.mark.parametrize("M, weight_grads", [(64, False), (32, True)])
def test_cpu_forward_runs_the_plain_version_and_matches_jax(M, weight_grads):
    """On CPU float32 tensors at a shape the kernel takes, the layer's
    forward is ``layer_math``'s bit for bit (weights requiring grad or not),
    and it matches the JAX package's ``_layer_math`` at 1e-5; the wrapper
    refuses CPU tensors, with and without ``sm90`` and weight gradients."""
    edges, center, cf, w, _, _ = (
        x.astype(np.float32) if isinstance(x, np.ndarray) else [y.astype(np.float32) for y in x]
        for x in _inputs(2, M, seed=M))
    scale = 1.0 / math.sqrt(D // H)
    assert _lib.k1_f32_sm90_takes(F32, M, D, H, F)
    tw = tfl.LayerWeights(*(torch.from_numpy(x).requires_grad_(weight_grads) for x in w))
    te, tc, tf = (torch.from_numpy(x) for x in (edges, center, cf))
    out = tfl.fused_transformer_layer(te, tc, tf, tw, H, scale)
    with torch.no_grad():
        plain = tfl.layer_math(te, tc, tf, tw, H, scale)
    for a, b in zip(out, plain):
        assert torch.equal(a.detach(), b)
    j_out = jfl._layer_math(jnp.asarray(edges), jnp.asarray(center), jnp.asarray(cf),
                            jfl.LayerWeights(*(jnp.asarray(x) for x in w)), H, scale)
    for a, b in zip(plain, j_out):
        assert rel(a.numpy(), np.asarray(b)) < 1e-5
    assert (plain[0][:, M - 1] == 0).all()
    for sm90 in (True, False):
        with pytest.raises(ValueError, match="cuda"):
            tfl.fused_layer_fwd_cuda(te, tc, tf, tw, H, scale, sm90=sm90,
                                     weight_grads=weight_grads)


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("source, body", [("fused_layer_fwd_f32_sm90.cu", "K1_F32"),
                                          ("layer_fwd.cuh", "K1_GENERAL")])
def test_phase_split_tool_finds_the_k1_marks(source, body):
    """``tools/k2_split.py --body k1-f32`` (the new kernel) and ``--body
    k1-general`` (the general body it replaces at these shapes) instrument a
    copy of the source at five phase marks, each in the source once."""
    tool = _tool("k2_split")
    text = tool.instrument((tool.CSRC / source).read_text(), getattr(tool, body))
    assert [f"SPLIT({i})" in text for i in range(6)] == [True] * 5 + [False]
    assert len(getattr(tool, f"{body}_PHASES")) == 5
    # the counters are read back whole (16 of them) into a buffer that holds them
    assert "g_split, 128)" in tool.COUNTERS
    assert "c_ulonglong * 16)()" in inspect.getsource(tool.main)
    assert "c_ulonglong * 8)" not in inspect.getsource(tool)


def test_front_bits_tool_finds_the_f32_marks():
    """``tools/sm90_front.py --dtype float32`` copies attn, res and h_norm
    out of copies of the Hopper float32 K1 and K2 at its marks: every mark
    is in its source once, and the copies read float rows of LT."""
    tool = _tool("sm90_front")
    for key, source, marks in tool.KERNELS["float32"]:
        text = tool.instrument((tool.CSRC / source).read_text(), marks)
        assert text.count("g_dump[") == 3, source
        assert "__device__ float* g_dump;" in text and "* LT + i_ % D]" in text


def test_path_times_tool_reads_chip_smoke_cases():
    """``tools/f32_path_times.py`` times the cases ``chip_smoke.py`` builds:
    the helpers it calls are there."""
    import chip_smoke

    text = (TOOLS / "f32_path_times.py").read_text()
    for name in set(re.findall(r"\bcs\.(\w+)\(", text)):
        assert callable(getattr(chip_smoke, name)), name
