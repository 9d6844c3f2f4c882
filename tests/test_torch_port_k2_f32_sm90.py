"""The Hopper float32 K2 (``csrc/fused_layer_bwd_f32_sm90.cu``): which calls
take it, its shared-memory budget, its C entry points, the accuracy of its
3xTF32 products, and the CPU path beside it.

The kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``layer_bwd_math`` there, and the two-pass K2-dW's first pass in
its spill mode against the same kernel). Here:

- the dispatch rule ``_lib.k2_f32_sm90_takes``: float32 at D = 128, heads
  of 16, 16 <= M <= 64 with M % 16 == 0, F a multiple of 128, without
  W8A8 or the int8 scores, with or without weight gradients;
- its budget ``_lib.k2_f32_sm90_smem`` (the C side's layout, mirrored)
  fits the 232,448 bytes a block may have at every shape it takes;
- the C entry points take the parameters ``_lib`` binds, and the two-pass
  K2-dW's entry runs the first pass its caller chose (and counts);
- the kernel's product, three TF32 products of the operands split as x =
  hi + lo (hi = tf32(x), lo = tf32(x - hi), rounded to nearest), holds each
  of the layer's dense and attention products at the served widths within
  1e-6 relative of float64, where one TF32 product does not;
- on the CPU the layer's float32 gradients still come from
  ``layer_bwd_math``, which matches the JAX package's ``_layer_bwd_math``,
  and the wrappers refuse CPU tensors at the shapes the kernel takes;
- ``tools/k2_split.py`` finds the kernel's phase marks.
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
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import fused_layer as tfl

F32, BF16 = torch.float32, torch.bfloat16
D, H, F = 128, 8, 256


@pytest.mark.parametrize("dtype, M, D_, H_, F_, dw, w8, i8, takes", [
    (F32, 64, 128, 8, 256, False, False, False, True),    # the f32 force call
    (F32, 64, 128, 8, 256, True, False, False, True),     # K2-dW's first pass
    (F32, 48, 128, 8, 256, False, False, False, True),
    (F32, 16, 128, 8, 256, False, False, False, True),
    (F32, 32, 128, 8, 512, False, False, False, True),
    (F32, 64, 128, 8, 128, False, False, False, True),
    (BF16, 64, 128, 8, 256, False, False, False, False),  # the bf16 Hopper K2's
    (BF16, 64, 128, 8, 256, False, True, False, False),   # W8A8
    (BF16, 64, 128, 8, 256, False, False, True, False),   # int8 scores
    (F32, 64, 128, 8, 256, False, True, False, False),
    (F32, 64, 128, 8, 256, False, False, True, False),
    (F32, 80, 128, 8, 256, False, False, False, False),   # M > 64
    (F32, 56, 128, 8, 256, False, False, False, False),   # M % 16
    (F32, 64, 256, 16, 512, False, False, False, False),  # D = 256
    (F32, 64, 128, 16, 256, False, False, False, False),  # heads of 8
    (F32, 64, 128, 8, 192, False, False, False, False),   # F % 128
    (torch.float64, 64, 128, 8, 256, False, False, False, False),
])
def test_dispatch_rule(dtype, M, D_, H_, F_, dw, w8, i8, takes):
    assert _lib.k2_f32_sm90_takes(dtype, M, D_, H_, F_, dw, w8, i8) is takes
    # the budget depends on the shape alone
    assert (_lib.k2_f32_sm90_smem(M, D_, H_, F_) > 0) is _lib.k2_f32_sm90_takes(F32, M, D_, H_, F_)
    # the bf16 Hopper K2 never takes what this one takes
    assert not (takes and _lib.k2_sm90_takes(dtype, M, D_, H_, F_, dw, w8, i8))


def test_smem_budget_fits_every_shape_it_takes():
    taken = 0
    for M in range(16, 257, 16):
        for F_ in range(128, 2049, 128):
            nbytes = _lib.k2_f32_sm90_smem(M, 128, 8, F_)
            if M <= 64:
                assert nbytes == 227072 and nbytes <= _lib.MAX_SHARED_BYTES
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
    text = (_lib.CSRC / "fused_layer_bwd_f32_sm90.cu").read_text()
    names = re.findall(r'extern "C" [\w ]+?\b(mtt_\w+)\(', text)
    assert sorted(names) == ["mtt_fused_layer_bwd_f32_sm90", "mtt_fused_layer_bwd_f32_sm90_ok",
                             "mtt_fused_layer_bwd_f32_sm90_smem"]
    assert "fused_layer_bwd_f32_sm90.cu" in _lib.SOURCES
    for name in names:
        assert _params(text, name) == _lib._SIGNATURES[name], name
    # the Hopper bf16 K2 and this one take the same arguments (one wrapper)
    assert _lib._SIGNATURES["mtt_fused_layer_bwd_f32_sm90"] == _lib._SIGNATURES[
        "mtt_fused_layer_bwd_sm90"]
    # the two-pass K2-dW passes w_ffn_out on to the float32 first pass
    dw = (_lib.CSRC / "fused_layer_bwd_dw_sm90.cu").read_text()
    assert "w_ffn_out, const float* i8_scales" in " ".join(dw.split())


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
    """The (A, B) operand pairs of the layer's dense products and of one
    head's attention products, from the float32 twin's intermediates at the
    served widths (d_vg, d_qkv: the backward's cotangents; P, dO, dS: the
    attention's), as float64."""
    edges, center, cf, w, g_edge, g_center = (
        torch.from_numpy(x) if isinstance(x, np.ndarray) else [torch.from_numpy(y) for y in x]
        for x in _inputs(A, M, seed=5))
    wt = tfl.LayerWeights(*(x.float() for x in w))
    e, c, f, ge, gc = (x.float() for x in (edges, center, cf, g_edge, g_center))
    _, t = tfl._layer_bwd(e, c, f, wt, ge, gc, H, 1.0 / math.sqrt(D // H), True, None, None)
    rows = lambda x: x.reshape(A * M, -1).double()  # noqa: E731
    wd = tfl.LayerWeights(*(x.double() for x in wt))
    pairs = {
        "qkv": (rows(t["n1"]), wd.w_qkv), "out": (rows(t["attn"]), wd.w_out),
        "ffn_in": (rows(t["h_norm"]), wd.w_in), "d_ffn_h": (rows(t["g_eo"]), wd.w_ffn_out.T),
        "d_h": (rows(t["d_vg"]), wd.w_in.T), "d_attn": (rows(t["d_attn_out"]), wd.w_out.T),
        "d_n1": (rows(t["d_qkv"]), wd.w_qkv.T),
    }
    # one head of atom 0: q, k, v, the softmax weights P, d_attn (dO), dS
    q, k, v = rows(t["n1"]).reshape(A, M, D)[0].matmul(wd.w_qkv).add(wd.b_qkv).split(D, dim=1)
    hs = slice(0, D // H)
    q, k, v = q[:, hs], k[:, hs], v[:, hs]
    s = q @ k.T / math.sqrt(D // H)
    e_ = torch.exp(s - s.amax(1, keepdim=True))
    cfk = cf[0].double()
    probs = e_ / (e_ * cfk).sum(1, keepdim=True)
    p = cfk * probs
    d_o = rows(t["d_attn_out"]).reshape(A, M, D)[0].matmul(wd.w_out.T)[:, hs]
    dp = d_o @ v.T
    ds = cfk * probs * (dp - (p * dp).sum(1, keepdim=True))
    pairs.update({"scores": (q, k.T), "p_v": (p, v), "d_p": (d_o, v.T), "d_q": (ds, k),
                  "d_k": (ds.T, q), "d_v": (p.T, d_o)})
    return pairs


def test_3xtf32_products_keep_float32_accuracy():
    """Every product of the layer, formed as the kernel forms it, lies within
    1e-6 relative (max |error| / max |exact|) of the float64 product; one
    TF32 product (hi b_hi alone: what ``allow_tf32`` would give) misses
    that by orders of magnitude, which is why the kernel splits."""
    for name, (a, b) in _products().items():
        exact = a @ b
        three = _product_3xtf32(a, b).double()
        one = (_tf32(a) @ _tf32(b)).double()
        assert rel(three, exact) < 1e-6, name
        assert rel(one, exact) > 1e-4, name


def test_tf32_rounding_keeps_ten_bits():
    # ties (1 + 2^-11, -3 - 2^-10: half a tf32 ulp) go away from zero
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -3.0 - 2.0 ** -10])
    assert _tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0, -3.0 - 2.0 ** -9]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = _tf32(y)
    lo = _tf32(y - hi)
    # x = hi + lo to about 2^-22 of x
    assert ((hi + lo - y).abs() <= 2.0 ** -21 * y.abs()).all()


@pytest.mark.parametrize("M", [64, 32])
def test_cpu_backward_runs_the_plain_version_and_matches_jax(M):
    """On CPU float32 tensors at a shape the kernel takes, the layer's input
    gradients are ``layer_bwd_math``'s bit for bit, and they match the JAX
    package's ``_layer_bwd_math`` at 1e-5 (its d_cf at 1e-5 as well); the
    wrappers refuse CPU tensors, with and without weight gradients."""
    edges, center, cf, w, g_edge, g_center = (
        x.astype(np.float32) if isinstance(x, np.ndarray) else [y.astype(np.float32) for y in x]
        for x in _inputs(2, M, seed=M))
    scale = 1.0 / math.sqrt(D // H)
    assert _lib.k2_f32_sm90_takes(F32, M, D, H, F)
    tw = tfl.LayerWeights(*(torch.from_numpy(x) for x in w))
    te, tc, tf, tge, tgc = (torch.from_numpy(x) for x in (edges, center, cf, g_edge, g_center))
    inputs = [x.clone().requires_grad_(True) for x in (te, tc, tf)]
    out = tfl.fused_transformer_layer(*inputs, tw, H, scale)
    grads = torch.autograd.grad(out, inputs, (tge, tgc))
    plain = tfl.layer_bwd_math(te, tc, tf, tw, tge, tgc, H, scale)
    for a, b in zip(grads, plain):
        assert torch.equal(a, b)
    j_out = jfl._layer_bwd_math(
        jnp.asarray(edges), jnp.asarray(center), jnp.asarray(cf),
        jfl.LayerWeights(*(jnp.asarray(x) for x in w)), jnp.asarray(g_edge),
        jnp.asarray(g_center), H, scale, weight_grads=False)[:3]
    for a, b in zip(plain, j_out):
        assert rel(a.numpy(), np.asarray(b)) < 1e-5
    for weight_grads in (False, True):
        with pytest.raises(ValueError, match="cuda"):
            tfl.fused_layer_bwd_cuda(te, tc, tf, tw, tge, tgc, H, scale, weight_grads=weight_grads)


def test_phase_split_tool_finds_the_f32_marks():
    """``tools/k2_split.py --body f32-hopper`` instruments a copy of the
    kernel at seven phase marks, each in the source once."""
    path = Path(tfl.__file__).resolve().parents[2] / "tools" / "k2_split.py"
    spec = importlib.util.spec_from_file_location("k2_split", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    text = tool.instrument((tool.CSRC / "fused_layer_bwd_f32_sm90.cu").read_text(), tool.F32_HOPPER)
    assert [f"SPLIT({i})" in text for i in range(8)] == [True] * 7 + [False]
    assert len(tool.F32_HOPPER_PHASES) == 7


def test_dw_entry_runs_the_first_pass_its_caller_counts():
    """The two-pass K2-dW's C entry takes the Hopper float32 first pass as
    its caller's choice (``hopper_f32``) and refuses it where that kernel
    does not run, so the counter the wrapper bumps names the pass that
    ran; the wrapper's choice is ``k2_f32_sm90_takes`` with weight
    gradients and no int8 scores."""
    dw = " ".join((_lib.CSRC / "fused_layer_bwd_dw_sm90.cu").read_text().split())
    assert "mtt_fused_layer_bwd_dw_sm90( int dtype, int hopper_f32," in dw
    assert ("if (hopper_f32 && (dtype != 0 || i8_scales != nullptr || "
            "!mtt::k2f32::takes(M, D, H, F))) return (int)cudaErrorInvalidValue;") in dw
    assert "hopper_f32 ? &f32 : nullptr" in dw and dw.count("k2f32::takes(") == 1
    src = inspect.getsource(tfl._k2dw_sm90)
    assert ("hopper_f32 = int8_scales is None and _lib.k2_f32_sm90_takes(cd, M, D, num_heads, F, "
            "True)") in src
    assert "int(hopper_f32)" in src and "elif hopper_f32:" in src
