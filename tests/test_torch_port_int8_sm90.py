"""The Hopper K1-int8 and K2-int8: the int8-score mode of the Hopper K1 and K2
(``csrc/fused_layer_{fwd,bwd}_sm90.cu``, the shared forward in
``csrc/layer_sm90.cuh``).

The kernels run only on the card (``chip_smoke.py`` holds them against
``layer_math`` / ``layer_bwd_math`` with ``int8_scales`` there). Here:

- the dispatch rule: ``_lib.k1_sm90_takes`` and ``_lib.k2_sm90_takes`` take
  the int8 scores at the served shapes where no weight requires grad; with
  weight gradients the step keeps the general K1-int8 and the two-pass
  K2-dW-int8; W8A8 takes the pair's W8A8 mode. The wrappers call the
  new entry points with the scales and count them (the library and the
  device checks stubbed);
- ``_lib``'s budgets of the int8 mode fit the 232,448 bytes a block may
  have at every shape they take, and the new ``extern "C"`` entries take
  the parameters ``_lib`` binds;
- on the CPU the layer runs the plain versions, and the wrappers refuse
  CPU tensors;
- a float emulation of the kernels' own roundings (the AV product as num
  / den on the bf16 ecf = rnd(cf e), and P, dO and dS in bf16 for the
  backward's tensor cores) stays under 1e-2 relative RMS of the plain
  versions at the served widths, and within bf16 noise of the JAX
  package's bf16 int8 layer (its interpret-mode kernels);
- ``chip_smoke.py``'s check that tells the int8 mode from the exact one
  accepts the emulation and refuses a kernel on the exact scores, or
  quantized half the way;
- the tools find their int8 marks.
"""

import ctypes
import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatrain_tpu.ops.pallas import fused_layer as jfl
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import fused_layer as tfl
from test_torch_port_head_sm90 import _params

BF16 = torch.bfloat16
TOOLS = Path(tfl.__file__).resolve().parents[2] / "tools"
ROOT = TOOLS.parents[1]


@pytest.mark.parametrize("M, D, H, F, w8, dw, takes", [
    (64, 128, 8, 256, False, False, True),    # the served int8 call
    (48, 128, 8, 256, False, False, True),
    (16, 128, 8, 256, False, False, True),
    (32, 128, 8, 512, False, False, True),
    (64, 128, 8, 256, False, True, False),    # the int8 training step
    (64, 128, 8, 256, True, False, True),     # W8A8 wins: the pair's W8A8 mode
    (96, 128, 8, 256, False, False, False),   # M > 64
    (64, 256, 8, 512, False, False, False),   # d_pet 256
    (64, 128, 16, 256, False, False, False),  # heads of 8
])
def test_dispatch_rule(M, D, H, F, w8, dw, takes):
    assert _lib.k1_sm90_takes(BF16, M, D, H, F, w8, True, dw) is takes
    assert _lib.k2_sm90_takes(BF16, M, D, H, F, dw, w8, True) is takes
    # float32 has no int8 scores; the Hopper float32 kernels refuse them
    assert not _lib.k1_f32_sm90_takes(torch.float32, M, D, H, F, w8, True)
    assert not _lib.k2_f32_sm90_takes(torch.float32, M, D, H, F, dw, w8, True)
    if dw and not w8:  # the int8 step's backward: the two-pass K2-dW-int8
        assert _lib.k2dw_sm90_takes(BF16, M, D, H, F, int8=True)


def test_smem_budget_fits_every_shape_it_takes():
    taken = 0
    for M in range(16, 257, 16):
        for F in range(128, 2049, 128):
            k1 = _lib.k1_sm90_smem(M, 128, 8, F, int8=True)
            k2 = _lib.k2_sm90_smem(M, 128, 8, F, int8=True)
            if M <= 64:
                # the exact kernels' layouts and the int8 q|k of each atom
                # (64 rows of 2D + 16 bytes): two atoms a block in K1, one
                # in K2
                assert (k1 - _lib.k1_sm90_smem(M, 128, 8, F), k2 - _lib.k2_sm90_smem(M, 128, 8, F)) \
                    == (2 * 64 * 272, 64 * 272)
                assert (k1, k2) == (220672, 218880)
                assert max(k1, k2) <= _lib.MAX_SHARED_BYTES
                taken += 1
            else:
                assert k1 == k2 == 0
    assert taken == 4 * 16


@pytest.mark.parametrize("source, names", [
    ("fused_layer_fwd_sm90.cu", ["mtt_fused_layer_fwd_sm90_ok", "mtt_fused_layer_fwd_sm90_smem",
                                 "mtt_fused_layer_fwd_int8_sm90_smem",
                                 "mtt_fused_layer_fwd_w8a8_sm90_smem", "mtt_fused_layer_fwd_sm90",
                                 "mtt_fused_layer_fwd_int8_sm90", "mtt_fused_layer_fwd_w8a8_sm90"]),
    ("fused_layer_bwd_sm90.cu", ["mtt_fused_layer_bwd_sm90_ok", "mtt_fused_layer_bwd_sm90_smem",
                                 "mtt_fused_layer_bwd_int8_sm90_smem",
                                 "mtt_fused_layer_bwd_w8a8_sm90_smem", "mtt_fused_layer_bwd_sm90",
                                 "mtt_fused_layer_bwd_int8_sm90", "mtt_fused_layer_bwd_w8a8_sm90"]),
])
def test_entry_points_take_the_bound_parameters(source, names):
    """Every entry of the two sources takes the parameters ``_lib`` binds
    (a device pointer of any type as ``c_void_p``). Every mode takes the
    shapes of the exact ``_ok`` query: the int8 mode has no ``_ok`` of its
    own."""
    text = (_lib.CSRC / source).read_text()
    assert re.findall(r'extern "C" [\w ]+?\b(mtt_\w+)\(', text) == names
    scalars = (ctypes.c_int, ctypes.c_longlong, ctypes.c_float)
    for name in names:
        params = [t if t in scalars else ctypes.c_void_p for t in _params(text, name)]
        # the W8A8 entries' scales are a host array of floats, a pointer
        # here (tests/test_torch_port_w8a8_sm90.py holds their exact types)
        bound = [ctypes.c_void_p if t is _lib._FP else t for t in _lib._SIGNATURES[name]]
        assert params == bound, name


def _case(A, M, D, F, seed=0):
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


def _torch_case(A, M, D, F, seed=0):
    edges, center, cf, w, g_edge, g_center = _case(A, M, D, F, seed)
    return (torch.from_numpy(edges).to(BF16), torch.from_numpy(center).to(BF16),
            torch.from_numpy(cf).float(), tfl.LayerWeights(*(torch.from_numpy(a).float() for a in w)),
            torch.from_numpy(g_edge).to(BF16), torch.from_numpy(g_center).to(BF16))


class _FakeLibrary:
    """Records the entry points called and their arguments (CPU tensors
    stand in for the card's)."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 1000 if name.endswith("_smem") else 0
        entry.__name__ = name
        return entry


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(_lib, "library", lambda: lib)
    monkeypatch.setattr(_lib, "require", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(_lib, "dw_blocks", lambda items, device: 132)
    monkeypatch.setattr(_lib, "sm_count", lambda device: 132)
    return lib


@pytest.mark.parametrize("M, sm90, entry, counter", [
    (64, True, "mtt_fused_layer_fwd_int8_sm90", "fused_layer_fwd_int8_sm90"),
    (48, True, "mtt_fused_layer_fwd_int8_sm90", "fused_layer_fwd_int8_sm90"),
    (64, False, "mtt_fused_layer_fwd_int8", "fused_layer_fwd_int8"),
    (80, True, "mtt_fused_layer_fwd_int8", "fused_layer_fwd_int8"),
])
def test_forward_wrapper_launches_what_the_rule_says(fake, M, sm90, entry, counter):
    """K1-int8: the Hopper K1's int8-score mode where the rule takes the
    call, with the per-atom scales after the four weight matrices; the
    general body with ``sm90=False`` or outside its shapes; one count
    each, and no exact K1."""
    H = 8
    edges, center, cf, w, _, _ = _torch_case(3, M, 128, 256)
    scales = tfl.int8_scales_for(edges, center, w, H, plain=True)
    names = ("fused_layer_fwd_int8_sm90", "fused_layer_fwd_int8", "fused_layer_fwd_sm90",
             "fused_layer_fwd")
    before = {k: _lib.LAUNCHES[k] for k in names}
    tfl.fused_layer_fwd_cuda(edges, center, cf, w, H, 0.25, int8_scales=scales, sm90=sm90)
    assert [k for k in fake.calls if not k.endswith("_smem")] == [entry]
    args = fake.calls[entry]
    # edges, center, cf, then ten weights (the general body) or six vectors
    # and four matrices (the Hopper K1), then the scales
    assert args[13] == scales.data_ptr()
    assert {k: _lib.LAUNCHES[k] - before[k] for k in names} == {k: int(k == counter) for k in names}


@pytest.mark.parametrize("M, sm90, weight_grads, entry, counter", [
    (64, True, False, "mtt_fused_layer_bwd_int8_sm90", "fused_layer_bwd_int8_sm90"),
    (16, True, False, "mtt_fused_layer_bwd_int8_sm90", "fused_layer_bwd_int8_sm90"),
    (64, False, False, "mtt_fused_layer_bwd_int8", "fused_layer_bwd_int8"),
    (64, True, True, "mtt_fused_layer_bwd_dw_sm90", "fused_layer_bwd_dw_int8_sm90"),
])
def test_backward_wrapper_launches_what_the_rule_says(fake, M, sm90, weight_grads, entry, counter):
    """K2-int8: the Hopper K2's int8-score mode where the rule takes the
    call, the scales after the three transposed weights; the general body
    with ``sm90=False``; with weight gradients the two-pass K2-dW-int8
    (its first pass the general body: ``hopper_f32`` 0), never the Hopper
    pair."""
    H = 8
    edges, center, cf, w, ge, gc = _torch_case(3, M, 128, 256)
    scales = tfl.int8_scales_for(edges, center, w, H, plain=True)
    names = ("fused_layer_bwd_int8_sm90", "fused_layer_bwd_int8", "fused_layer_bwd_sm90",
             "fused_layer_bwd_dw_int8_sm90", "fused_layer_bwd_dw_int8")
    before = {k: _lib.LAUNCHES[k] for k in names}
    tfl.fused_layer_bwd_cuda(edges, center, cf, w, ge, gc, H, 0.25, weight_grads,
                             int8_scales=scales, sm90=sm90)
    assert [k for k in fake.calls if not k.endswith("_smem")] == [entry]
    args = fake.calls[entry]
    if weight_grads:
        # the dtype, then the first pass: the general body's spill mode
        assert args[:2] == (_lib.dtype_code(BF16), 0)
        assert scales.data_ptr() in args
    else:
        # edges, center, cf, eight weights and four transposed (the general
        # body) or nine and three (the Hopper K2), then the scales
        assert args[15] == scales.data_ptr()
    assert {k: _lib.LAUNCHES[k] - before[k] for k in names} == {k: int(k == counter) for k in names}


def test_cpu_layer_runs_the_plain_versions_at_the_served_shape():
    """The layer with ``int8_scores`` on CPU bf16 tensors at a shape the
    Hopper int8 pair takes is ``layer_math`` / ``layer_bwd_math`` with the
    plain absmax's scales, bit for bit; the wrappers themselves refuse CPU
    tensors there, with and without ``sm90``."""
    M, D, H, F = 64, 128, 8, 256
    edges, center, cf, w, ge, gc = _torch_case(2, M, D, F)
    scale = 1.0 / math.sqrt(D // H)
    assert _lib.k1_sm90_takes(BF16, M, D, H, F, int8=True)
    assert _lib.k2_sm90_takes(BF16, M, D, H, F, int8=True)
    scales = tfl.int8_scales_for(edges, center, w, H, plain=True)
    x = [t.clone().requires_grad_(True) for t in (edges, center, cf)]
    out = tfl.fused_transformer_layer(*x, w, H, scale, int8_scores=True)
    grads = torch.autograd.grad(out, x, (ge, gc))
    for a, b in zip(out, tfl.layer_math(edges, center, cf, w, H, scale, int8_scales=scales)):
        assert torch.equal(a, b)
    for a, b in zip(grads, tfl.layer_bwd_math(edges, center, cf, w, ge, gc, H, scale,
                                              int8_scales=scales)):
        assert torch.equal(a, b)
    for sm90 in (True, False):
        with pytest.raises(ValueError, match="cuda"):
            tfl.fused_layer_fwd_cuda(edges, center, cf, w, H, scale, int8_scales=scales, sm90=sm90)
        with pytest.raises(ValueError, match="cuda"):
            tfl.fused_layer_bwd_cuda(edges, center, cf, w, ge, gc, H, scale, int8_scales=scales,
                                     sm90=sm90)


def _int8_attention(q, k, v, cf, scales, scale, cd):
    """The kernels' attention on the int8 scores, in float: E = e / z, the
    AV weights ecf = rnd(cf e) (bf16, as the tensor cores take them) and
    attn = rnd((ecf v) / z), z = sum_k ecf: the JAX package's num / den
    order. (A, H, Mq, Mk) E and P = ecf / z, and attn (A, M, H, hd)."""
    acc = torch.float32
    s = tfl._int8_scores(q, k, scales, scale, acc)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ecf = (e * cf.to(acc)[:, None, None, :]).to(cd).to(acc)
    z = ecf.sum(dim=-1, keepdim=True)
    num = torch.einsum("ahqk,akhd->aqhd", ecf, v.to(acc))
    attn = (num / z.permute(0, 2, 1, 3)).to(cd)
    return e / z, ecf / z, attn


def _forward(edges, center, cf, w, H, scale, scales):
    """``layer_math``'s int8-score forward with the kernels' attention
    (:func:`_int8_attention`): ``(edge_out, center_attn)`` and the
    recompute's pieces. A copy for this test; the plain version is
    unchanged."""
    A, M, D = edges.shape
    cd, acc = edges.dtype, torch.float32
    eps = tfl.rmsnorm_eps(cd)
    wc = tfl.LayerWeights(*(x.to(cd) for x in w))
    tokens = tfl._with_center(edges, center)
    x1, r1 = tfl._rms_stats(tokens, acc, eps)
    n1 = (x1 * r1 * wc.norm_attn.to(acc)).to(cd)
    qkv = tfl._matmul_bias(n1.reshape(A * M, D), wc.w_qkv, wc.b_qkv, cd)
    q, k, v = qkv.reshape(A, M, 3, H, D // H).unbind(2)
    probs, p_attn, attn = _int8_attention(q, k, v, cf, scales, scale, cd)
    attn = attn.reshape(A * M, D)
    attn_out = tfl._matmul_bias(attn, wc.w_out, wc.b_out, cd).reshape(A, M, D)
    res = tokens + attn_out
    x2, r2 = tfl._rms_stats(res, acc, eps)
    h_norm = (x2 * r2 * wc.norm_mlp.to(acc)).to(cd)
    vg = tfl._matmul_bias(h_norm.reshape(A * M, D), wc.w_in, wc.b_in)
    F = wc.w_ffn_out.shape[0]
    ffn_h = (vg[:, :F] * torch.sigmoid(vg[:, F:])).to(cd)
    ffn_out = tfl._matmul_bias(ffn_h, wc.w_ffn_out, wc.b_ffn_out, cd)
    out = (tfl._zero_last_slot(res + ffn_out.reshape(A, M, D)), attn_out[:, M - 1])
    return out, dict(x1=x1, r1=r1, x2=x2, r2=r2, q=q, k=k, v=v, probs=probs, p_attn=p_attn,
                     vg=vg, wc=wc)


def _backward(edges, center, cf, w, g_edge, g_center, H, scale, scales):
    """``layer_bwd_math``'s int8-score input gradients as the Hopper K2-int8
    rounds them: its recompute's attention (:func:`_int8_attention`), and
    P, d_attn (dO) and dS in the compute dtype for the attention's tensor
    cores; dQ and dK on the bf16 q and k (straight through). A copy for
    this test; the plain version is unchanged."""
    A, M, D = edges.shape
    cd, acc = edges.dtype, torch.float32
    wc = tfl.LayerWeights(*(x.to(cd) for x in w))
    wa = tfl.LayerWeights(*(x.to(acc) for x in wc))
    t = _forward(edges, center, cf, w, H, scale, scales)[1]

    def r(x):
        return x.to(cd).to(acc)

    x1, r1, x2, r2 = t["x1"], t["r1"], t["x2"], t["r2"]
    F = wc.w_ffn_out.shape[0]
    value, sig = t["vg"][:, :F], torch.sigmoid(t["vg"][:, F:])
    g_eo = tfl._zero_last_slot(g_edge.to(cd)).to(acc)
    d_ffn_h = g_eo.reshape(A * M, D) @ wa.w_ffn_out.T
    d_vg = torch.cat([d_ffn_h * sig, d_ffn_h * value * sig * (1.0 - sig)], dim=-1).to(cd)
    d_h = (d_vg.to(acc) @ wa.w_in.T).reshape(A, M, D)
    gs2 = d_h * (r2 * wa.norm_mlp)
    d_res = g_eo + gs2 - x2 * (r2 * r2 * torch.sum(gs2 * x2, dim=-1, keepdim=True) / D)
    d_attn_out = torch.cat([d_res[:, :-1], d_res[:, -1:] + g_center.to(acc)[:, None]], dim=1)
    d_attn = r((d_attn_out.to(cd).to(acc).reshape(A * M, D) @ wa.w_out.T).reshape(A, M, H, D // H))
    q, k, v, probs, p_attn = t["q"], t["k"], t["v"], t["probs"], t["p_attn"]
    d_p = torch.einsum("aqhd,akhd->ahqk", d_attn, v.to(acc))
    delta = torch.sum(p_attn * d_p, dim=-1, keepdim=True)
    tt = probs * (d_p - delta)
    d_cf = torch.sum(tt, dim=(1, 2))
    d_s = r(cf.to(acc)[:, None, None, :] * tt)
    d_q = torch.einsum("ahqk,akhd->aqhd", d_s, k.to(acc)) * scale
    d_k = torch.einsum("ahqk,aqhd->akhd", d_s, q.to(acc)) * scale
    d_v = torch.einsum("ahqk,aqhd->akhd", r(p_attn), d_attn)
    d_qkv = torch.stack([d_q, d_k, d_v], dim=2).reshape(A * M, 3 * D).to(cd)
    d_n1 = (d_qkv.to(acc) @ wa.w_qkv.T).reshape(A, M, D)
    gs1 = d_n1 * (r1 * wa.norm_attn)
    d_tokens = d_res + gs1 - x1 * (r1 * r1 * torch.sum(gs1 * x1, dim=-1, keepdim=True) / D)
    return tfl._zero_last_slot(d_tokens).to(cd), d_tokens[:, M - 1].to(cd), d_cf


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


@pytest.mark.parametrize("M", [64, 48])
def test_kernel_roundings_stay_within_the_kernel_bound(M):
    """At the served widths (D 128, 8 heads, F 256) the emulation of the
    kernels' own roundings is within 1e-2 relative RMS of the plain
    versions with the same scales, half the 2e-2 that ``chip_smoke.py``
    allows (the kernels' summation orders need the rest)."""
    D, H, F = 128, 8, 256
    edges, center, cf, w, ge, gc = _torch_case(8, M, D, F, seed=M)
    scale = 1.0 / math.sqrt(D // H)
    scales = tfl.int8_scales_for(edges, center, w, H, plain=True)
    fwd = _forward(edges, center, cf, w, H, scale, scales)[0]
    for a, b in zip(fwd, tfl.layer_math(edges, center, cf, w, H, scale, int8_scales=scales)):
        assert _rel_rms(a.float(), b.float()) < 1e-2
    bwd = _backward(edges, center, cf, w, ge, gc, H, scale, scales)
    plain = tfl.layer_bwd_math(edges, center, cf, w, ge, gc, H, scale, int8_scales=scales)
    for a, b in zip(bwd, plain):
        rel = _rel_rms(a.float(), b.float())
        assert 0 < rel < 1e-2, rel


def _jax(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, np.float32), dtype)


def test_kernel_roundings_against_the_jax_int8_layer_in_bf16(monkeypatch):
    """The JAX package's bf16 int8 layer, its interpret-mode kernels
    (``_forward_impl`` and ``_make_bwd_op(..., int8=True)`` under
    ``MTT_QSIDE=1`` and ``MTT_INT8_SCORES=1``, as the port's int8 tests run
    them), at the served widths: 9 atoms at M = 64, two blocks of 8, the
    second padded. The emulation of the kernels agrees with it to bf16
    noise: within 1e-2 relative RMS, and within twice the plain version's
    own distance from it (two independent roundings of one size add to
    about 1.4 times it)."""
    monkeypatch.setenv("MTT_QSIDE", "1")
    monkeypatch.setenv("MTT_INT8_SCORES", "1")
    A, M, D, H, F = 9, 64, 128, 8, 256
    scale = 1.0 / math.sqrt(D // H)
    edges, center, cf, w, ge, gc = _case(A, M, D, F, seed=5)
    bf = jnp.bfloat16
    jw = jfl.LayerWeights(*map(_jax, w))
    jx = (_jax(edges, bf), _jax(center, bf), _jax(cf))
    j_out = jfl._forward_impl(*jx, jw, H, scale)
    j_in = jfl._make_bwd_op(H, scale, weight_grads=False, int8=True)(*jx, jw, _jax(ge, bf),
                                                                     _jax(gc, bf))
    t = _torch_case(A, M, D, F, seed=5)
    scales = tfl.int8_scales_for(t[0], t[1], t[3], H, plain=True)
    emulated = (*_forward(*t[:4], H, scale, scales)[0],
                *_backward(*t, H, scale, scales))
    plain = (*tfl.layer_math(*t[:4], H, scale, int8_scales=scales),
             *tfl.layer_bwd_math(*t, H, scale, int8_scales=scales))
    for em, p, j in zip(emulated, plain, (*j_out, *j_in[:3])):
        j = np.asarray(j, np.float32)
        err, err_plain = _rel_rms(em.float(), j), _rel_rms(p.float(), j)
        assert err < 1e-2, err
        assert err < 2 * err_plain, (err, err_plain)


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_front_bits_tool_finds_its_int8_marks():
    """``tools/sm90_front.py --int8`` copies q|k|v (before the attention),
    attn, res and h_norm out of copies of the Hopper K1 and K2 at marks
    each source holds once, into rows of six slots; the copies run the
    int8 entries with the scales after the same arguments as ``_lib``
    binds. Beside them the tool builds a plain copy of the Hopper absmax
    pass (its two sources), whose scales it holds against K1-int8's q|k."""
    tool = _tool("sm90_front")
    kernels = dict((key, (source, marks)) for key, source, marks in tool.KERNELS["int8"])
    assert {k: s for k, (s, _) in kernels.items()} == {
        "k1": "fused_layer_fwd_sm90.cu", "k2": "fused_layer_bwd_sm90.cu",
        "absmax": ("int8_absmax_sm90.cu", "int8_absmax.cu")}
    assert kernels.pop("absmax")[1] == ()
    for key, (source, marks) in kernels.items():
        text = tool.instrument((tool.CSRC / source).read_text(), marks)
        # K1: both atoms of a block, four copies each
        assert text.count("g_dump[") == (8 if key == "k1" else 4)
        assert "* 6 * D + 3 * D + i_ % (3 * D)]" in text
        qkv = text.index("QKV[(i_ / (3 * D)) * LQ + i_ % (3 * D)]")
        assert qkv < text.index("attention_fwd<I8>(")
    assert _lib._SIGNATURES["mtt_fused_layer_fwd_int8_sm90"][:16] == [ctypes.c_void_p] * 16
    assert _lib._SIGNATURES["mtt_fused_layer_bwd_int8_sm90"][:21] == [ctypes.c_void_p] * 21


def test_phase_split_and_times_tools_find_the_int8_kernels():
    """``tools/k2_split.py --body hopper-int8 | k1-int8`` instruments the
    same sources at the same phase marks as the exact bodies (seven and
    five phases), and ``tools/layer_times.py`` times and digests K1-int8
    and K2-int8 beside their general bodies."""
    tool = _tool("k2_split")
    for source, marks, names in (("fused_layer_bwd_sm90.cu", tool.HOPPER, tool.HOPPER_PHASES),
                                 ("fused_layer_fwd_sm90.cu", tool.K1_HOPPER, tool.K1_HOPPER_PHASES)):
        text = tool.instrument((tool.CSRC / source).read_text(), marks)
        n = len(names)
        assert [f"SPLIT({i})" in text for i in range(n + 1)] == [True] * n + [False]
    source = (TOOLS / "k2_split.py").read_text()
    for body in ("hopper-int8", "k1-int8"):
        assert f'"{body}"' in source
    assert "mtt_fused_layer_bwd_int8_sm90" in source and "mtt_fused_layer_fwd_int8_sm90" in source
    text = (TOOLS / "layer_times.py").read_text()
    for name in ("fused_layer_fwd_int8", "fused_layer_bwd_int8", "fused_layer_fwd_int8_general",
                 "fused_layer_bwd_int8_general"):
        assert f'("{name}", ' in text, name


def test_chip_smoke_expects_the_hopper_int8_pair():
    """``chip_smoke.py``'s launch tables: the served int8 call launches the
    Hopper absmax pass and the Hopper K1-int8 and K2-int8 four times each
    and the general pass, the general int8 bodies and the exact K1/K2
    never; the int8 step the general pass and the general K1-int8 and
    never the Hopper pair. The kernel line has the new K1-int8 and K2-int8
    entries beside the general K1-int8's (the general K2-int8 runs on no
    path: the Hopper K2-int8's ``general_ms``), and the Hopper absmax pass
    beside the general one, each entry's launches from the run of its
    path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_for_int8", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.INT8_SM90 == ("fused_layer_fwd_int8_sm90", "fused_layer_bwd_int8_sm90")
    assert cs.INT8_KERNELS[:3] == ["int8_absmax_sm90", *cs.INT8_SM90]
    assert set(cs.INT8_NEVER) == {"int8_absmax", "fused_layer_fwd_int8", "fused_layer_bwd_int8",
                                  "fused_layer_fwd", "fused_layer_bwd", "fused_layer_fwd_sm90",
                                  "fused_layer_bwd_sm90"}
    assert cs.SOURCES["fused_layer_fwd_int8_sm90"][0].endswith("csrc/fused_layer_fwd_sm90.cu")
    assert cs.SOURCES["fused_layer_bwd_int8_sm90"][0].endswith("csrc/fused_layer_bwd_sm90.cu")
    assert cs.SOURCES["int8_absmax_sm90"][0].endswith("csrc/int8_absmax_sm90.cu")
    assert cs.SOURCES["int8_absmax"][0].endswith("csrc/int8_absmax.cu")
    assert "fused_layer_bwd_int8" not in cs.SOURCES
    assert cs.SOURCES["fused_layer_fwd_int8"][0].endswith("csrc/fused_layer_fwd.cu")
    assert cs.N_ENTRIES == 55
    report = {"slice_int8": {"launches": {"int8_absmax_sm90": 12, "fused_layer_fwd_int8_sm90": 12,
                                          "fused_layer_bwd_int8_sm90": 12}},
              "training_parity_int8": {"launches": {"int8_absmax": 4, "fused_layer_fwd_int8": 4,
                                                    "fused_layer_bwd_dw_int8_sm90": 8}}}
    assert [cs.launch_count(report, k) for k in (
        "int8_absmax_sm90", *cs.INT8_SM90, "int8_absmax", "fused_layer_fwd_int8",
        "fused_layer_bwd_dw_int8")] == [12, 12, 12, 4, 4, 8]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_int8", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("mode, follows", [("int8", True), ("exact", False), ("half", False)])
def test_chip_smoke_tells_the_int8_mode_from_the_exact_one(monkeypatch, mode, follows):
    """``chip_smoke.compare_int8_mode`` on the kernels' emulation (K1-int8's
    outputs and K2-int8's input gradients) against ``layer_math`` /
    ``layer_bwd_math`` with and without the scales, at the served widths:
    the emulation follows the int8 mode (its error well under the int8
    mode's distance from the exact one, alignment near 1); the same
    emulation on the exact scores (the rounded softmax alone), or on
    scores quantized half the way, is refused, though both lie within
    the 2e-2 bound of ``compare``."""
    cs = _chip_smoke()
    D, H, F = 128, 8, 256
    edges, center, cf, w, ge, gc = _torch_case(16, 64, D, F, seed=7)
    scale = 1.0 / math.sqrt(D // H)
    scales = tfl.int8_scales_for(edges, center, w, H, plain=True)
    i1 = tfl.layer_math(edges, center, cf, w, H, scale, int8_scales=scales)
    x1 = tfl.layer_math(edges, center, cf, w, H, scale)
    i2 = tfl.layer_bwd_math(edges, center, cf, w, ge, gc, H, scale, int8_scales=scales)
    x2 = tfl.layer_bwd_math(edges, center, cf, w, ge, gc, H, scale)
    int8 = tfl._int8_scores

    def exact(q, k, s, sc, acc):
        return torch.einsum("aqhd,akhd->ahqk", q.to(acc), k.to(acc)) * sc

    if mode != "int8":
        monkeypatch.setattr(tfl, "_int8_scores", exact if mode == "exact" else (
            lambda *a: 0.5 * (int8(*a) + exact(*a))))
    k1 = _forward(edges, center, cf, w, H, scale, scales)[0]
    k2 = _backward(edges, center, cf, w, ge, gc, H, scale, scales)
    for k, i in ((k1, i1), (k2, i2)):
        for a, b in zip(k, i):
            assert _rel_rms(a.float(), b.float()) < cs.BF16_BOUND
    if follows:
        for k, i, x in ((k1, i1, x1), (k2, i2, x2)):
            got = cs.compare_int8_mode(k, i, x)
            assert all(0 < d < 3e-2 for d in got["mode_distance"]), got
    else:
        with pytest.raises(RuntimeError, match="does not follow the int8 mode"):
            cs.compare_int8_mode(k2, i2, x2)
        with pytest.raises(RuntimeError, match="does not follow the int8 mode"):
            cs.compare_int8_mode(k1, i1, x1)
