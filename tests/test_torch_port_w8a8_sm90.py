"""The Hopper K1-W8A8 and K2-W8A8: the W8A8 mode of the Hopper K1 and K2
(``csrc/fused_layer_{fwd,bwd}_sm90.cu``, the shared forward and the int8
products in ``csrc/layer_sm90.cuh``).

The kernels run only on the card (``chip_smoke.py`` holds them against
``layer_math`` / ``layer_bwd_math`` with ``w8a8`` there). Here:

- the dispatch rule: ``_lib.k1_sm90_takes`` and ``_lib.k2_sm90_takes`` take
  W8A8 at the served shapes (W8A8 has no weight gradients); other windows
  and widths keep the general W8A8 bodies;
- ``_lib``'s budgets of the W8A8 mode follow the kernels' layout and fit
  the 232,448 bytes a block may have, and the new ``extern "C"`` entries
  take the parameters ``_lib`` binds; no mode but the exact one has an
  ``_ok`` query;
- the wrappers call the new entry points with the int8 weights and the
  scales and count them, ``sm90=False`` and other shapes the general
  bodies (the library and the device checks stubbed);
- on the CPU the layer runs the plain versions, and the wrappers refuse
  CPU tensors;
- a float emulation of the kernels' own roundings stays under 1e-2
  relative RMS of the plain versions at the served widths, and within
  bf16 noise of the JAX package's interpret-mode W8A8 kernel;
- ``chip_smoke.compare_int8_mode`` accepts the emulation against the W8A8
  and the exact plain versions, and refuses one whose dense products
  stayed bfloat16;
- the tools and ``chip_smoke.py``'s tables find the W8A8 pair.
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

from metatrain_tpu.ops.inference import no_param_grads as jax_no_param_grads
from metatrain_tpu.ops.pallas import fused_layer as jfl
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import fused_layer as tfl
from test_torch_port_head_sm90 import _params
from test_torch_port_int8_sm90 import _case, _FakeLibrary, _rel_rms, _torch_case

BF16 = torch.bfloat16
TOOLS = Path(tfl.__file__).resolve().parents[2] / "tools"
ROOT = TOOLS.parents[1]
D, H, F = 128, 8, 256
SCALE = 1.0 / math.sqrt(D // H)


@pytest.mark.parametrize("dtype, M, D, H, F, weight_grads, takes", [
    (BF16, 64, 128, 8, 256, False, True),    # the served W8A8 call
    (BF16, 48, 128, 8, 256, False, True),
    (BF16, 16, 128, 8, 256, False, True),
    (BF16, 32, 128, 8, 512, False, True),
    (BF16, 64, 128, 8, 256, True, False),    # weight gradients: not the W8A8 layer's
    (torch.float32, 64, 128, 8, 256, False, False),
    (BF16, 80, 128, 8, 256, False, False),   # M 80-128: the general bodies
    (BF16, 128, 128, 8, 256, False, False),
    (BF16, 64, 256, 8, 512, False, False),   # d_pet 256
    (BF16, 64, 128, 16, 256, False, False),  # heads of 8
    (BF16, 64, 128, 8, 192, False, False),   # F % 128
])
def test_dispatch_rule(dtype, M, D, H, F, weight_grads, takes):
    assert _lib.k1_sm90_takes(dtype, M, D, H, F, True, False, weight_grads) is takes
    assert _lib.k2_sm90_takes(dtype, M, D, H, F, weight_grads, True, False) is takes
    # W8A8 wins over the int8 scores where both are asked
    assert _lib.k1_sm90_takes(dtype, M, D, H, F, True, True, weight_grads) is takes
    assert _lib.k2_sm90_takes(dtype, M, D, H, F, weight_grads, True, True) is takes
    # the Hopper float32 kernels refuse W8A8
    assert not _lib.k1_f32_sm90_takes(torch.float32, M, D, H, F, True)
    assert not _lib.k2_f32_sm90_takes(torch.float32, M, D, H, F, weight_grads, True)


def test_smem_budget_follows_the_layout():
    """The W8A8 budgets are the int8 mode's: the int8 q and k of each atom
    (64 rows of 2D + 16 bytes) beside the exact layouts, because the int8
    n1 and h_norm (64 rows of D + 16 bytes) fit in the bf16 operand tile
    (rows of D + 8 bf16) and K1's int8 ffn_h tile (64 x 128 in the same
    rows) in q|k|v's room after res, where its bf16 tile was."""
    rows, la8 = 64, D + 16
    op_tile, qkv_room, res = rows * (D + 8) * 2, rows * (3 * D + 8) * 2, rows * (D + 8) * 2
    assert rows * la8 <= op_tile and res + rows * la8 <= qkv_room
    taken = 0
    for M in range(16, 257, 16):
        for F_ in range(128, 2049, 128):
            k1 = _lib.k1_sm90_smem(M, D, H, F_, w8a8=True)
            k2 = _lib.k2_sm90_smem(M, D, H, F_, w8a8=True)
            if M <= 64:
                assert (k1 - _lib.k1_sm90_smem(M, D, H, F_), k2 - _lib.k2_sm90_smem(M, D, H, F_)) \
                    == (2 * rows * (2 * D + 16), rows * (2 * D + 16))
                assert (k1, k2) == (_lib.k1_sm90_smem(M, D, H, F_, int8=True),
                                    _lib.k2_sm90_smem(M, D, H, F_, int8=True)) == (220672, 218880)
                assert max(k1, k2) <= _lib.MAX_SHARED_BYTES
                taken += 1
            else:
                assert k1 == k2 == 0
    assert taken == 4 * 16


@pytest.mark.parametrize("source, entry", [
    ("fused_layer_fwd_sm90.cu", "mtt_fused_layer_fwd_w8a8_sm90"),
    ("fused_layer_bwd_sm90.cu", "mtt_fused_layer_bwd_w8a8_sm90"),
])
def test_entry_points_take_the_bound_parameters(source, entry):
    """The W8A8 entries and their ``_smem`` queries take exactly the
    parameters ``_lib`` binds (device pointers as ``c_void_p``, the scales
    as a host array of floats); the exact ``_ok`` query is the only one of
    the source: the int8-score and W8A8 modes take its shapes."""
    text = (_lib.CSRC / source).read_text()
    for name in (entry, f"{entry}_smem"):
        params = _params(text, name)
        bound = _lib._SIGNATURES[name]
        assert len(params) == len(bound), name
        for p, b in zip(params, bound):
            assert p == b or (p == ctypes.POINTER(ctypes.c_float) and b is _lib._P) \
                or (p == ctypes.POINTER(ctypes.c_int8) and b is _lib._P), (name, p, b)
        assert bound.count(_lib._FP) == (name == entry), name
    oks = re.findall(r'extern "C" [\w ]+?\b(mtt_\w+_ok)\(', text)
    assert oks == [entry.replace("_w8a8", "")[:-len("_sm90")] + "_sm90_ok"]
    assert not [k for k in _lib._SIGNATURES if re.fullmatch(r"mtt_fused_layer_\w+_(int8|w8a8)_sm90_ok", k)]


def _w8a8(edges, center, cf, w, calib=None):
    """``(calib, int8 weights)`` of one layer from the plain probe, as
    ``chip_smoke.py`` calibrates its cases."""
    calib = calib or tfl.Int8Calib.from_stats(
        tfl.layer_probe_stats(edges, center, cf, w, H, SCALE).tolist(), w)
    return calib, tfl.quantize_layer_weights(w, calib)


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(_lib, "library", lambda: lib)
    monkeypatch.setattr(_lib, "require", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(_lib, "dw_blocks", lambda items, device: 132)
    monkeypatch.setattr(_lib, "sm_count", lambda device: 132)
    return lib


NAMES_FWD = ("fused_layer_fwd_w8a8_sm90", "fused_layer_fwd_w8a8", "fused_layer_fwd_sm90",
             "fused_layer_fwd_int8_sm90", "fused_layer_fwd")
NAMES_BWD = ("fused_layer_bwd_w8a8_sm90", "fused_layer_bwd_w8a8", "fused_layer_bwd_sm90",
             "fused_layer_bwd_int8_sm90", "fused_layer_bwd")


def _scales_of(args):
    arrays = [a for a in args if isinstance(a, ctypes.Array)]
    assert len(arrays) == 1
    return list(arrays[0])


@pytest.mark.parametrize("M, sm90, entry, counter", [
    (64, True, "mtt_fused_layer_fwd_w8a8_sm90", "fused_layer_fwd_w8a8_sm90"),
    (48, True, "mtt_fused_layer_fwd_w8a8_sm90", "fused_layer_fwd_w8a8_sm90"),
    (64, False, "mtt_fused_layer_fwd_w8a8", "fused_layer_fwd_w8a8"),
    (80, True, "mtt_fused_layer_fwd_w8a8", "fused_layer_fwd_w8a8"),
])
def test_forward_wrapper_launches_what_the_rule_says(fake, monkeypatch, M, sm90, entry, counter):
    """K1-W8A8: the Hopper K1's W8A8 mode where the rule takes the call
    (the inputs, six vectors, w_out^T, the int8 w_qkv^T, w_in^T in
    ``k1_sm90_w_vg``'s blocks and w_ffn_out^T, then the 11 scales); the
    general body with ``sm90=False`` or outside its shapes; one count each."""
    edges, center, cf, w, _, _ = _torch_case(3, M, D, F)
    w8a8 = _w8a8(edges, center, cf, w)
    arranged = []
    vg = tfl.k1_sm90_w_vg
    monkeypatch.setattr(tfl, "k1_sm90_w_vg", lambda x: arranged.append(vg(x)) or arranged[-1])
    before = {k: _lib.LAUNCHES[k] for k in NAMES_FWD}
    tfl.fused_layer_fwd_cuda(edges, center, cf, w, H, SCALE, w8a8=w8a8, sm90=sm90)
    assert [k for k in fake.calls if not k.endswith("_smem")] == [entry]
    args = fake.calls[entry]
    int8_t, scales = tfl._w8a8_kernel_args(edges, w8a8, H, SCALE)
    assert _scales_of(args) == list(scales)
    if counter.endswith("_sm90"):
        assert isinstance(args[13], ctypes.Array) and len(args) == 13 + 1 + 2 + 7
        # the int8 w_in^T in blocks of 64, value block i then gate block i
        assert len(arranged) == 1 and arranged[0].dtype == torch.int8
        assert torch.equal(arranged[0], vg(w8a8[1][3]))
        assert arranged[0].shape == (2 * F, D)
        assert list(fake.calls) == ["mtt_fused_layer_fwd_w8a8_sm90_smem", entry]
        assert fake.calls["mtt_fused_layer_fwd_w8a8_sm90_smem"] == (M, D, H, F)
    else:
        assert not arranged
    assert {k: _lib.LAUNCHES[k] - before[k] for k in NAMES_FWD} == {
        k: int(k == counter) for k in NAMES_FWD}


@pytest.mark.parametrize("M, sm90, entry, counter", [
    (64, True, "mtt_fused_layer_bwd_w8a8_sm90", "fused_layer_bwd_w8a8_sm90"),
    (16, True, "mtt_fused_layer_bwd_w8a8_sm90", "fused_layer_bwd_w8a8_sm90"),
    (64, False, "mtt_fused_layer_bwd_w8a8", "fused_layer_bwd_w8a8"),
    (96, True, "mtt_fused_layer_bwd_w8a8", "fused_layer_bwd_w8a8"),
])
def test_backward_wrapper_launches_what_the_rule_says(fake, M, sm90, entry, counter):
    """K2-W8A8: the Hopper K2's W8A8 mode where the rule takes the call
    (the inputs, nine bf16 weights, w_out^T, the int8 w_qkv^T and w_in^T,
    the scales, the cotangents, the outputs, then the attention scale); the
    general body with ``sm90=False`` or outside its shapes; W8A8 with
    weight gradients raises."""
    edges, center, cf, w, ge, gc = _torch_case(3, M, D, F)
    w8a8 = _w8a8(edges, center, cf, w)
    before = {k: _lib.LAUNCHES[k] for k in NAMES_BWD}
    tfl.fused_layer_bwd_cuda(edges, center, cf, w, ge, gc, H, SCALE, w8a8=w8a8, sm90=sm90)
    assert [k for k in fake.calls if not k.endswith("_smem")] == [entry]
    args = fake.calls[entry]
    _, scales = tfl._w8a8_kernel_args(edges, w8a8, H, SCALE)
    assert _scales_of(args) == list(scales)
    if counter.endswith("_sm90"):
        assert isinstance(args[15], ctypes.Array) and len(args) == 15 + 1 + 5 + 8
        assert args[-3] == pytest.approx(SCALE)
        assert args[16:18] == (ge.data_ptr(), gc.data_ptr())
    assert {k: _lib.LAUNCHES[k] - before[k] for k in NAMES_BWD} == {
        k: int(k == counter) for k in NAMES_BWD}
    with pytest.raises(ValueError, match="inference only"):
        tfl.fused_layer_bwd_cuda(edges, center, cf, w, ge, gc, H, SCALE, True, w8a8=w8a8)


def test_cpu_layer_runs_the_plain_versions_at_the_served_shape():
    """The W8A8 layer on CPU bf16 tensors at a shape the Hopper W8A8 pair
    takes is ``layer_math`` / ``layer_bwd_math`` with ``w8a8``, bit for
    bit; the wrappers themselves refuse CPU tensors there, with and without
    ``sm90``."""
    M = 64
    edges, center, cf, w, ge, gc = _torch_case(2, M, D, F)
    assert _lib.k1_sm90_takes(BF16, M, D, H, F, w8a8=True)
    assert _lib.k2_sm90_takes(BF16, M, D, H, F, w8a8=True)
    w8a8 = _w8a8(edges, center, cf, w)
    x = [t.clone().requires_grad_(True) for t in (edges, center, cf)]
    out = tfl.w8a8_transformer_layer(*x, w, H, SCALE, w8a8[0])
    grads = torch.autograd.grad(out, x, (ge, gc))
    for a, b in zip(out, tfl.layer_math(edges, center, cf, w, H, SCALE, w8a8=w8a8)):
        assert torch.equal(a, b)
    for a, b in zip(grads, tfl.layer_bwd_math(edges, center, cf, w, ge, gc, H, SCALE, w8a8=w8a8)):
        assert torch.equal(a, b)
    for sm90 in (True, False):
        with pytest.raises(ValueError, match="cuda"):
            tfl.fused_layer_fwd_cuda(edges, center, cf, w, H, SCALE, w8a8=w8a8, sm90=sm90)
        with pytest.raises(ValueError, match="cuda"):
            tfl.fused_layer_bwd_cuda(edges, center, cf, w, ge, gc, H, SCALE, w8a8=w8a8, sm90=sm90)


# ---- a float emulation of the kernels' roundings -----------------------------


def _forward(edges, center, cf, w, w8a8, dense_int8=True):
    """K1-W8A8's forward in float with the kernels' own roundings:
    ``layer_math``'s W8A8 branches (n1 and h_norm quantized from their
    floats, q and k from the dequantized floats, vg and the FFN-out sum
    dequantized with two roundings), and the attention as the tensor cores
    take it: ecf = rnd(cf e) in bf16, attn = rnd((ecf v) / z). With
    ``dense_int8=False`` a kernel whose dense products stayed bf16: the
    exact layer with W8A8's int8 scores alone. ``(edge_out, center_attn)``
    and the recompute's pieces."""
    calib, (wq, wk, wv, w_in, w_fo) = w8a8
    A, M, D_ = edges.shape
    cd, f32 = edges.dtype, torch.float32
    eps = tfl.rmsnorm_eps(cd)
    wc = tfl.LayerWeights(*(x.to(cd) for x in w))
    tokens = tfl._with_center(edges, center)
    x1, r1 = tfl._rms_stats(tokens, f32, eps)
    if dense_int8:
        n1 = tfl.rms_norm_q(tokens, wc.norm_attn, calib.normed).reshape(A * M, D_)
        b = wc.b_qkv.to(f32)
        q_f, k_f, v = (tfl.dot_i8(n1, wx, tfl.deq(calib.normed, ax), b[i * D_:(i + 1) * D_])
                       .reshape(A, M, H, D_ // H)
                       for i, (wx, ax) in enumerate(((wq, calib.w_q), (wk, calib.w_k), (wv, calib.w_v))))
        q, k, v = q_f.to(cd), k_f.to(cd), v.to(cd)
    else:
        n1 = (x1 * r1 * wc.norm_attn.to(f32)).to(cd)
        qkv = tfl._matmul_bias(n1.reshape(A * M, D_), wc.w_qkv, wc.b_qkv, cd)
        q, k, v = qkv.reshape(A, M, 3, H, D_ // H).unbind(2)
        q_f, k_f = q.to(f32), k.to(f32)
    qi, ki = tfl.qs_static(q_f, calib.q).double(), tfl.qs_static(k_f, calib.k).double()
    s = torch.einsum("aqhd,akhd->ahqk", qi, ki).to(f32) * tfl._f32(tfl.deq(calib.q, calib.k) * SCALE)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ecf = (e * cf.to(f32)[:, None, None, :]).to(cd).to(f32)
    z = ecf.sum(dim=-1, keepdim=True)
    num = torch.einsum("ahqk,akhd->aqhd", ecf, v.to(f32))
    attn = (num / z.permute(0, 2, 1, 3)).to(cd).reshape(A * M, D_)
    attn_out = tfl._matmul_bias(attn, wc.w_out, wc.b_out, cd).reshape(A, M, D_)
    res = tokens + attn_out
    x2, r2 = tfl._rms_stats(res, f32, eps)
    if dense_int8:
        _, vg = tfl._w8a8_ffn_in(res, wc, w8a8)
        ffn_i8 = tfl.qs_static(vg[:, :F] * torch.sigmoid(vg[:, F:]), calib.ffn_h)
        ffn_out = tfl.dot_i8(ffn_i8, w_fo, tfl.deq(calib.ffn_h, calib.w_fo),
                             wc.b_ffn_out.to(f32)).to(cd)
    else:
        h_norm = (x2 * r2 * wc.norm_mlp.to(f32)).to(cd)
        vg = tfl._matmul_bias(h_norm.reshape(A * M, D_), wc.w_in, wc.b_in)
        ffn_h = (vg[:, :F] * torch.sigmoid(vg[:, F:])).to(cd)
        ffn_out = tfl._matmul_bias(ffn_h, wc.w_ffn_out, wc.b_ffn_out, cd)
    out = (tfl._zero_last_slot(res + ffn_out.reshape(A, M, D_)), attn_out[:, M - 1])
    return out, dict(x1=x1, r1=r1, x2=x2, r2=r2, q=q, k=k, v=v, probs=e / z, p_attn=ecf / z, vg=vg)


def _backward(edges, center, cf, w, g_edge, g_center, w8a8, dense_int8=True):
    """K2-W8A8's input gradients as the kernel rounds them: its recompute
    (:func:`_forward`), every gradient product on the bf16 weights and the
    bf16 q, k, v (straight through), and P, d_attn (dO) and dS in the
    compute dtype for the attention's tensor cores, as K2-int8 rounds
    them."""
    A, M, D_ = edges.shape
    cd, acc = edges.dtype, torch.float32
    wc = tfl.LayerWeights(*(x.to(cd) for x in w))
    wa = tfl.LayerWeights(*(x.to(acc) for x in wc))
    t = _forward(edges, center, cf, w, w8a8, dense_int8)[1]

    def r(x):
        return x.to(cd).to(acc)

    x1, r1, x2, r2 = t["x1"], t["r1"], t["x2"], t["r2"]
    value, sig = t["vg"][:, :F], torch.sigmoid(t["vg"][:, F:])
    g_eo = tfl._zero_last_slot(g_edge.to(cd)).to(acc)
    d_ffn_h = g_eo.reshape(A * M, D_) @ wa.w_ffn_out.T
    d_vg = torch.cat([d_ffn_h * sig, d_ffn_h * value * sig * (1.0 - sig)], dim=-1).to(cd)
    d_h = (d_vg.to(acc) @ wa.w_in.T).reshape(A, M, D_)
    gs2 = d_h * (r2 * wa.norm_mlp)
    d_res = g_eo + gs2 - x2 * (r2 * r2 * torch.sum(gs2 * x2, dim=-1, keepdim=True) / D_)
    d_attn_out = torch.cat([d_res[:, :-1], d_res[:, -1:] + g_center.to(acc)[:, None]], dim=1)
    d_attn = r((d_attn_out.to(cd).to(acc).reshape(A * M, D_) @ wa.w_out.T).reshape(A, M, H, D_ // H))
    q, k, v, probs, p_attn = t["q"], t["k"], t["v"], t["probs"], t["p_attn"]
    d_p = torch.einsum("aqhd,akhd->ahqk", d_attn, v.to(acc))
    delta = torch.sum(p_attn * d_p, dim=-1, keepdim=True)
    tt = probs * (d_p - delta)
    d_cf = torch.sum(tt, dim=(1, 2))
    d_s = r(cf.to(acc)[:, None, None, :] * tt)
    d_q = torch.einsum("ahqk,akhd->aqhd", d_s, k.to(acc)) * SCALE
    d_k = torch.einsum("ahqk,aqhd->akhd", d_s, q.to(acc)) * SCALE
    d_v = torch.einsum("ahqk,aqhd->akhd", r(p_attn), d_attn)
    d_qkv = torch.stack([d_q, d_k, d_v], dim=2).reshape(A * M, 3 * D_).to(cd)
    d_n1 = (d_qkv.to(acc) @ wa.w_qkv.T).reshape(A, M, D_)
    gs1 = d_n1 * (r1 * wa.norm_attn)
    d_tokens = d_res + gs1 - x1 * (r1 * r1 * torch.sum(gs1 * x1, dim=-1, keepdim=True) / D_)
    return tfl._zero_last_slot(d_tokens).to(cd), d_tokens[:, M - 1].to(cd), d_cf


@pytest.mark.parametrize("M", [64, 48, 16])
def test_kernel_roundings_stay_within_the_kernel_bound(M):
    """At the served widths (D 128, 8 heads, F 256) the emulation of the
    kernels' own roundings is within 1e-2 relative RMS of the plain
    versions with the same calibration, half the 2e-2 that ``chip_smoke.py``
    allows (the kernels' summation orders and ``rsqrtf`` need the rest)."""
    edges, center, cf, w, ge, gc = _torch_case(8, M, D, F, seed=M + 1)
    w8a8 = _w8a8(edges, center, cf, w)
    fwd = _forward(edges, center, cf, w, w8a8)[0]
    for a, b in zip(fwd, tfl.layer_math(edges, center, cf, w, H, SCALE, w8a8=w8a8)):
        assert _rel_rms(a.float(), b.float()) < 1e-2
    bwd = _backward(edges, center, cf, w, ge, gc, w8a8)
    plain = tfl.layer_bwd_math(edges, center, cf, w, ge, gc, H, SCALE, w8a8=w8a8)
    for a, b in zip(bwd, plain):
        rel = _rel_rms(a.float(), b.float())
        assert 0 < rel < 1e-2, rel


def _jax(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, np.float32), dtype)


def test_kernel_roundings_against_the_jax_w8a8_kernel_in_bf16():
    """The JAX package's bf16 W8A8 layer, its interpret-mode kernels with a
    calibration (``fused_transformer_layer`` and its input gradients under
    ``no_param_grads``, as ``tests/test_torch_port_w8a8.py`` runs them), at
    the served widths: 5 atoms at M = 64. The emulation of the kernels
    agrees with it to bf16 noise: within the 2e-2 of the port's W8A8 parity
    tests, and within twice the plain version's own distance from it."""
    A, M = 5, 64
    edges, center, cf, w, ge, gc = _case(A, M, D, F, seed=11)
    bf = jnp.bfloat16
    jw = jfl.LayerWeights(*map(_jax, w))
    je, jc, jcf = _jax(edges, bf), _jax(center, bf), _jax(cf)
    stats = np.asarray(jfl.layer_probe_stats(je, jc, jcf, jw, H, SCALE), np.float64)
    wq = np.asarray(w[1], np.float64)

    def am(x):
        return float(np.max(np.abs(np.asarray(x, np.float64))))

    calib = jfl.Int8Calib(*(float(x) for x in stats), am(wq[:, :D]), am(wq[:, D:2 * D]),
                          am(wq[:, 2 * D:]), am(w[6]), am(w[8]))
    with jax_no_param_grads():
        j_out, vjp = jax.vjp(
            lambda e, c, f: jfl.fused_transformer_layer(e, c, f, jw, H, SCALE, calib), je, jc, jcf)
        j_in = vjp((_jax(ge, bf), _jax(gc, bf)))
    t = _torch_case(A, M, D, F, seed=11)
    w8a8 = _w8a8(*t[:4], tfl.Int8Calib(*calib))
    emulated = (*_forward(*t[:4], w8a8)[0], *_backward(*t, w8a8))
    plain = (*tfl.layer_math(*t[:4], H, SCALE, w8a8=w8a8),
             *tfl.layer_bwd_math(*t, H, SCALE, w8a8=w8a8))
    for em, p, j in zip(emulated, plain, (*j_out, *j_in)):
        j = np.asarray(j, np.float32)
        err, err_plain = _rel_rms(em.float(), j), _rel_rms(p.float(), j)
        assert err < 2e-2, err
        assert err < 2 * err_plain, (err, err_plain)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_w8a8", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("dense_int8, follows", [(True, True), (False, False)])
def test_chip_smoke_tells_the_w8a8_mode_from_the_exact_one(dense_int8, follows):
    """``chip_smoke.compare_int8_mode`` on the kernels' emulation (K1-W8A8's
    outputs and K2-W8A8's input gradients) against ``layer_math`` /
    ``layer_bwd_math`` with ``w8a8`` and without it, at the served widths:
    the emulation follows the W8A8 mode, and lies within the 2e-2 bound of
    ``compare``; the same emulation with its dense products in bf16 (the
    int8 scores alone) is refused by the mode check itself, output by
    output, whatever ``compare`` would say of it."""
    cs = _chip_smoke()
    edges, center, cf, w, ge, gc = _torch_case(16, 64, D, F, seed=7)
    w8a8 = _w8a8(edges, center, cf, w)
    i1 = tfl.layer_math(edges, center, cf, w, H, SCALE, w8a8=w8a8)
    x1 = tfl.layer_math(edges, center, cf, w, H, SCALE)
    i2 = tfl.layer_bwd_math(edges, center, cf, w, ge, gc, H, SCALE, w8a8=w8a8)
    x2 = tfl.layer_bwd_math(edges, center, cf, w, ge, gc, H, SCALE)
    k1 = _forward(edges, center, cf, w, w8a8, dense_int8)[0]
    k2 = _backward(edges, center, cf, w, ge, gc, w8a8, dense_int8)
    if follows:
        for k, i, x in ((k1, i1, x1), (k2, i2, x2)):
            for a, b in zip(k, i):
                assert _rel_rms(a.float(), b.float()) < cs.BF16_BOUND
            got = cs.compare_int8_mode(k, i, x)
            assert all(d > 1e-3 for d in got["mode_distance"]), got
    else:
        for k, i, x in ((k1, i1, x1), (k2, i2, x2)):
            for a, b, c in zip(k, i, x):
                with pytest.raises(RuntimeError, match="does not follow the int8 mode"):
                    cs.compare_int8_mode((a,), (b,), (c,))


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_front_bits_tool_finds_its_w8a8_marks():
    """``tools/sm90_front.py --w8a8`` copies, as floats, q|k|v and the int8
    q|k (before the attention), attn, res, the int8 h_norm and vg out of
    copies of the Hopper K1 and K2 at marks each source holds once, into
    rows of twelve slots; vg after each of K1's FFN-in chunks and after K2's
    dequantized FFN-in panels, in the W8A8 mode alone."""
    tool = _tool("sm90_front")
    kernels = {key: (source, marks) for key, source, marks in tool.KERNELS["w8a8"]}
    assert {k: s for k, (s, _) in kernels.items()} == {"k1": "fused_layer_fwd_sm90.cu",
                                                       "k2": "fused_layer_bwd_sm90.cu"}
    for key, (source, marks) in kernels.items():
        text = tool.instrument((tool.CSRC / source).read_text(), marks)
        # five row copies (q|k|v, the int8 q|k, attn, res, the int8
        # h_norm), K1's for both atoms of a block
        assert text.count("] = dump_f(") == (10 if key == "k1" else 5)
        assert "* 12 * D + 6 * D + i_ % (2 * D)] = dump_f(" in text
        assert text.index("* 12 * D + 3 * D + i_ % (3 * D)]") < text.index("attention_fwd<I8>(")
        vg = text.index(f"* 12 * D + {tool.VG_SLOT} * D + ")
        if key == "k1":
            assert text.index("glu_mm_s8(ring, c, HN, av, ag);") < vg < text.index(
                "panel_mm_s8<1>(ring, c, [&](int, int& ld) { ld = LA8; return (const int8_t*)FH; }, fo);")
        else:
            assert text.index("panel_mm_s8<1>(ring, c, op8, g8);") < vg < text.index("// d_vg = rnd(")
    assert sum(b - a for a, b in tool.W8A8_SLOTS.values()) == 12


def test_phase_split_and_times_tools_find_the_w8a8_kernels():
    """``tools/k2_split.py --body hopper-w8a8`` instruments the Hopper K2's
    source at the exact body's seven phase marks and calls the W8A8 entry
    with the port's int8 weights and scales; ``tools/layer_times.py`` times
    and digests K1-W8A8 and K2-W8A8 beside their general bodies."""
    tool = _tool("k2_split")
    text = tool.instrument((tool.CSRC / "fused_layer_bwd_sm90.cu").read_text(), tool.HOPPER)
    n = len(tool.HOPPER_PHASES)
    assert [f"SPLIT({i})" in text for i in range(n + 1)] == [True] * n + [False]
    source = (TOOLS / "k2_split.py").read_text()
    assert '"hopper-w8a8"' in source and "mtt_fused_layer_bwd_w8a8_sm90" in source
    assert "port_w8a8" in source
    text = (TOOLS / "layer_times.py").read_text()
    for name in ("fused_layer_fwd_w8a8", "fused_layer_bwd_w8a8", "fused_layer_fwd_w8a8_general",
                 "fused_layer_bwd_w8a8_general"):
        assert f'("{name}", ' in text, name


def test_chip_smoke_expects_the_hopper_w8a8_pair():
    """``chip_smoke.py``'s launch tables: the served W8A8 call launches the
    Hopper K1-W8A8 and K2-W8A8 four times each and the general W8A8 bodies
    and the exact K1/K2 never. The kernel line has the two Hopper entries in
    place of the general bodies' (which run on no path: their times are the
    entries' ``general_ms``), each with its launches from the W8A8 call."""
    cs = _chip_smoke()
    assert cs.W8A8_SM90 == ("fused_layer_fwd_w8a8_sm90", "fused_layer_bwd_w8a8_sm90")
    assert cs.W8A8_KERNELS[:2] == list(cs.W8A8_SM90)
    assert set(cs.W8A8_NEVER) == {"fused_layer_fwd_w8a8", "fused_layer_bwd_w8a8", "fused_layer_fwd",
                                  "fused_layer_bwd", "fused_layer_fwd_sm90", "fused_layer_bwd_sm90"}
    assert cs.SOURCES["fused_layer_fwd_w8a8_sm90"][0].endswith("csrc/fused_layer_fwd_sm90.cu")
    assert cs.SOURCES["fused_layer_bwd_w8a8_sm90"][0].endswith("csrc/fused_layer_bwd_sm90.cu")
    assert cs.SOURCES["fused_layer_fwd_w8a8_sm90"][1].startswith(
        "metatrain_tpu/ops/pallas/fused_layer.py:1161")
    assert "fused_layer_fwd_w8a8" not in cs.SOURCES and "fused_layer_bwd_w8a8" not in cs.SOURCES
    assert cs.N_ENTRIES == 55
    report = {"slice_w8a8": {"launches": {"fused_layer_fwd_w8a8_sm90": 12,
                                          "fused_layer_bwd_w8a8_sm90": 12}}}
    assert [cs.launch_count(report, k) for k in cs.W8A8_SM90] == [12, 12]
