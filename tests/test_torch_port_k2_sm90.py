"""The Hopper K2 (``csrc/fused_layer_bwd_sm90.cu``): which calls take it, its
shared-memory budget, the CPU path beside it, and the margin that its
extra bf16 roundings spend.

The kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``layer_bwd_math`` there). Here:

- the dispatch rule ``_lib.k2_sm90_takes``: the bfloat16 input-gradient
  variant, exact or with the dynamic int8 scores (K2-int8, the kernel's
  int8-score mode), at D = 128, heads of 16, 16 <= M <= 64 with M % 16 ==
  0, F a multiple of 128;
- its budget ``_lib.k2_sm90_smem`` (the C side's layout, mirrored) fits
  the 232,448 bytes a block may have at every shape it takes;
- on the CPU the layer's backward still runs the plain version, and the
  wrapper still refuses CPU tensors at the shapes the new kernel takes;
- rounding the softmax weights P, d_attn and dS to bf16 before the
  attention's products (the kernel's tensor cores take them so; the plain
  version keeps them float) moves the input gradients by less than the
  2e-2 relative RMS that ``chip_smoke.py`` allows, at the served widths.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import fused_layer as tfl

BF16 = torch.bfloat16


@pytest.mark.parametrize("dtype, M, D, H, F, dw, w8, i8, takes", [
    (BF16, 64, 128, 8, 256, False, False, False, True),   # the served call
    (BF16, 48, 128, 8, 256, False, False, False, True),   # bench.py's M
    (BF16, 16, 128, 8, 256, False, False, False, True),
    (BF16, 32, 128, 8, 512, False, False, False, True),
    (BF16, 64, 128, 8, 128, False, False, False, True),
    (torch.float32, 64, 128, 8, 256, False, False, False, False),
    (BF16, 64, 128, 8, 256, True, False, False, False),   # K2-dW
    (BF16, 64, 128, 8, 256, False, True, False, True),    # K2-W8A8 (the W8A8 mode)
    (BF16, 64, 128, 8, 256, False, False, True, True),    # K2-int8 (the int8-score mode)
    (BF16, 80, 128, 8, 256, False, False, False, False),  # M > 64
    (BF16, 56, 128, 8, 256, False, False, False, False),  # M % 16
    (BF16, 64, 256, 16, 512, False, False, False, False),  # D = 256
    (BF16, 64, 128, 16, 256, False, False, False, False),  # heads of 8
    (BF16, 64, 128, 4, 256, False, False, False, False),  # heads of 32
    (BF16, 64, 128, 8, 192, False, False, False, False),  # F % 128
])
def test_dispatch_rule(dtype, M, D, H, F, dw, w8, i8, takes):
    assert _lib.k2_sm90_takes(dtype, M, D, H, F, dw, w8, i8) is takes
    # the budget depends on the shape alone
    assert (_lib.k2_sm90_smem(M, D, H, F) > 0) is _lib.k2_sm90_takes(BF16, M, D, H, F)


def test_smem_budget_fits_every_shape_it_takes():
    taken = 0
    for M in range(16, 257, 16):
        for F in range(128, 2049, 128):
            nbytes = _lib.k2_sm90_smem(M, 128, 8, F)
            if M <= 64:
                assert nbytes == 201472 and nbytes <= _lib.MAX_SHARED_BYTES
                taken += 1
            else:
                assert nbytes == 0
    assert taken == 4 * 16


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
    x = [torch.from_numpy(rng.normal(size=s)).to(BF16) for s in ((A, M, D), (A, D), (A, M, D), (A, D))]
    return (x[0], x[1], torch.from_numpy(cf).float(),
            tfl.LayerWeights(*(torch.from_numpy(a).float() for a in w)), x[2], x[3])


def test_cpu_backward_runs_the_plain_version_at_the_served_shape():
    """The layer's gradient on CPU bf16 tensors at a shape the Hopper K2
    takes is ``layer_bwd_math``'s, bit for bit; the wrapper itself still
    refuses CPU tensors there."""
    M, D, H, F = 64, 128, 8, 256
    edges, center, cf, w, g_edge, g_center = _case(2, M, D, F)
    scale = 1.0 / math.sqrt(D // H)
    assert _lib.k2_sm90_takes(BF16, M, D, H, F)
    e = edges.clone().requires_grad_(True)
    c = center.clone().requires_grad_(True)
    f = cf.clone().requires_grad_(True)
    out = tfl.fused_transformer_layer(e, c, f, w, H, scale)
    grads = torch.autograd.grad(out, (e, c, f), (g_edge, g_center))
    plain = tfl.layer_bwd_math(edges, center, cf, w, g_edge, g_center, H, scale)
    for a, b in zip(grads, plain):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="cuda"):
        tfl.fused_layer_bwd_cuda(edges, center, cf, w, g_edge, g_center, H, scale)


def _bwd_rounded(edges, center, cf, w, g_edge, g_center, H, scale):
    """``layer_bwd_math``'s input gradients (the exact layer) with the
    attention's tensor-core operands rounded as the Hopper K2 rounds them:
    the softmax weights P (recompute and dV), d_attn (dP and dV) and dS (dQ
    and dK) in the compute dtype. A copy for this test; the plain version
    is unchanged."""
    A, M, D = edges.shape
    cd, acc = edges.dtype, torch.float32
    hd = D // H
    eps = tfl.rmsnorm_eps(cd)
    wc = tfl.LayerWeights(*(x.to(cd) for x in w))
    wa = tfl.LayerWeights(*(x.to(acc) for x in wc))

    def r(x):
        return x.to(cd).to(acc)

    tokens = tfl._with_center(edges, center)
    x1, r1 = tfl._rms_stats(tokens, acc, eps)
    n1 = (x1 * r1 * wa.norm_attn).to(cd)
    qkv = tfl._matmul_bias(n1.reshape(A * M, D), wc.w_qkv, wc.b_qkv, cd)
    q, k, v = qkv.reshape(A, M, 3, H, hd).unbind(2)
    probs, cf_k = tfl._attention_probs(q, k, cf, scale, acc)
    p_attn = cf_k * probs
    attn = torch.einsum("ahqk,akhd->aqhd", r(p_attn), v.to(acc)).reshape(A * M, D).to(cd)
    attn_out = tfl._matmul_bias(attn, wc.w_out, wc.b_out, cd).reshape(A, M, D)
    res = tokens + attn_out
    x2, r2 = tfl._rms_stats(res, acc, eps)
    d_ff = wc.w_ffn_out.shape[0]
    h_norm = (x2 * r2 * wa.norm_mlp).to(cd)
    vg = tfl._matmul_bias(h_norm.reshape(A * M, D), wc.w_in, wc.b_in)
    value, sig = vg[:, :d_ff], torch.sigmoid(vg[:, d_ff:])
    g_eo = tfl._zero_last_slot(g_edge.to(cd)).to(acc)
    d_ffn_h = g_eo.reshape(A * M, D) @ wa.w_ffn_out.T
    d_vg = torch.cat([d_ffn_h * sig, d_ffn_h * value * sig * (1.0 - sig)], dim=-1).to(cd)
    d_h = (d_vg.to(acc) @ wa.w_in.T).reshape(A, M, D)
    gs2 = d_h * (r2 * wa.norm_mlp)
    d_res = g_eo + gs2 - x2 * (r2 * r2 * torch.sum(gs2 * x2, dim=-1, keepdim=True) / D)
    d_attn_out = torch.cat([d_res[:, :-1], d_res[:, -1:] + g_center.to(acc)[:, None]], dim=1)
    d_attn = r((d_attn_out.to(cd).to(acc).reshape(A * M, D) @ wa.w_out.T).reshape(A, M, H, hd))
    d_p = torch.einsum("aqhd,akhd->ahqk", d_attn, v.to(acc))
    delta = torch.sum(p_attn * d_p, dim=-1, keepdim=True)
    t = probs * (d_p - delta)
    d_cf = torch.sum(t, dim=(1, 2))
    d_s = r(cf_k * t)
    d_q = torch.einsum("ahqk,akhd->aqhd", d_s, k.to(acc)) * scale
    d_k = torch.einsum("ahqk,aqhd->akhd", d_s, q.to(acc)) * scale
    d_v = torch.einsum("ahqk,aqhd->akhd", r(p_attn), d_attn)
    d_qkv = torch.stack([d_q, d_k, d_v], dim=2).reshape(A * M, 3 * D).to(cd)
    d_n1 = (d_qkv.to(acc) @ wa.w_qkv.T).reshape(A, M, D)
    gs1 = d_n1 * (r1 * wa.norm_attn)
    d_tokens = d_res + gs1 - x1 * (r1 * r1 * torch.sum(gs1 * x1, dim=-1, keepdim=True) / D)
    return tfl._zero_last_slot(d_tokens).to(cd), d_tokens[:, M - 1].to(cd), d_cf


@pytest.mark.parametrize("M", [64, 48])
def test_bf16_attention_operands_stay_within_the_kernel_bound(M):
    D, H, F = 128, 8, 256
    edges, center, cf, w, g_edge, g_center = _case(8, M, D, F, seed=M)
    scale = 1.0 / math.sqrt(D // H)
    plain = tfl.layer_bwd_math(edges, center, cf, w, g_edge, g_center, H, scale)
    rounded = _bwd_rounded(edges, center, cf, w, g_edge, g_center, H, scale)
    for a, b in zip(rounded, plain):
        a, b = a.double(), b.double()
        rel = ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()
        # half the bound: the kernel's other differences (summation order)
        # need the rest
        assert 0 < rel < 1e-2, rel


def test_phase_split_tool_finds_its_marks():
    """``tools/k2_split.py`` instruments a copy of each K2 body at its phase
    marks: every mark is in the sources once, seven phases each."""
    path = Path(tfl.__file__).resolve().parents[2] / "tools" / "k2_split.py"
    spec = importlib.util.spec_from_file_location("k2_split", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for source, marks, names in (("fused_layer_bwd_sm90.cu", tool.HOPPER, tool.HOPPER_PHASES),
                                 ("layer_bwd.cuh", tool.GENERAL, tool.GENERAL_PHASES)):
        text = tool.instrument((tool.CSRC / source).read_text(), marks)
        assert [f"SPLIT({i})" in text for i in range(8)] == [True] * 7 + [False]
        assert len(names) == 7
