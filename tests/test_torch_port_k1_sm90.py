"""The Hopper K1 (``csrc/fused_layer_fwd_sm90.cu``): which calls take it, its
shared-memory budget, the weights it reads, the CPU path beside it, and the
margin that its one extra bf16 rounding spends.

The kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``layer_math`` there). Here:

- the dispatch rule ``_lib.k1_sm90_takes``: the bfloat16 variant, exact or
  with the dynamic int8 scores (K1-int8, the kernel's int8-score mode), at
  D = 128, heads of 16, 16 <= M <= 64 with M % 16 == 0, F a multiple of
  128 (the Hopper K2's shapes);
- its budget ``_lib.k1_sm90_smem`` (the C side's layout, mirrored) fits
  the 232,448 bytes a block may have at every shape it takes;
- the wrapper's arrangement of w_in that its staged chunks read;
- on the CPU the layer's forward still runs the plain version, and the
  wrapper still refuses CPU tensors at the shapes the new kernel takes;
- rounding the softmax weights P = cf e / z to bf16 before P V (the
  kernel's tensor cores take them so, as the Hopper K2's recompute and the
  JAX package do; the plain version keeps them float) moves the outputs by
  less than the 2e-2 relative RMS that ``chip_smoke.py`` allows, at the
  served widths, and keeps the port within bf16 noise of the JAX
  package's bf16 layer.
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatrain_tpu.ops.pallas import fused_layer as jfl
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import fused_layer as tfl

BF16 = torch.bfloat16


@pytest.mark.parametrize("dtype, M, D, H, F, w8, i8, takes", [
    (BF16, 64, 128, 8, 256, False, False, True),   # the served call
    (BF16, 48, 128, 8, 256, False, False, True),   # bench.py's M
    (BF16, 16, 128, 8, 256, False, False, True),
    (BF16, 32, 128, 8, 256, False, False, True),
    (BF16, 64, 128, 8, 128, False, False, True),
    (BF16, 64, 128, 8, 512, False, False, True),
    (torch.float32, 64, 128, 8, 256, False, False, False),
    (BF16, 64, 128, 8, 256, True, False, True),    # K1-W8A8 (the W8A8 mode)
    (BF16, 64, 128, 8, 256, False, True, True),    # K1-int8 (the int8-score mode)
    (BF16, 80, 128, 8, 256, False, False, False),  # M > 64
    (BF16, 56, 128, 8, 256, False, False, False),  # M % 16
    (BF16, 64, 256, 16, 512, False, False, False),  # D = 256
    (BF16, 64, 128, 16, 256, False, False, False),  # heads of 8
    (BF16, 64, 128, 4, 256, False, False, False),  # heads of 32
    (BF16, 64, 128, 8, 192, False, False, False),  # F % 128
])
def test_dispatch_rule(dtype, M, D, H, F, w8, i8, takes):
    assert _lib.k1_sm90_takes(dtype, M, D, H, F, w8, i8) is takes
    # the budget depends on the shape alone, and the shapes are the Hopper K2's
    assert (_lib.k1_sm90_smem(M, D, H, F) > 0) is _lib.k1_sm90_takes(BF16, M, D, H, F)
    assert _lib.k1_sm90_takes(BF16, M, D, H, F) is _lib.k2_sm90_takes(BF16, M, D, H, F)


def test_smem_budget_fits_every_shape_it_takes():
    taken = 0
    for M in range(16, 257, 16):
        for F in range(128, 2049, 128):
            nbytes = _lib.k1_sm90_smem(M, 128, 8, F)
            if M <= 64:
                # two atoms per block: q|k|v and the operand tile each, the
                # ring, cf and the norms' factors each
                assert nbytes == 185856 and nbytes <= _lib.MAX_SHARED_BYTES
                taken += 1
            else:
                assert nbytes == 0
    assert taken == 4 * 16


@pytest.mark.parametrize("F", [128, 256, 512])
def test_w_vg_interleaves_value_and_gate_blocks(F):
    """Rows 128 i .. 128 i + 63 of the kernel's w_in copy are value columns
    64 i .. 64 i + 63 of w_in, the next 64 rows the same gate columns: one
    128-row staged chunk holds both halves of a 64-column F tile."""
    D = 128
    w_in = torch.arange(D * 2 * F, dtype=torch.float32).reshape(D, 2 * F).to(BF16)
    w_vg = tfl.k1_sm90_w_vg(w_in)
    assert w_vg.shape == (2 * F, D) and w_vg.is_contiguous()
    for i in range(F // 64):
        assert torch.equal(w_vg[128 * i:128 * i + 64], w_in[:, 64 * i:64 * i + 64].T)
        assert torch.equal(w_vg[128 * i + 64:128 * i + 128], w_in[:, F + 64 * i:F + 64 * i + 64].T)


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
    edges = rng.normal(size=(A, M, D))
    center = rng.normal(size=(A, D))
    return edges, center, cf, w


def _torch_case(A, M, D, F, seed=0):
    edges, center, cf, w = _case(A, M, D, F, seed)
    return (torch.from_numpy(edges).to(BF16), torch.from_numpy(center).to(BF16),
            torch.from_numpy(cf).float(), tfl.LayerWeights(*(torch.from_numpy(a).float() for a in w)))


def test_cpu_forward_runs_the_plain_version_at_the_served_shape():
    """The layer on CPU bf16 tensors at a shape the Hopper K1 takes is
    ``layer_math``'s, bit for bit; the wrapper itself still refuses CPU
    tensors there, with and without ``sm90``."""
    M, D, H, F = 64, 128, 8, 256
    edges, center, cf, w = _torch_case(2, M, D, F)
    scale = 1.0 / math.sqrt(D // H)
    assert _lib.k1_sm90_takes(BF16, M, D, H, F)
    out = tfl.fused_transformer_layer(edges, center, cf, w, H, scale)
    plain = tfl.layer_math(edges, center, cf, w, H, scale)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    for sm90 in (True, False):
        with pytest.raises(ValueError, match="cuda"):
            tfl.fused_layer_fwd_cuda(edges, center, cf, w, H, scale, sm90=sm90)


def _fwd_rounded(edges, center, cf, w, H, scale, round_p=True):
    """``layer_math``'s exact bf16 forward with the softmax weights P = cf
    e / z rounded to the compute dtype before P V, as the Hopper K1 rounds
    them (``round_p=False``: the plain version itself). A copy for this
    test; the plain version is unchanged."""
    A, M, D = edges.shape
    cd, acc = edges.dtype, torch.float32
    hd = D // H
    eps = tfl.rmsnorm_eps(cd)
    wc = tfl.LayerWeights(*(x.to(cd) for x in w))
    tokens = tfl._with_center(edges, center)
    x1, r1 = tfl._rms_stats(tokens, acc, eps)
    normed = (x1 * r1 * wc.norm_attn.to(acc)).to(cd)
    qkv = tfl._matmul_bias(normed.reshape(A * M, D), wc.w_qkv, wc.b_qkv, cd)
    q, k, v = qkv.reshape(A, M, 3, H, hd).unbind(2)
    probs, cf_k = tfl._attention_probs(q, k, cf, scale, acc)
    p_attn = cf_k * probs
    if round_p:
        p_attn = p_attn.to(cd).to(acc)
    attn = torch.einsum("ahqk,akhd->aqhd", p_attn, v.to(p_attn.dtype)).reshape(A * M, D).to(cd)
    attn_out = tfl._matmul_bias(attn, wc.w_out, wc.b_out, cd).reshape(A, M, D)
    res = tokens + attn_out
    x2, r2 = tfl._rms_stats(res, acc, eps)
    h_norm = (x2 * r2 * wc.norm_mlp.to(acc)).to(cd)
    vg = tfl._matmul_bias(h_norm.reshape(A * M, D), wc.w_in, wc.b_in)
    F = wc.w_ffn_out.shape[0]
    ffn_h = (vg[:, :F] * torch.sigmoid(vg[:, F:])).to(cd)
    ffn_out = tfl._matmul_bias(ffn_h, wc.w_ffn_out, wc.b_ffn_out, cd)
    return tfl._zero_last_slot(res + ffn_out.reshape(A, M, D)), attn_out[:, M - 1]


def _rel_rms(a, b):
    a, b = torch.as_tensor(np.asarray(a, np.float64)), torch.as_tensor(np.asarray(b, np.float64))
    return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()


@pytest.mark.parametrize("M", [64, 48])
def test_bf16_softmax_weights_stay_within_the_kernel_bound(M):
    D, H, F = 128, 8, 256
    edges, center, cf, w = _torch_case(8, M, D, F, seed=M)
    scale = 1.0 / math.sqrt(D // H)
    plain = tfl.layer_math(edges, center, cf, w, H, scale)
    # the emulation is the plain version but for the one rounding
    for a, b in zip(_fwd_rounded(edges, center, cf, w, H, scale, round_p=False), plain):
        assert torch.equal(a, b)
    rounded = _fwd_rounded(edges, center, cf, w, H, scale)
    for a, b in zip(rounded, plain):
        rel = _rel_rms(a.double(), b.double())
        # half the bound: the kernel's other differences (summation order)
        # need the rest
        assert 0 < rel < 1e-2, rel


def test_rounded_softmax_weights_against_the_jax_layer_in_bf16():
    """The JAX package's ``_layer_math`` (its plain path, as the JAX tests
    run it) in bf16 rounds the softmax weights before P V too, among its
    own roundings: the emulation of the kernel agrees with it to bf16
    noise, within twice the plain version's own distance from it (two
    independent roundings of one size add to about 1.4 times it)."""
    M, D, H, F = 64, 128, 8, 256
    edges, center, cf, w = _case(4, M, D, F, seed=3)
    scale = 1.0 / math.sqrt(D // H)
    bf = jnp.bfloat16
    j_out = jfl._layer_math(jnp.asarray(edges, bf), jnp.asarray(center, bf),
                            jnp.asarray(cf, jnp.float32),
                            jfl.LayerWeights(*(jnp.asarray(a, jnp.float32) for a in w)), H, scale)
    t_args = _torch_case(4, M, D, F, seed=3)
    rounded = _fwd_rounded(*t_args, H, scale)
    plain = tfl.layer_math(*t_args, H, scale)
    for j, r, p in zip(j_out, rounded, plain):
        j = np.asarray(j, np.float32)
        err_rounded = _rel_rms(r.float().numpy(), j)
        err_plain = _rel_rms(p.float().numpy(), j)
        assert err_rounded < 1e-2, err_rounded
        assert err_rounded < 2 * err_plain, (err_rounded, err_plain)


def test_phase_split_tool_finds_the_hopper_k1_marks():
    """``tools/k2_split.py --body k1-hopper`` instruments a copy of the
    Hopper K1 at its phase marks: every mark is in the source once, five
    phases."""
    path = Path(tfl.__file__).resolve().parents[2] / "tools" / "k2_split.py"
    spec = importlib.util.spec_from_file_location("k2_split", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    text = tool.instrument((tool.CSRC / "fused_layer_fwd_sm90.cu").read_text(), tool.K1_HOPPER)
    assert [f"SPLIT({i})" in text for i in range(6)] == [True] * 5 + [False]
    assert len(tool.K1_HOPPER_PHASES) == 5


def test_front_bits_tool_finds_its_marks():
    """``tools/sm90_front.py`` copies attn, res and h_norm out of copies of
    the Hopper K1 and K2 at its marks: every mark is in its source once."""
    path = Path(tfl.__file__).resolve().parents[2] / "tools" / "sm90_front.py"
    spec = importlib.util.spec_from_file_location("sm90_front", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for source, marks in (("fused_layer_fwd_sm90.cu", tool.K1_MARKS),
                          ("fused_layer_bwd_sm90.cu", tool.K2_MARKS)):
        text = tool.instrument((tool.CSRC / source).read_text(), marks)
        assert text.count("g_dump[") == (6 if source.startswith("fused_layer_fwd") else 3)
