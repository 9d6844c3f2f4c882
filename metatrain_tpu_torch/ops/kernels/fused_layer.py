"""Fused PET transformer layer: CUDA kernels K1/K2 and their plain versions.

Counterpart of ``metatrain_tpu/ops/pallas/fused_layer.py``. One
PreLN/RMSNorm/SwiGLU layer on the reserved-slot token layout:

    tokens = edges with the center token written into slot M-1
    -> RMSNorm -> QKV -> window attention with multiplicative cutoff
       weights cf (cf e^s / sum cf e^s) -> out-proj -> +residual
    -> RMSNorm -> SwiGLU FFN -> +residual, slot M-1 zeroed

returning ``(edge_out, center_attn)`` where ``center_attn`` is the
attention output of slot M-1.

- :func:`layer_math` and :func:`layer_bwd_math` are the plain PyTorch
  versions (forward, and backward for input gradients plus, with
  ``weight_grads=True``, the weight gradients summed over atoms).
- :func:`fused_transformer_layer` is the ``autograd.Function`` entry: a
  tensor on the CPU runs the plain versions; a CUDA tensor launches K1
  (``csrc/fused_layer_fwd.cu``; the exact bfloat16 one at the served
  shapes, where no weight requires grad, ``csrc/fused_layer_fwd_sm90.cu``)
  and, for its gradient, K2
  (``csrc/fused_layer_bwd.cu``; likewise ``csrc/fused_layer_bwd_sm90.cu``):
  the input-gradient variant, or the
  weight-gradient variant K2-dW when a weight requires grad. The backward
  is itself differentiable (training with forces): its gradient replays
  :func:`layer_bwd_math` under autograd, chunk by chunk over atoms
  (:func:`replay_layer_bwd`, the port of ``_chunked_replay_bwd``).

The static W8A8 layer (the JAX package's ``MTT_INT8_STATIC=1``,
inference in bfloat16 only) runs the QKV, score, FFN-in and FFN-out
products in int8 with static scales (:class:`Int8Calib`, from
:func:`layer_probe_stats` on a probe forward and from the weights);
``layer_math`` and ``layer_bwd_math`` take it as ``w8a8=(calib,
int8_weights)``, the backward by straight-through estimation.
:func:`w8a8_transformer_layer` is its ``autograd.Function``: K1-W8A8 and
K2-W8A8 on the card (the same sources), the plain versions on the CPU.

The dynamic int8 scores (the JAX package's ``MTT_INT8_SCORES=1``,
bfloat16 in the q-side layout) quantize q and k with one absmax scale per
block of atoms (:func:`int8_block_scales`, the plain version of the absmax
pass ``csrc/int8_absmax.cu``; the blocks are the JAX forward's,
:func:`int8_block_atoms`), computed once per layer call and handed to the
forward, the backward and the second-order replay alike as per-atom
``int8_scales`` (A, 2). ``fused_transformer_layer(..., int8_scores=True)``
runs K1-int8 and K2-int8 / K2-dW-int8 on the card.

Weights keep the JAX package's (in, out) layout and are cast to the
compute dtype (the dtype of ``edges``); accumulation is float32 (float64
for float64 inputs).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _lib


class LayerWeights(NamedTuple):
    """Weights of one layer (D = d_pet, F = d_feedforward), (in, out) layout."""

    norm_attn: torch.Tensor  # (D,)
    w_qkv: torch.Tensor  # (D, 3D)
    b_qkv: torch.Tensor  # (3D,)
    w_out: torch.Tensor  # (D, D)
    b_out: torch.Tensor  # (D,)
    norm_mlp: torch.Tensor  # (D,)
    w_in: torch.Tensor  # (D, 2F): value columns first, then gate columns
    b_in: torch.Tensor  # (2F,)
    w_ffn_out: torch.Tensor  # (F, D)
    b_ffn_out: torch.Tensor  # (D,)


def accumulation_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def rmsnorm_eps(dtype: torch.dtype) -> float:
    """torch.nn.RMSNorm(eps=None) parity: finfo(compute dtype).eps, with
    sub-float32 dtypes capped at float32's (the mean square accumulates in
    float32)."""
    if torch.finfo(dtype).bits < 32:
        dtype = torch.float32
    return float(torch.finfo(dtype).eps)


def _rms_stats(x, acc, eps):
    x32 = x.to(acc)
    return x32, torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)


def _matmul_bias(x2d, w, b, out_dtype=None):
    acc = accumulation_dtype(x2d.dtype)
    out = x2d.to(acc) @ w.to(acc) + b.to(acc)
    return out if out_dtype is None else out.to(out_dtype)


def _with_center(edges, center):
    return torch.cat([edges[:, :-1], center.to(edges.dtype)[:, None]], dim=1)


def _zero_last_slot(x):
    return torch.cat([x[:, :-1], torch.zeros_like(x[:, -1:])], dim=1)


def _rounded_softmax(s, cf, cd):
    """The softmax of the int8 score paths (the JAX package's
    ``_qside_tail``): ``(E, P)`` with e = exp(s - max), E = e / z and the AV
    weights P = rnd(cf e) / z, z = sum_k rnd(cf e); cf e is rounded to the
    compute dtype ``cd`` before the AV product and the denominator."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
    e_cf = (e * cf.to(s.dtype)[:, None, None, :]).to(cd).to(s.dtype)
    z = torch.sum(e_cf, dim=-1, keepdim=True)
    return e / z, e_cf / z


def _attention_probs(q, k, cf, scale, acc):
    """E = exp(s - max) / sum_k cf exp(s - max), (A, H, Mq, Mk); the
    attention weights are ``cf * E``. The max is a constant shift of the
    softmax, so it carries no gradient."""
    s = torch.einsum("aqhd,akhd->ahqk", q.to(acc), k.to(acc)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
    cf_k = cf.to(acc)[:, None, None, :]
    return e / torch.sum(cf_k * e, dim=-1, keepdim=True), cf_k


class Int8Calib(NamedTuple):
    """Static absmax calibration of one layer for the W8A8 path (Python
    floats): the activations' from a probe forward (:func:`layer_probe_stats`),
    the weights' from the float32 parameters. The JAX package's
    ``Int8Calib``: the same fields in the same order."""

    normed: float  # RMSNorm(attn) output
    q: float  # q after bias
    k: float  # k after bias
    h_norm: float  # RMSNorm(mlp) output
    ffn_h: float  # value * sigmoid(gate)
    w_q: float
    w_k: float
    w_v: float
    w_in: float
    w_fo: float

    @classmethod
    def from_stats(cls, stats, w: LayerWeights) -> "Int8Calib":
        """The calibration of a layer from its probe absmaxes (the five of
        :func:`layer_probe_stats`) and its float32 weights: the body of the
        JAX package's ``calibrate_from_sow`` for one layer."""
        D = w.w_qkv.shape[0]

        def am(x):
            return float(x.detach().abs().max())

        return cls(*(float(x) for x in stats), am(w.w_qkv[:, :D]), am(w.w_qkv[:, D:2 * D]),
                   am(w.w_qkv[:, 2 * D:]), am(w.w_in), am(w.w_ffn_out))


def _f32(x: float) -> float:
    """A Python float rounded once to float32, as JAX rounds a static scale
    when it meets a float32 array."""
    return float(np.float32(x))


def qs_static(x, absmax: float):
    """Static-scale int8 quantization: ``clamp(round(x * 127 / absmax),
    -127, 127)``, ``x * inv`` in float32 and rounded half to even."""
    inv = _f32(127.0 / max(float(absmax), 1e-12))
    return torch.clamp(torch.round(x.to(torch.float32) * inv), -127.0, 127.0).to(torch.int8)


def rms_norm_q(x, scale, absmax: float, eps=None):
    """RMSNorm in float32, quantized without a rounding to the compute dtype
    first (the JAX package's ``_rms_norm_q``)."""
    if eps is None:
        eps = rmsnorm_eps(x.dtype)
    x32, r = _rms_stats(x, torch.float32, eps)
    return qs_static(x32 * r * scale.to(torch.float32), absmax)


def deq(a: float, b: float) -> float:
    """Dequantization factor of a product of two int8 operands."""
    return (max(float(a), 1e-12) / 127.0) * (max(float(b), 1e-12) / 127.0)


def dot_i8(x_i8, w_i8, factor: float, b):
    """int8 x int8 product, dequantized and biased, float32: the int32 sums
    are formed exactly (in float64) and converted to float32."""
    out = (x_i8.to(torch.float64) @ w_i8.to(torch.float64)).to(torch.float32)
    return out * _f32(factor) + b.to(torch.float32)


def quantize_layer_weights(w: LayerWeights, calib: Int8Calib):
    """int8 copies of the quantized weights (``w_q``, ``w_k``, ``w_v``,
    ``w_in``, ``w_ffn_out``; (in, out) layout), from the float32
    parameters."""
    D = w.w_qkv.shape[0]
    return (
        qs_static(w.w_qkv[:, :D], calib.w_q),
        qs_static(w.w_qkv[:, D:2 * D], calib.w_k),
        qs_static(w.w_qkv[:, 2 * D:], calib.w_v),
        qs_static(w.w_in, calib.w_in),
        qs_static(w.w_ffn_out, calib.w_fo),
    )


def int8_block_atoms(M: int) -> int:
    """Atoms that share one pair of int8 score scales: the JAX package's
    forward blocks, ``_block_atoms(M)``."""
    if M <= 48:
        return 128
    return 8 if M <= 96 else 4


def quantize_i8(x, s):
    """``_quantize_i8`` at given scales: ``clamp(round(x / s), -127, 127)``
    in float32, x / s rounded once, half to even (the int8 values as
    floats; ``s`` broadcasts against ``x``)."""
    return torch.clamp(torch.round(x.to(torch.float32) / s), -127.0, 127.0)


def _exact_qk(edges, center, w: LayerWeights):
    """q and k of the layer, (A, M, D) each, as the exact forward rounds
    them."""
    A, M, D = edges.shape
    cd = edges.dtype
    acc = accumulation_dtype(cd)
    wc = LayerWeights(*(x.to(cd) for x in w))
    x1, r1 = _rms_stats(_with_center(edges, center), acc, rmsnorm_eps(cd))
    normed = (x1 * r1 * wc.norm_attn.to(acc)).to(cd)
    qkv = _matmul_bias(normed.reshape(A * M, D), wc.w_qkv, wc.b_qkv, cd).reshape(A, M, 3, D)
    return qkv[:, :, 0], qkv[:, :, 1]


def int8_block_scales(edges, center, w: LayerWeights, block_atoms: int = None):
    """Plain version of the absmax pass: ``(n_blocks, 2)`` float32 scales
    ``s = max(absmax, 1e-12) / 127`` of q and of k per block of
    ``block_atoms`` atoms (:func:`int8_block_atoms` by default), the absmax
    over every slot and column of the block's atoms, as the JAX package's
    ``_quantize_i8`` takes it over one kernel block. A partial last block
    is padded there with atoms whose tokens are 0: their q rows are b_q and
    their k rows b_k, so its absmax takes ``max |b_q|`` and ``max |b_k|``."""
    A, M, D = edges.shape
    BA = block_atoms or int8_block_atoms(M)
    with torch.no_grad():
        q, k = _exact_qk(edges, center, w)
        am = torch.stack([x.to(torch.float32).abs().amax(dim=(1, 2)) for x in (q, k)], dim=1)
        n_blocks = -(-A // BA)
        pad = n_blocks * BA - A
        am = torch.cat([am, am.new_zeros(pad, 2)]).reshape(n_blocks, BA, 2).amax(dim=1)
        if pad:
            b = w.b_qkv.to(edges.dtype).to(torch.float32).abs()
            am[-1] = torch.maximum(am[-1], torch.stack([b[:D].amax(), b[D:2 * D].amax()]))
        return torch.clamp_min(am, 1e-12) / 127.0


def int8_atom_scales(block_scales, A: int, block_atoms: int):
    """The (A, 2) per-atom view of per-block scales."""
    return block_scales.repeat_interleave(block_atoms, dim=0)[:A].contiguous()


def _int8_scores(q, k, scales, scale: float, acc):
    """(A, H, Mq, Mk) scores of the dynamic int8 path (``_qside_scores``
    with int8): q and k (A, M, H, hd) quantized per atom by ``scales`` (A,
    2), their exact int32 products times ``(s_q * s_k) * scale`` in
    float32. The value is the quantized one; the gradient is the exact
    product's (straight through), as the JAX package's replay takes it."""
    f32 = torch.float32
    s_q, s_k = (scales[:, i].to(f32)[:, None, None, None] for i in (0, 1))
    qi = quantize_i8(q.detach(), s_q)
    ki = quantize_i8(k.detach(), s_k)
    s_int = torch.einsum("aqhd,akhd->ahqk", qi.double(), ki.double()).to(f32)
    factor = (scales[:, 0].to(f32) * scales[:, 1].to(f32)) * torch.tensor(scale, dtype=f32)
    quant = (s_int * factor[:, None, None, None]).to(acc)
    exact = torch.einsum("aqhd,akhd->ahqk", q.to(acc), k.to(acc)) * scale
    return quant + (exact - exact.detach())


def _w8a8_attention(tokens, cf, wc: LayerWeights, w8a8, H, scale):
    """The W8A8 layer up to the attention weights: ``(normed_i8, q_i8,
    k_i8)``, q and k (float32 rounded to the compute dtype, the
    straight-through operands), v, E = e / z and the AV weights P = rnd(cf
    e) / z, with e = exp(s - max) of the int8 scores and z = sum rnd(cf e):
    cf e is rounded to the compute dtype before the AV product and the
    denominator, as the JAX package's ``_qside_tail``."""
    calib, (wq, wk, wv, _, _) = w8a8
    A, M, D = tokens.shape
    cd, f32 = tokens.dtype, torch.float32
    if cd == torch.float64:
        raise ValueError("the W8A8 layer computes in float32 or bfloat16")
    n_i8 = rms_norm_q(tokens, wc.norm_attn, calib.normed).reshape(A * M, D)
    b = wc.b_qkv.to(f32)
    q_f = dot_i8(n_i8, wq, deq(calib.normed, calib.w_q), b[:D])
    k_f = dot_i8(n_i8, wk, deq(calib.normed, calib.w_k), b[D:2 * D])
    v = dot_i8(n_i8, wv, deq(calib.normed, calib.w_v), b[2 * D:]).to(cd)
    q_i8, k_i8 = qs_static(q_f, calib.q), qs_static(k_f, calib.k)

    def heads(x):
        return x.reshape(A, M, H, D // H)

    s_int = torch.einsum("aqhd,akhd->ahqk", heads(q_i8).double(), heads(k_i8).double())
    s = s_int.to(f32) * _f32(deq(calib.q, calib.k) * scale)
    return ((n_i8, q_i8, k_i8), heads(q_f.to(cd)), heads(k_f.to(cd)), heads(v),
            *_rounded_softmax(s, cf, cd))


def _w8a8_ffn_in(res, wc: LayerWeights, w8a8):
    """The W8A8 layer's quantized h_norm and its FFN-in product vg (float32)."""
    calib, (_, _, _, w_in, _) = w8a8
    A, M, D = res.shape
    h_i8 = rms_norm_q(res, wc.norm_mlp, calib.h_norm).reshape(A * M, D)
    return h_i8, dot_i8(h_i8, w_in, deq(calib.h_norm, calib.w_in), wc.b_in.to(torch.float32))


def _layer_forward(edges, center, cf, w: LayerWeights, num_heads: int, scale: float, w8a8=None,
                   int8_scales=None):
    """``(edge_out, center_attn, operands)``: the operands are the five
    activations the W8A8 path quantizes (normed, q, k, h_norm, ffn_h), as
    the exact layer computes them (ffn_h in float32, the others in the
    compute dtype) or, with ``w8a8``, as their int8 quantizations. With
    ``int8_scales`` the scores are the dynamic int8 ones."""
    A, M, D = edges.shape
    cd = edges.dtype
    acc = accumulation_dtype(cd)
    hd = D // num_heads
    eps = rmsnorm_eps(cd)
    wc = LayerWeights(*(x.to(cd) for x in w))

    tokens = _with_center(edges, center)
    if w8a8 is None:
        x1, r1 = _rms_stats(tokens, acc, eps)
        normed = (x1 * r1 * wc.norm_attn.to(acc)).to(cd)
        qkv = _matmul_bias(normed.reshape(A * M, D), wc.w_qkv, wc.b_qkv, cd)
        q, k, v = qkv.reshape(A, M, 3, num_heads, hd).unbind(2)
        if int8_scales is None:
            probs, cf_k = _attention_probs(q, k, cf, scale, acc)
            p_attn = cf_k * probs
        else:
            p_attn = _rounded_softmax(_int8_scores(q, k, int8_scales, scale, acc), cf, cd)[1]
        operands = [normed, q.reshape(A, M, D), k.reshape(A, M, D)]
    else:
        operands, _, _, v, _, p_attn = _w8a8_attention(tokens, cf, wc, w8a8, num_heads, scale)
        operands = list(operands)
    attn = torch.einsum("ahqk,akhd->aqhd", p_attn, v.to(p_attn.dtype))
    attn = attn.reshape(A * M, D).to(cd)
    attn_out = _matmul_bias(attn, wc.w_out, wc.b_out, cd).reshape(A, M, D)
    center_attn = attn_out[:, M - 1]

    res = tokens + attn_out
    d_ff = wc.w_ffn_out.shape[0]
    if w8a8 is None:
        x2, r2 = _rms_stats(res, acc, eps)
        h_norm = (x2 * r2 * wc.norm_mlp.to(acc)).to(cd)
        vg = _matmul_bias(h_norm.reshape(A * M, D), wc.w_in, wc.b_in)
        ffn_f = vg[:, :d_ff] * torch.sigmoid(vg[:, d_ff:])
        ffn_out = _matmul_bias(ffn_f.to(cd), wc.w_ffn_out, wc.b_ffn_out, cd)
        operands += [h_norm, ffn_f]
    else:
        calib, (_, _, _, _, w_fo) = w8a8
        h_i8, vg = _w8a8_ffn_in(res, wc, w8a8)
        ffn_i8 = qs_static(vg[:, :d_ff] * torch.sigmoid(vg[:, d_ff:]), calib.ffn_h)
        ffn_out = dot_i8(ffn_i8, w_fo, deq(calib.ffn_h, calib.w_fo),
                         wc.b_ffn_out.to(torch.float32)).to(cd)
        operands += [h_i8, ffn_i8]
    edge_out = _zero_last_slot(res + ffn_out.reshape(A, M, D))
    return edge_out, center_attn, operands


def layer_math(edges, center, cf, w: LayerWeights, num_heads: int, scale: float, w8a8=None,
               int8_scales=None):
    """Plain PyTorch forward: ``(edge_out, center_attn)``.

    :param edges: (A, M, D) edge tokens; slot M-1 is ignored and replaced
        by the center token.
    :param center: (A, D) center tokens.
    :param cf: (A, M) multiplicative attention weights on the keys, with
        ``cf[:, M-1] == 1`` (the center).
    :param w8a8: ``(Int8Calib, quantize_layer_weights(w, calib))`` for the
        static W8A8 layer (float32 or bfloat16): QKV, scores, FFN-in and
        FFN-out in int8, AV and out-projection in the compute dtype.
    :param int8_scales: (A, 2) float32 ``s_q, s_k`` of each atom
        (:func:`int8_atom_scales` of :func:`int8_block_scales`) for the
        dynamic int8 scores, the plain version of K1-int8: the exact layer
        with int8 scores and the rounded softmax of :func:`_rounded_softmax`
        (differentiable straight through).
    """
    return _layer_forward(edges, center, cf, w, num_heads, scale, w8a8, int8_scales)[:2]


def layer_probe_stats(edges, center, cf, w: LayerWeights, num_heads: int, scale: float):
    """float32 absmaxes of the activations the W8A8 path quantizes, from an
    exact forward: ``[normed, q, k, h_norm, ffn_h]`` (the first four
    rounded to the compute dtype, ffn_h in float32), as the JAX package's
    ``layer_probe_stats``."""
    operands = _layer_forward(edges, center, cf, w, num_heads, scale)[2]
    return torch.stack([x.to(torch.float32).abs().max() for x in operands])


def layer_bwd_math(
    edges, center, cf, w: LayerWeights, g_edge, g_center, num_heads: int, scale: float,
    weight_grads: bool = False, w8a8=None, int8_scales=None,
):
    """Plain PyTorch backward of :func:`layer_math`: ``(d_edges, d_center,
    d_cf)`` with ``d_edges[:, M-1] == 0`` and ``d_cf`` in float32 (float64
    for float64 inputs). Every cotangent is rounded to the compute dtype
    before the product that consumes it, as K2 does.

    With ``weight_grads=True`` a fourth output holds the gradients of the
    10 weights summed over atoms (:class:`LayerWeights`, float32; float64
    for float64 inputs), with the casts of the JAX package's
    ``_layer_bwd_math(..., weight_grads=True)``: products of compute-dtype
    operands, norm-scale and bias sums of the unrounded cotangents where
    JAX takes them. This is the plain version of K2-dW, and the function
    that the second-order replay differentiates.

    With ``w8a8`` (input gradients only), the plain version of K2-W8A8: the
    recompute reproduces the W8A8 forward (its softmax weights and vg come
    from the int8 products), and every gradient product takes the weights
    and q, k in the compute dtype (straight-through estimation).

    With ``int8_scales`` (as :func:`layer_math` takes them), the plain
    version of K2-int8 (K2-dW-int8 with ``weight_grads``): the recompute
    quantizes the scores with the same scales, so its softmax is the
    forward's; the gradient products are K2-W8A8's, on the bf16 q and k.
    It is differentiable straight through (the second-order replay)."""
    d_inputs, t = _layer_bwd(edges, center, cf, w, g_edge, g_center, num_heads, scale,
                             weight_grads, w8a8, int8_scales)
    if not weight_grads:
        return d_inputs
    A, M = edges.shape[:2]
    acc = accumulation_dtype(edges.dtype)

    def rows_t(a, b):
        """a^T b over all A*M rows, operands in the compute dtype."""
        return a.reshape(A * M, -1).to(acc).T @ b.reshape(A * M, -1).to(acc)

    def colsum(x):
        return x.reshape(A * M, -1).to(acc).sum(0)

    dw = LayerWeights(
        norm_attn=colsum(t["norm_attn"]),
        w_qkv=rows_t(t["n1"], t["d_qkv"]),
        b_qkv=colsum(t["d_qkv"]),
        w_out=rows_t(t["attn"], t["d_attn_out"]),
        b_out=colsum(t["d_attn_out"]),
        norm_mlp=colsum(t["norm_mlp"]),
        w_in=rows_t(t["h_norm"], t["d_vg"]),
        b_in=colsum(t["d_vg"]),
        w_ffn_out=rows_t(t["ffn_h"], t["g_eo"]),
        b_ffn_out=colsum(t["g_eo"]),
    )
    return (*d_inputs, dw)


def _layer_bwd(edges, center, cf, w: LayerWeights, g_edge, g_center, num_heads, scale,
               weight_grads, w8a8, int8_scales):
    """:func:`layer_bwd_math`'s input gradients and, with
    ``weight_grads``, the rows its weight gradients sum: the products'
    operands (n1, d_qkv, attn, d_attn_out, h_norm, d_vg, ffn_h, g_eo in the
    compute dtype, as the products take them) and the norm scales' terms
    (norm_attn, norm_mlp: (A, M, D), unrounded); else ``None``."""
    if w8a8 is not None and weight_grads:
        raise ValueError("the W8A8 layer is inference only: it has no weight gradients")
    A, M, D = edges.shape
    cd = edges.dtype
    acc = accumulation_dtype(cd)
    H = num_heads
    hd = D // H
    eps = rmsnorm_eps(cd)
    wc = LayerWeights(*(x.to(cd) for x in w))
    wa = LayerWeights(*(x.to(acc) for x in wc))

    # forward recompute
    tokens = _with_center(edges, center)
    x1, r1 = _rms_stats(tokens, acc, eps)
    if w8a8 is None:
        n1 = (x1 * r1 * wa.norm_attn).to(cd)
        qkv = _matmul_bias(n1.reshape(A * M, D), wc.w_qkv, wc.b_qkv, cd)
        q, k, v = qkv.reshape(A, M, 3, H, hd).unbind(2)
        if int8_scales is None:
            probs, cf_k = _attention_probs(q, k, cf, scale, acc)
            p_attn = cf_k * probs
        else:
            probs, p_attn = _rounded_softmax(_int8_scores(q, k, int8_scales, scale, acc), cf, cd)
            cf_k = cf.to(acc)[:, None, None, :]
    else:
        _, q, k, v, probs, p_attn = _w8a8_attention(tokens, cf, wc, w8a8, H, scale)
        cf_k = cf.to(acc)[:, None, None, :]
    attn = torch.einsum("ahqk,akhd->aqhd", p_attn, v.to(acc)).reshape(A * M, D).to(cd)
    attn_out = _matmul_bias(attn, wc.w_out, wc.b_out, cd).reshape(A, M, D)
    res = tokens + attn_out
    x2, r2 = _rms_stats(res, acc, eps)
    d_ff = wc.w_ffn_out.shape[0]
    if w8a8 is None:
        h_norm = (x2 * r2 * wa.norm_mlp).to(cd)
        vg = _matmul_bias(h_norm.reshape(A * M, D), wc.w_in, wc.b_in)
    else:
        vg = _w8a8_ffn_in(res, wc, w8a8)[1]
    value, sig = vg[:, :d_ff], torch.sigmoid(vg[:, d_ff:])

    # SwiGLU and norm_mlp backward
    g_eo = _zero_last_slot(g_edge.to(cd)).to(acc)
    d_ffn_h = g_eo.reshape(A * M, D) @ wa.w_ffn_out.T
    d_vg = torch.cat([d_ffn_h * sig, d_ffn_h * value * sig * (1.0 - sig)], dim=-1).to(cd)
    d_h = (d_vg.to(acc) @ wa.w_in.T).reshape(A, M, D)
    gs2 = d_h * (r2 * wa.norm_mlp)
    d_res = g_eo + gs2 - x2 * (r2 * r2 * torch.sum(gs2 * x2, dim=-1, keepdim=True) / D)

    # out-projection backward; the center output taps attn_out[:, M-1]
    d_attn_out = torch.cat([d_res[:, :-1], d_res[:, -1:] + g_center.to(acc)[:, None]], dim=1)
    d_attn = (d_attn_out.to(cd).to(acc).reshape(A * M, D) @ wa.w_out.T).reshape(A, M, H, hd)

    # attention backward
    d_p = torch.einsum("aqhd,akhd->ahqk", d_attn, v.to(acc))
    delta = torch.sum(p_attn * d_p, dim=-1, keepdim=True)
    t = probs * (d_p - delta)
    d_cf = torch.sum(t, dim=(1, 2))
    d_s = cf_k * t
    d_q = torch.einsum("ahqk,akhd->aqhd", d_s, k.to(acc)) * scale
    d_k = torch.einsum("ahqk,aqhd->akhd", d_s, q.to(acc)) * scale
    d_v = torch.einsum("ahqk,aqhd->akhd", p_attn, d_attn)
    d_qkv = torch.stack([d_q, d_k, d_v], dim=2).reshape(A * M, 3 * D).to(cd)

    # QKV and norm_attn backward
    d_n1 = (d_qkv.to(acc) @ wa.w_qkv.T).reshape(A, M, D)
    gs1 = d_n1 * (r1 * wa.norm_attn)
    d_tokens = d_res + gs1 - x1 * (r1 * r1 * torch.sum(gs1 * x1, dim=-1, keepdim=True) / D)
    d_inputs = (_zero_last_slot(d_tokens).to(cd), d_tokens[:, M - 1].to(cd), d_cf)
    if not weight_grads:
        return d_inputs, None
    return d_inputs, {
        "norm_attn": d_n1 * (x1 * r1), "n1": n1, "d_qkv": d_qkv, "attn": attn,
        "d_attn_out": d_attn_out.to(cd), "norm_mlp": d_h * (x2 * r2), "h_norm": h_norm,
        "d_vg": d_vg, "ffn_h": (value * sig).to(cd), "g_eo": g_eo,
    }


def dw_shapes(D: int, F: int):
    """The shapes of the 10 weights (:class:`LayerWeights` order)."""
    return ((D,), (D, 3 * D), (3 * D,), (D, D), (D,), (D,), (D, 2 * F), (2 * F,), (F, D), (D,))


class DwOperands(NamedTuple):
    """What the two-pass K2-dW's first pass writes: per row (A * M rows, the
    compute dtype) the operands of dW = X^T dY, and per atom its vector sums
    (A, 7D + 2F) in the accumulation dtype: norm_attn, b_qkv, b_out,
    norm_mlp, b_in, b_ffn_out summed over the atom's rows."""

    n1: torch.Tensor  # (A*M, D)
    d_qkv: torch.Tensor  # (A*M, 3D)
    attn: torch.Tensor  # (A*M, D)
    d_attn_out: torch.Tensor  # (A*M, D)
    h_norm: torch.Tensor  # (A*M, D)
    d_vg: torch.Tensor  # (A*M, 2F)
    ffn_h: torch.Tensor  # (A*M, F)
    vectors: torch.Tensor  # (A, 7D + 2F)


def layer_dw_operands(edges, center, cf, w: LayerWeights, g_edge, g_center, num_heads: int,
                      scale: float, int8_scales=None) -> DwOperands:
    """Plain version of the two-pass K2-dW's first pass: the rows it spills
    and the per-atom vector sums (:class:`DwOperands`), from the same
    backward as :func:`layer_bwd_math` (``int8_scales`` as it takes them).
    :func:`dw_from_operands` sums them as the second pass does."""
    A, M = edges.shape[:2]
    acc = accumulation_dtype(edges.dtype)
    _, t = _layer_bwd(edges, center, cf, w, g_edge, g_center, num_heads, scale, True, None,
                      int8_scales)

    def per_atom(x):
        return x.reshape(A, M, -1).to(acc).sum(1)

    vectors = torch.cat([per_atom(t[k]) for k in (
        "norm_attn", "d_qkv", "d_attn_out", "norm_mlp", "d_vg", "g_eo")], dim=1)
    return DwOperands(*(t[k].reshape(A * M, -1) for k in (
        "n1", "d_qkv", "attn", "d_attn_out", "h_norm", "d_vg", "ffn_h")), vectors)


def dw_from_operands(ops: DwOperands, g_edge, plan: "_lib.K2dwPlan") -> LayerWeights:
    """Plain version of the two-pass K2-dW's second pass: the weight
    gradients (the accumulation dtype) of the rows of ``ops`` (A atoms of
    ``g_edge``'s M slots; the cotangent of w_ffn_out's product is ``g_edge``
    with slot M-1 zeroed), summed in the kernel's order: per chunk of
    ``plan`` (:func:`_lib.k2dw_plan`) and per slice of it
    (:func:`_lib.k2dw_slices`) a partial, the slices added in order, then
    the chunks in order."""
    A, M, D = g_edge.shape
    F = ops.ffn_h.shape[1]
    acc = ops.vectors.dtype
    g_eo = _zero_last_slot(g_edge.to(ops.n1.dtype)).reshape(A * M, D)
    pairs = ((ops.n1, ops.d_qkv), (ops.attn, ops.d_attn_out), (ops.h_norm, ops.d_vg),
             (ops.ffn_h, g_eo))
    sizes = [D, 3 * D, D, D, 2 * F, D]  # the vectors' widths
    total = None
    for a0, a1 in _lib.k2dw_chunks(plan, A):
        rows = (a1 - a0) * M
        step, slices = _lib.k2dw_slices(rows, D, F, plan.sms)
        chunk = None
        for s in range(slices):
            r0, r1 = a0 * M + s * step, a0 * M + min(rows, (s + 1) * step)
            b0, b1 = a0 + (a1 - a0) * s // slices, a0 + (a1 - a0) * (s + 1) // slices
            mats = [x[r0:r1].to(acc).T @ y[r0:r1].to(acc) for x, y in pairs]
            vec = torch.split(ops.vectors[b0:b1].sum(0), sizes)
            part = (vec[0], mats[0], vec[1], mats[1], vec[2], vec[3], mats[2], vec[4], mats[3],
                    vec[5])
            chunk = part if chunk is None else tuple(c + p for c, p in zip(chunk, part))
        total = chunk if total is None else tuple(t + c for t, c in zip(total, chunk))
    if total is None:  # no atoms
        return LayerWeights(*(torch.zeros(n, dtype=acc) for n in dw_shapes(D, F)))
    return LayerWeights(*total)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def check_layer_shapes(edges, cf, w: LayerWeights, num_heads):
    """``(A, M, D, F)``; raises where the fused layer's kernel body (K1/K2,
    and the GNN block that runs it) does not take the shapes: any window
    M % 16 == 0 (up to 256: the layout plan moves what does not fit in
    shared memory to a workspace) and any head width that divides D."""
    A, M, D = edges.shape
    F = w.w_ffn_out.shape[0]
    # bfloat16 products run on the tensor cores in 16-wide tiles
    width = 16 if edges.dtype == torch.bfloat16 else 4
    if M % 16 or not 16 <= M <= 256 or D % width or F % width or D % num_heads:
        raise ValueError(
            f"fused layer kernels need M % 16 == 0 with 16 <= M <= 256, D and F divisible by "
            f"{width} and a head count that divides D; got M={M}, D={D}, F={F}, "
            f"heads={num_heads}"
        )
    if cf.shape != (A, M):
        raise ValueError(f"cf {tuple(cf.shape)} does not match edges {tuple(edges.shape)}")
    return A, M, D, F


def _check_shapes(edges, center, cf, w: LayerWeights, num_heads):
    A, M, D, F = check_layer_shapes(edges, cf, w, num_heads)
    if center.shape != (A, D):
        raise ValueError(f"center {tuple(center.shape)} / cf {tuple(cf.shape)} "
                         f"do not match edges {tuple(edges.shape)}")
    return A, M, D, F


def _cuda_weights(w: LayerWeights, cd) -> LayerWeights:
    return LayerWeights(*(x.detach().to(cd).contiguous() for x in w))


def check_w8a8_shapes(D: int, F: int, num_heads: int) -> None:
    """Raises where the W8A8 kernels do not take the widths: their int8
    products run in k-steps of 32 (any head width: the score tiles pad a
    head to 16 columns)."""
    if D % 32 or F % 32 or D % num_heads:
        raise ValueError(f"the W8A8 kernels need D and F divisible by 32 and a head count that "
                         f"divides D; got D={D}, F={F}, heads={num_heads}")


def _w8a8_kernel_args(edges, w8a8, num_heads, scale):
    """The W8A8 kernels' extra arguments: the int8 weights transposed to
    (out, in) (``w_qkv``, ``w_in``, ``w_ffn_out``) and the 11 static scales
    (``LayerI8`` in ``csrc/common.cuh``), each rounded once to float32.
    Raises where the kernels do not take the dtype or the shapes."""
    calib, (wq, wk, wv, w_in, w_fo) = w8a8
    if edges.dtype != torch.bfloat16:
        raise TypeError(f"the W8A8 kernels take bfloat16, got {edges.dtype}")
    check_w8a8_shapes(wq.shape[0], w_fo.shape[0], num_heads)
    int8 = [torch.cat([wq, wk, wv], dim=1), w_in, w_fo]
    _lib.require({f"int8 weight {i}": x for i, x in enumerate(int8)}, edges.device, torch.int8)
    inv = [127.0 / max(float(a), 1e-12) for a in calib[:5]]
    factors = [deq(calib.normed, calib.w_q), deq(calib.normed, calib.w_k),
               deq(calib.normed, calib.w_v), deq(calib.h_norm, calib.w_in),
               deq(calib.ffn_h, calib.w_fo), deq(calib.q, calib.k) * scale]
    scales = (ctypes.c_float * 11)(*inv, *factors)
    return [x.t().contiguous() for x in int8], scales


def _int8_kernel_scales(edges, int8_scales):
    """The (A, 2) float32 scales the int8-score kernels read; raises where
    they do not take the dtype."""
    if edges.dtype != torch.bfloat16:
        raise TypeError(f"the int8-score kernels take bfloat16, got {edges.dtype}")
    if int8_scales.shape != (edges.shape[0], 2):
        raise ValueError(f"int8 scales {tuple(int8_scales.shape)} do not match "
                         f"{edges.shape[0]} atoms")
    _lib.require({"int8_scales": int8_scales}, edges.device, torch.float32)
    return int8_scales


def int8_absmax_cuda(edges, center, w: LayerWeights, block_atoms: int = None):
    """Launch the absmax pass (``csrc/int8_absmax.cu``, bfloat16): the
    ``(n_blocks, 2)`` float32 scales of :func:`int8_block_scales`."""
    A, M, D = edges.shape
    if center.shape != (A, D) or w.w_qkv.shape != (D, 3 * D):
        raise ValueError(f"center {tuple(center.shape)} or w_qkv {tuple(w.w_qkv.shape)} do not "
                         f"match edges {tuple(edges.shape)}")
    if edges.dtype != torch.bfloat16:
        raise TypeError(f"the absmax pass takes bfloat16, got {edges.dtype}")
    cd = edges.dtype
    wc = [x.detach().to(cd).contiguous() for x in (w.norm_attn, w.w_qkv, w.b_qkv)]
    _lib.require({"edges": edges, "center": center, "norm_attn": wc[0], "w_qkv": wc[1],
                  "b_qkv": wc[2]}, edges.device, cd)
    if M % 16 or D % 16:
        raise ValueError(f"the absmax pass needs M and D divisible by 16; got M={M}, D={D}")
    BA = block_atoms or int8_block_atoms(M)
    lib = _lib.library()
    _lib.check_shared(lib.mtt_int8_absmax_smem(D), "int8_absmax")
    scales = torch.empty((-(-A // BA), 2), dtype=torch.float32, device=edges.device)
    _lib.check(
        lib.mtt_int8_absmax(edges.data_ptr(), center.data_ptr(), *(x.data_ptr() for x in wc),
                            scales.data_ptr(), A, M, D, BA, rmsnorm_eps(cd),
                            _lib.stream_ptr(edges.device)),
        "int8_absmax",
    )
    _lib.LAUNCHES["int8_absmax"] += 1
    return scales


def int8_scales_for(edges, center, w: LayerWeights, plain: bool = False):
    """The (A, 2) per-atom int8 score scales of one layer call: the absmax
    pass on the card (its plain version on the CPU or with ``plain``),
    expanded from the blocks of :func:`int8_block_atoms` to their atoms."""
    A, M = edges.shape[:2]
    BA = int8_block_atoms(M)
    if edges.is_cuda and not plain:
        blocks = int8_absmax_cuda(edges, center, w, BA)
    else:
        blocks = int8_block_scales(edges, center, w, BA)
    return int8_atom_scales(blocks, A, BA)


def fused_layer_fwd_cuda(edges, center, cf, w: LayerWeights, num_heads, scale, w8a8=None,
                         int8_scales=None, *, sm90: bool = True, weight_grads: bool = False):
    """Launch K1. ``edges``/``center`` float32 or bfloat16, ``cf`` float32.

    The exact bfloat16 variant at the shapes of :func:`_lib.k1_sm90_takes`
    (the served ones) launches the Hopper K1 (``csrc/fused_layer_fwd_sm90.cu``,
    counter ``fused_layer_fwd_sm90``), which rounds the softmax weights to
    bfloat16 before P V as the Hopper K2's recompute and the JAX package
    do; ``sm90=False`` keeps the general body there too, for comparisons.
    ``weight_grads`` (a weight requires grad, so the backward is K2-dW and
    the replay, which keep P float) keeps the general body as well.

    With ``w8a8`` (``(Int8Calib, quantize_layer_weights(...))``, int8
    weights on the device) launch K1-W8A8 instead: bfloat16 only. With
    ``int8_scales`` ((A, 2) float32, :func:`int8_scales_for`) launch
    K1-int8: bfloat16 only.

    Windows whose buffers do not fit in shared memory run with a global
    workspace (one block per SM looping over the atoms)."""
    A, M, D, F = _check_shapes(edges, center, cf, w, num_heads)
    if w8a8 is not None:
        int8_t, scales = _w8a8_kernel_args(edges, w8a8, num_heads, scale)
    if int8_scales is not None:
        _int8_kernel_scales(edges, int8_scales)
    cd = edges.dtype
    dtype_code = _lib.dtype_code(cd)
    wc = _cuda_weights(w, cd)
    _lib.require({"edges": edges, "center": center, **wc._asdict()}, edges.device, cd)
    _lib.require({"cf": cf}, edges.device, torch.float32)
    if sm90 and _lib.k1_sm90_takes(cd, M, D, num_heads, F, w8a8 is not None,
                                   int8_scales is not None, weight_grads):
        return _k1_sm90(edges, center, cf, wc, num_heads, scale)
    lib = _lib.library()
    _, ws_floats = _lib.plan_query(lib.mtt_fused_layer_fwd_smem, M, D, F)
    grid = _lib.layer_grid(A, ws_floats, edges.device)
    ws = _lib.workspace(grid, ws_floats, edges.device)
    tail = (A, M, D, num_heads, F)
    launch = (grid, _lib.ptr(ws), _lib.stream_ptr(edges.device))
    edge_out = torch.empty_like(edges)
    center_out = torch.empty_like(center)
    io = (edges.data_ptr(), center.data_ptr(), cf.data_ptr())
    weights = [x.data_ptr() for x in wc]
    if w8a8 is not None:
        name = "fused_layer_fwd_w8a8"
        code = lib.mtt_fused_layer_fwd_w8a8(
            *io, *weights, *(x.data_ptr() for x in int8_t), scales,
            edge_out.data_ptr(), center_out.data_ptr(), *tail, rmsnorm_eps(cd), *launch)
    elif int8_scales is not None:
        name = "fused_layer_fwd_int8"
        code = lib.mtt_fused_layer_fwd_int8(
            *io, *weights, int8_scales.data_ptr(), edge_out.data_ptr(), center_out.data_ptr(),
            *tail, float(scale), rmsnorm_eps(cd), *launch)
    else:
        name = "fused_layer_fwd"
        code = lib.mtt_fused_layer_fwd(
            dtype_code, *io, *weights, edge_out.data_ptr(), center_out.data_ptr(),
            *tail, float(scale), rmsnorm_eps(cd), *launch)
    _lib.check(code, name)
    _lib.LAUNCHES[name] += 1
    return edge_out, center_out


def k1_sm90_w_vg(w_in):
    """w_in (D, 2F) as the Hopper K1 reads it: transposed to (2F, D) with the
    rows in blocks of 64, value columns 64 i .. 64 i + 63 then the same gate
    columns, so that one staged chunk holds both halves of a 64-column F
    tile."""
    D, F = w_in.shape[0], w_in.shape[1] // 2
    return w_in.t().reshape(2, F // 64, 64, D).transpose(0, 1).reshape(2 * F, D).contiguous()


def _k1_sm90(edges, center, cf, wc: LayerWeights, num_heads, scale):
    """The Hopper K1 on checked bfloat16 tensors (``wc`` in the compute
    dtype): one block per two atoms, no workspace. Its weights go in as
    w_qkv^T, w_out^T, :func:`k1_sm90_w_vg` and w_ffn_out^T."""
    A, M, D = edges.shape
    F = wc.w_ffn_out.shape[0]
    lib = _lib.library()
    _lib.check_shared(lib.mtt_fused_layer_fwd_sm90_smem(M, D, num_heads, F), "fused_layer_fwd_sm90")
    vectors = (wc.norm_attn, wc.b_qkv, wc.b_out, wc.norm_mlp, wc.b_in, wc.b_ffn_out)
    matrices = (wc.w_qkv.t().contiguous(), wc.w_out.t().contiguous(), k1_sm90_w_vg(wc.w_in),
                wc.w_ffn_out.t().contiguous())
    edge_out = torch.empty_like(edges)
    center_out = torch.empty_like(center)
    _lib.check(
        lib.mtt_fused_layer_fwd_sm90(
            edges.data_ptr(), center.data_ptr(), cf.data_ptr(), *(x.data_ptr() for x in vectors),
            *(x.data_ptr() for x in matrices), edge_out.data_ptr(), center_out.data_ptr(),
            A, M, D, num_heads, F, float(scale), rmsnorm_eps(edges.dtype),
            _lib.stream_ptr(edges.device)),
        "fused_layer_fwd_sm90",
    )
    _lib.LAUNCHES["fused_layer_fwd_sm90"] += 1
    return edge_out, center_out


def fused_layer_bwd_cuda(edges, center, cf, w: LayerWeights, g_edge, g_center, num_heads, scale,
                         weight_grads: bool = False, w8a8=None, int8_scales=None, *,
                         sm90: bool = True):
    """Launch K2: ``(d_edges, d_center, d_cf)`` with ``d_cf`` float32.

    The exact bfloat16 variant at the shapes of :func:`_lib.k2_sm90_takes`
    (the served ones) launches the Hopper K2 (``csrc/fused_layer_bwd_sm90.cu``,
    counter ``fused_layer_bwd_sm90``); ``sm90=False`` keeps the general body
    there too, for comparisons.

    With ``w8a8`` launch K2-W8A8 (bfloat16, input gradients only): the W8A8
    layer's straight-through backward. With ``int8_scales`` (the forward's)
    launch K2-int8 (bfloat16), or K2-dW-int8 with ``weight_grads``.

    With ``weight_grads=True`` launch K2-dW instead, which also returns the
    float32 weight gradients summed over atoms as a fourth output
    (:class:`LayerWeights`). At the shapes of :func:`_lib.k2dw_sm90_takes`
    (float32 or bfloat16, with or without ``int8_scales``) that is the
    two-pass K2-dW (``csrc/fused_layer_bwd_dw_sm90.cu``, counters
    ``fused_layer_bwd_dw_sm90`` or ``fused_layer_bwd_dw_int8_sm90``, and
    ``layer_dw_product``): the body spills each row's weight-gradient
    operands, then a split-K product sums them (:func:`layer_dw_operands`
    and :func:`dw_from_operands` are its plain halves). Elsewhere, or with
    ``sm90=False``, the accumulate body: one block per SM over a contiguous
    range of atoms, each block summing into its own float32 partial, a
    second pass adding the partials in block order. Either sum is the same
    from run to run."""
    A, M, D, F = _check_shapes(edges, center, cf, w, num_heads)
    cd = edges.dtype
    dtype_code = _lib.dtype_code(cd)
    wc = _cuda_weights(w, cd)
    _lib.require(
        {"edges": edges, "center": center, "g_edge": g_edge, "g_center": g_center,
         **wc._asdict()},
        edges.device, cd,
    )
    _lib.require({"cf": cf}, edges.device, torch.float32)
    if w8a8 is not None:
        if weight_grads:
            raise ValueError("the W8A8 layer is inference only: it has no weight gradients")
        int8_t, scales = _w8a8_kernel_args(edges, w8a8, num_heads, scale)
    if int8_scales is not None:
        _int8_kernel_scales(edges, int8_scales)
    if sm90 and _lib.k2_sm90_takes(cd, M, D, num_heads, F, weight_grads, w8a8 is not None,
                                   int8_scales is not None):
        return _k2_sm90(edges, center, cf, wc, g_edge, g_center, num_heads, scale)
    if sm90 and weight_grads and _lib.k2dw_sm90_takes(cd, M, D, num_heads, F,
                                                      int8_scales is not None):
        return _k2dw_sm90(edges, center, cf, wc, g_edge, g_center, num_heads, scale, int8_scales)
    transposed = [x.t().contiguous() for x in (wc.w_qkv, wc.w_out, wc.w_in, wc.w_ffn_out)]
    lib = _lib.library()
    dw_flag = int(weight_grads)
    if w8a8 is not None:
        name = "fused_layer_bwd_w8a8"
        query = (lib.mtt_fused_layer_bwd_w8a8_smem, M, D, num_heads, F)
    elif int8_scales is not None:
        name = f"fused_layer_bwd{'_dw' if weight_grads else ''}_int8"
        query = (lib.mtt_fused_layer_bwd_int8_smem, M, D, num_heads, F, dw_flag)
    else:
        name = "fused_layer_bwd_dw" if weight_grads else "fused_layer_bwd"
        query = (lib.mtt_fused_layer_bwd_smem, M, D, num_heads, F, dw_flag)
    _, ws_floats = _lib.plan_query(*query)
    grid = _lib.dw_blocks(A, edges.device) if weight_grads else _lib.layer_grid(
        A, ws_floats, edges.device)
    ws = _lib.workspace(grid, ws_floats, edges.device)
    d_edges = torch.empty_like(edges)
    d_center = torch.empty_like(center)
    d_cf = torch.empty_like(cf)
    partials = dw = None
    if weight_grads:
        sizes = [x.numel() for x in wc]
        partials = torch.empty((grid, sum(sizes)), dtype=torch.float32, device=edges.device)
        dw = torch.empty(sum(sizes), dtype=torch.float32, device=edges.device)
    inputs = (edges.data_ptr(), center.data_ptr(), cf.data_ptr(),
              *(x.data_ptr() for x in wc[:8]), *(x.data_ptr() for x in transposed))
    cots = (g_edge.data_ptr(), g_center.data_ptr())
    outs = (d_edges.data_ptr(), d_center.data_ptr(), d_cf.data_ptr())
    tail = (A, M, D, num_heads, F, float(scale), rmsnorm_eps(cd), grid, _lib.ptr(ws),
            _lib.stream_ptr(edges.device))
    if w8a8 is not None:
        code = lib.mtt_fused_layer_bwd_w8a8(
            *inputs, int8_t[0].data_ptr(), int8_t[1].data_ptr(), scales, *cots, *outs, *tail)
    elif int8_scales is not None:
        code = lib.mtt_fused_layer_bwd_int8(
            *inputs, int8_scales.data_ptr(), *cots, *outs, _lib.ptr(partials), _lib.ptr(dw), *tail)
    else:
        code = lib.mtt_fused_layer_bwd(
            dtype_code, *inputs, *cots, *outs, _lib.ptr(partials), _lib.ptr(dw), *tail)
    _lib.check(code, name)
    _lib.LAUNCHES[name] += 1
    if not weight_grads:
        return d_edges, d_center, d_cf
    parts = torch.split(dw, sizes)
    return d_edges, d_center, d_cf, LayerWeights(*(p.view(x.shape) for p, x in zip(parts, wc)))


def _k2_sm90(edges, center, cf, wc: LayerWeights, g_edge, g_center, num_heads, scale):
    """The Hopper K2 on checked bfloat16 tensors (``wc`` in the compute
    dtype): one block per atom, no workspace."""
    A, M, D = edges.shape
    F = wc.w_ffn_out.shape[0]
    lib = _lib.library()
    _lib.check_shared(lib.mtt_fused_layer_bwd_sm90_smem(M, D, num_heads, F), "fused_layer_bwd_sm90")
    transposed = [x.t().contiguous() for x in (wc.w_qkv, wc.w_out, wc.w_in)]
    d_edges = torch.empty_like(edges)
    d_center = torch.empty_like(center)
    d_cf = torch.empty_like(cf)
    _lib.check(
        lib.mtt_fused_layer_bwd_sm90(
            edges.data_ptr(), center.data_ptr(), cf.data_ptr(), *(x.data_ptr() for x in wc[:9]),
            *(x.data_ptr() for x in transposed), g_edge.data_ptr(), g_center.data_ptr(),
            d_edges.data_ptr(), d_center.data_ptr(), d_cf.data_ptr(), A, M, D, num_heads, F,
            float(scale), rmsnorm_eps(edges.dtype), _lib.stream_ptr(edges.device)),
        "fused_layer_bwd_sm90",
    )
    _lib.LAUNCHES["fused_layer_bwd_sm90"] += 1
    return d_edges, d_center, d_cf


def _k2dw_sm90(edges, center, cf, wc: LayerWeights, g_edge, g_center, num_heads, scale,
               int8_scales=None):
    """The two-pass K2-dW on checked tensors (``wc`` in the compute dtype):
    per chunk of :func:`_lib.k2dw_plan`, the body on K2's grid and layout
    plan, then the split-K product."""
    A, M, D = edges.shape
    F = wc.w_ffn_out.shape[0]
    cd = edges.dtype
    device = edges.device
    plan, ws_floats, ws_blocks = _k2dw_plan(edges, num_heads, F, int8_scales is not None)
    ws = _lib.workspace(ws_blocks, ws_floats, device)
    spill = torch.empty(plan.spill_bytes, dtype=torch.uint8, device=device)
    sizes = [x.numel() for x in wc]
    partials = torch.empty((max(plan.max_slices, 1), sum(sizes)), dtype=torch.float32,
                           device=device)
    dw = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    transposed = [x.t().contiguous() for x in (wc.w_qkv, wc.w_out, wc.w_in, wc.w_ffn_out)]
    d_edges = torch.empty_like(edges)
    d_center = torch.empty_like(center)
    d_cf = torch.empty_like(cf)
    lib = _lib.library()
    _lib.check(
        lib.mtt_fused_layer_bwd_dw_sm90(
            _lib.dtype_code(cd), edges.data_ptr(), center.data_ptr(), cf.data_ptr(),
            *(x.data_ptr() for x in wc[:8]), *(x.data_ptr() for x in transposed),
            _lib.ptr(int8_scales), g_edge.data_ptr(), g_center.data_ptr(), d_edges.data_ptr(),
            d_center.data_ptr(), d_cf.data_ptr(), dw.data_ptr(), spill.data_ptr(),
            partials.data_ptr(), _lib.ptr(ws), A, M, D, num_heads, F, float(scale),
            rmsnorm_eps(cd), ws_blocks, plan.sms, _lib.stream_ptr(device)),
        "fused_layer_bwd_dw_sm90",
    )
    _lib.LAUNCHES["fused_layer_bwd_dw_sm90" if int8_scales is None
                  else "fused_layer_bwd_dw_int8_sm90"] += 1
    _lib.LAUNCHES["layer_dw_product"] += 1
    parts = torch.split(dw, sizes)
    return d_edges, d_center, d_cf, LayerWeights(*(p.view(x.shape) for p, x in zip(parts, wc)))


def _k2dw_plan(edges, num_heads: int, F: int, int8: bool):
    """``(plan, workspace floats per block, workspace blocks)`` of the
    two-pass K2-dW on these edges: its chunks and K2's layout plan (the C
    query) for the first pass."""
    A, M, D = edges.shape
    lib = _lib.library()
    query = lib.mtt_fused_layer_bwd_int8_smem if int8 else lib.mtt_fused_layer_bwd_smem
    _, ws_floats = _lib.plan_query(query, M, D, num_heads, F, 0)
    plan = _lib.k2dw_plan(edges.element_size(), A, M, D, F, _lib.sm_count(edges.device))
    return plan, ws_floats, _lib.layer_grid(plan.chunk_atoms, ws_floats, edges.device)


def k2dw_workspace_bytes(edges, num_heads: int, F: int, int8: bool = False) -> int:
    """The device bytes the two-pass K2-dW allocates for one call besides its
    outputs: the spill of one chunk, the slices' partials and, where the
    body's plan moves buffers out of shared memory, its workspace."""
    plan, ws_floats, ws_blocks = _k2dw_plan(edges, num_heads, F, int8)
    D = edges.shape[2]
    return (plan.spill_bytes + 4 * max(plan.max_slices, 1) * _lib.dw_floats(D, F)
            + 4 * ws_blocks * ws_floats)


def pack_dw_operands(ops: DwOperands):
    """``(spill, vectors)``: the rows of ``ops`` as the first pass spills one
    chunk (the seven arrays one after another, flat, in the compute dtype)
    and the per-atom vector rows in float32, both contiguous."""
    spill = torch.cat([x.reshape(-1) for x in ops[:7]]).to(ops.n1.dtype).contiguous()
    return spill, ops.vectors.to(torch.float32).contiguous()


def layer_dw_product_cuda(spill, vectors, g_edge, sms: int = None) -> LayerWeights:
    """The two-pass K2-dW's second pass alone (``mtt_layer_dw_product``) on
    one chunk of rows (:func:`pack_dw_operands`; ``g_edge`` its atoms'
    cotangent): float32 weight gradients, the plain version
    :func:`dw_from_operands` with a one-chunk plan. For checks on the card;
    the training path runs it inside :func:`_k2dw_sm90`."""
    A, M, D = g_edge.shape
    F = (vectors.shape[1] - 7 * D) // 2
    cd = spill.dtype
    device = g_edge.device
    ge = g_edge.to(cd).contiguous()
    _lib.require({"spill": spill, "g_edge": ge}, device, cd)
    _lib.require({"vectors": vectors}, device, torch.float32)
    if spill.numel() != A * M * (7 * D + 3 * F) or vectors.shape[0] != A:
        raise ValueError(f"spill {tuple(spill.shape)} / vectors {tuple(vectors.shape)} do not "
                         f"match g_edge {tuple(g_edge.shape)}")
    sms = sms or _lib.sm_count(device)
    n = _lib.dw_floats(D, F)
    partials = torch.empty((_lib.dw_slice_target(A * M, D, F, sms), n), dtype=torch.float32,
                           device=device)
    dw = torch.empty(n, dtype=torch.float32, device=device)
    lib = _lib.library()
    _lib.check(
        lib.mtt_layer_dw_product(_lib.dtype_code(cd), spill.data_ptr(), vectors.data_ptr(),
                                 ge.data_ptr(), A, M, D, F, sms, partials.data_ptr(),
                                 dw.data_ptr(), _lib.stream_ptr(device)),
        "layer_dw_product",
    )
    _lib.LAUNCHES["layer_dw_product"] += 1
    shapes = dw_shapes(D, F)
    return LayerWeights(*(p.view(s) for p, s in zip(
        torch.split(dw, [math.prod(s) for s in shapes]), shapes)))


def _first_backward(edges, center, cf, w, g_edge, g_center, num_heads, scale, weight_grads,
                    int8_scales=None):
    """K2 / K2-dW (their int8-score variants with ``int8_scales``) on the
    card, :func:`layer_bwd_math` on the CPU."""
    if edges.is_cuda:
        return fused_layer_bwd_cuda(edges, center, cf, w, g_edge, g_center, num_heads, scale,
                                    weight_grads, int8_scales=int8_scales)
    return layer_bwd_math(edges, center, cf, w, g_edge, g_center, num_heads, scale, weight_grads,
                          int8_scales=int8_scales)


def replay_layer_bwd(inputs, w: LayerWeights, cotangents, ct_dw, num_heads, scale, chunk,
                     int8_scales=None):
    """The vector-Jacobian product of :func:`layer_bwd_math`, computed by
    replaying it under autograd over chunks of ``chunk`` atoms (port of
    ``_chunked_replay_bwd``).

    :param inputs: ``(edges, center, cf, g_edge, g_center)``.
    :param cotangents: cotangents of ``(d_edges, d_center, d_cf)``, each
        ``None`` where the output has none.
    :param ct_dw: cotangents of the weight gradients (a sequence of 10,
        ``None`` entries allowed), or ``None``: then the replay skips the
        weight-gradient products.
    :param int8_scales: the (A, 2) scales of the dynamic int8 scores, the
        forward's, sliced per chunk of atoms (constants: the JAX package's
        replay takes its absmax per chunk instead).
    :return: the cotangents of the five inputs and of the 10 weights.

    Atoms are independent rows and the weight gradients are sums over
    them, so the chunked sum is exact. Each chunk recomputes its forward
    and frees its graph before the next, so only one chunk's temporaries
    are alive. The last chunk is simply shorter: no padding, so no padded
    window with all-zero cutoff weights (whose 0/0 would poison the weight
    cotangents) ever exists.
    """
    _lib.REPLAYS["fused_layer"] += 1
    rows = tuple(inputs) + (() if int8_scales is None else (int8_scales,))

    def math(xs, ws, weight_grads):
        return layer_bwd_math(xs[0], xs[1], xs[2], LayerWeights(*ws), xs[3], xs[4], num_heads,
                              scale, weight_grads,
                              int8_scales=None if int8_scales is None else xs[5].detach())

    d_rows, d_w = chunked_replay(math, rows, w, cotangents, ct_dw, chunk)
    return d_rows[:5], d_w


def chunked_replay(math, inputs, weights, cotangents, ct_dw, chunk):
    """The vector-Jacobian product of a row-independent backward ``math(xs,
    ws, weight_grads)``, which returns one output per cotangent in
    ``cotangents`` (rows of the atoms in ``xs``) and, with ``weight_grads``,
    a last output of weight gradients summed over those atoms. Replayed
    under autograd over chunks of ``chunk`` atoms of ``inputs``; returns the
    cotangents of the inputs and of ``weights``. ``ct_dw`` (the weight
    gradients' cotangents, ``None`` entries allowed) or ``None``: then the
    replay skips the weight-gradient products."""
    weight_grads = ct_dw is not None and any(c is not None for c in ct_dw)
    A = inputs[0].shape[0]
    wl = [x.detach().requires_grad_(True) for x in weights]
    d_rows = [[] for _ in inputs]
    d_w = [torch.zeros_like(x) for x in weights]
    n_rows = len(cotangents)
    for a0 in range(0, A, chunk):
        xs = [t[a0:a0 + chunk].detach().requires_grad_(True) for t in inputs]
        outs, cts = [], []
        with torch.enable_grad():
            res = math(xs, wl, weight_grads)
            for out, ct in zip(res[:n_rows], cotangents):
                if ct is not None:
                    outs.append(out)
                    cts.append(ct[a0:a0 + chunk].to(out.dtype))
            if weight_grads:
                for out, ct in zip(res[n_rows], ct_dw):
                    if ct is not None:
                        outs.append(out)
                        cts.append(ct.to(out.dtype))
            grads = torch.autograd.grad(outs, xs + wl, cts, allow_unused=True) if outs else (
                [None] * (len(xs) + len(wl)))
        for i, (x, g) in enumerate(zip(xs, grads[:len(xs)])):
            d_rows[i].append(torch.zeros_like(x) if g is None else g)
        for i, g in enumerate(grads[len(xs):]):
            if g is not None:
                d_w[i] = d_w[i] + g
    return [torch.cat(parts) for parts in d_rows], d_w


class _FusedLayerBwd(torch.autograd.Function):
    """The layer's first backward as a function of its own: forward is K2
    or K2-dW (their int8-score variants with scales; the twin on the CPU),
    backward the chunked replay."""

    @staticmethod
    def forward(ctx, edges, center, cf, g_edge, g_center, int8_scales, num_heads, scale, chunk,
                weight_grads, *weights):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(edges, center, cf, g_edge, g_center, int8_scales, *weights)
        ctx.num_heads, ctx.scale, ctx.chunk = num_heads, scale, chunk
        ctx.weight_grads = weight_grads
        out = _first_backward(edges, center, cf, LayerWeights(*weights), g_edge, g_center,
                              num_heads, scale, weight_grads, int8_scales)
        return (*out[:3], *out[3]) if weight_grads else out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct_edges, ct_center, ct_cf, *ct_dw):
        edges, center, cf, g_edge, g_center, int8_scales, *weights = ctx.saved_tensors
        d_inputs, d_w = replay_layer_bwd(
            (edges, center, cf, g_edge, g_center), LayerWeights(*weights),
            (ct_edges, ct_center, ct_cf), ct_dw if ctx.weight_grads else None,
            ctx.num_heads, ctx.scale, ctx.chunk, int8_scales,
        )
        needs = ctx.needs_input_grad
        d_inputs = [d if needs[i] else None for i, d in enumerate(d_inputs)]
        d_w = [d.to(x.dtype) if needs[10 + i] else None
               for i, (d, x) in enumerate(zip(d_w, weights))]
        return (*d_inputs, None, None, None, None, None, *d_w)


def _first_forward(edges, center, cf, w, num_heads, scale, int8_scales, weight_grads):
    """K1 on the card, :func:`layer_math` on the CPU. ``weight_grads``: a
    weight requires grad, so the backward will be K2-dW and the replay;
    the Hopper K1, which rounds P where they do not, is then not taken."""
    if edges.is_cuda:
        return fused_layer_fwd_cuda(edges, center, cf, w, num_heads, scale,
                                    int8_scales=int8_scales, weight_grads=weight_grads)
    return layer_math(edges, center, cf, w, num_heads, scale, int8_scales=int8_scales)


class _FusedLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edges, center, cf, num_heads, scale, chunk, int8_scores, *weights):
        w = LayerWeights(*weights)
        # the dynamic int8 scores' scales: once per call, for the forward,
        # the backward and the replay alike (constants)
        int8_scales = int8_scales_for(edges, center, w) if int8_scores else None
        ctx.save_for_backward(edges, center, cf, int8_scales, *weights)
        ctx.num_heads, ctx.scale, ctx.chunk = num_heads, scale, chunk
        # the test backward makes for the weight gradients
        return _first_forward(edges, center, cf, w, num_heads, scale, int8_scales,
                              any(ctx.needs_input_grad[7:]))

    @staticmethod
    def backward(ctx, g_edge, g_center):
        edges, center, cf, int8_scales, *weights = ctx.saved_tensors
        # as the JAX package's _fused_bwd: the weight gradients come with
        # the first backward whenever a weight requires grad (fixed when
        # the forward ran), also in the backward that builds the forces
        weight_grads = any(ctx.needs_input_grad[7:])
        out = _FusedLayerBwd.apply(
            edges, center, cf, g_edge.to(edges.dtype).contiguous(),
            g_center.to(edges.dtype).contiguous(), int8_scales, ctx.num_heads, ctx.scale,
            ctx.chunk, weight_grads, *weights,
        )
        d_edges, d_center, d_cf = out[:3]
        d_w = [d.to(x.dtype) for d, x in zip(out[3:], weights)] if weight_grads else [None] * 10
        return (d_edges, d_center.to(center.dtype), d_cf.to(cf.dtype), None, None, None, None,
                *d_w)


def fused_transformer_layer(edges, center, cf, w: LayerWeights, num_heads: int, scale: float,
                            chunk: int = 1024, int8_scores: bool = False):
    """The fused layer with its hand-written backward. CPU tensors run
    :func:`layer_math` / :func:`layer_bwd_math`; CUDA tensors launch K1 /
    K2 (K2-dW when a weight requires grad). ``chunk`` is the number of
    atoms per step of the second-order replay (:func:`replay_layer_bwd`).
    With ``int8_scores`` (callers take it under
    :func:`int8_scores_applicable`), the dynamic int8 scores: the absmax
    pass, then K1-int8 and K2-int8 / K2-dW-int8 on the card."""
    return _FusedLayer.apply(edges, center, cf, num_heads, scale, chunk, int8_scores, *w)


def w8a8_applicable(edges, w: LayerWeights, num_heads: int, calib) -> bool:
    """The JAX package's gate of the static W8A8 layer (``use_int8_static``
    and ``_w8a8_applicable``): a calibration, bfloat16 compute, no weight
    that requires grad (inference), and the shapes of its q-side layout (M
    % 8 == 0, an even number of heads dividing D). Elsewhere the exact
    layer runs."""
    M, D = edges.shape[1:]
    return (calib is not None and edges.dtype == torch.bfloat16
            and not any(x.requires_grad for x in w)
            and M % 8 == 0 and D % num_heads == 0 and num_heads % 2 == 0)


def int8_scores_applicable(edges, num_heads: int) -> bool:
    """The JAX package's gate of the dynamic int8 scores
    (``_use_int8_scores`` and the q-side layout that alone takes them):
    bfloat16 compute, M % 8 == 0, an even number of heads dividing D; in
    training too. The static W8A8 layer wins where it applies (its callers
    ask :func:`w8a8_applicable` first)."""
    M, D = edges.shape[1:]
    return edges.dtype == torch.bfloat16 and M % 8 == 0 and D % num_heads == 0 and num_heads % 2 == 0


class _W8A8Layer(torch.autograd.Function):
    """The static W8A8 layer: forward K1-W8A8, backward K2-W8A8 (input
    gradients, straight through), or their plain versions on the CPU or
    with ``plain``. The weights are quantized from the float32 parameters
    at each call. Inference only: no weight gradients, no second order."""

    @staticmethod
    def forward(ctx, edges, center, cf, num_heads, scale, calib, plain, *weights):
        w = LayerWeights(*weights)
        wi8 = quantize_layer_weights(w, calib)
        ctx.save_for_backward(edges, center, cf, *weights, *wi8)
        ctx.num_heads, ctx.scale, ctx.calib, ctx.plain = num_heads, scale, calib, plain
        if edges.is_cuda and not plain:
            return fused_layer_fwd_cuda(edges, center, cf, w, num_heads, scale, w8a8=(calib, wi8))
        return layer_math(edges, center, cf, w, num_heads, scale, w8a8=(calib, wi8))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_edge, g_center):
        edges, center, cf, *rest = ctx.saved_tensors
        args = (edges, center, cf, LayerWeights(*rest[:10]), g_edge.to(edges.dtype).contiguous(),
                g_center.to(edges.dtype).contiguous(), ctx.num_heads, ctx.scale)
        w8a8 = (ctx.calib, tuple(rest[10:]))
        if edges.is_cuda and not ctx.plain:
            d_edges, d_center, d_cf = fused_layer_bwd_cuda(*args, w8a8=w8a8)
        else:
            d_edges, d_center, d_cf = layer_bwd_math(*args, w8a8=w8a8)
        return (d_edges, d_center.to(center.dtype), d_cf.to(cf.dtype), None, None, None, None,
                *([None] * 10))


def w8a8_transformer_layer(edges, center, cf, w: LayerWeights, num_heads: int, scale: float,
                           calib: Int8Calib, plain: bool = False):
    """The static W8A8 layer with its straight-through backward: CUDA
    tensors launch K1-W8A8 / K2-W8A8 (bfloat16; a kernel that fails raises),
    CPU tensors or ``plain`` run ``layer_math`` / ``layer_bwd_math`` with
    ``w8a8``. Callers take it under :func:`w8a8_applicable`."""
    return _W8A8Layer.apply(edges, center, cf, num_heads, scale, calib, plain, *w)
