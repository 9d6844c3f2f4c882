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
  versions (forward, and backward for input gradients).
- :func:`fused_transformer_layer` is the ``autograd.Function`` entry: a
  tensor on the CPU runs the plain versions; a CUDA tensor launches K1
  (``csrc/fused_layer_fwd.cu``) and, for its gradient, K2
  (``csrc/fused_layer_bwd.cu``), or raises. Weight gradients belong to the
  training slice: the backward raises when a weight requires grad.

Weights keep the JAX package's (in, out) layout and are cast to the
compute dtype (the dtype of ``edges``); accumulation is float32 (float64
for float64 inputs).
"""

from __future__ import annotations

from typing import NamedTuple

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


def _attention_probs(q, k, cf, scale, acc):
    """E = exp(s - max) / sum_k cf exp(s - max), (A, H, Mq, Mk); the
    attention weights are ``cf * E``. The max is a constant shift of the
    softmax, so it carries no gradient."""
    s = torch.einsum("aqhd,akhd->ahqk", q.to(acc), k.to(acc)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
    cf_k = cf.to(acc)[:, None, None, :]
    return e / torch.sum(cf_k * e, dim=-1, keepdim=True), cf_k


def layer_math(edges, center, cf, w: LayerWeights, num_heads: int, scale: float):
    """Plain PyTorch forward: ``(edge_out, center_attn)``.

    :param edges: (A, M, D) edge tokens; slot M-1 is ignored and replaced
        by the center token.
    :param center: (A, D) center tokens.
    :param cf: (A, M) multiplicative attention weights on the keys, with
        ``cf[:, M-1] == 1`` (the center).
    """
    A, M, D = edges.shape
    cd = edges.dtype
    acc = accumulation_dtype(cd)
    hd = D // num_heads
    eps = rmsnorm_eps(cd)
    wc = LayerWeights(*(x.to(cd) for x in w))

    tokens = _with_center(edges, center)
    x1, r1 = _rms_stats(tokens, acc, eps)
    normed = (x1 * r1 * wc.norm_attn.to(acc)).to(cd)
    qkv = _matmul_bias(normed.reshape(A * M, D), wc.w_qkv, wc.b_qkv, cd)
    q, k, v = qkv.reshape(A, M, 3, num_heads, hd).unbind(2)
    probs, cf_k = _attention_probs(q, k, cf, scale, acc)
    attn = torch.einsum("ahqk,akhd->aqhd", cf_k * probs, v.to(acc))
    attn = attn.reshape(A * M, D).to(cd)
    attn_out = _matmul_bias(attn, wc.w_out, wc.b_out, cd).reshape(A, M, D)
    center_attn = attn_out[:, M - 1]

    res = tokens + attn_out
    x2, r2 = _rms_stats(res, acc, eps)
    h_norm = (x2 * r2 * wc.norm_mlp.to(acc)).to(cd)
    d_ff = wc.w_ffn_out.shape[0]
    vg = _matmul_bias(h_norm.reshape(A * M, D), wc.w_in, wc.b_in)
    ffn_h = (vg[:, :d_ff] * torch.sigmoid(vg[:, d_ff:])).to(cd)
    ffn_out = _matmul_bias(ffn_h, wc.w_ffn_out, wc.b_ffn_out, cd).reshape(A, M, D)
    return _zero_last_slot(res + ffn_out), center_attn


def layer_bwd_math(
    edges, center, cf, w: LayerWeights, g_edge, g_center, num_heads: int, scale: float
):
    """Plain PyTorch backward of :func:`layer_math` for input gradients:
    ``(d_edges, d_center, d_cf)`` with ``d_edges[:, M-1] == 0`` and
    ``d_cf`` in float32 (float64 for float64 inputs). Every cotangent is
    rounded to the compute dtype before the product that consumes it, as
    K2 does."""
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
    n1 = (x1 * r1 * wa.norm_attn).to(cd)
    qkv = _matmul_bias(n1.reshape(A * M, D), wc.w_qkv, wc.b_qkv, cd)
    q, k, v = qkv.reshape(A, M, 3, H, hd).unbind(2)
    probs, cf_k = _attention_probs(q, k, cf, scale, acc)
    p_attn = cf_k * probs
    attn = torch.einsum("ahqk,akhd->aqhd", p_attn, v.to(acc)).reshape(A * M, D).to(cd)
    attn_out = _matmul_bias(attn, wc.w_out, wc.b_out, cd).reshape(A, M, D)
    res = tokens + attn_out
    x2, r2 = _rms_stats(res, acc, eps)
    h_norm = (x2 * r2 * wa.norm_mlp).to(cd)
    d_ff = wc.w_ffn_out.shape[0]
    vg = _matmul_bias(h_norm.reshape(A * M, D), wc.w_in, wc.b_in)
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
    return _zero_last_slot(d_tokens).to(cd), d_tokens[:, M - 1].to(cd), d_cf


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check_shapes(edges, center, cf, w: LayerWeights, num_heads):
    A, M, D = edges.shape
    F = w.w_ffn_out.shape[0]
    # bfloat16 products run on the tensor cores in 16-wide tiles
    width = 16 if edges.dtype == torch.bfloat16 else 4
    if M % 16 or M >= D or D % width or F % width or D % num_heads or (D // num_heads) % 4:
        raise ValueError(
            f"fused layer kernels need M % 16 == 0, M < D, D and F divisible by "
            f"{width} and a head width divisible by 4; got M={M}, D={D}, F={F}, "
            f"heads={num_heads}"
        )
    if center.shape != (A, D) or cf.shape != (A, M):
        raise ValueError(f"center {tuple(center.shape)} / cf {tuple(cf.shape)} "
                         f"do not match edges {tuple(edges.shape)}")
    return A, M, D, F


def _cuda_weights(w: LayerWeights, cd) -> LayerWeights:
    return LayerWeights(*(x.detach().to(cd).contiguous() for x in w))


def fused_layer_fwd_cuda(edges, center, cf, w: LayerWeights, num_heads, scale):
    """Launch K1. ``edges``/``center`` float32 or bfloat16, ``cf`` float32."""
    A, M, D, F = _check_shapes(edges, center, cf, w, num_heads)
    cd = edges.dtype
    code = _lib.dtype_code(cd)
    wc = _cuda_weights(w, cd)
    _lib.require({"edges": edges, "center": center, **wc._asdict()}, edges.device, cd)
    _lib.require({"cf": cf}, edges.device, torch.float32)
    lib = _lib.library()
    _lib.check_shared(lib.mtt_fused_layer_fwd_smem(M, D, F), "fused_layer_fwd")
    edge_out = torch.empty_like(edges)
    center_out = torch.empty_like(center)
    _lib.check(
        lib.mtt_fused_layer_fwd(
            code, edges.data_ptr(), center.data_ptr(), cf.data_ptr(),
            *(x.data_ptr() for x in wc),
            edge_out.data_ptr(), center_out.data_ptr(),
            A, M, D, num_heads, F, float(scale), rmsnorm_eps(cd),
            _lib.stream_ptr(edges.device),
        ),
        "fused_layer_fwd",
    )
    _lib.LAUNCHES["fused_layer_fwd"] += 1
    return edge_out, center_out


def fused_layer_bwd_cuda(edges, center, cf, w: LayerWeights, g_edge, g_center, num_heads, scale):
    """Launch K2: ``(d_edges, d_center, d_cf)`` with ``d_cf`` float32."""
    A, M, D, F = _check_shapes(edges, center, cf, w, num_heads)
    cd = edges.dtype
    code = _lib.dtype_code(cd)
    wc = _cuda_weights(w, cd)
    transposed = [x.t().contiguous() for x in (wc.w_qkv, wc.w_out, wc.w_in, wc.w_ffn_out)]
    _lib.require(
        {"edges": edges, "center": center, "g_edge": g_edge, "g_center": g_center,
         **wc._asdict()},
        edges.device, cd,
    )
    _lib.require({"cf": cf}, edges.device, torch.float32)
    lib = _lib.library()
    _lib.check_shared(lib.mtt_fused_layer_bwd_smem(M, D, num_heads, F), "fused_layer_bwd")
    d_edges = torch.empty_like(edges)
    d_center = torch.empty_like(center)
    d_cf = torch.empty_like(cf)
    _lib.check(
        lib.mtt_fused_layer_bwd(
            code, edges.data_ptr(), center.data_ptr(), cf.data_ptr(),
            *(x.data_ptr() for x in wc[:8]),
            *(x.data_ptr() for x in transposed),
            g_edge.data_ptr(), g_center.data_ptr(),
            d_edges.data_ptr(), d_center.data_ptr(), d_cf.data_ptr(),
            A, M, D, num_heads, F, float(scale), rmsnorm_eps(cd),
            _lib.stream_ptr(edges.device),
        ),
        "fused_layer_bwd",
    )
    _lib.LAUNCHES["fused_layer_bwd"] += 1
    return d_edges, d_center, d_cf


class _FusedLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edges, center, cf, num_heads, scale, *weights):
        w = LayerWeights(*weights)
        ctx.save_for_backward(edges, center, cf, *weights)
        ctx.num_heads, ctx.scale = num_heads, scale
        if edges.is_cuda:
            return fused_layer_fwd_cuda(edges, center, cf, w, num_heads, scale)
        return layer_math(edges, center, cf, w, num_heads, scale)

    @staticmethod
    def backward(ctx, g_edge, g_center):
        if any(ctx.needs_input_grad[5:]):
            raise NotImplementedError("weight gradients: training slice")
        edges, center, cf, *weights = ctx.saved_tensors
        w = LayerWeights(*weights)
        g_edge = g_edge.to(edges.dtype).contiguous()
        g_center = g_center.to(edges.dtype).contiguous()
        if edges.is_cuda:
            d_edges, d_center, d_cf = fused_layer_bwd_cuda(
                edges, center, cf, w, g_edge, g_center, ctx.num_heads, ctx.scale
            )
        else:
            d_edges, d_center, d_cf = layer_bwd_math(
                edges, center, cf, w, g_edge, g_center, ctx.num_heads, ctx.scale
            )
        return (d_edges, d_center.to(center.dtype), d_cf.to(cf.dtype),
                None, None, *([None] * len(weights)))


def fused_transformer_layer(edges, center, cf, w: LayerWeights, num_heads: int, scale: float):
    """The fused layer with its hand-written backward (input gradients
    only). CPU tensors run :func:`layer_math` / :func:`layer_bwd_math`;
    CUDA tensors launch K1 / K2."""
    return _FusedLayer.apply(edges, center, cf, num_heads, scale, *w)
