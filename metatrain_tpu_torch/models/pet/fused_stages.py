"""PET row-block stage math: the plain PyTorch versions behind K3/K4.

Counterpart of ``metatrain_tpu/models/pet/fused_stages.py``. Each stage
maps (rows, D) inputs and its weights (JAX (in, out) layout) to one
(rows, W) output; its ``*_bwd(inputs, weights, g, weight_grads=False)``
returns the input cotangents and, with ``weight_grads=True``, then the
weight gradients summed over rows in the order of ``weights`` (the plain
versions of K4 and K4-dW). Casts to the compute dtype (the dtype of
``inputs[0]``) fall where the JAX functions put them, and where the CUDA
kernels round; accumulation is float32 (float64 for float64), and so are
the weight gradients.
"""

from __future__ import annotations

import torch

from ...ops.kernels.fused_layer import accumulation_dtype as _acc
from ...ops.kernels.rowblock import COMBINATION_CODE, COMPRESS_CODE, HEAD_CODE, Stage

EPS_LAYERNORM = 1e-5


def _dot(x, w, acc):
    """``x @ w`` with both operands in x's dtype, accumulated in ``acc``."""
    return x.to(acc) @ w.to(x.dtype).to(acc)


def _dot_t(g, w, acc):
    """Cotangent-side projection ``g @ w.T`` (``g`` already in the compute
    dtype)."""
    return g.to(acc) @ w.to(g.dtype).to(acc).T


def _silu_grad(pre, sig):
    return sig * (1.0 + pre * (1.0 - sig))


def compress_math(inputs, weights):
    """compress_0 over the concatenated parts -> SiLU -> compress_1; the
    concat is split into one product per part against its rows of ``w0``."""
    w0, b0, w1, b1 = weights
    cd = inputs[0].dtype
    acc = _acc(cd)
    D = inputs[0].shape[-1]
    h = b0.to(cd).to(acc)
    for i, part in enumerate(inputs):
        h = h + _dot(part, w0[i * D : (i + 1) * D], acc)
    h = torch.nn.functional.silu(h).to(cd)
    return (_dot(h, w1, acc) + b1.to(cd).to(acc)).to(cd)


def _layer_norm(edges, reversed_edges, ln_scale, ln_bias, acc):
    x = torch.cat([edges, reversed_edges], dim=-1).to(acc)
    mean = torch.mean(x, dim=-1, keepdim=True)
    centered = x - mean
    rs = torch.rsqrt(torch.mean(centered * centered, dim=-1, keepdim=True) + EPS_LAYERNORM)
    xn0 = centered * rs
    cd = edges.dtype
    return xn0, rs, (xn0 * ln_scale.to(cd).to(acc) + ln_bias.to(cd).to(acc)).to(cd)


def combination_math(inputs, weights):
    """LayerNorm([edges | reversed]) -> Dense(2D) -> SiLU -> Dense(D), then
    ``messages + edges + combined``."""
    edges, reversed_edges, messages = inputs
    ln_scale, ln_bias, w0, b0, w1, b1 = weights
    cd = edges.dtype
    acc = _acc(cd)
    _, _, xn = _layer_norm(edges, reversed_edges, ln_scale, ln_bias, acc)
    h = torch.nn.functional.silu(_dot(xn, w0, acc) + b0.to(cd).to(acc)).to(cd)
    combined = _dot(h, w1, acc) + b1.to(cd).to(acc)
    return (messages.to(acc) + edges.to(acc) + combined).to(cd)


def head_math(inputs, weights):
    """Two-layer SiLU head."""
    (x,) = inputs
    w0, b0, w1, b1 = weights
    cd = x.dtype
    acc = _acc(cd)
    h = torch.nn.functional.silu(_dot(x, w0, acc) + b0.to(cd).to(acc)).to(cd)
    return torch.nn.functional.silu(_dot(h, w1, acc) + b1.to(cd).to(acc)).to(cd)


def _rows_t(a, b, acc):
    """Weight gradient ``a.T @ b`` summed over rows."""
    return a.to(acc).T @ b.to(acc)


def _compress_terms(inputs, weights, g):
    """The compress backward's input cotangents and the per-row terms of its
    weight gradients (``compress_bwd`` sums them over rows)."""
    w0, b0, w1, _ = weights
    cd = inputs[0].dtype
    acc = _acc(cd)
    D = inputs[0].shape[-1]
    pre = b0.to(cd).to(acc)
    for i, part in enumerate(inputs):
        pre = pre + _dot(part, w0[i * D : (i + 1) * D], acc)
    sig = torch.sigmoid(pre)
    g_c = g.to(cd)
    d_pre = _dot_t(g_c, w1, acc) * _silu_grad(pre, sig)
    d_pre_c = d_pre.to(cd)
    d_inputs = tuple(
        _dot_t(d_pre_c, w0[i * D : (i + 1) * D], acc).to(cd) for i in range(len(inputs))
    )
    return d_inputs, {"d_pre": d_pre, "d_pre_c": d_pre_c, "h": (pre * sig).to(cd), "g_c": g_c}


def compress_bwd(inputs, weights, g, weight_grads=False):
    d_inputs, t = _compress_terms(inputs, weights, g)
    if not weight_grads:
        return d_inputs
    acc = t["d_pre"].dtype
    return d_inputs + (
        torch.cat([_rows_t(part, t["d_pre_c"], acc) for part in inputs]),
        t["d_pre"].sum(0),
        _rows_t(t["h"], t["g_c"], acc),
        t["g_c"].to(acc).sum(0),
    )


def compress_operands(inputs, weights, g):
    """What the two-pass K4-dW's first pass gives for the compress: the input
    cotangents, the spilled rows (d_pre, h) and the rows of its vector sums
    (d_pre, g): the parts and g themselves are the other operands."""
    d_inputs, t = _compress_terms(inputs, weights, g)
    acc = t["d_pre"].dtype
    return d_inputs, (t["d_pre_c"], t["h"]), torch.cat([t["d_pre"], t["g_c"].to(acc)], dim=1)


def _combination_terms(inputs, weights, g):
    """The combination backward's input cotangents and the per-row terms of
    its weight gradients (``combination_bwd`` sums them over rows)."""
    edges, reversed_edges, _ = inputs
    ln_scale, ln_bias, w0, b0, w1, _ = weights
    cd = edges.dtype
    acc = _acc(cd)
    xn0, rs, xn = _layer_norm(edges, reversed_edges, ln_scale, ln_bias, acc)
    pre0 = _dot(xn, w0, acc) + b0.to(cd).to(acc)
    sig0 = torch.sigmoid(pre0)
    g_c = g.to(cd)
    d_pre0 = _dot_t(g_c, w1, acc) * _silu_grad(pre0, sig0)
    d_pre0_c = d_pre0.to(cd)
    d_xn = _dot_t(d_pre0_c, w0, acc)
    d_xn0 = d_xn * ln_scale.to(cd).to(acc)
    d_x = rs * (
        d_xn0
        - torch.mean(d_xn0, dim=-1, keepdim=True)
        - xn0 * torch.mean(d_xn0 * xn0, dim=-1, keepdim=True)
    )
    De = edges.shape[-1]
    d_inputs = ((d_x[:, :De] + g_c.to(acc)).to(cd), d_x[:, De:].to(cd), g_c)
    return d_inputs, {"xn0": xn0, "xn": xn, "d_pre": d_pre0, "d_pre_c": d_pre0_c, "d_xn": d_xn,
                      "h": (pre0 * sig0).to(cd), "g_c": g_c}


def combination_bwd(inputs, weights, g, weight_grads=False):
    d_inputs, t = _combination_terms(inputs, weights, g)
    if not weight_grads:
        return d_inputs
    acc = t["d_pre"].dtype
    return d_inputs + (
        (t["d_xn"] * t["xn0"]).sum(0),
        t["d_xn"].sum(0),
        _rows_t(t["xn"], t["d_pre_c"], acc),
        t["d_pre"].sum(0),
        _rows_t(t["h"], t["g_c"], acc),
        t["g_c"].to(acc).sum(0),
    )


def combination_operands(inputs, weights, g):
    """What the two-pass K4-dW's first pass gives for the combination: the
    input cotangents (d_edges, d_reversed), the spilled rows (xn, d_pre, h)
    and the rows of its vector sums (d_xn xn0, d_xn, d_pre, g)."""
    d_inputs, t = _combination_terms(inputs, weights, g)
    acc = t["d_pre"].dtype
    vec = torch.cat([t["d_xn"] * t["xn0"], t["d_xn"], t["d_pre"], t["g_c"].to(acc)], dim=1)
    return d_inputs[:2], (t["xn"], t["d_pre_c"], t["h"]), vec


def _head_terms(inputs, weights, g):
    """The head backward's input cotangent and the per-row terms of its
    weight gradients (``head_bwd`` sums them over rows)."""
    (x,) = inputs
    w0, b0, w1, b1 = weights
    cd = x.dtype
    acc = _acc(cd)
    pre0 = _dot(x, w0, acc) + b0.to(cd).to(acc)
    sig0 = torch.sigmoid(pre0)
    h0 = (pre0 * sig0).to(cd)
    pre1 = _dot(h0, w1, acc) + b1.to(cd).to(acc)
    d_pre1 = g.to(cd).to(acc) * _silu_grad(pre1, torch.sigmoid(pre1))
    d_pre1_c = d_pre1.to(cd)
    d_pre0 = _dot_t(d_pre1_c, w1, acc) * _silu_grad(pre0, sig0)
    d_pre0_c = d_pre0.to(cd)
    d_inputs = (_dot_t(d_pre0_c, w0, acc).to(cd),)
    return d_inputs, {"d_pre0": d_pre0, "d_pre0_c": d_pre0_c, "h0": h0, "d_pre1": d_pre1,
                      "d_pre1_c": d_pre1_c}


def head_bwd(inputs, weights, g, weight_grads=False):
    d_inputs, t = _head_terms(inputs, weights, g)
    if not weight_grads:
        return d_inputs
    acc = t["d_pre0"].dtype
    return d_inputs + (
        _rows_t(inputs[0], t["d_pre0_c"], acc),
        t["d_pre0"].sum(0),
        _rows_t(t["h0"], t["d_pre1_c"], acc),
        t["d_pre1"].sum(0),
    )


def head_operands(inputs, weights, g):
    """What the two-pass K4-dW's first pass gives for the head: the input
    cotangent, the spilled rows (d_pre0, h0, d_pre1) and the rows of its
    vector sums (d_pre0, d_pre1): x is the other operand."""
    d_inputs, t = _head_terms(inputs, weights, g)
    vec = torch.cat([t["d_pre0"], t["d_pre1"]], dim=1)
    return d_inputs, (t["d_pre0_c"], t["h0"], t["d_pre1_c"]), vec


COMPRESS = Stage("compress", COMPRESS_CODE, compress_math, compress_bwd, compress_operands)
COMBINATION = Stage("combination", COMBINATION_CODE, combination_math, combination_bwd,
                    combination_operands)
HEAD = Stage("head", HEAD_CODE, head_math, head_bwd, head_operands)
