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


def compress_bwd(inputs, weights, g, weight_grads=False):
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
    if not weight_grads:
        return d_inputs
    h = (pre * sig).to(cd)
    return d_inputs + (
        torch.cat([_rows_t(part, d_pre_c, acc) for part in inputs]),
        d_pre.sum(0),
        _rows_t(h, g_c, acc),
        g_c.to(acc).sum(0),
    )


def combination_bwd(inputs, weights, g, weight_grads=False):
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
    if not weight_grads:
        return d_inputs
    h = (pre0 * sig0).to(cd)
    return d_inputs + (
        (d_xn * xn0).sum(0),
        d_xn.sum(0),
        _rows_t(xn, d_pre0_c, acc),
        d_pre0.sum(0),
        _rows_t(h, g_c, acc),
        g_c.to(acc).sum(0),
    )


def head_bwd(inputs, weights, g, weight_grads=False):
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
    if not weight_grads:
        return d_inputs
    return d_inputs + (
        _rows_t(x, d_pre0_c, acc),
        d_pre0.sum(0),
        _rows_t(h0, d_pre1_c, acc),
        d_pre1.sum(0),
    )


COMPRESS = Stage("compress", COMPRESS_CODE, compress_math, compress_bwd)
COMBINATION = Stage("combination", COMBINATION_CODE, combination_math, combination_bwd)
HEAD = Stage("head", HEAD_CODE, head_math, head_bwd)
