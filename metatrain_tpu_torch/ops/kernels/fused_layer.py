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
  (``csrc/fused_layer_fwd.cu``) and, for its gradient, K2
  (``csrc/fused_layer_bwd.cu``): the input-gradient variant, or the
  weight-gradient variant K2-dW when a weight requires grad. The backward
  is itself differentiable (training with forces): its gradient replays
  :func:`layer_bwd_math` under autograd, chunk by chunk over atoms
  (:func:`replay_layer_bwd`, the port of ``_chunked_replay_bwd``).

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
    edges, center, cf, w: LayerWeights, g_edge, g_center, num_heads: int, scale: float,
    weight_grads: bool = False,
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
    that the second-order replay differentiates."""
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
    d_inputs = (_zero_last_slot(d_tokens).to(cd), d_tokens[:, M - 1].to(cd), d_cf)
    if not weight_grads:
        return d_inputs

    def rows_t(a, b):
        """a^T b over all A*M rows, operands in the compute dtype."""
        return a.reshape(A * M, -1).to(acc).T @ b.reshape(A * M, -1).to(acc)

    def colsum(x):
        return x.reshape(A * M, -1).to(acc).sum(0)

    d_attn_out_c = d_attn_out.to(cd)
    ffn_h = (value * sig).to(cd)
    dw = LayerWeights(
        norm_attn=colsum(d_n1 * (x1 * r1)),
        w_qkv=rows_t(n1, d_qkv),
        b_qkv=colsum(d_qkv),
        w_out=rows_t(attn, d_attn_out_c),
        b_out=colsum(d_attn_out_c),
        norm_mlp=colsum(d_h * (x2 * r2)),
        w_in=rows_t(h_norm, d_vg),
        b_in=colsum(d_vg),
        w_ffn_out=rows_t(ffn_h, g_eo),
        b_ffn_out=colsum(g_eo),
    )
    return (*d_inputs, dw)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def check_layer_shapes(edges, cf, w: LayerWeights, num_heads):
    """``(A, M, D, F)``; raises where the fused layer's kernel body (K1/K2,
    and the GNN block that runs it) does not take the shapes."""
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


def fused_layer_bwd_cuda(edges, center, cf, w: LayerWeights, g_edge, g_center, num_heads, scale,
                         weight_grads: bool = False):
    """Launch K2: ``(d_edges, d_center, d_cf)`` with ``d_cf`` float32.

    With ``weight_grads=True`` launch K2-dW instead, which also returns the
    float32 weight gradients summed over atoms as a fourth output
    (:class:`LayerWeights`). K2-dW runs one block per SM over a contiguous
    range of atoms, each block summing into its own float32 partial; a
    second pass adds the partials in block order, so the sum is the same
    from run to run."""
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
    name = "fused_layer_bwd_dw" if weight_grads else "fused_layer_bwd"
    lib = _lib.library()
    _lib.check_shared(lib.mtt_fused_layer_bwd_smem(M, D, num_heads, F, int(weight_grads)), name)
    d_edges = torch.empty_like(edges)
    d_center = torch.empty_like(center)
    d_cf = torch.empty_like(cf)
    partials = dw = None
    blocks = 0
    if weight_grads:
        sizes = [x.numel() for x in wc]
        blocks = _lib.dw_blocks(A, edges.device)
        partials = torch.empty((blocks, sum(sizes)), dtype=torch.float32, device=edges.device)
        dw = torch.empty(sum(sizes), dtype=torch.float32, device=edges.device)
    _lib.check(
        lib.mtt_fused_layer_bwd(
            code, edges.data_ptr(), center.data_ptr(), cf.data_ptr(),
            *(x.data_ptr() for x in wc[:8]),
            *(x.data_ptr() for x in transposed),
            g_edge.data_ptr(), g_center.data_ptr(),
            d_edges.data_ptr(), d_center.data_ptr(), d_cf.data_ptr(),
            _lib.ptr(partials), blocks, _lib.ptr(dw),
            A, M, D, num_heads, F, float(scale), rmsnorm_eps(cd),
            _lib.stream_ptr(edges.device),
        ),
        name,
    )
    _lib.LAUNCHES[name] += 1
    if not weight_grads:
        return d_edges, d_center, d_cf
    parts = torch.split(dw, sizes)
    return d_edges, d_center, d_cf, LayerWeights(*(p.view(x.shape) for p, x in zip(parts, wc)))


def _first_backward(edges, center, cf, w, g_edge, g_center, num_heads, scale, weight_grads):
    """K2 / K2-dW on the card, :func:`layer_bwd_math` on the CPU."""
    if edges.is_cuda:
        return fused_layer_bwd_cuda(edges, center, cf, w, g_edge, g_center, num_heads, scale,
                                    weight_grads)
    return layer_bwd_math(edges, center, cf, w, g_edge, g_center, num_heads, scale, weight_grads)


def replay_layer_bwd(inputs, w: LayerWeights, cotangents, ct_dw, num_heads, scale, chunk):
    """The vector-Jacobian product of :func:`layer_bwd_math`, computed by
    replaying it under autograd over chunks of ``chunk`` atoms (port of
    ``_chunked_replay_bwd``).

    :param inputs: ``(edges, center, cf, g_edge, g_center)``.
    :param cotangents: cotangents of ``(d_edges, d_center, d_cf)``, each
        ``None`` where the output has none.
    :param ct_dw: cotangents of the weight gradients (a sequence of 10,
        ``None`` entries allowed), or ``None``: then the replay skips the
        weight-gradient products.
    :return: the cotangents of the five inputs and of the 10 weights.

    Atoms are independent rows and the weight gradients are sums over
    them, so the chunked sum is exact. Each chunk recomputes its forward
    and frees its graph before the next, so only one chunk's temporaries
    are alive. The last chunk is simply shorter: no padding, so no padded
    window with all-zero cutoff weights (whose 0/0 would poison the weight
    cotangents) ever exists.
    """
    _lib.REPLAYS["fused_layer"] += 1
    return chunked_replay(
        lambda xs, ws, weight_grads: layer_bwd_math(xs[0], xs[1], xs[2], LayerWeights(*ws), xs[3],
                                                    xs[4], num_heads, scale, weight_grads),
        inputs, w, cotangents, ct_dw, chunk,
    )


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
    or K2-dW (the twin on the CPU), backward the chunked replay."""

    @staticmethod
    def forward(ctx, edges, center, cf, g_edge, g_center, num_heads, scale, chunk, weight_grads,
                *weights):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(edges, center, cf, g_edge, g_center, *weights)
        ctx.num_heads, ctx.scale, ctx.chunk = num_heads, scale, chunk
        ctx.weight_grads = weight_grads
        out = _first_backward(edges, center, cf, LayerWeights(*weights), g_edge, g_center,
                              num_heads, scale, weight_grads)
        return (*out[:3], *out[3]) if weight_grads else out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct_edges, ct_center, ct_cf, *ct_dw):
        edges, center, cf, g_edge, g_center, *weights = ctx.saved_tensors
        d_inputs, d_w = replay_layer_bwd(
            (edges, center, cf, g_edge, g_center), LayerWeights(*weights),
            (ct_edges, ct_center, ct_cf), ct_dw if ctx.weight_grads else None,
            ctx.num_heads, ctx.scale, ctx.chunk,
        )
        needs = ctx.needs_input_grad
        d_inputs = [d if needs[i] else None for i, d in enumerate(d_inputs)]
        d_w = [d.to(x.dtype) if needs[9 + i] else None
               for i, (d, x) in enumerate(zip(d_w, weights))]
        return (*d_inputs, None, None, None, None, *d_w)


class _FusedLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edges, center, cf, num_heads, scale, chunk, *weights):
        w = LayerWeights(*weights)
        ctx.save_for_backward(edges, center, cf, *weights)
        ctx.num_heads, ctx.scale, ctx.chunk = num_heads, scale, chunk
        if edges.is_cuda:
            return fused_layer_fwd_cuda(edges, center, cf, w, num_heads, scale)
        return layer_math(edges, center, cf, w, num_heads, scale)

    @staticmethod
    def backward(ctx, g_edge, g_center):
        edges, center, cf, *weights = ctx.saved_tensors
        # as the JAX package's _fused_bwd: the weight gradients come with
        # the first backward whenever a weight requires grad (fixed when
        # the forward ran), also in the backward that builds the forces
        weight_grads = any(ctx.needs_input_grad[6:])
        out = _FusedLayerBwd.apply(
            edges, center, cf, g_edge.to(edges.dtype).contiguous(),
            g_center.to(edges.dtype).contiguous(), ctx.num_heads, ctx.scale, ctx.chunk,
            weight_grads, *weights,
        )
        d_edges, d_center, d_cf = out[:3]
        d_w = [d.to(x.dtype) for d, x in zip(out[3:], weights)] if weight_grads else [None] * 10
        return (d_edges, d_center.to(center.dtype), d_cf.to(cf.dtype), None, None, None, *d_w)


def fused_transformer_layer(edges, center, cf, w: LayerWeights, num_heads: int, scale: float,
                            chunk: int = 1024):
    """The fused layer with its hand-written backward. CPU tensors run
    :func:`layer_math` / :func:`layer_bwd_math`; CUDA tensors launch K1 /
    K2 (K2-dW when a weight requires grad). ``chunk`` is the number of
    atoms per step of the second-order replay (:func:`replay_layer_bwd`)."""
    return _FusedLayer.apply(edges, center, cf, num_heads, scale, chunk, *w)
