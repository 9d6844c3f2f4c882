"""Fused GNN block: every attention layer of one PET GNN layer, and the node
stream between them, as one CUDA kernel pair; and its plain versions.

Counterpart of the GNN block of ``metatrain_tpu/ops/pallas/fused_layer.py``
(``fused_gnn_block``). For each attention layer l, on the reserved-slot
token layout of :mod:`.fused_layer`:

    with the node expansion (node width N != D):
        center = node @ w_contr + b_contr
    (edges, cattn) = layer_math(edges, center, cf, w_l)
    with the expansion: node = center_update(node, cattn, cw_l)
        (expansion residual, RMSNorm, SwiGLU center MLP N -> 4N -> N and
        its residual)
    without: node = cattn

- :func:`gnn_block_math` and :func:`gnn_block_bwd_math` are the plain
  PyTorch versions (forward; backward for input gradients plus, with
  ``weight_grads=True``, the gradients of every weight summed over atoms).
- :func:`fused_gnn_block` is the ``autograd.Function`` entry: a tensor on
  the CPU runs the plain versions; a CUDA tensor launches
  ``csrc/gnn_block_fwd.cu`` and, for its gradient, ``csrc/gnn_block_bwd.cu``
  (its weight-gradient variant when a weight requires grad). The backward
  is itself differentiable (training with forces): its gradient replays
  :func:`gnn_block_bwd_math` under autograd, chunk by chunk over atoms
  (:func:`replay_gnn_block_bwd`).

Weights come as one flat list in the JAX package's order
(:func:`flatten_gnn_weights`: the 10 :class:`LayerWeights` of each layer,
then, with the expansion, the 9 :class:`CenterWeights` of each layer), in
the (in, out) layout, cast to the compute dtype (the dtype of ``edges``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _lib
from .fused_layer import (
    LayerWeights,
    _matmul_bias,
    _rms_stats,
    accumulation_dtype,
    check_layer_shapes,
    chunked_replay,
    layer_bwd_math,
    layer_math,
    rmsnorm_eps,
)

MAX_LAYERS = 8  # attention layers per block the kernels take


class CenterWeights(NamedTuple):
    """Node-stream weights of one attention layer (N = d_node, D = d_pet),
    (in, out) layout."""

    w_contr: torch.Tensor  # (N, D)
    b_contr: torch.Tensor  # (D,)
    w_exp: torch.Tensor  # (D, N)
    b_exp: torch.Tensor  # (N,)
    norm_c: torch.Tensor  # (N,)
    w_in_c: torch.Tensor  # (N, 4N): value columns first, then gate columns
    b_in_c: torch.Tensor  # (4N,)
    w_out_c: torch.Tensor  # (2N, N)
    b_out_c: torch.Tensor  # (N,)


def flatten_gnn_weights(layer_ws, center_ws, expanded: bool) -> list:
    """The flat weight list: every layer's LayerWeights, then (expanded)
    every layer's CenterWeights."""
    flat = [t for w in layer_ws for t in w]
    if expanded:
        flat += [t for cw in center_ws for t in cw]
    return flat


def unflatten_gnn_weights(flat, n_layers: int, expanded: bool):
    """``(layer_ws, center_ws)`` from the flat list; ``center_ws`` holds
    ``None`` per layer without the expansion."""
    nl, nc = len(LayerWeights._fields), len(CenterWeights._fields)
    layer_ws = tuple(LayerWeights(*flat[i * nl:(i + 1) * nl]) for i in range(n_layers))
    if not expanded:
        return layer_ws, (None,) * n_layers
    off = n_layers * nl
    return layer_ws, tuple(CenterWeights(*flat[off + i * nc:off + (i + 1) * nc])
                           for i in range(n_layers))


def _center_forward(node, cattn, wc: CenterWeights, cd):
    """The node update with its intermediates: ``(n_mid, x2, r2, hn, v,
    sig, h, node_next)``; ``wc`` in the compute dtype."""
    acc = accumulation_dtype(cd)
    n_mid = node + _matmul_bias(cattn, wc.w_exp, wc.b_exp, cd)
    x2, r2 = _rms_stats(n_mid, acc, rmsnorm_eps(cd))
    hn = (x2 * r2 * wc.norm_c.to(acc)).to(cd)
    vg = _matmul_bias(hn, wc.w_in_c, wc.b_in_c)
    d_ff = wc.w_out_c.shape[0]
    v, sig = vg[:, :d_ff], torch.sigmoid(vg[:, d_ff:])
    h = (v * sig).to(cd)
    return n_mid, x2, r2, hn, v, sig, h, n_mid + _matmul_bias(h, wc.w_out_c, wc.b_out_c, cd)


def center_update(node, cattn, cw: CenterWeights, cd):
    """The node update of the expanded path: ``n_mid = node + cattn w_exp +
    b_exp``, RMSNorm over N, the SwiGLU center MLP and its residual."""
    return _center_forward(node, cattn, CenterWeights(*(x.to(cd) for x in cw)), cd)[-1]


def gnn_block_math(edges, node, cf, layer_ws, center_ws, num_heads: int, scale: float,
                   expanded: bool):
    """Plain PyTorch forward of one GNN layer's attention layers:
    ``(edge_out, node_out)``.

    :param edges: (A, M, D) edge tokens (slot M-1 is the center's).
    :param node: (A, N) node features with the expansion, (A, D) without.
    :param cf: (A, M) multiplicative attention weights, ``cf[:, M-1] == 1``.
    """
    cd = edges.dtype
    for w, cw in zip(layer_ws, center_ws):
        if expanded:
            center = _matmul_bias(node, cw.w_contr.to(cd), cw.b_contr.to(cd), cd)
        else:
            center = node
        edges, cattn = layer_math(edges, center, cf, w, num_heads, scale)
        node = center_update(node, cattn, cw, cd) if expanded else cattn
    return edges, node


def gnn_block_bwd_math(edges, node, cf, layer_ws, center_ws, g_edge, g_node, num_heads: int,
                       scale: float, expanded: bool, weight_grads: bool = False):
    """Plain PyTorch backward of :func:`gnn_block_math`: ``(d_edges,
    d_node, d_cf)`` with ``d_cf`` summed over the layers in float32
    (float64 for float64 inputs). The forward is recomputed, saving each
    layer's inputs; then, last layer first, the node stream's backward, the
    layer's :func:`layer_bwd_math` and the contraction's. Every cotangent is
    rounded to the compute dtype where the JAX package's
    ``_gnn_block_bwd_math`` rounds it.

    With ``weight_grads=True`` a fourth output holds the gradients of every
    weight summed over atoms, in the order of :func:`flatten_gnn_weights`
    (float32; float64 for float64 inputs). This is the plain version of the
    weight-gradient kernel and the function the second-order replay
    differentiates."""
    cd = edges.dtype
    acc = accumulation_dtype(cd)
    saved = []
    e, n = edges, node
    for w, cw in zip(layer_ws, center_ws):
        wc = CenterWeights(*(x.to(cd) for x in cw)) if expanded else None
        center = _matmul_bias(n, wc.w_contr, wc.b_contr, cd) if expanded else n
        e_next, cattn = layer_math(e, center, cf, w, num_heads, scale)
        extras = _center_forward(n, cattn, wc, cd) if expanded else None
        saved.append((e, n, center, cattn, wc, extras))
        e, n = e_next, (extras[-1] if expanded else cattn)

    def rows_t(a, b):
        return a.to(acc).T @ b.to(acc)

    def colsum(x):
        return x.to(acc).sum(0)

    n_layers = len(layer_ws)
    d_e, d_n, d_cf = g_edge, g_node.to(acc), None
    dws, dcs = [None] * n_layers, [None] * n_layers
    for i in reversed(range(n_layers)):
        e_in, n_in, center, cattn, wc, extras = saved[i]
        if expanded:
            n_mid, x2, r2, hn, v, sig, h, _ = extras
            wa = CenterWeights(*(x.to(acc) for x in wc))
            # node' = n_mid + h w_out_c + b_out_c, h = v sig(g), [v | g] = hn w_in_c + b_in_c
            d_n_cd = d_n.to(cd)
            d_h = d_n_cd.to(acc) @ wa.w_out_c.T
            d_vg = torch.cat([d_h * sig, d_h * v * sig * (1.0 - sig)], dim=-1).to(cd)
            d_hn = d_vg.to(acc) @ wa.w_in_c.T
            gs = d_hn * (r2 * wa.norm_c)
            N = x2.shape[-1]
            d_nmid = d_n + (gs - x2 * (r2 * r2 * torch.sum(gs * x2, dim=-1, keepdim=True) / N))
            d_nmid_cd = d_nmid.to(cd)
            d_cattn = (d_nmid_cd.to(acc) @ wa.w_exp.T).to(cd)
        else:
            d_cattn = d_n.to(cd)
        out = layer_bwd_math(e_in, center, cf, layer_ws[i], d_e, d_cattn, num_heads, scale,
                             weight_grads)
        d_e, d_center, d_cf_l = out[:3]
        d_cf = d_cf_l if d_cf is None else d_cf + d_cf_l
        if weight_grads:
            dws[i] = out[3]
        if not expanded:
            d_n = d_center.to(acc)
            continue
        if weight_grads:
            dcs[i] = CenterWeights(
                w_contr=rows_t(n_in, d_center), b_contr=colsum(d_center),
                w_exp=rows_t(cattn, d_nmid_cd), b_exp=colsum(d_nmid),
                norm_c=colsum(d_hn * (x2 * r2)), w_in_c=rows_t(hn, d_vg), b_in_c=colsum(d_vg),
                w_out_c=rows_t(h, d_n_cd), b_out_c=colsum(d_n),
            )
        d_n = d_nmid + d_center.to(acc) @ wa.w_contr.T
    d_inputs = (d_e, d_n.to(node.dtype), d_cf)
    if not weight_grads:
        return d_inputs
    return (*d_inputs, flatten_gnn_weights(dws, dcs, expanded))


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check_shapes(edges, node, cf, layer_ws, center_ws, num_heads, expanded):
    """``(A, M, D, F, Nn)``; raises where the kernels do not take the
    shapes."""
    A, M, D, F = check_layer_shapes(edges, cf, layer_ws[0], num_heads)
    if not 1 <= len(layer_ws) <= MAX_LAYERS:
        raise ValueError(f"the GNN block kernels take 1 to {MAX_LAYERS} layers, "
                         f"got {len(layer_ws)}")
    for w in layer_ws[1:]:
        if [x.shape for x in w] != [x.shape for x in layer_ws[0]]:
            raise ValueError("the layers of a GNN block must have the same shapes")
    Nn = node.shape[-1]
    if node.shape != (A, Nn) or (not expanded and Nn != D) or Nn % 2:
        raise ValueError(f"node {tuple(node.shape)} does not fit edges {tuple(edges.shape)} "
                         f"(expanded={expanded}; the node width must be even)")
    if expanded:
        want = [(Nn, D), (D,), (D, Nn), (Nn,), (Nn,), (Nn, 4 * Nn), (4 * Nn,), (2 * Nn, Nn),
                (Nn,)]
        for cw in center_ws:
            if [tuple(x.shape) for x in cw] != want:
                raise ValueError(f"center weights {[tuple(x.shape) for x in cw]} do not fit "
                                 f"N={Nn}, D={D}")
    return A, M, D, F, Nn


def _cuda_tensor(x, cd):
    """``x`` in the compute dtype, contiguous and 16-byte aligned (the
    node stream reads weights in pairs)."""
    x = x.detach().to(cd).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _cuda_weights(flat_w, n_layers, expanded, cd):
    layer_ws, center_ws = unflatten_gnn_weights([_cuda_tensor(x, cd) for x in flat_w],
                                                n_layers, expanded)
    return layer_ws, (center_ws if expanded else ())


def _require(edges, node, cf, layer_ws, center_ws, extra=None):
    cd = edges.dtype
    tensors = {"edges": edges, "node": node, **(extra or {})}
    for i, w in enumerate(layer_ws):
        tensors.update({f"layer_{i}.{k}": v for k, v in w._asdict().items()})
    for i, cw in enumerate(center_ws):
        tensors.update({f"center_{i}.{k}": v for k, v in cw._asdict().items()})
    _lib.require(tensors, edges.device, cd)
    _lib.require({"cf": cf}, edges.device, torch.float32)


def gnn_block_fwd_cuda(edges, node, cf, flat_w, num_heads, scale, n_layers, expanded):
    """Launch the block's forward. ``edges``/``node`` float32 or bfloat16
    (the same), ``cf`` float32."""
    cd = edges.dtype
    code = _lib.dtype_code(cd)
    layer_ws, center_ws = _cuda_weights(flat_w, n_layers, expanded, cd)
    A, M, D, F, Nn = _check_shapes(edges, node, cf, layer_ws, center_ws, num_heads, expanded)
    _require(edges, node, cf, layer_ws, center_ws)
    lib = _lib.library()
    _lib.check_shared(lib.mtt_gnn_block_fwd_smem(M, D, F, Nn), "gnn_block_fwd")
    edge_out = torch.empty_like(edges)
    node_out = torch.empty_like(node)
    _lib.check(
        lib.mtt_gnn_block_fwd(
            code, edges.data_ptr(), node.data_ptr(), cf.data_ptr(),
            _lib.pointer_array(x for w in layer_ws for x in w),
            _lib.pointer_array(x for cw in center_ws for x in cw),
            edge_out.data_ptr(), node_out.data_ptr(),
            A, n_layers, M, D, num_heads, F, Nn, int(expanded), float(scale), rmsnorm_eps(cd),
            _lib.stream_ptr(edges.device),
        ),
        "gnn_block_fwd",
    )
    _lib.LAUNCHES["gnn_block_fwd"] += 1
    return edge_out, node_out


def gnn_block_bwd_cuda(edges, node, cf, flat_w, g_edge, g_node, num_heads, scale, n_layers,
                       expanded, weight_grads: bool = False):
    """Launch the block's backward: ``(d_edges, d_node, d_cf)`` with
    ``d_cf`` float32.

    With ``weight_grads=True`` launch its weight-gradient variant instead,
    which also returns the float32 gradients of every weight summed over
    atoms, as a flat list in the order of ``flat_w``: the layer weights
    through per-block partials summed in block order (as K2-dW), the node
    stream's through a second kernel over the saved row vectors in atom
    order, so the sums are the same from run to run."""
    cd = edges.dtype
    code = _lib.dtype_code(cd)
    layer_ws, center_ws = _cuda_weights(flat_w, n_layers, expanded, cd)
    A, M, D, F, Nn = _check_shapes(edges, node, cf, layer_ws, center_ws, num_heads, expanded)
    _require(edges, node, cf, layer_ws, center_ws, {"g_edge": g_edge, "g_node": g_node})
    if g_edge.shape != edges.shape or g_node.shape != node.shape:
        raise ValueError("the cotangents must have the shapes of the outputs")
    transposed = [x.t().contiguous() for w in layer_ws
                  for x in (w.w_qkv, w.w_out, w.w_in, w.w_ffn_out)]
    name = "gnn_block_bwd_dw" if weight_grads else "gnn_block_bwd"
    lib = _lib.library()
    _lib.check_shared(lib.mtt_gnn_block_bwd_smem(M, D, num_heads, F, Nn, int(weight_grads)), name)
    dev = edges.device
    d_edges = torch.empty_like(edges)
    d_node = torch.empty_like(node)
    d_cf = torch.empty_like(cf)
    # what crosses between the kernel's phases (see gnn_block_bwd.cu)
    L = n_layers
    nbuf = min(L - 1, 2)
    escr = torch.empty((A, L - 1, M, D), dtype=cd, device=dev) if L > 1 else None
    dscr = torch.empty((nbuf, A, M, D), dtype=cd, device=dev) if nbuf else None
    vecs = torch.empty((A, L, 3, D), dtype=cd, device=dev)
    rows = (torch.empty((A, L, lib.mtt_gnn_block_row_floats(Nn, D)), dtype=torch.float32,
                        device=dev) if expanded else None)
    cuda_flat = flatten_gnn_weights(layer_ws, center_ws, expanded)
    partials = dw = None
    blocks = 0
    if weight_grads:
        sizes = [x.numel() for x in cuda_flat]
        blocks = _lib.dw_blocks(A, dev)
        per_layer = sum(x.numel() for x in layer_ws[0])
        partials = torch.empty((blocks, L * per_layer), dtype=torch.float32, device=dev)
        dw = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    _lib.check(
        lib.mtt_gnn_block_bwd(
            code, edges.data_ptr(), node.data_ptr(), cf.data_ptr(),
            _lib.pointer_array(x for w in layer_ws for x in w),
            _lib.pointer_array(transposed),
            _lib.pointer_array(x for cw in center_ws for x in cw),
            g_edge.data_ptr(), g_node.data_ptr(), d_edges.data_ptr(), d_node.data_ptr(),
            d_cf.data_ptr(), _lib.ptr(escr), _lib.ptr(dscr), nbuf, vecs.data_ptr(),
            _lib.ptr(rows), _lib.ptr(partials), blocks, _lib.ptr(dw),
            A, L, M, D, num_heads, F, Nn, int(expanded), float(scale), rmsnorm_eps(cd),
            _lib.stream_ptr(dev),
        ),
        name,
    )
    _lib.LAUNCHES[name] += 1
    if not weight_grads:
        return d_edges, d_node, d_cf
    parts = torch.split(dw, sizes)
    return d_edges, d_node, d_cf, [p.view(x.shape) for p, x in zip(parts, cuda_flat)]


def _first_backward(edges, node, cf, flat_w, g_edge, g_node, num_heads, scale, n_layers,
                    expanded, weight_grads):
    """The block's backward kernel on the card, :func:`gnn_block_bwd_math`
    on the CPU."""
    if edges.is_cuda:
        return gnn_block_bwd_cuda(edges, node, cf, flat_w, g_edge, g_node, num_heads, scale,
                                  n_layers, expanded, weight_grads)
    layer_ws, center_ws = unflatten_gnn_weights(flat_w, n_layers, expanded)
    return gnn_block_bwd_math(edges, node, cf, layer_ws, center_ws, g_edge, g_node, num_heads,
                              scale, expanded, weight_grads)


def replay_gnn_block_bwd(inputs, flat_w, cotangents, ct_dw, num_heads, scale, n_layers,
                         expanded, chunk):
    """The vector-Jacobian product of :func:`gnn_block_bwd_math`, replayed
    under autograd over chunks of ``chunk`` atoms (the block's
    ``_chunked_replay_bwd``; the last chunk is short, no padded windows).

    :param inputs: ``(edges, node, cf, g_edge, g_node)``.
    :param cotangents: cotangents of ``(d_edges, d_node, d_cf)``, each
        ``None`` where the output has none.
    :param ct_dw: cotangents of the weight gradients (one per weight of
        ``flat_w``, ``None`` entries allowed), or ``None``: then the replay
        skips the weight-gradient products.
    :return: the cotangents of the five inputs and of the weights.
    """
    _lib.REPLAYS["gnn_block"] += 1

    def math(xs, ws, weight_grads):
        layer_ws, center_ws = unflatten_gnn_weights(ws, n_layers, expanded)
        return gnn_block_bwd_math(xs[0], xs[1], xs[2], layer_ws, center_ws, xs[3], xs[4],
                                  num_heads, scale, expanded, weight_grads)

    return chunked_replay(math, inputs, flat_w, cotangents, ct_dw, chunk)


class _GnnBlockBwd(torch.autograd.Function):
    """The block's first backward as a function of its own: forward is the
    backward kernel (its weight-gradient variant with ``weight_grads``; the
    plain version on the CPU), backward the chunked replay."""

    @staticmethod
    def forward(ctx, edges, node, cf, g_edge, g_node, num_heads, scale, n_layers, expanded, chunk,
                weight_grads, *flat_w):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(edges, node, cf, g_edge, g_node, *flat_w)
        ctx.args = (num_heads, scale, n_layers, expanded)
        ctx.chunk, ctx.weight_grads = chunk, weight_grads
        out = _first_backward(edges, node, cf, flat_w, g_edge, g_node, num_heads, scale,
                              n_layers, expanded, weight_grads)
        return (*out[:3], *out[3]) if weight_grads else out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct_edges, ct_node, ct_cf, *ct_dw):
        edges, node, cf, g_edge, g_node, *flat_w = ctx.saved_tensors
        d_inputs, d_w = replay_gnn_block_bwd(
            (edges, node, cf, g_edge, g_node), flat_w, (ct_edges, ct_node, ct_cf),
            ct_dw if ctx.weight_grads else None, *ctx.args, ctx.chunk,
        )
        needs = ctx.needs_input_grad
        d_inputs = [d if needs[i] else None for i, d in enumerate(d_inputs)]
        d_w = [d.to(x.dtype) if needs[11 + i] else None
               for i, (d, x) in enumerate(zip(d_w, flat_w))]
        return (*d_inputs, None, None, None, None, None, None, *d_w)


class _GnnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edges, node, cf, num_heads, scale, n_layers, expanded, chunk, *flat_w):
        ctx.save_for_backward(edges, node, cf, *flat_w)
        ctx.args = (num_heads, scale, n_layers, expanded, chunk)
        if edges.is_cuda:
            return gnn_block_fwd_cuda(edges, node, cf, flat_w, num_heads, scale, n_layers,
                                      expanded)
        layer_ws, center_ws = unflatten_gnn_weights(flat_w, n_layers, expanded)
        return gnn_block_math(edges, node, cf, layer_ws, center_ws, num_heads, scale, expanded)

    @staticmethod
    def backward(ctx, g_edge, g_node):
        edges, node, cf, *flat_w = ctx.saved_tensors
        # as _FusedLayer.backward: the weight gradients come with the first
        # backward whenever a weight requires grad
        weight_grads = any(ctx.needs_input_grad[8:])
        out = _GnnBlockBwd.apply(
            edges, node, cf, g_edge.to(edges.dtype).contiguous(),
            g_node.to(node.dtype).contiguous(), *ctx.args, weight_grads, *flat_w,
        )
        d_edges, d_node, d_cf = out[:3]
        d_w = ([d.to(x.dtype) for d, x in zip(out[3:], flat_w)] if weight_grads
               else [None] * len(flat_w))
        return (d_edges, d_node.to(node.dtype), d_cf.to(cf.dtype), None, None, None, None, None,
                *d_w)


def fused_gnn_block(edges, node, cf, flat_w, num_heads: int, scale: float, n_layers: int,
                    expanded: bool, chunk: int = 1024):
    """The block with its hand-written backward: ``(edge_out, node_out)``.
    CPU tensors run :func:`gnn_block_math` / :func:`gnn_block_bwd_math`;
    CUDA tensors launch the block's kernels (the weight-gradient variant of
    the backward when a weight requires grad). ``chunk`` is the number of
    atoms per step of the second-order replay."""
    return _GnnBlock.apply(edges, node, cf, num_heads, scale, n_layers, expanded, chunk, *flat_w)
