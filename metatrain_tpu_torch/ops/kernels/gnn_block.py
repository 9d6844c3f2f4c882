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
- The Hopper GNN block: bfloat16 at the served shapes where no weight
  requires grad (:func:`_lib.gnn_sm90_takes`), the block is a fixed
  sequence of launches instead (:func:`block_forward`,
  :func:`block_backward`): each attention layer on the Hopper K1 / K2
  (``csrc/fused_layer_{fwd,bwd}_sm90.cu``) and, with the expansion, the
  node stream between them on ``csrc/gnn_node_sm90.cu``
  (:func:`gnn_node_fwd_cuda`, :func:`gnn_node_bwd_cuda`; plain versions
  :func:`node_stream_fwd_math`, :func:`node_stream_bwd_math`). The
  backward recomputes the forward by running the same sequence.

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
    _k1_sm90,
    _k2_sm90,
    _matmul_bias,
    _rms_stats,
    accumulation_dtype,
    check_layer_shapes,
    chunked_replay,
    k1_sm90_w_vg,
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


def _center_backward(d_n, extras, wa: CenterWeights, cd):
    """The node update's backward from ``d_n`` (the cotangent of its output,
    in the accumulation dtype), given ``_center_forward``'s intermediates
    and the weights ``wa`` in the accumulation dtype: ``(d_n_cd, d_vg, d_hn,
    d_nmid, d_cattn)``, each cotangent rounded to ``cd`` where the JAX
    package's ``_gnn_block_bwd_math`` rounds it."""
    acc = wa.w_exp.dtype
    _, x2, r2, _, v, sig, _, _ = extras
    # node' = n_mid + h w_out_c + b_out_c, h = v sig(g), [v | g] = hn w_in_c + b_in_c
    d_n_cd = d_n.to(cd)
    d_h = d_n_cd.to(acc) @ wa.w_out_c.T
    d_vg = torch.cat([d_h * sig, d_h * v * sig * (1.0 - sig)], dim=-1).to(cd)
    d_hn = d_vg.to(acc) @ wa.w_in_c.T
    gs = d_hn * (r2 * wa.norm_c)
    N = x2.shape[-1]
    d_nmid = d_n + (gs - x2 * (r2 * r2 * torch.sum(gs * x2, dim=-1, keepdim=True) / N))
    d_cattn = (d_nmid.to(cd).to(acc) @ wa.w_exp.T).to(cd)
    return d_n_cd, d_vg, d_hn, d_nmid, d_cattn


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
            d_n_cd, d_vg, d_hn, d_nmid, d_cattn = _center_backward(d_n, extras, wa, cd)
            d_nmid_cd = d_nmid.to(cd)
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
# The Hopper block: a fixed sequence of launches
# ---------------------------------------------------------------------------


def node_stream_fwd_math(node, cattn, cw, cw_next):
    """Plain version of the node-stream forward kernel at one layer
    boundary: ``(node_out, center)``. With ``cw`` (the layer's
    :class:`CenterWeights`) the update of ``node`` by the layer's center
    attention output ``cattn`` (else ``node_out`` is ``None``); with
    ``cw_next`` the next layer's contraction of the updated node (of
    ``node`` without ``cw``; else ``center`` is ``None``)."""
    cd = node.dtype
    if cw is not None:
        node = center_update(node, cattn, cw, cd)
    center = (None if cw_next is None else
              _matmul_bias(node, cw_next.w_contr.to(cd), cw_next.b_contr.to(cd), cd))
    return (node if cw is not None else None), center


def node_stream_bwd_math(node, cattn, dn, d_center, cw_con, cw):
    """Plain version of the node-stream backward kernel at one layer
    boundary. ``d_n = dn`` (the cotangent of the node features out of the
    layer, accumulated in float32, float64 for float64 inputs), plus with
    ``d_center`` the contraction's backward of the layer above,
    ``d_center w_contr^T`` (``cw_con`` that layer's weights). With ``cw``
    (the layer's, ``node`` and ``cattn`` its inputs) the node update's
    backward: ``(d_cattn, d_nmid)``, d_nmid in the accumulation dtype; else
    ``d_node``, d_n in the compute dtype."""
    cd = node.dtype if cw is not None else d_center.dtype
    acc = accumulation_dtype(cd)
    d_n = dn.to(acc)
    if d_center is not None:
        d_n = d_n + d_center.to(acc) @ cw_con.w_contr.to(cd).to(acc).T
    if cw is None:
        return d_n.to(cd)
    wc = CenterWeights(*(x.to(cd) for x in cw))
    extras = _center_forward(node, cattn, wc, cd)
    _, _, _, d_nmid, d_cattn = _center_backward(
        d_n, extras, CenterWeights(*(x.to(acc) for x in wc)), cd)
    return d_cattn, d_nmid


class BlockPieces(NamedTuple):
    """The launches of the Hopper block's sequence, or their plain
    versions: ``k1(edges, center, cf, w) -> (edge_out, cattn)``,
    ``k2(edges, center, cf, w, g_edge, g_center) -> (d_edges, d_center,
    d_cf)``, ``node_fwd`` and ``node_bwd`` as :func:`node_stream_fwd_math`
    and :func:`node_stream_bwd_math`."""

    k1: object
    k2: object
    node_fwd: object
    node_bwd: object


def plain_pieces(num_heads: int, scale: float) -> BlockPieces:
    """The plain versions of the sequence's launches: :func:`layer_math`,
    :func:`layer_bwd_math` and the node stream's."""
    return BlockPieces(
        k1=lambda e, c, cf, w: layer_math(e, c, cf, w, num_heads, scale),
        k2=lambda e, c, cf, w, ge, gc: layer_bwd_math(e, c, cf, w, ge, gc, num_heads, scale),
        node_fwd=node_stream_fwd_math,
        node_bwd=node_stream_bwd_math,
    )


def block_forward(edges, node, cf, layer_ws, center_ws, expanded: bool, pieces: BlockPieces,
                  trace=None, final: bool = True):
    """The Hopper block's forward as its sequence of launches: with the
    expansion the first contraction, then per layer the layer (``k1``) and
    the node stream to the next layer's center; ``(edge_out, node_out)``.

    :param center_ws: what ``pieces.node_*`` take for each layer's node
        weights (:class:`CenterWeights`, or the kernels'
        :class:`NodeWeights`); unused without the expansion.
    :param trace: a list that receives each layer's ``(edges, node,
        center, cattn)`` as the sequence computed them.
    :param final: ``False`` skips the last layer's node update (the
        backward's recompute reads no node past the last layer);
        ``node_out`` is then ``None`` with the expansion.
    """
    n_layers = len(layer_ws)
    center = pieces.node_fwd(node, None, None, center_ws[0])[1] if expanded else node
    for i, w in enumerate(layer_ws):
        e_next, cattn = pieces.k1(edges, center, cf, w)
        if trace is not None:
            trace.append((edges, node, center, cattn))
        if not expanded:
            node = center = cattn
        elif i + 1 < n_layers:
            node, center = pieces.node_fwd(node, cattn, center_ws[i], center_ws[i + 1])
        else:
            node = pieces.node_fwd(node, cattn, center_ws[i], None)[0] if final else None
        edges = e_next
    return edges, node


def block_backward(edges, node, cf, layer_ws, center_ws, g_edge, g_node, expanded: bool,
                   pieces: BlockPieces, trace=None):
    """The Hopper block's input-gradient backward as its sequence of
    launches: ``(d_edges, d_node, d_cf)``. The forward is recomputed by
    :func:`block_forward` itself, saving each layer's inputs; then, last
    layer first, the node stream's backward (with the contraction's backward
    of the layer above), the layer's (``k2``), and d_cf summed over the
    layers in float32 (float64 for float64 inputs), last layer first; the
    first contraction's backward gives d_node. ``trace`` receives the
    recompute's per-layer values as :func:`block_forward`'s does."""
    saved = [] if trace is None else trace
    block_forward(edges, node, cf, layer_ws, center_ws, expanded, pieces, saved, final=False)
    d_e, d_cf, dn, d_center = g_edge, None, g_node, None
    for i in reversed(range(len(layer_ws))):
        e_in, n_in, center, cattn = saved[i]
        if expanded:
            d_cattn, dn = pieces.node_bwd(n_in, cattn, dn, d_center,
                                          None if d_center is None else center_ws[i + 1],
                                          center_ws[i])
        else:
            d_cattn = dn
        d_e, d_center, d_cf_l = pieces.k2(e_in, center, cf, layer_ws[i], d_e, d_cattn)
        d_cf = d_cf_l if d_cf is None else d_cf + d_cf_l
        if not expanded:
            dn = d_center
    d_node = pieces.node_bwd(None, None, dn, d_center, center_ws[0], None) if expanded else dn
    return d_e, d_node, d_cf


class NodeWeights(NamedTuple):
    """One layer's node-stream weights as ``csrc/gnn_node_sm90.cu`` reads
    them (bfloat16, contiguous): the forward's matrices as (out, in) row-major
    (w_contr^T, w_exp^T, w_out_c^T, and w_vg: w_in_c^T with its rows in
    blocks of 128, value columns 128 i .. 128 i + 127 then the same gate
    columns, so that a 128-column hidden tile's value chunks and gate chunks
    follow each other in the weight stream), the backward's as they are,
    the vectors as they are."""

    w_contr_t: torch.Tensor  # (D, N)
    b_contr: torch.Tensor  # (D,)
    w_exp_t: torch.Tensor  # (N, D)
    b_exp: torch.Tensor  # (N,)
    norm_c: torch.Tensor  # (N,)
    w_vg: torch.Tensor  # (4N, N)
    b_in_c: torch.Tensor  # (4N,)
    w_out_t: torch.Tensor  # (N, 2N)
    b_out_c: torch.Tensor  # (N,)
    w_contr: torch.Tensor  # (N, D)
    w_exp: torch.Tensor  # (D, N)
    w_in_c: torch.Tensor  # (N, 4N)
    w_out_c: torch.Tensor  # (2N, N)


def node_sm90_weights(cw: CenterWeights) -> NodeWeights:
    """The kernels' arrangement of one layer's :class:`CenterWeights`
    (cast to bfloat16)."""
    cw = CenterWeights(*(_cuda_tensor(x, torch.bfloat16) for x in cw))
    return NodeWeights(
        w_contr_t=cw.w_contr.t().contiguous(), b_contr=cw.b_contr,
        w_exp_t=cw.w_exp.t().contiguous(), b_exp=cw.b_exp, norm_c=cw.norm_c,
        w_vg=k1_sm90_w_vg(cw.w_in_c, block=128), b_in_c=cw.b_in_c,
        w_out_t=cw.w_out_c.t().contiguous(), b_out_c=cw.b_out_c,
        w_contr=cw.w_contr, w_exp=cw.w_exp, w_in_c=cw.w_in_c, w_out_c=cw.w_out_c,
    )


def _node_check(tensors: dict, N: int, D: int, device) -> None:
    if not _lib.gnn_node_sm90_shape(N, D):
        raise ValueError(f"the Hopper node-stream kernels take D = 128 and N = 128 or 256, got "
                         f"N={N}, D={D}")
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _lib.require(tensors, device, torch.bfloat16)


def gnn_node_fwd_cuda(node, cattn, nw: NodeWeights, nw_next: NodeWeights):
    """Launch the node-stream forward kernel (``csrc/gnn_node_sm90.cu``,
    counter ``gnn_node_fwd_sm90``) as :func:`node_stream_fwd_math`: with
    ``nw`` the layer's update of ``node`` (A, N) by ``cattn`` (A, D), with
    ``nw_next`` the next layer's contraction; bfloat16 tensors on the card,
    the weights as :func:`node_sm90_weights` gives them."""
    A, N = node.shape
    w = nw if nw is not None else nw_next
    D = w.w_exp_t.shape[1]
    tensors = {"node": node, "cattn": cattn, **{f"w.{k}": v for k, v in w._asdict().items()}}
    if nw is not None and nw_next is not None:
        tensors.update({f"next.{k}": v for k, v in nw_next._asdict().items()})
    _node_check(tensors, N, D, node.device)
    if nw is not None and cattn.shape != (A, D):
        raise ValueError(f"cattn {tuple(cattn.shape)} does not fit node {tuple(node.shape)}")
    lib = _lib.library()
    _lib.check_shared(lib.mtt_gnn_node_sm90_smem(N, D, 0), "gnn_node_fwd_sm90")
    node_out = torch.empty_like(node) if nw is not None else None
    center = (torch.empty((A, D), dtype=node.dtype, device=node.device) if nw_next is not None
              else None)
    upd = (nw.w_exp_t, nw.b_exp, nw.norm_c, nw.w_vg, nw.b_in_c, nw.w_out_t, nw.b_out_c) if (
        nw is not None) else (None,) * 7
    con = (nw_next.w_contr_t, nw_next.b_contr) if nw_next is not None else (None, None)
    _lib.check(
        lib.mtt_gnn_node_fwd_sm90(
            node.data_ptr(), _lib.ptr(cattn if nw is not None else None),
            *(_lib.ptr(x) for x in upd + con), _lib.ptr(node_out), _lib.ptr(center),
            A, N, D, rmsnorm_eps(torch.bfloat16), _lib.stream_ptr(node.device)),
        "gnn_node_fwd_sm90",
    )
    _lib.LAUNCHES["gnn_node_fwd_sm90"] += 1
    return node_out, center


def gnn_node_bwd_cuda(node, cattn, dn, d_center, nw_con: NodeWeights, nw: NodeWeights):
    """Launch the node-stream backward kernel (``csrc/gnn_node_sm90.cu``,
    counter ``gnn_node_bwd_sm90``) as :func:`node_stream_bwd_math`: ``dn``
    (A, N) float32 or bfloat16, the rest bfloat16 on the card; with
    ``d_center`` (A, D) the contraction's backward of the layer above
    (``nw_con``), with ``nw`` the layer's update's backward, ``(d_cattn,
    d_nmid)`` with d_nmid float32; else ``d_node`` (bfloat16)."""
    A, N = dn.shape
    D = (nw if nw is not None else nw_con).w_exp.shape[0]
    tensors = {"d_center": d_center}
    if nw is not None:
        tensors.update({"node": node, "cattn": cattn,
                        **{f"w.{k}": v for k, v in nw._asdict().items()}})
    if d_center is not None:
        tensors["w_contr"] = nw_con.w_contr
    _node_check(tensors, N, D, dn.device)
    if dn.dtype not in (torch.float32, torch.bfloat16) or not dn.is_contiguous() or (
            dn.data_ptr() % 16):
        raise ValueError("dn must be a contiguous, 16-byte aligned float32 or bfloat16 tensor")
    lib = _lib.library()
    _lib.check_shared(lib.mtt_gnn_node_sm90_smem(N, D, 1), "gnn_node_bwd_sm90")
    dev = dn.device
    d_cattn = d_nmid = d_node = None
    if nw is not None:
        d_cattn = torch.empty((A, D), dtype=torch.bfloat16, device=dev)
        d_nmid = torch.empty((A, N), dtype=torch.float32, device=dev)
        weights = (nw.w_exp_t, nw.b_exp, nw.norm_c, nw.w_vg, nw.b_in_c, nw.w_out_c, nw.w_in_c,
                   nw.w_exp)
    else:
        d_node = torch.empty((A, N), dtype=torch.bfloat16, device=dev)
        weights = (None,) * 8
    f32 = dn.dtype == torch.float32
    _lib.check(
        lib.mtt_gnn_node_bwd_sm90(
            _lib.ptr(node if nw is not None else None), _lib.ptr(cattn if nw is not None else None),
            dn.data_ptr() if f32 else None, None if f32 else dn.data_ptr(), _lib.ptr(d_center),
            _lib.ptr(nw_con.w_contr if d_center is not None else None),
            *(_lib.ptr(x) for x in weights), _lib.ptr(d_cattn), _lib.ptr(d_nmid),
            _lib.ptr(d_node), A, N, D, rmsnorm_eps(torch.bfloat16), _lib.stream_ptr(dev)),
        "gnn_node_bwd_sm90",
    )
    _lib.LAUNCHES["gnn_node_bwd_sm90"] += 1
    return (d_cattn, d_nmid) if nw is not None else d_node


def sm90_pieces(num_heads: int, scale: float) -> BlockPieces:
    """The Hopper block's launches: the Hopper K1 and K2 (layer weights in
    bfloat16 on the card) and the node-stream kernels (:class:`NodeWeights`)."""
    return BlockPieces(
        k1=lambda e, c, cf, w: _k1_sm90(e, c, cf, w, num_heads, scale),
        k2=lambda e, c, cf, w, ge, gc: _k2_sm90(e, c, cf, w, ge, gc, num_heads, scale),
        node_fwd=gnn_node_fwd_cuda,
        node_bwd=gnn_node_bwd_cuda,
    )


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


def _aligned(x):
    """``x``, or a copy of it where it does not start on 16 bytes (the node
    streams read it in pairs or 16-byte pieces)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _cuda_tensor(x, cd):
    """``x`` in the compute dtype, contiguous and 16-byte aligned."""
    return _aligned(x.detach().to(cd).contiguous())


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


def gnn_block_fwd_cuda(edges, node, cf, flat_w, num_heads, scale, n_layers, expanded, *,
                       sm90: bool = True, weight_grads: bool = False, trace=None):
    """Launch the block's forward. ``edges``/``node`` float32 or bfloat16
    (the same), ``cf`` float32.

    Where :func:`_lib.gnn_sm90_takes` says so (bfloat16 at the served shapes,
    no weight requiring grad: ``weight_grads``) the Hopper block runs, a
    sequence of launches (:func:`block_forward` with :func:`sm90_pieces`;
    ``trace`` receives its per-layer values); ``sm90=False`` keeps the
    general kernel ``csrc/gnn_block_fwd.cu`` there too, for comparisons."""
    cd = edges.dtype
    code = _lib.dtype_code(cd)
    layer_ws, center_ws = _cuda_weights(flat_w, n_layers, expanded, cd)
    A, M, D, F, Nn = _check_shapes(edges, node, cf, layer_ws, center_ws, num_heads, expanded)
    _require(edges, node, cf, layer_ws, center_ws)
    if sm90 and _lib.gnn_sm90_takes(cd, M, D, num_heads, F, Nn, expanded, weight_grads):
        _lib.CALLS["gnn_block_fwd_sm90"] += 1
        return block_forward(edges, _aligned(node), cf, layer_ws,
                             [node_sm90_weights(cw) for cw in center_ws], expanded,
                             sm90_pieces(num_heads, scale), trace)
    lib = _lib.library()
    _, ws_floats = _lib.plan_query(lib.mtt_gnn_block_fwd_smem, M, D, F, Nn)
    grid = _lib.layer_grid(A, ws_floats, edges.device)
    ws = _lib.workspace(grid, ws_floats, edges.device)
    edge_out = torch.empty_like(edges)
    node_out = torch.empty_like(node)
    _lib.check(
        lib.mtt_gnn_block_fwd(
            code, edges.data_ptr(), node.data_ptr(), cf.data_ptr(),
            _lib.pointer_array(x for w in layer_ws for x in w),
            _lib.pointer_array(x for cw in center_ws for x in cw),
            edge_out.data_ptr(), node_out.data_ptr(),
            A, n_layers, M, D, num_heads, F, Nn, int(expanded), float(scale), rmsnorm_eps(cd),
            grid, _lib.ptr(ws), _lib.stream_ptr(edges.device),
        ),
        "gnn_block_fwd",
    )
    _lib.LAUNCHES["gnn_block_fwd"] += 1
    return edge_out, node_out


def gnn_block_bwd_cuda(edges, node, cf, flat_w, g_edge, g_node, num_heads, scale, n_layers,
                       expanded, weight_grads: bool = False, *, sm90: bool = True, trace=None):
    """Launch the block's backward: ``(d_edges, d_node, d_cf)`` with
    ``d_cf`` float32.

    Where :func:`_lib.gnn_sm90_takes` says so (bfloat16 at the served
    shapes, without ``weight_grads``) the Hopper block's backward runs
    (:func:`block_backward` with :func:`sm90_pieces`, the forward recomputed
    by the forward's own sequence; ``trace`` receives the recompute's
    per-layer values); ``sm90=False`` keeps the general kernel
    ``csrc/gnn_block_bwd.cu`` there too.

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
    if sm90 and _lib.gnn_sm90_takes(cd, M, D, num_heads, F, Nn, expanded, weight_grads):
        _lib.CALLS["gnn_block_bwd_sm90"] += 1
        return block_backward(edges, _aligned(node), cf, layer_ws,
                              [node_sm90_weights(cw) for cw in center_ws], g_edge,
                              _aligned(g_node), expanded, sm90_pieces(num_heads, scale), trace)
    transposed = [x.t().contiguous() for w in layer_ws
                  for x in (w.w_qkv, w.w_out, w.w_in, w.w_ffn_out)]
    name = "gnn_block_bwd_dw" if weight_grads else "gnn_block_bwd"
    lib = _lib.library()
    _, ws_floats = _lib.plan_query(lib.mtt_gnn_block_bwd_smem, M, D, num_heads, F, Nn,
                                   int(weight_grads))
    dev = edges.device
    grid = _lib.dw_blocks(A, dev) if weight_grads else _lib.layer_grid(A, ws_floats, dev)
    ws = _lib.workspace(grid, ws_floats, dev)
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
    if weight_grads:
        sizes = [x.numel() for x in cuda_flat]
        per_layer = sum(x.numel() for x in layer_ws[0])
        partials = torch.empty((grid, L * per_layer), dtype=torch.float32, device=dev)
        dw = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    _lib.check(
        lib.mtt_gnn_block_bwd(
            code, edges.data_ptr(), node.data_ptr(), cf.data_ptr(),
            _lib.pointer_array(x for w in layer_ws for x in w),
            _lib.pointer_array(transposed),
            _lib.pointer_array(x for cw in center_ws for x in cw),
            g_edge.data_ptr(), g_node.data_ptr(), d_edges.data_ptr(), d_node.data_ptr(),
            d_cf.data_ptr(), _lib.ptr(escr), _lib.ptr(dscr), nbuf, vecs.data_ptr(),
            _lib.ptr(rows), _lib.ptr(partials), _lib.ptr(dw),
            A, L, M, D, num_heads, F, Nn, int(expanded), float(scale), rmsnorm_eps(cd),
            grid, _lib.ptr(ws), _lib.stream_ptr(dev),
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
            # the backward takes the weight-gradient variant whenever a
            # weight requires grad: the forward then keeps the general body
            return gnn_block_fwd_cuda(edges, node, cf, flat_w, num_heads, scale, n_layers,
                                      expanded, weight_grads=any(ctx.needs_input_grad[8:]))
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
