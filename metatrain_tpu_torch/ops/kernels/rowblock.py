"""Row-block stages: CUDA kernels K3/K4 behind one ``autograd.Function``.

Counterpart of ``metatrain_tpu/ops/pallas/rowblock.py``. PET's compress,
combination and head stages each apply a small MLP to every row of a
(rows, ...) array. A :class:`Stage` names one of them and carries its
plain PyTorch versions (``models/pet/fused_stages.py``):
``math(inputs, weights) -> out`` and ``bwd(inputs, weights, g,
weight_grads=False) -> (*d_inputs, *d_weights)`` (the weight gradients,
summed over rows, only with ``weight_grads=True``). :func:`rowblock` runs
a stage with its hand-written backward: on the CPU through those plain
versions, on the card through K3 (``csrc/rowblock_fwd.cu``) and K4
(``csrc/rowblock_bwd.cu``), one templated kernel instantiated per stage;
K4-dW, its weight-gradient variant, runs when a weight requires grad. The
bfloat16 compress, combination and head at d_part 128 (every served bf16
call's) run the Hopper kernels: the forward the Hopper K3
(``csrc/rowblock_fwd_sm90.cu``, ``_lib.k3_sm90_takes``: only where no
weight requires grad, so a training step keeps the general K3), the
backward the Hopper K4 (``csrc/rowblock_bwd_sm90.cu``,
``_lib.k4_sm90_takes``). Both share ``csrc/rowblock_sm90.cuh``: the
streamed row tiles, the combination's LayerNorm and the head's forward
up to pre1 (its weights resident in shared memory), so the served
forward's xn and h and the backward's recompute round alike. The float32
compress, combination and head at d_part 128 run the Hopper float32 K3
and K4 (``csrc/rowblock_fwd_f32_sm90.cu``, ``_lib.k3_f32_sm90_takes``, and
``csrc/rowblock_bwd_f32_sm90.cu``, ``_lib.k4_f32_sm90_takes``; 3xTF32 on
the tensor cores), with or without weight gradients. Both run the
forward up to h (the head's up to pre1) from
``csrc/rowblock_f32_sm90.cuh``, so the f32 K4's recompute is K3's forward
bit for bit. Without weight gradients the backward is K4, with them the
two-pass K4-dW, its spill mode followed by K2-dW's split-K product
(``csrc/layer_dw_sm90.cuh``);
:func:`rowblock_dw_operands` and :func:`rowblock_dw_from_operands` are the
two passes' plain versions.
The backward is differentiable again (training with forces): its
gradient replays ``stage.bwd`` under autograd, as the JAX package's
``bwd_op_bwd`` differentiates ``_bwd_math_reference``.

Weights keep the JAX package's (in, out) layout and are cast to the
compute dtype (the dtype of ``inputs[0]``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Sequence

import torch

from . import _lib


# kernel instantiations (the ``stage`` argument of the C entry points)
COMPRESS_CODE, COMBINATION_CODE, HEAD_CODE = 0, 1, 2


class Stage(NamedTuple):
    """A row-block stage: its kernel instantiation ``code``, its plain
    forward/backward and, where the two-pass K4-dW takes it, ``operands(inputs,
    weights, g) -> (input cotangents, spilled rows, rows of the vector sums)``,
    the plain version of that first pass per row."""

    name: str
    code: int
    math: Callable
    bwd: Callable
    operands: Callable = None


def _split_weights(stage: Stage, weights):
    if stage.code == COMBINATION_CODE:
        ln_scale, ln_bias, w0, b0, w1, b1 = weights
        return (ln_scale, ln_bias), (w0, b0, w1, b1)
    return (None, None), tuple(weights)


def _launch_geometry(stage: Stage, inputs, w0, w1):
    rows, d_part = inputs[0].shape
    for x in inputs:
        if x.shape != (rows, d_part):
            raise ValueError("row-block inputs must share one (rows, D) shape")
    if stage.code == COMBINATION_CODE and len(inputs) != 3:
        raise ValueError("combination takes (edges, reversed, messages)")
    if stage.code == HEAD_CODE and len(inputs) != 1:
        raise ValueError("head takes one input")
    n_in = 2 if stage.code == COMBINATION_CODE else len(inputs)
    w_in, w_hid = w0.shape
    w_out = w1.shape[1]
    if w_in != n_in * d_part or w1.shape[0] != w_hid:
        raise ValueError(f"weights {tuple(w0.shape)}, {tuple(w1.shape)} do not fit "
                         f"{n_in} inputs of width {d_part}")
    if stage.code == HEAD_CODE and w_out != w_hid:
        raise ValueError("head layers must share one width")
    if stage.code == COMBINATION_CODE and w_out != d_part:
        raise ValueError("combination output must have the edge width")
    # bfloat16 products run on the tensor cores in 16-wide tiles
    width = 16 if inputs[0].dtype == torch.bfloat16 else 4
    if (w_in % width) or (w_hid % width) or (w_out % width) or (d_part % 4):
        raise ValueError(f"row-block kernel widths must be multiples of {width}")
    return rows, d_part, w_in, w_hid, w_out


def _prepare(stage: Stage, inputs, weights):
    """Check shapes, devices and dtypes; returns the dtype code, the three
    input slots, the weights in the compute dtype and the geometry."""
    cd = inputs[0].dtype
    (ln_scale, ln_bias), (w0, b0, w1, b1) = _split_weights(stage, weights)
    geometry = _launch_geometry(stage, inputs, w0, w1)
    wc = [None if x is None else x.detach().to(cd).contiguous()
          for x in (ln_scale, ln_bias, w0, b0, w1, b1)]
    _lib.require({f"x{i}": x for i, x in enumerate(inputs)}, inputs[0].device, cd)
    _lib.require({f"w{i}": x for i, x in enumerate(wc)}, inputs[0].device, cd)
    parts = list(inputs) + [None] * (3 - len(inputs))
    return _lib.dtype_code(cd), parts, wc, geometry


def rowblock_fwd_cuda(stage: Stage, inputs: Sequence[torch.Tensor], weights, *,
                      weight_grads: bool = False, sm90: bool = True):
    """Launch K3 for ``stage``: returns the (rows, w_out) output. In
    bfloat16 the compress, combination and head stages at the widths of
    :func:`_lib.k3_sm90_takes` (d_part 128) launch the Hopper K3
    (``csrc/rowblock_fwd_sm90.cu``, counter ``rowblock_fwd_sm90[<stage>]``)
    unless ``weight_grads`` (a weight requires grad: the backward is then
    K4-dW, and the training step keeps the general K3). In float32 the
    compress, combination and head at the widths of
    :func:`_lib.k3_f32_sm90_takes` launch the Hopper float32 K3
    (``csrc/rowblock_fwd_f32_sm90.cu``, counter
    ``rowblock_fwd_f32_sm90[<stage>]``), with or without ``weight_grads``.
    ``sm90=False`` keeps the general body, for comparisons."""
    code, parts, (ln_s, ln_b, w0, b0, w1, b1), geometry = _prepare(stage, inputs, weights)
    rows, d_part, w_in, w_hid, w_out = geometry
    dtype = inputs[0].dtype
    if sm90 and (_lib.k3_sm90_takes(dtype, stage.code, d_part, w_in, w_hid, w_out, weight_grads)
                 or _lib.k3_f32_sm90_takes(dtype, stage.code, d_part, w_in, w_hid, w_out,
                                           weight_grads)):
        return _k3_sm90(stage, inputs, (ln_s, ln_b, w0, b0, w1, b1), geometry)
    lib = _lib.library()
    _lib.check_shared(lib.mtt_rowblock_fwd_smem(w_in, w_hid, None), "rowblock_fwd")
    out = torch.empty((rows, w_out), dtype=inputs[0].dtype, device=inputs[0].device)
    _lib.check(
        lib.mtt_rowblock_fwd(
            code, stage.code, *(_lib.ptr(x) for x in parts), len(inputs),
            *(_lib.ptr(x) for x in (ln_s, ln_b, w0, b0, w1, b1)), out.data_ptr(),
            rows, d_part, w_in, w_hid, w_out, _lib.stream_ptr(out.device),
        ),
        "rowblock_fwd",
    )
    _lib.LAUNCHES[f"rowblock_fwd[{stage.name}]"] += 1
    return out


def _k3_sm90(stage: Stage, inputs, weights, geometry):
    """The Hopper K3 on checked bfloat16 tensors, or the Hopper float32 K3
    on float32 ones (``weights`` = ln_scale, ln_bias, w0, b0, w1, b1 in the
    compute dtype; ln_scale and ln_bias None but for the combination): one
    persistent block per SM, no scratch. Their weights go in as w0^T and
    w1^T, the (N, K) layouts their products take; both take the same
    arguments."""
    rows, d_part, w_in, w_hid, w_out = geometry
    ln_s, ln_b, w0, b0, w1, b1 = weights
    kernel = "rowblock_fwd_f32_sm90" if inputs[0].dtype == torch.float32 else "rowblock_fwd_sm90"
    name = f"{kernel}[{stage.name}]"
    out = torch.empty((rows, w_out), dtype=inputs[0].dtype, device=inputs[0].device)
    if rows == 0:
        return out
    if any(x.data_ptr() % 16 for x in inputs):
        raise ValueError(f"{name} copies rows in 16-byte pieces: its inputs must start on 16 bytes")
    lib = _lib.library()
    _lib.check_shared(getattr(lib, f"mtt_{kernel}_smem")(stage.code, d_part, w_in, w_hid, w_out), name)
    w0_t, w1_t = w0.t().contiguous(), w1.t().contiguous()  # held here until the launch
    _lib.check(
        getattr(lib, f"mtt_{kernel}")(
            stage.code, *(x.data_ptr() for x in inputs), *[None] * (3 - len(inputs)),
            len(inputs), _lib.ptr(ln_s), _lib.ptr(ln_b), w0_t.data_ptr(), b0.data_ptr(),
            w1_t.data_ptr(), b1.data_ptr(), out.data_ptr(), rows, d_part, w_in, w_hid, w_out,
            _lib.dw_blocks(-(-rows // 64), out.device), _lib.stream_ptr(out.device),
        ),
        name,
    )
    _lib.LAUNCHES[name] += 1
    return out


def rowblock_bwd_cuda(stage: Stage, inputs: Sequence[torch.Tensor], weights, g,
                      weight_grads: bool = False, *, sm90: bool = True):
    """Launch K4 for ``stage``: returns the input cotangents (for the
    combination, the messages' cotangent is ``g`` itself). In bfloat16
    without weight gradients the compress, combination and head stages at
    the widths of :func:`_lib.k4_sm90_takes` (d_part 128) launch the Hopper K4
    (``csrc/rowblock_bwd_sm90.cu``, counter ``rowblock_bwd_sm90[<stage>]``);
    ``sm90=False`` keeps the general body there too, for comparisons. With
    ``weight_grads=True`` launch K4-dW, which also returns the float32
    weight gradients summed over rows, in the order of ``weights``: one
    block per SM over a contiguous range of 64-row tiles, each block
    summing into its own float32 partial, then a second pass that adds the
    partials in block order (the same sum in every run). Tiles are 64 rows,
    or 32 or 16 for stages too wide for 64 (``_lib.rowblock_bwd_rows``). In
    float32 the compress, combination and head at the widths of
    :func:`_lib.k4_f32_sm90_takes` launch the Hopper float32 K4 instead
    (counter ``rowblock_bwd_f32_sm90[<stage>]``), and with ``weight_grads``
    the two-pass K4-dW (``rowblock_bwd_dw_f32_sm90[<stage>]`` and
    ``rowblock_dw_product``); ``sm90=False`` keeps the general body."""
    code, parts, (ln_s, ln_b, w0, b0, w1, b1), geometry = _prepare(stage, inputs, weights)
    rows, d_part, w_in, w_hid, w_out = geometry
    _lib.require({"g": g}, g.device, inputs[0].dtype)
    if g.shape != (rows, w_out):
        raise ValueError(f"cotangent {tuple(g.shape)} != output {(rows, w_out)}")
    if sm90 and _lib.k4_sm90_takes(inputs[0].dtype, stage.code, d_part, w_in, w_hid, w_out,
                                   weight_grads):
        return _k4_sm90(stage, inputs, (ln_s, ln_b, w0, b0, w1, b1), g, geometry)
    if sm90 and _lib.k4_f32_sm90_takes(inputs[0].dtype, stage.code, d_part, w_in, w_hid, w_out,
                                       weight_grads):
        return _k4_f32_sm90(stage, inputs, weights, (ln_s, ln_b, w0, b0, w1, b1), g, geometry,
                            weight_grads)
    name = f"rowblock_bwd{'_dw' if weight_grads else ''}[{stage.name}]"
    lib = _lib.library()
    tile = ctypes.c_int(0)
    _lib.check_shared(lib.mtt_rowblock_bwd_smem(stage.code, w_in, w_hid, w_out,
                                                int(weight_grads), ctypes.byref(tile)), name)
    n_grads = 2 if stage.code == COMBINATION_CODE else len(inputs)
    d = [torch.empty_like(inputs[i]) for i in range(n_grads)]
    w0_t, w1_t = w0.t().contiguous(), w1.t().contiguous()
    d_ptrs = [x.data_ptr() for x in d] + [None] * (3 - n_grads)
    partials = dw = None
    blocks = 0
    if weight_grads:
        shapes = [tuple(x.shape) for x in weights]
        sizes = [x.numel() for x in weights]
        blocks = _lib.dw_blocks(-(-rows // tile.value), g.device)
        partials = torch.empty((blocks, sum(sizes)), dtype=torch.float32, device=g.device)
        dw = torch.empty(sum(sizes), dtype=torch.float32, device=g.device)
    _lib.check(
        lib.mtt_rowblock_bwd(
            code, stage.code, *(_lib.ptr(x) for x in parts), len(inputs),
            *(_lib.ptr(x) for x in (ln_s, ln_b, w0, b0, w1, b1)),
            w0_t.data_ptr(), w1_t.data_ptr(),
            g.data_ptr(), *d_ptrs, _lib.ptr(partials), blocks, _lib.ptr(dw),
            rows, d_part, w_in, w_hid, w_out, _lib.stream_ptr(g.device),
        ),
        name,
    )
    _lib.LAUNCHES[name] += 1
    if stage.code == COMBINATION_CODE:
        d.append(g)
    if weight_grads:
        d.extend(p.view(s) for p, s in zip(torch.split(dw, sizes), shapes))
    return tuple(d)


def _k4_sm90(stage: Stage, inputs, weights, g, geometry, front_out=None):
    """The Hopper K4 on checked bfloat16 tensors (``weights`` = ln_scale,
    ln_bias, w0, b0, w1, b1 in the compute dtype; ln_scale and ln_bias None
    but for the combination): one persistent block per SM, no scratch. Its
    weights go in as w0^T (the forward product), w1 and w0 (the backward
    ones), and for the head also w1^T (its recompute of the second layer).
    ``front_out`` (the head only): a (rows, 128) bf16 tensor that receives
    the kernel's recomputed forward output."""
    rows, d_part, w_in, w_hid, w_out = geometry
    ln_s, ln_b, w0, b0, w1, b1 = weights
    name = f"rowblock_bwd_sm90[{stage.name}]"
    n_grads = _n_input_grads(stage, len(inputs))
    d = [torch.empty_like(inputs[i]) for i in range(n_grads)]
    if rows == 0:
        return (*d, g) if stage.code == COMBINATION_CODE else tuple(d)
    if any(x.data_ptr() % 16 for x in (*inputs[:n_grads], g)):
        raise ValueError(f"{name} copies rows in 16-byte pieces: its inputs must start on 16 bytes")
    lib = _lib.library()
    _lib.check_shared(lib.mtt_rowblock_bwd_sm90_smem(stage.code, d_part, w_in, w_hid, w_out), name)
    # held here until the launch
    w0_t = w0.t().contiguous()
    w1_t = w1.t().contiguous() if stage.code == HEAD_CODE else None
    _lib.check(
        lib.mtt_rowblock_bwd_sm90(
            stage.code, *(x.data_ptr() for x in inputs[:n_grads]), *[None] * (3 - n_grads),
            len(inputs), *(_lib.ptr(x) for x in (ln_s, ln_b, w0, b0, w1, b1, w0_t, w1_t)),
            g.data_ptr(), *(x.data_ptr() for x in d), *[None] * (3 - n_grads),
            _lib.ptr(front_out), rows, d_part, w_in, w_hid, w_out,
            _lib.dw_blocks(-(-rows // 64), g.device), _lib.stream_ptr(g.device),
        ),
        name,
    )
    _lib.LAUNCHES[name] += 1
    return (*d, g) if stage.code == COMBINATION_CODE else tuple(d)


def _k4_f32_sm90(stage: Stage, inputs, weights, wc, g, geometry, weight_grads):
    """The Hopper float32 K4 on checked float32 tensors (``wc`` = ln_scale,
    ln_bias, w0, b0, w1, b1, ln_scale and ln_bias None but for the
    combination): one persistent block per SM. Its weights go in as w0^T
    (the forward product), w1 and w0 (the backward ones), and for the head
    also w1^T and b1 (its recompute's pre1 product). With
    ``weight_grads`` the two-pass K4-dW: per chunk of :func:`_lib.k4dw_plan`
    the body's spill mode, then the split-K product; returns the input
    cotangents and then the float32 weight gradients in the order of
    ``weights``."""
    rows, d_part, w_in, w_hid, w_out = geometry
    ln_s, ln_b, w0, b0, w1, b1 = wc
    name = f"rowblock_bwd{'_dw' if weight_grads else ''}_f32_sm90[{stage.name}]"
    n_grads = _n_input_grads(stage, len(inputs))
    d = [torch.empty_like(inputs[i]) for i in range(n_grads)]
    tail = (g,) if stage.code == COMBINATION_CODE else ()
    shapes = [tuple(x.shape) for x in weights]
    if rows == 0:
        dw = tuple(torch.zeros(s, dtype=torch.float32, device=g.device) for s in shapes)
        return (*d, *tail, *(dw if weight_grads else ()))
    if any(x.data_ptr() % 16 for x in (*inputs[:n_grads], g)):
        raise ValueError(f"{name} copies rows in 16-byte pieces: its inputs must start on 16 bytes")
    lib = _lib.library()
    _lib.check_shared(lib.mtt_rowblock_bwd_f32_sm90_smem(stage.code, d_part, w_in, w_hid, w_out), name)
    # held here until the launch
    w0_t = w0.t().contiguous()
    w1_t, b1 = (w1.t().contiguous(), b1) if stage.code == HEAD_CODE else (None, None)
    xs = [x.data_ptr() for x in inputs[:n_grads]] + [None] * (3 - n_grads)
    head = (stage.code, *xs, len(inputs), _lib.ptr(ln_s), _lib.ptr(ln_b), b0.data_ptr(),
            w0_t.data_ptr(), w1.data_ptr(), w0.data_ptr(), _lib.ptr(w1_t), _lib.ptr(b1),
            g.data_ptr(), *(x.data_ptr() for x in d), *[None] * (3 - n_grads))
    stream = _lib.stream_ptr(g.device)
    if not weight_grads:
        _lib.check(lib.mtt_rowblock_bwd_f32_sm90(
            *head, rows, d_part, w_in, w_hid, w_out,
            _lib.dw_blocks(-(-rows // _lib.ROW_TILE), g.device), stream), name)
        _lib.LAUNCHES[name] += 1
        return (*d, *tail)
    plan = _lib.k4dw_plan(stage.code, rows, w_in, w_hid, _lib.sm_count(g.device))
    sizes = [math.prod(s) for s in shapes]
    spill = torch.empty(plan.spill_bytes, dtype=torch.uint8, device=g.device)
    partials = torch.empty((max(plan.max_slices, 1), sum(sizes)), dtype=torch.float32,
                           device=g.device)
    dw = torch.empty(sum(sizes), dtype=torch.float32, device=g.device)
    _lib.check(lib.mtt_rowblock_bwd_dw_f32_sm90(
        *head, dw.data_ptr(), spill.data_ptr(), partials.data_ptr(), rows, d_part, w_in, w_hid,
        w_out, plan.sms, stream), name)
    _lib.LAUNCHES[name] += 1
    _lib.LAUNCHES["rowblock_dw_product"] += 1
    return (*d, *tail, *(x.view(s) for x, s in zip(torch.split(dw, sizes), shapes)))


class RowDwOperands(NamedTuple):
    """What the two-pass K4-dW's first pass gives: the input cotangents, the
    spilled rows (compress: d_pre, h; combination: xn, d_pre, h; head:
    d_pre0, h0, d_pre1) and per 64-row tile its vector sums (tiles,
    [ln_scale, ln_bias,] b0, b1), in the accumulation dtype."""

    d_inputs: tuple
    rows: tuple
    vectors: torch.Tensor


def rowblock_dw_operands(stage: Stage, inputs, weights, g) -> RowDwOperands:
    """Plain version of the two-pass K4-dW's first pass (``stage.operands``,
    the vector rows summed per 64-row tile in row order);
    :func:`rowblock_dw_from_operands` sums them as the second pass does."""
    d_inputs, rows_, vec = stage.operands(inputs, weights, g)
    tiles = -(-vec.shape[0] // _lib.ROW_TILE)
    pad = torch.zeros((tiles * _lib.ROW_TILE - vec.shape[0], vec.shape[1]), dtype=vec.dtype,
                      device=vec.device)
    return RowDwOperands(d_inputs, rows_, torch.cat([vec, pad]).reshape(
        tiles, _lib.ROW_TILE, -1).sum(1))


def _dw_pairs(stage: Stage, inputs, g, ops: RowDwOperands):
    """The second pass's products (X, Y) of dW = X^T Y, in its tile order."""
    if stage.code == COMBINATION_CODE:
        xn, d_pre, h = ops.rows
        return [(xn, d_pre), (h, g)]
    if stage.code == HEAD_CODE:  # the one-part compress's, d_pre1 in g's place
        d_pre0, h0, d_pre1 = ops.rows
        return [(inputs[0], d_pre0), (h0, d_pre1)]
    d_pre, h = ops.rows
    return [(x, d_pre) for x in inputs] + [(h, g)]


def rowblock_dw_from_operands(stage: Stage, inputs, g, ops: RowDwOperands,
                              plan: "_lib.K4dwPlan"):
    """Plain version of the two-pass K4-dW's second pass: the weight
    gradients (the accumulation dtype, in the order of the stage's weights)
    of ``ops``, summed in the kernels' order: per chunk of ``plan``
    (:func:`_lib.k4dw_plan`) and per slice of it (:func:`_lib.dw_slices`) a
    partial (the slice's rows' products, its share of the chunk's tiles'
    vector rows), the slices added in order, then the chunks in order."""
    acc = ops.vectors.dtype
    pairs = _dw_pairs(stage, inputs, g, ops)
    rows = g.shape[0]
    n_tiles = _lib.k4dw_product_tiles(stage.code, len(inputs))
    w_hid, w_out = ops.rows[-1].shape[1], g.shape[1]
    sizes = [ops.vectors.shape[1] - w_hid - w_out, w_hid, w_out]  # [ln_scale, ln_bias,] b0, b1
    total = None
    for r0, r1 in _lib.k4dw_chunks(plan, rows):
        step, slices = _lib.dw_slices(r1 - r0, n_tiles, plan.sms)
        t0, tiles = r0 // _lib.ROW_TILE, -(-(r1 - r0) // _lib.ROW_TILE)
        chunk = None
        for s in range(slices):
            a, b = r0 + s * step, min(r1, r0 + (s + 1) * step)
            mats = [x[a:b].to(acc).T @ y[a:b].to(acc) for x, y in pairs]
            vec = ops.vectors[t0 + tiles * s // slices:t0 + tiles * (s + 1) // slices].sum(0)
            if stage.code == COMBINATION_CODE:
                ln, b0, b1 = torch.split(vec, sizes)
                part = (*torch.split(ln, ln.shape[0] // 2), mats[0], b0, mats[1], b1)
            else:
                _, b0, b1 = torch.split(vec, sizes)
                part = (torch.cat(mats[:-1]), b0, mats[-1], b1)
            chunk = part if chunk is None else tuple(c + p for c, p in zip(chunk, part))
        total = chunk if total is None else tuple(x + c for x, c in zip(total, chunk))
    return total


def rowblock_dw_product_cuda(stage: Stage, inputs, g, ops: RowDwOperands, sms: int = None):
    """The two-pass K4-dW's second pass alone (``mtt_rowblock_dw_product``)
    on one chunk of rows (``ops`` of ``inputs`` and ``g``, float32, on the
    card): the weight gradients of :func:`rowblock_dw_from_operands` with a
    one-chunk plan. For checks on the card; the training path runs it inside
    the two-pass K4-dW."""
    rows, d_part = g.shape
    n_grads = _n_input_grads(stage, len(inputs))
    spill = torch.cat([x.reshape(-1) for x in ops.rows]).to(torch.float32).contiguous()
    vec = ops.vectors.to(torch.float32).contiguous()
    _lib.require({"spill": spill, "vectors": vec, "g": g,
                  **{f"x{i}": x for i, x in enumerate(inputs[:n_grads])}}, g.device, torch.float32)
    w_hid = ops.rows[-1].shape[1]
    w_in = 2 * d_part if stage.code == COMBINATION_CODE else len(inputs) * d_part
    sms = sms or _lib.sm_count(g.device)
    n_dw = (2 * w_in if stage.code == COMBINATION_CODE else 0) + w_in * w_hid + w_hid + w_hid * d_part + d_part
    partials = torch.empty((_lib.dw_slice_target_tiles(rows, _lib.k4dw_product_tiles(
        stage.code, len(inputs)), sms), n_dw), dtype=torch.float32, device=g.device)
    dw = torch.empty(n_dw, dtype=torch.float32, device=g.device)
    lib = _lib.library()
    xs = [x.data_ptr() for x in inputs[:n_grads]] + [None] * (3 - n_grads)
    _lib.check(lib.mtt_rowblock_dw_product(
        stage.code, *xs, len(inputs), g.data_ptr(), spill.data_ptr(), vec.data_ptr(), rows, w_in,
        w_hid, d_part, sms, partials.data_ptr(), dw.data_ptr(), _lib.stream_ptr(g.device)),
        "rowblock_dw_product")
    _lib.LAUNCHES["rowblock_dw_product"] += 1
    ln = (w_in, w_in) if stage.code == COMBINATION_CODE else ()
    shapes = [(n,) for n in ln] + [(w_in, w_hid), (w_hid,), (w_hid, d_part), (d_part,)]
    return tuple(x.view(s) for x, s in zip(torch.split(dw, [math.prod(s) for s in shapes]), shapes))


def k4_sm90_head_front(stage: Stage, inputs, weights, g):
    """The Hopper K4 head on CUDA bfloat16 tensors at the widths it takes,
    with its recomputed forward written out: returns ``(d_x, out)``, out =
    rnd(silu(pre1)) from the device code (``csrc/rowblock_sm90.cuh``
    ``head_front``) that the Hopper K3 head runs as its forward, so ``out``
    must equal ``rowblock_fwd_cuda``'s output bit for bit. A check of the
    shared front, not a path of the model."""
    _, _, (ln_s, ln_b, w0, b0, w1, b1), geometry = _prepare(stage, inputs, weights)
    _lib.require({"g": g}, g.device, inputs[0].dtype)
    if stage.code != HEAD_CODE or not _lib.k4_sm90_takes(inputs[0].dtype, stage.code, *geometry[1:]):
        raise ValueError("the Hopper K4 head takes bfloat16 heads at d_part 128")
    if g.shape != inputs[0].shape:
        raise ValueError(f"cotangent {tuple(g.shape)} != output {tuple(inputs[0].shape)}")
    out = torch.empty_like(inputs[0])
    (d_x,) = _k4_sm90(stage, inputs, (ln_s, ln_b, w0, b0, w1, b1), g, geometry, front_out=out)
    return d_x, out


def _n_input_grads(stage: Stage, n_inputs: int) -> int:
    """Input cotangents a backward computes; the combination's third (the
    messages') is the output cotangent itself and is passed on as is."""
    return 2 if stage.code == COMBINATION_CODE else n_inputs


def replay_rowblock_bwd(stage: Stage, inputs, weights, g, cotangents, ct_dw):
    """The vector-Jacobian product of ``stage.bwd``, by replaying it under
    autograd (the JAX package's ``bwd_op_bwd``, not chunked).

    :param cotangents: cotangents of the computed input cotangents
        (``None`` where there is none).
    :param ct_dw: cotangents of the weight gradients, or ``None``: then
        the replay skips the weight-gradient products.
    :return: the cotangents of ``inputs``, ``weights`` and ``g``.
    """
    weight_grads = ct_dw is not None and any(c is not None for c in ct_dw)
    _lib.REPLAYS[f"rowblock[{stage.name}]"] += 1
    xs = [x.detach().requires_grad_(True) for x in inputs]
    ws = [w.detach().requires_grad_(True) for w in weights]
    gg = g.detach().requires_grad_(True)
    n = _n_input_grads(stage, len(inputs))
    with torch.enable_grad():
        res = stage.bwd(xs, ws, gg, weight_grads)
        pairs = [(o, c) for o, c in zip(res[:n], cotangents) if c is not None]
        if weight_grads:
            pairs += [(o, c) for o, c in zip(res[len(inputs):], ct_dw) if c is not None]
        if not pairs:
            return [None] * len(xs), [None] * len(ws), None
        grads = torch.autograd.grad([o for o, _ in pairs], xs + ws + [gg],
                                    [c.to(o.dtype) for o, c in pairs], allow_unused=True)
    return list(grads[:len(xs)]), list(grads[len(xs):-1]), grads[-1]


def _first_backward(stage: Stage, inputs, weights, g, weight_grads):
    """K4 / K4-dW on the card, ``stage.bwd`` on the CPU; returns the
    computed input cotangents and then the weight gradients."""
    if g.is_cuda:
        out = rowblock_bwd_cuda(stage, inputs, weights, g, weight_grads)
    else:
        out = stage.bwd(inputs, weights, g, weight_grads)
    n = _n_input_grads(stage, len(inputs))
    return tuple(out[:n]) + tuple(out[len(inputs):])


class _RowBlockBwd(torch.autograd.Function):
    """The stage's first backward as a function of its own: forward is K4
    or K4-dW (the plain version on the CPU), backward the replay."""

    @staticmethod
    def forward(ctx, stage, n_inputs, weight_grads, g, *args):
        ctx.set_materialize_grads(False)
        ctx.stage, ctx.n_inputs, ctx.weight_grads = stage, n_inputs, weight_grads
        ctx.save_for_backward(g, *args)
        return _first_backward(stage, args[:n_inputs], args[n_inputs:], g, weight_grads)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cts):
        g, *args = ctx.saved_tensors
        n = ctx.n_inputs
        n_d = _n_input_grads(ctx.stage, n)
        d_x, d_w, d_g = replay_rowblock_bwd(
            ctx.stage, args[:n], args[n:], g, cts[:n_d],
            cts[n_d:] if ctx.weight_grads else None,
        )
        grads = [d_g, *d_x, *d_w]
        needs = ctx.needs_input_grad[3:]
        return (None, None, None, *[
            (torch.zeros_like(x) if d is None else d.to(x.dtype)) if need else None
            for d, x, need in zip(grads, (g, *args), needs)
        ])


def _first_forward(stage: Stage, inputs, weights, weight_grads):
    """K3 on the card, ``stage.math`` on the CPU. ``weight_grads``: a
    weight requires grad, so the backward will be K4-dW and the replay;
    the bfloat16 Hopper K3 is then not taken and the bf16 training step
    keeps the general K3, while the Hopper float32 K3 runs either way (its
    forward is K4-dW's float32 recompute)."""
    if inputs[0].is_cuda:
        return rowblock_fwd_cuda(stage, inputs, weights, weight_grads=weight_grads)
    return stage.math(inputs, weights)


class _RowBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage, n_inputs, *args):
        ctx.stage, ctx.n_inputs = stage, n_inputs
        ctx.save_for_backward(*args)
        # the test backward makes for the weight gradients
        return _first_forward(stage, args[:n_inputs], args[n_inputs:],
                              any(ctx.needs_input_grad[2 + n_inputs:]))

    @staticmethod
    def backward(ctx, g):
        n = ctx.n_inputs
        args = ctx.saved_tensors
        inputs, weights = args[:n], args[n:]
        # as the JAX package's op_bwd: weight gradients whenever a weight
        # requires grad (fixed when the forward ran)
        weight_grads = any(ctx.needs_input_grad[2 + n:])
        g = g.to(inputs[0].dtype).contiguous()
        out = _RowBlockBwd.apply(ctx.stage, n, weight_grads, g, *args)
        n_d = _n_input_grads(ctx.stage, n)
        d_inputs = list(out[:n_d]) + [g] * (n - n_d)
        d_inputs = [d if ctx.needs_input_grad[2 + i] else None for i, d in enumerate(d_inputs)]
        d_w = ([d.to(w.dtype) for d, w in zip(out[n_d:], weights)] if weight_grads
               else [None] * len(weights))
        return (None, None, *d_inputs, *d_w)


def rowblock(stage: Stage, inputs: Sequence[torch.Tensor], weights: Sequence[torch.Tensor]):
    """Run ``stage`` over (rows, D) inputs with its hand-written backward."""
    return _RowBlock.apply(stage, len(inputs), *inputs, *weights)
