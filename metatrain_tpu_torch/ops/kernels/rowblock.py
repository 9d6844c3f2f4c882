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
K4-dW, its weight-gradient variant, runs when a weight requires grad.
The backward is differentiable again (training with forces): its
gradient replays ``stage.bwd`` under autograd, as the JAX package's
``bwd_op_bwd`` differentiates ``_bwd_math_reference``.

Weights keep the JAX package's (in, out) layout and are cast to the
compute dtype (the dtype of ``inputs[0]``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from . import _lib


# kernel instantiations (the ``stage`` argument of the C entry points)
COMPRESS_CODE, COMBINATION_CODE, HEAD_CODE = 0, 1, 2


class Stage(NamedTuple):
    """A row-block stage: its kernel instantiation ``code`` and its plain
    forward/backward."""

    name: str
    code: int
    math: Callable
    bwd: Callable


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


def rowblock_fwd_cuda(stage: Stage, inputs: Sequence[torch.Tensor], weights):
    """Launch K3 for ``stage``: returns the (rows, w_out) output."""
    code, parts, (ln_s, ln_b, w0, b0, w1, b1), geometry = _prepare(stage, inputs, weights)
    rows, d_part, w_in, w_hid, w_out = geometry
    lib = _lib.library()
    _lib.check_shared(lib.mtt_rowblock_fwd_smem(w_in, w_hid), "rowblock_fwd")
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


def rowblock_bwd_cuda(stage: Stage, inputs: Sequence[torch.Tensor], weights, g,
                      weight_grads: bool = False):
    """Launch K4 for ``stage``: returns the input cotangents (for the
    combination, the messages' cotangent is ``g`` itself). With
    ``weight_grads=True`` launch K4-dW, which also returns the float32
    weight gradients summed over rows, in the order of ``weights``: one
    block per SM over a contiguous range of 64-row tiles, each block
    summing into its own float32 partial, then a second pass that adds the
    partials in block order (the same sum in every run)."""
    code, parts, (ln_s, ln_b, w0, b0, w1, b1), geometry = _prepare(stage, inputs, weights)
    rows, d_part, w_in, w_hid, w_out = geometry
    _lib.require({"g": g}, g.device, inputs[0].dtype)
    if g.shape != (rows, w_out):
        raise ValueError(f"cotangent {tuple(g.shape)} != output {(rows, w_out)}")
    name = f"rowblock_bwd{'_dw' if weight_grads else ''}[{stage.name}]"
    lib = _lib.library()
    _lib.check_shared(
        lib.mtt_rowblock_bwd_smem(stage.code, w_in, w_hid, w_out, int(weight_grads)), name
    )
    n_grads = 2 if stage.code == COMBINATION_CODE else len(inputs)
    d = [torch.empty_like(inputs[i]) for i in range(n_grads)]
    w0_t, w1_t = w0.t().contiguous(), w1.t().contiguous()
    d_ptrs = [x.data_ptr() for x in d] + [None] * (3 - n_grads)
    partials = dw = None
    blocks = 0
    if weight_grads:
        shapes = [tuple(x.shape) for x in weights]
        sizes = [x.numel() for x in weights]
        blocks = _lib.dw_blocks(-(-rows // 64), g.device)
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


class _RowBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage, n_inputs, *args):
        inputs, weights = args[:n_inputs], args[n_inputs:]
        ctx.stage, ctx.n_inputs = stage, n_inputs
        ctx.save_for_backward(*args)
        if inputs[0].is_cuda:
            return rowblock_fwd_cuda(stage, inputs, weights)
        return stage.math(inputs, weights)

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
