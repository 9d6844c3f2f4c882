"""Row-block stages: CUDA kernels K3/K4 behind one ``autograd.Function``.

Counterpart of ``metatrain_tpu/ops/pallas/rowblock.py``. PET's compress,
combination and head stages each apply a small MLP to every row of a
(rows, ...) array. A :class:`Stage` names one of them and carries its
plain PyTorch versions (``models/pet/fused_stages.py``):
``math(inputs, weights) -> out`` and ``bwd(inputs, weights, g) ->
d_inputs``. :func:`rowblock` runs a stage with its hand-written backward:
on the CPU through those plain versions, on the card through K3
(``csrc/rowblock_fwd.cu``) and K4 (``csrc/rowblock_bwd.cu``), one
templated kernel instantiated per stage. Weight gradients belong to the
training slice: the backward raises when a weight requires grad.

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


def rowblock_bwd_cuda(stage: Stage, inputs: Sequence[torch.Tensor], weights, g):
    """Launch K4 for ``stage``: returns the input cotangents (for the
    combination, the messages' cotangent is ``g`` itself)."""
    code, parts, (ln_s, ln_b, w0, b0, w1, b1), geometry = _prepare(stage, inputs, weights)
    rows, d_part, w_in, w_hid, w_out = geometry
    _lib.require({"g": g}, g.device, inputs[0].dtype)
    if g.shape != (rows, w_out):
        raise ValueError(f"cotangent {tuple(g.shape)} != output {(rows, w_out)}")
    lib = _lib.library()
    _lib.check_shared(
        lib.mtt_rowblock_bwd_smem(stage.code, w_in, w_hid, w_out), "rowblock_bwd"
    )
    n_grads = 2 if stage.code == COMBINATION_CODE else len(inputs)
    d = [torch.empty_like(inputs[i]) for i in range(n_grads)]
    w0_t, w1_t = w0.t().contiguous(), w1.t().contiguous()
    d_ptrs = [x.data_ptr() for x in d] + [None] * (3 - n_grads)
    _lib.check(
        lib.mtt_rowblock_bwd(
            code, stage.code, *(_lib.ptr(x) for x in parts), len(inputs),
            *(_lib.ptr(x) for x in (ln_s, ln_b, w0, b0, w1, b1)),
            w0_t.data_ptr(), w1_t.data_ptr(),
            g.data_ptr(), *d_ptrs,
            rows, d_part, w_in, w_hid, w_out, _lib.stream_ptr(g.device),
        ),
        "rowblock_bwd",
    )
    _lib.LAUNCHES[f"rowblock_bwd[{stage.name}]"] += 1
    if stage.code == COMBINATION_CODE:
        d.append(g)
    return tuple(d)


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
        if any(ctx.needs_input_grad[2 + n:]):
            raise NotImplementedError("weight gradients: training slice")
        args = ctx.saved_tensors
        inputs, weights = args[:n], args[n:]
        g = g.to(inputs[0].dtype).contiguous()
        if g.is_cuda:
            d_inputs = rowblock_bwd_cuda(ctx.stage, inputs, weights, g)
        else:
            d_inputs = ctx.stage.bwd(inputs, weights, g)
        d_inputs = [d if ctx.needs_input_grad[2 + i] else None for i, d in enumerate(d_inputs)]
        return (None, None, *d_inputs, *([None] * len(weights)))


def rowblock(stage: Stage, inputs: Sequence[torch.Tensor], weights: Sequence[torch.Tensor]):
    """Run ``stage`` over (rows, D) inputs with its hand-written backward."""
    return _RowBlock.apply(stage, len(inputs), *inputs, *weights)
