"""Window attention: CUDA kernels and their plain versions.

Counterpart of ``metatrain_tpu/ops/pallas/attention.py``. PET's unfused
transformer layers attend within each atom's window of T = M + 1 tokens
(the center token first, then the edges), per head:

    out = softmax(q_h k_h^T * scale + bias[:, None, :]) v_h

with one additive bias per key, the same for every query and head (the
log-cutoff ``log(clip([1 | cf], 1e-15))``).

- :func:`attention_math` is the plain version (``reference_window_attention``):
  products accumulated in float32 (float64 for float64), the softmax
  weights rounded to the compute dtype before they multiply v.
- :func:`attention_bwd_math` is its vector-Jacobian product
  (``_bwd_math_reference``): ``(dq, dk, dv, dbias)``, dbias in float32
  (float64 for float64).
- :func:`window_attention` is the ``autograd.Function`` entry: a tensor on
  the CPU runs the plain versions; a CUDA tensor launches
  ``csrc/window_attention_fwd.cu`` and, for its gradient,
  ``csrc/window_attention_bwd.cu``. The backward is differentiable again
  (training with forces): its gradient replays :func:`attention_bwd_math`
  under autograd, chunk by chunk over atoms, as the JAX package's
  ``bwd_op_bwd`` differentiates ``_bwd_math_reference``.

The kernels take q, k, v (A, T, D) in float32 or bfloat16, with rows
evenly spaced (the q, k and v slices of one (A, T, 3D) projection need no
copy), and the bias (A, T) in float32; any head width up to 64 (the float
kernels pad a head to 8, 16, 32 or 64 columns with zeros).
"""

from __future__ import annotations

import torch

from . import _lib
from .fused_layer import accumulation_dtype


def attention_math(q, k, v, bias, num_heads: int, scale: float):
    """Plain forward: (A, T, D) in the dtype of ``q``."""
    A, T, D = q.shape
    hd = D // num_heads
    acc = accumulation_dtype(q.dtype)
    qh, kh, vh = (x.reshape(A, T, num_heads, hd).to(acc) for x in (q, k, v))
    scores = torch.einsum("aqhd,akhd->ahqk", qh, kh) * scale
    scores = scores + bias[:, None, None, :].to(acc)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("ahqk,akhd->aqhd", weights.to(acc), vh)
    return out.reshape(A, T, D).to(q.dtype)


def attention_bwd_math(q, k, v, bias, g, num_heads: int, scale: float, create_graph: bool = False):
    """Plain backward: ``(dq, dk, dv, dbias)``, the cotangents of the inputs
    of :func:`attention_math` for the output cotangent ``g``; dbias in
    float32 (float64 for float64 inputs). With ``create_graph`` the result
    is differentiable in the inputs, which must then require grad (the
    second-order replay)."""
    acc = accumulation_dtype(q.dtype)
    with torch.enable_grad():
        if not create_graph:
            q, k, v, bias = (x.detach().requires_grad_(True) for x in (q, k, v, bias))
        b = bias.to(acc)
        out = attention_math(q, k, v, b, num_heads, scale)
        return torch.autograd.grad(out, (q, k, v, b), g.to(out.dtype), create_graph=create_graph)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _rows(x: torch.Tensor):
    """``(x, ld)``: x itself when its (T, D) rows are evenly spaced, ``ld``
    elements apart, 16-byte aligned, else a contiguous copy."""
    A, T, D = x.shape
    ld = x.stride(1)
    aligned = x.data_ptr() % 16 == 0 and (ld * x.element_size()) % 16 == 0
    if x.stride(2) == 1 and x.stride(0) == T * ld and aligned:
        return x, ld
    return x.contiguous(), D


def _check(q, k, v, bias, num_heads, extra=None):
    A, T, D = q.shape
    if D % num_heads or not _lib.head_regs(D // num_heads):
        raise ValueError(f"window attention kernels take a head count that divides D into heads "
                         f"of at most 64; got D={D}, heads={num_heads}")
    for name, x in (("k", k), ("v", v), ("g", extra)):
        if x is not None and x.shape != q.shape:
            raise ValueError(f"{name} {tuple(x.shape)} does not match q {tuple(q.shape)}")
    if bias.shape != (A, T):
        raise ValueError(f"bias {tuple(bias.shape)} does not match (A, T) = {(A, T)}")
    tensors = {"q": q, "k": k, "v": v, "g": extra}
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take cuda tensors, got {q.device}")
    for name, x in tensors.items():
        if x is not None and (x.device != q.device or x.dtype != q.dtype):
            raise ValueError(f"{name} is {x.dtype} on {x.device}, expected {q.dtype} on {q.device}")
    _lib.require({"bias": bias}, q.device, torch.float32)
    return A, T, D, _lib.dtype_code(q.dtype)


def window_attention_fwd_cuda(q, k, v, bias, num_heads: int, scale: float):
    """Launch the forward kernel: (A, T, D) in the dtype of ``q``."""
    A, T, D, code = _check(q, k, v, bias, num_heads)
    (q, ldq), (k, ldk), (v, ldv) = _rows(q), _rows(k), _rows(v)
    lib = _lib.library()
    _lib.check_shared(lib.mtt_window_attention_fwd_smem(code, T, D, num_heads), "window_attention_fwd")
    out = torch.empty((A, T, D), dtype=q.dtype, device=q.device)
    _lib.check(
        lib.mtt_window_attention_fwd(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), ldq, ldk, ldv, bias.data_ptr(),
            out.data_ptr(), A, T, D, num_heads, float(scale), _lib.stream_ptr(q.device),
        ),
        "window_attention_fwd",
    )
    _lib.LAUNCHES["window_attention_fwd"] += 1
    return out


def window_attention_bwd_cuda(q, k, v, bias, g, num_heads: int, scale: float):
    """Launch the backward kernel: ``(dq, dk, dv, dbias)``, dbias float32."""
    A, T, D, code = _check(q, k, v, bias, num_heads, g)
    (q, ldq), (k, ldk), (v, ldv), (g, ldg) = _rows(q), _rows(k), _rows(v), _rows(g)
    lib = _lib.library()
    _lib.check_shared(lib.mtt_window_attention_bwd_smem(code, T, D, num_heads), "window_attention_bwd")
    dq, dk, dv = (torch.empty((A, T, D), dtype=q.dtype, device=q.device) for _ in range(3))
    dbias = torch.empty((A, T), dtype=torch.float32, device=q.device)
    _lib.check(
        lib.mtt_window_attention_bwd(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), ldq, ldk, ldv, ldg,
            bias.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
            A, T, D, num_heads, float(scale), _lib.stream_ptr(q.device),
        ),
        "window_attention_bwd",
    )
    _lib.LAUNCHES["window_attention_bwd"] += 1
    return dq, dk, dv, dbias


def replay_attention_bwd(inputs, cotangents, num_heads, scale, chunk):
    """The vector-Jacobian product of :func:`attention_bwd_math`, replayed
    under autograd over chunks of ``chunk`` atoms (windows are independent,
    so the chunked result is exact and only one chunk's graph is alive).

    :param inputs: ``(q, k, v, bias, g)``.
    :param cotangents: cotangents of ``(dq, dk, dv, dbias)``, ``None``
        where an output has none.
    :return: the cotangents of the five inputs.
    """
    _lib.REPLAYS["window_attention"] += 1
    A = inputs[0].shape[0]
    d_rows = [[] for _ in inputs]
    for a0 in range(0, A, chunk):
        xs = [t[a0:a0 + chunk].detach().requires_grad_(True) for t in inputs]
        with torch.enable_grad():
            res = attention_bwd_math(*xs, num_heads, scale, create_graph=True)
            pairs = [(o, c[a0:a0 + chunk].to(o.dtype)) for o, c in zip(res, cotangents)
                     if c is not None]
            grads = (torch.autograd.grad([o for o, _ in pairs], xs, [c for _, c in pairs],
                                         allow_unused=True) if pairs else [None] * len(xs))
        for i, (x, d) in enumerate(zip(xs, grads)):
            d_rows[i].append(torch.zeros_like(x) if d is None else d)
    return [torch.cat(parts) for parts in d_rows]


class _WindowAttentionBwd(torch.autograd.Function):
    """The attention's first backward as a function of its own: forward is
    the backward kernel (the plain version on the CPU), backward the
    chunked replay."""

    @staticmethod
    def forward(ctx, q, k, v, bias, g, num_heads, scale, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, bias, g)
        ctx.num_heads, ctx.scale, ctx.chunk = num_heads, scale, chunk
        if q.is_cuda:
            return window_attention_bwd_cuda(q, k, v, bias, g, num_heads, scale)
        return tuple(attention_bwd_math(q, k, v, bias, g, num_heads, scale))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cts):
        inputs = ctx.saved_tensors
        grads = replay_attention_bwd(inputs, cts, ctx.num_heads, ctx.scale, ctx.chunk)
        grads = [d.to(x.dtype) if need else None
                 for d, x, need in zip(grads, inputs, ctx.needs_input_grad)]
        return (*grads, None, None, None)


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads, scale, chunk):
        ctx.save_for_backward(q, k, v, bias)
        ctx.num_heads, ctx.scale, ctx.chunk = num_heads, scale, chunk
        if q.is_cuda:
            return window_attention_fwd_cuda(q, k, v, bias, num_heads, scale)
        return attention_math(q, k, v, bias, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = _WindowAttentionBwd.apply(
            q, k, v, bias, g.to(q.dtype), ctx.num_heads, ctx.scale, ctx.chunk)
        return dq, dk, dv, dbias.to(bias.dtype), None, None, None


def window_attention(q, k, v, bias, num_heads: int, scale: float, chunk: int = 1024):
    """Windowed multi-head attention with its hand-written backward. CPU
    tensors run :func:`attention_math` / :func:`attention_bwd_math`; CUDA
    tensors launch the kernels. ``chunk`` is the number of atoms per step
    of the second-order replay."""
    return _WindowAttention.apply(q, k, v, bias, num_heads, scale, chunk)
