"""Reversed-edge permute: the CUDA kernel and its plain version.

Counterpart of ``metatrain_tpu/ops/pallas/color_gather.py``
(``colored_permute``, ``colored_permute_acc`` and ``reverse_pair``) on the
plain NEF layout. PET's message reversal is an involutive row permutation
``rev`` of the flat (A*M, D) edge array (padded slots map to themselves):

- :func:`permute` computes ``x[rev]`` and, with ``acc``, ``x[rev] + acc``
  in one pass: on a CUDA tensor through ``csrc/permute.cu``, on the CPU
  through ``torch.index_select`` (and one add). Both give the same bits:
  the kernel copies rows and adds once in the storage dtype.
- :func:`reverse_pair` returns ``(x, x reversed)``, the pair every PET path
  consumes. Its backward sums the two cotangents as ``g_x + g_rev[rev]``
  with one launch of the accumulate variant (the TPU's fused cotangent
  fan-in), or runs the plain permute when one of them is ``None``. The
  permutation is an involution, so the adjoint of ``x[rev]`` is the same
  gather: the backwards are the permute Function again, and double
  backward (training with forces) never builds a scatter.

The JAX package's colored slot layouts are TPU-only and not ported: the
port's batches are plain, and one kernel covers the TPU's plain and grouped
kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _lib


def permute_math(x: torch.Tensor, rev: torch.Tensor, acc: Optional[torch.Tensor] = None):
    """Plain version: ``x[rev]`` (+ ``acc``) along axis 0."""
    out = torch.index_select(x, 0, rev)
    return out if acc is None else out + acc


def permute_cuda(x: torch.Tensor, rev: torch.Tensor, acc: Optional[torch.Tensor] = None):
    """Launch the permute kernel (the accumulate variant with ``acc``).
    ``x`` and ``acc``: (rows, ...) float32 or bfloat16, contiguous, with
    rows of a multiple of 16 bytes; ``rev``: (rows,) integer."""
    rows = x.shape[0]
    width = x[0].numel() if rows else 0
    name = "permute" if acc is None else "permute_acc"
    _lib.require({"x": x, "acc": acc}, x.device, x.dtype)
    if acc is not None and acc.shape != x.shape:
        raise ValueError(f"acc {tuple(acc.shape)} does not match x {tuple(x.shape)}")
    if rev.shape != (rows,) or rev.device != x.device:
        raise ValueError(f"rev must be ({rows},) on {x.device}, got {tuple(rev.shape)} on {rev.device}")
    if (width * x.element_size()) % 16:
        raise ValueError(f"{name} needs rows of a multiple of 16 bytes, got {width} x {x.dtype}")
    rev = rev.to(torch.int64).contiguous()
    out = torch.empty_like(x)
    _lib.check(
        _lib.library().mtt_permute(
            _lib.dtype_code(x.dtype), x.data_ptr(), _lib.ptr(acc), rev.data_ptr(),
            out.data_ptr(), rows, width, _lib.stream_ptr(x.device),
        ),
        name,
    )
    _lib.LAUNCHES[name] += 1
    return out


def _permute(x, rev, acc=None):
    if x.is_cuda:
        return permute_cuda(x.contiguous(), rev, None if acc is None else acc.contiguous())
    return permute_math(x, rev, acc)


class _Permute(torch.autograd.Function):
    """``x[rev]`` (+ ``acc``); backward: ``(g[rev], g)``."""

    @staticmethod
    def forward(ctx, x, rev, acc):
        ctx.save_for_backward(rev)
        ctx.has_acc = acc is not None
        return _permute(x, rev, acc)

    @staticmethod
    def backward(ctx, g):
        (rev,) = ctx.saved_tensors
        return _Permute.apply(g, rev, None), None, g if ctx.has_acc else None


def permute(x: torch.Tensor, rev: torch.Tensor, acc: Optional[torch.Tensor] = None):
    """``x[rev]`` (+ ``acc``) along axis 0 for an involutive permutation
    ``rev``, differentiable to any order."""
    return _Permute.apply(x, rev, acc)


class _ReversePair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rev):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(rev)
        return x.view_as(x), _permute(x, rev)

    @staticmethod
    def backward(ctx, g_x, g_rev):
        (rev,) = ctx.saved_tensors
        if g_rev is None:
            return g_x, None
        return permute(g_rev, rev, g_x), None


def reverse_pair(x: torch.Tensor, nbr_reverse: torch.Tensor):
    """``(x, x reversed over edges)`` for (A, M, ...) edge arrays: the
    reversed partner of every slot through ``nbr_reverse`` (flat indices into
    A*M), with the backward's cotangent add fused into the permute."""
    A, M = x.shape[:2]
    flat = x.reshape((A * M,) + x.shape[2:])
    same, rev = _ReversePair.apply(flat, nbr_reverse.reshape(-1))
    return same.view(x.shape), rev.view(x.shape)
