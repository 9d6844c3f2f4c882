"""Involutive row permutations with gather-only adjoints.

Counterpart of ``metatrain_tpu/ops/involution.py``. The neighbor-position
gather (PET's reversed-edge lookup runs through the permute kernel of
``ops/kernels/permute.py`` instead) would back-propagate through
``index_add_`` (a scatter with atomics, nondeterministic in its summation
order on the GPU). The reversal index ``rev`` is an involutive
permutation (``rev[rev] == arange``), so the exact adjoint of ``x[rev]``
is the same gather; both functions here are ``autograd.Function``s whose
backward is again a gather, deterministic and free of atomics. Each
backward calls the Functions themselves, so double backward works too.
"""

from __future__ import annotations

import torch


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rev):
        ctx.save_for_backward(rev)
        return torch.index_select(x, 0, rev)

    @staticmethod
    def backward(ctx, grad):
        (rev,) = ctx.saved_tensors
        return _PermuteRows.apply(grad, rev), None


def permute_rows(x: torch.Tensor, rev: torch.Tensor) -> torch.Tensor:
    """``x[rev]`` along axis 0 for an involutive permutation ``rev``."""
    return _PermuteRows.apply(x, rev)


class _NbrGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pos, nbr_indices, nbr_reverse):
        ctx.save_for_backward(nbr_reverse)
        A, M = nbr_indices.shape
        return torch.index_select(pos, 0, nbr_indices.reshape(-1)).reshape(
            (A, M) + pos.shape[1:]
        )

    @staticmethod
    def backward(ctx, grad):
        # the reversed slot's center is nbr_indices[i, m] (padded slots
        # self-map and carry zero cotangents): dpos[p] = sum_m g[rev(p, m)]
        (rev,) = ctx.saved_tensors
        A, M = rev.shape
        flat = grad.reshape((A * M,) + grad.shape[2:])
        return permute_rows(flat, rev.reshape(-1)).reshape(grad.shape).sum(1), None, None


def nbr_gather(
    pos: torch.Tensor, nbr_indices: torch.Tensor, nbr_reverse: torch.Tensor
) -> torch.Tensor:
    """``pos[nbr_indices]`` (A, ...) -> (A, M, ...) with a scatter-free
    adjoint through the involutive edge reversal ``nbr_reverse`` (flat
    indices into A*M, padded slots self-referencing)."""
    return _NbrGather.apply(pos, nbr_indices, nbr_reverse)
