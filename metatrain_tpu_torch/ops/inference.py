"""Inference mode: parameters that do not require grad.

Counterpart of ``metatrain_tpu/ops/inference.py``. The JAX package traces
inference under a flag so that its backward kernels skip weight
gradients. In PyTorch the flag is the parameters' own ``requires_grad``:
the kernels' ``autograd.Function``s read ``ctx.needs_input_grad`` and
compute input gradients only, and they raise when a weight requires grad
(weight gradients belong to the training slice).
"""

from __future__ import annotations

import contextlib

from torch import nn


@contextlib.contextmanager
def no_param_grads(module: nn.Module):
    """Parameters of ``module`` stop requiring grad inside the block."""
    params = list(module.parameters())
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)
