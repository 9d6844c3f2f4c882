"""Inference mode: parameters that do not require grad.

Counterpart of ``metatrain_tpu/ops/inference.py``. The JAX package traces
inference under a flag so that its backward kernels skip weight
gradients. In PyTorch the flag is the parameters' own ``requires_grad``,
read by the kernels' ``autograd.Function``s (``ctx.needs_input_grad``):
with no weight that requires grad the backward launches the
input-gradient kernel (K2, K4, the GNN block's and the window attention's
backward); when one does, it launches the weight-gradient variant (K2-dW,
K4-dW, the block's dW variant), which returns the weight gradients too.
The static W8A8 layer (``PET(..., int8_static=True)``) is inference only,
as the JAX package's ``use_int8_static``: it runs only while no weight of
the layer requires grad; otherwise the exact layer runs.
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
