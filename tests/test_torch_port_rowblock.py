"""Port parity: the row-block stages (plain versions of K3/K4) vs the JAX package.

Each stage's inputs and weights are made with numpy from a seed and fed
to the JAX package's stage math (``reference_rowblock``, its hand-written
backwards and ``jax.vjp``) and to the port's stage math, its backward and
the ``rowblock`` ``autograd.Function``. float64 agrees to 1e-12 relative,
float32 to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import rel
from metatrain_tpu.models.pet import fused_stages as jst
from metatrain_tpu.ops.pallas.rowblock import reference_rowblock
from metatrain_tpu_torch.models.pet import fused_stages as tst
from metatrain_tpu_torch.ops.kernels import rowblock as trb

ROWS, D, D_HEAD = 8 * 16, 32, 48
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _case(name, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def lecun(i, o):
        return rng.normal(size=(i, o)) / np.sqrt(i)

    def vec(n, base=0.0):
        return base + 0.1 * rng.normal(size=n)

    def x(width=D):
        return rng.normal(size=(ROWS, width))

    if name == "compress2":
        inputs, weights = (x(), x()), (lecun(2 * D, D), vec(D), lecun(D, D), vec(D))
        stages = (jst.compress_math, jst.compress_bwd, tst.COMPRESS)
    elif name == "compress3":
        inputs, weights = (x(), x(), x()), (lecun(3 * D, D), vec(D), lecun(D, D), vec(D))
        stages = (jst.compress_math, jst.compress_bwd, tst.COMPRESS)
    elif name == "combination":
        inputs = (x(), x(), x())
        weights = (vec(2 * D, 1.0), vec(2 * D), lecun(2 * D, 2 * D), vec(2 * D),
                   lecun(2 * D, D), vec(D))
        stages = (jst.combination_math, jst.combination_bwd, tst.COMBINATION)
    else:
        inputs = (x(),)
        weights = (lecun(D, D_HEAD), vec(D_HEAD), lecun(D_HEAD, D_HEAD), vec(D_HEAD))
        stages = (jst.head_math, jst.head_bwd, tst.HEAD)
    out_width = weights[-1].shape[0]
    g = rng.normal(size=(ROWS, out_width)).astype(dtype)
    inputs = tuple(a.astype(dtype) for a in inputs)
    weights = tuple(a.astype(dtype) for a in weights)
    return inputs, weights, g, stages



def _torch(arrays, requires_grad=False):
    return tuple(torch.from_numpy(a).requires_grad_(requires_grad) for a in arrays)


STAGES = ["compress2", "compress3", "combination", "head"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", STAGES)
def test_stage_forward_and_input_gradients_match_jax(name, dtype):
    inputs, weights, g, (j_math, j_bwd, stage) = _case(name, dtype)
    j_in = tuple(jnp.asarray(a) for a in inputs)
    j_w = tuple(jnp.asarray(a) for a in weights)
    (j_out,) = reference_rowblock(j_math, j_in, j_w)
    j_hand, _ = j_bwd(j_in, j_w, (jnp.asarray(g),), False)
    _, vjp = jax.vjp(lambda *ins: j_math(ins, j_w)[0], *j_in)
    j_auto = vjp(jnp.asarray(g))

    t_in, t_w = _torch(inputs), _torch(weights)
    assert rel(stage.math(t_in, t_w), j_out) < TOL[dtype]
    t_bwd = stage.bwd(t_in, t_w, torch.from_numpy(g))
    assert len(t_bwd) == len(inputs)
    for t, jh, ja in zip(t_bwd, j_hand, j_auto):
        assert rel(t, jh) < TOL[dtype]
        assert rel(t, ja) < TOL[dtype]


@pytest.mark.parametrize("name", STAGES)
def test_rowblock_function_on_cpu_matches_jax_vjp(name):
    inputs, weights, g, (j_math, _, stage) = _case(name, np.float64, seed=3)
    j_w = tuple(jnp.asarray(a) for a in weights)
    _, vjp = jax.vjp(lambda *ins: j_math(ins, j_w)[0], *(jnp.asarray(a) for a in inputs))
    j_grads = vjp(jnp.asarray(g))
    t_in = _torch(inputs, requires_grad=True)
    out = trb.rowblock(stage, t_in, _torch(weights))
    grads = torch.autograd.grad(out, t_in, torch.from_numpy(g))
    for t, j in zip(grads, j_grads):
        assert rel(t, j) < 1e-12


def test_weight_gradients_raise():
    inputs, weights, _, (_, _, stage) = _case("head", np.float64)
    t_w = _torch(weights)
    t_w = (t_w[0].clone().requires_grad_(True),) + t_w[1:]
    out = trb.rowblock(stage, _torch(inputs, requires_grad=True), t_w)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


def test_cuda_wrappers_reject_cpu_tensors_and_bad_shapes():
    inputs, weights, g, (_, _, stage) = _case("compress3", np.float32)
    with pytest.raises(ValueError, match="cuda"):
        trb.rowblock_fwd_cuda(stage, _torch(inputs), _torch(weights))
    with pytest.raises(ValueError, match="cuda"):
        trb.rowblock_bwd_cuda(stage, _torch(inputs), _torch(weights), torch.from_numpy(g))
    inputs, weights, _, (_, _, stage) = _case("combination", np.float32)
    with pytest.raises(ValueError, match="combination takes"):
        trb.rowblock_fwd_cuda(stage, _torch(inputs[:2]), _torch(weights))
