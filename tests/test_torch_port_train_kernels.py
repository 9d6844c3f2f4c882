"""Port parity: the training backwards of the fused layer and the row-block
stages (plain versions of K2-dW/K4-dW, and the second-order replay) vs the
JAX package.

The same inputs, made with numpy from a seed, go through the JAX package's
plain references (``_layer_math``, ``_layer_bwd_math``, the stage math and
its hand-written backwards, ``reference_rowblock``; no Pallas) and through
the port's twins and ``autograd.Function``s on the CPU.

- Weight gradients of the first backward: float64 to 1e-12 relative
  against ``jax.vjp`` with respect to the weights. The JAX hand-written
  backwards return weight gradients in float32 whatever the compute dtype,
  so against them the bound is float32's (1e-6).
- Grad and grad-of-grad through the Functions (training with forces):
  float64 to 1e-10 against ``jax.grad`` of the plain math, with a replay
  chunk that does not divide the atom count; float32 to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import rel
from metatrain_tpu.models.pet import fused_stages as jst
from metatrain_tpu.ops.pallas import fused_layer as jfl
from metatrain_tpu.ops.pallas.rowblock import reference_rowblock
from metatrain_tpu_torch.models.pet import fused_stages as tst
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import fused_layer as tfl
from metatrain_tpu_torch.ops.kernels import rowblock as trb

A, M, D, H, F = 11, 16, 32, 4, 64
CHUNK = 4  # does not divide A: the replay's last chunk is short
SCALE = 1.0 / np.sqrt(D // H)
TOL = {np.float64: 1e-12, np.float32: 1e-5}
TOL2 = {np.float64: 1e-10, np.float32: 1e-5}
JAX_DW_TOL = 1e-6  # the JAX hand-written backwards round dW to float32


def _layer_inputs(dtype, seed):
    rng = np.random.default_rng(seed)

    def lecun(i, o):
        return rng.normal(size=(i, o)) / np.sqrt(i)

    weights = [
        1 + 0.1 * rng.normal(size=D), lecun(D, 3 * D), 0.1 * rng.normal(size=3 * D),
        lecun(D, D), 0.1 * rng.normal(size=D), 1 + 0.1 * rng.normal(size=D),
        lecun(D, 2 * F), 0.1 * rng.normal(size=2 * F), lecun(F, D), 0.1 * rng.normal(size=D),
    ]
    n_real = rng.integers(M // 2, M - 1, size=(A, 1))
    cf = rng.uniform(0.05, 1.0, size=(A, M)) * (np.arange(M)[None] < n_real)
    cf[:, M - 1] = 1.0
    arrays = dict(
        edges=rng.normal(size=(A, M, D)), center=rng.normal(size=(A, D)), cf=cf,
        g_edge=rng.normal(size=(A, M, D)), g_center=rng.normal(size=(A, D)),
        h_center=rng.normal(size=(A, D)),
    )
    arrays = {k: v.astype(dtype) for k, v in arrays.items()}
    return arrays, [w.astype(dtype) for w in weights]


def _check(t, j, tol, what=None):
    """``rel(t, j) < tol``; where the reference is exactly zero (a weight
    that the input gradients do not depend on), the port's too."""
    t = t.detach().numpy()
    if not np.abs(np.asarray(j)).any():
        assert not np.abs(t).any(), what
    else:
        assert rel(t, j) < tol, what


def _grads(out, inputs):
    """``torch.autograd.grad`` with zeros for unused inputs, keeping the graph."""
    grads = torch.autograd.grad(out, inputs, create_graph=True, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_layer_weight_gradients_match_jax(dtype):
    x, w = _layer_inputs(dtype, seed=0)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    jw = jfl.LayerWeights(*(jnp.asarray(a) for a in w))
    j_hand = jfl._layer_bwd_math(j["edges"], j["center"], j["cf"], jw, j["g_edge"],
                                 j["g_center"], H, SCALE, weight_grads=True)
    _, vjp = jax.vjp(lambda ww: jfl._layer_math(j["edges"], j["center"], j["cf"], ww, H, SCALE),
                     jw)
    (j_auto,) = vjp((j["g_edge"], j["g_center"]))

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out = tfl.layer_bwd_math(t["edges"], t["center"], t["cf"],
                             tfl.LayerWeights(*(torch.from_numpy(a) for a in w)),
                             t["g_edge"], t["g_center"], H, SCALE, weight_grads=True)
    assert len(out) == 4
    # the input cotangents are those of the input-gradient variant
    plain = tfl.layer_bwd_math(t["edges"], t["center"], t["cf"],
                               tfl.LayerWeights(*(torch.from_numpy(a) for a in w)),
                               t["g_edge"], t["g_center"], H, SCALE)
    for a, b in zip(out[:3], plain):
        assert torch.equal(a, b)
    for name, dw, jh, ja in zip(tfl.LayerWeights._fields, out[3], j_hand[3], j_auto):
        assert dw.dtype == (torch.float64 if dtype == np.float64 else torch.float32), name
        assert rel(dw, jh) < max(TOL[dtype], JAX_DW_TOL), name
        assert rel(dw, ja) < TOL[dtype], name


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_layer_grad_and_grad_of_grad_match_jax(dtype):
    x, w = _layer_inputs(dtype, seed=1)

    def j_l1(e, c, f, ww):
        eo, ca = jfl._layer_math(e, c, f, ww, H, SCALE)
        return jnp.sum(eo * x["g_edge"]) + jnp.sum(ca * x["g_center"])

    def j_l2(e, c, f, ww):
        de, dc, df = jax.grad(j_l1, argnums=(0, 1, 2))(e, c, f, ww)
        return jnp.sum(de**2) + jnp.sum(dc * x["h_center"]) + jnp.sum(df**2)

    j_args = (jnp.asarray(x["edges"]), jnp.asarray(x["center"]), jnp.asarray(x["cf"]),
              jfl.LayerWeights(*(jnp.asarray(a) for a in w)))
    j_g1 = jax.grad(j_l1, argnums=3)(*j_args)
    j_g2 = jax.grad(j_l2, argnums=(0, 1, 2, 3))(*j_args)

    ins = [torch.from_numpy(x[k]).requires_grad_(True) for k in ("edges", "center", "cf")]
    tw = [torch.from_numpy(a).requires_grad_(True) for a in w]
    replays = _lib.REPLAYS["fused_layer"]
    edge_out, center_attn = tfl.fused_transformer_layer(*ins, tfl.LayerWeights(*tw), H, SCALE,
                                                        chunk=CHUNK)
    l1 = torch.sum(edge_out * torch.from_numpy(x["g_edge"])) + torch.sum(
        center_attn * torch.from_numpy(x["g_center"]))
    g1 = _grads(l1, ins + tw)
    l2 = torch.sum(g1[0] ** 2) + torch.sum(g1[1] * torch.from_numpy(x["h_center"])) + torch.sum(
        g1[2] ** 2)
    g2 = _grads(l2, ins + tw)

    for name, t, j in zip(tfl.LayerWeights._fields, g1[3:], j_g1):
        _check(t, j, TOL2[dtype], name)
    for t, j in zip(g2[:3], j_g2[:3]):
        _check(t, j, TOL2[dtype])
    for name, t, j in zip(tfl.LayerWeights._fields, g2[3:], j_g2[3]):
        _check(t, j, TOL2[dtype], name)
    assert _lib.REPLAYS["fused_layer"] == replays + 1


def _stage_case(name, dtype, seed, rows=8 * 16 + 3, d_head=48):
    rng = np.random.default_rng(seed)

    def lecun(i, o):
        return rng.normal(size=(i, o)) / np.sqrt(i)

    def vec(n, base=0.0):
        return base + 0.1 * rng.normal(size=n)

    def x(width=D):
        return rng.normal(size=(rows, width))

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
        weights = (lecun(D, d_head), vec(d_head), lecun(d_head, d_head), vec(d_head))
        stages = (jst.head_math, jst.head_bwd, tst.HEAD)
    g = rng.normal(size=(rows, weights[-1].shape[0])).astype(dtype)
    return (tuple(a.astype(dtype) for a in inputs), tuple(a.astype(dtype) for a in weights),
            g, stages)


STAGES = ["compress2", "compress3", "combination", "head"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", STAGES)
def test_stage_weight_gradients_match_jax(name, dtype):
    inputs, weights, g, (j_math, j_bwd, stage) = _stage_case(name, dtype, seed=2)
    j_in = tuple(jnp.asarray(a) for a in inputs)
    j_w = tuple(jnp.asarray(a) for a in weights)
    j_d_in, j_hand = j_bwd(j_in, j_w, (jnp.asarray(g),), True)
    _, vjp = jax.vjp(lambda *ww: j_math(j_in, ww)[0], *j_w)
    j_auto = vjp(jnp.asarray(g))

    t_in = tuple(torch.from_numpy(a) for a in inputs)
    t_w = tuple(torch.from_numpy(a) for a in weights)
    out = stage.bwd(t_in, t_w, torch.from_numpy(g), weight_grads=True)
    assert len(out) == len(inputs) + len(weights)
    for t, j in zip(out[:len(inputs)], j_d_in):
        assert rel(t, j) < TOL[dtype]
    for i, (t, jh, ja) in enumerate(zip(out[len(inputs):], j_hand, j_auto)):
        assert t.shape == weights[i].shape
        assert rel(t, jh) < max(TOL[dtype], JAX_DW_TOL), i
        assert rel(t, ja) < TOL[dtype], i


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", STAGES)
def test_rowblock_grad_and_grad_of_grad_match_jax(name, dtype):
    inputs, weights, g, (j_math, _, stage) = _stage_case(name, dtype, seed=3)
    n = len(inputs)

    def j_l1(ins, ww):
        (out,) = reference_rowblock(j_math, ins, ww)
        return jnp.sum(out * g)

    def j_l2(ins, ww):
        d_ins = jax.grad(j_l1)(ins, ww)
        return sum(jnp.sum(d**2) for d in d_ins)

    j_in = tuple(jnp.asarray(a) for a in inputs)
    j_w = tuple(jnp.asarray(a) for a in weights)
    j_g1 = jax.grad(j_l1, argnums=1)(j_in, j_w)
    j_g2_in, j_g2_w = jax.grad(j_l2, argnums=(0, 1))(j_in, j_w)

    t_in = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    t_w = [torch.from_numpy(a).requires_grad_(True) for a in weights]
    replays = _lib.REPLAYS[f"rowblock[{stage.name}]"]
    l1 = torch.sum(trb.rowblock(stage, t_in, t_w) * torch.from_numpy(g))
    g1 = _grads(l1, t_in + t_w)
    l2 = sum(torch.sum(d**2) for d in g1[:n])
    g2 = _grads(l2, t_in + t_w)

    for i, (t, j) in enumerate(zip(g1[n:], j_g1)):
        _check(t, j, TOL2[dtype], i)
    for i, (t, j) in enumerate(zip(g2, tuple(j_g2_in) + tuple(j_g2_w))):
        _check(t, j, TOL2[dtype], i)
    assert _lib.REPLAYS[f"rowblock[{stage.name}]"] == replays + 1
