"""Port parity: the fused PET layer (plain versions of K1/K2) vs the JAX package.

The same inputs, made with numpy from a seed, go through the JAX
package's ``_layer_math`` / ``_layer_bwd_math`` (its plain references;
no Pallas) and through the port's ``layer_math`` / ``layer_bwd_math``
and its ``autograd.Function``. float64 agrees to 1e-12 relative
(different but exact formulations: max-subtracted vs plain exponentials,
reassociated sums); float32 to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import rel
from metatrain_tpu.ops.pallas import fused_layer as jfl
from metatrain_tpu_torch.ops.kernels import fused_layer as tfl

A, M, D, H, F = 8, 16, 32, 4, 64
SCALE = 1.0 / np.sqrt(D // H)
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)

    def lecun(i, o):
        return rng.normal(size=(i, o)) / np.sqrt(i)

    weights = [
        1 + 0.1 * rng.normal(size=D), lecun(D, 3 * D), 0.1 * rng.normal(size=3 * D),
        lecun(D, D), 0.1 * rng.normal(size=D), 1 + 0.1 * rng.normal(size=D),
        lecun(D, 2 * F), 0.1 * rng.normal(size=2 * F), lecun(F, D), 0.1 * rng.normal(size=D),
    ]
    edges = rng.normal(size=(A, M, D))
    center = rng.normal(size=(A, D))
    n_real = rng.integers(M // 2, M - 1, size=(A, 1))
    cf = rng.uniform(0.05, 1.0, size=(A, M)) * (np.arange(M)[None] < n_real)
    cf[:, M - 1] = 1.0
    g_edge = rng.normal(size=(A, M, D))
    g_center = rng.normal(size=(A, D))
    cast = [x.astype(dtype) for x in (edges, center, g_edge, g_center)]
    return cast[0], cast[1], cf.astype(dtype), [w.astype(dtype) for w in weights], cast[2], cast[3]



def _jax_weights(weights):
    return jfl.LayerWeights(*(jnp.asarray(w) for w in weights))


def _torch_weights(weights):
    return tfl.LayerWeights(*(torch.from_numpy(w) for w in weights))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_forward_matches_jax(dtype):
    edges, center, cf, w, _, _ = _inputs(dtype)
    j_edge, j_center = jfl._layer_math(
        jnp.asarray(edges), jnp.asarray(center), jnp.asarray(cf), _jax_weights(w), H, SCALE
    )
    t_edge, t_center = tfl.layer_math(
        torch.from_numpy(edges), torch.from_numpy(center), torch.from_numpy(cf),
        _torch_weights(w), H, SCALE,
    )
    assert rel(t_edge, j_edge) < TOL[dtype]
    assert rel(t_center, j_center) < TOL[dtype]
    assert (t_edge[:, M - 1] == 0).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_input_gradients_match_jax(dtype):
    edges, center, cf, w, g_edge, g_center = _inputs(dtype, seed=1)
    jw = _jax_weights(w)
    j_hand = jfl._layer_bwd_math(
        jnp.asarray(edges), jnp.asarray(center), jnp.asarray(cf), jw,
        jnp.asarray(g_edge), jnp.asarray(g_center), H, SCALE, weight_grads=False,
    )[:3]
    _, vjp = jax.vjp(
        lambda e, c, f: jfl._layer_math(e, c, f, jw, H, SCALE),
        jnp.asarray(edges), jnp.asarray(center), jnp.asarray(cf),
    )
    j_auto = vjp((jnp.asarray(g_edge), jnp.asarray(g_center)))
    t_bwd = tfl.layer_bwd_math(
        torch.from_numpy(edges), torch.from_numpy(center), torch.from_numpy(cf),
        _torch_weights(w), torch.from_numpy(g_edge), torch.from_numpy(g_center), H, SCALE,
    )
    # the JAX hand-written backward returns d_cf in float32 whatever the
    # compute dtype; autodiff keeps float64
    hand_tol = (TOL[dtype], TOL[dtype], max(TOL[dtype], 1e-6))
    for t, jh, ja, tol in zip(t_bwd, j_hand, j_auto, hand_tol):
        assert rel(t, jh) < tol
        assert rel(t, ja) < TOL[dtype]
    # the center slot's cotangent goes to d_center; forces need d_cf
    assert (t_bwd[0][:, M - 1] == 0).all()
    assert np.abs(t_bwd[2].numpy()).max() > 0


def test_autograd_function_on_cpu_matches_jax_vjp():
    edges, center, cf, w, g_edge, g_center = _inputs(np.float64, seed=2)
    jw = _jax_weights(w)
    _, vjp = jax.vjp(
        lambda e, c, f: jfl._layer_math(e, c, f, jw, H, SCALE),
        jnp.asarray(edges), jnp.asarray(center), jnp.asarray(cf),
    )
    j_grads = vjp((jnp.asarray(g_edge), jnp.asarray(g_center)))
    x = [torch.from_numpy(a).requires_grad_(True) for a in (edges, center, cf)]
    out = tfl.fused_transformer_layer(*x, _torch_weights(w), H, SCALE)
    grads = torch.autograd.grad(out, x, (torch.from_numpy(g_edge), torch.from_numpy(g_center)))
    for t, j in zip(grads, j_grads):
        assert rel(t, j) < 1e-12


def test_weight_gradients_raise():
    edges, center, cf, w, _, _ = _inputs(np.float64)
    tw = _torch_weights(w)
    tw = tw._replace(w_qkv=tw.w_qkv.clone().requires_grad_(True))
    e = torch.from_numpy(edges).requires_grad_(True)
    edge_out, _ = tfl.fused_transformer_layer(e, torch.from_numpy(center), torch.from_numpy(cf), tw, H, SCALE)
    with pytest.raises(NotImplementedError, match="training slice"):
        edge_out.sum().backward()


def test_cuda_wrappers_reject_cpu_tensors_and_bad_shapes():
    edges, center, cf, w, g_edge, g_center = _inputs(np.float32)
    args = [torch.from_numpy(a) for a in (edges, center, cf)]
    with pytest.raises(ValueError, match="cuda"):
        tfl.fused_layer_fwd_cuda(*args, _torch_weights(w), H, SCALE)
    with pytest.raises(ValueError, match="cuda"):
        tfl.fused_layer_bwd_cuda(*args, _torch_weights(w), torch.from_numpy(g_edge),
                                 torch.from_numpy(g_center), H, SCALE)
    with pytest.raises(ValueError, match="M % 16"):
        tfl.fused_layer_fwd_cuda(args[0][:, :12], args[1], args[2][:, :12], _torch_weights(w), H, SCALE)
