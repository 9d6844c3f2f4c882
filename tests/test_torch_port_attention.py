"""Port parity: the window attention and the reversed-edge permute (the plain
versions of their CUDA kernels, and the ``autograd.Function``s around them)
vs the JAX package.

The same inputs, made with numpy from a seed, go through the JAX package's
``reference_window_attention`` and its interpret-mode Pallas
``window_attention``, and through the port on the CPU. Windows have T odd,
as PET's center-first windows (T = M + 1), and the bias is a log-cutoff
with padded keys at log(1e-15), exactly representable in float32 (the
Pallas kernel casts the bias to float32).

- Against the reference, in float64: forward, ``dq/dk/dv/dbias`` and
  grad-of-grad (through the port's Function, with a replay chunk that does
  not divide the atom count) to 1e-12.
- Against the interpret-mode Pallas kernel: its products accumulate in
  float32 whatever the input dtype (``preferred_element_type``), and it
  returns dbias in float32, so the bound is float32's (1e-6) there.
- The permute and its accumulate transpose equal the JAX package's
  ``color_gather.reverse_pair`` on a plain batch bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import rel
from metatrain_tpu.ops.pallas import color_gather as jcg
from metatrain_tpu.ops.pallas.attention import reference_window_attention, window_attention
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import attention as tat
from metatrain_tpu_torch.ops.kernels import permute as tpm

H, SCALE = 2, 0.35
CHUNK = 2  # does not divide A: the replay's last chunk is short
PALLAS_TOL = 1e-6  # the Pallas kernel accumulates in float32


def _inputs(A, T, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g, hk = (rng.normal(size=(A, T, D)) for _ in range(5))
    n_real = rng.integers((T - 1) // 2, T - 1, size=(A, 1))
    cf = rng.uniform(0.0, 1.0, size=(A, T - 1)) * (np.arange(T - 1)[None] < n_real)
    bias = np.log(np.clip(np.concatenate([np.ones((A, 1)), cf], axis=1), 1e-15, None))
    bias = bias.astype(np.float32).astype(np.float64)
    return q, k, v, bias, g, hk


def _l2_weights(A, T, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(A, T))


def _jax_grads(fn, q, k, v, bias, g, hk, hb):
    """First and second derivatives of the JAX attention ``fn``."""
    def l1(*x):
        return jnp.sum(fn(*x, H, SCALE) * g)

    def l2(*x):
        dq, dk, dv, db = jax.grad(l1, argnums=(0, 1, 2, 3))(*x)
        return jnp.sum(dq**2) + jnp.sum(dk * hk) + jnp.sum(dv**2) + jnp.sum(db * hb)

    args = tuple(jnp.asarray(a) for a in (q, k, v, bias))
    return fn(*args, H, SCALE), jax.grad(l1, argnums=(0, 1, 2, 3))(*args), jax.grad(
        l2, argnums=(0, 1, 2, 3))(*args)


def _port_grads(q, k, v, bias, g, hk, hb):
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    out = tat.window_attention(*ins, H, SCALE, chunk=CHUNK)
    g1 = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)), ins, create_graph=True)
    l2 = (torch.sum(g1[0] ** 2) + torch.sum(g1[1] * torch.from_numpy(hk))
          + torch.sum(g1[2] ** 2) + torch.sum(g1[3] * torch.from_numpy(hb)))
    g2 = torch.autograd.grad(l2, ins)
    return out, g1, g2


@pytest.mark.parametrize("A,T,D", [(5, 9, 16), (3, 17, 32)])
def test_plain_attention_matches_reference(A, T, D):
    q, k, v, bias, g, hk = _inputs(A, T, D, seed=0)
    t = [torch.from_numpy(a) for a in (q, k, v, bias, g)]
    out = tat.attention_math(*t[:4], H, SCALE)
    ref = reference_window_attention(*(jnp.asarray(a) for a in (q, k, v, bias)), H, SCALE)
    assert out.dtype == torch.float64
    assert rel(out.numpy(), ref) < 1e-12
    grads = tat.attention_bwd_math(*t, H, SCALE)
    _, vjp = jax.vjp(lambda *x: reference_window_attention(*x, H, SCALE),
                     *(jnp.asarray(a) for a in (q, k, v, bias)))
    for ours, theirs in zip(grads, vjp(jnp.asarray(g))):
        assert rel(ours.numpy(), theirs) < 1e-12


def test_attention_function_grad_of_grad_matches_reference():
    A, T, D = 5, 9, 16
    q, k, v, bias, g, hk = _inputs(A, T, D, seed=1)
    hb = _l2_weights(A, T, seed=2)
    j_out, j_g1, j_g2 = _jax_grads(reference_window_attention, q, k, v, bias, g, hk, hb)
    replays = _lib.REPLAYS["window_attention"]
    out, g1, g2 = _port_grads(q, k, v, bias, g, hk, hb)
    assert _lib.REPLAYS["window_attention"] == replays + 1
    assert rel(out.detach().numpy(), j_out) < 1e-12
    for ours, theirs in zip(g1 + g2, tuple(j_g1) + tuple(j_g2)):
        assert ours.dtype == torch.float64
        assert rel(ours.detach().numpy(), theirs) < 1e-12


def test_attention_matches_pallas_interpret():
    A, T, D = 4, 9, 16
    q, k, v, bias, g, hk = _inputs(A, T, D, seed=3)
    hb = _l2_weights(A, T, seed=4)
    j_out, j_g1, j_g2 = _jax_grads(window_attention, q, k, v, bias, g, hk, hb)
    out, g1, g2 = _port_grads(q, k, v, bias, g, hk, hb)
    assert rel(out.detach().numpy(), j_out) < PALLAS_TOL
    for ours, theirs in zip(g1 + g2, tuple(j_g1) + tuple(j_g2)):
        assert rel(ours.detach().numpy(), theirs) < PALLAS_TOL


def test_attention_float32_function_matches_twin():
    """float32 through the Function equals the plain twin's autograd."""
    A, T, D = 5, 9, 16
    q, k, v, bias, g, _ = (a.astype(np.float32) for a in _inputs(A, T, D, seed=5))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    ref = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    out = tat.window_attention(*ins, H, SCALE)
    out_ref = tat.attention_math(*ref, H, SCALE)
    assert torch.equal(out, out_ref)
    ours = torch.autograd.grad(out, ins, torch.from_numpy(g))
    theirs = torch.autograd.grad(out_ref, ref, torch.from_numpy(g))
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.float32
        assert rel(a.numpy(), b.numpy()) < 1e-6


def _plain_batch(A=6, M=4, seed=0):
    """An involutive reversal index of a plain NEF batch: random pairs of
    slots, the rest (padding) mapped to themselves."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(A * M)
    n = (A * M // 2) * 3 // 4
    rev = np.arange(A * M)
    rev[order[:n]], rev[order[n:2 * n]] = order[n:2 * n], order[:n]
    return rev.reshape(A, M)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_reverse_pair_and_transpose_match_jax_bitwise(dtype):
    A, M, D = 6, 4, 8
    rev = _plain_batch(A, M)
    rng = np.random.default_rng(1)
    x, g0, g1 = (rng.normal(size=(A, M, D)).astype(dtype) for _ in range(3))

    def j_pair(xx):
        return jcg.reverse_pair(xx, {"nbr_reverse": jnp.asarray(rev)})

    j_out, vjp = jax.vjp(j_pair, jnp.asarray(x))
    (j_dx,) = vjp((jnp.asarray(g0), jnp.asarray(g1)))
    (j_dx_rev,) = vjp((jnp.zeros_like(jnp.asarray(g0)), jnp.asarray(g1)))

    tx = torch.from_numpy(x).requires_grad_(True)
    same, reversed_ = tpm.reverse_pair(tx, torch.from_numpy(rev))
    np.testing.assert_array_equal(same.detach().numpy(), np.asarray(j_out[0]))
    np.testing.assert_array_equal(reversed_.detach().numpy(), np.asarray(j_out[1]))
    (dx,) = torch.autograd.grad((same, reversed_), tx,
                                (torch.from_numpy(g0), torch.from_numpy(g1)))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(j_dx))
    # only the reversed output used: the plain permute of its cotangent
    (dx_rev,) = torch.autograd.grad(tpm.reverse_pair(tx, torch.from_numpy(rev))[1], tx,
                                    torch.from_numpy(g1))
    np.testing.assert_array_equal(dx_rev.numpy(), np.asarray(j_dx_rev))
    # the accumulate variant is one index_select and one add
    flat = torch.from_numpy(rev.reshape(-1))
    acc = tpm.permute_math(torch.from_numpy(g1).reshape(A * M, D), flat,
                           torch.from_numpy(g0).reshape(A * M, D))
    np.testing.assert_array_equal(acc.numpy().reshape(A, M, D), np.asarray(j_dx))


def test_reverse_pair_grad_of_grad():
    """Second derivatives through the pair (its backward is the permute
    Function again) equal those of index_select under autograd."""
    A, M, D = 6, 4, 8
    rev = torch.from_numpy(_plain_batch(A, M, seed=2))
    rng = np.random.default_rng(3)
    x0, w = (torch.from_numpy(rng.normal(size=(A, M, D))) for _ in range(2))

    def second(pair):
        x = x0.clone().requires_grad_(True)
        same, reversed_ = pair(x)
        l1 = torch.sum(torch.sin(same) * reversed_ * w)
        (g,) = torch.autograd.grad(l1, x, create_graph=True)
        (g2,) = torch.autograd.grad(torch.sum(g**2), x)
        return g, g2

    def plain_pair(x):
        return x, x.reshape(A * M, D)[rev.reshape(-1)].reshape(A, M, D)

    ours = second(lambda x: tpm.reverse_pair(x, rev))
    theirs = second(plain_pair)
    for a, b in zip(ours, theirs):
        assert torch.allclose(a, b, rtol=1e-13, atol=1e-13)
