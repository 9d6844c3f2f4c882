"""The Hopper K4 (``csrc/rowblock_bwd_sm90.cu``): which calls take it, its
shared-memory budget, the CPU path beside it, the rounding points it copies,
and the repair that keeps the Hopper K1 off the weight-gradient path.

The kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain versions there). Here:

- the dispatch rule ``_lib.k4_sm90_takes``: bfloat16 without weight
  gradients, the compress with 2 or 3 parts, the combination and the head
  at d_part 128;
- its budget ``_lib.k4_sm90_smem`` (the C side's layout, mirrored) fits
  the 232,448 bytes a block may have wherever the rule takes;
- on the CPU ``rowblock`` still runs the plain versions, and the wrapper
  still refuses CPU tensors at the shapes the new kernel takes;
- the plain versions ``compress_bwd``, ``combination_bwd`` and
  ``head_bwd``, whose rounding points the kernel copies, agree with the JAX
  package's in bfloat16 at the served widths;
- ``k1_sm90_takes`` refuses a call whose weights require grad, and the
  fused layer's forward tells it so.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatrain_tpu.models.pet import fused_stages as jst
from metatrain_tpu_torch.models.pet import fused_stages as tst
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import fused_layer as tfl
from metatrain_tpu_torch.ops.kernels import rowblock as trb

BF16 = torch.bfloat16
COMPRESS, COMBINATION, HEAD = trb.COMPRESS_CODE, trb.COMBINATION_CODE, trb.HEAD_CODE


@pytest.mark.parametrize("dtype, stage, d_part, w_in, w_hid, w_out, dw, takes", [
    (BF16, COMPRESS, 128, 384, 128, 128, False, True),     # the 3-part compress
    (BF16, COMPRESS, 128, 256, 128, 128, False, True),     # the first GNN layer's
    (BF16, COMBINATION, 128, 256, 256, 128, False, True),
    (torch.float32, COMPRESS, 128, 384, 128, 128, False, False),
    (torch.float32, COMBINATION, 128, 256, 256, 128, False, False),
    (BF16, COMPRESS, 128, 384, 128, 128, True, False),     # K4-dW
    (BF16, COMBINATION, 128, 256, 256, 128, True, False),  # K4-dW
    (BF16, HEAD, 128, 128, 128, 128, False, True),         # the served head
    (BF16, HEAD, 128, 128, 128, 128, True, False),         # K4-dW
    (torch.float32, HEAD, 128, 128, 128, 128, False, False),
    (BF16, HEAD, 256, 256, 256, 256, False, False),        # d_pet 256
    (BF16, HEAD, 128, 128, 256, 256, False, False),        # another d_head
    (BF16, HEAD, 128, 128, 64, 64, False, False),
    (BF16, COMPRESS, 256, 768, 256, 256, False, False),    # d_pet 256
    (BF16, COMBINATION, 256, 512, 512, 256, False, False),  # d_pet 256
    (BF16, COMPRESS, 128, 128, 128, 128, False, False),    # one part
    (BF16, COMPRESS, 128, 384, 256, 128, False, False),    # another hidden width
    (BF16, COMBINATION, 128, 256, 128, 128, False, False),
])
def test_dispatch_rule(dtype, stage, d_part, w_in, w_hid, w_out, dw, takes):
    assert _lib.k4_sm90_takes(dtype, stage, d_part, w_in, w_hid, w_out, dw) is takes
    # the budget depends on the stage and widths alone
    assert (_lib.k4_sm90_smem(stage, d_part, w_in, w_hid, w_out) > 0) is \
        _lib.k4_sm90_takes(BF16, stage, d_part, w_in, w_hid, w_out)


def test_smem_budget_fits_wherever_the_rule_takes():
    taken = {}
    for stage in (COMPRESS, COMBINATION, HEAD):
        for d_part in (64, 128, 256):
            for w_in in range(d_part, 4 * d_part + 1, d_part):
                for w_hid in (d_part, 2 * d_part):
                    nbytes = _lib.k4_sm90_smem(stage, d_part, w_in, w_hid, d_part)
                    if nbytes:
                        assert nbytes <= _lib.MAX_SHARED_BYTES
                        taken[(stage, w_in)] = nbytes
    # the ring, two input and two g tiles, d_pre; the combination also xn
    # and its row statistics; the head its four 128 x 128 weights whole
    # instead of the ring, two x and two g tiles and the h0 / d_pre tile
    assert 4 * 128 * 128 * 2 + 5 * 64 * 136 * 2 == 218112
    assert taken == {(COMPRESS, 256): 168960, (COMPRESS, 384): 201728,
                     (COMBINATION, 256): 220672, (HEAD, 128): 218112}


def _bf16_values(a):
    """float32 numpy values that bfloat16 holds exactly (the weights and
    biases as the kernels see them after the wrapper's cast)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _case(name, rows=200, D=128, seed=0):
    """Inputs, weights and the cotangent of a stage at the served widths,
    float32 arrays of bfloat16 values."""
    rng = np.random.default_rng(seed)

    def lecun(i, o):
        return rng.normal(size=(i, o)) / np.sqrt(i)

    def vec(n, base=0.0):
        return base + 0.1 * rng.normal(size=n)

    n_parts = {"compress2": 2, "compress3": 3, "combination": 3, "head": 1}[name]
    inputs = [rng.normal(size=(rows, D)) for _ in range(n_parts)]
    if name == "combination":
        weights = [vec(2 * D, 1.0), vec(2 * D), lecun(2 * D, 2 * D), vec(2 * D),
                   lecun(2 * D, D), vec(D)]
        stages = (jst.combination_bwd, tst.COMBINATION)
    elif name == "head":
        weights = [lecun(D, D), vec(D), lecun(D, D), vec(D)]
        stages = (jst.head_bwd, tst.HEAD)
    else:
        weights = [lecun(n_parts * D, D), vec(D), lecun(D, D), vec(D)]
        stages = (jst.compress_bwd, tst.COMPRESS)
    g = rng.normal(size=(rows, D))
    return ([_bf16_values(a) for a in inputs], [_bf16_values(a) for a in weights],
            _bf16_values(g), stages)


def _torch(arrays, dtype=BF16):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


STAGES = ["compress2", "compress3", "combination", "head"]


@pytest.mark.parametrize("name", STAGES)
def test_cpu_backward_runs_the_plain_version_at_the_served_widths(name):
    """The stage's gradient on CPU bf16 tensors at widths the Hopper K4
    takes is the plain version's, bit for bit; the wrapper itself still
    refuses CPU tensors there."""
    inputs, weights, g, (_, stage) = _case(name, rows=96)
    xs = [x.requires_grad_(True) for x in _torch(inputs)]
    ws = _torch(weights, torch.float32)
    gt = torch.from_numpy(g).to(BF16)
    rows, d_part = xs[0].shape
    w_in, w_hid = ws[-4].shape
    assert _lib.k4_sm90_takes(BF16, stage.code, d_part, w_in, w_hid, ws[-2].shape[1])
    out = trb.rowblock(stage, xs, ws)
    grads = torch.autograd.grad(out, xs, gt)
    plain = stage.bwd([x.detach() for x in xs], ws, gt)
    for a, b in zip(grads, plain):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="cuda"):
        trb.rowblock_bwd_cuda(stage, [x.detach() for x in xs], ws, gt)


@pytest.mark.parametrize("name", STAGES)
def test_plain_backward_matches_jax_in_bf16_at_the_served_widths(name):
    """The plain versions round where the JAX package's hand-written
    backwards do (g, xn, h0, d_pre, the outputs; pre and the LayerNorm
    backward in float), so in bfloat16 at D = 128 the two agree to float32
    summation order: relative RMS <= 1e-2 per output. The Hopper K4 copies
    these rounding points."""
    inputs, weights, g, (j_bwd, stage) = _case(name, seed=7)
    bf = jnp.bfloat16
    j_out, _ = j_bwd(tuple(jnp.asarray(a, bf) for a in inputs),
                     tuple(jnp.asarray(a, jnp.float32) for a in weights),
                     (jnp.asarray(g, bf),), False)
    t_out = stage.bwd(_torch(inputs), _torch(weights, torch.float32), torch.from_numpy(g).to(BF16))
    assert len(t_out) == len(j_out)
    for t, j in zip(t_out, j_out):
        assert t.dtype == BF16
        err = _rel_rms(t.float().numpy(), np.asarray(j, np.float32))
        assert err <= 1e-2, err


def test_k1_sm90_refuses_weight_grads():
    assert _lib.k1_sm90_takes(BF16, 64, 128, 8, 256)
    assert not _lib.k1_sm90_takes(BF16, 64, 128, 8, 256, weight_grads=True)
    # the Hopper K2 already refused them: the two rules agree again
    assert not _lib.k2_sm90_takes(BF16, 64, 128, 8, 256, weight_grads=True)


@pytest.mark.parametrize("weights_need_grad", [False, True])
def test_fused_layer_forward_passes_weight_grads_on(monkeypatch, weights_need_grad):
    """The fused layer's forward hands K1 the same test its backward makes
    for the weight gradients, so a training call keeps the general K1."""
    seen = []
    first_forward = tfl._first_forward

    def spy(*args):
        seen.append(args[-1])
        return first_forward(*args)

    monkeypatch.setattr(tfl, "_first_forward", spy)
    rng = np.random.default_rng(1)
    A, M, D, H, F = 2, 16, 32, 2, 64
    shapes = [(D,), (D, 3 * D), (3 * D,), (D, D), (D,), (D,), (D, 2 * F), (2 * F,), (F, D), (D,)]
    w = tfl.LayerWeights(*(torch.from_numpy(rng.normal(size=s) * 0.1).requires_grad_(
        weights_need_grad) for s in shapes))
    edges = torch.from_numpy(rng.normal(size=(A, M, D))).requires_grad_(True)
    center = torch.from_numpy(rng.normal(size=(A, D)))
    cf = torch.ones(A, M, dtype=torch.float64)
    out = tfl.fused_transformer_layer(edges, center, cf, w, H, 1.0 / math.sqrt(D // H))
    assert seen == [weights_need_grad]
    assert torch.isfinite(out[0]).all()
