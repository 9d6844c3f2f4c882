"""The Hopper K3 (``csrc/rowblock_fwd_sm90.cu``): which calls take it, its
shared-memory budget, the CPU path beside it and the rounding points it
copies.

The kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain versions there). Here:

- the dispatch rule ``_lib.k3_sm90_takes``: bfloat16, no weight that
  requires grad, the compress with 2 or 3 parts, the combination and the
  head at d_part 128;
- its budget ``_lib.k3_sm90_smem`` (the C side's layout, mirrored) fits
  the 232,448 bytes a block may have wherever the rule takes;
- on the CPU ``rowblock`` still runs the plain versions, and the wrapper
  still refuses CPU tensors at the shapes the new kernel takes;
- the row-block forward hands the rule the test its backward makes for
  the weight gradients, so a training step keeps the general K3;
- the plain versions ``compress_math``, ``combination_math`` and
  ``head_math``, whose rounding points the kernel copies, agree in
  bfloat16 at the served widths with the JAX package's ``fused_rowblock`` (its Pallas kernel in
  interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatrain_tpu.models.pet import fused_stages as jst
from metatrain_tpu.ops.pallas.rowblock import fused_rowblock
from metatrain_tpu_torch.models.pet import fused_stages as tst
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import rowblock as trb

BF16 = torch.bfloat16
COMPRESS, COMBINATION, HEAD = trb.COMPRESS_CODE, trb.COMBINATION_CODE, trb.HEAD_CODE


@pytest.mark.parametrize("dtype, stage, d_part, w_in, w_hid, w_out, dw, takes", [
    (BF16, COMPRESS, 128, 384, 128, 128, False, True),     # the 3-part compress
    (BF16, COMPRESS, 128, 256, 128, 128, False, True),     # the first GNN layer's
    (BF16, COMBINATION, 128, 256, 256, 128, False, True),
    (torch.float32, COMPRESS, 128, 384, 128, 128, False, False),
    (torch.float32, COMBINATION, 128, 256, 256, 128, False, False),
    (BF16, COMPRESS, 128, 384, 128, 128, True, False),     # a training step's
    (BF16, COMPRESS, 128, 256, 128, 128, True, False),
    (BF16, COMBINATION, 128, 256, 256, 128, True, False),
    (BF16, HEAD, 128, 128, 128, 128, False, True),         # the served head
    (BF16, HEAD, 128, 128, 128, 128, True, False),         # a training step's
    (torch.float32, HEAD, 128, 128, 128, 128, False, False),
    (BF16, HEAD, 256, 256, 256, 256, False, False),        # d_pet 256
    (BF16, HEAD, 128, 128, 256, 256, False, False),        # another d_head
    (BF16, HEAD, 128, 128, 64, 64, False, False),
    (BF16, COMPRESS, 256, 768, 256, 256, False, False),    # d_pet 256
    (BF16, COMBINATION, 256, 512, 512, 256, False, False),  # d_pet 256
    (BF16, COMPRESS, 128, 128, 128, 128, False, False),    # one part
    (BF16, COMPRESS, 128, 512, 128, 128, False, False),    # four parts
    (BF16, COMPRESS, 128, 384, 256, 128, False, False),    # another hidden width
    (BF16, COMPRESS, 128, 384, 128, 256, False, False),    # another output width
    (BF16, COMBINATION, 128, 256, 128, 128, False, False),
])
def test_dispatch_rule(dtype, stage, d_part, w_in, w_hid, w_out, dw, takes):
    assert _lib.k3_sm90_takes(dtype, stage, d_part, w_in, w_hid, w_out, dw) is takes
    # the budget depends on the stage and widths alone
    assert (_lib.k3_sm90_smem(stage, d_part, w_in, w_hid, w_out) > 0) is \
        _lib.k3_sm90_takes(BF16, stage, d_part, w_in, w_hid, w_out)
    # the forward and the backward of the served stages are Hopper kernels
    # at the same widths
    assert _lib.k3_sm90_shape(stage, d_part, w_in, w_hid, w_out) is \
        _lib.k4_sm90_shape(stage, d_part, w_in, w_hid, w_out)


def test_smem_budget_fits_wherever_the_rule_takes():
    taken = {}
    for stage in (COMPRESS, COMBINATION, HEAD):
        for d_part in (64, 128, 256):
            for w_in in range(d_part, 4 * d_part + 1, d_part):
                for w_hid in (d_part, 2 * d_part):
                    nbytes = _lib.k3_sm90_smem(stage, d_part, w_in, w_hid, d_part)
                    if nbytes:
                        assert nbytes <= _lib.MAX_SHARED_BYTES
                        taken[(stage, w_in)] = nbytes
    # the C source's Geo: the ring 49,152, two input tiles 2 x 64 x (w_in +
    # 8) x 2, the h tile 64 x (w_hid + 8) x 2; the combination also two
    # messages tiles 2 x 64 x 136 x 2, the xn tile and 2 x 64 floats; the
    # head its two 128 x 128 weights whole instead of the ring, two x tiles
    # and the h tile
    ring, tile = 3 * 128 * 64 * 2, 64 * 2
    expected = {
        (COMPRESS, 256): ring + 2 * tile * 264 + tile * 136,
        (COMPRESS, 384): ring + 2 * tile * 392 + tile * 136,
        (COMBINATION, 256): ring + 2 * tile * 264 + tile * 264 + 2 * tile * 136 + tile * 264
        + 2 * 64 * 4,
        (HEAD, 128): 2 * 128 * 128 * 2 + 2 * tile * 136 + tile * 136,
    }
    assert taken == expected == {(COMPRESS, 256): 134144, (COMPRESS, 384): 166912,
                                 (COMBINATION, 256): 219648, (HEAD, 128): 117760}


def _bf16_values(a):
    """float32 numpy values that bfloat16 holds exactly (the weights and
    biases as the kernels see them after the wrapper's cast)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _case(name, rows=200, D=128, seed=0):
    """Inputs and weights of a stage at the served widths, float32 arrays
    of bfloat16 values."""
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
        stages = (jst.combination_math, tst.COMBINATION)
    elif name == "head":
        weights = [lecun(D, D), vec(D), lecun(D, D), vec(D)]
        stages = (jst.head_math, tst.HEAD)
    else:
        weights = [lecun(n_parts * D, D), vec(D), lecun(D, D), vec(D)]
        stages = (jst.compress_math, tst.COMPRESS)
    return [_bf16_values(a) for a in inputs], [_bf16_values(a) for a in weights], stages


def _torch(arrays, dtype=BF16):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


STAGES = ["compress2", "compress3", "combination", "head"]


@pytest.mark.parametrize("name", STAGES)
def test_cpu_forward_runs_the_plain_version_at_the_served_widths(name):
    """The stage on CPU bf16 tensors at widths the Hopper K3 takes is the
    plain version, bit for bit; the wrapper itself still refuses CPU
    tensors there."""
    inputs, weights, (_, stage) = _case(name, rows=96)
    xs = _torch(inputs)
    ws = _torch(weights, torch.float32)
    rows, d_part = xs[0].shape
    w_in, w_hid = ws[-4].shape
    assert _lib.k3_sm90_takes(BF16, stage.code, d_part, w_in, w_hid, ws[-2].shape[1])
    out = trb.rowblock(stage, xs, ws)
    assert out.dtype == BF16 and out.shape == (rows, d_part)
    assert torch.equal(out, stage.math(xs, ws))
    with pytest.raises(ValueError, match="cuda"):
        trb.rowblock_fwd_cuda(stage, xs, ws)


@pytest.mark.parametrize("weights_need_grad", [False, True])
def test_rowblock_forward_passes_weight_grads_on(monkeypatch, weights_need_grad):
    """The row-block forward hands K3 the same test its backward makes for
    the weight gradients, so a training step keeps the general K3."""
    seen = []
    first_forward = trb._first_forward

    def spy(*args):
        seen.append(args[-1])
        return first_forward(*args)

    monkeypatch.setattr(trb, "_first_forward", spy)
    inputs, weights, (_, stage) = _case("compress2", rows=32)
    xs = [x.requires_grad_(True) for x in _torch(inputs, torch.float64)]
    ws = [w.requires_grad_(weights_need_grad) for w in _torch(weights, torch.float64)]
    out = trb.rowblock(stage, xs, ws)
    assert seen == [weights_need_grad]
    grads = torch.autograd.grad(out.sum(), xs)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("name", STAGES)
def test_plain_forward_matches_jax_in_bf16_at_the_served_widths(name):
    """The plain versions round where the JAX package's stage math does
    (xn, h and the output; the LayerNorm statistics and the products'
    sums in float), so in bfloat16 at D = 128 the port's plain version and
    ``fused_rowblock`` (the Pallas kernel in interpret mode) agree to
    float32 summation order: relative RMS <= 1e-2. The Hopper K3 copies
    these rounding points."""
    inputs, weights, (j_math, stage) = _case(name, seed=7)
    bf = jnp.bfloat16
    (j_out,) = fused_rowblock(j_math, tuple(jnp.asarray(a, bf) for a in inputs),
                              tuple(jnp.asarray(a, jnp.float32) for a in weights))
    t_out = stage.math(_torch(inputs), _torch(weights, torch.float32))
    assert t_out.dtype == BF16 and t_out.shape == j_out.shape
    err = _rel_rms(t_out.float().numpy(), np.asarray(j_out, np.float32))
    assert err <= 1e-2, err
