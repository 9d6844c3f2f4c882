"""The Hopper K3 and K4 heads (``csrc/rowblock_{fwd,bwd}_sm90.cu``): the
C entry points' parameters as ``_lib`` binds them, the shared-front check's
wrapper, and the served head at the plain level.

The kernels run only on the card (``chip_smoke.py`` holds them against the
plain versions there, and the Hopper K3 head's output against the Hopper K4
head's recompute of it). Here:

- every ``extern "C"`` entry of the row-block sources takes the parameters
  ``_lib`` declares for it: a parameter the head added on one side only
  would pass pointers into the wrong slots, which only the card would show;
- ``k4_sm90_head_front`` refuses CPU tensors;
- ``tools/k2_split.py --body k3-head|k4-head`` finds its phase marks;
- the PET head, served as ``rowblock`` runs it in bfloat16 at d_part 128,
  is the plain version on the CPU forward and backward, and both agree
  with the JAX package's row-block head (the Pallas kernel in interpret
  mode, and the hand-written backward).
"""

import ctypes
import importlib.util
import re

import jax
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
_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _params(source: str, name: str):
    """The ctypes types of the parameters of ``extern "C" ... name(...)``
    in ``source``: pointers to void as c_void_p, ``int*`` as a pointer to
    c_int, scalars by their C type."""
    m = re.search(r'extern "C" [\w ]+?\b' + name + r"\(([^)]*)\)", source)
    assert m, name
    types = []
    for param in m.group(1).split(","):
        param = " ".join(param.replace("const", "").split())  # "void* x0", "long long rows"
        if "*" in param:
            base = param.split("*")[0].strip()
            types.append(ctypes.c_void_p if base == "void" else ctypes.POINTER(_TYPES[base]))
        else:
            types.append(_TYPES[param.rsplit(" ", 1)[0]])
    return types


@pytest.mark.parametrize("source", ["rowblock_fwd_sm90.cu", "rowblock_bwd_sm90.cu"])
def test_entry_points_take_the_bound_parameters(source):
    text = (_lib.CSRC / source).read_text()
    names = re.findall(r'extern "C" [\w ]+?\b(mtt_\w+)\(', text)
    assert len(names) == 3
    for name in names:
        assert _params(text, name) == _lib._SIGNATURES[name], name


def _case(rows=96, D=128, seed=0):
    rng = np.random.default_rng(seed)

    def bf16_values(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()

    x = bf16_values(rng.normal(size=(rows, D)))
    weights = [bf16_values(a) for a in (rng.normal(size=(D, D)) / np.sqrt(D), 0.1 * rng.normal(size=D),
                                        rng.normal(size=(D, D)) / np.sqrt(D), 0.1 * rng.normal(size=D))]
    g = bf16_values(rng.normal(size=(rows, D)))
    return x, weights, g


def test_head_front_check_refuses_cpu_tensors():
    x, weights, g = _case()
    xt, gt = torch.from_numpy(x).to(BF16), torch.from_numpy(g).to(BF16)
    with pytest.raises(ValueError, match="cuda"):
        trb.k4_sm90_head_front(tst.HEAD, [xt], [torch.from_numpy(w) for w in weights], gt)


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def test_served_head_forward_and_backward_match_jax():
    """The head through ``rowblock`` on CPU bf16 tensors (the plain
    versions the Hopper heads copy) against the JAX package's row-block
    head: ``fused_rowblock`` in interpret mode for the output, ``jax.vjp``
    of it (the registered hand-written ``head_bwd``) for d_x; relative RMS
    <= 1e-2 each, the summation order of float32 products apart."""
    x, weights, g = _case(rows=160, seed=3)
    xt = torch.from_numpy(x).to(BF16).requires_grad_(True)
    ws = [torch.from_numpy(w) for w in weights]
    out = trb.rowblock(tst.HEAD, [xt], ws)
    (d_x,) = torch.autograd.grad(out, [xt], torch.from_numpy(g).to(BF16))
    jw = tuple(jnp.asarray(w, jnp.float32) for w in weights)
    (j_out,), vjp = jax.vjp(lambda a: fused_rowblock(jst.head_math, (a,), jw),
                            jnp.asarray(x, jnp.bfloat16))
    (j_dx,) = vjp((jnp.asarray(g, jnp.bfloat16),))
    assert out.dtype == d_x.dtype == BF16
    assert _rel_rms(out.detach().float().numpy(), np.asarray(j_out, np.float32)) <= 1e-2
    assert _rel_rms(d_x.float().numpy(), np.asarray(j_dx, np.float32)) <= 1e-2


@pytest.mark.parametrize("body", ["k3-head", "k4-head"])
def test_phase_split_tool_finds_the_head_marks(body):
    """``tools/k2_split.py`` instruments copies of the shared ``head_front``
    and of each head kernel at its phase marks: every mark is in its source
    once, the kernel's phases numbered after the front's."""
    path = _lib.CSRC.parent / "tools" / "k2_split.py"
    spec = importlib.util.spec_from_file_location("k2_split", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    front = tool.instrument((_lib.CSRC / "rowblock_sm90.cuh").read_text(), tool.HEAD_FRONT)
    source, marks, names = {
        "k3-head": ("rowblock_fwd_sm90.cu", tool.K3_HEAD, tool.K3_HEAD_PHASES),
        "k4-head": ("rowblock_bwd_sm90.cu", tool.K4_HEAD, tool.K4_HEAD_PHASES)}[body]
    unit = tool.instrument((_lib.CSRC / source).read_text(), marks, 3)
    assert [f"SPLIT({i})" in front for i in range(4)] == [True] * 3 + [False]
    n = len(names)
    assert [f"SPLIT({i})" in unit for i in range(n + 1)] == [False] * 3 + [True] * (n - 3) + [False]
