"""The Hopper absmax pass (``csrc/int8_absmax_sm90.cu``): the per-block q and
k scales of the served int8 call, from the Hopper K1-int8's own RMSNorm and
q and k panels.

The kernel runs only on the card (``chip_smoke.py`` holds its scales bit
for bit against the per-block max of the Hopper K1-int8's q|k, and within
one bf16 ulp of ``int8_block_scales``). Here:

- the routing rule: ``_lib.absmax_sm90_takes`` is the Hopper K1-int8's
  (the served int8 call), not the int8 training step's, M = 96's, d_pet
  256's or float32's; W8A8 quantizes with static scales and runs no pass;
- ``_lib.absmax_sm90_smem`` follows the C source's layout, and the new
  entries take the parameters ``_lib`` binds;
- the wrappers' routing on a stub library: the served layer launches the
  Hopper pass, a layer whose weights require grad or ``sm90=False`` the
  general one;
- on the CPU ``int8_scales_for`` is ``int8_block_scales`` bit for bit;
- a float emulation of the kernel's reduction (its ranges of atom pairs
  per block, the per-atom max over rows m < M, the per-block max through
  the float bits, a partial last block's padding, the quotient) equals
  ``int8_block_scales`` bitwise on the twin's q and k, and JAX's
  ``_quantize_i8`` scales over the padded block.
"""

import ctypes
import importlib.util
import re

import numpy as np
import pytest
import torch

from metatrain_tpu.ops.pallas import fused_layer as jfl
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import fused_layer as tfl
from test_torch_port_head_sm90 import _params
from test_torch_port_int8_scores import _jax, _jax_qk, _padded_block, _torch
from test_torch_port_int8_sm90 import _torch_case

BF16 = torch.bfloat16
ROOT = _lib.CSRC.parents[1]
SOURCE = "int8_absmax_sm90.cu"
ENTRIES = ["mtt_int8_absmax_sm90_ok", "mtt_int8_absmax_sm90_smem", "mtt_int8_absmax_sm90"]


@pytest.mark.parametrize("dtype, M, D, H, F, weight_grads, takes", [
    (BF16, 64, 128, 8, 256, False, True),             # the served int8 call
    (BF16, 48, 128, 8, 256, False, True),
    (BF16, 16, 128, 8, 512, False, True),
    (BF16, 64, 128, 8, 256, True, False),             # the int8 training step
    (BF16, 96, 128, 8, 256, False, False),            # M 80-128
    (BF16, 64, 256, 8, 512, False, False),            # d_pet 256
    (BF16, 64, 128, 16, 256, False, False),           # heads of 8
    (torch.float32, 64, 128, 8, 256, False, False),   # no int8 scores in float32
])
def test_routing_rule_is_the_hopper_k1_int8s(dtype, M, D, H, F, weight_grads, takes):
    assert _lib.absmax_sm90_takes(dtype, M, D, H, F, weight_grads=weight_grads) is takes
    assert _lib.k1_sm90_takes(dtype, M, D, H, F, int8=True, weight_grads=weight_grads) is takes
    # the budget is the shape's (bfloat16, no weight requiring grad)
    assert (_lib.absmax_sm90_smem(M, D, H, F) > 0) is _lib.sm90_shape(M, D, H, F)


def _c_constants(*sources):
    """The ``constexpr int`` constants of the C sources, evaluated in order
    (comments dropped; several names in one declaration allowed)."""
    env = {}
    for source in sources:
        text = re.sub(r"//[^\n]*", "", (_lib.CSRC / source).read_text())
        for decl in re.findall(r"constexpr int ([^;]+);", text):
            for part in decl.split(","):
                name, expr = (x.strip() for x in part.split("=", 1))
                env[name] = eval(expr, {}, dict(env))  # noqa: S307 - integer arithmetic
    return env


def test_smem_follows_the_c_layout():
    """The budget is the C source's kSmemBytes wherever the rule takes the
    shape (one block per SM fits), and 0 elsewhere."""
    c = _c_constants("layer_sm90.cuh", SOURCE)
    assert c["kSmemBytes"] == 166400 <= _lib.MAX_SHARED_BYTES
    # the resident weights: the q and k rows of w_qkv^T, 2D x D bf16
    assert c["kWeightBytes"] == 2 * c["D"] * c["D"] * 2
    taken = 0
    for M in range(16, 257, 16):
        for F in range(128, 1025, 128):
            got = _lib.absmax_sm90_smem(M, 128, 8, F)
            assert got == (c["kSmemBytes"] if M <= 64 else 0)
            taken += got > 0
    assert taken == 4 * 8
    assert _lib.absmax_sm90_smem(64, 256, 8, 512) == _lib.absmax_sm90_smem(64, 128, 16, 256) == 0


def test_entry_points_take_the_bound_parameters():
    text = (_lib.CSRC / SOURCE).read_text()
    assert re.findall(r'extern "C" [\w ]+?\b(mtt_\w+)\(', text) == ENTRIES
    for name in ENTRIES:
        params = [ctypes.c_void_p if t == ctypes.POINTER(ctypes.c_float) else t
                  for t in _params(text, name)]
        assert params == _lib._SIGNATURES[name], name
    assert SOURCE in _lib.SOURCES
    # the quotient step is the general pass's, shared through one header
    assert '#include "int8_absmax.cuh"' in text
    assert "int8_scales_kernel" not in text
    assert "mtt::int8_scales(" in text


class _FakeLibrary:
    """Records the entry points called and their arguments (CPU tensors
    stand in for the card's)."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 1000 if name.endswith("_smem") else 0
        entry.__name__ = name
        return entry


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(_lib, "library", lambda: lib)
    monkeypatch.setattr(_lib, "require", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(_lib, "sm_count", lambda device: 132)
    return lib


NAMES = ("int8_absmax_sm90", "int8_absmax")


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so ``int8_scales_for``
    takes its card branch into the stub library."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("M, weight_grads, sm90, entry, counter", [
    (64, False, True, "mtt_int8_absmax_sm90", "int8_absmax_sm90"),   # the served int8 call
    (48, False, True, "mtt_int8_absmax_sm90", "int8_absmax_sm90"),
    (16, False, True, "mtt_int8_absmax_sm90", "int8_absmax_sm90"),
    (64, True, True, "mtt_int8_absmax", "int8_absmax"),              # a weight requires grad
    (64, False, False, "mtt_int8_absmax", "int8_absmax"),            # sm90=False
    (96, False, True, "mtt_int8_absmax", "int8_absmax"),             # M 80-128
])
def test_wrapper_launches_what_the_rule_says(fake, M, weight_grads, sm90, entry, counter):
    """The card's scales of one layer call (``int8_scales_for``): the
    Hopper pass where the Hopper K1-int8 runs (w_qkv^T, the layer's widths,
    even blocks of ``int8_block_atoms``, the SMs), else the general pass;
    one count each, the blocks expanded to the atoms."""
    H, D, F = 8, 128, 256
    A = 5
    edges, center, _, w, _, _ = _torch_case(A, M, D, F)
    edges = edges.as_subclass(_OnCard)
    before = {k: _lib.LAUNCHES[k] for k in NAMES}
    scales = tfl.int8_scales_for(edges, center, w, H, weight_grads=weight_grads, sm90=sm90)
    BA = tfl.int8_block_atoms(M)
    assert scales.shape == (A, 2) and scales.dtype == torch.float32
    assert [k for k in fake.calls if not k.endswith("_smem")] == [entry]
    args = fake.calls[entry]
    assert args[0] == edges.data_ptr()
    if counter == "int8_absmax_sm90":
        assert fake.calls["mtt_int8_absmax_sm90_smem"] == (M, D, H, F)
        assert args[6:12] == (A, M, D, H, F, BA) and args[13] == 132
    else:
        assert args[7:10] == (M, D, BA)
    assert {k: _lib.LAUNCHES[k] - before[k] for k in NAMES} == {k: int(k == counter) for k in NAMES}


def test_hopper_wrapper_refuses_other_shapes_and_cpu_tensors(fake, monkeypatch):
    """The Hopper pass raises outside its shapes (no quiet fallback); with
    the real checks the wrapper refuses CPU tensors."""
    edges, center, _, w, _, _ = _torch_case(3, 96, 128, 256)
    with pytest.raises(ValueError, match="does not take"):
        tfl.int8_absmax_sm90_cuda(edges, center, w, 8)
    assert not fake.calls
    monkeypatch.undo()
    edges, center, _, w, _, _ = _torch_case(3, 64, 128, 256)
    with pytest.raises(ValueError, match="cuda"):
        tfl.int8_absmax_sm90_cuda(edges, center, w, 8)


def test_w8a8_layer_runs_no_absmax_pass(fake):
    """W8A8 wins over the int8 scores and quantizes with its static
    scales: its Hopper K1 launch is the only one, no absmax pass."""
    from test_torch_port_w8a8_sm90 import _w8a8

    edges, center, cf, w, _, _ = _torch_case(3, 64, 128, 256)
    before = {k: _lib.LAUNCHES[k] for k in NAMES}
    tfl.fused_layer_fwd_cuda(edges, center, cf, w, 8, 0.25, w8a8=_w8a8(edges, center, cf, w))
    assert [k for k in fake.calls if not k.endswith("_smem")] == ["mtt_fused_layer_fwd_w8a8_sm90"]
    assert {k: _lib.LAUNCHES[k] - before[k] for k in NAMES} == {k: 0 for k in NAMES}


@pytest.mark.parametrize("M", [64, 16])
def test_cpu_scales_are_the_plain_versions(M):
    """On CPU tensors every routing gives ``int8_block_scales`` bit for bit,
    expanded to the atoms."""
    A = 21
    edges, center, _, w, _, _ = _torch_case(A, M, 128, 256, seed=3)
    BA = tfl.int8_block_atoms(M)
    want = tfl.int8_atom_scales(tfl.int8_block_scales(edges, center, w, BA), A, BA)
    for kw in ({}, {"weight_grads": True}, {"sm90": False}, {"plain": True}):
        got = tfl.int8_scales_for(edges, center, w, 8, **kw)
        assert got.dtype == torch.float32 and torch.equal(got, want), kw


def _emulate(q, k, b_qkv, block_atoms, sms=132):
    """The kernel's reduction in float32, step by step: persistent block b
    takes atom pairs [P b / G, P (b + 1) / G) (an odd last atom standing in
    for the missing one); per pair the max of |q| and |k| over rows m < M
    (the bf16 values, as K1 stores them); a running max per block of
    threads, handed on with atomicMax on the float bits at the end of a
    scale block or of the range; then int8_scales: a partial last block
    takes max |b_q| and max |b_k| of the bias in q's dtype, s = max(m,
    1e-12) / 127 rounded once."""
    A, M, D = q.shape
    atom = torch.stack([x.to(torch.float32).abs().amax(dim=(1, 2)) for x in (q, k)], dim=1)
    pairs = (A + 1) // 2
    n_blocks = -(-A // block_atoms)
    bits = np.zeros((n_blocks, 2), np.uint32)  # cudaMemsetAsync
    grid = min(pairs, sms)
    for b in range(grid):
        p0, p1 = pairs * b // grid, pairs * (b + 1) // grid
        run = np.zeros(2, np.float32)
        for pr in range(p0, p1):
            a0 = 2 * pr
            a1 = a0 + 1 if a0 + 1 < A else a0
            run = np.maximum(run, np.maximum(atom[a0].numpy(), atom[a1].numpy()))
            blk = 2 * pr // block_atoms
            if pr + 1 == p1 or 2 * (pr + 1) // block_atoms != blk:
                bits[blk] = np.maximum(bits[blk], run.view(np.uint32))
                run = np.zeros(2, np.float32)
    am = bits.view(np.float32).copy()
    if A % block_atoms:
        bias = b_qkv.to(q.dtype).to(torch.float32).abs().numpy()
        am[-1] = np.maximum(am[-1], [bias[:D].max(), bias[D:2 * D].max()])
    return torch.from_numpy(np.maximum(am, np.float32(1e-12)) / np.float32(127.0))


@pytest.mark.parametrize("M", [64, 48, 16])
def test_emulated_reduction_is_the_plain_version_bitwise(M):
    """At A = 2047 (odd: the last pair holds one atom; a partial last block)
    the emulation on the twin's q and k equals ``int8_block_scales`` bit
    for bit, on the card's grid and on grids whose ranges cut scale blocks
    in the middle."""
    A, D, F = 2047, 128, 256
    edges, center, _, w, _, _ = _torch_case(A, M, D, F, seed=M)
    BA = tfl.int8_block_atoms(M)
    assert A % BA and BA % 2 == 0
    want = tfl.int8_block_scales(edges, center, w, BA)
    q, k = tfl._exact_qk(edges, center, w)
    assert q.dtype == BF16
    for sms in (132, 7, 1):
        assert torch.equal(_emulate(q, k, w.b_qkv, BA, sms), want), sms


@pytest.mark.parametrize("seed", [0, 1])
def test_emulated_reduction_is_jaxs_padded_block(seed):
    """On one block padded as the JAX package's ``_forward_impl`` pads it,
    the emulation on the real atoms equals ``_quantize_i8``'s scales over
    the padded block (float32; 1e-6 relative, as the plain version's own
    test: the two frameworks sum the QKV product in different orders)."""
    A, BA, M = 5, 8, 64
    w, real, block = _padded_block(seed, A, BA, M)
    jw, tw = jfl.LayerWeights(*map(_jax, w)), tfl.LayerWeights(*map(_torch, w))
    te, tc = (_torch(x) for x in real[:2])
    q, k = tfl._exact_qk(te, tc, tw)
    assert q.dtype == torch.float32
    got = _emulate(q, k, tw.b_qkv, BA)
    jq, jk = _jax_qk(_jax(block[0]), _jax(block[1]), jw)
    (_, jsq), (_, jsk) = jfl._quantize_i8(jq), jfl._quantize_i8(jk)
    np.testing.assert_allclose(got[0].numpy(), [float(jsq), float(jsk)], rtol=1e-6)
    assert torch.equal(got, tfl.int8_block_scales(te, tc, tw, BA))


def _tool(name):
    path = _lib.CSRC.parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"absmax_{name}", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("M", [64, 16])
def test_tools_hold_the_pass_against_k1_int8s_qk(M):
    """``tools/sm90_front.py`` builds the K1-int8 copy whose dump takes q|k|v
    before the attention (``K1_INT8``, which ``chip_smoke.py`` builds beside
    the kernels) and a plain copy of the pass; its reduction of a dump
    (``block_scales``) is ``int8_block_scales``'s, bit for bit, on the
    twin's q and k at an odd A. ``tools/layer_times.py`` times and digests
    both passes side by side."""
    tool = _tool("sm90_front")
    key, source, marks = tool.K1_INT8
    assert (key, source, marks) == ("k1_int8", "fused_layer_fwd_sm90.cu", tool.K1_INT8_MARKS)
    text = tool.instrument((tool.CSRC / source).read_text(), marks)
    assert text.index("QKV[(i_ / (3 * D)) * LQ + i_ % (3 * D)]") < text.index("attention_fwd<I8>(")
    assert ("absmax", ("int8_absmax_sm90.cu", "int8_absmax.cu"), ()) in tool.KERNELS["int8"]
    assert tool.EPS == tfl.rmsnorm_eps(BF16)
    A = 301
    edges, center, _, w, _, _ = _torch_case(A, M, 128, 256, seed=5)
    BA = tfl.int8_block_atoms(M)
    q, k = tfl._exact_qk(edges, center, w)
    assert torch.equal(tool.block_scales(q, k, w.b_qkv, BA),
                       tfl.int8_block_scales(edges, center, w, BA))
    assert tool.port_fused_layer() is tfl
    assert torch.equal(tool.port_int8_scales(edges, center, w, 8),
                       tfl.int8_scales_for(edges, center, w, 8))
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "front.K1_INT8" in smoke and "front.absmax_compare(" in smoke
    times = (_lib.CSRC.parent / "tools" / "layer_times.py").read_text()
    for name in ("int8_absmax_sm90", "int8_absmax", "fused_layer_fwd_int8_on_general_scales",
                 "fused_layer_bwd_int8_on_general_scales"):
        assert f'("{name}", ' in times, name


def test_phase_split_tool_finds_the_absmax_marks():
    """``tools/k2_split.py --body absmax`` stamps the pass's loop over atom
    pairs at marks the source holds once: five phases a pair, each stamp
    inside the loop, with the quotient's source built beside it."""
    tool = _tool("k2_split")
    text = tool.instrument((tool.CSRC / SOURCE).read_text(), tool.ABSMAX)
    n = len(tool.ABSMAX_PHASES)
    assert [f"SPLIT({i})" in text for i in range(n + 1)] == [True] * n + [False]
    loop = text[text.index("for (long long pr = p0"):text.index("    cp_async_wait<0>();\n}")]
    assert all(f"SPLIT({i})" in loop for i in range(n))
    source = (_lib.CSRC.parent / "tools" / "k2_split.py").read_text()
    assert '"absmax"' in source and "mtt_int8_absmax_sm90" in source
    # the blocks are the port's rule, not a copy of it
    assert "port_fused_layer().int8_block_atoms(M)" in source and "128 if M" not in source
