"""The Hopper float32 K3 (``csrc/rowblock_fwd_f32_sm90.cu``): which calls take
it, its shared-memory budget, its C entry points, what the wrapper hands it,
the accuracy of its 3xTF32 products, the forward it shares with the Hopper
float32 K4, and the CPU path beside it.

The kernel itself runs only on the card (``chip_smoke.py`` holds it against
``stage.math`` there, and ``tools/sm90_front.py --kernel rowblock`` its pre,
h, xn0 and rs against the Hopper float32 K4's recompute, bit for bit). Here:

- the dispatch rule ``_lib.k3_f32_sm90_takes``: float32, the compress with
  2 or 3 parts and the combination at d_part 128, with or without weight
  gradients (the rule of the f32 K4, whose recompute it shares); the head,
  bfloat16 and d_pet 256 stay elsewhere;
- its budget ``_lib.k3_f32_sm90_smem`` (the C side's layout, mirrored) fits
  the 232,448 bytes a block may have wherever the rule takes;
- the stage's two products formed as the kernel forms them (3xTF32, each
  staged chunk of 16 k summed from zero) stay within 1e-6 of float64;
- on the CPU the stage's forward is ``stage.math``, which matches the JAX
  package's ``compress_math`` / ``combination_math`` (1e-12 in float64,
  1e-5 in float32) and its ``fused_rowblock`` (interpret mode), and the
  wrapper refuses CPU tensors;
- the C entry points take the parameters ``_lib`` binds, and the wrapper
  passes them (w0^T, w1^T) and counts the launch;
- both float32 row-block kernels run the forward of
  ``csrc/rowblock_f32_sm90.cuh`` in the same order;
- ``tools/sm90_front.py`` and ``tools/layer_times.py`` find their marks.
"""

import ctypes
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import rel
from metatrain_tpu.models.pet import fused_stages as jst
from metatrain_tpu.ops.pallas.rowblock import fused_rowblock
from metatrain_tpu_torch import _build
from metatrain_tpu_torch.models.pet import fused_stages as tst
from metatrain_tpu_torch.ops.kernels import _lib
from metatrain_tpu_torch.ops.kernels import rowblock as trb
from test_torch_port_k2dw_sm90 import _params
from test_torch_port_k4dw_f32_sm90 import _product_3xtf32, _tf32

F32, BF16 = torch.float32, torch.bfloat16
D = 128
TOOLS = Path(trb.__file__).resolve().parents[2] / "tools"


def _case(name, rows, dtype, seed=0):
    """numpy inputs and weights of a stage at the served widths."""
    rng = np.random.default_rng(seed)

    def lecun(i, o):
        return rng.normal(size=(i, o)) / np.sqrt(i)

    def vec(n, base=0.0):
        return base + 0.1 * rng.normal(size=n)

    n_parts = {"compress2": 2, "compress3": 3, "combination": 3}[name]
    inputs = [rng.normal(size=(rows, D)) for _ in range(n_parts)]
    if name == "combination":
        weights = [vec(2 * D, 1.0), vec(2 * D), lecun(2 * D, 2 * D), vec(2 * D), lecun(2 * D, D), vec(D)]
    else:
        weights = [lecun(n_parts * D, D), vec(D), lecun(D, D), vec(D)]
    return [a.astype(dtype) for a in inputs], [a.astype(dtype) for a in weights]


def _stages(name):
    if name == "combination":
        return tst.COMBINATION, jst.combination_math
    return tst.COMPRESS, jst.compress_math


@pytest.mark.parametrize("dtype, stage, d_part, w_in, w_hid, w_out, dw, takes", [
    (F32, 0, 128, 384, 128, 128, False, True),   # the f32 force call's 3-part compress
    (F32, 0, 128, 384, 128, 128, True, True),    # the f32 training step's
    (F32, 0, 128, 256, 128, 128, False, True),   # the first GNN layer's 2 parts
    (F32, 0, 128, 256, 128, 128, True, True),
    (F32, 1, 128, 256, 256, 128, False, True),   # the combination
    (F32, 1, 128, 256, 256, 128, True, True),
    (F32, 2, 128, 128, 128, 128, False, True),   # the head: the Hopper float32 head
    (F32, 2, 128, 128, 128, 128, True, True),
    (BF16, 0, 128, 384, 128, 128, False, False),  # bf16: the Hopper K3's
    (BF16, 1, 128, 256, 256, 128, True, False),   # bf16 training: the general body
    (F32, 0, 256, 768, 256, 256, False, False),   # d_pet 256
    (F32, 1, 256, 512, 512, 256, True, False),
    (F32, 0, 128, 512, 128, 128, False, False),   # 4 parts
    (F32, 0, 128, 128, 128, 128, False, False),   # 1 part
    (F32, 1, 128, 256, 128, 128, False, False),   # another hidden width
    (torch.float64, 1, 128, 256, 256, 128, False, False),
])
def test_dispatch_rule(dtype, stage, d_part, w_in, w_hid, w_out, dw, takes):
    # weight gradients do not enter the rule: K4-dW's float32 first pass
    # recomputes this kernel's forward bit for bit
    assert _lib.k3_f32_sm90_takes(dtype, stage, d_part, w_in, w_hid, w_out, dw) is takes
    assert _lib.k3_f32_sm90_takes(dtype, stage, d_part, w_in, w_hid, w_out, dw) is \
        _lib.k4_f32_sm90_takes(dtype, stage, d_part, w_in, w_hid, w_out, dw)
    assert (_lib.k3_f32_sm90_smem(stage, d_part, w_in, w_hid, w_out) > 0) is \
        _lib.k3_f32_sm90_takes(F32, stage, d_part, w_in, w_hid, w_out)
    # the bf16 Hopper K3 never takes what this one takes
    assert not (takes and _lib.k3_sm90_takes(dtype, stage, d_part, w_in, w_hid, w_out, dw))


def test_smem_budget_fits_wherever_the_rule_takes():
    taken = {}
    for stage in (0, 1, 2):
        for d_part in (64, 128, 256):
            for w_in in range(d_part, 4 * d_part + 1, d_part):
                for w_hid in (d_part, 2 * d_part):
                    nbytes = _lib.k3_f32_sm90_smem(stage, d_part, w_in, w_hid, d_part)
                    if nbytes:
                        assert nbytes <= _lib.MAX_SHARED_BYTES
                        taken[(stage, w_in)] = nbytes
    # the ring, the x tile, the h tile (the head's h0); the combination also
    # the edges | messages tile, ln_scale and ln_bias, rs
    assert taken == {(0, 256): 124928, (0, 384): 157696, (1, 256): 226560, (2, 128): 92160}
    # the C source states the same layout
    text = (_lib.CSRC / "rowblock_fwd_f32_sm90.cu").read_text()
    assert "157,696 at 3 parts, 124,928 at 2, 226,560 for the combination" in text


@pytest.mark.parametrize("name", ["compress3", "combination"])
def test_3xtf32_products_keep_float32_accuracy(name):
    """The stage's two products at the served widths (pre = x w0, or xn w0,
    and h w1), formed as the kernel forms them (per staged chunk of 16 k
    the three TF32 products from zero, the chunks added in order), lie within
    1e-6 relative (max |error| / max |exact|) of the float64 product; one
    TF32 product misses that by orders of magnitude."""
    inputs, weights = _case(name, 256, np.float64, seed=11)
    stage, _ = _stages(name)
    xs, ws = [torch.from_numpy(a) for a in inputs], [torch.from_numpy(a) for a in weights]
    if stage is tst.COMBINATION:
        _, _, x = tst._layer_norm(xs[0], xs[1], ws[0], ws[1], torch.float64)
        w0, b0, w1 = ws[2], ws[3], ws[4]
    else:
        x = torch.cat(xs, dim=1)
        w0, b0, w1 = ws[0], ws[1], ws[2]
    h = torch.nn.functional.silu(x @ w0 + b0)
    for key, (a, b) in {"pre": (x, w0), "out": (h, w1)}.items():
        exact = a @ b
        assert rel(_product_3xtf32(a, b).double(), exact) < 1e-6, key
        assert rel((_tf32(a) @ _tf32(b)).double(), exact) > 1e-4, key


@pytest.mark.parametrize("name", ["compress2", "compress3", "combination"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cpu_forward_runs_the_plain_version_and_matches_jax(name, dtype):
    """Through ``rowblock`` on CPU tensors at the widths the kernel takes, the
    forward is ``stage.math`` bit for bit, weights requiring grad or not; it
    matches the JAX package's stage math (1e-12 in float64, 1e-5 in float32);
    the wrapper refuses CPU tensors, with and without ``sm90`` and weight
    gradients."""
    inputs, weights = _case(name, 200, dtype, seed=3)
    stage, j_math = _stages(name)
    code = stage.code
    w_in, w_hid = weights[-4].shape
    assert _lib.k3_f32_sm90_takes(F32, code, D, w_in, w_hid, D, True)
    xs = [torch.from_numpy(a) for a in inputs]
    plain = stage.math(xs, [torch.from_numpy(a) for a in weights])
    for need in (False, True):
        ws = [torch.from_numpy(a).requires_grad_(need) for a in weights]
        assert torch.equal(trb.rowblock(stage, xs, ws).detach(), plain)
    (j_out,) = j_math([jnp.asarray(a) for a in inputs], [jnp.asarray(a) for a in weights])
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert rel(plain.numpy(), np.asarray(j_out)) < tol
    for sm90 in (True, False):
        for weight_grads in (False, True):
            with pytest.raises(ValueError, match="cuda"):
                trb.rowblock_fwd_cuda(stage, xs, [torch.from_numpy(a) for a in weights], sm90=sm90,
                                      weight_grads=weight_grads)


@pytest.mark.parametrize("name", ["compress3", "combination"])
def test_plain_forward_matches_jax_pallas_in_float32(name):
    """In float32 at the served widths the port's plain version and the JAX
    package's ``fused_rowblock`` (its Pallas kernel in interpret mode) agree
    within 1e-5 relative: the function the Hopper float32 K3 is held to on
    the card."""
    inputs, weights = _case(name, 160, np.float32, seed=5)
    stage, j_math = _stages(name)
    (j_out,) = fused_rowblock(j_math, tuple(jnp.asarray(a) for a in inputs),
                              tuple(jnp.asarray(a) for a in weights))
    t_out = stage.math([torch.from_numpy(a) for a in inputs], [torch.from_numpy(a) for a in weights])
    assert t_out.dtype == F32 and t_out.shape == j_out.shape
    assert rel(t_out.numpy(), np.asarray(j_out)) < 1e-5


def test_entry_points_take_the_bound_parameters():
    text = (_lib.CSRC / "rowblock_fwd_f32_sm90.cu").read_text()
    names = re.findall(r'extern "C" [\w ]+?\b(mtt_\w+)\(', text)
    assert sorted(names) == ["mtt_rowblock_fwd_f32_sm90", "mtt_rowblock_fwd_f32_sm90_ok",
                             "mtt_rowblock_fwd_f32_sm90_smem"]
    assert "rowblock_fwd_f32_sm90.cu" in _lib.SOURCES
    for name in names:
        assert _params(text, name) == _lib._SIGNATURES[name], name
    # the bf16 Hopper K3 and this one take the same arguments (one wrapper)
    assert _lib._SIGNATURES["mtt_rowblock_fwd_f32_sm90"] == _lib._SIGNATURES["mtt_rowblock_fwd_sm90"]


def test_both_f32_kernels_run_the_shared_forward_in_order():
    """The Hopper float32 K3 and K4 include ``rowblock_f32_sm90.cuh`` (the
    build recompiles both when it changes) and call its forward in the same
    order, so K3's pre, xn and h are the K4 recompute's; neither keeps a
    copy of its own."""
    phases = r"\b(layer_norm_rows|compress_pre|combination_pre|hidden)(?:<\w+>)?\("
    calls = {}
    for unit in ("rowblock_fwd_f32_sm90.cu", "rowblock_bwd_f32_sm90.cu"):
        deps = {p.name for p in _build.includes(_lib.CSRC / unit)}
        assert {"rowblock_f32_sm90.cuh", "tf32_sm90.cuh"} <= deps, unit
        text = (_lib.CSRC / unit).read_text()
        body = re.sub(r"//[^\n]*", "", text[text.index("#include"):])
        found = re.findall(phases, body)
        # each phase once where it is called (h for both columns of a pair)
        calls[unit] = [c for i, c in enumerate(found) if i == 0 or c != found[i - 1]]
        for name in ("copy_rows", "layer_norm_rows", "rows_slice"):
            assert not re.search(r"__device__ __forceinline__ void " + name + r"\(", text), (unit, name)
    assert calls["rowblock_fwd_f32_sm90.cu"] == [
        "compress_pre", "hidden", "layer_norm_rows", "combination_pre", "hidden"]
    assert calls["rowblock_bwd_f32_sm90.cu"] == calls["rowblock_fwd_f32_sm90.cu"]
    header = (_lib.CSRC / "rowblock_f32_sm90.cuh").read_text()
    for name in ("copy_rows", "rows_slice", "layer_norm_rows", "compress_pre", "combination_pre",
                 "hidden"):
        assert re.search(r"__device__ __forceinline__ \w+ " + name + r"\(", header), name


class _FakeLibrary:
    """Records the entry points called and copies the f32 K3's weight
    matrices out of the host pointers it is handed (CPU tensors)."""

    def __init__(self, w_in, w_hid):
        self.called, self.matrices, self.shapes = [], None, ((w_hid, w_in), (D, w_hid))

    def __getattr__(self, name):
        def entry(*args):
            self.called.append(name)
            if name.endswith("_smem"):
                return 1000
            if name == "mtt_rowblock_fwd_f32_sm90":
                self.matrices = [
                    torch.from_numpy(np.ctypeslib.as_array(
                        (ctypes.c_float * (r * c)).from_address(ptr)).reshape(r, c).copy())
                    for ptr, (r, c) in zip((args[7], args[9]), self.shapes)]
            return 0
        entry.__name__ = name
        return entry


@pytest.mark.parametrize("name, dtype, weight_grads, sm90, kernel", [
    ("compress3", F32, False, True, "rowblock_fwd_f32_sm90[compress]"),
    ("compress2", F32, True, True, "rowblock_fwd_f32_sm90[compress]"),
    ("combination", F32, False, True, "rowblock_fwd_f32_sm90[combination]"),
    ("combination", F32, True, True, "rowblock_fwd_f32_sm90[combination]"),
    ("compress3", F32, False, False, "rowblock_fwd[compress]"),
    ("combination", BF16, False, True, "rowblock_fwd_sm90[combination]"),
    ("combination", BF16, True, True, "rowblock_fwd[combination]"),
])
def test_wrapper_launches_the_kernel_it_counts(monkeypatch, name, dtype, weight_grads, sm90, kernel):
    """At widths the rule takes, ``rowblock_fwd_cuda`` in float32 calls the
    Hopper float32 K3's entry with w0^T and w1^T, with or without weight
    gradients, and counts it; ``sm90=False`` calls the general body, and
    bfloat16 keeps the bf16 rule (the library and the device checks are
    stubbed: CPU tensors stand in for the card's)."""
    inputs, weights = _case(name, 100, np.float32, seed=1)
    stage, _ = _stages(name)
    w_in, w_hid = weights[-4].shape
    fake = _FakeLibrary(w_in, w_hid)
    monkeypatch.setattr(_lib, "library", lambda: fake)
    monkeypatch.setattr(_lib, "require", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(_lib, "dw_blocks", lambda items, device: 132)
    xs = [torch.from_numpy(a).to(dtype) for a in inputs]
    ws = [torch.from_numpy(a) for a in weights]
    before = _lib.LAUNCHES[kernel]
    out = trb.rowblock_fwd_cuda(stage, xs, ws, weight_grads=weight_grads, sm90=sm90)
    assert out.shape == (100, D) and out.dtype == dtype
    assert _lib.LAUNCHES[kernel] == before + 1
    entry = "mtt_" + kernel.split("[")[0]
    assert fake.called[-1] == entry
    if entry == "mtt_rowblock_fwd_f32_sm90":
        for got, want in zip(fake.matrices, (ws[-4].T, ws[-2].T)):
            assert torch.equal(got, want)
    else:
        assert "mtt_rowblock_fwd_f32_sm90" not in fake.called


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("stage", ["compress", "combination"])
def test_front_bits_tool_finds_the_rowblock_marks(stage):
    """``tools/sm90_front.py --kernel rowblock`` copies pre, h (and xn0, rs)
    out of copies of the Hopper float32 K3 and K4 at its marks: every mark
    is in its source once, both copies write pre, and the K3's copy of h
    reads its h tile while the K4's takes hidden(pre)."""
    tool = _tool("sm90_front")
    texts = {}
    for key, source, marks in tool.ROWBLOCK_KERNELS[stage]:
        text = tool.instrument((tool.CSRC / source).read_text(), marks)
        assert "__device__ float* g_dump;" in text and "d_[0] = pre[j_][2 * h_];" in text
        texts[key] = text
    assert "H[m_ * G::LH + k_]" in texts["k3"] and "H[m_" not in texts["k4"]
    assert "hidden(pre[j_][2 * h_])" in texts["k4"]
    for text in texts.values():
        assert ("RS[threadIdx.x]" in text) is (stage == "combination")


def test_layer_times_tool_reports_the_f32_rowblocks():
    """``tools/layer_times.py`` times and digests the float32 compress and
    combination's K3, K4 and K4-dW (the f32 K4's and K4-dW's digests equal in
    two trees prove the header move changed no bit)."""
    text = (TOOLS / "layer_times.py").read_text()
    for name in ("rowblock_bwd", "rowblock_bwd_dw", "rowblock_fwd", "rowblock_fwd_general"):
        assert f'("{name}"' in text, name
    assert 'digests[f"{name}[{key}]_f32"]' in text
