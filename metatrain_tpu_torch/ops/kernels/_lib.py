"""Build, load and launch the port's CUDA kernels (``metatrain_tpu_torch/csrc``).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a``, one
object per source file (compiled again only when the source or a header it
includes changed; the stale ones all at once), linked into one shared
library with a plain C interface, written to the git-ignored
``metatrain_tpu_torch/_build/``, and bound with ctypes. Every
pointer argument is a ``c_void_p``; each C entry point launches on the
current PyTorch stream and returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where
it launches its kernel, and nowhere else. ``REPLAYS`` counts the
second-order replays (plain PyTorch, no kernel) by the op they replay,
``CALLS`` the calls of the Hopper GNN block, a sequence of launches that
``LAUNCHES`` counts kernel by kernel.

The fused-layer kernels (K1, K2 and their variants, the GNN block) place
their per-atom buffers with a layout plan (``csrc/common.cuh``
``SmemPlan``): in shared memory where they fit, else in the block's slice
of a global workspace that the wrapper allocates. :func:`make_plan` and
the ``*_plan`` functions below mirror the C side, so that the CPU tests
can check every shape; ``chip_smoke.py`` checks that both agree.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import shutil
from pathlib import Path
from typing import NamedTuple

import torch

from ..._build import PACKAGE_DIR, build_library

CSRC = PACKAGE_DIR / "csrc"
SOURCES = (
    "fused_layer_fwd.cu",
    "fused_layer_fwd_sm90.cu",
    "fused_layer_fwd_f32_sm90.cu",
    "fused_layer_bwd.cu",
    "fused_layer_bwd_sm90.cu",
    "fused_layer_bwd_f32_sm90.cu",
    "fused_layer_bwd_dw_sm90.cu",
    "rowblock_fwd.cu",
    "rowblock_fwd_sm90.cu",
    "rowblock_fwd_f32_sm90.cu",
    "rowblock_bwd.cu",
    "rowblock_bwd_sm90.cu",
    "rowblock_bwd_f32_sm90.cu",
    "permute.cu",
    "window_attention_fwd.cu",
    "window_attention_bwd.cu",
    "gnn_block_fwd.cu",
    "gnn_block_bwd.cu",
    "gnn_node_sm90.cu",
    "gnn_node_f32_sm90.cu",
    "int8_absmax.cu",
    "int8_absmax_sm90.cu",
)
LIBRARY = "libmtt_kernels.so"
MAX_SHARED_BYTES = 232448  # per block on sm_90 (227 KB)
MAX_SHARED_FLOATS = MAX_SHARED_BYTES // 4

LAUNCHES: collections.Counter = collections.Counter()
REPLAYS: collections.Counter = collections.Counter()
CALLS: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers
_FP = ctypes.POINTER(ctypes.c_float)  # a host array of floats
_LP = ctypes.POINTER(ctypes.c_longlong)  # an output argument
_IP = ctypes.POINTER(ctypes.c_int)
# A, M, D, H, F, scale, eps, grid, workspace, stream
_LAYER_TAIL = [_L, _I, _I, _I, _I, _F, _F, _I, _P, _P]
_SIGNATURES = {
    "mtt_fused_layer_fwd": [_I] + [_P] * 15 + _LAYER_TAIL,
    "mtt_fused_layer_bwd": [_I] + [_P] * 22 + _LAYER_TAIL,
    "mtt_fused_layer_fwd_sm90": [_P] * 15 + [_L, _I, _I, _I, _I, _F, _F, _P],
    # the Hopper K1's arguments and the int8 scales after the weight matrices
    "mtt_fused_layer_fwd_int8_sm90": [_P] * 16 + [_L, _I, _I, _I, _I, _F, _F, _P],
    "mtt_fused_layer_fwd_f32_sm90": [_P] * 15 + [_L, _I, _I, _I, _I, _F, _F, _P],
    "mtt_fused_layer_bwd_sm90": [_P] * 20 + [_L, _I, _I, _I, _I, _F, _F, _P],
    # the Hopper K2's arguments and the int8 scales after the transposed weights
    "mtt_fused_layer_bwd_int8_sm90": [_P] * 21 + [_L, _I, _I, _I, _I, _F, _F, _P],
    "mtt_fused_layer_bwd_f32_sm90": [_P] * 20 + [_L, _I, _I, _I, _I, _F, _F, _P],
    # K1-W8A8 on Hopper: the inputs, six vectors, w_out^T, the three int8
    # matrices, the 11 scales (a host array), the outputs; A, M, D, H, F, eps
    "mtt_fused_layer_fwd_w8a8_sm90": [_P] * 13 + [_FP, _P, _P, _L, _I, _I, _I, _I, _F, _P],
    # K2-W8A8 on Hopper: the inputs, nine bf16 weights, w_out^T, the two int8
    # matrices, the scales, the cotangents and outputs; A, M, D, H, F, scale, eps
    "mtt_fused_layer_bwd_w8a8_sm90": [_P] * 15 + [_FP] + [_P] * 5 + [_L, _I, _I, _I, _I, _F, _F, _P],
    # dtype, the Hopper float32 first pass or not, 26 pointers (the inputs,
    # 13 weights, int8 scales, cotangents, outputs, dw, spill, partials,
    # workspace), A, M, D, H, F, scale, eps, workspace blocks, SMs, stream
    "mtt_fused_layer_bwd_dw_sm90": [_I, _I] + [_P] * 26 + [_L, _I, _I, _I, _I, _F, _F, _I, _I, _P],
    "mtt_fused_layer_bwd_dw_sm90_ok": [_I] * 6,
    "mtt_fused_layer_bwd_dw_sm90_plan": [_I, _L, _I, _I, _I, _I, _LP],
    "mtt_layer_dw_slices": [_L, _I, _I, _I, _LP],
    "mtt_layer_dw_product": [_I, _P, _P, _P, _L, _I, _I, _I, _I, _P, _P, _P],
    "mtt_fused_layer_fwd_w8a8": [_P] * 16 + [_FP, _P, _P, _L, _I, _I, _I, _I, _F, _I, _P, _P],
    "mtt_fused_layer_bwd_w8a8": [_P] * 17 + [_FP] + [_P] * 5 + _LAYER_TAIL,
    "mtt_fused_layer_fwd_int8": [_P] * 16 + _LAYER_TAIL,
    "mtt_fused_layer_bwd_int8": [_P] * 23 + _LAYER_TAIL,
    "mtt_int8_absmax": [_P] * 6 + [_L, _I, _I, _I, _F, _P],
    # edges, center, norm_attn, w_qkv^T, b_qkv, scales; A, M, D, H, F,
    # block_atoms, eps, SMs, stream
    "mtt_int8_absmax_sm90": [_P] * 6 + [_L, _I, _I, _I, _I, _I, _F, _I, _P],
    "mtt_int8_absmax_sm90_ok": [_I] * 4,
    "mtt_int8_absmax_sm90_smem": [_I] * 4,
    "mtt_rowblock_fwd": [_I, _I, _P, _P, _P, _I] + [_P] * 7 + [_L, _I, _I, _I, _I, _P],
    "mtt_rowblock_fwd_sm90": [_I, _P, _P, _P, _I] + [_P] * 7 + [_L, _I, _I, _I, _I, _I, _P],
    "mtt_rowblock_fwd_f32_sm90": [_I, _P, _P, _P, _I] + [_P] * 7 + [_L, _I, _I, _I, _I, _I, _P],
    "mtt_rowblock_bwd": [_I, _I, _P, _P, _P, _I] + [_P] * 13 + [_I, _P] + [_L, _I, _I, _I, _I, _P],
    "mtt_rowblock_bwd_sm90": [_I, _P, _P, _P, _I] + [_P] * 13 + [_L, _I, _I, _I, _I, _I, _P],
    # stage, x0..x2, n_parts, ln_scale, ln_bias, b0, w0_t, w1, w0, w1_t, b1, g,
    # d0..d2, rows, d_part, w_in, w_hid, w_out, blocks, stream
    "mtt_rowblock_bwd_f32_sm90": [_I, _P, _P, _P, _I] + [_P] * 12 + [_L, _I, _I, _I, _I, _I, _P],
    # ... d0..d2, dw, spill, partials, rows, d_part, w_in, w_hid, w_out, sms, stream
    "mtt_rowblock_bwd_dw_f32_sm90": [_I, _P, _P, _P, _I] + [_P] * 15 + [_L, _I, _I, _I, _I, _I, _P],
    "mtt_rowblock_bwd_dw_f32_sm90_plan": [_I, _L, _I, _I, _I, _I, _LP],
    # stage, x0..x2, n_parts, g, spill, vec, rows, w_in, w_hid, w_out, sms,
    # partials, dw, stream
    "mtt_rowblock_dw_product": [_I, _P, _P, _P, _I, _P, _P, _P, _L, _I, _I, _I, _I, _P, _P, _P],
    "mtt_permute": [_I, _P, _P, _P, _P, _L, _I, _P],
    "mtt_window_attention_fwd": [_I, _P, _P, _P, _I, _I, _I, _P, _P, _L, _I, _I, _I, _F, _P],
    "mtt_window_attention_bwd": [_I] + [_P] * 4 + [_I] * 4 + [_P] * 5 + [_L, _I, _I, _I, _F, _P],
    "mtt_gnn_block_fwd": [_I, _P, _P, _P, _PP, _PP, _P, _P, _L] + [_I] * 7 + [_F, _F, _I, _P, _P],
    "mtt_gnn_block_bwd": [_I, _P, _P, _P, _PP, _PP, _PP] + [_P] * 7 + [_I] + [_P] * 4 + [_L]
    + [_I] * 7 + [_F, _F, _I, _P, _P],
    # node, cattn, 9 weights, node_out, center_out, A, N, D, eps, stream
    "mtt_gnn_node_fwd_sm90": [_P] * 13 + [_L, _I, _I, _F, _P],
    # node, cattn, dn_f, dn_h, d_center, 9 weights, d_cattn, d_nmid, d_node,
    # A, N, D, eps, stream
    "mtt_gnn_node_bwd_sm90": [_P] * 17 + [_L, _I, _I, _F, _P],
    "mtt_gnn_node_sm90_ok": [_I, _I],
    "mtt_gnn_node_sm90_smem": [_I, _I, _I],
    # the float32 pair: the forward as the bf16 one's; the backward's node,
    # cattn, dn, d_center, 9 weights, d_cattn, d_nmid, d_node, the spill
    # (s_hn, s_h, s_dvg, s_dn, vec, vec_con), A, N, D, eps, stream
    "mtt_gnn_node_fwd_f32_sm90": [_P] * 13 + [_L, _I, _I, _F, _P],
    "mtt_gnn_node_bwd_f32_sm90": [_P] * 22 + [_L, _I, _I, _F, _P],
    # node, cattn, d_center, d_nmid, s_hn, s_h, s_dvg, s_dn, vec, partials,
    # dw, A, N, D, SMs, partials' rows, stream
    "mtt_gnn_node_dw_f32_sm90": [_P] * 11 + [_L, _I, _I, _I, _I, _P],
    "mtt_gnn_node_f32_sm90_ok": [_I, _I],
    "mtt_gnn_node_f32_sm90_smem": [_I, _I, _I],
    "mtt_fused_layer_fwd_smem": [_I, _I, _I, _LP],
    "mtt_fused_layer_bwd_smem": [_I, _I, _I, _I, _I, _LP],
    "mtt_fused_layer_bwd_w8a8_smem": [_I, _I, _I, _I, _LP],
    "mtt_fused_layer_bwd_int8_smem": [_I, _I, _I, _I, _I, _LP],
    "mtt_int8_absmax_smem": [_I],
    "mtt_fused_layer_fwd_sm90_smem": [_I] * 4,
    "mtt_fused_layer_fwd_sm90_ok": [_I] * 4,
    "mtt_fused_layer_fwd_int8_sm90_smem": [_I] * 4,
    "mtt_fused_layer_fwd_w8a8_sm90_smem": [_I] * 4,
    "mtt_fused_layer_fwd_f32_sm90_smem": [_I] * 4,
    "mtt_fused_layer_fwd_f32_sm90_ok": [_I] * 4,
    "mtt_fused_layer_bwd_sm90_smem": [_I] * 4,
    "mtt_fused_layer_bwd_sm90_ok": [_I] * 4,
    "mtt_fused_layer_bwd_int8_sm90_smem": [_I] * 4,
    "mtt_fused_layer_bwd_w8a8_sm90_smem": [_I] * 4,
    "mtt_fused_layer_bwd_f32_sm90_smem": [_I] * 4,
    "mtt_fused_layer_bwd_f32_sm90_ok": [_I] * 4,
    "mtt_rowblock_fwd_smem": [_I, _I, _IP],
    "mtt_rowblock_fwd_sm90_ok": [_I] * 5,
    "mtt_rowblock_fwd_sm90_smem": [_I] * 5,
    "mtt_rowblock_fwd_f32_sm90_ok": [_I] * 5,
    "mtt_rowblock_fwd_f32_sm90_smem": [_I] * 5,
    "mtt_rowblock_bwd_smem": [_I, _I, _I, _I, _I, _IP],
    "mtt_rowblock_bwd_sm90_ok": [_I] * 5,
    "mtt_rowblock_bwd_sm90_smem": [_I] * 5,
    "mtt_rowblock_bwd_f32_sm90_ok": [_I] * 5,
    "mtt_rowblock_bwd_f32_sm90_smem": [_I] * 5,
    "mtt_window_attention_fwd_smem": [_I, _I, _I, _I],
    "mtt_window_attention_bwd_smem": [_I, _I, _I, _I],
    "mtt_gnn_block_fwd_smem": [_I] * 4 + [_LP],
    "mtt_gnn_block_bwd_smem": [_I] * 6 + [_LP],
    "mtt_gnn_block_row_floats": [_I, _I],
}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")


def nvcc_compile_command() -> list:
    """Compile one source to an object (the source and ``-o`` follow)."""
    return [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    ]


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library."""
    units = [CSRC / s for s in SOURCES]
    link = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared"]
    path = build_library(link, units, LIBRARY, timeout=900,
                         compile_command=nvcc_compile_command(), units=units)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = (ctypes.c_size_t if name.endswith("_smem") else
                      ctypes.c_longlong if name.endswith("_floats") else ctypes.c_int)
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"CUDA kernels take float32 or bfloat16, got {dtype}")


def check_shared(nbytes: int, name: str) -> None:
    if nbytes > MAX_SHARED_BYTES:
        raise ValueError(
            f"{name} needs {nbytes} bytes of shared memory per block at these "
            f"shapes; the H100 allows {MAX_SHARED_BYTES}"
        )


def require(tensors: dict, device: torch.device, dtype: torch.dtype) -> None:
    """Raise unless ``device`` is a CUDA device and every tensor is
    contiguous, on ``device`` and of ``dtype`` (``None`` entries are
    skipped)."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take cuda tensors, got {device}")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def dw_blocks(work_items: int, device: torch.device) -> int:
    """Blocks of a weight-gradient kernel: one per SM (one block fits an
    SM for shared memory), fewer when there are fewer work items. Fixed
    for a card and a shape, so the partial sums and their order are too."""
    return max(1, min(int(work_items), sm_count(device)))


def plan_query(fn, *args):
    """``(shared bytes, workspace floats per block)`` of a kernel's layout
    plan, from its C query ``fn(*args, &ws_floats)``."""
    ws = ctypes.c_longlong(0)
    nbytes = int(fn(*args, ctypes.byref(ws)))
    check_shared(nbytes, fn.__name__)
    return nbytes, ws.value


def layer_grid(atoms: int, ws_floats: int, device: torch.device) -> int:
    """Blocks of a fused-layer kernel without weight gradients: one per atom
    where every buffer is shared, else one per SM, each looping over atoms
    with its workspace slice."""
    return int(atoms) if ws_floats == 0 else dw_blocks(atoms, device)


def workspace(grid: int, ws_floats: int, device: torch.device):
    """The global workspace of ``grid`` blocks (``None`` when the plan puts
    every buffer in shared memory)."""
    if ws_floats == 0:
        return None
    return torch.empty(grid * ws_floats, dtype=torch.float32, device=device)


# ---- layout plans (the C side's, csrc/common.cuh and the bodies) ----------


class Plan(NamedTuple):
    smem_floats: int
    ws_floats: int
    shared: tuple  # per buffer, in layout order: in shared memory or not


def make_plan(sizes, keep, cap: int = MAX_SHARED_FLOATS) -> Plan:
    """``common.cuh`` ``make_plan``: buffers claim shared memory in the
    order of ``keep`` where they still fit under ``cap`` floats, the rest go
    to the workspace; every size rounded up to 4 floats."""
    sizes = [(int(s) + 3) // 4 * 4 for s in sizes]
    shared = [False] * len(sizes)
    used = 0
    for i in keep:
        if used + sizes[i] <= cap:
            shared[i] = True
            used += sizes[i]
    smem = sum(s for s, sh in zip(sizes, shared) if sh)
    return Plan(smem, sum(sizes) - smem, tuple(shared))


def qkv_stride(D: int) -> int:
    return 3 * D + 4


def layer_fwd_plan(M: int, D: int, F: int, cap: int = MAX_SHARED_FLOATS) -> Plan:
    """K1's buffers X, N, Q, P, CF (``layer_fwd.cuh``)."""
    sizes = [M * D, M * D, M * max(qkv_stride(D), F), M * (M + 1), M]
    return make_plan(sizes, [4, 0, 1, 3, 2], cap)


def scratch_floats(M: int, D: int, H: int, F: int, dw: bool, q8: bool) -> int:
    ffn = 16 * (D + 2 * F + (D + F if dw else 0))
    att = (3 if q8 else 2) * M * (M + 1) + M * (D // H)
    return max(ffn, att, M * D)


def layer_bwd_plan(M: int, D: int, H: int, F: int, dw: bool, q8: bool,
                   cap: int = MAX_SHARED_FLOATS) -> Plan:
    """K2's buffers X, QKV, RES, SCR, RS1, RS2, CF, DCF (``layer_bwd.cuh``);
    ``q8``: the int8-score variants' extra softmax buffer."""
    sizes = [M * D, M * qkv_stride(D), max(M * D, M * (M + 1)),
             scratch_floats(M, D, H, F, dw, q8), M, M, M, M]
    return make_plan(sizes, [4, 5, 6, 7, 0, 1, 2, 3], cap)


# ---- the Hopper K1 and K2 (csrc/fused_layer_{fwd,bwd}_sm90.cu) --------------

def sm90_shape(M: int, D: int, H: int, F: int) -> bool:
    """The shapes both Hopper kernels take (their C queries
    ``mtt_fused_layer_{fwd,bwd}_sm90_ok``): D = 128 with heads of 16, 16 <= M
    <= 64 with M % 16 == 0, F a multiple of 128."""
    return D == 128 and H * 16 == D and 16 <= M <= 64 and M % 16 == 0 and F >= 128 and F % 128 == 0


def k1_sm90_takes(dtype: torch.dtype, M: int, D: int, H: int, F: int, w8a8: bool = False,
                  int8: bool = False, weight_grads: bool = False) -> bool:
    """Whether ``fused_layer_fwd_cuda`` launches the Hopper K1: bfloat16,
    exact, with the dynamic int8 scores (``int8``: K1-int8, counter
    ``fused_layer_fwd_int8_sm90``) or W8A8 (``w8a8``: K1-W8A8, counter
    ``fused_layer_fwd_w8a8_sm90``; it wins over ``int8``), at the shapes of
    :func:`sm90_shape`, where no weight requires grad. It rounds the
    softmax weights to bf16 as the Hopper K2 does; with ``weight_grads``
    the backward is K2-dW's general first pass and the replay, which keep
    them float, so the forward is the general K1 (K1-int8) too and the
    energy and its gradient come from one function (W8A8 has no weight
    gradients)."""
    return dtype == torch.bfloat16 and not weight_grads and sm90_shape(M, D, H, F)


def k1_sm90_smem(M: int, D: int, H: int, F: int, int8: bool = False, w8a8: bool = False) -> int:
    """``mtt_fused_layer_fwd_sm90_smem`` (``int8``:
    ``mtt_fused_layer_fwd_int8_sm90_smem``; ``w8a8``:
    ``mtt_fused_layer_fwd_w8a8_sm90_smem``): its shared bytes per block (two
    atoms, each padded to 64 rows), 0 for a shape it does not take. The C
    source's layout: per atom q|k|v, where res and the ffn_h tile go later
    (bf16 rows of 3D + 8), and the operand tile (n1, attn, h_norm; bf16 rows
    of D + 8); three weight chunks of 128 x 64 bf16; per atom the floats
    cf, r1, r2; with ``int8`` or ``w8a8``, per atom the int8 copy of q and k
    (rows of 2D + 16 bytes). W8A8's int8 n1, h_norm (rows of D + 16 bytes)
    and ffn_h tile (64 x 128 in the same rows) take the rooms of their bf16
    versions."""
    if not k1_sm90_takes(torch.bfloat16, M, D, H, F, w8a8, int8):
        return 0
    rows = 64
    atom = rows * (3 * D + 8) * 2 + rows * (D + 8) * 2
    q8 = rows * (2 * D + 16) if int8 or w8a8 else 0
    return 2 * atom + 3 * 128 * 64 * 2 + 2 * 4 * 3 * rows + 2 * q8


def absmax_sm90_takes(dtype: torch.dtype, M: int, D: int, H: int, F: int,
                      weight_grads: bool = False) -> bool:
    """Whether the int8 scores' scales come from the Hopper absmax pass
    (``csrc/int8_absmax_sm90.cu``, counter ``int8_absmax_sm90``; C
    ``mtt_int8_absmax_sm90_ok``): exactly where the forward is the Hopper
    K1-int8 (:func:`k1_sm90_takes` with ``int8``), whose q and k it forms
    with the same code. Everywhere else (weight gradients, M above 64,
    d_pet 256) the general K1-int8 and K2-dW-int8 quantize, and the general
    pass (``int8_absmax``) forms q and k as they do."""
    return k1_sm90_takes(dtype, M, D, H, F, int8=True, weight_grads=weight_grads)


def absmax_sm90_smem(M: int, D: int, H: int, F: int) -> int:
    """``mtt_int8_absmax_sm90_smem``: its shared bytes per block, 0 for a
    shape it does not take. The C source's layout: the q and k rows of
    w_qkv^T as four resident 128 x 64 bf16 chunks, the n1 tiles of two atoms
    (bf16 rows of D + 8), two buffers of a pair's token rows (64 x D bf16
    per atom) and the norms' factors of two atoms (64 floats each)."""
    if not absmax_sm90_takes(torch.bfloat16, M, D, H, F):
        return 0
    rows = 64
    return 4 * 128 * 64 * 2 + 2 * rows * (D + 8) * 2 + 4 * rows * D * 2 + 2 * rows * 4


def k1_f32_sm90_takes(dtype: torch.dtype, M: int, D: int, H: int, F: int, w8a8: bool = False,
                      int8: bool = False) -> bool:
    """Whether ``fused_layer_fwd_cuda`` launches the Hopper float32 K1
    (``csrc/fused_layer_fwd_f32_sm90.cu``, counter
    ``fused_layer_fwd_f32_sm90``): float32 at the shapes of
    :func:`sm90_shape` (its C query ``mtt_fused_layer_fwd_f32_sm90_ok``),
    without W8A8 or the int8 scores, with or without weight gradients: its
    forward up to h_norm is the Hopper float32 K2's recompute, bit for bit,
    and K2-dW's float32 first pass is that kernel, so the energy and its
    gradient come from one function."""
    return dtype == torch.float32 and not (w8a8 or int8) and sm90_shape(M, D, H, F)


def k1_f32_sm90_smem(M: int, D: int, H: int, F: int) -> int:
    """``mtt_fused_layer_fwd_f32_sm90_smem``: its shared bytes per block
    (one atom, padded to 64 rows), 0 for a shape it does not take. The C
    source's layout, every buffer float: q|k|v, then the ffn_h tile (rows
    of 3D + 4), the operand tile (n1, attn, h_norm) and res (rows of D + 4
    each), three weight chunks of 128 x 16, and cf, r1, r2."""
    if not k1_f32_sm90_takes(torch.float32, M, D, H, F):
        return 0
    rows = 64
    return 4 * (rows * (3 * D + 4) + 2 * rows * (D + 4) + 3 * 128 * 16 + 3 * rows)


def k2_sm90_takes(dtype: torch.dtype, M: int, D: int, H: int, F: int, weight_grads: bool = False,
                  w8a8: bool = False, int8: bool = False) -> bool:
    """Whether ``fused_layer_bwd_cuda`` launches the Hopper K2: the bfloat16
    input-gradient variant, exact, with the dynamic int8 scores (``int8``:
    K2-int8, counter ``fused_layer_bwd_int8_sm90``) or W8A8 (``w8a8``:
    K2-W8A8, counter ``fused_layer_bwd_w8a8_sm90``; it wins over ``int8``),
    at D = 128 with heads of 16, 16 <= M <= 64 with M % 16 == 0, F a
    multiple of 128 (the shape rule is the C side's
    ``mtt_fused_layer_bwd_sm90_ok``). The weight gradients (K2-dW,
    K2-dW-int8) keep their own bodies."""
    return dtype == torch.bfloat16 and not weight_grads and sm90_shape(M, D, H, F)


def k2_sm90_smem(M: int, D: int, H: int, F: int, int8: bool = False, w8a8: bool = False) -> int:
    """``mtt_fused_layer_bwd_sm90_smem`` (``int8``:
    ``mtt_fused_layer_bwd_int8_sm90_smem``; ``w8a8``:
    ``mtt_fused_layer_bwd_w8a8_sm90_smem``): its shared bytes per block (one
    atom, padded to 64 rows), 0 for a shape it does not take. The C
    source's layout: q|k|v (bf16 rows of 3D + 8), the operand tile (n1,
    attn, h_norm, d_attn_out, dq; rows of D + 8), res and g_eo then d_res
    (float rows of D + 8), the d_vg tile then d_attn (rows of 2D + 8), three
    weight chunks of 128 x 64 bf16, and floats: cf, r1, r2, the
    softmax max, sum and delta per head, d_cf's column sums per (head,
    query tile) and the row-sum scratch; with ``int8`` or ``w8a8``, the
    int8 copy of q and k (rows of 2D + 16 bytes). W8A8's int8 n1 and h_norm
    (rows of D + 16 bytes) take the operand tile's room."""
    if not k2_sm90_takes(torch.bfloat16, M, D, H, F, w8a8=w8a8, int8=int8):
        return 0
    rows, heads = 64, 8
    tiles = rows * (3 * D + 8) * 2 + rows * (D + 8) * 2 + rows * (D + 8) * 4 + rows * (2 * D + 8) * 2
    ring = 3 * 128 * 64 * 2
    stats = 3 * rows + 3 * heads * rows + heads * 4 * rows + 4 * rows
    q8 = rows * (2 * D + 16) if int8 or w8a8 else 0
    return tiles + ring + 4 * stats + q8


def k2_f32_sm90_takes(dtype: torch.dtype, M: int, D: int, H: int, F: int,
                      weight_grads: bool = False, w8a8: bool = False, int8: bool = False) -> bool:
    """Whether the Hopper float32 K2 (``csrc/fused_layer_bwd_f32_sm90.cu``)
    runs: float32 at the shapes of :func:`sm90_shape` (its C query
    ``mtt_fused_layer_bwd_f32_sm90_ok``), without W8A8 or the int8 scores.
    Without ``weight_grads`` it is ``fused_layer_bwd_cuda``'s kernel
    (counter ``fused_layer_bwd_f32_sm90``); with them, the two-pass K2-dW's
    first pass (counter ``fused_layer_bwd_dw_f32_sm90``)."""
    return dtype == torch.float32 and not (w8a8 or int8) and sm90_shape(M, D, H, F)


def k2_f32_sm90_smem(M: int, D: int, H: int, F: int) -> int:
    """``mtt_fused_layer_bwd_f32_sm90_smem``: its shared bytes per block (one
    atom, padded to 64 rows), 0 for a shape it does not take. The C source's
    layout, every buffer float: q|k|v (rows of 3D + 4), the operand tile,
    res / g_eo / the attention backward's statistics, the d_vg tile / d_attn
    (rows of D + 4 each), three weight chunks of 128 x 16, and cf, r1, r2
    and 4 x 64 of row-sum scratch."""
    if not k2_f32_sm90_takes(torch.float32, M, D, H, F):
        return 0
    rows = 64
    return 4 * (rows * (3 * D + 4) + 3 * rows * (D + 4) + 3 * 128 * 16 + 7 * rows)


# ---- the two-pass K2-dW (csrc/fused_layer_bwd_dw_sm90.cu, layer_dw_sm90.cuh) --

K2DW_SPILL_CAP = 512 << 20  # bytes of spill per chunk, at most (dwp::kSpillCap)
DW_TILE = 128
DW_STEP_ROWS = 64
DW_MIN_SLICE_ROWS = 256


def k2dw_sm90_takes(dtype: torch.dtype, M: int, D: int, H: int, F: int, int8: bool = False) -> bool:
    """Whether ``fused_layer_bwd_cuda(..., weight_grads=True)`` launches the
    two-pass K2-dW (its C query ``mtt_fused_layer_bwd_dw_sm90_ok``): float32
    or bfloat16 (the int8 scores: bfloat16), the body's windows (M % 16 ==
    0, 16 <= M <= 256, heads dividing D) and the products' 128-wide tiles
    (D 128 or 256, F a multiple of 128). Other shapes keep the accumulate
    body."""
    dtypes = (torch.bfloat16,) if int8 else (torch.float32, torch.bfloat16)
    return (dtype in dtypes and M % 16 == 0 and 16 <= M <= 256 and H > 0 and D % H == 0
            and D % DW_TILE == 0 and 0 < D <= 256 and F > 0 and F % DW_TILE == 0)


def dw_product_tiles(D: int, F: int) -> int:
    """The 128 x 128 output tiles of the four products (w_qkv, w_out, w_in,
    w_ffn_out)."""
    nD = D // DW_TILE
    return nD * 3 * nD + nD * nD + nD * (2 * F // DW_TILE) + (F // DW_TILE) * nD


def dw_floats(D: int, F: int) -> int:
    """The 10 weights' gradients of one layer (``DwLayout(D, F).total``)."""
    return 4 * D * D + 3 * D * F + 7 * D + 2 * F


def dw_vector_floats(D: int, F: int) -> int:
    """The per-atom vector row: norm_attn, b_qkv, b_out, norm_mlp, b_in,
    b_ffn_out."""
    return 7 * D + 2 * F


def dw_slice_target_tiles(R: int, tiles: int, sms: int) -> int:
    """The slices of a chunk of R rows whose products have ``tiles`` output
    tiles (``dwp::slice_target_tiles``)."""
    s = 2 * sms // max(tiles, 1)
    return max(1, min(s, R // DW_MIN_SLICE_ROWS))


def dw_slice_target(R: int, D: int, F: int, sms: int) -> int:
    return dw_slice_target_tiles(R, dw_product_tiles(D, F), sms)


def dw_slices(R: int, tiles: int, sms: int):
    """``(step, slices)`` of a chunk of R rows whose products have ``tiles``
    output tiles: as many slices as fill two blocks per SM in one wave (2
    SMs / tiles, at least 1), fewer where one would hold under 256 rows, of
    ``step`` rows each (a multiple of 64), the last one shorter."""
    per_slice = -(-R // dw_slice_target_tiles(R, tiles, sms))
    step = -(-per_slice // DW_STEP_ROWS) * DW_STEP_ROWS
    return step, -(-R // step)


def k2dw_slices(R: int, D: int, F: int, sms: int):
    """``(step, slices)`` of a chunk of R rows of K2-dW (``mtt_layer_dw_slices``):
    :func:`dw_slices` with its four products' tiles."""
    return dw_slices(R, dw_product_tiles(D, F), sms)


class K2dwPlan(NamedTuple):
    chunk_atoms: int   # atoms per chunk (the last one may hold fewer)
    chunks: int
    vec_offset: int    # bytes: the per-atom vector rows start here in the spill
    spill_bytes: int   # the spill of one chunk: operand rows, then vector rows
    max_slices: int    # rows of the partials
    sms: int           # the card's SMs, which the slices depend on


def k2dw_plan(elem_bytes: int, A: int, M: int, D: int, F: int, sms: int,
              cap: int = K2DW_SPILL_CAP) -> K2dwPlan:
    """The two-pass K2-dW's chunks (``mtt_fused_layer_bwd_dw_sm90_plan``):
    as many atoms a chunk as keep the spill (7D + 3F values a row in the
    compute dtype, ``elem_bytes`` each, and 7D + 2F floats an atom) under
    ``cap`` bytes; where that is not all of them, a multiple of ``sms``
    (whole waves of the first pass, one atom per SM), the last chunk
    holding the rest."""
    row_bytes = (7 * D + 3 * F) * elem_bytes
    atom_bytes = M * row_bytes + dw_vector_floats(D, F) * 4
    if A <= 0:
        return K2dwPlan(0, 0, 0, 0, 0, sms)
    per = max(cap // atom_bytes, 1)
    if sms < per < A:
        per = per // sms * sms
    per = min(per, A)
    chunks = -(-A // per)
    vec_offset = -(-per * M * row_bytes // 256) * 256
    return K2dwPlan(per, chunks, vec_offset, vec_offset + per * dw_vector_floats(D, F) * 4,
                    dw_slice_target(per * M, D, F, sms), sms)


def k2dw_chunks(plan: K2dwPlan, A: int):
    """The chunks' atoms ``[(a0, a1), ...]``, in the order they run."""
    return [(a0, min(a0 + plan.chunk_atoms, A)) for a0 in range(0, A, plan.chunk_atoms)] \
        if plan.chunks else []



# ---- the Hopper K4 (csrc/rowblock_bwd_sm90.cu) -------------------------------

def k4_sm90_shape(stage: int, d_part: int, w_in: int, w_hid: int, w_out: int) -> bool:
    """The stages and widths the Hopper K4 takes (its C query
    ``mtt_rowblock_bwd_sm90_ok``): d_part = w_out = 128; the compress
    (stage 0) with 2 or 3 parts and w_hid 128; the combination (stage 1)
    with w_in = w_hid = 256; the head (stage 2) with w_in = w_hid = 128."""
    if d_part != 128 or w_out != 128:
        return False
    if stage == 0:
        return w_in in (2 * d_part, 3 * d_part) and w_hid == d_part
    if stage == 1:
        return w_in == 2 * d_part and w_hid == 2 * d_part
    if stage == 2:
        return w_in == d_part and w_hid == d_part
    return False


def k4_sm90_takes(dtype: torch.dtype, stage: int, d_part: int, w_in: int, w_hid: int, w_out: int,
                  weight_grads: bool = False) -> bool:
    """Whether ``rowblock_bwd_cuda`` launches the Hopper K4: bfloat16, no
    weight gradients, a stage and widths of :func:`k4_sm90_shape`."""
    return (dtype == torch.bfloat16 and not weight_grads
            and k4_sm90_shape(stage, d_part, w_in, w_hid, w_out))


def k4_sm90_smem(stage: int, d_part: int, w_in: int, w_hid: int, w_out: int) -> int:
    """``mtt_rowblock_bwd_sm90_smem``: its shared bytes per block, 0 where
    it does not take the stage. The C source's layout: three weight chunks
    of 128 x 64 bf16, two input tiles (bf16 rows of w_in + 8), two g tiles
    (rows of 136), the d_pre tile (rows of w_hid + 8); the combination also
    the xn tile and 6 x 64 floats (mean, rs, row-sum scratch). The head
    holds its four 128 x 128 weights (w0^T, w1^T, w1, w0) whole instead of
    the ring, then two x and two g tiles and the h0 / d_pre tile (rows of
    136 each)."""
    if not k4_sm90_shape(stage, d_part, w_in, w_hid, w_out):
        return 0
    rows = 64
    if stage == 2:
        return 4 * 128 * 128 * 2 + 5 * rows * (d_part + 8) * 2
    nbytes = 3 * 128 * 64 * 2 + 2 * rows * (w_in + 8) * 2 + 2 * rows * (d_part + 8) * 2
    nbytes += rows * (w_hid + 8) * 2
    if stage == 1:
        nbytes += rows * (w_in + 8) * 2 + 6 * rows * 4
    return nbytes


# ---- the Hopper float32 K4 and the two-pass K4-dW (csrc/rowblock_bwd_f32_sm90.cu)

K4DW_SPILL_CAP = K2DW_SPILL_CAP  # bytes of spill per chunk, at most
ROW_TILE = 64


def k4_f32_sm90_takes(dtype: torch.dtype, stage: int, d_part: int, w_in: int, w_hid: int, w_out: int,
                      weight_grads: bool = False) -> bool:
    """Whether ``rowblock_bwd_cuda`` launches the Hopper float32 K4 (its C
    query ``mtt_rowblock_bwd_f32_sm90_ok``): float32, the compress (stage 0),
    the combination (stage 1) or the head (stage 2) at the widths of
    :func:`k4_sm90_shape`. Without ``weight_grads`` it is K4 (counter
    ``rowblock_bwd_f32_sm90[<stage>]``); with them, the two-pass K4-dW's first
    pass (``rowblock_bwd_dw_f32_sm90[<stage>]``, then ``rowblock_dw_product``)."""
    return dtype == torch.float32 and k4_sm90_shape(stage, d_part, w_in, w_hid, w_out)


def k4_f32_sm90_smem(stage: int, d_part: int, w_in: int, w_hid: int, w_out: int) -> int:
    """``mtt_rowblock_bwd_f32_sm90_smem``: its shared bytes per block (both
    modes), 0 where it does not take the stage. The C source's layout, every
    buffer float: three weight chunks of 128 x 16; the x tile (rows of w_in +
    4), the d_pre tile (rows of w_hid + 4), two g tiles (rows of 132); the
    combination also ln_scale and ln_bias; rs and 4 x 128 of sum scratch;
    the head also the h0 tile (rows of w_hid + 4)."""
    if not k4_f32_sm90_takes(torch.float32, stage, d_part, w_in, w_hid, w_out):
        return 0
    rows = ROW_TILE
    floats = 3 * 128 * 16 + rows * (w_in + 4) + rows * (w_hid + 4) + 2 * rows * (d_part + 4)
    floats += (2 * w_in if stage == 1 else 0) + rows + 4 * 128
    floats += rows * (w_hid + 4) if stage == 2 else 0
    return 4 * floats


def k4dw_row_floats(stage: int, w_in: int, w_hid: int) -> int:
    """The floats the two-pass K4-dW spills a row: d_pre and h, and for the
    combination xn; the head's d_pre0, h0 and d_pre1."""
    if stage == 2:
        return 3 * w_hid
    return (w_in if stage == 1 else 0) + 2 * w_hid


def k4dw_vector_floats(stage: int, w_in: int, w_hid: int) -> int:
    """A 64-row tile's vector row: [ln_scale, ln_bias,] b0, b1 sums (w_out
    = 128; the head's b0 and b1 sums are those of d_pre0 and d_pre1)."""
    return (2 * w_in if stage == 1 else 0) + w_hid + 128


def k4dw_product_tiles(stage: int, n_parts: int) -> int:
    """The second pass's 128 x 128 output tiles: the compress one per part
    and h^T g; the combination xn^T d_pre (2 x 2) and h^T g (2 x 1); the
    head (one part) x^T d_pre0 and h0^T d_pre1."""
    return 6 if stage == 1 else n_parts + 1


class K4dwPlan(NamedTuple):
    chunk_tiles: int  # 64-row tiles a chunk (the last one may hold fewer)
    chunks: int
    vec_offset: int   # bytes: the per-tile vector rows start here in the spill
    spill_bytes: int  # the spill of one chunk: operand rows, then vector rows
    max_slices: int   # rows of the partials
    sms: int          # the card's SMs, which the slices depend on


def k4dw_plan(stage: int, rows: int, w_in: int, w_hid: int, sms: int,
              cap: int = K4DW_SPILL_CAP) -> K4dwPlan:
    """The two-pass K4-dW's chunks (``mtt_rowblock_bwd_dw_f32_sm90_plan``):
    as many 64-row tiles a chunk as keep its spill (:func:`k4dw_row_floats`
    a row and :func:`k4dw_vector_floats` a tile, float32) under ``cap``
    bytes; where that is not all of them, a multiple of ``sms`` (whole waves
    of the first pass, one tile a block), the last chunk holding the rest."""
    tiles = -(-rows // ROW_TILE)
    if tiles <= 0:
        return K4dwPlan(0, 0, 0, 0, 0, sms)
    row_bytes = 4 * k4dw_row_floats(stage, w_in, w_hid)
    tile_bytes = ROW_TILE * row_bytes + 4 * k4dw_vector_floats(stage, w_in, w_hid)
    per = max(cap // tile_bytes, 1)
    if sms < per < tiles:
        per = per // sms * sms
    per = min(per, tiles)
    vec_offset = -(-per * ROW_TILE * row_bytes // 256) * 256
    n_parts = w_in // 128
    return K4dwPlan(per, -(-tiles // per), vec_offset,
                    vec_offset + per * 4 * k4dw_vector_floats(stage, w_in, w_hid),
                    dw_slice_target_tiles(min(per * ROW_TILE, rows), k4dw_product_tiles(stage, n_parts),
                                          sms), sms)


def k4dw_chunks(plan: K4dwPlan, rows: int):
    """The chunks' rows ``[(r0, r1), ...]``, in the order they run."""
    step = plan.chunk_tiles * ROW_TILE
    return [(r0, min(r0 + step, rows)) for r0 in range(0, rows, step)] if plan.chunks else []


# ---- the Hopper K3 (csrc/rowblock_fwd_sm90.cu) -------------------------------

def k3_sm90_shape(stage: int, d_part: int, w_in: int, w_hid: int, w_out: int) -> bool:
    """The stages and widths the Hopper K3 takes (its C query
    ``mtt_rowblock_fwd_sm90_ok``): those of the Hopper K4,
    :func:`k4_sm90_shape`."""
    return k4_sm90_shape(stage, d_part, w_in, w_hid, w_out)


def k3_sm90_takes(dtype: torch.dtype, stage: int, d_part: int, w_in: int, w_hid: int, w_out: int,
                  weight_grads: bool = False) -> bool:
    """Whether ``rowblock_fwd_cuda`` launches the Hopper K3: bfloat16, a
    stage and widths of :func:`k3_sm90_shape`, and no weight that requires
    grad. With ``weight_grads`` the backward is K4-dW and the replay, and
    the training step keeps the general K3 it was measured with."""
    return (dtype == torch.bfloat16 and not weight_grads
            and k3_sm90_shape(stage, d_part, w_in, w_hid, w_out))


def k3_sm90_smem(stage: int, d_part: int, w_in: int, w_hid: int, w_out: int) -> int:
    """``mtt_rowblock_fwd_sm90_smem``: its shared bytes per block, 0 where
    it does not take the stage. The C source's layout: three weight chunks
    of 128 x 64 bf16, two input tiles (bf16 rows of w_in + 8), the h tile
    (rows of w_hid + 8); the combination also two messages tiles (rows of
    d_part + 8), the xn tile (rows of w_in + 8) and 2 x 64 floats (mean,
    rs). The head holds its two 128 x 128 weights (w0^T, w1^T) whole
    instead of the ring, then two x tiles and the h tile (rows of 136
    each)."""
    if not k3_sm90_shape(stage, d_part, w_in, w_hid, w_out):
        return 0
    rows = 64
    if stage == 2:
        return 2 * 128 * 128 * 2 + 3 * rows * (d_part + 8) * 2
    nbytes = 3 * 128 * 64 * 2 + 2 * rows * (w_in + 8) * 2 + rows * (w_hid + 8) * 2
    if stage == 1:
        nbytes += 2 * rows * (d_part + 8) * 2 + rows * (w_in + 8) * 2 + 2 * rows * 4
    return nbytes


# ---- the Hopper float32 K3 (csrc/rowblock_fwd_f32_sm90.cu) -------------------

def k3_f32_sm90_takes(dtype: torch.dtype, stage: int, d_part: int, w_in: int, w_hid: int, w_out: int,
                      weight_grads: bool = False) -> bool:
    """Whether ``rowblock_fwd_cuda`` launches the Hopper float32 K3 (its C
    query ``mtt_rowblock_fwd_f32_sm90_ok``, counter
    ``rowblock_fwd_f32_sm90[<stage>]``): the stages and widths of the Hopper
    float32 K4, :func:`k4_f32_sm90_takes` (the head's too). ``weight_grads``
    does not enter the rule: its forward up to h (the head's up to pre1) is
    the recompute of the f32 K4 and of K4-dW's first pass, so the training
    step's forward runs it too."""
    return k4_f32_sm90_takes(dtype, stage, d_part, w_in, w_hid, w_out)


def k3_f32_sm90_smem(stage: int, d_part: int, w_in: int, w_hid: int, w_out: int) -> int:
    """``mtt_rowblock_fwd_f32_sm90_smem``: its shared bytes per block, 0
    where it does not take the stage. The C source's layout, every buffer
    float: three weight chunks of 128 x 16, the x tile (rows of w_in + 4),
    the h tile (rows of w_hid + 4; the head's h0); the combination also the
    edges | messages tile (rows of w_in + 4), ln_scale and ln_bias, and
    rs."""
    if not k3_f32_sm90_takes(torch.float32, stage, d_part, w_in, w_hid, w_out):
        return 0
    rows = ROW_TILE
    floats = 3 * 128 * 16 + rows * (w_in + 4) + rows * (w_hid + 4)
    if stage == 1:
        floats += rows * (w_in + 4) + 2 * w_in + rows
    return 4 * floats


def center_fwd_floats(N: int, D: int) -> int:
    return 9 * N + D + 4 + max(4 * N, 2 * 512)


def center_bwd_floats(N: int, D: int) -> int:
    return 16 * N + D + 4


def gnn_fwd_plan(M: int, D: int, F: int, N: int) -> Plan:
    return layer_fwd_plan(M, D, F, MAX_SHARED_FLOATS - center_fwd_floats(N, D))


def gnn_block_sizes(M: int, D: int, H: int, F: int, N: int, dw: bool, backward: bool):
    """``(shared bytes, workspace floats per block)`` of the GNN block's
    forward or backward."""
    f = gnn_fwd_plan(M, D, F, N)
    if not backward:
        return 4 * (f.smem_floats + center_fwd_floats(N, D)), f.ws_floats
    b = layer_bwd_plan(M, D, H, F, dw, False)
    smem = max(f.smem_floats + center_fwd_floats(N, D), b.smem_floats, center_bwd_floats(N, D))
    return 4 * smem, max(f.ws_floats, b.ws_floats)


# ---- the Hopper GNN block (ops/kernels/gnn_block.py, csrc/gnn_node_sm90.cu) --

def gnn_node_sm90_shape(N: int, D: int) -> bool:
    """The widths the Hopper node-stream kernels take (their C query
    ``mtt_gnn_node_sm90_ok``): d_pet D = 128 and the node width N = 128 or
    256 (PET's default d_node), each a whole number of 128-column panels
    whose accumulators stay in registers."""
    return D == 128 and N in (128, 256)


def gnn_node_f32_sm90_shape(N: int, D: int) -> bool:
    """The widths the Hopper float32 node-stream kernels take (their C query
    ``mtt_gnn_node_f32_sm90_ok``): d_pet D = 128 and the node width N = 128
    or 256 (PET's default d_node), the widths whose float tiles fit the
    shared-memory plan of :func:`gnn_node_f32_sm90_smem` (N = 384 would
    need 324,864 B for the backward) with their 64 x N sums in registers."""
    return D == 128 and N in (128, 256)


def gnn_sm90_takes(dtype: torch.dtype, M: int, D: int, H: int, F: int, N: int, expanded: bool,
                   weight_grads: bool = False) -> bool:
    """Whether ``gnn_block_{fwd,bwd}_cuda`` run the Hopper GNN block: each
    attention layer on the Hopper kernels and, with the node expansion, the
    node stream on a Hopper node-stream pair, at the shapes of
    :func:`sm90_shape`:

    - bfloat16 where no weight requires grad (K1's rule: the Hopper K1
      rounds P, the weight-gradient body and the replay do not): the Hopper
      K1 and K2, the node stream on ``csrc/gnn_node_sm90.cu`` at the widths
      of :func:`gnn_node_sm90_shape`;
    - float32 with or without ``weight_grads``: the Hopper float32 K1, K2
      or two-pass K2-dW, the node stream on ``csrc/gnn_node_f32_sm90.cu``
      (its spill mode and split-K product for the weight gradients) at the
      widths of :func:`gnn_node_f32_sm90_shape`, d_node 128 or 256. The f32
      call and the f32 training step both run this forward, so energy and
      forces come from one function.

    Everything else keeps ``csrc/gnn_block_{fwd,bwd}.cu``."""
    if not sm90_shape(M, D, H, F):
        return False
    if dtype == torch.float32:
        return not expanded or gnn_node_f32_sm90_shape(N, D)
    return (dtype == torch.bfloat16 and not weight_grads
            and (not expanded or gnn_node_sm90_shape(N, D)))


def gnn_node_f32_sm90_smem(N: int, D: int, backward: bool) -> int:
    """``mtt_gnn_node_f32_sm90_smem``: the float32 node-stream kernels'
    shared bytes per block (one tile of 64 atoms, the backward's in either
    mode), 0 for widths they do not take. The C source's plan, float tiles
    of 64 rows with 4 floats of padding: the ring of three 128 x 16 weight
    chunks; forward cattn (D wide), n_mid and hn (N wide), the sigmoid /
    h tile (128), r2; backward the rooms that phases share: U (two 128
    tiles, or one N tile where wider: d_center, n_mid, d_v | d_g, cattn),
    HN (cattn, hn, n_mid again), DN (d_n, then d_nmid), r2 and 4 x 128
    floats of sum scratch."""
    if not gnn_node_f32_sm90_shape(N, D):
        return 0
    rows = 64

    def tile(width):
        return rows * (width + 4)

    ring = 3 * 128 * 16
    if not backward:
        return 4 * (ring + tile(D) + 2 * tile(N) + tile(128) + rows)
    return 4 * (ring + max(2 * tile(128), tile(N)) + 2 * tile(N) + rows + 4 * 128)


def gnn_node_dw_tiles(N: int, D: int) -> int:
    """The 128 x 128 output tiles of the node weights' four products in the
    float32 second pass: w_contr (N x D), w_exp (D x N), w_in_c (N x 4N),
    w_out_c (2N x N)."""
    n, d = N // DW_TILE, D // DW_TILE
    return n * d + d * n + n * 4 * n + 2 * n * n


def gnn_node_dw_floats(N: int, D: int) -> int:
    """The node weights' gradients of one layer (``CenterWeights``)."""
    return 2 * N * D + D + 6 * N * N + 7 * N


def gnn_node_sm90_smem(N: int, D: int, backward: bool) -> int:
    """``mtt_gnn_node_sm90_smem``: the node-stream kernels' shared bytes per
    block (one tile of 64 atoms), 0 for widths they do not take. The C
    source's layout, bf16 tiles of 64 rows with 8 elements of padding: the
    ring of three 128 x 64 weight chunks; forward cattn (D wide), n_mid and
    hn (N wide), the h tile (128), r2; backward d_center and cattn (D),
    n_mid, hn and rnd(d_n) (N), the d_v and d_g tiles (128), r2 and 4 x 64
    floats of row-sum scratch."""
    if not gnn_node_sm90_shape(N, D):
        return 0
    rows = 64

    def tile(width):
        return rows * (width + 8) * 2

    ring = 3 * 128 * 64 * 2
    if not backward:
        return ring + tile(D) + 2 * tile(N) + tile(128) + 4 * rows
    return ring + 2 * tile(D) + 3 * tile(N) + 2 * tile(128) + 4 * 5 * rows


def rowblock_fwd_rows(w_in: int, w_hid: int) -> int:
    """K3's rows per tile: 64, or 32 or 16 where 64 do not fit."""
    rows = 64
    while rows > 16 and rows * (w_in + w_hid) > MAX_SHARED_FLOATS:
        rows //= 2
    return rows


def rowblock_bwd_floats(stage: int, w_in: int, w_hid: int, w_out: int, dw: bool, rows: int) -> int:
    if stage == 2:  # head
        return rows * (w_in + 3 * w_hid)
    return rows * (w_in + w_hid + w_out + (w_hid if dw else 0)) + 2 * rows


def rowblock_bwd_rows(stage: int, w_in: int, w_hid: int, w_out: int, dw: bool) -> int:
    """K4's (K4-dW's) rows per tile."""
    rows = 64
    while rows > 16 and rowblock_bwd_floats(stage, w_in, w_hid, w_out, dw, rows) > MAX_SHARED_FLOATS:
        rows //= 2
    return rows


def head_regs(hd: int) -> int:
    """The register width of a head in the window-attention float kernels
    (0: wider than they take)."""
    for width in (8, 16, 32, 64):
        if hd <= width:
            return width
    return 0


def ptr(t):
    return None if t is None else t.data_ptr()


def pointer_array(tensors):
    """A host array of the tensors' device pointers (an argument of type
    ``_PP``), or ``None`` for no tensors."""
    tensors = list(tensors)
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors)) if tensors else None
