"""Build, load and launch the port's CUDA kernels (``metatrain_tpu_torch/csrc``).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source file, all at once, linked into one shared library
with a plain C interface, written to the git-ignored
``metatrain_tpu_torch/_build/``, and bound with ctypes. Every
pointer argument is a ``c_void_p``; each C entry point launches on the
current PyTorch stream and returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where
it launches its kernel, and nowhere else. ``REPLAYS`` counts the
second-order replays (plain PyTorch, no kernel) by the op they replay.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import shutil
from pathlib import Path

import torch

from ..._build import PACKAGE_DIR, build_library

CSRC = PACKAGE_DIR / "csrc"
SOURCES = (
    "fused_layer_fwd.cu",
    "fused_layer_bwd.cu",
    "rowblock_fwd.cu",
    "rowblock_bwd.cu",
    "permute.cu",
    "window_attention_fwd.cu",
    "window_attention_bwd.cu",
    "gnn_block_fwd.cu",
    "gnn_block_bwd.cu",
)
LIBRARY = "libmtt_kernels.so"
MAX_SHARED_BYTES = 232448  # per block on sm_90 (227 KB)

LAUNCHES: collections.Counter = collections.Counter()
REPLAYS: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers
_FP = ctypes.POINTER(ctypes.c_float)  # a host array of floats
_SIGNATURES = {
    "mtt_fused_layer_fwd": [_I] + [_P] * 15 + [_L, _I, _I, _I, _I, _F, _F, _P],
    "mtt_fused_layer_bwd": [_I] + [_P] * 21 + [_I, _P] + [_L, _I, _I, _I, _I, _F, _F, _P],
    "mtt_fused_layer_fwd_w8a8": [_P] * 16 + [_FP, _P, _P, _L, _I, _I, _I, _I, _F, _P],
    "mtt_fused_layer_bwd_w8a8": [_P] * 17 + [_FP] + [_P] * 5 + [_L, _I, _I, _I, _I, _F, _F, _P],
    "mtt_rowblock_fwd": [_I, _I, _P, _P, _P, _I] + [_P] * 7 + [_L, _I, _I, _I, _I, _P],
    "mtt_rowblock_bwd": [_I, _I, _P, _P, _P, _I] + [_P] * 13 + [_I, _P] + [_L, _I, _I, _I, _I, _P],
    "mtt_permute": [_I, _P, _P, _P, _P, _L, _I, _P],
    "mtt_window_attention_fwd": [_I, _P, _P, _P, _I, _I, _I, _P, _P, _L, _I, _I, _I, _F, _P],
    "mtt_window_attention_bwd": [_I] + [_P] * 4 + [_I] * 4 + [_P] * 5 + [_L, _I, _I, _I, _F, _P],
    "mtt_gnn_block_fwd": [_I, _P, _P, _P, _PP, _PP, _P, _P, _L] + [_I] * 7 + [_F, _F, _P],
    "mtt_gnn_block_bwd": [_I, _P, _P, _P, _PP, _PP, _PP] + [_P] * 7 + [_I] + [_P] * 3 + [_I, _P, _L]
    + [_I] * 7 + [_F, _F, _P],
    "mtt_fused_layer_fwd_smem": [_I, _I, _I],
    "mtt_fused_layer_bwd_smem": [_I, _I, _I, _I, _I],
    "mtt_fused_layer_bwd_w8a8_smem": [_I, _I, _I, _I],
    "mtt_rowblock_fwd_smem": [_I, _I],
    "mtt_rowblock_bwd_smem": [_I, _I, _I, _I, _I],
    "mtt_window_attention_fwd_smem": [_I, _I, _I, _I],
    "mtt_window_attention_bwd_smem": [_I, _I, _I, _I],
    "mtt_gnn_block_fwd_smem": [_I] * 4,
    "mtt_gnn_block_bwd_smem": [_I] * 6,
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
    headers = sorted(CSRC.glob("*.cuh"))
    path = build_library(link, units + headers, LIBRARY, timeout=900,
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


def dw_blocks(work_items: int, device: torch.device) -> int:
    """Blocks of a weight-gradient kernel: one per SM (one block fits an
    SM for shared memory), fewer when there are fewer work items. Fixed
    for a card and a shape, so the partial sums and their order are too."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(int(work_items), sms))


def ptr(t):
    return None if t is None else t.data_ptr()


def pointer_array(tensors):
    """A host array of the tensors' device pointers (an argument of type
    ``_PP``), or ``None`` for no tensors."""
    tensors = list(tensors)
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors)) if tensors else None
