"""Check on a CUDA device that the Hopper K1 and the Hopper K2's recompute
compute attn, res and h_norm to the same bits, in bfloat16 or in float32;
or that the Hopper float32 K3 and the Hopper float32 K4's recompute compute
a row-block stage's pre, h, xn0 and rs (the head's pre0, h0 and pre1) to
the same bits.

Usage, on a machine with a CUDA device and nvcc::

    python metatrain_tpu_torch/tools/sm90_front.py [--dtype bfloat16|float32] [--A 2047] [--M 64]
    python metatrain_tpu_torch/tools/sm90_front.py --int8 [--A 2047] [--M 64]
    python metatrain_tpu_torch/tools/sm90_front.py --w8a8 [--A 2047] [--M 64]
    python metatrain_tpu_torch/tools/sm90_front.py --kernel rowblock --dtype float32 \
        --stage compress|combination|head [--rows 100003]

In bfloat16 both kernels run the forward phases of ``csrc/layer_sm90.cuh``
up to h_norm, K1 in its two-atom layout (m64n64k16 panels) and K2 in its
one-atom layout (m64n32k16). In float32 the Hopper float32 K1
(``csrc/fused_layer_fwd_f32_sm90.cu``) and the Hopper float32 K2
(``csrc/fused_layer_bwd_f32_sm90.cu``) both run those of
``csrc/layer_f32_sm90.cuh``, one atom per block. The tool copies the
sources into a temporary directory, inserts into each kernel a copy of the
atom's attn (after the attention) and of res and h_norm (after the second
norm) to a global buffer, builds each copy alone with nvcc, runs both on
one seeded case (D = 128, 8 heads, F = 256, inputs as ``layer_times.py``
makes them, in ``--dtype``; an odd A, so that the bf16 K1's last block
holds one atom) and prints one JSON line: the card (``nvidia-smi`` name
and power limit), the dtype, the shape, and per activation whether the
two kernels' copies are bitwise equal. The checkout's sources are not
changed: they carry no such copies.

With ``--int8`` (bfloat16) the two kernels run their int8-score mode
(K1-int8 and K2-int8, the entries ``mtt_fused_layer_{fwd,bwd}_int8_sm90``)
on the port's per-atom scales (``fused_layer.int8_scales_for``), and the
copies take q|k|v too (before the attention): the line says whether
K1-int8's q|k|v, attn, res and h_norm equal K2-int8's recompute. Beside
them the tool builds a plain copy of the Hopper absmax pass
(``csrc/int8_absmax_sm90.cu`` with ``csrc/int8_absmax.cu``) and reports
under ``absmax_sm90`` whether its scales equal, bit for bit, the per-block
max of the q and k that K1-int8 quantizes (:func:`absmax_compare`, which
``chip_smoke.py`` runs on the port's own pass at M = 64, 48 and 16).

With ``--w8a8`` (bfloat16) the two kernels run their W8A8 mode (K1-W8A8 and
K2-W8A8, the entries ``mtt_fused_layer_{fwd,bwd}_w8a8_sm90``) on the port's
int8 weights and scales (``fused_layer._w8a8_kernel_args`` of a calibration
from the plain probe), and the copies, in float, take q|k|v, the int8 q and
k, attn, res, the int8 h_norm and vg (the FFN-in product, dequantized and
biased, before the SwiGLU): the line says whether K1-W8A8's copies equal
K2-W8A8's recompute's. The buffer starts as NaN, so a slot that either
kernel leaves unwritten is unequal.

With ``--kernel rowblock`` (float32 only) the Hopper float32 K3
(``csrc/rowblock_fwd_f32_sm90.cu``) and the Hopper float32 K4
(``csrc/rowblock_bwd_f32_sm90.cu``) both run the forward up to h of
``csrc/rowblock_f32_sm90.cuh``. The copies take, per row, pre (after the
pre product and its bias), h (K3: its h tile as the second product reads
it; K4: ``hidden(pre)``, as K4-dW spills it) and, for the combination, xn0
and rs (after the LayerNorm); for the head, pre0 and pre1 (after
``head_pre1``) and h0 (its h tile, as the pre1 product reads it, in both).
One seeded case of ``--rows`` rows (odd by default, so that the last 64-row
tile is partial: the 3-part compress, or edges, reversed and messages, or
the head's x, with the weights ``layer_times.py`` makes); the JSON line
says per activation whether the two kernels' copies are bitwise equal, and
whether every valid row was written. The head's output is silu(pre1), so
its pre1 equal means the f32 K3 head's output is the f32 K4 head's
recompute. ``chip_smoke.py`` runs the head's check through
:func:`spawn` (the copies built beside the kernels) and
:func:`rowblock_compare`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"

# g_dump is (A, M, 3, D) bf16 (float32 for the float32 kernels): attn, res,
# h_norm of each atom's rows
DUMP = '__device__ __nv_bfloat16* g_dump;\n'
DUMP_F32 = '__device__ float* g_dump;\n'
SETTER = ('\nextern "C" int dump_set(void* p) '
          '{ return (int)cudaMemcpyToSymbol(g_dump, &p, sizeof(p)); }\n')


def _copy(slot: int, rows: str, src: str, ld: str = "LA", slots: int = 3, width: str = "D") -> str:
    """Code that copies ``width`` columns of ``src`` rows (bf16 rows of LA,
    or rows of ``ld``) of atom ``rows`` into g_dump from slot ``slot`` on
    (rows of ``slots`` x D); ``rows`` names the atom index expression. A
    float g_dump of 12 slots (``--w8a8``) takes bf16 and int8 values as
    floats."""
    pre, post = ("dump_f(", ")") if slots == 12 else ("", "")
    return (f"    __syncthreads();\n"
            f"    for (int i_ = threadIdx.x; i_ < M * {width}; i_ += blockDim.x)\n"
            f"        g_dump[(({rows}) * M + i_ / {width}) * {slots} * D + {slot} * D + i_ % {width}] = "
            f"{pre}{src}[(i_ / {width}) * {ld} + i_ % {width}]{post};\n")


def _k1_copy(slot: int, buf: str, **kw) -> str:
    # both atoms of the block, atom 1 only where it exists
    return (_copy(slot, "a0", buf, **kw)
            + "    if (has1) {\n" + _copy(slot, "a1", f"({buf} + kStride)", **kw) + "    }\n")


# (text, insert before it, code): each text occurs once in its source
K1_MARKS = (
    ('#include "layer_sm90.cuh"\n', False, DUMP),
    ("    // ---- res = rnd(x1", True, _k1_copy(0, "OP")),
    ("    // ---- SwiGLU over F tiles", True, _k1_copy(1, "RES") + _k1_copy(2, "OP")),
)
K2_MARKS = (
    ('#include "layer_sm90.cuh"\n', False, DUMP),
    ("    // res = rnd(x1 + rnd(attn w_out + b))", True, _copy(0, "a", "OP")),
    ("    // ---- SwiGLU backward", True, _copy(1, "a", "RES") + _copy(2, "a", "OP")),
)

# the int8-score mode (--int8): g_dump is (A, M, 6, D), attn, res and
# h_norm, then q|k|v (copied before the attention); beside the pair, a
# plain copy of the Hopper absmax pass, whose scales must be those of
# K1-int8's q and k (absmax_compare; chip_smoke.py builds K1_INT8 alone)
QKV6 = dict(ld="LQ", slots=6, width="(3 * D)")
K1_INT8_MARKS = (
    ('#include "layer_sm90.cuh"\n', False, DUMP),
    ("    // ---- attention, one warp per", True, _k1_copy(3, "QKV", **QKV6)),
    ("    // ---- res = rnd(x1", True, _k1_copy(0, "OP", slots=6)),
    ("    // ---- SwiGLU over F tiles", True, _k1_copy(1, "RES", slots=6) + _k1_copy(2, "OP", slots=6)),
)
K2_INT8_MARKS = (
    ('#include "layer_sm90.cuh"\n', False, DUMP),
    ("    // ---- recompute: attention", True, _copy(3, "a", "QKV", **QKV6)),
    ("    // res = rnd(x1 + rnd(attn w_out + b))", True, _copy(0, "a", "OP", slots=6)),
    ("    // ---- SwiGLU backward", True, _copy(1, "a", "RES", slots=6) + _copy(2, "a", "OP", slots=6)),
)

K1_INT8 = ("k1_int8", "fused_layer_fwd_sm90.cu", K1_INT8_MARKS)

# the float32 kernels: one atom per block, float tiles in rows of LT
K1_F32_MARKS = (
    ('#include "layer_sm90.cuh"\n', False, DUMP_F32),
    ("    // ---- res = x1 + (attn w_out + b)", True, _copy(0, "a", "OP", "LT")),
    ("    // ---- SwiGLU over F tiles", True, _copy(1, "a", "RES", "LT") + _copy(2, "a", "OP", "LT")),
)
K2_F32_MARKS = (
    ('#include "layer_sm90.cuh"\n', False, DUMP_F32),
    ("    // res = x1 + (attn w_out + b)", True, _copy(0, "a", "OP", "LT")),
    ("    // g_eo into res's buffer", True, _copy(1, "a", "RES", "LT") + _copy(2, "a", "OP", "LT")),
)
# the W8A8 mode (--w8a8): g_dump is float, (A, M, 12, D): attn, res, the
# int8 h_norm, q|k|v, the int8 q|k, then vg (value columns, then gate)
DUMP_W8 = ('__device__ float* g_dump;\n'
           '__device__ __forceinline__ float dump_f(__nv_bfloat16 x) { return __bfloat162float(x); }\n'
           '__device__ __forceinline__ float dump_f(int8_t x) { return (float)x; }\n')
W8 = dict(slots=12)
VG_SLOT = 8


def _k1_vg() -> str:
    """K1-W8A8's vg of the calling thread's atom after each FFN-in chunk
    (ffn_w8a8: the atom from its edge_out rows), dequantized as the kernel
    dequantizes it."""
    return ("            panel_pairs([&](int j_, int h_, int m_, int n_) {\n"
            "                const int col_ = j0 + 64 * r + n_ % 32 + 32 * ((threadIdx.x >> 7) & 1);\n"
            "                if (m_ >= M || !store) return;\n"
            "                const long long a_ = (eo - p.edge_out) / ((long long)M * D);\n"
            f"                float* d_ = g_dump + (size_t)(a_ * M + m_) * 12 * D + {VG_SLOT} * D + col_;\n"
            "                for (int u_ = 0; u_ < 2; ++u_) {\n"
            "                    d_[u_] = dequant(av[j_][2 * h_ + u_], s8.deq_in, to_f(p.b_in[col_ + u_]));\n"
            "                    d_[F + u_] = dequant(ag[j_][2 * h_ + u_], s8.deq_in, to_f(p.b_in[F + col_ + u_]));\n"
            "                }\n"
            "            });\n")


_K2_VG = ("        if constexpr (W8) {\n"
          "            panel_each([&](int j_, int i_, int m_, int n_) {\n"
          "                if (m_ >= M) return;\n"
          f"                float* d_ = g_dump + (size_t)(a * M + m_) * 12 * D + {VG_SLOT} * D + j0 + n_;\n"
          "                d_[0] = av[j_][i_];\n"
          "                d_[F] = ag[j_][i_];\n"
          "            });\n"
          "        }\n")
QKV8 = dict(ld="LQ8", slots=12, width="(2 * D)")
K1_W8A8_MARKS = (
    ('#include "layer_sm90.cuh"\n', False, DUMP_W8),
    ("    // ---- attention, one warp per", True,
     _k1_copy(3, "QKV", ld="LQ", slots=12, width="(3 * D)") + _k1_copy(6, "Q8", **QKV8)
     .replace("(Q8 + kStride)", "(Q8 + kQ8Bytes)")),
    ("    // ---- res = rnd(x1", True, _k1_copy(0, "OP", **W8)),
    ("        ffn_w8a8(ring, c, p,", True,
     (_k1_copy(1, "RES", **W8) + _k1_copy(2, "OP8", ld="LA8", **W8)).replace("(OP8 + kStride)",
                                                                               "(OP8 + kAtomBytes)")),
    ("            glu_mm_s8(ring, c, HN, av, ag);\n", False, _k1_vg()),
)
K2_W8A8_MARKS = (
    ('#include "layer_sm90.cuh"\n', False, DUMP_W8),
    ("    // ---- recompute: attention", True,
     _copy(3, "a", "QKV", ld="LQ", slots=12, width="(3 * D)") + _copy(6, "a", "Q8", **QKV8)),
    ("    // res = rnd(x1 + rnd(attn w_out + b))", True, _copy(0, "a", "OP", **W8)),
    ("    // ---- SwiGLU backward", True, _copy(1, "a", "RES", **W8) + _copy(2, "a", "OP8", ld="LA8", **W8)),
    ("        panel_mm<2>(ring, c, [&](int r, int& ld) { ld = LA; return (const bf16*)GEO + r * kChunkK; }, ad);\n",
     True, _K2_VG),
)
W8A8_SLOTS = {"attn": (0, 1), "res": (1, 2), "h_norm_int8": (2, 3), "q": (3, 4), "k": (4, 5),
              "v": (5, 6), "q_int8": (6, 7), "k_int8": (7, 8), "vg": (8, 12)}

KERNELS = {
    "bfloat16": (("k1", "fused_layer_fwd_sm90.cu", K1_MARKS), ("k2", "fused_layer_bwd_sm90.cu", K2_MARKS)),
    "float32": (("k1", "fused_layer_fwd_f32_sm90.cu", K1_F32_MARKS),
                ("k2", "fused_layer_bwd_f32_sm90.cu", K2_F32_MARKS)),
    "int8": (("k1", "fused_layer_fwd_sm90.cu", K1_INT8_MARKS),
             ("k2", "fused_layer_bwd_sm90.cu", K2_INT8_MARKS),
             ("absmax", ("int8_absmax_sm90.cu", "int8_absmax.cu"), ())),
    "w8a8": (("k1", "fused_layer_fwd_sm90.cu", K1_W8A8_MARKS),
             ("k2", "fused_layer_bwd_sm90.cu", K2_W8A8_MARKS)),
}

# the row-block stages: g_dump is (rows, RB_STRIDE) float, per row pre at 0,
# h at 256, xn0 at 512 and rs at 768 (the tile's rows from row0, those
# below valid); the head's pre0 at 0, h0 at 256 and pre1 at 512
RB_STRIDE = 1024
RB_SLOTS = {"pre": 0, "h": 256, "xn0": 512, "rs": 768}


def _rb_pre(col: str, with_h: bool) -> str:
    """Code that copies the pre panel (registers, columns ``col`` + n) and,
    with ``with_h``, hidden(pre) of the tile's valid rows."""
    h = ("            d_[256] = hidden(pre[j_][2 * h_]);\n"
         "            d_[257] = hidden(pre[j_][2 * h_ + 1]);\n") if with_h else ""
    return ("    panel_pairs([&](int j_, int h_, int m_, int n_) {\n"
            "        if (m_ < valid) {\n"
            f"            float* d_ = g_dump + (size_t)(row0 + m_) * {RB_STRIDE} + {col} + n_;\n"
            "            d_[0] = pre[j_][2 * h_];\n"
            "            d_[1] = pre[j_][2 * h_ + 1];\n"
            f"{h}"
            "        }\n"
            "    });\n")


def _rb_rows(slot: int, src: str, ld: str, width: str) -> str:
    """Code that copies ``width`` columns of the tile's valid rows of
    ``src`` (rows of ``ld`` floats) into ``slot``."""
    return ("    __syncthreads();\n"
            f"    for (int i_ = threadIdx.x; i_ < kRows * ({width}); i_ += blockDim.x) {{\n"
            f"        const int m_ = i_ / ({width}), k_ = i_ % ({width});\n"
            f"        if (m_ < valid) g_dump[(size_t)(row0 + m_) * {RB_STRIDE} + {slot} + k_] = "
            f"{src}[m_ * {ld} + k_];\n"
            "    }\n")


# the head (both kernels' head_tile): pre0 and pre1 from registers, h0
# from the h tile
_RB_HEAD = ("    panel_pairs([&](int j_, int h_, int m_, int n_) {\n"
            "        if (m_ < valid) {\n"
            f"            float* d_ = g_dump + (size_t)(row0 + m_) * {RB_STRIDE} + n_;\n"
            "            d_[0] = pre0[j_][2 * h_];\n"
            "            d_[1] = pre0[j_][2 * h_ + 1];\n"
            "            d_[512] = pre1[j_][2 * h_];\n"
            "            d_[513] = pre1[j_][2 * h_ + 1];\n"
            "        }\n"
            "    });\n"
            + _rb_rows(256, "H", "Widths<kHead, 1>::LH", "128"))
_RB_HEAD_MARK = "    head_pre1(ring, c, X, H, p.b0, p.b1, pre0, pre1);\n"
_RB_LN = (_rb_rows(512, "X", "G::LX", "G::W_IN")
          + f"    if ((int)threadIdx.x < valid) g_dump[(size_t)(row0 + threadIdx.x) * {RB_STRIDE} + 768] = "
          "RS[threadIdx.x];\n")
_RB_DUMP = '#include "rowblock_f32_sm90.cuh"\n'
ROWBLOCK_KERNELS = {
    "compress": (
        ("k3", "rowblock_fwd_f32_sm90.cu", (
            (_RB_DUMP, False, DUMP_F32),
            ("    compress_pre<NP>(ring, c, X, p.b0, pre);\n", False, _rb_pre("0", False)),
            ("    // (the first consume's barrier orders these stores before the reads)\n"
             "    out_panel<kCompress", True, _rb_rows(256, "H", "G::LH", "G::W_HID")))),
        ("k4", "rowblock_bwd_f32_sm90.cu", (
            (_RB_DUMP, False, DUMP_F32),
            ("    compress_pre<NP>(ring, c, X, p.b0, pre);\n", False, _rb_pre("0", True)))),
    ),
    "combination": (
        ("k3", "rowblock_fwd_f32_sm90.cu", (
            (_RB_DUMP, False, DUMP_F32),
            ("    layer_norm_rows(X, RS);\n", False, _RB_LN),
            ("        combination_pre(ring, c, X, LN, p.b0, q, pre);\n", False,
             _rb_pre("q * kCN", False)),
            ("    // out = (messages + edges) + (h w1 + b1)", True,
             _rb_rows(256, "H", "G::LH", "G::W_HID")))),
        ("k4", "rowblock_bwd_f32_sm90.cu", (
            (_RB_DUMP, False, DUMP_F32),
            ("    // (the first consume's barrier orders these stores before the reads)\n"
             "    float* v = p.vec", True, _RB_LN),
            ("        combination_pre(ring, c, X, LN, p.b0, q, pre);\n", False,
             _rb_pre("q * kCN", True)))),
    ),
    "head": tuple((key, source, ((_RB_DUMP, False, DUMP_F32), (_RB_HEAD_MARK, False, _RB_HEAD)))
                  for key, source in (("k3", "rowblock_fwd_f32_sm90.cu"),
                                      ("k4", "rowblock_bwd_f32_sm90.cu"))),
}


def instrument(text: str, marks) -> str:
    for mark, before, code in marks:
        if text.count(mark) != 1:
            raise RuntimeError(f"mark not found once in the source: {mark!r}")
        at = text.index(mark) + (0 if before else len(mark))
        text = text[:at] + code + text[at:]
    return text + SETTER


def spawn(work: Path, kernels) -> dict:
    """Start one nvcc per instrumented copy of ``kernels`` in ``work`` (a
    tuple of sources without marks: one library of the plain copies);
    returns the processes by key (:func:`load` waits for them)."""
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, work / header.name)
    nvcc = shutil.which("nvcc") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")
    procs = {}
    for key, source, marks in kernels:
        if isinstance(source, tuple):
            units = [work / f"{key}_{s}" for s in source]
            for unit, s in zip(units, source):
                unit.write_text((CSRC / s).read_text())
        else:
            units = [work / f"{key}_{source}"]
            units[0].write_text(instrument((CSRC / source).read_text(), marks))
        procs[key] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-shared", *map(str, units), "-o", str(work / f"{key}.so")])
    return procs


def load(work: Path, procs: dict) -> dict:
    """Wait for :func:`spawn`'s builds and load the copies (killing the
    others where one fails)."""
    try:
        for key, proc in procs.items():
            if proc.wait(timeout=600) != 0:
                raise RuntimeError(f"nvcc failed on the {key} copy")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {key: ctypes.CDLL(str(work / f"{key}.so")) for key in procs}


def build(work: Path, mode: str = "bfloat16", kernels=None) -> dict:
    return load(work, spawn(work, kernels or KERNELS[mode]))


def port_fused_layer():
    """The port's ``ops.kernels.fused_layer`` of this checkout (its rules
    and plain versions: the kernels under test are the tool's copies, not
    the port's library)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the checkout
    from metatrain_tpu_torch.ops.kernels import fused_layer as fl

    return fl


def port_int8_scales(e, c, w, H):
    """The (A, 2) int8 score scales of one layer call, as the port takes
    them (``fused_layer.int8_scales_for``, its plain absmax pass)."""
    fl = port_fused_layer()
    return fl.int8_scales_for(e, c, fl.LayerWeights(*w), H, plain=True)


def port_w8a8(e, c, cf, w, H, scale):
    """The W8A8 kernels' int8 weights and scales for one layer call, as the
    port passes them: a calibration from the plain probe on these inputs,
    ``fused_layer._w8a8_kernel_args`` (the int8 w_qkv^T, w_in^T, w_ffn_out^T
    and the 11 scales) and K1's arrangement of w_in^T
    (``k1_sm90_w_vg``)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the checkout
    from metatrain_tpu_torch.ops.kernels import fused_layer as fl

    lw = fl.LayerWeights(*w)
    calib = fl.Int8Calib.from_stats(fl.layer_probe_stats(e, c, cf, lw, H, scale).tolist(), lw)
    int8_t, scales = fl._w8a8_kernel_args(e, (calib, fl.quantize_layer_weights(lw, calib)), H, scale)
    return int8_t, fl.k1_sm90_w_vg(int8_t[1].t()), scales


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("layer", "rowblock"), default="layer")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--int8", action="store_true", help="the int8-score mode (bfloat16)")
    parser.add_argument("--w8a8", action="store_true", help="the W8A8 mode (bfloat16)")
    parser.add_argument("--stage", choices=tuple(ROWBLOCK_KERNELS), default="compress")
    parser.add_argument("--A", type=int, default=2047)
    parser.add_argument("--M", type=int, default=64)
    parser.add_argument("--rows", type=int, default=100003)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sm90_front: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    if args.kernel == "rowblock":
        if args.dtype != "float32":
            parser.error("--kernel rowblock compares the float32 K3 and K4")
        return rowblock_main(args, card)
    if (args.int8 or args.w8a8) and args.dtype != "bfloat16":
        parser.error("--int8 and --w8a8 run the bfloat16 kernels")
    if args.int8 and args.w8a8:
        parser.error("one mode at a time")
    A, M, D, H, F = args.A, args.M, 128, 8, 256
    dev = torch.device("cuda", 0)
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    w, e, c, cf, ge, gc, t, w_vg = make_case(A, M, dtype, dev)
    scale, eps = 1.0 / math.sqrt(D // H), EPS
    P, I, L, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    if args.w8a8:
        return w8a8_main(card, A, M, D, H, F, e, c, cf, w, t, ge, gc, scale, eps)
    dumps = {}
    slots = ("attn", "res", "h_norm") + (("q", "k", "v") if args.int8 else ())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), "int8" if args.int8 else args.dtype)
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the float32 K1 reads w_in^T as it is
        runs = {
            "k1": ("mtt_fused_layer_fwd_f32_sm90", [P] * 15,
                   [e, c, cf, *(w[i] for i in (0, 2, 4, 5, 7, 9)), t[1], t[3], t[6], t[8],
                    torch.empty_like(e), torch.empty_like(c)]),
            "k2": ("mtt_fused_layer_bwd_f32_sm90", [P] * 20,
                   [e, c, cf, *w[:9], t[1], t[3], t[6], ge, gc, torch.empty_like(e),
                    torch.empty_like(c), torch.empty_like(cf)]),
        } if args.dtype == "float32" else {
            "k1": ("mtt_fused_layer_fwd_sm90", [P] * 15,
                   [e, c, cf, *(w[i] for i in (0, 2, 4, 5, 7, 9)), t[1], t[3], w_vg, t[8],
                    torch.empty_like(e), torch.empty_like(c)]),
            "k2": ("mtt_fused_layer_bwd_sm90", [P] * 20,
                   [e, c, cf, *w[:9], t[1], t[3], t[6], ge, gc, torch.empty_like(e),
                    torch.empty_like(c), torch.empty_like(cf)]),
        }
        if args.int8:
            # the scales after K1's weight matrices and K2's transposed weights
            s8 = port_int8_scales(e, c, w, H)
            for key, at in (("k1", 13), ("k2", 15)):
                entry, ptypes, ptrs = runs[key]
                runs[key] = (entry.replace("_sm90", "_int8_sm90"), ptypes + [P],
                             ptrs[:at] + [s8] + ptrs[at:])
            # the Hopper absmax pass (the tool's copy) against K1-int8's q|k
            absmax = absmax_compare(libs["k1"], A, M, copy_absmax(libs["absmax"]))
        for key, (entry, ptypes, ptrs) in runs.items():
            dump = torch.zeros(A, M, len(slots), D, dtype=dtype, device=dev)
            lib = libs[key]
            fn = getattr(lib, entry)
            fn.argtypes = ptypes + [L, I, I, I, I, F_, F_, P]
            lib.dump_set.argtypes = [P]
            if lib.dump_set(dump.data_ptr()) != 0:
                raise RuntimeError("could not set the dump buffer")
            if fn(*(x.data_ptr() for x in ptrs), A, M, D, H, F, scale, eps, stream) != 0:
                raise RuntimeError(f"{entry} failed to launch")
            torch.cuda.synchronize()
            dumps[key] = dump
    equal = {name: torch.equal(dumps["k1"][:, :, i], dumps["k2"][:, :, i]) for i, name in enumerate(slots)}
    line = {"card": card, "dtype": args.dtype, "int8": args.int8, "shape": [A, M, D, H, F],
            "bitwise_equal": equal, "finite": bool(torch.isfinite(dumps["k1"].float()).all())}
    if args.int8:
        line["absmax_sm90"] = absmax
        equal = equal | {"absmax_sm90": absmax["bitwise_equal"]}
    print(json.dumps(line))
    return 0 if all(equal.values()) else 2


EPS = 1.1920928955078125e-07  # float32's machine epsilon: the kernels' RMSNorm eps in bf16 and f32


def make_case(A: int, M: int, dtype, dev, seed: int = 0):
    """One seeded layer case (D = 128, 8 heads, F = 256; inputs as
    ``layer_times.py`` makes them): the ten weights in ``dtype`` on
    ``dev``, edges, center, cf, the cotangents, the transposed matrices
    ``t`` (w_qkv, w_out, w_in, w_ffn_out by their index) and w_in^T in
    ``fused_layer.k1_sm90_w_vg``'s blocks of 64 (value rows, then gate)."""
    import torch

    D, F = 128, 256
    gen = torch.Generator().manual_seed(seed)

    def lecun(*shape):
        return torch.randn(*shape, generator=gen) / math.sqrt(shape[0])

    w = [1 + 0.1 * torch.randn(D, generator=gen), lecun(D, 3 * D),
         0.1 * torch.randn(3 * D, generator=gen), lecun(D, D), 0.1 * torch.randn(D, generator=gen),
         1 + 0.1 * torch.randn(D, generator=gen), lecun(D, 2 * F),
         0.1 * torch.randn(2 * F, generator=gen), lecun(F, D), 0.1 * torch.randn(D, generator=gen)]
    w = [x.to(dev, dtype).contiguous() for x in w]
    n_real = torch.randint(M // 2, M - 1, (A, 1), generator=gen)
    cf = torch.rand(A, M, generator=gen) * (torch.arange(M)[None] < n_real)
    cf[:, M - 1] = 1.0
    cf = cf.to(dev)
    e, c, ge, gc = (torch.randn(*s, generator=gen).to(dev, dtype)
                    for s in ((A, M, D), (A, D), (A, M, D), (A, D)))
    w_vg = w[6].t().reshape(2, F // 64, 64, D).transpose(0, 1).reshape(2 * F, D).contiguous()
    t = {i: w[i].t().contiguous() for i in (1, 3, 6, 8)}
    return w, e, c, cf, ge, gc, t, w_vg


def block_scales(q, k, b_qkv, block_atoms: int):
    """The int8 score scales of blocks of ``block_atoms`` atoms from given q
    and k (A, M, D) in bf16: the absmax over each block's atoms, a partial
    last block taking max |b_q| and max |b_k| (its padding atoms' rows),
    then max(absmax, 1e-12) / 127 rounded once to float32, on ``q``'s
    device (``int8_block_scales``'s reduction, here on the values a kernel
    quantizes). The quotient is numpy's on the host, as the kernels'
    ``__fdiv_rn``: PyTorch's CUDA division by a scalar multiplies by its
    reciprocal, one float ulp off in some blocks."""
    import numpy as np
    import torch

    A, _, D = q.shape
    am = torch.stack([x.float().abs().amax(dim=(1, 2)) for x in (q, k)], dim=1)
    n = -(-A // block_atoms)
    pad = n * block_atoms - A
    am = torch.cat([am, am.new_zeros(pad, 2)]).reshape(n, block_atoms, 2).amax(dim=1)
    if pad:
        b = b_qkv.to(torch.bfloat16).float().abs()
        am[-1] = torch.maximum(am[-1], torch.stack([b[:D].amax(), b[D:2 * D].amax()]))
    quotient = torch.clamp_min(am, 1e-12).cpu().numpy() / np.float32(127.0)
    return torch.from_numpy(quotient).to(q.device)


def copy_absmax(lib):
    """The Hopper absmax pass of the tool's copy (``ABSMAX_COPY``) as a
    function (e, c, w, H, block_atoms) -> (n_blocks, 2) scales."""
    import torch

    fn = lib.mtt_int8_absmax_sm90
    P, I, L, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [P] * 6 + [L, I, I, I, I, I, F_, I, P]

    def run(e, c, w, H, block_atoms):
        A, M, D = e.shape
        out = torch.empty(-(-A // block_atoms), 2, device=e.device)
        w_qkv_t = w[1].t().contiguous()
        sms = torch.cuda.get_device_properties(e.device).multi_processor_count
        code = fn(e.data_ptr(), c.data_ptr(), w[0].data_ptr(), w_qkv_t.data_ptr(), w[2].data_ptr(),
                  out.data_ptr(), A, M, D, H, w[8].shape[0], block_atoms, EPS, sms,
                  torch.cuda.current_stream(e.device).cuda_stream)
        if code != 0:
            raise RuntimeError(f"mtt_int8_absmax_sm90 failed to launch ({code})")
        return out
    return run


def absmax_compare(k1_lib, A: int, M: int, hopper_blocks, seed: int = 0,
                   general_blocks=None, block_atoms: int = None) -> dict:
    """The Hopper absmax pass's scales (``hopper_blocks(e, c, w, H,
    block_atoms)``: the port's wrapper or the tool's copy) against those
    of the q|k that the Hopper K1-int8 itself forms, bit for bit: one
    seeded case (:func:`make_case`, bfloat16) through ``k1_lib`` (the
    instrumented K1-int8 copy of ``K1_INT8_MARKS``, whose dump takes
    q|k|v before the attention) on the pass's own scales; the dump's q and
    k reduced by :func:`block_scales`, in blocks of ``block_atoms`` (the
    port's ``int8_block_atoms(M)`` by default; 2, one atom pair a block,
    keeps a per-block maximum from hiding a differing value). Returns the
    shape, the blocks, and whether the two are bitwise equal; with
    ``general_blocks`` (the general pass, ``fused_layer.int8_absmax_cuda(e,
    c, w, block_atoms)``) also how many of its blocks differ from K1-int8's
    q|k max."""
    import torch

    D, H, F = 128, 8, 256
    dev = torch.device("cuda", 0)
    w, e, c, cf, _, _, t, w_vg = make_case(A, M, torch.bfloat16, dev, seed)
    block_atoms = block_atoms or port_fused_layer().int8_block_atoms(M)
    blocks = hopper_blocks(e, c, w, H, block_atoms)
    s8 = blocks.repeat_interleave(block_atoms, dim=0)[:A].contiguous()
    dump = torch.full((A, M, 6, D), float("nan"), dtype=torch.bfloat16, device=dev)
    P, I, L, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = k1_lib.mtt_fused_layer_fwd_int8_sm90
    fn.argtypes = [P] * 16 + [L, I, I, I, I, F_, F_, P]
    k1_lib.dump_set.argtypes = [P]
    if k1_lib.dump_set(dump.data_ptr()) != 0:
        raise RuntimeError("could not set the dump buffer")
    args = [e, c, cf, *(w[i] for i in (0, 2, 4, 5, 7, 9)), t[1], t[3], w_vg, t[8], s8,
            torch.empty_like(e), torch.empty_like(c)]
    if fn(*(x.data_ptr() for x in args), A, M, D, H, F, 1.0 / math.sqrt(D // H), EPS,
          torch.cuda.current_stream(dev).cuda_stream) != 0:
        raise RuntimeError("mtt_fused_layer_fwd_int8_sm90 failed to launch")
    torch.cuda.synchronize()
    q, k = dump[:, :, 3], dump[:, :, 4]
    want = block_scales(q, k, w[2], block_atoms)
    res = {"A": A, "M": M, "block_atoms": block_atoms, "blocks": int(blocks.shape[0]),
           "qk_finite": bool(torch.isfinite(dump[:, :, 3:5].float()).all()),
           "bitwise_equal": torch.equal(blocks, want)}
    if general_blocks is not None:
        general = general_blocks(e, c, w, block_atoms)
        res["general_blocks_differ"] = int((general != want).any(dim=1).sum())
    return res


def w8a8_main(card, A, M, D, H, F, e, c, cf, w, t, ge, gc, scale, eps) -> int:
    """K1-W8A8's q|k|v, int8 q|k, attn, res, int8 h_norm and vg against
    K2-W8A8's recompute, bitwise (one float dump of 12 slots per row)."""
    import torch

    dev = e.device
    int8_t, w_vg8, scales = port_w8a8(e, c, cf, w, H, scale)
    P, I, L, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    FP = ctypes.POINTER(ctypes.c_float)
    # (entry, tensors before the scales, tensors after them, the scale too)
    runs = {
        "k1": ("mtt_fused_layer_fwd_w8a8_sm90",
               [e, c, cf, *(w[i] for i in (0, 2, 4, 5, 7, 9)), t[3], int8_t[0], w_vg8, int8_t[2]],
               [torch.empty_like(e), torch.empty_like(c)], False),
        "k2": ("mtt_fused_layer_bwd_w8a8_sm90", [e, c, cf, *w[:9], t[3], int8_t[0], int8_t[1]],
               [ge, gc, torch.empty_like(e), torch.empty_like(c), torch.empty_like(cf)], True),
    }
    dumps = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), "w8a8")
        stream = torch.cuda.current_stream(dev).cuda_stream
        for key, (entry, before, after, with_scale) in runs.items():
            dump = torch.full((A, M, 12, D), float("nan"), device=dev)
            lib = libs[key]
            fn = getattr(lib, entry)
            fn.argtypes = ([P] * len(before) + [FP] + [P] * len(after) + [L, I, I, I, I]
                           + [F_] * (2 if with_scale else 1) + [P])
            lib.dump_set.argtypes = [P]
            if lib.dump_set(dump.data_ptr()) != 0:
                raise RuntimeError("could not set the dump buffer")
            tail = (scale, eps) if with_scale else (eps,)
            if fn(*(x.data_ptr() for x in before), scales, *(x.data_ptr() for x in after),
                  A, M, D, H, F, *tail, stream) != 0:
                raise RuntimeError(f"{entry} failed to launch")
            torch.cuda.synchronize()
            dumps[key] = dump
    equal = {name: torch.equal(dumps["k1"][:, :, a:b], dumps["k2"][:, :, a:b])
             for name, (a, b) in W8A8_SLOTS.items()}
    print(json.dumps({"card": card, "dtype": "bfloat16", "w8a8": True, "shape": [A, M, D, H, F],
                      "bitwise_equal": equal, "finite": bool(torch.isfinite(dumps["k1"]).all())}))
    return 0 if all(equal.values()) else 2


def rowblock_main(args, card: str) -> int:
    """The row-block stage's pre, h (and xn0, rs; the head's pre0, h0,
    pre1) of the Hopper float32 K3 and the Hopper float32 K4's recompute,
    bitwise."""
    with tempfile.TemporaryDirectory() as tmp:
        res = rowblock_compare(args.stage, args.rows, build(Path(tmp), kernels=ROWBLOCK_KERNELS[args.stage]))
    print(json.dumps({"card": card, "kernel": "rowblock", "dtype": "float32", **res}))
    return 0 if all(res["bitwise_equal"].values()) and res["every_row_written"] else 2


def rowblock_compare(stage: str, rows: int, libs: dict) -> dict:
    """Run the instrumented copies ``libs`` (:func:`build` of
    ``ROWBLOCK_KERNELS[stage]``) on one seeded case of ``rows`` rows;
    returns the stage, the rows, per activation whether the two copies are
    bitwise equal, and whether every valid row was written."""
    import torch

    D = 128
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    def lecun(*shape):
        return (torch.randn(*shape, generator=gen) / math.sqrt(shape[0])).to(dev)

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=gen)).to(dev)

    xs = [torch.randn(rows, D, generator=gen).to(dev) for _ in range(3)]
    n_parts = 3
    if stage == "compress":
        code, w_in, w_hid = 0, 3 * D, D
        ln_s = ln_b = None
        w0, b0, w1, b1 = lecun(w_in, w_hid), vec(w_hid), lecun(w_hid, D), vec(D)
    elif stage == "head":
        code, w_in, w_hid, n_parts = 2, D, D, 1
        xs = xs[:1] + [None, None]
        ln_s = ln_b = None
        w0, b0, w1, b1 = lecun(w_in, w_hid), vec(w_hid), lecun(w_hid, D), vec(D)
    else:
        code, w_in, w_hid = 1, 2 * D, 2 * D
        ln_s, ln_b = vec(w_in, 1.0), vec(w_in)
        w0, b0, w1, b1 = lecun(w_in, w_hid), vec(w_hid), lecun(w_hid, D), vec(D)
    g = torch.randn(rows, D, generator=gen).to(dev)
    w0_t, w1_t = w0.t().contiguous(), w1.t().contiguous()
    blocks = min(-(-rows // 64), torch.cuda.get_device_properties(dev).multi_processor_count)
    out, d = torch.empty(rows, D, device=dev), [torch.empty(rows, D, device=dev) for _ in range(3)]
    n_d = {0: 3, 1: 2, 2: 1}[code]
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def ptr(x):
        return None if x is None else x.data_ptr()

    # the head's K4 also takes w1^T and b1
    w1_t4, b1_4 = (w1_t, b1) if code == 2 else (None, None)
    dumps = {}
    stream = torch.cuda.current_stream(dev).cuda_stream
    runs = {
        "k3": ("mtt_rowblock_fwd_f32_sm90", [I, P, P, P, I] + [P] * 7,
               [code, *map(ptr, xs), n_parts, ptr(ln_s), ptr(ln_b), ptr(w0_t), ptr(b0), ptr(w1_t),
                ptr(b1), ptr(out)]),
        "k4": ("mtt_rowblock_bwd_f32_sm90", [I, P, P, P, I] + [P] * 12,
               [code, *map(ptr, xs), n_parts, ptr(ln_s), ptr(ln_b), ptr(b0), ptr(w0_t), ptr(w1),
                ptr(w0), ptr(w1_t4), ptr(b1_4), ptr(g), *(ptr(x) for x in d[:n_d]), *[None] * (3 - n_d)]),
    }
    for key, (entry, ptypes, call) in runs.items():
        dump = torch.full((rows, RB_STRIDE), float("nan"), device=dev)
        lib = libs[key]
        fn = getattr(lib, entry)
        fn.argtypes = ptypes + [L, I, I, I, I, I, P]
        lib.dump_set.argtypes = [P]
        if lib.dump_set(dump.data_ptr()) != 0:
            raise RuntimeError("could not set the dump buffer")
        if fn(*call, rows, D, w_in, w_hid, D, blocks, stream) != 0:
            raise RuntimeError(f"{entry} failed to launch")
        torch.cuda.synchronize()
        dumps[key] = dump
    slots = {"pre": slice(0, w_hid), "h": slice(256, 256 + w_hid)}
    if code == 1:
        slots |= {"xn0": slice(512, 512 + w_in), "rs": slice(768, 769)}
    if code == 2:
        slots = {"pre0": slice(0, D), "h0": slice(256, 256 + D), "pre1": slice(512, 512 + D)}
    equal = {name: torch.equal(dumps["k3"][:, s], dumps["k4"][:, s]) for name, s in slots.items()}
    written = all(bool(torch.isfinite(dumps[k][:, s]).all()) for k in dumps for s in slots.values())
    return {"stage": stage, "rows": rows, "bitwise_equal": equal, "every_row_written": written}


if __name__ == "__main__":
    sys.exit(main())
