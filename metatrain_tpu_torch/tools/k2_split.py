"""Phase split of K2, of the Hopper K1 (bf16 or float32), of the Hopper K3 and
K4 heads, or of K4 / K4-dW's float32 compress and combination, by
``clock64()`` stamps, on a CUDA device.

Usage, on a machine with a CUDA device and nvcc::

    python metatrain_tpu_torch/tools/k2_split.py
        --body hopper|general|f32-hopper|k1-hopper|k1-f32|k1-general|k3-head|k4-head|k4dw-general|k4-f32
        |hopper-int8|k1-int8|hopper-w8a8|absmax
        [--dtype bfloat16|float32] [--dw] [--A 11392] [--M 64]

Copies the body's sources (``--body hopper``: the Hopper K2,
``csrc/fused_layer_bwd_sm90.cu``; ``general``: K2's general body,
``csrc/layer_bwd.cuh`` with a one-kernel launcher, in ``--dtype``;
``f32-hopper``: the Hopper float32 K2,
``csrc/fused_layer_bwd_f32_sm90.cu``; ``k1-hopper``: the
Hopper K1, ``csrc/fused_layer_fwd_sm90.cu``; ``hopper-int8`` /
``k1-int8``: K2-int8 / K1-int8, the same sources and phases in their
int8-score mode, on the port's scales (``sm90_front.port_int8_scales``);
``hopper-w8a8``: K2-W8A8, the same source and phases in its W8A8 mode, on
the port's int8 weights and scales (``sm90_front.port_w8a8``); ``k1-f32``: the Hopper float32
K1, ``csrc/fused_layer_fwd_f32_sm90.cu``; ``k1-general``: K1's general
body, ``csrc/layer_fwd.cuh`` in ``csrc/fused_layer_fwd.cu``, in
``--dtype``; ``k3-head`` / ``k4-head``: the
Hopper K3 / K4 head, ``csrc/rowblock_{fwd,bwd}_sm90.cu`` with the shared
``head_front`` of ``csrc/rowblock_sm90.cuh``; ``absmax``: the Hopper absmax
pass, ``csrc/int8_absmax_sm90.cu`` with ``csrc/int8_absmax.cu``, its loop
over atom pairs in phases) into a
temporary directory, inserts after each phase's closing barrier a stamp of
thread 0's ``clock64()`` that adds the phase's cycles to a device counter,
builds that copy alone with nvcc, runs it on a seeded case (D = 128, 8
heads, F = 256, inputs as ``layer_times.py`` makes them, in bfloat16 but
for ``f32-hopper``, ``k1-f32`` and ``--dtype float32``; the heads at A x M
rows; the float32 K4 bodies at A x M rows, the 3-part compress and the
combination) and prints one JSON line (the K4 bodies: one per stage): the card (``nvidia-smi`` name and power
limit), the cycles per atom (the heads: per 64-row tile of a block), each
phase's share of them and the instrumented launch's mean CUDA-event ms.
The checkout's sources are not changed: they carry no instrumentation.
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

STAMP = ('__device__ unsigned long long g_split[16];\n'
         '#define SPLIT(i) if (threadIdx.x == 0) { long long t_ = clock64(); '
         'atomicAdd(&g_split[i], (unsigned long long)(t_ - t_prev)); t_prev = t_; }\n')
COUNTERS = ('\nextern "C" int split_read(unsigned long long* out) '
            '{ return (int)cudaMemcpyFromSymbol(out, g_split, 128); }\n'
            'extern "C" int split_zero() { unsigned long long z[16] = {}; '
            'return (int)cudaMemcpyToSymbol(g_split, z, 128); }\n')

# (text, stamp before it rather than after, the stamp): each text occurs
# once; a stamp of None is the next phase's SPLIT
HOPPER = (
    ('#include "layer_sm90.cuh"\n', False, STAMP),
    ("    int c = 0;\n", False, "    long long t_prev = clock64();\n"),
    ("    // ---- recompute: attention", True, None),
    ("    // res = rnd(x1 + rnd(attn w_out + b))", True, None),
    ("    // ---- SwiGLU backward", True, None),
    ("    // ---- norm_mlp backward", True, None),
    ("    // ---- attention backward, pass 1", True, None),
    ("    // ---- QKV + norm_attn backward", True, None),
    ("}\n\n}  // namespace\n", True, None),
)
HOPPER_PHASES = ["norm, QKV", "recompute attention", "out-projection, h_norm", "SwiGLU tiles",
                 "d_res, d_attn", "attention backward, d_cf", "d_n1, final norm"]
F32_HOPPER = (
    ('#include "layer_sm90.cuh"\n', False, STAMP),
    ("    int c = 0;\n", False, "    long long t_prev = clock64();\n"),
    ("    // ---- recompute: attention", True, None),
    ("    // res = x1 + (attn w_out + b)", True, None),
    ("    // ---- SwiGLU backward", True, None),
    ("    // ---- norm_mlp backward", True, None),
    ("    // ---- attention backward, pass 1", True, None),
    ("    // ---- QKV + norm_attn backward", True, None),
    ("}\n\ntemplate <bool SP>\nint launch_mode", True, None),
)
F32_HOPPER_PHASES = ["norm, QKV", "recompute attention", "out-projection, h_norm, g_eo",
                     "SwiGLU tiles", "d_res, d_attn", "attention backward, d_cf",
                     "d_n1, final norm"]
K1_HOPPER = (
    ('#include "layer_sm90.cuh"\n', False, STAMP),
    ("    int c = 0;\n", False, "    long long t_prev = clock64();\n"),
    ("    // ---- attention, one warp per", True, None),
    ("    // ---- res = rnd(x1", True, None),
    ("    // ---- SwiGLU over F tiles", True, None),
    ("    // ---- edge_out = rnd(", True, None),
    ("}\n\n}  // namespace\n", True, None),
)
K1_HOPPER_PHASES = ["norm, QKV", "attention", "out-projection, h_norm", "SwiGLU tiles", "edge_out"]
K1_F32 = (
    ('#include "layer_sm90.cuh"\n', False, STAMP),
    ("    int c = 0;\n", False, "    long long t_prev = clock64();\n"),
    ("    // ---- attention, one warp per", True, None),
    ("    // ---- res = x1 + (attn w_out + b)", True, None),
    ("    // ---- SwiGLU over F tiles", True, None),
    ("    // ---- edge_out = res + (", True, None),
    ("}\n\n}  // namespace\n", True, None),
)
K1_F32_PHASES = K1_HOPPER_PHASES
# K1's general body (layer_fwd.cuh), one atom per block where it is all shared
K1_GENERAL = (
    ('#include "common.cuh"\n', False, STAMP),
    ("    float* CF = b.CF;\n", False, "    long long t_prev = clock64();\n"),
    ("    for (int h = 0; h < H; ++h) {\n", True, None),
    ("    block_mm<16>(N, D, M, D, w.w_out, D, D,", True, None),
    ("    rmsnorm_rows<T, !W8>(X, N, nullptr, M, D, w.norm_mlp, eps);", True, None),
    ("    // each output element reads and writes only its own X entry", True, None),
    ("}\n\n}  // namespace mtt", True, None),
)
K1_GENERAL_PHASES = ["norm, QKV", "attention, head by head", "out-projection, residual",
                     "h_norm, FFN-in, SwiGLU", "FFN-out, edge_out"]
GENERAL = (
    ('#include "common.cuh"\n', False, STAMP),
    ("    const DwLayout L(D, F, SP);\n", False, "    long long t_prev = clock64();\n"),
    ("            QKV[m * LQ + n] = rnd<T>(acc + to_f(p.b_qkv[n]));\n        });\n    }\n"
     "    __syncthreads();\n", False, None),
    ("    block_mm<16>(SCR, D, M, D, p.w_out, D, D,", True, None),
    ("    if (ACC) {\n        // keep attn", True, None),
    ("    // ---- out-projection backward", True, None),
    ("    block_mm<16>(SCR, D, M, D, p.w_out_t, D, D, [&](int m, int n, float acc) "
     "{ DAT[m * D + n] = acc; });\n    __syncthreads();\n", False, None),
    ("    // ---- QKV + norm_attn backward", True, None),
    ("        io.d_cf[k] = io.add_dcf ? io.d_cf[k] + DCF[k] : DCF[k];\n", False, None),
)
GENERAL_PHASES = ["norm, QKV", "recompute attention", "out-projection", "SwiGLU row chunks",
                  "out-projection backward", "attention backward", "QKV backward, final norm"]
# the heads: head_front's phases (rowblock_sm90.cuh), then the kernel's own
HEAD_FRONT = (
    ("    int c = 0;\n", False, "    long long t_prev = clock64();\n"),
    ("    panel_pairs([&](int j, int h, int m, int n) {\n        const float2 b = ld2(b0 + n);", True,
     None),
    ("    zero(pre1);\n", True, None),
    ("}\n\n// The head's output", True, None),
)
K3_HEAD = (
    ("        head_out(pre1,", True, "        long long t_prev = clock64();\n"),
    ("        cp_async_wait<0>();\n", True, None),
    ("        __syncthreads();  // tile t + 1 in; H and tile t's buffer free\n", False, None),
)
K3_HEAD_PHASES = ["pre0 product", "h epilogue", "pre1 product", "out epilogue, store",
                  "wait for the next tile"]
K4_HEAD = (
    ("    head_front(W, X, H, p.b0, p.b1, pre0, acc);  // acc: pre1\n", False,
     "    long long t_prev = clock64();\n"),
    ("    int c = 4;\n", True, None),
    ("    __syncthreads();  // every warp has read d_pre1\n", True, None),
    ("    zero(acc);  // d_x = rnd(d_pre0 w0^T)\n", True, None),
    ("}\n\n__global__ void __launch_bounds__(kThreads, 1) k4_head_sm90_kernel", True, None),
    ("        cp_async_wait<0>();\n", True, "        long long t_prev = clock64();\n"),
    ("        __syncthreads();  // tile t + 1 in; H and tile t's buffers free\n", False, None),
)
K4_HEAD_PHASES = ["pre0 product", "h0 epilogue", "pre1 product", "d_pre1 epilogue",
                  "d_h0 product", "d_pre0 epilogue", "d_x product, store", "wait for the next tile"]
# K4-dW's general body (rowblock_bwd.cu) in its compress and combination
# tiles: the compress stamps phases 0-5, the combination 0-4 and 6-8
K4DW_GENERAL = (
    ('#include "common.cuh"\n', False, STAMP),
    ("    float* HH = RS + tile;            // DW: (tile, Wh) hidden activation h\n", False,
     "    long long t_prev = clock64();\n"),
    ("    block_mm<16>(IN, Win, tile, Win, p.w0, Wh, Wh,", True, None),
    ("    if (DW) {\n        accum_atb<T, false>(P + L.w1", True, None),
    ("    block_mm<16>(G, Wo, tile, Wo, p.w1_t, Wh, Wh,", True, None),
    ("    if (DW) {\n        accum_atb<T, true>(P + L.w0, Wh, IN,", True, None),
    ("    if (STAGE == kCompress) {\n        block_mm<16>(PRE,", True, None),
    ("            if (m < valid) douts[n / Dp][(row0 + m) * Dp + n % Dp] = from_f<T>(acc);\n"
     "        });\n", False, None),
    ("    if (DW) {\n        for (int c = threadIdx.x; c < Win;", True, None),
    ("    for (int r = warp; r < valid; r += nw) {\n        const float* dxn", True, None),
    ("            douts[c / Dp][o] = from_f<T>(dx);\n        }\n    }\n", False, None),
)
K4DW_GENERAL_PHASES = ["loads (combination: and LayerNorm)", "pre product", "dW: h^T g, db1",
                       "g w1^T product, d_pre", "dW: X^T d_pre, db0", "d_part products, stores",
                       "d_xn product", "dW: ln_scale, ln_bias (inputs re-read)",
                       "LayerNorm backward, stores"]
# the Hopper float32 K4 (rowblock_bwd_f32_sm90.cu)
# the Hopper absmax pass: its loop over atom pairs (the stamps inside it)
ABSMAX = (
    ('#include "layer_sm90.cuh"\n', False, STAMP),
    ("    float mq = 0.f, mk = 0.f;\n", False, "    long long t_prev = clock64();\n"),
    ("        const bf16* X = TOK + buf", True, None),
    ("        int c = 0;\n", True, None),
    ("        qkv_panel<8>(res, c, n1, 1, b_qkv,", True, None),
    ("        // both atoms of a pair lie", True, None),
    ("    }\n    cp_async_wait<0>();\n", True, None),
)
ABSMAX_PHASES = ["stage next, wait tokens", "RMSNorm", "q panel", "k panel", "flush"]
K4_F32 = (
    ('#include "rowblock_f32_sm90.cuh"\n', False, STAMP),
    ("    float pre[4][4], dh[4][4];\n    compress_pre", True, "    long long t_prev = clock64();\n"),
    ("    zero(dh);\n    panel_mm<8>(ring, c, [&](int r, int& ld) { ld = G::LG; return Gt + r * kCK; }, dh, "
     "kRows);\n    // d_pre into", True, None),
    ("    if constexpr (SP) {\n        float* v = p.vec + t * G::NV;", True, None),
    ("    // d_part q = d_pre w0_q^T", True, None),
    ("            if (m < valid) st2(out + (size_t)m * kPart + n, acc[j][2 * h], acc[j][2 * h + 1]);\n"
     "        });\n    }\n", False, None),
    ("    using G = Geo<kCombination, 2>;\n    const long long row0 = t * kRows;\n", False,
     "    long long t_prev = clock64();\n"),
    ("    // (the first consume's barrier orders these stores before the reads)", True, None),
    ("        zero(dh);\n        panel_mm<8>", True, None),
    ("        if constexpr (SP)\n            panel_col_sums(RED,", True, None),
    ("    // d_xn = d_pre w0^T, in registers", True, None),
    ("    __syncthreads();  // every warp has read DP", True, None),
    ("    // d = d_xn ln_scale; LayerNorm backward", True, None),
    ("            rs * (dx[1][j][2 * h + 1] - ma - xn0(m, kCN + n + 1) * mb));\n    });\n", False, None),
)
# compress 0-3, combination 4-10
K4_F32_PHASES = ["pre product (rows waited for)", "g w1^T product, d_pre, spill", "vector sums",
                 "d_part products, stores", "loads, LayerNorm", "pre products",
                 "g w1^T products, d_pre, spill", "b0 sums", "d_xn products",
                 "next x issued, ln and b1 sums", "LayerNorm backward, stores"]
GENERAL_LAUNCHER = '''#include "layer_bwd.cuh"
using namespace mtt;
using T = STORAGE;

__global__ void __launch_bounds__(kThreads) k2_general(LayerBwdW<T> w, const T* e, const T* c,
        const float* cf, const T* ge, const T* gc, T* de, T* dc, float* dcf, int M, int D, int H,
        int F, float scale, float eps, SmemPlan plan) {
    extern __shared__ __align__(16) float smem[];
    const BwdBufs b = BwdBufs::make<true>(plan, smem, nullptr);
    const long long a = blockIdx.x, r = a * M * D;
    AtomIO<T> io{e + r, c + a * D, cf + a * M, ge + r, gc + a * D, de + r, dc + a * D, dcf + a * M, false};
    layer_bwd_atom<T, false>(w, io, M, D, H, F, scale, eps, b, nullptr);
}

extern "C" int k2_general_launch(const void** wp, const void* e, const void* c, const float* cf,
        const void* ge, const void* gc, void* de, void* dc, float* dcf, long long A, int M, int D,
        int H, int F, float scale, float eps) {
    LayerBwdW<T> w{(const T*)wp[0], (const T*)wp[1], (const T*)wp[2], (const T*)wp[3],
                   (const T*)wp[4], (const T*)wp[5], (const T*)wp[6], (const T*)wp[7],
                   (const T*)wp[8], (const T*)wp[9], (const T*)wp[10], (const T*)wp[11]};
    const SmemPlan plan = layer_bwd_plan(M, D, H, F, false, false);
    if (plan.ws_floats) return -1;
    const size_t bytes = plan.smem_floats * 4;
    cudaFuncSetAttribute(k2_general, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    k2_general<<<(unsigned)A, kThreads, bytes>>>(w, (const T*)e, (const T*)c, cf, (const T*)ge,
        (const T*)gc, (T*)de, (T*)dc, dcf, M, D, H, F, scale, eps, plan);
    return (int)cudaGetLastError();
}
'''


def instrument(text: str, marks, phase: int = 0) -> str:
    """``text`` with a stamp at each mark: the given text, or phase i's
    ``SPLIT(i)`` (a barrier first, so that the phase's slowest warp counts),
    phases numbered from ``phase``."""
    for mark, before, stamp in marks:
        if text.count(mark) != 1:
            raise RuntimeError(f"phase mark not found once in the source: {mark!r}")
        if stamp is None:
            stamp = f"    __syncthreads();\n    SPLIT({phase})\n"
            phase += 1
        at = text.index(mark) + (0 if before else len(mark))
        text = text[:at] + stamp + text[at:]
    return text


def build(work: Path, body: str, dtype: str) -> Path:
    for source in CSRC.glob("*.cu*"):
        shutil.copy(source, work / source.name)
    extra = []
    if body in ("hopper", "k1-hopper", "k1-f32", "f32-hopper", "k4dw-general", "k4-f32",
                "hopper-int8", "k1-int8", "hopper-w8a8", "absmax"):
        unit, marks = {"hopper": ("fused_layer_bwd_sm90.cu", HOPPER),
                       "hopper-int8": ("fused_layer_bwd_sm90.cu", HOPPER),
                       "hopper-w8a8": ("fused_layer_bwd_sm90.cu", HOPPER),
                       "k1-hopper": ("fused_layer_fwd_sm90.cu", K1_HOPPER),
                       "k1-int8": ("fused_layer_fwd_sm90.cu", K1_HOPPER),
                       "k1-f32": ("fused_layer_fwd_f32_sm90.cu", K1_F32),
                       "f32-hopper": ("fused_layer_bwd_f32_sm90.cu", F32_HOPPER),
                       "k4dw-general": ("rowblock_bwd.cu", K4DW_GENERAL),
                       "k4-f32": ("rowblock_bwd_f32_sm90.cu", K4_F32),
                       "absmax": ("int8_absmax_sm90.cu", ABSMAX)}[body]
        unit = work / unit
        unit.write_text(instrument(unit.read_text(), marks) + COUNTERS)
        if body == "absmax":  # its quotient step
            extra = [str(work / "int8_absmax.cu")]
    elif body == "k1-general":
        header = work / "layer_fwd.cuh"
        header.write_text(instrument(header.read_text(), K1_GENERAL))
        unit = work / "fused_layer_fwd.cu"
        unit.write_text(unit.read_text() + COUNTERS)
    elif body in ("k3-head", "k4-head"):
        header = work / "rowblock_sm90.cuh"
        text = instrument(header.read_text(), HEAD_FRONT)
        header.write_text(text.replace('#include "layer_sm90.cuh"\n',
                                       '#include "layer_sm90.cuh"\n' + STAMP))
        unit = work / ("rowblock_fwd_sm90.cu" if body == "k3-head" else "rowblock_bwd_sm90.cu")
        marks = K3_HEAD if body == "k3-head" else K4_HEAD
        front_phases = sum(stamp is None for _, _, stamp in HEAD_FRONT)
        unit.write_text(instrument(unit.read_text(), marks, front_phases) + COUNTERS)
    else:
        header = work / "layer_bwd.cuh"
        header.write_text(instrument(header.read_text(), GENERAL))
        unit = work / "launcher.cu"
        storage = "float" if dtype == "float32" else "__nv_bfloat16"
        unit.write_text(GENERAL_LAUNCHER.replace("STORAGE", storage) + COUNTERS)
    lib = work / "split.so"
    nvcc = shutil.which("nvcc") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", str(unit), *extra, "-o", str(lib)], check=True,
                   timeout=600)
    return lib


def k4_split(args, card: str) -> int:
    """The float32 K4 bodies' split: the 3-part compress and the combination
    at A x M rows (d_part 128), inputs and weights from a seeded generator,
    one JSON line per stage: cycles per 64-row tile (each block's tiles run
    one after another), each phase's share, the instrumented launch's ms."""
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    rows, D = args.A * args.M, 128
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = -(-rows // 64)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    names = K4DW_GENERAL_PHASES if args.body == "k4dw-general" else K4_F32_PHASES

    def t(*shape, scale=1.0, base=0.0):
        return (base + scale * torch.randn(*shape, generator=gen)).to(dev).contiguous()

    with tempfile.TemporaryDirectory() as tmp:
        lib = ctypes.CDLL(str(build(Path(tmp), args.body, "float32")))
        stream = torch.cuda.current_stream(dev).cuda_stream
        for stage, n_parts in ((0, 3), (1, 3)):
            w_in = n_parts * D if stage == 0 else 2 * D
            w_hid = D if stage == 0 else 2 * D
            xs = [t(rows, D) for _ in range(n_parts)]
            ln_s, ln_b = (t(w_in, scale=0.1, base=1.0), t(w_in, scale=0.1)) if stage else (None, None)
            w0, b0 = t(w_in, w_hid, scale=w_in ** -0.5), t(w_hid, scale=0.1)
            w1, b1 = t(w_hid, D, scale=w_hid ** -0.5), t(D, scale=0.1)
            w0_t, w1_t = w0.t().contiguous(), w1.t().contiguous()
            g = t(rows, D)
            n_d = 2 if stage else n_parts
            d = [torch.empty_like(xs[0]) for _ in range(n_d)] + [None] * (3 - n_d)
            ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
            n_dw = sum(x.numel() for x in (ln_s, ln_b, w0, b0, w1, b1) if x is not None)
            dw = torch.empty(n_dw, device=dev)
            if args.body == "k4dw-general":
                partials = torch.empty(sms, n_dw, device=dev)
                fn = lib.mtt_rowblock_bwd
                fn.argtypes = [I, I, P, P, P, I] + [P] * 13 + [I, P] + [L, I, I, I, I, P]
                vals = [0, stage, *map(ptr, xs + [None] * (3 - n_parts)), n_parts,
                        *map(ptr, (ln_s, ln_b, w0, b0, w1, b1, w0_t, w1_t, g, *d, partials)),
                        sms, dw.data_ptr()]
            elif args.dw:
                plan = (ctypes.c_longlong * 5)()
                lib.mtt_rowblock_bwd_dw_f32_sm90_plan.argtypes = [I, L, I, I, I, I, P]
                lib.mtt_rowblock_bwd_dw_f32_sm90_plan(stage, rows, w_in, w_hid, D, sms, plan)
                spill = torch.empty(plan[3], dtype=torch.uint8, device=dev)
                partials = torch.empty(max(plan[4], 1), n_dw, device=dev)
                fn = lib.mtt_rowblock_bwd_dw_f32_sm90
                fn.argtypes = [I, P, P, P, I] + [P] * 15 + [L, I, I, I, I, I, P]
                vals = [stage, *map(ptr, xs + [None] * (3 - n_parts)), n_parts,
                        *map(ptr, (ln_s, ln_b, b0, w0_t, w1, w0, None, None, g, *d, dw, spill,
                                   partials))]
            else:
                fn = lib.mtt_rowblock_bwd_f32_sm90
                fn.argtypes = [I, P, P, P, I] + [P] * 12 + [L, I, I, I, I, I, P]
                vals = [stage, *map(ptr, xs + [None] * (3 - n_parts)), n_parts,
                        *map(ptr, (ln_s, ln_b, b0, w0_t, w1, w0, None, None, g, *d))]
            # the general body takes no grid; the Hopper K4 its blocks, its K4-dW the SMs
            tail = ([D, w_in, w_hid, D] if args.body == "k4dw-general" else
                    [D, w_in, w_hid, D, sms] if args.dw else [D, w_in, w_hid, D, min(sms, tiles)])

            def run():
                return fn(*vals, rows, *tail, stream)

            if run() != 0:
                raise RuntimeError("launch failed")
            torch.cuda.synchronize()
            lib.split_zero()
            run()
            torch.cuda.synchronize()
            counts = (ctypes.c_ulonglong * 16)()
            lib.split_read(counts)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run()
            end.record()
            torch.cuda.synchronize()
            cycles = list(counts)[:len(names)]
            total = sum(cycles)
            print(json.dumps({"card": card, "body": args.body, "dw": args.dw or args.body == "k4dw-general",
                              "stage": "compress3" if stage == 0 else "combination",
                              "rows": rows, "cycles_per_tile": total / tiles,
                              "share": {n: x / total for n, x in zip(names, cycles) if x},
                              "instrumented_ms": start.elapsed_time(end) / 5}), flush=True)
            del xs, g, d, dw
            torch.cuda.empty_cache()
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--body", choices=("hopper", "general", "f32-hopper", "k1-hopper", "k1-f32",
                                           "k1-general", "k3-head", "k4-head", "k4dw-general",
                                           "k4-f32", "hopper-int8", "k1-int8", "hopper-w8a8",
                                           "absmax"),
                        required=True)
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                        help="the general bodies' storage type (the Hopper bodies have one each)")
    parser.add_argument("--dw", action="store_true",
                        help="k4-f32: the spill mode (K4-dW's first pass) and its second pass")
    parser.add_argument("--A", type=int, default=11392)
    parser.add_argument("--M", type=int, default=64)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k2_split: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    if args.body in ("k4dw-general", "k4-f32"):
        return k4_split(args, card)
    from sm90_front import port_fused_layer, port_int8_scales, port_w8a8  # this directory's
    own = "float32" if args.body in ("f32-hopper", "k1-f32") else "bfloat16"
    if args.dtype not in (None, own) and args.body not in ("general", "k1-general"):
        parser.error(f"--body {args.body} runs in {own}")
    args.dtype = args.dtype or own
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    A, M, D, H, F = args.A, args.M, 128, 8, 256
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

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
    de, dc, dcf = torch.empty_like(e), torch.empty_like(c), torch.empty_like(cf)
    scale, eps = 1.0 / math.sqrt(D // H), float(torch.finfo(torch.float32).eps)
    P, I, L, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    with tempfile.TemporaryDirectory() as tmp:
        lib = ctypes.CDLL(str(build(Path(tmp), args.body, args.dtype)))
        stream = torch.cuda.current_stream(dev).cuda_stream
        if args.body in ("k3-head", "k4-head"):
            # the head at A x M rows: x, g and its weights in their (N, K)
            # layouts, one persistent block per SM
            rows, blocks = A * M, torch.cuda.get_device_properties(dev).multi_processor_count
            hw = [lecun(D, D), 0.1 * torch.randn(D, generator=gen), lecun(D, D),
                  0.1 * torch.randn(D, generator=gen)]
            w0, b0, w1, b1 = (x.to(dev, torch.bfloat16).contiguous() for x in hw)
            x, g = (torch.randn(rows, D, generator=gen).to(dev, torch.bfloat16) for _ in range(2))
            out = torch.empty_like(x)
            w0_t, w1_t = w0.t().contiguous(), w1.t().contiguous()
            # (stage 2, x0..x2, n_parts 1, ..., out or g and d_x, ...) as
            # rowblock.py passes them
            if args.body == "k3-head":
                fn, ptrs = lib.mtt_rowblock_fwd_sm90, [x, None, None, 1, None, None, w0_t, b0,
                                                       w1_t, b1, out]
            else:
                fn, ptrs = lib.mtt_rowblock_bwd_sm90, [x, None, None, 1, None, None, w0, b0, w1,
                                                       b1, w0_t, w1_t, g, out, None, None, None]
            fn.argtypes = [I, P, P, P, I] + [P] * (len(ptrs) - 4) + [L] + [I] * 5 + [P]
            vals = [v if v is None or isinstance(v, int) else v.data_ptr() for v in ptrs]

            def run():
                return fn(2, *vals, rows, D, D, D, D, blocks, stream)
        elif args.body in ("hopper", "f32-hopper", "hopper-int8"):
            ptrs = [e, c, cf, *w[:9], *(w[i].t().contiguous() for i in (1, 3, 6)), ge, gc, de, dc,
                    dcf]
            fn = getattr(lib, {"hopper": "mtt_fused_layer_bwd_sm90", "f32-hopper": "mtt_fused_layer_bwd_f32_sm90",
                               "hopper-int8": "mtt_fused_layer_bwd_int8_sm90"}[args.body])
            if args.body == "hopper-int8":  # the scales after the transposed weights
                ptrs.insert(15, port_int8_scales(e, c, w, H))
            fn.argtypes = [P] * len(ptrs) + [L, I, I, I, I, F_, F_, P]

            def run():
                return fn(*(x.data_ptr() for x in ptrs), A, M, D, H, F, scale, eps, stream)
        elif args.body == "hopper-w8a8":
            # the inputs, nine bf16 weights, w_out^T, the int8 w_qkv^T and
            # w_in^T, the scales (a host array), the cotangents and outputs
            int8_t, _, scales = port_w8a8(e, c, cf, w, H, scale)
            before = [e, c, cf, *w[:9], w[3].t().contiguous(), int8_t[0], int8_t[1]]
            after = [ge, gc, de, dc, dcf]
            fn = lib.mtt_fused_layer_bwd_w8a8_sm90
            fn.argtypes = ([P] * len(before) + [ctypes.POINTER(ctypes.c_float)] + [P] * len(after)
                           + [L, I, I, I, I, F_, F_, P])

            def run():
                return fn(*(x.data_ptr() for x in before), scales, *(x.data_ptr() for x in after),
                          A, M, D, H, F, scale, eps, stream)
        elif args.body == "absmax":
            # edges, center, norm_attn, w_qkv^T, b_qkv, the scales; one
            # persistent block per SM, blocks of fused_layer.int8_block_atoms
            block_atoms = port_fused_layer().int8_block_atoms(M)
            ptrs = [e, c, w[0], w[1].t().contiguous(), w[2],
                    torch.empty(-(-A // block_atoms), 2, device=dev)]
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            fn = lib.mtt_int8_absmax_sm90
            fn.argtypes = [P] * 6 + [L, I, I, I, I, I, F_, I, P]

            def run():
                return fn(*(x.data_ptr() for x in ptrs), A, M, D, H, F, block_atoms, eps, sms,
                          stream)
        elif args.body == "k1-f32":
            # w_in^T as it is
            ptrs = [e, c, cf, *(w[i] for i in (0, 2, 4, 5, 7, 9)),
                    *(w[i].t().contiguous() for i in (1, 3, 6, 8)), de, dc]
            lib.mtt_fused_layer_fwd_f32_sm90.argtypes = [P] * 15 + [L, I, I, I, I, F_, F_, P]

            def run():
                return lib.mtt_fused_layer_fwd_f32_sm90(*(x.data_ptr() for x in ptrs), A, M, D, H,
                                                        F, scale, eps, stream)
        elif args.body == "k1-general":
            # the weights as they are, no workspace: one block per atom
            ptrs = [e, c, cf, *w, de, dc]
            lib.mtt_fused_layer_fwd.argtypes = [I] + [P] * 15 + [L, I, I, I, I, F_, F_, I, P, P]
            code = 0 if dtype == torch.float32 else 1

            def run():
                return lib.mtt_fused_layer_fwd(code, *(x.data_ptr() for x in ptrs), A, M, D, H, F,
                                               scale, eps, A, None, stream)
        elif args.body in ("k1-hopper", "k1-int8"):
            # w_in^T with value and gate rows interleaved in blocks of 64, as
            # fused_layer.k1_sm90_w_vg arranges it
            w_vg = w[6].t().reshape(2, F // 64, 64, D).transpose(0, 1).reshape(2 * F, D).contiguous()
            ptrs = [e, c, cf, *(w[i] for i in (0, 2, 4, 5, 7, 9)), w[1].t().contiguous(),
                    w[3].t().contiguous(), w_vg, w[8].t().contiguous(), de, dc]
            fn = lib.mtt_fused_layer_fwd_sm90
            if args.body == "k1-int8":  # the scales after the weight matrices
                fn = lib.mtt_fused_layer_fwd_int8_sm90
                ptrs.insert(13, port_int8_scales(e, c, w, H))
            fn.argtypes = [P] * len(ptrs) + [L, I, I, I, I, F_, F_, P]

            def run():
                return fn(*(x.data_ptr() for x in ptrs), A, M, D, H, F, scale, eps, stream)
        else:
            wl = w[:8] + [w[i].t().contiguous() for i in (1, 3, 6, 8)]
            arr = (ctypes.c_void_p * 12)(*(x.data_ptr() for x in wl))
            lib.k2_general_launch.argtypes = [P] * 9 + [L, I, I, I, I, F_, F_]

            def run():
                return lib.k2_general_launch(arr, *(x.data_ptr() for x in (e, c, cf, ge, gc, de,
                                                                            dc, dcf)),
                                             A, M, D, H, F, scale, eps)
        if run() != 0:
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        lib.split_zero()
        run()
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * 16)()  # split_read copies all 16 counters
        lib.split_read(counts)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        end.record()
        torch.cuda.synchronize()
    names = {"hopper": HOPPER_PHASES, "general": GENERAL_PHASES, "f32-hopper": F32_HOPPER_PHASES,
             "hopper-int8": HOPPER_PHASES, "hopper-w8a8": HOPPER_PHASES, "k1-int8": K1_HOPPER_PHASES, "k1-hopper": K1_HOPPER_PHASES, "k1-f32": K1_F32_PHASES, "k1-general": K1_GENERAL_PHASES,
             "k3-head": K3_HEAD_PHASES, "k4-head": K4_HEAD_PHASES,
             "absmax": ABSMAX_PHASES}[args.body]
    cycles = list(counts)[:len(names)]
    total = sum(cycles)
    # the heads' stamps count per 64-row tile of a block
    per = {"cycles_per_tile": total / -(-A * M // 64)} if args.body.endswith("-head") else {
        "cycles_per_atom": total / A}
    print(json.dumps({"card": card, "body": args.body, "dtype": args.dtype,
                      "shape": [A, M, D, H, F], **per,
                      "share": {n: x / total for n, x in zip(names, cycles)},
                      "instrumented_ms": start.elapsed_time(end) / 5}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
