"""Phase split of K2, of the Hopper K1, or of the Hopper K3 and K4 heads, in
bfloat16 by ``clock64()`` stamps, on a CUDA device.

Usage, on a machine with a CUDA device and nvcc::

    python metatrain_tpu_torch/tools/k2_split.py --body hopper|general|k1-hopper|k3-head|k4-head
        [--A 11392] [--M 64]

Copies the body's sources (``--body hopper``: the Hopper K2,
``csrc/fused_layer_bwd_sm90.cu``; ``general``: K2's general body,
``csrc/layer_bwd.cuh`` with a one-kernel launcher; ``k1-hopper``: the
Hopper K1, ``csrc/fused_layer_fwd_sm90.cu``; ``k3-head`` / ``k4-head``: the
Hopper K3 / K4 head, ``csrc/rowblock_{fwd,bwd}_sm90.cu`` with the shared
``head_front`` of ``csrc/rowblock_sm90.cuh``) into a
temporary directory, inserts after each phase's closing barrier a stamp of
thread 0's ``clock64()`` that adds the phase's cycles to a device counter,
builds that copy alone with nvcc, runs it on a seeded case (D = 128, 8
heads, F = 256, inputs as ``layer_times.py`` makes them; the heads at A x M
rows) and prints one JSON line: the card (``nvidia-smi`` name and power
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

STAMP = ('__device__ unsigned long long g_split[8];\n'
         '#define SPLIT(i) if (threadIdx.x == 0) { long long t_ = clock64(); '
         'atomicAdd(&g_split[i], (unsigned long long)(t_ - t_prev)); t_prev = t_; }\n')
COUNTERS = ('\nextern "C" int split_read(unsigned long long* out) '
            '{ return (int)cudaMemcpyFromSymbol(out, g_split, 64); }\n'
            'extern "C" int split_zero() { unsigned long long z[8] = {}; '
            'return (int)cudaMemcpyToSymbol(g_split, z, 64); }\n')

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
GENERAL_LAUNCHER = '''#include "layer_bwd.cuh"
using namespace mtt;
using T = __nv_bfloat16;

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


def build(work: Path, body: str) -> Path:
    for name in ("common.cuh", "layer_bwd.cuh", "layer_sm90.cuh", "fused_layer_bwd_sm90.cu",
                 "fused_layer_fwd_sm90.cu", "rowblock_sm90.cuh", "rowblock_fwd_sm90.cu",
                 "rowblock_bwd_sm90.cu"):
        shutil.copy(CSRC / name, work / name)
    if body in ("hopper", "k1-hopper"):
        unit = work / ("fused_layer_bwd_sm90.cu" if body == "hopper" else "fused_layer_fwd_sm90.cu")
        marks = HOPPER if body == "hopper" else K1_HOPPER
        unit.write_text(instrument(unit.read_text(), marks) + COUNTERS)
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
        unit.write_text(GENERAL_LAUNCHER + COUNTERS)
    lib = work / "split.so"
    nvcc = shutil.which("nvcc") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", str(unit), "-o", str(lib)], check=True,
                   timeout=600)
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--body", choices=("hopper", "general", "k1-hopper", "k3-head", "k4-head"),
                        required=True)
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
    A, M, D, H, F = args.A, args.M, 128, 8, 256
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    def lecun(*shape):
        return torch.randn(*shape, generator=gen) / math.sqrt(shape[0])

    w = [1 + 0.1 * torch.randn(D, generator=gen), lecun(D, 3 * D),
         0.1 * torch.randn(3 * D, generator=gen), lecun(D, D), 0.1 * torch.randn(D, generator=gen),
         1 + 0.1 * torch.randn(D, generator=gen), lecun(D, 2 * F),
         0.1 * torch.randn(2 * F, generator=gen), lecun(F, D), 0.1 * torch.randn(D, generator=gen)]
    w = [x.to(dev, torch.bfloat16).contiguous() for x in w]
    n_real = torch.randint(M // 2, M - 1, (A, 1), generator=gen)
    cf = torch.rand(A, M, generator=gen) * (torch.arange(M)[None] < n_real)
    cf[:, M - 1] = 1.0
    cf = cf.to(dev)
    e, c, ge, gc = (torch.randn(*s, generator=gen).to(dev, torch.bfloat16)
                    for s in ((A, M, D), (A, D), (A, M, D), (A, D)))
    de, dc, dcf = torch.empty_like(e), torch.empty_like(c), torch.empty_like(cf)
    scale, eps = 1.0 / math.sqrt(D // H), float(torch.finfo(torch.float32).eps)
    P, I, L, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    with tempfile.TemporaryDirectory() as tmp:
        lib = ctypes.CDLL(str(build(Path(tmp), args.body)))
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
        elif args.body == "hopper":
            ptrs = [e, c, cf, *w[:9], *(w[i].t().contiguous() for i in (1, 3, 6)), ge, gc, de, dc,
                    dcf]
            lib.mtt_fused_layer_bwd_sm90.argtypes = [P] * 20 + [L, I, I, I, I, F_, F_, P]

            def run():
                return lib.mtt_fused_layer_bwd_sm90(*(x.data_ptr() for x in ptrs), A, M, D, H, F,
                                                    scale, eps, stream)
        elif args.body == "k1-hopper":
            # w_in^T with value and gate rows interleaved in blocks of 64, as
            # fused_layer.k1_sm90_w_vg arranges it
            w_vg = w[6].t().reshape(2, F // 64, 64, D).transpose(0, 1).reshape(2 * F, D).contiguous()
            ptrs = [e, c, cf, *(w[i] for i in (0, 2, 4, 5, 7, 9)), w[1].t().contiguous(),
                    w[3].t().contiguous(), w_vg, w[8].t().contiguous(), de, dc]
            lib.mtt_fused_layer_fwd_sm90.argtypes = [P] * 15 + [L, I, I, I, I, F_, F_, P]

            def run():
                return lib.mtt_fused_layer_fwd_sm90(*(x.data_ptr() for x in ptrs), A, M, D, H, F,
                                                    scale, eps, stream)
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
        counts = (ctypes.c_ulonglong * 8)()
        lib.split_read(counts)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        end.record()
        torch.cuda.synchronize()
    names = {"hopper": HOPPER_PHASES, "general": GENERAL_PHASES, "k1-hopper": K1_HOPPER_PHASES,
             "k3-head": K3_HEAD_PHASES, "k4-head": K4_HEAD_PHASES}[args.body]
    cycles = list(counts)[:len(names)]
    total = sum(cycles)
    # the heads' stamps count per 64-row tile of a block
    per = {"cycles_per_tile": total / -(-A * M // 64)} if args.body.endswith("-head") else {
        "cycles_per_atom": total / A}
    print(json.dumps({"card": card, "body": args.body, "shape": [A, M, D, H, F], **per,
                      "share": {n: x / total for n, x in zip(names, cycles)},
                      "instrumented_ms": start.elapsed_time(end) / 5}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
