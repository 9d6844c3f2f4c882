// Device helpers shared by the port's hand-written Hopper kernels.
//
// Storage type T is float or __nv_bfloat16; all arithmetic and every
// shared-memory buffer is float. rnd<T>(x) rounds a float to T and back:
// the kernels call it exactly where the plain PyTorch versions cast to the
// compute dtype, so bf16 runs round at the same points.
//
// block_mm is the one matrix-product primitive: Y = X @ W for a tile X of
// `rows` rows held in shared memory (float, row stride ldx) and a weight
// matrix W (K, N) streamed from global memory (it stays resident in L2
// across blocks). Two bodies, chosen by the storage type:
// - float: FMA loops on the CUDA cores. Each thread owns one output column
//   and MR rows; the four consecutive k of a row come from one 16-byte
//   shared load that every lane of the warp reads at the same address (a
//   broadcast), so the loop is one shared load per four FMAs. Weight loads
//   are coalesced across the warp. Full float32, as the plain version.
// - bfloat16: tensor cores (mma.sync m16n8k16, float accumulators), one
//   warp per 64 x 16 output tile. Every operand a kernel feeds a product is
//   rounded to the compute dtype first, so X holds bf16-exact floats and
//   converting its fragments to bf16 is exact: the product is the FMA
//   body's up to summation order.
//
// block_mm_s8 is the int8 product of the W8A8 layer (s8 tensor cores,
// int32 sums): X is a float tile quantized as its fragments are loaded,
// W an int8 matrix stored transposed.
//
// SmemPlan places a kernel's per-atom buffers: in shared memory where they
// fit, else in the block's own slice of a global workspace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace mtt {

constexpr int kThreads = 512;

// Row stride of the q|k|v buffer of the fused layer kernels (3D + 4 floats:
// 16-byte aligned rows that do not all start in the same bank).
__host__ __device__ inline int qkv_stride(int D) { return 3 * D + 4; }

// ---- shared-memory layout plans -----------------------------------------
//
// A body's buffers claim shared memory in the order of its `keep` list, each
// where it still fits under the 227 KB a block may have; the others go to
// the block's slice of a global workspace (ws_floats per block, allocated
// by the caller; L2-resident at moderate sizes, and read and written only
// by its block). Offsets keep the body's layout order in both regions, so
// where every buffer fits the layout is the one the kernels always had.
// Every size is rounded up to 4 floats (16-byte aligned buffers).
// ops/kernels/_lib.py mirrors make_plan for the CPU tests.

constexpr long long kMaxSharedFloats = 232448 / 4;
constexpr int kMaxPlanBufs = 8;

struct SmemPlan {
    int n = 0;
    long long off[kMaxPlanBufs] = {};
    bool shared[kMaxPlanBufs] = {};
    long long smem_floats = 0, ws_floats = 0;
    __device__ float* at(int i, float* smem, float* ws) const {
        return (shared[i] ? smem : ws) + off[i];
    }
};

// Buffer i of a plan. SH (every buffer shared, ws_floats == 0): smem + its
// offset, so that the compiler keeps shared-memory loads and stores for it;
// otherwise a generic pointer into shared memory or the workspace.
template <bool SH>
__device__ __forceinline__ float* plan_ptr(const SmemPlan& p, int i, float* smem, float* ws) {
    if constexpr (SH) {
        return smem + p.off[i];
    } else {
        return p.at(i, smem, ws);
    }
}

inline SmemPlan make_plan(const long long* sizes, const int* keep, int n, long long cap) {
    SmemPlan p;
    p.n = n;
    long long used = 0;
    for (int j = 0; j < n; ++j) {
        const long long s = (sizes[keep[j]] + 3) / 4 * 4;
        if (used + s <= cap) {
            p.shared[keep[j]] = true;
            used += s;
        }
    }
    for (int i = 0; i < n; ++i) {
        long long& end = p.shared[i] ? p.smem_floats : p.ws_floats;
        p.off[i] = end;
        end += (sizes[i] + 3) / 4 * 4;
    }
    return p;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

template <typename T> __device__ __forceinline__ float rnd(float x) {
    return to_f(from_f<T>(x));
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float siluf_(float x) { return x * sigmoidf_(x); }
// d silu(p) / dp
__device__ __forceinline__ float silu_grad(float p) {
    const float s = sigmoidf_(p);
    return s * (1.f + p * (1.f - s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// ---- float32: FMA loops ----------------------------------------------

// Y[m, n] = epi(m, n, sum_k X[m, k] W[k, n]) for m < rows, n < N.
// Requires rows % MR == 0, K % 4 == 0, ldx % 4 == 0, X 16-byte aligned.
template <int MR, typename Epi>
__device__ __forceinline__ void block_mm_fma(
    const float* __restrict__ X, int ldx, int rows, int K,
    const float* __restrict__ W, int ldw, int N, Epi epi) {
    const int items = N * (rows / MR);
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
        const int n = it % N;
        const int r0 = (it / N) * MR;
        float acc[MR];
#pragma unroll
        for (int r = 0; r < MR; ++r) acc[r] = 0.f;
        const float* xr = X + (size_t)r0 * ldx;
        const float* wc = W + n;
        for (int k = 0; k < K; k += 4) {
            const float w0 = wc[(size_t)(k + 0) * ldw];
            const float w1 = wc[(size_t)(k + 1) * ldw];
            const float w2 = wc[(size_t)(k + 2) * ldw];
            const float w3 = wc[(size_t)(k + 3) * ldw];
#pragma unroll
            for (int r = 0; r < MR; ++r) {
                const float4 x = *reinterpret_cast<const float4*>(xr + (size_t)r * ldx + k);
                float a = acc[r];
                a = fmaf(x.x, w0, a);
                a = fmaf(x.y, w1, a);
                a = fmaf(x.z, w2, a);
                a = fmaf(x.w, w3, a);
                acc[r] = a;
            }
        }
#pragma unroll
        for (int r = 0; r < MR; ++r) epi(r0 + r, n, acc[r]);
    }
}

// Gated variant: for each n < N computes both sum_k X[m, k] W[k, n] and
// sum_k X[m, k] W[k, n + N] (the value and gate halves of a SwiGLU
// projection, W of shape (K, 2N)) and calls epi(m, n, value, gate).
template <int MR, typename Epi>
__device__ __forceinline__ void block_mm_glu_fma(
    const float* __restrict__ X, int ldx, int rows, int K,
    const float* __restrict__ W, int N, Epi epi) {
    const int items = N * (rows / MR);
    const int ldw = 2 * N;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
        const int n = it % N;
        const int r0 = (it / N) * MR;
        float av[MR], ag[MR];
#pragma unroll
        for (int r = 0; r < MR; ++r) av[r] = ag[r] = 0.f;
        const float* xr = X + (size_t)r0 * ldx;
        const float* wv = W + n;
        const float* wg = W + N + n;
        for (int k = 0; k < K; k += 4) {
            float v[4], g[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                v[i] = wv[(size_t)(k + i) * ldw];
                g[i] = wg[(size_t)(k + i) * ldw];
            }
#pragma unroll
            for (int r = 0; r < MR; ++r) {
                const float4 x = *reinterpret_cast<const float4*>(xr + (size_t)r * ldx + k);
                av[r] = fmaf(x.x, v[0], fmaf(x.y, v[1], fmaf(x.z, v[2], fmaf(x.w, v[3], 0.f)))) + av[r];
                ag[r] = fmaf(x.x, g[0], fmaf(x.y, g[1], fmaf(x.z, g[2], fmaf(x.w, g[3], 0.f)))) + ag[r];
            }
        }
#pragma unroll
        for (int r = 0; r < MR; ++r) epi(r0 + r, n, av[r], ag[r]);
    }
}

// ---- bfloat16: tensor cores -------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    __nv_bfloat162 v = __halves2bfloat162(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float2 x) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x.x, x.y);
    return *reinterpret_cast<uint32_t*>(&v);
}

// c += a @ b for one m16n8k16 tile: a row-major 16 x 16, b column-major
// 16 x 8, both bf16; c float.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[mt][j] = X[m0 + 16 mt + (0..15), :K] @ W[:K, c0 + 8 j + (0..7)] for
// mt < mt_n <= 4, j < 2: one warp's 64 x 16 tile. In the A and C fragments
// lane l holds rows l / 4 (and +8) at columns 2 (l % 4) (+1, +8, +9); in
// the B fragment column l / 4 at rows 2 (l % 4) (+1, +8, +9). B comes
// straight from global memory (L2), A from the float tile in shared memory.
__device__ __forceinline__ void tc_tile(
    const float* __restrict__ X, int ldx, int m0, int mt_n, int K,
    const __nv_bfloat16* __restrict__ W, int ldw, int c0, float (&acc)[4][2][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
        uint32_t b[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const __nv_bfloat16* w = W + (size_t)(k0 + 2 * t) * ldw + c0 + 8 * j + g;
            b[j][0] = pack_bf16(w[0], w[ldw]);
            b[j][1] = pack_bf16(w[8 * (size_t)ldw], w[9 * (size_t)ldw]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
            if (mt < mt_n) {
                const float* x = X + (size_t)(m0 + 16 * mt + g) * ldx + k0 + 2 * t;
                const uint32_t a[4] = {
                    pack_bf16(*reinterpret_cast<const float2*>(x)),
                    pack_bf16(*reinterpret_cast<const float2*>(x + 8 * ldx)),
                    pack_bf16(*reinterpret_cast<const float2*>(x + 8)),
                    pack_bf16(*reinterpret_cast<const float2*>(x + 8 * ldx + 8)),
                };
                mma_16816(acc[mt][0], a, b[0]);
                mma_16816(acc[mt][1], a, b[1]);
            }
        }
    }
}

// Calls f(mt, j, i, m, n) for element i of accumulator acc[mt][j], which
// holds output (m, n).
template <typename F>
__device__ __forceinline__ void tc_tile_store(int m0, int mt_n, int n0, F f) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
        if (mt >= mt_n) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                f(mt, j, i, m0 + 16 * mt + g + 8 * (i >> 1), n0 + 8 * j + 2 * t + (i & 1));
    }
}

// Requires rows % 16 == 0, K % 16 == 0, N % 16 == 0, ldx even.
template <typename Epi>
__device__ __forceinline__ void block_mm_tc(
    const float* __restrict__ X, int ldx, int rows, int K,
    const __nv_bfloat16* __restrict__ W, int ldw, int N, Epi epi) {
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int col_tiles = N / 16, tiles = col_tiles * ((rows + 63) / 64);
    for (int tile = warp; tile < tiles; tile += nw) {
        const int n0 = (tile % col_tiles) * 16, m0 = (tile / col_tiles) * 64;
        const int mt_n = min(4, (rows - m0) / 16);
        float acc[4][2][4];
        tc_tile(X, ldx, m0, mt_n, K, W, ldw, n0, acc);
        tc_tile_store(m0, mt_n, n0, [&](int mt, int j, int i, int m, int n) {
            epi(m, n, acc[mt][j][i]);
        });
    }
}

template <typename Epi>
__device__ __forceinline__ void block_mm_glu_tc(
    const float* __restrict__ X, int ldx, int rows, int K,
    const __nv_bfloat16* __restrict__ W, int N, Epi epi) {
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int col_tiles = N / 16, tiles = col_tiles * ((rows + 63) / 64);
    for (int tile = warp; tile < tiles; tile += nw) {
        const int n0 = (tile % col_tiles) * 16, m0 = (tile / col_tiles) * 64;
        const int mt_n = min(4, (rows - m0) / 16);
        float av[4][2][4], ag[4][2][4];
        tc_tile(X, ldx, m0, mt_n, K, W, 2 * N, n0, av);
        tc_tile(X, ldx, m0, mt_n, K, W, 2 * N, N + n0, ag);
        tc_tile_store(m0, mt_n, n0, [&](int mt, int j, int i, int m, int n) {
            epi(m, n, av[mt][j][i], ag[mt][j][i]);
        });
    }
}

// ---- int8: tensor cores (the W8A8 layer) ------------------------------
//
// A float x quantizes to clamp(rint(x * inv), -127, 127): x * inv rounded
// once to float, then to the nearest integer with ties to even (as
// jnp.round and torch.round; never roundf). The float tiles stay in shared
// memory and are quantized as the A fragments are loaded, the way tc_tile
// rounds to bf16. The int8 weights come transposed, (N, K), so that the
// four consecutive k a lane needs are one 32-bit load. The int32 sums are
// exact (|sum| <= K 127^2 < 2^24 for K <= 1040), and so is their
// conversion to float.

// The W8A8 layer's int8 weights, transposed to (out, in), and its static
// scales: 127 / absmax of each quantized activation, and each product's
// dequantization factor (absmax_x / 127) (absmax_w / 127), the scores' with
// the attention scale folded in; every factor rounded once to float.
struct LayerI8 {
    const int8_t* w_qkv_t = nullptr;  // (3D, D)
    const int8_t* w_in_t = nullptr;   // (2F, D): value rows, then gate rows
    const int8_t* w_fo_t = nullptr;   // (D, F)
    float inv_normed = 0.f, inv_q = 0.f, inv_k = 0.f, inv_hnorm = 0.f, inv_ffn = 0.f;
    float deq_q = 0.f, deq_k = 0.f, deq_v = 0.f, deq_in = 0.f, deq_fo = 0.f, deq_scores = 0.f;
};

// The scales in the order of the wrappers' array: the five inverses
// (normed, q, k, h_norm, ffn_h), then the six factors (q, k, v, FFN-in,
// FFN-out, scores).
inline LayerI8 layer_i8(const void* w_qkv_t, const void* w_in_t, const void* w_fo_t,
                        const float* s) {
    return LayerI8{(const int8_t*)w_qkv_t, (const int8_t*)w_in_t, (const int8_t*)w_fo_t,
                   s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10]};
}

// The dynamic int8 scores of one atom (the JAX package's MTT_INT8_SCORES=1):
// q and k quantize as rint(x / s) with the absmax scales s_q, s_k of the
// atom's block of atoms, and the int32 products dequantize by factor =
// (s_q s_k) scale, each product rounded once to float.
struct ScoresI8 {
    float s_q = 0.f, s_k = 0.f, factor = 0.f;
};

__device__ __forceinline__ ScoresI8 scores_i8(const float* s, float scale) {
    return ScoresI8{s[0], s[1], __fmul_rn(__fmul_rn(s[0], s[1]), scale)};
}

// x * deq + b with two roundings, as the plain version (no fused FMA)
__device__ __forceinline__ float dequant(int acc, float deq, float b) {
    return __fadd_rn(__fmul_rn((float)acc, deq), b);
}

// clamp(rint(x * p), -127, 127) with p the inverse scale (static scales),
// or with DIV clamp(rint(x / p), -127, 127) with p the scale itself (the
// dynamic scores, as the JAX package's _quantize_i8 divides).
template <bool DIV = false>
__device__ __forceinline__ uint32_t quant_s8(float x, float p) {
    const int q = __float2int_rn(DIV ? __fdiv_rn(x, p) : __fmul_rn(x, p));
    return (uint32_t)(min(127, max(-127, q)) & 0xff);
}

// four floats quantized and packed, x.x in the low byte
template <bool DIV = false>
__device__ __forceinline__ uint32_t quant4_s8(float4 x, float p) {
    return quant_s8<DIV>(x.x, p) | quant_s8<DIV>(x.y, p) << 8 | quant_s8<DIV>(x.z, p) << 16 |
           quant_s8<DIV>(x.w, p) << 24;
}

// x[0..3] quantized and packed, where column d + i >= n is a zero column
// (a head padded to the tile's width); scalar loads, any alignment.
template <bool DIV>
__device__ __forceinline__ uint32_t quant4_s8_tail(const float* x, int d, int n, float p) {
    uint32_t r = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        if (d + i < n) r |= quant_s8<DIV>(x[i], p) << (8 * i);
    return r;
}

// c += a @ b for one m16n8k32 tile: a row-major 16 x 32, b column-major
// 32 x 8, both int8; c int32.
__device__ __forceinline__ void mma_s8_16832(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a @ b for one m16n8k16 tile of int8 (a 16 x 16, b 16 x 8).
__device__ __forceinline__ void mma_s8_16816(int (&c)[4], const uint32_t (&a)[2], uint32_t b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(b));
}

// acc[mt][j] = q(X[m0 + 16 mt + (0..15), :K]) @ Wt[c0 + 8 j + (0..7), :K]^T
// for mt < mt_n <= 4, j < 2: one warp's 64 x 16 tile, k in steps of 32. In
// the A fragment lane l holds rows l / 4 (and +8) at columns 4 (l % 4) ..
// +3 (and +16); in the B fragment column l / 4 at rows 4 (l % 4) .. +3 (and
// +16); the C fragment is tc_tile's.
__device__ __forceinline__ void tc_tile_s8(
    const float* __restrict__ X, int ldx, int m0, int mt_n, int K, float inv,
    const int8_t* __restrict__ Wt, int c0, int (&acc)[4][2][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 32) {
        uint32_t b[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int8_t* w = Wt + (size_t)(c0 + 8 * j + g) * K + k0 + 4 * t;
            b[j][0] = *reinterpret_cast<const uint32_t*>(w);
            b[j][1] = *reinterpret_cast<const uint32_t*>(w + 16);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
            if (mt < mt_n) {
                const float* x = X + (size_t)(m0 + 16 * mt + g) * ldx + k0 + 4 * t;
                const uint32_t a[4] = {
                    quant4_s8(*reinterpret_cast<const float4*>(x), inv),
                    quant4_s8(*reinterpret_cast<const float4*>(x + 8 * ldx), inv),
                    quant4_s8(*reinterpret_cast<const float4*>(x + 16), inv),
                    quant4_s8(*reinterpret_cast<const float4*>(x + 8 * ldx + 16), inv),
                };
                mma_s8_16832(acc[mt][0], a, b[0]);
                mma_s8_16832(acc[mt][1], a, b[1]);
            }
        }
    }
}

// Y[m, n] = epi(m, n, sum_k q(X[m, k]) Wt[n, k]) (an int32 sum) for m <
// rows, n < N, with q(x) = clamp(rint(x inv), -127, 127). rows % 16 == 0,
// K % 32 == 0, N % 16 == 0, ldx % 4 == 0, X 16-byte aligned.
template <typename Epi>
__device__ __forceinline__ void block_mm_s8(
    const float* __restrict__ X, int ldx, int rows, int K, float inv,
    const int8_t* __restrict__ Wt, int N, Epi epi) {
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int col_tiles = N / 16, tiles = col_tiles * ((rows + 63) / 64);
    for (int tile = warp; tile < tiles; tile += nw) {
        const int n0 = (tile % col_tiles) * 16, m0 = (tile / col_tiles) * 64;
        const int mt_n = min(4, (rows - m0) / 16);
        int acc[4][2][4];
        tc_tile_s8(X, ldx, m0, mt_n, K, inv, Wt, n0, acc);
        tc_tile_store(m0, mt_n, n0, [&](int mt, int j, int i, int m, int n) {
            epi(m, n, acc[mt][j][i]);
        });
    }
}

// Gated variant (Wt of shape (2N, K): value rows, then gate rows): calls
// epi(m, n, value, gate) with both int32 sums.
template <typename Epi>
__device__ __forceinline__ void block_mm_glu_s8(
    const float* __restrict__ X, int ldx, int rows, int K, float inv,
    const int8_t* __restrict__ Wt, int N, Epi epi) {
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int col_tiles = N / 16, tiles = col_tiles * ((rows + 63) / 64);
    for (int tile = warp; tile < tiles; tile += nw) {
        const int n0 = (tile % col_tiles) * 16, m0 = (tile / col_tiles) * 64;
        const int mt_n = min(4, (rows - m0) / 16);
        int av[4][2][4], ag[4][2][4];
        tc_tile_s8(X, ldx, m0, mt_n, K, inv, Wt, n0, av);
        tc_tile_s8(X, ldx, m0, mt_n, K, inv, Wt, N + n0, ag);
        tc_tile_store(m0, mt_n, n0, [&](int mt, int j, int i, int m, int n) {
            epi(m, n, av[mt][j][i], ag[mt][j][i]);
        });
    }
}

// S[q, k] = epi(q, k, sum_{d < hd} q(Qh[q, d]) q(Kh[k, d])) for q, k < M,
// q and k quantized by p_q and p_k (inverse scales, or with DIV scales):
// one head's scores (m16n8k16, one warp per 16 x 8 tile). M % 16 == 0, ld
// % 4 == 0. A head width that is not a multiple of 16 is padded to one in
// registers with zero columns (exact zeros in the int32 sums); with hd %
// 16 == 0, Qh and Kh must be 16-byte aligned.
template <bool DIV = false, typename Epi>
__device__ __forceinline__ void scores_s8(
    const float* __restrict__ Qh, float p_q, const float* __restrict__ Kh, float p_k,
    int ld, int M, int hd, Epi epi) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int col_tiles = M / 8, tiles = (M / 16) * col_tiles;
    const bool vec = hd % 16 == 0;
    for (int tile = warp; tile < tiles; tile += nw) {
        const int m0 = (tile / col_tiles) * 16, n0 = (tile % col_tiles) * 8;
        int c[4] = {0, 0, 0, 0};
        for (int d0 = 0; d0 < hd; d0 += 16) {
            const int d = d0 + 4 * t;
            const float* x = Qh + (size_t)(m0 + g) * ld + d;
            const float* y = Kh + (size_t)(n0 + g) * ld + d;
            uint32_t a[2], b;
            if (vec) {
                a[0] = quant4_s8<DIV>(*reinterpret_cast<const float4*>(x), p_q);
                a[1] = quant4_s8<DIV>(*reinterpret_cast<const float4*>(x + 8 * ld), p_q);
                b = quant4_s8<DIV>(*reinterpret_cast<const float4*>(y), p_k);
            } else {
                a[0] = quant4_s8_tail<DIV>(x, d, hd, p_q);
                a[1] = quant4_s8_tail<DIV>(x + 8 * ld, d, hd, p_q);
                b = quant4_s8_tail<DIV>(y, d, hd, p_k);
            }
            mma_s8_16816(c, a, b);
        }
        epi(m0 + g, n0 + 2 * t, c[0]);
        epi(m0 + g, n0 + 2 * t + 1, c[1]);
        epi(m0 + g + 8, n0 + 2 * t, c[2]);
        epi(m0 + g + 8, n0 + 2 * t + 1, c[3]);
    }
}

// ---- dispatch on the storage type -------------------------------------

// Y[m, n] = epi(m, n, sum_k X[m, k] W[k, n]) for m < rows, n < N.
// float: rows % MR == 0, K % 4 == 0; bfloat16: rows, K and N % 16 == 0.
// ldx % 4 == 0 and X 16-byte aligned in both.
template <int MR, typename T, typename Epi>
__device__ __forceinline__ void block_mm(
    const float* __restrict__ X, int ldx, int rows, int K,
    const T* __restrict__ W, int ldw, int N, Epi epi) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        block_mm_tc(X, ldx, rows, K, W, ldw, N, epi);
    } else {
        block_mm_fma<MR>(X, ldx, rows, K, W, ldw, N, epi);
    }
}

// Gated variant: for each n < N computes both sum_k X[m, k] W[k, n] and
// sum_k X[m, k] W[k, n + N] (the value and gate halves of a SwiGLU
// projection, W of shape (K, 2N)) and calls epi(m, n, value, gate).
template <int MR, typename T, typename Epi>
__device__ __forceinline__ void block_mm_glu(
    const float* __restrict__ X, int ldx, int rows, int K,
    const T* __restrict__ W, int N, Epi epi) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        block_mm_glu_tc(X, ldx, rows, K, W, N, epi);
    } else {
        block_mm_glu_fma<MR>(X, ldx, rows, K, W, N, epi);
    }
}

// Y[m] = rnd(X[m] * rsqrt(mean(X[m]^2) + eps) * scale), one warp per row
// (ROUND = false: the float value, which the W8A8 layer quantizes);
// rs_out[m] (optional) receives the row's rsqrt factor.
template <typename T, bool ROUND = true>
__device__ __forceinline__ void rmsnorm_rows(
    const float* __restrict__ X, float* __restrict__ Y, float* rs_out,
    int rows, int D, const T* __restrict__ scale, float eps) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    for (int m = warp; m < rows; m += nw) {
        const float* x = X + (size_t)m * D;
        float s = 0.f;
        for (int k = lane; k < D; k += 32) s = fmaf(x[k], x[k], s);
        s = warp_sum(s);
        const float r = rsqrtf(s / D + eps);
        if (rs_out != nullptr && lane == 0) rs_out[m] = r;
        for (int k = lane; k < D; k += 32) {
            const float y = x[k] * r * to_f(scale[k]);
            Y[(size_t)m * D + k] = ROUND ? rnd<T>(y) : y;
        }
    }
}

// ---- window attention products (float, shared memory, FMA loops) -----
//
// Each thread computes a small register tile and reuses every shared load
// across it. Score matrices use a row stride of M + 1 floats, so that the
// threads of a warp reading one column of eight rows hit eight banks.
// A head width (K of smem_abt, Dc of the others) that is not a multiple of
// 4 takes a scalar loop, one output per thread: any width, any alignment.

// C[i, j] = sum_k A[i, k] B[j, k] for i < R, j < C: 2 x 4 outputs per
// thread; consecutive threads take consecutive row pairs, so a warp shares
// its B rows (broadcast loads). R % 2 == 0, C % 4 == 0; with K % 4 == 0,
// lda and ldb % 4 == 0 and A and B 16-byte aligned.
template <typename Epi>
__device__ __forceinline__ void smem_abt(
    const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
    int R, int C, int K, Epi epi) {
    if (K & 3) {
        for (int t = threadIdx.x; t < R * C; t += blockDim.x) {
            const int i = t % R, j = t / R;
            float acc = 0.f;
            for (int k = 0; k < K; ++k) acc = fmaf(A[(size_t)i * lda + k], B[(size_t)j * ldb + k], acc);
            epi(i, j, acc);
        }
        return;
    }
    const int row_pairs = R / 2, tiles = row_pairs * (C / 4);
    for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
        const int i0 = 2 * (t % row_pairs), j0 = 4 * (t / row_pairs);
        float acc[2][4] = {};
        for (int k = 0; k < K; k += 4) {
            float4 a[2], b[4];
#pragma unroll
            for (int r = 0; r < 2; ++r)
                a[r] = *reinterpret_cast<const float4*>(A + (size_t)(i0 + r) * lda + k);
#pragma unroll
            for (int c = 0; c < 4; ++c)
                b[c] = *reinterpret_cast<const float4*>(B + (size_t)(j0 + c) * ldb + k);
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    acc[r][c] = fmaf(a[r].x, b[c].x, fmaf(a[r].y, b[c].y,
                                fmaf(a[r].z, b[c].z, fmaf(a[r].w, b[c].w, acc[r][c]))));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) epi(i0 + r, j0 + c, acc[r][c]);
    }
}

// C[i, d] = sum_k A[i, k] w[k] B[k, d] for i < R, d < Dc (w == nullptr: no
// weights): one row and four columns per thread. With Dc % 4 == 0, ldb % 4
// == 0 and B 16-byte aligned.
template <typename Epi>
__device__ __forceinline__ void smem_awb(
    const float* __restrict__ A, int lda, const float* __restrict__ w,
    const float* __restrict__ B, int ldb, int R, int Dc, int K, Epi epi) {
    if (Dc & 3) {
        for (int t = threadIdx.x; t < R * Dc; t += blockDim.x) {
            const int i = t / Dc, d = t % Dc;
            const float* a = A + (size_t)i * lda;
            float acc = 0.f;
            for (int k = 0; k < K; ++k)
                acc = fmaf(w == nullptr ? a[k] : w[k] * a[k], B[(size_t)k * ldb + d], acc);
            epi(i, d, acc);
        }
        return;
    }
    const int quads = Dc / 4, tiles = R * quads;
    for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
        const int i = t / quads, d0 = 4 * (t % quads);
        const float* a = A + (size_t)i * lda;
        float acc[4] = {};
        for (int k = 0; k < K; ++k) {
            const float x = w == nullptr ? a[k] : w[k] * a[k];
            const float4 b = *reinterpret_cast<const float4*>(B + (size_t)k * ldb + d0);
            acc[0] = fmaf(x, b.x, acc[0]);
            acc[1] = fmaf(x, b.y, acc[1]);
            acc[2] = fmaf(x, b.z, acc[2]);
            acc[3] = fmaf(x, b.w, acc[3]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) epi(i, d0 + c, acc[c]);
    }
}

// C[j, d] = sum_i A[i, j] B[i, d] for j < R, d < Dc (A transposed, i < K):
// one row and four columns per thread. With Dc % 4 == 0, ldb % 4 == 0 and
// B 16-byte aligned.
template <typename Epi>
__device__ __forceinline__ void smem_atb(
    const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
    int R, int Dc, int K, Epi epi) {
    if (Dc & 3) {
        for (int t = threadIdx.x; t < R * Dc; t += blockDim.x) {
            const int j = t / Dc, d = t % Dc;
            float acc = 0.f;
            for (int i = 0; i < K; ++i) acc = fmaf(A[(size_t)i * lda + j], B[(size_t)i * ldb + d], acc);
            epi(j, d, acc);
        }
        return;
    }
    const int quads = Dc / 4, tiles = R * quads;
    for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
        const int j = t / quads, d0 = 4 * (t % quads);
        float acc[4] = {};
        for (int i = 0; i < K; ++i) {
            const float x = A[(size_t)i * lda + j];
            const float4 b = *reinterpret_cast<const float4*>(B + (size_t)i * ldb + d0);
            acc[0] = fmaf(x, b.x, acc[0]);
            acc[1] = fmaf(x, b.y, acc[1]);
            acc[2] = fmaf(x, b.z, acc[2]);
            acc[3] = fmaf(x, b.w, acc[3]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) epi(j, d0 + c, acc[c]);
    }
}

// Row-wise softmax with multiplicative key weights cf (row stride lds):
// with m the row max, S[q, k] <- exp(S[q, k] - m) / sum_k' cf[k']
// exp(S[q, k'] - m). This is cf * exp(s) / sum cf * exp(s) divided by cf[k]
// (so it stays defined where cf[k] == 0); the probabilities are
// cf[k] * S[q, k]. One warp per row.
__device__ __forceinline__ void cf_softmax_rows(float* __restrict__ S, int lds, const float* __restrict__ cf, int M) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    for (int q = warp; q < M; q += nw) {
        float* row = S + (size_t)q * lds;
        float mx = -INFINITY;
        for (int k = lane; k < M; k += 32) mx = fmaxf(mx, row[k]);
        mx = warp_max(mx);
        float z = 0.f;
        for (int k = lane; k < M; k += 32) {
            const float e = expf(row[k] - mx);
            row[k] = e;
            z = fmaf(cf[k], e, z);
        }
        z = warp_sum(z);
        const float inv = 1.f / z;
        for (int k = lane; k < M; k += 32) row[k] *= inv;
    }
}

// The W8A8 layer's softmax rows (the JAX package's _qside_tail): cf * e is
// rounded to the compute dtype before the AV product and the denominator.
// With m the row max and e = exp(S[q, k] - m), S[q, k] <- w / z with w =
// rnd<T>(cf[k] e) and z = sum_k w: the AV weights, cf included. With E,
// also E[q, k] = e / z (row stride lds), which the straight-through
// backward's softmax gradient takes. One warp per row.
template <typename T>
__device__ __forceinline__ void cf_softmax_rows_w8(float* __restrict__ S, int lds, const float* __restrict__ cf,
                                                   int M, float* __restrict__ E) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    for (int q = warp; q < M; q += nw) {
        float* row = S + (size_t)q * lds;
        float mx = -INFINITY;
        for (int k = lane; k < M; k += 32) mx = fmaxf(mx, row[k]);
        mx = warp_max(mx);
        float z = 0.f;
        for (int k = lane; k < M; k += 32) {
            const float e = expf(row[k] - mx);
            const float w = rnd<T>(cf[k] * e);
            row[k] = w;
            if (E != nullptr) E[(size_t)q * lds + k] = e;
            z += w;
        }
        z = warp_sum(z);
        const float inv = 1.f / z;
        for (int k = lane; k < M; k += 32) {
            row[k] *= inv;
            if (E != nullptr) E[(size_t)q * lds + k] *= inv;
        }
    }
}

// ---- weight gradients: per-block partials, summed in a fixed order ----
// (sum_partials_kernel lives in an anonymous namespace per translation
// unit: every .cu file that includes this header gets its own copy.)
//
// A weight-gradient kernel runs a fixed grid (one block per SM); each
// block owns a contiguous range of the work and its own float partial of
// all the weight gradients in global memory. Every element of a partial
// is always updated by the same thread, in the block's program order, so
// no atomics are needed; sum_partials then adds the partials in block
// order. Both orders are fixed for a grid, so the result is the same in
// every run.

// P[i, j] += sum_{r < R} A[r, i] * B'[r, j] for i < K, j < N, where B' is
// B rounded to T (ROUND_B) or B itself. A 4 x 4 register tile per thread;
// consecutive threads take consecutive column quads, so the A loads of a
// warp are broadcasts and the read-modify-write of P is coalesced.
// K % 4 == 0, N % 4 == 0, lda, ldb and ldp % 4 == 0, all 16-byte aligned.
template <typename T, bool ROUND_B>
__device__ __forceinline__ void accum_atb(
    float* __restrict__ P, int ldp, const float* __restrict__ A, int lda,
    const float* __restrict__ B, int ldb, int R, int K, int N) {
    const int nq = N / 4, tiles = (K / 4) * nq;
    for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
        const int i0 = 4 * (t / nq), j0 = 4 * (t % nq);
        float acc[4][4] = {};
        for (int r = 0; r < R; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(A + (size_t)r * lda + i0);
            float4 b = *reinterpret_cast<const float4*>(B + (size_t)r * ldb + j0);
            if (ROUND_B) {
                b.x = rnd<T>(b.x);
                b.y = rnd<T>(b.y);
                b.z = rnd<T>(b.z);
                b.w = rnd<T>(b.w);
            }
            const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
                acc[ii][0] = fmaf(av[ii], b.x, acc[ii][0]);
                acc[ii][1] = fmaf(av[ii], b.y, acc[ii][1]);
                acc[ii][2] = fmaf(av[ii], b.z, acc[ii][2]);
                acc[ii][3] = fmaf(av[ii], b.w, acc[ii][3]);
            }
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
            float4* p = reinterpret_cast<float4*>(P + (size_t)(i0 + ii) * ldp + j0);
            float4 v = *p;
            v.x += acc[ii][0];
            v.y += acc[ii][1];
            v.z += acc[ii][2];
            v.w += acc[ii][3];
            *p = v;
        }
    }
}

// P[j] += sum_{r < R} B[r, j] for j < N (one thread per column).
__device__ __forceinline__ void accum_colsum(float* __restrict__ P, const float* __restrict__ B, int ldb, int R, int N) {
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
        float s = 0.f;
        for (int r = 0; r < R; ++r) s += B[(size_t)r * ldb + j];
        P[j] += s;
    }
}

__device__ __forceinline__ void zero_floats(float* __restrict__ P, long long n) {
    for (long long i = threadIdx.x; i < n; i += blockDim.x) P[i] = 0.f;
}

namespace {

// out[e] = sum_{b < blocks} partials[b, e], b in order.
__global__ void __launch_bounds__(256) sum_partials_kernel(
    const float* __restrict__ partials, int blocks, long long n, float* __restrict__ out) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partials[(size_t)b * n + e];
    out[e] = s;
}

inline int launch_sum_partials(const float* partials, int blocks, long long n, float* out, cudaStream_t stream) {
    const unsigned grid = (unsigned)((n + 255) / 256);
    sum_partials_kernel<<<grid, 256, 0, stream>>>(partials, blocks, n, out);
    return (int)cudaGetLastError();
}

}  // namespace

}  // namespace mtt
