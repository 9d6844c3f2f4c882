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

// Y[m] = rnd(X[m] * rsqrt(mean(X[m]^2) + eps) * scale), one warp per row;
// rs_out[m] (optional) receives the row's rsqrt factor.
template <typename T>
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
        for (int k = lane; k < D; k += 32) Y[(size_t)m * D + k] = rnd<T>(x[k] * r * to_f(scale[k]));
    }
}

// ---- window attention products (float, shared memory, FMA loops) -----
//
// Each thread computes a small register tile and reuses every shared load
// across it. Score matrices use a row stride of M + 1 floats, so that the
// threads of a warp reading one column of eight rows hit eight banks.

// C[i, j] = sum_k A[i, k] B[j, k] for i < R, j < C: 2 x 4 outputs per
// thread; consecutive threads take consecutive row pairs, so a warp shares
// its B rows (broadcast loads). R % 2 == 0, C % 4 == 0, K % 4 == 0, lda and
// ldb % 4 == 0, A and B 16-byte aligned.
template <typename Epi>
__device__ __forceinline__ void smem_abt(
    const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
    int R, int C, int K, Epi epi) {
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
// weights): one row and four columns per thread. Dc % 4 == 0, ldb % 4 == 0,
// B 16-byte aligned.
template <typename Epi>
__device__ __forceinline__ void smem_awb(
    const float* __restrict__ A, int lda, const float* __restrict__ w,
    const float* __restrict__ B, int ldb, int R, int Dc, int K, Epi epi) {
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
// one row and four columns per thread. Dc % 4 == 0, ldb % 4 == 0, B
// 16-byte aligned.
template <typename Epi>
__device__ __forceinline__ void smem_atb(
    const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
    int R, int Dc, int K, Epi epi) {
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
