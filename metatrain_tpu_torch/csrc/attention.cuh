// Helpers of the window-attention kernels (window_attention_fwd.cu,
// window_attention_bwd.cu): one head's row of a (A, T, ld) array moved
// between global memory and float registers in 16-byte vectors, the
// block's shared-memory staging of whole (T, D) windows, and for the
// bf16 tensor-core variants the staging of bf16 windows padded to whole
// 16-row tiles and the fragment loads of mma.sync m16n8k16 (layouts in
// common.cuh's tc_tile).

#pragma once

#include "common.cuh"

namespace mtt {

// r[d] = p[d] for d < HD. HD * sizeof(T) % 16 == 0 and p 16-byte aligned.
template <int HD, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&r)[HD]) {
    constexpr int per = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < HD / per; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(p + c * per);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < per; ++i) r[c * per + i] = to_f(e[i]);
    }
}

// p[d] = T(r[d] * s) for d < HD, same alignment as load_row.
template <int HD, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ p, const float (&r)[HD], float s) {
    constexpr int per = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < HD / per; ++c) {
        uint4 raw;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int i = 0; i < per; ++i) e[i] = from_f<T>(r[c * per + i] * s);
        *reinterpret_cast<uint4*>(p + c * per) = raw;
    }
}

// S[t * D + d] = float(x[t * ld + d]) for the T x D window x (coalesced).
template <typename T>
__device__ __forceinline__ void stage_window(float* __restrict__ S, const T* __restrict__ x, int ld,
                                             int T_, int D) {
    for (int i = threadIdx.x; i < T_ * D; i += blockDim.x) {
        const int t = i / D;
        S[i] = to_f(x[(size_t)t * ld + (i - t * D)]);
    }
}

// The register width of a head of hd columns in the float kernels: 8, 16,
// 32 or 64 (0: wider than the kernels take).
__host__ __device__ inline int head_regs(int hd) {
    return hd <= 8 ? 8 : hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : 0;
}

// r[d] = p[d] for d < hd, 0 for hd <= d < HD: a head of hd columns padded
// with zero columns to the HD registers of the kernel; hd == HD takes
// load_row's vectors.
template <int HD, typename T>
__device__ __forceinline__ void load_head(const T* __restrict__ p, int hd, float (&r)[HD]) {
    if (hd == HD) {
        load_row<HD>(p, r);
        return;
    }
#pragma unroll
    for (int d = 0; d < HD; ++d) r[d] = d < hd ? to_f(p[d]) : 0.f;
}

// p[d] = T(r[d] * s) for d < hd (store_row where hd == HD).
template <int HD, typename T>
__device__ __forceinline__ void store_head(T* __restrict__ p, int hd, const float (&r)[HD], float s) {
    if (hd == HD) {
        store_row<HD>(p, r, s);
        return;
    }
#pragma unroll
    for (int d = 0; d < HD; ++d)
        if (d < hd) p[d] = from_f<T>(r[d] * s);
}

// S[t * H HD + h HD + d] = float(x[t * ld + h hd + d]) for d < hd and 0 for
// hd <= d < HD: the T x D window x with each of its H heads padded to HD
// columns (stage_window where hd == HD).
template <typename T>
__device__ __forceinline__ void stage_heads(float* __restrict__ S, const T* __restrict__ x, int ld,
                                            int T_, int H, int hd, int HD) {
    if (hd == HD) {
        stage_window(S, x, ld, T_, H * hd);
        return;
    }
    const int DP = H * HD;
    for (int i = threadIdx.x; i < T_ * DP; i += blockDim.x) {
        const int t = i / DP, c = i - t * DP, h = c / HD, d = c - h * HD;
        S[i] = d < hd ? to_f(x[(size_t)t * ld + h * hd + d]) : 0.f;
    }
}

// sum_d a[d] * b[d], d in order
template <int HD>
__device__ __forceinline__ float dot_row(const float (&a)[HD], const float* __restrict__ b) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) s = fmaf(a[d], b[d], s);
    return s;
}

template <int HD>
__device__ __forceinline__ float dot_row(const float* __restrict__ b, const float (&a)[HD]) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) s = fmaf(b[d], a[d], s);
    return s;
}

// Threads per block: enough for one (head, row) item each at T x H items,
// up to the cap the kernel's registers allow.
inline int attention_threads(int items, int cap) {
    const int warps = (items + 31) / 32;
    const int t = 32 * warps;
    return t < cap ? t : cap;
}

// ---- bfloat16 tensor-core variants --------------------------------------

// Row stride (elements) of a staged bf16 window: D + 8 puts the 8 rows of
// a fragment load in 8 different banks.
__host__ __device__ inline int tc_stride(int D) { return D + 8; }

// S[r * ld + d] = x[r * ldx + d] for r < T, 0 for T <= r < rows (16-byte
// copies; D % 8 == 0, x's rows 16-byte aligned).
__device__ __forceinline__ void stage_window_bf16(
    __nv_bfloat16* __restrict__ S, int ld, const __nv_bfloat16* __restrict__ x, int ldx,
    int T_, int rows, int D) {
    const int vecs = D / 8;
    for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
        const int r = i / vecs, c = (i - r * vecs) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < T_) v = *reinterpret_cast<const uint4*>(x + (size_t)r * ldx + c);
        *reinterpret_cast<uint4*>(S + (size_t)r * ld + c) = v;
    }
}

// Two consecutive bf16 of a row, as one 32-bit fragment register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// p[0] and p[ld] (the same column of two consecutive rows) as one register.
__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* p, int ld) {
    return pack_bf16(p[0], p[ld]);
}

// The A fragment of the 16 x 16 tile at X (row stride ld): rows 16-aligned
// tile rows, columns 16 consecutive elements.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* X, int ld) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* x = X + g * ld + 2 * t;
    a[0] = ld_pair(x);
    a[1] = ld_pair(x + 8 * ld);
    a[2] = ld_pair(x + 8);
    a[3] = ld_pair(x + 8 * ld + 8);
}

// The B fragment (k 16 x n 8) of B[k][n] = Y[n][k]: Y's rows are the n
// columns (k contiguous along Y's rows).
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[2], const __nv_bfloat16* Y, int ld) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* y = Y + g * ld + 2 * t;
    b[0] = ld_pair(y);
    b[1] = ld_pair(y + 8);
}

// The B fragment (k 16 x n 8) of B[k][n] = Y[k][n]: Y's rows are the k
// rows.
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[2], const __nv_bfloat16* Y, int ld) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* y = Y + 2 * t * ld + g;
    b[0] = ld_col_pair(y, ld);
    b[1] = ld_col_pair(y + 8 * ld, ld);
}

// The A fragment of the 16 x 16 tile whose accumulators are c0 (columns
// 0-7) and c1 (columns 8-15): the C layout of two n-tiles is the A layout.
__device__ __forceinline__ void frag_a_from_acc(uint32_t (&a)[4], const float (&c0)[4],
                                                const float (&c1)[4]) {
    a[0] = pack_bf16(make_float2(c0[0], c0[1]));
    a[1] = pack_bf16(make_float2(c0[2], c0[3]));
    a[2] = pack_bf16(make_float2(c1[0], c1[1]));
    a[3] = pack_bf16(make_float2(c1[2], c1[3]));
}

// acc += X @ B for a float tile X in accumulator layout, split into a bf16
// head and a bf16 remainder so that the product keeps ~16 bits of X.
__device__ __forceinline__ void mma_split(float (&acc)[4], const float (&c0)[4],
                                          const float (&c1)[4], const uint32_t (&b)[2]) {
    float h0[4], h1[4], r0[4], r1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        h0[i] = rnd<__nv_bfloat16>(c0[i]);
        h1[i] = rnd<__nv_bfloat16>(c1[i]);
        r0[i] = c0[i] - h0[i];
        r1[i] = c1[i] - h1[i];
    }
    uint32_t a[4];
    frag_a_from_acc(a, h0, h1);
    mma_16816(acc, a, b);
    frag_a_from_acc(a, r0, r1);
    mma_16816(acc, a, b);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace mtt
