// 3xTF32 on mma.sync for the Hopper float32 kernels, the Hopper float32 K1
// and K2 (fused_layer_{fwd,bwd}_f32_sm90.cu, through layer_f32_sm90.cuh) and
// the Hopper float32 K3 and K4 (rowblock_{fwd,bwd}_f32_sm90.cu, through
// rowblock_f32_sm90.cuh): the split of float operands into tf32 hi + lo and
// the three products, the ring of staged float weight chunks (128 rows x 16
// k, cp.async, swizzled), and the block's 64 x 128 panel product and its row
// and column sums (16 warps, the mma.sync C fragments' layout).
// fused_layer_bwd_f32_sm90.cu describes the design; an edit here changes all
// four kernels.

#pragma once

#include <type_traits>

#include "layer_sm90.cuh"

namespace mtt {
namespace tf32 {

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::kRows;
using sm90::kThreads;
using sm90::quad_sum;

constexpr int kCN = 128;  // rows of a staged chunk (output columns)
constexpr int kCK = 16;   // its columns (the product's k)
constexpr int kStages = 3;
constexpr int kChunk = kCN * kCK;
static_assert(kThreads == kCN * kCK / 4, "one 16-byte piece of a chunk per thread");

// ---- 3xTF32 ----------------------------------------------------------------

// cvt.rna.tf32.f32 in integer operations: half a tf32 ulp added, the low
// 13 bits cleared (to nearest, ties away from zero: the same bits). The
// conversion instruction issues at a fraction of the integer rate: on the
// H100 at the served shape it cost the Hopper float32 K2 3 ms of 20.
__device__ __forceinline__ uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = hi + lo to about 2^-22 of x
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in three TF32 products, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
    mma_tf32(c, al, bh[0], bh[1]);
    mma_tf32(c, ah, bl[0], bl[1]);
    mma_tf32(c, ah, bh[0], bh[1]);
}

// The split A fragment (m16n8k8: a0 row g col t, a1 row g + 8, a2 col t + 4,
// a3 both) of the 16 x 8 tile at X (row-major, ld).
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* X, int ld) {
    const int lane = threadIdx.x & 31;
    const float* x = X + (lane >> 2) * ld + (lane & 3);
    split(x[0], hi[0], lo[0]);
    split(x[8 * ld], hi[1], lo[1]);
    split(x[4], hi[2], lo[2]);
    split(x[8 * ld + 4], hi[3], lo[3]);
}

// The same fragment of xf(A): each element x of column k0 + k taken as
// xf(x, k0 + k).
template <typename XF>
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* X, int ld, XF xf,
                                       int k0) {
    const int lane = threadIdx.x & 31, t = lane & 3;
    const float* x = X + (lane >> 2) * ld + t;
    split(xf(x[0], k0 + t), hi[0], lo[0]);
    split(xf(x[8 * ld], k0 + t), hi[1], lo[1]);
    split(xf(x[4], k0 + t + 4), hi[2], lo[2]);
    split(xf(x[8 * ld + 4], k0 + t + 4), hi[3], lo[3]);
}

// A as it is.
struct NoMap {
    __device__ float operator()(float x, int) const { return x; }
};

// The split B fragment (b0 k = t, b1 k = t + 4; n = g) of the 8 x 8 tile
// whose n-th column is row n of Y (row-major, ld): Y holds B transposed.
__device__ __forceinline__ void load_b(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* Y, int ld) {
    const int lane = threadIdx.x & 31;
    const float* y = Y + (lane >> 2) * ld + (lane & 3);
    split(y[0], hi[0], lo[0]);
    split(y[4], hi[1], lo[1]);
}

// ---- the weight ring -------------------------------------------------------

// A chunk's element (n, k) lies at n * 16 + 4 ((k / 4) ^ (n / 2 % 4)) + k % 4:
// the 16-byte pieces of a row swizzled so that the 8 rows of a B fragment
// fall in 8 different bank quads.
__device__ __forceinline__ int swz(int n, int piece) { return n * kCK + ((piece ^ ((n >> 1) & 3)) << 2); }

// No rows ride in the ring's groups.
struct NoRows {
    __device__ void operator()(int) const {}
};

// Chunk c goes to stage c % 3; chunks 0 and 1 are issued up front, and
// consuming chunk c issues chunk c + 2 into the stage chunk c - 1 left,
// after the barrier that ends every warp's use of it. Every issue commits
// one cp.async group (empty past the last chunk). src(c, &ld) gives chunk
// c's first element and its row stride (a weight's (N, K) row-major
// layout); rows(c) may issue more cp.async copies into chunk c's group,
// which the ring's waits then complete by consume(c).
template <typename Src, typename Rows = NoRows>
struct Ring {
    float* ring;
    Src src;
    int count;
    Rows rows;

    __device__ void issue(int c) {
        rows(c);
        if (c < count) {
            int ld;
            const float* g = src(c, ld);
            const int row = threadIdx.x >> 2, piece = threadIdx.x & 3;
            cp_async16(ring + (c % kStages) * kChunk + swz(row, piece), g + (size_t)row * ld + 4 * piece);
        }
        cp_async_commit();
    }

    __device__ void start() {
        for (int c = 0; c < kStages - 1; ++c) issue(c);
    }

    __device__ const float* consume(int c) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        issue(c + kStages - 1);
        return ring + (c % kStages) * kChunk;
    }
};

// The panel layout of a 64 x 128 product: warp w computes rows 16 (w / 4)
// .. + 15 and columns 32 (w % 4) .. + 31, acc[j][i] its row 16 (w / 4) +
// lane / 4 + 8 (i / 2), column 32 (w % 4) + 8 j + 2 (lane % 4) + i % 2 (the
// mma.sync C fragments). The row block follows w / 4, so each of the SM's
// four schedulers (warps w % 4) holds one warp of every row block, and the
// padded rows of a window below 64 slots, whose warps skip their products,
// free all four alike.
__device__ __forceinline__ int panel_row0() { return 16 * (threadIdx.x >> 7); }
__device__ __forceinline__ int panel_col0() { return 32 * ((threadIdx.x >> 5) & 3); }

// Calls f(j, i, m, n) for every element of a warp's panel tile.
template <typename F>
__device__ __forceinline__ void panel_each(F f) {
    const int lane = threadIdx.x & 31;
    const int m0 = panel_row0() + (lane >> 2), n0 = panel_col0() + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) f(j, i, m0 + 8 * (i >> 1), n0 + 8 * j + (i & 1));
}

// Calls f(j, h, m, n) for the pairs (i = 2h, 2h + 1): columns n, n + 1 of row m.
template <typename F>
__device__ __forceinline__ void panel_pairs(F f) {
    const int lane = threadIdx.x & 31;
    const int m0 = panel_row0() + (lane >> 2), n0 = panel_col0() + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) f(j, h, m0 + 8 * h, n0 + 8 * j);
}

// Per-row sums of the panel: part(j, i, m, n) over each row's 128 columns
// (the 4 lanes of a quad, then the 4 warps of a row block, in a fixed
// order); red is 4 x 64 floats of shared memory. Returns the sums of the
// calling thread's rows m0 (s[0]) and m0 + 8 (s[1]).
template <typename Part>
__device__ __forceinline__ void panel_row_sums(float* red, Part part, float (&s)[2]) {
    const int lane = threadIdx.x & 31;
    float p[2] = {0.f, 0.f};
    panel_each([&](int j, int i, int m, int n) { p[i >> 1] += part(j, i, m, n); });
#pragma unroll
    for (int h = 0; h < 2; ++h) p[h] = quad_sum(p[h]);
    const int m0 = panel_row0() + (lane >> 2), cg = (threadIdx.x >> 5) & 3;
    if ((lane & 3) == 0) {
        red[cg * kRows + m0] = p[0];
        red[cg * kRows + m0 + 8] = p[1];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * h;
        s[h] = ((red[m] + red[kRows + m]) + red[2 * kRows + m]) + red[3 * kRows + m];
    }
    __syncthreads();
}

// acc += A (64 x 16 NCH) B (16 NCH x 128) over the ring's next NCH chunks, c
// advanced, in the panel layout (rows from M on: no products, acc as it
// was). a_of(r, &ld) gives chunk r's 16 columns of A (row 0, float, shared
// memory); xf (the element x of A's column k as xf(x, k)) maps them as they
// load. Each chunk's six products start from zero and are then added to
// acc: the tensor cores' float sums drop low bits where a rounded add keeps
// them, so they sum 16 k at a time (5 x less error at the served shape
// than accumulating all of K in them).
template <int NCH, typename R, typename AOf, typename XF = NoMap>
__device__ __forceinline__ void panel_mm(R& ring, int& c, AOf a_of, float (&acc)[4][4], int M, XF xf = {}) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r0 = panel_row0(), n0 = panel_col0() + g;
    if (r0 >= M) {  // padded rows: the ring's barriers only
        for (int r = 0; r < NCH; ++r) ring.consume(c++);
        return;
    }
#pragma unroll 1
    for (int r = 0; r < NCH; ++r) {
        const float* B = ring.consume(c++);
        float part[4][4] = {};
        int lda;
        const float* A = a_of(r, lda);
        A += (size_t)r0 * lda;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
            uint32_t ah[4], al[4];
            if constexpr (std::is_same_v<XF, NoMap>)
                load_a(ah, al, A + 8 * ks, lda);
            else
                load_a(ah, al, A + 8 * ks, lda, xf, r * kCK + 8 * ks);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int n = n0 + 8 * j;
                uint32_t bh[2], bl[2];
                split(B[swz(n, 2 * ks) + t], bh[0], bl[0]);
                split(B[swz(n, 2 * ks + 1) + t], bh[1], bl[1]);
                mma3(part[j], ah, al, bh, bl);
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
    }
}

// Column sums of a 64 x 128 panel: part(j, i, m, n) summed over the rows of
// each column (the two rows of a thread, the 8 lanes of a column, then the
// 4 row groups, in a fixed order) into out[n]; red: 4 x 128 floats of
// shared memory. Ends with a barrier.
template <typename Part>
__device__ __forceinline__ void panel_col_sums(float* red, Part part, float* out) {
    const int lane = threadIdx.x & 31;
    const int m0 = panel_row0() + (lane >> 2), n0 = panel_col0() + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            float v = part(j, u, m0, n0 + 8 * j + u) + part(j, u + 2, m0 + 8, n0 + 8 * j + u);
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (lane < 4) red[(threadIdx.x >> 7) * kCN + n0 + 8 * j + u] = v;
        }
    __syncthreads();
    for (int n = threadIdx.x; n < kCN; n += kThreads)
        out[n] = ((red[n] + red[kCN + n]) + red[2 * kCN + n]) + red[3 * kCN + n];
    __syncthreads();
}

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

__device__ __forceinline__ void st2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

}  // namespace tf32
}  // namespace mtt
