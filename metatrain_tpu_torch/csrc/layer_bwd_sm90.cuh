// Helpers of the Hopper K2 (fused_layer_bwd_sm90.cu), which alone includes
// this header: cp.async copies into a ring of staged weight tiles, ldmatrix
// fragment loads, and the block's 64 x 128 panel product on wgmma.
//
// Every dense product of the kernel is Y (64 x N) = A (64 x K) B (K x N)
// with A in bf16 in shared memory and B a weight matrix in global memory,
// taken in its (N, K) row-major layout (K-major, as wgmma takes B; the
// wrapper's transposed copies supply every product's). B reaches the
// tensor cores through the ring: a chunk is 128 rows (n) x 64 columns (k)
// of one weight, copied with cp.async while the chunks before it are
// multiplied, into the 128-byte-swizzled K-major layout that wgmma reads
// (row n's 16-byte piece j at n * 128 + ((j ^ n % 8) * 16)). The kernel's
// products consume one fixed sequence of chunks per atom (its Chunks), so
// the copies run ahead across the products and across the phases between
// them. The attention's products (in the source) stay on mma.sync
// m16n8k16 with ldmatrix fragments.

#pragma once

#include "common.cuh"

namespace mtt {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;      // 16 warps
constexpr int kRows = 64;          // one atom's window, padded to one 64-row tile
constexpr int kChunkN = 128;       // rows of a staged weight chunk (output columns)
constexpr int kChunkK = 64;        // columns of a chunk (the product's k): one 128-byte row
constexpr int kStages = 3;
constexpr int kChunkElems = kChunkN * kChunkK;  // 16 KB, 1024-byte aligned stages

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
}

// The A fragment of the 16 x 16 tile at (r0, c0) of a row-major bf16 matrix.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* X, int ld, int r0, int c0) {
    const int lane = threadIdx.x & 31;
    ldsm_x4(a, X + (size_t)(r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (b[0..1]: n0..n0+7, b[2..3]: n0+8..n0+15) of
// a 16-deep k step at k0, from a matrix stored (n, k) row-major.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* X, int ld, int n0, int k0) {
    const int lane = threadIdx.x & 31;
    ldsm_x4(b, X + (size_t)(n0 + ((lane >> 4) & 1) * 8 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// The same fragments from a matrix stored (k, n) row-major.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* X, int ld, int n0, int k0) {
    const int lane = threadIdx.x & 31;
    ldsm_x4_t(b, X + (size_t)(k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0 + ((lane >> 4) & 1) * 8);
}

__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
    const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
    mma_16816(c0, a, b0);
    mma_16816(c1, a, b1);
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The A fragment of a 16 x 16 tile held as two n8 accumulator tiles
// (c0: columns 0-7, c1: columns 8-15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
    a[0] = pack_bf16(make_float2(c0[0], c0[1]));
    a[1] = pack_bf16(make_float2(c0[2], c0[3]));
    a[2] = pack_bf16(make_float2(c1[0], c1[1]));
    a[3] = pack_bf16(make_float2(c1[2], c1[3]));
}

// The ring of staged weight chunks. Chunk c goes to stage c % kStages;
// chunks 0 .. kStages - 2 are issued up front, and consuming chunk c
// issues chunk c + kStages - 1 into the stage chunk c - 1 left, after the
// barrier that ends every warp's use of it. Every issue commits one
// cp.async group (empty past the last chunk), so wait_group<kStages - 2>
// at chunk c leaves only the later chunks in flight.
template <typename Src>
struct WeightRing {
    bf16* ring;
    Src src;   // src(c, &ld): the chunk's first element in global memory
    int count;

    __device__ void issue(int c) {
        if (c < count) {
            int ld;
            const bf16* g = src(c, ld);
            bf16* s = ring + (c % kStages) * kChunkElems;
            for (int p = threadIdx.x; p < kChunkN * kChunkK / 8; p += blockDim.x) {
                const int row = p >> 3, piece = p & 7;
                cp_async16(s + row * kChunkK + ((piece ^ (row & 7)) * 8), g + (size_t)row * ld + piece * 8);
            }
        }
        cp_async_commit();
    }

    __device__ void start() {
        for (int c = 0; c < kStages - 1; ++c) issue(c);
    }

    __device__ const bf16* consume(int c) {
        cp_async_wait<kStages - 2>();
        // the chunk was written through the generic proxy; wgmma reads it
        // through the async one
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        issue(c + kStages - 1);
        return ring + (c % kStages) * kChunkElems;
    }
};

// The wgmma descriptor of a K-major bf16 tile in the 128-byte swizzle:
// 8-row groups 1024 bytes apart (the leading offset is unused there).
__device__ __forceinline__ uint64_t desc_sw128(const bf16* p) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
           (1ull << 62);
}

__device__ __forceinline__ void acc_fence(float (&acc)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(acc[j][i])::"memory");
}

// acc += A B for one warpgroup: the 64 x 16 A tile in registers (each warp
// its 16 rows, the m16n8k16 fragment), B 16 (k) x 32 (n) by descriptor.
__device__ __forceinline__ void wgmma_m64n32k16(float (&acc)[4][4], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]), "+f"(acc[1][0]),
          "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]), "+f"(acc[2][0]), "+f"(acc[2][1]),
          "+f"(acc[2][2]), "+f"(acc[2][3]), "+f"(acc[3][0]), "+f"(acc[3][1]), "+f"(acc[3][2]),
          "+f"(acc[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// acc += A (64 x 64 NCH) B (64 NCH x 128) over the next NCH chunks of the
// ring, chunk index c advanced. Warpgroup w / 4 owns output columns 32 (w /
// 4) .. + 31 (one wgmma m64n32k16 per k step, B from the staged chunk),
// warp w its rows 16 (w % 4) .. + 15 (their A fragments from shared memory
// by ldmatrix): acc[j][i] is row 16 (w % 4) + lane / 4 + 8 (i / 2), column
// 32 (w / 4) + 8 j + 2 (lane % 4) + i % 2, as in mma.sync's C fragments.
// a_of(r, &ld) gives chunk r's 64 columns of A (row 0).
template <int NCH, typename Ring, typename AOf>
__device__ __forceinline__ void panel_mm(Ring& ring, int& c, AOf a_of, float (&acc)[4][4]) {
    const int warp = threadIdx.x >> 5;
    const int r0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
#pragma unroll 1
    for (int r = 0; r < NCH; ++r) {
        const bf16* B = ring.consume(c++);
        int lda;
        const bf16* A = a_of(r, lda);
        uint32_t a[kChunkK / 16][4];
#pragma unroll
        for (int ks = 0; ks < kChunkK / 16; ++ks) load_a(a[ks], A, lda, r0, 16 * ks);
        // the warpgroup's 32 rows of the chunk start on a 1024-byte boundary;
        // a k step of 16 advances 32 bytes inside the swizzled rows
        const uint64_t desc = desc_sw128(B + n0 * kChunkK);
        acc_fence(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < kChunkK / 16; ++ks) wgmma_m64n32k16(acc, a[ks], desc + 2 * ks);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        acc_fence(acc);
    }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// Calls f(j, i, m, n) for every element of a warp's panel tile.
template <typename F>
__device__ __forceinline__ void panel_each(F f) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int m0 = 16 * (warp & 3) + (lane >> 2), n0 = 32 * (warp >> 2) + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) f(j, i, m0 + 8 * (i >> 1), n0 + 8 * j + (i & 1));
}

// Calls f(j, h, m, n) for the pairs (i = 2h, 2h + 1) of a warp's panel tile:
// columns n and n + 1 of row m.
template <typename F>
__device__ __forceinline__ void panel_pairs(F f) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int m0 = 16 * (warp & 3) + (lane >> 2), n0 = 32 * (warp >> 2) + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) f(j, h, m0 + 8 * h, n0 + 8 * j);
}

// Per-row sums of a 64 x 128 panel: part(j, i, m, n) summed over each row's
// 128 columns (the 4 lanes of a quad, then the 4 warps of a row block, in
// a fixed order); red is 4 x 64 floats of shared memory. Returns, for the
// calling thread, the sums of its rows m0 (s[0]) and m0 + 8 (s[1]).
template <typename Part>
__device__ __forceinline__ void panel_row_sums(float* red, Part part, float (&s)[2]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float p[2] = {0.f, 0.f};
    panel_each([&](int j, int i, int m, int n) { p[i >> 1] += part(j, i, m, n); });
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        p[h] += __shfl_xor_sync(0xffffffffu, p[h], 1);
        p[h] += __shfl_xor_sync(0xffffffffu, p[h], 2);
    }
    const int m0 = 16 * (warp & 3) + (lane >> 2);
    if ((lane & 3) == 0) {
        red[(warp >> 2) * kRows + m0] = p[0];
        red[(warp >> 2) * kRows + m0 + 8] = p[1];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * h;
        s[h] = ((red[m] + red[kRows + m]) + red[2 * kRows + m]) + red[3 * kRows + m];
    }
    __syncthreads();
}

}  // namespace sm90
}  // namespace mtt
