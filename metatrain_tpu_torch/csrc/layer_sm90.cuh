// Helpers of the Hopper K1 (fused_layer_fwd_sm90.cu) and the Hopper K2
// (fused_layer_bwd_sm90.cu), and of the Hopper absmax pass
// (int8_absmax_sm90.cu: K1's RMSNorm and q and k panels, no ring):
// cp.async copies into a ring of staged weight tiles, ldmatrix fragment
// loads, the block's 64 x 128 panel product on wgmma, and the layer's
// forward up to h_norm (the phases at the end), which K1 runs as its first
// half and K2 as its recompute: the same device code, so the two kernels
// compute q|k|v, attn, res and h_norm to the same bits. Their int8-score
// mode (K1-int8, K2-int8: the kernels' mode kInt8, attention_fwd's I8 flag)
// quantizes q and k once per atom into an int8 copy and forms the scores
// on int8 tensor cores. Their W8A8 mode (K1-W8A8, K2-W8A8) runs QKV and
// FFN-in (K1: FFN-out too) as s8 wgmma on int8 operand tiles and int8
// weight chunks (the W8A8 section below) and the scores as the int8 mode
// does.
//
// Every dense product of the kernels is, per atom, Y (64 x N) = A (64 x K)
// B (K x N) with A in bf16 in shared memory and B a weight matrix in global
// memory,
// taken in its (N, K) row-major layout (K-major, as wgmma takes B; the
// wrapper's transposed copies supply every product's). B reaches the
// tensor cores through the ring: a chunk is 128 rows (n) x 64 columns (k)
// of one weight, copied with cp.async while the chunks before it are
// multiplied, into the 128-byte-swizzled K-major layout that wgmma reads
// (row n's 16-byte piece j at n * 128 + ((j ^ n % 8) * 16)). A kernel's
// products consume one fixed sequence of chunks per block (its Chunks; a
// block of two atoms multiplies both by each chunk), so the copies run
// ahead across the products and across the phases between them. The attention's products stay on mma.sync m16n8k16 with ldmatrix
// fragments.

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

// The one layer width the kernels take: D = 128 in 8 heads of 16.
constexpr int D = 128, HD = 16, H = 8;
constexpr int LQ = 3 * D + 8;  // q|k|v row (bf16)
constexpr int LA = D + 8;      // 64 x 128 bf16 operand rows

// The kernels' modes: exact, the dynamic int8 scores (K1-int8, K2-int8) and
// the static W8A8 layer (K1-W8A8, K2-W8A8).
enum Mode : int { kExact = 0, kInt8 = 1, kW8A8 = 2 };

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

template <int N8>
__device__ __forceinline__ void acc_fence(float (&acc)[N8][4]) {
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(acc[j][i])::"memory");
}

template <int N8>
__device__ __forceinline__ void acc_fence(int (&acc)[N8][4]) {
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(acc[j][i])::"memory");
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

// The same with B 16 (k) x 64 (n): acc[j] holds columns 8 j .. 8 j + 7.
__device__ __forceinline__ void wgmma_m64n64k16(float (&acc)[8][4], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
        "{%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]), "+f"(acc[1][0]),
          "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]), "+f"(acc[2][0]), "+f"(acc[2][1]),
          "+f"(acc[2][2]), "+f"(acc[2][3]), "+f"(acc[3][0]), "+f"(acc[3][1]), "+f"(acc[3][2]),
          "+f"(acc[3][3]), "+f"(acc[4][0]), "+f"(acc[4][1]), "+f"(acc[4][2]), "+f"(acc[4][3]),
          "+f"(acc[5][0]), "+f"(acc[5][1]), "+f"(acc[5][2]), "+f"(acc[5][3]), "+f"(acc[6][0]),
          "+f"(acc[6][1]), "+f"(acc[6][2]), "+f"(acc[6][3]), "+f"(acc[7][0]), "+f"(acc[7][1]),
          "+f"(acc[7][2]), "+f"(acc[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

__device__ __forceinline__ void wgmma_k16(float (&acc)[4][4], const uint32_t (&a)[4], uint64_t desc) {
    wgmma_m64n32k16(acc, a, desc);
}

__device__ __forceinline__ void wgmma_k16(float (&acc)[8][4], const uint32_t (&a)[4], uint64_t desc) {
    wgmma_m64n64k16(acc, a, desc);
}

// The panel layout of a block of one or of two atoms. With one atom (N8 =
// 4) warpgroup w / 4 owns columns 32 (w / 4) .. + 31 of the atom's 64 x 128
// panel; with two (N8 = 8: atom 0 in warps 0-7, atom 1 in warps 8-15) it
// owns columns 64 (w / 4 % 2) .. + 63 of its atom's. Warp w computes rows
// 16 (w % 4) .. + 15 of its warpgroup's tile: acc[j][i] is row 16 (w % 4)
// + lane / 4 + 8 (i / 2), column n0 + 8 j + 2 (lane % 4) + i % 2, as in
// mma.sync's C fragments.
template <int N8>
__device__ __forceinline__ int panel_col0() {
    static_assert(N8 == 4 || N8 == 8, "one atom (n32 per warpgroup) or two (n64)");
    const int wg = threadIdx.x >> 7;
    return N8 == 4 ? 32 * wg : 64 * (wg & 1);
}

// The calling thread's atom in a block of N8 / 4 atoms.
template <int N8>
__device__ __forceinline__ int panel_atom() {
    return N8 == 4 ? 0 : threadIdx.x >> 8;
}

// acc += A (64 x 64 NCH) B (64 NCH x 128) over the next NCH chunks of the
// ring, chunk index c advanced, in the panel layout of panel_col0 (one
// wgmma m64n32k16 or m64n64k16 per k step, B from the staged chunk; each
// warp's rows of A from shared memory by ldmatrix). a_of(r, &ld) gives
// chunk r's 64 columns of the calling thread's atom's A (row 0).
template <int NCH, typename Ring, typename AOf, int N8>
__device__ __forceinline__ void panel_mm(Ring& ring, int& c, AOf a_of, float (&acc)[N8][4]) {
    const int warp = threadIdx.x >> 5;
    const int r0 = 16 * (warp & 3), n0 = panel_col0<N8>();
#pragma unroll 1
    for (int r = 0; r < NCH; ++r) {
        const bf16* B = ring.consume(c++);
        int lda;
        const bf16* A = a_of(r, lda);
        uint32_t a[kChunkK / 16][4];
#pragma unroll
        for (int ks = 0; ks < kChunkK / 16; ++ks) load_a(a[ks], A, lda, r0, 16 * ks);
        // the warpgroup's rows of the chunk start on a 1024-byte boundary;
        // a k step of 16 advances 32 bytes inside the swizzled rows
        const uint64_t desc = desc_sw128(B + n0 * kChunkK);
        acc_fence(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < kChunkK / 16; ++ks) wgmma_k16(acc, a[ks], desc + 2 * ks);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        acc_fence(acc);
    }
}

template <int N8, typename T>
__device__ __forceinline__ void zero(T (&acc)[N8][4]) {
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0;
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

// Calls f(j, h, m, n) for the pairs (i = 2h, 2h + 1) of a warp's panel tile
// (N8 / 4 atoms per block): columns n and n + 1 of row m of its atom.
template <int N8 = 4, typename F>
__device__ __forceinline__ void panel_pairs(F f) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int m0 = 16 * (warp & 3) + (lane >> 2), n0 = panel_col0<N8>() + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < N8; ++j)
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

__device__ __forceinline__ float2 ld2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Row q's scores against the atom's keys for one head: s[j] holds keys 8 j
// + 2 (lane % 4) (+1) of rows lane / 4 and lane / 4 + 8 of the query tile
// whose A fragment is qa; key tiles from M on are left unset.
__device__ __forceinline__ void head_scores(float (&s)[8][4], const uint32_t (&qa)[4], const bf16* K, int M) {
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
        if (16 * kp < M) {
            uint32_t b[4];
            load_b_nk(b, K, LQ, 16 * kp, 0);
#pragma unroll
            for (int i = 0; i < 4; ++i) s[2 * kp][i] = s[2 * kp + 1][i] = 0.f;
            mma_pair(s[2 * kp], s[2 * kp + 1], qa, b);
        }
    }
}

// ---- the dynamic int8 scores (K1-int8, K2-int8) --------------------------
// Once q|k|v is in shared memory, all threads quantize the atom's q and k
// into an int8 copy (Q8: rows of LQ8 bytes, q then k), x / s rounded once
// to float, then to the nearest integer (ties to even) and clamped to +-127
// (quant_s8<true>, the plain version's quantize_i8). The score products
// read their fragments from it: mma.sync m16n8k16 .s8, where lane l holds
// columns 4 (l % 4) .. + 3 of row l / 4 (A: and of row l / 4 + 8; B: of
// key row l / 4), one 32-bit load each; the C fragment is the bf16 one's.
// The int32 sums are exact, so a product of the same rows gives the same
// score wherever it is formed.

constexpr int LQ8 = 2 * D + 16;  // int8 q|k row: 68 words, a fragment's 8 rows in distinct banks

// x[0..3] (bf16, 8-byte aligned) quantized by the scale s and packed
__device__ __forceinline__ uint32_t quant4_bf16(const bf16* x, float s) {
    const uint2 u = *reinterpret_cast<const uint2*>(x);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return quant4_s8<true>(make_float4(lo.x, lo.y, hi.x, hi.y), s);
}

// Q8 = q and k of rows m < M quantized by the atom's scales (the caller
// puts a barrier between this and the reads).
__device__ __forceinline__ void quantize_qk(const bf16* QKV, int8_t* Q8, int M, const ScoresI8& i8) {
    constexpr int kQuads = 2 * D / 4;
    for (int p = threadIdx.x; p < M * kQuads; p += kThreads) {
        const int m = p / kQuads, c = 4 * (p % kQuads);
        *reinterpret_cast<uint32_t*>(Q8 + m * LQ8 + c) = quant4_bf16(QKV + m * LQ + c, c < D ? i8.s_q : i8.s_k);
    }
}

// The int8 A fragment of the 16 x 16 tile at (r0, c0) of Q8.
__device__ __forceinline__ void load_a_s8(uint32_t (&a)[2], const int8_t* Q8, int r0, int c0) {
    const int lane = threadIdx.x & 31;
    const int8_t* x = Q8 + (r0 + (lane >> 2)) * LQ8 + c0 + 4 * (lane & 3);
    a[0] = *reinterpret_cast<const uint32_t*>(x);
    a[1] = *reinterpret_cast<const uint32_t*>(x + 8 * LQ8);
}

// One head's int8 scores of the 16 rows of qa against rows n0 .. n0 + 7 of
// Y (the head's columns of Q8; a 16-deep B fragment), each int32 sum times
// factor rounded once to float.
__device__ __forceinline__ void scores_s8_tile(float (&s)[4], const uint32_t (&qa)[2], const int8_t* Y, int n0,
                                               float factor) {
    const int lane = threadIdx.x & 31;
    int c[4] = {0, 0, 0, 0};
    mma_s8_16816(c, qa, *reinterpret_cast<const uint32_t*>(Y + (n0 + (lane >> 2)) * LQ8 + 4 * (lane & 3)));
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = __fmul_rn((float)c[i], factor);
}

// head_scores with the int8 scores: query rows q0 .. q0 + 15 of head h
// against its keys, from Q8, the attention scale in factor.
__device__ __forceinline__ void head_scores_i8(float (&s)[8][4], const int8_t* Q8, int h, int q0, int M,
                                               float factor) {
    uint32_t qa[2];
    load_a_s8(qa, Q8, q0, h * HD);
#pragma unroll
    for (int j = 0; j < 8; ++j)
        if (8 * j < M) scores_s8_tile(s[j], qa, Q8 + D + h * HD, 8 * j, factor);
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ---- the layer's forward up to h_norm (K1, and K2's recompute) -----------
// Each phase ends with its own stores; the caller puts the barriers between
// them. Rows of a 64-row buffer from M on are never written here: the
// products carry them along, and nothing reads them into a row below M.

// y = x r w (float) for rows m < M, r = rsqrt(mean(x^2) + eps), one warp
// per row: x = src(m) (D bf16), r to RS[m]; put(m, y) takes the lane's
// columns 4 lane .. + 3; then extra(m) on the same warp.
template <typename Src, typename Put, typename Extra>
__device__ __forceinline__ void rms_rows_each(Src src, const bf16* w, float* RS, int M, float eps, Put put,
                                              Extra extra) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int m = warp; m < M; m += kThreads / 32) {
        const bf16* x = src(m) + 4 * lane;
        const float2 x0 = ld2(x), x1 = ld2(x + 2);
        const float r = rsqrtf(warp_sum(x0.x * x0.x + x0.y * x0.y + x1.x * x1.x + x1.y * x1.y) / D + eps);
        if (lane == 0) RS[m] = r;
        const float2 w0 = ld2(w + 4 * lane), w1 = ld2(w + 4 * lane + 2);
        put(m, make_float4(x0.x * r * w0.x, x0.y * r * w0.y, x1.x * r * w1.x, x1.y * r * w1.y));
        extra(m);
    }
}

// Y = rnd(x r w) (rows of LA)
template <typename Src, typename Extra>
__device__ __forceinline__ void rms_rows(Src src, const bf16* w, float* RS, bf16* Y, int M, float eps,
                                         Extra extra) {
    const int lane = threadIdx.x & 31;
    rms_rows_each(src, w, RS, M, eps, [&](int m, float4 y4) {
        bf16* y = Y + m * LA + 4 * lane;
        store2(y, y4.x, y4.y);
        store2(y + 2, y4.z, y4.w);
    }, extra);
}

// Panel pn of q|k|v (columns 128 pn .. + 127: q, k or v) over the ring's
// next 2 chunks (w_qkv^T rows 128 pn .. + 127, two k halves), N1 the calling
// thread's atom's n1: put(m, col, y0, y1) takes columns col and col + 1 of
// row m as n1 w_qkv + b in float, the bias added after the sum. K1, K2 and
// the Hopper absmax pass (int8_absmax_sm90.cu) all form q and k here.
template <int N8, typename Ring, typename Put>
__device__ __forceinline__ void qkv_panel(Ring& ring, int& c, const bf16* N1, int pn, const bf16* b_qkv,
                                          Put put) {
    float acc[N8][4];
    zero(acc);
    panel_mm<2>(ring, c, [&](int r, int& ld) { ld = LA; return N1 + r * kChunkK; }, acc);
    panel_pairs<N8>([&](int j, int h, int m, int n) {
        const int col = pn * kChunkN + n;
        const float2 b = ld2(b_qkv + col);
        put(m, col, acc[j][2 * h] + b.x, acc[j][2 * h + 1] + b.y);
    });
}

// q|k|v = rnd(n1 w_qkv + b): three panels over the ring's next 6 chunks.
// With two atoms per block (N8 = 8), atom 1's n1 and q|k|v lie `stride`
// elements after atom 0's.
template <int N8 = 4, typename Ring>
__device__ __forceinline__ void qkv_panels(Ring& ring, int& c, const bf16* N1, bf16* QKV, const bf16* b_qkv,
                                           size_t stride = 0) {
    N1 += panel_atom<N8>() * stride;
    QKV += panel_atom<N8>() * stride;
    for (int pn = 0; pn < 3; ++pn)
        qkv_panel<N8>(ring, c, N1, pn, b_qkv,
                      [&](int m, int col, float y0, float y1) { store2(QKV + m * LQ + col, y0, y1); });
}

// attn = rnd(P v) with P = cf e / z rounded to bf16, e = exp(s - max), z =
// sum_k cf e: one warp per (head, 16-row query tile), all heads at once.
// stats(h, row, mx, z) takes the rows' max and sum (rows row and row + 8)
// from the quad's first lane.
//
// I8: the dynamic int8 scores (from Q8, quantize_qk's, times factor) and
// the rounded softmax of the JAX package's _qside_tail: ecf = rnd(cf e) in
// bf16, z = sum_k ecf, attn = rnd((ecf v) / z), the AV product on ecf
// itself.
template <bool I8 = false, typename Stats>
__device__ __forceinline__ void attention_fwd(const bf16* QKV, bf16* O, const float* CF, int M, float scale,
                                              Stats stats, const int8_t* Q8 = nullptr, float factor = 0.f) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int QT = M / 16;
    for (int task = warp; task < H * QT; task += kThreads / 32) {
        const int h = task / QT, q0 = 16 * (task % QT);
        float s[8][4];
        if constexpr (I8) {
            head_scores_i8(s, Q8, h, q0, M, factor);
        } else {
            uint32_t qa[4];
            load_a(qa, QKV, LQ, q0, h * HD);
            head_scores(s, qa, QKV + D + h * HD, M);
        }
        float mx[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (8 * j < M)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    if constexpr (!I8) s[j][i] *= scale;
                    mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
                }
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (8 * j < M)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float cf = CF[8 * j + 2 * t + (i & 1)];
                    s[j][i] = expf(s[j][i] - mx[i >> 1]);
                    if constexpr (I8) {
                        s[j][i] = rnd<bf16>(cf * s[j][i]);  // ecf
                        z[i >> 1] += s[j][i];
                    } else {
                        z[i >> 1] = fmaf(cf, s[j][i], z[i >> 1]);
                    }
                }
        z[0] = quad_sum(z[0]);
        z[1] = quad_sum(z[1]);
        if (t == 0) stats(h, q0 + g, mx, z);
        float o[2][4] = {};
#pragma unroll
        for (int kp = 0; kp < 4; ++kp) {
            if (16 * kp < M) {
                float p0[4], p1[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int k = 16 * kp + 2 * t + (i & 1);
                    p0[i] = I8 ? s[2 * kp][i] : CF[k] * (s[2 * kp][i] / z[i >> 1]);
                    p1[i] = I8 ? s[2 * kp + 1][i] : CF[k + 8] * (s[2 * kp + 1][i] / z[i >> 1]);
                }
                uint32_t pa[4], b[4];
                acc_to_a(pa, p0, p1);
                load_b_kn(b, QKV + 2 * D + h * HD, LQ, 0, 16 * kp);
                mma_pair(o[0], o[1], pa, b);
            }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            if constexpr (I8) {
#pragma unroll
                for (int i = 0; i < 4; ++i) o[nt][i] /= z[i >> 1];
            }
            bf16* y = O + (q0 + g) * LA + h * HD + 8 * nt + 2 * t;
            store2(y, o[nt][0], o[nt][1]);
            store2(y + 8 * LA, o[nt][2], o[nt][3]);
        }
    }
}

// res = rnd(x + rnd(attn w_out + b)) for rows m < M (x = token(m) of the
// calling thread's atom), over the ring's next 2 chunks (w_out^T); center(m,
// n, o0, o1) takes the rounded out-projection of columns n, n + 1 of each
// such row. With two atoms per block, atom 1's attn and res lie `stride`
// elements after atom 0's.
template <int N8 = 4, typename Ring, typename Token, typename Center>
__device__ __forceinline__ void out_proj_res(Ring& ring, int& c, const bf16* ATT, bf16* RES, Token token,
                                             const bf16* b_out, int M, Center center, size_t stride = 0) {
    ATT += panel_atom<N8>() * stride;
    RES += panel_atom<N8>() * stride;
    float acc[N8][4];
    zero(acc);
    panel_mm<2>(ring, c, [&](int r, int& ld) { ld = LA; return ATT + r * kChunkK; }, acc);
    panel_pairs<N8>([&](int j, int h, int m, int n) {
        if (m >= M) return;
        const float2 x = ld2(token(m) + n), b = ld2(b_out + n);
        const float o0 = rnd<bf16>(acc[j][2 * h] + b.x), o1 = rnd<bf16>(acc[j][2 * h + 1] + b.y);
        store2(RES + m * LA + n, x.x + o0, x.y + o1);
        center(m, n, o0, o1);
    });
}


// ---- the static W8A8 layer (K1-W8A8, K2-W8A8) ---------------------------
// The plain version's quantizers and int8 products (fused_layer.py
// rms_norm_q, qs_static, dot_i8): an activation quantizes from its float,
// clamp(rint(x * inv), +-127) with the static inverse scale (quant_s8), and
// an int8 product dequantizes its exact int32 sum as (acc * deq) + b, two
// roundings (dequant). The int8 operand tiles (n1, h_norm, K1's ffn_h) are
// 64 rows of LA8 bytes; the weight chunks of an int8 product are 128 rows
// (n) x 128 k bytes: the same 16 KB stage and the same 128-byte swizzle as
// a bf16 chunk of 64 k, so a k32 step of s8 wgmma advances the same 32
// bytes as a k16 step of bf16. wgmma takes 8-bit A and B K-major only: the
// chunks are (N, K) rows and the operand tiles row-major, both K-major.

constexpr int LA8 = D + 16;    // int8 operand rows: 36 words, a fragment's 8 rows in distinct banks
constexpr int kChunkK8 = 128;  // k of an int8 chunk (its 128-byte rows)

// An int8 chunk's first element and row stride as the ring copies them:
// bf16 units of 2 bytes (16-byte pieces either way).
__device__ __forceinline__ const bf16* chunk8(const int8_t* p, int ld_bytes, int& ld) {
    ld = ld_bytes / 2;
    return reinterpret_cast<const bf16*>(p);
}

// The int8 A fragment of the 16 x 32 tile at (r0, c0) of a row-major int8
// matrix (rows of ld bytes), as wgmma k32 and mma.sync m16n8k32 take it:
// lane l holds bytes 4 (l % 4) .. + 3 of rows l / 4 (a[0], a[2]: + 16) and
// l / 4 + 8 (a[1], a[3]).
__device__ __forceinline__ void load_a_s8_k32(uint32_t (&a)[4], const int8_t* X, int ld, int r0, int c0) {
    const int lane = threadIdx.x & 31;
    const int8_t* x = X + (r0 + (lane >> 2)) * ld + c0 + 4 * (lane & 3);
    a[0] = *reinterpret_cast<const uint32_t*>(x);
    a[1] = *reinterpret_cast<const uint32_t*>(x + 8 * ld);
    a[2] = *reinterpret_cast<const uint32_t*>(x + 16);
    a[3] = *reinterpret_cast<const uint32_t*>(x + 8 * ld + 16);
}

// acc += A B for one warpgroup in int32: the 64 x 32 int8 A tile in
// registers (each warp its 16 rows), B 32 (k) x 32 (n) int8 by descriptor.
__device__ __forceinline__ void wgmma_m64n32k32_s8(int (&acc)[4][4], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p;\n}\n"
        : "+r"(acc[0][0]), "+r"(acc[0][1]), "+r"(acc[0][2]), "+r"(acc[0][3]), "+r"(acc[1][0]),
          "+r"(acc[1][1]), "+r"(acc[1][2]), "+r"(acc[1][3]), "+r"(acc[2][0]), "+r"(acc[2][1]),
          "+r"(acc[2][2]), "+r"(acc[2][3]), "+r"(acc[3][0]), "+r"(acc[3][1]), "+r"(acc[3][2]),
          "+r"(acc[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// The same with B 32 (k) x 64 (n): acc[j] holds columns 8 j .. 8 j + 7.
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&acc)[8][4], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
        "{%32,%33,%34,%35}, %36, p;\n}\n"
        : "+r"(acc[0][0]), "+r"(acc[0][1]), "+r"(acc[0][2]), "+r"(acc[0][3]), "+r"(acc[1][0]),
          "+r"(acc[1][1]), "+r"(acc[1][2]), "+r"(acc[1][3]), "+r"(acc[2][0]), "+r"(acc[2][1]),
          "+r"(acc[2][2]), "+r"(acc[2][3]), "+r"(acc[3][0]), "+r"(acc[3][1]), "+r"(acc[3][2]),
          "+r"(acc[3][3]), "+r"(acc[4][0]), "+r"(acc[4][1]), "+r"(acc[4][2]), "+r"(acc[4][3]),
          "+r"(acc[5][0]), "+r"(acc[5][1]), "+r"(acc[5][2]), "+r"(acc[5][3]), "+r"(acc[6][0]),
          "+r"(acc[6][1]), "+r"(acc[6][2]), "+r"(acc[6][3]), "+r"(acc[7][0]), "+r"(acc[7][1]),
          "+r"(acc[7][2]), "+r"(acc[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

__device__ __forceinline__ void wgmma_k32(int (&acc)[4][4], const uint32_t (&a)[4], uint64_t desc) {
    wgmma_m64n32k32_s8(acc, a, desc);
}

__device__ __forceinline__ void wgmma_k32(int (&acc)[8][4], const uint32_t (&a)[4], uint64_t desc) {
    wgmma_m64n64k32_s8(acc, a, desc);
}

// panel_mm over int8: acc += A (64 x 128 NCH, int8) B over the next NCH int8
// chunks of the ring, the int32 sums exact (|acc| <= K 127^2 < 2^24 for the
// widths taken, so their conversion to float is too). a_of(r, &ld) gives
// chunk r's 128 columns of the calling thread's atom's A (rows of ld bytes).
template <int NCH, typename Ring, typename AOf, int N8>
__device__ __forceinline__ void panel_mm_s8(Ring& ring, int& c, AOf a_of, int (&acc)[N8][4]) {
    const int warp = threadIdx.x >> 5;
    const int r0 = 16 * (warp & 3), n0 = panel_col0<N8>();
#pragma unroll 1
    for (int r = 0; r < NCH; ++r) {
        const bf16* B = ring.consume(c++);
        int lda;
        const int8_t* A = a_of(r, lda);
        uint32_t a[kChunkK8 / 32][4];
#pragma unroll
        for (int ks = 0; ks < kChunkK8 / 32; ++ks) load_a_s8_k32(a[ks], A, lda, r0, 32 * ks);
        const uint64_t desc = desc_sw128(B + n0 * kChunkK);
        acc_fence(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < kChunkK8 / 32; ++ks) wgmma_k32(acc, a[ks], desc + 2 * ks);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        acc_fence(acc);
    }
}

// Y8 = clamp(rint((x r w) inv), +-127) for rows m < M (rms_norm_q), rows of
// LA8 bytes: the float quantized without a rounding to bf16 first.
template <typename Src, typename Extra>
__device__ __forceinline__ void rms_rows_s8(Src src, const bf16* w, float* RS, int8_t* Y8, int M, float eps,
                                            float inv, Extra extra) {
    const int lane = threadIdx.x & 31;
    rms_rows_each(src, w, RS, M, eps, [&](int m, float4 y4) {
        *reinterpret_cast<uint32_t*>(Y8 + m * LA8 + 4 * lane) = quant4_s8(y4, inv);
    }, extra);
}

// W8A8 q|k|v: per panel p (q, k, v) over the ring's next int8 chunk (w_qkv^T
// rows 128 p .. + 127, int8), x_f = (acc deq_p) + b in float (dot_i8);
// q|k|v = rnd(x_f) (v the AV operand, q and k K2-W8A8's straight-through
// operands), and q and k quantized from x_f with inv_q / inv_k into Q8
// (quantize_qk's layout). With two atoms per block (N8 = 8), atom 1's n1,
// q|k|v and Q8 lie stride_n1 bytes, stride elements and stride_q8 bytes
// after atom 0's.
template <int N8 = 4, typename Ring>
__device__ __forceinline__ void qkv_panels_s8(Ring& ring, int& c, const int8_t* N1, bf16* QKV,
                                              int8_t* Q8, const bf16* b_qkv, const LayerI8& s8,
                                              size_t stride = 0, size_t stride_n1 = 0,
                                              size_t stride_q8 = 0) {
    N1 += panel_atom<N8>() * stride_n1;
    QKV += panel_atom<N8>() * stride;
    Q8 += panel_atom<N8>() * stride_q8;
    for (int pn = 0; pn < 3; ++pn) {
        int acc[N8][4];
        zero(acc);
        panel_mm_s8<1>(ring, c, [&](int, int& ld) { ld = LA8; return N1; }, acc);
        const float deq = pn == 0 ? s8.deq_q : pn == 1 ? s8.deq_k : s8.deq_v;
        const float inv = pn == 0 ? s8.inv_q : s8.inv_k;
        panel_pairs<N8>([&](int j, int h, int m, int n) {
            const int col = pn * kChunkN + n;
            const float2 b = ld2(b_qkv + col);
            const float x0 = dequant(acc[j][2 * h], deq, b.x), x1 = dequant(acc[j][2 * h + 1], deq, b.y);
            store2(QKV + m * LQ + col, x0, x1);
            if (pn < 2)
                *reinterpret_cast<uint16_t*>(Q8 + m * LQ8 + col) =
                    (uint16_t)(quant_s8(x0, inv) | quant_s8(x1, inv) << 8);
        });
    }
}

}  // namespace sm90
}  // namespace mtt
