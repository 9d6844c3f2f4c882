// K2-dW's plan and its second pass (fused_layer_bwd_dw_sm90.cu describes
// the design): the weight gradients dW = X^T dY of one chunk of spilled
// rows as a deterministic split-K product, the per-atom vector rows summed
// the same way, and the sum of the slices' partials. The float32 K4-dW
// (rowblock_bwd_f32_sm90.cu) runs the same second pass on its own products
// (each product's shape in tiles comes from its arguments) and its per-tile
// vector rows.
//
// The plan (mirrored by _lib.k2dw_plan): atoms in chunks whose spill (the
// operand rows in T, then one float row of vector sums per atom) stays
// under kSpillCap bytes, a multiple of the SM count where there is more
// than one chunk (whole waves of pass 1); each chunk's rows cut into slices of `step` rows
// (a multiple of 64). Block (tile, slice) writes the float partial of one
// 128 x 128 output tile over one slice; a last pass adds the slices in
// order and the chunks in order. Both orders depend only on the shape and
// the SM count, so two launches give the same bits.

#pragma once

#include "layer_bwd.cuh"
#include "layer_sm90.cuh"

namespace mtt {
namespace dwp {
namespace {  // each translation unit that includes this header has its own copy

using sm90::bf16;

constexpr long long kSpillCap = 512LL << 20;  // bytes of spill per chunk, at most
constexpr int kTile = 128;                    // output tiles: 128 x 128
constexpr int kThreads = 256;
constexpr int kStepRows = 64;                 // a slice is a multiple of this many rows
constexpr int kMinSliceRows = 256;

// The output tiles of the four products: w_qkv (D x 3D), w_out (D x D),
// w_in (D x 2F), w_ffn_out (F x D), each in 128 x 128 tiles, row-major.
__host__ __device__ inline int product_tiles(int D, int F) {
    const int nD = D / kTile;
    return nD * (3 * nD) + nD * nD + nD * (2 * F / kTile) + (F / kTile) * nD;
}

struct Plan {
    long long chunk_atoms;  // atoms per chunk (the last one may hold fewer)
    long long chunks;
    long long vec_offset;   // bytes: the vector rows start here in the spill
    long long spill_bytes;  // the whole spill of one chunk
    long long max_slices;   // partials to allocate: slices of a chunk, at most
};

// The slices of a chunk of R rows: as many as fill two blocks per SM in one
// wave (2 SMs / tiles, at least 1), fewer where a slice would hold under
// kMinSliceRows rows; `step` rows each (a multiple of kStepRows), the last
// one shorter.
// tiles: the products' output tiles.
__host__ __device__ inline long long slice_target_tiles(long long R, int tiles, int sms) {
    long long s = 2LL * sms / (tiles > 1 ? tiles : 1);
    const long long most = R / kMinSliceRows;
    if (s > most) s = most;
    return s < 1 ? 1 : s;
}

__host__ __device__ inline long long slice_step_tiles(long long R, int tiles, int sms) {
    const long long s = slice_target_tiles(R, tiles, sms);
    const long long step = (R + s - 1) / s;
    return (step + kStepRows - 1) / kStepRows * kStepRows;
}

__host__ __device__ inline long long slice_target(long long R, int D, int F, int sms) {
    return slice_target_tiles(R, product_tiles(D, F), sms);
}

__host__ __device__ inline long long slice_step(long long R, int D, int F, int sms) {
    return slice_step_tiles(R, product_tiles(D, F), sms);
}

__host__ __device__ inline long long vector_floats(int D, int F) { return DwLayout(D, F, true).total; }

inline Plan make_plan(int elem_bytes, long long A, int M, int D, int F, int sms,
                      long long cap = kSpillCap) {
    const long long row_bytes = (7LL * D + 3LL * F) * elem_bytes;
    const long long atom_bytes = M * row_bytes + vector_floats(D, F) * 4;
    long long per = cap / atom_bytes;
    if (per < 1) per = 1;
    // a chunk that is not the whole: whole waves of one atom per SM
    if (per < A && per > sms) per = per / sms * sms;
    if (per > A) per = A;
    Plan p{};
    if (A <= 0) return p;
    p.chunks = (A + per - 1) / per;
    p.chunk_atoms = per;
    p.vec_offset = (p.chunk_atoms * M * row_bytes + 255) / 256 * 256;
    p.spill_bytes = p.vec_offset + p.chunk_atoms * vector_floats(D, F) * 4;
    p.max_slices = slice_target(p.chunk_atoms * M, D, F, sms);
    return p;
}

// Shapes the products take: D and F multiples of the 128-wide tiles, D up
// to 256 (the body's limit).
__host__ __device__ inline bool product_shape(int D, int F) {
    return D > 0 && D % kTile == 0 && D <= 256 && F > 0 && F % kTile == 0;
}

// ---- the products -------------------------------------------------------

// Up to four products dW_q = X_q^T Y_q over the chunk's rows, product q
// tr[q] x tc[q] output tiles of 128 x 128 (the rest 0 x 0). K2-dW's four:
// X = n1, attn, h_norm, ffn_h; Y = d_qkv, d_attn_out, d_vg, the cotangent
// g_edge, whose rows m % M == M - 1 read as 0 (geo_q = 3).
template <typename T>
struct ProductArgs {
    const T* X[4];
    const T* Y[4];
    int ldx[4], ldy[4];
    long long out[4];  // offsets of the products' outputs in a partial
    int ldo[4];
    int tr[4], tc[4];  // each product's output tiles: rows, columns
    int tiles;         // all the products' tiles: the grid's x
    int geo_q;         // the product whose Y skips rows m % M == M - 1 (-1: none)
    long long rows, step;  // the chunk's rows, rows per slice
    int M;
    float* partials;       // (slices, n_dw)
    long long n_dw;
};

// The products of one chunk: its spill (DwSpill, R_cap rows) holds `rows`.
template <typename T>
ProductArgs<T> product_args(const T* spill, long long R_cap, const T* g_edge, long long rows, int M,
                            int D, int F, int sms, float* partials) {
    const DwSpill<T> S{const_cast<T*>(spill), nullptr, R_cap};
    const DwLayout L(D, F);
    ProductArgs<T> a{};
    const T* X[4] = {S.at(kDwN1, 0, D, F), S.at(kDwAttn, 0, D, F), S.at(kDwHnorm, 0, D, F),
                     S.at(kDwFfnH, 0, D, F)};
    const T* Y[4] = {S.at(kDwQkv, 0, D, F), S.at(kDwDao, 0, D, F), S.at(kDwVg, 0, D, F), g_edge};
    const int ldx[4] = {D, D, D, F}, ldy[4] = {3 * D, D, 2 * F, D};
    const long long out[4] = {L.w_qkv, L.w_out, L.w_in, L.w_ffn_out};
    const int ldo[4] = {3 * D, D, 2 * F, D};
    const int nD = D / kTile;
    const int tr[4] = {nD, nD, nD, F / kTile}, tc[4] = {3 * nD, nD, 2 * F / kTile, nD};
    for (int q = 0; q < 4; ++q) {
        a.X[q] = X[q];
        a.Y[q] = Y[q];
        a.ldx[q] = ldx[q];
        a.ldy[q] = ldy[q];
        a.out[q] = out[q];
        a.ldo[q] = ldo[q];
        a.tr[q] = tr[q];
        a.tc[q] = tc[q];
    }
    a.tiles = product_tiles(D, F);
    a.geo_q = 3;
    a.rows = rows;
    a.step = slice_step(rows, D, F, sms);
    a.M = M;
    a.partials = partials;
    a.n_dw = L.total;
    return a;
}

struct TileOf {
    int q, i0, j0;  // product, first output row, first output column
};

// Tile t of the products, in product order, each product's tiles row-major.
template <typename T>
__device__ __forceinline__ TileOf tile_of(int t, const ProductArgs<T>& p) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int n = p.tr[q] * p.tc[q];
        if (t < n) return TileOf{q, (t / p.tc[q]) * kTile, (t % p.tc[q]) * kTile};
        t -= n;
    }
    return TileOf{3, 0, 0};
}

// A 16-byte copy, zero-filled where `pred` is false (src is then not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool pred) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sm90::smem_addr(dst)), "l"(src),
                 "r"(pred ? 16 : 0)
                 : "memory");
}

// The chunk's rows [r0, r1) that block (tile, slice) sums.
template <typename T>
struct SliceRows {
    long long r0, r1;
    __device__ SliceRows(const ProductArgs<T>& p) {
        r0 = (long long)blockIdx.y * p.step;
        r1 = r0 + p.step < p.rows ? r0 + p.step : p.rows;
    }
};

// float32: 8 x 8 FFMA register tiles per thread (rows ty*4 + i and 64 +
// ty*4 + i, columns tx*4 + j and 64 + tx*4 + j: conflict-free float4
// loads; a warp holds 4 ty by 8 tx, so each of its loads reads at most
// 128 distinct bytes), 32 rows a k step, three cp.async stages of 2 x 32
// x 128 floats (96 KB: two blocks per SM).
constexpr int kF32K = 32, kF32Stages = 3;
constexpr int kF32StageFloats = 2 * kF32K * kTile;
constexpr int kF32SmemBytes = kF32Stages * kF32StageFloats * 4;

__global__ void __launch_bounds__(kThreads, 2) product_f32_kernel(ProductArgs<float> p) {
    extern __shared__ __align__(16) float fsm[];
    const TileOf tl = tile_of(blockIdx.x, p);
    const SliceRows<float> sr(p);
    const float* X = p.X[tl.q] + tl.i0;
    const float* Y = p.Y[tl.q] + tl.j0;
    const int ldx = p.ldx[tl.q], ldy = p.ldy[tl.q];
    const bool geo = tl.q == p.geo_q;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
    const long long nk = (sr.r1 - sr.r0 + kF32K - 1) / kF32K;
    float* const base = fsm;

    auto issue = [&](long long kt) {
        if (kt < nk) {
            float* xs = base + (kt % kF32Stages) * kF32StageFloats;
            float* ys = xs + kF32K * kTile;
            for (int e = tid; e < kF32K * kTile / 4; e += kThreads) {
                const int r = e >> 5, c = (e & 31) * 4;
                const long long row = sr.r0 + kt * kF32K + r;
                const bool in = row < sr.r1;
                const bool yin = in && !(geo && (int)row % p.M == p.M - 1);
                cp_async16_zfill(xs + r * kTile + c, in ? X + row * ldx + c : X, in);
                cp_async16_zfill(ys + r * kTile + c, yin ? Y + row * ldy + c : Y, yin);
            }
        }
        sm90::cp_async_commit();
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int s = 0; s < kF32Stages - 1; ++s) issue(s);
    for (long long kt = 0; kt < nk; ++kt) {
        sm90::cp_async_wait<kF32Stages - 2>();
        __syncthreads();
        issue(kt + kF32Stages - 1);
        const float* xs = base + (kt % kF32Stages) * kF32StageFloats;
        const float* ys = xs + kF32K * kTile;
#pragma unroll
        for (int k = 0; k < kF32K; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(xs + k * kTile + ty * 4);
            const float4 a1 = *reinterpret_cast<const float4*>(xs + k * kTile + 64 + ty * 4);
            const float4 b0 = *reinterpret_cast<const float4*>(ys + k * kTile + tx * 4);
            const float4 b1 = *reinterpret_cast<const float4*>(ys + k * kTile + 64 + tx * 4);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }
    sm90::cp_async_wait<0>();
    float* P = p.partials + blockIdx.y * p.n_dw + p.out[tl.q];
    const int ldo = p.ldo[tl.q];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int row = tl.i0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
        float* o = P + (long long)row * ldo + tl.j0;
        *reinterpret_cast<float4*>(o + tx * 4) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(o + 64 + tx * 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
}

// bfloat16: wgmma with both operands from shared memory. A stage holds 64
// rows of X's 128 tile columns and of Y's, each as two 64-column halves in
// the 128-byte swizzle (row r's 16-byte piece j at r * 128 + ((j ^ r % 8)
// * 16), halves 8,192 bytes apart): the rows are K, so wgmma reads both
// MN-major (transposed) and X^T needs no copy. Warpgroup g takes output
// rows 64 g .. + 63 (X's half g) against both halves of Y: two m64n64k16
// per 16-row k step, each operand one 64-wide half, so only the 8-row
// groups' stride (1,024 bytes) is in play.
constexpr int kBfK = 64, kBfStages = 3;
constexpr int kBfHalf = kBfK * 64 * 2;       // bytes: 64 rows x 64 columns
constexpr int kBfStageBytes = 4 * kBfHalf;   // X's two halves, then Y's
constexpr int kBfSmemBytes = kBfStages * kBfStageBytes;

__device__ __forceinline__ uint64_t desc_mn(const void* p) {
    // start, leading and stride byte offsets (both 1,024: one 64-wide half
    // per operand, 8-row groups 1,024 bytes apart), the 128-byte swizzle
    return (uint64_t)((sm90::smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// acc += A B, m64n64k16, A and B MN-major in shared memory.
__device__ __forceinline__ void wgmma_mn_m64n64k16(float (&acc)[8][4], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
        "%32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]), "+f"(acc[1][0]),
          "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]), "+f"(acc[2][0]), "+f"(acc[2][1]),
          "+f"(acc[2][2]), "+f"(acc[2][3]), "+f"(acc[3][0]), "+f"(acc[3][1]), "+f"(acc[3][2]),
          "+f"(acc[3][3]), "+f"(acc[4][0]), "+f"(acc[4][1]), "+f"(acc[4][2]), "+f"(acc[4][3]),
          "+f"(acc[5][0]), "+f"(acc[5][1]), "+f"(acc[5][2]), "+f"(acc[5][3]), "+f"(acc[6][0]),
          "+f"(acc[6][1]), "+f"(acc[6][2]), "+f"(acc[6][3]), "+f"(acc[7][0]), "+f"(acc[7][1]),
          "+f"(acc[7][2]), "+f"(acc[7][3])
        : "l"(da), "l"(db));
}

__global__ void __launch_bounds__(kThreads, 2) product_bf16_kernel(ProductArgs<bf16> p) {
    extern __shared__ __align__(1024) unsigned char bsm[];
    const TileOf tl = tile_of(blockIdx.x, p);
    const SliceRows<bf16> sr(p);
    const bf16* X = p.X[tl.q] + tl.i0;
    const bf16* Y = p.Y[tl.q] + tl.j0;
    const int ldx = p.ldx[tl.q], ldy = p.ldy[tl.q];
    const bool geo = tl.q == p.geo_q;
    const int tid = threadIdx.x;
    const long long nk = (sr.r1 - sr.r0 + kBfK - 1) / kBfK;
    unsigned char* const base = bsm;

    auto issue = [&](long long kt) {
        if (kt < nk) {
            unsigned char* st = base + (kt % kBfStages) * kBfStageBytes;
            // 64 rows x 16 pieces of 16 bytes per operand
            for (int e = tid; e < kBfK * 16; e += kThreads) {
                const int r = e >> 4, c = e & 15, half = c >> 3, piece = c & 7;
                const long long row = sr.r0 + kt * kBfK + r;
                const bool in = row < sr.r1;
                const bool yin = in && !(geo && (int)row % p.M == p.M - 1);
                const int off = half * kBfHalf + r * 128 + ((piece ^ (r & 7)) * 16);
                cp_async16_zfill(st + off, in ? X + row * ldx + c * 8 : X, in);
                cp_async16_zfill(st + 2 * kBfHalf + off, yin ? Y + row * ldy + c * 8 : Y, yin);
            }
        }
        sm90::cp_async_commit();
    };

    float acc[2][8][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) sm90::zero(acc[h]);
    const int g = tid >> 7;
    for (int s = 0; s < kBfStages - 1; ++s) issue(s);
    for (long long kt = 0; kt < nk; ++kt) {
        sm90::cp_async_wait<kBfStages - 2>();
        // written through the generic proxy, read by wgmma through the async one
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        issue(kt + kBfStages - 1);
        const unsigned char* st = base + (kt % kBfStages) * kBfStageBytes;
        const unsigned char* xa = st + g * kBfHalf;
        const unsigned char* yb = st + 2 * kBfHalf;
#pragma unroll
        for (int h = 0; h < 2; ++h) sm90::acc_fence(acc[h]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < kBfK / 16; ++ks) {
            // a k step of 16 rows: two 8-row groups, 2,048 bytes on
            const uint64_t da = desc_mn(xa + ks * 2048);
#pragma unroll
            for (int h = 0; h < 2; ++h) wgmma_mn_m64n64k16(acc[h], da, desc_mn(yb + h * kBfHalf + ks * 2048));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int h = 0; h < 2; ++h) sm90::acc_fence(acc[h]);
    }
    sm90::cp_async_wait<0>();
    // acc[h][j][i]: row 64 g + 16 (warp % 4) + lane / 4 + 8 (i / 2), column
    // 64 h + 8 j + 2 (lane % 4) + i % 2
    float* P = p.partials + blockIdx.y * p.n_dw + p.out[tl.q];
    const int ldo = p.ldo[tl.q];
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int m0 = tl.i0 + 64 * g + 16 * warp + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float* o = P + (long long)(m0 + 8 * r) * ldo + tl.j0 + 64 * h + 8 * j + 2 * (lane & 3);
                *reinterpret_cast<float2*>(o) = make_float2(acc[h][j][2 * r], acc[h][j][2 * r + 1]);
            }
}

// Where a vector row's elements go in a partial: segment i, its len[i]
// elements after those of the segments before it, to off[i] on.
struct VecMap {
    int len[6];
    long long off[6];
    int total;  // the row's elements
};

// K2-dW's per-atom row: norm_attn, b_qkv, b_out, norm_mlp, b_in, b_ffn_out.
__host__ __device__ inline VecMap k2_vec_map(int D, int F) {
    const DwLayout L(D, F);
    return VecMap{{D, 3 * D, D, D, 2 * F, D},
                  {L.norm_attn, L.b_qkv, L.b_out, L.norm_mlp, L.b_in, L.b_ffn_out},
                  (int)DwLayout(D, F, true).total};
}

// The vector sums: partial s, vector element c (at its map's offset) = the
// sum over the slice's units (atoms, or tiles of rows) [s U / S, (s + 1) U
// / S) of their rows' element c, in unit order.
__global__ void __launch_bounds__(256) vector_sums_kernel(const float* __restrict__ vec, long long units,
                                                          VecMap map, float* __restrict__ partials,
                                                          long long n_dw) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= map.total) return;
    const long long S = gridDim.y, s = blockIdx.y;
    const long long u0 = units * s / S, u1 = units * (s + 1) / S;
    float sum = 0.f;
    for (long long u = u0; u < u1; ++u) sum += vec[u * map.total + c];
    int i = 0, c0 = 0;
    while (c >= c0 + map.len[i]) c0 += map.len[i++];
    partials[s * n_dw + map.off[i] + (c - c0)] = sum;
}

// out[e] (+)= sum over slices s < S of partials[s, e], s in order: the
// first chunk writes, the later ones add, in chunk order.
__global__ void __launch_bounds__(256) sum_slices_kernel(const float* __restrict__ partials, int S,
                                                         long long n, float* __restrict__ out, int first) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    float s = 0.f;
    for (int b = 0; b < S; ++b) s += partials[(size_t)b * n + e];
    out[e] = first ? s : out[e] + s;
}

// Pass 2 of one chunk: the products, the vector sums (units rows of
// map.total floats at vec), then the slices summed into dw. T = float or
// bf16.
template <typename T>
int run_products(const ProductArgs<T>& a, const float* vec, long long units, const VecMap& map, float* dw,
                 bool first, cudaStream_t stream) {
    const long long S = (a.rows + a.step - 1) / a.step;
    const dim3 grid((unsigned)a.tiles, (unsigned)S);
    cudaError_t err;
    if constexpr (sizeof(T) == 4) {
        err = cudaFuncSetAttribute(product_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kF32SmemBytes);
        if (err != cudaSuccess) return (int)err;
        product_f32_kernel<<<grid, kThreads, kF32SmemBytes, stream>>>(a);
    } else {
        err = cudaFuncSetAttribute(product_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kBfSmemBytes);
        if (err != cudaSuccess) return (int)err;
        product_bf16_kernel<<<grid, kThreads, kBfSmemBytes, stream>>>(a);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    vector_sums_kernel<<<dim3((unsigned)((map.total + 255) / 256), (unsigned)S), 256, 0, stream>>>(
        vec, units, map, a.partials, a.n_dw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_slices_kernel<<<(unsigned)((a.n_dw + 255) / 256), 256, 0, stream>>>(a.partials, (int)S, a.n_dw, dw,
                                                                            first ? 1 : 0);
    return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dwp
}  // namespace mtt
