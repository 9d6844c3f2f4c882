// K3 on Hopper: the exact bfloat16 forward of PET's compress, combination
// and head row-block stages, redesigned for the H100.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/rowblock.py
// `_forward_impl` (:93; pallas_call at :113), in bfloat16, for the three
// math functions it is traced over: `compress_math` (:26),
// `combination_math` (:45) and `head_math` (:66) of
// metatrain_tpu/models/pet/fused_stages.py. It computes the same function
// as K3's general body (rowblock_fwd.cu) and the plain versions
// `compress_math` / `combination_math` / `head_math` of
// metatrain_tpu_torch/models/pet/fused_stages.py, at d_part = 128:
//   compress    (2 or 3 parts: w_in 256 or 384, w_hid = w_out = 128)
//                 pre = sum_i X_i w0_i + b0, h = rnd(silu(pre)),
//                 out = rnd(h w1 + b1)
//   combination (w_in = w_hid = 256, w_out = 128; X = [edges | reversed])
//                 xn0 = (X - mean) rs, rs = rsqrt(var + 1e-5) (two passes),
//                 xn = rnd(xn0 ln_scale + ln_bias), h = rnd(silu(xn w0 +
//                 b0)), out = rnd(messages + edges + (h w1 + b1)), added in
//                 that order
//   head        (w_in = w_hid = w_out = 128; its own kernel, below)
//                 h = rnd(silu(x w0 + b0)), out = rnd(silu(h w1 + b1))
// It rounds where the plain version rounds and nowhere else: xn, h and the
// output. Products accumulate in float; only their summation order differs
// from the plain version's. The LayerNorm and the head's front are the
// Hopper K4's recompute (rowblock_sm90.cuh layer_norm_rows, head_front),
// so the served forward's xn and h and the backward's round the same way
// (the general K3 sums its rows in another order).
// mtt_rowblock_fwd_sm90_ok is the shape rule; the wrapper sends every other
// shape, float32 and any call whose weights require grad (training keeps
// the general K3) to rowblock_fwd.cu.
//
// What bounds it on the H100: bytes. At the served rows (A = 11,392 atoms
// x M = 64 = 729,088) the 3-part compress reads 3 parts and writes the
// output, 1,024 B per row: 0.223 ms at 3.35 TB/s (its two products, 96
// GFLOP, take 0.097 ms at 989 TFLOP/s); the 2-part compress 768 B per row,
// 0.167 ms; the combination reads edges, reversed and messages and writes
// the output, 1,024 B per row: 0.223 ms (143 GFLOP: 0.145 ms). The general
// body took 23-26x that; its causes and what this design does about each:
// - scalar bf16 loads with integer division per element, widened into
//   float tiles (131 KB at 3 parts: one block per SM, nothing overlaps the
//   loads): here the row tiles stay bf16 (rows padded by 8 elements, so
//   ldmatrix reads them without bank conflicts) and are streamed as in the
//   Hopper K4. One persistent block per SM walks a contiguous range of
//   64-row tiles; the next tile's inputs (the parts, or edges | reversed
//   and the messages) are copied with 16-byte cp.async into a second buffer
//   while this tile's products run, each piece riding in the cp.async group
//   of one weight chunk (rowblock_sm90.cuh StreamRing), so the ring's own
//   waits complete them by the tile's last chunk. Rows past the end are
//   zero-filled and never stored.
// - weights fetched from L2 for every mma.sync: every weight reaches the
//   tensor cores through layer_sm90.cuh's ring of three staged chunks (128
//   x 64 bf16, 128-byte swizzle), one fixed sequence per tile (Chunks):
//   compress 2 NP (pre) + 2 (h w1), 8 chunks at 3 parts and 6 at 2;
//   combination 4 per hidden panel of 128 columns (2 panels) + 4 (h w1): 12.
// - half the warps idle (64 x 16 warp tiles): every product is a 64 x 128
//   panel on wgmma m64n32k16, each of the four warpgroups on 32 columns,
//   all 16 warps busy (layer_sm90.cuh panel_mm).
// - the epilogue re-reading messages and edges from global memory: h goes
//   from the accumulators through bias and SiLU into a bf16 tile, the A
//   operand of the second product; the output is stored from registers,
//   with the combination's messages and edges read from the streamed tiles.
// Shared memory (bytes): the ring 49,152; two input tiles 2 x 64 x (w_in +
// 8) x 2; the h tile 64 x (w_hid + 8) x 2; the combination also two
// messages tiles 2 x 17,408, the xn tile and the rows' mean and rs.
// 166,912 at 3 parts, 134,144 at 2, 219,648 for the combination: one block
// per SM.
//
// The head (k3_head_sm90_kernel) reads x and writes the output, 512 B per
// row: 0.111 ms at the served rows (two 128 x 128 products, 47.8 GFLOP:
// 0.048 ms). The general head took 23x that, for the causes above, and the
// ring would still cost one barrier and one full wgmma wait per chunk per
// tile. Its weights are small enough to stay: w0^T and w1^T, 65,536 B, are
// loaded once per block into shared memory in the ring's swizzle
// (rowblock_sm90.cuh ResidentWeights) and read there by every tile, with no
// ring, no per-chunk barrier and no weight traffic from L2 after the first
// tile. x is double-buffered (RowTiles): at the start of tile t its 1,024
// 16-byte pieces of tile t + 1 are issued as one cp.async group, waited for
// at the end of tile t. A tile is head_front (pre0, h to the h tile, pre1)
// and head_out (SiLU, rounded, stored from registers). Shared memory:
// 65,536 + 2 x 17,408 (x) + 17,408 (h) = 117,760 B, one block per SM.
//
// No atomics: every output element is written once by one thread, so every
// launch gives the same bits.

#include "rowblock_sm90.cuh"

namespace mtt {
namespace sm90 {
namespace {

enum Stage { kCompress = 0, kCombination = 1, kHead = 2 };

// The layout of one instantiation: NX arrays make up the input tile X
// (compress: the NP parts; combination: edges and reversed), the
// combination's messages are one more (NG = 1), in tiles of their own.
template <int STAGE, int NP>
struct Geo {
    static constexpr int NX = STAGE == kCompress ? NP : 2;
    static constexpr int NG = STAGE == kCompress ? 0 : 1;
    static constexpr int W_IN = NX * kPart;
    static constexpr int W_HID = STAGE == kCompress ? kPart : 2 * kPart;
    static constexpr int LX = W_IN + 8;   // X and xn rows (bf16)
    static constexpr int LH = W_HID + 8;  // h rows
    static constexpr int NCH = STAGE == kCompress ? 2 * NP + 2 : 12;  // chunks per tile
    static constexpr int kRing = kStages * kChunkElems * 2;
    static constexpr int kX = kRows * LX * 2;
    static constexpr int kG = kRows * LA * 2;
    static constexpr int kOffX = kRing;  // the ring first: 1024-byte aligned
    static constexpr int kOffG = kOffX + 2 * kX;
    static constexpr int kOffH = kOffG + 2 * NG * kG;
    static constexpr int kOffXN = kOffH + kRows * LH * 2;
    static constexpr int kOffStats = kOffXN + (STAGE == kCombination ? kX : 0);
    static constexpr int kSmem = kOffStats + (STAGE == kCombination ? 2 * kRows * 4 : 0);
    static_assert(kSmem <= 232448, "one block per SM");
};

struct Args {
    const bf16* x[3];  // (rows, 128) each: the parts, or edges, reversed and messages
    const bf16* ln_scale;
    const bf16* ln_bias;
    const bf16* b0;
    const bf16* b1;
    bf16* out;  // (rows, 128)
    long long rows;
};

// A tile's weight chunks in the order its products consume them, each (N,
// K) row-major: compress: pre (w0^T, 2 NP), h w1 (w1^T, 2); combination:
// per hidden panel q, pre (w0^T rows 128 q .., 4), then h w1 (w1^T, 4).
template <int STAGE, int NP>
struct Chunks {
    const bf16 *w0_t, *w1_t;

    __device__ const bf16* operator()(int c, int& ld) const {
        using G = Geo<STAGE, NP>;
        int r = c % G::NCH;
        if (STAGE == kCompress) {
            if (r < 2 * NP) {
                ld = G::W_IN;
                return w0_t + r * kChunkK;
            }
            r -= 2 * NP;
        } else {
            if (r < 8) {
                ld = G::W_IN;
                return w0_t + (size_t)(r >> 2) * kChunkN * G::W_IN + (r & 3) * kChunkK;
            }
            r -= 8;
        }
        ld = G::W_HID;
        return w1_t + r * kChunkK;
    }
};

// compress, one tile: X (64 x LX) in shared memory, H the block's own
template <int NP, typename Ring>
__device__ __forceinline__ void compress_tile(Ring& ring, int& c, const Args& p, const bf16* X, bf16* H,
                                              long long row0, int valid) {
    using G = Geo<kCompress, NP>;
    float acc[4][4];
    zero(acc);
    panel_mm<2 * NP>(ring, c, [&](int r, int& ld) { ld = G::LX; return X + r * kChunkK; }, acc);
    panel_pairs([&](int j, int h, int m, int n) {
        const float2 b = ld2(p.b0 + n);
        store2(H + m * G::LH + n, siluf_(acc[j][2 * h] + b.x), siluf_(acc[j][2 * h + 1] + b.y));
    });
    // (the next consume's barrier orders these stores before the reads)
    zero(acc);
    panel_mm<2>(ring, c, [&](int r, int& ld) { ld = G::LH; return (const bf16*)H + r * kChunkK; }, acc);
    bf16* out = p.out + row0 * kPart;
    panel_pairs([&](int j, int h, int m, int n) {
        if (m >= valid) return;
        const float2 b = ld2(p.b1 + n);
        store2(out + (size_t)m * kPart + n, acc[j][2 * h] + b.x, acc[j][2 * h + 1] + b.y);
    });
}

// combination, one tile: X = [edges | reversed] (64 x LX) and the messages
// Mt in shared memory; XN, H, MEAN and RS the block's own
template <typename Ring>
__device__ __forceinline__ void combination_tile(Ring& ring, int& c, const Args& p, const bf16* X,
                                                 const bf16* Mt, bf16* XN, bf16* H, float* MEAN,
                                                 float* RS, long long row0, int valid) {
    using G = Geo<kCombination, 2>;
    layer_norm_rows(X, p.ln_scale, p.ln_bias, XN, MEAN, RS);
    // (the first consume's barrier orders these stores before the reads)

    // per hidden panel q: h = rnd(silu(xn w0 + b0)) (columns 128 q ..) into H
#pragma unroll 1
    for (int q = 0; q < 2; ++q) {
        float acc[4][4];
        zero(acc);
        panel_mm<4>(ring, c, [&](int r, int& ld) { ld = G::LX; return (const bf16*)XN + r * kChunkK; }, acc);
        panel_pairs([&](int j, int h, int m, int n) {
            const int col = q * kChunkN + n;
            const float2 b = ld2(p.b0 + col);
            store2(H + m * G::LH + col, siluf_(acc[j][2 * h] + b.x), siluf_(acc[j][2 * h + 1] + b.y));
        });
    }

    // out = rnd(messages + edges + (h w1 + b1))
    float acc[4][4];
    zero(acc);
    panel_mm<4>(ring, c, [&](int r, int& ld) { ld = G::LH; return (const bf16*)H + r * kChunkK; }, acc);
    bf16* out = p.out + row0 * kPart;
    panel_pairs([&](int j, int h, int m, int n) {
        if (m >= valid) return;
        const float2 b = ld2(p.b1 + n), e = ld2(X + m * G::LX + n), msg = ld2(Mt + m * LA + n);
        const float y0 = acc[j][2 * h] + b.x, y1 = acc[j][2 * h + 1] + b.y;
        store2(out + (size_t)m * kPart + n, (msg.x + e.x) + y0, (msg.y + e.y) + y1);
    });
}

template <int STAGE, int NP>
__global__ void __launch_bounds__(kThreads, 1) k3_sm90_kernel(Args p, Chunks<STAGE, NP> chunks) {
    using G = Geo<STAGE, NP>;
    extern __shared__ __align__(1024) unsigned char smem[];
    bf16* XB = reinterpret_cast<bf16*>(smem + G::kOffX);  // two input tiles
    bf16* MB = reinterpret_cast<bf16*>(smem + G::kOffG);  // two messages tiles (combination)
    bf16* H = reinterpret_cast<bf16*>(smem + G::kOffH);
    bf16* XN = reinterpret_cast<bf16*>(smem + G::kOffXN);
    float* MEAN = reinterpret_cast<float*>(smem + G::kOffStats);
    float* RS = MEAN + kRows;

    const long long tiles = (p.rows + kRows - 1) / kRows;
    const long long t0 = tiles * blockIdx.x / gridDim.x, t1 = tiles * (blockIdx.x + 1) / gridDim.x;
    const int T = (int)(t1 - t0);
    using In = TileInputs<G::NX, G::NG, G::NCH>;
    In inputs{{}, XB, MB, p.rows, t0, T};
#pragma unroll
    for (int a = 0; a < G::NX + G::NG; ++a) inputs.src[a] = p.x[a];
    StreamRing<Chunks<STAGE, NP>, In> ring{{reinterpret_cast<bf16*>(smem), chunks, T * G::NCH}, inputs};
    ring.start();
    cp_async_wait<0>();  // tile 0
    __syncthreads();
    int c = 0;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
        const long long row0 = (t0 + t) * kRows;
        const int valid = (int)min((long long)kRows, p.rows - row0);
        const bf16* X = XB + (t & 1) * kRows * G::LX;
        if constexpr (STAGE == kCompress)
            compress_tile<NP>(ring, c, p, X, H, row0, valid);
        else
            combination_tile(ring, c, p, X, MB + (t & 1) * kRows * LA, XN, H, MEAN, RS, row0, valid);
    }
}

// ---- the head: resident weights (chunks 0, 1 w0^T; 2, 3 w1^T), no ring ----
constexpr int kHeadOffX = 4 * kChunkElems * 2;  // 65,536
constexpr int kHeadOffH = kHeadOffX + 2 * kRows * LA * 2;
constexpr int kHeadSmem = kHeadOffH + kRows * LA * 2;
static_assert(kHeadSmem == 117760, "the layout _lib.k3_sm90_smem mirrors");

struct HeadArgs {
    const bf16 *x, *w0_t, *b0, *w1_t, *b1;
    bf16* out;  // (rows, 128)
    long long rows;
};

__global__ void __launch_bounds__(kThreads, 1) k3_head_sm90_kernel(HeadArgs p) {
    extern __shared__ __align__(1024) unsigned char smem[];
    const ResidentWeights W{reinterpret_cast<bf16*>(smem)};
    bf16* H = reinterpret_cast<bf16*>(smem + kHeadOffH);
    const long long tiles = (p.rows + kRows - 1) / kRows;
    const long long t0 = tiles * blockIdx.x / gridDim.x, t1 = tiles * (blockIdx.x + 1) / gridDim.x;
    const int T = (int)(t1 - t0);
    if (T == 0) return;
    const RowTiles<1> X{{p.x}, {reinterpret_cast<bf16*>(smem + kHeadOffX)}, p.rows, t0};
    W.load(0, p.w0_t);
    W.load(1, p.w1_t);
    X.load(0);  // one cp.async group with the weights
    cp_async_wait<0>();
    // written through the generic proxy; wgmma reads the weights through
    // the async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
        if (t + 1 < T) X.load(t + 1);  // into the buffer tile t - 1 left
        const long long row0 = (t0 + t) * kRows;
        float pre0[4][4], pre1[4][4];
        head_front(W, X.tile(0, t), H, p.b0, p.b1, pre0, pre1);
        head_out(pre1, p.out + row0 * kPart, (int)min((long long)kRows, p.rows - row0));
        cp_async_wait<0>();
        __syncthreads();  // tile t + 1 in; H and tile t's buffer free
    }
}

template <int STAGE, int NP>
int launch(const Args& a, const Chunks<STAGE, NP>& chunks, int blocks, cudaStream_t stream) {
    const int bytes = Geo<STAGE, NP>::kSmem;
    cudaError_t err = cudaFuncSetAttribute(k3_sm90_kernel<STAGE, NP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    k3_sm90_kernel<STAGE, NP><<<(unsigned)blocks, kThreads, bytes, stream>>>(a, chunks);
    return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sm90
}  // namespace mtt

// Whether the Hopper K3 takes a stage (0 compress, 1 combination, 2 head)
// and its widths (rowblock_sm90.cuh rowblock_sm90_ok).
extern "C" int mtt_rowblock_fwd_sm90_ok(int stage, int d_part, int w_in, int w_hid, int w_out) {
    return mtt::sm90::rowblock_sm90_ok(stage, d_part, w_in, w_hid, w_out);
}

// Its shared memory per block, 0 where it does not take the stage.
extern "C" size_t mtt_rowblock_fwd_sm90_smem(int stage, int d_part, int w_in, int w_hid, int w_out) {
    using namespace mtt::sm90;
    if (!mtt_rowblock_fwd_sm90_ok(stage, d_part, w_in, w_hid, w_out)) return 0;
    if (stage == kHead) return kHeadSmem;
    if (stage == kCombination) return Geo<kCombination, 2>::kSmem;
    return w_in == 3 * kPart ? Geo<kCompress, 3>::kSmem : Geo<kCompress, 2>::kSmem;
}

// bfloat16 tensors. x0..x2: the compress parts (n_parts of them), edges,
// reversed and messages, or the head's x; w0_t (w_hid, w_in) and w1_t
// (w_out, w_hid), the transposes of w0 and w1; out (rows, w_out). `blocks`
// persistent blocks (one per SM) walk contiguous ranges of 64-row tiles on
// `stream`. Returns the CUDA error code (cudaErrorInvalidValue for a shape
// it does not take).
extern "C" int mtt_rowblock_fwd_sm90(
    int stage, const void* x0, const void* x1, const void* x2, int n_parts,
    const void* ln_scale, const void* ln_bias, const void* w0_t, const void* b0, const void* w1_t,
    const void* b1, void* out, long long rows, int d_part, int w_in, int w_hid, int w_out, int blocks,
    void* stream) {
    using namespace mtt::sm90;
    if (!mtt_rowblock_fwd_sm90_ok(stage, d_part, w_in, w_hid, w_out) || blocks <= 0 ||
        (stage == kCompress && n_parts * d_part != w_in) || (stage == kCombination && n_parts != 3) ||
        (stage == kHead && n_parts != 1))
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (stage == kHead) {
        cudaError_t err = cudaFuncSetAttribute(k3_head_sm90_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kHeadSmem);
        if (err != cudaSuccess) return (int)err;
        const HeadArgs h{(const bf16*)x0, (const bf16*)w0_t, (const bf16*)b0, (const bf16*)w1_t,
                         (const bf16*)b1, (bf16*)out, rows};
        k3_head_sm90_kernel<<<(unsigned)blocks, kThreads, kHeadSmem, s>>>(h);
        return (int)cudaGetLastError();
    }
    const Args a{{(const bf16*)x0, (const bf16*)x1, (const bf16*)x2}, (const bf16*)ln_scale,
                 (const bf16*)ln_bias, (const bf16*)b0, (const bf16*)b1, (bf16*)out, rows};
    const bf16 *v0 = (const bf16*)w0_t, *v1 = (const bf16*)w1_t;
    if (stage == kCombination) return launch<kCombination, 2>(a, {v0, v1}, blocks, s);
    if (w_in == 3 * kPart) return launch<kCompress, 3>(a, {v0, v1}, blocks, s);
    return launch<kCompress, 2>(a, {v0, v1}, blocks, s);
}
