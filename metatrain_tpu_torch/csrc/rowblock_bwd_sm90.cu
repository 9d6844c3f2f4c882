// K4 on Hopper: the exact bfloat16 backward of PET's compress, combination
// and head row-block stages, redesigned for the H100.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/rowblock.py
// `_make_bwd_op` (:213; pallas_call at :279) with weight_grads=False, in
// bfloat16, for its three stages: the hand-written backwards
// `compress_bwd` (:112), `combination_bwd` (:148) and `head_bwd` (:198) of
// metatrain_tpu/models/pet/fused_stages.py. It computes the same function
// as K4's general body (rowblock_bwd.cu) and the plain versions
// `compress_bwd` / `combination_bwd` / `head_bwd` of
// metatrain_tpu_torch/models/pet/fused_stages.py, at d_part = 128:
//   compress    (2 or 3 parts: w_in 256 or 384, w_hid = w_out = 128)
//                 pre = X w0 + b0, d_pre = rnd((g w1^T) silu'(pre)),
//                 d_part_i = rnd(d_pre w0_i^T)
//   combination (w_in = w_hid = 256, w_out = 128; X = [edges | reversed])
//                 xn0 = (X - mean) rs, xn = rnd(xn0 ln_scale + ln_bias),
//                 pre = xn w0 + b0, d_pre = rnd((g w1^T) silu'(pre)),
//                 d = (d_pre w0^T) ln_scale, d_x = rs (d - mean(d) - xn0
//                 mean(d xn0)), d_edges = rnd(d_x[:, :128] + g),
//                 d_reversed = rnd(d_x[:, 128:]); d_messages = g is
//                 returned by the caller without a launch
//   head        (w_in = w_hid = w_out = 128; its own kernel, below)
//                 pre0 = x w0 + b0, h0 = rnd(silu(pre0)), pre1 = h0 w1 + b1,
//                 d_pre1 = rnd(g silu'(pre1)), d_pre0 = rnd((d_pre1 w1^T)
//                 silu'(pre0)), d_x = rnd(d_pre0 w0^T)
// It rounds where the plain version rounds and nowhere else: g (already
// bf16), xn, h0, d_pre (d_pre0, d_pre1) and the outputs. pre, g w1^T,
// d_pre w0^T and the LayerNorm backward stay in float, so K3, this kernel,
// K4-dW and the second-order replay compute one function; products
// accumulate in float, only their summation order differs from the plain
// version's. mtt_rowblock_bwd_sm90_ok is the shape rule; the wrapper sends
// every other shape, K4-dW and float32 to rowblock_bwd.cu.
//
// What bounds it on the H100: bytes. At the served rows (A = 11,392 atoms
// x M = 64 = 729,088) the 3-part compress reads 3 parts and g and writes
// 3 cotangents, 1,792 B per row: 0.390 ms at 3.35 TB/s (its three products,
// 167 GFLOP, take 0.169 ms at 989 TFLOP/s); the combination reads edges,
// reversed and g and writes 2 cotangents, 1,280 B per row: 0.279 ms (239
// GFLOP: 0.242 ms). The general body took 21-28x that; its causes and what
// this design does about each:
// - scalar bf16 loads with integer division per element, converted into
//   float tiles (164 KB at 64 rows: one block per SM, nothing overlaps the
//   loads): here the row tiles stay bf16 (rows padded by 8 elements, so
//   ldmatrix reads them without bank conflicts) and are streamed. One
//   persistent block per SM walks a contiguous range of 64-row tiles; the
//   next tile's inputs (parts or edges | reversed, and g) are copied with
//   16-byte cp.async into a second buffer while this tile's products run,
//   in as many pieces as the tile has weight chunks minus two, each riding
//   in the cp.async group of one chunk (rowblock_sm90.cuh StreamRing,
//   shared with the Hopper K3), so the ring's own waits complete them by
//   the tile's last chunk. Rows past the end are zero-filled and never
//   stored.
// - weights fetched from L2 for every mma.sync: every weight reaches the
//   tensor cores through layer_sm90.cuh's ring of three staged chunks (128
//   x 64 bf16, 128-byte swizzle), one fixed sequence per tile (Chunks):
//   compress 2 NP (pre) + 2 (g w1^T) + 2 NP (d_part), 14 chunks at 3 parts
//   and 10 at 2; combination per hidden panel of 128 columns 4 (pre) + 2
//   (g w1^T), then 2 x 4 (d_pre w0^T): 20.
// - half the warps idle (64 x 16 warp tiles): every product is a 64 x 128
//   panel on wgmma m64n32k16, each of the four warpgroups on 32 columns,
//   all 16 warps busy (layer_sm90.cuh panel_mm, one atom per block).
// - the LayerNorm backward re-reading its inputs from global memory: d_pre
//   forms in registers from the accumulators of g w1^T and pre and goes to
//   a bf16 tile, the A operand of the last product; the combination's d_xn
//   stays in registers (2 panels x 16 floats per thread), its row sums come
//   from panel_row_sums in a fixed order, and xn0 is recomputed from the x
//   tile and the per-row mean and rs. xn itself comes from the Hopper K3's
//   LayerNorm (rowblock_sm90.cuh layer_norm_rows), so the served forward
//   and this recompute round it the same way.
// Shared memory (bytes): the ring 49,152; two input tiles 2 x 64 x (w_in +
// 8) x 2; two g tiles 2 x 17,408; the d_pre tile 64 x (w_hid + 8) x 2; the
// combination also the xn tile and its row statistics. 201,728 at 3 parts,
// 168,960 at 2, 220,672 for the combination: one block per SM.
// What is left: one barrier and one full wgmma wait per staged chunk, as in
// the Hopper K1 and K2.
//
// The head (k4_head_sm90_kernel) reads x and g and writes d_x, 768 B per
// row: 0.167 ms at the served rows (four 128 x 128 products, 95.6 GFLOP:
// 0.097 ms). The general head took 25x that, for the causes above; the
// ring would still cost one barrier and one full wgmma wait per chunk per
// tile, 8 chunks a tile. Its weights are small enough to stay: w0^T and
// w1^T for the recompute, w1 and w0 for d_h0 = d_pre1 w1^T and d_x =
// d_pre0 w0^T, eight chunks, 131,072 B, loaded once per block into shared
// memory in the ring's swizzle (rowblock_sm90.cuh ResidentWeights) and
// read there by every tile: no ring, no per-chunk barrier, no weight
// traffic from L2 after the first tile. x and g are double-buffered
// (RowTiles): at the start of tile t their 2 x 1,024 16-byte pieces of
// tile t + 1 are issued as one cp.async group, waited for at the end of
// tile t. A tile: head_front (pre0 in registers, h0 to the one bf16 tile,
// pre1 in registers: the Hopper K3 head's own code, so the served h and
// this h0 round the same way), then d_pre1 from pre1 and the g tile into
// that tile, d_h0 on it, d_pre0 = d_h0 silu'(pre0) into it again, d_x
// rounded and stored from registers; five barriers a tile order the tile's
// reuse. Shared memory: 131,072 + 2 x 17,408 (x) + 2 x 17,408 (g) + 17,408
// (h0 / d_pre) = 218,112 B, one block per SM (a second bf16 tile would
// take it to 235,520, over the 232,448 a block may have).
//
// No atomics: every output element is written once by one thread, and the
// row sums run in a fixed order, so every launch gives the same bits.

#include "rowblock_sm90.cuh"

namespace mtt {
namespace sm90 {
namespace {

enum Stage { kCompress = 0, kCombination = 1, kHead = 2 };

// The layout of one instantiation: NP arrays make up the input tile X
// (compress: the parts; combination: edges and reversed), g is one more.
template <int STAGE, int NP>
struct Geo {
    static constexpr int W_IN = NP * kPart;
    static constexpr int W_HID = STAGE == kCompress ? kPart : 2 * kPart;
    static constexpr int LX = W_IN + 8;   // X and xn rows (bf16)
    static constexpr int LP = W_HID + 8;  // d_pre rows
    static constexpr int NCH = STAGE == kCompress ? 4 * NP + 2 : 20;  // chunks per tile
    static constexpr int kRing = kStages * kChunkElems * 2;
    static constexpr int kX = kRows * LX * 2;
    static constexpr int kG = kRows * LA * 2;
    static constexpr int kOffX = kRing;  // the ring first: 1024-byte aligned
    static constexpr int kOffG = kOffX + 2 * kX;
    static constexpr int kOffP = kOffG + 2 * kG;
    static constexpr int kOffXN = kOffP + kRows * LP * 2;
    static constexpr int kOffStats = kOffXN + (STAGE == kCombination ? kX : 0);
    static constexpr int kSmem = kOffStats + (STAGE == kCombination ? 6 * kRows * 4 : 0);
    static_assert(kSmem <= 232448, "one block per SM");
};

struct Args {
    const bf16* x[3];  // (rows, 128) each: the parts, or edges and reversed
    const bf16* g;     // (rows, 128)
    const bf16* ln_scale;
    const bf16* ln_bias;
    const bf16* b0;
    bf16* d[3];  // (rows, 128) each: one per part, or d_edges and d_reversed
    long long rows;
};

// A tile's weight chunks in the order its products consume them, each (N,
// K) row-major: compress: pre (w0^T, 2 NP), g w1^T (w1, 2), d_part p (w0
// rows 128 p .., 2 per part); combination: per hidden panel q, pre (w0^T
// rows 128 q .., 4) and g w1^T (w1 rows 128 q .., 2), then d_pre w0^T per
// output panel q (w0 rows 128 q .., 4).
template <int STAGE, int NP>
struct Chunks {
    const bf16 *w0_t, *w1, *w0;

    __device__ const bf16* operator()(int c, int& ld) const {
        using G = Geo<STAGE, NP>;
        int r = c % G::NCH;
        if (STAGE == kCompress) {
            if (r < 2 * NP) {
                ld = G::W_IN;
                return w0_t + r * kChunkK;
            }
            r -= 2 * NP;
            ld = kPart;
            if (r < 2) return w1 + r * kChunkK;
            r -= 2;
            return w0 + (size_t)(r >> 1) * kChunkN * kPart + (r & 1) * kChunkK;
        }
        if (r < 12) {
            const int q = r / 6;
            r %= 6;
            if (r < 4) {
                ld = G::W_IN;
                return w0_t + (size_t)q * kChunkN * G::W_IN + r * kChunkK;
            }
            ld = kPart;
            return w1 + (size_t)q * kChunkN * kPart + (r - 4) * kChunkK;
        }
        r -= 12;
        ld = G::W_HID;
        return w0 + (size_t)(r >> 2) * kChunkN * G::W_HID + (r & 3) * kChunkK;
    }
};

// d_pre = d_h silu'(pre), pre with its bias (rounded by the caller's store)
__device__ __forceinline__ float d_pre(float dh, float pre) { return dh * silu_grad(pre); }

// compress, one tile: X (64 x LX) and g in shared memory
template <int NP, typename Ring>
__device__ __forceinline__ void compress_tile(Ring& ring, int& c, const Args& p, const bf16* X,
                                              const bf16* Gt, bf16* DP, long long row0, int valid) {
    using G = Geo<kCompress, NP>;
    float pre[4][4], dh[4][4];
    zero(pre);
    panel_mm<2 * NP>(ring, c, [&](int r, int& ld) { ld = G::LX; return X + r * kChunkK; }, pre);
    zero(dh);
    panel_mm<2>(ring, c, [&](int r, int& ld) { ld = LA; return Gt + r * kChunkK; }, dh);
    panel_pairs([&](int j, int h, int m, int n) {
        const float2 b = ld2(p.b0 + n);
        store2(DP + m * G::LP + n, d_pre(dh[j][2 * h], pre[j][2 * h] + b.x),
               d_pre(dh[j][2 * h + 1], pre[j][2 * h + 1] + b.y));
    });
    // d_part q = rnd(d_pre w0_q^T): one 64 x 128 panel per part
#pragma unroll
    for (int q = 0; q < NP; ++q) {
        float acc[4][4];
        zero(acc);
        panel_mm<2>(ring, c, [&](int r, int& ld) { ld = G::LP; return (const bf16*)DP + r * kChunkK; }, acc);
        bf16* out = p.d[q] + row0 * kPart;
        panel_pairs([&](int j, int h, int m, int n) {
            if (m < valid) store2(out + (size_t)m * kPart + n, acc[j][2 * h], acc[j][2 * h + 1]);
        });
    }
}

// combination, one tile: X = [edges | reversed] (64 x LX) and g in shared
// memory; XN, DP, MEAN, RS and RED the block's own
template <typename Ring>
__device__ __forceinline__ void combination_tile(Ring& ring, int& c, const Args& p, const bf16* X,
                                                 const bf16* Gt, bf16* XN, bf16* DP, float* MEAN,
                                                 float* RS, float* RED, long long row0, int valid) {
    using G = Geo<kCombination, 2>;

    // LayerNorm statistics and xn = rnd(xn0 ln_scale + ln_bias): the Hopper
    // K3's own (rowblock_sm90.cuh)
    layer_norm_rows(X, p.ln_scale, p.ln_bias, XN, MEAN, RS);
    // (the first consume's barrier orders these stores before the reads)

    // per hidden panel q: pre = xn w0 + b0 and d_h = g w1^T (columns 128 q
    // ..), d_pre = rnd(d_h silu'(pre)) into DP
#pragma unroll 1
    for (int q = 0; q < 2; ++q) {
        float pre[4][4], dh[4][4];
        zero(pre);
        panel_mm<4>(ring, c, [&](int r, int& ld) { ld = G::LX; return (const bf16*)XN + r * kChunkK; }, pre);
        zero(dh);
        panel_mm<2>(ring, c, [&](int r, int& ld) { ld = LA; return Gt + r * kChunkK; }, dh);
        panel_pairs([&](int j, int h, int m, int n) {
            const int col = q * kChunkN + n;
            const float2 b = ld2(p.b0 + col);
            store2(DP + m * G::LP + col, d_pre(dh[j][2 * h], pre[j][2 * h] + b.x),
                   d_pre(dh[j][2 * h + 1], pre[j][2 * h + 1] + b.y));
        });
    }

    // d = (d_pre w0^T) ln_scale, in registers: dx[q] holds columns 128 q ..
    float dx[2][4][4];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        zero(dx[q]);
        panel_mm<4>(ring, c, [&](int r, int& ld) { ld = G::LP; return (const bf16*)DP + r * kChunkK; }, dx[q]);
    }
    panel_each([&](int j, int i, int m, int n) {
        dx[0][j][i] *= to_f(p.ln_scale[n]);
        dx[1][j][i] *= to_f(p.ln_scale[kChunkN + n]);
    });

    // LayerNorm backward: d_x = rs (d - mean(d) - xn0 mean(d xn0)), xn0 =
    // (x - mean) rs from the x tile
    auto xn0 = [&](int m, int col) { return (to_f(X[m * G::LX + col]) - MEAN[m]) * RS[m]; };
    float sa[2], sb[2];
    panel_row_sums(RED, [&](int j, int i, int m, int n) { return dx[0][j][i] + dx[1][j][i]; }, sa);
    panel_row_sums(RED, [&](int j, int i, int m, int n) {
        return dx[0][j][i] * xn0(m, n) + dx[1][j][i] * xn0(m, kChunkN + n);
    }, sb);
    panel_pairs([&](int j, int h, int m, int n) {
        if (m >= valid) return;
        const float rs = RS[m], ma = sa[h] / G::W_IN, mb = sb[h] / G::W_IN;
        const float2 g = ld2(Gt + m * LA + n);
        const size_t o = (size_t)(row0 + m) * kPart + n;
        store2(p.d[0] + o, rs * (dx[0][j][2 * h] - ma - xn0(m, n) * mb) + g.x,
               rs * (dx[0][j][2 * h + 1] - ma - xn0(m, n + 1) * mb) + g.y);
        store2(p.d[1] + o, rs * (dx[1][j][2 * h] - ma - xn0(m, kChunkN + n) * mb),
               rs * (dx[1][j][2 * h + 1] - ma - xn0(m, kChunkN + n + 1) * mb));
    });
    __syncthreads();  // MEAN, RS and XN are the next tile's
}

template <int STAGE, int NP>
__global__ void __launch_bounds__(kThreads, 1) k4_sm90_kernel(Args p, Chunks<STAGE, NP> chunks) {
    using G = Geo<STAGE, NP>;
    extern __shared__ __align__(1024) unsigned char smem[];
    bf16* XB = reinterpret_cast<bf16*>(smem + G::kOffX);  // two input tiles
    bf16* GB = reinterpret_cast<bf16*>(smem + G::kOffG);  // two g tiles
    bf16* DP = reinterpret_cast<bf16*>(smem + G::kOffP);  // d_pre
    bf16* XN = reinterpret_cast<bf16*>(smem + G::kOffXN);
    float* MEAN = reinterpret_cast<float*>(smem + G::kOffStats);
    float* RS = MEAN + kRows;
    float* RED = RS + kRows;

    const long long tiles = (p.rows + kRows - 1) / kRows;
    const long long t0 = tiles * blockIdx.x / gridDim.x, t1 = tiles * (blockIdx.x + 1) / gridDim.x;
    const int T = (int)(t1 - t0);
    using In = TileInputs<NP, 1, G::NCH>;
    In inputs{{}, XB, GB, p.rows, t0, T};
#pragma unroll
    for (int a = 0; a < NP; ++a) inputs.src[a] = p.x[a];
    inputs.src[NP] = p.g;
    StreamRing<Chunks<STAGE, NP>, In> ring{
        {reinterpret_cast<bf16*>(smem), chunks, T * G::NCH}, inputs};
    ring.start();
    cp_async_wait<0>();  // tile 0
    __syncthreads();
    int c = 0;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
        const long long row0 = (t0 + t) * kRows;
        const int valid = (int)min((long long)kRows, p.rows - row0);
        const bf16* X = XB + (t & 1) * kRows * G::LX;
        const bf16* Gt = GB + (t & 1) * kRows * LA;
        if constexpr (STAGE == kCompress)
            compress_tile<NP>(ring, c, p, X, Gt, DP, row0, valid);
        else
            combination_tile(ring, c, p, X, Gt, XN, DP, MEAN, RS, RED, row0, valid);
    }
}

// ---- the head: resident weights (chunks 0, 1 w0^T; 2, 3 w1^T; 4, 5 w1;
// 6, 7 w0), no ring ----
constexpr int kHeadOffX = 8 * kChunkElems * 2;  // 131,072
constexpr int kHeadOffG = kHeadOffX + 2 * kRows * LA * 2;
constexpr int kHeadOffH = kHeadOffG + 2 * kRows * LA * 2;
constexpr int kHeadSmem = kHeadOffH + kRows * LA * 2;
static_assert(kHeadSmem == 218112, "the layout _lib.k4_sm90_smem mirrors");

struct HeadArgs {
    const bf16 *x, *g, *w0_t, *b0, *w1_t, *b1, *w1, *w0;
    bf16* d_x;        // (rows, 128)
    bf16* front_out;  // null, or (rows, 128): the recomputed rnd(silu(pre1)), for checks
    long long rows;
};

// head, one tile: X and g (rows of LA) in shared memory, H the block's own
__device__ __forceinline__ void head_tile(const ResidentWeights& W, const HeadArgs& p, const bf16* X,
                                          const bf16* Gt, bf16* H, long long row0, int valid) {
    float pre0[4][4], acc[4][4];
    head_front(W, X, H, p.b0, p.b1, pre0, acc);  // acc: pre1
    if (p.front_out) head_out(acc, p.front_out + row0 * kPart, valid);
    __syncthreads();  // every warp has read h0
    panel_pairs([&](int j, int h, int m, int n) {  // d_pre1 = rnd(g silu'(pre1))
        const float2 g = ld2(Gt + m * LA + n);
        store2(H + m * LA + n, d_pre(g.x, acc[j][2 * h]), d_pre(g.y, acc[j][2 * h + 1]));
    });
    __syncthreads();
    int c = 4;
    zero(acc);  // d_h0 = d_pre1 w1^T
    panel_mm<2>(W, c, [&](int r, int& ld) { ld = LA; return (const bf16*)H + r * kChunkK; }, acc);
    __syncthreads();  // every warp has read d_pre1
    panel_pairs([&](int j, int h, int m, int n) {  // d_pre0 = rnd(d_h0 silu'(pre0))
        store2(H + m * LA + n, d_pre(acc[j][2 * h], pre0[j][2 * h]),
               d_pre(acc[j][2 * h + 1], pre0[j][2 * h + 1]));
    });
    __syncthreads();
    zero(acc);  // d_x = rnd(d_pre0 w0^T)
    panel_mm<2>(W, c, [&](int r, int& ld) { ld = LA; return (const bf16*)H + r * kChunkK; }, acc);
    bf16* out = p.d_x + row0 * kPart;
    panel_pairs([&](int j, int h, int m, int n) {
        if (m < valid) store2(out + (size_t)m * kPart + n, acc[j][2 * h], acc[j][2 * h + 1]);
    });
}

__global__ void __launch_bounds__(kThreads, 1) k4_head_sm90_kernel(HeadArgs p) {
    extern __shared__ __align__(1024) unsigned char smem[];
    const ResidentWeights W{reinterpret_cast<bf16*>(smem)};
    bf16* H = reinterpret_cast<bf16*>(smem + kHeadOffH);
    const long long tiles = (p.rows + kRows - 1) / kRows;
    const long long t0 = tiles * blockIdx.x / gridDim.x, t1 = tiles * (blockIdx.x + 1) / gridDim.x;
    const int T = (int)(t1 - t0);
    if (T == 0) return;
    const RowTiles<2> in{{p.x, p.g},
                         {reinterpret_cast<bf16*>(smem + kHeadOffX), reinterpret_cast<bf16*>(smem + kHeadOffG)},
                         p.rows, t0};
    W.load(0, p.w0_t);
    W.load(1, p.w1_t);
    W.load(2, p.w1);
    W.load(3, p.w0);
    in.load(0);  // one cp.async group with the weights
    cp_async_wait<0>();
    // written through the generic proxy; wgmma reads the weights through
    // the async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
        if (t + 1 < T) in.load(t + 1);  // into the buffers tile t - 1 left
        const long long row0 = (t0 + t) * kRows;
        head_tile(W, p, in.tile(0, t), in.tile(1, t), H, row0, (int)min((long long)kRows, p.rows - row0));
        cp_async_wait<0>();
        __syncthreads();  // tile t + 1 in; H and tile t's buffers free
    }
}

template <int STAGE, int NP>
int launch(const Args& a, const Chunks<STAGE, NP>& chunks, int blocks, cudaStream_t stream) {
    const int bytes = Geo<STAGE, NP>::kSmem;
    cudaError_t err = cudaFuncSetAttribute(k4_sm90_kernel<STAGE, NP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    k4_sm90_kernel<STAGE, NP><<<(unsigned)blocks, kThreads, bytes, stream>>>(a, chunks);
    return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sm90
}  // namespace mtt

// Whether the Hopper K4 takes a stage (0 compress, 1 combination, 2 head)
// and its widths (rowblock_sm90.cuh rowblock_sm90_ok).
extern "C" int mtt_rowblock_bwd_sm90_ok(int stage, int d_part, int w_in, int w_hid, int w_out) {
    return mtt::sm90::rowblock_sm90_ok(stage, d_part, w_in, w_hid, w_out);
}

// Its shared memory per block, 0 where it does not take the stage.
extern "C" size_t mtt_rowblock_bwd_sm90_smem(int stage, int d_part, int w_in, int w_hid, int w_out) {
    using namespace mtt::sm90;
    if (!mtt_rowblock_bwd_sm90_ok(stage, d_part, w_in, w_hid, w_out)) return 0;
    if (stage == kHead) return kHeadSmem;
    if (stage == kCombination) return Geo<kCombination, 2>::kSmem;
    return w_in == 3 * kPart ? Geo<kCompress, 3>::kSmem : Geo<kCompress, 2>::kSmem;
}

// bfloat16 tensors. x0..x2: the compress parts (n_parts of them), edges
// and reversed, or the head's x; w0 (w_in, w_hid) and its transpose w0_t,
// w1 (w_hid, w_out) and (the head only) its transpose w1_t and b1; g (rows,
// w_out); d0..d2 receive the input cotangents (one per part, d_edges and
// d_reversed, or the head's d_x). front_out (the head only, null in the
// served calls): where given, receives the head's recomputed forward
// output, for holding it against the Hopper K3 head's. `blocks` persistent
// blocks (one per SM) walk contiguous ranges of 64-row tiles on `stream`.
// Returns the CUDA error code (cudaErrorInvalidValue for a shape it does
// not take).
extern "C" int mtt_rowblock_bwd_sm90(
    int stage, const void* x0, const void* x1, const void* x2, int n_parts,
    const void* ln_scale, const void* ln_bias, const void* w0, const void* b0, const void* w1,
    const void* b1, const void* w0_t, const void* w1_t, const void* g, void* d0, void* d1, void* d2,
    void* front_out, long long rows, int d_part, int w_in, int w_hid, int w_out, int blocks,
    void* stream) {
    using namespace mtt::sm90;
    if (!mtt_rowblock_bwd_sm90_ok(stage, d_part, w_in, w_hid, w_out) || blocks <= 0 ||
        (stage == kCompress && n_parts * d_part != w_in) || (stage == kHead && n_parts != 1))
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (stage == kHead) {
        cudaError_t err = cudaFuncSetAttribute(k4_head_sm90_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kHeadSmem);
        if (err != cudaSuccess) return (int)err;
        const HeadArgs h{(const bf16*)x0, (const bf16*)g, (const bf16*)w0_t, (const bf16*)b0,
                         (const bf16*)w1_t, (const bf16*)b1, (const bf16*)w1, (const bf16*)w0,
                         (bf16*)d0, (bf16*)front_out, rows};
        k4_head_sm90_kernel<<<(unsigned)blocks, kThreads, kHeadSmem, s>>>(h);
        return (int)cudaGetLastError();
    }
    const Args a{{(const bf16*)x0, (const bf16*)x1, (const bf16*)x2}, (const bf16*)g,
                 (const bf16*)ln_scale, (const bf16*)ln_bias, (const bf16*)b0,
                 {(bf16*)d0, (bf16*)d1, (bf16*)d2}, rows};
    const bf16 *wt = (const bf16*)w0_t, *v1 = (const bf16*)w1, *v0 = (const bf16*)w0;
    if (stage == kCombination) return launch<kCombination, 2>(a, {wt, v1, v0}, blocks, s);
    if (w_in == 3 * kPart) return launch<kCompress, 3>(a, {wt, v1, v0}, blocks, s);
    return launch<kCompress, 2>(a, {wt, v1, v0}, blocks, s);
}
