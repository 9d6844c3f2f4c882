// K4 and K4-dW on Hopper in float32: the backward of PET's compress,
// combination and head row-block stages, redesigned for the H100, in two
// modes of one body. Plain mode is K4 (the input cotangents); spill mode is
// K4-dW's first pass, whose second pass is K2-dW's split-K product
// (layer_dw_sm90.cuh).
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/rowblock.py
// `_make_bwd_op` (:213; pallas_call at :279) in float32 for its three
// stages, with weight_grads=False (K4) and True (K4-dW): the hand-written
// backwards `compress_bwd` (:112), `combination_bwd` (:148) and `head_bwd`
// (:198) of metatrain_tpu/models/pet/fused_stages.py. It computes the
// function of the plain versions `compress_bwd` / `combination_bwd` /
// `head_bwd` of metatrain_tpu_torch/models/pet/fused_stages.py
// (`stage.bwd(..., weight_grads=False/True)`) at d_part = 128:
//   compress    (2 or 3 parts: w_in 256 or 384, w_hid = w_out = 128)
//                 pre = X w0 + b0, d_pre = (g w1^T) silu'(pre),
//                 d_part_i = d_pre w0_i^T
//   combination (w_in = w_hid = 256, w_out = 128; X = [edges | reversed])
//                 xn0 = (X - mean) rs, xn = xn0 ln_scale + ln_bias,
//                 pre = xn w0 + b0, d_pre = (g w1^T) silu'(pre),
//                 d_xn = d_pre w0^T, d = d_xn ln_scale,
//                 d_x = rs (d - mean(d) - xn0 mean(d xn0)),
//                 d_edges = d_x[:, :128] + g, d_reversed = d_x[:, 128:];
//                 d_messages = g is returned by the caller without a launch
//   head        (w_in = w_hid = w_out = 128)
//                 pre0 = x w0 + b0, h0 = silu(pre0), pre1 = h0 w1 + b1,
//                 d_pre1 = g silu'(pre1), d_pre0 = (d_pre1 w1^T) silu'(pre0),
//                 d_x = d_pre0 w0^T
// and K4-dW's weight gradients, summed over rows in float:
//   dw0 = X^T d_pre (compress: part_i^T d_pre per part; combination: xn^T
//   d_pre), db0 = sum d_pre, dw1 = h^T g with h = silu(pre), db1 = sum g,
//   and for the combination d ln_scale = sum d_xn xn0, d ln_bias = sum d_xn;
//   the head's dw0 = x^T d_pre0, db0 = sum d_pre0, dw1 = h0^T d_pre1, db1 =
//   sum d_pre1.
// mtt_rowblock_bwd_f32_sm90_ok is the shape rule (rowblock_sm90.cuh's);
// the wrapper sends bfloat16 K4-dW, d_pet 256 and every other shape to the
// general body (rowblock_bwd.cu).
// Its recompute up to h (the tile streaming, the LayerNorm, the pre
// products, SiLU; the head's up to pre1) is rowblock_f32_sm90.cuh's, which
// the Hopper float32 K3 (rowblock_fwd_f32_sm90.cu) runs as its forward: one
// device code, so the f32 energy's pre-activations are the ones the forces
// differentiate.
//
// What bounds it on the H100: operations. At the crystal's rows (A = 11,392
// x M = 64 = 729,088) K4 runs three products a row (pre, g w1^T, d_pre
// w0^T): 167 GFLOP for the 3-part compress, 239 for the combination; K4-dW
// also the two X^T dY products: 263 / 382 GFLOP. As three TF32 products
// each at 495 TFLOP/s that is 1.01 / 1.45 ms (K4) and 1.59 / 2.32 ms (K4-dW);
// on the FFMA pipes at 67 TFLOP/s 2.5 / 3.57 and 3.92 / 5.71 ms. The general
// body took 5-6x the FFMA bound; its causes, and what this design does:
// - every product on FFMA from float tiles, its B operand (a weight) read
//   from L2 for every product: here every product runs on mma.sync m16n8k8
//   as three TF32 products (tf32_sm90.cuh, as the Hopper float32 K2: x = hi
//   + lo split in registers, each staged chunk's products summed from zero
//   and then added), the weights staged through the ring of three 128 x 16
//   float chunks (cp.async, swizzled) in one fixed sequence per tile
//   (Chunks): compress 8 NP (pre) + 8 (g w1^T) + 8 NP (d_part), 56 chunks
//   at 3 parts and 40 at 2; combination per hidden panel of 128 columns 16
//   (pre) + 8 (g w1^T), then 2 x 16 (d_pre w0^T): 80; head 8 (pre0, w0^T)
//   + 8 (pre1, w1^T) + 8 (d_pre1 w1^T, w1) + 8 (d_pre0 w0^T, w0): 32.
// - one 64-row tile at a time, loaded by scalar loads with an integer
//   division per element: here one persistent 512-thread block per SM
//   walks a contiguous range of 64-row tiles, and the next tile's rows are
//   copied with 16-byte cp.async while this tile's products run. They do
//   not fit twice in float32 (the 3-part compress's x tile alone is 99,328
//   B; with g, d_pre and the ring 212,992 B single-buffered), so of the
//   three ways out (32-row tiles, which double every weight chunk's reads
//   and barriers per row; x streamed in k-slices beside the weight chunks,
//   which the combination's LayerNorm cannot take, since it needs whole
//   rows first; one x buffer) this body keeps one x buffer and two g
//   buffers, and lets the next tile's rows in as soon as the last read of
//   their buffer is done. In the compress that is the pre product, the
//   first of the tile's three: the next tile's parts ride in the cp.async
//   groups of the chunks after it (NextRows, in the ring's own groups, so
//   the ring's waits complete them), and its g in the groups of the tile's
//   chunks from the third on. In the combination x is read until the
//   LayerNorm backward at the tile's end, so its buffer and d_pre's swap
//   roles every tile: the next tile's edges | reversed go into this tile's
//   d_pre buffer once the last product has read it, during the LayerNorm
//   backward; g rides as in the compress. The head streams like the
//   compress (its x tile's last read is the pre0 product); h0 waits in a
//   tile of its own for the pre1 product, which then takes d_pre0, and
//   d_pre1 goes into the d_pre tile. Rows past the end are zero-filled and
//   never stored.
// - the weight gradients' products X^T dY read, add and write the block's
//   float partial in global memory for every tile (about 12 KB of L2
//   traffic a row for the combination): here the spill mode writes, once
//   per row, the operands that no input holds (compress: d_pre and h, 1,024
//   B a row: X is the parts; combination: xn, d_pre and h, 3,072 B; head:
//   d_pre0, h0 and d_pre1, 1,536 B), and per tile one float row of its
//   vector sums; the second pass then forms
//   dW = X^T dY as layer_dw_sm90.cuh's deterministic split-K product (FFMA
//   register tiles, one partial per 128 x 128 tile and slice, the slices
//   added in order, then the chunks), reading the parts and g from the
//   inputs (the head's second product takes the spilled d_pre1 in g's
//   place: dw1 = h0^T d_pre1).
// - the LayerNorm re-reading the inputs from global memory, one thread per
//   column: here its statistics come from the x tile (one warp per row),
//   xn0 = (x - mean) rs replaces x in place, and xn = xn0 ln_scale + ln_bias
//   is formed where the pre product loads its A fragments (ln_scale and
//   ln_bias in shared memory); the backward's d stays in registers (2
//   panels x 16 floats a thread), its row sums in a fixed order
//   (panel_row_sums).
// Shared memory (bytes): the ring 24,576; compress: the x tile 64 x (128 NP
// + 4) x 4, d_pre 64 x 132 x 4, two g tiles 2 x 33,792; combination: two x
// | d_pre buffers 2 x 66,560, two g tiles, ln_scale and ln_bias 2,048; rs
// 256 and the row and column sums' scratch 2,048: 227,584 at 3 parts,
// 194,816 at 2, 229,632 for the combination: one block per SM. The head:
// the compress's at 1 part and the h0 tile 64 x 132 x 4, 195,840.
// The memory the spill takes: rows go in chunks of whole waves of tiles
// whose spill stays under 512 MiB (k4dw_plan); each chunk's first pass is
// followed by its second, and the chunks' sums are added in chunk order.
// No atomics: every output element is written once by one thread, and
// every sum runs in an order fixed by the shape and the SM count, so every
// launch gives the same bits; the plain mode's input cotangents equal the
// spill mode's (one body: the spill adds stores only).

#include "layer_dw_sm90.cuh"
#include "rowblock_f32_sm90.cuh"

namespace mtt {
namespace k4f32 {
namespace {

// the tile streaming, the forward up to h (the f32 K3's), 3xTF32, the
// weight ring and the panel products
using namespace rf32;
using sm90::kRows;  // sm90's, not common.cuh's
using sm90::kThreads;
using sm90::zero;

// The layout of one instantiation (rowblock_f32_sm90.cuh Widths: NP arrays
// make up the x tile).
template <int STAGE, int NP>
struct Geo {
    using W = Widths<STAGE, NP>;
    static constexpr int W_IN = W::W_IN, W_HID = W::W_HID, LX = W::LX, PRE = W::PRE;
    static constexpr int LP = W_HID + 4;  // d_pre rows
    static constexpr int LG = kPart + 4;  // g rows
    static constexpr int NCH = STAGE == kCompress ? 16 * NP + 8 : STAGE == kHead ? 32 : 80;  // chunks per tile
    static constexpr int NV = (STAGE == kCombination ? 2 * W_IN : 0) + W_HID + kPart;  // vector row
    static constexpr int kX = kRows * LX * 4;
    static constexpr int kP = kRows * LP * 4;
    static constexpr int kG = kRows * LG * 4;
    static constexpr int kOffX = kStages * kChunk * 4;  // the ring first
    static constexpr int kOffP = kOffX + kX;            // d_pre (combination: x and d_pre swap)
    static constexpr int kOffG = kOffP + kP;
    static constexpr int kOffLn = kOffG + 2 * kG;
    static constexpr int kOffRS = kOffLn + (STAGE == kCombination ? 2 * W_IN * 4 : 0);
    static constexpr int kOffRed = kOffRS + kRows * 4;
    static constexpr int kOffH = kOffRed + 4 * kCN * 4;  // head: h0, then d_pre0 (rows of LH)
    static constexpr int kSmem = kOffH + (STAGE == kHead ? kRows * W::LH * 4 : 0);
    static_assert(STAGE == kCompress || kX == kP, "the combination's x and d_pre buffers swap");
    static_assert(kSmem <= 232448, "one block per SM");
};

struct Args {
    const float* x[3];  // (rows, 128): the parts, or edges and reversed
    const float* g;     // (rows, 128)
    const float* ln_scale;
    const float* ln_bias;
    const float* b0;    // (w_hid,)
    const float* w0_t;  // (w_hid, w_in): the pre product's B
    const float* w1;    // (w_hid, 128): g w1^T's
    const float* w0;    // (w_in, w_hid): d_pre w0^T's
    const float* w1_t;  // head: (128, w_hid): pre1's
    const float* b1;    // head: (128,)
    float* d[3];        // (rows, 128): the input cotangents
    long long rows;     // the launch's rows (spill mode: the chunk's)
    // spill mode, row r of the launch and tile t of it
    float* xn;     // combination: (rows, 256)
    float* dpre;   // (rows, w_hid): the head's d_pre0
    float* h;      // (rows, w_hid): the head's h0
    float* dpre1;  // head: (rows, 128)
    float* vec;    // (tiles, NV): [ln_scale, ln_bias,] b0, b1 sums
};

// A tile's weight chunks in the order its products consume them, each 128
// rows (n) x 16 columns (k) of a weight in its (N, K) row-major layout:
// compress: pre (w0^T, 8 NP), g w1^T (w1, 8), d_part q (w0 rows 128 q ..,
// 8 per part); combination: per hidden panel q, pre (w0^T rows 128 q ..,
// 16) and g w1^T (w1 rows 128 q .., 8), then d_pre w0^T per output panel q
// (w0 rows 128 q .., 16); head: pre0 (w0^T, 8), pre1 (w1^T, 8), d_pre1
// w1^T (w1, 8), d_pre0 w0^T (w0, 8), every weight 128 x 128.
template <int STAGE, int NP>
struct Chunks {
    const float *w0_t, *w1, *w0, *w1_t;

    __device__ const float* operator()(int c, int& ld) const {
        using G = Geo<STAGE, NP>;
        int r = c % G::NCH;
        if (STAGE == kHead) {
            const int q = r >> 3;
            ld = kPart;
            return (q == 0 ? w0_t : q == 1 ? w1_t : q == 2 ? w1 : w0) + (r & 7) * kCK;
        }
        if (STAGE == kCompress) {
            if (r < 8 * NP) {
                ld = G::W_IN;
                return w0_t + r * kCK;
            }
            r -= 8 * NP;
            ld = kPart;
            if (r < 8) return w1 + r * kCK;
            r -= 8;
            return w0 + (size_t)(r >> 3) * kCN * kPart + (r & 7) * kCK;
        }
        if (r < 48) {
            const int q = r / 24;
            r %= 24;
            if (r < 16) {
                ld = G::W_IN;
                return w0_t + (size_t)q * kCN * G::W_IN + r * kCK;
            }
            ld = kPart;
            return w1 + (size_t)q * kCN * kPart + (r - 16) * kCK;
        }
        r -= 48;
        ld = G::W_HID;
        return w0 + (size_t)(r >> 4) * kCN * G::W_HID + (r & 15) * kCK;
    }
};

// The next tile's rows, issued with the weight chunks of this tile: chunk c
// = t NCH + r carries slice r - 2 of tile t + 1's g (2 <= r < NCH) into g
// buffer (t + 1) % 2 and, in the compress (the head), slice r - PRE - 2 of
// its parts (its x) (PRE + 2 <= r < NCH: after the barrier that ends the
// pre (pre0) product, the x tile's last read) into the x tile. The
// combination's x goes in with issue_x, after the tile's last product.
template <int STAGE, int NP>
struct NextRows {
    const Args& p;  // the kernel's (grid-constant) parameters: x, g, rows
    float* X;       // the compress's x tile
    float* G;       // g buffer 0; buffer 1 follows
    long long t0;   // the block's first tile
    int T;          // the block's tiles

    static constexpr int kXUnits = Widths<STAGE, NP>::kXUnits;
    static constexpr int kGUnits = kRows * kPieces;

    __device__ void operator()(int c) const {
        using Gm = Geo<STAGE, NP>;
        const int t = c / Gm::NCH + 1, r = c % Gm::NCH;
        if (t >= T) return;
        const long long row0 = (t0 + t) * kRows;
        int lo, hi;
        if (rows_slice<Gm::NCH, 2, kGUnits>(r, lo, hi))
            copy_rows<1>({p.g, p.g, p.g}, G + (t & 1) * kRows * Gm::LG, Gm::LG, row0, p.rows, lo, hi);
        if constexpr (STAGE != kCombination) {
            if (rows_slice<Gm::NCH, Gm::PRE + 2, kXUnits>(r, lo, hi))
                copy_rows<NP>(p.x, X, Gm::LX, row0, p.rows, lo, hi);
        }
    }

    // tile t's x (all of it) into dst
    __device__ void issue_x(int t, float* dst) const {
        copy_rows<NP>(p.x, dst, Geo<STAGE, NP>::LX, (t0 + t) * kRows, p.rows, 0, kXUnits);
    }

    __device__ void issue_g(int t) const {
        copy_rows<1>({p.g, p.g, p.g}, G + (t & 1) * kRows * Geo<STAGE, NP>::LG, Geo<STAGE, NP>::LG,
                     (t0 + t) * kRows, p.rows, 0, kGUnits);
    }
};

// d_pre = d_h silu'(pre), pre with its bias
__device__ __forceinline__ float d_pre(float dh, float pre) { return dh * silu_grad(pre); }

// Two floats to global memory, marked evict-first: the spill is read once,
// by the second pass, and must not push the weights out of L2.
__device__ __forceinline__ void spill2(float* p, float x, float y) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(x, y));
}

// compress, one tile: x (64 x LX) and g in shared memory
template <int NP, bool SP, typename R>
__device__ __forceinline__ void compress_tile(R& ring, int& c, const Args& p, const float* X, const float* Gt,
                                              float* DP, float* RED, long long t, int valid) {
    using G = Geo<kCompress, NP>;
    const long long row0 = t * kRows;
    float pre[4][4], dh[4][4];
    compress_pre<NP>(ring, c, X, p.b0, pre);
    zero(dh);
    panel_mm<8>(ring, c, [&](int r, int& ld) { ld = G::LG; return Gt + r * kCK; }, dh, kRows);
    // d_pre into DP and dh; the spill: d_pre and h = silu(pre)
    panel_pairs([&](int j, int h, int m, int n) {
        const float p0 = pre[j][2 * h], p1 = pre[j][2 * h + 1];
        dh[j][2 * h] = d_pre(dh[j][2 * h], p0);
        dh[j][2 * h + 1] = d_pre(dh[j][2 * h + 1], p1);
        st2(DP + m * G::LP + n, dh[j][2 * h], dh[j][2 * h + 1]);
        if constexpr (SP) {
            if (m < valid) {
                const size_t o = (size_t)(row0 + m) * kPart + n;
                spill2(p.dpre + o, dh[j][2 * h], dh[j][2 * h + 1]);
                spill2(p.h + o, hidden(p0), hidden(p1));
            }
        }
    });
    if constexpr (SP) {
        float* v = p.vec + t * G::NV;
        panel_col_sums(RED, [&](int j, int i, int m, int n) { return m < valid ? dh[j][i] : 0.f; }, v);
        panel_col_sums(RED, [&](int j, int i, int m, int n) { return Gt[m * G::LG + n]; }, v + G::W_HID);
    }
    // d_part q = d_pre w0_q^T: one 64 x 128 panel per part
#pragma unroll
    for (int q = 0; q < NP; ++q) {
        float acc[4][4];
        zero(acc);
        panel_mm<8>(ring, c, [&](int r, int& ld) { ld = G::LP; return (const float*)DP + r * kCK; }, acc, kRows);
        float* out = p.d[q] + row0 * kPart;
        panel_pairs([&](int j, int h, int m, int n) {
            if (m < valid) st2(out + (size_t)m * kPart + n, acc[j][2 * h], acc[j][2 * h + 1]);
        });
    }
}

// head, one tile: x (64 x LX) and g in shared memory; H takes h0, then
// d_pre0 (after the d_pre1 w1^T product, behind the pre1 product's last
// read), DP d_pre1
template <bool SP, typename R>
__device__ __forceinline__ void head_tile(R& ring, int& c, const Args& p, const float* X, const float* Gt,
                                          float* DP, float* H, float* RED, long long t, int valid) {
    using G = Geo<kHead, 1>;
    constexpr int LH = G::W::LH;
    const long long row0 = t * kRows;
    float pre0[4][4], pre1[4][4];
    head_pre1(ring, c, X, H, p.b0, p.b1, pre0, pre1);
    // d_pre1 = g silu'(pre1) into DP and pre1's registers; the spill: d_pre1
    // and h0 (each thread's own elements of H)
    panel_pairs([&](int j, int h, int m, int n) {
        const float2 g = ld2(Gt + m * G::LG + n);
        pre1[j][2 * h] = d_pre(g.x, pre1[j][2 * h]);
        pre1[j][2 * h + 1] = d_pre(g.y, pre1[j][2 * h + 1]);
        st2(DP + m * G::LP + n, pre1[j][2 * h], pre1[j][2 * h + 1]);
        if constexpr (SP) {
            if (m < valid) {
                const size_t o = (size_t)(row0 + m) * kPart + n;
                const float2 h0 = ld2(H + m * LH + n);
                spill2(p.dpre1 + o, pre1[j][2 * h], pre1[j][2 * h + 1]);
                spill2(p.h + o, h0.x, h0.y);
            }
        }
    });
    float* v = p.vec + t * G::NV;  // spill mode: b0, b1 sums
    if constexpr (SP)
        panel_col_sums(RED, [&](int j, int i, int m, int n) { return m < valid ? pre1[j][i] : 0.f; },
                       v + G::W_HID);
    // d_h0 = d_pre1 w1^T; d_pre0 = d_h0 silu'(pre0) into H
    float dh[4][4];
    zero(dh);
    panel_mm<8>(ring, c, [&](int r, int& ld) { ld = G::LP; return (const float*)DP + r * kCK; }, dh, kRows);
    panel_pairs([&](int j, int h, int m, int n) {
        dh[j][2 * h] = d_pre(dh[j][2 * h], pre0[j][2 * h]);
        dh[j][2 * h + 1] = d_pre(dh[j][2 * h + 1], pre0[j][2 * h + 1]);
        st2(H + m * LH + n, dh[j][2 * h], dh[j][2 * h + 1]);
        if constexpr (SP) {
            if (m < valid) spill2(p.dpre + (size_t)(row0 + m) * kPart + n, dh[j][2 * h], dh[j][2 * h + 1]);
        }
    });
    if constexpr (SP)
        panel_col_sums(RED, [&](int j, int i, int m, int n) { return m < valid ? dh[j][i] : 0.f; }, v);
    // d_x = d_pre0 w0^T
    float acc[4][4];
    zero(acc);
    panel_mm<8>(ring, c, [&](int r, int& ld) { ld = LH; return (const float*)H + r * kCK; }, acc, kRows);
    float* out = p.d[0] + row0 * kPart;
    panel_pairs([&](int j, int h, int m, int n) {
        if (m < valid) st2(out + (size_t)m * kPart + n, acc[j][2 * h], acc[j][2 * h + 1]);
    });
}

// combination, one tile: X (xn0 after the LayerNorm) and g in shared
// memory, DP the other x | d_pre buffer; LN holds ln_scale then ln_bias.
// The next tile's x goes into DP after the last product (next_x).
template <bool SP, typename R, typename N>
__device__ __forceinline__ void combination_tile(R& ring, int& c, const Args& p, float* X, const float* Gt,
                                                 float* DP, const float* LN, float* RS, float* RED, long long t,
                                                 int valid, N next_x) {
    using G = Geo<kCombination, 2>;
    const long long row0 = t * kRows;
    cp_async_wait<0>();  // this tile's x
    __syncthreads();
    // the spill mode writes xn = xn0 ln_scale + ln_bias for the valid rows
    layer_norm_rows(X, RS, [&](int m, int col, float4 y) {
        if constexpr (SP) {
            if (m < valid) {
                constexpr int W = G::W_IN;
                const float4 ls = *reinterpret_cast<const float4*>(LN + col);
                const float4 lb = *reinterpret_cast<const float4*>(LN + W + col);
                __stcs(reinterpret_cast<float4*>(p.xn + (size_t)(row0 + m) * W + col),
                       make_float4(fmaf(y.x, ls.x, lb.x), fmaf(y.y, ls.y, lb.y), fmaf(y.z, ls.z, lb.z),
                                   fmaf(y.w, ls.w, lb.w)));
            }
        }
    });
    // (the first consume's barrier orders these stores before the reads)
    float* v = p.vec + t * G::NV;  // spill mode: ln_scale, ln_bias, b0, b1 sums

    // per hidden panel q: pre = xn w0 + b0, xn formed as the A fragments
    // load; d_h = g w1^T; d_pre = d_h silu'(pre) into DP (columns 128 q ..)
#pragma unroll 1
    for (int q = 0; q < 2; ++q) {
        float pre[4][4], dh[4][4];
        combination_pre(ring, c, X, LN, p.b0, q, pre);
        zero(dh);
        panel_mm<8>(ring, c, [&](int r, int& ld) { ld = G::LG; return Gt + r * kCK; }, dh, kRows);
        panel_pairs([&](int j, int h, int m, int n) {
            const int col = q * kCN + n;
            const float p0 = pre[j][2 * h], p1 = pre[j][2 * h + 1];
            dh[j][2 * h] = d_pre(dh[j][2 * h], p0);
            dh[j][2 * h + 1] = d_pre(dh[j][2 * h + 1], p1);
            st2(DP + m * G::LP + col, dh[j][2 * h], dh[j][2 * h + 1]);
            if constexpr (SP) {
                if (m < valid) {
                    const size_t o = (size_t)(row0 + m) * G::W_HID + col;
                    spill2(p.dpre + o, dh[j][2 * h], dh[j][2 * h + 1]);
                    spill2(p.h + o, hidden(p0), hidden(p1));
                }
            }
        });
        if constexpr (SP)
            panel_col_sums(RED, [&](int j, int i, int m, int n) { return m < valid ? dh[j][i] : 0.f; },
                           v + 2 * G::W_IN + q * kCN);
    }

    // d_xn = d_pre w0^T, in registers: dx[q] holds columns 128 q ..
    float dx[2][4][4];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        zero(dx[q]);
        panel_mm<16>(ring, c, [&](int r, int& ld) { ld = G::LP; return (const float*)DP + r * kCK; }, dx[q],
                     kRows);
    }
    __syncthreads();  // every warp has read DP: the next tile's x may land there
    next_x(DP);

    const auto xn0 = [&](int m, int col) { return X[m * G::LX + col]; };
    if constexpr (SP) {
        // d ln_scale = sum d_xn xn0, d ln_bias = sum d_xn (before ln_scale)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            panel_col_sums(RED, [&](int j, int i, int m, int n) {
                return m < valid ? dx[q][j][i] * xn0(m, q * kCN + n) : 0.f;
            }, v + q * kCN);
            panel_col_sums(RED, [&](int j, int i, int m, int n) { return m < valid ? dx[q][j][i] : 0.f; },
                           v + G::W_IN + q * kCN);
        }
        panel_col_sums(RED, [&](int j, int i, int m, int n) { return Gt[m * G::LG + n]; },
                       v + 2 * G::W_IN + G::W_HID);
    }
    // d = d_xn ln_scale; LayerNorm backward: d_x = rs (d - mean(d) - xn0
    // mean(d xn0))
    panel_each([&](int j, int i, int m, int n) {
        dx[0][j][i] *= LN[n];
        dx[1][j][i] *= LN[kCN + n];
    });
    float sa[2], sb[2];
    panel_row_sums(RED, [&](int j, int i, int m, int n) { return dx[0][j][i] + dx[1][j][i]; }, sa);
    panel_row_sums(RED, [&](int j, int i, int m, int n) {
        return dx[0][j][i] * xn0(m, n) + dx[1][j][i] * xn0(m, kCN + n);
    }, sb);
    panel_pairs([&](int j, int h, int m, int n) {
        if (m >= valid) return;
        const float rs = RS[m], ma = sa[h] / G::W_IN, mb = sb[h] / G::W_IN;
        const float2 g = ld2(Gt + m * G::LG + n);
        const size_t o = (size_t)(row0 + m) * kPart + n;
        st2(p.d[0] + o, rs * (dx[0][j][2 * h] - ma - xn0(m, n) * mb) + g.x,
            rs * (dx[0][j][2 * h + 1] - ma - xn0(m, n + 1) * mb) + g.y);
        st2(p.d[1] + o, rs * (dx[1][j][2 * h] - ma - xn0(m, kCN + n) * mb),
            rs * (dx[1][j][2 * h + 1] - ma - xn0(m, kCN + n + 1) * mb));
    });
}

// SP: K4-dW's first pass (the spill mode). p is grid-constant: the spill's
// pointers are read from the parameters where they are written.
template <int STAGE, int NP, bool SP>
__global__ void __launch_bounds__(kThreads, 1) k4_f32_sm90_kernel(const __grid_constant__ Args p) {
    using G = Geo<STAGE, NP>;
    extern __shared__ __align__(16) unsigned char smem[];
    float* XB = reinterpret_cast<float*>(smem + G::kOffX);
    float* PB = reinterpret_cast<float*>(smem + G::kOffP);
    float* GB = reinterpret_cast<float*>(smem + G::kOffG);
    float* LN = reinterpret_cast<float*>(smem + G::kOffLn);
    float* RS = reinterpret_cast<float*>(smem + G::kOffRS);
    float* RED = reinterpret_cast<float*>(smem + G::kOffRed);
    float* HB = reinterpret_cast<float*>(smem + G::kOffH);

    const long long tiles = (p.rows + kRows - 1) / kRows;
    const long long t0 = tiles * blockIdx.x / gridDim.x, t1 = tiles * (blockIdx.x + 1) / gridDim.x;
    const int T = (int)(t1 - t0);
    if (T == 0) return;
    const NextRows<STAGE, NP> next{p, XB, GB, t0, T};
    next.issue_x(0, XB);  // tile 0, one cp.async group
    next.issue_g(0);
    cp_async_commit();
    if constexpr (STAGE == kCombination) {
        for (int k = threadIdx.x; k < G::W_IN; k += kThreads) {
            LN[k] = p.ln_scale[k];
            LN[G::W_IN + k] = p.ln_bias[k];
        }
    }
    Ring<Chunks<STAGE, NP>, NextRows<STAGE, NP>> ring{reinterpret_cast<float*>(smem),
                                                      Chunks<STAGE, NP>{p.w0_t, p.w1, p.w0, p.w1_t}, T * G::NCH,
                                                      next};
    ring.start();
    int c = 0;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
        const long long tile = t0 + t;
        const int valid = (int)min((long long)kRows, p.rows - tile * kRows);
        const float* Gt = GB + (t & 1) * kRows * G::LG;
        if constexpr (STAGE == kCompress) {
            compress_tile<NP, SP>(ring, c, p, XB, Gt, PB, RED, tile, valid);
        } else if constexpr (STAGE == kHead) {
            head_tile<SP>(ring, c, p, XB, Gt, PB, HB, RED, tile, valid);
        } else {
            // tile t's x is in buffer t % 2 (XB, PB); the other one takes d_pre
            float* X = (t & 1) ? PB : XB;
            float* DP = (t & 1) ? XB : PB;
            combination_tile<SP>(ring, c, p, X, Gt, DP, LN, RS, RED, tile, valid, [&](float* dst) {
                if (t + 1 < T) next.issue_x(t + 1, dst);
                cp_async_commit();
            });
        }
    }
    cp_async_wait<0>();
}

// Offsets of the weight gradients in dw, in the order of the stage's
// weights ([ln_scale, ln_bias,] w0, b0, w1, b1), as rowblock_bwd.cu's.
struct DwLayout {
    long long ln_scale, ln_bias, w0, b0, w1, b1, total;
    __host__ __device__ DwLayout(int stage, int w_in, int w_hid, int w_out) {
        const long long ln = stage == kCombination ? w_in : 0;
        ln_scale = 0;
        ln_bias = ln;
        w0 = 2 * ln;
        b0 = w0 + (long long)w_in * w_hid;
        w1 = b0 + w_hid;
        b1 = w1 + (long long)w_hid * w_out;
        total = b1 + w_out;
    }
};

bool takes(int stage, int d_part, int w_in, int w_hid, int w_out) {
    return sm90::rowblock_sm90_ok(stage, d_part, w_in, w_hid, w_out);
}

size_t smem_bytes(int stage, int w_in) {
    if (stage == kCombination) return Geo<kCombination, 2>::kSmem;
    if (stage == kHead) return Geo<kHead, 1>::kSmem;
    return w_in == 3 * kPart ? Geo<kCompress, 3>::kSmem : Geo<kCompress, 2>::kSmem;
}

int vector_floats(int stage, int w_in, int w_hid) {
    return (stage == kCombination ? 2 * w_in : 0) + w_hid + kPart;
}

// The spilled floats a row: compress d_pre and h; combination also xn;
// head d_pre0, h0 and d_pre1.
int row_floats(int stage, int w_in, int w_hid) {
    return stage == kHead ? 3 * w_hid : (stage == kCombination ? w_in : 0) + 2 * w_hid;
}

// The products' output tiles: compress one per part and h^T g; combination
// xn^T d_pre (2 x 2) and h^T g (2 x 1); head x^T d_pre0 and h0^T d_pre1.
int product_tiles(int stage, int n_parts) { return stage == kCombination ? 6 : n_parts + 1; }

struct Plan {
    long long chunk_tiles;  // 64-row tiles a chunk (the last one may hold fewer)
    long long chunks;
    long long vec_offset;   // bytes: the vector rows start here in the spill
    long long spill_bytes;  // the spill of one chunk: operand rows, then vector rows
    long long max_slices;   // partials to allocate
};

// As many tiles a chunk as keep its spill (row_floats a row, vector_floats
// a tile, float32) under kSpillCap; where that is not all of them, a
// multiple of the SM count (whole waves of the first pass), the last chunk
// holding the rest.
Plan make_plan(int stage, long long rows, int w_in, int w_hid, int sms) {
    Plan p{};
    const long long tiles = (rows + kRows - 1) / kRows;
    if (tiles <= 0) return p;
    const long long row_bytes = 4LL * row_floats(stage, w_in, w_hid);
    const long long tile_bytes = kRows * row_bytes + 4LL * vector_floats(stage, w_in, w_hid);
    long long per = dwp::kSpillCap / tile_bytes;
    if (per < 1) per = 1;
    if (per < tiles && per > sms) per = per / sms * sms;
    if (per > tiles) per = tiles;
    p.chunk_tiles = per;
    p.chunks = (tiles + per - 1) / per;
    p.vec_offset = (per * kRows * row_bytes + 255) / 256 * 256;
    p.spill_bytes = p.vec_offset + per * 4LL * vector_floats(stage, w_in, w_hid);
    const int np = w_in / kPart;
    const long long chunk_rows = per * kRows < rows ? per * kRows : rows;
    p.max_slices = dwp::slice_target_tiles(chunk_rows, product_tiles(stage, np), sms);
    return p;
}

template <int STAGE, int NP, bool SP>
int launch_mode(const Args& a, int blocks, cudaStream_t stream) {
    const int bytes = Geo<STAGE, NP>::kSmem;
    cudaError_t err = cudaFuncSetAttribute(k4_f32_sm90_kernel<STAGE, NP, SP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    k4_f32_sm90_kernel<STAGE, NP, SP><<<(unsigned)blocks, kThreads, bytes, stream>>>(a);
    return (int)cudaGetLastError();
}

template <bool SP>
int launch(int stage, int w_in, const Args& a, int blocks, cudaStream_t stream) {
    if (stage == kCombination) return launch_mode<kCombination, 2, SP>(a, blocks, stream);
    if (stage == kHead) return launch_mode<kHead, 1, SP>(a, blocks, stream);
    if (w_in == 3 * kPart) return launch_mode<kCompress, 3, SP>(a, blocks, stream);
    return launch_mode<kCompress, 2, SP>(a, blocks, stream);
}

// The second pass's products over a chunk of `rows` rows: x the chunk's
// parts (the head's x), g its cotangent, xn, dpre, h and dpre1 the chunk's
// spill arrays. The head's are the one-part compress's with d_pre1 in g's
// place.
dwp::ProductArgs<float> product_args(int stage, const float* const (&x)[3], int n_parts, const float* g,
                                     const float* xn, const float* dpre, const float* h, const float* dpre1,
                                     long long rows, int w_in, int w_hid, int sms, float* partials) {
    const DwLayout L(stage, w_in, w_hid, kPart);
    dwp::ProductArgs<float> a{};
    if (stage != kCombination) {
        for (int q = 0; q < n_parts; ++q) {
            a.X[q] = x[q];
            a.Y[q] = dpre;
            a.ldx[q] = a.ldy[q] = a.ldo[q] = kPart;
            a.out[q] = L.w0 + (long long)q * kPart * w_hid;
            a.tr[q] = a.tc[q] = 1;
        }
        a.X[n_parts] = h;
        a.Y[n_parts] = stage == kHead ? dpre1 : g;
        a.ldx[n_parts] = a.ldy[n_parts] = a.ldo[n_parts] = kPart;
        a.out[n_parts] = L.w1;
        a.tr[n_parts] = a.tc[n_parts] = 1;
    } else {
        a.X[0] = xn;
        a.Y[0] = dpre;
        a.ldx[0] = w_in;
        a.ldy[0] = a.ldo[0] = w_hid;
        a.out[0] = L.w0;
        a.tr[0] = w_in / dwp::kTile;
        a.tc[0] = w_hid / dwp::kTile;
        a.X[1] = h;
        a.Y[1] = g;
        a.ldx[1] = w_hid;
        a.ldy[1] = a.ldo[1] = kPart;
        a.out[1] = L.w1;
        a.tr[1] = w_hid / dwp::kTile;
        a.tc[1] = 1;
    }
    a.tiles = product_tiles(stage, n_parts);
    a.geo_q = -1;
    a.rows = rows;
    a.step = dwp::slice_step_tiles(rows, a.tiles, sms);
    a.M = 1;
    a.partials = partials;
    a.n_dw = L.total;
    return a;
}

dwp::VecMap vec_map(int stage, int w_in, int w_hid) {
    const DwLayout L(stage, w_in, w_hid, kPart);
    if (stage != kCombination)  // compress b0, b1 (g); head b0 (d_pre0), b1 (d_pre1)
        return dwp::VecMap{{w_hid, kPart, 0, 0, 0, 0}, {L.b0, L.b1, 0, 0, 0, 0}, w_hid + kPart};
    return dwp::VecMap{{w_in, w_in, w_hid, kPart, 0, 0},
                       {L.ln_scale, L.ln_bias, L.b0, L.b1, 0, 0},
                       vector_floats(stage, w_in, w_hid)};
}

// The spill's arrays (R rows each): compress d_pre, h; combination xn,
// d_pre, h; head d_pre0, h0, d_pre1.
void spill_arrays(int stage, float* spill, long long R, int w_in, int w_hid, float*& xn, float*& dpre, float*& h,
                  float*& dpre1) {
    xn = stage == kCombination ? spill : nullptr;
    dpre = spill + (stage == kCombination ? R * w_in : 0);
    h = dpre + R * w_hid;
    dpre1 = stage == kHead ? h + R * w_hid : nullptr;
}

bool valid_call(int stage, int n_parts, int d_part, int w_in, int w_hid, int w_out) {
    return takes(stage, d_part, w_in, w_hid, w_out) &&
           (stage == kCombination ? n_parts == 3 : n_parts * d_part == w_in);
}

// The head's recompute also takes w1^T and b1 (its pre1 product).
bool valid_call(int stage, int n_parts, int d_part, int w_in, int w_hid, int w_out, const float* w1_t,
                const float* b1) {
    return valid_call(stage, n_parts, d_part, w_in, w_hid, w_out) && (stage != kHead || (w1_t && b1));
}

}  // namespace
}  // namespace k4f32
}  // namespace mtt

// Whether the Hopper float32 K4 takes a stage (0 compress, 1 combination, 2
// head) and its widths: those of the Hopper K4 (rowblock_sm90.cuh), d_part
// 128.
extern "C" int mtt_rowblock_bwd_f32_sm90_ok(int stage, int d_part, int w_in, int w_hid, int w_out) {
    return mtt::k4f32::takes(stage, d_part, w_in, w_hid, w_out) ? 1 : 0;
}

// Its shared memory per block (both modes), 0 where it does not take the stage.
extern "C" size_t mtt_rowblock_bwd_f32_sm90_smem(int stage, int d_part, int w_in, int w_hid, int w_out) {
    if (!mtt::k4f32::takes(stage, d_part, w_in, w_hid, w_out)) return 0;
    return mtt::k4f32::smem_bytes(stage, w_in);
}

// The two-pass K4-dW's plan for `rows` rows on a card of `sms` SMs into out:
// tiles a chunk, chunks, the vector rows' byte offset, the spill's bytes,
// the partials' rows.
extern "C" void mtt_rowblock_bwd_dw_f32_sm90_plan(int stage, long long rows, int w_in, int w_hid, int w_out,
                                                  int sms, long long* out) {
    const mtt::k4f32::Plan p = mtt::k4f32::make_plan(stage, rows, w_in, w_hid, sms);
    out[0] = p.chunk_tiles;
    out[1] = p.chunks;
    out[2] = p.vec_offset;
    out[3] = p.spill_bytes;
    out[4] = p.max_slices;
}

// float32 tensors. x0..x2: the compress parts (n_parts of them) or edges,
// reversed and messages (n_parts 3; the messages are not read), or the
// head's x (n_parts 1); b0 (w_hid), w0_t (w_hid, w_in), w1 (w_hid, w_out),
// w0 (w_in, w_hid), w1_t (w_out, w_hid; the head's, else unread), b1
// (w_out; the head's, else unread); g (rows, w_out); d0..d2 receive the
// input cotangents (one per part, or d_edges and d_reversed, or d_x).
// `blocks` persistent blocks (one per SM) walk contiguous ranges of 64-row
// tiles on `stream`. Returns the CUDA error code (cudaErrorInvalidValue for
// a shape it does not take).
extern "C" int mtt_rowblock_bwd_f32_sm90(int stage, const float* x0, const float* x1, const float* x2,
                                         int n_parts, const float* ln_scale, const float* ln_bias, const float* b0,
                                         const float* w0_t, const float* w1, const float* w0, const float* w1_t,
                                         const float* b1, const float* g, float* d0, float* d1, float* d2,
                                         long long rows, int d_part, int w_in, int w_hid, int w_out, int blocks,
                                         void* stream) {
    using namespace mtt::k4f32;
    if (!valid_call(stage, n_parts, d_part, w_in, w_hid, w_out, w1_t, b1) || blocks <= 0)
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    const Args a{{x0, x1, x2}, g, ln_scale, ln_bias, b0, w0_t, w1, w0, w1_t, b1, {d0, d1, d2}, rows,
                 nullptr, nullptr, nullptr, nullptr, nullptr};
    return launch<false>(stage, w_in, a, blocks, (cudaStream_t)stream);
}

// K4-dW: as mtt_rowblock_bwd_f32_sm90, and dw (the stage's weights' floats,
// in their order: [ln_scale, ln_bias,] w0, b0, w1, b1) receives the weight
// gradients. spill: the plan's spill_bytes; partials: (max_slices, n_dw)
// floats. Per chunk of the plan: the body's spill mode on the chunk's tiles
// (one block per SM at most), then the second pass into dw.
extern "C" int mtt_rowblock_bwd_dw_f32_sm90(int stage, const float* x0, const float* x1, const float* x2,
                                            int n_parts, const float* ln_scale, const float* ln_bias,
                                            const float* b0, const float* w0_t, const float* w1, const float* w0,
                                            const float* w1_t, const float* b1, const float* g, float* d0,
                                            float* d1, float* d2, float* dw, void* spill, float* partials,
                                            long long rows, int d_part, int w_in, int w_hid, int w_out, int sms,
                                            void* stream) {
    using namespace mtt::k4f32;
    if (!valid_call(stage, n_parts, d_part, w_in, w_hid, w_out, w1_t, b1) || sms <= 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const long long n_dw = DwLayout(stage, w_in, w_hid, w_out).total;
    if (rows == 0) return (int)cudaMemsetAsync(dw, 0, n_dw * sizeof(float), s);
    const Plan plan = make_plan(stage, rows, w_in, w_hid, sms);
    float *xn, *dpre, *h, *dpre1;
    spill_arrays(stage, (float*)spill, plan.chunk_tiles * mtt::sm90::kRows, w_in, w_hid, xn, dpre, h, dpre1);
    float* vec = (float*)((unsigned char*)spill + plan.vec_offset);
    const long long chunk_rows = plan.chunk_tiles * mtt::sm90::kRows;
    for (long long k = 0; k < plan.chunks; ++k) {
        const long long r0 = k * chunk_rows, n = rows - r0 < chunk_rows ? rows - r0 : chunk_rows;
        const auto at = [&](auto* ptr) { return ptr == nullptr ? ptr : ptr + r0 * d_part; };
        const float* const x[3] = {at(x0), at(x1), at(x2)};
        const Args a{{x[0], x[1], x[2]}, g + r0 * w_out, ln_scale, ln_bias, b0, w0_t, w1, w0, w1_t, b1,
                     {at(d0), at(d1), at(d2)}, n, xn, dpre, h, dpre1, vec};
        const long long tiles = (n + mtt::sm90::kRows - 1) / mtt::sm90::kRows;
        int err = launch<true>(stage, w_in, a, (int)(tiles < sms ? tiles : sms), s);
        if (err != 0) return err;
        const auto pa =
            product_args(stage, x, n_parts, g + r0 * w_out, xn, dpre, h, dpre1, n, w_in, w_hid, sms, partials);
        err = mtt::dwp::run_products<float>(pa, vec, tiles, vec_map(stage, w_in, w_hid), dw, k == 0, s);
        if (err != 0) return err;
    }
    return 0;
}

// The second pass alone on one chunk of `rows` rows (for checks against its
// plain version): spill holds the chunk's operand arrays (rows rows each:
// compress d_pre, h; combination xn, d_pre, h; head d_pre0, h0, d_pre1), vec
// its tiles' vector rows;
// x0..x2 and g the chunk's inputs. dw receives its weight gradients.
extern "C" int mtt_rowblock_dw_product(int stage, const float* x0, const float* x1, const float* x2, int n_parts,
                                       const float* g, const float* spill, const float* vec, long long rows,
                                       int w_in, int w_hid, int w_out, int sms, float* partials, float* dw,
                                       void* stream) {
    using namespace mtt::k4f32;
    if (!valid_call(stage, n_parts, kPart, w_in, w_hid, w_out) || rows <= 0 || sms <= 0)
        return (int)cudaErrorInvalidValue;
    float *xn, *dpre, *h, *dpre1;
    spill_arrays(stage, (float*)spill, rows, w_in, w_hid, xn, dpre, h, dpre1);
    const float* const x[3] = {x0, x1, x2};
    const auto pa = product_args(stage, x, n_parts, g, xn, dpre, h, dpre1, rows, w_in, w_hid, sms, partials);
    const long long tiles = (rows + mtt::sm90::kRows - 1) / mtt::sm90::kRows;
    return mtt::dwp::run_products<float>(pa, vec, tiles, vec_map(stage, w_in, w_hid), dw, true,
                                         (cudaStream_t)stream);
}
