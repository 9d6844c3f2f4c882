// The float32 compress and combination forward on Hopper up to h, and the
// head's up to pre1, shared by the Hopper float32 K3
// (rowblock_fwd_f32_sm90.cu), which runs it as its forward, and the Hopper
// float32 K4 and K4-dW's first pass (rowblock_bwd_f32_sm90.cu), which run
// it as their recompute: one device code in one order, so the f32
// forward's pre, xn and h (the head's pre0, h0 and pre1) and the
// backward's are the same bits, and the f32 row-block stages' energy and
// forces come from one function. It holds, in the order the kernels run
// them:
// - copy_rows and rows_slice: the tile streaming. A tile's rows are copied
//   with 16-byte cp.async (rows past the end zero-filled); the next tile's
//   rows ride in slices in the cp.async groups of the weight chunks from a
//   given chunk of the tile on (each kernel's NextRows), so the ring's own
//   waits complete them;
// - layer_norm_rows: the combination's LayerNorm, xn0 in place and rs;
// - compress_pre: pre = X w0 + b0 over the ring's next 8 NP chunks;
// - combination_pre: hidden panel q of pre = xn w0 + b0 over the next 16,
//   xn = xn0 ln_scale + ln_bias formed where the A fragments load;
// - hidden: h = silu(pre);
// - head_pre1: the head's pre0 = X w0 + b0 (compress_pre over 8 chunks),
//   h0 = silu(pre0) into an h tile, pre1 = h0 w1 + b1 over the next 8.
// The 3xTF32 helpers, the weight ring and the panel product are
// tf32_sm90.cuh's; an edit here changes both kernels (check the f32 K4's
// and K4-dW's digests with tools/layer_times.py, parent vs change, and
// tools/sm90_front.py --kernel rowblock: the f32 K3's pre, h, xn0 and rs
// equal to the f32 K4 recompute's).

#pragma once

#include "rowblock_sm90.cuh"
#include "tf32_sm90.cuh"

namespace mtt {
namespace rf32 {

using namespace tf32;  // 3xTF32, the weight ring, the panel products
using sm90::kRows;  // sm90's, not common.cuh's
using sm90::kThreads;
using sm90::zero;

enum Stage { kCompress = 0, kCombination = 1, kHead = 2 };
constexpr int kPart = 128;          // d_part = w_out: every streamed and written row
constexpr int kPieces = kPart / 4;  // 16-byte copies per row of one array

// The widths of an instantiation: NP arrays make up the x tile (compress:
// the parts; combination: edges and reversed; head: x, NP = 1).
template <int STAGE, int NP>
struct Widths {
    static_assert(STAGE != kHead || NP == 1, "the head takes one input");
    static constexpr int W_IN = NP * kPart;
    static constexpr int W_HID = STAGE == kCombination ? 2 * kPart : kPart;
    static constexpr int LX = W_IN + 4;                              // x (xn0) rows, floats
    static constexpr int LH = W_HID + 4;                             // h (h0) rows, floats
    static constexpr int PRE = STAGE == kCombination ? 16 : 8 * NP;  // chunks of a pre product
    static constexpr int kXUnits = kRows * NP * kPieces;             // 16-byte pieces of the x tile
};

// Units [lo, hi) of a tile's rows from row0 (of `rows`): unit u is 16-byte
// piece u % 32 of row u / 32 % 64 of array u / 2048, copied to dst (rows of
// ld floats, array a at column 128 a); rows past the end zero-filled.
template <int NA>
__device__ __forceinline__ void copy_rows(const float* const (&src)[3], float* dst, int ld, long long row0,
                                          long long rows, int lo, int hi) {
    for (int u = lo + threadIdx.x; u < hi; u += kThreads) {
        const int a = u / (kRows * kPieces), row = (u / kPieces) % kRows, piece = u % kPieces;
        const bool valid = row0 + row < rows;
        const float* s = src[0];
#pragma unroll
        for (int k = 1; k < NA; ++k)
            if (a == k) s = src[k];  // a select, not an indexed (local-memory) load
        sm90::cp_async16_zfill(dst + row * ld + a * kPart + piece * 4,
                               valid ? s + (row0 + row) * kPart + piece * 4 : s, valid ? 16 : 0);
    }
}

// The streaming scheme: UNITS pieces of rows spread evenly over the carrier
// chunks FIRST .. NCH - 1 of a tile; chunk r (of the tile's NCH) carries
// [lo, hi). False where it carries none.
template <int NCH, int FIRST, int UNITS>
__device__ __forceinline__ bool rows_slice(int r, int& lo, int& hi) {
    static_assert(FIRST < NCH, "at least one carrier chunk");
    constexpr int n = (UNITS + NCH - FIRST - 1) / (NCH - FIRST);
    lo = (r - FIRST) * n;
    hi = min(UNITS, lo + n);
    return r >= FIRST && lo < hi;
}

// No stores beside the LayerNorm's own.
struct NoOut {
    __device__ void operator()(int, int, float4) const {}
};

// The combination's LayerNorm over the 64 rows of X = [edges | reversed]
// (rows of LX): per row rs = rsqrt(var + 1e-5) (two passes) to RS[m] and
// xn0 = (x - mean) rs in place; out(m, col, xn0) is called for each four
// columns stored (K4-dW's spill writes xn there). One warp per row, lane l
// on columns 4 l .. 4 l + 3 and 128 + 4 l .. + 3.
template <typename Out = NoOut>
__device__ __forceinline__ void layer_norm_rows(float* X, float* RS, Out out = {}) {
    constexpr int W = 2 * kPart, LX = W + 4;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int m = warp; m < kRows; m += kThreads / 32) {
        float4* x = reinterpret_cast<float4*>(X + m * LX);
        float4 v[2] = {x[lane], x[32 + lane]};
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 2; ++k) s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
        const float mean = warp_sum(s) / W;
        float var = 0.f;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            v[k] = make_float4(v[k].x - mean, v[k].y - mean, v[k].z - mean, v[k].w - mean);
            var = fmaf(v[k].x, v[k].x, fmaf(v[k].y, v[k].y, fmaf(v[k].z, v[k].z, fmaf(v[k].w, v[k].w, var))));
        }
        const float rs = rsqrtf(warp_sum(var) / W + 1e-5f);
        if (lane == 0) RS[m] = rs;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const float4 y = make_float4(v[k].x * rs, v[k].y * rs, v[k].z * rs, v[k].w * rs);
            x[32 * k + lane] = y;
            out(m, 128 * k + 4 * lane, y);
        }
    }
}

// acc += b (columns of the panel)
__device__ __forceinline__ void add_bias(float (&acc)[4][4], const float* b) {
    panel_pairs([&](int j, int h, int m, int n) {
        const float2 v = ld2(b + n);
        acc[j][2 * h] += v.x;
        acc[j][2 * h + 1] += v.y;
    });
}

// compress: pre = X w0 + b0 over the ring's next 8 NP chunks (w0^T), in the
// panel layout; X the x tile (the parts side by side, rows of LX).
template <int NP, typename R>
__device__ __forceinline__ void compress_pre(R& ring, int& c, const float* X, const float* b0, float (&pre)[4][4]) {
    using W = Widths<kCompress, NP>;
    zero(pre);
    panel_mm<W::PRE>(ring, c, [&](int r, int& ld) { ld = W::LX; return X + r * kCK; }, pre, kRows);
    add_bias(pre, b0);
}

// combination, hidden panel q: pre = xn w0 + b0 (columns 128 q ..) over the
// ring's next 16 chunks (w0^T rows 128 q ..), xn = xn0 ln_scale + ln_bias
// formed as the A fragments load from X (xn0, rows of LX); LN holds
// ln_scale then ln_bias.
template <typename R>
__device__ __forceinline__ void combination_pre(R& ring, int& c, const float* X, const float* LN, const float* b0,
                                                int q, float (&pre)[4][4]) {
    using W = Widths<kCombination, 2>;
    const auto xn = [&](float x, int k) { return fmaf(x, LN[k], LN[W::W_IN + k]); };
    zero(pre);
    panel_mm<W::PRE>(ring, c, [&](int r, int& ld) { ld = W::LX; return X + r * kCK; }, pre, kRows, xn);
    add_bias(pre, b0 + q * kCN);
}

// h = silu(pre): the f32 K3's second product's A, K4-dW's spilled h
__device__ __forceinline__ float hidden(float pre) { return siluf_(pre); }

// head: pre0 = X w0 + b0 over the ring's next 8 chunks (w0^T; X the x tile,
// rows of LX), h0 = silu(pre0) into H (rows of LH), then pre1 = h0 w1 + b1
// over the next 8 (w1^T), both in the panel layout; pre0 stays for the
// backward's silu'(pre0). The previous reads of H lie behind the pre0
// product's barriers, and the pre1 product's first consume orders these
// stores before its reads.
template <typename R>
__device__ __forceinline__ void head_pre1(R& ring, int& c, const float* X, float* H, const float* b0,
                                          const float* b1, float (&pre0)[4][4], float (&pre1)[4][4]) {
    using W = Widths<kHead, 1>;
    compress_pre<1>(ring, c, X, b0, pre0);
    panel_pairs([&](int j, int h, int m, int n) {
        st2(H + m * W::LH + n, hidden(pre0[j][2 * h]), hidden(pre0[j][2 * h + 1]));
    });
    zero(pre1);
    panel_mm<W::W_HID / kCK>(ring, c, [&](int r, int& ld) { ld = W::LH; return (const float*)H + r * kCK; },
                             pre1, kRows);
    add_bias(pre1, b1);
}

}  // namespace rf32
}  // namespace mtt
