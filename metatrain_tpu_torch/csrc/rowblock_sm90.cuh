// Helpers of the Hopper K3 (rowblock_fwd_sm90.cu) and the Hopper K4
// (rowblock_bwd_sm90.cu), the two sources that include this header: the
// streaming of 64-row bf16 input tiles in the weight ring's own cp.async
// groups (TileInputs, StreamRing), the combination's LayerNorm rows
// (layer_norm_rows), and the head's resident weights, plain double-buffered
// row tiles and forward up to pre1 (ResidentWeights, RowTiles, head_front,
// head_out). K3 runs layer_norm_rows and head_front as its forward and K4
// as its recompute: the same device code, so the served forward's xn and h
// and the backward's round the same way.
//
// Both kernels run one persistent 512-thread block per SM over a contiguous
// range of 64-row tiles. A tile's inputs are d_part = 128 wide bf16 arrays:
// NX of them side by side in the X tile (bf16 rows of NX 128 + 8, so
// ldmatrix reads them without bank conflicts), and NG (0 or 1) more in a
// tile of their own (rows of LA). Two buffers of each: tile t of the block
// lives in buffer t % 2, and the next tile's rows are copied into the other
// one while this tile's products run.

#pragma once

#include "layer_sm90.cuh"

namespace mtt {
namespace sm90 {

constexpr int kPart = 128;               // d_part: every streamed row and output row
constexpr int kPieces = kPart * 2 / 16;  // 16-byte copies per row of one array

// The stages (0 compress, 1 combination, 2 head) and widths both kernels
// take: d_part = w_out = 128; the compress with w_in 256 or 384 (2 or 3
// parts) and w_hid 128; the combination with w_in = w_hid = 256; the head
// with w_in = w_hid = 128. The wrappers check the variant (bfloat16; the
// backward without weight gradients, the forward where no weight requires
// grad).
inline bool rowblock_sm90_ok(int stage, int d_part, int w_in, int w_hid, int w_out) {
    if (d_part != kPart || w_out != kPart) return false;
    if (stage == 0) return (w_in == 2 * d_part || w_in == 3 * d_part) && w_hid == d_part;
    if (stage == 1) return w_in == 2 * d_part && w_hid == 2 * d_part;
    if (stage == 2) return w_in == d_part && w_hid == d_part;
    return false;
}

// A 16-byte cp.async that fills the rest of the destination with zeros
// (bytes = 0: all of it, for rows past the end).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(bytes)
                 : "memory");
}

// The block's input tiles, for a sequence of NCH weight chunks per tile:
// tile t (of the block's T, from global tile t0) goes to buffer t % 2.
// Chunk c = t NCH + r of the block's sequence carries piece r - 2 of tile t
// + 1 (2 <= r < NCH), chunk 0 all of tile 0. Unit u of a tile is 16-byte
// piece u % 16 of row u / 16 % 64 of array u / 1024: arrays 0 .. NX - 1 go
// to the X tile, array NX (where NG = 1) to the G tile.
template <int NX, int NG, int NCH>
struct TileInputs {
    static constexpr int LX = NX * kPart + 8;  // X rows (bf16)
    static constexpr int UNITS = kRows * (NX + NG) * kPieces;  // 16-byte copies per tile
    static constexpr int PIECE = (UNITS + NCH - 3) / (NCH - 2);  // per chunk 2 .. NCH - 1

    const bf16* src[NX + NG];
    bf16* X;  // buffer 0; buffer 1 follows
    bf16* G;
    long long rows, t0;
    int T;

    __device__ void copy(int t, int lo, int hi) const {
        const long long row0 = (t0 + t) * kRows;
        bf16* X1 = X + (t & 1) * kRows * LX;
        bf16* G1 = G + (t & 1) * kRows * LA;
        for (int u = lo + threadIdx.x; u < hi; u += kThreads) {
            const int a = u / (kRows * kPieces), row = (u / kPieces) % kRows, piece = u % kPieces;
            const bool valid = row0 + row < rows;
            const bf16* s = src[0];
#pragma unroll
            for (int k = 1; k < NX + NG; ++k)
                if (a == k) s = src[k];  // a select, not an indexed (local-memory) load
            s += valid ? (row0 + row) * kPart + piece * 8 : 0;
            bf16* d = a < NX ? X1 + row * LX + a * kPart + piece * 8 : G1 + row * LA + piece * 8;
            cp_async16_zfill(d, s, valid ? 16 : 0);
        }
    }

    __device__ void operator()(int c) const {
        const int t = c / NCH, r = c % NCH;
        if (c == 0) {
            copy(0, 0, UNITS);
        } else if (r >= 2 && t + 1 < T) {
            const int lo = (r - 2) * PIECE;
            copy(t + 1, lo, min(UNITS, lo + PIECE));
        }
    }
};

// layer_sm90.cuh's WeightRing whose every issue also copies the input
// pieces of its chunk (inputs(c)) into the same cp.async group, so the
// ring's waits complete them too: the pieces of chunk c are in shared
// memory for every thread after consume(c). Tile t + 1's last piece rides
// in tile t's last chunk, so the buffer of tile t - 1 is overwritten only
// after the barrier of tile t's first chunk.
template <typename Src, typename In>
struct StreamRing : WeightRing<Src> {
    In inputs;

    __device__ void issue(int c) {
        inputs(c);
        WeightRing<Src>::issue(c);
    }

    __device__ void start() {
        for (int c = 0; c < kStages - 1; ++c) issue(c);
    }

    __device__ const bf16* consume(int c) {
        cp_async_wait<kStages - 2>();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        issue(c + kStages - 1);
        return this->ring + (c % kStages) * kChunkElems;
    }
};

// The combination's LayerNorm over the 64 rows of X = [edges | reversed]
// (bf16 rows of LX = 2 128 + 8): per row the mean and rs = rsqrt(var +
// 1e-5) (two passes, in float) to MEAN[m] and RS[m], and xn = rnd((x -
// mean) rs ln_scale + ln_bias) to XN (rows of LX). One warp per row, lane l
// on columns 8 l .. 8 l + 7, summed in that order and then across the warp.
// The caller orders the stores before their reads with a barrier.
__device__ __forceinline__ void layer_norm_rows(const bf16* X, const bf16* ln_scale, const bf16* ln_bias,
                                                bf16* XN, float* MEAN, float* RS) {
    constexpr int W_IN = 2 * kPart, LX = W_IN + 8;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int m = warp; m < kRows; m += kThreads / 32) {
        const bf16* x = X + m * LX + 8 * lane;
        float v[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float2 f = ld2(x + 2 * k);
            v[2 * k] = f.x;
            v[2 * k + 1] = f.y;
        }
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) s += v[k];
        const float mean = warp_sum(s) / W_IN;
        float var = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) var = fmaf(v[k] - mean, v[k] - mean, var);
        const float rs = rsqrtf(warp_sum(var) / W_IN + 1e-5f);
        if (lane == 0) {
            MEAN[m] = mean;
            RS[m] = rs;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int col = 8 * lane + 2 * k;
            const float2 ls = ld2(ln_scale + col), lb = ld2(ln_bias + col);
            store2(XN + m * LX + col, (v[2 * k] - mean) * rs * ls.x + lb.x,
                   (v[2 * k + 1] - mean) * rs * ls.y + lb.y);
        }
    }
}

// ---- the head stage: resident weights, plain double-buffered rows -------

// Weights held in shared memory for the whole launch, each a 128 x 128
// (N, K) row-major matrix as two chunks (its k halves) in the 128-byte
// swizzle of the ring's stages: weight i is chunks 2 i and 2 i + 1. The
// caller loads them once, waits, issues the proxy fence and a barrier.
// consume(c) is the ring's interface for panel_mm: the chunk's address, with
// no wait, no barrier and no copy, so the caller orders every A tile's
// stores before a product's reads with barriers of its own.
struct ResidentWeights {
    bf16* base;

    __device__ void load(int i, const bf16* w) const {
        for (int p = threadIdx.x; p < 2 * kChunkN * kChunkK / 8; p += kThreads) {
            const int half = p / (kChunkN * kChunkK / 8), row = (p >> 3) % kChunkN, piece = p & 7;
            cp_async16(base + (2 * i + half) * kChunkElems + row * kChunkK + ((piece ^ (row & 7)) * 8),
                       w + (size_t)row * kPart + half * kChunkK + piece * 8);
        }
    }

    __device__ const bf16* consume(int c) const { return base + c * kChunkElems; }
};

// NA streamed (rows, 128) bf16 arrays, each in two 64-row tiles of rows of
// LA: tile t of the block (global tile t0 + t) in buffer t % 2. load(t)
// issues the 16-byte cp.async copies of tile t (rows past the end
// zero-filled) and commits them as one group.
template <int NA>
struct RowTiles {
    const bf16* src[NA];
    bf16* buf[NA];  // buffer 0; buffer 1 follows at kRows * LA
    long long rows, t0;

    __device__ void load(int t) const {
        const long long row0 = (t0 + t) * kRows;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
            bf16* dst = buf[a] + (t & 1) * kRows * LA;
            for (int u = threadIdx.x; u < kRows * kPieces; u += kThreads) {
                const int row = u / kPieces, piece = u % kPieces;
                const bool valid = row0 + row < rows;
                cp_async16_zfill(dst + row * LA + piece * 8,
                                 src[a] + (valid ? (row0 + row) * kPart + piece * 8 : 0), valid ? 16 : 0);
            }
        }
        cp_async_commit();
    }

    __device__ const bf16* tile(int a, int t) const { return buf[a] + (t & 1) * kRows * LA; }
};

// The head's forward up to pre1 for one 64-row tile: pre0 = X w0 + b0 (in
// registers), h0 = rnd(silu(pre0)) to H, then pre1 = h0 w1 + b1 (in
// registers), both in the panel layout of panel_pairs. W holds w0^T
// (chunks 0, 1) and w1^T (2, 3). X and H are bf16 rows of LA. The Hopper K3
// head runs it as its forward and the Hopper K4 head as its recompute, so
// the served h and the backward's h0 round the same way. Returns while
// warps may still read H: the caller puts a barrier before its next store
// there.
__device__ __forceinline__ void head_front(const ResidentWeights& W, const bf16* X, bf16* H,
                                           const bf16* b0, const bf16* b1, float (&pre0)[4][4],
                                           float (&pre1)[4][4]) {
    int c = 0;
    zero(pre0);
    panel_mm<2>(W, c, [&](int r, int& ld) { ld = LA; return X + r * kChunkK; }, pre0);
    panel_pairs([&](int j, int h, int m, int n) {
        const float2 b = ld2(b0 + n);
        pre0[j][2 * h] += b.x;
        pre0[j][2 * h + 1] += b.y;
        store2(H + m * LA + n, siluf_(pre0[j][2 * h]), siluf_(pre0[j][2 * h + 1]));
    });
    __syncthreads();
    zero(pre1);
    panel_mm<2>(W, c, [&](int r, int& ld) { ld = LA; return (const bf16*)H + r * kChunkK; }, pre1);
    panel_pairs([&](int j, int h, int m, int n) {
        const float2 b = ld2(b1 + n);
        pre1[j][2 * h] += b.x;
        pre1[j][2 * h + 1] += b.y;
    });
}

// The head's output rnd(silu(pre1)) for the valid rows of a tile whose
// first row is `out`: the Hopper K3 head's store, and the Hopper K4 head's
// store of its recompute where a check asks for it.
__device__ __forceinline__ void head_out(const float (&pre1)[4][4], bf16* out, int valid) {
    panel_pairs([&](int j, int h, int m, int n) {
        if (m < valid)
            store2(out + (size_t)m * kPart + n, siluf_(pre1[j][2 * h]), siluf_(pre1[j][2 * h + 1]));
    });
}

}  // namespace sm90
}  // namespace mtt
