// K3 on Hopper in float32: the forward of PET's compress, combination and
// head row-block stages, redesigned for the H100 on the Hopper float32 K4's
// recompute code.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/rowblock.py
// `_forward_impl` (:93; pallas_call at :113) in float32 for the three math
// functions it is traced over: `compress_math` (:26), `combination_math`
// (:45) and `head_math` (:66) of metatrain_tpu/models/pet/fused_stages.py.
// It computes the plain versions `compress_math` / `combination_math` /
// `head_math` of metatrain_tpu_torch/models/pet/fused_stages.py at d_part =
// 128:
//   compress    (2 or 3 parts: w_in 256 or 384, w_hid = w_out = 128)
//                 pre = sum_i X_i w0_i + b0, h = silu(pre), out = h w1 + b1
//   combination (w_in = w_hid = 256, w_out = 128; X = [edges | reversed])
//                 xn0 = (X - mean) rs, rs = rsqrt(var + 1e-5) (two passes),
//                 xn = xn0 ln_scale + ln_bias, h = silu(xn w0 + b0),
//                 out = (messages + edges) + (h w1 + b1)
//   head        (w_in = w_hid = w_out = 128)
//                 pre0 = x w0 + b0, h0 = silu(pre0), pre1 = h0 w1 + b1,
//                 out = silu(pre1)
// with or without weight gradients: the f32 call's forward and the f32
// training step's (mtt_rowblock_fwd_f32_sm90_ok is the shape rule; the
// wrapper sends bfloat16, d_pet 256 and every other shape to
// rowblock_fwd.cu or the bf16 Hopper K3).
//
// One function with K4: everything up to h is rowblock_f32_sm90.cuh's
// (layer_norm_rows, compress_pre, combination_pre, hidden; the head's
// head_pre1, up to pre1), the device code the Hopper float32 K4 and K4-dW's
// first pass run as their recompute, on the same weight chunks in the same
// order. So pre, xn0, rs, xn and h (the head's pre0, h0 and pre1) are the
// f32 K4's bit for bit (tools/sm90_front.py --kernel rowblock checks it on
// the card), and the forces differentiate the pre-activations that made the
// energy.
//
// What bounds it on the H100: operations. At the crystal's rows (A = 11,392
// x M = 64 = 729,088) the 3-part compress runs 95.6 GFLOP and the
// combination 143.3 (two products a row); as three TF32 products each at 495
// TFLOP/s that is 0.579 / 0.869 ms, on the FFMA pipes at 67 TFLOP/s 1.43 /
// 2.14 ms; the bytes (1.49 GB for the combination: edges, reversed,
// messages in, the output out) take 0.446 ms at 3.35 TB/s. The general body
// (rowblock_fwd.cu, FFMA from float tiles with every weight read from L2
// for every product) took about 5x the FFMA bound. Here, as in the f32 K4:
// - every product runs on mma.sync m16n8k8 as three TF32 products
//   (tf32_sm90.cuh: x = hi + lo split in registers, each staged chunk's
//   products summed from zero, then added), the weights staged through the
//   ring of three 128 x 16 float chunks in one fixed sequence per tile
//   (Chunks): compress 8 NP (pre, w0^T) + 8 (h w1, w1^T), 32 chunks at 3
//   parts and 24 at 2; combination 2 x 16 (pre per hidden panel) + 16
//   (h w1): 48; head 8 (pre0) + 8 (pre1): 16.
// - one persistent 512-thread block per SM walks a contiguous range of
//   64-row tiles. The x tile is single-buffered, as in the f32 K4: the next
//   tile's parts (or edges | reversed) ride in the cp.async groups of the
//   chunks after the last pre product, the x tile's last read (NextRows).
//   In the combination the LayerNorm writes xn0 over x in place, so the
//   raw edges are gone by the epilogue: edges and messages stream into a
//   tile of their own (where the f32 K4 keeps its two g tiles), in the
//   groups of the tile's own chunks from its third on, after the barrier
//   that ends the previous tile's epilogue, their last read.
// - h goes from the pre accumulators through SiLU into an h tile, the A
//   operand of the second product; the output (with b1, and for the
//   combination messages and edges from the streamed tile; the head's
//   silu(pre1)) is stored from registers. Rows past the end are
//   zero-filled and never stored.
// - the head's four 128 x 128 float weights (256 KB) do not fit in shared
//   memory as the bf16 Hopper head keeps them: they stream through the
//   ring like the compress's.
// Shared memory (bytes): the ring 24,576; the x tile 64 x (128 NP + 4) x 4;
// the h tile 64 x (w_hid + 4) x 4; the combination also the edges |
// messages tile 64 x 260 x 4, ln_scale and ln_bias 2,048 and rs 256:
// 157,696 at 3 parts, 124,928 at 2, 226,560 for the combination: one block
// per SM. The head: 92,160 (the ring, the x and h0 tiles); one block per SM
// too (its 512 threads take the registers of two).
// No atomics: every output element is written once by one thread in an
// order fixed by the shape, so every launch gives the same bits.

#include "rowblock_f32_sm90.cuh"

namespace mtt {
namespace k3f32 {
namespace {

// the tile streaming, the forward up to h (the f32 K4's recompute), 3xTF32,
// the weight ring and the panel products
using namespace rf32;
using sm90::kRows;  // sm90's, not common.cuh's
using sm90::kThreads;
using sm90::zero;

// The layout of one instantiation.
template <int STAGE, int NP>
struct Geo {
    using W = Widths<STAGE, NP>;
    static constexpr int W_IN = W::W_IN, W_HID = W::W_HID, LX = W::LX, LH = W::LH, PRE = W::PRE;
    static constexpr int PRES = STAGE == kCombination ? 2 * PRE : PRE;  // chunks of the pre products
    static constexpr int NCH = PRES + W_HID / kCK;                    // chunks per tile
    static constexpr int kX = kRows * LX * 4;
    static constexpr int kH = kRows * LH * 4;
    static constexpr int kOffX = kStages * kChunk * 4;  // the ring first
    static constexpr int kOffH = kOffX + kX;
    static constexpr int kOffEM = kOffH + kH;  // combination: edges | messages, rows of LX
    static constexpr int kOffLn = kOffEM + (STAGE == kCombination ? kX : 0);
    static constexpr int kOffRS = kOffLn + (STAGE == kCombination ? 2 * W_IN * 4 : 0);
    static constexpr int kSmem = kOffRS + (STAGE == kCombination ? kRows * 4 : 0);
    static_assert(STAGE != kCombination || LX == 2 * kPart + 4, "edges | messages in rows of the x tile's");
    static_assert(kSmem <= 232448, "one block per SM");
};

struct Args {
    const float* x[3];  // (rows, 128): the parts, or edges, reversed and messages, or x
    const float* ln_scale;
    const float* ln_bias;
    const float* w0_t;  // (w_hid, w_in): the pre product's B
    const float* b0;    // (w_hid,)
    const float* w1_t;  // (128, w_hid): h w1's
    const float* b1;    // (128,)
    float* out;         // (rows, 128)
    long long rows;
};

// A tile's weight chunks in the order its products consume them, each 128
// rows (n) x 16 columns (k) of a weight in its (N, K) row-major layout:
// compress: pre (w0^T, 8 NP), then h w1 (w1^T, 8); combination: pre per
// hidden panel q (w0^T rows 128 q .., 16 each), then h w1 (w1^T, 16); head:
// pre0 (w0^T, 8), then pre1 (w1^T, 8). The pre chunks (the head's pre0 and
// pre1 chunks) are the f32 K4's.
template <int STAGE, int NP>
struct Chunks {
    const float *w0_t, *w1_t;

    __device__ const float* operator()(int c, int& ld) const {
        using G = Geo<STAGE, NP>;
        const int r = c % G::NCH;
        if (r < G::PRES) {
            ld = G::W_IN;
            return w0_t + (size_t)(r / G::PRE) * kCN * G::W_IN + (r % G::PRE) * kCK;
        }
        ld = G::W_HID;
        return w1_t + (r - G::PRES) * kCK;
    }
};

// The rows a tile needs, issued with the weight chunks: chunk c = t NCH + r
// carries slice r - PRES - 2 of tile t + 1's x (PRES + 2 <= r < NCH: after
// the barrier that ends the last pre product, the x tile's last read) and,
// in the combination, slice r - 2 of tile t's own edges | messages (2 <= r
// < NCH: after the barrier that ends tile t - 1's epilogue, their last
// read). The ring's waits complete both by tile t's last chunk.
template <int STAGE, int NP>
struct NextRows {
    const Args& p;  // the kernel's (grid-constant) parameters: x, rows
    float* X;       // the x tile
    float* EM;      // the combination's edges | messages tile
    long long t0;   // the block's first tile
    int T;          // the block's tiles

    static constexpr int kEMUnits = 2 * kRows * kPieces;  // 16-byte pieces of edges | messages

    __device__ void operator()(int c) const {
        using G = Geo<STAGE, NP>;
        const int t = c / G::NCH, r = c % G::NCH;
        int lo, hi;
        if (t + 1 < T && rows_slice<G::NCH, G::PRES + 2, G::W::kXUnits>(r, lo, hi))
            copy_rows<NP>(p.x, X, G::LX, (t0 + t + 1) * kRows, p.rows, lo, hi);
        if constexpr (STAGE == kCombination) {
            if (t >= 1 && t < T && rows_slice<G::NCH, 2, kEMUnits>(r, lo, hi))
                copy_rows<2>({p.x[0], p.x[2], p.x[2]}, EM, G::LX, (t0 + t) * kRows, p.rows, lo, hi);
        }
    }

    // tile 0's rows, all of them
    __device__ void first() const {
        using G = Geo<STAGE, NP>;
        copy_rows<NP>(p.x, X, G::LX, t0 * kRows, p.rows, 0, G::W::kXUnits);
        if constexpr (STAGE == kCombination)
            copy_rows<2>({p.x[0], p.x[2], p.x[2]}, EM, G::LX, t0 * kRows, p.rows, 0, kEMUnits);
    }
};

// out = h w1 + b1 over the ring's next W_HID / 16 chunks (w1^T), h in H
// (rows of LH); the combination adds it to messages + edges (EM: edges |
// messages, rows of LX), as the plain version orders the sum. Stored from
// registers for the valid rows.
template <int STAGE, int NP, typename R>
__device__ __forceinline__ void out_panel(R& ring, int& c, const Args& p, const float* H, const float* EM,
                                          long long row0, int valid) {
    using G = Geo<STAGE, NP>;
    float acc[4][4];
    zero(acc);
    panel_mm<G::W_HID / kCK>(ring, c, [&](int r, int& ld) { ld = G::LH; return H + r * kCK; }, acc, kRows);
    panel_pairs([&](int j, int h, int m, int n) {
        if (m >= valid) return;
        const float2 b = ld2(p.b1 + n);
        const float o0 = acc[j][2 * h] + b.x, o1 = acc[j][2 * h + 1] + b.y;
        float* out = p.out + (size_t)(row0 + m) * kPart + n;
        if constexpr (STAGE == kCompress) {
            st2(out, o0, o1);
        } else {
            const float2 e = ld2(EM + m * G::LX + n), msg = ld2(EM + m * G::LX + kPart + n);
            st2(out, (msg.x + e.x) + o0, (msg.y + e.y) + o1);
        }
    });
}

// compress, one tile: x (64 x LX) in shared memory, h to H
template <int NP, typename R>
__device__ __forceinline__ void compress_tile(R& ring, int& c, const Args& p, const float* X, float* H,
                                              long long t, int valid) {
    using G = Geo<kCompress, NP>;
    const long long row0 = t * kRows;
    float pre[4][4];
    compress_pre<NP>(ring, c, X, p.b0, pre);
    // h = silu(pre), the second product's A
    panel_pairs([&](int j, int h, int m, int n) {
        st2(H + m * G::LH + n, hidden(pre[j][2 * h]), hidden(pre[j][2 * h + 1]));
    });
    // (the first consume's barrier orders these stores before the reads)
    out_panel<kCompress, NP>(ring, c, p, H, nullptr, row0, valid);
}

// head, one tile: x (64 x LX) in shared memory, h0 to H; out = silu(pre1)
// stored from registers
template <typename R>
__device__ __forceinline__ void head_tile(R& ring, int& c, const Args& p, const float* X, float* H, long long t,
                                          int valid) {
    const long long row0 = t * kRows;
    float pre0[4][4], pre1[4][4];
    head_pre1(ring, c, X, H, p.b0, p.b1, pre0, pre1);
    float* out = p.out + row0 * kPart;
    panel_pairs([&](int j, int h, int m, int n) {
        if (m < valid) st2(out + (size_t)m * kPart + n, siluf_(pre1[j][2 * h]), siluf_(pre1[j][2 * h + 1]));
    });
}

// combination, one tile: X (xn0 after the LayerNorm) and EM (edges |
// messages) in shared memory, h to H; LN holds ln_scale then ln_bias.
template <typename R>
__device__ __forceinline__ void combination_tile(R& ring, int& c, const Args& p, float* X, float* H,
                                                 const float* EM, const float* LN, float* RS, long long t,
                                                 int valid) {
    using G = Geo<kCombination, 2>;
    const long long row0 = t * kRows;
    layer_norm_rows(X, RS);
    // (the first consume's barrier orders these stores before the reads)
    // per hidden panel q: pre = xn w0 + b0, xn formed as the A fragments
    // load; h = silu(pre) into H (columns 128 q ..)
#pragma unroll 1
    for (int q = 0; q < 2; ++q) {
        float pre[4][4];
        combination_pre(ring, c, X, LN, p.b0, q, pre);
        panel_pairs([&](int j, int h, int m, int n) {
            st2(H + m * G::LH + q * kCN + n, hidden(pre[j][2 * h]), hidden(pre[j][2 * h + 1]));
        });
    }
    // out = (messages + edges) + (h w1 + b1)
    out_panel<kCombination, 2>(ring, c, p, H, EM, row0, valid);
}

template <int STAGE, int NP>
__global__ void __launch_bounds__(kThreads, 1) k3_f32_sm90_kernel(const __grid_constant__ Args p) {
    using G = Geo<STAGE, NP>;
    extern __shared__ __align__(16) unsigned char smem[];
    float* X = reinterpret_cast<float*>(smem + G::kOffX);
    float* H = reinterpret_cast<float*>(smem + G::kOffH);
    float* EM = reinterpret_cast<float*>(smem + G::kOffEM);
    float* LN = reinterpret_cast<float*>(smem + G::kOffLn);
    float* RS = reinterpret_cast<float*>(smem + G::kOffRS);

    const long long tiles = (p.rows + kRows - 1) / kRows;
    const long long t0 = tiles * blockIdx.x / gridDim.x, t1 = tiles * (blockIdx.x + 1) / gridDim.x;
    const int T = (int)(t1 - t0);
    if (T == 0) return;
    const NextRows<STAGE, NP> next{p, X, EM, t0, T};
    next.first();  // tile 0, one cp.async group
    cp_async_commit();
    if constexpr (STAGE == kCombination) {
        for (int k = threadIdx.x; k < G::W_IN; k += kThreads) {
            LN[k] = p.ln_scale[k];
            LN[G::W_IN + k] = p.ln_bias[k];
        }
    }
    Ring<Chunks<STAGE, NP>, NextRows<STAGE, NP>> ring{reinterpret_cast<float*>(smem),
                                                      Chunks<STAGE, NP>{p.w0_t, p.w1_t}, T * G::NCH, next};
    ring.start();
    int c = 0;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
        const long long tile = t0 + t;
        const int valid = (int)min((long long)kRows, p.rows - tile * kRows);
        if constexpr (STAGE == kCompress) {
            compress_tile<NP>(ring, c, p, X, H, tile, valid);
        } else if constexpr (STAGE == kHead) {
            head_tile(ring, c, p, X, H, tile, valid);
        } else {
            if (t == 0) {  // tile 0's rows and LN, before the LayerNorm (later tiles': the ring's waits)
                cp_async_wait<0>();
                __syncthreads();
            }
            combination_tile(ring, c, p, X, H, EM, LN, RS, tile, valid);
        }
    }
    cp_async_wait<0>();
}

template <int STAGE, int NP>
int launch(const Args& a, int blocks, cudaStream_t stream) {
    const int bytes = Geo<STAGE, NP>::kSmem;
    cudaError_t err = cudaFuncSetAttribute(k3_f32_sm90_kernel<STAGE, NP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    k3_f32_sm90_kernel<STAGE, NP><<<(unsigned)blocks, kThreads, bytes, stream>>>(a);
    return (int)cudaGetLastError();
}

bool takes(int stage, int d_part, int w_in, int w_hid, int w_out) {
    return sm90::rowblock_sm90_ok(stage, d_part, w_in, w_hid, w_out);
}

size_t smem_bytes(int stage, int w_in) {
    if (stage == kCombination) return Geo<kCombination, 2>::kSmem;
    if (stage == kHead) return Geo<kHead, 1>::kSmem;
    return w_in == 3 * kPart ? Geo<kCompress, 3>::kSmem : Geo<kCompress, 2>::kSmem;
}

}  // namespace
}  // namespace k3f32
}  // namespace mtt

// Whether the Hopper float32 K3 takes a stage (0 compress, 1 combination,
// 2 head) and its widths: those of the Hopper float32 K4
// (rowblock_sm90.cuh), d_part 128.
extern "C" int mtt_rowblock_fwd_f32_sm90_ok(int stage, int d_part, int w_in, int w_hid, int w_out) {
    return mtt::k3f32::takes(stage, d_part, w_in, w_hid, w_out) ? 1 : 0;
}

// Its shared memory per block, 0 where it does not take the stage.
extern "C" size_t mtt_rowblock_fwd_f32_sm90_smem(int stage, int d_part, int w_in, int w_hid, int w_out) {
    if (!mtt::k3f32::takes(stage, d_part, w_in, w_hid, w_out)) return 0;
    return mtt::k3f32::smem_bytes(stage, w_in);
}

// float32 tensors, the arguments of mtt_rowblock_fwd_sm90. x0..x2: the
// compress parts (n_parts of them), or edges, reversed and messages
// (n_parts 3), or the head's x (n_parts 1); w0_t (w_hid, w_in) and w1_t (w_out, w_hid), the transposes of
// w0 and w1; out (rows, w_out). `blocks` persistent blocks (one per SM) walk
// contiguous ranges of 64-row tiles on `stream`. Returns the CUDA error code
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int mtt_rowblock_fwd_f32_sm90(int stage, const float* x0, const float* x1, const float* x2,
                                         int n_parts, const float* ln_scale, const float* ln_bias,
                                         const float* w0_t, const float* b0, const float* w1_t, const float* b1,
                                         float* out, long long rows, int d_part, int w_in, int w_hid, int w_out,
                                         int blocks, void* stream) {
    using namespace mtt::k3f32;
    if (!takes(stage, d_part, w_in, w_hid, w_out) || blocks <= 0 ||
        (stage == kCombination ? n_parts != 3 : n_parts * d_part != w_in))
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    const Args a{{x0, x1, x2}, ln_scale, ln_bias, w0_t, b0, w1_t, b1, out, rows};
    const cudaStream_t s = (cudaStream_t)stream;
    if (stage == kCombination) return launch<kCombination, 2>(a, blocks, s);
    if (stage == kHead) return launch<kHead, 1>(a, blocks, s);
    if (w_in == 3 * kPart) return launch<kCompress, 3>(a, blocks, s);
    return launch<kCompress, 2>(a, blocks, s);
}
