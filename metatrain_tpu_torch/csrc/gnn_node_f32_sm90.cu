// The node stream of the fused GNN block on Hopper in float32: the node
// update and the contractions between the attention layers, forward,
// input-gradient backward and, in a spill mode, the weight-gradient
// backward's first pass; its second pass is K2-dW's split-K product
// (layer_dw_sm90.cuh). 64 atoms per tile.
//
// Replaces the node-stream part of the TPU kernels
// metatrain_tpu/ops/pallas/fused_layer.py `_gnn_fwd_kernel` (:1671,
// pallas_call :1759) and `_gnn_bwd_kernel` (:1690, pallas_call :1805, with
// and without weight gradients; body `_gnn_block_math` /
// `_gnn_block_bwd_math`) in float32. The Hopper float32 GNN block
// (ops/kernels/gnn_block.py `sm90_f32_pieces`) runs each attention layer on
// the Hopper float32 K1, K2 or two-pass K2-dW and these kernels between
// them:
//
//   forward (node_fwd_f32_kernel), per atom, N = d_node, D = d_pet = 128:
//     n_mid   = node + (cattn w_exp + b_exp)                 (D -> N)
//     hn      = n_mid r2 norm_c, r2 = rsqrt(mean(n_mid^2) + eps)
//     [v | g] = hn w_in_c + b_in_c                          (N -> 4N)
//     h       = v sigmoid(g)
//     node'   = n_mid + (h w_out_c + b_out_c)                (2N -> N)
//     center' = node' w_contr + b_contr                      (N -> D, the next layer's)
//   with the update alone after the last layer, and the contraction alone
//   before the first;
//
//   backward (node_bwd_f32_kernel): the contraction's backward of the layer
//   above first, d_n = dn + d_center w_contr^T, then
//     d_h = d_n w_out_c^T;  d_vg = [d_h sig, d_h v sig (1 - sig)]
//     d_hn = d_vg w_in_c^T;  gs = d_hn r2 norm_c
//     d_nmid = d_n + (gs - n_mid (r2^2 sum(gs n_mid) / N))
//     d_cattn = d_nmid w_exp^T
//   recomputing n_mid, hn, v and g from node and cattn with the forward's
//   own device code (expand, rms_tile, glu_tile); after the first layer the
//   contraction's backward alone gives d_node = d_n;
//
//   spill mode (the same kernel, SP): also each atom's operands of the node
//   weights' products, hn, h, d_vg and (with the contraction's backward)
//   d_n, and per tile the column sums of the vector gradients: b_exp (d_nmid),
//   norm_c (d_hn n_mid r2), b_in_c (d_vg), b_out_c (d_n) into the layer's
//   vector row, and b_contr (d_center) into the layer above's. The second
//   pass (mtt_gnn_node_dw_f32_sm90) then forms dW = X^T dY for w_contr
//   (node, d_center), w_exp (cattn, d_nmid), w_in_c (hn, d_vg) and w_out_c
//   (h, d_n) as a split-K product over atoms in a fixed slice order and sums
//   the vector rows likewise: two launches give the same bits.
// The plain versions are gnn_block.py's node_stream_fwd_math,
// node_stream_bwd_math, node_stream_bwd_dw_math and node_stream_dw_math.
//
// What bounds it on the H100: operations. At N = 256 a tile's forward is
// 224 staged chunks of 16 k for a 64 x 128 panel, its backward 384
// (2 (2 N D + 6 N^2) and 2 (3 N D + 10 N^2) flops an atom); at A = 11,392
// that is 8.6 and 14.3 GFLOP, 0.052 / 0.087 ms as three TF32 products at 495
// TFLOP/s. The general block ran the stream as one FFMA GEMV per atom, every
// weight read from L2 per atom. Here a tile of 64 atoms is one 64-row panel
// and every product runs on mma.sync m16n8k8 as three TF32 products through
// tf32_sm90.cuh's ring of staged 128 x 16 float chunks (panel_mm; each
// chunk's products summed from zero, then added in float): the weights are
// read once per 64 atoms. w_in_c^T comes with its value and gate rows
// interleaved in blocks of 128 (the wrapper's w_vg), so that a hidden tile's
// gate chunks and then its value chunks leave g and v of the same elements
// in the same thread: sigmoid(g) waits in that thread's own elements of a
// tile and h = v sigmoid(g) forms in registers (one 64 x 128 accumulator
// live at a time beside the 64 x N sums that stay in registers: node' in
// the forward, d_hn in the backward).
//
// Shared memory (floats, rows padded by 4; at N = 256):
//   forward: the ring 24,576 B, cattn (64 x D) 33,792, n_mid and hn / node'
//   (64 x N) 2 x 66,560, sigmoid(g) / h (64 x 128) 33,792, r2 256:
//   225,536 B;
//   backward: the float tiles of the bf16 pair's layout do not fit (ring,
//   d_center, cattn, n_mid, hn, d_n, d_v, d_g: 360 KB), so the buffers
//   share rooms by phase: room U (2 x 64 x 128) holds d_center (the
//   contraction's backward), then n_mid (until hn is formed), then d_v and
//   d_g (per hidden tile), then cattn again (the last expansion); room HN
//   (64 x N) holds cattn (the first expansion), then hn (the hidden tiles),
//   then n_mid recomputed by the expansion's own code for the RMSNorm's
//   backward; room DN (64 x N) d_n, then d_nmid; r2 and 4 x 128 of sum
//   scratch: 227,584 B. One block per SM (512 threads, 128 registers at
//   most); mtt_gnn_node_f32_sm90_smem and _lib.gnn_node_f32_sm90_smem give
//   these sizes.
// N = 128 or 256 (mtt_gnn_node_f32_sm90_ok); one tile per block; no
// atomics.

#include "layer_dw_sm90.cuh"
#include "tf32_sm90.cuh"

namespace mtt {
namespace nodef32 {
namespace {

using namespace tf32;  // 3xTF32, the weight ring, the panel products
using sm90::D;
using sm90::kRows;
using sm90::kThreads;
using sm90::zero;

constexpr int LT = kCN + 4;         // a 64 x 128 tile's row (floats)
constexpr int kTileT = kRows * LT;  // floats
constexpr int kRingFloats = kStages * kChunk;
constexpr int kDK = D / kCK;        // chunks of a product over D

template <int NP>
struct Geo {
    static constexpr int N = kCN * NP;
    static constexpr int LN = N + 4;          // a 64 x N tile's row
    static constexpr int NK = N / kCK;        // chunks of a product over N
    static constexpr int kTileN = kRows * LN;
    static constexpr int kU = 2 * kTileT > kTileN ? 2 * kTileT : kTileN;
    static constexpr int kFwdFloats = kRingFloats + kTileT + 2 * kTileN + kTileT + kRows;
    static constexpr int kBwdFloats = kRingFloats + kU + 2 * kTileN + kRows + 4 * kCN;
    // the vector row of a layer: b_contr, b_exp, norm_c, b_in_c, b_out_c
    static constexpr int kVec = D + 7 * N;
    static constexpr int kVecExp = D, kVecNorm = D + N, kVecIn = D + 2 * N, kVecOut = D + 6 * N;
};

static_assert(Geo<2>::kFwdFloats * 4 <= 232448 && Geo<2>::kBwdFloats * 4 <= 232448, "one block per SM");

// Chunk r's 16 columns of a tile with rows of LD floats.
template <int LD>
struct Cols {
    const float* X;
    __device__ const float* operator()(int r, int& ld) const {
        ld = LD;
        return X + r * kCK;
    }
};

// T (64 x W floats, rows of ldt) = rows a0 .. a0 + 63 of g (A x W), zero past A.
__device__ __forceinline__ void load_rows(float* T, int ldt, const float* g, int W, long long a0, long long A) {
    const int pieces = W / 4;
    for (int i = threadIdx.x; i < kRows * pieces; i += kThreads) {
        const int m = i / pieces, k = (i % pieces) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (a0 + m < A) v = *reinterpret_cast<const float4*>(g + (a0 + m) * W + k);
        *reinterpret_cast<float4*>(T + m * ldt + k) = v;
    }
}

// Rows a0 .. (below A) of g (A x W) = T's rows.
__device__ __forceinline__ void store_rows(float* g, int W, const float* T, int ldt, long long a0, long long A) {
    const int pieces = W / 4;
    for (int i = threadIdx.x; i < kRows * pieces; i += kThreads) {
        const int m = i / pieces, k = (i % pieces) * 4;
        if (a0 + m < A)
            *reinterpret_cast<float4*>(g + (a0 + m) * W + k) = *reinterpret_cast<const float4*>(T + m * ldt + k);
    }
}

// The forward's weight chunks in the order its products consume them, each
// a weight in its (N_out, K) row-major layout: with the update, the
// expansion (w_exp^T, per 128 columns of N its D / 16 k slices), then per
// hidden tile t of 128 of the 2N columns its gate chunks (rows 256 t + 128
// .. of w_vg, N / 16 k slices), its value chunks (rows 256 t ..) and the
// out-projection (w_out_c^T rows 128 q .., columns 128 t .. + 127, per q);
// with the contraction, w_contr^T (N / 16 k slices).
struct FwdChunks {
    const float *w_exp_t, *w_vg, *w_out_t, *w_contr_t;
    int N;
    bool upd;

    __device__ const float* operator()(int c, int& ld) const {
        const int NP = N / kCN, NK = N / kCK;
        if (upd) {
            if (c < NP * kDK) {
                ld = D;
                return w_exp_t + (size_t)(c / kDK) * kCN * D + (c % kDK) * kCK;
            }
            c -= NP * kDK;
            const int per = 2 * NK + NP * (kCN / kCK);
            if (c < 2 * NP * per) {
                const int t = c / per;
                int r = c % per;
                if (r < 2 * NK) {
                    ld = N;
                    return w_vg + (size_t)(2 * t + (r < NK ? 1 : 0)) * kCN * N + (r % NK) * kCK;
                }
                r -= 2 * NK;
                ld = 2 * N;
                return w_out_t + (size_t)(r / (kCN / kCK)) * kCN * 2 * N + t * kCN + (r % (kCN / kCK)) * kCK;
            }
            c -= 2 * NP * per;
        }
        ld = N;
        return w_contr_t + (size_t)c * kCK;
    }
};

__host__ __device__ constexpr int fwd_chunk_count(int N, bool upd, bool con) {
    return (upd ? (N / kCN) * kDK + 2 * (N / kCN) * (2 * (N / kCK) + (N / kCN) * (kCN / kCK)) : 0) +
           (con ? N / kCK : 0);
}

// The backward's, likewise: with the contraction's backward, w_contr (per
// 128 columns of N its D / 16 k slices); with the update's, the recompute's
// expansion (w_exp^T), then per hidden tile t: d_h's (w_out_c rows 128 t ..,
// N / 16 k slices), the gate and value chunks of the forward, d_hn's (w_in_c
// rows 128 q .., per q the value columns 128 t .. + 127 then the same gate
// columns); then the expansion again (n_mid for the RMSNorm's backward) and
// d_cattn's (w_exp, N / 16 k slices).
struct BwdChunks {
    const float *w_contr, *w_exp_t, *w_out_c, *w_vg, *w_in_c, *w_exp;
    int N;
    bool pro;

    __device__ const float* operator()(int c, int& ld) const {
        const int NP = N / kCN, NK = N / kCK, E = NP * kDK;
        if (pro) {
            if (c < E) {
                ld = D;
                return w_contr + (size_t)(c / kDK) * kCN * D + (c % kDK) * kCK;
            }
            c -= E;
        }
        if (c < E) {
            ld = D;
            return w_exp_t + (size_t)(c / kDK) * kCN * D + (c % kDK) * kCK;
        }
        c -= E;
        const int per = 3 * NK + NP * 16;
        if (c < 2 * NP * per) {
            const int t = c / per;
            int r = c % per;
            ld = N;
            if (r < NK) return w_out_c + (size_t)t * kCN * N + r * kCK;
            r -= NK;
            if (r < 2 * NK) return w_vg + (size_t)(2 * t + (r < NK ? 1 : 0)) * kCN * N + (r % NK) * kCK;
            r -= 2 * NK;
            const int q = r / 16, e = r % 16;
            ld = 4 * N;
            return w_in_c + (size_t)q * kCN * 4 * N + (e < 8 ? 0 : 2 * N) + t * kCN + (e % 8) * kCK;
        }
        c -= 2 * NP * per;
        if (c < E) {
            ld = D;
            return w_exp_t + (size_t)(c / kDK) * kCN * D + (c % kDK) * kCK;
        }
        c -= E;
        ld = N;
        return w_exp + (size_t)c * kCK;
    }
};

__host__ __device__ constexpr int bwd_chunk_count(int N, bool pro, bool body) {
    return (pro ? (N / kCN) * kDK : 0) +
           (body ? 2 * (N / kCN) * kDK + 2 * (N / kCN) * (3 * (N / kCK) + (N / kCN) * 16) + N / kCK : 0);
}

// NM (rows of LN) = node + (cattn w_exp + b_exp) over the ring's next 8 NP
// chunks, cattn in CA (rows of LT); rows past A read node as zero.
template <int NP, typename R>
__device__ __forceinline__ void expand(R& ring, int& c, const float* CA, float* NM, const float* node,
                                       const float* b_exp, long long a0, long long A) {
    using G = Geo<NP>;
#pragma unroll 1
    for (int q = 0; q < NP; ++q) {
        float acc[4][4];
        zero(acc);
        panel_mm<kDK>(ring, c, Cols<LT>{CA}, acc, kRows);
        panel_pairs([&](int j, int h, int m, int n) {
            const int col = kCN * q + n;
            const float2 b = ld2(b_exp + col);
            const float2 x = a0 + m < A ? ld2(node + (a0 + m) * G::N + col) : make_float2(0.f, 0.f);
            st2(NM + m * G::LN + col, x.x + (acc[j][2 * h] + b.x), x.y + (acc[j][2 * h + 1] + b.y));
        });
    }
}

// HN = NM r2 norm_c, r2 = rsqrt(mean(NM^2) + eps) to R2: one warp per row.
// The caller syncs before (NM written) and after.
template <int NP>
__device__ __forceinline__ void rms_tile(const float* NM, float* HN, const float* norm_c, float* R2, float eps) {
    using G = Geo<NP>;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int m = warp; m < kRows; m += kThreads / 32) {
        float s = 0.f;
#pragma unroll
        for (int n = 4 * lane; n < G::N; n += 128) {
            const float4 x = *reinterpret_cast<const float4*>(NM + m * G::LN + n);
            s += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
        }
        const float r = rsqrtf(warp_sum(s) / G::N + eps);
        if (lane == 0) R2[m] = r;
#pragma unroll
        for (int n = 4 * lane; n < G::N; n += 128) {
            const float4 x = *reinterpret_cast<const float4*>(NM + m * G::LN + n);
            const float4 w = *reinterpret_cast<const float4*>(norm_c + n);
            *reinterpret_cast<float4*>(HN + m * G::LN + n) =
                make_float4(x.x * r * w.x, x.y * r * w.y, x.z * r * w.z, x.w * r * w.w);
        }
    }
}

// Hidden tile t: SG (rows of LT, the thread's own elements) = sigmoid(hn
// w_g + b_g) over the ring's next N / 16 gate chunks, then av = hn w_v (no
// bias) over as many value chunks. SG's writes follow the gate chunks'
// barriers, which every warp passes only after its reads of the tile's
// room before.
template <int NP, typename R>
__device__ __forceinline__ void glu_tile(R& ring, int& c, const float* HN, float* SG, const float* b_in_c, int t,
                                         float (&av)[4][4]) {
    using G = Geo<NP>;
    {
        float ag[4][4];
        zero(ag);
        panel_mm<G::NK>(ring, c, Cols<G::LN>{HN}, ag, kRows);
        panel_pairs([&](int j, int h, int m, int n) {
            const float2 b = ld2(b_in_c + 2 * G::N + kCN * t + n);
            st2(SG + m * LT + n, sigmoidf_(ag[j][2 * h] + b.x), sigmoidf_(ag[j][2 * h + 1] + b.y));
        });
    }
    zero(av);
    panel_mm<G::NK>(ring, c, Cols<G::LN>{HN}, av, kRows);
}

struct FwdArgs {
    const float* node;     // (A, N)
    const float* cattn;    // (A, D): the layer's center attention output; null: no update
    const float* b_exp;    // (N,)
    const float* norm_c;   // (N,)
    const float* b_in_c;   // (4N,): value columns, then gate columns
    const float* b_out_c;  // (N,)
    const float* b_contr;  // (D,): the next layer's
    float* node_out;       // (A, N), with the update
    float* center_out;     // (A, D), with the contraction
    long long A;
    float eps;
};

template <int NP, bool UPD, bool CON>
__global__ void __launch_bounds__(kThreads, 1) node_fwd_f32_kernel(const FwdArgs p, const FwdChunks chunks) {
    using G = Geo<NP>;
    constexpr int N = G::N, LN = G::LN;
    extern __shared__ __align__(1024) float node_smem[];
    float* CA = node_smem + kRingFloats;
    float* NM = CA + kTileT;
    float* HN = NM + G::kTileN;  // hn, then node' (the contraction's operand)
    float* HT = HN + G::kTileN;  // sigmoid(g), then h
    float* R2 = HT + kTileT;
    const long long a0 = (long long)blockIdx.x * kRows;

    Ring<FwdChunks> ring{node_smem, chunks, fwd_chunk_count(N, UPD, CON)};
    ring.start();
    int c = 0;
    if constexpr (UPD) {
        load_rows(CA, LT, p.cattn, D, a0, p.A);
        expand<NP>(ring, c, CA, NM, p.node, p.b_exp, a0, p.A);
        __syncthreads();
        rms_tile<NP>(NM, HN, p.norm_c, R2, p.eps);
        // h and its out-projection, hidden tile after hidden tile
        float acc[NP][4][4];
#pragma unroll
        for (int q = 0; q < NP; ++q) zero(acc[q]);
#pragma unroll 1
        for (int t = 0; t < 2 * NP; ++t) {
            float av[4][4];
            glu_tile<NP>(ring, c, HN, HT, p.b_in_c, t, av);
            panel_pairs([&](int j, int h, int m, int n) {
                const float2 bv = ld2(p.b_in_c + kCN * t + n), s = ld2(HT + m * LT + n);
                st2(HT + m * LT + n, (av[j][2 * h] + bv.x) * s.x, (av[j][2 * h + 1] + bv.y) * s.y);
            });
#pragma unroll
            for (int q = 0; q < NP; ++q) panel_mm<kCN / kCK>(ring, c, Cols<LT>{HT}, acc[q], kRows);
        }
        // node' = n_mid + (h w_out_c + b_out_c); every warp is past the last
        // reads of hn (the out-projection's barriers)
#pragma unroll
        for (int q = 0; q < NP; ++q) {
            panel_pairs([&](int j, int h, int m, int n) {
                const int col = kCN * q + n;
                const float2 x = ld2(NM + m * LN + col), b = ld2(p.b_out_c + col);
                const float y0 = x.x + (acc[q][j][2 * h] + b.x), y1 = x.y + (acc[q][j][2 * h + 1] + b.y);
                if (a0 + m < p.A) st2(p.node_out + (a0 + m) * N + col, y0, y1);
                if (CON) st2(HN + m * LN + col, y0, y1);
            });
        }
    } else {
        load_rows(HN, LN, p.node, N, a0, p.A);
    }
    if constexpr (CON) {
        float acc[4][4];
        zero(acc);
        panel_mm<G::NK>(ring, c, Cols<LN>{HN}, acc, kRows);
        panel_pairs([&](int j, int h, int m, int n) {
            if (a0 + m >= p.A) return;
            const float2 b = ld2(p.b_contr + n);
            st2(p.center_out + (a0 + m) * D + n, acc[j][2 * h] + b.x, acc[j][2 * h + 1] + b.y);
        });
    }
}

struct BwdArgs {
    const float* node;      // (A, N), with the update's backward
    const float* cattn;     // (A, D), with the update's backward (null: the contraction's alone)
    const float* dn;        // (A, N) the incoming cotangent (g_node, or d_nmid of the layer above)
    const float* d_center;  // (A, D) the layer above's; null: no contraction's backward
    const float* b_exp;     // (N,)
    const float* norm_c;    // (N,)
    const float* b_in_c;    // (4N,)
    float* d_cattn;         // (A, D), with the update's backward
    float* d_nmid;          // (A, N), with the update's backward
    float* d_node;          // (A, N), the contraction's backward alone
    // spill mode: the products' operands and the tiles' vector rows
    float* s_hn;     // (A, N)
    float* s_h;      // (A, 2N)
    float* s_dvg;    // (A, 4N)
    float* s_dn;     // (A, N), with the contraction's backward
    float* vec;      // (tiles, D + 7N): this layer's row
    float* vec_con;  // (tiles, D + 7N): the layer above's (its b_contr)
    long long A;
    float eps;
};

template <int NP, bool PRO, bool BODY, bool SP>
__global__ void __launch_bounds__(kThreads, 1) node_bwd_f32_kernel(const BwdArgs p, const BwdChunks chunks) {
    using G = Geo<NP>;
    constexpr int N = G::N, LN = G::LN;
    extern __shared__ __align__(1024) float node_smem[];
    float* U = node_smem + kRingFloats;  // d_center; n_mid; d_v | d_g; cattn
    float* HN = U + G::kU;         // cattn; hn; n_mid
    float* DN = HN + G::kTileN;    // d_n, then d_nmid
    float* R2 = DN + G::kTileN;
    float* RED = R2 + kRows;  // 4 x 128 floats of sum scratch
    float* DV = U;
    float* DG = U + kTileT;
    const long long a0 = (long long)blockIdx.x * kRows;
    float* const vec = SP && BODY ? p.vec + blockIdx.x * (long long)G::kVec : nullptr;

    Ring<BwdChunks> ring{node_smem, chunks, bwd_chunk_count(N, PRO, BODY)};
    ring.start();
    int c = 0;
    // ---- the contraction's backward: d_n = dn + d_center w_contr^T ---------
    if constexpr (PRO) {
        load_rows(U, LT, p.d_center, D, a0, p.A);
#pragma unroll 1
        for (int q = 0; q < NP; ++q) {
            float acc[4][4];
            zero(acc);
            panel_mm<kDK>(ring, c, Cols<LT>{U}, acc, kRows);
            panel_pairs([&](int j, int h, int m, int n) {
                const int col = kCN * q + n;
                const long long a = a0 + m;
                const float2 d = a < p.A ? ld2(p.dn + a * N + col) : make_float2(0.f, 0.f);
                const float v0 = d.x + acc[j][2 * h], v1 = d.y + acc[j][2 * h + 1];
                if (!BODY) {
                    if (a < p.A) st2(p.d_node + a * N + col, v0, v1);
                } else {
                    st2(DN + m * LN + col, v0, v1);
                    if (SP && a < p.A) st2(p.s_dn + a * N + col, v0, v1);
                }
            });
        }
        // the layer above's b_contr: the tile's column sums of d_center
        if constexpr (SP)
            panel_col_sums(RED, [&](int, int, int m, int n) { return U[m * LT + n]; },
                           p.vec_con + blockIdx.x * (long long)G::kVec);
    }
    if constexpr (BODY) {
        if constexpr (!PRO) load_rows(DN, LN, p.dn, N, a0, p.A);
        // ---- the forward's n_mid and hn (its code), cattn in hn's room ----
        load_rows(HN, LT, p.cattn, D, a0, p.A);
        expand<NP>(ring, c, HN, U, p.node, p.b_exp, a0, p.A);
        __syncthreads();
        rms_tile<NP>(U, HN, p.norm_c, R2, p.eps);
        __syncthreads();
        if constexpr (SP) {
            store_rows(p.s_hn, N, HN, LN, a0, p.A);
#pragma unroll
            for (int q = 0; q < NP; ++q)  // b_out_c: the column sums of d_n
                panel_col_sums(RED, [&](int, int, int m, int n) { return DN[m * LN + kCN * q + n]; },
                               vec + G::kVecOut + kCN * q);
        }

        // ---- per hidden tile: d_h, then g and v -> d_vg -> d_hn (registers)
        float dhn[NP][4][4];
#pragma unroll
        for (int q = 0; q < NP; ++q) zero(dhn[q]);
#pragma unroll 1
        for (int t = 0; t < 2 * NP; ++t) {
            {
                float dh[4][4];
                zero(dh);
                panel_mm<G::NK>(ring, c, Cols<LN>{DN}, dh, kRows);
                panel_pairs([&](int j, int h, int m, int n) { st2(DV + m * LT + n, dh[j][2 * h], dh[j][2 * h + 1]); });
            }
            float av[4][4];
            glu_tile<NP>(ring, c, HN, DG, p.b_in_c, t, av);
            panel_pairs([&](int j, int h, int m, int n) {
                const float2 bv = ld2(p.b_in_c + kCN * t + n), s = ld2(DG + m * LT + n), d = ld2(DV + m * LT + n);
                const float v0 = av[j][2 * h] + bv.x, v1 = av[j][2 * h + 1] + bv.y;
                const float dv0 = d.x * s.x, dv1 = d.y * s.y;
                const float dg0 = d.x * v0 * s.x * (1.f - s.x), dg1 = d.y * v1 * s.y * (1.f - s.y);
                st2(DV + m * LT + n, dv0, dv1);
                st2(DG + m * LT + n, dg0, dg1);
                if (SP && a0 + m < p.A) {
                    const long long a = a0 + m;
                    st2(p.s_h + a * 2 * N + kCN * t + n, v0 * s.x, v1 * s.y);
                    st2(p.s_dvg + a * 4 * N + kCN * t + n, dv0, dv1);
                    st2(p.s_dvg + a * 4 * N + 2 * N + kCN * t + n, dg0, dg1);
                }
            });
            if constexpr (SP) {  // b_in_c: the column sums of d_v and d_g
                panel_col_sums(RED, [&](int, int, int m, int n) { return DV[m * LT + n]; },
                               vec + G::kVecIn + kCN * t);
                panel_col_sums(RED, [&](int, int, int m, int n) { return DG[m * LT + n]; },
                               vec + G::kVecIn + 2 * N + kCN * t);
            }
#pragma unroll
            for (int q = 0; q < NP; ++q)
                panel_mm<16>(ring, c, [&](int r, int& ld) {
                    ld = LT;
                    return (const float*)(r < 8 ? DV : DG) + (r & 7) * kCK;
                }, dhn[q], kRows);
        }

        // ---- the RMSNorm's backward -> d_nmid ------------------------------
        // n_mid again by the expansion's code, into hn's room; cattn in U
        // once every warp is past its last reads of d_v and d_g
        __syncthreads();
        load_rows(U, LT, p.cattn, D, a0, p.A);
        expand<NP>(ring, c, U, HN, p.node, p.b_exp, a0, p.A);
        float s[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < NP; ++q) {
            float sq[2];
            panel_row_sums(RED, [&](int j, int i, int m, int n) {
                const int col = kCN * q + n;
                const float gs = dhn[q][j][i] * (R2[m] * p.norm_c[col]);
                return gs * HN[m * LN + col];
            }, sq);
            s[0] += sq[0];
            s[1] += sq[1];
        }
#pragma unroll
        for (int q = 0; q < NP; ++q) {
            panel_pairs([&](int j, int h, int m, int n) {
                const int col = kCN * q + n;
                const float r = R2[m], cm = r * r * s[h] / N;
                const float2 x = ld2(HN + m * LN + col), w = ld2(p.norm_c + col), d = ld2(DN + m * LN + col);
                const float g0 = dhn[q][j][2 * h] * (r * w.x), g1 = dhn[q][j][2 * h + 1] * (r * w.y);
                const float y0 = d.x + (g0 - x.x * cm), y1 = d.y + (g1 - x.y * cm);
                st2(DN + m * LN + col, y0, y1);
                if (a0 + m < p.A) st2(p.d_nmid + (a0 + m) * N + col, y0, y1);
            });
        }
        if constexpr (SP) {
#pragma unroll
            for (int q = 0; q < NP; ++q) {  // b_exp (d_nmid) and norm_c (d_hn n_mid r2)
                panel_col_sums(RED, [&](int, int, int m, int n) { return DN[m * LN + kCN * q + n]; },
                               vec + G::kVecExp + kCN * q);
                panel_col_sums(RED, [&](int j, int i, int m, int n) {
                    return dhn[q][j][i] * (HN[m * LN + kCN * q + n] * R2[m]);
                }, vec + G::kVecNorm + kCN * q);
            }
        }

        // ---- d_cattn = d_nmid w_exp^T -------------------------------------
        float acc[4][4];
        zero(acc);
        panel_mm<G::NK>(ring, c, Cols<LN>{DN}, acc, kRows);
        panel_pairs([&](int j, int h, int m, int n) {
            if (a0 + m < p.A) st2(p.d_cattn + (a0 + m) * D + n, acc[j][2 * h], acc[j][2 * h + 1]);
        });
    }
}

template <typename Kernel, typename Args, typename Chunks>
int launch(Kernel kernel, int floats, const Args& p, const Chunks& chunks, cudaStream_t stream) {
    const int bytes = floats * 4;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)((p.A + kRows - 1) / kRows), kThreads, bytes, stream>>>(p, chunks);
    return (int)cudaGetLastError();
}

template <int NP>
int run_fwd(const FwdArgs& p, const FwdChunks& chunks, bool upd, bool con, cudaStream_t stream) {
    constexpr int f = Geo<NP>::kFwdFloats;
    if (upd && con) return launch(node_fwd_f32_kernel<NP, true, true>, f, p, chunks, stream);
    if (upd) return launch(node_fwd_f32_kernel<NP, true, false>, f, p, chunks, stream);
    return launch(node_fwd_f32_kernel<NP, false, true>, f, p, chunks, stream);
}

template <int NP, bool SP>
int run_bwd(const BwdArgs& p, const BwdChunks& chunks, bool pro, bool body, cudaStream_t stream) {
    constexpr int f = Geo<NP>::kBwdFloats;
    if (pro && body) return launch(node_bwd_f32_kernel<NP, true, true, SP>, f, p, chunks, stream);
    if (body) return launch(node_bwd_f32_kernel<NP, false, true, SP>, f, p, chunks, stream);
    return launch(node_bwd_f32_kernel<NP, true, false, SP>, f, p, chunks, stream);
}

bool takes(int N, int D_) { return D_ == D && (N == 128 || N == 256); }

// The output tiles of the node weights' four products (128 x 128 each):
// w_contr (N x D), w_exp (D x N), w_in_c (N x 4N), w_out_c (2N x N).
int product_tiles(int N) {
    const int NP = N / dwp::kTile;
    return NP + NP + NP * 4 * NP + 2 * NP * NP;
}

// The node weights' gradients of one layer in CenterWeights order: w_contr,
// b_contr, w_exp, b_exp, norm_c, w_in_c, b_in_c, w_out_c, b_out_c.
struct DwLayoutNode {
    long long w_contr, b_contr, w_exp, b_exp, norm_c, w_in_c, b_in_c, w_out_c, b_out_c, total;
    explicit DwLayoutNode(int N) {
        const long long n = N, d = D;
        w_contr = 0;
        b_contr = w_contr + n * d;
        w_exp = b_contr + d;
        b_exp = w_exp + d * n;
        norm_c = b_exp + n;
        w_in_c = norm_c + n;
        b_in_c = w_in_c + 4 * n * n;
        w_out_c = b_in_c + 4 * n;
        b_out_c = w_out_c + 2 * n * n;
        total = b_out_c + n;
    }
};

}  // namespace
}  // namespace nodef32
}  // namespace mtt

// Whether the Hopper float32 node-stream kernels take the widths: d_pet D =
// 128 and the node width N = 128 or 256.
extern "C" int mtt_gnn_node_f32_sm90_ok(int N, int D) { return mtt::nodef32::takes(N, D) ? 1 : 0; }

// Their shared bytes per block (one tile of 64 atoms; the backward's in
// either mode), 0 where they do not take the widths.
extern "C" size_t mtt_gnn_node_f32_sm90_smem(int N, int D, int backward) {
    using namespace mtt::nodef32;
    if (!takes(N, D)) return 0;
    if (backward) return 4 * (size_t)(N == 256 ? Geo<2>::kBwdFloats : Geo<1>::kBwdFloats);
    return 4 * (size_t)(N == 256 ? Geo<2>::kFwdFloats : Geo<1>::kFwdFloats);
}

// The node-stream forward of one layer boundary, float32 tensors. cattn
// non-null: the update of `node` by the layer's center attention output
// (w_exp^T (N, D), b_exp, norm_c, w_vg = w_in_c^T (4N, N) with its rows in
// blocks of 128, value block i then gate block i, b_in_c, w_out_c^T (N,
// 2N), b_out_c) into node_out; w_contr_t non-null: the next layer's
// contraction (w_contr^T (D, N), b_contr) of the updated node (of `node`
// without the update) into center_out. One block per 64 atoms on `stream`.
// Returns the CUDA error code (cudaErrorInvalidValue for widths it does not
// take or neither part).
extern "C" int mtt_gnn_node_fwd_f32_sm90(const float* node, const float* cattn, const float* w_exp_t,
                                         const float* b_exp, const float* norm_c, const float* w_vg,
                                         const float* b_in_c, const float* w_out_t, const float* b_out_c,
                                         const float* w_contr_t, const float* b_contr, float* node_out,
                                         float* center_out, long long A, int N, int D, float eps, void* stream) {
    using namespace mtt::nodef32;
    const bool upd = cattn != nullptr, con = w_contr_t != nullptr;
    if (!takes(N, D) || !(upd || con)) return (int)cudaErrorInvalidValue;
    if (A == 0) return 0;
    const FwdArgs p{node, cattn, b_exp, norm_c, b_in_c, b_out_c, b_contr, node_out, center_out, A, eps};
    const FwdChunks chunks{w_exp_t, w_vg, w_out_t, w_contr_t, N, upd};
    if (N == 256) return run_fwd<2>(p, chunks, upd, con, (cudaStream_t)stream);
    return run_fwd<1>(p, chunks, upd, con, (cudaStream_t)stream);
}

// The node-stream backward of one layer boundary, float32 tensors.
// d_center non-null: first the contraction's backward of the layer above
// (w_contr (N, D) as it is), d_n = dn + d_center w_contr^T; else d_n = dn.
// cattn non-null: the layer's node-update backward from d_n, recomputing its
// forward from node and cattn (w_exp^T, b_exp, norm_c, w_vg, b_in_c as the
// forward takes them, w_out_c (2N, N), w_in_c (N, 4N) and w_exp (D, N) as
// they are), into d_cattn and d_nmid; else d_node = d_n. Spill mode (vec or
// vec_con non-null): with the update's backward also s_hn (A, N), s_h (A,
// 2N), s_dvg (A, 4N), with the contraction's s_dn (A, N), and each tile's
// vector sums into its row of vec (b_exp, norm_c, b_in_c, b_out_c) and of
// vec_con (b_contr), rows of D + 7N floats. One block per 64 atoms on
// `stream`. Returns the CUDA error code.
extern "C" int mtt_gnn_node_bwd_f32_sm90(const float* node, const float* cattn, const float* dn,
                                         const float* d_center, const float* w_contr, const float* w_exp_t,
                                         const float* b_exp, const float* norm_c, const float* w_vg,
                                         const float* b_in_c, const float* w_out_c, const float* w_in_c,
                                         const float* w_exp, float* d_cattn, float* d_nmid, float* d_node,
                                         float* s_hn, float* s_h, float* s_dvg, float* s_dn, float* vec,
                                         float* vec_con, long long A, int N, int D, float eps, void* stream) {
    using namespace mtt::nodef32;
    const bool pro = d_center != nullptr, body = cattn != nullptr, sp = vec != nullptr || vec_con != nullptr;
    const bool spill_ok = !sp || ((!body || (s_hn && s_h && s_dvg && vec && (!pro || s_dn))) && (!pro || vec_con) &&
                                  (body || !vec));
    if (!takes(N, D) || !(pro || body) || dn == nullptr || !spill_ok) return (int)cudaErrorInvalidValue;
    if (A == 0) return 0;
    const BwdArgs p{node, cattn, dn, d_center, b_exp, norm_c, b_in_c, d_cattn, d_nmid, d_node,
                    s_hn, s_h, s_dvg, s_dn, vec, vec_con, A, eps};
    const BwdChunks chunks{w_contr, w_exp_t, w_out_c, w_vg, w_in_c, w_exp, N, pro};
    const cudaStream_t s = (cudaStream_t)stream;
    if (N == 256) return sp ? run_bwd<2, true>(p, chunks, pro, body, s) : run_bwd<2, false>(p, chunks, pro, body, s);
    return sp ? run_bwd<1, true>(p, chunks, pro, body, s) : run_bwd<1, false>(p, chunks, pro, body, s);
}

// The second pass of one layer's node weights (float32): the four products
// dW = X^T dY over A atoms (w_contr: node, d_center; w_exp: cattn, d_nmid;
// w_in_c: s_hn, s_dvg; w_out_c: s_h, s_dn) as K2-dW's split-K product, the
// tiles' vector rows `vec` (ceil(A / 64) rows of D + 7N floats) summed the
// same way, into dw (CenterWeights order, flat). partials: (max_slices,
// n_dw) floats; the call is refused where the plan's slices exceed
// max_slices. Returns the CUDA error code.
extern "C" int mtt_gnn_node_dw_f32_sm90(const float* node, const float* cattn, const float* d_center,
                                        const float* d_nmid, const float* s_hn, const float* s_h,
                                        const float* s_dvg, const float* s_dn, const float* vec, float* partials,
                                        float* dw, long long A, int N, int D, int sms, int max_slices,
                                        void* stream) {
    using namespace mtt::nodef32;
    namespace dwp = mtt::dwp;
    if (!takes(N, D) || sms <= 0) return (int)cudaErrorInvalidValue;
    const DwLayoutNode L(N);
    const cudaStream_t s = (cudaStream_t)stream;
    if (A == 0) return (int)cudaMemsetAsync(dw, 0, L.total * sizeof(float), s);
    const int NP = N / dwp::kTile, DP = D / dwp::kTile;
    dwp::ProductArgs<float> a{};
    const float* X[4] = {node, cattn, s_hn, s_h};
    const float* Y[4] = {d_center, d_nmid, s_dvg, s_dn};
    const int ldx[4] = {N, D, N, 2 * N}, ldy[4] = {D, N, 4 * N, N};
    const long long out[4] = {L.w_contr, L.w_exp, L.w_in_c, L.w_out_c};
    const int tr[4] = {NP, DP, NP, 2 * NP}, tc[4] = {DP, NP, 4 * NP, NP};
    for (int q = 0; q < 4; ++q) {
        a.X[q] = X[q];
        a.Y[q] = Y[q];
        a.ldx[q] = ldx[q];
        a.ldy[q] = a.ldo[q] = ldy[q];
        a.out[q] = out[q];
        a.tr[q] = tr[q];
        a.tc[q] = tc[q];
    }
    a.tiles = product_tiles(N);
    a.geo_q = -1;
    a.rows = A;
    a.step = dwp::slice_step_tiles(A, a.tiles, sms);
    a.M = 1;
    a.partials = partials;
    a.n_dw = L.total;
    if ((A + a.step - 1) / a.step > max_slices) return (int)cudaErrorInvalidValue;
    const dwp::VecMap map{{D, N, N, 4 * N, N, 0}, {L.b_contr, L.b_exp, L.norm_c, L.b_in_c, L.b_out_c, 0}, D + 7 * N};
    return dwp::run_products<float>(a, vec, (A + mtt::sm90::kRows - 1) / mtt::sm90::kRows, map, dw, true, s);
}
