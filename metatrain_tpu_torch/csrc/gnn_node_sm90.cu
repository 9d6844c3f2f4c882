// The node stream of the fused GNN block on Hopper: the node update and
// the contractions between the attention layers, forward and
// input-gradient backward, 64 atoms per tile.
//
// Replaces the node-stream part of the TPU kernels
// metatrain_tpu/ops/pallas/fused_layer.py `_gnn_fwd_kernel` and
// `_gnn_bwd_kernel` (body `_gnn_block_math` / `_gnn_block_bwd_math`) in
// bfloat16 without weight gradients. The Hopper GNN block
// (ops/kernels/gnn_block.py) runs each attention layer on the Hopper K1 and
// K2 and this pair of kernels between them:
//
//   forward (node_fwd_kernel), per atom, N = d_node, D = d_pet = 128:
//     n_mid   = rnd(node + rnd(cattn w_exp + b_exp))          (D -> N)
//     hn      = rnd(n_mid r2 norm_c), r2 = rsqrt(mean(n_mid^2) + eps)
//     [v | g] = hn w_in_c + b_in_c                           (N -> 4N, float)
//     h       = rnd(v sigmoid(g))
//     node'   = rnd(n_mid + rnd(h w_out_c + b_out_c))         (2N -> N)
//     center' = rnd(node' w_contr + b_contr)                  (N -> D, the next layer's)
//   with the update alone after the last layer, and the contraction alone
//   before the first;
//
//   backward (node_bwd_kernel): the contraction's backward of the layer
//   above first, d_n = d_nmid' + d_center' w_contr'^T (float), then
//     d_h = rnd(d_n) w_out_c^T;  d_vg = rnd([d_h sig, d_h v sig (1 - sig)])
//     d_hn = d_vg w_in_c^T;  gs = d_hn r2 norm_c
//     d_nmid = d_n + (gs - n_mid (r2^2 sum(gs n_mid) / N))      (float)
//     d_cattn = rnd(rnd(d_nmid) w_exp^T)
//   recomputing n_mid, hn, v and g from node and cattn with the forward's
//   own device code; after the first layer the contraction's backward
//   alone gives d_node = rnd(d_n).
// Rounding is the plain version's (gnn_block.py `_center_forward`,
// `gnn_block_bwd_math`); vg and every cotangent that crosses a launch stay
// float.
//
// What bounds it on the H100: the general block ran the stream as one GEMV
// per atom (0.9 MB of bf16 weights read from L2 per atom and layer, ~21 GB a
// launch at A = 11,392). Here a tile of 64 atoms is one 64-row panel and
// every product runs on wgmma through layer_sm90.cuh's ring of staged 128 x
// 64 weight chunks (panel_mm, one 64 x 128 panel per product, each
// warpgroup 32 columns): the weights are read once per 64 atoms, 56 chunks
// (0.9 MB) a tile forward and 92 backward at N = 256. The forward's
// w_in_c^T comes with its value and gate rows interleaved in blocks of 128
// (the wrapper's w_vg), so that a hidden tile's value chunks and then its
// gate chunks leave v and g of the same elements in the same thread and
// h = rnd(v sigmoid(g)) forms in registers; the backward recomputes them
// the same way beside d_h. At L = 2 the stream is ~10.5 GFLOP a block call,
// ~0.011 ms at 989 TFLOP/s: a chunk barrier per 1 MFLOP keeps it far from
// that, and it is a small part of the block either way. N = 128 or 256
// (`mtt_gnn_node_sm90_ok`); one tile per block; no atomics, the same bits in
// every launch.

#include "layer_sm90.cuh"

namespace mtt {
namespace sm90 {
namespace {

constexpr int LT = kChunkN + 8;  // a 64 x 128 bf16 tile (the h, d_v and d_g tiles)
constexpr int kRingBytes = kStages * kChunkElems * 2;
constexpr int kTileD = kRows * LA * 2;  // a 64 x D bf16 tile (cattn, d_center)
constexpr int kTileT = kRows * LT * 2;

// A 64 x N bf16 tile.
template <int NP>
struct NodeTile {
    static constexpr int N = kChunkN * NP;
    static constexpr int LN = N + 8;
    static constexpr int kBytes = kRows * LN * 2;
};

// Shared bytes of the forward: the ring, cattn, n_mid, hn (then node'),
// the h tile, r2.
template <int NP>
constexpr int fwd_bytes() {
    return kRingBytes + kTileD + 2 * NodeTile<NP>::kBytes + kTileT + 4 * kRows;
}

// Of the backward: the ring, d_center, cattn, n_mid, hn, rnd(d_n) (then
// rnd(d_nmid)), the d_v and d_g tiles, r2 and 4 x 64 of row-sum scratch.
template <int NP>
constexpr int bwd_bytes() {
    return kRingBytes + 2 * kTileD + 3 * NodeTile<NP>::kBytes + 2 * kTileT + 4 * 5 * kRows;
}

static_assert(bwd_bytes<2>() <= 232448, "one block per SM");
static_assert(kRingBytes % 1024 == 0, "the swizzled ring leads the shared memory");

// T (64 x W bf16, row stride ldt) = rows a0 .. a0 + 63 of g (A x W bf16),
// zero past A.
__device__ __forceinline__ void load_tile(bf16* T, int ldt, const bf16* g, int W, long long a0,
                                          long long A) {
    const int pieces = W / 8;
    for (int i = threadIdx.x; i < kRows * pieces; i += kThreads) {
        const int m = i / pieces, k = (i % pieces) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (a0 + m < A) v = *reinterpret_cast<const uint4*>(g + (a0 + m) * W + k);
        *reinterpret_cast<uint4*>(T + m * ldt + k) = v;
    }
}

// The forward's weight chunks in the order its products consume them, each
// as (N_out, K) row-major: with the update, the expansion (w_exp^T, 2 per
// 128 columns of N), then per hidden tile t of 128 of the 2N columns the
// value chunks (rows 256 t .. + 127 of w_vg, N / 64 k slices), the gate
// chunks (rows 256 t + 128 .., the same) and the out-projection (w_out_c^T
// rows 128 q .., columns 128 t .. + 127 in two halves, per q); with the
// contraction, w_contr^T (N / 64 k slices).
struct FwdChunks {
    const bf16 *w_exp_t, *w_vg, *w_out_t, *w_contr_t;
    int N;
    bool upd;

    __device__ const bf16* operator()(int c, int& ld) const {
        const int NP = N / kChunkN, NK = N / kChunkK;
        if (upd) {
            if (c < 2 * NP) {
                ld = D;
                return w_exp_t + (size_t)(c >> 1) * kChunkN * D + (c & 1) * kChunkK;
            }
            c -= 2 * NP;
            const int per = 2 * NK + 2 * NP;
            if (c < NK * per) {
                const int t = c / per;
                int r = c % per;
                if (r < 2 * NK) {
                    ld = N;
                    return w_vg + (size_t)(2 * t + r / NK) * kChunkN * N + (r % NK) * kChunkK;
                }
                r -= 2 * NK;
                ld = 2 * N;
                return w_out_t + (size_t)(r >> 1) * kChunkN * 2 * N + t * kChunkN + (r & 1) * kChunkK;
            }
            c -= NK * per;
        }
        ld = N;
        return w_contr_t + c * kChunkK;
    }
};

__host__ __device__ constexpr int fwd_chunk_count(int N, bool upd, bool con) {
    return (upd ? 2 * (N / kChunkN) + (N / kChunkK) * (2 * (N / kChunkK) + 2 * (N / kChunkN)) : 0) +
           (con ? N / kChunkK : 0);
}

// The backward's, likewise: with the prologue, w_contr (2 per 128 columns of
// N); with the body, the recompute's expansion (w_exp^T), then per hidden
// tile t: d_h's (w_out_c rows 128 t .., N / 64 k slices), the value and
// gate chunks of the forward, d_hn's (w_in_c rows 128 q .., per q the value
// columns 128 t .. + 127 then the same gate columns, in halves); last
// d_cattn's (w_exp, N / 64 k slices).
struct BwdChunks {
    const bf16 *w_contr, *w_exp_t, *w_out_c, *w_vg, *w_in_c, *w_exp;
    int N;
    bool pro;

    __device__ const bf16* operator()(int c, int& ld) const {
        const int NP = N / kChunkN, NK = N / kChunkK;
        if (pro) {
            if (c < 2 * NP) {
                ld = D;
                return w_contr + (size_t)(c >> 1) * kChunkN * D + (c & 1) * kChunkK;
            }
            c -= 2 * NP;
        }
        if (c < 2 * NP) {
            ld = D;
            return w_exp_t + (size_t)(c >> 1) * kChunkN * D + (c & 1) * kChunkK;
        }
        c -= 2 * NP;
        const int per = 3 * NK + 4 * NP;
        if (c < NK * per) {
            const int t = c / per;
            int r = c % per;
            ld = N;
            if (r < NK) return w_out_c + (size_t)t * kChunkN * N + r * kChunkK;
            r -= NK;
            if (r < 2 * NK) return w_vg + (size_t)(2 * t + r / NK) * kChunkN * N + (r % NK) * kChunkK;
            r -= 2 * NK;
            const int q = r >> 2, e = r & 3;
            ld = 4 * N;
            const int col = (e < 2 ? 0 : 2 * N) + t * kChunkN + (e & 1) * kChunkK;
            return w_in_c + (size_t)q * kChunkN * 4 * N + col;
        }
        c -= NK * per;
        ld = N;
        return w_exp + c * kChunkK;
    }
};

__host__ __device__ constexpr int bwd_chunk_count(int N, bool pro, bool body) {
    return (pro ? 2 * (N / kChunkN) : 0) +
           (body ? 2 * (N / kChunkN) + (N / kChunkK) * (3 * (N / kChunkK) + 4 * (N / kChunkN)) +
                       N / kChunkK
                 : 0);
}

// NM = rnd(node + rnd(cattn w_exp + b_exp)) over the ring's next 2 NP
// chunks, cattn in CA; rows past A read node as zero.
template <int NP, typename Ring>
__device__ __forceinline__ void expand(Ring& ring, int& c, const bf16* CA, bf16* NM, const bf16* node,
                                       const bf16* b_exp, long long a0, long long A) {
    constexpr int N = NodeTile<NP>::N, LN = NodeTile<NP>::LN;
#pragma unroll 1
    for (int q = 0; q < NP; ++q) {
        float acc[4][4];
        zero(acc);
        panel_mm<2>(ring, c, [&](int r, int& ld) { ld = LA; return CA + r * kChunkK; }, acc);
        panel_pairs([&](int j, int h, int m, int n) {
            const int col = kChunkN * q + n;
            const float2 b = ld2(b_exp + col);
            const float2 x = a0 + m < A ? ld2(node + (a0 + m) * N + col) : make_float2(0.f, 0.f);
            store2(NM + m * LN + col, x.x + rnd<bf16>(acc[j][2 * h] + b.x),
                   x.y + rnd<bf16>(acc[j][2 * h + 1] + b.y));
        });
    }
}

// HN = rnd(NM r2 norm_c), r2 = rsqrt(mean(NM^2) + eps) to R2: one warp per
// row. The caller syncs before (NM written) and after.
template <int NP>
__device__ __forceinline__ void rms_tile(const bf16* NM, bf16* HN, const bf16* norm_c, float* R2, float eps) {
    constexpr int N = NodeTile<NP>::N, LN = NodeTile<NP>::LN;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int m = warp; m < kRows; m += kThreads / 32) {
        float s = 0.f;
#pragma unroll
        for (int n = 2 * lane; n < N; n += 64) {
            const float2 x = ld2(NM + m * LN + n);
            s = fmaf(x.x, x.x, fmaf(x.y, x.y, s));
        }
        const float r = rsqrtf(warp_sum(s) / N + eps);
        if (lane == 0) R2[m] = r;
#pragma unroll
        for (int n = 2 * lane; n < N; n += 64) {
            const float2 x = ld2(NM + m * LN + n), w = ld2(norm_c + n);
            store2(HN + m * LN + n, x.x * r * w.x, x.y * r * w.y);
        }
    }
}

// av, ag = hn times hidden tile t's value and gate columns (no bias): the
// ring's next N / 64 value chunks, then as many gate chunks, so that each
// thread holds v and g of the same elements.
template <int NP, typename Ring>
__device__ __forceinline__ void glu_tile(Ring& ring, int& c, const bf16* HN, float (&av)[4][4],
                                         float (&ag)[4][4]) {
    constexpr int NK = 2 * NP, LN = NodeTile<NP>::LN;
    auto a = [&](int r, int& ld) { ld = LN; return HN + r * kChunkK; };
    zero(av);
    zero(ag);
    panel_mm<NK>(ring, c, a, av);
    panel_mm<NK>(ring, c, a, ag);
}

struct FwdArgs {
    const bf16* node;     // (A, N)
    const bf16* cattn;    // (A, D): the layer's center attention output; null: no update
    const bf16* b_exp;    // (N,)
    const bf16* norm_c;   // (N,)
    const bf16* b_in_c;   // (4N,): value columns, then gate columns
    const bf16* b_out_c;  // (N,)
    const bf16* b_contr;  // (D,): the next layer's
    bf16* node_out;       // (A, N), with the update
    bf16* center_out;     // (A, D), with the contraction
    long long A;
    float eps;
};

template <int NP, bool UPD, bool CON>
__global__ void __launch_bounds__(kThreads, 1) node_fwd_kernel(FwdArgs p, FwdChunks chunks) {
    constexpr int N = NodeTile<NP>::N, LN = NodeTile<NP>::LN, NK = 2 * NP;
    extern __shared__ __align__(1024) unsigned char smem[];
    bf16* CA = reinterpret_cast<bf16*>(smem + kRingBytes);
    bf16* NM = CA + kRows * LA;
    bf16* HN = NM + kRows * LN;  // hn, then node' (the contraction's operand)
    bf16* HT = HN + kRows * LN;
    float* R2 = reinterpret_cast<float*>(HT + kRows * LT);
    const long long a0 = (long long)blockIdx.x * kRows;

    WeightRing<FwdChunks> ring{reinterpret_cast<bf16*>(smem), chunks, fwd_chunk_count(N, UPD, CON)};
    ring.start();
    int c = 0;
    if constexpr (UPD) {
        load_tile(CA, LA, p.cattn, D, a0, p.A);
        expand<NP>(ring, c, CA, NM, p.node, p.b_exp, a0, p.A);
        __syncthreads();
        rms_tile<NP>(NM, HN, p.norm_c, R2, p.eps);
        // h and its out-projection, hidden tile after hidden tile; each h
        // tile is written after the tile's value and gate chunks, whose
        // barriers every warp passes only once done with the previous h tile
        float acc[NP][4][4];
#pragma unroll
        for (int q = 0; q < NP; ++q) zero(acc[q]);
#pragma unroll 1
        for (int t = 0; t < NK; ++t) {
            float av[4][4], ag[4][4];
            glu_tile<NP>(ring, c, HN, av, ag);
            panel_pairs([&](int j, int h, int m, int n) {
                const int col = kChunkN * t + n;
                const float2 bv = ld2(p.b_in_c + col), bg = ld2(p.b_in_c + 2 * N + col);
                store2(HT + m * LT + n, (av[j][2 * h] + bv.x) * sigmoidf_(ag[j][2 * h] + bg.x),
                       (av[j][2 * h + 1] + bv.y) * sigmoidf_(ag[j][2 * h + 1] + bg.y));
            });
#pragma unroll
            for (int q = 0; q < NP; ++q)
                panel_mm<2>(ring, c, [&](int r, int& ld) { ld = LT; return (const bf16*)HT + r * kChunkK; },
                            acc[q]);
        }
        // node' = rnd(n_mid + rnd(h w_out_c + b_out_c)); every warp is past
        // the last reads of hn (the last gate chunks' barriers)
#pragma unroll
        for (int q = 0; q < NP; ++q) {
            panel_pairs([&](int j, int h, int m, int n) {
                const int col = kChunkN * q + n;
                const float2 x = ld2(NM + m * LN + col), b = ld2(p.b_out_c + col);
                const float y0 = x.x + rnd<bf16>(acc[q][j][2 * h] + b.x);
                const float y1 = x.y + rnd<bf16>(acc[q][j][2 * h + 1] + b.y);
                if (a0 + m < p.A) store2(p.node_out + (a0 + m) * N + col, y0, y1);
                if (CON) store2(HN + m * LN + col, y0, y1);
            });
        }
    } else {
        load_tile(HN, LN, p.node, N, a0, p.A);
    }
    if constexpr (CON) {
        float acc[4][4];
        zero(acc);
        panel_mm<NK>(ring, c, [&](int r, int& ld) { ld = LN; return (const bf16*)HN + r * kChunkK; }, acc);
        panel_pairs([&](int j, int h, int m, int n) {
            if (a0 + m >= p.A) return;
            const float2 b = ld2(p.b_contr + n);
            store2(p.center_out + (a0 + m) * D + n, acc[j][2 * h] + b.x, acc[j][2 * h + 1] + b.y);
        });
    }
}

struct BwdArgs {
    const bf16* node;      // (A, N), with the body
    const bf16* cattn;     // (A, D), with the body (null: the prologue alone)
    const float* dn_f;     // (A, N) the incoming cotangent in float (d_nmid of the layer above),
    const bf16* dn_h;      // or in bf16 (g_node): one of the two
    const bf16* d_center;  // (A, D) the layer above's; null: no prologue
    const bf16* b_exp;     // (N,)
    const bf16* norm_c;    // (N,)
    const bf16* b_in_c;    // (4N,)
    bf16* d_cattn;         // (A, D), with the body
    float* d_nmid;         // (A, N), with the body (holds d_n in between)
    bf16* d_node;          // (A, N), the prologue alone
    long long A;
    float eps;
};

template <int NP, bool PRO, bool BODY>
__global__ void __launch_bounds__(kThreads, 1) node_bwd_kernel(BwdArgs p, BwdChunks chunks) {
    constexpr int N = NodeTile<NP>::N, LN = NodeTile<NP>::LN, NK = 2 * NP;
    extern __shared__ __align__(1024) unsigned char smem[];
    bf16* DC = reinterpret_cast<bf16*>(smem + kRingBytes);
    bf16* CA = DC + kRows * LA;
    bf16* NM = CA + kRows * LA;
    bf16* HN = NM + kRows * LN;
    bf16* DNC = HN + kRows * LN;  // rnd(d_n), then rnd(d_nmid)
    bf16* DV = DNC + kRows * LN;
    bf16* DG = DV + kRows * LT;
    float* R2 = reinterpret_cast<float*>(DG + kRows * LT);
    float* RED = R2 + kRows;
    const long long a0 = (long long)blockIdx.x * kRows;
    // the incoming cotangent's pair at (atom, column), zero past A
    auto dn_in = [&](long long a, int col) {
        if (a >= p.A) return make_float2(0.f, 0.f);
        if (p.dn_f != nullptr) return *reinterpret_cast<const float2*>(p.dn_f + a * N + col);
        return ld2(p.dn_h + a * N + col);
    };

    WeightRing<BwdChunks> ring{reinterpret_cast<bf16*>(smem), chunks, bwd_chunk_count(N, PRO, BODY)};
    ring.start();
    int c = 0;
    // ---- the contraction's backward: d_n = dn + d_center w_contr^T ---------
    if constexpr (PRO) {
        load_tile(DC, LA, p.d_center, D, a0, p.A);
#pragma unroll 1
        for (int q = 0; q < NP; ++q) {
            float acc[4][4];
            zero(acc);
            panel_mm<2>(ring, c, [&](int r, int& ld) { ld = LA; return (const bf16*)DC + r * kChunkK; }, acc);
            panel_pairs([&](int j, int h, int m, int n) {
                const int col = kChunkN * q + n;
                const long long a = a0 + m;
                const float2 d = dn_in(a, col);
                const float v0 = d.x + acc[j][2 * h], v1 = d.y + acc[j][2 * h + 1];
                if (!BODY) {
                    if (a < p.A) store2(p.d_node + a * N + col, v0, v1);
                } else {
                    // d_n waits in d_nmid's rows (this thread reads it back)
                    if (a < p.A) *reinterpret_cast<float2*>(p.d_nmid + a * N + col) = make_float2(v0, v1);
                    store2(DNC + m * LN + col, v0, v1);
                }
            });
        }
    }
    if constexpr (BODY) {
        if constexpr (!PRO) {
            for (int i = threadIdx.x; i < kRows * N / 2; i += kThreads) {
                const int m = i / (N / 2), col = 2 * (i % (N / 2));
                const float2 d = dn_in(a0 + m, col);
                store2(DNC + m * LN + col, d.x, d.y);
            }
        }
        // ---- the forward's n_mid, hn (its code) ------------------------------
        load_tile(CA, LA, p.cattn, D, a0, p.A);
        expand<NP>(ring, c, CA, NM, p.node, p.b_exp, a0, p.A);
        __syncthreads();
        rms_tile<NP>(NM, HN, p.norm_c, R2, p.eps);

        // ---- per hidden tile: d_h, v, g -> d_vg -> d_hn (registers) ----------
        float dhn[NP][4][4];
#pragma unroll
        for (int q = 0; q < NP; ++q) zero(dhn[q]);
#pragma unroll 1
        for (int t = 0; t < NK; ++t) {
            float dh[4][4];
            zero(dh);
            panel_mm<NK>(ring, c, [&](int r, int& ld) { ld = LN; return (const bf16*)DNC + r * kChunkK; }, dh);
            float av[4][4], ag[4][4];
            glu_tile<NP>(ring, c, HN, av, ag);
            panel_pairs([&](int j, int h, int m, int n) {
                const int col = kChunkN * t + n;
                const float2 bv = ld2(p.b_in_c + col), bg = ld2(p.b_in_c + 2 * N + col);
                float dv[2], dg[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float v = av[j][2 * h + e] + (e ? bv.y : bv.x);
                    const float sg = sigmoidf_(ag[j][2 * h + e] + (e ? bg.y : bg.x));
                    const float d = dh[j][2 * h + e];
                    dv[e] = d * sg;
                    dg[e] = d * v * sg * (1.f - sg);
                }
                store2(DV + m * LT + n, dv[0], dv[1]);
                store2(DG + m * LT + n, dg[0], dg[1]);
            });
#pragma unroll
            for (int q = 0; q < NP; ++q)
                panel_mm<4>(ring, c, [&](int r, int& ld) {
                    ld = LT;
                    return (const bf16*)(r < 2 ? DV : DG) + (r & 1) * kChunkK;
                }, dhn[q]);
        }

        // ---- RMSNorm backward -> d_nmid (float, global), rnd(d_nmid) -------
        float s[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < NP; ++q) {
            float sq[2];
            panel_row_sums(RED, [&](int j, int i, int m, int n) {
                const int col = kChunkN * q + n;
                const float gs = dhn[q][j][i] * (R2[m] * __bfloat162float(p.norm_c[col]));
                return gs * __bfloat162float(NM[m * LN + col]);
            }, sq);
            s[0] += sq[0];
            s[1] += sq[1];
        }
#pragma unroll
        for (int q = 0; q < NP; ++q) {
            panel_pairs([&](int j, int h, int m, int n) {
                const int col = kChunkN * q + n;
                const long long a = a0 + m;
                const float r = R2[m], cm = r * r * s[h] / N;
                const float2 x = ld2(NM + m * LN + col), w = ld2(p.norm_c + col);
                float2 d = make_float2(0.f, 0.f);
                if (PRO) {
                    if (a < p.A) d = *reinterpret_cast<const float2*>(p.d_nmid + a * N + col);
                } else {
                    d = dn_in(a, col);
                }
                const float g0 = dhn[q][j][2 * h] * (r * w.x), g1 = dhn[q][j][2 * h + 1] * (r * w.y);
                const float y0 = d.x + (g0 - x.x * cm), y1 = d.y + (g1 - x.y * cm);
                if (a < p.A) *reinterpret_cast<float2*>(p.d_nmid + a * N + col) = make_float2(y0, y1);
                store2(DNC + m * LN + col, y0, y1);
            });
        }

        // ---- d_cattn = rnd(rnd(d_nmid) w_exp^T) -------------------------------
        float acc[4][4];
        zero(acc);
        panel_mm<NK>(ring, c, [&](int r, int& ld) { ld = LN; return (const bf16*)DNC + r * kChunkK; }, acc);
        panel_pairs([&](int j, int h, int m, int n) {
            if (a0 + m < p.A) store2(p.d_cattn + (a0 + m) * D + n, acc[j][2 * h], acc[j][2 * h + 1]);
        });
    }
}

template <typename Kernel, typename Args, typename Chunks>
int launch(Kernel kernel, int bytes, const Args& p, const Chunks& chunks, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)((p.A + kRows - 1) / kRows), kThreads, bytes, stream>>>(p, chunks);
    return (int)cudaGetLastError();
}

template <int NP>
int run_fwd(const FwdArgs& p, const FwdChunks& chunks, bool upd, bool con, cudaStream_t stream) {
    if (upd && con) return launch(node_fwd_kernel<NP, true, true>, fwd_bytes<NP>(), p, chunks, stream);
    if (upd) return launch(node_fwd_kernel<NP, true, false>, fwd_bytes<NP>(), p, chunks, stream);
    return launch(node_fwd_kernel<NP, false, true>, fwd_bytes<NP>(), p, chunks, stream);
}

template <int NP>
int run_bwd(const BwdArgs& p, const BwdChunks& chunks, bool pro, bool body, cudaStream_t stream) {
    if (pro && body) return launch(node_bwd_kernel<NP, true, true>, bwd_bytes<NP>(), p, chunks, stream);
    if (body) return launch(node_bwd_kernel<NP, false, true>, bwd_bytes<NP>(), p, chunks, stream);
    return launch(node_bwd_kernel<NP, true, false>, bwd_bytes<NP>(), p, chunks, stream);
}

}  // namespace
}  // namespace sm90
}  // namespace mtt

// Whether the Hopper node-stream kernels take the widths: d_pet D = 128 and
// the node width N = 128 or 256.
extern "C" int mtt_gnn_node_sm90_ok(int N, int D) {
    return D == mtt::sm90::D && (N == 128 || N == 256);
}

// Their shared bytes per block (one tile of 64 atoms), 0 where they do not
// take the widths.
extern "C" size_t mtt_gnn_node_sm90_smem(int N, int D, int backward) {
    if (!mtt_gnn_node_sm90_ok(N, D)) return 0;
    using namespace mtt::sm90;
    if (backward) return N == 256 ? bwd_bytes<2>() : bwd_bytes<1>();
    return N == 256 ? fwd_bytes<2>() : fwd_bytes<1>();
}

// The node-stream forward of one layer boundary, bfloat16 tensors. cattn
// non-null: the update of `node` by the layer's center attention output
// (w_exp^T (N, D), b_exp, norm_c, w_vg = w_in_c^T (4N, N) with its rows in
// blocks of 128, value block i then gate block i, b_in_c, w_out_c^T (N,
// 2N), b_out_c) into node_out; w_contr_t non-null: the next layer's
// contraction (w_contr^T (D, N), b_contr) of the updated node (of `node`
// without the update) into center_out. One block per 64 atoms on `stream`.
// Returns the CUDA error code (cudaErrorInvalidValue for widths it does not
// take or neither part).
extern "C" int mtt_gnn_node_fwd_sm90(
    const void* node, const void* cattn, const void* w_exp_t, const void* b_exp, const void* norm_c,
    const void* w_vg, const void* b_in_c, const void* w_out_t, const void* b_out_c,
    const void* w_contr_t, const void* b_contr, void* node_out, void* center_out,
    long long A, int N, int D, float eps, void* stream) {
    using namespace mtt::sm90;
    const bool upd = cattn != nullptr, con = w_contr_t != nullptr;
    if (!mtt_gnn_node_sm90_ok(N, D) || !(upd || con)) return (int)cudaErrorInvalidValue;
    if (A == 0) return 0;
    const FwdArgs p{(const bf16*)node, (const bf16*)cattn, (const bf16*)b_exp, (const bf16*)norm_c,
                    (const bf16*)b_in_c, (const bf16*)b_out_c, (const bf16*)b_contr, (bf16*)node_out,
                    (bf16*)center_out, A, eps};
    const FwdChunks chunks{(const bf16*)w_exp_t, (const bf16*)w_vg, (const bf16*)w_out_t,
                           (const bf16*)w_contr_t, N, upd};
    if (N == 256) return run_fwd<2>(p, chunks, upd, con, (cudaStream_t)stream);
    return run_fwd<1>(p, chunks, upd, con, (cudaStream_t)stream);
}

// The node-stream backward of one layer boundary, bfloat16 tensors but the
// float cotangents. d_center non-null: first the contraction's backward of
// the layer above (w_contr (N, D) as it is), d_n = dn + d_center w_contr^T;
// else d_n = dn. dn: dn_f (float) or dn_h (bf16), one of the two. cattn
// non-null: the layer's node-update backward from d_n, recomputing its
// forward from node and cattn (w_exp^T, b_exp, norm_c, w_vg, b_in_c as the
// forward takes them, w_out_c (2N, N), w_in_c (N, 4N) and w_exp (D, N) as
// they are), into d_cattn (bf16) and d_nmid (float; it must not be dn_f);
// else d_node = rnd(d_n). One block per 64 atoms on `stream`. Returns the
// CUDA error code.
extern "C" int mtt_gnn_node_bwd_sm90(
    const void* node, const void* cattn, const void* dn_f, const void* dn_h, const void* d_center,
    const void* w_contr, const void* w_exp_t, const void* b_exp, const void* norm_c, const void* w_vg,
    const void* b_in_c, const void* w_out_c, const void* w_in_c, const void* w_exp,
    void* d_cattn, void* d_nmid, void* d_node, long long A, int N, int D, float eps, void* stream) {
    using namespace mtt::sm90;
    const bool pro = d_center != nullptr, body = cattn != nullptr;
    if (!mtt_gnn_node_sm90_ok(N, D) || !(pro || body) || (dn_f == nullptr) == (dn_h == nullptr) ||
        (body && dn_f != nullptr && dn_f == d_nmid))
        return (int)cudaErrorInvalidValue;
    if (A == 0) return 0;
    const BwdArgs p{(const bf16*)node, (const bf16*)cattn, (const float*)dn_f, (const bf16*)dn_h,
                    (const bf16*)d_center, (const bf16*)b_exp, (const bf16*)norm_c, (const bf16*)b_in_c,
                    (bf16*)d_cattn, (float*)d_nmid, (bf16*)d_node, A, eps};
    const BwdChunks chunks{(const bf16*)w_contr, (const bf16*)w_exp_t, (const bf16*)w_out_c,
                           (const bf16*)w_vg, (const bf16*)w_in_c, (const bf16*)w_exp, N, pro};
    if (N == 256) return run_bwd<2>(p, chunks, pro, body, (cudaStream_t)stream);
    return run_bwd<1>(p, chunks, pro, body, (cudaStream_t)stream);
}
