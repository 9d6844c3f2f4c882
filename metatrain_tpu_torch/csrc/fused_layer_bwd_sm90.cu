// K2 on Hopper: the exact bfloat16 input-gradient backward of the fused PET
// transformer layer, redesigned for the H100 at the served shapes; and,
// as its int8-score mode, K2-int8 there, and as its W8A8 mode, K2-W8A8
// (below).
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/fused_layer.py
// `_bwd_kernel` (pallas_call in `_make_bwd_op`) with weight_grads=False,
// without int8 or W8A8, in bfloat16: the same function as K2
// (fused_layer_bwd.cu) and its plain version `layer_bwd_math`, that is
// (d_edges, d_center, d_cf) with d_edges[:, M-1] == 0 and d_cf float32.
// It takes D = 128, heads of 16 (H = 8), 16 <= M <= 64 with M % 16 == 0
// and F % 128 == 0 (mtt_fused_layer_bwd_sm90_ok; the wrapper sends every
// other shape, and every other variant, to fused_layer_bwd.cu).
//
// What bounds it on the H100: operations. At the served shape (A = 11,392
// atoms, M = 64, F = 256) the dense products (16 D^2 + 10 D F a row: the
// forward recomputed but for FFN-out, then the input gradients) and the
// attention's products are 502 GFLOP: 0.507 ms at 989 TFLOP/s. The old
// body took 30 ms (59 x its bound); the design answers its four causes:
// - one atom per SM, one phase at a time: the old body kept every
//   activation in float (207 KB). Here every activation the plain version
//   rounds to bf16 is stored in bf16 (tokens' norm, q|k|v, attn, res,
//   h_norm, g_eo, d_vg, d_attn_out, d_attn and dq|dk|dv), and only what
//   the plain version keeps in float stays float: d_res (shared), vg, d_h
//   and d_n1 (registers, never whole in memory), the softmax statistics
//   and d_cf. Shared memory per atom: q|k|v 50,176 B, one 64 x 128 bf16
//   operand buffer 17,408 B, res + g_eo then d_res 34,816 B, the d_vg tile
//   then d_attn 33,792 B, the weight ring 49,152 B, statistics and
//   partial sums 16,128 B: 201,472 B. That is still one atom per SM, so a
//   second atom per tile does not fit; 16 warps per block hide latency
//   instead.
// - weights streamed from L2 as scalar loads: every weight reaches the
//   tensor cores through a ring of three staged chunks (128 x 64 bf16,
//   cp.async, 16-byte copies), issued two chunks ahead in one fixed
//   sequence of 36 chunks per atom (576 KB: each weight read once by the
//   recompute and once by the backward), so the copies overlap the
//   products and the phases between them. The SwiGLU backward walks F in
//   tiles of 128 columns (value column j beside gate column F + j): each
//   staged chunk serves all 64 rows, where the old body re-read w_in,
//   w_in^T and w_ffn_out^T for each of four 16-row chunks.
// - dense products on wgmma: each of the four warpgroups runs
//   m64n32k16 on its 32 columns of a 64 x 128 output panel, A (the atom's
//   64 rows, bf16) in registers from shared memory by ldmatrix, B straight
//   from the staged chunk by descriptor (the 128-byte swizzle); four k steps
//   per chunk, then one wait.
// - attention on FMA loops, one head after another: every attention
//   product (scores, P V, dP = dO V^T, dQ = dS K, dK = dS^T Q, dV = P^T
//   dO) runs on mma.sync with one warp per (head, 16-row tile), all heads
//   at once; the row statistics (max, cutoff-weighted sum, delta = sum P
//   dP) stay in float registers. The tensor cores take P, dO and dS in
//   bf16 where the plain version keeps them float (the JAX package's
//   _layer_bwd_math rounds the same three operands); everything else
//   rounds where the plain version does.
//
// d_cf is summed over queries and heads in a fixed order (per (head, query
// tile) column sums, then a fixed sum over them): no atomics, the same
// bits in every launch.
//
// The recompute up to h_norm is layer_sm90.cuh's forward phases, which the
// Hopper K1 (fused_layer_fwd_sm90.cu) runs too: the served bf16 call's
// forces are the gradient of the function whose energy K1 computes.
//
// K2-int8 (mtt_fused_layer_bwd_int8_sm90, the kernel's mode kInt8) replaces
// `_bwd_kernel` with int8 and weight_grads=False: the plain version is
// `layer_bwd_math(..., int8_scales=)`, the general body K2-int8 of
// fused_layer_bwd.cu. Its recompute is K1-int8's forward (the int8 copy of
// q and k, 64 x 272 bytes: 218,880 B a block), and both attention passes
// recompute the scores from that copy (the same int32 sums, transposed in
// pass 2) and the rounded weights P = rnd(cf e) / z from them and the
// stored (max, 1 / z): E and P as products with 1 / z, where the exact
// kernel divides each score by z. The softmax gradient is the general I8
// body's, the rounding taken as the identity: delta = sum_k P dP, dS = cf
// E (dP - delta) with E = e / z, and dQ = dS K, dK = dS^T Q on the bf16 q
// and k (straight through). P, dO and dS round to bf16 for the tensor
// cores as in the exact kernel; d_cf keeps its fixed order. Bound as K2:
// 0.501 ms.
//
// K2-W8A8 (mtt_fused_layer_bwd_w8a8_sm90, the kernel's W8A8 mode) replaces
// `_bwd_kernel` with w8a8 (its W8A8 recompute): the plain version is
// `layer_bwd_math(..., w8a8=)`, the general body K2-W8A8 of
// fused_layer_bwd.cu. Its recompute is K1-W8A8's forward up to vg, with
// the same device code in the same order: n1 and h_norm quantized from
// their floats into the operand tile, QKV and FFN-in as s8 wgmma on int8
// chunks (w_qkv^T and w_in^T in int8; FFN-in as two int8 chunks per F
// tile of 128, value rows then gate rows, vg = (acc deq_in) + b_in in
// float: the int32 sums are exact, so vg is K1-W8A8's bit for bit), q and
// k into the int8 copy from their dequantized floats, the scores and the
// rounded softmax of K2-int8 with factor = deq(q, k) scale. The backward
// is K2-int8's: every gradient product in bf16 on the exact bf16 weights
// and the bf16 q, k, v (straight through), P, dO and dS rounded to bf16.
// Inference only: no weight gradients. 13 + 8 F / 128 chunks (29 at F =
// 256, of which 5 int8), the shared memory of K2-int8 (218,880 B). Bound
// at the served shape: 0.417 ms (the recompute's int8 products at 1,979
// TOPS, the rest at 989 TFLOP/s).

#include "layer_sm90.cuh"

namespace mtt {
namespace sm90 {
namespace {

constexpr int LV = 2 * D + 8;  // the d_vg tile: 128 value | 128 gate columns
constexpr int LR = D + 8;      // d_res (float)

constexpr int kQkvBytes = kRows * LQ * 2;
constexpr int kOpBytes = kRows * LA * 2;
constexpr int kResBytes = kRows * LR * 4;
constexpr int kVgBytes = kRows * LV * 2;
constexpr int kRingBytes = kStages * kChunkElems * 2;
constexpr int kStatFloats = 3 * kRows + 3 * H * kRows + H * 4 * kRows + 4 * kRows;
constexpr int kOffA = kQkvBytes;
constexpr int kOffRes = kOffA + kOpBytes;
constexpr int kOffVg = kOffRes + kResBytes;
constexpr int kOffRing = kOffVg + kVgBytes;
constexpr int kOffStats = kOffRing + kRingBytes;
constexpr int kSmemBytes = kOffStats + kStatFloats * 4;
// K2-int8: the int8 copy of q and k, after the rest
constexpr int kSmemBytesI8 = kSmemBytes + kRows * LQ8;
static_assert(kSmemBytesI8 <= 232448, "one block per SM");

struct Args {
    const bf16* edges;      // (A, M, D)
    const bf16* center;     // (A, D)
    const float* cf;        // (A, M)
    const bf16* norm_attn;  // (D,)
    const bf16* b_qkv;      // (3D,)
    const bf16* b_out;      // (D,)
    const bf16* norm_mlp;   // (D,)
    const bf16* b_in;       // (2F,)
    const bf16* g_edge;     // (A, M, D)
    const bf16* g_center;   // (A, D)
    const float* i8_scales;  // K2-int8: (A, 2) s_q, s_k
    bf16* d_edges;          // (A, M, D)
    bf16* d_center;         // (A, D)
    float* d_cf;            // (A, M)
    int M, F;
    float scale, eps;
};

// The atom's weight chunks in the order the products consume them, each as
// (N, K) row-major: QKV (w_qkv^T, 3 panels x 2), out-projection (w_out^T,
// 2), per F tile of 128 columns j0: value and gate of FFN-in (w_in^T rows
// j0 and F + j0, 2 + 2), d_ffn_h (w_ffn_out rows j0, 2), d_h (w_in columns
// j0, j0 + 64, F + j0, F + j0 + 64, 4); d_attn (w_out, 2); d_n1 (w_qkv, 6).
struct Chunks {
    const bf16 *w_qkv_t, *w_out_t, *w_in_t, *w_ffn_out, *w_in, *w_out, *w_qkv;
    int F;

    __device__ const bf16* operator()(int c, int& ld) const {
        ld = D;
        if (c < 6) return w_qkv_t + (size_t)(c >> 1) * kChunkN * D + (c & 1) * kChunkK;
        c -= 6;
        if (c < 2) return w_out_t + c * kChunkK;
        c -= 2;
        if (c < 10 * (F / kChunkN)) {
            const int j0 = c / 10 * kChunkN, r = c % 10;
            if (r < 2) return w_in_t + (size_t)j0 * D + r * kChunkK;
            if (r < 4) return w_in_t + (size_t)(F + j0) * D + (r - 2) * kChunkK;
            if (r < 6) return w_ffn_out + (size_t)j0 * D + (r - 4) * kChunkK;
            ld = 2 * F;
            return w_in + (r < 8 ? j0 : F + j0) + (r & 1) * kChunkK;
        }
        c -= 10 * (F / kChunkN);
        if (c < 2) return w_out + c * kChunkK;
        ld = 3 * D;
        return w_qkv + (c - 2) * kChunkK;
    }
};

__host__ __device__ constexpr int chunk_count(int F) { return 16 + 10 * (F / kChunkN); }

// K2-W8A8's chunks: QKV (w_qkv^T int8, 3 panels of 128 k), out-projection
// (w_out^T, 2), per F tile of 128 columns j0: value and gate of FFN-in (the
// int8 w_in^T rows j0 and F + j0, 1 + 1), d_ffn_h (w_ffn_out rows j0, 2), d_h
// (w_in columns j0, j0 + 64, F + j0, F + j0 + 64, 4); d_attn (w_out, 2);
// d_n1 (w_qkv, 6). The backward's chunks are the exact kernel's, bf16. The
// mode's static scales travel here, beside its int8 weights: a LayerI8 in
// Args (its members have default initializers) took registers from the
// exact and int8 modes and slowed them by 2-3 % on the H100.
struct ChunksW8 {
    const int8_t *w_qkv_t, *w_in_t;
    const bf16 *w_out_t, *w_ffn_out, *w_in, *w_out, *w_qkv;
    int F;
    LayerI8 s8;

    __device__ const bf16* operator()(int c, int& ld) const {
        if (c < 3) return chunk8(w_qkv_t + (size_t)c * kChunkN * D, D, ld);
        c -= 3;
        ld = D;
        if (c < 2) return w_out_t + c * kChunkK;
        c -= 2;
        if (c < 8 * (F / kChunkN)) {
            const int j0 = c / 8 * kChunkN, r = c % 8;
            if (r < 2) return chunk8(w_in_t + (size_t)(r * F + j0) * D, D, ld);
            if (r < 4) return w_ffn_out + (size_t)j0 * D + (r - 2) * kChunkK;
            ld = 2 * F;
            return w_in + (r < 6 ? j0 : F + j0) + (r & 1) * kChunkK;
        }
        c -= 8 * (F / kChunkN);
        if (c < 2) return w_out + c * kChunkK;
        ld = 3 * D;
        return w_qkv + (c - 2) * kChunkK;
    }
};

__host__ __device__ constexpr int chunk_count_w8(int F) { return 13 + 8 * (F / kChunkN); }

// MODE kInt8: K2-int8, the scores recomputed from the int8 products and
// the rounded softmax weights P = rnd(cf e) / z from them and the stored
// (max, 1 / z); the rest as the exact kernel (straight through: dS times
// the bf16 q and k). kW8A8: K2-W8A8, the same on K1-W8A8's recompute.
template <int MODE, typename Ch>
__global__ void __launch_bounds__(kThreads, 1)
    k2_sm90_kernel(Args p, Ch chunks) {
    constexpr bool I8 = MODE != kExact;  // the int8 scores and the rounded softmax
    constexpr bool W8 = MODE == kW8A8;
    extern __shared__ __align__(1024) unsigned char smem[];
    bf16* QKV = reinterpret_cast<bf16*>(smem);               // q|k|v, then q|dk|dv
    bf16* OP = reinterpret_cast<bf16*>(smem + kOffA);        // n1, attn, h_norm, d_attn_out, dq
    int8_t* OP8 = reinterpret_cast<int8_t*>(OP);             // W8A8: n1 and h_norm in int8
    bf16* RES = reinterpret_cast<bf16*>(smem + kOffRes);     // res
    bf16* GEO = RES + kRows * LA;                            // g_eo
    float* DRES = reinterpret_cast<float*>(smem + kOffRes);  // d_res (over res and g_eo)
    bf16* DVG = reinterpret_cast<bf16*>(smem + kOffVg);      // the d_vg tile
    bf16* DO = DVG;                                          // d_attn, rows of LA
    float* CF = reinterpret_cast<float*>(smem + kOffStats);
    float* RS1 = CF + kRows;
    float* RS2 = RS1 + kRows;
    float* SMAX = RS2 + kRows;       // (H, 64): each row's score max
    float* SZ = SMAX + H * kRows;    // sum_k cf_k exp(s - max) (I8: 1 / sum_k ecf)
    float* SDEL = SZ + H * kRows;    // delta = sum_k P dP
    float* DCFP = SDEL + H * kRows;  // (H, 4 query tiles, 64): column sums of T
    float* RED = DCFP + H * 4 * kRows;

    const int M = p.M, F = p.F;
    const long long a = blockIdx.x;
    const bf16* e = p.edges + a * M * D;
    const bf16* c_in = p.center + a * D;
    const bf16* ge = p.g_edge + a * M * D;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int QT = M / 16;
    const float scale = p.scale;
    int8_t* Q8 = reinterpret_cast<int8_t*>(smem + kSmemBytes);  // K2-int8, K2-W8A8: q and k in int8
    ScoresI8 i8;
    if constexpr (MODE == kInt8) i8 = scores_i8(p.i8_scales + 2 * a, scale);
    if constexpr (W8) i8.factor = chunks.s8.deq_scores;

    WeightRing<Ch> ring{reinterpret_cast<bf16*>(smem + kOffRing), chunks,
                        W8 ? chunk_count_w8(F) : chunk_count(F)};
    ring.start();
    int c = 0;
    auto token = [&](int m) { return m == M - 1 ? c_in : e + (size_t)m * D; };

    // ---- recompute: r1, n1 = rnd(x1 r1 w) (W8A8: quantized) -------------
    if constexpr (W8)
        rms_rows_s8(token, p.norm_attn, RS1, OP8, M, p.eps, chunks.s8.inv_normed, [](int) {});
    else
        rms_rows(token, p.norm_attn, RS1, OP, M, p.eps, [](int) {});
    for (int m = threadIdx.x; m < M; m += kThreads) CF[m] = p.cf[a * M + m];

    auto op_cols = [&](int r, int& ld) { ld = LA; return (const bf16*)OP + r * kChunkK; };
    auto op8 = [&](int, int& ld) { ld = LA8; return (const int8_t*)OP8; };

    // q|k|v = rnd(n1 w_qkv + b) (W8A8: of the int8 product; q and k into Q8)
    if constexpr (W8)
        qkv_panels_s8(ring, c, OP8, QKV, Q8, p.b_qkv, chunks.s8);
    else
        qkv_panels(ring, c, OP, QKV, p.b_qkv);
    __syncthreads();

    // ---- recompute: attention, one warp per (head, 16-row query tile) ----
    if constexpr (MODE == kInt8) {
        quantize_qk(QKV, Q8, M, i8);
        __syncthreads();
    }
    attention_fwd<I8>(QKV, OP, CF, M, scale, [&](int h, int row, const float (&mx)[2], const float (&z)[2]) {
        SMAX[h * kRows + row] = mx[0];
        SMAX[h * kRows + row + 8] = mx[1];
        SZ[h * kRows + row] = I8 ? 1.f / z[0] : z[0];
        SZ[h * kRows + row + 8] = I8 ? 1.f / z[1] : z[1];
    }, Q8, i8.factor);
    __syncthreads();

    // res = rnd(x1 + rnd(attn w_out + b))
    out_proj_res(ring, c, OP, RES, token, p.b_out, M, [](int, int, float, float) {});
    __syncthreads();

    // r2, h_norm = rnd(res r2 w) (W8A8: quantized); g_eo = rnd(g_edge), row M-1 zero
    auto res_row = [&](int m) { return (const bf16*)RES + m * LA; };
    auto g_eo = [&](int m) {
        const float2 g0 = m == M - 1 ? make_float2(0.f, 0.f) : ld2(ge + (size_t)m * D + 4 * lane);
        const float2 g1 = m == M - 1 ? make_float2(0.f, 0.f) : ld2(ge + (size_t)m * D + 4 * lane + 2);
        store2(GEO + m * LA + 4 * lane, g0.x, g0.y);
        store2(GEO + m * LA + 4 * lane + 2, g1.x, g1.y);
    };
    if constexpr (W8)
        rms_rows_s8(res_row, p.norm_mlp, RS2, OP8, M, p.eps, chunks.s8.inv_hnorm, g_eo);
    else
        rms_rows(res_row, p.norm_mlp, RS2, OP, M, p.eps, g_eo);

    // ---- SwiGLU backward over F tiles of 128 columns -> d_h (registers) --
    float dh[4][4];
    zero(dh);
    for (int j0 = 0; j0 < F; j0 += kChunkN) {
        float av[4][4], ag[4][4], ad[4][4];
        zero(av);
        zero(ag);
        zero(ad);
        if constexpr (W8) {
            // vg = (h_norm w_in deq_in) + b_in in float, from the int8 products
            int v8[4][4], g8[4][4];
            zero(v8);
            zero(g8);
            panel_mm_s8<1>(ring, c, op8, v8);
            panel_mm_s8<1>(ring, c, op8, g8);
            panel_each([&](int j, int i, int m, int n) {
                av[j][i] = dequant(v8[j][i], chunks.s8.deq_in, to_f(p.b_in[j0 + n]));
                ag[j][i] = dequant(g8[j][i], chunks.s8.deq_in, to_f(p.b_in[F + j0 + n]));
            });
        } else {
            panel_mm<2>(ring, c, op_cols, av);
            panel_mm<2>(ring, c, op_cols, ag);
        }
        panel_mm<2>(ring, c, [&](int r, int& ld) { ld = LA; return (const bf16*)GEO + r * kChunkK; }, ad);
        // d_vg = rnd(d_ffn_h s, d_ffn_h v s (1 - s)), v and s from vg = h_norm w_in + b
        panel_pairs([&](int j, int h, int m, int n) {
            const float2 bv = ld2(p.b_in + j0 + n), bg = ld2(p.b_in + F + j0 + n);
            float dv[2], dg[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int i = 2 * h + u;
                const float v = W8 ? av[j][i] : av[j][i] + (u ? bv.y : bv.x);
                const float s = sigmoidf_(W8 ? ag[j][i] : ag[j][i] + (u ? bg.y : bg.x));
                const float d = ad[j][i];
                dv[u] = d * s;
                dg[u] = d * v * s * (1.f - s);
            }
            store2(DVG + m * LV + n, dv[0], dv[1]);
            store2(DVG + m * LV + kChunkN + n, dg[0], dg[1]);
        });
        panel_mm<4>(ring, c, [&](int r, int& ld) { ld = LV; return (const bf16*)DVG + r * kChunkK; }, dh);
    }

    // ---- norm_mlp backward: d_res = g_eo + gs2 - x2 r2^2 sum(gs2 x2) / D --
    {
        float s2[2];
        panel_row_sums(RED, [&](int j, int i, int m, int n) {
            return dh[j][i] * (RS2[m] * to_f(p.norm_mlp[n])) * to_f(RES[m * LA + n]);
        }, s2);
        panel_each([&](int j, int i, int m, int n) {
            const float r2 = RS2[m], x2 = to_f(RES[m * LA + n]);
            const float gs = dh[j][i] * (r2 * to_f(p.norm_mlp[n]));
            dh[j][i] = to_f(GEO[m * LA + n]) + gs - x2 * (r2 * r2 * s2[i >> 1] / D);
        });
        __syncthreads();  // res and g_eo are read; d_res takes their place
        panel_each([&](int j, int i, int m, int n) { DRES[m * LR + n] = dh[j][i]; });
        // d_attn_out = rnd(d_res + g_center at row M-1)
        panel_pairs([&](int j, int h, int m, int n) {
            float2 gc = make_float2(0.f, 0.f);
            if (m == M - 1) gc = ld2(p.g_center + a * D + n);
            store2(OP + m * LA + n, dh[j][2 * h] + gc.x, dh[j][2 * h + 1] + gc.y);
        });
    }

    // d_attn = rnd(d_attn_out w_out^T)
    {
        float acc[4][4];
        zero(acc);
        panel_mm<2>(ring, c, op_cols, acc);
        panel_pairs([&](int j, int h, int m, int n) {
            store2(DO + m * LA + n, acc[j][2 * h], acc[j][2 * h + 1]);
        });
    }
    __syncthreads();

    // ---- attention backward, pass 1: one warp per (head, query tile) -----
    // dP = dO v^T, delta = sum_k P dP, T = E (dP - delta), dS = cf T, dq =
    // rnd(scale dS k); the column sums of T go to DCFP. E = e / z, and P =
    // cf E (I8: rnd(cf e) / z, the forward's AV weights; both as products
    // with the stored 1 / z).
    for (int task = warp; task < H * QT; task += kThreads / 32) {
        const int h = task / QT, qt = task % QT, q0 = 16 * qt;
        uint32_t oa[4];
        load_a(oa, DO, LA, q0, h * HD);
        float s[8][4], dp[8][4];
        if constexpr (I8) {
            head_scores_i8(s, Q8, h, q0, M, i8.factor);
        } else {
            uint32_t qa[4];
            load_a(qa, QKV, LQ, q0, h * HD);
            head_scores(s, qa, QKV + D + h * HD, M);
        }
        head_scores(dp, oa, QKV + 2 * D + h * HD, M);
        const float mx[2] = {SMAX[h * kRows + q0 + g], SMAX[h * kRows + q0 + g + 8]};
        const float z[2] = {SZ[h * kRows + q0 + g], SZ[h * kRows + q0 + g + 8]};  // I8: 1 / z
        float delta[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (8 * j < M)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float cf = CF[8 * j + 2 * t + (i & 1)];
                    if constexpr (I8) {
                        const float e = expf(s[j][i] - mx[i >> 1]);
                        s[j][i] = e * z[i >> 1];  // E
                        delta[i >> 1] = fmaf(rnd<bf16>(cf * e) * z[i >> 1], dp[j][i], delta[i >> 1]);
                    } else {
                        s[j][i] = expf(s[j][i] * scale - mx[i >> 1]) / z[i >> 1];  // E
                        delta[i >> 1] = fmaf(cf * s[j][i], dp[j][i], delta[i >> 1]);
                    }
                }
        delta[0] = quad_sum(delta[0]);
        delta[1] = quad_sum(delta[1]);
        if (t == 0) {
            SDEL[h * kRows + q0 + g] = delta[0];
            SDEL[h * kRows + q0 + g + 8] = delta[1];
        }
        float dq[2][4] = {};
#pragma unroll
        for (int kp = 0; kp < 4; ++kp) {
            if (16 * kp < M) {
                float d0[4], d1[4];
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int j = 2 * kp + u;
                    float col[2];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float tt = s[j][i] * (dp[j][i] - delta[i >> 1]);
                        (u ? d1 : d0)[i] = CF[8 * j + 2 * t + (i & 1)] * tt;
                        if (i < 2) col[i] = tt;
                        else col[i - 2] += tt;
                    }
#pragma unroll
                    for (int x = 0; x < 2; ++x) {
                        col[x] += __shfl_xor_sync(0xffffffffu, col[x], 4);
                        col[x] += __shfl_xor_sync(0xffffffffu, col[x], 8);
                        col[x] += __shfl_xor_sync(0xffffffffu, col[x], 16);
                    }
                    if (g == 0) {
                        float* dst = DCFP + (h * 4 + qt) * kRows + 8 * j + 2 * t;
                        dst[0] = col[0];
                        dst[1] = col[1];
                    }
                }
                uint32_t da[4], b[4];
                acc_to_a(da, d0, d1);
                load_b_kn(b, QKV + D + h * HD, LQ, 0, 16 * kp);
                mma_pair(dq[0], dq[1], da, b);
            }
        }
        // dq overwrites d_attn_out (read by the d_attn product already)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            bf16* y = OP + (q0 + g) * LA + h * HD + 8 * nt + 2 * t;
            store2(y, dq[nt][0] * scale, dq[nt][1] * scale);
            store2(y + 8 * LA, dq[nt][2] * scale, dq[nt][3] * scale);
        }
    }
    __syncthreads();

    // ---- pass 2: one warp per (head, key tile), over the query tiles ------
    // dk = rnd(scale dS^T q), dv = rnd(P^T dO), over this tile's k and v
    for (int task = warp; task < H * QT; task += kThreads / 32) {
        const int h = task / QT, k0 = 16 * (task % QT);
        uint32_t ka[4], va[4], ka8[2];
        if constexpr (I8)
            load_a_s8(ka8, Q8, k0, D + h * HD);
        else
            load_a(ka, QKV, LQ, k0, D + h * HD);
        load_a(va, QKV, LQ, k0, 2 * D + h * HD);
        const float cfr[2] = {CF[k0 + g], CF[k0 + g + 8]};
        float dk[2][4] = {}, dv[2][4] = {};
        for (int q0 = 0; q0 < M; q0 += 16) {
            uint32_t b[4];
            float sT[2][4] = {}, dpT[2][4] = {};
            if constexpr (I8) {
                // the forward's scores transposed: the same int32 sums
                scores_s8_tile(sT[0], ka8, Q8 + h * HD, q0, i8.factor);
                scores_s8_tile(sT[1], ka8, Q8 + h * HD, q0 + 8, i8.factor);
            } else {
                load_b_nk(b, QKV + h * HD, LQ, q0, 0);
                mma_pair(sT[0], sT[1], ka, b);
            }
            load_b_nk(b, DO + h * HD, LA, q0, 0);
            mma_pair(dpT[0], dpT[1], va, b);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int q = h * kRows + q0 + 8 * nt + 2 * t + (i & 1);
                    const float cf = cfr[i >> 1];
                    float E;
                    if constexpr (I8) {
                        const float e = expf(sT[nt][i] - SMAX[q]);
                        E = e * SZ[q];
                        sT[nt][i] = rnd<bf16>(cf * e) * SZ[q];  // P^T
                    } else {
                        E = expf(sT[nt][i] * scale - SMAX[q]) / SZ[q];
                        sT[nt][i] = cf * E;  // P^T
                    }
                    dpT[nt][i] = cf * (E * (dpT[nt][i] - SDEL[q]));  // dS^T
                }
            uint32_t pa[4], sa[4];
            acc_to_a(pa, sT[0], sT[1]);
            acc_to_a(sa, dpT[0], dpT[1]);
            load_b_kn(b, DO + h * HD, LA, 0, q0);
            mma_pair(dv[0], dv[1], pa, b);
            load_b_kn(b, QKV + h * HD, LQ, 0, q0);
            mma_pair(dk[0], dk[1], sa, b);
        }
        // only this warp reads these rows of k and v in pass 2
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            bf16* yk = QKV + (k0 + g) * LQ + D + h * HD + 8 * nt + 2 * t;
            store2(yk, dk[nt][0] * scale, dk[nt][1] * scale);
            store2(yk + 8 * LQ, dk[nt][2] * scale, dk[nt][3] * scale);
            bf16* yv = yk + D;
            store2(yv, dv[nt][0], dv[nt][1]);
            store2(yv + 8 * LQ, dv[nt][2], dv[nt][3]);
        }
    }
    __syncthreads();

    // d_cf[k] = sum over heads and query tiles, in a fixed order
    for (int k = threadIdx.x; k < M; k += kThreads) {
        float s = 0.f;
        for (int h = 0; h < H; ++h)
            for (int qt = 0; qt < QT; ++qt) s += DCFP[(h * 4 + qt) * kRows + k];
        p.d_cf[a * M + k] = s;
    }

    // ---- QKV + norm_attn backward: d_n1 = [dq|dk|dv] w_qkv^T -------------
    float dn[4][4];
    zero(dn);
    panel_mm<6>(ring, c, [&](int r, int& ld) {
        if (r < 2) {
            ld = LA;
            return (const bf16*)OP + r * kChunkK;
        }
        ld = LQ;
        return (const bf16*)QKV + D + (r - 2) * kChunkK;
    }, dn);
    float s1[2];
    panel_row_sums(RED, [&](int j, int i, int m, int n) {
        if (m >= M) return 0.f;
        return dn[j][i] * (RS1[m] * to_f(p.norm_attn[n])) * to_f(token(m)[n]);
    }, s1);
    bf16* de = p.d_edges + a * M * D;
    panel_pairs([&](int j, int h, int m, int n) {
        if (m >= M) return;
        const float r1 = RS1[m], c1 = r1 * r1 * s1[h] / D;
        const float2 x = ld2(token(m) + n), w = ld2(p.norm_attn + n);
        const float t0 = DRES[m * LR + n] + dn[j][2 * h] * (r1 * w.x) - x.x * c1;
        const float t1 = DRES[m * LR + n + 1] + dn[j][2 * h + 1] * (r1 * w.y) - x.y * c1;
        if (m == M - 1) {
            store2(p.d_center + a * D + n, t0, t1);
            store2(de + (size_t)m * D + n, 0.f, 0.f);
        } else {
            store2(de + (size_t)m * D + n, t0, t1);
        }
    });
}

}  // namespace
}  // namespace sm90
}  // namespace mtt

// Whether the Hopper K2 takes a shape: D = 128, heads of 16, 16 <= M <= 64
// with M % 16 == 0, F a multiple of 128 (the wrapper checks the variant:
// bfloat16, no weight gradients; exact, int8 scores or W8A8). Every mode
// takes these shapes.
extern "C" int mtt_fused_layer_bwd_sm90_ok(int M, int D, int H, int F) {
    return D == mtt::sm90::D && H == mtt::sm90::H && M >= 16 && M <= mtt::sm90::kRows && M % 16 == 0 &&
           F >= mtt::sm90::kChunkN && F % mtt::sm90::kChunkN == 0;
}

// Its shared memory per block (one atom), 0 where it does not take the shape.
extern "C" size_t mtt_fused_layer_bwd_sm90_smem(int M, int D, int H, int F) {
    return mtt_fused_layer_bwd_sm90_ok(M, D, H, F) ? (size_t)mtt::sm90::kSmemBytes : 0;
}

// K2-int8's blocks hold the atom's int8 q and k besides.
extern "C" size_t mtt_fused_layer_bwd_int8_sm90_smem(int M, int D, int H, int F) {
    return mtt_fused_layer_bwd_sm90_ok(M, D, H, F) ? (size_t)mtt::sm90::kSmemBytesI8 : 0;
}

// K2-W8A8's too (its int8 n1 and h_norm reuse the operand tile's room).
extern "C" size_t mtt_fused_layer_bwd_w8a8_sm90_smem(int M, int D, int H, int F) {
    return mtt_fused_layer_bwd_sm90_ok(M, D, H, F) ? (size_t)mtt::sm90::kSmemBytesI8 : 0;
}

// The launch of a mode, with its chunks and its Args (but for the shape).
template <int MODE, typename Ch>
static int launch_k2(mtt::sm90::Args args, Ch chunks, long long A, int M, int D, int H, int F, void* stream) {
    if (!mtt_fused_layer_bwd_sm90_ok(M, D, H, F)) return (int)cudaErrorInvalidValue;
    if (A == 0) return 0;
    args.M = M;
    args.F = F;
    const int bytes = MODE == mtt::sm90::kExact ? mtt::sm90::kSmemBytes : mtt::sm90::kSmemBytesI8;
    cudaError_t err = cudaFuncSetAttribute(mtt::sm90::k2_sm90_kernel<MODE, Ch>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    mtt::sm90::k2_sm90_kernel<MODE, Ch><<<(unsigned)A, mtt::sm90::kThreads, bytes, (cudaStream_t)stream>>>(
        args, chunks);
    return (int)cudaGetLastError();
}

// The exact and the int8-score modes: the same weights, the same chunks.
template <int MODE>
static int launch_k2_bf16(const void* edges, const void* center, const float* cf, const void* norm_attn,
                          const void* w_qkv, const void* b_qkv, const void* w_out, const void* b_out,
                          const void* norm_mlp, const void* w_in, const void* b_in, const void* w_ffn_out,
                          const void* w_qkv_t, const void* w_out_t, const void* w_in_t,
                          const float* i8_scales, const void* g_edge, const void* g_center, void* d_edges,
                          void* d_center, float* d_cf, long long A, int M, int D, int H, int F, float scale,
                          float eps, void* stream) {
    using mtt::sm90::bf16;
    const mtt::sm90::Args args{(const bf16*)edges, (const bf16*)center, cf, (const bf16*)norm_attn,
                               (const bf16*)b_qkv, (const bf16*)b_out, (const bf16*)norm_mlp,
                               (const bf16*)b_in, (const bf16*)g_edge, (const bf16*)g_center, i8_scales,
                               (bf16*)d_edges, (bf16*)d_center, d_cf, M, F, scale, eps};
    const mtt::sm90::Chunks chunks{(const bf16*)w_qkv_t, (const bf16*)w_out_t, (const bf16*)w_in_t,
                                   (const bf16*)w_ffn_out, (const bf16*)w_in, (const bf16*)w_out,
                                   (const bf16*)w_qkv, F};
    return launch_k2<MODE>(args, chunks, A, M, D, H, F, stream);
}

// bfloat16 tensors; the weights in the (in, out) layout and the transposed
// copies of w_qkv, w_out and w_in. One block per atom on `stream`. Returns
// the CUDA error code (0 = ok; cudaErrorInvalidValue for a shape it does
// not take).
extern "C" int mtt_fused_layer_bwd_sm90(
    const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* norm_mlp,
    const void* w_in, const void* b_in, const void* w_ffn_out,
    const void* w_qkv_t, const void* w_out_t, const void* w_in_t,
    const void* g_edge, const void* g_center,
    void* d_edges, void* d_center, float* d_cf,
    long long A, int M, int D, int H, int F, float scale, float eps, void* stream) {
    return launch_k2_bf16<mtt::sm90::kExact>(edges, center, cf, norm_attn, w_qkv, b_qkv, w_out, b_out,
                                             norm_mlp, w_in, b_in, w_ffn_out, w_qkv_t, w_out_t, w_in_t,
                                             nullptr, g_edge, g_center, d_edges, d_center, d_cf, A, M, D, H,
                                             F, scale, eps, stream);
}

// K2-int8: the Hopper K2's arguments and the (A, 2) float32 scales K1-int8
// took, after the transposed weights.
extern "C" int mtt_fused_layer_bwd_int8_sm90(
    const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* norm_mlp,
    const void* w_in, const void* b_in, const void* w_ffn_out,
    const void* w_qkv_t, const void* w_out_t, const void* w_in_t, const float* i8_scales,
    const void* g_edge, const void* g_center,
    void* d_edges, void* d_center, float* d_cf,
    long long A, int M, int D, int H, int F, float scale, float eps, void* stream) {
    return launch_k2_bf16<mtt::sm90::kInt8>(edges, center, cf, norm_attn, w_qkv, b_qkv, w_out, b_out,
                                            norm_mlp, w_in, b_in, w_ffn_out, w_qkv_t, w_out_t, w_in_t,
                                            i8_scales, g_edge, g_center, d_edges, d_center, d_cf, A, M, D, H,
                                            F, scale, eps, stream);
}

// K2-W8A8: bfloat16 tensors, the weights the backward's products read in
// the (in, out) layout (w_qkv, w_out, w_in, w_ffn_out) and w_out^T for the
// recompute's out-projection; the int8 w_qkv^T (3D, D) and w_in^T (2F, D:
// value rows, then gate rows); then the 11 static scales of the general
// entry (a host array: common.cuh layer_i8's order). `scale` is the
// attention scale of dq and dk (the scores' factor holds it already).
extern "C" int mtt_fused_layer_bwd_w8a8_sm90(
    const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* norm_mlp,
    const void* w_in, const void* b_in, const void* w_ffn_out, const void* w_out_t,
    const void* w_qkv8_t, const void* w_in8_t, const float* scales,
    const void* g_edge, const void* g_center,
    void* d_edges, void* d_center, float* d_cf,
    long long A, int M, int D, int H, int F, float scale, float eps, void* stream) {
    using mtt::sm90::bf16;
    const mtt::sm90::Args args{(const bf16*)edges, (const bf16*)center, cf, (const bf16*)norm_attn,
                               (const bf16*)b_qkv, (const bf16*)b_out, (const bf16*)norm_mlp,
                               (const bf16*)b_in, (const bf16*)g_edge, (const bf16*)g_center, nullptr,
                               (bf16*)d_edges, (bf16*)d_center, d_cf, M, F, scale, eps};
    const mtt::sm90::ChunksW8 chunks{(const int8_t*)w_qkv8_t, (const int8_t*)w_in8_t, (const bf16*)w_out_t,
                                     (const bf16*)w_ffn_out, (const bf16*)w_in, (const bf16*)w_out,
                                     (const bf16*)w_qkv, F,
                                     mtt::layer_i8(nullptr, nullptr, nullptr, scales)};
    return launch_k2<mtt::sm90::kW8A8>(args, chunks, A, M, D, H, F, stream);
}
