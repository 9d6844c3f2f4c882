// K2 on Hopper in float32: the input-gradient backward of the fused PET
// transformer layer, redesigned for the H100 at the served shapes, and, in
// its spill mode, the first pass of the two-pass K2-dW in float32.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/fused_layer.py
// `_bwd_kernel` (pallas_call in `_make_bwd_op`, body `_layer_bwd_math`) in
// float32: the same function as K2's general body (layer_bwd.cuh) and its
// plain version `layer_bwd_math`, that is (d_edges, d_center, d_cf) with
// d_edges[:, M-1] == 0. It takes D = 128, heads of 16 (H = 8), 16 <= M <= 64
// with M % 16 == 0 and F % 128 == 0 (mtt_fused_layer_bwd_f32_sm90_ok); the
// wrapper sends every other shape, and W8A8 and the int8 scores (bf16
// only), to the general body. The spill mode writes what layer_bwd.cuh's
// SP mode writes (DwSpill's seven arrays, DwLayout(D, F, true)'s vector row
// per atom), so the second pass (layer_dw_sm90.cuh) is unchanged, and its
// input gradients equal this kernel's bit for bit (one body, the spill
// adds stores only). Its recompute of the forward up to h_norm is
// layer_f32_sm90.cuh's phases, which the Hopper float32 K1
// (fused_layer_fwd_f32_sm90.cu) runs as its first half: the forward that
// gives the f32 energy and the recompute its gradient starts from are the
// same bits.
//
// What bounds it on the H100: operations. At the served shape (A = 11,392,
// M = 64, F = 256) the dense products (16 D^2 + 10 D F a row: the forward
// recomputed but for FFN-out, which no gradient needs, then the input
// gradients) and the attention's are 502 GFLOP: 7.49 ms on the FFMA pipes
// at 67 TFLOP/s, 3.04 ms as three TF32 tensor-core products each at 495
// TFLOP/s. The general body took 44 ms (5.9 x the FFMA bound); the design
// answers its four causes:
// - FFMA at one output column per thread, bound by load issue (a broadcast
//   shared load per four FMAs, each weight loaded by every 16 rows): every
//   dense and attention product runs on mma.sync m16n8k8 in TF32 as three
//   products, a_hi b_hi + a_hi b_lo + a_lo b_hi with x = hi + lo, hi =
//   tf32(x), lo = tf32(x - hi) (rounded to nearest), summed in float32: the
//   dropped a_lo b_lo is about 2^-22 of each product, so the sums keep
//   float32's accuracy where plain TF32 keeps three digits. The split is
//   made in registers from the float operands as they are loaded, so
//   nothing is stored twice.
// - the SwiGLU backward in 16-row chunks, re-reading w_in, w_ffn_out^T and
//   w_in^T four times per atom: every weight reaches the tensor cores
//   through a ring of three staged chunks (128 rows x 16 k, 8 KB, cp.async,
//   swizzled so that the B fragments load without bank conflicts), issued
//   two ahead in one fixed sequence of 64 + 40 F / 128 chunks per atom
//   (each weight read once by the recompute and once by the backward); the
//   SwiGLU walks F in tiles of 128 columns, so each chunk serves all 64
//   rows.
// - the attention backward one head at a time, the whole block joining a
//   barrier between its steps: one warp per (head, 16-row tile), all heads
//   at once, as the bf16 Hopper K2; the row statistics (max, the
//   cutoff-weighted sum, delta) in registers and, between its two passes,
//   in shared memory; d_cf summed over queries per (head, key) in the
//   second pass, then over heads, in a fixed order: no atomics, the same
//   bits in every launch. The softmax weights P and dS enter the products
//   as the k-permuted A fragments of their own accumulators.
// - one atom per SM with no room for a ring: every buffer is float and
//   serves one phase after another. Shared memory per atom (M padded to 64
//   rows): q|k|v, then q|dk|dv (rows of 3D + 4) 99,328 B; the operand tile
//   (n1, attn, h_norm, d_attn_out, dq; rows of D + 4) 33,792 B; res, then
//   g_eo, then the attention backward's statistics 33,792 B; the d_vg tile
//   (value half, then gate half), then d_attn 33,792 B; the ring 24,576 B;
//   cf, r1, r2 and the row-sum scratch 1,792 B: 227,072 B. res and d_res
//   wait in the atom's own d_edges rows (each element written and read
//   back by the same thread) while their buffer serves g_eo and the
//   statistics; vg, d_h and d_n1 stay in registers. 16 warps per block.
//   A window below 64 slots pads to 64 rows, and the warps of the padded
//   row blocks skip their dense products (panel_mm).
// Everything outside the products is float32 at the points where the plain
// version computes it.

#include "k2_f32_sm90.cuh"
#include "layer_f32_sm90.cuh"
#include "layer_sm90.cuh"

namespace mtt {
namespace k2f32 {
namespace {

using namespace lf32;  // the forward phases up to h_norm, 3xTF32, the ring
using lf32::kRows;  // sm90's, not common.cuh's
using lf32::kThreads;

constexpr int kOffOp = kQkvBytes;
constexpr int kOffRes = kOffOp + kTileBytes;
constexpr int kOffVg = kOffRes + kTileBytes;
constexpr int kOffRing = kOffVg + kTileBytes;
constexpr int kOffStats = kOffRing + kStages * kChunk * 4;
constexpr int kSmemBytes = kOffStats + 7 * kRows * 4;  // cf, r1, r2, 4 x 64 row-sum scratch
static_assert(kSmemBytes <= 232448, "one block per SM");
static_assert(4 * H * kRows <= kRows * LT, "the statistics fit the res buffer");

// ---- the weight ring -------------------------------------------------------

// The atom's weight chunks in the order the products consume them, each
// 128 rows (n) x 16 columns (k) of a weight in its (N, K) row-major layout:
// QKV (w_qkv^T, 3 panels x 8), out-projection (w_out^T, 8), per F tile of
// 128 columns j0: value and gate of FFN-in (w_in^T rows j0 and F + j0, 8 +
// 8), d_ffn_h (w_ffn_out rows j0, 8), d_h (w_in columns j0, then F + j0, 8
// + 8); d_attn (w_out, 8); d_n1 (w_qkv, 24).
struct Chunks {
    const float *w_qkv_t, *w_out_t, *w_in_t, *w_ffn_out, *w_in, *w_out, *w_qkv;
    int F;

    __device__ const float* operator()(int c, int& ld) const {
        ld = D;
        if (c < 24) return w_qkv_t + (size_t)(c >> 3) * kCN * D + (c & 7) * kCK;
        c -= 24;
        if (c < 8) return w_out_t + c * kCK;
        c -= 8;
        if (c < 40 * (F / kCN)) {
            const int j0 = c / 40 * kCN, r = c % 40, k = (r & 7) * kCK;
            if (r < 8) return w_in_t + (size_t)j0 * D + k;
            if (r < 16) return w_in_t + (size_t)(F + j0) * D + k;
            if (r < 24) return w_ffn_out + (size_t)j0 * D + k;
            ld = 2 * F;
            return w_in + (r < 32 ? j0 : F + j0) + k;
        }
        c -= 40 * (F / kCN);
        if (c < 8) return w_out + c * kCK;
        ld = 3 * D;
        return w_qkv + (c - 8) * kCK;
    }
};

__host__ __device__ constexpr int chunk_count(int F) { return 64 + 40 * (F / kCN); }

// SP: K2-dW's first pass (the spill mode). p is grid-constant: the spill's
// pointers are read from the parameters where they are written.
template <bool SP>
__global__ void __launch_bounds__(kThreads, 1) k2_f32_sm90_kernel(const __grid_constant__ Args p) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* QKV = reinterpret_cast<float*>(smem);             // q|k|v, then q|dk|dv
    float* OP = reinterpret_cast<float*>(smem + kOffOp);     // n1, attn, h_norm, d_attn_out, dq
    float* RES = reinterpret_cast<float*>(smem + kOffRes);   // res, g_eo, statistics
    float* DVG = reinterpret_cast<float*>(smem + kOffVg);    // d_vg halves, d_attn; column-sum scratch
    float* CF = reinterpret_cast<float*>(smem + kOffStats);
    float* RS1 = CF + kRows;
    float* RS2 = RS1 + kRows;
    float* RED = RS2 + kRows;       // 4 x 64: row-sum scratch
    float* GEO = RES;               // g_eo, rows from M - 1 on zero
    float* SMAX = RES;              // (H, 64): each query row's score max
    float* SZ = SMAX + H * kRows;   // sum_k cf_k exp(s - max)
    float* SDEL = SZ + H * kRows;   // delta = sum_k P dP
    float* DCFH = SDEL + H * kRows; // (H, 64): d_cf per head, summed over queries
    float* DO = DVG;                // d_attn

    const int M = p.M, F = p.F;
    const int js = blockIdx.x;  // the atom's row block in the spill
    const long long a = p.a0 + js;
    const float* e = p.edges + a * M * D;
    const float* c_in = p.center + a * D;
    const float* ge = p.g_edge + a * M * D;
    float* de = p.d_edges + a * M * D;  // also res, then d_res, of this thread's own elements
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int QT = M / 16;
    const float scale = p.scale;
    const DwLayout L(D, F, true);
    auto token = [&](int m) { return m == M - 1 ? c_in : e + (size_t)m * D; };
    auto rows = [&](int k, int m) { return p.sp.at(k, (long long)js * M + m, D, F); };
    auto vec = [&]() { return p.sp.vec + (long long)js * L.total; };
    auto op_cols = [&](int r, int& ld) { ld = LT; return (const float*)OP + r * kCK; };

    Ring<Chunks> ring{reinterpret_cast<float*>(smem + kOffRing),
              Chunks{p.w_qkv_t, p.w_out_t, p.w_in_t, p.w_ffn_out, p.w_in, p.w_out, p.w_qkv, F}, chunk_count(F)};
    ring.start();
    int c = 0;

    // ---- recompute: r1, n1 = x1 r1 w ------------------------------------------
    rms_rows(token, p.norm_attn, RS1, OP, M, p.eps);
    for (int m = threadIdx.x; m < M; m += kThreads) CF[m] = p.cf[a * M + m];
    if constexpr (SP) {
        __syncthreads();
        spill_rows(rows(kDwN1, 0), D, OP, LT, M, D);
    }

    // q|k|v = n1 w_qkv + b
    qkv_panels(ring, c, OP, QKV, p.b_qkv, M);
    __syncthreads();

    // ---- recompute: attention, one warp per (head, 16-row query tile) -------
    // attn = P v with P = cf e / z, e = exp(s - max), z = sum_k cf e
    attention_fwd(QKV, CF, OP, M, scale);
    __syncthreads();
    if constexpr (SP) spill_rows(rows(kDwAttn, 0), D, OP, LT, M, D);

    // res = x1 + (attn w_out + b), to RES and to this thread's d_edges rows
    out_proj(ring, c, OP, p.b_out, M, [&](int m, int n, float o0, float o1) {
        const float2 x = ld2(token(m) + n);
        const float r0 = x.x + o0, r1 = x.y + o1;
        st2(RES + m * LT + n, r0, r1);
        st2(de + (size_t)m * D + n, r0, r1);
    });
    __syncthreads();

    // r2, h_norm = res r2 w; then g_eo takes res's place
    rms_rows([&](int m) { return (const float*)RES + m * LT; }, p.norm_mlp, RS2, OP, M, p.eps);
    __syncthreads();
    // g_eo into res's buffer (rows from M - 1 on zero)
    for (int i = threadIdx.x; i < kRows * D / 4; i += kThreads) {
        const int m = i / (D / 4), k = 4 * (i % (D / 4));
        const float4 v = m < M - 1 ? *reinterpret_cast<const float4*>(ge + (size_t)m * D + k)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(GEO + m * LT + k) = v;
    }
    if constexpr (SP) {
        spill_rows(rows(kDwHnorm, 0), D, OP, LT, M, D);
        __syncthreads();
        vec_colsum(vec() + L.b_ffn_out, GEO, LT, M, D, true);
    }

    // ---- SwiGLU backward over F tiles of 128 columns -> d_h (registers) ----
    float dh[4][4];
    zero(dh);
    auto geo_cols = [&](int r, int& ld) { ld = LT; return (const float*)GEO + r * kCK; };
    auto vg_cols = [&](int r, int& ld) { ld = LT; return (const float*)DVG + r * kCK; };
    for (int j0 = 0; j0 < F; j0 += kCN) {
        float av[4][4], ag[4][4], ad[4][4];
        vg_panels(ring, c, OP, av, ag, M);
        zero(ad);
        panel_mm<8>(ring, c, geo_cols, ad, M);
        // d_vg = (d_ffn_h s, d_ffn_h v s (1 - s)), v and s from vg = h_norm
        // w_in + b: the value half to DVG, the gate half kept in ag
        panel_pairs([&](int j, int h, int m, int n) {
            const float2 bv = ld2(p.b_in + j0 + n), bg = ld2(p.b_in + F + j0 + n);
            float dv[2], fh[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int i = 2 * h + u;
                const float v = av[j][i] + (u ? bv.y : bv.x);
                const float s = sigmoidf_(ag[j][i] + (u ? bg.y : bg.x));
                const float d = ad[j][i];
                dv[u] = d * s;
                ag[j][i] = d * v * s * (1.f - s);
                fh[u] = v * s;
            }
            st2(DVG + m * LT + n, dv[0], dv[1]);
            if constexpr (SP) {
                if (m < M) __stcs(reinterpret_cast<float2*>(rows(kDwFfnH, m) + j0 + n), make_float2(fh[0], fh[1]));
            }
        });
        panel_mm<8>(ring, c, vg_cols, dh, M);
        if constexpr (SP) {
            spill_rows(rows(kDwVg, 0) + j0, 2 * F, DVG, LT, M, kCN);
            vec_colsum(vec() + L.b_in + j0, DVG, LT, M, kCN, true);
        }
        __syncthreads();  // every warp has read the value half
        panel_pairs([&](int j, int h, int m, int n) { st2(DVG + m * LT + n, ag[j][2 * h], ag[j][2 * h + 1]); });
        panel_mm<8>(ring, c, vg_cols, dh, M);
        if constexpr (SP) {
            spill_rows(rows(kDwVg, 0) + F + j0, 2 * F, DVG, LT, M, kCN);
            vec_colsum(vec() + L.b_in + F + j0, DVG, LT, M, kCN, true);
        }
    }

    // ---- norm_mlp backward: d_res = g_eo + gs2 - x2 r2^2 sum(gs2 x2) / D ---
    {
        float s2[2];
        panel_row_sums(RED, [&](int j, int i, int m, int n) {
            return m < M ? dh[j][i] * (RS2[m] * p.norm_mlp[n]) * de[(size_t)m * D + n] : 0.f;
        }, s2);
        if constexpr (SP) {
            // norm_mlp: sum over rows of d_h (x2 r2)
            panel_col_sums(DVG, [&](int j, int i, int m, int n) {
                return m < M ? dh[j][i] * (de[(size_t)m * D + n] * RS2[m]) : 0.f;
            }, vec() + L.norm_mlp);
        }
        panel_each([&](int j, int i, int m, int n) {
            if (m >= M) return;
            const float r2 = RS2[m], x2 = de[(size_t)m * D + n];
            const float gs = dh[j][i] * (r2 * p.norm_mlp[n]);
            dh[j][i] = GEO[m * LT + n] + gs - x2 * (r2 * r2 * s2[i >> 1] / D);
        });
        // d_res waits in d_edges; d_attn_out = d_res + g_center at row M-1
        panel_pairs([&](int j, int h, int m, int n) {
            if (m >= M) return;
            st2(de + (size_t)m * D + n, dh[j][2 * h], dh[j][2 * h + 1]);
            float2 gc = make_float2(0.f, 0.f);
            if (m == M - 1) gc = ld2(p.g_center + a * D + n);
            st2(OP + m * LT + n, dh[j][2 * h] + gc.x, dh[j][2 * h + 1] + gc.y);
        });
    }

    // d_attn = d_attn_out w_out^T
    {
        float acc[4][4];
        zero(acc);
        panel_mm<8>(ring, c, op_cols, acc, M);
        panel_pairs([&](int j, int h, int m, int n) { st2(DO + m * LT + n, acc[j][2 * h], acc[j][2 * h + 1]); });
    }
    if constexpr (SP) {
        spill_rows(rows(kDwDao, 0), D, OP, LT, M, D);
        vec_colsum(vec() + L.b_out, OP, LT, M, D, true);
    }
    __syncthreads();

    // ---- attention backward, pass 1: one warp per (head, query tile) -------
    // E = e / z again, dP = dO v^T, delta, T = E (dP - delta), dS = cf T,
    // dq = scale dS k (over d_attn_out: read by the d_attn product already)
    for (int task = warp; task < H * QT; task += kThreads / 32) {
        const int h = task / QT, q0 = 16 * (task % QT);
        float s[8][4], dp[8][4];
        abt16(s, QKV + q0 * LQ + h * HD, LQ, QKV + D + h * HD, LQ, M);
        abt16(dp, DO + q0 * LT + h * HD, LT, QKV + 2 * D + h * HD, LQ, M);
        float mx[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (8 * j < M)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    s[j][i] *= scale;
                    mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
                }
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (8 * j < M)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    s[j][i] = expf(s[j][i] - mx[i >> 1]);
                    z[i >> 1] = fmaf(CF[8 * j + 2 * t + (i & 1)], s[j][i], z[i >> 1]);
                }
        z[0] = quad_sum(z[0]);
        z[1] = quad_sum(z[1]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (8 * j < M)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    s[j][i] /= z[i >> 1];  // E
                    delta[i >> 1] = fmaf(CF[8 * j + 2 * t + (i & 1)] * s[j][i], dp[j][i], delta[i >> 1]);
                }
        delta[0] = quad_sum(delta[0]);
        delta[1] = quad_sum(delta[1]);
        if (t == 0) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int q = h * kRows + q0 + g + 8 * u;
                SMAX[q] = mx[u];
                SZ[q] = z[u];
                SDEL[q] = delta[u];
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (8 * j < M)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    dp[j][i] = CF[8 * j + 2 * t + (i & 1)] * (s[j][i] * (dp[j][i] - delta[i >> 1]));  // dS
        float dq[2][4] = {};
        acc_xy<8>(dq, dp, QKV + D + h * HD, LQ, M / 8);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            float* y = OP + (q0 + g) * LT + h * HD + 8 * nt + 2 * t;
            st2(y, dq[nt][0] * scale, dq[nt][1] * scale);
            st2(y + 8 * LT, dq[nt][2] * scale, dq[nt][3] * scale);
        }
    }
    __syncthreads();

    // ---- pass 2: one warp per (head, key tile), over the query tiles --------
    // dk = scale dS^T q, dv = P^T dO over this tile's k and v; d_cf's sum of
    // T over the queries
    for (int task = warp; task < H * QT; task += kThreads / 32) {
        const int h = task / QT, k0 = 16 * (task % QT);
        uint32_t kh[2][4], kl[2][4], vh[2][4], vl[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
            load_a(kh[ks], kl[ks], QKV + k0 * LQ + D + h * HD + 8 * ks, LQ);
            load_a(vh[ks], vl[ks], QKV + k0 * LQ + 2 * D + h * HD + 8 * ks, LQ);
        }
        const float cfr[2] = {CF[k0 + g], CF[k0 + g + 8]};
        float dk[2][4] = {}, dv[2][4] = {}, dcf[2] = {0.f, 0.f};
        for (int q0 = 0; q0 < M; q0 += 16) {
            float sT[2][4] = {}, dpT[2][4] = {};
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int ks = 0; ks < 2; ++ks) {
                    uint32_t bh[2], bl[2];
                    load_b(bh, bl, QKV + (q0 + 8 * nt) * LQ + h * HD + 8 * ks, LQ);
                    mma3(sT[nt], kh[ks], kl[ks], bh, bl);
                    load_b(bh, bl, DO + (q0 + 8 * nt) * LT + h * HD + 8 * ks, LT);
                    mma3(dpT[nt], vh[ks], vl[ks], bh, bl);
                }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int q = h * kRows + q0 + 8 * nt + 2 * t + (i & 1);
                    const float E = expf(sT[nt][i] * scale - SMAX[q]) / SZ[q];
                    const float tt = E * (dpT[nt][i] - SDEL[q]);
                    dcf[i >> 1] += tt;
                    sT[nt][i] = cfr[i >> 1] * E;    // P^T
                    dpT[nt][i] = cfr[i >> 1] * tt;  // dS^T
                }
            acc_xy<2>(dv, sT, DO + q0 * LT + h * HD, LT, 2);
            acc_xy<2>(dk, dpT, QKV + q0 * LQ + h * HD, LQ, 2);
        }
        dcf[0] = quad_sum(dcf[0]);
        dcf[1] = quad_sum(dcf[1]);
        if (t == 0) {
            DCFH[h * kRows + k0 + g] = dcf[0];
            DCFH[h * kRows + k0 + g + 8] = dcf[1];
        }
        // only this warp reads these rows of k and v in pass 2
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            float* yk = QKV + (k0 + g) * LQ + D + h * HD + 8 * nt + 2 * t;
            st2(yk, dk[nt][0] * scale, dk[nt][1] * scale);
            st2(yk + 8 * LQ, dk[nt][2] * scale, dk[nt][3] * scale);
            float* yv = yk + D;
            st2(yv, dv[nt][0], dv[nt][1]);
            st2(yv + 8 * LQ, dv[nt][2], dv[nt][3]);
        }
    }
    __syncthreads();

    // d_cf[k] = the heads' sums, in head order
    for (int k = threadIdx.x; k < M; k += kThreads) {
        float s = 0.f;
        for (int h = 0; h < H; ++h) s += DCFH[h * kRows + k];
        p.d_cf[a * M + k] = s;
    }
    if constexpr (SP) {
        spill_rows(rows(kDwQkv, 0), 3 * D, OP, LT, M, D);
        spill_rows(rows(kDwQkv, 0) + D, 3 * D, QKV + D, LQ, M, 2 * D);
        vec_colsum(vec() + L.b_qkv, OP, LT, M, D, true);
        vec_colsum(vec() + L.b_qkv + D, QKV + D, LQ, M, 2 * D, true);
    }

    // ---- QKV + norm_attn backward: d_n1 = [dq|dk|dv] w_qkv^T ---------------
    float dn[4][4];
    zero(dn);
    panel_mm<24>(ring, c, [&](int r, int& ld) {
        if (r < 8) {
            ld = LT;
            return (const float*)OP + r * kCK;
        }
        ld = LQ;
        return (const float*)QKV + D + (r - 8) * kCK;
    }, dn, M);
    float s1[2];
    panel_row_sums(RED, [&](int j, int i, int m, int n) {
        return m < M ? dn[j][i] * (RS1[m] * p.norm_attn[n]) * token(m)[n] : 0.f;
    }, s1);
    if constexpr (SP) {
        // norm_attn: sum over rows of d_n1 (x1 r1)
        panel_col_sums(DVG, [&](int j, int i, int m, int n) {
            return m < M ? dn[j][i] * (token(m)[n] * RS1[m]) : 0.f;
        }, vec() + L.norm_attn);
    }
    panel_pairs([&](int j, int h, int m, int n) {
        if (m >= M) return;
        const float r1 = RS1[m], c1 = r1 * r1 * s1[h] / D;
        const float2 x = ld2(token(m) + n), w = ld2(p.norm_attn + n), dr = ld2(de + (size_t)m * D + n);
        const float t0 = dr.x + dn[j][2 * h] * (r1 * w.x) - x.x * c1;
        const float t1 = dr.y + dn[j][2 * h + 1] * (r1 * w.y) - x.y * c1;
        if (m == M - 1) {
            st2(p.d_center + a * D + n, t0, t1);
            st2(de + (size_t)m * D + n, 0.f, 0.f);
        } else {
            st2(de + (size_t)m * D + n, t0, t1);
        }
    });
}

template <bool SP>
int launch_mode(const Args& a, long long atoms, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(k2_f32_sm90_kernel<SP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    k2_f32_sm90_kernel<SP><<<(unsigned)atoms, kThreads, kSmemBytes, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

bool takes(int M, int D_, int H_, int F) { return lf32::takes(M, D_, H_, F); }

size_t smem_bytes() { return (size_t)kSmemBytes; }

int launch(const Args& a, long long atoms, bool spill, cudaStream_t stream) {
    if (!takes(a.M, D, H, a.F)) return (int)cudaErrorInvalidValue;
    if (atoms <= 0) return 0;
    return spill ? launch_mode<true>(a, atoms, stream) : launch_mode<false>(a, atoms, stream);
}

}  // namespace k2f32
}  // namespace mtt

// Whether the Hopper float32 K2 takes a shape: D = 128, heads of 16, 16 <= M
// <= 64 with M % 16 == 0, F a multiple of 128 (the wrapper checks the
// variant: float32, no W8A8, no int8 scores; with weight gradients, the
// two-pass K2-dW runs it as its first pass).
extern "C" int mtt_fused_layer_bwd_f32_sm90_ok(int M, int D, int H, int F) {
    return mtt::k2f32::takes(M, D, H, F) ? 1 : 0;
}

// Its shared memory per block (one atom), 0 where it does not take the shape.
extern "C" size_t mtt_fused_layer_bwd_f32_sm90_smem(int M, int D, int H, int F) {
    return mtt::k2f32::takes(M, D, H, F) ? mtt::k2f32::smem_bytes() : 0;
}

// float32 tensors; the weights in the (in, out) layout and the transposed
// copies of w_qkv, w_out and w_in (w_ffn_out as it is: (F, D) is the (N, K)
// layout of its product). One block per atom on `stream`. Returns the CUDA
// error code (0 = ok; cudaErrorInvalidValue for a shape it does not take).
extern "C" int mtt_fused_layer_bwd_f32_sm90(
    const float* edges, const float* center, const float* cf,
    const float* norm_attn, const float* w_qkv, const float* b_qkv,
    const float* w_out, const float* b_out, const float* norm_mlp,
    const float* w_in, const float* b_in, const float* w_ffn_out,
    const float* w_qkv_t, const float* w_out_t, const float* w_in_t,
    const float* g_edge, const float* g_center,
    float* d_edges, float* d_center, float* d_cf,
    long long A, int M, int D, int H, int F, float scale, float eps, void* stream) {
    if (!mtt::k2f32::takes(M, D, H, F)) return (int)cudaErrorInvalidValue;
    const mtt::k2f32::Args args{edges, center, cf, norm_attn, b_qkv, b_out, norm_mlp, b_in,
                                w_qkv_t, w_out_t, w_in_t, w_ffn_out, w_in, w_out, w_qkv,
                                g_edge, g_center, d_edges, d_center, d_cf, {}, 0, M, F, scale, eps};
    return mtt::k2f32::launch(args, A, false, (cudaStream_t)stream);
}
