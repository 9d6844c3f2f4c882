// The per-atom body of K1 (one fused PET transformer layer, forward),
// shared by K1 (fused_layer_fwd.cu) and the GNN block (gnn_block_fwd.cu,
// and the forward recompute of gnn_block_bwd.cu).
//
// Buffers of the body (floats): X (M x D, the tokens, then the residual),
// N (M x D: normed, attn, h_norm), Q (M x max(3D + 4, F): q|k|v, then
// ffn_h), P (M x (M + 1): one head's scores) and CF (M). layer_fwd_plan
// places them (common.cuh SmemPlan): all in shared memory up to ~181 KB
// (M = 64, D = 128); for larger windows or widths q|k|v moves first to the
// block's workspace slice, then the scores, N and X.
//
// W8 = true is the W8A8 layer (the JAX package's _layer_math with w8a8):
// the QKV, score, FFN-in and FFN-out products run on int8 tensor cores
// with static scales (common.cuh LayerI8), the AV and out-projection
// products stay in T. Where the exact layer rounds to T, the W8A8 layer
// keeps the float the quantizer takes: the two RMSNorm outputs, q and k
// (quantized again for the scores) and ffn_h; v is rounded to T. The
// softmax rounds cf * e to T (cf_softmax_rows_w8). Same buffers.
//
// I8 = true is the dynamic int8 scores (_layer_math with int8, q-side):
// the exact layer, but each head's scores are the int8 product of q and k
// quantized by their block's absmax scales (common.cuh ScoresI8), followed
// by the W8A8 layer's softmax (_qside_tail). Same buffers.

#pragma once

#include "common.cuh"

namespace mtt {

// One layer's weights in the compute dtype, (in, out) layout.
template <typename T>
struct LayerW {
    const T* norm_attn;  // (D,)
    const T* w_qkv;      // (D, 3D)
    const T* b_qkv;      // (3D,)
    const T* w_out;      // (D, D)
    const T* b_out;      // (D,)
    const T* norm_mlp;   // (D,)
    const T* w_in;       // (D, 2F)
    const T* b_in;       // (2F,)
    const T* w_ffn_out;  // (F, D)
    const T* b_ffn_out;  // (D,)
};

enum FwdBuf { kFwdX, kFwdN, kFwdQ, kFwdP, kFwdCF, kFwdBufs };

// The body's buffers placed under `cap` floats of shared memory: the cutoff
// weights and the products' operands X and N first, then the scores, then
// q|k|v.
inline SmemPlan layer_fwd_plan(int M, int D, int F, long long cap = kMaxSharedFloats) {
    const int LQ = qkv_stride(D);
    const long long sizes[kFwdBufs] = {(long long)M * D, (long long)M * D,
                                       (long long)M * (LQ > F ? LQ : F), (long long)M * (M + 1), M};
    const int keep[kFwdBufs] = {kFwdCF, kFwdX, kFwdN, kFwdP, kFwdQ};
    return make_plan(sizes, keep, kFwdBufs, cap);
}

struct FwdBufs {
    float *X, *N, *Q, *P, *CF;
    // SH: the plan keeps every buffer shared (plan_ptr)
    template <bool SH>
    __device__ static FwdBufs make(const SmemPlan& p, float* smem, float* ws) {
        return FwdBufs{plan_ptr<SH>(p, kFwdX, smem, ws), plan_ptr<SH>(p, kFwdN, smem, ws),
                       plan_ptr<SH>(p, kFwdQ, smem, ws), plan_ptr<SH>(p, kFwdP, smem, ws),
                       plan_ptr<SH>(p, kFwdCF, smem, ws)};
    }
};

// One layer on one atom. On entry X holds the tokens with the center token
// in slot M-1, and CF the cutoff weights (cf[M-1] == 1). The attention
// output of slot M-1 goes to center_out (global, T) or center_s (shared,
// float rounded to T), whichever is not null. With edge_out or keep, the
// rest of the layer runs and its edge output (slot M-1 zeroed) goes to
// edge_out (global) and, with keep, back into X; with neither the body
// stops after the out-projection.
template <typename T, bool W8 = false, bool I8 = false>
__device__ __forceinline__ void layer_fwd_atom(
    const FwdBufs& b, const LayerW<T>& w, int M, int D, int H, int F, float scale, float eps,
    T* center_out, float* center_s, T* edge_out, bool keep, LayerI8 s8 = {}, ScoresI8 i8 = {}) {
    static_assert(!(W8 && I8), "one int8 variant at a time");
    constexpr bool Q8 = W8 || I8;  // int8 scores and the rounded softmax
    const int hd = D / H;
    const int LQ = qkv_stride(D), LP = M + 1;
    float* X = b.X;
    float* N = b.N;
    float* Q = b.Q;
    float* P = b.P;
    float* CF = b.CF;

    rmsnorm_rows<T, !W8>(X, N, nullptr, M, D, w.norm_attn, eps);
    __syncthreads();
    if constexpr (W8) {
        block_mm_s8(N, D, M, D, s8.inv_normed, s8.w_qkv_t, 3 * D, [&](int m, int n, int acc) {
            const int part = n / D;  // q, k, v
            const float o = dequant(acc, part == 0 ? s8.deq_q : part == 1 ? s8.deq_k : s8.deq_v,
                                    to_f(w.b_qkv[n]));
            Q[m * LQ + n] = part == 2 ? rnd<T>(o) : o;
        });
    } else {
        block_mm<16>(N, D, M, D, w.w_qkv, 3 * D, 3 * D, [&](int m, int n, float acc) {
            Q[m * LQ + n] = rnd<T>(acc + to_f(w.b_qkv[n]));
        });
    }
    __syncthreads();

    for (int h = 0; h < H; ++h) {
        if constexpr (W8) {
            scores_s8(Q + h * hd, s8.inv_q, Q + D + h * hd, s8.inv_k, LQ, M, hd,
                      [&](int q, int k, int s) { P[q * LP + k] = __fmul_rn((float)s, s8.deq_scores); });
        } else if constexpr (I8) {
            scores_s8<true>(Q + h * hd, i8.s_q, Q + D + h * hd, i8.s_k, LQ, M, hd,
                            [&](int q, int k, int s) { P[q * LP + k] = __fmul_rn((float)s, i8.factor); });
        } else {
            smem_abt(Q + h * hd, LQ, Q + D + h * hd, LQ, M, M, hd,
                     [&](int q, int k, float s) { P[q * LP + k] = s * scale; });
        }
        __syncthreads();
        if constexpr (Q8) {
            cf_softmax_rows_w8<T>(P, LP, CF, M, nullptr);
        } else {
            cf_softmax_rows(P, LP, CF, M);
        }
        __syncthreads();
        // the rounded softmax weights hold cf already
        smem_awb(P, LP, Q8 ? nullptr : CF, Q + 2 * D + h * hd, LQ, M, hd, M,
                 [&](int q, int d, float o) { N[q * D + h * hd + d] = rnd<T>(o); });
        __syncthreads();
    }

    block_mm<16>(N, D, M, D, w.w_out, D, D, [&](int m, int n, float acc) {
        const float o = rnd<T>(acc + to_f(w.b_out[n]));
        if (m == M - 1) {
            if (center_out != nullptr) center_out[n] = from_f<T>(o);
            if (center_s != nullptr) center_s[n] = o;
        }
        X[m * D + n] = rnd<T>(X[m * D + n] + o);
    });
    __syncthreads();
    if (edge_out == nullptr && !keep) return;

    rmsnorm_rows<T, !W8>(X, N, nullptr, M, D, w.norm_mlp, eps);
    __syncthreads();
    // value = vg[:, :F], gate = vg[:, F:]; vg itself stays in float
    if constexpr (W8) {
        block_mm_glu_s8(N, D, M, D, s8.inv_hnorm, s8.w_in_t, F, [&](int m, int n, int v, int g) {
            const float vf = dequant(v, s8.deq_in, to_f(w.b_in[n]));
            const float gf = dequant(g, s8.deq_in, to_f(w.b_in[F + n]));
            Q[m * F + n] = vf * sigmoidf_(gf);
        });
    } else {
        block_mm_glu<16>(N, D, M, D, w.w_in, F, [&](int m, int n, float v, float g) {
            v += to_f(w.b_in[n]);
            g += to_f(w.b_in[F + n]);
            Q[m * F + n] = rnd<T>(v * sigmoidf_(g));
        });
    }
    __syncthreads();

    // each output element reads and writes only its own X entry, so the
    // edge output can overwrite the residual in place
    if constexpr (W8) {
        block_mm_s8(Q, F, M, F, s8.inv_ffn, s8.w_fo_t, D, [&](int m, int n, int acc) {
            const float o = rnd<T>(dequant(acc, s8.deq_fo, to_f(w.b_ffn_out[n])));
            const float e = m == M - 1 ? 0.f : X[m * D + n] + o;
            if (edge_out != nullptr) edge_out[m * D + n] = from_f<T>(e);
            if (keep) X[m * D + n] = rnd<T>(e);
        });
    } else {
        block_mm<16>(Q, F, M, F, w.w_ffn_out, D, D, [&](int m, int n, float acc) {
            const float o = rnd<T>(acc + to_f(w.b_ffn_out[n]));
            const float e = m == M - 1 ? 0.f : X[m * D + n] + o;
            if (edge_out != nullptr) edge_out[m * D + n] = from_f<T>(e);
            if (keep) X[m * D + n] = rnd<T>(e);
        });
    }
}

}  // namespace mtt
