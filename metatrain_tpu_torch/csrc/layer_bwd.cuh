// The per-atom body of K2 / K2-dW (one fused PET transformer layer,
// backward), shared by K2 (fused_layer_bwd.cu) and the GNN block's
// backward (gnn_block_bwd.cu). fused_layer_bwd.cu describes the design.
//
// W8 = true is K2-W8A8, the input gradients of the W8A8 layer
// (layer_fwd.cuh) by straight-through estimation, as the JAX package's
// _layer_bwd_math with w8a8: the recompute reproduces the quantized
// forward (int8 QKV, scores and FFN-in; cf * e rounded), and every
// gradient product takes the T weights and q, k rounded to T, as if the
// quantizers were the identity. No weight gradients.
//
// I8 = true is the backward of the dynamic int8 scores (layer_fwd.cuh),
// as _layer_bwd_math with int8: the recompute quantizes each head's scores
// with the same block scales as the forward, so it reproduces K1-int8's
// softmax; the softmax and every gradient product are K2-W8A8's (q and k
// are already in T). With DW as well, the weight gradients.
//
// Buffers (layer_bwd_plan): X (M x D), QKV (M x (3D + 4)), RES (M x max(D,
// M + 1)), SCR (scratch_floats), RS1, RS2, CF, DCF (M each); all in shared
// memory up to ~231 KB (K2-dW at M = 64, D = 128), else the scratch, then
// RES, then q|k|v move to the block's workspace slice.

#pragma once

#include "common.cuh"

namespace mtt {

constexpr int kRowChunk = 16;

// The weights the backward reads: the forward's (but w_ffn_out) and
// transposed copies for the products with the cotangents.
template <typename T>
struct LayerBwdW {
    const T* norm_attn;
    const T* w_qkv;        // (D, 3D)
    const T* b_qkv;
    const T* w_out;        // (D, D)
    const T* b_out;
    const T* norm_mlp;
    const T* w_in;         // (D, 2F)
    const T* b_in;
    const T* w_qkv_t;      // (3D, D)
    const T* w_out_t;      // (D, D)
    const T* w_in_t;       // (2F, D)
    const T* w_ffn_out_t;  // (D, F)
};

// One atom's rows in global memory.
template <typename T>
struct AtomIO {
    const T* e;      // (M, D) edge tokens; slot M-1 is not read
    const T* c_in;   // (D,) center token
    const float* cf; // (M,)
    const T* ge;     // (M, D) cotangent of the edge output
    const T* gc;     // (D,) cotangent of the center output
    T* d_edges;      // (M, D)
    T* d_center;     // (D,)
    float* d_cf;     // (M,)
    bool add_dcf;    // d_cf += this layer's instead of =
};

// Offsets of the weight gradients in a partial, in LayerWeights order
// (all multiples of 4 floats: D % 4 == 0 and F % 4 == 0).
struct DwLayout {
    long long norm_attn, w_qkv, b_qkv, w_out, b_out, norm_mlp, w_in, b_in, w_ffn_out, b_ffn_out, total;
    __host__ __device__ DwLayout(int D, int F) {
        norm_attn = 0;
        w_qkv = norm_attn + D;
        b_qkv = w_qkv + 3LL * D * D;
        w_out = b_qkv + 3 * D;
        b_out = w_out + (long long)D * D;
        norm_mlp = b_out + D;
        w_in = norm_mlp + D;
        b_in = w_in + 2LL * D * F;
        w_ffn_out = b_in + 2 * F;
        b_ffn_out = w_ffn_out + (long long)F * D;
        total = b_ffn_out + D;
    }
};

// Scratch: n1 / attn / d_attn_out (M x D), the SwiGLU row chunk (with
// K2-dW's two extra row buffers), or one head's attention backward (E, T:
// M x (M + 1); dq: M x hd; with int8 scores (q8): the AV weights, M x (M +
// 1)), whichever is largest.
__host__ __device__ inline size_t scratch_floats(int M, int D, int H, int F, bool dw, bool q8 = false) {
    const size_t ffn = (size_t)kRowChunk * (D + 2 * F + (dw ? D + F : 0));
    const size_t att = (q8 ? 3 : 2) * (size_t)M * (M + 1) + (size_t)M * (D / H);
    const size_t rows = (size_t)M * D;
    const size_t big = ffn > att ? ffn : att;
    return big > rows ? big : rows;
}

enum BwdBuf { kBwdX, kBwdQKV, kBwdRES, kBwdSCR, kBwdRS1, kBwdRS2, kBwdCF, kBwdDCF, kBwdBufs };

// The body's buffers placed under `cap` floats of shared memory: the four
// row vectors and X first, then q|k|v, RES and the scratch.
inline SmemPlan layer_bwd_plan(int M, int D, int H, int F, bool dw, bool q8,
                               long long cap = kMaxSharedFloats) {
    const long long md = (long long)M * D, mp = (long long)M * (M + 1);
    const long long sizes[kBwdBufs] = {md, (long long)M * qkv_stride(D), md > mp ? md : mp,
                                       (long long)scratch_floats(M, D, H, F, dw, q8), M, M, M, M};
    const int keep[kBwdBufs] = {kBwdRS1, kBwdRS2, kBwdCF, kBwdDCF, kBwdX, kBwdQKV, kBwdRES, kBwdSCR};
    return make_plan(sizes, keep, kBwdBufs, cap);
}

struct BwdBufs {
    float *X, *QKV, *RES, *SCR, *RS1, *RS2, *CF, *DCF;
    // SH: the plan keeps every buffer shared (plan_ptr)
    template <bool SH>
    __device__ static BwdBufs make(const SmemPlan& p, float* smem, float* ws) {
        return BwdBufs{plan_ptr<SH>(p, kBwdX, smem, ws),   plan_ptr<SH>(p, kBwdQKV, smem, ws),
                       plan_ptr<SH>(p, kBwdRES, smem, ws), plan_ptr<SH>(p, kBwdSCR, smem, ws),
                       plan_ptr<SH>(p, kBwdRS1, smem, ws), plan_ptr<SH>(p, kBwdRS2, smem, ws),
                       plan_ptr<SH>(p, kBwdCF, smem, ws),  plan_ptr<SH>(p, kBwdDCF, smem, ws)};
    }
};

// d_x of y = rnd(x * r * w) given dy, for one row (one warp): returns the
// row sum s = sum(gs * x) with gs = dy * r * w, so d_x = gs - x r^2 s / D.
template <typename T>
__device__ __forceinline__ float rms_bwd_sum(const float* x, const float* dy, float r, const T* w, int D, int lane) {
    float s = 0.f;
    for (int k = lane; k < D; k += 32) s = fmaf(dy[k] * r * to_f(w[k]), x[k], s);
    return warp_sum(s);
}

// One atom's backward; with DW, its weight gradients are added to the
// block's partial P; with W8, the W8A8 layer's (s8: its int8 weights and
// scales); with I8, the dynamic int8 scores' (i8: the atom's scales).
template <typename T, bool DW, bool W8 = false, bool I8 = false>
__device__ __forceinline__ void layer_bwd_atom(const LayerBwdW<T>& p, const AtomIO<T>& io, int M, int D, int H,
                               int F, float scale, float eps, const BwdBufs& bufs, float* P,
                               LayerI8 s8 = {}, ScoresI8 i8 = {}) {
    static_assert(!(DW && W8), "the W8A8 layer has no weight gradients");
    static_assert(!(W8 && I8), "one int8 variant at a time");
    constexpr bool Q8 = W8 || I8;  // int8 scores and the rounded softmax
    const int hd = D / H;
    const int LQ = qkv_stride(D), LP = M + 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const DwLayout L(D, F);

    float* X = bufs.X;      // tokens, later attn (DW), d_attn, d_n1
    float* QKV = bufs.QKV;  // q|k|v, then dq|dk|dv
    float* RES = bufs.RES;  // one head's softmax, then res, then d_res
    float* SCR = bufs.SCR;  // n1, attn, SwiGLU chunk, d_attn_out, attention bwd, n1 (DW)
    float* RS1 = bufs.RS1;
    float* RS2 = bufs.RS2;
    float* CF = bufs.CF;
    float* DCF = bufs.DCF;

    const T* e = io.e;
    const T* ge = io.ge;
    const T* gc = io.gc;
    const T* c_in = io.c_in;
    for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
        const int m = i / D;
        X[i] = m == M - 1 ? to_f(c_in[i % D]) : to_f(e[i]);
    }
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
        CF[i] = io.cf[i];
        DCF[i] = 0.f;
    }
    __syncthreads();

    // ---- forward recompute up to the residual ----------------------------
    rmsnorm_rows<T, !W8>(X, SCR, RS1, M, D, p.norm_attn, eps);
    __syncthreads();
    if constexpr (W8) {
        // q and k stay float until each head's scores are recomputed below
        block_mm_s8(SCR, D, M, D, s8.inv_normed, s8.w_qkv_t, 3 * D, [&](int m, int n, int acc) {
            const int part = n / D;
            const float o = dequant(acc, part == 0 ? s8.deq_q : part == 1 ? s8.deq_k : s8.deq_v,
                                    to_f(p.b_qkv[n]));
            QKV[m * LQ + n] = part == 2 ? rnd<T>(o) : o;
        });
    } else {
        block_mm<16>(SCR, D, M, D, p.w_qkv, 3 * D, 3 * D, [&](int m, int n, float acc) {
            QKV[m * LQ + n] = rnd<T>(acc + to_f(p.b_qkv[n]));
        });
    }
    __syncthreads();
    for (int h = 0; h < H; ++h) {
        if constexpr (W8) {
            scores_s8(QKV + h * hd, s8.inv_q, QKV + D + h * hd, s8.inv_k, LQ, M, hd,
                      [&](int q, int k, int s) { RES[q * LP + k] = __fmul_rn((float)s, s8.deq_scores); });
        } else if constexpr (I8) {
            scores_s8<true>(QKV + h * hd, i8.s_q, QKV + D + h * hd, i8.s_k, LQ, M, hd,
                            [&](int q, int k, int s) { RES[q * LP + k] = __fmul_rn((float)s, i8.factor); });
        } else {
            smem_abt(QKV + h * hd, LQ, QKV + D + h * hd, LQ, M, M, hd,
                     [&](int q, int k, float s) { RES[q * LP + k] = s * scale; });
        }
        __syncthreads();
        if constexpr (Q8) {
            cf_softmax_rows_w8<T>(RES, LP, CF, M, nullptr);
        } else {
            cf_softmax_rows(RES, LP, CF, M);
        }
        __syncthreads();
        smem_awb(RES, LP, Q8 ? nullptr : CF, QKV + 2 * D + h * hd, LQ, M, hd, M,
                 [&](int q, int d, float o) { SCR[q * D + h * hd + d] = rnd<T>(o); });
        __syncthreads();
    }
    block_mm<16>(SCR, D, M, D, p.w_out, D, D, [&](int m, int n, float acc) {
        RES[m * D + n] = rnd<T>(X[m * D + n] + rnd<T>(acc + to_f(p.b_out[n])));
    });
    __syncthreads();
    if (DW) {
        // keep attn for w_out's gradient: the tokens are not read again
        for (int i = threadIdx.x; i < M * D; i += blockDim.x) X[i] = SCR[i];
        __syncthreads();
    }

    // ---- SwiGLU + norm_mlp backward, 16 rows at a time -> RES = d_res ------
    float* HN = SCR;                   // (16, D): h_norm (K2: then g_eo, d_h)
    float* VG = SCR + kRowChunk * D;   // (16, 2F): vg, then d_vg
    float* GE = DW ? VG + kRowChunk * 2 * F : HN;  // (16, D): g_eo, then d_h
    float* FH = GE + kRowChunk * D;    // DW: (16, F) ffn_h
    for (int c0 = 0; c0 < M; c0 += kRowChunk) {
        rmsnorm_rows<T, !W8>(RES + c0 * D, HN, RS2 + c0, kRowChunk, D, p.norm_mlp, eps);
        __syncthreads();
        if constexpr (W8) {
            block_mm_s8(HN, D, kRowChunk, D, s8.inv_hnorm, s8.w_in_t, 2 * F, [&](int m, int n, int acc) {
                VG[m * 2 * F + n] = dequant(acc, s8.deq_in, to_f(p.b_in[n]));
            });
        } else {
            block_mm<16>(HN, D, kRowChunk, D, p.w_in, 2 * F, 2 * F, [&](int m, int n, float acc) {
                VG[m * 2 * F + n] = acc + to_f(p.b_in[n]);
            });
        }
        __syncthreads();
        for (int i = threadIdx.x; i < kRowChunk * D; i += blockDim.x) {
            const int m = c0 + i / D;
            GE[i] = m == M - 1 ? 0.f : to_f(ge[(size_t)m * D + i % D]);
        }
        if (DW) {
            for (int i = threadIdx.x; i < kRowChunk * F; i += blockDim.x) {
                const int m = i / F, j = i % F;
                FH[i] = rnd<T>(VG[m * 2 * F + j] * sigmoidf_(VG[m * 2 * F + F + j]));
            }
        }
        __syncthreads();
        if (DW) {
            accum_atb<T, false>(P + L.w_ffn_out, D, FH, F, GE, D, kRowChunk, F, D);
            accum_colsum(P + L.b_ffn_out, GE, D, kRowChunk, D);
        }
        block_mm<16>(GE, D, kRowChunk, D, p.w_ffn_out_t, F, F, [&](int m, int j, float dfh) {
            const float v = VG[m * 2 * F + j], s = sigmoidf_(VG[m * 2 * F + F + j]);
            VG[m * 2 * F + j] = rnd<T>(dfh * s);
            VG[m * 2 * F + F + j] = rnd<T>(dfh * v * s * (1.f - s));
        });
        __syncthreads();
        if (DW) {
            accum_atb<T, false>(P + L.w_in, 2 * F, HN, D, VG, 2 * F, kRowChunk, D, 2 * F);
            accum_colsum(P + L.b_in, VG, 2 * F, kRowChunk, 2 * F);
        }
        block_mm<16>(VG, 2 * F, kRowChunk, 2 * F, p.w_in_t, D, D, [&](int m, int n, float acc) {
            GE[m * D + n] = acc;
        });
        __syncthreads();
        if (DW) {
            // norm_mlp: sum over rows of d_h * (x2 * r2), before RES turns into d_res
            for (int k = threadIdx.x; k < D; k += blockDim.x) {
                float s = 0.f;
                for (int r = 0; r < kRowChunk; ++r)
                    s = fmaf(GE[r * D + k], RES[(c0 + r) * D + k] * RS2[c0 + r], s);
                P[L.norm_mlp + k] += s;
            }
            __syncthreads();
        }
        for (int r = warp; r < kRowChunk; r += nw) {
            const int m = c0 + r;
            float* x2 = RES + m * D;
            const float r2 = RS2[m];
            const float s = rms_bwd_sum<T>(x2, GE + r * D, r2, p.norm_mlp, D, lane);
            const float c = r2 * r2 * s / D;
            for (int k = lane; k < D; k += 32) {
                const float g_eo = m == M - 1 ? 0.f : to_f(ge[(size_t)m * D + k]);
                const float gs = GE[r * D + k] * r2 * to_f(p.norm_mlp[k]);
                x2[k] = g_eo + gs - x2[k] * c;
            }
        }
        __syncthreads();
    }

    // ---- out-projection backward: d_attn = rnd(d_res + g_center@M-1) W^T ----
    for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
        const int m = i / D;
        SCR[i] = rnd<T>(RES[i] + (m == M - 1 ? to_f(gc[i % D]) : 0.f));
    }
    __syncthreads();
    if (DW) {
        accum_atb<T, false>(P + L.w_out, D, X, D, SCR, D, M, D, D);
        accum_colsum(P + L.b_out, SCR, D, M, D);
        __syncthreads();
    }
    float* DAT = X;
    block_mm<16>(SCR, D, M, D, p.w_out_t, D, D, [&](int m, int n, float acc) { DAT[m * D + n] = acc; });
    __syncthreads();

    // ---- attention backward, one head at a time ---------------------------
    float* E = SCR;             // exp(s - max) / sum cf exp(s - max)   (M x LP)
    float* Tm = E + M * LP;     // dP, then E * (dP - delta)            (M x LP)
    float* DQ = Tm + M * LP;    // (M, hd): dq of this head
    float* PW = DQ + M * hd;    // Q8: the AV weights rnd(cf e) / z     (M x LP)
    for (int h = 0; h < H; ++h) {
        float* qh = QKV + h * hd;
        float* kh = QKV + D + h * hd;
        float* vh = QKV + 2 * D + h * hd;
        if constexpr (W8) {
            scores_s8(qh, s8.inv_q, kh, s8.inv_k, LQ, M, hd,
                      [&](int q, int k, int s) { PW[q * LP + k] = __fmul_rn((float)s, s8.deq_scores); });
            __syncthreads();
            cf_softmax_rows_w8<T>(PW, LP, CF, M, E);
            // straight through: the gradient products take q and k in T
            for (int idx = threadIdx.x; idx < M * hd; idx += blockDim.x) {
                const int m = idx / hd, d = idx % hd;
                qh[m * LQ + d] = rnd<T>(qh[m * LQ + d]);
                kh[m * LQ + d] = rnd<T>(kh[m * LQ + d]);
            }
        } else if constexpr (I8) {
            // straight through: q and k are in T already
            scores_s8<true>(qh, i8.s_q, kh, i8.s_k, LQ, M, hd,
                            [&](int q, int k, int s) { PW[q * LP + k] = __fmul_rn((float)s, i8.factor); });
            __syncthreads();
            cf_softmax_rows_w8<T>(PW, LP, CF, M, E);
        } else {
            smem_abt(qh, LQ, kh, LQ, M, M, hd, [&](int q, int k, float s) { E[q * LP + k] = s * scale; });
            __syncthreads();
            cf_softmax_rows(E, LP, CF, M);
        }
        smem_abt(DAT + h * hd, D, vh, LQ, M, M, hd, [&](int q, int k, float s) { Tm[q * LP + k] = s; });
        __syncthreads();
        for (int q = warp; q < M; q += nw) {
            float delta = 0.f;
            for (int k = lane; k < M; k += 32)
                delta = fmaf(Q8 ? PW[q * LP + k] : CF[k] * E[q * LP + k], Tm[q * LP + k], delta);
            delta = warp_sum(delta);
            for (int k = lane; k < M; k += 32) Tm[q * LP + k] = E[q * LP + k] * (Tm[q * LP + k] - delta);
        }
        __syncthreads();
        // d_cf[k] += sum_q T[q, k]; dq[q] = scale sum_k cf_k T[q, k] k_k;
        // dv[k] = cf_k sum_q E[q, k] d_attn[q] (v is no longer read)
        for (int k = threadIdx.x; k < M; k += blockDim.x) {
            float s = 0.f;
            for (int q = 0; q < M; ++q) s += Tm[q * LP + k];
            DCF[k] += s;
        }
        smem_awb(Tm, LP, CF, kh, LQ, M, hd, M, [&](int q, int d, float s) { DQ[q * hd + d] = s * scale; });
        if constexpr (Q8) {
            smem_atb(PW, LP, DAT + h * hd, D, M, hd, M,
                     [&](int k, int d, float s) { vh[k * LQ + d] = rnd<T>(s); });
        } else {
            smem_atb(E, LP, DAT + h * hd, D, M, hd, M,
                     [&](int k, int d, float s) { vh[k * LQ + d] = rnd<T>(s * CF[k]); });
        }
        __syncthreads();
        // dk[k] = scale cf_k sum_q T[q, k] q_q (q still intact), then dq -> q
        smem_atb(Tm, LP, qh, LQ, M, hd, M,
                 [&](int k, int d, float s) { kh[k * LQ + d] = rnd<T>(s * scale * CF[k]); });
        __syncthreads();
        for (int idx = threadIdx.x; idx < M * hd; idx += blockDim.x)
            qh[(idx / hd) * LQ + idx % hd] = rnd<T>(DQ[idx]);
        __syncthreads();
    }

    // ---- QKV + norm_attn backward -> d_tokens -----------------------------
    float* DN1 = X;
    block_mm<16>(QKV, LQ, M, 3 * D, p.w_qkv_t, D, D, [&](int m, int n, float acc) { DN1[m * D + n] = acc; });
    if (DW) {
        // n1 again, as the forward's rmsnorm_rows rounded it
        for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
            const int m = i / D, k = i % D;
            const float x1 = m == M - 1 ? to_f(c_in[k]) : to_f(e[i]);
            SCR[i] = rnd<T>(x1 * RS1[m] * to_f(p.norm_attn[k]));
        }
    }
    __syncthreads();
    if (DW) {
        accum_atb<T, false>(P + L.w_qkv, 3 * D, SCR, D, QKV, LQ, M, D, 3 * D);
        accum_colsum(P + L.b_qkv, QKV, LQ, M, 3 * D);
        // norm_attn: sum over rows of d_n1 * (x1 * r1)
        for (int k = threadIdx.x; k < D; k += blockDim.x) {
            float s = 0.f;
            for (int m = 0; m < M; ++m) {
                const float x1 = m == M - 1 ? to_f(c_in[k]) : to_f(e[(size_t)m * D + k]);
                s = fmaf(DN1[m * D + k], x1 * RS1[m], s);
            }
            P[L.norm_attn + k] += s;
        }
    }
    // the tokens are read again from global memory (same values as X held)
    T* d_edges = io.d_edges;
    for (int m = warp; m < M; m += nw) {
        const T* x1 = m == M - 1 ? c_in : e + (size_t)m * D;
        const float r1 = RS1[m];
        float s = 0.f;
        for (int k = lane; k < D; k += 32)
            s = fmaf(DN1[m * D + k] * r1 * to_f(p.norm_attn[k]), to_f(x1[k]), s);
        const float c = r1 * r1 * warp_sum(s) / D;
        for (int k = lane; k < D; k += 32) {
            const float gs = DN1[m * D + k] * r1 * to_f(p.norm_attn[k]);
            const float dt = RES[m * D + k] + gs - to_f(x1[k]) * c;
            if (m == M - 1) {
                io.d_center[k] = from_f<T>(dt);
                d_edges[m * D + k] = from_f<T>(0.f);
            } else {
                d_edges[m * D + k] = from_f<T>(dt);
            }
        }
    }
    for (int k = threadIdx.x; k < M; k += blockDim.x)
        io.d_cf[k] = io.add_dcf ? io.d_cf[k] + DCF[k] : DCF[k];
}

}  // namespace mtt
