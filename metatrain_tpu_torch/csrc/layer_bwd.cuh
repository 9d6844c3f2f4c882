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
// SP = true (with DW) is K2-dW's spill mode (fused_layer_bwd_dw_sm90.cu):
// instead of adding each atom's weight-gradient products into a block
// partial, the body writes the products' operand rows to global memory
// (DwSpill, in T, rounded where the plain version rounds them) and the
// atom's norm-scale and bias sums to its own float row (DwLayout(D, F,
// true)); a second pass forms the products. Its buffers are K2's.
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
// (all multiples of 4 floats: D % 4 == 0 and F % 4 == 0). With vectors,
// the six vectors alone in the same order (the matrices take no room): the
// per-atom row of the spill mode.
struct DwLayout {
    long long norm_attn, w_qkv, b_qkv, w_out, b_out, norm_mlp, w_in, b_in, w_ffn_out, b_ffn_out, total;
    __host__ __device__ DwLayout(int D, int F, bool vectors = false) {
        const long long m = vectors ? 0 : 1;
        norm_attn = 0;
        w_qkv = norm_attn + D;
        b_qkv = w_qkv + m * 3LL * D * D;
        w_out = b_qkv + 3 * D;
        b_out = w_out + m * D * D;
        norm_mlp = b_out + D;
        w_in = norm_mlp + D;
        b_in = w_in + m * 2LL * D * F;
        w_ffn_out = b_in + 2 * F;
        b_ffn_out = w_ffn_out + m * F * D;
        total = b_ffn_out + D;
    }
};

// The spill mode's output for one chunk of atoms: R rows of operands in T,
// seven (R, width) arrays one after another (the X and dY of dW = X^T dY
// for w_qkv: n1 (D), d_qkv (3D); w_out: attn (D), d_attn_out (D, rounded);
// w_in: h_norm (D), d_vg (2F); w_ffn_out: ffn_h (F), whose dY, g_eo, is
// the cotangent itself), and one float row of vector sums per atom. The
// body reads it through a pointer into the kernel's (grid-constant)
// parameters, so that none of it stays in registers across the phases.
enum DwArray { kDwN1, kDwQkv, kDwAttn, kDwDao, kDwHnorm, kDwVg, kDwFfnH };

template <typename T>
struct DwSpill {
    T* rows;         // (R, 7D + 3F) as seven column blocks
    float* vec;      // (atoms, DwLayout(D, F, true).total)
    long long R;     // the rows the spill holds

    // row r of array k (widths D, 3D, D, D, D, 2F, F)
    __host__ __device__ __forceinline__ T* at(int k, long long r, int D, int F) const {
        const int c0[7] = {0, D, 4 * D, 5 * D, 6 * D, 7 * D, 7 * D + 2 * F};
        const int w[7] = {D, 3 * D, D, D, D, 2 * F, F};
        return rows + R * c0[k] + r * w[k];
    }
};

// Four values to d in T (4 T-aligned), marked evict-first: the spill is
// read once, by the next pass, and must not push the weights the body
// re-reads out of L2.
template <typename T>
__device__ __forceinline__ void spill4(T* d, float4 v) {
    if constexpr (sizeof(T) == 4) {
        __stcs(reinterpret_cast<float4*>(d), v);
    } else {
        __stcs(reinterpret_cast<uint2*>(d),
               make_uint2(pack_bf16(make_float2(v.x, v.y)), pack_bf16(make_float2(v.z, v.w))));
    }
}

// The spill mode's vector sums: P[j] = sum_{r < R} B[r, j] (first) or P[j]
// += it, j < N; the old value is loaded before the sum, so its latency
// hides behind it. Element j is always written by the same thread.
__device__ __forceinline__ void vec_colsum(float* __restrict__ P, const float* __restrict__ B, int ldb, int R,
                                           int N, bool first) {
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
        const float old = first ? 0.f : P[j];
        float s = 0.f;
        for (int r = 0; r < R; ++r) s += B[(size_t)r * ldb + j];
        P[j] = old + s;
    }
}

// dst[r, c] = src[r, c] in T for r < rows, c < cols, four columns at a time
// (the values already rounded to T where the plain version rounds them;
// cols, ldd and lds multiples of 4, src 16-byte aligned, dst 4 T-aligned).
template <typename T>
__device__ __forceinline__ void spill_rows(T* __restrict__ dst, int ldd, const float* __restrict__ src,
                                           int lds, int rows, int cols) {
    const int q = cols / 4;
    for (int i = threadIdx.x; i < rows * q; i += blockDim.x) {
        const int r = i / q, c = 4 * (i - r * q);
        spill4(dst + (size_t)r * ldd + c, *reinterpret_cast<const float4*>(src + (size_t)r * lds + c));
    }
}

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
// block's partial P (with SP, its operand rows go to atom j of the chunk's
// spill `sp`, and its vector sums to the spill's row j, written whole; P
// is not read); with W8, the W8A8 layer's (s8: its int8 weights and
// scales); with I8, the dynamic int8 scores' (i8: the atom's scales).
template <typename T, bool DW, bool W8 = false, bool I8 = false, bool SP = false>
__device__ __forceinline__ void layer_bwd_atom(const LayerBwdW<T>& p, const AtomIO<T>& io, int M, int D, int H,
                               int F, float scale, float eps, const BwdBufs& bufs, float* P,
                               LayerI8 s8 = {}, ScoresI8 i8 = {}, const DwSpill<T>* sp = nullptr,
                               int j = 0) {
    static_assert(!(DW && W8), "the W8A8 layer has no weight gradients");
    static_assert(!(W8 && I8), "one int8 variant at a time");
    static_assert(!SP || DW, "the spill mode is a weight-gradient mode");
    constexpr bool Q8 = W8 || I8;  // int8 scores and the rounded softmax
    constexpr bool ACC = DW && !SP;  // the products accumulate into P here
    const int hd = D / H;
    const int LQ = qkv_stride(D), LP = M + 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const DwLayout L(D, F, SP);
    // where the vector sums go (sums over all rows, or over each 16-row
    // chunk in turn: the first call writes); the spill's rows of array k
    auto vec = [&]() -> float* {
        if constexpr (SP) return sp->vec + (long long)j * L.total;
        return P;
    };
    auto colsum = [&](long long off, const float* B, int ldb, int R, int N, bool first) {
        if constexpr (SP) {
            vec_colsum(vec() + off, B, ldb, R, N, first);
        } else {
            accum_colsum(P + off, B, ldb, R, N);
        }
    };
    auto rows = [&](int k, int r) -> T* { return sp->at(k, (long long)j * M + r, D, F); };

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
    if constexpr (SP) spill_rows(rows(kDwN1, 0), D, SCR, D, M, D);
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
    if constexpr (SP) spill_rows(rows(kDwAttn, 0), D, SCR, D, M, D);
    block_mm<16>(SCR, D, M, D, p.w_out, D, D, [&](int m, int n, float acc) {
        RES[m * D + n] = rnd<T>(X[m * D + n] + rnd<T>(acc + to_f(p.b_out[n])));
    });
    __syncthreads();
    if (ACC) {
        // keep attn for w_out's gradient: the tokens are not read again
        for (int i = threadIdx.x; i < M * D; i += blockDim.x) X[i] = SCR[i];
        __syncthreads();
    }

    // ---- SwiGLU + norm_mlp backward, 16 rows at a time -> RES = d_res ------
    float* HN = SCR;                   // (16, D): h_norm (K2: then g_eo, d_h)
    float* VG = SCR + kRowChunk * D;   // (16, 2F): vg, then d_vg
    float* GE = ACC ? VG + kRowChunk * 2 * F : HN;  // (16, D): g_eo, then d_h
    float* FH = GE + kRowChunk * D;    // accumulate mode: (16, F) ffn_h
    for (int c0 = 0; c0 < M; c0 += kRowChunk) {
        rmsnorm_rows<T, !W8>(RES + c0 * D, HN, RS2 + c0, kRowChunk, D, p.norm_mlp, eps);
        __syncthreads();
        if constexpr (SP) spill_rows(rows(kDwHnorm, c0), D, HN, D, kRowChunk, D);
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
        if constexpr (SP) {
            for (int i = threadIdx.x; i < kRowChunk * F / 4; i += blockDim.x) {
                const int m = 4 * i / F, j = 4 * i - m * F;
                const float* v = VG + m * 2 * F + j;
                spill4(rows(kDwFfnH, c0 + m) + j,
                       make_float4(rnd<T>(v[0] * sigmoidf_(v[F])), rnd<T>(v[1] * sigmoidf_(v[F + 1])),
                                   rnd<T>(v[2] * sigmoidf_(v[F + 2])), rnd<T>(v[3] * sigmoidf_(v[F + 3]))));
            }
        } else if (DW) {
            for (int i = threadIdx.x; i < kRowChunk * F; i += blockDim.x) {
                const int m = i / F, j = i % F;
                FH[i] = rnd<T>(VG[m * 2 * F + j] * sigmoidf_(VG[m * 2 * F + F + j]));
            }
        }
        __syncthreads();
        if (ACC) accum_atb<T, false>(P + L.w_ffn_out, D, FH, F, GE, D, kRowChunk, F, D);
        if (DW) colsum(L.b_ffn_out, GE, D, kRowChunk, D, c0 == 0);
        block_mm<16>(GE, D, kRowChunk, D, p.w_ffn_out_t, F, F, [&](int m, int j, float dfh) {
            const float v = VG[m * 2 * F + j], s = sigmoidf_(VG[m * 2 * F + F + j]);
            VG[m * 2 * F + j] = rnd<T>(dfh * s);
            VG[m * 2 * F + F + j] = rnd<T>(dfh * v * s * (1.f - s));
        });
        __syncthreads();
        if (ACC) accum_atb<T, false>(P + L.w_in, 2 * F, HN, D, VG, 2 * F, kRowChunk, D, 2 * F);
        if constexpr (SP) spill_rows(rows(kDwVg, c0), 2 * F, VG, 2 * F, kRowChunk, 2 * F);
        if (DW) colsum(L.b_in, VG, 2 * F, kRowChunk, 2 * F, c0 == 0);
        block_mm<16>(VG, 2 * F, kRowChunk, 2 * F, p.w_in_t, D, D, [&](int m, int n, float acc) {
            GE[m * D + n] = acc;
        });
        __syncthreads();
        if (DW) {
            // norm_mlp: sum over rows of d_h * (x2 * r2), before RES turns into d_res
            for (int k = threadIdx.x; k < D; k += blockDim.x) {
                float* v = vec() + L.norm_mlp + k;
                const float old = SP && c0 == 0 ? 0.f : *v;
                float s = 0.f;
                for (int r = 0; r < kRowChunk; ++r)
                    s = fmaf(GE[r * D + k], RES[(c0 + r) * D + k] * RS2[c0 + r], s);
                *v = old + s;
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
        if constexpr (SP) {
            spill_rows(rows(kDwDao, 0), D, SCR, D, M, D);
        } else {
            accum_atb<T, false>(P + L.w_out, D, X, D, SCR, D, M, D, D);
        }
        colsum(L.b_out, SCR, D, M, D, true);
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
    if constexpr (SP) {
        // the tokens again, into the free scratch, for norm_attn's sum
        for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
            const int m = i / D;
            SCR[i] = m == M - 1 ? to_f(c_in[i % D]) : to_f(e[i]);
        }
    }
    if (ACC) {
        // n1 again, as the forward's rmsnorm_rows rounded it
        for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
            const int m = i / D, k = i % D;
            const float x1 = m == M - 1 ? to_f(c_in[k]) : to_f(e[i]);
            SCR[i] = rnd<T>(x1 * RS1[m] * to_f(p.norm_attn[k]));
        }
    }
    __syncthreads();
    if (DW) {
        if constexpr (SP) {
            spill_rows(rows(kDwQkv, 0), 3 * D, QKV, LQ, M, 3 * D);
        } else {
            accum_atb<T, false>(P + L.w_qkv, 3 * D, SCR, D, QKV, LQ, M, D, 3 * D);
        }
        colsum(L.b_qkv, QKV, LQ, M, 3 * D, true);
        // norm_attn: sum over rows of d_n1 * (x1 * r1)
        for (int k = threadIdx.x; k < D; k += blockDim.x) {
            float s = 0.f;
            for (int m = 0; m < M; ++m) {
                const float x1 = SP ? SCR[m * D + k]
                                    : m == M - 1 ? to_f(c_in[k]) : to_f(e[(size_t)m * D + k]);
                s = fmaf(DN1[m * D + k], x1 * RS1[m], s);
            }
            if constexpr (SP) {
                vec()[L.norm_attn + k] = s;
            } else {
                P[L.norm_attn + k] += s;
            }
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
