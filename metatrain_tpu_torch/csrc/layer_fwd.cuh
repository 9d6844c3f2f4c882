// The per-atom body of K1 (one fused PET transformer layer, forward),
// shared by K1 (fused_layer_fwd.cu) and the GNN block (gnn_block_fwd.cu,
// and the forward recompute of gnn_block_bwd.cu).
//
// Shared-memory layout of the body (floats): X (M x D, the tokens, then
// the residual), N (M x D: normed, attn, h_norm), Q (M x max(3D + 4, F):
// q|k|v, then ffn_h), P (M x (M + 1): one head's scores) and CF (M).

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

__host__ __device__ inline size_t layer_fwd_floats(int M, int D, int F) {
    const int LQ = qkv_stride(D);
    return 2 * (size_t)M * D + (size_t)M * (LQ > F ? LQ : F) + (size_t)M * (M + 1) + M;
}

// The cutoff weights' place in the layout.
__host__ __device__ inline float* layer_fwd_cf(float* smem, int M, int D, int F) {
    return smem + layer_fwd_floats(M, D, F) - M;
}

// One layer on one atom. On entry X (the first M * D floats of smem) holds
// the tokens with the center token in slot M-1, and CF the cutoff weights
// (cf[M-1] == 1). The attention output of slot M-1 goes to center_out
// (global, T) or center_s (shared, float rounded to T), whichever is not
// null. With edge_out or keep, the rest of the layer runs and its edge
// output (slot M-1 zeroed) goes to edge_out (global) and, with keep, back
// into X; with neither the body stops after the out-projection.
template <typename T>
__device__ void layer_fwd_atom(float* smem, const LayerW<T>& w, int M, int D, int H, int F,
                               float scale, float eps, T* center_out, float* center_s,
                               T* edge_out, bool keep) {
    const int hd = D / H;
    const int LQ = qkv_stride(D), LP = M + 1;
    float* X = smem;
    float* N = X + M * D;
    float* Q = N + M * D;
    float* P = Q + M * (LQ > F ? LQ : F);
    float* CF = P + M * LP;

    rmsnorm_rows<T>(X, N, nullptr, M, D, w.norm_attn, eps);
    __syncthreads();
    block_mm<16>(N, D, M, D, w.w_qkv, 3 * D, 3 * D, [&](int m, int n, float acc) {
        Q[m * LQ + n] = rnd<T>(acc + to_f(w.b_qkv[n]));
    });
    __syncthreads();

    for (int h = 0; h < H; ++h) {
        smem_abt(Q + h * hd, LQ, Q + D + h * hd, LQ, M, M, hd,
                 [&](int q, int k, float s) { P[q * LP + k] = s * scale; });
        __syncthreads();
        cf_softmax_rows(P, LP, CF, M);
        __syncthreads();
        smem_awb(P, LP, CF, Q + 2 * D + h * hd, LQ, M, hd, M,
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

    rmsnorm_rows<T>(X, N, nullptr, M, D, w.norm_mlp, eps);
    __syncthreads();
    // value = vg[:, :F], gate = vg[:, F:]; vg itself stays in float
    block_mm_glu<16>(N, D, M, D, w.w_in, F, [&](int m, int n, float v, float g) {
        v += to_f(w.b_in[n]);
        g += to_f(w.b_in[F + n]);
        Q[m * F + n] = rnd<T>(v * sigmoidf_(g));
    });
    __syncthreads();

    // each output element reads and writes only its own X entry, so the
    // edge output can overwrite the residual in place
    block_mm<16>(Q, F, M, F, w.w_ffn_out, D, D, [&](int m, int n, float acc) {
        const float o = rnd<T>(acc + to_f(w.b_ffn_out[n]));
        const float e = m == M - 1 ? 0.f : X[m * D + n] + o;
        if (edge_out != nullptr) edge_out[m * D + n] = from_f<T>(e);
        if (keep) X[m * D + n] = rnd<T>(e);
    });
}

}  // namespace mtt
