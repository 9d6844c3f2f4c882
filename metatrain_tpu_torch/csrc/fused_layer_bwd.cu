// K2: fused PET transformer layer, backward for input gradients.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/fused_layer.py
// `_bwd_kernel` (entered through `_make_bwd_op` / `_fused_bwd`, body
// `_layer_bwd_math`) in its `weight_grads=False` variant: the layer is
// recomputed per atom, then back-propagated to d_edges (slot M-1 zero),
// d_center and d_cf (float). Forces need d_cf: the cutoff weights depend
// on the positions. Weight gradients belong to the training slice.
//
// What bounds it on the H100: about twice the forward's FLOPs on the same
// per-atom activations, and shared memory. One block per atom keeps the
// tokens, q/k/v (overwritten head by head with dq/dk/dv), the attention
// softmax, the residual (then d_res) and scratch that serves one phase
// after another: ~165 KB at M=48, ~207 KB at M=64 (D=128, one block per
// SM). The tokens are read again from global memory at the end instead of
// being kept. The SwiGLU backward runs over row
// chunks of 16 tokens (its rows are independent), so the (M, 2F) gate
// activations never need to be resident at once. The attention backward
// runs one head at a time with max-subtracted scores, its five products on
// FMA register tiles (common.cuh smem_abt / smem_awb / smem_atb); d_cf is
// summed over queries and heads in a fixed order (no atomics), so it is
// deterministic.
// Transposed weight copies come from the caller, so every product is the
// same block_mm as in the forward (FMA in f32, tensor cores in bf16); the
// five per-head attention products stay on FMA loops and are the larger
// share of the time in bf16.

#include "common.cuh"

namespace mtt {
namespace {

constexpr int kRowChunk = 16;

template <typename T>
struct LayerBwdArgs {
    const T* edges;
    const T* center;
    const float* cf;
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
    const T* g_edge;       // (A, M, D)
    const T* g_center;     // (A, D)
    T* d_edges;            // (A, M, D)
    T* d_center;           // (A, D)
    float* d_cf;           // (A, M)
    int M, D, H, F;
    float scale, eps;
};

__host__ __device__ inline int qkv_stride(int D) { return 3 * D + 4; }

// Scratch: n1 / attn / d_attn_out (M x D), the SwiGLU row chunk, or one
// head's attention backward (E, T: M x (M + 1); dq: M x hd), whichever is
// largest.
__host__ __device__ inline size_t scratch_floats(int M, int D, int H, int F) {
    const size_t ffn = (size_t)kRowChunk * (D + 2 * F);
    const size_t att = 2 * (size_t)M * (M + 1) + (size_t)M * (D / H);
    const size_t rows = (size_t)M * D;
    const size_t big = ffn > att ? ffn : att;
    return big > rows ? big : rows;
}

__host__ __device__ inline size_t smem_floats(int M, int D, int H, int F) {
    return 2 * (size_t)M * D + (size_t)M * qkv_stride(D) + scratch_floats(M, D, H, F) + 4 * (size_t)M;
}

// d_x of y = rnd(x * r * w) given dy, for one row (one warp): returns the
// row sum s = sum(gs * x) with gs = dy * r * w, so d_x = gs - x r^2 s / D.
template <typename T>
__device__ __forceinline__ float rms_bwd_sum(const float* x, const float* dy, float r, const T* w, int D, int lane) {
    float s = 0.f;
    for (int k = lane; k < D; k += 32) s = fmaf(dy[k] * r * to_f(w[k]), x[k], s);
    return warp_sum(s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_layer_bwd_kernel(LayerBwdArgs<T> p) {
    extern __shared__ __align__(16) float smem[];
    const int M = p.M, D = p.D, F = p.F, H = p.H, hd = D / H;
    const int LQ = qkv_stride(D), LP = M + 1;  // M < D: the scores fit in RES
    const long long a = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;

    float* X = smem;              // tokens, later d_attn, later d_n1
    float* QKV = X + M * D;       // q|k|v, then dq|dk|dv
    float* RES = QKV + M * LQ;    // one head's softmax, then res, then d_res
    float* SCR = RES + M * D;     // n1, attn, SwiGLU chunk, d_attn_out, attention bwd
    float* RS1 = SCR + scratch_floats(M, D, H, F);
    float* RS2 = RS1 + M;
    float* CF = RS2 + M;
    float* DCF = CF + M;

    const T* e = p.edges + a * M * D;
    const T* ge = p.g_edge + a * M * D;
    const T* gc = p.g_center + a * D;
    const T* c_in = p.center + a * D;
    for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
        const int m = i / D;
        X[i] = m == M - 1 ? to_f(c_in[i % D]) : to_f(e[i]);
    }
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
        CF[i] = p.cf[a * M + i];
        DCF[i] = 0.f;
    }
    __syncthreads();

    // ---- forward recompute up to the residual ----------------------------
    rmsnorm_rows<T>(X, SCR, RS1, M, D, p.norm_attn, p.eps);
    __syncthreads();
    block_mm<16>(SCR, D, M, D, p.w_qkv, 3 * D, 3 * D, [&](int m, int n, float acc) {
        QKV[m * LQ + n] = rnd<T>(acc + to_f(p.b_qkv[n]));
    });
    __syncthreads();
    for (int h = 0; h < H; ++h) {
        smem_abt(QKV + h * hd, LQ, QKV + D + h * hd, LQ, M, M, hd,
                 [&](int q, int k, float s) { RES[q * LP + k] = s * p.scale; });
        __syncthreads();
        cf_softmax_rows(RES, LP, CF, M);
        __syncthreads();
        smem_awb(RES, LP, CF, QKV + 2 * D + h * hd, LQ, M, hd, M,
                 [&](int q, int d, float o) { SCR[q * D + h * hd + d] = rnd<T>(o); });
        __syncthreads();
    }
    block_mm<16>(SCR, D, M, D, p.w_out, D, D, [&](int m, int n, float acc) {
        RES[m * D + n] = rnd<T>(X[m * D + n] + rnd<T>(acc + to_f(p.b_out[n])));
    });
    __syncthreads();

    // ---- SwiGLU + norm_mlp backward, 16 rows at a time -> RES = d_res ------
    float* HN = SCR;                   // (16, D): h_norm, g_eo, d_h
    float* VG = SCR + kRowChunk * D;   // (16, 2F): vg, then d_vg
    for (int c0 = 0; c0 < M; c0 += kRowChunk) {
        rmsnorm_rows<T>(RES + c0 * D, HN, RS2 + c0, kRowChunk, D, p.norm_mlp, p.eps);
        __syncthreads();
        block_mm<16>(HN, D, kRowChunk, D, p.w_in, 2 * F, 2 * F, [&](int m, int n, float acc) {
            VG[m * 2 * F + n] = acc + to_f(p.b_in[n]);
        });
        __syncthreads();
        for (int i = threadIdx.x; i < kRowChunk * D; i += blockDim.x) {
            const int m = c0 + i / D;
            HN[i] = m == M - 1 ? 0.f : to_f(ge[(size_t)m * D + i % D]);
        }
        __syncthreads();
        block_mm<16>(HN, D, kRowChunk, D, p.w_ffn_out_t, F, F, [&](int m, int j, float dfh) {
            const float v = VG[m * 2 * F + j], s = sigmoidf_(VG[m * 2 * F + F + j]);
            VG[m * 2 * F + j] = rnd<T>(dfh * s);
            VG[m * 2 * F + F + j] = rnd<T>(dfh * v * s * (1.f - s));
        });
        __syncthreads();
        block_mm<16>(VG, 2 * F, kRowChunk, 2 * F, p.w_in_t, D, D, [&](int m, int n, float acc) {
            HN[m * D + n] = acc;
        });
        __syncthreads();
        for (int r = warp; r < kRowChunk; r += nw) {
            const int m = c0 + r;
            float* x2 = RES + m * D;
            const float r2 = RS2[m];
            const float s = rms_bwd_sum<T>(x2, HN + r * D, r2, p.norm_mlp, D, lane);
            const float c = r2 * r2 * s / D;
            for (int k = lane; k < D; k += 32) {
                const float g_eo = m == M - 1 ? 0.f : to_f(ge[(size_t)m * D + k]);
                const float gs = HN[r * D + k] * r2 * to_f(p.norm_mlp[k]);
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
    float* DAT = X;
    block_mm<16>(SCR, D, M, D, p.w_out_t, D, D, [&](int m, int n, float acc) { DAT[m * D + n] = acc; });
    __syncthreads();

    // ---- attention backward, one head at a time ---------------------------
    float* E = SCR;             // exp(s - max) / sum cf exp(s - max)   (M x LP)
    float* Tm = E + M * LP;     // dP, then E * (dP - delta)            (M x LP)
    float* DQ = Tm + M * LP;    // (M, hd): dq of this head
    for (int h = 0; h < H; ++h) {
        float* qh = QKV + h * hd;
        float* kh = QKV + D + h * hd;
        float* vh = QKV + 2 * D + h * hd;
        smem_abt(qh, LQ, kh, LQ, M, M, hd, [&](int q, int k, float s) { E[q * LP + k] = s * p.scale; });
        __syncthreads();
        cf_softmax_rows(E, LP, CF, M);
        smem_abt(DAT + h * hd, D, vh, LQ, M, M, hd, [&](int q, int k, float s) { Tm[q * LP + k] = s; });
        __syncthreads();
        for (int q = warp; q < M; q += nw) {
            float delta = 0.f;
            for (int k = lane; k < M; k += 32) delta = fmaf(CF[k] * E[q * LP + k], Tm[q * LP + k], delta);
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
        smem_awb(Tm, LP, CF, kh, LQ, M, hd, M, [&](int q, int d, float s) { DQ[q * hd + d] = s * p.scale; });
        smem_atb(E, LP, DAT + h * hd, D, M, hd, M,
                 [&](int k, int d, float s) { vh[k * LQ + d] = rnd<T>(s * CF[k]); });
        __syncthreads();
        // dk[k] = scale cf_k sum_q T[q, k] q_q (q still intact), then dq -> q
        smem_atb(Tm, LP, qh, LQ, M, hd, M,
                 [&](int k, int d, float s) { kh[k * LQ + d] = rnd<T>(s * p.scale * CF[k]); });
        __syncthreads();
        for (int idx = threadIdx.x; idx < M * hd; idx += blockDim.x)
            qh[(idx / hd) * LQ + idx % hd] = rnd<T>(DQ[idx]);
        __syncthreads();
    }

    // ---- QKV + norm_attn backward -> d_tokens -----------------------------
    float* DN1 = X;
    block_mm<16>(QKV, LQ, M, 3 * D, p.w_qkv_t, D, D, [&](int m, int n, float acc) { DN1[m * D + n] = acc; });
    __syncthreads();
    // the tokens are read again from global memory (same values as X held)
    T* d_edges = p.d_edges + a * M * D;
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
                p.d_center[a * D + k] = from_f<T>(dt);
                d_edges[m * D + k] = from_f<T>(0.f);
            } else {
                d_edges[m * D + k] = from_f<T>(dt);
            }
        }
    }
    for (int k = threadIdx.x; k < M; k += blockDim.x) p.d_cf[a * M + k] = DCF[k];
}

template <typename T>
int launch(const LayerBwdArgs<T>& p, long long A, cudaStream_t stream) {
    const size_t bytes = smem_floats(p.M, p.D, p.H, p.F) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fused_layer_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    fused_layer_bwd_kernel<T><<<(unsigned)A, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mtt

extern "C" size_t mtt_fused_layer_bwd_smem(int M, int D, int H, int F) {
    return mtt::smem_floats(M, D, H, F) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error code (0 = ok).
extern "C" int mtt_fused_layer_bwd(
    int dtype, const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* norm_mlp,
    const void* w_in, const void* b_in,
    const void* w_qkv_t, const void* w_out_t, const void* w_in_t, const void* w_ffn_out_t,
    const void* g_edge, const void* g_center,
    void* d_edges, void* d_center, float* d_cf,
    long long A, int M, int D, int H, int F, float scale, float eps, void* stream) {
#define MTT_ARGS(T)                                                                      \
    mtt::LayerBwdArgs<T>{(const T*)edges, (const T*)center, cf, (const T*)norm_attn,     \
                         (const T*)w_qkv, (const T*)b_qkv, (const T*)w_out,              \
                         (const T*)b_out, (const T*)norm_mlp, (const T*)w_in,            \
                         (const T*)b_in, (const T*)w_qkv_t, (const T*)w_out_t,           \
                         (const T*)w_in_t, (const T*)w_ffn_out_t, (const T*)g_edge,      \
                         (const T*)g_center, (T*)d_edges, (T*)d_center, d_cf,            \
                         M, D, H, F, scale, eps}
    if (A == 0) return 0;
    if (dtype == 0) return mtt::launch(MTT_ARGS(float), A, (cudaStream_t)stream);
    return mtt::launch(MTT_ARGS(__nv_bfloat16), A, (cudaStream_t)stream);
#undef MTT_ARGS
}
