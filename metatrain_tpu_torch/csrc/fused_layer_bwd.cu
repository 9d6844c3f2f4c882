// K2: fused PET transformer layer, backward; K2-dW, its weight-gradient
// variant.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/fused_layer.py
// `_bwd_kernel` (entered through `_make_bwd_op` / `_fused_bwd`, body
// `_layer_bwd_math`): the layer is recomputed per atom, then
// back-propagated to d_edges (slot M-1 zero), d_center and d_cf (float).
// Forces need d_cf: the cutoff weights depend on the positions. K2 is the
// `weight_grads=False` variant (force calls); K2-dW (DW = true) is the
// `weight_grads=True` one (training): it also sums over atoms the float
// gradients of the 10 layer weights.
//
// What bounds it on the H100: about twice the forward's FLOPs on the same
// per-atom activations, and shared memory. One block per atom (K2) keeps
// the tokens, q/k/v (overwritten head by head with dq/dk/dv), the attention
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
//
// K2-dW adds the four X^T dY products (w_qkv, w_out, w_in, w_ffn_out: as
// many FLOPs again as the forward's products), the bias column sums and
// the two RMSNorm scale sums, and 661 KB of float gradients (D=128,
// F=256) per atom to accumulate. One partial per atom would be ~7.5 GB,
// and atomics would sum in an order that changes from run to run. So
// K2-dW runs a fixed grid of one block per SM; each block walks a
// contiguous range of atoms and adds each atom's products into its own
// float partial in global memory (common.cuh accum_atb: every element
// always updated by the same thread), and a second pass adds the partials
// in block order: the same sum in every run. The products read operands
// the backward already holds in shared memory: the attention output is
// kept in the token buffer (free after the residual), the SwiGLU chunk
// gets two more 16-row buffers (g_eo and the gated activation, so that
// h_norm survives until d_vg exists; 231 KB at M=64), and the normed
// tokens are recomputed at the end into the free scratch. The products
// run on FMA register tiles in both dtypes; the partials' traffic
// (2 x 661 KB per atom, mostly L2) is the price of determinism here.

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
    float* partials;       // K2-dW: (gridDim.x, n_dw) per-block weight gradients
    long long A;
    int M, D, H, F;
    float scale, eps;
};

__host__ __device__ inline int qkv_stride(int D) { return 3 * D + 4; }

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
// M x (M + 1); dq: M x hd), whichever is largest.
__host__ __device__ inline size_t scratch_floats(int M, int D, int H, int F, bool dw) {
    const size_t ffn = (size_t)kRowChunk * (D + 2 * F + (dw ? D + F : 0));
    const size_t att = 2 * (size_t)M * (M + 1) + (size_t)M * (D / H);
    const size_t rows = (size_t)M * D;
    const size_t big = ffn > att ? ffn : att;
    return big > rows ? big : rows;
}

__host__ __device__ inline size_t smem_floats(int M, int D, int H, int F, bool dw) {
    return 2 * (size_t)M * D + (size_t)M * qkv_stride(D) + scratch_floats(M, D, H, F, dw) + 4 * (size_t)M;
}

// d_x of y = rnd(x * r * w) given dy, for one row (one warp): returns the
// row sum s = sum(gs * x) with gs = dy * r * w, so d_x = gs - x r^2 s / D.
template <typename T>
__device__ __forceinline__ float rms_bwd_sum(const float* x, const float* dy, float r, const T* w, int D, int lane) {
    float s = 0.f;
    for (int k = lane; k < D; k += 32) s = fmaf(dy[k] * r * to_f(w[k]), x[k], s);
    return warp_sum(s);
}

// One atom's backward; with DW, its weight gradients are added to the
// block's partial P.
template <typename T, bool DW>
__device__ void layer_bwd_atom(const LayerBwdArgs<T>& p, long long a, float* smem, float* P) {
    const int M = p.M, D = p.D, F = p.F, H = p.H, hd = D / H;
    const int LQ = qkv_stride(D), LP = M + 1;  // M < D: the scores fit in RES
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const DwLayout L(D, F);

    float* X = smem;              // tokens, later attn (DW), d_attn, d_n1
    float* QKV = X + M * D;       // q|k|v, then dq|dk|dv
    float* RES = QKV + M * LQ;    // one head's softmax, then res, then d_res
    float* SCR = RES + M * D;     // n1, attn, SwiGLU chunk, d_attn_out, attention bwd, n1 (DW)
    float* RS1 = SCR + scratch_floats(M, D, H, F, DW);
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
        rmsnorm_rows<T>(RES + c0 * D, HN, RS2 + c0, kRowChunk, D, p.norm_mlp, p.eps);
        __syncthreads();
        block_mm<16>(HN, D, kRowChunk, D, p.w_in, 2 * F, 2 * F, [&](int m, int n, float acc) {
            VG[m * 2 * F + n] = acc + to_f(p.b_in[n]);
        });
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

// K2: one block per atom. K2-dW: a fixed grid, block b walks atoms
// [b A / grid, (b + 1) A / grid) and sums their weight gradients into
// partial b.
template <typename T, bool DW>
__global__ void __launch_bounds__(kThreads) fused_layer_bwd_kernel(LayerBwdArgs<T> p) {
    extern __shared__ __align__(16) float smem[];
    if constexpr (!DW) {
        layer_bwd_atom<T, false>(p, blockIdx.x, smem, nullptr);
    } else {
        const long long total = DwLayout(p.D, p.F).total;
        float* P = p.partials + blockIdx.x * total;
        zero_floats(P, total);
        __syncthreads();
        const long long a0 = p.A * blockIdx.x / gridDim.x, a1 = p.A * (blockIdx.x + 1) / gridDim.x;
        for (long long a = a0; a < a1; ++a) {
            layer_bwd_atom<T, true>(p, a, smem, P);
            __syncthreads();
        }
    }
}

template <typename T, bool DW>
int launch(const LayerBwdArgs<T>& p, unsigned grid, cudaStream_t stream) {
    const size_t bytes = smem_floats(p.M, p.D, p.H, p.F, DW) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fused_layer_bwd_kernel<T, DW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    fused_layer_bwd_kernel<T, DW><<<grid, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const LayerBwdArgs<T>& p, int dw_blocks, float* dw, cudaStream_t stream) {
    if (dw == nullptr) return launch<T, false>(p, (unsigned)p.A, stream);
    const int err = launch<T, true>(p, (unsigned)dw_blocks, stream);
    if (err != 0) return err;
    return launch_sum_partials(p.partials, dw_blocks, DwLayout(p.D, p.F).total, dw, stream);
}

}  // namespace
}  // namespace mtt

extern "C" size_t mtt_fused_layer_bwd_smem(int M, int D, int H, int F, int dw) {
    return mtt::smem_floats(M, D, H, F, dw != 0) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. dw == nullptr launches K2; otherwise
// K2-dW with dw_blocks blocks, partials (dw_blocks, n_dw) floats of
// scratch, and dw (n_dw floats, LayerWeights order) receiving the weight
// gradients. Returns the CUDA error code (0 = ok).
extern "C" int mtt_fused_layer_bwd(
    int dtype, const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* norm_mlp,
    const void* w_in, const void* b_in,
    const void* w_qkv_t, const void* w_out_t, const void* w_in_t, const void* w_ffn_out_t,
    const void* g_edge, const void* g_center,
    void* d_edges, void* d_center, float* d_cf,
    float* partials, int dw_blocks, float* dw,
    long long A, int M, int D, int H, int F, float scale, float eps, void* stream) {
#define MTT_ARGS(T)                                                                      \
    mtt::LayerBwdArgs<T>{(const T*)edges, (const T*)center, cf, (const T*)norm_attn,     \
                         (const T*)w_qkv, (const T*)b_qkv, (const T*)w_out,              \
                         (const T*)b_out, (const T*)norm_mlp, (const T*)w_in,            \
                         (const T*)b_in, (const T*)w_qkv_t, (const T*)w_out_t,           \
                         (const T*)w_in_t, (const T*)w_ffn_out_t, (const T*)g_edge,      \
                         (const T*)g_center, (T*)d_edges, (T*)d_center, d_cf, partials,  \
                         A, M, D, H, F, scale, eps}
    if (A == 0) return dw == nullptr ? 0 : (int)cudaMemsetAsync(dw, 0, mtt::DwLayout(D, F).total * sizeof(float), (cudaStream_t)stream);
    if (dtype == 0) return mtt::dispatch(MTT_ARGS(float), dw_blocks, dw, (cudaStream_t)stream);
    return mtt::dispatch(MTT_ARGS(__nv_bfloat16), dw_blocks, dw, (cudaStream_t)stream);
#undef MTT_ARGS
}
