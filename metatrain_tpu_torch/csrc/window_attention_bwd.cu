// Window attention, backward: dq, dk, dv (compute dtype) and dbias (float32)
// of out = softmax(q_h k_h^T * scale + bias) v_h, given the cotangent g of
// out.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/attention.py
// `_attention_bwd_kernel` (behind `_make_bwd_op` / `window_attention`'s
// custom VJP; `_attention_bwd_kernel_mexp` is the same function in the
// TPU's matrix layout). As there, nothing of the forward is saved: the
// softmax is recomputed from q, k and the bias, with the row max
// subtracted, and every product runs in float on values of the compute
// dtype (the cotangent is not rounded):
//   w = softmax(s), dw[t, u] = g[t] . v[u], ds = w * (dw - sum_u w dw),
//   dq = scale ds k, dk = scale ds^T q, dv = w^T g, dbias[u] = sum_h,t ds.
//
// What bounds it on the H100: at T = 65, D = 128, 8 heads of 16 the function
// reads q, k, v, g and the bias and writes dq, dk, dv and dbias once (bytes,
// in bf16) and needs 5 products of 1.1 MFLOP each per window (about even
// with bytes in f32 off the tensor cores). One block per window, in two
// phases, so that no thread or warp ever sums across another:
// - rows: per (head, query row or tile), with the keys staged in shared
//   memory: the row's max m and denominator l, delta = sum_u w dw, and dq;
//   (m, l, delta) are left in shared memory;
// - columns: per (head, key or key tile), w[t, u] recomputed from (m, l):
//   dv, dk and the head's dbias summed over the queries. The heads' dbias
//   partials are then added in head order, so dbias is the same in every
//   run.
// Two kernels: bf16 with heads of 16 (the served shape) on tensor cores,
// one warp per (head, 16-row tile); otherwise float on the CUDA cores, one
// thread per (head, row), with q and g replacing k and v in shared memory
// between the phases (its operations bound it); a head of a width other
// than 8, 16, 32 or 64 (up to 64) is padded with zero columns in registers
// and in the staged rows, as the forward's. T is odd (65 at the
// served shapes): the tensor-core kernel pads to whole tiles with zero
// rows and bias -inf, the float kernel needs no tiles. Both take ex2.approx
// exponentials (__expf) and divide once per row.
#include "attention.cuh"

namespace mtt {
namespace {

template <int HD>
constexpr int bwd_max_threads() { return HD <= 8 ? 1024 : (HD <= 16 ? 640 : (HD <= 32 ? 320 : 256)); }

// HD: the register width of a head (head_regs(hd)); the staged rows are DP
// = H HD floats.
template <typename T, int HD>
__global__ void __launch_bounds__(bwd_max_threads<HD>()) window_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ g,
    int ldq, int ldk, int ldv, int ldg, const float* __restrict__ bias, T* __restrict__ dq,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dbias, int Tn, int D, int H,
    float scale) {
    extern __shared__ __align__(16) float smem[];
    const int hd = D / H, DP = H * HD;
    float* X = smem;               // k, then q
    float* Y = X + Tn * DP;        // v, then g
    float* B = Y + Tn * DP;        // bias
    float* RM = B + Tn;            // per (h, t): row max
    float* RL = RM + H * Tn;       // 1 / row denominator
    float* RD = RL + H * Tn;       // delta = sum_u w dw
    float* DB = RD + H * Tn;       // per (h, u): the head's dbias
    const long long a = blockIdx.x;
    const int items = H * Tn;
    stage_heads(X, k + a * Tn * ldk, ldk, Tn, H, hd, HD);
    stage_heads(Y, v + a * Tn * ldv, ldv, Tn, H, hd, HD);
    for (int u = threadIdx.x; u < Tn; u += blockDim.x) B[u] = bias[a * Tn + u];
    __syncthreads();

    // rows
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
        const int h = item / Tn, t = item - h * Tn;
        float qr[HD], gr[HD], acc[HD];
        load_head<HD>(q + (a * Tn + t) * ldq + h * hd, hd, qr);
        load_head<HD>(g + (a * Tn + t) * ldg + h * hd, hd, gr);
        const float* Kh = X + h * HD;
        const float* Vh = Y + h * HD;
        float m = -INFINITY;
        for (int u = 0; u < Tn; ++u) m = fmaxf(m, dot_row(qr, Kh + u * DP) * scale + B[u]);
        float l = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = 0.f;
        for (int u = 0; u < Tn; ++u) {
            const float e = __expf(dot_row(qr, Kh + u * DP) * scale + B[u] - m);
            l += e;
            const float* vr = Vh + u * DP;
#pragma unroll
            for (int d = 0; d < HD; ++d) acc[d] = fmaf(e, vr[d], acc[d]);
        }
        float delta = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) delta = fmaf(gr[d], acc[d], delta);
        l = 1.f / l;
        delta *= l;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = 0.f;
        for (int u = 0; u < Tn; ++u) {
            const float w = __expf(dot_row(qr, Kh + u * DP) * scale + B[u] - m) * l;
            const float ds = w * (dot_row(gr, Vh + u * DP) - delta);
            const float* kr = Kh + u * DP;
#pragma unroll
            for (int d = 0; d < HD; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
        }
        store_head<HD>(dq + (a * Tn + t) * D + h * hd, hd, acc, scale);
        RM[item] = m;
        RL[item] = l;
        RD[item] = delta;
    }
    __syncthreads();
    stage_heads(X, q + a * Tn * ldq, ldq, Tn, H, hd, HD);
    stage_heads(Y, g + a * Tn * ldg, ldg, Tn, H, hd, HD);
    __syncthreads();

    // columns
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
        const int h = item / Tn, u = item - h * Tn;
        float kr[HD], vr[HD], ak[HD], av[HD];
        load_head<HD>(k + (a * Tn + u) * ldk + h * hd, hd, kr);
        load_head<HD>(v + (a * Tn + u) * ldv + h * hd, hd, vr);
#pragma unroll
        for (int d = 0; d < HD; ++d) ak[d] = av[d] = 0.f;
        const float* Qh = X + h * HD;
        const float* Gh = Y + h * HD;
        const float bu = B[u];
        float db = 0.f;
        for (int t = 0; t < Tn; ++t) {
            const int row = h * Tn + t;
            const float* qt = Qh + t * DP;
            const float* gt = Gh + t * DP;
            const float w = __expf(dot_row(qt, kr) * scale + bu - RM[row]) * RL[row];
            const float ds = w * (dot_row(gt, vr) - RD[row]);
            db += ds;
#pragma unroll
            for (int d = 0; d < HD; ++d) {
                av[d] = fmaf(w, gt[d], av[d]);
                ak[d] = fmaf(ds, qt[d], ak[d]);
            }
        }
        store_head<HD>(dk + (a * Tn + u) * D + h * hd, hd, ak, scale);
        store_head<HD>(dv + (a * Tn + u) * D + h * hd, hd, av, 1.f);
        DB[item] = db;
    }
    __syncthreads();
    for (int u = threadIdx.x; u < Tn; u += blockDim.x) {
        float s = 0.f;
        for (int h = 0; h < H; ++h) s += DB[h * Tn + u];
        dbias[a * Tn + u] = s;
    }
}

size_t smem_bytes(int Tn, int D, int H) {
    return (2 * (size_t)Tn * H * head_regs(D / H) + Tn + 4 * (size_t)H * Tn) * sizeof(float);
}

// bf16, head width 16, T <= 16 KT: tensor cores, the same two phases with
// one warp per (head, 16-row tile) and q, k, v, g staged as bf16 windows of
// 16 KT rows (zero rows past T; keys past T get bias -inf):
// - rows (query tile): S = Q K^T, the softmax w, dP = G V^T, delta =
//   sum_u w dP, dS = w (dP - delta), dq = scale dS K;
// - columns (key tile): S^T = K Q^T, w^T from the rows' (m, l), dP^T =
//   V G^T, dS^T, dv = w^T G, dk = scale dS^T Q and the head's dbias.
// Q, K, V and G are bf16 values, so S and dP are exact products summed in
// float; w and dS are float and enter their products split into two bf16
// halves (mma_split), which keeps ~16 bits of them. The exponentials are
// ex2.approx (__expf) and each row divides once: instructions, not products
// or bytes, bound this kernel.
constexpr int kTcThreads = 256;

template <int KT>
__global__ void __launch_bounds__(kTcThreads) window_attention_bwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g, int ldq, int ldk,
    int ldv, int ldg, const float* __restrict__ bias, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, float* __restrict__ dbias,
    int Tn, int D, int H, float scale) {
    extern __shared__ __align__(16) float smem[];
    constexpr int TP = 16 * KT, NT = 2 * KT;
    const int LD = tc_stride(D);
    float* B = smem;             // bias, -inf past T
    float* RM = B + TP;          // per (h, query): row max
    float* RL = RM + H * TP;     // 1 / row denominator
    float* RD = RL + H * TP;     // delta
    float* DB = RD + H * TP;     // per (h, key): the head's dbias
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(DB + H * TP);
    __nv_bfloat16* Ks = Qs + TP * LD;
    __nv_bfloat16* Vs = Ks + TP * LD;
    __nv_bfloat16* Gs = Vs + TP * LD;
    const long long a = blockIdx.x;
    stage_window_bf16(Qs, LD, q + a * Tn * ldq, ldq, Tn, TP, D);
    stage_window_bf16(Ks, LD, k + a * Tn * ldk, ldk, Tn, TP, D);
    stage_window_bf16(Vs, LD, v + a * Tn * ldv, ldv, Tn, TP, D);
    stage_window_bf16(Gs, LD, g + a * Tn * ldg, ldg, Tn, TP, D);
    for (int u = threadIdx.x; u < TP; u += blockDim.x) B[u] = u < Tn ? bias[a * Tn + u] : -INFINITY;
    __syncthreads();

    const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
    const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;

    // rows: accumulator element i of tile nt is (query r0 + gr + 8 (i >> 1),
    // key nt * 8 + 2t + (i & 1))
    for (int task = warp; task < H * KT; task += warps) {
        const int h = task / KT, r0 = (task - h * KT) * 16, c = h * 16;
        uint32_t qa[4], ga[4];
        frag_a(qa, Qs + r0 * LD + c, LD);
        frag_a(ga, Gs + r0 * LD + c, LD);
        float S[NT][4], P[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            uint32_t kb[2], vb[2];
            frag_b_rows(kb, Ks + nt * 8 * LD + c, LD);
            frag_b_rows(vb, Vs + nt * 8 * LD + c, LD);
#pragma unroll
            for (int i = 0; i < 4; ++i) S[nt][i] = P[nt][i] = 0.f;
            mma_16816(S[nt], qa, kb);
            mma_16816(P[nt], ga, vb);  // dP = G V^T
        }
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                S[nt][i] = S[nt][i] * scale + B[nt * 8 + 2 * t + (i & 1)];
                m[i >> 1] = fmaxf(m[i >> 1], S[nt][i]);
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                S[nt][i] = __expf(S[nt][i] - m[i >> 1]);
                l[i >> 1] += S[nt][i];
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = 1.f / quad_sum(l[r]);  // 1 / denominator
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                S[nt][i] *= l[i >> 1];  // w
                delta[i >> 1] = fmaf(S[nt][i], P[nt][i], delta[i >> 1]);
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) delta[r] = quad_sum(delta[r]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) S[nt][i] *= P[nt][i] - delta[i >> 1];  // dS

        float O[2][4] = {};
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
            for (int dn = 0; dn < 2; ++dn) {
                uint32_t kb[2];
                frag_b_cols(kb, Ks + j * 16 * LD + c + dn * 8, LD);
                mma_split(O[dn], S[2 * j], S[2 * j + 1], kb);
            }
#pragma unroll
        for (int dn = 0; dn < 2; ++dn)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = r0 + gr + 8 * half;
                if (row < Tn)
                    *reinterpret_cast<__nv_bfloat162*>(dq + (a * Tn + row) * D + c + dn * 8 + 2 * t) =
                        __floats2bfloat162_rn(O[dn][2 * half] * scale, O[dn][2 * half + 1] * scale);
            }
        if (t == 0)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = h * TP + r0 + gr + 8 * half;
                RM[row] = m[half];
                RL[row] = l[half];
                RD[row] = delta[half];
            }
    }
    __syncthreads();

    // columns: accumulator element i of tile nt is (key k0 + gr + 8 (i >> 1),
    // query nt * 8 + 2t + (i & 1))
    for (int task = warp; task < H * KT; task += warps) {
        const int h = task / KT, k0 = (task - h * KT) * 16, c = h * 16;
        uint32_t ka[4], va[4];
        frag_a(ka, Ks + k0 * LD + c, LD);
        frag_a(va, Vs + k0 * LD + c, LD);
        float S[NT][4], P[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            uint32_t qb[2], gb[2];
            frag_b_rows(qb, Qs + nt * 8 * LD + c, LD);
            frag_b_rows(gb, Gs + nt * 8 * LD + c, LD);
#pragma unroll
            for (int i = 0; i < 4; ++i) S[nt][i] = P[nt][i] = 0.f;
            mma_16816(S[nt], ka, qb);  // S^T = K Q^T
            mma_16816(P[nt], va, gb);  // dP^T = V G^T
        }
        const float bk[2] = {B[k0 + gr], B[k0 + gr + 8]};
        float db[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int row = h * TP + nt * 8 + 2 * t + (i & 1);
                const float w = __expf(S[nt][i] * scale + bk[i >> 1] - RM[row]) * RL[row];
                S[nt][i] = w;
                P[nt][i] = w * (P[nt][i] - RD[row]);  // dS^T
                db[i >> 1] += P[nt][i];
            }
        float OK[2][4] = {}, OV[2][4] = {};
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
            for (int dn = 0; dn < 2; ++dn) {
                uint32_t qb[2], gb[2];
                frag_b_cols(qb, Qs + j * 16 * LD + c + dn * 8, LD);
                frag_b_cols(gb, Gs + j * 16 * LD + c + dn * 8, LD);
                mma_split(OV[dn], S[2 * j], S[2 * j + 1], gb);
                mma_split(OK[dn], P[2 * j], P[2 * j + 1], qb);
            }
#pragma unroll
        for (int dn = 0; dn < 2; ++dn)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int key = k0 + gr + 8 * half;
                if (key < Tn) {
                    const long long o = (a * Tn + key) * D + c + dn * 8 + 2 * t;
                    *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(
                        OK[dn][2 * half] * scale, OK[dn][2 * half + 1] * scale);
                    *reinterpret_cast<__nv_bfloat162*>(dv + o) =
                        __floats2bfloat162_rn(OV[dn][2 * half], OV[dn][2 * half + 1]);
                }
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) db[r] = quad_sum(db[r]);
        if (t == 0) {
            DB[h * TP + k0 + gr] = db[0];
            DB[h * TP + k0 + gr + 8] = db[1];
        }
    }
    __syncthreads();
    for (int u = threadIdx.x; u < Tn; u += blockDim.x) {
        float sum = 0.f;
        for (int h = 0; h < H; ++h) sum += DB[h * TP + u];
        dbias[a * Tn + u] = sum;
    }
}

size_t tc_smem_bytes(int KT, int D, int H) {
    const size_t TP = 16 * (size_t)KT;
    return (TP + 4 * H * TP) * sizeof(float) + 4 * TP * tc_stride(D) * sizeof(__nv_bfloat16);
}

template <int KT>
int launch_tc(const void* q, const void* k, const void* v, const void* g, int ldq, int ldk,
              int ldv, int ldg, const float* bias, void* dq, void* dk, void* dv, float* dbias,
              long long A, int Tn, int D, int H, float scale, cudaStream_t stream) {
    const size_t bytes = tc_smem_bytes(KT, D, H);
    auto kernel = window_attention_bwd_tc_kernel<KT>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    using bf = __nv_bfloat16;
    kernel<<<(unsigned)A, kTcThreads, bytes, stream>>>(
        (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)g, ldq, ldk, ldv, ldg, bias, (bf*)dq,
        (bf*)dk, (bf*)dv, dbias, Tn, D, H, scale);
    return (int)cudaGetLastError();
}

int dispatch_tc(const void* q, const void* k, const void* v, const void* g, int ldq, int ldk,
                int ldv, int ldg, const float* bias, void* dq, void* dk, void* dv, float* dbias,
                long long A, int Tn, int D, int H, float scale, cudaStream_t s) {
#define MTT_TC(KT) \
    launch_tc<KT>(q, k, v, g, ldq, ldk, ldv, ldg, bias, dq, dk, dv, dbias, A, Tn, D, H, scale, s)
    switch ((Tn + 15) / 16) {
        case 1: return MTT_TC(1);
        case 2: return MTT_TC(2);
        case 3: return MTT_TC(3);
        case 4: return MTT_TC(4);
        case 5: return MTT_TC(5);
        case 6: return MTT_TC(6);
        case 7: return MTT_TC(7);
        case 8: return MTT_TC(8);
    }
#undef MTT_TC
    return (int)cudaErrorInvalidValue;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* g, int ldq, int ldk, int ldv,
           int ldg, const float* bias, void* dq, void* dk, void* dv, float* dbias, long long A,
           int Tn, int D, int H, float scale, cudaStream_t stream) {
    const size_t bytes = smem_bytes(Tn, D, H);
    auto kernel = window_attention_bwd_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int threads = attention_threads(H * Tn, bwd_max_threads<HD>());
    kernel<<<(unsigned)A, threads, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)g, ldq, ldk, ldv, ldg, bias, (T*)dq,
        (T*)dk, (T*)dv, dbias, Tn, D, H, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, const void* g, int ldq, int ldk,
             int ldv, int ldg, const float* bias, void* dq, void* dk, void* dv, float* dbias,
             long long A, int Tn, int D, int H, float scale, cudaStream_t s) {
#define MTT_LAUNCH(HD) \
    launch<T, HD>(q, k, v, g, ldq, ldk, ldv, ldg, bias, dq, dk, dv, dbias, A, Tn, D, H, scale, s)
    switch (head_regs(hd)) {
        case 8: return MTT_LAUNCH(8);
        case 16: return MTT_LAUNCH(16);
        case 32: return MTT_LAUNCH(32);
        case 64: return MTT_LAUNCH(64);
    }
#undef MTT_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mtt

extern "C" int mtt_window_attention_tc(int dtype, int T, int D, int H);

extern "C" size_t mtt_window_attention_bwd_smem(int dtype, int T, int D, int H) {
    return mtt_window_attention_tc(dtype, T, D, H) ? mtt::tc_smem_bytes((T + 15) / 16, D, H)
                                                    : mtt::smem_bytes(T, D, H);
}

// dtype: 0 = float32, 1 = bfloat16. q, k, v, g: (A, T, ld*) with rows ld*
// elements apart (windows T * ld* apart), any head width D / H up to 64;
// bias (A, T) float32. dq, dk, dv: (A, T, D) contiguous; dbias (A, T)
// float32. Returns the CUDA error code.
extern "C" int mtt_window_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* g, int ldq, int ldk,
    int ldv, int ldg, const float* bias, void* dq, void* dk, void* dv, float* dbias, long long A,
    int T, int D, int H, float scale, void* stream) {
    if (A == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return mtt::dispatch<float>(D / H, q, k, v, g, ldq, ldk, ldv, ldg, bias, dq, dk, dv, dbias,
                                    A, T, D, H, scale, s);
    if (mtt_window_attention_tc(dtype, T, D, H))
        return mtt::dispatch_tc(q, k, v, g, ldq, ldk, ldv, ldg, bias, dq, dk, dv, dbias, A, T, D,
                                H, scale, s);
    return mtt::dispatch<__nv_bfloat16>(D / H, q, k, v, g, ldq, ldk, ldv, ldg, bias, dq, dk, dv,
                                        dbias, A, T, D, H, scale, s);
}
