// Window attention, forward: out = softmax(q_h k_h^T * scale + bias) v_h per
// head h, over each atom's window of T tokens.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/attention.py
// `_attention_fwd_kernel` (behind `_fwd_impl` / `window_attention`; its
// `_attention_fwd_kernel_mexp` variant computes the same function in a
// layout that suits the TPU's matrix unit). The bias is additive, the same
// for every query and head: PET's log(clip(cutoff, 1e-15)), so padded keys
// keep a weight of ~1e-15 relative to the others; no -inf mask. Each row
// subtracts its max before the exponential, as the TPU kernel does.
//
// What bounds it on the H100: at T = 65, D = 128, 8 heads of 16 the function
// reads q, k, v and the bias and writes out once, and needs ~2.2 MFLOP per
// window: ~32 FLOP per byte in bf16, far below the 295 of the tensor cores,
// so its bound is bytes (bf16) and, in f32 at 67 TFLOP/s off the tensor
// cores, about even. T is odd (the center token leads the window), so no
// tile of 8 or 16 divides it. Two kernels:
// - bf16 with heads of 16 (the served shape): tensor cores (mma.sync
//   m16n8k16). One block per window stages q, k and v as bf16, padded to
//   whole 16-row tiles (zero rows, bias -inf for the padded keys); one warp
//   per (head, 16-query tile) forms its scores with one k-step per key
//   tile, takes the row softmax on the accumulators (a row lives in one
//   quad of lanes) and multiplies the weights, rounded to bf16 as the plain
//   version rounds them, with v.
// - otherwise (f32, other head widths): float on the CUDA cores. One block
//   per window stages k and v as float (67 KB at T = 65, three blocks per
//   SM); one thread per (head, query row) keeps its q row and its output row
//   in registers and walks over the keys three times (row max; softmax
//   denominator; weights, rounded to bf16, times values); the keys of a
//   warp's rows are
//   shared-memory broadcasts. Its operations bound it. In float the
//   denominator and the weights times values share one pass (no rounding
//   of the weights), so the keys are walked twice. The registers hold 8,
//   16, 32 or 64 columns: a head of another width up to 64 (12, 24, ...)
//   is padded with zero columns, in the registers and in the staged k and
//   v rows (H x 64 floats per row at most), which add exact zeros.
// Both subtract each row's max before the exponential, as the TPU kernel
// does, and take ex2.approx exponentials (__expf) and one division per row.
// Next step: several windows per block.

#include "attention.cuh"

namespace mtt {
namespace {

template <int HD>
constexpr int fwd_max_threads() { return HD <= 16 ? 1024 : HD <= 32 ? 512 : 256; }

// HD: the register width of a head (head_regs(hd)); the staged rows are DP
// = H HD floats.
template <typename T, int HD>
__global__ void __launch_bounds__(fwd_max_threads<HD>()) window_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, int ldq, int ldk,
    int ldv, const float* __restrict__ bias, T* __restrict__ out, int Tn, int D, int H,
    float scale) {
    extern __shared__ __align__(16) float smem[];
    const int hd = D / H, DP = H * HD;
    float* K = smem;
    float* V = K + Tn * DP;
    float* B = V + Tn * DP;
    const long long a = blockIdx.x;
    stage_heads(K, k + a * Tn * ldk, ldk, Tn, H, hd, HD);
    stage_heads(V, v + a * Tn * ldv, ldv, Tn, H, hd, HD);
    for (int u = threadIdx.x; u < Tn; u += blockDim.x) B[u] = bias[a * Tn + u];
    __syncthreads();

    for (int item = threadIdx.x; item < H * Tn; item += blockDim.x) {
        const int h = item / Tn, t = item - h * Tn;
        float qr[HD], o[HD];
        load_head<HD>(q + (a * Tn + t) * ldq + h * hd, hd, qr);
        const float* Kh = K + h * HD;
        const float* Vh = V + h * HD;

        float m = -INFINITY;
        for (int u = 0; u < Tn; ++u) m = fmaxf(m, dot_row(qr, Kh + u * DP) * scale + B[u]);
#pragma unroll
        for (int d = 0; d < HD; ++d) o[d] = 0.f;
        float l = 0.f;
        if constexpr (std::is_same_v<T, float>) {
            // float weights need no rounding: the denominator and P V
            // share one pass
            for (int u = 0; u < Tn; ++u) {
                const float e = __expf(dot_row(qr, Kh + u * DP) * scale + B[u] - m);
                l += e;
                const float* vr = Vh + u * DP;
#pragma unroll
                for (int d = 0; d < HD; ++d) o[d] = fmaf(e, vr[d], o[d]);
            }
            store_head<HD>(out + (a * Tn + t) * D + h * hd, hd, o, 1.f / l);
        } else {
            for (int u = 0; u < Tn; ++u) l += __expf(dot_row(qr, Kh + u * DP) * scale + B[u] - m);
            const float inv = 1.f / l;
            for (int u = 0; u < Tn; ++u) {
                const float p = rnd<T>(__expf(dot_row(qr, Kh + u * DP) * scale + B[u] - m) * inv);
                const float* vr = Vh + u * DP;
#pragma unroll
                for (int d = 0; d < HD; ++d) o[d] = fmaf(p, vr[d], o[d]);
            }
            store_head<HD>(out + (a * Tn + t) * D + h * hd, hd, o, 1.f);
        }
    }
}

size_t smem_bytes(int Tn, int D, int H) {
    return (2 * (size_t)Tn * H * head_regs(D / H) + Tn) * sizeof(float);
}

// bf16, head width 16, T <= 16 KT: tensor cores. One warp per (head,
// 16-query tile): S = Q K^T over KT key tiles (2 KT mma, head width 16 is
// one k-step), the row softmax on the accumulators (a row's 2 KT x 2
// values per lane and its quad), the weights rounded to bf16, O = P V (2 KT
// mma). q, k and v are staged as bf16 windows of 16 KT rows (zero rows
// past T); keys past T get bias -inf. The exponentials are ex2.approx
// (__expf) and each row divides once: the weights are rounded to bf16
// anyway, and instructions, not products or bytes, bound this kernel.
constexpr int kTcThreads = 256;

template <int KT>
__global__ void __launch_bounds__(kTcThreads) window_attention_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, int ldq, int ldk, int ldv,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int Tn, int D, int H,
    float scale) {
    extern __shared__ __align__(16) float smem[];
    constexpr int TP = 16 * KT, NT = 2 * KT;
    const int LD = tc_stride(D);
    float* B = smem;
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(B + TP);
    __nv_bfloat16* Ks = Qs + TP * LD;
    __nv_bfloat16* Vs = Ks + TP * LD;
    const long long a = blockIdx.x;
    stage_window_bf16(Qs, LD, q + a * Tn * ldq, ldq, Tn, TP, D);
    stage_window_bf16(Ks, LD, k + a * Tn * ldk, ldk, Tn, TP, D);
    stage_window_bf16(Vs, LD, v + a * Tn * ldv, ldv, Tn, TP, D);
    for (int u = threadIdx.x; u < TP; u += blockDim.x) B[u] = u < Tn ? bias[a * Tn + u] : -INFINITY;
    __syncthreads();

    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    for (int task = threadIdx.x >> 5; task < H * KT; task += blockDim.x >> 5) {
        const int h = task / KT, r0 = (task - h * KT) * 16, c = h * 16;
        uint32_t qa[4];
        frag_a(qa, Qs + r0 * LD + c, LD);
        float S[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            uint32_t kb[2];
            frag_b_rows(kb, Ks + nt * 8 * LD + c, LD);
#pragma unroll
            for (int i = 0; i < 4; ++i) S[nt][i] = 0.f;
            mma_16816(S[nt], qa, kb);
        }
        // rows g (i = 0, 1) and g + 8 (i = 2, 3); keys nt * 8 + 2t (+1)
        float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                S[nt][i] = S[nt][i] * scale + B[nt * 8 + 2 * t + (i & 1)];
                m[i >> 1] = fmaxf(m[i >> 1], S[nt][i]);
            }
        float l[2] = {0.f, 0.f};
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
        for (int r = 0; r < 2; ++r) l[r] = 1.f / quad_sum(l[r]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) S[nt][i] *= l[i >> 1];  // rounded to bf16 below

        float O[2][4] = {};
#pragma unroll
        for (int j = 0; j < KT; ++j) {
            uint32_t pa[4];
            frag_a_from_acc(pa, S[2 * j], S[2 * j + 1]);
#pragma unroll
            for (int dn = 0; dn < 2; ++dn) {
                uint32_t vb[2];
                frag_b_cols(vb, Vs + j * 16 * LD + c + dn * 8, LD);
                mma_16816(O[dn], pa, vb);
            }
        }
#pragma unroll
        for (int dn = 0; dn < 2; ++dn)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = r0 + g + 8 * half;
                if (row < Tn)
                    *reinterpret_cast<__nv_bfloat162*>(out + (a * Tn + row) * D + c + dn * 8 + 2 * t) =
                        __floats2bfloat162_rn(O[dn][2 * half], O[dn][2 * half + 1]);
            }
    }
}

size_t tc_smem_bytes(int KT, int D) {
    const size_t TP = 16 * (size_t)KT;
    return TP * sizeof(float) + 3 * TP * tc_stride(D) * sizeof(__nv_bfloat16);
}

template <int KT>
int launch_tc(const void* q, const void* k, const void* v, int ldq, int ldk, int ldv,
              const float* bias, void* out, long long A, int Tn, int D, int H, float scale,
              cudaStream_t stream) {
    const size_t bytes = tc_smem_bytes(KT, D);
    auto kernel = window_attention_fwd_tc_kernel<KT>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)A, kTcThreads, bytes, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, ldq, ldk, ldv,
        bias, (__nv_bfloat16*)out, Tn, D, H, scale);
    return (int)cudaGetLastError();
}

int dispatch_tc(const void* q, const void* k, const void* v, int ldq, int ldk, int ldv,
                const float* bias, void* out, long long A, int Tn, int D, int H, float scale,
                cudaStream_t s) {
#define MTT_TC(KT) launch_tc<KT>(q, k, v, ldq, ldk, ldv, bias, out, A, Tn, D, H, scale, s)
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
int launch(const void* q, const void* k, const void* v, int ldq, int ldk, int ldv,
           const float* bias, void* out, long long A, int Tn, int D, int H, float scale,
           cudaStream_t stream) {
    const size_t bytes = smem_bytes(Tn, D, H);
    auto kernel = window_attention_fwd_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int threads = attention_threads(H * Tn, fwd_max_threads<HD>());
    kernel<<<(unsigned)A, threads, bytes, stream>>>((const T*)q, (const T*)k, (const T*)v, ldq, ldk,
                                                    ldv, bias, (T*)out, Tn, D, H, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, int ldq, int ldk, int ldv,
             const float* bias, void* out, long long A, int Tn, int D, int H, float scale,
             cudaStream_t s) {
    switch (head_regs(hd)) {
        case 8: return launch<T, 8>(q, k, v, ldq, ldk, ldv, bias, out, A, Tn, D, H, scale, s);
        case 16: return launch<T, 16>(q, k, v, ldq, ldk, ldv, bias, out, A, Tn, D, H, scale, s);
        case 32: return launch<T, 32>(q, k, v, ldq, ldk, ldv, bias, out, A, Tn, D, H, scale, s);
        case 64: return launch<T, 64>(q, k, v, ldq, ldk, ldv, bias, out, A, Tn, D, H, scale, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mtt

// Whether the bf16 tensor-core variant takes these shapes (head width 16,
// T <= 128); the FMA kernel takes the rest.
extern "C" int mtt_window_attention_tc(int dtype, int T, int D, int H) {
    return dtype == 1 && D == 16 * H && T <= 128;
}

extern "C" size_t mtt_window_attention_fwd_smem(int dtype, int T, int D, int H) {
    return mtt_window_attention_tc(dtype, T, D, H) ? mtt::tc_smem_bytes((T + 15) / 16, D)
                                                    : mtt::smem_bytes(T, D, H);
}

// dtype: 0 = float32, 1 = bfloat16. q, k, v: (A, T, ld*) with rows ld*
// elements apart (windows T * ld* apart), any head width D / H up to 64;
// bias (A, T) float32; out (A, T, D) contiguous. Returns the CUDA error code.
extern "C" int mtt_window_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, int ldq, int ldk, int ldv,
    const float* bias, void* out, long long A, int T, int D, int H, float scale, void* stream) {
    if (A == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return mtt::dispatch<float>(D / H, q, k, v, ldq, ldk, ldv, bias, out, A, T, D, H, scale, s);
    if (mtt_window_attention_tc(dtype, T, D, H))
        return mtt::dispatch_tc(q, k, v, ldq, ldk, ldv, bias, out, A, T, D, H, scale, s);
    return mtt::dispatch<__nv_bfloat16>(D / H, q, k, v, ldq, ldk, ldv, bias, out, A, T, D, H,
                                        scale, s);
}
