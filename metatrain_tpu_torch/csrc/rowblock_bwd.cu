// K4: PET row-block stages, backward for input gradients.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/rowblock.py
// `_make_bwd_op` (the backward pallas_call), which runs the hand-written
// backwards `compress_bwd`, `combination_bwd` and `head_bwd` of
// metatrain_tpu/models/pet/fused_stages.py with `weight_grads=False`. The
// same three instantiations as K3 recompute the stage for a tile of 64
// rows and pull the cotangent back to the inputs:
//   compress    : d_part_i = rnd(rnd((rnd(g) @ w1^T) * silu'(pre)) @ w0_i^T)
//   combination : d_edges = rnd(LayerNorm'(d_xn) [:D] + g), d_rev = rnd(... [D:]);
//                 d_messages = g is returned by the caller without a launch
//   head        : d_x = rnd(rnd(rnd(g silu'(pre1)) @ w1^T silu'(pre0)) @ w0^T)
//
// What bounds it on the H100: about twice K3's products per row, with the
// recomputed pre-activations held in shared memory next to the cotangent
// tile (up to 164 KB at 64 rows); the caller passes transposed weight
// copies so that every product is common.cuh's block_mm (FMA in f32,
// tensor cores in bf16).

#include "common.cuh"

namespace mtt {
namespace {

constexpr int kRows = 64;
enum Stage { kCompress = 0, kCombination = 1, kHead = 2 };

template <typename T>
struct RowBwdArgs {
    const T* x0;
    const T* x1;
    const T* x2;
    int n_parts;
    const T* ln_scale;
    const T* ln_bias;
    const T* w0;    // (w_in, w_hid)
    const T* b0;
    const T* w1;    // (w_hid, w_out)
    const T* b1;
    const T* w0_t;  // (w_hid, w_in)
    const T* w1_t;  // (w_out, w_hid)
    const T* g;     // (rows, w_out)
    T* d0;
    T* d1;
    T* d2;
    long long rows;
    int d_part, w_in, w_hid, w_out;
};

__host__ __device__ inline size_t smem_floats(int stage, int w_in, int w_hid, int w_out) {
    if (stage == kHead) return (size_t)kRows * (w_in + 3 * w_hid);
    return (size_t)kRows * (w_in + w_hid + w_out) + 2 * kRows;
}

template <typename T, int STAGE>
__global__ void __launch_bounds__(kThreads) rowblock_bwd_kernel(RowBwdArgs<T> p) {
    extern __shared__ __align__(16) float smem[];
    const int Win = p.w_in, Wh = p.w_hid, Wo = p.w_out, Dp = p.d_part;
    const long long row0 = (long long)blockIdx.x * kRows;
    const int valid = (int)min((long long)kRows, p.rows - row0);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const T* parts[3] = {p.x0, p.x1, p.x2};
    T* douts[3] = {p.d0, p.d1, p.d2};

    if (STAGE == kHead) {
        float* X = smem;                 // (64, Win)
        float* PRE0 = X + kRows * Win;   // (64, Wh)
        float* H0 = PRE0 + kRows * Wh;   // h0, then rnd(d_pre0)
        float* DP1 = H0 + kRows * Wh;    // rnd(d_pre1)
        for (int i = threadIdx.x; i < kRows * Win; i += blockDim.x) {
            const int r = i / Win;
            X[i] = r < valid ? to_f(p.x0[(row0 + r) * Win + i % Win]) : 0.f;
        }
        __syncthreads();
        block_mm<16>(X, Win, kRows, Win, p.w0, Wh, Wh, [&](int m, int n, float acc) {
            const float pre = acc + to_f(p.b0[n]);
            PRE0[m * Wh + n] = pre;
            H0[m * Wh + n] = rnd<T>(siluf_(pre));
        });
        __syncthreads();
        block_mm<16>(H0, Wh, kRows, Wh, p.w1, Wh, Wh, [&](int m, int n, float acc) {
            const float g = m < valid ? to_f(p.g[(row0 + m) * Wh + n]) : 0.f;
            DP1[m * Wh + n] = rnd<T>(g * silu_grad(acc + to_f(p.b1[n])));
        });
        __syncthreads();
        block_mm<16>(DP1, Wh, kRows, Wh, p.w1_t, Wh, Wh, [&](int m, int n, float acc) {
            H0[m * Wh + n] = rnd<T>(acc * silu_grad(PRE0[m * Wh + n]));
        });
        __syncthreads();
        block_mm<16>(H0, Wh, kRows, Wh, p.w0_t, Win, Win, [&](int m, int n, float acc) {
            if (m < valid) p.d0[(row0 + m) * Win + n] = from_f<T>(acc);
        });
        return;
    }

    float* IN = smem;                  // (64, Win): inputs or xn; later d_xn0
    float* PRE = IN + kRows * Win;     // (64, Wh): pre-activation, then rnd(d_pre)
    float* G = PRE + kRows * Wh;       // (64, Wo): cotangent
    float* MEAN = G + kRows * Wo;
    float* RS = MEAN + kRows;

    if (STAGE == kCombination) {
        for (int r = warp; r < kRows; r += nw) {
            float* x = IN + r * Win;
            float s = 0.f;
            for (int c = lane; c < Win; c += 32) {
                x[c] = r < valid ? to_f(parts[c / Dp][(row0 + r) * Dp + c % Dp]) : 0.f;
                s += x[c];
            }
            const float mean = warp_sum(s) / Win;
            float v = 0.f;
            for (int c = lane; c < Win; c += 32) v = fmaf(x[c] - mean, x[c] - mean, v);
            const float rs = rsqrtf(warp_sum(v) / Win + 1e-5f);
            if (lane == 0) {
                MEAN[r] = mean;
                RS[r] = rs;
            }
            for (int c = lane; c < Win; c += 32)
                x[c] = rnd<T>((x[c] - mean) * rs * to_f(p.ln_scale[c]) + to_f(p.ln_bias[c]));
        }
    } else {
        for (int i = threadIdx.x; i < kRows * Win; i += blockDim.x) {
            const int r = i / Win, c = i % Win;
            IN[i] = r < valid ? to_f(parts[c / Dp][(row0 + r) * Dp + c % Dp]) : 0.f;
        }
    }
    for (int i = threadIdx.x; i < kRows * Wo; i += blockDim.x) {
        const int r = i / Wo;
        G[i] = r < valid ? to_f(p.g[(row0 + r) * Wo + i % Wo]) : 0.f;
    }
    __syncthreads();
    block_mm<16>(IN, Win, kRows, Win, p.w0, Wh, Wh, [&](int m, int n, float acc) {
        PRE[m * Wh + n] = acc + to_f(p.b0[n]);
    });
    __syncthreads();
    block_mm<16>(G, Wo, kRows, Wo, p.w1_t, Wh, Wh, [&](int m, int n, float acc) {
        PRE[m * Wh + n] = rnd<T>(acc * silu_grad(PRE[m * Wh + n]));
    });
    __syncthreads();

    if (STAGE == kCompress) {
        block_mm<16>(PRE, Wh, kRows, Wh, p.w0_t, Win, Win, [&](int m, int n, float acc) {
            if (m < valid) douts[n / Dp][(row0 + m) * Dp + n % Dp] = from_f<T>(acc);
        });
        return;
    }

    // combination: d_xn0 = (d_pre @ w0^T) * ln_scale, then LayerNorm backward
    block_mm<16>(PRE, Wh, kRows, Wh, p.w0_t, Win, Win, [&](int m, int n, float acc) {
        IN[m * Win + n] = acc * to_f(p.ln_scale[n]);
    });
    __syncthreads();
    for (int r = warp; r < valid; r += nw) {
        const float* dxn = IN + r * Win;
        const float mean = MEAN[r], rs = RS[r];
        float sa = 0.f, sb = 0.f;
        for (int c = lane; c < Win; c += 32) {
            const float xn0 = (to_f(parts[c / Dp][(row0 + r) * Dp + c % Dp]) - mean) * rs;
            sa += dxn[c];
            sb = fmaf(dxn[c], xn0, sb);
        }
        sa = warp_sum(sa) / Win;
        sb = warp_sum(sb) / Win;
        for (int c = lane; c < Win; c += 32) {
            const long long o = (row0 + r) * Dp + c % Dp;
            const float xn0 = (to_f(parts[c / Dp][o]) - mean) * rs;
            float dx = rs * (dxn[c] - sa - xn0 * sb);
            if (c < Dp) dx += G[r * Wo + c];
            douts[c / Dp][o] = from_f<T>(dx);
        }
    }
}

template <typename T, int STAGE>
int launch(const RowBwdArgs<T>& p, cudaStream_t stream) {
    const size_t bytes = smem_floats(STAGE, p.w_in, p.w_hid, p.w_out) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        rowblock_bwd_kernel<T, STAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((p.rows + kRows - 1) / kRows);
    rowblock_bwd_kernel<T, STAGE><<<blocks, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int stage, const RowBwdArgs<T>& p, cudaStream_t stream) {
    if (stage == kCompress) return launch<T, kCompress>(p, stream);
    if (stage == kCombination) return launch<T, kCombination>(p, stream);
    return launch<T, kHead>(p, stream);
}

}  // namespace
}  // namespace mtt

extern "C" size_t mtt_rowblock_bwd_smem(int stage, int w_in, int w_hid, int w_out) {
    return mtt::smem_floats(stage, w_in, w_hid, w_out) * sizeof(float);
}

// Same stage codes and inputs as mtt_rowblock_fwd; g is the output
// cotangent, d0..d2 receive the input cotangents (compress: one per part;
// combination: d0 = d_edges, d1 = d_reversed; head: d0).
extern "C" int mtt_rowblock_bwd(
    int dtype, int stage, const void* x0, const void* x1, const void* x2, int n_parts,
    const void* ln_scale, const void* ln_bias,
    const void* w0, const void* b0, const void* w1, const void* b1,
    const void* w0_t, const void* w1_t, const void* g,
    void* d0, void* d1, void* d2,
    long long rows, int d_part, int w_in, int w_hid, int w_out, void* stream) {
#define MTT_ARGS(T)                                                                      \
    mtt::RowBwdArgs<T>{(const T*)x0, (const T*)x1, (const T*)x2, n_parts,                \
                       (const T*)ln_scale, (const T*)ln_bias, (const T*)w0, (const T*)b0, \
                       (const T*)w1, (const T*)b1, (const T*)w0_t, (const T*)w1_t,        \
                       (const T*)g, (T*)d0, (T*)d1, (T*)d2, rows, d_part, w_in, w_hid,    \
                       w_out}
    if (rows == 0) return 0;
    if (dtype == 0) return mtt::dispatch(stage, MTT_ARGS(float), (cudaStream_t)stream);
    return mtt::dispatch(stage, MTT_ARGS(__nv_bfloat16), (cudaStream_t)stream);
#undef MTT_ARGS
}
