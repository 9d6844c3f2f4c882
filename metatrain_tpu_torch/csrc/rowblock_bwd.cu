// K4: PET row-block stages, backward; K4-dW, its weight-gradient variant.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/rowblock.py
// `_make_bwd_op` (the backward pallas_call), which runs the hand-written
// backwards `compress_bwd`, `combination_bwd` and `head_bwd` of
// metatrain_tpu/models/pet/fused_stages.py: K4 with `weight_grads=False`,
// K4-dW (DW = true) with `weight_grads=True`. The same three
// instantiations as K3 recompute the stage for a tile of 64 rows and pull
// the cotangent back to the inputs:
//   compress    : d_part_i = rnd(rnd((rnd(g) @ w1^T) * silu'(pre)) @ w0_i^T)
//   combination : d_edges = rnd(LayerNorm'(d_xn) [:D] + g), d_rev = rnd(... [D:]);
//                 d_messages = g is returned by the caller without a launch
//   head        : d_x = rnd(rnd(rnd(g silu'(pre1)) @ w1^T silu'(pre0)) @ w0^T)
// K4-dW also sums the weight gradients over rows, in float:
//   dw0 = X^T rnd(d_pre0), db0 = sum d_pre0, dw1 = h^T rnd(d_pre1 or g),
//   db1 = sum (d_pre1 or g), and for the combination d ln_scale = sum d_xn
//   xn0, d ln_bias = sum d_xn (d_xn before the ln_scale product).
//
// What bounds it on the H100: about twice K3's products per row, with the
// recomputed pre-activations held in shared memory next to the cotangent
// tile (up to 164 KB at 64 rows); the caller passes transposed weight
// copies so that every product is common.cuh's block_mm (FMA in f32,
// tensor cores in bf16). K4-dW adds as many FLOPs again for the X^T dY
// products (FMA register tiles, common.cuh accum_atb) and keeps the hidden
// activation h in one more tile (the combination then needs 230 KB). The
// sum over up to ~10^6 rows must not depend on the run: K4-dW runs a fixed
// grid of one block per SM, each block walks a contiguous range of row
// tiles and adds into its own float partial (each element always updated
// by the same thread), and a second pass adds the partials in block order.
// The unrounded d_pre tiles are kept where the bias sums need them: the
// products that consume them round on their own (bf16 fragments are
// packed with round-to-nearest-even, the same as rnd), so the input
// cotangents are those of K4.

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
    float* partials;  // K4-dW: (gridDim.x, n_dw) per-block weight gradients
    long long rows;
    int d_part, w_in, w_hid, w_out;
};

__host__ __device__ inline size_t smem_floats(int stage, int w_in, int w_hid, int w_out, bool dw) {
    if (stage == kHead) return (size_t)kRows * (w_in + 3 * w_hid);
    return (size_t)kRows * (w_in + w_hid + w_out + (dw ? w_hid : 0)) + 2 * kRows;
}

// Offsets of the weight gradients in a partial, in the order of the
// stage's weights ([ln_scale, ln_bias,] w0, b0, w1, b1).
struct DwLayout {
    long long ln_scale, ln_bias, w0, b0, w1, b1, total;
    __host__ __device__ DwLayout(int stage, int w_in, int w_hid, int w_out) {
        const long long ln = stage == kCombination ? w_in : 0;
        ln_scale = 0;
        ln_bias = ln;
        w0 = 2 * ln;
        b0 = w0 + (long long)w_in * w_hid;
        w1 = b0 + w_hid;
        b1 = w1 + (long long)w_hid * w_out;
        total = b1 + w_out;
    }
};

// One tile of 64 rows from row0; with DW, its weight gradients are added
// to the block's partial P.
template <typename T, int STAGE, bool DW>
__device__ void rowblock_bwd_tile(const RowBwdArgs<T>& p, long long row0, float* smem, float* P) {
    const int Win = p.w_in, Wh = p.w_hid, Wo = p.w_out, Dp = p.d_part;
    const int valid = (int)min((long long)kRows, p.rows - row0);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const T* parts[3] = {p.x0, p.x1, p.x2};
    T* douts[3] = {p.d0, p.d1, p.d2};
    const DwLayout L(STAGE, Win, Wh, Wo);

    if (STAGE == kHead) {
        float* X = smem;                 // (64, Win)
        float* PRE0 = X + kRows * Win;   // (64, Wh)
        float* H0 = PRE0 + kRows * Wh;   // h0, then d_pre0 (rounded unless DW)
        float* DP1 = H0 + kRows * Wh;    // d_pre1 (rounded unless DW)
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
            const float d = g * silu_grad(acc + to_f(p.b1[n]));
            DP1[m * Wh + n] = DW ? d : rnd<T>(d);
        });
        __syncthreads();
        if (DW) {
            accum_atb<T, true>(P + L.w1, Wh, H0, Wh, DP1, Wh, valid, Wh, Wh);
            accum_colsum(P + L.b1, DP1, Wh, valid, Wh);
            __syncthreads();
        }
        block_mm<16>(DP1, Wh, kRows, Wh, p.w1_t, Wh, Wh, [&](int m, int n, float acc) {
            const float d = acc * silu_grad(PRE0[m * Wh + n]);
            H0[m * Wh + n] = DW ? d : rnd<T>(d);
        });
        __syncthreads();
        if (DW) {
            accum_atb<T, true>(P + L.w0, Wh, X, Win, H0, Wh, valid, Win, Wh);
            accum_colsum(P + L.b0, H0, Wh, valid, Wh);
        }
        block_mm<16>(H0, Wh, kRows, Wh, p.w0_t, Win, Win, [&](int m, int n, float acc) {
            if (m < valid) p.d0[(row0 + m) * Win + n] = from_f<T>(acc);
        });
        return;
    }

    float* IN = smem;                  // (64, Win): inputs or xn; later d_xn0 (DW: d_xn)
    float* PRE = IN + kRows * Win;     // (64, Wh): pre-activation, then d_pre (rounded unless DW)
    float* G = PRE + kRows * Wh;       // (64, Wo): cotangent
    float* MEAN = G + kRows * Wo;
    float* RS = MEAN + kRows;
    float* HH = RS + kRows;            // DW: (64, Wh) hidden activation h

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
        const float pre = acc + to_f(p.b0[n]);
        PRE[m * Wh + n] = pre;
        if (DW) HH[m * Wh + n] = rnd<T>(siluf_(pre));
    });
    __syncthreads();
    if (DW) {
        accum_atb<T, false>(P + L.w1, Wo, HH, Wh, G, Wo, valid, Wh, Wo);
        accum_colsum(P + L.b1, G, Wo, valid, Wo);
    }
    block_mm<16>(G, Wo, kRows, Wo, p.w1_t, Wh, Wh, [&](int m, int n, float acc) {
        const float d = acc * silu_grad(PRE[m * Wh + n]);
        PRE[m * Wh + n] = DW ? d : rnd<T>(d);
    });
    __syncthreads();
    if (DW) {
        accum_atb<T, true>(P + L.w0, Wh, IN, Win, PRE, Wh, valid, Win, Wh);
        accum_colsum(P + L.b0, PRE, Wh, valid, Wh);
    }

    if (STAGE == kCompress) {
        block_mm<16>(PRE, Wh, kRows, Wh, p.w0_t, Win, Win, [&](int m, int n, float acc) {
            if (m < valid) douts[n / Dp][(row0 + m) * Dp + n % Dp] = from_f<T>(acc);
        });
        return;
    }

    // combination: d_xn0 = (d_pre @ w0^T) * ln_scale, then LayerNorm backward
    if (DW) __syncthreads();  // the products above read IN (xn)
    block_mm<16>(PRE, Wh, kRows, Wh, p.w0_t, Win, Win, [&](int m, int n, float acc) {
        IN[m * Win + n] = DW ? acc : acc * to_f(p.ln_scale[n]);
    });
    __syncthreads();
    if (DW) {
        for (int c = threadIdx.x; c < Win; c += blockDim.x) {
            float sx = 0.f, s1 = 0.f;
            for (int r = 0; r < valid; ++r) {
                const float xn0 = (to_f(parts[c / Dp][(row0 + r) * Dp + c % Dp]) - MEAN[r]) * RS[r];
                sx = fmaf(IN[r * Win + c], xn0, sx);
                s1 += IN[r * Win + c];
            }
            P[L.ln_scale + c] += sx;
            P[L.ln_bias + c] += s1;
        }
    }
    for (int r = warp; r < valid; r += nw) {
        const float* dxn = IN + r * Win;
        const float mean = MEAN[r], rs = RS[r];
        float sa = 0.f, sb = 0.f;
        for (int c = lane; c < Win; c += 32) {
            const float xn0 = (to_f(parts[c / Dp][(row0 + r) * Dp + c % Dp]) - mean) * rs;
            const float d = DW ? dxn[c] * to_f(p.ln_scale[c]) : dxn[c];
            sa += d;
            sb = fmaf(d, xn0, sb);
        }
        sa = warp_sum(sa) / Win;
        sb = warp_sum(sb) / Win;
        for (int c = lane; c < Win; c += 32) {
            const long long o = (row0 + r) * Dp + c % Dp;
            const float xn0 = (to_f(parts[c / Dp][o]) - mean) * rs;
            const float d = DW ? dxn[c] * to_f(p.ln_scale[c]) : dxn[c];
            float dx = rs * (d - sa - xn0 * sb);
            if (c < Dp) dx += G[r * Wo + c];
            douts[c / Dp][o] = from_f<T>(dx);
        }
    }
}

// K4: one block per 64-row tile. K4-dW: a fixed grid, block b walks tiles
// [b n / grid, (b + 1) n / grid) and sums their weight gradients into
// partial b.
template <typename T, int STAGE, bool DW>
__global__ void __launch_bounds__(kThreads) rowblock_bwd_kernel(RowBwdArgs<T> p) {
    extern __shared__ __align__(16) float smem[];
    if constexpr (!DW) {
        rowblock_bwd_tile<T, STAGE, false>(p, (long long)blockIdx.x * kRows, smem, nullptr);
    } else {
        const long long total = DwLayout(STAGE, p.w_in, p.w_hid, p.w_out).total;
        float* P = p.partials + blockIdx.x * total;
        zero_floats(P, total);
        __syncthreads();
        const long long tiles = (p.rows + kRows - 1) / kRows;
        const long long t0 = tiles * blockIdx.x / gridDim.x, t1 = tiles * (blockIdx.x + 1) / gridDim.x;
        for (long long t = t0; t < t1; ++t) {
            rowblock_bwd_tile<T, STAGE, true>(p, t * kRows, smem, P);
            __syncthreads();
        }
    }
}

template <typename T, int STAGE, bool DW>
int launch(const RowBwdArgs<T>& p, unsigned grid, cudaStream_t stream) {
    const size_t bytes = smem_floats(STAGE, p.w_in, p.w_hid, p.w_out, DW) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        rowblock_bwd_kernel<T, STAGE, DW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    rowblock_bwd_kernel<T, STAGE, DW><<<grid, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T, int STAGE>
int launch_stage(const RowBwdArgs<T>& p, int dw_blocks, float* dw, cudaStream_t stream) {
    if (dw == nullptr) return launch<T, STAGE, false>(p, (unsigned)((p.rows + kRows - 1) / kRows), stream);
    const int err = launch<T, STAGE, true>(p, (unsigned)dw_blocks, stream);
    if (err != 0) return err;
    const long long total = DwLayout(STAGE, p.w_in, p.w_hid, p.w_out).total;
    return launch_sum_partials(p.partials, dw_blocks, total, dw, stream);
}

template <typename T>
int dispatch(int stage, const RowBwdArgs<T>& p, int dw_blocks, float* dw, cudaStream_t stream) {
    if (stage == kCompress) return launch_stage<T, kCompress>(p, dw_blocks, dw, stream);
    if (stage == kCombination) return launch_stage<T, kCombination>(p, dw_blocks, dw, stream);
    return launch_stage<T, kHead>(p, dw_blocks, dw, stream);
}

}  // namespace
}  // namespace mtt

extern "C" size_t mtt_rowblock_bwd_smem(int stage, int w_in, int w_hid, int w_out, int dw) {
    return mtt::smem_floats(stage, w_in, w_hid, w_out, dw != 0) * sizeof(float);
}

// Same stage codes and inputs as mtt_rowblock_fwd; g is the output
// cotangent, d0..d2 receive the input cotangents (compress: one per part;
// combination: d0 = d_edges, d1 = d_reversed; head: d0). dw == nullptr
// launches K4; otherwise K4-dW with dw_blocks blocks, partials
// (dw_blocks, n_dw) floats of scratch, and dw (n_dw floats, in the order
// of the stage's weights) receiving the weight gradients.
extern "C" int mtt_rowblock_bwd(
    int dtype, int stage, const void* x0, const void* x1, const void* x2, int n_parts,
    const void* ln_scale, const void* ln_bias,
    const void* w0, const void* b0, const void* w1, const void* b1,
    const void* w0_t, const void* w1_t, const void* g,
    void* d0, void* d1, void* d2, float* partials, int dw_blocks, float* dw,
    long long rows, int d_part, int w_in, int w_hid, int w_out, void* stream) {
#define MTT_ARGS(T)                                                                      \
    mtt::RowBwdArgs<T>{(const T*)x0, (const T*)x1, (const T*)x2, n_parts,                \
                       (const T*)ln_scale, (const T*)ln_bias, (const T*)w0, (const T*)b0, \
                       (const T*)w1, (const T*)b1, (const T*)w0_t, (const T*)w1_t,        \
                       (const T*)g, (T*)d0, (T*)d1, (T*)d2, partials, rows, d_part, w_in, \
                       w_hid, w_out}
    if (rows == 0) {
        if (dw == nullptr) return 0;
        const long long n = mtt::DwLayout(stage, w_in, w_hid, w_out).total;
        return (int)cudaMemsetAsync(dw, 0, n * sizeof(float), (cudaStream_t)stream);
    }
    if (dtype == 0) return mtt::dispatch(stage, MTT_ARGS(float), dw_blocks, dw, (cudaStream_t)stream);
    return mtt::dispatch(stage, MTT_ARGS(__nv_bfloat16), dw_blocks, dw, (cudaStream_t)stream);
#undef MTT_ARGS
}
