// The absmax pass of PET's dynamic int8 scores: per block of atoms, the
// scales s_q and s_k that K1-int8, K2-int8 and K2-dW-int8 quantize q and k
// with.
//
// Replaces the reductions of the TPU kernel
// metatrain_tpu/ops/pallas/fused_layer.py `_quantize_i8` (inside
// `_qside_scores`, run by `_fwd_kernel` and `_bwd_kernel` with `int8`): a
// grid step of the TPU kernel holds one block of atoms (`_block_atoms`:
// 128 at M <= 48, 8 at M <= 96, 4 above) in VMEM and takes the absmax of
// its q and of its k over every atom, slot and column, then s = max(absmax,
// 1e-12) / 127. The port's kernels run one atom per thread block, in no
// order, so the reduction across atoms is this pass of its own, run once
// per layer call; its scales go to the forward and to the backward, which
// then quantize alike.
//
// Per atom, one thread block recomputes RMSNorm and the q and k columns of
// the QKV product exactly as the general bodies round them (K1-int8 of
// fused_layer_fwd.cu and K2-dW-int8's first pass: the same rmsnorm_rows
// and block_mm, so the same float values), 64 rows at a time, and reduces
// |q| and |k| to the block's maxima with atomicMax on the float bits (the
// values are non-negative, so their bits order as unsigned integers and
// the result does not depend on the order). A second small kernel
// (int8_scales, shared with the Hopper pass) folds in the padding of a
// partial last block (the JAX package pads it with atoms whose tokens are 0
// and cf 1: their q rows are b_q and their k rows b_k) and turns the maxima
// into scales. The Hopper K1-int8 and K2-int8 form q and k on wgmma, in
// another order of summation: where they run (the served int8 call), the
// scales come from int8_absmax_sm90.cu, which forms q and k with their code.
//
// What bounds it on the H100: 2/3 of K1's QKV product (2 M D 2D operations
// per atom, on bf16 tensor cores) and one read of the edges; the product
// dominates, about a fifth of K1's time.

#include "common.cuh"
#include "int8_absmax.cuh"

namespace mtt {
namespace {

constexpr int kAbsRows = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads) int8_absmax_kernel(
    const T* __restrict__ edges, const T* __restrict__ center, const T* __restrict__ norm_attn,
    const T* __restrict__ w_qkv, const T* __restrict__ b_qkv, long long A, int M, int D,
    int block_atoms, float eps, unsigned* __restrict__ bits) {
    extern __shared__ __align__(16) float smem[];
    float* X = smem;                 // (64, D): a chunk of the atom's tokens
    float* N = X + kAbsRows * D;     // (64, D): their normed rows
    __shared__ float red[2][kThreads / 32];
    const long long a = blockIdx.x;
    float mq = 0.f, mk = 0.f;
    for (int r0 = 0; r0 < M; r0 += kAbsRows) {
        const int rows = min(kAbsRows, M - r0);
        for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
            const int m = r0 + i / D;
            X[i] = m == M - 1 ? to_f(center[a * D + i % D]) : to_f(edges[(a * M + r0) * D + i]);
        }
        __syncthreads();
        rmsnorm_rows<T>(X, N, nullptr, rows, D, norm_attn, eps);
        __syncthreads();
        // q and k: the first 2D columns of q|k|v, rounded as K1 rounds them
        block_mm<16>(N, D, rows, D, w_qkv, 3 * D, 2 * D, [&](int m, int n, float acc) {
            const float v = fabsf(rnd<T>(acc + to_f(b_qkv[n])));
            if (n < D) {
                mq = fmaxf(mq, v);
            } else {
                mk = fmaxf(mk, v);
            }
        });
        __syncthreads();
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    mq = warp_max(mq);
    mk = warp_max(mk);
    if (lane == 0) {
        red[0][warp] = mq;
        red[1][warp] = mk;
    }
    __syncthreads();
    if (threadIdx.x < 2) {
        float m = 0.f;
        for (int w = 0; w < nw; ++w) m = fmaxf(m, red[threadIdx.x][w]);
        atomicMax(bits + 2 * (a / block_atoms) + threadIdx.x, __float_as_uint(m));
    }
}

// scales[b] = max(absmax_b, 1e-12) / 127 for q and k, the absmax of a
// partial last block taking the padding atoms' |b_q| and |b_k| too. One
// warp per block of atoms; scales holds the maxima' bits on entry.
template <typename T>
__global__ void int8_scales_kernel(const T* __restrict__ b_qkv, long long A, int D, int block_atoms,
                                   float* __restrict__ scales) {
    const int b = blockIdx.x, lane = threadIdx.x;
    const long long n_blocks = (A + block_atoms - 1) / block_atoms;
    float pq = 0.f, pk = 0.f;
    if (b == n_blocks - 1 && A % block_atoms != 0) {
        for (int n = lane; n < D; n += 32) {
            pq = fmaxf(pq, fabsf(to_f(b_qkv[n])));
            pk = fmaxf(pk, fabsf(to_f(b_qkv[D + n])));
        }
    }
    pq = warp_max(pq);
    pk = warp_max(pk);
    if (lane < 2) {
        const float m = fmaxf(__uint_as_float(reinterpret_cast<unsigned*>(scales)[2 * b + lane]),
                              lane == 0 ? pq : pk);
        scales[2 * b + lane] = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
    }
}

}  // namespace

int int8_scales(const void* b_qkv, float* scales, long long A, int D, int block_atoms, cudaStream_t stream) {
    using T = __nv_bfloat16;
    const long long n_blocks = (A + block_atoms - 1) / block_atoms;
    int8_scales_kernel<T><<<(unsigned)n_blocks, 32, 0, stream>>>((const T*)b_qkv, A, D, block_atoms, scales);
    return (int)cudaGetLastError();
}

}  // namespace mtt

extern "C" size_t mtt_int8_absmax_smem(int D) {
    return 2 * (size_t)mtt::kAbsRows * D * sizeof(float);
}

// bfloat16 only. edges (A, M, D), center (A, D), the layer's norm_attn,
// w_qkv (D, 3D) and b_qkv; scales (ceil(A / block_atoms), 2) float32
// receives s_q, s_k of each block of block_atoms atoms. Returns the CUDA
// error code (0 = ok).
extern "C" int mtt_int8_absmax(
    const void* edges, const void* center, const void* norm_attn, const void* w_qkv,
    const void* b_qkv, float* scales, long long A, int M, int D, int block_atoms, float eps,
    void* stream) {
    using T = __nv_bfloat16;
    if (A == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const long long n_blocks = (A + block_atoms - 1) / block_atoms;
    cudaError_t err = cudaMemsetAsync(scales, 0, 2 * n_blocks * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    const size_t bytes = mtt_int8_absmax_smem(D);
    err = cudaFuncSetAttribute(mtt::int8_absmax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    mtt::int8_absmax_kernel<T><<<(unsigned)A, mtt::kThreads, bytes, s>>>(
        (const T*)edges, (const T*)center, (const T*)norm_attn, (const T*)w_qkv, (const T*)b_qkv, A,
        M, D, block_atoms, eps, reinterpret_cast<unsigned*>(scales));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return mtt::int8_scales(b_qkv, scales, A, D, block_atoms, s);
}
