// Reversed-edge permute: out[r] = x[rev[r]] (+ acc[r]) over (rows, D) rows.
//
// Replaces the TPU kernels of metatrain_tpu/ops/pallas/color_gather.py:
// `_kernel` (behind `_kernel_impl`, the banded layout) and `_grouped_kernel`
// (behind `_kernel_impl_grouped`, the grouped layout), which compute this
// function as one-hot matmuls on slot layouts built for the TPU's matrix
// unit; `acc` is their fused accumulate variant (`colored_permute_acc`, the
// cotangent fan-in of `reverse_pair`). On the plain layout the function is a
// row gather, and one kernel covers both.
//
// What bounds it on the H100: bytes. Each output row reads one input row
// (and one acc row) and writes one row; there is no arithmetic beyond the
// add. One warp per row, each lane moving 16 bytes per load and store, so a
// warp moves 512 bytes of a row per step with every access coalesced; the
// random row order costs nothing extra at rows of 256 bytes and more. The
// add is one add in the storage type (float, or bf16 rounded from the float
// sum), so the result equals index_select (+ add) bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mtt {
namespace {

constexpr int kPermuteThreads = 256;

__device__ __forceinline__ float2 add2(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }

// adds the 16 bytes b to a, as elements of T
template <typename T>
__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b);

template <>
__device__ __forceinline__ uint4 add_vec<float>(uint4 a, uint4 b) {
    return make_uint4(__float_as_uint(__uint_as_float(a.x) + __uint_as_float(b.x)),
                      __float_as_uint(__uint_as_float(a.y) + __uint_as_float(b.y)),
                      __float_as_uint(__uint_as_float(a.z) + __uint_as_float(b.z)),
                      __float_as_uint(__uint_as_float(a.w) + __uint_as_float(b.w)));
}

template <>
__device__ __forceinline__ uint4 add_vec<__nv_bfloat16>(uint4 a, uint4 b) {
    uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w}, out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 s = add2(__bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&av[i])),
                              __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&bv[i])));
        __nv_bfloat162 r = __floats2bfloat162_rn(s.x, s.y);
        out[i] = *reinterpret_cast<uint32_t*>(&r);
    }
    return make_uint4(out[0], out[1], out[2], out[3]);
}

// vecs = D * sizeof(T) / 16 vectors per row
template <typename T, bool ACC>
__global__ void __launch_bounds__(kPermuteThreads) permute_kernel(
    const uint4* __restrict__ x, const uint4* __restrict__ acc, const long long* __restrict__ rev,
    uint4* __restrict__ out, long long rows, int vecs) {
    const int lane = threadIdx.x & 31;
    const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
    for (long long r = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); r < rows;
         r += warps) {
        const uint4* src = x + rev[r] * vecs;
        uint4* dst = out + r * vecs;
        for (int i = lane; i < vecs; i += 32) {
            uint4 v = src[i];
            if (ACC) v = add_vec<T>(v, acc[r * vecs + i]);
            dst[i] = v;
        }
    }
}

template <typename T, bool ACC>
int launch(const void* x, const void* acc, const long long* rev, void* out, long long rows, int D,
           cudaStream_t stream) {
    const int vecs = (int)(D * sizeof(T) / 16);
    const int warps_per_block = kPermuteThreads / 32;
    long long blocks = (rows + warps_per_block - 1) / warps_per_block;
    if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond 64 blocks per SM
    permute_kernel<T, ACC><<<(unsigned)blocks, kPermuteThreads, 0, stream>>>(
        (const uint4*)x, (const uint4*)acc, rev, (uint4*)out, rows, vecs);
    return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mtt

// dtype: 0 = float32, 1 = bfloat16; acc may be null (no add). D * itemsize
// must be a multiple of 16 and every pointer 16-byte aligned. Returns the
// CUDA error code (0 = ok).
extern "C" int mtt_permute(int dtype, const void* x, const void* acc, const long long* rev,
                           void* out, long long rows, int D, void* stream) {
    if (rows == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return acc ? mtt::launch<float, true>(x, acc, rev, out, rows, D, s)
                   : mtt::launch<float, false>(x, acc, rev, out, rows, D, s);
    return acc ? mtt::launch<__nv_bfloat16, true>(x, acc, rev, out, rows, D, s)
               : mtt::launch<__nv_bfloat16, false>(x, acc, rev, out, rows, D, s);
}
