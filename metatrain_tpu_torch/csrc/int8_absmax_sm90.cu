// The absmax pass of PET's dynamic int8 scores on Hopper: per block of
// atoms, the scales s_q and s_k that the Hopper K1-int8 and K2-int8
// (fused_layer_{fwd,bwd}_sm90.cu, mode kInt8) quantize q and k with, at the
// shapes where they run (the served int8 call: bfloat16, no weight
// requiring grad, D = 128, heads of 16, 16 <= M <= 64 with M % 16 == 0, F %
// 128 == 0; mtt_int8_absmax_sm90_ok is the Hopper K1's rule).
//
// Replaces the reductions of the TPU kernel
// metatrain_tpu/ops/pallas/fused_layer.py `_quantize_i8` (inside
// `_qside_scores`, run by `_fwd_kernel` and `_bwd_kernel` with `int8`),
// over the blocks of `_block_atoms` (8 atoms at M = 64, 128 at M <= 48):
// s = max(absmax, 1e-12) / 127 of the block's q and of its k, the absmax of
// the very values quantized. The general pass (int8_absmax.cu) forms q and
// k as the general bodies do (FFMA block_mm); the Hopper K1/K2 form them on
// wgmma in another order of summation, so their scales come from here.
//
// The same q|k bits as the Hopper K1-int8: each block takes atom pairs (2
// b, 2 b + 1; an odd last atom stands in for the missing one, as in K1),
// rows 0 .. M - 2 from the edges and M - 1 from the center, normalises them
// with layer_sm90.cuh's rms_rows and forms the q and k panels with its
// qkv_panel in the two-atom layout (N8 = 8: warps 0-7 atom 0, 8-15 atom 1,
// m64n64k16, two 64-k chunks per panel, the bias added after the sum):
// K1's own device code, on the same operands, so the same float values;
// each is rounded to bf16 as K1 stores it. The v panel is skipped. Per
// thread a running max of |q| and of |k| over rows m < M (the rows from M
// on are never written); at the end of a scale block (or of the block's
// range of pairs) a warp reduction and one atomicMax per warp on the float
// bits (non-negative, so they order as unsigned integers and the result
// does not depend on the order). int8_absmax.cu's int8_scales then folds
// in a partial last block's padding and takes the quotient.
//
// What bounds it on the H100: one read of the edges (A M D bf16: 186.6 MB
// at A = 11,392, M = 64, 0.0557 ms at 3.35 TB/s) against 2/3 of K1's QKV
// product (2 M D 2D operations per atom: 47.8 GFLOP, 0.048 ms at 989
// TFLOP/s), about even. The design: one persistent block per SM over a
// contiguous range of atom pairs; the q|k rows of w_qkv^T (256 x 128 bf16,
// 64 KB) staged once per block as four resident chunks in the ring's
// 128-byte swizzle, so the wgmma reads are K1's with no ring barrier; each
// pair's token rows copied by cp.async into one of two buffers while the
// pair before is normed and multiplied. Shared memory per block: the
// weights 65,536 B, n1 of two atoms 34,816 B, two pairs' tokens 65,536 B,
// the norms' factors 512 B: 166,400 B.

#include "int8_absmax.cuh"
#include "layer_sm90.cuh"

namespace mtt {
namespace sm90 {
namespace {

constexpr int kQkChunks = 4;                                // q and k: 2 panels x 2 k halves
constexpr int kWeightBytes = kQkChunks * kChunkElems * 2;   // resident, 1024-byte aligned
constexpr int kOpBytes = kRows * LA * 2;                    // one atom's n1
constexpr int kTokElems = kRows * D;                        // one atom's token rows (bf16)
constexpr int kOffOp = kWeightBytes;
constexpr int kOffTok = kOffOp + 2 * kOpBytes;              // two buffers of a pair's tokens
constexpr int kOffRs = kOffTok + 4 * kTokElems * 2;
constexpr int kSmemBytes = kOffRs + 2 * kRows * 4;
static_assert(kSmemBytes <= 232448, "one block per SM");
static_assert(kOffTok % 16 == 0, "cp.async targets 16-byte pieces");

// The resident q|k chunks, consumed as panel_mm consumes the ring's: chunk
// c is w_qkv^T rows 128 (c / 2) .. + 127, columns 64 (c % 2) .. + 63.
struct Resident {
    const bf16* w;
    __device__ const bf16* consume(int c) const { return w + c * kChunkElems; }
};

// |x| of x rounded to bf16, as K1 stores q and k
__device__ __forceinline__ float abs_bf16(float x) { return fabsf(__bfloat162float(__float2bfloat16_rn(x))); }

__global__ void __launch_bounds__(kThreads, 1)
    absmax_sm90_kernel(const bf16* __restrict__ edges, const bf16* __restrict__ center,
                       const bf16* __restrict__ norm_attn, const bf16* __restrict__ w_qkv_t,
                       const bf16* __restrict__ b_qkv, long long A, int M, int block_atoms, float eps,
                       unsigned* __restrict__ bits) {
    extern __shared__ __align__(1024) unsigned char smem[];
    bf16* W = reinterpret_cast<bf16*>(smem);
    bf16* OP = reinterpret_cast<bf16*>(smem + kOffOp);
    bf16* TOK = reinterpret_cast<bf16*>(smem + kOffTok);
    float* RS = reinterpret_cast<float*>(smem + kOffRs);  // rms_rows' factors, unused

    // the weights, once: K1's chunk layout (WeightRing::issue)
    for (int p = threadIdx.x; p < kQkChunks * kChunkN * kChunkK / 8; p += kThreads) {
        const int c = p / (kChunkN * kChunkK / 8), row = (p >> 3) % kChunkN, piece = p & 7;
        const bf16* g = w_qkv_t + (size_t)(c >> 1) * kChunkN * D + (c & 1) * kChunkK;
        cp_async16(W + c * kChunkElems + row * kChunkK + ((piece ^ (row & 7)) * 8),
                   g + (size_t)row * D + piece * 8);
    }
    cp_async_commit();

    // pair pr's token rows into buffer buf: atom 0 rows 0 .. M - 1, then atom 1
    auto stage = [&](long long pr, int buf) {
        const long long a0 = 2 * pr, a1 = a0 + 1 < A ? a0 + 1 : a0;
        bf16* X = TOK + buf * 2 * kTokElems;
        constexpr int kPieces = D / 8;  // 16-byte pieces of a row (no division by M)
        for (int p = threadIdx.x; p < 2 * M * kPieces; p += kThreads) {
            const int row = p / kPieces, piece = p % kPieces, at = row >= M, m = row - at * M;
            const long long a = at ? a1 : a0;
            const bf16* src = m == M - 1 ? center + a * D : edges + (a * M + m) * D;
            cp_async16(X + at * kTokElems + m * D + piece * 8, src + piece * 8);
        }
    };

    const long long pairs = (A + 1) / 2;
    const long long p0 = pairs * blockIdx.x / gridDim.x, p1 = pairs * (blockIdx.x + 1) / gridDim.x;
    if (p0 < p1) stage(p0, 0);
    cp_async_commit();

    Resident res{W};
    const bf16* n1 = OP + panel_atom<8>() * kRows * LA;
    float mq = 0.f, mk = 0.f;
    for (long long pr = p0; pr < p1; ++pr) {
        const int buf = (int)((pr - p0) & 1);
        if (pr + 1 < p1) stage(pr + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();  // the weights and this pair's tokens
        // written through the generic proxy; wgmma reads the weights
        // through the async one
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        const bf16* X = TOK + buf * 2 * kTokElems;
        rms_rows([&](int m) { return X + m * D; }, norm_attn, RS, OP, M, eps, [](int) {});
        rms_rows([&](int m) { return X + kTokElems + m * D; }, norm_attn, RS + kRows, OP + kRows * LA, M,
                 eps, [](int) {});
        __syncthreads();
        int c = 0;
        qkv_panel<8>(res, c, n1, 0, b_qkv, [&](int m, int, float y0, float y1) {
            if (m < M) mq = fmaxf(mq, fmaxf(abs_bf16(y0), abs_bf16(y1)));
        });
        qkv_panel<8>(res, c, n1, 1, b_qkv, [&](int m, int, float y0, float y1) {
            if (m < M) mk = fmaxf(mk, fmaxf(abs_bf16(y0), abs_bf16(y1)));
        });
        // both atoms of a pair lie in one scale block (block_atoms is even)
        const long long blk = 2 * pr / block_atoms;
        if (pr + 1 == p1 || 2 * (pr + 1) / block_atoms != blk) {
            mq = warp_max(mq);
            mk = warp_max(mk);
            if ((threadIdx.x & 31) == 0) {
                atomicMax(bits + 2 * blk, __float_as_uint(mq));
                atomicMax(bits + 2 * blk + 1, __float_as_uint(mk));
            }
            mq = mk = 0.f;
        }
        __syncthreads();  // n1 and this pair's buffer are free again
    }
    cp_async_wait<0>();
}

}  // namespace
}  // namespace sm90
}  // namespace mtt

// Whether the Hopper absmax pass takes a shape: the Hopper K1's rule
// (mtt_fused_layer_fwd_sm90_ok), whose int8 mode quantizes with its scales.
extern "C" int mtt_int8_absmax_sm90_ok(int M, int D, int H, int F) {
    return D == mtt::sm90::D && H == mtt::sm90::H && M >= 16 && M <= mtt::sm90::kRows && M % 16 == 0 &&
           F >= mtt::sm90::kChunkN && F % mtt::sm90::kChunkN == 0;
}

// Its shared memory per block, 0 where it does not take the shape.
extern "C" size_t mtt_int8_absmax_sm90_smem(int M, int D, int H, int F) {
    return mtt_int8_absmax_sm90_ok(M, D, H, F) ? (size_t)mtt::sm90::kSmemBytes : 0;
}

// bfloat16: edges (A, M, D), center (A, D), the layer's norm_attn, w_qkv^T
// (3D, D; rows 0 .. 2D - 1 are read) and b_qkv; scales (ceil(A /
// block_atoms), 2) float32 receives s_q, s_k of each block of block_atoms
// (even) atoms. min(ceil(A / 2), sms) persistent blocks on `stream`.
// Returns the CUDA error code (0 = ok; cudaErrorInvalidValue for a shape or
// an odd block it does not take).
extern "C" int mtt_int8_absmax_sm90(
    const void* edges, const void* center, const void* norm_attn, const void* w_qkv_t,
    const void* b_qkv, float* scales, long long A, int M, int D, int H, int F, int block_atoms,
    float eps, int sms, void* stream) {
    using mtt::sm90::bf16;
    if (!mtt_int8_absmax_sm90_ok(M, D, H, F) || block_atoms <= 0 || block_atoms % 2 || sms <= 0)
        return (int)cudaErrorInvalidValue;
    if (A == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const long long n_blocks = (A + block_atoms - 1) / block_atoms;
    cudaError_t err = cudaMemsetAsync(scales, 0, 2 * n_blocks * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    const int bytes = mtt::sm90::kSmemBytes;
    err = cudaFuncSetAttribute(mtt::sm90::absmax_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    const long long pairs = (A + 1) / 2;
    const unsigned grid = (unsigned)(pairs < sms ? pairs : sms);
    mtt::sm90::absmax_sm90_kernel<<<grid, mtt::sm90::kThreads, bytes, s>>>(
        (const bf16*)edges, (const bf16*)center, (const bf16*)norm_attn, (const bf16*)w_qkv_t,
        (const bf16*)b_qkv, A, M, block_atoms, eps, reinterpret_cast<unsigned*>(scales));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return mtt::int8_scales(b_qkv, scales, A, D, block_atoms, s);
}
