// The last step of both absmax passes (int8_absmax.cu, the general one, and
// int8_absmax_sm90.cu, the Hopper one): the per-block maxima of |q| and |k|
// into the scales s = max(absmax, 1e-12) / 127.

#pragma once

#include <cuda_runtime.h>

namespace mtt {

// scales (n_blocks, 2) holds the bits of each block's maxima of |q| and |k|
// on entry (non-negative floats, gathered with atomicMax) and s_q, s_k on
// exit; the absmax of a partial last block takes the padding atoms' |b_q|
// and |b_k| too (b_qkv bfloat16). One warp per block of atoms on `stream`.
// Returns the CUDA error code.
int int8_scales(const void* b_qkv, float* scales, long long A, int D, int block_atoms, cudaStream_t stream);

}  // namespace mtt
