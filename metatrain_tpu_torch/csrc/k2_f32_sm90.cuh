// The launch of the Hopper float32 K2 (fused_layer_bwd_f32_sm90.cu), shared
// by its own entry (the input-gradient backward) and the two-pass K2-dW
// (fused_layer_bwd_dw_sm90.cu), whose first pass in float32 runs the same
// body in its spill mode.

#pragma once

#include "layer_bwd.cuh"

namespace mtt {
namespace k2f32 {

struct Args {
    const float* edges;      // (A, M, D)
    const float* center;     // (A, D)
    const float* cf;         // (A, M)
    const float* norm_attn;  // (D,)
    const float* b_qkv;      // (3D,)
    const float* b_out;      // (D,)
    const float* norm_mlp;   // (D,)
    const float* b_in;       // (2F,)
    // every product's B in its (N, K) row-major layout
    const float* w_qkv_t;    // (3D, D)
    const float* w_out_t;    // (D, D)
    const float* w_in_t;     // (2F, D)
    const float* w_ffn_out;  // (F, D)
    const float* w_in;       // (D, 2F)
    const float* w_out;      // (D, D)
    const float* w_qkv;      // (D, 3D)
    const float* g_edge;     // (A, M, D)
    const float* g_center;   // (A, D)
    float* d_edges;          // (A, M, D)
    float* d_center;         // (A, D)
    float* d_cf;             // (A, M)
    DwSpill<float> sp;       // spill mode: the chunk's spill, atom a0 its row block 0
    long long a0;            // the launch's first atom
    int M, F;
    float scale, eps;
};

// D = 128, heads of 16, 16 <= M <= 64 with M % 16 == 0, F a multiple of 128.
bool takes(int M, int D, int H, int F);

// Shared bytes per block (one atom).
size_t smem_bytes();

// One block per atom a0 .. a0 + atoms - 1 on `stream`; with `spill`, the
// spill mode (K2-dW's first pass: the operand rows and vector sums to
// a.sp). Returns the CUDA error code.
int launch(const Args& a, long long atoms, bool spill, cudaStream_t stream);

}  // namespace k2f32
}  // namespace mtt
