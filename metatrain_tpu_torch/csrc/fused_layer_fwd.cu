// K1: fused PET transformer layer, forward.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/fused_layer.py
// `_fwd_kernel` (entered through `_forward_impl` / `fused_transformer_layer`,
// body `_layer_math`). One PreLN layer per atom: the center token goes into
// the reserved slot M-1, then RMSNorm, QKV, window multi-head attention
// with multiplicative cutoff weights (cf * e^s / sum cf * e^s), output
// projection and residual, RMSNorm, SwiGLU and residual; slot M-1 of the
// edge output is zeroed and its attention output is the center output.
// The per-atom body is layer_fwd.cuh's layer_fwd_atom, which the GNN block
// (gnn_block_fwd.cu, gnn_block_bwd.cu) runs too.
//
// What bounds it on the H100: the layer does ~23 MFLOP per atom at M=64
// (the QKV, out-projection and SwiGLU products are ~90 % of it) on 64 x 128
// activations. Those activations never leave shared memory: one thread
// block per atom holds the token block, its normed copy, q/k/v and one
// head's score matrix (~181 KB in float at M=64, D=128; one block per SM),
// so device memory sees one read and one write of the edge block. The
// weights (644 KB in f32, 322 KB in bf16) do not fit in shared memory;
// every block streams them from L2. The products go through common.cuh
// block_mm: FMA loops in f32, mma.sync tensor cores in bf16. The window
// attention (scores, softmax, P @ V per head) runs on FMA loops over
// register tiles (common.cuh smem_abt / smem_awb), 512 threads per block
// to hide the latency of the L2 weight loads. Next steps: wgmma with weight
// tiles staged by TMA, and several atoms per block to share each tile.

#include "layer_fwd.cuh"

namespace mtt {
namespace {

template <typename T>
struct LayerArgs {
    const T* edges;   // (A, M, D)
    const T* center;  // (A, D)
    const float* cf;  // (A, M), cf[:, M-1] == 1
    LayerW<T> w;
    T* edge_out;      // (A, M, D)
    T* center_out;    // (A, D)
    int M, D, H, F;
    float scale, eps;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_layer_fwd_kernel(LayerArgs<T> p) {
    extern __shared__ __align__(16) float smem[];
    const int M = p.M, D = p.D;
    const long long a = blockIdx.x;
    float* X = smem;
    float* CF = layer_fwd_cf(smem, M, D, p.F);
    const T* e = p.edges + a * M * D;
    for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
        const int m = i / D;
        X[i] = m == M - 1 ? to_f(p.center[a * D + i % D]) : to_f(e[i]);
    }
    for (int i = threadIdx.x; i < M; i += blockDim.x) CF[i] = p.cf[a * M + i];
    __syncthreads();
    layer_fwd_atom<T>(smem, p.w, M, D, p.H, p.F, p.scale, p.eps, p.center_out + a * D, nullptr,
                      p.edge_out + a * M * D, false);
}

template <typename T>
int launch(const LayerArgs<T>& p, long long A, cudaStream_t stream) {
    const size_t bytes = layer_fwd_floats(p.M, p.D, p.F) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fused_layer_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    fused_layer_fwd_kernel<T><<<(unsigned)A, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mtt

extern "C" size_t mtt_fused_layer_fwd_smem(int M, int D, int F) {
    return mtt::layer_fwd_floats(M, D, F) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error code (0 = ok).
extern "C" int mtt_fused_layer_fwd(
    int dtype, const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* norm_mlp,
    const void* w_in, const void* b_in, const void* w_ffn_out, const void* b_ffn_out,
    void* edge_out, void* center_out,
    long long A, int M, int D, int H, int F, float scale, float eps, void* stream) {
#define MTT_ARGS(T)                                                                   \
    mtt::LayerArgs<T>{(const T*)edges, (const T*)center, cf,                          \
                      mtt::LayerW<T>{(const T*)norm_attn, (const T*)w_qkv,            \
                                     (const T*)b_qkv, (const T*)w_out,                \
                                     (const T*)b_out, (const T*)norm_mlp,             \
                                     (const T*)w_in, (const T*)b_in,                  \
                                     (const T*)w_ffn_out, (const T*)b_ffn_out},       \
                      (T*)edge_out, (T*)center_out, M, D, H, F, scale, eps}
    if (A == 0) return 0;
    if (dtype == 0) return mtt::launch(MTT_ARGS(float), A, (cudaStream_t)stream);
    return mtt::launch(MTT_ARGS(__nv_bfloat16), A, (cudaStream_t)stream);
#undef MTT_ARGS
}
