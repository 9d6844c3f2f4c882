// K2: fused PET transformer layer, backward; K2-dW, its weight-gradient
// variant.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/fused_layer.py
// `_bwd_kernel` (entered through `_make_bwd_op` / `_fused_bwd`, body
// `_layer_bwd_math`): the layer is recomputed per atom, then
// back-propagated to d_edges (slot M-1 zero), d_center and d_cf (float).
// Forces need d_cf: the cutoff weights depend on the positions. K2 is the
// `weight_grads=False` variant (force calls); K2-dW (DW = true) is the
// `weight_grads=True` one (training): it also sums over atoms the float
// gradients of the 10 layer weights.
// The per-atom body is layer_bwd.cuh's layer_bwd_atom, which the GNN
// block's backward (gnn_block_bwd.cu) runs too.
//
// What bounds it on the H100: about twice the forward's FLOPs on the same
// per-atom activations, and shared memory. One block per atom (K2) keeps
// the tokens, q/k/v (overwritten head by head with dq/dk/dv), the attention
// softmax, the residual (then d_res) and scratch that serves one phase
// after another: ~165 KB at M=48, ~207 KB at M=64 (D=128, one block per
// SM). The tokens are read again from global memory at the end instead of
// being kept. The SwiGLU backward runs over row
// chunks of 16 tokens (its rows are independent), so the (M, 2F) gate
// activations never need to be resident at once. The attention backward
// runs one head at a time with max-subtracted scores, its five products on
// FMA register tiles (common.cuh smem_abt / smem_awb / smem_atb); d_cf is
// summed over queries and heads in a fixed order (no atomics), so it is
// deterministic.
// Transposed weight copies come from the caller, so every product is the
// same block_mm as in the forward (FMA in f32, tensor cores in bf16); the
// five per-head attention products stay on FMA loops and are the larger
// share of the time in bf16.
//
// K2-dW adds the four X^T dY products (w_qkv, w_out, w_in, w_ffn_out: as
// many FLOPs again as the forward's products), the bias column sums and
// the two RMSNorm scale sums, and 661 KB of float gradients (D=128,
// F=256) per atom to accumulate. One partial per atom would be ~7.5 GB,
// and atomics would sum in an order that changes from run to run. So
// K2-dW runs a fixed grid of one block per SM; each block walks a
// contiguous range of atoms and adds each atom's products into its own
// float partial in global memory (common.cuh accum_atb: every element
// always updated by the same thread), and a second pass adds the partials
// in block order: the same sum in every run. The products read operands
// the backward already holds in shared memory: the attention output is
// kept in the token buffer (free after the residual), the SwiGLU chunk
// gets two more 16-row buffers (g_eo and the gated activation, so that
// h_norm survives until d_vg exists; 231 KB at M=64), and the normed
// tokens are recomputed at the end into the free scratch. The products
// run on FMA register tiles in both dtypes; the partials' traffic
// (2 x 661 KB per atom, mostly L2) is the price of determinism here.

#include "layer_bwd.cuh"

namespace mtt {
namespace {

template <typename T>
struct LayerBwdArgs {
    const T* edges;        // (A, M, D)
    const T* center;       // (A, D)
    const float* cf;       // (A, M)
    LayerBwdW<T> w;
    const T* g_edge;       // (A, M, D)
    const T* g_center;     // (A, D)
    T* d_edges;            // (A, M, D)
    T* d_center;           // (A, D)
    float* d_cf;           // (A, M)
    float* partials;       // K2-dW: (gridDim.x, n_dw) per-block weight gradients
    long long A;
    int M, D, H, F;
    float scale, eps;
};

template <typename T>
__device__ AtomIO<T> atom_io(const LayerBwdArgs<T>& p, long long a) {
    const long long rows = a * p.M * p.D;
    return AtomIO<T>{p.edges + rows, p.center + a * p.D, p.cf + a * p.M, p.g_edge + rows,
                     p.g_center + a * p.D, p.d_edges + rows, p.d_center + a * p.D,
                     p.d_cf + a * p.M, false};
}

// K2: one block per atom. K2-dW: a fixed grid, block b walks atoms
// [b A / grid, (b + 1) A / grid) and sums their weight gradients into
// partial b.
template <typename T, bool DW>
__global__ void __launch_bounds__(kThreads) fused_layer_bwd_kernel(LayerBwdArgs<T> p) {
    extern __shared__ __align__(16) float smem[];
    if constexpr (!DW) {
        layer_bwd_atom<T, false>(p.w, atom_io(p, blockIdx.x), p.M, p.D, p.H, p.F, p.scale, p.eps,
                                 smem, nullptr);
    } else {
        const long long total = DwLayout(p.D, p.F).total;
        float* P = p.partials + blockIdx.x * total;
        zero_floats(P, total);
        __syncthreads();
        const long long a0 = p.A * blockIdx.x / gridDim.x, a1 = p.A * (blockIdx.x + 1) / gridDim.x;
        for (long long a = a0; a < a1; ++a) {
            layer_bwd_atom<T, true>(p.w, atom_io(p, a), p.M, p.D, p.H, p.F, p.scale, p.eps, smem, P);
            __syncthreads();
        }
    }
}

template <typename T, bool DW>
int launch(const LayerBwdArgs<T>& p, unsigned grid, cudaStream_t stream) {
    const size_t bytes = layer_bwd_floats(p.M, p.D, p.H, p.F, DW) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fused_layer_bwd_kernel<T, DW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    fused_layer_bwd_kernel<T, DW><<<grid, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const LayerBwdArgs<T>& p, int dw_blocks, float* dw, cudaStream_t stream) {
    if (dw == nullptr) return launch<T, false>(p, (unsigned)p.A, stream);
    const int err = launch<T, true>(p, (unsigned)dw_blocks, stream);
    if (err != 0) return err;
    return launch_sum_partials(p.partials, dw_blocks, DwLayout(p.D, p.F).total, dw, stream);
}

}  // namespace
}  // namespace mtt

extern "C" size_t mtt_fused_layer_bwd_smem(int M, int D, int H, int F, int dw) {
    return mtt::layer_bwd_floats(M, D, H, F, dw != 0) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. dw == nullptr launches K2; otherwise
// K2-dW with dw_blocks blocks, partials (dw_blocks, n_dw) floats of
// scratch, and dw (n_dw floats, LayerWeights order) receiving the weight
// gradients. Returns the CUDA error code (0 = ok).
extern "C" int mtt_fused_layer_bwd(
    int dtype, const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* norm_mlp,
    const void* w_in, const void* b_in,
    const void* w_qkv_t, const void* w_out_t, const void* w_in_t, const void* w_ffn_out_t,
    const void* g_edge, const void* g_center,
    void* d_edges, void* d_center, float* d_cf,
    float* partials, int dw_blocks, float* dw,
    long long A, int M, int D, int H, int F, float scale, float eps, void* stream) {
#define MTT_ARGS(T)                                                                      \
    mtt::LayerBwdArgs<T>{(const T*)edges, (const T*)center, cf,                          \
                         mtt::LayerBwdW<T>{(const T*)norm_attn, (const T*)w_qkv,         \
                                           (const T*)b_qkv, (const T*)w_out,             \
                                           (const T*)b_out, (const T*)norm_mlp,          \
                                           (const T*)w_in, (const T*)b_in,               \
                                           (const T*)w_qkv_t, (const T*)w_out_t,         \
                                           (const T*)w_in_t, (const T*)w_ffn_out_t},     \
                         (const T*)g_edge, (const T*)g_center, (T*)d_edges,              \
                         (T*)d_center, d_cf, partials, A, M, D, H, F, scale, eps}
    if (A == 0) return dw == nullptr ? 0 : (int)cudaMemsetAsync(dw, 0, mtt::DwLayout(D, F).total * sizeof(float), (cudaStream_t)stream);
    if (dtype == 0) return mtt::dispatch(MTT_ARGS(float), dw_blocks, dw, (cudaStream_t)stream);
    return mtt::dispatch(MTT_ARGS(__nv_bfloat16), dw_blocks, dw, (cudaStream_t)stream);
#undef MTT_ARGS
}
