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
//
// K2-W8A8 (mtt_fused_layer_bwd_w8a8, bfloat16 only) is K2 with the body's
// W8 flag: the TPU kernel's `_bwd_kernel` with `calib`, input gradients by
// straight-through estimation. Its recompute runs the W8A8 forward's int8
// products (QKV, scores per head, FFN-in); the gradient products are K2's.
// The AV weights rnd(cf e) / z and the softmax gradient's e / z differ in
// the W8A8 layer, so one more M x (M + 1) buffer: ~224 KB at M=64.
//
// K2-int8 and K2-dW-int8 (mtt_fused_layer_bwd_int8, bfloat16 only): the
// body's I8 flag, the TPU kernel's `_bwd_kernel` with `int8`: the recompute
// quantizes each head's scores with the block scales K1-int8 took (the
// same (A, 2) array), so the softmax is K1-int8's; the softmax gradient
// and the gradient products are K2-W8A8's, straight through on the bf16 q
// and k. K2-dW-int8 adds K2-dW's weight gradients. One more M x (M + 1)
// buffer than K2 / K2-dW.
//
// Windows that do not fit (K2-dW from M = 80 at D = 128, K2 from M = 96,
// every variant at D = 256): layer_bwd_plan moves the scratch, then RES,
// then q|k|v to the block's workspace slice, and K2 runs one block per SM
// looping over the atoms (K2-dW's grid already does).

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
    LayerI8 s8;            // K2-W8A8: the int8 weights and scales
    const float* i8_scales;  // int8 scores: (A, 2) s_q, s_k
    SmemPlan plan;         // layer_bwd_plan
    float* ws;             // (gridDim.x, plan.ws_floats) or nullptr
};

template <typename T>
__device__ AtomIO<T> atom_io(const LayerBwdArgs<T>& p, long long a) {
    const long long rows = a * p.M * p.D;
    return AtomIO<T>{p.edges + rows, p.center + a * p.D, p.cf + a * p.M, p.g_edge + rows,
                     p.g_center + a * p.D, p.d_edges + rows, p.d_center + a * p.D,
                     p.d_cf + a * p.M, false};
}

// K2 and its variants without dW: block b runs atoms b, b + grid, ... (one
// atom per block where every buffer is shared: grid = A). K2-dW: a fixed
// grid, block b walks atoms [b A / grid, (b + 1) A / grid) and sums their
// weight gradients into partial b.
template <typename T, bool DW, bool W8, bool I8, bool SH>
__global__ void __launch_bounds__(kThreads) fused_layer_bwd_kernel(LayerBwdArgs<T> p) {
    extern __shared__ __align__(16) float smem[];
    const BwdBufs b = BwdBufs::make<SH>(p.plan, smem, p.ws + blockIdx.x * p.plan.ws_floats);
    float* P = nullptr;
    long long a0 = blockIdx.x, a1 = p.A, step = gridDim.x;
    if constexpr (DW) {
        const long long total = DwLayout(p.D, p.F).total;
        P = p.partials + blockIdx.x * total;
        zero_floats(P, total);
        __syncthreads();
        a0 = p.A * blockIdx.x / gridDim.x, a1 = p.A * (blockIdx.x + 1) / gridDim.x, step = 1;
    }
    for (long long a = a0; a < a1; a += step) {
        ScoresI8 i8;
        if constexpr (I8) i8 = scores_i8(p.i8_scales + 2 * a, p.scale);
        layer_bwd_atom<T, DW, W8, I8>(p.w, atom_io(p, a), p.M, p.D, p.H, p.F, p.scale, p.eps, b,
                                      P, p.s8, i8);
        __syncthreads();
    }
}

template <typename T, bool DW, bool W8, bool I8, bool SH>
int launch_plan(const LayerBwdArgs<T>& p, unsigned grid, cudaStream_t stream) {
    const size_t bytes = p.plan.smem_floats * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(fused_layer_bwd_kernel<T, DW, W8, I8, SH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    fused_layer_bwd_kernel<T, DW, W8, I8, SH><<<grid, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T, bool DW, bool W8 = false, bool I8 = false>
int launch(LayerBwdArgs<T> p, unsigned grid, float* ws, cudaStream_t stream) {
    p.plan = layer_bwd_plan(p.M, p.D, p.H, p.F, DW, W8 || I8);
    p.ws = ws;
    if (p.plan.ws_floats == 0) return launch_plan<T, DW, W8, I8, true>(p, grid, stream);
    return launch_plan<T, DW, W8, I8, false>(p, grid, stream);
}

// grid: the blocks of K2 (A, or fewer with a workspace), or of K2-dW.
template <typename T, bool I8 = false>
int dispatch(const LayerBwdArgs<T>& p, int grid, float* ws, float* dw, cudaStream_t stream) {
    if (dw == nullptr) return launch<T, false, false, I8>(p, (unsigned)grid, ws, stream);
    const int err = launch<T, true, false, I8>(p, (unsigned)grid, ws, stream);
    if (err != 0) return err;
    return launch_sum_partials(p.partials, grid, DwLayout(p.D, p.F).total, dw, stream);
}

size_t plan_bytes(int M, int D, int H, int F, bool dw, bool q8, long long* ws_floats) {
    const SmemPlan plan = layer_bwd_plan(M, D, H, F, dw, q8);
    if (ws_floats != nullptr) *ws_floats = plan.ws_floats;
    return plan.smem_floats * sizeof(float);
}

}  // namespace
}  // namespace mtt

// Shared-memory bytes of K2 (dw = 0) or K2-dW (dw = 1); with ws_floats, the
// floats of workspace per block (0: every buffer is shared).
extern "C" size_t mtt_fused_layer_bwd_smem(int M, int D, int H, int F, int dw, long long* ws_floats) {
    return mtt::plan_bytes(M, D, H, F, dw != 0, false, ws_floats);
}

extern "C" size_t mtt_fused_layer_bwd_w8a8_smem(int M, int D, int H, int F, long long* ws_floats) {
    return mtt::plan_bytes(M, D, H, F, false, true, ws_floats);
}

extern "C" size_t mtt_fused_layer_bwd_int8_smem(int M, int D, int H, int F, int dw,
                                                long long* ws_floats) {
    return mtt::plan_bytes(M, D, H, F, dw != 0, true, ws_floats);
}

#define MTT_BWD_W(T)                                                                          \
    mtt::LayerBwdW<T>{(const T*)norm_attn, (const T*)w_qkv, (const T*)b_qkv, (const T*)w_out, \
                      (const T*)b_out, (const T*)norm_mlp, (const T*)w_in, (const T*)b_in,    \
                      (const T*)w_qkv_t, (const T*)w_out_t, (const T*)w_in_t,                 \
                      (const T*)w_ffn_out_t}

// dtype: 0 = float32, 1 = bfloat16. dw == nullptr launches K2 with grid
// blocks; otherwise K2-dW with grid blocks, partials (grid, n_dw) floats of
// scratch, and dw (n_dw floats, LayerWeights order) receiving the weight
// gradients. ws: grid x the ws_floats of mtt_fused_layer_bwd_smem, or null
// when it is 0. Returns the CUDA error code (0 = ok).
extern "C" int mtt_fused_layer_bwd(
    int dtype, const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* norm_mlp,
    const void* w_in, const void* b_in,
    const void* w_qkv_t, const void* w_out_t, const void* w_in_t, const void* w_ffn_out_t,
    const void* g_edge, const void* g_center,
    void* d_edges, void* d_center, float* d_cf,
    float* partials, float* dw,
    long long A, int M, int D, int H, int F, float scale, float eps, int grid, float* ws,
    void* stream) {
#define MTT_ARGS(T)                                                                     \
    mtt::LayerBwdArgs<T>{(const T*)edges, (const T*)center, cf, MTT_BWD_W(T),           \
                         (const T*)g_edge, (const T*)g_center, (T*)d_edges,             \
                         (T*)d_center, d_cf, partials, A, M, D, H, F, scale, eps}
    if (A == 0) return dw == nullptr ? 0 : (int)cudaMemsetAsync(dw, 0, mtt::DwLayout(D, F).total * sizeof(float), (cudaStream_t)stream);
    if (dtype == 0) return mtt::dispatch(MTT_ARGS(float), grid, ws, dw, (cudaStream_t)stream);
    return mtt::dispatch(MTT_ARGS(__nv_bfloat16), grid, ws, dw, (cudaStream_t)stream);
}

// K2-W8A8, bfloat16 only: K2's arguments (no weight gradients), the int8
// copies of w_qkv and w_in transposed to (out, in), and the 11 static scales
// in LayerI8's order (the recompute's scores take the last, with the
// attention scale folded in; the gradient products take scale).
extern "C" int mtt_fused_layer_bwd_w8a8(
    const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* norm_mlp,
    const void* w_in, const void* b_in,
    const void* w_qkv_t, const void* w_out_t, const void* w_in_t, const void* w_ffn_out_t,
    const void* w_qkv_i8_t, const void* w_in_i8_t, const float* scales,
    const void* g_edge, const void* g_center,
    void* d_edges, void* d_center, float* d_cf,
    long long A, int M, int D, int H, int F, float scale, float eps, int grid, float* ws,
    void* stream) {
    using T = __nv_bfloat16;
    float* partials = nullptr;  // no weight gradients
    mtt::LayerBwdArgs<T> p = MTT_ARGS(T);
    p.s8 = mtt::layer_i8(w_qkv_i8_t, w_in_i8_t, nullptr, scales);
    if (A == 0) return 0;
    return mtt::launch<T, false, true>(p, (unsigned)grid, ws, (cudaStream_t)stream);
}

// K2-int8 (dw == nullptr) and K2-dW-int8, bfloat16 only: mtt_fused_layer_bwd's
// arguments and the (A, 2) float32 scales K1-int8 took. The shared memory is
// mtt_fused_layer_bwd_int8_smem's.
extern "C" int mtt_fused_layer_bwd_int8(
    const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* norm_mlp,
    const void* w_in, const void* b_in,
    const void* w_qkv_t, const void* w_out_t, const void* w_in_t, const void* w_ffn_out_t,
    const float* i8_scales, const void* g_edge, const void* g_center,
    void* d_edges, void* d_center, float* d_cf,
    float* partials, float* dw,
    long long A, int M, int D, int H, int F, float scale, float eps, int grid, float* ws,
    void* stream) {
    using T = __nv_bfloat16;
    if (A == 0) return dw == nullptr ? 0 : (int)cudaMemsetAsync(dw, 0, mtt::DwLayout(D, F).total * sizeof(float), (cudaStream_t)stream);
    mtt::LayerBwdArgs<T> p = MTT_ARGS(T);
    p.i8_scales = i8_scales;
    return mtt::dispatch<T, true>(p, grid, ws, dw, (cudaStream_t)stream);
}
#undef MTT_ARGS
#undef MTT_BWD_W
