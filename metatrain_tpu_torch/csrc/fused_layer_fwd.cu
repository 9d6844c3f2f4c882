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
//
// K1-W8A8 (mtt_fused_layer_fwd_w8a8, bfloat16 only): the same kernel with
// the body's W8 flag, the TPU kernel's static W8A8 branch (`_fwd_kernel`
// with `calib`, `_layer_math` with w8a8). The QKV, score, FFN-in and
// FFN-out products run on int8 tensor cores (mma.sync m16n8k32, the scores
// m16n8k16 over a head of 16) against int8 weights quantized once per call
// by the wrapper and stored transposed; the activations are quantized by
// static scales as their fragments are loaded from shared memory, so it
// needs no more shared memory than K1. Bound on the H100: ~20 M int8
// products per atom at M=64 (at 1,979 TOPS) and ~3 M bf16 ones (AV,
// out-projection); the FMA softmax and AV loops and the L2 weight stream
// are where K1's time goes, and they stay.
//
// K1-int8 (mtt_fused_layer_fwd_int8, bfloat16 only): the body's I8 flag,
// the TPU kernel's dynamic int8 scores (`_fwd_kernel` with `int8`,
// `_qside_scores`): K1, but each head's scores are the s8 mma.sync product
// of q and k quantized, as their fragments load, by the scales of the
// atom's block of atoms (int8_absmax.cu computes them in a pass before),
// then the W8A8 softmax. Its bound is K1's less a tenth (the score
// products at the int8 rate); its time is K1's.
//
// Windows that do not fit: layer_fwd_plan moves q|k|v (then the scores, N,
// X) to a per-block slice of a global workspace, and the grid becomes one
// block per SM looping over the atoms, so every M up to 256 and D up to 256
// runs; below ~227 KB the layout and the grid are unchanged.

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
    long long A;
    int M, D, H, F;
    float scale, eps;
    LayerI8 s8;                // the W8A8 variant's int8 weights and scales
    const float* i8_scales;    // the int8-scores variant's (A, 2) s_q, s_k
    SmemPlan plan;             // layer_fwd_plan
    float* ws;                 // (gridDim.x, plan.ws_floats) or nullptr
};

// Block b runs atoms b, b + grid, ...: one atom per block where every
// buffer fits in shared memory (grid = A), else a grid of resident blocks,
// each with its workspace slice.
template <typename T, bool W8, bool I8, bool SH>
__global__ void __launch_bounds__(kThreads) fused_layer_fwd_kernel(LayerArgs<T> p) {
    extern __shared__ __align__(16) float smem[];
    const int M = p.M, D = p.D;
    const FwdBufs b = FwdBufs::make<SH>(p.plan, smem, p.ws + blockIdx.x * p.plan.ws_floats);
    for (long long a = blockIdx.x; a < p.A; a += gridDim.x) {
        const T* e = p.edges + a * M * D;
        for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
            const int m = i / D;
            b.X[i] = m == M - 1 ? to_f(p.center[a * D + i % D]) : to_f(e[i]);
        }
        for (int i = threadIdx.x; i < M; i += blockDim.x) b.CF[i] = p.cf[a * M + i];
        __syncthreads();
        ScoresI8 i8;
        if constexpr (I8) i8 = scores_i8(p.i8_scales + 2 * a, p.scale);
        layer_fwd_atom<T, W8, I8>(b, p.w, M, D, p.H, p.F, p.scale, p.eps, p.center_out + a * D,
                                  nullptr, p.edge_out + a * M * D, false, p.s8, i8);
        __syncthreads();
    }
}

template <typename T, bool W8, bool I8, bool SH>
int launch_plan(const LayerArgs<T>& p, int grid, cudaStream_t stream) {
    const size_t bytes = p.plan.smem_floats * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(fused_layer_fwd_kernel<T, W8, I8, SH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    fused_layer_fwd_kernel<T, W8, I8, SH><<<(unsigned)grid, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T, bool W8 = false, bool I8 = false>
int launch(LayerArgs<T> p, int grid, float* ws, cudaStream_t stream) {
    p.plan = layer_fwd_plan(p.M, p.D, p.F);
    p.ws = ws;
    if (p.plan.ws_floats == 0) return launch_plan<T, W8, I8, true>(p, grid, stream);
    return launch_plan<T, W8, I8, false>(p, grid, stream);
}

}  // namespace
}  // namespace mtt

// Shared-memory bytes of K1 and its variants (all take the same plan); with
// ws_floats, the floats of workspace per block (0: every buffer is shared).
extern "C" size_t mtt_fused_layer_fwd_smem(int M, int D, int F, long long* ws_floats) {
    const mtt::SmemPlan plan = mtt::layer_fwd_plan(M, D, F);
    if (ws_floats != nullptr) *ws_floats = plan.ws_floats;
    return plan.smem_floats * sizeof(float);
}

#define MTT_LAYER_W(T)                                                                       \
    mtt::LayerW<T>{(const T*)norm_attn, (const T*)w_qkv, (const T*)b_qkv, (const T*)w_out,  \
                   (const T*)b_out,     (const T*)norm_mlp, (const T*)w_in, (const T*)b_in,  \
                   (const T*)w_ffn_out, (const T*)b_ffn_out}

// dtype: 0 = float32, 1 = bfloat16. grid: A, or with a workspace (ws:
// grid x the ws_floats of mtt_fused_layer_fwd_smem) the blocks that loop
// over the atoms. Returns the CUDA error code (0 = ok).
extern "C" int mtt_fused_layer_fwd(
    int dtype, const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* norm_mlp,
    const void* w_in, const void* b_in, const void* w_ffn_out, const void* b_ffn_out,
    void* edge_out, void* center_out,
    long long A, int M, int D, int H, int F, float scale, float eps, int grid, float* ws,
    void* stream) {
#define MTT_ARGS(T)                                                                 \
    mtt::LayerArgs<T>{(const T*)edges, (const T*)center, cf, MTT_LAYER_W(T),        \
                      (T*)edge_out, (T*)center_out, A, M, D, H, F, scale, eps}
    if (A == 0) return 0;
    if (dtype == 0) return mtt::launch(MTT_ARGS(float), grid, ws, (cudaStream_t)stream);
    return mtt::launch(MTT_ARGS(__nv_bfloat16), grid, ws, (cudaStream_t)stream);
#undef MTT_ARGS
}

// K1-W8A8, bfloat16 only: the weights as for mtt_fused_layer_fwd (w_qkv,
// w_in and w_ffn_out are not read), their int8 copies transposed to (out,
// in), and the 11 static scales in LayerI8's order. The shared memory is
// mtt_fused_layer_fwd_smem's.
extern "C" int mtt_fused_layer_fwd_w8a8(
    const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* norm_mlp,
    const void* w_in, const void* b_in, const void* w_ffn_out, const void* b_ffn_out,
    const void* w_qkv_i8_t, const void* w_in_i8_t, const void* w_fo_i8_t, const float* scales,
    void* edge_out, void* center_out, long long A, int M, int D, int H, int F, float eps,
    int grid, float* ws, void* stream) {
    using T = __nv_bfloat16;
    const mtt::LayerArgs<T> p{
        (const T*)edges, (const T*)center, cf, MTT_LAYER_W(T), (T*)edge_out, (T*)center_out, A, M,
        D, H, F, 1.f, eps, mtt::layer_i8(w_qkv_i8_t, w_in_i8_t, w_fo_i8_t, scales)};
    if (A == 0) return 0;
    return mtt::launch<T, true>(p, grid, ws, (cudaStream_t)stream);
}

// K1-int8, bfloat16 only: K1's arguments and the (A, 2) float32 scales s_q,
// s_k of each atom's block (mtt_int8_absmax). The shared memory is
// mtt_fused_layer_fwd_smem's.
extern "C" int mtt_fused_layer_fwd_int8(
    const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* norm_mlp,
    const void* w_in, const void* b_in, const void* w_ffn_out, const void* b_ffn_out,
    const float* i8_scales, void* edge_out, void* center_out,
    long long A, int M, int D, int H, int F, float scale, float eps, int grid, float* ws,
    void* stream) {
    using T = __nv_bfloat16;
    mtt::LayerArgs<T> p{(const T*)edges, (const T*)center, cf, MTT_LAYER_W(T), (T*)edge_out,
                        (T*)center_out, A, M, D, H, F, scale, eps};
    p.i8_scales = i8_scales;
    if (A == 0) return 0;
    return mtt::launch<T, false, true>(p, grid, ws, (cudaStream_t)stream);
}
#undef MTT_LAYER_W
