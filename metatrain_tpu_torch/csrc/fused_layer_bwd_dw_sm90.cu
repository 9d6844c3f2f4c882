// K2-dW on Hopper: the fused PET transformer layer's training backward,
// its input gradients and the weight gradients summed over atoms, in two
// passes: the per-atom body streams each row's weight-gradient operands
// out once, then a deterministic split-K product forms dW = X^T dY.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/fused_layer.py
// `_bwd_kernel` (pallas_call in `_make_bwd_op`) with weight_grads=True, in
// float32 and bfloat16, and with the dynamic int8 scores (K2-dW-int8,
// bfloat16): the same function as K2-dW's accumulate body
// (fused_layer_bwd.cu) and its plain version `layer_bwd_math(...,
// weight_grads=True)`. The TPU kernel revisits one VMEM accumulator on a
// sequential grid; 132 SMs run in no order, so the sum over atoms needs a
// second pass.
//
// What bounds it on the H100: operations (at A = 11,392 atoms, M = 64, D =
// 128, F = 256: the recompute, the input-gradient products and the four
// X^T dY products, 11.8 ms in float32 at 67 TFLOP/s, 0.80 ms in bf16 at
// 989). The accumulate body adds each atom's products into its block's
// float partial in global memory (4 updates per atom of w_in and w_ffn_out
// at M = 64, ~3.7 MB of traffic per atom, ~42 GB a launch: 132 partials of
// 662 KB do not fit the 50 MB L2) on FMA tiles 16 or M rows deep, even in
// bf16. Here:
// - pass 1 (dw_pass1_kernel) runs layer_bwd.cuh's body in its spill mode
//   on K2's grid (one block per atom where every buffer is shared, else one
//   per SM over the atoms with its workspace slice): d_edges, d_center and
//   d_cf as the accumulate body gives them, and each row's n1, d_qkv,
//   attn, d_attn_out, h_norm, d_vg and ffn_h written once in the compute
//   dtype (7D + 3F values a row: 6.5 KB in float32, 3.3 KB in bf16), plus
//   one float row per atom of its norm-scale and bias sums. g_eo is not
//   copied: pass 2 reads the cotangent with slot M - 1 as zero.
// - pass 2 (layer_dw_sm90.cuh) cuts the chunk's rows into a fixed number
//   of slices; block (tile, slice) writes the partial of one 128 x 128
//   output tile over one slice: float32 on 8 x 8 FFMA register tiles
//   (cp.async, three stages), bf16 on wgmma with both operands MN-major in
//   shared memory (the spilled rows are K). The vector rows are summed per
//   slice the same way; a last pass adds the slices in order.
// - the spill stays under 512 MiB: the atoms run in chunks (each pass 1,
//   then pass 2), and the chunks' sums are added in chunk order. Every
//   order is fixed by the shape and the SM count: the same bits in every
//   launch.
// The spill's traffic (written once, read about twice, ~10 GB a float32
// launch at the shape above) is this design's own cost; the bound stays
// the function's.

#include "layer_dw_sm90.cuh"

namespace mtt {
namespace {

template <typename T>
struct Pass1Args {
    const T* edges;
    const T* center;
    const float* cf;
    LayerBwdW<T> w;
    const T* g_edge;
    const T* g_center;
    T* d_edges;
    T* d_center;
    float* d_cf;
    const float* i8_scales;  // int8 scores: (A, 2)
    long long a0, a1;        // the chunk's atoms
    int M, D, H, F;
    float scale, eps;
    DwSpill<T> sp;           // the chunk's spill
    SmemPlan plan;           // K2's layout plan (no weight-gradient buffers)
    float* ws;
};

// p is grid-constant: the body reads the spill's pointers from the
// parameters where it writes, instead of holding them in registers.
template <typename T, bool I8, bool SH>
__global__ void __launch_bounds__(kThreads) dw_pass1_kernel(const __grid_constant__ Pass1Args<T> p) {
    extern __shared__ __align__(16) float smem[];
    const BwdBufs b = BwdBufs::make<SH>(p.plan, smem, p.ws + blockIdx.x * p.plan.ws_floats);
    for (long long a = p.a0 + blockIdx.x; a < p.a1; a += gridDim.x) {
        const int j = (int)(a - p.a0);
        const long long rows = a * p.M * p.D;
        const AtomIO<T> io{p.edges + rows, p.center + a * p.D, p.cf + a * p.M, p.g_edge + rows,
                           p.g_center + a * p.D, p.d_edges + rows, p.d_center + a * p.D,
                           p.d_cf + a * p.M, false};
        ScoresI8 i8;
        if constexpr (I8) i8 = scores_i8(p.i8_scales + 2 * a, p.scale);
        layer_bwd_atom<T, true, false, I8, true>(p.w, io, p.M, p.D, p.H, p.F, p.scale, p.eps, b, nullptr,
                                                 {}, i8, &p.sp, j);
        __syncthreads();
    }
}

template <typename T, bool I8, bool SH>
int launch_pass1(const Pass1Args<T>& p, unsigned grid, cudaStream_t stream) {
    const size_t bytes = p.plan.smem_floats * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(dw_pass1_kernel<T, I8, SH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    dw_pass1_kernel<T, I8, SH><<<grid, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

// Every chunk: pass 1 (grid: one block per atom where the plan keeps every
// buffer shared, else at most ws_blocks blocks over the chunk's atoms),
// then pass 2 into dw.
template <typename T, bool I8>
int run(Pass1Args<T> p, long long A, int ws_blocks, int sms, float* partials, float* dw,
        unsigned char* spill, cudaStream_t stream) {
    p.plan = layer_bwd_plan(p.M, p.D, p.H, p.F, false, I8);
    const dwp::Plan plan = dwp::make_plan((int)sizeof(T), A, p.M, p.D, p.F, sms);
    p.sp = DwSpill<T>{reinterpret_cast<T*>(spill), reinterpret_cast<float*>(spill + plan.vec_offset),
                      plan.chunk_atoms * p.M};
    for (long long c = 0; c < plan.chunks; ++c) {
        p.a0 = c * plan.chunk_atoms;
        p.a1 = p.a0 + plan.chunk_atoms < A ? p.a0 + plan.chunk_atoms : A;
        const long long atoms = p.a1 - p.a0;
        int err;
        if (p.plan.ws_floats == 0) {
            err = launch_pass1<T, I8, true>(p, (unsigned)atoms, stream);
        } else {
            const long long grid = atoms < ws_blocks ? atoms : ws_blocks;
            err = launch_pass1<T, I8, false>(p, (unsigned)grid, stream);
        }
        if (err != 0) return err;
        const dwp::ProductArgs<T> a = dwp::product_args<T>(p.sp.rows, p.sp.R, p.g_edge + p.a0 * p.M * p.D,
                                                           atoms * p.M, p.M, p.D, p.F, sms, partials);
        err = dwp::run_products<T>(a, p.sp.vec, atoms, dw, c == 0, stream);
        if (err != 0) return err;
    }
    return 0;
}

bool takes(int dtype, int M, int D, int H, int F, int int8) {
    return (dtype == 0 || dtype == 1) && (!int8 || dtype == 1) && M % 16 == 0 && M >= 16 && M <= 256 &&
           H > 0 && D % H == 0 && dwp::product_shape(D, F);
}

}  // namespace
}  // namespace mtt

// Whether the two-pass K2-dW takes the shape (dtype 0 = float32, 1 =
// bfloat16; int8: the dynamic int8 scores, bfloat16 only).
extern "C" int mtt_fused_layer_bwd_dw_sm90_ok(int dtype, int M, int D, int H, int F, int int8) {
    return mtt::takes(dtype, M, D, H, F, int8) ? 1 : 0;
}

// The plan for A atoms on a card of `sms` SMs (elem_bytes: 4 or 2) into
// out: atoms per chunk, chunks, the vector rows' byte offset, the spill's
// bytes, the partials' rows.
extern "C" void mtt_fused_layer_bwd_dw_sm90_plan(int elem_bytes, long long A, int M, int D, int F, int sms,
                                                 long long* out) {
    const mtt::dwp::Plan p = mtt::dwp::make_plan(elem_bytes, A, M, D, F, sms);
    out[0] = p.chunk_atoms;
    out[1] = p.chunks;
    out[2] = p.vec_offset;
    out[3] = p.spill_bytes;
    out[4] = p.max_slices;
}

// The rows per slice and the slices of a chunk of R rows.
extern "C" void mtt_layer_dw_slices(long long R, int D, int F, int sms, long long* out) {
    out[0] = mtt::dwp::slice_step(R, D, F, sms);
    out[1] = (R + out[0] - 1) / out[0];
}

#define MTT_BWD_W(T)                                                                          \
    mtt::LayerBwdW<T>{(const T*)norm_attn, (const T*)w_qkv, (const T*)b_qkv, (const T*)w_out, \
                      (const T*)b_out, (const T*)norm_mlp, (const T*)w_in, (const T*)b_in,    \
                      (const T*)w_qkv_t, (const T*)w_out_t, (const T*)w_in_t,                 \
                      (const T*)w_ffn_out_t}

// dtype: 0 = float32, 1 = bfloat16; i8_scales: (A, 2) float32 for the
// int8 scores (bfloat16), else null. dw: n_dw floats (LayerWeights order)
// receiving the weight gradients. spill: the plan's spill_bytes; partials:
// (max_slices, n_dw) floats; ws: ws_blocks x K2's workspace floats
// (mtt_fused_layer_bwd_smem / _int8_smem with dw = 0), or null when that is
// 0. Returns the CUDA error code (0 = ok).
extern "C" int mtt_fused_layer_bwd_dw_sm90(
    int dtype, const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, const void* norm_mlp,
    const void* w_in, const void* b_in,
    const void* w_qkv_t, const void* w_out_t, const void* w_in_t, const void* w_ffn_out_t,
    const float* i8_scales, const void* g_edge, const void* g_center,
    void* d_edges, void* d_center, float* d_cf, float* dw,
    void* spill, float* partials, float* ws,
    long long A, int M, int D, int H, int F, float scale, float eps, int ws_blocks, int sms,
    void* stream) {
    if (!mtt::takes(dtype, M, D, H, F, i8_scales != nullptr)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (A == 0) return (int)cudaMemsetAsync(dw, 0, mtt::DwLayout(D, F).total * sizeof(float), s);
#define MTT_PASS1(T)                                                                              \
    mtt::Pass1Args<T>{(const T*)edges, (const T*)center, cf, MTT_BWD_W(T), (const T*)g_edge,     \
                      (const T*)g_center, (T*)d_edges, (T*)d_center, d_cf, i8_scales, 0, 0, M, D, \
                      H, F, scale, eps, {}, {}, ws}
    unsigned char* sp = (unsigned char*)spill;
    if (dtype == 0) return mtt::run<float, false>(MTT_PASS1(float), A, ws_blocks, sms, partials, dw, sp, s);
    if (i8_scales == nullptr)
        return mtt::run<__nv_bfloat16, false>(MTT_PASS1(__nv_bfloat16), A, ws_blocks, sms, partials, dw, sp, s);
    return mtt::run<__nv_bfloat16, true>(MTT_PASS1(__nv_bfloat16), A, ws_blocks, sms, partials, dw, sp, s);
#undef MTT_PASS1
}
#undef MTT_BWD_W

// Pass 2 alone on one chunk of given rows (for checks against its plain
// version): spill holds the operand rows of `atoms` atoms (a DwSpill of
// atoms x M rows), vec their vector rows; g_edge the chunk's cotangent. dw
// receives the chunk's weight gradients.
extern "C" int mtt_layer_dw_product(int dtype, const void* spill, const float* vec, const void* g_edge,
                                    long long atoms, int M, int D, int F, int sms, float* partials,
                                    float* dw, void* stream) {
    if ((dtype != 0 && dtype != 1) || !mtt::dwp::product_shape(D, F) || atoms <= 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const long long R = atoms * M;
    if (dtype == 0) {
        const auto a = mtt::dwp::product_args<float>((const float*)spill, R, (const float*)g_edge, R, M, D, F,
                                                     sms, partials);
        return mtt::dwp::run_products<float>(a, vec, atoms, dw, true, s);
    }
    using bf = __nv_bfloat16;
    const auto a = mtt::dwp::product_args<bf>((const bf*)spill, R, (const bf*)g_edge, R, M, D, F, sms, partials);
    return mtt::dwp::run_products<bf>(a, vec, atoms, dw, true, s);
}
