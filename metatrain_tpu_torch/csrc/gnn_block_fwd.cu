// Fused GNN block, forward: every attention layer of one GNN layer and the
// node stream between them, in one kernel.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/fused_layer.py
// `_gnn_fwd_kernel` (entered through `_gnn_forward_impl` /
// `fused_gnn_block`, body `_gnn_block_math`). Per attention layer l: with
// the node expansion (N != D) the center token is contracted from the
// node features; the layer runs as K1 (layer_fwd.cuh); the node features
// are updated from the center's attention output (gnn_block.cuh); without
// the expansion the node is the center's attention output itself.
//
// What bounds it on the H100: the layers do K1's work (~23 MFLOP per atom
// and layer at M = 64, on FMA loops in f32 and mma.sync in bf16), the same
// instruction-bound body as K1; the node stream is one row per atom times
// 0.9 MB of bf16 weights per layer (1.8 MB in f32), read from L2 by every
// block: ~21 GB of L2 reads per launch at A = 11,392, L = 2. What the
// kernel saves is device memory traffic: one thread block per atom keeps
// the edge block in shared memory from layer to layer (K1's layout, ~182
// KB at M = 64, D = 128, plus ~14 KB for the node stream), so device
// memory sees one read and one write of the (M, D) edges per GNN layer
// instead of one per attention layer. Next steps: several atoms per block,
// or a cluster sharing each weight tile through distributed shared
// memory, so the node stream's weights are read once per group of atoms.

#include "gnn_block.cuh"

namespace mtt {
namespace {

template <typename T>
struct GnnFwdArgs {
    const T* edges;   // (A, M, D)
    const T* node;    // (A, Nn), Nn = N with the expansion, D without
    const float* cf;  // (A, M), cf[:, M-1] == 1
    LayerW<T> layer[kMaxGnnLayers];
    CenterW<T> center[kMaxGnnLayers];
    T* edge_out;      // (A, M, D)
    T* node_out;      // (A, Nn)
    long long A;
    int L, M, D, H, F, Nn;
    bool expanded;
    float scale, eps;
    SmemPlan plan;    // K1's body, under the node stream's shared memory
    float* ws;        // (gridDim.x, plan.ws_floats) or nullptr
};

// Block b runs atoms b, b + grid, ... (grid = A where every buffer is
// shared).
template <typename T, bool SH>
__global__ void __launch_bounds__(kThreads) gnn_block_fwd_kernel(GnnFwdArgs<T> p) {
    extern __shared__ __align__(16) float smem[];
    const int M = p.M, D = p.D, Nn = p.Nn;
    const FwdBufs b = FwdBufs::make<SH>(p.plan, smem, p.ws + blockIdx.x * p.plan.ws_floats);
    const CenterSmem c(smem + p.plan.smem_floats, Nn, D);
    const CenterRows none(Nn, D);
    float* slot = b.X + (M - 1) * D;
    for (long long a = blockIdx.x; a < p.A; a += gridDim.x) {
        const T* e = p.edges + a * M * D;
        for (int i = threadIdx.x; i < (M - 1) * D; i += blockDim.x) b.X[i] = to_f(e[i]);
        for (int i = threadIdx.x; i < M; i += blockDim.x) b.CF[i] = p.cf[a * M + i];
        for (int i = threadIdx.x; i < Nn; i += blockDim.x) c.node[i] = to_f(p.node[a * Nn + i]);
        __syncthreads();
        for (int l = 0; l < p.L; ++l) {
            if (p.expanded) {
                center_contract<T>(p.center[l], c, Nn, D, slot, nullptr);
            } else {
                for (int d = threadIdx.x; d < D; d += blockDim.x) slot[d] = c.node[d];
            }
            __syncthreads();
            const bool last = l == p.L - 1;
            layer_fwd_atom<T>(b, p.layer[l], M, D, p.H, p.F, p.scale, p.eps, nullptr, c.cattn,
                              last ? p.edge_out + a * M * D : nullptr, !last);
            __syncthreads();
            if (p.expanded) {
                center_update<T>(p.center[l], c, Nn, D, p.eps, nullptr, none);
            } else {
                for (int d = threadIdx.x; d < D; d += blockDim.x) c.node[d] = c.cattn[d];
                __syncthreads();
            }
        }
        for (int i = threadIdx.x; i < Nn; i += blockDim.x) p.node_out[a * Nn + i] = from_f<T>(c.node[i]);
        __syncthreads();
    }
}

template <typename T, bool SH>
int launch_plan(const GnnFwdArgs<T>& p, int grid, cudaStream_t stream) {
    const size_t bytes = (p.plan.smem_floats + center_fwd_floats(p.Nn, p.D)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        gnn_block_fwd_kernel<T, SH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    gnn_block_fwd_kernel<T, SH><<<(unsigned)grid, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(GnnFwdArgs<T>& p, int grid, cudaStream_t stream) {
    p.plan = gnn_fwd_plan(p.M, p.D, p.F, p.Nn);
    if (p.plan.ws_floats == 0) return launch_plan<T, true>(p, grid, stream);
    return launch_plan<T, false>(p, grid, stream);
}

template <typename T>
int run(const void* edges, const void* node, const float* cf, const void* const* layer_w,
        const void* const* center_w, void* edge_out, void* node_out, long long A, int L, int M,
        int D, int H, int F, int Nn, int expanded, float scale, float eps, int grid, float* ws,
        cudaStream_t stream) {
    GnnFwdArgs<T> p{};
    p.edges = (const T*)edges;
    p.node = (const T*)node;
    p.cf = cf;
    for (int l = 0; l < L; ++l) {
        const T* const* w = (const T* const*)layer_w + 10 * l;
        p.layer[l] = LayerW<T>{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], w[9]};
        if (expanded) {
            const T* const* c = (const T* const*)center_w + 9 * l;
            p.center[l] = CenterW<T>{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8]};
        }
    }
    p.edge_out = (T*)edge_out;
    p.node_out = (T*)node_out;
    p.L = L, p.M = M, p.D = D, p.H = H, p.F = F, p.Nn = Nn;
    p.expanded = expanded != 0;
    p.scale = scale, p.eps = eps;
    p.A = A;
    p.ws = ws;
    return launch(p, grid, stream);
}

}  // namespace
}  // namespace mtt

// Shared-memory bytes of the block's forward; with ws_floats, the floats
// of workspace per block (0: every buffer is shared).
extern "C" size_t mtt_gnn_block_fwd_smem(int M, int D, int F, int Nn, long long* ws_floats) {
    const mtt::SmemPlan plan = mtt::gnn_fwd_plan(M, D, F, Nn);
    if (ws_floats != nullptr) *ws_floats = plan.ws_floats;
    return (plan.smem_floats + mtt::center_fwd_floats(Nn, D)) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. layer_w: L x 10 pointers (LayerWeights
// order per layer); center_w: L x 9 (CenterWeights order), read only with
// expanded. 1 <= L <= 8. grid: A, or with a workspace (ws: grid x the
// ws_floats of mtt_gnn_block_fwd_smem) the blocks that loop over the atoms.
// Returns the CUDA error code (0 = ok).
extern "C" int mtt_gnn_block_fwd(
    int dtype, const void* edges, const void* node, const float* cf,
    const void* const* layer_w, const void* const* center_w, void* edge_out, void* node_out,
    long long A, int L, int M, int D, int H, int F, int Nn, int expanded, float scale, float eps,
    int grid, float* ws, void* stream) {
    if (L < 1 || L > mtt::kMaxGnnLayers) return (int)cudaErrorInvalidValue;
    if (A == 0) return 0;
    if (dtype == 0)
        return mtt::run<float>(edges, node, cf, layer_w, center_w, edge_out, node_out, A, L, M, D,
                               H, F, Nn, expanded, scale, eps, grid, ws, (cudaStream_t)stream);
    return mtt::run<__nv_bfloat16>(edges, node, cf, layer_w, center_w, edge_out, node_out, A, L,
                                   M, D, H, F, Nn, expanded, scale, eps, grid, ws,
                                   (cudaStream_t)stream);
}
