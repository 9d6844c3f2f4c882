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
    int L, M, D, H, F, Nn;
    bool expanded;
    float scale, eps;
};

__host__ __device__ inline size_t gnn_fwd_floats(int M, int D, int F, int Nn) {
    return layer_fwd_floats(M, D, F) + center_fwd_floats(Nn, D);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gnn_block_fwd_kernel(GnnFwdArgs<T> p) {
    extern __shared__ __align__(16) float smem[];
    const int M = p.M, D = p.D, Nn = p.Nn;
    const long long a = blockIdx.x;
    float* X = smem;
    float* CF = layer_fwd_cf(smem, M, D, p.F);
    const CenterSmem c(smem + layer_fwd_floats(M, D, p.F), Nn, D);
    const T* e = p.edges + a * M * D;
    for (int i = threadIdx.x; i < (M - 1) * D; i += blockDim.x) X[i] = to_f(e[i]);
    for (int i = threadIdx.x; i < M; i += blockDim.x) CF[i] = p.cf[a * M + i];
    for (int i = threadIdx.x; i < Nn; i += blockDim.x) c.node[i] = to_f(p.node[a * Nn + i]);
    __syncthreads();

    float* slot = X + (M - 1) * D;
    const CenterRows none(Nn, D);
    for (int l = 0; l < p.L; ++l) {
        if (p.expanded) {
            center_contract<T>(p.center[l], c, Nn, D, slot, nullptr);
        } else {
            for (int d = threadIdx.x; d < D; d += blockDim.x) slot[d] = c.node[d];
        }
        __syncthreads();
        const bool last = l == p.L - 1;
        layer_fwd_atom<T>(smem, p.layer[l], M, D, p.H, p.F, p.scale, p.eps, nullptr, c.cattn,
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
}

template <typename T>
int launch(const GnnFwdArgs<T>& p, long long A, cudaStream_t stream) {
    const size_t bytes = gnn_fwd_floats(p.M, p.D, p.F, p.Nn) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        gnn_block_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    gnn_block_fwd_kernel<T><<<(unsigned)A, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
int run(const void* edges, const void* node, const float* cf, const void* const* layer_w,
        const void* const* center_w, void* edge_out, void* node_out, long long A, int L, int M,
        int D, int H, int F, int Nn, int expanded, float scale, float eps, cudaStream_t stream) {
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
    return launch(p, A, stream);
}

}  // namespace
}  // namespace mtt

extern "C" size_t mtt_gnn_block_fwd_smem(int M, int D, int F, int Nn) {
    return mtt::gnn_fwd_floats(M, D, F, Nn) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. layer_w: L x 10 pointers (LayerWeights
// order per layer); center_w: L x 9 (CenterWeights order), read only with
// expanded. 1 <= L <= 8. Returns the CUDA error code (0 = ok).
extern "C" int mtt_gnn_block_fwd(
    int dtype, const void* edges, const void* node, const float* cf,
    const void* const* layer_w, const void* const* center_w, void* edge_out, void* node_out,
    long long A, int L, int M, int D, int H, int F, int Nn, int expanded, float scale, float eps,
    void* stream) {
    if (L < 1 || L > mtt::kMaxGnnLayers) return (int)cudaErrorInvalidValue;
    if (A == 0) return 0;
    if (dtype == 0)
        return mtt::run<float>(edges, node, cf, layer_w, center_w, edge_out, node_out, A, L, M, D,
                               H, F, Nn, expanded, scale, eps, (cudaStream_t)stream);
    return mtt::run<__nv_bfloat16>(edges, node, cf, layer_w, center_w, edge_out, node_out, A, L,
                                   M, D, H, F, Nn, expanded, scale, eps, (cudaStream_t)stream);
}
