// Fused GNN block, backward (input gradients) and its weight-gradient
// variant.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/fused_layer.py
// `_gnn_bwd_kernel` (entered through `_make_gnn_bwd_op` /
// `_fused_gnn_bwd`, body `_gnn_block_bwd_math`). One thread block per atom
// first recomputes the forward of all L attention layers (K1's body and
// the node stream, as gnn_block_fwd.cu), saving what the backward reads;
// then, layer by layer in reverse: the node stream's backward (GEMVs with
// the transposed weights), which gives the center token's cotangent; the
// layer's backward as K2 (layer_bwd.cuh); and the cotangent of the node
// features through the contraction. d_cf is summed over the layers.
//
// Shared memory is the limit: K2's body alone needs ~207 KB at M = 64 and
// K2-dW's ~231 KB of the 227 KB a block may have, so nothing else can stay
// resident beside it. What crosses from one phase to the next goes through
// a global scratch that the block writes and reads back itself: the edge
// inputs of layers 1..L-1 ((A, L-1, M, D): ~187 MB in bf16 at A = 11,392),
// the edge cotangents between layers, each layer's center token, its
// cotangent and d_center ((A, L, 3, D)), and the node stream's row vectors
// ((A, L, CenterRows) floats). K2's body reads its tokens from a global
// pointer anyway. The phases reuse one shared buffer, sized for the
// largest (K2's).
//
// Weight gradients (DW): the 10 layer weights of each layer as K2-dW, into
// per-block float partials (a fixed grid of one block per SM over
// contiguous atom ranges) summed in block order by a second pass. The 9
// node-stream weights of each layer are sums over atoms of outer products
// of row vectors (~460 K floats per layer at N = 256): instead of adding
// 1.8 MB per atom into the partials, each atom's row vectors stay in the
// row scratch, and a third kernel forms every X^T dY tile over all atoms in
// atom order (as K4-dW's tiles). Both sums are the same in every run; no
// atomics.

#include "gnn_block.cuh"
#include "layer_bwd.cuh"

namespace mtt {
namespace {

template <typename T>
struct GnnBwdArgs {
    const T* edges;    // (A, M, D)
    const T* node;     // (A, Nn)
    const float* cf;   // (A, M)
    LayerW<T> layer[kMaxGnnLayers];
    LayerBwdW<T> lbwd[kMaxGnnLayers];
    CenterW<T> center[kMaxGnnLayers];
    const T* g_edge;   // (A, M, D)
    const T* g_node;   // (A, Nn)
    T* d_edges;        // (A, M, D)
    T* d_node;         // (A, Nn)
    float* d_cf;       // (A, M)
    T* escr;           // (A, L-1, M, D): edge inputs of layers 1..L-1
    T* dscr;           // (nbuf, A, M, D): edge cotangents between layers
    T* vecs;           // (A, L, 3, D): center, its cotangent, d_center
    float* rows;       // (A, L, CenterRows.total), with the expansion
    float* partials;   // DW: (gridDim.x, L x n_dw) per-block layer weight gradients
    long long A;
    int L, M, D, H, F, Nn, nbuf;
    bool expanded;
    float scale, eps;
};

// The node stream's backward in shared memory (floats).
struct CenterBwdSmem {
    float *dn, *dnc, *dh, *dvg, *dhn, *dnm, *dnmc, *dc, *nmid, *vg, *sc;
    __device__ CenterBwdSmem(float* base, int N, int D) {
        dn = base;
        dnc = dn + N;
        dh = dnc + N;
        dvg = dh + 2 * N;
        dhn = dvg + 4 * N;
        dnm = dhn + N;
        dnmc = dnm + N;
        dc = dnmc + N;
        nmid = dc + D;
        vg = nmid + N;
        sc = vg + 4 * N;
    }
};

__host__ __device__ inline size_t center_bwd_floats(int N, int D) { return 16 * (size_t)N + D + 4; }

__host__ __device__ inline size_t gnn_bwd_floats(int M, int D, int H, int F, int Nn, bool dw) {
    size_t n = layer_fwd_floats(M, D, F) + center_fwd_floats(Nn, D);
    const size_t lb = layer_bwd_floats(M, D, H, F, dw), cb = center_bwd_floats(Nn, D);
    n = n > lb ? n : lb;
    return n > cb ? n : cb;
}

// Node stream backward of one layer, from b.dn (the node features'
// cotangent): writes the center output's cotangent to gc (global) and
// d_nmid (and, with DW, the weight-gradient rows) to rows.
template <typename T, bool DW>
__device__ void center_bwd(const CenterW<T>& cw, const CenterBwdSmem& b, int N, int D, float* rows,
                           const CenterRows& R, T* gc) {
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
        b.nmid[n] = rows[R.nmid + n];
        b.dnc[n] = rnd<T>(b.dn[n]);
        if (DW) {
            rows[R.d_n + n] = b.dn[n];
            rows[R.d_n_cd + n] = b.dnc[n];
        }
    }
    for (int j = threadIdx.x; j < 4 * N; j += blockDim.x) b.vg[j] = rows[R.vg + j];
    const float r2 = rows[R.r2];
    __syncthreads();
    // node' = n_mid + h @ w_out_c + b_out_c  ->  d_h = rnd(d_n) @ w_out_c^T
    block_gemv_rows<T>(b.dnc, N, cw.w_out_c, 2 * N, [&](int j, float s) { b.dh[j] = s; });
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * N; j += blockDim.x) {
        const float v = b.vg[j], sg = sigmoidf_(b.vg[2 * N + j]);
        b.dvg[j] = rnd<T>(b.dh[j] * sg);
        b.dvg[2 * N + j] = rnd<T>(b.dh[j] * v * sg * (1.f - sg));
    }
    __syncthreads();
    block_gemv_rows<T>(b.dvg, 4 * N, cw.w_in_c, N, [&](int n, float s) { b.dhn[n] = s; });
    if (DW)
        for (int j = threadIdx.x; j < 4 * N; j += blockDim.x) rows[R.d_vg + j] = b.dvg[j];
    __syncthreads();
    // RMSNorm backward: d_nmid = d_n + gs - x (r2^2 sum(gs x) / N), gs = d_hn r2 norm_c
    if ((threadIdx.x >> 5) == 0) {
        const int lane = threadIdx.x & 31;
        float s = 0.f;
        for (int n = lane; n < N; n += 32) s = fmaf(b.dhn[n] * (r2 * to_f(cw.norm_c[n])), b.nmid[n], s);
        s = warp_sum(s);
        if (lane == 0) b.sc[0] = s;
    }
    __syncthreads();
    const float c = r2 * r2 * b.sc[0] / N;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
        const float gs = b.dhn[n] * (r2 * to_f(cw.norm_c[n]));
        const float dnm = b.dn[n] + (gs - b.nmid[n] * c);
        b.dnmc[n] = rnd<T>(dnm);
        rows[R.d_nmid + n] = dnm;
        if (DW) {
            rows[R.d_nmid_cd + n] = b.dnmc[n];
            rows[R.nc + n] = b.dhn[n] * (b.nmid[n] * r2);
        }
    }
    __syncthreads();
    // n_mid = node + cattn @ w_exp + b_exp  ->  d_cattn = rnd(rnd(d_nmid) @ w_exp^T)
    block_gemv_rows<T>(b.dnmc, N, cw.w_exp, D, [&](int d, float s) { gc[d] = from_f<T>(s); });
}

// After the layer's backward: b.dn = d_nmid + d_center @ w_contr^T, the
// cotangent of the layer's input node features.
template <typename T, bool DW>
__device__ void center_bwd_tail(const CenterW<T>& cw, const CenterBwdSmem& b, int N, int D,
                                float* rows, const CenterRows& R, const T* d_center) {
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
        b.dc[d] = to_f(d_center[d]);
        if (DW) rows[R.d_center + d] = b.dc[d];
    }
    for (int n = threadIdx.x; n < N; n += blockDim.x) b.dnm[n] = rows[R.d_nmid + n];
    __syncthreads();
    block_gemv_rows<T>(b.dc, D, cw.w_contr, N, [&](int n, float s) { b.dn[n] = b.dnm[n] + s; });
    __syncthreads();
}

template <typename T, bool DW>
__device__ void gnn_bwd_atom(const GnnBwdArgs<T>& p, long long a, float* smem, float* P) {
    const int M = p.M, D = p.D, Nn = p.Nn, L = p.L;
    const long long rows_md = (long long)M * D;
    const CenterRows R(Nn, D);

    // ---- forward recompute: K1's layout and the node stream ---------------
    {
        float* X = smem;
        float* CF = layer_fwd_cf(smem, M, D, p.F);
        const CenterSmem c(smem + layer_fwd_floats(M, D, p.F), Nn, D);
        const T* e = p.edges + a * rows_md;
        for (int i = threadIdx.x; i < (M - 1) * D; i += blockDim.x) X[i] = to_f(e[i]);
        for (int i = threadIdx.x; i < M; i += blockDim.x) CF[i] = p.cf[a * M + i];
        for (int i = threadIdx.x; i < Nn; i += blockDim.x) c.node[i] = to_f(p.node[a * Nn + i]);
        __syncthreads();
        float* slot = X + (M - 1) * D;
        for (int l = 0; l < L; ++l) {
            T* vec = p.vecs + (a * L + l) * 3 * D;
            float* rows = p.expanded ? p.rows + (a * L + l) * R.total : nullptr;
            if (p.expanded) {
                for (int n = threadIdx.x; n < Nn; n += blockDim.x) rows[R.n_in + n] = c.node[n];
                center_contract<T>(p.center[l], c, Nn, D, slot, vec);
            } else {
                for (int d = threadIdx.x; d < D; d += blockDim.x) {
                    slot[d] = c.node[d];
                    vec[d] = from_f<T>(c.node[d]);
                }
            }
            __syncthreads();
            const bool last = l == L - 1;
            T* e_next = last ? nullptr : p.escr + (a * (L - 1) + l) * rows_md;
            layer_fwd_atom<T>(smem, p.layer[l], M, D, p.H, p.F, p.scale, p.eps, nullptr, c.cattn,
                              e_next, !last);
            __syncthreads();
            if (p.expanded) {
                for (int d = threadIdx.x; d < D; d += blockDim.x) rows[R.cattn + d] = c.cattn[d];
                center_update<T>(p.center[l], c, Nn, D, p.eps, rows, R);
            } else {
                for (int d = threadIdx.x; d < D; d += blockDim.x) c.node[d] = c.cattn[d];
                __syncthreads();
            }
        }
    }

    // ---- backward, last layer first -----------------------------------------
    const CenterBwdSmem b(smem, Nn, D);
    for (int i = threadIdx.x; i < Nn; i += blockDim.x) b.dn[i] = to_f(p.g_node[a * Nn + i]);
    __syncthreads();
    const long long plane = p.A * rows_md;
    for (int l = L - 1; l >= 0; --l) {
        T* vec = p.vecs + (a * L + l) * 3 * D;
        float* rows = p.expanded ? p.rows + (a * L + l) * R.total : nullptr;
        if (p.expanded) {
            center_bwd<T, DW>(p.center[l], b, Nn, D, rows, R, vec + D);
        } else {
            for (int d = threadIdx.x; d < D; d += blockDim.x) vec[D + d] = from_f<T>(b.dn[d]);
        }
        __syncthreads();
        AtomIO<T> io;
        io.e = l == 0 ? p.edges + a * rows_md : p.escr + (a * (L - 1) + l - 1) * rows_md;
        io.c_in = vec;
        io.cf = p.cf + a * M;
        io.ge = l == L - 1 ? p.g_edge + a * rows_md : p.dscr + ((l + 1) % p.nbuf) * plane + a * rows_md;
        io.gc = vec + D;
        io.d_edges = l == 0 ? p.d_edges + a * rows_md : p.dscr + (l % p.nbuf) * plane + a * rows_md;
        io.d_center = vec + 2 * D;
        io.d_cf = p.d_cf + a * M;
        io.add_dcf = l < L - 1;
        layer_bwd_atom<T, DW>(p.lbwd[l], io, M, D, p.H, p.F, p.scale, p.eps, smem,
                              DW ? P + l * DwLayout(D, p.F).total : nullptr);
        __syncthreads();
        if (p.expanded) {
            center_bwd_tail<T, DW>(p.center[l], b, Nn, D, rows, R, vec + 2 * D);
        } else {
            for (int d = threadIdx.x; d < D; d += blockDim.x) b.dn[d] = to_f(vec[2 * D + d]);
            __syncthreads();
        }
    }
    for (int i = threadIdx.x; i < Nn; i += blockDim.x) p.d_node[a * Nn + i] = from_f<T>(b.dn[i]);
}

// One block per atom; with DW a fixed grid, block b walks atoms
// [b A / grid, (b + 1) A / grid) and sums the layer weight gradients into
// partial b.
template <typename T, bool DW>
__global__ void __launch_bounds__(kThreads) gnn_block_bwd_kernel(GnnBwdArgs<T> p) {
    extern __shared__ __align__(16) float smem[];
    if constexpr (!DW) {
        gnn_bwd_atom<T, false>(p, blockIdx.x, smem, nullptr);
    } else {
        const long long total = p.L * DwLayout(p.D, p.F).total;
        float* P = p.partials + blockIdx.x * total;
        zero_floats(P, total);
        __syncthreads();
        const long long a0 = p.A * blockIdx.x / gridDim.x, a1 = p.A * (blockIdx.x + 1) / gridDim.x;
        for (long long a = a0; a < a1; ++a) {
            gnn_bwd_atom<T, true>(p, a, smem, P);
            __syncthreads();
        }
    }
}

// ---- node-stream weight gradients: sums over atoms of outer products ----

struct RowProduct {
    int layer, x_off, y_off, I, J;  // x_off < 0: a row of ones (I == 1, a column sum)
    long long out;                  // offset of the (I, J) result in dw
};

struct CenterDwArgs {
    const float* rows;  // (A, L, R) floats
    long long A;
    int L, R, n_prod;
    RowProduct prod[kMaxGnnLayers * 9];
    float* dw;
};

constexpr int kDwTile = 64, kDwAtoms = 32, kDwThreads = 256;

// dw[out + i J + j] = sum_a X[a, i] Y[a, j] for one 64 x 64 tile of one
// product: 4 x 4 outputs per thread, atoms in order in chunks of 32 staged
// in shared memory, so every element has one summation order.
__global__ void __launch_bounds__(kDwThreads) center_dw_kernel(CenterDwArgs p) {
    const RowProduct q = p.prod[blockIdx.y];
    const int tiles_j = (q.J + kDwTile - 1) / kDwTile, tiles_i = (q.I + kDwTile - 1) / kDwTile;
    if ((int)blockIdx.x >= tiles_i * tiles_j) return;
    const int i0 = (blockIdx.x / tiles_j) * kDwTile, j0 = (blockIdx.x % tiles_j) * kDwTile;
    __shared__ __align__(16) float Xs[kDwAtoms][kDwTile];
    __shared__ __align__(16) float Ys[kDwAtoms][kDwTile];
    const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
    float acc[4][4] = {};
    for (long long a0 = 0; a0 < p.A; a0 += kDwAtoms) {
        const int na = (int)(p.A - a0 < kDwAtoms ? p.A - a0 : kDwAtoms);
        for (int idx = threadIdx.x; idx < kDwAtoms * kDwTile; idx += blockDim.x) {
            const int r = idx / kDwTile, col = idx % kDwTile;
            float xv = 0.f, yv = 0.f;
            if (r < na) {
                const float* row = p.rows + ((a0 + r) * p.L + q.layer) * (long long)p.R;
                if (i0 + col < q.I) xv = q.x_off < 0 ? 1.f : row[q.x_off + i0 + col];
                if (j0 + col < q.J) yv = row[q.y_off + j0 + col];
            }
            Xs[r][col] = xv;
            Ys[r][col] = yv;
        }
        __syncthreads();
        for (int r = 0; r < na; ++r) {
            const float4 x = *reinterpret_cast<const float4*>(&Xs[r][4 * ti]);
            const float4 y = *reinterpret_cast<const float4*>(&Ys[r][4 * tj]);
            const float xv[4] = {x.x, x.y, x.z, x.w}, yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(xv[ii], yv[jj], acc[ii][jj]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
            const int i = i0 + 4 * ti + ii, j = j0 + 4 * tj + jj;
            if (i < q.I && j < q.J) p.dw[q.out + (long long)i * q.J + j] = acc[ii][jj];
        }
}

// The CenterWeights gradients of every layer, in order, after the layer
// gradients in dw.
int launch_center_dw(const float* rows, long long A, int L, int N, int D, float* dw,
                     cudaStream_t stream) {
    const CenterRows R(N, D);
    CenterDwArgs p{};
    p.rows = rows;
    p.A = A;
    p.L = L;
    p.R = R.total;
    p.dw = dw;
    long long out = 0;
    int max_tiles = 1;
    for (int l = 0; l < L; ++l) {
        const RowProduct prods[9] = {
            {l, R.n_in, R.d_center, N, D, 0},       // w_contr
            {l, -1, R.d_center, 1, D, 0},           // b_contr
            {l, R.cattn, R.d_nmid_cd, D, N, 0},     // w_exp
            {l, -1, R.d_nmid, 1, N, 0},             // b_exp
            {l, -1, R.nc, 1, N, 0},                 // norm_c
            {l, R.hn, R.d_vg, N, 4 * N, 0},         // w_in_c
            {l, -1, R.d_vg, 1, 4 * N, 0},           // b_in_c
            {l, R.h, R.d_n_cd, 2 * N, N, 0},        // w_out_c
            {l, -1, R.d_n, 1, N, 0},                // b_out_c
        };
        for (const RowProduct& q : prods) {
            RowProduct& r = p.prod[p.n_prod++];
            r = q;
            r.out = out;
            out += (long long)q.I * q.J;
            const int tiles = ((q.I + kDwTile - 1) / kDwTile) * ((q.J + kDwTile - 1) / kDwTile);
            max_tiles = tiles > max_tiles ? tiles : max_tiles;
        }
    }
    center_dw_kernel<<<dim3((unsigned)max_tiles, (unsigned)p.n_prod), kDwThreads, 0, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T, bool DW>
int launch(const GnnBwdArgs<T>& p, unsigned grid, cudaStream_t stream) {
    const size_t bytes = gnn_bwd_floats(p.M, p.D, p.H, p.F, p.Nn, DW) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        gnn_block_bwd_kernel<T, DW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    gnn_block_bwd_kernel<T, DW><<<grid, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
int run(int dw_blocks, float* dw, const void* edges, const void* node, const float* cf,
        const void* const* layer_w, const void* const* layer_t, const void* const* center_w,
        const void* g_edge, const void* g_node, void* d_edges, void* d_node, float* d_cf,
        void* escr, void* dscr, int nbuf, void* vecs, float* rows, float* partials, long long A,
        int L, int M, int D, int H, int F, int Nn, int expanded, float scale, float eps,
        cudaStream_t stream) {
    GnnBwdArgs<T> p{};
    p.edges = (const T*)edges;
    p.node = (const T*)node;
    p.cf = cf;
    for (int l = 0; l < L; ++l) {
        const T* const* w = (const T* const*)layer_w + 10 * l;
        const T* const* t = (const T* const*)layer_t + 4 * l;
        p.layer[l] = LayerW<T>{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], w[9]};
        p.lbwd[l] = LayerBwdW<T>{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7],
                                 t[0], t[1], t[2], t[3]};
        if (expanded) {
            const T* const* c = (const T* const*)center_w + 9 * l;
            p.center[l] = CenterW<T>{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8]};
        }
    }
    p.g_edge = (const T*)g_edge;
    p.g_node = (const T*)g_node;
    p.d_edges = (T*)d_edges;
    p.d_node = (T*)d_node;
    p.d_cf = d_cf;
    p.escr = (T*)escr;
    p.dscr = (T*)dscr;
    p.vecs = (T*)vecs;
    p.rows = rows;
    p.partials = partials;
    p.A = A;
    p.L = L, p.M = M, p.D = D, p.H = H, p.F = F, p.Nn = Nn, p.nbuf = nbuf > 0 ? nbuf : 1;
    p.expanded = expanded != 0;
    p.scale = scale, p.eps = eps;
    if (dw == nullptr) return launch<T, false>(p, (unsigned)A, stream);
    int err = launch<T, true>(p, (unsigned)dw_blocks, stream);
    if (err != 0) return err;
    err = launch_sum_partials(partials, dw_blocks, L * DwLayout(D, F).total, dw, stream);
    if (err != 0 || !expanded) return err;
    return launch_center_dw(rows, A, L, Nn, D, dw + L * DwLayout(D, F).total, stream);
}

}  // namespace
}  // namespace mtt

extern "C" size_t mtt_gnn_block_bwd_smem(int M, int D, int H, int F, int Nn, int dw) {
    return mtt::gnn_bwd_floats(M, D, H, F, Nn, dw != 0) * sizeof(float);
}

// Floats per atom and layer of the node stream's row scratch.
extern "C" long long mtt_gnn_block_row_floats(int Nn, int D) { return mtt::CenterRows(Nn, D).total; }

// dtype: 0 = float32, 1 = bfloat16. layer_w: L x 10 pointers (LayerWeights
// order per layer); layer_t: L x 4 transposed copies (w_qkv, w_out, w_in,
// w_ffn_out); center_w: L x 9 (CenterWeights order), read only with
// expanded. Scratch from the caller: escr (A, L-1, M, D), dscr (nbuf, A, M,
// D) with nbuf = min(L - 1, 2), vecs (A, L, 3, D) of the compute dtype;
// rows (A, L, mtt_gnn_block_row_floats) floats with expanded. dw ==
// nullptr launches the input-gradient variant; otherwise the weight-
// gradient variant with dw_blocks blocks, partials (dw_blocks, L x n_dw)
// floats, and dw receiving the float gradients of every weight in the
// JAX package's flat order (L x LayerWeights, then L x CenterWeights).
// 1 <= L <= 8. Returns the CUDA error code (0 = ok).
extern "C" int mtt_gnn_block_bwd(
    int dtype, const void* edges, const void* node, const float* cf,
    const void* const* layer_w, const void* const* layer_t, const void* const* center_w,
    const void* g_edge, const void* g_node, void* d_edges, void* d_node, float* d_cf,
    void* escr, void* dscr, int nbuf, void* vecs, float* rows,
    float* partials, int dw_blocks, float* dw,
    long long A, int L, int M, int D, int H, int F, int Nn, int expanded, float scale, float eps,
    void* stream) {
    if (L < 1 || L > mtt::kMaxGnnLayers) return (int)cudaErrorInvalidValue;
    if (A == 0) {
        if (dw == nullptr) return 0;
        const long long n = L * mtt::DwLayout(D, F).total +
                            (expanded ? L * ((long long)Nn * (2 * D + 6 * Nn + 7) + D) : 0);
        return (int)cudaMemsetAsync(dw, 0, n * sizeof(float), (cudaStream_t)stream);
    }
#define MTT_RUN(T)                                                                            \
    mtt::run<T>(dw_blocks, dw, edges, node, cf, layer_w, layer_t, center_w, g_edge, g_node,   \
                d_edges, d_node, d_cf, escr, dscr, nbuf, vecs, rows, partials, A, L, M, D, H, \
                F, Nn, expanded, scale, eps, (cudaStream_t)stream)
    if (dtype == 0) return MTT_RUN(float);
    return MTT_RUN(__nv_bfloat16);
#undef MTT_RUN
}
