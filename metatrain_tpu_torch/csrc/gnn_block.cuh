// The node (center-token) stream of the fused GNN block, shared by its
// forward (gnn_block_fwd.cu) and backward (gnn_block_bwd.cu) kernels.
//
// Between two attention layers of one GNN layer the node features (width
// N) are updated from the center token's attention output (width D):
//     center = rnd(node @ w_contr + b_contr)             (N -> D)
//     n_mid  = rnd(node + rnd(cattn @ w_exp + b_exp))    (D -> N)
//     hn     = rnd(n_mid * rsqrt(mean(n_mid^2) + eps) * norm_c)
//     [v | g] = hn @ w_in_c + b_in_c                     (N -> 4N, float)
//     h      = rnd(v * sigmoid(g))
//     node'  = rnd(n_mid + rnd(h @ w_out_c + b_out_c))   (2N -> N)
// rounding where the plain version (ops/kernels/gnn_block.py) rounds. Each
// is one row per atom times a weight matrix: a GEMV whose weights come
// from L2 (0.9 MB per atom and layer in bf16), which bounds the stream.

#pragma once

#include "layer_fwd.cuh"

namespace mtt {

constexpr int kMaxGnnLayers = 8;

// One attention layer's node-stream weights in the compute dtype, (in,
// out) layout, in CenterWeights order.
template <typename T>
struct CenterW {
    const T* w_contr;  // (N, D)
    const T* b_contr;  // (D,)
    const T* w_exp;    // (D, N)
    const T* b_exp;    // (N,)
    const T* norm_c;   // (N,)
    const T* w_in_c;   // (N, 4N)
    const T* b_in_c;   // (4N,)
    const T* w_out_c;  // (2N, N)
    const T* b_out_c;  // (N,)
};

template <typename T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Floats of reduction scratch block_gemv needs for outputs of width n_out.
__host__ __device__ inline int gemv_red_floats(int n_out) {
    return n_out > 2 * kThreads ? n_out : 2 * kThreads;
}

// y[n] = epi(n, sum_k x[k] W[k, n]) for n < n_out: x (K floats) in shared
// memory, W (K, n_out) in global memory. A thread takes two adjacent
// columns over one of S slices of k (S as large as the block allows), so
// a warp reads 64 consecutive weights of a row at once; the slices are
// added in order (deterministic). n_out even, red of gemv_red_floats.
// Ends with __syncthreads() before the epilogue; the caller syncs after.
template <typename T, typename Epi>
__device__ void block_gemv(const float* x, int K, const T* __restrict__ W, int n_out, float* red,
                           Epi epi) {
    const int pairs = n_out / 2;
    int S = 1;
    while (2 * S * pairs <= (int)blockDim.x && K % (2 * S) == 0) S *= 2;
    const int klen = K / S;
    for (int it = threadIdx.x; it < pairs * S; it += blockDim.x) {
        const int pr = it % pairs, s = it / pairs;
        const T* w = W + (size_t)s * klen * n_out + 2 * pr;
        const float* xs = x + s * klen;
        float a0 = 0.f, a1 = 0.f;
        for (int k = 0; k < klen; ++k) {
            const float2 wv = load2(w + (size_t)k * n_out);
            a0 = fmaf(xs[k], wv.x, a0);
            a1 = fmaf(xs[k], wv.y, a1);
        }
        red[2 * it] = a0;
        red[2 * it + 1] = a1;
    }
    __syncthreads();
    for (int pr = threadIdx.x; pr < pairs; pr += blockDim.x) {
        float a0 = 0.f, a1 = 0.f;
        for (int s = 0; s < S; ++s) {
            a0 += red[2 * (s * pairs + pr)];
            a1 += red[2 * (s * pairs + pr) + 1];
        }
        epi(2 * pr, a0);
        epi(2 * pr + 1, a1);
    }
}

// y[j] = epi(j, sum_k W[j, k] x[k]) for j < n_out: the product with the
// transpose of W (n_out, K), one warp per row j (coalesced row reads, a
// fixed shuffle order). K even.
template <typename T, typename Epi>
__device__ void block_gemv_rows(const float* x, int K, const T* __restrict__ W, int n_out, Epi epi) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    for (int j = warp; j < n_out; j += nw) {
        const T* w = W + (size_t)j * K;
        float s = 0.f;
        for (int k = 2 * lane; k < K; k += 64) {
            const float2 wv = load2(w + k);
            s = fmaf(wv.x, x[k], fmaf(wv.y, x[k + 1], s));
        }
        s = warp_sum(s);
        if (lane == 0) epi(j, s);
    }
}

// sum_n x[n]^2 (warp 0 writes it to *out); the caller syncs.
__device__ __forceinline__ void row_sum_sq(const float* x, int n, float* out) {
    if ((threadIdx.x >> 5) != 0) return;
    const int lane = threadIdx.x & 31;
    float s = 0.f;
    for (int k = lane; k < n; k += 32) s = fmaf(x[k], x[k], s);
    s = warp_sum(s);
    if (lane == 0) *out = s;
}

// Offsets (floats) of one atom's node-stream rows for one layer in the
// backward's global scratch: the forward's values it reads back and, for
// the weight gradients, the row vectors whose outer products over atoms
// the second pass sums.
struct CenterRows {
    int n_in, cattn, nmid, r2, hn, vg, h, d_n, d_n_cd, d_vg, nc, d_nmid, d_nmid_cd, d_center, total;
    __host__ __device__ CenterRows(int N, int D) {
        n_in = 0;
        cattn = n_in + N;
        nmid = cattn + D;
        r2 = nmid + N;
        hn = r2 + 4;
        vg = hn + N;
        h = vg + 4 * N;
        d_n = h + 2 * N;
        d_n_cd = d_n + N;
        d_vg = d_n_cd + N;
        nc = d_vg + 4 * N;
        d_nmid = nc + N;
        d_nmid_cd = d_nmid + N;
        d_center = d_nmid_cd + N;
        total = d_center + D;
    }
};

// Shared-memory floats of the forward's node stream: node (N), cattn (D),
// n_mid (N), hn (N), vg (4N), h (2N), 4 scalars and the GEMV scratch.
__host__ __device__ inline size_t center_fwd_floats(int N, int D) {
    return (size_t)N + D + N + N + 4 * N + 2 * N + 4 + gemv_red_floats(4 * N);
}

struct CenterSmem {
    float *node, *cattn, *nmid, *hn, *vg, *h, *sc, *red;
    __device__ CenterSmem(float* base, int N, int D) {
        node = base;
        cattn = node + N;
        nmid = cattn + D;
        hn = nmid + N;
        vg = hn + N;
        h = vg + 4 * N;
        sc = h + 2 * N;
        red = sc + 4;
    }
};

// center = rnd(node @ w_contr + b_contr), written to slot M-1 of X (and to
// center_g, global, if not null).
template <typename T>
__device__ void center_contract(const CenterW<T>& cw, const CenterSmem& c, int N, int D, float* x_slot,
                                T* center_g) {
    block_gemv<T>(c.node, N, cw.w_contr, D, c.red, [&](int d, float acc) {
        const float v = rnd<T>(acc + to_f(cw.b_contr[d]));
        x_slot[d] = v;
        if (center_g != nullptr) center_g[d] = from_f<T>(v);
    });
}

// node <- the updated node features from node and cattn (both in c). With
// rows (global) not null, saves n_mid, r2, hn, vg and h there.
template <typename T>
__device__ void center_update(const CenterW<T>& cw, const CenterSmem& c, int N, int D, float eps,
                              float* rows, const CenterRows& R) {
    block_gemv<T>(c.cattn, D, cw.w_exp, N, c.red, [&](int n, float acc) {
        c.nmid[n] = rnd<T>(c.node[n] + rnd<T>(acc + to_f(cw.b_exp[n])));
    });
    __syncthreads();
    row_sum_sq(c.nmid, N, c.sc);
    __syncthreads();
    const float r2 = rsqrtf(c.sc[0] / N + eps);
    for (int n = threadIdx.x; n < N; n += blockDim.x) c.hn[n] = rnd<T>(c.nmid[n] * r2 * to_f(cw.norm_c[n]));
    __syncthreads();
    block_gemv<T>(c.hn, N, cw.w_in_c, 4 * N, c.red, [&](int j, float acc) {
        c.vg[j] = acc + to_f(cw.b_in_c[j]);
    });
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * N; j += blockDim.x) c.h[j] = rnd<T>(c.vg[j] * sigmoidf_(c.vg[2 * N + j]));
    if (rows != nullptr) {
        for (int n = threadIdx.x; n < N; n += blockDim.x) {
            rows[R.nmid + n] = c.nmid[n];
            rows[R.hn + n] = c.hn[n];
        }
        for (int j = threadIdx.x; j < 4 * N; j += blockDim.x) rows[R.vg + j] = c.vg[j];
        if (threadIdx.x == 0) rows[R.r2] = r2;
    }
    __syncthreads();
    if (rows != nullptr)
        for (int j = threadIdx.x; j < 2 * N; j += blockDim.x) rows[R.h + j] = c.h[j];
    block_gemv<T>(c.h, 2 * N, cw.w_out_c, N, c.red, [&](int n, float acc) {
        c.node[n] = rnd<T>(c.nmid[n] + rnd<T>(acc + to_f(cw.b_out_c[n])));
    });
    __syncthreads();
}

}  // namespace mtt
