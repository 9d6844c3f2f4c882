// The fused PET layer's float32 forward up to h_norm on Hopper, shared by
// the Hopper float32 K1 (fused_layer_fwd_f32_sm90.cu), which runs it as its
// first half, and the Hopper float32 K2 (fused_layer_bwd_f32_sm90.cu), which
// runs it as its recompute: the same device code in the same order, so the
// two kernels compute q|k|v, attn, res and h_norm to the same bits, and the
// f32 energy and its gradient come from one function. The phases, in the
// order both kernels run them, each ending with its own stores (the caller
// puts the barriers between them):
// - rms_rows: r1 and n1 = x1 r1 w (and, over res, r2 and h_norm);
// - qkv_panels: q|k|v = n1 w_qkv + b, three panels of 128 columns;
// - attention_fwd: attn = P v with P = cf e / z, one warp per (head,
//   16-row query tile), on mma.sync 3xTF32;
// - out_proj: attn w_out + b, handed to the caller's epilogue (res = x1 +
//   it; K1 keeps slot M-1's as the center output);
// - vg_panels: per F tile of 128 columns the SwiGLU's value and gate panels
//   (h_norm w_in, without the bias).
// The dense products consume the ring's chunks in this order: w_qkv^T (24),
// w_out^T (8), then per F tile the value and gate rows of w_in^T (8 + 8);
// each kernel's Chunks continues the sequence with its own. The 3xTF32
// helpers, the weight ring and the panel product are tf32_sm90.cuh's; an
// edit here changes both kernels (check the f32 K2's and K2-dW's digests and
// the f32 K1's against the K2 recompute: tools/layer_times.py,
// tools/sm90_front.py --dtype float32).

#pragma once

#include "tf32_sm90.cuh"

namespace mtt {
namespace lf32 {

using namespace tf32;  // 3xTF32, the weight ring, the panel products
using sm90::kRows;  // sm90's, not common.cuh's
using sm90::kThreads;
using sm90::D;
using sm90::H;
using sm90::HD;
using sm90::quad_max;
using sm90::zero;

constexpr int LQ = 3 * D + 4;  // q|k|v row (floats)
constexpr int LT = D + 4;      // a 64 x 128 tile's row

constexpr int kQkvBytes = kRows * LQ * 4;
constexpr int kTileBytes = kRows * LT * 4;

// The shapes both kernels take: D = 128, heads of 16, 16 <= M <= 64 with M
// % 16 == 0, F a multiple of 128.
__host__ __device__ constexpr bool takes(int M, int D_, int H_, int F) {
    return D_ == D && H_ == H && M >= 16 && M <= kRows && M % 16 == 0 && F >= kCN && F % kCN == 0;
}

// s[j] (16 x 8, C fragments) = A (16 x 16 at X, ld lda) B_j^T with B_j rows
// 8 j .. 8 j + 7 of Y (16 columns, ld ldy), for the tiles j with 8 j < n.
__device__ __forceinline__ void abt16(float (&s)[8][4], const float* X, int lda, const float* Y, int ldy,
                                      int n) {
    uint32_t ah[2][4], al[2][4];
    load_a(ah[0], al[0], X, lda);
    load_a(ah[1], al[1], X + 8, lda);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        if (8 * j < n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
                uint32_t bh[2], bl[2];
                load_b(bh, bl, Y + (size_t)8 * j * ldy + 8 * ks, ldy);
                mma3(s[j], ah[ks], al[ks], bh, bl);
            }
        }
    }
}

// acc[nt] (16 x 8) += X Y: X (16 x 8 NJ) held as C fragments x[j] of its
// 8-column tiles, Y (8 NJ x 16, rows at Y, ld ldy) column tile nt. The C
// fragment of tile j is an A fragment of the product whose k runs over
// columns 8 j + 2 t (k = t) and 8 j + 2 t + 1 (k = t + 4), so B takes Y's
// rows in that order.
template <int NJ>
__device__ __forceinline__ void acc_xy(float (&acc)[2][4], const float (&x)[NJ][4], const float* Y, int ldy,
                                       int nj) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
            uint32_t ah[4], al[4];
            split(x[j][0], ah[0], al[0]);
            split(x[j][2], ah[1], al[1]);
            split(x[j][1], ah[2], al[2]);
            split(x[j][3], ah[3], al[3]);
            const float* y = Y + (size_t)(8 * j + 2 * t) * ldy + g;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                uint32_t bh[2], bl[2];
                split(y[8 * nt], bh[0], bl[0]);
                split(y[ldy + 8 * nt], bh[1], bl[1]);
                mma3(acc[nt], ah, al, bh, bl);
            }
        }
    }
}

// Y = x r w for rows m < M, r = rsqrt(mean(x^2) + eps), one warp per row:
// x = src(m) (D floats), r to RS[m], Y in rows of LT.
template <typename Src>
__device__ __forceinline__ void rms_rows(Src src, const float* w, float* RS, float* Y, int M, float eps) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float4 wv = *reinterpret_cast<const float4*>(w + 4 * lane);
    for (int m = warp; m < M; m += kThreads / 32) {
        const float4 x = *reinterpret_cast<const float4*>(src(m) + 4 * lane);
        const float r = rsqrtf(warp_sum(x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w) / D + eps);
        if (lane == 0) RS[m] = r;
        *reinterpret_cast<float4*>(Y + m * LT + 4 * lane) =
            make_float4(x.x * r * wv.x, x.y * r * wv.y, x.z * r * wv.z, x.w * r * wv.w);
    }
}

// The A operand of a panel product: chunk r's 16 columns of a 64 x 128
// tile in rows of LT.
struct TileCols {
    const float* X;
    __device__ const float* operator()(int r, int& ld) const {
        ld = LT;
        return X + r * kCK;
    }
};

// q|k|v (rows of LQ) = n1 w_qkv + b over the ring's next 24 chunks, n1 in OP.
template <typename R>
__device__ __forceinline__ void qkv_panels(R& ring, int& c, const float* OP, float* QKV, const float* b_qkv,
                                           int M) {
    for (int pn = 0; pn < 3; ++pn) {
        float acc[4][4];
        zero(acc);
        panel_mm<8>(ring, c, TileCols{OP}, acc, M);
        panel_pairs([&](int j, int h, int m, int n) {
            const int col = pn * kCN + n;
            const float2 b = ld2(b_qkv + col);
            st2(QKV + m * LQ + col, acc[j][2 * h] + b.x, acc[j][2 * h + 1] + b.y);
        });
    }
}

// attn (to Y, rows of LT) = P v with P = cf e / z, e = exp(s - max), z =
// sum_k cf e, s = scale q k^T: one warp per (head, 16-row query tile).
__device__ __forceinline__ void attention_fwd(const float* QKV, const float* CF, float* Y, int M, float scale) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int QT = M / 16;
    for (int task = warp; task < H * QT; task += kThreads / 32) {
        const int h = task / QT, q0 = 16 * (task % QT);
        float s[8][4];
        abt16(s, QKV + q0 * LQ + h * HD, LQ, QKV + D + h * HD, LQ, M);
        float mx[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (8 * j < M)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    s[j][i] *= scale;
                    mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
                }
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (8 * j < M)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    s[j][i] = expf(s[j][i] - mx[i >> 1]);
                    z[i >> 1] = fmaf(CF[8 * j + 2 * t + (i & 1)], s[j][i], z[i >> 1]);
                }
        z[0] = quad_sum(z[0]);
        z[1] = quad_sum(z[1]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (8 * j < M)
#pragma unroll
                for (int i = 0; i < 4; ++i) s[j][i] = CF[8 * j + 2 * t + (i & 1)] * (s[j][i] / z[i >> 1]);
        float o[2][4] = {};
        acc_xy<8>(o, s, QKV + 2 * D + h * HD, LQ, M / 8);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            float* y = Y + (q0 + g) * LT + h * HD + 8 * nt + 2 * t;
            st2(y, o[nt][0], o[nt][1]);
            st2(y + 8 * LT, o[nt][2], o[nt][3]);
        }
    }
}

// attn w_out + b over the ring's next 8 chunks, attn in OP: epi(m, n, o0,
// o1) gets columns n, n + 1 of each row m < M.
template <typename R, typename Epi>
__device__ __forceinline__ void out_proj(R& ring, int& c, const float* OP, const float* b_out, int M, Epi epi) {
    float acc[4][4];
    zero(acc);
    panel_mm<8>(ring, c, TileCols{OP}, acc, M);
    panel_pairs([&](int j, int h, int m, int n) {
        if (m >= M) return;
        const float2 b = ld2(b_out + n);
        epi(m, n, acc[j][2 * h] + b.x, acc[j][2 * h + 1] + b.y);
    });
}

// One F tile's value and gate panels, h_norm (in OP) times the ring's next
// 8 + 8 chunks (w_in^T's value rows, then its gate rows), without the bias.
template <typename R>
__device__ __forceinline__ void vg_panels(R& ring, int& c, const float* OP, float (&av)[4][4],
                                          float (&ag)[4][4], int M) {
    zero(av);
    zero(ag);
    panel_mm<8>(ring, c, TileCols{OP}, av, M);
    panel_mm<8>(ring, c, TileCols{OP}, ag, M);
}

}  // namespace lf32
}  // namespace mtt
