// K1 on Hopper in float32: the fused PET transformer layer's forward,
// redesigned for the H100 at the served shapes.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/fused_layer.py
// `_fwd_kernel` (pallas_call in `_forward_impl`, body `_layer_math`) in
// float32, without W8A8 or the int8 scores: the same function as K1's
// general body (layer_fwd.cuh) and its plain version `layer_math`, that is
// (edge_out, center_out) with edge_out[:, M-1] == 0 and center_out slot
// M-1's out-projection attn w_out + b_out (not the residual). It takes D =
// 128, heads of 16 (H = 8), 16 <= M <= 64 with M % 16 == 0 and F % 128 == 0
// (mtt_fused_layer_fwd_f32_sm90_ok), with or without weight gradients; the
// wrapper sends every other shape and variant to the general body.
//
// One function for the energy and its gradient: the layer up to h_norm is
// layer_f32_sm90.cuh's phases, which the Hopper float32 K2 runs as its
// recompute (and K2-dW's float32 first pass, its spill mode), in the same
// order on the same layout of the operands, so this kernel's attn, res and
// h_norm are the bits the gradient starts from
// (tools/sm90_front.py --dtype float32 holds the two against each other).
//
// What bounds it on the H100: operations. At the served shape (A = 11,392,
// M = 64, F = 256) the dense products (8 D^2 + 6 D F a row) and the
// attention's are 263 GFLOP: 3.92 ms on the FFMA pipes at 67 TFLOP/s, 1.59
// ms as three TF32 tensor-core products each at 495 TFLOP/s; device memory
// sees one read of the tokens and one write of the edge output (0.75 GB,
// 0.22 ms). The general body took 15.3 ms; the design answers its causes:
// - FFMA at one output column per thread, bound by load issue: every dense
//   and attention product runs on mma.sync m16n8k8 as three TF32 products
//   (tf32_sm90.cuh: x = hi + lo split in registers, each staged chunk's
//   products summed from zero and then added in float32);
// - no staged weights (644 KB streamed from L2 per atom): every weight
//   reaches the tensor cores once per atom through the ring of three staged
//   chunks of 128 rows x 16 k (8 KB, cp.async, swizzled), issued two ahead
//   in one fixed sequence of 32 + 24 F / 128 chunks (Chunks below);
// - the attention head after head with barriers between them: one warp per
//   (head, 16-row query tile), all heads at once;
// - the SwiGLU in narrow row chunks: F walks in tiles of 128 columns, each
//   chunk serving all 64 rows. Per tile, ffn_h = v sigmoid(g) is formed in
//   registers from the value and gate panels and stored as a 64 x 128 float
//   A tile in the room q|k|v left; its product with w_ffn_out^T's chunks
//   adds into a 64 x 128 float sum that stays in registers across the
//   tiles. Then edge_out = res + (sum + b_ffn_out), in the general body's
//   order of rounding.
// Shared memory per block (one atom, M padded to 64 rows, 16 warps): q|k|v
// (rows of 3D + 4), then the ffn_h tile, 99,328 B; the operand tile (n1,
// attn, h_norm; rows of D + 4) 33,792 B; res 33,792 B; the ring 24,576 B;
// cf, r1 and r2 768 B: 192,256 B, one block per SM. A window below 64 slots
// pads to 64 rows, and the warps of the padded row blocks skip their dense
// products (panel_mm).

#include "layer_f32_sm90.cuh"
#include "layer_sm90.cuh"

namespace mtt {
namespace k1f32 {
namespace {

using namespace lf32;  // the forward phases up to h_norm, 3xTF32, the ring
using lf32::kRows;  // sm90's, not common.cuh's
using lf32::kThreads;

constexpr int kOffOp = kQkvBytes;
constexpr int kOffRes = kOffOp + kTileBytes;
constexpr int kOffRing = kOffRes + kTileBytes;
constexpr int kOffStats = kOffRing + kStages * kChunk * 4;
constexpr int kSmemBytes = kOffStats + 3 * kRows * 4;  // cf, r1, r2
static_assert(kSmemBytes <= 232448, "one block per SM");
static_assert(kTileBytes <= kQkvBytes, "the ffn_h tile fits q|k|v's room");

struct Args {
    const float* edges;      // (A, M, D)
    const float* center;     // (A, D)
    const float* cf;         // (A, M)
    const float* norm_attn;  // (D,)
    const float* b_qkv;      // (3D,)
    const float* b_out;      // (D,)
    const float* norm_mlp;   // (D,)
    const float* b_in;       // (2F,)
    const float* b_ffn_out;  // (D,)
    float* edge_out;         // (A, M, D)
    float* center_out;       // (A, D)
    int M, F;
    float scale, eps;
};

// The atom's weight chunks in the order the products consume them, each
// 128 rows (n) x 16 columns (k) of a weight in its (N, K) row-major layout:
// the shared phases' QKV (w_qkv^T, 3 panels x 8) and out-projection
// (w_out^T, 8), then per F tile of 128 columns j0: value and gate of
// FFN-in (w_in^T rows j0 and F + j0, 8 + 8), FFN-out (w_ffn_out^T columns
// j0 .. j0 + 127, 8).
struct Chunks {
    const float *w_qkv_t, *w_out_t, *w_in_t, *w_ffn_out_t;
    int F;

    __device__ const float* operator()(int c, int& ld) const {
        ld = D;
        if (c < 24) return w_qkv_t + (size_t)(c >> 3) * kCN * D + (c & 7) * kCK;
        c -= 24;
        if (c < 8) return w_out_t + c * kCK;
        c -= 8;
        const int j0 = c / 24 * kCN, r = c % 24, k = (r & 7) * kCK;
        if (r < 8) return w_in_t + (size_t)j0 * D + k;
        if (r < 16) return w_in_t + (size_t)(F + j0) * D + k;
        ld = F;
        return w_ffn_out_t + j0 + k;
    }
};

__host__ __device__ constexpr int chunk_count(int F) { return 32 + 24 * (F / kCN); }

__global__ void __launch_bounds__(kThreads, 1) k1_f32_sm90_kernel(const __grid_constant__ Args p,
                                                                  const __grid_constant__ Chunks w) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* QKV = reinterpret_cast<float*>(smem);          // q|k|v, then the ffn_h tile
    float* OP = reinterpret_cast<float*>(smem + kOffOp);  // n1, attn, h_norm
    float* RES = reinterpret_cast<float*>(smem + kOffRes);
    float* CF = reinterpret_cast<float*>(smem + kOffStats);
    float* RS1 = CF + kRows;
    float* RS2 = RS1 + kRows;
    float* FH = QKV;  // ffn_h of one F tile (rows of LT)

    const int M = p.M, F = p.F;
    const long long a = blockIdx.x;
    const float* e = p.edges + a * M * D;
    const float* c_in = p.center + a * D;
    auto token = [&](int m) { return m == M - 1 ? c_in : e + (size_t)m * D; };

    Ring<Chunks> ring{reinterpret_cast<float*>(smem + kOffRing), w, chunk_count(F)};
    ring.start();
    int c = 0;

    // ---- r1, n1 = x1 r1 w ----------------------------------------------------
    rms_rows(token, p.norm_attn, RS1, OP, M, p.eps);
    for (int m = threadIdx.x; m < M; m += kThreads) CF[m] = p.cf[a * M + m];

    // q|k|v = n1 w_qkv + b
    qkv_panels(ring, c, OP, QKV, p.b_qkv, M);
    __syncthreads();

    // ---- attention, one warp per (head, 16-row query tile) -------------------
    attention_fwd(QKV, CF, OP, M, p.scale);
    __syncthreads();

    // ---- res = x1 + (attn w_out + b); slot M-1's attn w_out + b is the center
    // output
    out_proj(ring, c, OP, p.b_out, M, [&](int m, int n, float o0, float o1) {
        const float2 x = ld2(token(m) + n);
        st2(RES + m * LT + n, x.x + o0, x.y + o1);
        if (m == M - 1) st2(p.center_out + a * D + n, o0, o1);
    });
    __syncthreads();

    // r2, h_norm = res r2 w
    rms_rows([&](int m) { return (const float*)RES + m * LT; }, p.norm_mlp, RS2, OP, M, p.eps);
    __syncthreads();

    // ---- SwiGLU over F tiles of 128 columns -> ffn_out (registers) ------------
    // The ffn_h tile is written after the tile's value and gate panels, whose
    // ring barriers every warp passes only after its reads of the tile
    // before; the FFN-out panel's first barrier orders the writes before
    // its reads.
    float fo[4][4];
    zero(fo);
    for (int j0 = 0; j0 < F; j0 += kCN) {
        float av[4][4], ag[4][4];
        vg_panels(ring, c, OP, av, ag, M);
        panel_pairs([&](int j, int h, int m, int n) {
            if (m >= M) return;
            const float2 bv = ld2(p.b_in + j0 + n), bg = ld2(p.b_in + F + j0 + n);
            float fh[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int i = 2 * h + u;
                const float v = av[j][i] + (u ? bv.y : bv.x);
                const float s = sigmoidf_(ag[j][i] + (u ? bg.y : bg.x));
                fh[u] = v * s;
            }
            st2(FH + m * LT + n, fh[0], fh[1]);
        });
        panel_mm<8>(ring, c, TileCols{FH}, fo, M);
    }

    // ---- edge_out = res + (ffn_h w_ffn_out + b), slot M-1 zero ----------------
    float* eo = p.edge_out + a * M * D;
    panel_pairs([&](int j, int h, int m, int n) {
        if (m >= M) return;
        if (m == M - 1) {
            st2(eo + (size_t)m * D + n, 0.f, 0.f);
            return;
        }
        const float2 x = ld2(RES + m * LT + n), b = ld2(p.b_ffn_out + n);
        st2(eo + (size_t)m * D + n, x.x + (fo[j][2 * h] + b.x), x.y + (fo[j][2 * h + 1] + b.y));
    });
}

}  // namespace
}  // namespace k1f32
}  // namespace mtt

// Whether the Hopper float32 K1 takes a shape: D = 128, heads of 16, 16 <=
// M <= 64 with M % 16 == 0, F a multiple of 128 (the wrapper checks the
// variant: float32, no W8A8, no int8 scores; with or without weight
// gradients).
extern "C" int mtt_fused_layer_fwd_f32_sm90_ok(int M, int D, int H, int F) {
    return mtt::lf32::takes(M, D, H, F) ? 1 : 0;
}

// Its shared memory per block (one atom), 0 where it does not take the shape.
extern "C" size_t mtt_fused_layer_fwd_f32_sm90_smem(int M, int D, int H, int F) {
    return mtt::lf32::takes(M, D, H, F) ? (size_t)mtt::k1f32::kSmemBytes : 0;
}

// float32 tensors: the norm scales and biases, then the weight matrices in
// the (N, K) layouts of their products: w_qkv^T (3D, D), w_out^T (D, D),
// w_in^T (2F, D) and w_ffn_out^T (D, F). One block per atom on `stream`.
// Returns the CUDA error code (0 = ok; cudaErrorInvalidValue for a shape it
// does not take).
extern "C" int mtt_fused_layer_fwd_f32_sm90(
    const float* edges, const float* center, const float* cf,
    const float* norm_attn, const float* b_qkv, const float* b_out, const float* norm_mlp,
    const float* b_in, const float* b_ffn_out,
    const float* w_qkv_t, const float* w_out_t, const float* w_in_t, const float* w_ffn_out_t,
    float* edge_out, float* center_out,
    long long A, int M, int D, int H, int F, float scale, float eps, void* stream) {
    namespace k1 = mtt::k1f32;
    if (!mtt::lf32::takes(M, D, H, F)) return (int)cudaErrorInvalidValue;
    if (A == 0) return 0;
    const k1::Args args{edges, center, cf, norm_attn, b_qkv, b_out, norm_mlp, b_in, b_ffn_out,
                        edge_out, center_out, M, F, scale, eps};
    const k1::Chunks chunks{w_qkv_t, w_out_t, w_in_t, w_ffn_out_t, F};
    cudaError_t err = cudaFuncSetAttribute(k1::k1_f32_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           k1::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    k1::k1_f32_sm90_kernel<<<(unsigned)A, mtt::lf32::kThreads, k1::kSmemBytes, (cudaStream_t)stream>>>(args,
                                                                                                      chunks);
    return (int)cudaGetLastError();
}
