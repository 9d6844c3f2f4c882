// K1 on Hopper: the exact bfloat16 forward of the fused PET transformer
// layer, redesigned for the H100 at the served shapes; and, as its
// int8-score mode, K1-int8 there (below).
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/fused_layer.py
// `_fwd_kernel` (pallas_call in `_forward_impl`, body `_layer_math`)
// without int8 or W8A8, in bfloat16: the same function as K1
// (fused_layer_fwd.cu) and its plain version `layer_math`, that is
// (edge_out, center_out) with edge_out[:, M-1] == 0 and center_out slot
// M-1 of the out-projection rnd(attn w_out + b_out) (not the residual). It
// takes D = 128, heads of 16 (H = 8), 16 <= M <= 64 with M % 16 == 0 and F
// % 128 == 0 (mtt_fused_layer_fwd_sm90_ok, the Hopper K2's rule; the
// wrapper sends every other shape, and every other variant, to
// fused_layer_fwd.cu).
//
// What bounds it on the H100: operations. At the served shape (A = 11,392
// atoms, M = 64, F = 256) the layer is 23.1 MFLOP per atom (QKV 6.29,
// scores 1.05, P V 1.05, out-projection 2.10, FFN-in 8.39, FFN-out 4.19):
// 263 GFLOP, 0.266 ms at 989 TFLOP/s. The general body took 11 ms (42 x
// its bound); the design answers its four causes:
// - f32 activations (181 KB per atom, one atom per SM, no room to stage
//   weights): every activation the plain version rounds to bf16 is stored
//   in bf16 (the tokens' norm, q|k|v, attn, res, h_norm, ffn_h); vg, the
//   SwiGLU input, stays float and lives only in registers, one F tile at a
//   time, and so does the FFN-out sum. Buffers are reused phase by phase:
//   res and the ffn_h tile go where q|k|v was. Shared memory per block of
//   two atoms: per atom q|k|v (then res and ffn_h) 50,176 B and the operand
//   tile (n1, attn, h_norm) 17,408 B; the weight ring 49,152 B; per atom cf
//   and the two norms' factors 768 B: 185,856 B.
// - weights as scalar loads from L2 (3.7 GB per launch, nothing
//   overlapping them): every weight reaches the tensor cores through the
//   Hopper K2's ring of three staged chunks (128 x 64 bf16, cp.async, the
//   128-byte swizzle), issued two chunks ahead in one fixed sequence of 8 +
//   3 F / 64 chunks (20 at F = 256: 320 KB, each weight read once), so the
//   copies overlap the products and the phases between them. Each block
//   serves two atoms (warps 0-7 the first, 8-15 the second) from every
//   staged chunk: half the weight traffic and half the chunk barriers per
//   atom of one atom per block, which was 15 % slower on the H100.
// - the attention on FMA loops, head after head (24 barriers per atom):
//   the scores and P V run on mma.sync with one warp per (head, 16-row
//   query tile), all heads at once, between two barriers. The tensor cores
//   take the softmax weights P = cf e / z in bf16 where the plain version
//   keeps them float; the JAX package rounds them too, and so does the
//   Hopper K2's recompute, whose code this is.
// - narrow tiles (16-row products, the SwiGLU input in 16-row chunks):
//   every dense product is a 64-row panel on wgmma, A from shared memory by
//   ldmatrix, B from the staged chunk by descriptor; each warpgroup runs
//   m64n64k16 on 64 columns of its atom's 128. The FFN walks F in tiles of
//   64 columns: one pair of chunks holds the tile's value and gate rows of
//   w_in^T (the wrapper interleaves them), and each warpgroup takes the
//   same 32 value and gate columns (two m64n32k16 per k step), so that
//   ffn_h = rnd(v sigmoid(g)) forms in registers into a bf16 64 x 64 tile;
//   that tile times w_ffn_out rows j0 .. j0 + 63 adds into a 64 x 128 float
//   sum that stays in registers across the tiles.
//
// The phases up to h_norm are layer_sm90.cuh's, the Hopper K2's recompute:
// the same device code in the same order (the dense ones in their
// two-atom instantiation), so K1's attn, res and h_norm are the bits K2
// recomputes. edge_out = rnd(res + rnd(sum + b_ffn_out)), the general
// body's order of rounding. No atomics: the same bits in every launch.
//
// K1-int8 (mtt_fused_layer_fwd_int8_sm90, the kernel's I8 flag) replaces
// the same `_fwd_kernel` with the dynamic int8 scores (`_qside_scores` /
// `_qside_tail` with int8, `_quantize_i8`) where no weight requires grad:
// the plain version is `layer_math(..., int8_scales=)`, the general body
// K1-int8 of fused_layer_fwd.cu. Each atom's q and k are quantized once,
// clamp(rint(x / s), +-127) with its block's absmax scales (the (A, 2)
// array of int8_absmax.cu), into an int8 copy in shared memory (per atom
// 64 x 272 bytes: 220,672 B a block); the scores are int32 sums on
// mma.sync m16n8k16 .s8 times (s_q s_k) scale, the plain version's bits;
// the softmax is rounded as the JAX package's: ecf = rnd(cf e) in bf16,
// attn = rnd((ecf v) / z), z = sum_k ecf. Bound at the served shape as
// K1: 0.260 ms (the score products at 1,979 TOPS); the int8 work adds
// one pass over q and k and no weight traffic. The forward phases are
// K2-int8's recompute, so its energy and K2-int8's forces come from one
// function.

#include "layer_sm90.cuh"

namespace mtt {
namespace sm90 {
namespace {

constexpr int LH = 64 + 8;  // the ffn_h tile: 64 rows of one 64-column F tile (bf16)

// One atom's part of shared memory: q|k|v, where res (rows of LA) and the
// ffn_h tile (rows of LH) go once the attention is done, then the operand
// tile (n1, attn, h_norm).
constexpr int kQkvBytes = kRows * LQ * 2;
constexpr int kOpBytes = kRows * LA * 2;
constexpr int kOffFh = kOpBytes;  // inside q|k|v, after res
constexpr int kAtomBytes = kQkvBytes + kOpBytes;
constexpr int kRingBytes = kStages * kChunkElems * 2;
constexpr int kOffRing = 2 * kAtomBytes;
constexpr int kOffStats = kOffRing + kRingBytes;
constexpr int kStatFloats = 3 * kRows;  // per atom: cf, r1, r2
constexpr int kSmemBytes = kOffStats + 2 * kStatFloats * 4;
// K1-int8: per atom the int8 copy of q and k, after the rest
constexpr int kQ8Bytes = kRows * LQ8;
constexpr int kSmemBytesI8 = kSmemBytes + 2 * kQ8Bytes;
static_assert(kAtomBytes % 1024 == 0, "the swizzled ring needs 1024-byte aligned stages");
static_assert(kOffFh + kRows * LH * 2 <= kQkvBytes, "res and the ffn_h tile go where q|k|v was");
static_assert(kSmemBytesI8 <= 232448, "one block per SM");

struct Args {
    const bf16* edges;      // (A, M, D)
    const bf16* center;     // (A, D)
    const float* cf;        // (A, M)
    const bf16* norm_attn;  // (D,)
    const bf16* b_qkv;      // (3D,)
    const bf16* b_out;      // (D,)
    const bf16* norm_mlp;   // (D,)
    const bf16* b_in;       // (2F,)
    const bf16* b_ffn_out;  // (D,)
    const float* i8_scales;  // K1-int8: (A, 2) s_q, s_k
    bf16* edge_out;         // (A, M, D)
    bf16* center_out;       // (A, D)
    long long A;
    int M, F;
    float scale, eps;
};

// The block's weight chunks in the order the products consume them, each as
// (N, K) row-major: QKV (w_qkv^T, 3 panels x 2), out-projection (w_out^T,
// 2), per F tile of 64 columns j0: FFN-in (rows 2 j0 .. 2 j0 + 127 of
// w_in^T with its value and gate rows interleaved in blocks of 64, the
// wrapper's w_vg: value columns j0 .. j0 + 63, then the same gate columns;
// 2 k halves), FFN-out (w_ffn_out^T columns j0 .. j0 + 63, 1).
struct Chunks {
    const bf16 *w_qkv_t, *w_out_t, *w_vg, *w_fo_t;
    int F;

    __device__ const bf16* operator()(int c, int& ld) const {
        ld = D;
        if (c < 6) return w_qkv_t + (size_t)(c >> 1) * kChunkN * D + (c & 1) * kChunkK;
        c -= 6;
        if (c < 2) return w_out_t + c * kChunkK;
        c -= 2;
        const int j0 = c / 3 * 64, r = c % 3;
        if (r < 2) return w_vg + (size_t)(2 * j0) * D + r * kChunkK;
        ld = F;
        return w_fo_t + j0;
    }
};

__host__ __device__ constexpr int chunk_count(int F) { return 8 + 3 * (F / 64); }

// av, ag += h_norm (64 x 128) times the value and gate rows of the ring's
// next 2 chunks: warpgroup w / 4 % 2 of each atom takes value and gate
// columns 32 (w / 4 % 2) .. + 31 of the F tile (two m64n32k16 per k step),
// so that each thread holds v and g of the same elements.
template <typename Ring>
__device__ __forceinline__ void glu_mm(Ring& ring, int& c, const bf16* HN, float (&av)[4][4],
                                       float (&ag)[4][4]) {
    const int r0 = 16 * ((threadIdx.x >> 5) & 3), half = (threadIdx.x >> 7) & 1;
#pragma unroll 1
    for (int r = 0; r < 2; ++r) {
        const bf16* B = ring.consume(c++);
        uint32_t a[kChunkK / 16][4];
#pragma unroll
        for (int ks = 0; ks < kChunkK / 16; ++ks) load_a(a[ks], HN + r * kChunkK, LA, r0, 16 * ks);
        // 32-row blocks of the chunk start on 1024-byte boundaries
        const uint64_t dv = desc_sw128(B + 32 * half * kChunkK);
        const uint64_t dg = desc_sw128(B + (64 + 32 * half) * kChunkK);
        acc_fence(av);
        acc_fence(ag);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < kChunkK / 16; ++ks) {
            wgmma_m64n32k16(av, a[ks], dv + 2 * ks);
            wgmma_m64n32k16(ag, a[ks], dg + 2 * ks);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        acc_fence(av);
        acc_fence(ag);
    }
}

// Two atoms per block (2 b and 2 b + 1; an odd last atom is computed twice
// and stored once). Warps 0-7 run atom 0's part of every dense product and
// warps 8-15 atom 1's, each warpgroup on 64 columns (m64n64k16), so each
// staged chunk serves both atoms; the norms and the attention run atom
// after atom on all 16 warps. I8: K1-int8, each atom's scores from its own
// scale pair.
template <bool I8>
__global__ void __launch_bounds__(kThreads, 1)
    k1_sm90_kernel(Args p, Chunks chunks) {
    extern __shared__ __align__(1024) unsigned char smem[];
    constexpr size_t kStride = kAtomBytes / 2;  // elements from atom 0's buffers to atom 1's
    bf16* QKV = reinterpret_cast<bf16*>(smem);            // q|k|v
    bf16* RES = QKV;                                      // then res
    bf16* FH = reinterpret_cast<bf16*>(smem + kOffFh);    // and the ffn_h tile
    bf16* OP = reinterpret_cast<bf16*>(smem + kQkvBytes);  // n1, attn, h_norm
    float* STATS = reinterpret_cast<float*>(smem + kOffStats);

    const int M = p.M, F = p.F;
    const long long a0 = 2 * (long long)blockIdx.x;
    const bool has1 = a0 + 1 < p.A;
    const long long a1 = has1 ? a0 + 1 : a0;
    const bf16* e0 = p.edges + a0 * M * D;
    const bf16* e1 = p.edges + a1 * M * D;
    const bf16* c0 = p.center + a0 * D;
    const bf16* c1 = p.center + a1 * D;
    const int at = panel_atom<8>();  // the calling thread's atom in the dense products
    const bool store = at == 0 || has1;

    WeightRing<Chunks> ring{reinterpret_cast<bf16*>(smem + kOffRing), chunks, chunk_count(F)};
    ring.start();
    int c = 0;
    auto token0 = [&](int m) { return m == M - 1 ? c0 : e0 + (size_t)m * D; };
    auto token1 = [&](int m) { return m == M - 1 ? c1 : e1 + (size_t)m * D; };

    // ---- r1, n1 = rnd(x1 r1 w) --------------------------------------------
    rms_rows(token0, p.norm_attn, STATS + kRows, OP, M, p.eps, [](int) {});
    rms_rows(token1, p.norm_attn, STATS + kStatFloats + kRows, OP + kStride, M, p.eps, [](int) {});
    for (int i = threadIdx.x; i < 2 * M; i += kThreads)
        STATS[(i >= M) * kStatFloats + i % M] = p.cf[(i >= M ? a1 : a0) * M + i % M];

    // q|k|v = rnd(n1 w_qkv + b)
    qkv_panels<8>(ring, c, OP, QKV, p.b_qkv, kStride);
    __syncthreads();

    // ---- attention, one warp per (head, 16-row query tile) ---------------
    auto no_stats = [](int, int, const float (&)[2], const float (&)[2]) {};
    int8_t* Q8 = reinterpret_cast<int8_t*>(smem + kSmemBytes);  // K1-int8: q and k in int8
    float f0 = 0.f, f1 = 0.f;
    if constexpr (I8) {
        const ScoresI8 i80 = scores_i8(p.i8_scales + 2 * a0, p.scale);
        const ScoresI8 i81 = scores_i8(p.i8_scales + 2 * a1, p.scale);
        quantize_qk(QKV, Q8, M, i80);
        quantize_qk(QKV + kStride, Q8 + kQ8Bytes, M, i81);
        f0 = i80.factor;
        f1 = i81.factor;
        __syncthreads();
    }
    attention_fwd<I8>(QKV, OP, STATS, M, p.scale, no_stats, Q8, f0);
    attention_fwd<I8>(QKV + kStride, OP + kStride, STATS + kStatFloats, M, p.scale, no_stats, Q8 + kQ8Bytes,
                      f1);
    __syncthreads();

    // ---- res = rnd(x1 + rnd(attn w_out + b)); center_out = slot M-1's ----
    bf16* c_out = p.center_out + (at ? a1 : a0) * D;
    out_proj_res<8>(
        ring, c, OP, RES, [&](int m) { return at ? token1(m) : token0(m); }, p.b_out, M,
        [&](int m, int n, float o0, float o1) {
            if (m == M - 1 && store) store2(c_out + n, o0, o1);
        },
        kStride);
    __syncthreads();

    // r2, h_norm = rnd(res r2 w)
    rms_rows([&](int m) { return (const bf16*)RES + m * LA; }, p.norm_mlp, STATS + 2 * kRows, OP, M, p.eps,
             [](int) {});
    rms_rows([&](int m) { return (const bf16*)RES + kStride + m * LA; }, p.norm_mlp,
             STATS + kStatFloats + 2 * kRows, OP + kStride, M, p.eps, [](int) {});

    // ---- SwiGLU over F tiles of 64 columns -> the FFN-out sum (registers)
    // Each tile's ffn_h is written after the tile's FFN-in chunks, whose
    // barriers every warp has passed only once it is done reading the
    // previous tile's ffn_h.
    const bf16* hn = OP + at * kStride;
    bf16* fh = FH + at * kStride;
    float fo[8][4];
    zero(fo);
    for (int j0 = 0; j0 < F; j0 += 64) {
        float av[4][4], ag[4][4];
        zero(av);
        zero(ag);
        glu_mm(ring, c, hn, av, ag);
        // ffn_h = rnd(v sigmoid(g)), v and g from vg = h_norm w_in + b
        panel_pairs([&](int j, int h, int m, int n) {
            const int col = n % 32 + 32 * ((threadIdx.x >> 7) & 1);
            const float2 bv = ld2(p.b_in + j0 + col), bg = ld2(p.b_in + F + j0 + col);
            store2(fh + m * LH + col, (av[j][2 * h] + bv.x) * sigmoidf_(ag[j][2 * h] + bg.x),
                   (av[j][2 * h + 1] + bv.y) * sigmoidf_(ag[j][2 * h + 1] + bg.y));
        });
        panel_mm<1>(ring, c, [&](int, int& ld) { ld = LH; return (const bf16*)fh; }, fo);
    }

    // ---- edge_out = rnd(res + rnd(ffn_h w_ffn_out + b)), slot M-1 zero ----
    bf16* eo = p.edge_out + (at ? a1 : a0) * M * D;
    const bf16* res = RES + at * kStride;
    panel_pairs<8>([&](int j, int h, int m, int n) {
        if (m >= M || !store) return;
        if (m == M - 1) {
            store2(eo + (size_t)m * D + n, 0.f, 0.f);
            return;
        }
        const float2 x = ld2(res + m * LA + n), b = ld2(p.b_ffn_out + n);
        store2(eo + (size_t)m * D + n, x.x + rnd<bf16>(fo[j][2 * h] + b.x),
               x.y + rnd<bf16>(fo[j][2 * h + 1] + b.y));
    });
}

}  // namespace
}  // namespace sm90
}  // namespace mtt

// Whether the Hopper K1 takes a shape: D = 128, heads of 16, 16 <= M <= 64
// with M % 16 == 0, F a multiple of 128 (the wrapper checks the variant:
// bfloat16, no W8A8, no weight requiring grad; exact or int8 scores).
extern "C" int mtt_fused_layer_fwd_sm90_ok(int M, int D, int H, int F) {
    return D == mtt::sm90::D && H == mtt::sm90::H && M >= 16 && M <= mtt::sm90::kRows && M % 16 == 0 &&
           F >= mtt::sm90::kChunkN && F % mtt::sm90::kChunkN == 0;
}

// Its shared memory per block (two atoms), 0 where it does not take the shape.
extern "C" size_t mtt_fused_layer_fwd_sm90_smem(int M, int D, int H, int F) {
    return mtt_fused_layer_fwd_sm90_ok(M, D, H, F) ? (size_t)mtt::sm90::kSmemBytes : 0;
}

// K1-int8 takes the same shapes; its blocks hold the int8 q and k of both
// atoms besides.
extern "C" int mtt_fused_layer_fwd_int8_sm90_ok(int M, int D, int H, int F) {
    return mtt_fused_layer_fwd_sm90_ok(M, D, H, F);
}

extern "C" size_t mtt_fused_layer_fwd_int8_sm90_smem(int M, int D, int H, int F) {
    return mtt_fused_layer_fwd_sm90_ok(M, D, H, F) ? (size_t)mtt::sm90::kSmemBytesI8 : 0;
}

// The launch of either mode.
template <bool I8>
static int launch_k1(const void* edges, const void* center, const float* cf, const void* norm_attn,
                     const void* b_qkv, const void* b_out, const void* norm_mlp, const void* b_in,
                     const void* b_ffn_out, const void* w_qkv_t, const void* w_out_t, const void* w_vg,
                     const void* w_ffn_out_t, const float* i8_scales, void* edge_out, void* center_out,
                     long long A, int M, int D, int H, int F, float scale, float eps, void* stream) {
    using mtt::sm90::bf16;
    if (!mtt_fused_layer_fwd_sm90_ok(M, D, H, F)) return (int)cudaErrorInvalidValue;
    if (A == 0) return 0;
    const mtt::sm90::Args args{(const bf16*)edges, (const bf16*)center, cf, (const bf16*)norm_attn,
                               (const bf16*)b_qkv, (const bf16*)b_out, (const bf16*)norm_mlp,
                               (const bf16*)b_in, (const bf16*)b_ffn_out, i8_scales, (bf16*)edge_out,
                               (bf16*)center_out, A, M, F, scale, eps};
    const mtt::sm90::Chunks chunks{(const bf16*)w_qkv_t, (const bf16*)w_out_t, (const bf16*)w_vg,
                                   (const bf16*)w_ffn_out_t, F};
    const int bytes = I8 ? mtt::sm90::kSmemBytesI8 : mtt::sm90::kSmemBytes;
    cudaError_t err = cudaFuncSetAttribute(mtt::sm90::k1_sm90_kernel<I8>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    mtt::sm90::k1_sm90_kernel<I8><<<(unsigned)((A + 1) / 2), mtt::sm90::kThreads, bytes,
                                    (cudaStream_t)stream>>>(args, chunks);
    return (int)cudaGetLastError();
}

// bfloat16 tensors: the norm scales and biases, then the weight matrices
// rearranged as the chunks read them: w_qkv^T (3D, D), w_out^T (D, D),
// w_vg = w_in^T (2F, D) with its rows in blocks of 64, value block i then
// gate block i, and w_ffn_out^T (D, F). One block per two atoms on
// `stream`. Returns the CUDA error code (0 = ok; cudaErrorInvalidValue for
// a shape it does not take).
extern "C" int mtt_fused_layer_fwd_sm90(
    const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* b_qkv, const void* b_out, const void* norm_mlp,
    const void* b_in, const void* b_ffn_out,
    const void* w_qkv_t, const void* w_out_t, const void* w_vg, const void* w_ffn_out_t,
    void* edge_out, void* center_out,
    long long A, int M, int D, int H, int F, float scale, float eps, void* stream) {
    return launch_k1<false>(edges, center, cf, norm_attn, b_qkv, b_out, norm_mlp, b_in, b_ffn_out, w_qkv_t,
                            w_out_t, w_vg, w_ffn_out_t, nullptr, edge_out, center_out, A, M, D, H, F, scale,
                            eps, stream);
}

// K1-int8: the Hopper K1's arguments and the (A, 2) float32 scales s_q, s_k
// of each atom's block (mtt_int8_absmax), after the weight matrices.
extern "C" int mtt_fused_layer_fwd_int8_sm90(
    const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* b_qkv, const void* b_out, const void* norm_mlp,
    const void* b_in, const void* b_ffn_out,
    const void* w_qkv_t, const void* w_out_t, const void* w_vg, const void* w_ffn_out_t,
    const float* i8_scales, void* edge_out, void* center_out,
    long long A, int M, int D, int H, int F, float scale, float eps, void* stream) {
    return launch_k1<true>(edges, center, cf, norm_attn, b_qkv, b_out, norm_mlp, b_in, b_ffn_out, w_qkv_t,
                           w_out_t, w_vg, w_ffn_out_t, i8_scales, edge_out, center_out, A, M, D, H, F, scale,
                           eps, stream);
}
