// K1 on Hopper: the exact bfloat16 forward of the fused PET transformer
// layer, redesigned for the H100 at the served shapes; and, as its
// int8-score mode, K1-int8 there, and as its W8A8 mode, K1-W8A8 (below).
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
// K1-int8 (mtt_fused_layer_fwd_int8_sm90, the kernel's mode kInt8) replaces
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
//
// K1-W8A8 (mtt_fused_layer_fwd_w8a8_sm90, the kernel's W8A8 mode) replaces
// the same `_fwd_kernel` with w8a8 (`_layer_math`'s W8A8 branches, the
// quantizers `_qs_static`, `_rms_norm_q`, `_dot_i8`, `_deq` and the rounded
// softmax of `_qside_tail`): the plain version is `layer_math(..., w8a8=)`,
// the general body K1-W8A8 of fused_layer_fwd.cu. QKV, FFN-in and FFN-out
// run as s8 wgmma (m64n64k32 / m64n32k32) on int8 operand tiles and int8
// weight chunks (layer_sm90.cuh's W8A8 section): n1 and h_norm quantize
// from their floats into the operand tile's room (rows of LA8 bytes), q
// and k from the dequantized float q_f, k_f into the int8 copy of K1-int8
// (bf16 q|k|v beside it: v is the AV operand); the scores and the softmax
// are K1-int8's with factor = deq(q, k) scale; the out-projection stays
// bf16. The FFN walks F in tiles of 128: two int8 chunks of value and gate
// rows (w_in^T int8 in k1_sm90_w_vg's blocks of 64), ffn_h quantized from
// v sigmoid(g) into an int8 64 x 128 tile where the bf16 ffn_h tile was,
// then one int8 chunk of w_ffn_out^T; the FFN-out sum stays int32 in
// registers across the tiles (exact), then edge_out = rnd(res + rnd((sum
// deq_fo) + b_ffn_out)). 5 + 3 F / 128 chunks (11 at F = 256, 176 KB:
// half the bf16 weight bytes), the shared memory of K1-int8 (220,672 B).
// Bound at the served shape: 0.151 ms (the int8 products at 1,979 TOPS,
// AV and the out-projection at 989 TFLOP/s). The forward phases up to h_norm
// and vg are K2-W8A8's recompute (int32 sums are exact in any order, so
// vg is too), so its energy and K2-W8A8's forces come from one function.

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
// K1-W8A8: the int8 n1 and h_norm in the operand tile's room, the int8
// ffn_h tile (64 x 128) in the bf16 one's, the int8 q and k as K1-int8's
static_assert(kRows * LA8 <= kOpBytes && kOffFh + kRows * LA8 <= kQkvBytes, "int8 tiles reuse rooms");

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

// K1-W8A8's chunks: QKV (w_qkv^T int8, 3 panels of 128 k), out-projection
// (w_out^T bf16, 2), per F tile of 128 columns j0: FFN-in (two int8 chunks of
// the int8 w_in^T in k1_sm90_w_vg's blocks of 64: value columns j0 + 64 r ..
// + 63, then the same gate columns), FFN-out (w_ffn_out^T int8 columns j0 ..
// j0 + 127, 1). The mode's static scales travel here, beside its int8
// weights, and not in Args (see K2's ChunksW8).
struct ChunksW8 {
    const int8_t *w_qkv_t, *w_vg, *w_fo_t;
    const bf16* w_out_t;
    int F;
    LayerI8 s8;

    __device__ const bf16* operator()(int c, int& ld) const {
        if (c < 3) return chunk8(w_qkv_t + (size_t)c * kChunkN * D, D, ld);
        c -= 3;
        ld = D;
        if (c < 2) return w_out_t + c * kChunkK;
        c -= 2;
        const int j0 = c / 3 * kChunkN, r = c % 3;
        if (r < 2) return chunk8(w_vg + (size_t)(2 * j0 + r * kChunkN) * D, D, ld);
        return chunk8(w_fo_t + j0, F, ld);
    }
};

__host__ __device__ constexpr int chunk_count_w8(int F) { return 5 + 3 * (F / kChunkN); }

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

// glu_mm over int8: av, ag += h_norm (64 x 128 int8) times the value and
// gate rows of the ring's next int8 chunk, in glu_mm's layout (two
// m64n32k32 per k step).
template <typename Ring>
__device__ __forceinline__ void glu_mm_s8(Ring& ring, int& c, const int8_t* HN, int (&av)[4][4],
                                          int (&ag)[4][4]) {
    const int r0 = 16 * ((threadIdx.x >> 5) & 3), half = (threadIdx.x >> 7) & 1;
    const bf16* B = ring.consume(c++);
    uint32_t a[kChunkK8 / 32][4];
#pragma unroll
    for (int ks = 0; ks < kChunkK8 / 32; ++ks) load_a_s8_k32(a[ks], HN, LA8, r0, 32 * ks);
    const uint64_t dv = desc_sw128(B + 32 * half * kChunkK);
    const uint64_t dg = desc_sw128(B + (64 + 32 * half) * kChunkK);
    acc_fence(av);
    acc_fence(ag);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kChunkK8 / 32; ++ks) {
        wgmma_m64n32k32_s8(av, a[ks], dv + 2 * ks);
        wgmma_m64n32k32_s8(ag, a[ks], dg + 2 * ks);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    acc_fence(av);
    acc_fence(ag);
}

// K1-W8A8 from h_norm on, for the calling thread's atom (its int8 h_norm HN,
// the int8 ffn_h tile FH, res, its edge_out rows): per F tile of 128
// columns, ffn_h = q(v sigmoid(g)) with v and g of vg = (h_norm w_in deq_in)
// + b_in in float, 64 columns per FFN-in chunk, then the tile's FFN-out
// chunk into the int32 sum; edge_out = rnd(res + rnd((sum deq_fo) +
// b_ffn_out)), slot M-1 zero. The tile's FH stores follow its FFN-in
// chunks' barriers, which every warp passes only once it is done reading
// the previous tile's FH.
template <typename Ring>
__device__ __forceinline__ void ffn_w8a8(Ring& ring, int& c, const Args& p, const LayerI8& s8,
                                         const int8_t* HN, int8_t* FH, const bf16* res, bf16* eo, int M, int F,
                                         bool store) {
    int fo[8][4];
    zero(fo);
    for (int j0 = 0; j0 < F; j0 += kChunkN) {
        for (int r = 0; r < 2; ++r) {
            int av[4][4], ag[4][4];
            zero(av);
            zero(ag);
            glu_mm_s8(ring, c, HN, av, ag);
            panel_pairs([&](int j, int h, int m, int n) {
                const int col = 64 * r + n % 32 + 32 * ((threadIdx.x >> 7) & 1);
                const float2 bv = ld2(p.b_in + j0 + col), bg = ld2(p.b_in + F + j0 + col);
                const float v0 = dequant(av[j][2 * h], s8.deq_in, bv.x);
                const float v1 = dequant(av[j][2 * h + 1], s8.deq_in, bv.y);
                const float g0 = dequant(ag[j][2 * h], s8.deq_in, bg.x);
                const float g1 = dequant(ag[j][2 * h + 1], s8.deq_in, bg.y);
                *reinterpret_cast<uint16_t*>(FH + m * LA8 + col) =
                    (uint16_t)(quant_s8(v0 * sigmoidf_(g0), s8.inv_ffn) |
                               quant_s8(v1 * sigmoidf_(g1), s8.inv_ffn) << 8);
            });
        }
        panel_mm_s8<1>(ring, c, [&](int, int& ld) { ld = LA8; return (const int8_t*)FH; }, fo);
    }
    panel_pairs<8>([&](int j, int h, int m, int n) {
        if (m >= M || !store) return;
        if (m == M - 1) {
            store2(eo + (size_t)m * D + n, 0.f, 0.f);
            return;
        }
        const float2 x = ld2(res + m * LA + n), b = ld2(p.b_ffn_out + n);
        store2(eo + (size_t)m * D + n, x.x + rnd<bf16>(dequant(fo[j][2 * h], s8.deq_fo, b.x)),
               x.y + rnd<bf16>(dequant(fo[j][2 * h + 1], s8.deq_fo, b.y)));
    });
}

// Two atoms per block (2 b and 2 b + 1; an odd last atom is computed twice
// and stored once). Warps 0-7 run atom 0's part of every dense product and
// warps 8-15 atom 1's, each warpgroup on 64 columns (m64n64k16), so each
// staged chunk serves both atoms; the norms and the attention run atom
// after atom on all 16 warps. MODE kInt8: K1-int8, each atom's scores from
// its own scale pair; kW8A8: K1-W8A8 (n1, h_norm and ffn_h in int8, the
// products but AV and the out-projection on s8 wgmma).
template <int MODE, typename Ch>
__global__ void __launch_bounds__(kThreads, 1)
    k1_sm90_kernel(Args p, Ch chunks) {
    constexpr bool I8 = MODE != kExact;  // the int8 scores and the rounded softmax
    constexpr bool W8 = MODE == kW8A8;
    extern __shared__ __align__(1024) unsigned char smem[];
    constexpr size_t kStride = kAtomBytes / 2;  // elements from atom 0's buffers to atom 1's
    bf16* QKV = reinterpret_cast<bf16*>(smem);            // q|k|v
    bf16* RES = QKV;                                      // then res
    bf16* FH = reinterpret_cast<bf16*>(smem + kOffFh);    // and the ffn_h tile
    bf16* OP = reinterpret_cast<bf16*>(smem + kQkvBytes);  // n1, attn, h_norm
    int8_t* OP8 = reinterpret_cast<int8_t*>(OP);          // W8A8: n1 and h_norm in int8
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

    WeightRing<Ch> ring{reinterpret_cast<bf16*>(smem + kOffRing), chunks,
                        W8 ? chunk_count_w8(F) : chunk_count(F)};
    ring.start();
    int c = 0;
    auto token0 = [&](int m) { return m == M - 1 ? c0 : e0 + (size_t)m * D; };
    auto token1 = [&](int m) { return m == M - 1 ? c1 : e1 + (size_t)m * D; };

    // ---- r1, n1 = rnd(x1 r1 w) (W8A8: quantized from x1 r1 w) ------------
    if constexpr (W8) {
        rms_rows_s8(token0, p.norm_attn, STATS + kRows, OP8, M, p.eps, chunks.s8.inv_normed, [](int) {});
        rms_rows_s8(token1, p.norm_attn, STATS + kStatFloats + kRows, OP8 + kAtomBytes, M, p.eps,
                    chunks.s8.inv_normed, [](int) {});
    } else {
        rms_rows(token0, p.norm_attn, STATS + kRows, OP, M, p.eps, [](int) {});
        rms_rows(token1, p.norm_attn, STATS + kStatFloats + kRows, OP + kStride, M, p.eps, [](int) {});
    }
    for (int i = threadIdx.x; i < 2 * M; i += kThreads)
        STATS[(i >= M) * kStatFloats + i % M] = p.cf[(i >= M ? a1 : a0) * M + i % M];

    // q|k|v = rnd(n1 w_qkv + b) (W8A8: of the int8 product; q and k into Q8)
    int8_t* Q8 = reinterpret_cast<int8_t*>(smem + kSmemBytes);  // K1-int8, K1-W8A8: q and k in int8
    if constexpr (W8)
        qkv_panels_s8<8>(ring, c, OP8, QKV, Q8, p.b_qkv, chunks.s8, kStride, kAtomBytes, kQ8Bytes);
    else
        qkv_panels<8>(ring, c, OP, QKV, p.b_qkv, kStride);
    __syncthreads();

    // ---- attention, one warp per (head, 16-row query tile) ---------------
    auto no_stats = [](int, int, const float (&)[2], const float (&)[2]) {};
    float f0 = 0.f, f1 = 0.f;
    if constexpr (W8) {
        f0 = f1 = chunks.s8.deq_scores;  // the static factor
    } else if constexpr (MODE == kInt8) {
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

    // r2, h_norm = rnd(res r2 w) (W8A8: quantized from res r2 w)
    auto res0 = [&](int m) { return (const bf16*)RES + m * LA; };
    auto res1 = [&](int m) { return (const bf16*)RES + kStride + m * LA; };
    if constexpr (W8) {
        rms_rows_s8(res0, p.norm_mlp, STATS + 2 * kRows, OP8, M, p.eps, chunks.s8.inv_hnorm, [](int) {});
        rms_rows_s8(res1, p.norm_mlp, STATS + kStatFloats + 2 * kRows, OP8 + kAtomBytes, M, p.eps,
                    chunks.s8.inv_hnorm, [](int) {});
        int8_t* fh8 = reinterpret_cast<int8_t*>(smem + kOffFh) + at * kAtomBytes;
        ffn_w8a8(ring, c, p, chunks.s8, OP8 + at * kAtomBytes, fh8, RES + at * kStride,
                 p.edge_out + (at ? a1 : a0) * M * D, M, F, store);
        return;
    }
    rms_rows(res0, p.norm_mlp, STATS + 2 * kRows, OP, M, p.eps, [](int) {});
    rms_rows(res1, p.norm_mlp, STATS + kStatFloats + 2 * kRows, OP + kStride, M, p.eps, [](int) {});

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
// bfloat16, no weight requiring grad; exact, int8 scores or W8A8). Every
// mode takes these shapes.
extern "C" int mtt_fused_layer_fwd_sm90_ok(int M, int D, int H, int F) {
    return D == mtt::sm90::D && H == mtt::sm90::H && M >= 16 && M <= mtt::sm90::kRows && M % 16 == 0 &&
           F >= mtt::sm90::kChunkN && F % mtt::sm90::kChunkN == 0;
}

// Its shared memory per block (two atoms), 0 where it does not take the shape.
extern "C" size_t mtt_fused_layer_fwd_sm90_smem(int M, int D, int H, int F) {
    return mtt_fused_layer_fwd_sm90_ok(M, D, H, F) ? (size_t)mtt::sm90::kSmemBytes : 0;
}

// K1-int8's blocks hold the int8 q and k of both atoms besides.
extern "C" size_t mtt_fused_layer_fwd_int8_sm90_smem(int M, int D, int H, int F) {
    return mtt_fused_layer_fwd_sm90_ok(M, D, H, F) ? (size_t)mtt::sm90::kSmemBytesI8 : 0;
}

// K1-W8A8's too (its int8 n1, h_norm and ffn_h reuse the bf16 tiles' rooms).
extern "C" size_t mtt_fused_layer_fwd_w8a8_sm90_smem(int M, int D, int H, int F) {
    return mtt_fused_layer_fwd_sm90_ok(M, D, H, F) ? (size_t)mtt::sm90::kSmemBytesI8 : 0;
}

// The launch of a mode, with its chunks and its Args (but for the shape).
template <int MODE, typename Ch>
static int launch_k1(mtt::sm90::Args args, Ch chunks, long long A, int M, int D, int H, int F, void* stream) {
    if (!mtt_fused_layer_fwd_sm90_ok(M, D, H, F)) return (int)cudaErrorInvalidValue;
    if (A == 0) return 0;
    args.A = A;
    args.M = M;
    args.F = F;
    const int bytes = MODE == mtt::sm90::kExact ? mtt::sm90::kSmemBytes : mtt::sm90::kSmemBytesI8;
    cudaError_t err = cudaFuncSetAttribute(mtt::sm90::k1_sm90_kernel<MODE, Ch>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    mtt::sm90::k1_sm90_kernel<MODE, Ch><<<(unsigned)((A + 1) / 2), mtt::sm90::kThreads, bytes,
                                          (cudaStream_t)stream>>>(args, chunks);
    return (int)cudaGetLastError();
}

// The exact and the int8-score modes: the same weights, the same chunks.
template <int MODE>
static int launch_k1_bf16(const void* edges, const void* center, const float* cf, const void* norm_attn,
                          const void* b_qkv, const void* b_out, const void* norm_mlp, const void* b_in,
                          const void* b_ffn_out, const void* w_qkv_t, const void* w_out_t, const void* w_vg,
                          const void* w_ffn_out_t, const float* i8_scales, void* edge_out, void* center_out,
                          long long A, int M, int D, int H, int F, float scale, float eps, void* stream) {
    using mtt::sm90::bf16;
    const mtt::sm90::Args args{(const bf16*)edges, (const bf16*)center, cf, (const bf16*)norm_attn,
                               (const bf16*)b_qkv, (const bf16*)b_out, (const bf16*)norm_mlp,
                               (const bf16*)b_in, (const bf16*)b_ffn_out, i8_scales,
                               (bf16*)edge_out, (bf16*)center_out, A, M, F, scale, eps};
    const mtt::sm90::Chunks chunks{(const bf16*)w_qkv_t, (const bf16*)w_out_t, (const bf16*)w_vg,
                                   (const bf16*)w_ffn_out_t, F};
    return launch_k1<MODE>(args, chunks, A, M, D, H, F, stream);
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
    return launch_k1_bf16<mtt::sm90::kExact>(edges, center, cf, norm_attn, b_qkv, b_out, norm_mlp, b_in,
                                             b_ffn_out, w_qkv_t, w_out_t, w_vg, w_ffn_out_t, nullptr,
                                             edge_out, center_out, A, M, D, H, F, scale, eps, stream);
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
    return launch_k1_bf16<mtt::sm90::kInt8>(edges, center, cf, norm_attn, b_qkv, b_out, norm_mlp, b_in,
                                            b_ffn_out, w_qkv_t, w_out_t, w_vg, w_ffn_out_t, i8_scales,
                                            edge_out, center_out, A, M, D, H, F, scale, eps, stream);
}

// K1-W8A8: the norm scales and biases (bfloat16), w_out^T (bfloat16), the
// int8 weights as the chunks read them: w_qkv^T (3D, D), w_in^T (2F, D) in
// k1_sm90_w_vg's blocks of 64 and w_ffn_out^T (D, F), then the 11 static
// scales of the general entry (a host array: common.cuh layer_i8's order;
// the scores' factor holds the attention scale).
extern "C" int mtt_fused_layer_fwd_w8a8_sm90(
    const void* edges, const void* center, const float* cf,
    const void* norm_attn, const void* b_qkv, const void* b_out, const void* norm_mlp,
    const void* b_in, const void* b_ffn_out, const void* w_out_t,
    const void* w_qkv8_t, const void* w_vg8, const void* w_fo8_t, const float* scales,
    void* edge_out, void* center_out,
    long long A, int M, int D, int H, int F, float eps, void* stream) {
    using mtt::sm90::bf16;
    const mtt::sm90::Args args{(const bf16*)edges, (const bf16*)center, cf, (const bf16*)norm_attn,
                               (const bf16*)b_qkv, (const bf16*)b_out, (const bf16*)norm_mlp,
                               (const bf16*)b_in, (const bf16*)b_ffn_out, nullptr, (bf16*)edge_out,
                               (bf16*)center_out, A, M, F, 0.f, eps};
    const mtt::sm90::ChunksW8 chunks{(const int8_t*)w_qkv8_t, (const int8_t*)w_vg8, (const int8_t*)w_fo8_t,
                                     (const bf16*)w_out_t, F,
                                     mtt::layer_i8(nullptr, nullptr, nullptr, scales)};
    return launch_k1<mtt::sm90::kW8A8>(args, chunks, A, M, D, H, F, stream);
}
