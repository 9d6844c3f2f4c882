// K3: PET row-block stages, forward.
//
// Replaces the TPU kernel metatrain_tpu/ops/pallas/rowblock.py
// `_forward_impl` (entry `fused_rowblock`), the one generic Pallas kernel
// that is traced over three math functions of
// metatrain_tpu/models/pet/fused_stages.py. Here one templated two-layer
// row-MLP kernel is instantiated three times:
//   compress    : h = rnd(silu([x_0 | x_1 | x_2] @ w0 + b0)); out = rnd(h @ w1 + b1)
//   combination : xn = rnd(LayerNorm([edges | reversed])); h = rnd(silu(xn @ w0 + b0));
//                 out = rnd(messages + edges + h @ w1 + b1)
//   head        : h = rnd(silu(x @ w0 + b0)); out = rnd(silu(h @ w1 + b1))
//
// What bounds it on the H100: rows = atoms x neighbor slots (729,088 at the
// bench crystal's served batch, A = 11,392 x M = 64). At d_pet 128 a row
// does about 128 operations per byte it moves (the 3-part compress 131 k
// for 1,024 B), below the card's 295 in bf16, so bytes bound it. A block
// takes a tile of 64 rows; the concatenated input and the hidden layer
// stay in shared memory (up to 128 KB at d_pet 128), so device memory sees
// each input row once and each output row once. The weights stream from
// L2; 64 rows per tile amortise each weight read over 64 rows. Wider
// stages take tiles of 32 or 16 rows, the most that fit (rowblock_fwd_rows:
// the combination at d_pet 256, 2 x 512 floats per row, takes 32). The
// products are common.cuh block_mm: FMA loops in f32, mma.sync tensor
// cores in bf16. The served bf16 compress, combination and head at d_part
// 128 run the Hopper K3 (rowblock_fwd_sm90.cu) instead; this body keeps
// float32, d_pet 256 and every call whose weights require grad.

#include "common.cuh"

namespace mtt {
namespace {

enum Stage { kCompress = 0, kCombination = 1, kHead = 2 };

// Rows per tile: 64, or 32 or 16 where 64 rows of the input and hidden
// layer do not fit in shared memory.
inline int rowblock_fwd_rows(int w_in, int w_hid) {
    int rows = 64;
    while (rows > 16 && (long long)rows * (w_in + w_hid) > kMaxSharedFloats) rows /= 2;
    return rows;
}

template <typename T>
struct RowArgs {
    const T* x0;
    const T* x1;
    const T* x2;
    int n_parts;
    const T* ln_scale;
    const T* ln_bias;
    const T* w0;  // (w_in, w_hid)
    const T* b0;
    const T* w1;  // (w_hid, w_out)
    const T* b1;
    T* out;
    long long rows;
    int d_part, w_in, w_hid, w_out;
    int tile;  // rows per block (rowblock_fwd_rows)
};

template <typename T, int STAGE>
__global__ void __launch_bounds__(kThreads) rowblock_fwd_kernel(RowArgs<T> p) {
    extern __shared__ __align__(16) float smem[];
    const int Win = p.w_in, Wh = p.w_hid, Wo = p.w_out, Dp = p.d_part, tile = p.tile;
    const long long row0 = (long long)blockIdx.x * tile;
    const int valid = (int)min((long long)tile, p.rows - row0);
    float* IN = smem;
    float* HID = IN + tile * Win;
    const T* parts[3] = {p.x0, p.x1, p.x2};

    if (STAGE == kCombination) {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
        for (int r = warp; r < tile; r += nw) {
            float* x = IN + r * Win;
            float s = 0.f;
            for (int c = lane; c < Win; c += 32) {
                x[c] = r < valid ? to_f(parts[c / Dp][(row0 + r) * Dp + c % Dp]) : 0.f;
                s += x[c];
            }
            const float mean = warp_sum(s) / Win;
            float v = 0.f;
            for (int c = lane; c < Win; c += 32) v = fmaf(x[c] - mean, x[c] - mean, v);
            const float rs = rsqrtf(warp_sum(v) / Win + 1e-5f);
            for (int c = lane; c < Win; c += 32)
                x[c] = rnd<T>((x[c] - mean) * rs * to_f(p.ln_scale[c]) + to_f(p.ln_bias[c]));
        }
    } else {
        for (int i = threadIdx.x; i < tile * Win; i += blockDim.x) {
            const int r = i / Win, c = i % Win;
            IN[i] = r < valid ? to_f(parts[c / Dp][(row0 + r) * Dp + c % Dp]) : 0.f;
        }
    }
    __syncthreads();

    block_mm<16>(IN, Win, tile, Win, p.w0, Wh, Wh, [&](int m, int n, float acc) {
        HID[m * Wh + n] = rnd<T>(siluf_(acc + to_f(p.b0[n])));
    });
    __syncthreads();

    block_mm<16>(HID, Wh, tile, Wh, p.w1, Wo, Wo, [&](int m, int n, float acc) {
        if (m >= valid) return;
        const long long o = (row0 + m) * Wo + n;
        float y = acc + to_f(p.b1[n]);
        if (STAGE == kCombination) y = to_f(p.x2[o]) + to_f(p.x0[o]) + y;
        if (STAGE == kHead) y = siluf_(y);
        p.out[o] = from_f<T>(y);
    });
}

template <typename T, int STAGE>
int launch(RowArgs<T> p, cudaStream_t stream) {
    p.tile = rowblock_fwd_rows(p.w_in, p.w_hid);
    const int tile = p.tile;
    const size_t bytes = (size_t)tile * (p.w_in + p.w_hid) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        rowblock_fwd_kernel<T, STAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((p.rows + tile - 1) / tile);
    rowblock_fwd_kernel<T, STAGE><<<blocks, kThreads, bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int stage, const RowArgs<T>& p, cudaStream_t stream) {
    if (stage == kCompress) return launch<T, kCompress>(p, stream);
    if (stage == kCombination) return launch<T, kCombination>(p, stream);
    return launch<T, kHead>(p, stream);
}

}  // namespace
}  // namespace mtt

// Shared-memory bytes of K3; with rows, the rows per tile.
extern "C" size_t mtt_rowblock_fwd_smem(int w_in, int w_hid, int* rows) {
    const int tile = mtt::rowblock_fwd_rows(w_in, w_hid);
    if (rows != nullptr) *rows = tile;
    return (size_t)tile * (w_in + w_hid) * sizeof(float);
}

// stage: 0 = compress (x0..x{n_parts-1} concatenated), 1 = combination
// (x0 = edges, x1 = reversed, x2 = messages), 2 = head (x0).
// dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error code (0 = ok).
extern "C" int mtt_rowblock_fwd(
    int dtype, int stage, const void* x0, const void* x1, const void* x2, int n_parts,
    const void* ln_scale, const void* ln_bias,
    const void* w0, const void* b0, const void* w1, const void* b1, void* out,
    long long rows, int d_part, int w_in, int w_hid, int w_out, void* stream) {
#define MTT_ARGS(T)                                                                   \
    mtt::RowArgs<T>{(const T*)x0, (const T*)x1, (const T*)x2, n_parts,                \
                    (const T*)ln_scale, (const T*)ln_bias, (const T*)w0, (const T*)b0, \
                    (const T*)w1, (const T*)b1, (T*)out, rows, d_part, w_in, w_hid, w_out}
    if (rows == 0) return 0;
    if (dtype == 0) return mtt::dispatch(stage, MTT_ARGS(float), (cudaStream_t)stream);
    return mtt::dispatch(stage, MTT_ARGS(__nv_bfloat16), (cudaStream_t)stream);
#undef MTT_ARGS
}
