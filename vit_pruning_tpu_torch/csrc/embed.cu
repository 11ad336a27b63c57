// Kernels B8a and B8b: the fused patch embedding (sm_90a).
//
//   vpt_patch_embed_forward  replaces vit_pruning_tpu/ops/pallas/embed.py
//                            ::fused_patch_embed_u8 (B8a: uint8 patches,
//                            the image normalisation folded in) and
//                            ::fused_patch_embed_f (B8b: float patches)
//
// out[t, :] = round_w((A[t, :] as f32) * scale + shift) @ W + b + pos[t % N],
// cast once to W's dtype. A is the patch matrix [T = B*N, K = C*P*P] (uint8,
// float32 or bfloat16), W [K, D] and b [D] in W's dtype (float32 or
// bfloat16), pos [N, D] in W's dtype or float32. B8a's scale is
// 1/(255 std) and its shift -mean/std (computed in double by the caller,
// then f32); B8b's are 1 and 0. In the TPU kernel's order: the affine is a
// multiply, then an add, each rounded (__fmul_rn / __fadd_rn: no FMA
// contraction), the result is rounded to W's dtype, the product accumulates
// in f32, then + b and + pos in f32 and one cast. The TPU wrapper fed pos as
// broadcast [B*N, D] rows; here the epilogue reads row t % N of pos [N, D]:
// the same function with B times fewer bytes.
//
// What bounds it on an H100: 2 T K D operations against T K bytes of uint8
// patches (4 T K of float) + T D output values. At DeiT-S width (K 768,
// D 384) that is ~250 operations per byte in bf16, just under the ridge
// (~295), so the bound is the tensor cores' and the memory's alike; at
// ViT-H's (K 588, D 1280) it is operations.
//
// B8a (uint8 patches): one tiled product whose A-tile load (the prologue)
// applies the affine and the rounding, so no normalised copy of the
// patches reaches device memory, and whose epilogue adds b and the
// position row and casts, so the output is written once. bf16 weights:
// WMMA 16x16x16 tiles (mma.sync) with f32 accumulators, 128x128 block tile,
// K in steps of 32 through two shared-memory buffers filled from registers
// (the next tile's loads are in flight during the current tile's products).
//
// B8b (float patches, bf16 weights) has no affine to fold (scale 1, shift
// 0 are the identity), so it runs wgmma.cuh's wgmma + TMA body with its own
// epilogue (+ b, + pos[t % N] in f32, one cast) and one of three A
// producers, chosen by shape: bf16 patches whose rows TMA can describe
// (K % 8 == 0, 16-byte aligned: DeiT-S's K 768) go by TMA straight into the
// swizzled ring; bf16 rows that are 8-byte but not 16-byte multiples
// (ViT-H's K 588: 1,176 bytes) by 8-byte cp.async into the same layout; f32
// patches (and bf16 rows of any other width) through the producer warps'
// registers, rounded to bf16 there. The K tail is zero filled in each.
//
// f32 weights (both): FMA tiles, full f32 (no TF32).
//
// ViT-H's K = 3*14*14 = 588 is not a multiple of the 32-wide K step, and its
// patch rows (588 bytes in uint8, 1,176 in bf16) are not 16-byte aligned:
// B8a reads A one element a lane (a warp reads 32 consecutive values of one
// row), never in 16-byte vectors, and the K tail of both A and W is zero
// filled. W, b, pos and out rows are read and written 8 values at a time:
// D % 8 == 0 and 16-byte aligned pointers, checked by the wrapper.
//
// Later work: an embed that reads the [B, C, H, W] image directly (no patch
// matrix), and B8a on the wgmma body.

#include <mma.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace vpt {

__device__ __forceinline__ float in_f(float v) { return v; }
__device__ __forceinline__ float in_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float in_f(uint8_t v) { return static_cast<float>(v); }

// (x * scale) + shift, each step rounded on its own, as the TPU kernel's f32 ops
__device__ __forceinline__ float affine(float x, float scale, float shift) {
  return __fadd_rn(__fmul_rn(x, scale), shift);
}

// 8 consecutive position values, pos in f32 or bf16
__device__ __forceinline__ void load_pos8(const void* pos, int pos_f32, long i, float* v) {
  if (pos_f32)
    load8(static_cast<const float*>(pos) + i, v);
  else
    load8(static_cast<const bf16*>(pos) + i, v);
}

namespace pe {
constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
constexpr int WM = 64, WN = 32, FM = WM / 16, FN = WN / 16;  // warp tile (2 x 4 warps), fragments
constexpr int LDA = BK + 8, LDB = BN + 8;  // +8 bf16 staggers the banks
constexpr int A_TILE = BM * LDA, B_TILE = BK * LDB;  // elements
constexpr int A_ROWS = BM / (THREADS / 32);          // A rows a warp loads per tile
constexpr size_t SMEM = sizeof(bf16) * 2 * (A_TILE + B_TILE);
static_assert(SMEM >= sizeof(float) * (THREADS / 32) * 256, "epilogue tiles reuse the buffers");
static_assert(SMEM <= 48 * 1024, "static shared memory");
}  // namespace pe

template <typename Tin>
__global__ void __launch_bounds__(pe::THREADS)
embed_bf16_kernel(const Tin* __restrict__ A, const bf16* __restrict__ W,
                  const bf16* __restrict__ bias, const void* __restrict__ pos, int pos_f32,
                  bf16* __restrict__ out, long T, int N, int K, int D, float scale, float shift) {
  using namespace nvcuda;
  using namespace pe;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [2][BM][LDA]
  bf16* Bs = As + 2 * A_TILE;                // [2][BK][LDB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // one K step in registers: A rows warp*A_ROWS.. (lane = k), W as 16-byte chunks
  Tin ra[A_ROWS];
  uint4 rb[2];
  auto fetch = [&](int kt) {
    const int k = kt * BK + lane;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const long m = m0 + warp * A_ROWS + i;
      ra[i] = (m < T && k < K) ? A[m * K + k] : Tin{};
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // W: 32 rows x 16 chunks of 8
      const int c = tid + q * THREADS;
      const int r = c >> 4, nc = (c & 15) * 8;
      const int kk = kt * BK + r, n = n0 + nc;
      rb[q] = (kk < K && n < D) ? *reinterpret_cast<const uint4*>(W + (long)kk * D + n)
                                : make_uint4(0, 0, 0, 0);
    }
  };
  // the prologue: affine, rounded to bf16, into the buffer; zeros past T and K
  auto stash = [&](int kt, int buf) {
    bf16* as = As + buf * A_TILE;
    bf16* bs = Bs + buf * B_TILE;
    const int k = kt * BK + lane;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const long m = m0 + warp * A_ROWS + i;
      const float v = (m < T && k < K) ? affine(in_f(ra[i]), scale, shift) : 0.f;
      as[(warp * A_ROWS + i) * LDA + lane] = __float2bfloat16(v);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tid + q * THREADS;
      const int r = c >> 4, nc = (c & 15) * 8;
      *reinterpret_cast<uint4*>(bs + r * LDB + nc) = rb[q];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + BK - 1) / BK;
  fetch(0);
  stash(0, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) fetch(kt + 1);  // in flight during this step's products
    const bf16* as = As + buf * A_TILE;
    const bf16* bs = Bs + buf * B_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read in step kt - 1, before that step's barrier
    if (kt + 1 < nk) stash(kt + 1, buf ^ 1);
    __syncthreads();
  }

  // epilogue: each fragment through a per-warp 16x16 f32 tile; a lane owns
  // half a row (8 values): + b, + the position row, one cast
  float* cs = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long m = m0 + wm * WM + i * 16 + r;
      const int nb = n0 + wn * WN + j * 16 + c0;
      if (m < T && nb < D) {  // D % 8 == 0: the 8 columns are all in or all out
        float v[8], t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = cs[r * 16 + c0 + u];
        load8(bias + nb, t);
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] += t[u];
        load_pos8(pos, pos_f32, (m % N) * D + nb, t);
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] += t[u];
        store8(out + m * D + nb, v);
      }
      __syncwarp();
    }
}

// f32 weights: common.cuh's gemm_f32_tile (B1's f32 GEMM body) with the
// affine as its A load and + b + pos as its store. pos is f32 here (the
// entry point's rule for f32 weights).
template <typename Tin>
__global__ void __launch_bounds__(fg::THREADS)
embed_f32_kernel(const Tin* __restrict__ A, const float* __restrict__ W,
                 const float* __restrict__ bias, const float* __restrict__ pos,
                 float* __restrict__ out, long T, int N, int K, int D, float scale, float shift) {
  gemm_f32_tile(
      (long)blockIdx.x * fg::BM, blockIdx.y * fg::BN, T, D, K, W,
      [&](long m, int k) { return affine(in_f(A[m * K + k]), scale, shift); },
      [&](long m, int n, float v) { out[m * D + n] = (v + bias[n]) + pos[(m % N) * D + n]; });
}

// B8b's epilogue on the wgmma body: + b, + pos[m % N] (f32 or bf16) in f32,
// one cast. D % 8 == 0: the 8 columns are all in or all out.
struct EmbedEpi {
  const bf16* bias;
  const void* pos;
  int pos_f32, tokens;  // pos rows: tokens = N patches an image
  bf16* out;
  __device__ __forceinline__ void operator()(int m, int n, float* v, int M, int D) const {
    if (m >= M || n >= D) return;
    float t[8];
    load8(bias + n, t);
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] += t[u];
    load_pos8(pos, pos_f32, (long)(m % tokens) * D + n, t);
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] += t[u];
    store8(out + (long)m * D + n, v);
  }
};

template <typename Tin>
cudaError_t embed_wgmma(const Tin* A, const bf16* W, const bf16* b, const void* pos, int pos_f32,
                        bf16* out, int T, int N, int K, int D, cudaStream_t st) {
  CUtensorMap tw;
  VPT_TRY(tma_map_w(&tw, W, D, K));
  const EmbedEpi epi{b, pos, pos_f32, N, out};
  if constexpr (std::is_same<Tin, bf16>::value) {
    if (aligned16(A) && K % 8 == 0) {
      CUtensorMap ta;
      VPT_TRY(tma_map_a(&ta, A, K, T, K));
      return wgmma_gemm(ta, tw, TmaA{}, epi, T, D, K, st);
    }
    if ((reinterpret_cast<uintptr_t>(A) & 7) == 0 && K % 4 == 0)
      return wgmma_gemm(tw, tw, CpAsyncA{A, K}, epi, T, D, K, st);
    return wgmma_gemm(tw, tw, RegA<bf16>{A, K, 0}, epi, T, D, K, st);
  } else {
    const int wide = K % 4 == 0 && aligned16(A);  // two 16-byte loads a chunk
    return wgmma_gemm(tw, tw, RegA<float>{A, K, wide}, epi, T, D, K, st);
  }
}

template <typename Tin>
cudaError_t patch_embed(int w_dtype, const Tin* A, const void* W, const void* b, const void* pos,
                        int pos_f32, void* out, long T, int N, int K, int D, float scale,
                        float shift, cudaStream_t st) {
  if (w_dtype == 1) {
    if constexpr (std::is_same<Tin, uint8_t>::value) {  // B8a
      const dim3 grid((T + pe::BM - 1) / pe::BM, (D + pe::BN - 1) / pe::BN);
      embed_bf16_kernel<Tin><<<grid, pe::THREADS, 0, st>>>(A, (const bf16*)W, (const bf16*)b, pos,
                                                            pos_f32, (bf16*)out, T, N, K, D, scale,
                                                            shift);
    } else {  // B8b: scale 1 and shift 0 are the identity
      return embed_wgmma<Tin>(A, (const bf16*)W, (const bf16*)b, pos, pos_f32, (bf16*)out, (int)T,
                              N, K, D, st);
    }
  } else {
    const dim3 grid((T + fg::BM - 1) / fg::BM, (D + fg::BN - 1) / fg::BN);
    embed_f32_kernel<Tin><<<grid, fg::THREADS, 0, st>>>(A, (const float*)W, (const float*)b,
                                                        (const float*)pos, (float*)out, T, N, K, D,
                                                        scale, shift);
  }
  return cudaGetLastError();
}

}  // namespace vpt

using namespace vpt;

extern "C" {

// in_dtype: 0 = float32, 1 = bfloat16, 2 = uint8 (patches [T, K], row-major,
// any alignment). w_dtype: 0 = float32, 1 = bfloat16 (W [K, D], b [D], out
// [T, D]). pos [N, D] in W's dtype, or float32 with pos_f32 = 1. T a
// multiple of N (B images of N patches); D % 8 == 0; W, b, pos and out
// 16-byte aligned.
int vpt_patch_embed_forward(int in_dtype, int w_dtype, int pos_f32, const void* patches,
                            const void* w, const void* b, const void* pos, void* out, int T, int N,
                            int K, int D, float scale, float shift, void* stream) {
  if (in_dtype < 0 || in_dtype > 2 || (w_dtype != 0 && w_dtype != 1) || (pos_f32 != 0 && pos_f32 != 1) ||
      (w_dtype == 0 && !pos_f32) || T < 1 || N < 1 || T % N || K < 1 || D < 8 || D % 8 ||
      (D + pe::BN - 1) / pe::BN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case 0:
      return patch_embed<float>(w_dtype, (const float*)patches, w, b, pos, pos_f32, out, T, N, K, D,
                                scale, shift, st);
    case 1:
      return patch_embed<bf16>(w_dtype, (const bf16*)patches, w, b, pos, pos_f32, out, T, N, K, D,
                               scale, shift, st);
    default:
      return patch_embed<uint8_t>(w_dtype, (const uint8_t*)patches, w, b, pos, pos_f32, out, T, N, K,
                                  D, scale, shift, st);
  }
}

}  // extern "C"
