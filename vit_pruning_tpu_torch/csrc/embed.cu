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
// bf16 weights (B8a and B8b): wgmma.cuh's wgmma + TMA body, one tiled
// product whose A producer applies the affine (B8a) and the rounding to
// bf16, so no normalised copy of the patches reaches device memory, and
// whose epilogue adds b and the position row in f32 and casts once, so the
// output is written once. The A producer is chosen by the patches' type and
// shape:
//   - uint8 (B8a): through the producer warps' registers (RegA<uint8_t>),
//     each row read 16 bytes at a time where the rows allow (DeiT-S's K
//     768), 4 bytes at a time where they are 4-byte multiples (ViT-H's K
//     588: 588-byte rows), else byte by byte; the affine in f32, rounded to
//     bf16, into the swizzled ring. The A operand that reaches the tensor
//     cores is the one the TPU kernel builds, bit for bit.
//   - bf16 whose rows TMA can describe (K % 8 == 0, 16-byte aligned:
//     DeiT-S's K 768): by TMA straight into the swizzled ring;
//   - bf16 rows that are 8-byte but not 16-byte multiples (ViT-H's K 588:
//     1,176 bytes): by 8-byte cp.async into the same layout;
//   - f32 patches (and bf16 rows of any other width): through the producer
//     warps' registers, rounded to bf16 there.
// B8b has no affine to fold (scale 1, shift 0 are the identity). The K tail
// is zero filled in each.
//
// f32 weights (both): FMA tiles, full f32 (no TF32).
//
// W, b, pos and out rows are read and written 8 values at a time: D % 8 ==
// 0 and 16-byte aligned pointers, checked by the wrapper. Each launch is
// counted per body (vpt_embed_body_counts).
//
// Later work: an embed that reads the [B, C, H, W] image directly (no patch
// matrix).

#include <atomic>

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

// B8's epilogue on the wgmma body: + b, + pos[m % N] (f32 or bf16) in f32,
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
                        bf16* out, int T, int N, int K, int D, float scale, float shift,
                        cudaStream_t st) {
  CUtensorMap tw;
  VPT_TRY(tma_map_w(&tw, W, D, K));
  const EmbedEpi epi{b, pos, pos_f32, N, out};
  if constexpr (std::is_same<Tin, uint8_t>::value) {  // B8a
    const uintptr_t a = reinterpret_cast<uintptr_t>(A);
    const int wide = K % 16 == 0 && a % 16 == 0 ? 16 : K % 4 == 0 && a % 4 == 0 ? 4 : 1;
    return wgmma_gemm(tw, tw, RegA<uint8_t>{A, K, wide, scale, shift}, epi, T, D, K, st);
  } else if constexpr (std::is_same<Tin, bf16>::value) {  // B8b: scale 1, shift 0
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

// launches per body: 0 wgmma (bf16 weights), 1 FMA tiles (f32 weights)
std::atomic<long long> g_embed_launches[2];

template <typename Tin>
cudaError_t patch_embed(int w_dtype, const Tin* A, const void* W, const void* b, const void* pos,
                        int pos_f32, void* out, long T, int N, int K, int D, float scale,
                        float shift, cudaStream_t st) {
  if (w_dtype == 1) {
    VPT_TRY(embed_wgmma<Tin>(A, (const bf16*)W, (const bf16*)b, pos, pos_f32, (bf16*)out, (int)T,
                             N, K, D, scale, shift, st));
    g_embed_launches[0]++;
    return cudaSuccess;
  }
  const dim3 grid((T + fg::BM - 1) / fg::BM, (D + fg::BN - 1) / fg::BN);
  embed_f32_kernel<Tin><<<grid, fg::THREADS, 0, st>>>(A, (const float*)W, (const float*)b,
                                                      (const float*)pos, (float*)out, T, N, K, D,
                                                      scale, shift);
  VPT_TRY(cudaGetLastError());
  g_embed_launches[1]++;
  return cudaSuccess;
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
  // the grid's second dimension: the wgmma body's row tiles, the FMA tiles' column tiles
  const long grid_y = w_dtype == 1 ? (T + wgm::BM - 1) / wgm::BM : (D + fg::BN - 1) / fg::BN;
  if (in_dtype < 0 || in_dtype > 2 || (w_dtype != 0 && w_dtype != 1) || (pos_f32 != 0 && pos_f32 != 1) ||
      (w_dtype == 0 && !pos_f32) || T < 1 || N < 1 || T % N || K < 1 || D < 8 || D % 8 ||
      grid_y > 65535)
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

// launches of the wgmma body and of the FMA tiles since the last reset
void vpt_embed_body_counts(long long* out) {
  out[0] = g_embed_launches[0].load();
  out[1] = g_embed_launches[1].load();
}

void vpt_embed_body_reset() {
  g_embed_launches[0] = 0;
  g_embed_launches[1] = 0;
}

}  // extern "C"
