// The GEMMs of the layer kernels B1, B2, B3 and B5 (sm_90a): common.cuh's
// gemm(), out[M, N] = epilogue(A[M, K] (row stride lda) @ W[K, N]), W dense
// [K, N] row-major as the param tree stores it. Epilogue, in the TPU
// kernels' order: + bias[n] (T), activation, + residual (T or f32), cast
// (common.cuh).
//
// bf16 takes one of two bodies, chosen by shape alone (wgmma_takes):
//   - wgmma.cuh's wgmma + TMA body wherever TMA can describe A and W
//     (16-byte aligned, lda, N and K multiples of 8): every product of the
//     layers at every geometry the kernels take;
//   - the WMMA (mma.sync) body below otherwise: on the serving paths only
//     B2's classifier when the label count is not a multiple of 8 (100 in
//     the smoke test: 200-byte W rows).
// Each launch is counted per body (vpt_gemm_body_counts) and the shapes
// that took the WMMA body are kept (vpt_gemm_wmma_shapes), so a run can
// show which products took which body.
//
// f32: FMA tiles on the CUDA cores (common.cuh's gemm_f32_tile, full f32,
// no TF32, so f32 matches a f32 reference closely).

#include <mma.h>

#include <algorithm>
#include <atomic>
#include <mutex>
#include <vector>

#include "common.cuh"
#include "wgmma.cuh"

namespace vpt {

// WMMA body: 128x128 block tile, 8 warps (2 x 4), 64x32 per warp as 4x2
// WMMA 16x16x16 fragments (mma.sync) with f32 accumulators; K in steps of 32
// through a 3-stage ring in dynamic smem, A by cp.async. Needs K % 8 == 0,
// lda % 8 == 0 and 16-byte aligned A (checked by the caller). W is read
// value by value: this body takes only the products whose W rows are no
// 16-byte multiple. The epilogue writes 8 outputs per lane with 16-byte
// accesses where the strides allow (Epilogue::vec).
namespace wg {
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int WM = 64, WN = 32, FM = WM / 16, FN = WN / 16;  // warp tile, fragments
constexpr int LDA = BK + 8, LDB = BN + 8;  // +8 bf16 staggers the banks
constexpr int A_STAGE = BM * LDA, B_STAGE = BK * LDB;        // elements
constexpr size_t SMEM = sizeof(bf16) * STAGES * (A_STAGE + B_STAGE);
static_assert(SMEM >= sizeof(float) * (THREADS / 32) * 256, "epilogue tiles reuse the ring");
}

__global__ void __launch_bounds__(wg::THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, long lda, const bf16* __restrict__ W, int M, int N,
                 int K, Epilogue e) {
  using namespace nvcuda;
  using namespace wg;
  extern __shared__ __align__(128) unsigned char gsmem[];
  bf16* As = reinterpret_cast<bf16*>(gsmem);  // [STAGES][BM][LDA]
  bf16* Bs = As + STAGES * A_STAGE;           // [STAGES][BK][LDB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
    bf16* as = As + stage * A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // A: 128 rows x 4 chunks of 8
      const int c = tid + q * THREADS;
      const int r = c >> 2, kc = (c & 3) * 8;
      const int m = m0 + r, k = k0 + kc;
      const bool ok = m < M && k < K;
      cp_async16(as + r * LDA + kc, ok ? A + m * lda + k : A, ok);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // W: 32 rows x 16 chunks of 8
      const int c = tid + q * THREADS;
      const int r = c >> 4, nc = (c & 15) * 8;
      const int k = k0 + r, n = n0 + nc;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bs[r * LDB + nc + j] =
            (k < K && n + j < N) ? W[(long)k * N + n + j] : __float2bfloat16(0.f);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tile(s, s);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's, and stage kt-1 is free
    if (kt + STAGES - 1 < nk) load_tile(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const bf16* as = As + (kt % STAGES) * A_STAGE;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE;
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
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the epilogue tiles

  // epilogue: each fragment through a per-warp 16x16 f32 tile; lane owns
  // half a row (8 values)
  float* cs = reinterpret_cast<float*>(gsmem) + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * WM + i * 16 + r;
      const int nb = n0 + wn * WN + j * 16 + c0;
      if (m < M) {
        float v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = cs[r * 16 + c0 + t];
        if (e.vec && nb + 8 <= N) {
          epilogue_store8<bf16>(e, m, nb, v);
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t)
            if (nb + t < N) epilogue_store<bf16>(e, m, nb + t, v[t]);
        }
      }
      __syncwarp();
    }
}

// the wgmma body's epilogue: common.cuh's, 8 outputs at a time
struct LayerEpi {
  Epilogue e;
  __device__ __forceinline__ void operator()(int m, int n, float* v, int M, int N) const {
    if (m >= M || n >= N) return;
    if (e.vec && n + 8 <= N) {
      epilogue_store8<bf16>(e, m, n, v);
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (n + t < N) epilogue_store<bf16>(e, m, n + t, v[t]);
    }
  }
};

// f32: common.cuh's gemm_f32_tile with A read as is and the Epilogue
__global__ void __launch_bounds__(fg::THREADS)
gemm_f32_kernel(const float* __restrict__ A, long lda, const float* __restrict__ W, int M, int N,
                int K, Epilogue e) {
  gemm_f32_tile(
      (long)blockIdx.y * fg::BM, blockIdx.x * fg::BN, M, N, K, W,
      [&](long m, int k) { return A[m * lda + k]; },
      [&](long m, int n, float v) { epilogue_store<float>(e, static_cast<int>(m), n, v); });
}

// launches per bf16 body (0 wgmma, 1 WMMA) and the distinct shapes that
// took the WMMA body
std::atomic<long long> g_body_launches[2];
std::mutex g_wmma_shapes_mu;
std::vector<int> g_wmma_shapes;  // M, N, K triples
constexpr size_t kMaxShapes = 64;

void note_wmma_shape(int M, int N, int K) {
  std::lock_guard<std::mutex> lock(g_wmma_shapes_mu);
  for (size_t i = 0; i < g_wmma_shapes.size(); i += 3)
    if (g_wmma_shapes[i] == M && g_wmma_shapes[i + 1] == N && g_wmma_shapes[i + 2] == K) return;
  if (g_wmma_shapes.size() < 3 * kMaxShapes) g_wmma_shapes.insert(g_wmma_shapes.end(), {M, N, K});
}

cudaError_t gemm(const bf16* A, long lda, const bf16* W, int M, int N, int K, Epilogue e,
                 cudaStream_t st) {
  set_vec<bf16>(e);
  if (wgmma_takes(A, lda, W, N, K)) {
    CUtensorMap ta, tw;
    VPT_TRY(tma_map_a(&ta, A, lda, M, K));
    VPT_TRY(tma_map_w(&tw, W, N, K));
    VPT_TRY(wgmma_gemm(ta, tw, TmaA{}, LayerEpi{e}, M, N, K, st));
    g_body_launches[0]++;
    return cudaSuccess;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wg::SMEM);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + wg::BN - 1) / wg::BN, (M + wg::BM - 1) / wg::BM);
  gemm_bf16_kernel<<<grid, wg::THREADS, wg::SMEM, st>>>(A, lda, W, M, N, K, e);
  VPT_TRY(cudaGetLastError());
  g_body_launches[1]++;
  note_wmma_shape(M, N, K);
  return cudaSuccess;
}
cudaError_t gemm(const float* A, long lda, const float* W, int M, int N, int K,
                 const Epilogue& e, cudaStream_t st) {
  dim3 grid((N + fg::BN - 1) / fg::BN, (M + fg::BM - 1) / fg::BM);
  gemm_f32_kernel<<<grid, fg::THREADS, 0, st>>>(A, lda, W, M, N, K, e);
  return cudaGetLastError();
}

}  // namespace vpt

using namespace vpt;

extern "C" {

// One bf16 product through gemm(), for tests of the bodies: A [M, K] bf16
// (row stride lda, a multiple of 8, 16-byte aligned), W [K, N] bf16; bias
// [N] bf16 or null; act 0 none, 1 erf GELU, 2 tanh GELU; residual [M, N]
// (row stride ldr) bf16 or f32 (res_f32), or null; out [M, N] (row stride
// ldc) bf16 or f32 (out_f32).
int vpt_gemm_bf16(const void* A, long lda, const void* W, int M, int N, int K, const void* bias,
                  int act, const void* res, long ldr, int res_f32, void* out, long ldc, int out_f32,
                  void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 8 || lda % 8 || lda < K || !aligned16(A) || act < 0 ||
      act > 2 || ldc < N || (res && ldr < N))
    return cudaErrorInvalidValue;
  return gemm(static_cast<const bf16*>(A), lda, static_cast<const bf16*>(W), M, N, K,
              epi(bias, act, res, ldr, res_f32 != 0, out, ldc, out_f32 != 0),
              static_cast<cudaStream_t>(stream));
}

// launches of the wgmma body and of the WMMA body since the last reset
void vpt_gemm_body_counts(long long* out) {
  out[0] = g_body_launches[0].load();
  out[1] = g_body_launches[1].load();
}

void vpt_gemm_body_reset() {
  g_body_launches[0] = 0;
  g_body_launches[1] = 0;
  std::lock_guard<std::mutex> lock(g_wmma_shapes_mu);
  g_wmma_shapes.clear();
}

// the distinct (M, N, K) that took the WMMA body since the last reset: up
// to `max` triples into mnk; returns how many there are
int vpt_gemm_wmma_shapes(int* mnk, int max) {
  std::lock_guard<std::mutex> lock(g_wmma_shapes_mu);
  const int n = static_cast<int>(g_wmma_shapes.size() / 3);
  for (int i = 0; i < 3 * std::min(n, max); ++i) mnk[i] = g_wmma_shapes[i];
  return n;
}

}  // extern "C"
