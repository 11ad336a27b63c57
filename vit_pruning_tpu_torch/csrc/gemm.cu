// The GEMMs of the layer kernels B1, B3 and B5 and of B2 in f32 (sm_90a): common.cuh's
// gemm(), out[M, N] = epilogue(A[M, K] (row stride lda) @ W[K, N]), W dense
// [K, N] row-major as the param tree stores it. Epilogue, in the TPU
// kernels' order: + bias[n] (T), activation, + residual (T or f32), cast
// (common.cuh).
//
// bf16 takes one of two bodies, chosen by shape alone (wgmma_takes):
//   - wgmma.cuh's persistent wgmma + TMA body wherever TMA can describe A
//     and W (16-byte aligned, lda, N and K multiples of 8): every product
//     of the layers at every geometry the kernels take, one launch a
//     product, each block walking several 128 x 128 output tiles;
//   - the WMMA (mma.sync) body below otherwise: no product of the serving
//     paths since B2's bf16 launches (cls_logits.cu) replaced its products
//     and pad the classifier to a multiple of 8 labels; a direct gemm_bf16
//     call with N % 8 != 0.
//
// f32 takes split6.cuh's split body (N a multiple of 8, as every product of
// the layers): the product on wgmma as six bf16 passes over exact three-way
// splits of both operands, accumulated in f32 (full f32 accuracy, no TF32).
//
// Each launch is counted per body (vpt_gemm_body_counts), with the output
// tiles the wgmma body walked and the blocks it launched to walk them, and
// the shapes that took the WMMA body are kept (vpt_gemm_wmma_shapes), so a
// run can show which products took which body and how many tiles a block
// walked.

#include <mma.h>

#include <algorithm>
#include <atomic>
#include <mutex>
#include <vector>

#include "common.cuh"
#include "split6.cuh"

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

// the GEMM bodies' epilogue, common.cuh's, 8 outputs at a time, bias and
// residual in T (or f32). The persistent wgmma body loads a tile's bias
// (cols) before its products, brings its residual rows into L2 (prefetch),
// and loads four groups' residual (fetch) before it finishes the first
// (finish); it fixes the activation at compile time (ACT >= 0), so that a
// group's eight activations interleave. ACT -1 reads it from e.
template <typename T, int ACT = -1>
struct LayerEpi {
  Epilogue e;
  using Cols = Raw8<T>;
  __device__ __forceinline__ void operator()(int m, int n, float* v, int M, int N) const {
    Raw8<T> b{};
    float r[8];
    cols(n, b, N);
    fetch(m, n, r, M, N);
    finish(m, n, v, b, r, M, N);
  }
  __device__ __forceinline__ bool whole(int n, int N) const { return e.vec && n + 8 <= N; }
  __device__ __forceinline__ void cols(int n, Raw8<T>& b, int N) const {
    if (e.bias && whole(n, N)) b = load_raw8(static_cast<const T*>(e.bias) + n);
  }
  __device__ __forceinline__ void fetch(int m, int n, float* r, int M, int N) const {
    if (m < M && whole(n, N)) epilogue_fetch8<T>(e, m, n, r);
  }
  __device__ __forceinline__ void finish(int m, int n, float* v, const Raw8<T>& b, const float* r,
                                         int M, int N) const {
    if (m >= M || n >= N) return;
    if (whole(n, N)) {
      epilogue_finish8<T, ACT>(e, m, n, v, b, r);
    } else {  // rows not 16-byte aligned, or the last columns: value by value
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (n + i < N) epilogue_store<T>(e, m, n + i, v[i]);
    }
  }
  // where the persistent body stores by TMA (e.vec: whole groups alone)
  __device__ __forceinline__ void apply(int, float* v, const Raw8<T>& b, const float* r) const {
    epilogue_apply8<T, ACT>(e, v, b, r);
  }
  __device__ __forceinline__ bool out_f32() const { return e.out_f32; }
  // the residual rows of tile (m0, n0) into L2: a warpgroup's 128 threads,
  // 128 rows of 128 columns in 128-byte lines
  __device__ __forceinline__ void prefetch(int m0, int n0, int M, int N) const {
    if (!e.res) return;
    const int el = e.res_f32 ? 4 : sizeof(T), lines = el;  // 128 el bytes a row
    for (int i = threadIdx.x & 127; i < 128 * lines; i += 128) {
      const int m = m0 + i / lines, n = n0 + i % lines * (128 / el);
      if (m < M && n < N)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(static_cast<const char*>(e.res) +
                                                          (m * e.ldr + n) * el));
    }
  }
};

// DINOv2's two variants of the persistent body's epilogue, each its own
// instance of the body (so that LayerEpi's instances are what they were
// without them), bf16 alone, no activation. Both load the bias before the
// tile's products, as LayerEpi; ScaledEpi reads LayerScale's gain where it
// applies it (an L1-resident [N] vector), so that no more registers stay
// live across the products than LayerEpi's.
//
// ScaledEpi: out = res + gamma[n] * (acc + b), res in bf16 or f32, out in
// bf16 or f32 (O and fc2 of a LayerScale layer).
struct ScaledEpi : LayerEpi<bf16, ACT_NONE> {
  __device__ __forceinline__ void finish(int m, int n, float* v, const Cols& c, const float* r,
                                         int M, int N) const {
    if (m >= M || n >= N) return;
    if (whole(n, N)) {
      apply(n, v, c, r);
      if (e.out_f32)
        store8(static_cast<float*>(e.out) + m * e.ldc + n, v);
      else
        store8(static_cast<bf16*>(e.out) + m * e.ldc + n, v);
      return;
    }
    const bf16* bias = static_cast<const bf16*>(e.bias);
    const bf16* gamma = static_cast<const bf16*>(e.gamma);
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // rows not 16-byte aligned, or the last columns
      const int j = n + i;
      if (j >= N) continue;
      float x = (v[i] + (bias ? to_f(bias[j]) : 0.f)) * to_f(gamma[j]);
      if (e.res) {
        const long ri = m * e.ldr + j;
        x += e.res_f32 ? static_cast<const float*>(e.res)[ri]
                       : to_f(static_cast<const bf16*>(e.res)[ri]);
      }
      if (e.out_f32)
        static_cast<float*>(e.out)[m * e.ldc + j] = x;
      else
        static_cast<bf16*>(e.out)[m * e.ldc + j] = from_f<bf16>(x);
    }
  }
  __device__ __forceinline__ void apply(int n, float* v, const Cols& c, const float* r) const {
    float t[8];
    load8(static_cast<const bf16*>(e.gamma) + n, t);
    if (e.bias) {
      float b[8];
      load8(reinterpret_cast<const bf16*>(&c), b);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += b[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] *= t[i];
    if (e.res) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += r[i];
    }
  }
};

// GatedEpi: SwiGLU's fc1, whose product columns are (u1, u2) pairs (2i,
// 2i + 1): a group of 8 columns gives 4 outputs, silu(u1 + b) * (u2 + b),
// at column n / 2 of an [M, N / 2] bf16 output, no residual. kGate tells the
// body to stage and store a 64-column quarter as a [16 x 32] box.
struct GatedEpi : LayerEpi<bf16, ACT_NONE> {
  static constexpr bool kGate = true;
  __device__ __forceinline__ void finish(int m, int n, float* v, const Cols& c, const float* r,
                                         int M, int N) const {
    if (m >= M || n >= N) return;
    if (whole(n, N)) {
      apply(n, v, c, r);
      store4(static_cast<bf16*>(e.out) + m * e.ldc + n / 2, v);
      return;
    }
    const bf16* bias = static_cast<const bf16*>(e.bias);
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // rows not 16-byte aligned, or the last columns
      const int j = n + 2 * i;
      if (j + 1 >= N) continue;
      const float u1 = v[2 * i] + (bias ? to_f(bias[j]) : 0.f);
      const float u2 = v[2 * i + 1] + (bias ? to_f(bias[j + 1]) : 0.f);
      static_cast<bf16*>(e.out)[m * e.ldc + j / 2] = from_f<bf16>(swiglu(u1, u2));
    }
  }
  // the 4 outputs in v[0..3]
  __device__ __forceinline__ void apply(int, float* v, const Cols& c, const float*) const {
    if (e.bias) {
      float b[8];
      load8(reinterpret_cast<const bf16*>(&c), b);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += b[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = swiglu(v[2 * i], v[2 * i + 1]);
  }
};

// launches per body (0 bf16 wgmma, 1 bf16 WMMA, 2 f32 split), then the
// wgmma body's output tiles (3) and blocks (4), its tiles through the gated
// epilogue (5) and through LayerScale's (6), and the distinct shapes that
// took the WMMA body
constexpr int kBodies = 3, kCounts = 7;
std::atomic<long long> g_body_launches[kCounts];
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
                 cudaStream_t st, bf16*) {
  set_vec<bf16>(e);
  if (e.gate || e.gamma) {  // the variants: the persistent body alone, no activation
    if (!wgmma_takes(A, lda, W, N, K) || e.act != ACT_NONE ||
        (e.gate && (e.gamma || e.res || e.out_f32 || N % 16)))
      return cudaErrorInvalidValue;
    CUtensorMap ta, tw, to;
    VPT_TRY(tma_map_a(&ta, A, lda, M, K));
    VPT_TRY(tma_map_w(&tw, W, N, K));
    // the gated output is [M, N / 2]: boxes of 16 rows x 32
    if (e.vec)
      VPT_TRY(e.gate ? tma_map_out(&to, e.out, e.ldc, M, N / 2, 2, 32)
                     : tma_map_out(&to, e.out, e.ldc, M, N, e.out_f32 ? 4 : 2));
    const CUtensorMap* tmo = e.vec ? &to : nullptr;
    Walk walk;
    if (e.gate)
      VPT_TRY(wgmma_gemm(ta, tw, tmo, GatedEpi{{e}}, M, N, K, st, &walk));
    else
      VPT_TRY(wgmma_gemm(ta, tw, tmo, ScaledEpi{{e}}, M, N, K, st, &walk));
    g_body_launches[0]++;
    g_body_launches[kBodies] += walk.tiles;
    g_body_launches[kBodies + 1] += walk.blocks;
    g_body_launches[e.gate ? kBodies + 2 : kBodies + 3] += walk.tiles;
    return cudaSuccess;
  }
  if (wgmma_takes(A, lda, W, N, K)) {
    CUtensorMap ta, tw;
    VPT_TRY(tma_map_a(&ta, A, lda, M, K));
    VPT_TRY(tma_map_w(&tw, W, N, K));
    // the output by TMA where its rows are 16-byte aligned (as every other
    // access of the epilogue then is)
    CUtensorMap to;
    if (e.vec) VPT_TRY(tma_map_out(&to, e.out, e.ldc, M, N, e.out_f32 ? 4 : 2));
    const CUtensorMap* tmo = e.vec ? &to : nullptr;
    Walk walk;
    if (e.act == ACT_GELU_TANH)
      VPT_TRY(wgmma_gemm(ta, tw, tmo, LayerEpi<bf16, ACT_GELU_TANH>{e}, M, N, K, st, &walk));
    else if (e.act == ACT_GELU_ERF)
      VPT_TRY(wgmma_gemm(ta, tw, tmo, LayerEpi<bf16, ACT_GELU_ERF>{e}, M, N, K, st, &walk));
    else
      VPT_TRY(wgmma_gemm(ta, tw, tmo, LayerEpi<bf16, ACT_NONE>{e}, M, N, K, st, &walk));
    g_body_launches[0]++;
    g_body_launches[kBodies] += walk.tiles;
    g_body_launches[kBodies + 1] += walk.blocks;
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
// f32: split6.cuh's split body, A read as f32 (SplitA), common.cuh's epilogue
cudaError_t gemm(const float* A, long lda, const float* W, int M, int N, int K,
                 const Epilogue& e0, cudaStream_t st, bf16* wplanes) {
  if (N % 8 || e0.gate || e0.gamma) return cudaErrorInvalidValue;
  Epilogue e = e0;
  set_vec<float>(e);
  VPT_TRY(split6_gemm(SplitA{A, lda, M, K, lda % 4 == 0 && aligned16(A)}, W, N,
                      LayerEpi<float>{e}, wplanes, st));
  g_body_launches[2]++;
  return cudaSuccess;
}

}  // namespace vpt

using namespace vpt;

extern "C" {

// One bf16 product through gemm(), for tests of the bodies: A [M, K] bf16
// (row stride lda, a multiple of 8, 16-byte aligned), W [K, N] bf16; bias
// [N] bf16 or null; act 0 none, 1 erf GELU, 2 tanh GELU; residual [M, N]
// (row stride ldr) bf16 or f32 (res_f32), or null; out [M, N] (row stride
// ldc) bf16 or f32 (out_f32). gamma [N] bf16 or null: LayerScale's gain
// before the residual; gate: SwiGLU's (u1, u2) column pairs into out [M,
// N / 2] bf16 (no activation, residual or gamma).
int vpt_gemm_bf16(const void* A, long lda, const void* W, int M, int N, int K, const void* bias,
                  int act, const void* res, long ldr, int res_f32, void* out, long ldc, int out_f32,
                  const void* gamma, int gate, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 8 || lda % 8 || lda < K || !aligned16(A) || act < 0 ||
      act > 2 || ldc < (gate ? N / 2 : N) || (res && ldr < N))
    return cudaErrorInvalidValue;
  Epilogue e = scaled(epi(bias, act, res, ldr, res_f32 != 0, out, ldc, out_f32 != 0), gamma);
  return gemm(static_cast<const bf16*>(A), lda, static_cast<const bf16*>(W), M, N, K,
              gate ? gated(e) : e, static_cast<cudaStream_t>(stream));
}

// One f32 product through gemm(), for tests of the split body: A [M, K] f32
// (row stride lda >= K, any alignment), W [K, N] f32 with N a multiple of 8;
// bias [N] f32 or null; act as vpt_gemm_bf16's; residual [M, N] (row stride
// ldr) f32 or null; out [M, N] (row stride ldc) f32; wplanes: a workspace of
// 3 K N bf16, 16-byte aligned, for W's planes.
int vpt_gemm_f32(const void* A, long lda, const void* W, int M, int N, int K, const void* bias,
                 int act, const void* res, long ldr, void* out, long ldc, void* wplanes,
                 void* stream) {
  if (M < 1 || N < 1 || K < 1 || lda < K || act < 0 || act > 2 || ldc < N || (res && ldr < N))
    return cudaErrorInvalidValue;
  return gemm(static_cast<const float*>(A), lda, static_cast<const float*>(W), M, N, K,
              epi(bias, act, res, ldr, true, out, ldc, true), static_cast<cudaStream_t>(stream),
              static_cast<bf16*>(wplanes));
}

// since the last reset: launches of the bf16 wgmma body, the bf16 WMMA body
// and the f32 split body, then the output tiles the wgmma body walked and
// the blocks it launched, and of those tiles the ones through the gated
// (SwiGLU) epilogue and through LayerScale's (seven counts)
void vpt_gemm_body_counts(long long* out) {
  for (int b = 0; b < kCounts; ++b) out[b] = g_body_launches[b].load();
}

void vpt_gemm_body_reset() {
  for (int b = 0; b < kCounts; ++b) g_body_launches[b] = 0;
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
