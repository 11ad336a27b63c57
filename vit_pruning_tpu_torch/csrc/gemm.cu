// The GEMMs of the layer kernels B1, B3 and B5 and of B2 in f32 (sm_90a): common.cuh's
// gemm(), out[M, N] = epilogue(A[M, K] (row stride lda) @ W[K, N]), W dense
// [K, N] row-major as the param tree stores it. Epilogue, in the TPU
// kernels' order: + bias[n] (T), activation, + residual (T or f32), cast
// (common.cuh).
//
// bf16 takes one of two bodies, chosen by shape alone (wgmma_takes):
//   - wgmma.cuh's wgmma + TMA body wherever TMA can describe A and W
//     (16-byte aligned, lda, N and K multiples of 8): every product of the
//     layers at every geometry the kernels take;
//   - the WMMA (mma.sync) body below otherwise: no product of the serving
//     paths since B2's bf16 launches (cls_logits.cu) replaced its products
//     and pad the classifier to a multiple of 8 labels; a direct gemm_bf16
//     call with N % 8 != 0.
//
// f32 takes the split body below (N a multiple of 8, as every product of the
// layers): the product on wgmma as six bf16 passes over exact three-way
// splits of both operands, accumulated in f32 (full f32 accuracy, no TF32).
//
// Each launch is counted per body (vpt_gemm_body_counts) and the shapes
// that took the WMMA body are kept (vpt_gemm_wmma_shapes), so a run can
// show which products took which body.

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

// the wgmma bodies' epilogue: common.cuh's, 8 outputs at a time, bias and
// residual in T (or f32)
template <typename T>
struct LayerEpi {
  Epilogue e;
  __device__ __forceinline__ void operator()(int m, int n, float* v, int M, int N) const {
    if (m >= M || n >= N) return;
    if (e.vec && n + 8 <= N) {
      epilogue_store8<T>(e, m, n, v);
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (n + t < N) epilogue_store<T>(e, m, n + t, v[t]);
    }
  }
};

// ---------------------------------------------------------------------------
// f32: the split body. It replaces the FMA tiles (common.cuh's
// gemm_f32_tile) under every f32 product of B1, B3, B5 and B2, the float32
// route of vit_pruning_tpu/ops/pallas/layer.py::fused_vit_layer and
// model.py::fused_vit_encoder (their jnp.dot on f32 operands with
// preferred_element_type f32).
//
// Each f32 value of A and of W is split as hi + mid + lo, three bf16 values
// whose sum is the value exactly (wgmma.cuh's split_bf16x3: finite values
// from ~2^-110 to bf16's largest, ~3.39e38). A 32-deep k-step runs six bf16
// wgmma passes over the planes, lo.hi, hi.lo, mid.mid, mid.hi, hi.mid and
// hi.hi (the small terms first). Each bf16 x bf16 product is exact in f32;
// the three terms left out (mid.lo, lo.mid, lo.lo) are below 2^-26 of |a w|
// together, under f32's own rounding of each product (2^-24). The tensor
// cores add each k16 product into the accumulator truncated to its exponent,
// so one accumulator over all of K drifted with K (at K 3072, 1e-4 from a
// float64 product at outputs ~5, 40x cuBLAS f32's error): each step's six
// passes start from zero and are added to a running sum in f32 registers.
// An infinite operand value gives NaN in its output row or column where the
// plain f32 product gives +-inf (inf times a zero part of the other
// operand); NaN stays NaN.
//
// What bounds it on an H100: six bf16 passes at 989 TFLOP/s are 164.8
// TFLOP/s of f32 work, 2.5x the CUDA cores' 67 TFLOP/s, and the layers' f32
// products at the CLI's ViT-B batch 16 or the train steps' DeiT-S batch 32
// sit above that ridge. What held a first version (both operands split by
// eight producer warps, two 64-deep stages) to a third of it was the
// producer: splitting and storing 16,384 values a step took as long without
// any wgmma as with them (kernel_variants.py f32). So:
//   - W is split once per product into three bf16 planes in device memory
//     (split_planes_kernel, into the caller's workspace: 6 bytes a weight,
//     W being read once where every row tile of A would split it again),
//     and TMA brings each step's six W boxes [32 k][64 n] into the ring;
//   - producer: eight warps read the f32 A tile [128 rows x 32 k] straight
//     from device memory (16-byte loads where the rows allow, zeros past M
//     and K), the next step's loads in flight while they split this step's
//     values in registers and store the three planes K-major with the
//     64-byte swizzle, then arrive on the stage's "full" barrier;
//   - consumers: two warpgroups, 64 rows each, run the six passes of
//     m64n128k16 (12 wgmma a step) on the stage that has arrived, hand it
//     back ("empty") and add the step's sum into the running one;
//   - epilogue: wgmma.cuh's transpose, then LayerEpi<float>.
// A stage is 48 KB (six planes of 8 KB), so four stages and one block an SM
// (193 KB with the barriers); four 32-deep stages ran the products 5-20%
// faster than two 64-deep ones. The producers give registers to the
// consumers (setmaxnreg 96 / 160: 64 accumulators and 64 running sums a
// thread). Any M, K and lda; N a multiple of 8 (TMA's row stride of the
// planes).
namespace f3 {
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4;
constexpr int PLANE_A = BM * BK * 2;  // one bf16 plane of the A tile: 128 rows of 64 bytes
constexpr int PLANE_W = BK * BN * 2;  // one of the W tile: two boxes [32 k][64 n]
constexpr int W_BOX = BK * 64 * 2;
constexpr int STAGE_BYTES = 3 * (PLANE_A + PLANE_W);
constexpr int CONSUMERS = 256, PRODUCERS = 256;  // two warpgroups; eight producer warps
constexpr size_t SMEM = 1024 + size_t(STAGES) * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
static_assert(SMEM <= 232448, "one block an SM");
}  // namespace f3

// W [n values] f32 -> its hi, mid and lo bf16 planes at planes, planes + n,
// planes + 2 n: four values a thread (16-byte loads where W allows)
__global__ void split_planes_kernel(const float* __restrict__ W, long n, int wide,
                                    bf16* __restrict__ planes) {
  const long i = 4 * (blockIdx.x * (long)blockDim.x + threadIdx.x);
  if (i >= n) return;
  float v[4];
  if (wide && i + 4 <= n) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(W + i));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = i + t < n ? __ldg(W + i + t) : 0.f;
  }
  float pl[3][4];
#pragma unroll
  for (int t = 0; t < 4; ++t) split_bf16x3(v[t], pl[0][t], pl[1][t], pl[2][t]);
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    bf16* dst = planes + p * n + i;
    if (wide && i + 4 <= n) {
      uint2 u;
      u.x = pack_bf16x2(pl[p][0], pl[p][1]);
      u.y = pack_bf16x2(pl[p][2], pl[p][3]);
      *reinterpret_cast<uint2*>(dst) = u;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (i + t < n) dst[t] = __float2bfloat16_rn(pl[p][t]);
    }
  }
}

// 8 values of a f32 row from column c on, zeros past `cols`; wide: two
// 16-byte loads (16-byte aligned rows and c a multiple of 8)
__device__ __forceinline__ void load8_f32(const float* row, int c, int cols, bool wide,
                                          float (&v)[8]) {
  if (wide && c + 8 <= cols) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + c));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row + c + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = c + t < cols ? __ldg(row + c + t) : 0.f;
}

// 8 f32 values split into their hi, mid and lo bf16 planes: 16 bytes at dst
// in each of the three planes, `plane` bytes apart
__device__ __forceinline__ void store_split8(unsigned char* dst, int plane, const float (&v)[8]) {
  uint4 u[3];
  uint32_t* hi = reinterpret_cast<uint32_t*>(&u[0]);
  uint32_t* mid = reinterpret_cast<uint32_t*>(&u[1]);
  uint32_t* lo = reinterpret_cast<uint32_t*>(&u[2]);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float h0, m0, l0, h1, m1, l1;
    split_bf16x3(v[2 * t], h0, m0, l0);
    split_bf16x3(v[2 * t + 1], h1, m1, l1);
    hi[t] = pack_bf16x2(h0, h1);
    mid[t] = pack_bf16x2(m0, m1);
    lo[t] = pack_bf16x2(l0, l1);
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) *reinterpret_cast<uint4*>(dst + p * plane) = u[p];
}

// The A rows a producer thread pt takes: pt / 4 + 64 i (i < 2), chunk pt % 4
// of the step's 32 k. A plane holds 64-byte rows with the 64-byte swizzle
// (16-byte chunk c of row r at c ^ ((r / 2) % 4)), K-major, as wgmma reads
// it (gmma_desc64).
struct SplitA {
  const float* A;
  long lda;
  int M, K, wide;
  __device__ __forceinline__ void load(float (&a)[2][8], int pt, int m0, int k0) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + (pt >> 2) + 64 * i;
      if (m < M) {
        load8_f32(A + m * lda, k0 + (pt & 3) * 8, K, wide, a[i]);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) a[i][t] = 0.f;
      }
    }
  }
  __device__ __forceinline__ void store(unsigned char* st, const float (&a)[2][8], int pt) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (pt >> 2) + 64 * i;
      store_split8(st + row * 64 + (((pt & 3) ^ ((row >> 1) & 3)) << 4), f3::PLANE_A, a[i]);
    }
  }
};

// wgmma's shared-memory descriptor for a K-major operand with 64-byte rows
// and the 64-byte swizzle: SBO = 512 (the next 8 rows)
__device__ __forceinline__ uint64_t gmma_desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

template <typename Epi>
__global__ void __launch_bounds__(f3::CONSUMERS + f3::PRODUCERS, 1)
gemm_split6_kernel(const __grid_constant__ CUtensorMap tmW, const SplitA sa, int N,
                   const Epi epi) {
  using namespace f3;
  extern __shared__ unsigned char fsm[];
  const uint32_t raw = smem_u32(fsm);
  unsigned char* ring = fsm + (((raw + 1023) & ~1023u) - raw);  // 128-byte swizzle: 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (sa.K + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1 + PRODUCERS);  // + the TMA's expected bytes
      mbar_init(smem_u32(empty + s), CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // --- producer ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n" ::: "memory");
    const int pt = tid - CONSUMERS;
    // step kt into stage kt % STAGES: W's planes by TMA, A split from `a`
    auto produce = [&](int kt, const float (&a)[2][8]) {
      const int s = kt % STAGES;
      if (kt >= STAGES) mbar_wait(smem_u32(empty + s), ((kt / STAGES) - 1) & 1);
      unsigned char* st = ring + s * STAGE_BYTES;
      const uint32_t fb = smem_u32(full + s);
      if (pt == 0) {
        mbar_arrive_expect(fb, 3 * PLANE_W);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int b = 0; b < 2; ++b)
            tma_load_3d(smem_u32(st + 3 * PLANE_A + p * PLANE_W + b * W_BOX), &tmW, fb,
                        n0 + 64 * b, kt * BK, p);
      }
      sa.store(st, a, pt);
      // the generic-proxy stores become visible to wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(fb);
    };
    float a0[2][8], a1[2][8];  // two steps of A: the next one's loads in flight
    sa.load(a0, pt, m0, 0);
    for (int kt = 0; kt < nk; kt += 2) {
      if (kt + 1 < nk) sa.load(a1, pt, m0, (kt + 1) * BK);
      produce(kt, a0);
      if (kt + 1 < nk) {
        if (kt + 2 < nk) sa.load(a0, pt, m0, (kt + 2) * BK);
        produce(kt + 1, a1);
      }
    }
    return;
  }

  // --- consumers: warpgroup wg takes rows wg * 64 .. + 63 of the tile ---
  asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
  // the six passes of a k-step, (A plane, W plane) with 0 hi, 1 mid, 2 lo
  constexpr int kPasses[][2] = {{2, 0}, {0, 2}, {1, 1}, {1, 0}, {0, 1}, {0, 0}};
  constexpr int kNumPasses = sizeof(kPasses) / sizeof(kPasses[0]);
  const int wg = tid >> 7, lane = tid & 31;
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    mbar_wait(smem_u32(full + s), (kt / STAGES) & 1);
    const uint32_t base = smem_u32(ring + s * STAGE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < kNumPasses; ++p) {
      const uint32_t a0 = base + kPasses[p][0] * PLANE_A + wg * (64 * 64);
      const uint32_t b0 = base + 3 * PLANE_A + kPasses[p][1] * PLANE_W;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 16 k: 32 bytes along A's rows, 16 rows (2 KB) of W
        wgmma_m64n128k16(acc, gmma_desc64(a0 + kk * 32), gmma_desc(b0 + kk * 2048, W_BOX, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(smem_u32(empty + s));
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
  }
  wgmma_tile_epilogue(sum, m0 + wg * 64, n0, epi, sa.M, N);
}

// launches per body (0 bf16 wgmma, 1 bf16 WMMA, 2 f32 split) and the
// distinct shapes that took the WMMA body
constexpr int kBodies = 3;
std::atomic<long long> g_body_launches[kBodies];
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
  if (wgmma_takes(A, lda, W, N, K)) {
    CUtensorMap ta, tw;
    VPT_TRY(tma_map_a(&ta, A, lda, M, K));
    VPT_TRY(tma_map_w(&tw, W, N, K));
    VPT_TRY(wgmma_gemm(ta, tw, TmaA{}, LayerEpi<bf16>{e}, M, N, K, st));
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
                 const Epilogue& e0, cudaStream_t st, bf16* wplanes) {
  if (!wplanes || N % 8 || !aligned16(wplanes)) return cudaErrorInvalidValue;
  const long n = static_cast<long>(K) * N;
  split_planes_kernel<<<(n / 4 + 255) / 256 + 1, 256, 0, st>>>(W, n, aligned16(W), wplanes);
  VPT_TRY(cudaGetLastError());
  CUtensorMap tw;
  VPT_TRY(tma_map_3d_64(&tw, wplanes, N, K, 3, f3::BK));
  Epilogue e = e0;
  set_vec<float>(e);
  auto kernel = gemm_split6_kernel<LayerEpi<float>>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)f3::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + f3::BN - 1) / f3::BN, (M + f3::BM - 1) / f3::BM);
  kernel<<<grid, f3::CONSUMERS + f3::PRODUCERS, f3::SMEM, st>>>(
      tw, SplitA{A, lda, M, K, lda % 4 == 0 && aligned16(A)}, N, LayerEpi<float>{e});
  VPT_TRY(cudaGetLastError());
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

// launches of the bf16 wgmma body, the bf16 WMMA body and the f32 split body
// since the last reset
void vpt_gemm_body_counts(long long* out) {
  for (int b = 0; b < kBodies; ++b) out[b] = g_body_launches[b].load();
}

void vpt_gemm_body_reset() {
  for (int b = 0; b < kBodies; ++b) g_body_launches[b] = 0;
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
