// The f32 split body (sm_90a): out[M, N] = epilogue(A[M, K] @ W[K, N]) in
// full f32 accuracy on the tensor cores, for every f32 product of the port:
// gemm.cu's gemm() (B1, B3, B5 and B2 in float32: the float32 route of
// vit_pruning_tpu/ops/pallas/layer.py::fused_vit_layer and
// model.py::fused_vit_encoder, their jnp.dot on f32 operands with
// preferred_element_type f32), mlp.cu's float32 route of B7 (its two
// products) and embed.cu's B8a / B8b with f32 weights (the product, its A
// source applying the affine). It replaced the FMA tiles on the CUDA cores
// under all of them. The caller gives the A source (how a producer thread
// reads and splits its share of the A tile) and the epilogue.
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
//     W being read once where every row tile of A would split it again; the
//     planes' rows padded with zeros to a multiple of 8 values, TMA's row
//     stride), and TMA brings each step's six W boxes [32 k][64 n] into the
//     ring;
//   - producer: eight warps read the A tile [128 rows x 32 k] straight from
//     device memory through the A source (SplitA: f32, 16-byte loads where
//     the rows allow; embed.cu's: patches through the affine), zeros past M
//     and K, the next step's loads in flight while they split this step's
//     values in registers and store the three planes K-major with the
//     64-byte swizzle, then arrive on the stage's "full" barrier;
//   - consumers: two warpgroups, 64 rows each, run the six passes of
//     m64n128k16 (12 wgmma a step) on the stage that has arrived, hand it
//     back ("empty") and add the step's sum into the running one;
//   - epilogue: wgmma.cuh's transpose, then the caller's epilogue.
// A stage is 48 KB (six planes of 8 KB), so four stages and one block an SM
// (193 KB with the barriers); four 32-deep stages ran the products 5-20%
// faster than two 64-deep ones. The producers give registers to the
// consumers (setmaxnreg 96 / 160: 64 accumulators and 64 running sums a
// thread). Any M, N, K and lda.
//
// Every unit that includes this file gets its own kernels (split_planes_kernel
// is static, gemm_split6_kernel is instantiated on the unit's own A source or
// epilogue), so a library built from sources with a stage changed
// (kernel_variants.py) keeps the other units' bodies as they are.

#pragma once

#include "wgmma.cuh"

namespace vpt {

namespace f3 {
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4;
constexpr int PLANE_A = BM * BK * 2;  // one bf16 plane of the A tile: 128 rows of 64 bytes
constexpr int PLANE_W = BK * BN * 2;  // one of the W tile: two boxes [32 k][64 n]
constexpr int W_BOX = BK * 64 * 2;
constexpr int STAGE_BYTES = 3 * (PLANE_A + PLANE_W);
constexpr int CONSUMERS = 256, PRODUCERS = 256;  // two warpgroups; eight producer warps
constexpr size_t SMEM = 1024 + size_t(STAGES) * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
static_assert(SMEM <= 232448, "one block an SM");
// the planes' row length for W [K, N]: N padded to a multiple of 8
__host__ __device__ constexpr long plane_width(int N) { return (N + 7) / 8 * 8; }
}  // namespace f3

// W [K, N] f32 -> its hi, mid and lo bf16 planes [K, ldp] at planes, planes +
// K ldp, planes + 2 K ldp (ldp = plane_width(N), the padding zeros): four
// values a thread (16-byte loads where W allows: wide, a 16-byte aligned base
// and N % 4 == 0)
static __global__ void split_planes_kernel(const float* __restrict__ W, int K, int N, long ldp,
                                           int wide, bf16* __restrict__ planes) {
  const long n = K * ldp;
  const long i = 4 * (blockIdx.x * (long)blockDim.x + threadIdx.x);
  if (i >= n) return;
  const long k = i / ldp;
  const int c = static_cast<int>(i - k * ldp);  // a multiple of 4, as ldp is
  const float* row = W + k * N;
  float v[4];
  if (wide && c + 4 <= N) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(row + c));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = c + t < N ? __ldg(row + c + t) : 0.f;
  }
  float pl[3][4];
#pragma unroll
  for (int t = 0; t < 4; ++t) split_bf16x3(v[t], pl[0][t], pl[1][t], pl[2][t]);
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    uint2 u;
    u.x = pack_bf16x2(pl[p][0], pl[p][1]);
    u.y = pack_bf16x2(pl[p][2], pl[p][3]);
    *reinterpret_cast<uint2*>(planes + p * n + i) = u;
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

// An A source gives the body M, K and two calls for producer thread pt:
// load(a, pt, m0, k0), the f32 values of its share of step k0's A tile
// (zeros past M and K), and store(st, a, pt), their planes into the stage.
// The share: rows pt / 4 + 64 i (i < 2) of the tile, chunk pt % 4 of the
// step's 32 k. A plane holds 64-byte rows with the 64-byte swizzle (16-byte
// chunk c of row r at c ^ ((r / 2) % 4)), K-major, as wgmma reads it
// (gmma_desc64).
__device__ __forceinline__ void store_split_share(unsigned char* st, const float (&a)[2][8],
                                                  int pt) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (pt >> 2) + 64 * i;
    store_split8(st + row * 64 + (((pt & 3) ^ ((row >> 1) & 3)) << 4), f3::PLANE_A, a[i]);
  }
}

// A in f32, row stride lda: wide where every row may be read 16 bytes at a
// time (lda % 4 == 0, a 16-byte aligned base)
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
    store_split_share(st, a, pt);
  }
};

// wgmma's shared-memory descriptor for a K-major operand with 64-byte rows
// and the 64-byte swizzle: SBO = 512 (the next 8 rows)
__device__ __forceinline__ uint64_t gmma_desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

template <typename ASrc, typename Epi>
__global__ void __launch_bounds__(f3::CONSUMERS + f3::PRODUCERS, 1)
gemm_split6_kernel(const __grid_constant__ CUtensorMap tmW, const ASrc sa, int N,
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

// One product on the split body: W [K, N] f32 (K = sa.K) split into
// `planes` (3 K plane_width(N) bf16, 16-byte aligned, the caller's
// workspace), then the body over the A source's M rows. The grid's second
// dimension is M's row tiles: M at most 65,535 x 128.
template <typename ASrc, typename Epi>
cudaError_t split6_gemm(const ASrc& sa, const float* W, int N, const Epi& epi, bf16* planes,
                        cudaStream_t st) {
  const long ldp = f3::plane_width(N), n = sa.K * ldp;
  if (!planes || !aligned16(planes) || (sa.M + f3::BM - 1) / f3::BM > 65535)
    return cudaErrorInvalidValue;
  const int wide = aligned16(W) && N % 4 == 0;
  split_planes_kernel<<<(n / 4 + 255) / 256 + 1, 256, 0, st>>>(W, sa.K, N, ldp, wide, planes);
  VPT_TRY(cudaGetLastError());
  CUtensorMap tw;
  VPT_TRY(tma_map_3d_64(&tw, planes, ldp, sa.K, 3, f3::BK));
  auto kernel = gemm_split6_kernel<ASrc, Epi>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)f3::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + f3::BN - 1) / f3::BN, (sa.M + f3::BM - 1) / f3::BM);
  kernel<<<grid, f3::CONSUMERS + f3::PRODUCERS, f3::SMEM, st>>>(tw, sa, N, epi);
  return cudaGetLastError();
}

}  // namespace vpt
