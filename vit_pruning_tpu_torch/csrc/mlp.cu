// Kernel B7: the transformer MLP, erf-GELU(x W1 + b1) W2 + b2, all in f32
// (sm_90a).
//
//   vpt_mlp_forward  replaces vit_pruning_tpu/ops/pallas/mlp.py::fused_mlp
//
// x [T, D], W1 [D, M] and W2 [M, D] are read in their dtype (f32 or bf16);
// both products, the bias adds and the GELU run in f32, the second product
// takes the unrounded f32 GELU output, and the output is cast once to x's
// dtype. The [T, M] hidden activation never reaches device memory. Two
// bodies, chosen by dtype and shape (mlp_tc_takes), each launch counted per
// body (vpt_mlp_body_counts):
//
// The tensor-core body (bf16 operands; D and M multiples of 8, x, W1, W2
// 16-byte aligned: every configuration of the repo). What bounds it on an
// H100: at DeiT-S width the MLP does 4 D M FLOP a row against 4 D bytes of
// it, far above the ridge, so tensor-core issue. The first product's
// operands are bf16, so bf16 wgmma with f32 accumulation computes it
// exactly. The second product's A is the unrounded f32 GELU output h;
// wgmma.cuh's split_bf16x3 writes h = hi + mid + lo exactly, and three bf16
// passes (lo, mid, hi, into one f32 accumulator) compute h W2 in f32 up to
// the order of the sums: 3x the bf16 work, ~5x the CUDA cores' FP32 rate.
// What bounds it in practice is the GELU and the split, f32 work on the CUDA
// cores for every element of h (kernel_variants.py times the body with
// each stage taken out; the GELU is the largest), so the design is
// warp-specialised around them:
//   - A block owns 64 rows and a column block of up to 6 x 64 output
//     columns (DeiT-S's D 384 in one, so every element of h is computed
//     once; ViT-H's D 1280 in four).
//   - Producer: one thread streams, through a ring of 16 KB stages, an x
//     box [64 rows x 64 k] and a W1 box [64 k x 64 m] per k-step of each
//     64-wide chunk of the hidden dimension; another streams the chunk's W2
//     boxes [64 m x 64 n] of the block's columns through a ring of its own.
//     128-byte swizzle; TMA zero-fills past T, D and M.
//   - The h warpgroup: h chunk [64, 64] = x W1[:, chunk] by wgmma into 32
//     registers; + b1, erf GELU in f32 (zeros past M), split; the three
//     planes go to shared memory in the swizzled K-major A layout (two
//     plane buffers, handed over by mbarriers).
//   - Two output warpgroups: each adds lo, mid and hi times its boxes of
//     W2[chunk, :] into a [64, 64 NB] f32 accumulator in registers (one
//     m64n{64 NB}k16 wgmma per 16 of the chunk and plane); the epilogue adds
//     b2 and stores bf16 pairs, masked at T and D.
//
// The FMA body (f32 operands, the parity route, and any shape the
// tensor-core body does not take): the TPU kernel's M-blocked variant. One
// block owns TM rows; it keeps them in shared memory as f32 with an f32
// accumulator [TM, D], and walks M in blocks of 64: h = GELU(x_tile W1[:,
// blk] + b1[blk]) into shared memory, then acc += h W2[blk, :]. Weight
// tiles of 32 x 64 are staged through shared memory; each thread computes
// TM/16 rows x 4 columns of a 64-column chunk by FMA, with its rows' values
// read as one vector (x and h are kept transposed, k-major). It is held to
// the CUDA cores' FP32 rate (67 TFLOP/s).

#include <atomic>

#include "wgmma.cuh"

namespace vpt {
namespace b7 {
constexpr int THREADS = 256;
constexpr int BMM = 64;  // M block
constexpr int BK = 32, BN = 64;  // staged weight tile
constexpr int kMaxSmem = 232448;

// shared memory, in floats: x^T [D][TM + 4], acc [TM][D], h^T [BMM][TM + 4],
// weight tile [BK][BN]
__host__ __device__ inline size_t smem_bytes(int tm, int d) {
  return sizeof(float) * ((size_t)d * (tm + 4) + (size_t)tm * d + BMM * (tm + 4) + BK * BN);
}
}  // namespace b7

// c[RPT][4] = A[rows of this thread][0, K) . B[0, K)[n0 + 4 tx, + 4), with A
// k-major in shared memory (lda = TM + 4) and B [K, N] row-major in device
// memory (T), staged tile by tile through `bt`. Every thread of the block
// must call it (it synchronises).
template <typename T, int TM>
__device__ __forceinline__ void tile_product(const float* At, const T* __restrict__ B, long ldb,
                                             int K, int n0, int N, float* bt, float (&c)[TM / 16][4]) {
  using namespace b7;
  constexpr int RPT = TM / 16, LDA = TM + 4;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = k0 + i / BN, n = n0 + i % BN;
      bt[i] = (k < K && n < N) ? to_f(B[(long)k * ldb + n]) : 0.f;
    }
    __syncthreads();
    const int kn = min(BK, K - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(bt + kk * BN + tx * 4);
      const float* ar = At + (long)(k0 + kk) * LDA + ty * RPT;
      float a[RPT];
      if constexpr (RPT == 2) {
        const float2 t = *reinterpret_cast<const float2*>(ar);
        a[0] = t.x;
        a[1] = t.y;
      } else {
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = ar[i];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        c[i][0] = fmaf(a[i], bv.x, c[i][0]);
        c[i][1] = fmaf(a[i], bv.y, c[i][1]);
        c[i][2] = fmaf(a[i], bv.z, c[i][2]);
        c[i][3] = fmaf(a[i], bv.w, c[i][3]);
      }
    }
    __syncthreads();
  }
}

template <typename T, int TM>
__global__ void __launch_bounds__(b7::THREADS)
mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
           const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out, int rows, int D,
           int M) {
  using namespace b7;
  constexpr int RPT = TM / 16, LDA = TM + 4;
  extern __shared__ __align__(16) float sm[];
  float* xt = sm;                      // [D][LDA]
  float* acc = xt + (long)D * LDA;     // [TM][D]
  float* ht = acc + (long)TM * D;      // [BMM][LDA]
  float* bt = ht + BMM * LDA;          // [BK][BN]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long r0 = (long)blockIdx.x * TM;

  for (int i = tid; i < TM * D; i += THREADS) {
    const int r = i / D, k = i % D;
    xt[(long)k * LDA + r] = r0 + r < rows ? to_f(x[(r0 + r) * D + k]) : 0.f;
    acc[i] = 0.f;
  }
  __syncthreads();

  for (int m0 = 0; m0 < M; m0 += BMM) {
    float c[RPT][4] = {};
    tile_product<T, TM>(xt, w1, M, D, m0, M, bt, c);  // x_tile . W1[:, m0:m0+64]
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + tx * 4 + j;
        ht[(tx * 4 + j) * LDA + ty * RPT + i] =
            m < M ? gelu(c[i][j] + to_f(b1[m]), ACT_GELU_ERF) : 0.f;
      }
    __syncthreads();
    const int kb = min(BMM, M - m0);
    for (int n0 = 0; n0 < D; n0 += BN) {  // acc += h . W2[m0:m0+64, :]
      float c2[RPT][4] = {};
      tile_product<T, TM>(ht, w2 + (long)m0 * D, D, kb, n0, D, bt, c2);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx * 4 + j;
          if (n < D) acc[(ty * RPT + i) * D + n] += c2[i][j];
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < TM * D; i += THREADS) {
    const int r = i / D, n = i % D;
    if (r0 + r < rows) out[(r0 + r) * D + n] = from_f<T>(acc[i] + to_f(b2[n]));
  }
}

// the row tile: 32 rows where the shared memory holds them, else 16
inline int mlp_tile_rows(int D) {
  if (b7::smem_bytes(32, D) <= (size_t)b7::kMaxSmem) return 32;
  if (b7::smem_bytes(16, D) <= (size_t)b7::kMaxSmem) return 16;
  return 0;
}

template <typename T, int TM>
cudaError_t mlp_tm(const T* x, const T* w1, const T* b1, const T* w2, const T* b2, T* out, int rows,
                   int D, int M, cudaStream_t st) {
  const size_t smem = b7::smem_bytes(TM, D);
  VPT_TRY(cudaFuncSetAttribute(mlp_kernel<T, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem));
  mlp_kernel<T, TM><<<(rows + TM - 1) / TM, b7::THREADS, smem, st>>>(x, w1, b1, w2, b2, out, rows,
                                                                     D, M);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mlp(const T* x, const T* w1, const T* b1, const T* w2, const T* b2, T* out, int rows,
                int D, int M, cudaStream_t st) {
  switch (mlp_tile_rows(D)) {
    case 32: return mlp_tm<T, 32>(x, w1, b1, w2, b2, out, rows, D, M, st);
    case 16: return mlp_tm<T, 16>(x, w1, b1, w2, b2, out, rows, D, M, st);
    default: return cudaErrorInvalidValue;
  }
}


// --- the tensor-core body (bf16) ----------------------------------------------

namespace b7tc {
constexpr int BOX = 64 * 128;  // one TMA box: 64 rows of 128 bytes (64 bf16)
constexpr int SA = 4;          // stages of the h ring: an x box and a W1 box each
constexpr int SB = 2;          // stages of the output ring: a chunk's W2 boxes each
__host__ __device__ constexpr int kd(int D) { return (D + 63) / 64; }
// 64-column boxes per output warpgroup: at most 3 (a [64, 192] f32
// accumulator, 96 registers a thread), as few column blocks as that allows
inline int boxes(int D) {
  const int ncb = (kd(D) + 5) / 6;
  return (kd(D) + 2 * ncb - 1) / (2 * ncb);
}
// the rings and the planes at a 1024-byte boundary, then 16 barriers
template <int NB>
constexpr size_t smem_bytes() {
  return 1024 + size_t(2 * SA + 6 + 2 * NB * SB) * BOX + 16 * sizeof(uint64_t);
}
template <int NB>
__device__ __forceinline__ void wgmma_out(float (&d)[NB * 32], uint64_t da, uint64_t db) {
  if constexpr (NB == 1) wgmma_m64n64k16<1>(d, da, db);
  else if constexpr (NB == 2) wgmma_m64n128k16(d, da, db);
  else wgmma_m64n192k16(d, da, db);
}
}  // namespace b7tc

// A block: 64 rows, a column block of 2 NB boxes, four warpgroups. The
// producer's thread 0 fills the h ring, thread 32 the output ring. The h
// warpgroup computes each 64-wide chunk of h = x W1[:, chunk] (wgmma, x and
// W1 streamed together) in 32 registers, adds b1, applies the erf GELU,
// splits, and stores the three planes into one of two plane buffers in the
// swizzled K-major A layout. Each output warpgroup adds lo, mid and hi times
// its NB boxes of W2[chunk, :] into its accumulators (one m64n{64 NB}k16
// wgmma per 16 of the chunk and plane, A from the planes). The producer
// gives up registers for the others (setmaxnreg: 40, 152, 160, 160).
template <int NB>
__global__ void __launch_bounds__(512, 1)
mlp_tc_kernel(const __grid_constant__ CUtensorMap tmX, const __grid_constant__ CUtensorMap tmW1,
              const __grid_constant__ CUtensorMap tmW2, const bf16* __restrict__ b1,
              const bf16* __restrict__ b2, bf16* __restrict__ out, int T, int D, int M) {
  using namespace b7tc;
  extern __shared__ unsigned char msm[];
  const uint32_t raw = smem_u32(msm);
  unsigned char* ring_h = msm + (((raw + 1023) & ~1023u) - raw);  // [SA][x box, W1 box]
  unsigned char* planes = ring_h + 2 * SA * BOX;                 // [2][hi, mid, lo]
  unsigned char* ring_o = planes + 6 * BOX;                      // [SB][2 NB W2 boxes]
  uint64_t* full_h = reinterpret_cast<uint64_t*>(ring_o + 2 * NB * SB * BOX);
  uint64_t* empty_h = full_h + SA;
  uint64_t* full_o = empty_h + SA;
  uint64_t* empty_o = full_o + SB;
  uint64_t* planes_full = empty_o + SB;
  uint64_t* planes_empty = planes_full + 2;
  const int KD = kd(D), nch = (M + 63) / 64;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, q = lane & 3;
  const int r0 = blockIdx.x * 64, n0 = blockIdx.y * 2 * NB * 64;

  if (tid == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(smem_u32(full_h + s), 1);
      mbar_init(smem_u32(empty_h + s), 4);  // the h warpgroup's warps
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(smem_u32(full_o + s), 1);
      mbar_init(smem_u32(empty_o + s), 8);  // the output warpgroups' warps
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_u32(planes_full + b), 128);  // every thread of the h warpgroup
      mbar_init(smem_u32(planes_empty + b), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // --- producer ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int g = 0;
      for (int ch = 0; ch < nch; ++ch)
        for (int kb = 0; kb < KD; ++kb, ++g) {
          const int s = g % SA;
          if (g >= SA) mbar_wait(smem_u32(empty_h + s), ((g / SA) - 1) & 1);
          const uint32_t fb = smem_u32(full_h + s), dst = smem_u32(ring_h + 2 * s * BOX);
          mbar_arrive_expect(fb, 2 * BOX);
          tma_load_2d(dst, &tmX, fb, kb * 64, r0);                // x [T, D]
          tma_load_2d(dst + BOX, &tmW1, fb, ch * 64, kb * 64);    // W1 [D, M]
        }
    } else if (tid == 32) {
      for (int ch = 0; ch < nch; ++ch) {
        const int s = ch % SB;
        if (ch >= SB) mbar_wait(smem_u32(empty_o + s), ((ch / SB) - 1) & 1);
        const uint32_t fb = smem_u32(full_o + s), dst = smem_u32(ring_o + 2 * NB * s * BOX);
        mbar_arrive_expect(fb, 2 * NB * BOX);
        for (int j = 0; j < 2 * NB; ++j)  // W2 [M, D]: the chunk's rows, the block's columns
          tma_load_2d(dst + j * BOX, &tmW2, fb, n0 + j * 64, ch * 64);
      }
    }
    return;
  }

  if (wg == 1) {  // --- h: x W1, GELU, split ---
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n" ::: "memory");
    const int row = warp * 16 + (lane >> 2);
    int g = 0;
    for (int ch = 0; ch < nch; ++ch) {
      float h[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) h[i] = 0.f;
      for (int kb = 0; kb < KD; ++kb, ++g) {
        const int s = g % SA;
        mbar_wait(smem_u32(full_h + s), (g / SA) & 1);
        const uint32_t xa = smem_u32(ring_h + 2 * s * BOX), wa = xa + BOX;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 16 k: 32 bytes along x's rows, 16 rows (2 KB) of W1
          wgmma_m64n64k16<1>(h, gmma_desc(xa + kk * 32, 16, 1024),
                             gmma_desc(wa + kk * 2048, BOX, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(smem_u32(empty_h + s));
      }
      const int buf = ch & 1;
      if (ch >= 2) mbar_wait(smem_u32(planes_empty + buf), ((ch >> 1) - 1) & 1);
      unsigned char* pb = planes + buf * 3 * BOX;
#pragma unroll
      for (int p = 0; p < 16; ++p) {  // accumulators 2p, 2p + 1: one row, two columns
        const int r = row + 8 * (p & 1), c = (p >> 1) * 8 + 2 * q, m = ch * 64 + c;
        float v[2], hi[2], mid[2], lo[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {  // M is even: m + 1 < M with m
          v[t] = m < M ? gelu(h[2 * p + t] + __bfloat162float(b1[m + t]), ACT_GELU_ERF) : 0.f;
          split_bf16x3(v[t], hi[t], mid[t], lo[t]);
        }
        const int off = r * 128 + (((c >> 3) ^ (r & 7)) << 4) + 4 * q;  // 128-byte swizzle
        *reinterpret_cast<uint32_t*>(pb + off) = pack_bf16x2(hi[0], hi[1]);
        *reinterpret_cast<uint32_t*>(pb + BOX + off) = pack_bf16x2(mid[0], mid[1]);
        *reinterpret_cast<uint32_t*>(pb + 2 * BOX + off) = pack_bf16x2(lo[0], lo[1]);
      }
      // the generic-proxy stores become visible to wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(smem_u32(planes_full + buf));
    }
    return;
  }

  // --- output warpgroup wo: columns n0 + wo * NB * 64 .. ---
  asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
  const int wo = wg - 2;
  float acc[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) acc[i] = 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1, s = ch % SB;
    mbar_wait(smem_u32(planes_full + buf), (ch >> 1) & 1);
    mbar_wait(smem_u32(full_o + s), (ch / SB) & 1);
    const uint32_t pa = smem_u32(planes + buf * 3 * BOX);
    const uint32_t wb = smem_u32(ring_o + (2 * NB * s + NB * wo) * BOX);
    wgmma_fence();
#pragma unroll
    for (int pl = 2; pl >= 0; --pl)  // lo, mid, hi
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_out<NB>(acc, gmma_desc(pa + pl * BOX + ks * 32, 16, 1024),
                      gmma_desc(wb + ks * 2048, BOX, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) {
      mbar_arrive(smem_u32(planes_empty + buf));
      mbar_arrive(smem_u32(empty_o + s));
    }
  }

  const int row = r0 + warp * 16 + (lane >> 2), nw = n0 + wo * NB * 64;
#pragma unroll
  for (int p = 0; p < NB * 16; ++p) {  // accumulators 2p, 2p + 1: one row, two columns
    const int r = row + 8 * (p & 1), n = nw + (p >> 1) * 8 + 2 * q;
    if (r < T && n < D) {  // D is even: n + 1 < D too
      const float v0 = acc[2 * p] + __bfloat162float(b2[n]);
      const float v1 = acc[2 * p + 1] + __bfloat162float(b2[n + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out + (long)r * D + n) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// TMA can describe x, W1 and W2, and out takes 4-byte stores
inline bool mlp_tc_takes(const bf16* x, const bf16* w1, const bf16* w2, const bf16* out, int D,
                         int M) {
  return D % 8 == 0 && M % 8 == 0 && aligned16(x) && aligned16(w1) && aligned16(w2) &&
         (reinterpret_cast<uintptr_t>(out) & 3) == 0;
}

template <int NB>
cudaError_t mlp_tc_launch(const CUtensorMap& tx, const CUtensorMap& t1, const CUtensorMap& t2,
                          const bf16* b1, const bf16* b2, bf16* out, int T, int D, int M,
                          cudaStream_t st) {
  auto kernel = mlp_tc_kernel<NB>;
  constexpr size_t smem = b7tc::smem_bytes<NB>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((T + 63) / 64, (b7tc::kd(D) + 2 * NB - 1) / (2 * NB));
  kernel<<<grid, 512, smem, st>>>(tx, t1, t2, b1, b2, out, T, D, M);
  return cudaGetLastError();
}

cudaError_t mlp_tc(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
                   bf16* out, int T, int D, int M, cudaStream_t st) {
  CUtensorMap tx, t1, t2;  // 64 x 64 boxes of x [T, D], W1 [D, M], W2 [M, D]
  VPT_TRY(tma_map_2d(&tx, x, D, T, (uint64_t)D * 2, 64, 64));
  VPT_TRY(tma_map_2d(&t1, w1, M, D, (uint64_t)M * 2, 64, 64));
  VPT_TRY(tma_map_2d(&t2, w2, D, M, (uint64_t)D * 2, 64, 64));
  switch (b7tc::boxes(D)) {
    case 1: return mlp_tc_launch<1>(tx, t1, t2, b1, b2, out, T, D, M, st);
    case 2: return mlp_tc_launch<2>(tx, t1, t2, b1, b2, out, T, D, M, st);
    case 3: return mlp_tc_launch<3>(tx, t1, t2, b1, b2, out, T, D, M, st);
    default: return cudaErrorInvalidValue;
  }
}

std::atomic<long long> g_mlp_body_launches[2];  // tensor-core body, FMA body
}  // namespace vpt

using namespace vpt;

extern "C" {

// the widest hidden size D whose FMA row tile fits in shared memory (1,520;
// the tensor-core body streams x and takes any D)
int vpt_mlp_max_hidden() {
  int d = 8;
  while (mlp_tile_rows(d + 8)) d += 8;
  return d;
}

// dtype: 0 = float32, 1 = bfloat16. x [T, D], w1 [D, M], b1 [M], w2 [M, D],
// b2 [D], out [T, D], all contiguous in the dtype.
int vpt_mlp_forward(int dtype, const void* x, const void* w1, const void* b1, const void* w2,
                    const void* b2, void* out, int T, int D, int M, void* stream) {
  if ((dtype != 0 && dtype != 1) || T < 1 || D < 1 || M < 1 || !mlp_tile_rows(D))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16 *xb = (const bf16*)x, *w1b = (const bf16*)w1, *w2b = (const bf16*)w2;
  cudaError_t rc;
  if (dtype == 1 && mlp_tc_takes(xb, w1b, w2b, (const bf16*)out, D, M)) {
    rc = mlp_tc(xb, w1b, (const bf16*)b1, w2b, (const bf16*)b2, (bf16*)out, T, D, M, st);
    if (rc == cudaSuccess) g_mlp_body_launches[0]++;
    return rc;
  }
  if (dtype == 0)
    rc = mlp<float>((const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
                    (const float*)b2, (float*)out, T, D, M, st);
  else
    rc = mlp<bf16>(xb, w1b, (const bf16*)b1, w2b, (const bf16*)b2, (bf16*)out, T, D, M, st);
  if (rc == cudaSuccess) g_mlp_body_launches[1]++;
  return rc;
}

// launches of the tensor-core body and of the FMA body since the last reset
void vpt_mlp_body_counts(long long* out) {
  out[0] = g_mlp_body_launches[0].load();
  out[1] = g_mlp_body_launches[1].load();
}

void vpt_mlp_body_reset() {
  g_mlp_body_launches[0] = 0;
  g_mlp_body_launches[1] = 0;
}

}  // extern "C"
