// Kernel B7: the transformer MLP, erf-GELU(x W1 + b1) W2 + b2, all in f32
// (sm_90a).
//
//   vpt_mlp_forward  replaces vit_pruning_tpu/ops/pallas/mlp.py::fused_mlp
//
// x [T, D], W1 [D, M] and W2 [M, D] are read in their dtype (f32 or bf16)
// and upcast; both products, the bias adds and the GELU run in f32, the
// second product takes the unrounded f32 GELU output, and the output is cast
// once to x's dtype. The [T, M] hidden activation never reaches device
// memory. This is the TPU kernel's M-blocked variant (its resident variant
// is VMEM sizing): one block owns TM rows; it keeps them in shared memory as
// f32 with an f32 accumulator [TM, D], and walks M in blocks of 64:
// h = GELU(x_tile W1[:, blk] + b1[blk]) into shared memory, then
// acc += h W2[blk, :]. Weight tiles of 32 x 64 are staged through shared
// memory; each thread computes TM/16 rows x 4 columns of a 64-column chunk
// by FMA, with its rows' values read as one vector (x and h are kept
// transposed, k-major).
//
// What bounds it on an H100: the contract is f32 arithmetic. The first
// product's inputs are exact in bf16 when x and W1 are bf16, so bf16 tensor
// cores with f32 accumulation compute it exactly; the second takes the
// unrounded f32 GELU output, so neither bf16 nor TF32 tensor cores compute
// it, and it is held to the CUDA cores' FP32 rate (67 TFLOP/s). At DeiT-S
// width the MLP does 4 D M FLOP a row against 4 D bytes of it (bf16): far
// above either ridge. The weights are re-read
// from L2 by every block (T / TM blocks); a 3xTF32 split, register-resident
// accumulators and larger row tiles are later work.

#include "common.cuh"

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

}  // namespace vpt

using namespace vpt;

extern "C" {

// the widest hidden size D whose row tile fits in shared memory
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
  if (dtype == 0)
    return mlp<float>((const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
                      (const float*)b2, (float*)out, T, D, M, st);
  return mlp<bf16>((const bf16*)x, (const bf16*)w1, (const bf16*)b1, (const bf16*)w2,
                   (const bf16*)b2, (bf16*)out, T, D, M, st);
}

}  // extern "C"
