// Kernel B4, the int8 serving layer, for Hopper (sm_90a). Two C entry points:
//
//   vpt_vit_layer_int8_forward  replaces vit_pruning_tpu/ops/pallas/layer_int8.py
//                               ::fused_vit_layer_int8: B1's pre-LN block
//                               (layer.cu) with QKV, O, fc1 and fc2 as
//                               int8 x int8 -> int32 products
//   vpt_rowquant                the per-row quantization on its own
//
// What it computes, in the TPU kernel's order: LN1 in f32, its f32 output
// quantized per row (scale = max(amax, 1e-12) * (1/127), x / scale rounded
// half to even, clipped to +-127); the QKV product in int8 with the
// per-column weight scales, dequantized as (acc * row scale) * column scale
// + bias and cast to x's dtype; B1's staged2 attention (layer.cu); ctx
// quantized per row; the O product + bias + residual into the f32 stream
// x1; LN2, quantized; fc1 + bias, GELU (tanh for bf16, erf for f32), cast
// to x's dtype; that quantized per row; fc2 + bias + x1, cast.
//
// What bounds it on an H100: at DeiT-S width and batch 512 the four products
// are ~90% of the operations and run on the int8 tensor cores (1,979 TOP/s
// dense, twice the bf16 rate), attention stays in the serving dtype (989
// TFLOP/s bf16), so the layer is bound by operations; the least time is
// int8 ops / 1979e12 + attention FLOPs / 989e12. The design does what B1
// does about it: one tiled GEMM per product with its dequant, bias, GELU,
// residual and cast fused into the epilogue, and the per-row quantization
// fused where the row is whole in one warp: into the layer norms. ctx (KW
// wide) and the GELU output (MLP wide) span several GEMM column tiles, so
// each has a row-quantization pass of its own (a read in x's dtype and an
// int8 write, a few percent of the layer's bytes).
//
// The simple first version: mma.sync m16n8k32 int8 tiles with int32
// accumulators fed by ldmatrix from a 3-stage cp.async ring, the weights
// transposed to [N, K] by the wrapper; wgmma, TMA and fusing the two row
// passes are later work. The dequant multiplies with __fmul_rn so that no
// FMA contraction moves it off the plain version's rounding.

#include "common.cuh"

namespace vpt {

// 1/127 as the TPU kernel's `(1.0 / 127.0)`: a double constant taken to f32
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ float row_scale(float amax) { return fmaxf(amax, 1e-12f) * kInv127; }

// v / s (true division) rounded half to even, clipped to +-127
__device__ __forceinline__ signed char quantize(float v, float s) {
  return static_cast<signed char>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

// ---------------------------------------------------------------------------
// LayerNorm fused with the row quantization of its f32 output: one warp per
// row; the LN value is formed with _rn intrinsics (no contraction) so that
// the amax pass and the quantizing pass see the same numbers.

template <typename Tin, typename Tg>
__global__ void ln_rowquant_kernel(const Tin* __restrict__ x, long ldx, const Tg* __restrict__ g,
                                   const Tg* __restrict__ b, signed char* __restrict__ q,
                                   float* __restrict__ qs, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const Tin* xr = x + row * ldx;
  float mean, rs;
  ln_stats(xr, d, eps, mean, rs);
  auto ln = [&](int i) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(to_f(xr[i]), mean), rs), to_f(g[i])),
                     to_f(b[i]));
  };
  float amax = 0.f;
  for (int i = lane; i < d; i += 32) amax = fmaxf(amax, fabsf(ln(i)));
  const float s = row_scale(warp_max(amax));
  signed char* qr = q + (long)row * d;
  for (int i = lane; i < d; i += 32) qr[i] = quantize(ln(i), s);
  if (lane == 0) qs[row] = s;
}

// Row quantization of x [rows, k] (T): one warp per row, 8 values a lane
// per step (k % 8 == 0, 16-byte aligned rows: checked by the callers).
template <typename T>
__global__ void rowquant_kernel(const T* __restrict__ x, long ldx, signed char* __restrict__ q,
                                float* __restrict__ qs, int rows, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * ldx;
  float v[8];
  float amax = 0.f;
  for (int c = lane * 8; c < k; c += 256) {
    load8(xr + c, v);
#pragma unroll
    for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(v[t]));
  }
  const float s = row_scale(warp_max(amax));
  signed char* qr = q + (long)row * k;
  for (int c = lane * 8; c < k; c += 256) {
    load8(xr + c, v);
    char4 lo, hi;
    lo.x = quantize(v[0], s), lo.y = quantize(v[1], s), lo.z = quantize(v[2], s);
    lo.w = quantize(v[3], s), hi.x = quantize(v[4], s), hi.y = quantize(v[5], s);
    hi.z = quantize(v[6], s), hi.w = quantize(v[7], s);
    reinterpret_cast<char4*>(qr + c)[0] = lo;
    reinterpret_cast<char4*>(qr + c)[1] = hi;
  }
  if (lane == 0) qs[row] = s;
}

constexpr int kRowWarps = 8;

template <typename Tin, typename Tg>
cudaError_t ln_rowquant(const Tin* x, long ldx, const Tg* g, const Tg* b, signed char* q, float* qs,
                        int rows, int d, float eps, cudaStream_t st) {
  ln_rowquant_kernel<Tin, Tg><<<(rows + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, st>>>(
      x, ldx, g, b, q, qs, rows, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t rowquant(const T* x, long ldx, signed char* q, float* qs, int rows, int k,
                     cudaStream_t st) {
  rowquant_kernel<T><<<(rows + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, st>>>(x, ldx, q, qs,
                                                                                    rows, k);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8 GEMM  out[M, N] = epilogue((A[M, K] @ W[K, N]) * rs[m] * ws[n]),
// A int8 row-major with row stride lda, W given transposed, Wt [N, K]
// row-major (both operands K-contiguous, as mma's row.col form reads them),
// int32 accumulation with mma.sync m16n8k32 (the native int8 shape: twice
// the k of a bf16 m16n8k16 per instruction). 128x128 block tile, 8 warps
// (2 x 4), 64x32 per warp as 4x4 tiles of 16x8; K in steps of 64 through a
// 3-stage cp.async ring; fragments by ldmatrix.x4. Each 64-byte tile row
// keeps its four 16-byte chunks XOR-swizzled by (row / 2) % 4, so the eight
// rows an ldmatrix reads, and the ring's 16-byte writes, fall in distinct
// banks. Needs K % 16 == 0, lda % 16 == 0 and 16-byte aligned A and Wt
// (checked by the callers).
namespace i8 {
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3, THREADS = 256;
constexpr int WM = 64, WN = 32, MT = WM / 16, NT = WN / 8;
constexpr int A_STAGE = BM * BK, B_STAGE = BN * BK;  // bytes
constexpr size_t SMEM = STAGES * (A_STAGE + B_STAGE);
constexpr int LDS = WN + 4;  // epilogue staging row (ints)
static_assert(SMEM >= sizeof(int) * (THREADS / 32) * 16 * LDS, "epilogue tiles reuse the ring");
}  // namespace i8

// byte offset of 16-byte chunk c (0..3) of tile row r
__device__ __forceinline__ int swz(int r, int c) {
  return r * i8::BK + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__global__ void __launch_bounds__(i8::THREADS)
gemm_s8_kernel(const signed char* __restrict__ A, long lda, const float* __restrict__ rs,
               const signed char* __restrict__ Wt, const float* __restrict__ ws, int M, int N,
               int K, Epilogue e) {
  using namespace i8;
  extern __shared__ __align__(128) unsigned char gsmem[];
  unsigned char* As = gsmem;                     // [STAGES][BM][BK], swizzled
  unsigned char* Bs = gsmem + STAGES * A_STAGE;  // [STAGES][BN][BK], swizzled

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
    unsigned char* as = As + stage * A_STAGE;
    unsigned char* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int t = 0; t < 2; ++t) {  // 128 rows x 4 chunks of 16 bytes, each operand
      const int c = tid + t * THREADS;
      const int r = c >> 2, kc = c & 3, k = k0 + kc * 16;
      const int m = m0 + r, n = n0 + r;
      const bool oka = m < M && k < K, okb = n < N && k < K;
      cp_async16(as + swz(r, kc), oka ? A + m * lda + k : A, oka);
      cp_async16(bs + swz(r, kc), okb ? Wt + (long)n * K + k : Wt, okb);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

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
    const unsigned char* as = As + (kt % STAGES) * A_STAGE;
    const unsigned char* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      // A 16x32: matrices (rows 0-7 | 8-15) x (k 0-15 | 16-31) -> a0..a3;
      // B 16(n)x32: matrices (n 0-7, k lo), (n 0-7, k hi), (n 8-15, k lo), (n 8-15, k hi)
      unsigned a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], as + swz(wm * WM + i * 16 + (lane & 15), ks * 2 + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned r[4];
        ldmatrix_x4(r, bs + swz(wn * WN + j * 8 + (lane & 7) + (lane >> 4) * 8,
                                ks * 2 + ((lane >> 3) & 1)));
        b[j][0] = r[0], b[j][1] = r[1], b[j + 1][0] = r[2], b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the epilogue tiles

  // epilogue: each 16-row slab of the warp's tile through a per-warp
  // [16][LDS] int tile; lane owns half a row (16 values, two 8-wide stores):
  // dequant, then bias / GELU / residual / cast
  int* cs = reinterpret_cast<int*>(gsmem) + warp * 16 * LDS;
  const int g = lane >> 2, tig = lane & 3;
  const int r = lane >> 1, cb = (lane & 1) * 16;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {  // mma's accumulator layout: rows g, g + 8; cols 2 tig, +1
      const int col = j * 8 + tig * 2;
      cs[g * LDS + col] = acc[i][j][0];
      cs[g * LDS + col + 1] = acc[i][j][1];
      cs[(g + 8) * LDS + col] = acc[i][j][2];
      cs[(g + 8) * LDS + col + 1] = acc[i][j][3];
    }
    __syncwarp();
    const int m = m0 + wm * WM + i * 16 + r;
    if (m < M) {
      const float rsm = rs[m];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nb = n0 + wn * WN + cb + h * 8;
        float v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t)
          v[t] = nb + t < N
                     ? __fmul_rn(__fmul_rn(__int2float_rn(cs[r * LDS + cb + h * 8 + t]), rsm),
                                 ws[nb + t])
                     : 0.f;
        if (e.vec && nb + 8 <= N) {
          epilogue_store8<T>(e, m, nb, v);
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t)
            if (nb + t < N) epilogue_store<T>(e, m, nb + t, v[t]);
        }
      }
    }
    __syncwarp();
  }
}

template <typename T>
cudaError_t gemm_s8(const signed char* A, long lda, const float* rs, const signed char* Wt,
                    const float* ws, int M, int N, int K, Epilogue e, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_s8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)i8::SMEM);
  if (attr != cudaSuccess) return attr;
  set_vec<T>(e);
  dim3 grid((N + i8::BN - 1) / i8::BN, (M + i8::BM - 1) / i8::BM);
  gemm_s8_kernel<T><<<grid, i8::THREADS, i8::SMEM, st>>>(A, lda, rs, Wt, ws, M, N, K, e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The B4 layer on x [B, S, D]; keys masked by `mask` [B, S] bytes (or null).
// Each stage's int8 codes and f32 row scales land in buffers of their own,
// so a caller can read every quantized activation back.

template <typename T>
cudaError_t layer_int8_forward(
    const T* x, const unsigned char* mask, const T* ln1g, const T* ln1b, const signed char* wqkv,
    const float* sqkv, const T* bqkv, const signed char* wo, const float* so, const T* bo,
    const T* ln2g, const T* ln2b, const signed char* w1, const float* s1, const T* b1,
    const signed char* w2, const float* s2, const T* b2, T* out, signed char* q_ln1, float* s_ln1,
    signed char* q_ctx, float* s_ctx, signed char* q_ln2, float* s_ln2, signed char* q_gelu,
    float* s_gelu, T* qkv, T* ctx, float* x1, T* m1, int B, int S, int D, int H, int HD, int M,
    float eps, cudaStream_t st) {
  const int rows = B * S, KW = H * HD;
  const int act = sizeof(T) == 2 ? ACT_GELU_TANH : ACT_GELU_ERF;
  VPT_TRY(ln_rowquant<T, T>(x, D, ln1g, ln1b, q_ln1, s_ln1, rows, D, eps, st));
  VPT_TRY(gemm_s8<T>(q_ln1, D, s_ln1, wqkv, sqkv, rows, 3 * KW, D,
                     epi(bqkv, ACT_NONE, nullptr, 0, false, qkv, 3 * KW, false), st));
  VPT_TRY(attention(qkv, mask, nullptr, ctx, B, S, H, KW, st));
  VPT_TRY(rowquant<T>(ctx, KW, q_ctx, s_ctx, rows, KW, st));
  VPT_TRY(gemm_s8<T>(q_ctx, KW, s_ctx, wo, so, rows, D, KW,
                     epi(bo, ACT_NONE, x, D, false, x1, D, true), st));
  VPT_TRY(ln_rowquant<float, T>(x1, D, ln2g, ln2b, q_ln2, s_ln2, rows, D, eps, st));
  VPT_TRY(gemm_s8<T>(q_ln2, D, s_ln2, w1, s1, rows, M, D,
                     epi(b1, act, nullptr, 0, false, m1, M, false), st));
  VPT_TRY(rowquant<T>(m1, M, q_gelu, s_gelu, rows, M, st));
  VPT_TRY(gemm_s8<T>(q_gelu, M, s_gelu, w2, s2, rows, D, M,
                     epi(b2, ACT_NONE, x1, D, true, out, D, false), st));
  return cudaSuccess;
}

}  // namespace vpt

using namespace vpt;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, biases, LN params, out, qkv, ctx,
// m1); weights int8 and transposed, [N, K] row-major, their scales f32 [N].
// mask: [B, S]
// bytes (torch.bool) or null. Workspaces: codes int8 and scales f32 [B*S]
// of each stage (LN1 [B*S, D], ctx [B*S, KW], LN2 [B*S, D], GELU [B*S, M]);
// qkv [B*S, 3KW], ctx [B*S, KW], m1 [B*S, M] in the dtype; x1 [B*S, D] f32.
int vpt_vit_layer_int8_forward(
    int dtype, const void* x, const void* mask, const void* ln1g, const void* ln1b,
    const void* wqkv, const void* sqkv, const void* bqkv, const void* wo, const void* so,
    const void* bo, const void* ln2g, const void* ln2b, const void* w1, const void* s1,
    const void* b1, const void* w2, const void* s2, const void* b2, void* out, void* q_ln1,
    void* s_ln1, void* q_ctx, void* s_ctx, void* q_ln2, void* s_ln2, void* q_gelu, void* s_gelu,
    void* qkv, void* ctx, void* x1, void* m1, int B, int S, int D, int H, int HD, int M, float eps,
    void* stream) {
  if (!shapes_ok(dtype, B, S, D, H, HD, M) || D % 16 || M % 16) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using i8p = const signed char*;
  using fp = const float*;
#define VPT_INT8(T)                                                                               \
  layer_int8_forward<T>((const T*)x, (const unsigned char*)mask, (const T*)ln1g, (const T*)ln1b,   \
                        (i8p)wqkv, (fp)sqkv, (const T*)bqkv, (i8p)wo, (fp)so, (const T*)bo,        \
                        (const T*)ln2g, (const T*)ln2b, (i8p)w1, (fp)s1, (const T*)b1, (i8p)w2,    \
                        (fp)s2, (const T*)b2, (T*)out, (signed char*)q_ln1, (float*)s_ln1,         \
                        (signed char*)q_ctx, (float*)s_ctx, (signed char*)q_ln2, (float*)s_ln2,    \
                        (signed char*)q_gelu, (float*)s_gelu, (T*)qkv, (T*)ctx, (float*)x1,        \
                        (T*)m1, B, S, D, H, HD, M, eps, st)
  return dtype == 0 ? VPT_INT8(float) : VPT_INT8(bf16);
#undef VPT_INT8
}

// x [rows, k] in the dtype, k % 8 == 0, 16-byte aligned -> q int8 [rows, k],
// s f32 [rows]
int vpt_rowquant(int dtype, const void* x, void* q, void* s, int rows, int k, void* stream) {
  if ((dtype != 0 && dtype != 1) || rows <= 0 || k <= 0 || k % 8) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? rowquant<float>((const float*)x, k, (signed char*)q, (float*)s, rows, k, st)
                    : rowquant<bf16>((const bf16*)x, k, (signed char*)q, (float*)s, rows, k, st);
}

}  // extern "C"
