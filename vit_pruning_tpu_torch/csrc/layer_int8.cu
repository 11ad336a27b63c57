// Kernel B4, the int8 serving layer, for Hopper (sm_90a). C entry points:
//
//   vpt_vit_layer_int8_forward  replaces vit_pruning_tpu/ops/pallas/layer_int8.py
//                               ::fused_vit_layer_int8: B1's pre-LN block
//                               (layer.cu) with QKV, O, fc1 and fc2 as
//                               int8 x int8 -> int32 products
//   vpt_rowquant                the per-row quantization on its own
//   vpt_gemm_s8                 one int8 product, for tests of the body
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
// int8 ops / 1979e12 + attention FLOPs / 989e12. The design:
//   - the four products run wgmma_s8.cuh's wgmma s8 + TMA body, the weights
//     K-major [N, K] as 8-bit wgmma requires (laid out once per forward by
//     the caller), with the dequant, bias, GELU, residual and cast fused
//     into the epilogue (__int2float_rn, then __fmul_rn by the row scale,
//     then by the column scale, so that no FMA contraction moves it off the
//     plain version's rounding; int32 sums are exact in any order);
//   - the row quantization is fused where the row is whole in one warp,
//     into the layer norms;
//   - ctx (KW wide) and the GELU output (MLP wide) span several column
//     tiles of the kernel that writes them, so each has a row-quantization
//     pass of its own (a read in x's dtype and an int8 write). Fusing them
//     into the next product's A producer (each row's amax recorded by the
//     writer's epilogue, the codes formed in registers) was measured and
//     kept out: every column tile of the next product re-reads and
//     re-quantizes its rows in x's dtype, which cost more than the passes
//     (PERF.md, B4's row).

#include <atomic>

#include "wgmma_s8.cuh"

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
// the amax pass and the quantizing pass see the same numbers. As
// layer.cu's layer_norm, the statistics run over the first dn of the d
// values; zero-padded columns (g = b = 0) give LN value 0 and code 0, and
// leave the row's amax as it is.

template <typename Tin, typename Tg>
__global__ void ln_rowquant_kernel(const Tin* __restrict__ x, long ldx, const Tg* __restrict__ g,
                                   const Tg* __restrict__ b, signed char* __restrict__ q,
                                   float* __restrict__ qs, int rows, int d, int dn, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const Tin* xr = x + row * ldx;
  float mean, rs;
  ln_stats(xr, dn, eps, mean, rs);
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
                        int rows, int d, int dn, float eps, cudaStream_t st) {
  ln_rowquant_kernel<Tin, Tg><<<(rows + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, st>>>(
      x, ldx, g, b, q, qs, rows, d, dn, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t rowquant(const T* x, long ldx, signed char* q, float* qs, int rows, int k,
                     cudaStream_t st) {
  rowquant_kernel<T><<<(rows + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, st>>>(x, ldx, q, qs,
                                                                                    rows, k);
  return cudaGetLastError();
}

// 8 consecutive values read through the read-only path: the epilogue's
// inputs do not alias its output, so the loads may run ahead of its stores
__device__ __forceinline__ void ldg8(const bf16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 f = __bfloat1622float2(h[t]);
    v[2 * t] = f.x;
    v[2 * t + 1] = f.y;
  }
}
__device__ __forceinline__ void ldg8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The products' epilogue: v = (acc * row scale) * column scale, then
// common.cuh's order (+ bias, activation, + residual, cast). e.vec also
// asks for a 16-byte aligned ws.
template <typename T>
struct Int8Epi {
  Epilogue e;
  const float* rs;
  const float* ws;

  __device__ __forceinline__ void operator()(int m, int n, const int* acc, int M, int N) const {
    if (m >= M || n >= N) return;
    const float r = __ldg(rs + m);
    if (e.vec && n + 8 <= N) {
      float v[8], t8[8];
      ldg8(ws + n, t8);
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = __fmul_rn(__fmul_rn(__int2float_rn(acc[t]), r), t8[t]);
      if (e.bias) {
        ldg8(static_cast<const T*>(e.bias) + n, t8);
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] += t8[t];
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = gelu(v[t], e.act);
      if (e.res) {
        const long ri = m * e.ldr + n;
        if (e.res_f32)
          ldg8(static_cast<const float*>(e.res) + ri, t8);
        else
          ldg8(static_cast<const T*>(e.res) + ri, t8);
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] += t8[t];
      }
      const long o = m * e.ldc + n;
      if (e.out_f32)
        store8(static_cast<float*>(e.out) + o, v);
      else
        store8(static_cast<T*>(e.out) + o, v);
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (n + t < N)
          epilogue_store<T>(e, m, n + t, __fmul_rn(__fmul_rn(__int2float_rn(acc[t]), r), ws[n + t]));
    }
  }
};

// launches of the s8 body since the last reset (four a layer)
std::atomic<long long> g_s8_launches;

// out = epilogue(A codes [M, K] (row stride lda) @ Wt^T), rs their row scales
template <typename T>
cudaError_t gemm_s8(const signed char* A, long lda, const float* rs, const signed char* Wt,
                    const float* ws, int M, int N, int K, Epilogue e, cudaStream_t st) {
  set_vec<T>(e);
  e.vec = e.vec && aligned16(ws);
  VPT_TRY(wgmma_s8(A, lda, Wt, Int8Epi<T>{e, rs, ws}, M, N, K, st));
  g_s8_launches++;
  return cudaSuccess;
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
    float* s_gelu, T* qkv, T* ctx, float* x1, T* m1, bf16* aplanes, int B, int S, int D, int H,
    int HD, int M, int DN, float eps, cudaStream_t st) {
  const int rows = B * S, KW = H * HD;
  const int act = sizeof(T) == 2 ? ACT_GELU_TANH : ACT_GELU_ERF;
  VPT_TRY(ln_rowquant<T, T>(x, D, ln1g, ln1b, q_ln1, s_ln1, rows, D, DN, eps, st));
  VPT_TRY(gemm_s8<T>(q_ln1, D, s_ln1, wqkv, sqkv, rows, 3 * KW, D,
                     epi(bqkv, ACT_NONE, nullptr, 0, false, qkv, 3 * KW, false), st));
  VPT_TRY(attention(qkv, mask, nullptr, ctx, B, S, H, KW, st, false, aplanes));
  VPT_TRY(rowquant<T>(ctx, KW, q_ctx, s_ctx, rows, KW, st));
  VPT_TRY(gemm_s8<T>(q_ctx, KW, s_ctx, wo, so, rows, D, KW,
                     epi(bo, ACT_NONE, x, D, false, x1, D, true), st));
  VPT_TRY(ln_rowquant<float, T>(x1, D, ln2g, ln2b, q_ln2, s_ln2, rows, D, DN, eps, st));
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
// m1); weights int8 K-major, [N, K] row-major (ops/quant.py::
// kmajor_int8_weights), their scales f32 [N]. mask: [B, S] bytes
// (torch.bool) or null. Workspaces: codes int8 and scales f32 [B*S] of each
// stage (LN1 [B*S, D], ctx [B*S, KW], LN2 [B*S, D], GELU [B*S, M]); qkv
// [B*S, 3KW], ctx [B*S, KW], m1 [B*S, M] in the dtype; x1 [B*S, D] f32;
// aplanes, float32 only (else null): the f32 attention's planes of q, k and
// v, 9 B S KW bf16 (layer.cu's attention). DN: the layer norms' width, as
// layer.cu's vpt_vit_layer_forward's.
int vpt_vit_layer_int8_forward(
    int dtype, const void* x, const void* mask, const void* ln1g, const void* ln1b,
    const void* wqkv, const void* sqkv, const void* bqkv, const void* wo, const void* so,
    const void* bo, const void* ln2g, const void* ln2b, const void* w1, const void* s1,
    const void* b1, const void* w2, const void* s2, const void* b2, void* out, void* q_ln1,
    void* s_ln1, void* q_ctx, void* s_ctx, void* q_ln2, void* s_ln2, void* q_gelu, void* s_gelu,
    void* qkv, void* ctx, void* x1, void* m1, void* aplanes, int B, int S, int D, int H, int HD,
    int M, int DN, float eps, void* stream) {
  if (!shapes_ok(dtype, B, S, D, H, HD, M, DN) || D % 16 || M % 16 ||
      (long)B * S > 65535L * w8::BM)
    return cudaErrorInvalidValue;
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
                        (T*)m1, (bf16*)aplanes, B, S, D, H, HD, M, DN, eps, st)
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

// One product on the s8 body, as B4 runs it, for tests of the body: out [M,
// N] = epilogue(A @ Wt^T), A int8 codes [M, K] (row stride lda, a multiple
// of 16), rs their f32 row scales [M], Wt int8 [N, K], ws f32 [N]. dtype 0 =
// float32, 1 = bfloat16: bias [N], residual and out in it unless res_f32 /
// out_f32; act 0 none, 1 erf GELU, 2 tanh GELU. N % 8 == 0, K % 16 == 0,
// 16-byte aligned A and Wt.
int vpt_gemm_s8(int dtype, const void* A, long lda, const void* rs, const void* Wt, const void* ws,
                int M, int N, int K, const void* bias, int act, const void* res, long ldr,
                int res_f32, void* out, long ldc, int out_f32, void* stream) {
  if ((dtype != 0 && dtype != 1) || M < 1 || N < 1 || N % 8 || K < 1 || K % 16 || lda % 16 || lda < K ||
      act < 0 || act > 2 || ldc < N || (res && ldr < N) || !aligned16(A) || !aligned16(Wt))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epilogue e = epi(bias, act, res, ldr, res_f32 != 0, out, ldc, out_f32 != 0);
  const signed char* a = static_cast<const signed char*>(A);
  const signed char* w = static_cast<const signed char*>(Wt);
  const float* r = static_cast<const float*>(rs);
  const float* s = static_cast<const float*>(ws);
  return dtype == 0 ? gemm_s8<float>(a, lda, r, w, s, M, N, K, e, st)
                    : gemm_s8<bf16>(a, lda, r, w, s, M, N, K, e, st);
}

// launches of the s8 body since the last reset
long long vpt_int8_body_launches() { return g_s8_launches.load(); }

void vpt_int8_body_reset() { g_s8_launches = 0; }

}  // extern "C"
