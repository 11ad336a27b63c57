// Shared by the kernels' translation units (layer.cu, layer_int8.cu): the
// numerics helpers, the GEMM epilogue (bias, activation, residual, cast)
// and the declarations of the launchers that layer.cu defines and
// layer_int8.cu reuses (B1's attention, the shape rules). Everything defined
// here is inline or a template, so both units may include it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vpt {

using bf16 = __nv_bfloat16;

constexpr int kHD = 64;           // head dim the kernels take (DeiT-S; ViT-H's 80 is ROADMAP)
constexpr int kMaxChunks = 8;     // keys per lane of the attention kernels: S <= 256
constexpr int kMaxSeq = kMaxChunks * 32;

enum Act { ACT_NONE = 0, ACT_GELU_ERF = 1, ACT_GELU_TANH = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
// value after a round trip through T (the TPU kernel's .astype(x.dtype))
template <typename T> __device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu(float v, int act) {
  if (act == ACT_GELU_ERF) return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
  if (act == ACT_GELU_TANH) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return v;
}

// LayerNorm statistics of one row, one warp: f32 mean and 1/sqrt(var + eps)
// with var = mean((x - mean)^2), as the TPU kernels.
template <typename Tin>
__device__ __forceinline__ void ln_stats(const Tin* xr, int d, float eps, float& mean, float& rs) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += to_f(xr[i]);
  mean = warp_sum(s) / d;
  float v = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float t = to_f(xr[i]) - mean;
    v += t * t;
  }
  rs = rsqrtf(warp_sum(v) / d + eps);
}

// ---------------------------------------------------------------------------
// GEMM epilogue, in the TPU kernels' order: + bias[n] (T), activation,
// + residual (T or f32), cast.

struct Epilogue {
  const void* bias;  // [N] in T, or null
  int act;
  const void* res;   // residual, or null
  long ldr;
  int res_f32;
  void* out;
  long ldc;
  int out_f32;
  int vec;  // 8-wide accesses are 16-byte aligned (set_vec)
};

inline Epilogue epi(const void* bias, int act, const void* res, long ldr, bool res_f32, void* out,
                    long ldc, bool out_f32) {
  return Epilogue{bias, act, res, ldr, res_f32 ? 1 : 0, out, ldc, out_f32 ? 1 : 0, 0};
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// 8-wide epilogue accesses: every row start of out/res and the bias 16-byte
// aligned, for the epilogue's dtype T of bias and T-typed out/res
template <typename T>
inline void set_vec(Epilogue& e) {
  const long el = sizeof(T), out_el = e.out_f32 ? 4 : el, res_el = e.res_f32 ? 4 : el;
  e.vec = aligned16(e.out) && (e.ldc * out_el) % 16 == 0 && (!e.bias || aligned16(e.bias)) &&
          (!e.res || (aligned16(e.res) && (e.ldr * res_el) % 16 == 0));
}

template <typename T>
__device__ __forceinline__ void epilogue_store(const Epilogue& e, int m, int n, float v) {
  if (e.bias) v += to_f(static_cast<const T*>(e.bias)[n]);
  v = gelu(v, e.act);
  if (e.res) {
    const long r = m * e.ldr + n;
    v += e.res_f32 ? static_cast<const float*>(e.res)[r] : to_f(static_cast<const T*>(e.res)[r]);
  }
  const long o = m * e.ldc + n;
  if (e.out_f32)
    static_cast<float*>(e.out)[o] = v;
  else
    static_cast<T*>(e.out)[o] = from_f<T>(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0 = zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// 8 consecutive values <-> 16 bytes (bf16) or 32 bytes (f32)
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 f = __bfloat1622float2(h[t]);
    v[2 * t] = f.x;
    v[2 * t + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) h[t] = __floats2bfloat162_rn(v[2 * t], v[2 * t + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// the epilogue of 8 consecutive outputs (m, n..n+7), all in range
template <typename T>
__device__ __forceinline__ void epilogue_store8(const Epilogue& e, int m, int n, float* v) {
  float t[8];
  if (e.bias) {
    load8(static_cast<const T*>(e.bias) + n, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += t[i];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = gelu(v[i], e.act);
  if (e.res) {
    const long r = m * e.ldr + n;
    if (e.res_f32)
      load8(static_cast<const float*>(e.res) + r, t);
    else
      load8(static_cast<const T*>(e.res) + r, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += t[i];
  }
  const long o = m * e.ldc + n;
  if (e.out_f32)
    store8(static_cast<float*>(e.out) + o, v);
  else
    store8(static_cast<T*>(e.out) + o, v);
}

#define VPT_TRY(...)                          \
  do {                                        \
    cudaError_t err_ = (__VA_ARGS__);         \
    if (err_ != cudaSuccess) return err_;     \
  } while (0)

// --- defined in layer.cu ---------------------------------------------------

// B1's attention (staged2 numerics) on qkv [B*S, 3KW] -> ctx [B*S, KW]; keys
// masked by `mask` [B, S] bytes or by the kept counts [B] (either may be null)
cudaError_t attention(const float* qkv, const unsigned char* mask, const int* counts, float* ctx,
                      int B, int S, int H, int KW, cudaStream_t st);
cudaError_t attention(const bf16* qkv, const unsigned char* mask, const int* counts, bf16* ctx,
                      int B, int S, int H, int KW, cudaStream_t st);

// the geometry every layer kernel takes
bool shapes_ok(int dtype, int B, int S, int D, int H, int HD, int M);

}  // namespace vpt
