// Shared by the kernels' translation units (layer.cu, layer_attention.cu,
// cls_logits.cu, gemm.cu, layer_int8.cu, encoder.cu, attention.cu, mlp.cu,
// embed.cu): the numerics helpers, the GEMM epilogue (bias, activation,
// residual, cast), what the attention bodies share (the key flags, the
// layout of q, k, v), and the declarations of the launchers that layer.cu,
// layer_attention.cu and gemm.cu define and layer_int8.cu and encoder.cu
// reuse (B1's attention and LayerNorm, the GEMMs, the shape rules). The
// bf16 GEMM body on wgmma + TMA, which gemm.cu and embed.cu share, is
// wgmma.cuh; the f32 split body, which gemm.cu, mlp.cu and embed.cu share,
// is split6.cuh; the f32 attention body, which layer.cu (B1, B3-B5) and
// attention.cu (B6) share, is split_attention.cuh. Everything defined here
// is inline or a template, so every unit may include it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vpt {

using bf16 = __nv_bfloat16;

// The head dims the layer kernels (B1-B5) take, each an instance of the
// attention kernels: vit_tiny's 16 (one wgmma k-step of 16), the quality
// gate model's 32 (two), DeiT-S's 64 (four) and ViT-H's 80 (five).
__host__ __device__ constexpr bool layer_head_dim_ok(int hd) {
  return hd == 16 || hd == 32 || hd == 64 || hd == 80;
}
// The tokens B3's inversion takes a round (layer.cu), 9 chunks of 32. Longer
// sequences (a position table resized past 288 tokens: DeiT-S at 384 gives
// 577) go in more rounds, with the same numerics. (The attention bodies of
// B1-B6 and B2's launches have limits of their own: layer_attention.cu,
// attention.cu, split_attention.cuh, cls_logits.cu.)
constexpr int kResidentChunks = 9;
constexpr int kResidentSeq = kResidentChunks * 32;

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
// + residual (T or f32), cast. Two variants for the bf16 persistent body
// alone (gemm.cu's LayerEpi; other bodies refuse them): LayerScale's
// (gamma: + residual after the gain, out = res + gamma[n] * (acc + bias))
// and SwiGLU's gated fc1 (gate: the product's columns are (u1, u2) pairs,
// 2i and 2i + 1, and out [M, N / 2] = silu(u1 + b) * (u2 + b) in T).

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
  const void* gamma;  // [N] in T: LayerScale's gain before the residual, or null
  int gate;           // SwiGLU's pairs: out = silu(u1) * u2, N / 2 columns
};

inline Epilogue epi(const void* bias, int act, const void* res, long ldr, bool res_f32, void* out,
                    long ldc, bool out_f32) {
  return Epilogue{bias, act, res, ldr, res_f32 ? 1 : 0, out, ldc, out_f32 ? 1 : 0, 0, nullptr, 0};
}
// the same epilogue with LayerScale's gain
inline Epilogue scaled(Epilogue e, const void* gamma) {
  e.gamma = gamma;
  return e;
}
// the same epilogue as SwiGLU's gate (no activation, residual or f32 out)
inline Epilogue gated(Epilogue e) {
  e.gate = 1;
  return e;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// 8-wide epilogue accesses: every row start of out/res and the bias 16-byte
// aligned, for the epilogue's dtype T of bias and T-typed out/res
template <typename T>
inline void set_vec(Epilogue& e) {
  const long el = sizeof(T), out_el = e.out_f32 ? 4 : el, res_el = e.res_f32 ? 4 : el;
  e.vec = aligned16(e.out) && (e.ldc * out_el) % 16 == 0 && (!e.bias || aligned16(e.bias)) &&
          (!e.res || (aligned16(e.res) && (e.ldr * res_el) % 16 == 0)) &&
          (!e.gamma || aligned16(e.gamma));
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
// 4 consecutive bf16 values <- 8 bytes (the gated epilogue's outputs)
__device__ __forceinline__ void store4(bf16* p, const float* v) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}
// SwiGLU's gate, in f32: silu(u1) * u2
__device__ __forceinline__ float swiglu(float u1, float u2) {
  return u1 / (1.0f + __expf(-u1)) * u2;
}

// 8 consecutive values of T as they lie in memory (16 bytes of bf16, 32 of f32)
template <typename T>
struct Raw8 {
  uint4 u[sizeof(T) / 2];
};
template <typename T>
__device__ __forceinline__ Raw8<T> load_raw8(const T* p) {
  return *reinterpret_cast<const Raw8<T>*>(p);
}

// the epilogue of 8 consecutive outputs (m, n..n+7), all in range, from
// what it reads besides the product, loaded apart so that a caller can
// issue the loads early: the bias (b; read when e.bias) and the residual
// (r; read when e.res). Bias, activation (ACT, or
// e.act where ACT < 0), + residual (apply), then cast and store (finish).
template <typename T>
__device__ __forceinline__ void epilogue_fetch8(const Epilogue& e, int m, int n, float* r) {
  if (!e.res) return;
  const long i = m * e.ldr + n;
  if (e.res_f32)
    load8(static_cast<const float*>(e.res) + i, r);
  else
    load8(static_cast<const T*>(e.res) + i, r);
}
template <typename T, int ACT = -1>
__device__ __forceinline__ void epilogue_apply8(const Epilogue& e, float* v, const Raw8<T>& b,
                                                const float* r) {
  if (e.bias) {
    float t[8];
    load8(reinterpret_cast<const T*>(&b), t);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += t[i];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = gelu(v[i], ACT < 0 ? e.act : ACT);
  if (e.res) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += r[i];
  }
}
template <typename T, int ACT = -1>
__device__ __forceinline__ void epilogue_finish8(const Epilogue& e, int m, int n, float* v,
                                                 const Raw8<T>& b, const float* r) {
  epilogue_apply8<T, ACT>(e, v, b, r);
  const long o = m * e.ldc + n;
  if (e.out_f32)
    store8(static_cast<float*>(e.out) + o, v);
  else
    store8(static_cast<T*>(e.out) + o, v);
}
template <typename T>
__device__ __forceinline__ void epilogue_store8(const Epilogue& e, int m, int n, float* v) {
  Raw8<T> b{};
  float r[8];
  if (e.bias) b = load_raw8(static_cast<const T*>(e.bias) + n);
  epilogue_fetch8<T>(e, m, n, r);
  epilogue_finish8<T>(e, m, n, v, b, r);
}

#define VPT_TRY(...)                          \
  do {                                        \
    cudaError_t err_ = (__VA_ARGS__);         \
    if (err_ != cudaSuccess) return err_;     \
  } while (0)

// ---------------------------------------------------------------------------
// What the attention bodies share: the key flags and the layout of q, k, v
// and the output.

// Key j of image b: 0 absent (j >= S), 1 valid, 2 masked (-1e30). The mask
// is a [B, S] byte mask (B1, B6), or the image's kept count, keys j <
// counts[b] valid (B3's compacted rows), or neither (every key valid).
__device__ __forceinline__ unsigned char key_flag(const unsigned char* mask, const int* counts,
                                                  int b, int S, int j) {
  if (j >= S) return 0;
  if (counts) return j < counts[b] ? 1 : 2;
  return (mask == nullptr || mask[(long)b * S + j]) ? 1 : 2;
}

// element (image b, head h, token j, column d) of q, k, v or the output sits
// at ptr[b * img + h * head + j * row + d]
struct AttnLayout {
  long img, head, row;
};

// Whether split_attention.cuh's f32 body keeps a row's logits in registers
// (one pass, "resident": one box of 64 hd columns and at most four 64-key
// chunks) or streams K and V twice ("streamed")
__host__ __device__ constexpr bool split_attention_resident(int hd, int S) {
  return hd <= 64 && S >= 1 && (S + 63) / 64 <= 4;
}

// --- defined in layer_attention.cu, layer.cu and gemm.cu ----------------------

// B1's attention on qkv [B*S, 3KW] -> ctx [B*S, KW], head dim KW / H (one of
// layer_head_dim_ok's); keys masked by `mask`
// [B, S] bytes or by the kept counts [B] (either may be null). normalized
// false: staged2 numerics (B1, B3, B4: numerators rounded to T, PV scaled by
// 1/rowsum); true: B5's (P = exp / rowsum, then rounded to T, then PV).
// float32 (layer.cu, split_attention.cuh's body) splits q, k and v into
// `planes`, a workspace of 9 B S KW bf16 (16-byte aligned); bf16
// (layer_attention.cu) takes none (null).
cudaError_t attention(const float* qkv, const unsigned char* mask, const int* counts, float* ctx,
                      int B, int S, int H, int KW, cudaStream_t st, bool normalized, bf16* planes);
cudaError_t attention(const bf16* qkv, const unsigned char* mask, const int* counts, bf16* ctx,
                      int B, int S, int H, int KW, cudaStream_t st, bool normalized, bf16* planes);
// the body layer attention takes (layer_attention.cu's rule, mirrored by
// ops/cuda/layer.py::attention_body): 0 wgmma resident, 1 wgmma streamed
// (bf16), 2 split resident, 3 split streamed (f32), -1 refused
int layer_attention_body(int dtype, int hd, int S);
// one launch of the layer attention's body, for vpt_layer_attention_body_counts
void count_layer_attention(int body);

// out[M, N] = epilogue(A[M, K] (row stride lda) @ W[K, N]), defined in
// gemm.cu: in bf16 the wgmma + TMA body where TMA can describe A and W (else
// WMMA tiles), in float32 the split body (six bf16 wgmma passes over exact
// three-way splits of A and W, full f32 accuracy), which first splits W into
// the workspace wplanes (3 K N bf16, 16-byte aligned; N a multiple of 8).
// bf16 takes no workspace.
cudaError_t gemm(const bf16* A, long lda, const bf16* W, int M, int N, int K, Epilogue e,
                 cudaStream_t st, bf16* wplanes = nullptr);
cudaError_t gemm(const float* A, long lda, const float* W, int M, int N, int K, const Epilogue& e,
                 cudaStream_t st, bf16* wplanes);

// LayerNorm of `rows` rows of x (Tin) into y (T), d values a row, f32
// statistics over the first dn of them; instances <float, float>,
// <bf16, bf16> and <float, bf16>
template <typename Tin, typename T>
cudaError_t layer_norm(const Tin* x, long ldx, const T* g, const T* b, T* y, long ldy, int rows,
                       int d, int dn, float eps, cudaStream_t st);

// the geometry every layer kernel takes: HD one of layer_head_dim_ok's,
// any S >= 1, D and M multiples of 8, the layer norms' width 1 <= DN <= D
bool shapes_ok(int dtype, int B, int S, int D, int H, int HD, int M, int DN);

}  // namespace vpt
