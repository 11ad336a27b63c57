// Shared by the kernels' translation units (layer.cu, gemm.cu, layer_int8.cu,
// encoder.cu, attention.cu, mlp.cu, embed.cu): the numerics helpers, the GEMM
// epilogue (bias, activation, residual, cast), the f32 GEMM body that B1 and
// B8 share, the f32 attention kernel that B1 (in float32) and B6 share, and
// the declarations of the launchers that layer.cu and gemm.cu define and
// layer_int8.cu and encoder.cu reuse (B1's attention and LayerNorm, the
// GEMMs, the shape rules). The bf16 GEMM body on wgmma + TMA, which gemm.cu
// and embed.cu share, is wgmma.cuh. Everything defined here is inline or a
// template, so every unit may include it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vpt {

using bf16 = __nv_bfloat16;

// The head dims the layer kernels (B1-B5) take, each an instance of the
// attention kernels: vit_tiny's 16 (one WMMA k-tile of 16), the quality
// gate model's 32 (two), DeiT-S's 64 (four) and ViT-H's 80 (five).
__host__ __device__ constexpr bool layer_head_dim_ok(int hd) {
  return hd == 16 || hd == 32 || hd == 64 || hd == 80;
}
// The longest sequence whose keys the attention kernels keep resident in
// shared memory for a whole (head, image): 9 chunks of 32 keys. Longer
// sequences (a position table resized past 288 tokens: DeiT-S at 384 gives
// 577) stream their keys through shared memory in chunks, with the same
// numerics.
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

// ---------------------------------------------------------------------------
// One block of the f32 GEMM on the CUDA cores: layer.cu's (B1-B5 in float32)
// and embed.cu's (B8 with f32 weights). A 64x64 output tile at (m0, n0), 256
// threads, 4x4 outputs a thread, K in steps of 16, plain FMA (full f32, no
// TF32, so it matches a f32 reference closely). load_a(m, k) gives A's value
// in f32 (the caller's prologue) and store(m, n, v) takes each product (the
// caller's epilogue); both are asked only for m < M, k < K and n < N.
namespace fg {
constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
}

template <typename LoadA, typename Store>
__device__ __forceinline__ void gemm_f32_tile(long m0, int n0, long M, int N, int K,
                                              const float* __restrict__ W, LoadA load_a,
                                              Store store) {
  using namespace fg;
  __shared__ float As[BK][BM + 4];  // transposed: As[k][m]
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = tid + q * THREADS;
      const int ar = c >> 4, ak = c & 15;  // A: 64 rows x 16
      const long m = m0 + ar;
      const int k = k0 + ak;
      As[ak][ar] = (m < M && k < K) ? load_a(m, k) : 0.f;
      const int bk = c >> 6, bn = c & 63;  // W: 16 rows x 64
      const int kb = k0 + bk, n = n0 + bn;
      Bs[bk][bn] = (kb < K && n < N) ? W[(long)kb * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long m = m0 + ty + 16 * i;
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) store(m, n, acc[i][j]);
    }
}

// ---------------------------------------------------------------------------
// Attention in f32 on the CUDA cores: B1, B3, B4 and B5 in float32 (through
// layer.cu's attention()) and B6's FMA body. Up to kResidentSeq keys, one
// block per (head, image): K^T of the head sits in shared memory as f32, rows padded by one
// word so the transposing store is free of bank conflicts, and V too where
// both fit in the 227 KB (at hd 64 always; at hd 128 and long sequences V is
// read from global memory, where L1 and L2 hold it). Each of the 8 warps
// takes 4 query rows at a time: one key per lane and chunk of 32 keys for
// QK^T, the row max and sum by warp shuffles, P kept in a per-warp row of
// shared memory, one output column per lane for PV. q, k and v are read in T
// and upcast; logits, softmax and PV are f32; the output is cast once to T.
// NORM false is staged2 (PV on the numerators, scaled by 1/rowsum at the
// end), true divides P by the row sum before PV.

constexpr float kNegInf = -1e30f;  // masked-key logit, as the TPU kernel

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

namespace fa {
constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int NQ = 4;              // query rows per warp pass
constexpr size_t kMaxSmem = 232448;  // 227 KB per block
__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }
// offsets in floats, each 16-byte aligned: K^T [hd][ldk], V [S][hd] (vsmem),
// Q rows [WARPS][NQ][r4(hd)], P rows [WARPS][NQ][ldp]; then the key flags,
// one byte each
struct Smem {
  int v, q, p, flag;
  __host__ __device__ Smem(int nc, int s, int hd, bool vsmem) {
    v = r4(hd * (nc * 32 + 1));
    q = v + (vsmem ? r4(s * hd) : 0);
    p = q + WARPS * NQ * r4(hd);
    flag = p + WARPS * NQ * nc * 32;
  }
  __host__ __device__ size_t bytes(int nc) const { return sizeof(float) * flag + nc * 32; }
};
__device__ __forceinline__ float lane4(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}
}  // namespace fa

// HDT: the head dim when fixed at compile time, else 0 and hd_ is read.
// Both products read their broadcast operand (the Q row, the P row) four
// values at a time (LDS.128): shared-memory loads, not FMAs, bound the loops.
// The sums still run over d and j in order.
template <typename T, int NC, int HDT, bool NORM, bool VSMEM>
__global__ void __launch_bounds__(fa::THREADS)
attention_f32_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     AttnLayout in, const unsigned char* __restrict__ mask,
                     const int* __restrict__ counts, T* __restrict__ out, AttnLayout ol, int S,
                     int hd_, float scale) {
  using namespace fa;
  constexpr int ldp = NC * 32, ldk = ldp + 1;
  const int hd = HDT ? HDT : hd_, ldq = r4(hd);
  extern __shared__ __align__(16) float sm[];
  const Smem lay(NC, S, hd, VSMEM);
  float* Kt = sm;                                  // [hd][ldk]
  float* Vs = sm + lay.v;                          // [S][hd], VSMEM only
  float* Qs = sm + lay.q;                          // [WARPS][NQ][ldq]
  float* Ps = sm + lay.p;                          // [WARPS][NQ][ldp]
  unsigned char* flag = reinterpret_cast<unsigned char*>(sm + lay.flag);  // [ldp]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long at = b * in.img + h * in.head;
  const T *qb = q + at, *kb = k + at, *vb = v + at;
  T* ob = out + b * ol.img + h * ol.head;

  for (int i = tid; i < S * hd; i += THREADS) {
    const int j = i / hd, d = i % hd;
    Kt[d * ldk + j] = to_f(kb[j * in.row + d]);
    if (VSMEM) Vs[i] = to_f(vb[j * in.row + d]);
  }
  for (int i = tid; i < (ldp - S) * hd; i += THREADS)  // absent keys: finite zeros
    Kt[(i % hd) * ldk + S + i / hd] = 0.f;
  for (int j = tid; j < ldp; j += THREADS) flag[j] = key_flag(mask, counts, b, S, j);
  __syncthreads();

  float* q_w = Qs + warp * NQ * ldq;
  float* p_w = Ps + warp * NQ * ldp;
  const int hd4 = hd & ~3, s4 = S & ~3;
  for (int q0 = warp * NQ; q0 < S; q0 += WARPS * NQ) {
    for (int i = lane; i < NQ * hd; i += 32) {
      const int qi = i / hd, d = i % hd;
      q_w[qi * ldq + d] = q0 + qi < S ? to_f(qb[(q0 + qi) * in.row + d]) : 0.f;
    }
    __syncwarp();

    float acc[NQ][NC];
#pragma unroll
    for (int qi = 0; qi < NQ; ++qi)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[qi][c] = 0.f;
    auto qk_step = [&](int d, const float (&qd)[NQ]) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Kt[d * ldk + c * 32 + lane];
#pragma unroll
      for (int qi = 0; qi < NQ; ++qi)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[qi][c] = fmaf(qd[qi], kv[c], acc[qi][c]);
    };
    for (int d0 = 0; d0 < hd4; d0 += 4) {
      float4 q4[NQ];
#pragma unroll
      for (int qi = 0; qi < NQ; ++qi) q4[qi] = *reinterpret_cast<const float4*>(q_w + qi * ldq + d0);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float qd[NQ];
#pragma unroll
        for (int qi = 0; qi < NQ; ++qi) qd[qi] = lane4(q4[qi], t);
        qk_step(d0 + t, qd);
      }
    }
    for (int d = hd4; d < hd; ++d) {
      float qd[NQ];
#pragma unroll
      for (int qi = 0; qi < NQ; ++qi) qd[qi] = q_w[qi * ldq + d];
      qk_step(d, qd);
    }

    float rinv[NQ];
#pragma unroll
    for (int qi = 0; qi < NQ; ++qi) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int f = flag[c * 32 + lane];
        acc[qi][c] = f == 2 ? kNegInf : acc[qi][c] * scale;
        if (f) mx = fmaxf(mx, acc[qi][c]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[qi][c] = flag[c * 32 + lane] ? expf(acc[qi][c] - mx) : 0.f;
        sum += acc[qi][c];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int c = 0; c < NC; ++c) p_w[qi * ldp + c * 32 + lane] = NORM ? acc[qi][c] / sum : acc[qi][c];
      rinv[qi] = NORM ? 1.0f : 1.0f / sum;
    }
    __syncwarp();

    for (int d = lane; d < hd; d += 32) {
      float o[NQ] = {};
      auto pv_step = [&](int j, const float (&pj)[NQ]) {
        const float vj = VSMEM ? Vs[j * hd + d] : to_f(vb[j * in.row + d]);
#pragma unroll
        for (int qi = 0; qi < NQ; ++qi) o[qi] = fmaf(pj[qi], vj, o[qi]);
      };
      for (int j0 = 0; j0 < s4; j0 += 4) {
        float4 p4[NQ];
#pragma unroll
        for (int qi = 0; qi < NQ; ++qi) p4[qi] = *reinterpret_cast<const float4*>(p_w + qi * ldp + j0);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float pj[NQ];
#pragma unroll
          for (int qi = 0; qi < NQ; ++qi) pj[qi] = lane4(p4[qi], t);
          pv_step(j0 + t, pj);
        }
      }
      for (int j = s4; j < S; ++j) {
        float pj[NQ];
#pragma unroll
        for (int qi = 0; qi < NQ; ++qi) pj[qi] = p_w[qi * ldp + j];
        pv_step(j, pj);
      }
#pragma unroll
      for (int qi = 0; qi < NQ; ++qi)
        if (q0 + qi < S) ob[(q0 + qi) * ol.row + d] = from_f<T>(o[qi] * rinv[qi]);
    }
    __syncwarp();
  }
}

// Sequences past kResidentSeq: one block per (head, image, 32 query rows),
// each warp its NQ rows, the keys streamed through shared memory in chunks
// of KC (K^T and, in the last pass, V as f32). Pass 1 takes the row max
// over all keys; with NORM pass 2 the row sum; the last pass forms P (the
// staged2 numerators, or P / sum with NORM) into the warp's P rows and adds
// its PV into registers, one output column a lane per 32 of hd. Each lane
// sees its keys, and each output column its keys, in the resident kernel's
// order, so both give the same sums.
namespace fs {
constexpr int KC = 64, NCB = KC / 32;  // keys a chunk, per lane 2
constexpr int ODC = 4;                 // output columns a lane: hd <= 128
constexpr int QROWS = fa::WARPS * fa::NQ;
// offsets in floats: K^T [hd][KC + 1], V [KC][hd], Q rows [WARPS][NQ][r4(hd)],
// P rows [WARPS][NQ][KC], then KC key flags
struct Smem {
  int v, q, p, flag;
  __host__ __device__ explicit Smem(int hd) {
    v = fa::r4(hd * (KC + 1));
    q = v + fa::r4(KC * hd);
    p = q + QROWS * fa::r4(hd);
    flag = p + QROWS * KC;
  }
  __host__ __device__ size_t bytes() const { return sizeof(float) * flag + KC; }
};
}  // namespace fs

template <typename T, int HDT, bool NORM>
__global__ void __launch_bounds__(fa::THREADS)
attention_f32_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, AttnLayout in,
                            const unsigned char* __restrict__ mask, const int* __restrict__ counts,
                            T* __restrict__ out, AttnLayout ol, int S, int hd_, float scale) {
  using namespace fa;
  using fs::KC;
  using fs::NCB;
  using fs::ODC;
  constexpr int ldk = KC + 1;
  const int hd = HDT ? HDT : hd_, ldq = r4(hd);
  extern __shared__ __align__(16) float sm[];
  const fs::Smem lay(hd);
  float* Kt = sm;            // [hd][ldk]
  float* Vs = sm + lay.v;    // [KC][hd]
  float* Qs = sm + lay.q;    // [WARPS][NQ][ldq]
  float* Ps = sm + lay.p;    // [WARPS][NQ][KC]
  unsigned char* flag = reinterpret_cast<unsigned char*>(sm + lay.flag);  // [KC]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long at = b * in.img + h * in.head;
  const T *qb = q + at, *kb = k + at, *vb = v + at;
  T* ob = out + b * ol.img + h * ol.head;
  const int q0 = (blockIdx.z * WARPS + warp) * NQ;
  float* q_w = Qs + warp * NQ * ldq;
  float* p_w = Ps + warp * NQ * KC;
  for (int i = lane; i < NQ * hd; i += 32) {
    const int qi = i / hd, d = i % hd;
    q_w[qi * ldq + d] = q0 + qi < S ? to_f(qb[(q0 + qi) * in.row + d]) : 0.f;
  }
  __syncwarp();

  float mx[NQ], sum[NQ], o[NQ][ODC];
#pragma unroll
  for (int qi = 0; qi < NQ; ++qi) {
    mx[qi] = -INFINITY;
    sum[qi] = 0.f;
#pragma unroll
    for (int u = 0; u < ODC; ++u) o[qi][u] = 0.f;
  }
  const int hd4 = hd & ~3, nch = (S + KC - 1) / KC;
  constexpr int kPasses = NORM ? 3 : 2;
  for (int pass = 0; pass < kPasses; ++pass) {
    const bool last = pass == kPasses - 1;
    for (int ch = 0; ch < nch; ++ch) {
      const int j0 = ch * KC, nk = min(KC, S - j0);
      __syncthreads();  // every warp is done with the previous chunk
      for (int i = tid; i < KC * hd; i += THREADS) {
        const int jj = i / hd, d = i % hd;
        const bool ok = jj < nk;
        Kt[d * ldk + jj] = ok ? to_f(kb[(long)(j0 + jj) * in.row + d]) : 0.f;
        if (last) Vs[i] = ok ? to_f(vb[(long)(j0 + jj) * in.row + d]) : 0.f;
      }
      for (int jj = tid; jj < KC; jj += THREADS) flag[jj] = key_flag(mask, counts, b, S, j0 + jj);
      __syncthreads();

      float acc[NQ][NCB];
#pragma unroll
      for (int qi = 0; qi < NQ; ++qi)
#pragma unroll
        for (int c = 0; c < NCB; ++c) acc[qi][c] = 0.f;
      auto qk_step = [&](int d, const float (&qd)[NQ]) {
        float kv[NCB];
#pragma unroll
        for (int c = 0; c < NCB; ++c) kv[c] = Kt[d * ldk + c * 32 + lane];
#pragma unroll
        for (int qi = 0; qi < NQ; ++qi)
#pragma unroll
          for (int c = 0; c < NCB; ++c) acc[qi][c] = fmaf(qd[qi], kv[c], acc[qi][c]);
      };
      for (int d0 = 0; d0 < hd4; d0 += 4) {
        float4 q4[NQ];
#pragma unroll
        for (int qi = 0; qi < NQ; ++qi) q4[qi] = *reinterpret_cast<const float4*>(q_w + qi * ldq + d0);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float qd[NQ];
#pragma unroll
          for (int qi = 0; qi < NQ; ++qi) qd[qi] = lane4(q4[qi], t);
          qk_step(d0 + t, qd);
        }
      }
      for (int d = hd4; d < hd; ++d) {
        float qd[NQ];
#pragma unroll
        for (int qi = 0; qi < NQ; ++qi) qd[qi] = q_w[qi * ldq + d];
        qk_step(d, qd);
      }

#pragma unroll
      for (int qi = 0; qi < NQ; ++qi)
#pragma unroll
        for (int c = 0; c < NCB; ++c) {
          const int f = flag[c * 32 + lane];
          const float l = f == 2 ? kNegInf : acc[qi][c] * scale;
          if (pass == 0) {
            if (f) mx[qi] = fmaxf(mx[qi], l);
          } else if (!last) {  // NORM's sum pass
            if (f) sum[qi] += expf(l - mx[qi]);
          } else {
            const float e = f ? expf(l - mx[qi]) : 0.f;
            if (!NORM) sum[qi] += e;
            p_w[qi * KC + c * 32 + lane] = NORM ? e / sum[qi] : e;
          }
        }
      if (last) {
        __syncwarp();
#pragma unroll
        for (int u = 0; u < ODC; ++u) {
          const int d = lane + 32 * u;
          if (d < hd)
            for (int j = 0; j < nk; ++j) {
              const float vj = Vs[j * hd + d];
#pragma unroll
              for (int qi = 0; qi < NQ; ++qi) o[qi][u] = fmaf(p_w[qi * KC + j], vj, o[qi][u]);
            }
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int qi = 0; qi < NQ; ++qi) {
      if (pass == 0) mx[qi] = warp_max(mx[qi]);
      if (NORM && pass == 1) sum[qi] = warp_sum(sum[qi]);
    }
  }
#pragma unroll
  for (int qi = 0; qi < NQ; ++qi) {
    const float rinv = NORM ? 1.0f : 1.0f / warp_sum(sum[qi]);
    if (q0 + qi < S)
#pragma unroll
      for (int u = 0; u < ODC; ++u) {
        const int d = lane + 32 * u;
        if (d < hd) ob[(q0 + qi) * ol.row + d] = from_f<T>(o[qi][u] * rinv);
      }
  }
}

template <typename T, int HDT, bool NORM>
cudaError_t attention_f32_stream(const T* q, const T* k, const T* v, AttnLayout in,
                                 const unsigned char* mask, const int* counts, T* out,
                                 AttnLayout ol, int B, int H, int S, int hd, cudaStream_t st) {
  if (hd > 32 * fs::ODC) return cudaErrorInvalidValue;
  const size_t smem = fs::Smem(hd).bytes();
  auto kernel = attention_f32_stream_kernel<T, HDT, NORM>;
  VPT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const dim3 grid(H, B, (S + fs::QROWS - 1) / fs::QROWS);
  kernel<<<grid, fa::THREADS, smem, st>>>(q, k, v, in, mask, counts, out, ol, S, hd, scale);
  return cudaGetLastError();
}

template <typename T, int NC, int HDT, bool NORM>
cudaError_t attention_f32_nc(const T* q, const T* k, const T* v, AttnLayout in,
                             const unsigned char* mask, const int* counts, T* out, AttnLayout ol,
                             int B, int H, int S, int hd, cudaStream_t st) {
  const bool vsmem = fa::Smem(NC, S, hd, true).bytes(NC) <= fa::kMaxSmem;
  const size_t smem = fa::Smem(NC, S, hd, vsmem).bytes(NC);
  if (smem > fa::kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = vsmem ? attention_f32_kernel<T, NC, HDT, NORM, true>
                      : attention_f32_kernel<T, NC, HDT, NORM, false>;
  VPT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  // 1/sqrt(hd) as the TPU wrappers compute it (in double, then f32)
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  kernel<<<dim3(H, B), fa::THREADS, smem, st>>>(q, k, v, in, mask, counts, out, ol, S, hd, scale);
  return cudaGetLastError();
}

// the resident kernel for S <= kResidentSeq (9 chunks of 32 keys), the
// streamed one past it
template <typename T, int HDT, bool NORM>
cudaError_t attention_f32(const T* q, const T* k, const T* v, AttnLayout in,
                          const unsigned char* mask, const int* counts, T* out, AttnLayout ol,
                          int B, int H, int S, int hd, cudaStream_t st) {
#define VPT_NC(n) \
  case n: return attention_f32_nc<T, n, HDT, NORM>(q, k, v, in, mask, counts, out, ol, B, H, S, hd, st)
  switch ((S + 31) / 32) {
    VPT_NC(1); VPT_NC(2); VPT_NC(3); VPT_NC(4); VPT_NC(5); VPT_NC(6); VPT_NC(7); VPT_NC(8); VPT_NC(9);
    default:
      return attention_f32_stream<T, HDT, NORM>(q, k, v, in, mask, counts, out, ol, B, H, S, hd, st);
  }
#undef VPT_NC
}

// --- defined in layer.cu and gemm.cu -----------------------------------------

// B1's attention on qkv [B*S, 3KW] -> ctx [B*S, KW], head dim KW / H (one of
// layer_head_dim_ok's); keys masked by `mask`
// [B, S] bytes or by the kept counts [B] (either may be null). normalized
// false: staged2 numerics (B1, B3, B4: numerators rounded to T, PV scaled by
// 1/rowsum); true: B5's (P = exp / rowsum, then rounded to T, then PV).
cudaError_t attention(const float* qkv, const unsigned char* mask, const int* counts, float* ctx,
                      int B, int S, int H, int KW, cudaStream_t st, bool normalized = false);
cudaError_t attention(const bf16* qkv, const unsigned char* mask, const int* counts, bf16* ctx,
                      int B, int S, int H, int KW, cudaStream_t st, bool normalized = false);

// out[M, N] = epilogue(A[M, K] (row stride lda) @ W[K, N]), defined in
// gemm.cu: in bf16 the wgmma + TMA body where TMA can describe A and W (else
// WMMA tiles), FMA tiles (full f32) in float32
cudaError_t gemm(const bf16* A, long lda, const bf16* W, int M, int N, int K, Epilogue e,
                 cudaStream_t st);
cudaError_t gemm(const float* A, long lda, const float* W, int M, int N, int K, const Epilogue& e,
                 cudaStream_t st);

// LayerNorm of `rows` rows of x (Tin) into y (T), f32 statistics; instances
// <float, float>, <bf16, bf16> and <float, bf16>
template <typename Tin, typename T>
cudaError_t layer_norm(const Tin* x, long ldx, const T* g, const T* b, T* y, long ldy, int rows,
                       int d, float eps, cudaStream_t st);

// the geometry every layer kernel takes: HD one of layer_head_dim_ok's,
// any S >= 1, D and M multiples of 8
bool shapes_ok(int dtype, int B, int S, int D, int H, int HD, int M);

}  // namespace vpt
