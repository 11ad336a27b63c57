// Hand-written Hopper kernels for the ViT serving path (sm_90a).
//
// Two C entry points, each launching a short fixed sequence of kernels on
// the caller's stream (the caller allocates every buffer):
//
//   vpt_vit_layer_forward           replaces vit_pruning_tpu/ops/pallas/layer.py
//                                   ::fused_vit_layer (B1, staged2 numerics)
//   vpt_vit_layer_bucketed_forward  replaces ::fused_vit_layer_bucketed (B3):
//                                   gather -> B1 at the capacity -> scatter
//
// (::fused_vit_layer_cls_logits, B2, is cls_logits.cu's.) What bounds them
// on an H100: at DeiT-S width the four layer products (QKV, O, fc1, fc2) are
// ~90% of a layer's operations and, at batch 512, well above the bf16 ridge
// (~295 FLOP/byte), so they are bound by tensor-core throughput; attention
// (S 197, hd 64) is a few percent of the FLOPs, and its softmax runs on the
// CUDA cores. The TPU kernel kept the whole layer in 100 MB of VMEM; an SM
// has 227 KB, so the layer is split into LN -> GEMM -> attention -> GEMM ->
// LN -> GEMM -> GEMM, each GEMM with its epilogue (bias, GELU, residual,
// cast) fused so that no elementwise pass touches memory on its own. The
// residual stream after attention (x1) is kept in f32 between kernels, as
// the TPU kernel kept it in f32 in VMEM.
//
// Numerics kept from the TPU kernels: LN in f32 with var = mean((x-mean)^2)
// and eps from the caller; products accumulate in f32 and add the bias before
// the cast; masked keys get -1e30 (not -inf); B1 keeps the softmax numerators
// unnormalised in the input dtype and scales the PV sum by 1/rowsum; GELU is
// the tanh form for bf16 and erf for f32.
//
// The GEMMs are gemm.cu's: in bf16 wgmma.cuh's wgmma + TMA body for every
// layer product, in f32 the split body (wgmma on exact three-way bf16 splits
// of both operands, six passes: f32 accuracy, no TF32). The attention of B1
// and B3 (and of B4, B5), at head dims 16, 32, 64 and 80: in bf16
// layer_attention.cu's wgmma + TMA body (one 64-query tile of one head a
// block, the logits in registers, P fed to PV from registers), in f32
// split_attention.cuh's body, the same design on three-way bf16 splits of
// q, k, v and P (below).

#include "split_attention.cuh"

namespace vpt {

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row, f32 statistics, output in T. The statistics
// run over the first dn of the row's d values: a row zero-padded from the
// model's width dn up to a width the GEMMs take (ROADMAP C.1) is normalised
// over its true width, and its padded columns, whose g and b are zero, come
// out zero.

template <typename Tin, typename T>
__global__ void layer_norm_kernel(const Tin* __restrict__ x, long ldx, const T* __restrict__ g,
                                  const T* __restrict__ b, T* __restrict__ y, long ldy, int rows,
                                  int d, int dn, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const Tin* xr = x + row * ldx;
  float mean, rs;
  ln_stats(xr, dn, eps, mean, rs);
  T* yr = y + row * ldy;
  for (int i = lane; i < d; i += 32)
    yr[i] = from_f<T>((to_f(xr[i]) - mean) * rs * to_f(g[i]) + to_f(b[i]));
}

template <typename Tin, typename T>
cudaError_t layer_norm(const Tin* x, long ldx, const T* g, const T* b, T* y, long ldy, int rows,
                       int d, int dn, float eps, cudaStream_t st) {
  const int warps = 8;
  layer_norm_kernel<Tin, T><<<(rows + warps - 1) / warps, warps * 32, 0, st>>>(x, ldx, g, b, y, ldy,
                                                                              rows, d, dn, eps);
  return cudaGetLastError();
}
template cudaError_t layer_norm<float, float>(const float*, long, const float*, const float*,
                                              float*, long, int, int, int, float, cudaStream_t);
template cudaError_t layer_norm<bf16, bf16>(const bf16*, long, const bf16*, const bf16*, bf16*,
                                            long, int, int, int, float, cudaStream_t);
template cudaError_t layer_norm<float, bf16>(const float*, long, const bf16*, const bf16*, bf16*,
                                             long, int, int, int, float, cudaStream_t);

// B1's attention in float32 (shared with B3, B4 and B5): split_attention.cuh's
// body, six bf16 wgmma passes over exact three-way splits of q, k, v and P,
// one instance per head dim (QK^T in hd / 16 steps). q, k and v are the three
// KW-wide thirds of each qkv row; the context is [B*S, KW]; their planes go
// to `planes` (9 B S KW bf16). The bf16 one is layer_attention.cu's.
cudaError_t attention(const float* qkv, const unsigned char* mask, const int* counts, float* ctx,
                      int B, int S, int H, int KW, cudaStream_t st, bool normalized,
                      bf16* planes) {
  const int hd = KW / H, body = layer_attention_body(0, hd, S);
  if (body < 0 || KW % H) return cudaErrorInvalidValue;
  const AttnLayout in{(long)S * 3 * KW, hd, 3L * KW}, ol{(long)S * KW, hd, KW};
  cudaError_t rc;
#define VPT_F32(KS)                                                                              \
  split_attention<KS, float>(qkv, qkv + KW, qkv + 2 * KW, in, mask, counts, ctx, ol, B, H, S, hd, \
                             normalized, planes, st)
  switch (hd) {
    case 16: rc = VPT_F32(1); break;
    case 32: rc = VPT_F32(2); break;
    case 64: rc = VPT_F32(4); break;
    default: rc = VPT_F32(5); break;
  }
#undef VPT_F32
  if (rc == cudaSuccess) count_layer_attention(body);
  return rc;
}

// The B1 layer on x [B, S, D]; keys masked by `mask` [B, S] bytes or, for
// B3's compacted rows, by the kept counts [B] (either may be null).
//
// DINOv2's block (bf16 alone: the variants are the persistent body's,
// gemm.cu): ls1 and ls2 [D], LayerScale's gains, or null, scale the O and
// fc2 products before their residuals (x1 = x + ls1 (ctx Wo + bo), out =
// x1 + ls2 (m1 W2 + b2)); `gated`: SwiGLU's fc1, w1 [D, 2M] and b1 [2M]
// with each u1 column beside its u2 partner (interleaved once at load,
// ops/swiglu.py), whose epilogue writes m1 = silu(u1) * u2 [rows, M]: the
// [rows, 2M] product never reaches device memory.
template <typename T>
cudaError_t layer_forward(const T* x, const unsigned char* mask, const int* counts, const T* ln1g,
                          const T* ln1b, const T* wqkv, const T* bqkv, const T* wo, const T* bo,
                          const T* ln2g, const T* ln2b, const T* w1, const T* b1, const T* w2,
                          const T* b2, const T* ls1, const T* ls2, bool gate, T* out, T* h, T* qkv,
                          T* ctx, float* x1, T* m1, bf16* wplanes, int B, int S, int D, int H,
                          int HD, int M, int DN, float eps, cudaStream_t st) {
  const int rows = B * S, KW = H * HD;
  const int act = sizeof(T) == 2 ? ACT_GELU_TANH : ACT_GELU_ERF;
  VPT_TRY(layer_norm<T, T>(x, D, ln1g, ln1b, h, D, rows, D, DN, eps, st));
  VPT_TRY(gemm(h, D, wqkv, rows, 3 * KW, D, epi(bqkv, ACT_NONE, nullptr, 0, false, qkv, 3 * KW, false), st,
               wplanes));
  VPT_TRY(attention(qkv, mask, counts, ctx, B, S, H, KW, st, false, wplanes));
  VPT_TRY(gemm(ctx, KW, wo, rows, D, KW, scaled(epi(bo, ACT_NONE, x, D, false, x1, D, true), ls1),
               st, wplanes));
  VPT_TRY(layer_norm<float, T>(x1, D, ln2g, ln2b, h, D, rows, D, DN, eps, st));
  if (gate)
    VPT_TRY(gemm(h, D, w1, rows, 2 * M, D, gated(epi(b1, ACT_NONE, nullptr, 0, false, m1, M, false)),
                 st, wplanes));
  else
    VPT_TRY(gemm(h, D, w1, rows, M, D, epi(b1, act, nullptr, 0, false, m1, M, false), st, wplanes));
  VPT_TRY(gemm(m1, M, w2, rows, D, M, scaled(epi(b2, ACT_NONE, x1, D, true, out, D, false), ls2),
               st, wplanes));
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// B3, the bucketed layer of the re-decide modes. The TPU kernel gathered and
// scattered with one-hot matmuls inside VMEM; here three small kernels move
// rows by index around the B1 layer run at the capacity `cap`:
//   bucket_invert  dest [B, S] -> src [B, cap] (source token of each
//                  compacted row) and the kept counts [B], one block an image;
//   gather_rows    xc[b, r] = x[b, src[b, r]];
//   layer_forward  on xc, keys r >= counts[b] masked (no [B, cap] mask built);
//   expand_rows    out[b, t] = yc[b, dest[b, t]] if t is kept, else x[b, t].
// dest puts kept tokens first and skipped ones after them, so the rows past
// an image's count hold skipped tokens: masked as keys, dropped on the way
// back, but real values, never uninitialised memory (src starts at 0 in case
// a caller's dest is not a permutation). The extra traffic over B1 at `cap`
// is one read of x and one write of out, [B, S, D] each; nothing syncs with
// the host.

// The block's threads walk the tokens in rounds of kInvertThreads, every
// thread in every round (the count is a barrier), so every token of any
// sequence length is inverted and counted: one round up to kResidentSeq.
constexpr int kInvertThreads = kResidentSeq;
static_assert(kInvertThreads % 32 == 0 && kInvertThreads <= 1024, "one block of whole warps");

__global__ void __launch_bounds__(kInvertThreads)
bucket_invert_kernel(const int* __restrict__ dest, const unsigned char* __restrict__ kept,
                     int* __restrict__ src, int* __restrict__ counts, int S, int cap) {
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int r = tid; r < cap; r += blockDim.x) src[(long)b * cap + r] = 0;
  __syncthreads();  // the zero fill is done before any row is written below
  int count = 0;
  for (int t0 = 0; t0 < S; t0 += blockDim.x) {
    const int t = t0 + tid;
    count += __syncthreads_count(t < S && kept[(long)b * S + t]);
    if (t < S) {
      const int r = dest[(long)b * S + t];
      if (r >= 0 && r < cap) src[(long)b * cap + r] = t;
    }
  }
  if (tid == 0) counts[b] = count;
}

// Rows move as 16-byte chunks: D % 8 == 0 makes a row a whole number of
// chunks in both dtypes, and the wrapper checks that x is 16-byte aligned.
template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ x, const int* __restrict__ src,
                                   T* __restrict__ xc, int S, int cap, int chunks, long total) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long row = i / chunks;  // b * cap + r
  const int c = static_cast<int>(i % chunks);
  const long from = (row / cap) * S + src[row];
  reinterpret_cast<uint4*>(xc)[row * chunks + c] = reinterpret_cast<const uint4*>(x)[from * chunks + c];
}

template <typename T>
__global__ void expand_rows_kernel(const T* __restrict__ x, const T* __restrict__ yc,
                                   const int* __restrict__ dest,
                                   const unsigned char* __restrict__ kept, T* __restrict__ out,
                                   int S, int cap, int chunks, long total) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long row = i / chunks;  // b * S + t
  const int c = static_cast<int>(i % chunks);
  const int r = dest[row];
  const bool take = kept[row] && r >= 0 && r < cap;
  const long from = take ? (row / S) * cap + r : row;
  const uint4* src = reinterpret_cast<const uint4*>(take ? yc : x);
  reinterpret_cast<uint4*>(out)[row * chunks + c] = src[from * chunks + c];
}

template <typename T>
cudaError_t bucketed_forward(const T* x, const int* dest, const unsigned char* kept, const T* ln1g,
                             const T* ln1b, const T* wqkv, const T* bqkv, const T* wo, const T* bo,
                             const T* ln2g, const T* ln2b, const T* w1, const T* b1, const T* w2,
                             const T* b2, T* out, int* src, int* counts, T* xc, T* yc, T* h, T* qkv,
                             T* ctx, float* x1, T* m1, bf16* wplanes, int B, int S, int cap, int D,
                             int H, int HD, int M, int DN, float eps, cudaStream_t st) {
  const int chunks = D * static_cast<int>(sizeof(T)) / 16;
  bucket_invert_kernel<<<B, kInvertThreads, 0, st>>>(dest, kept, src, counts, S, cap);
  VPT_TRY(cudaGetLastError());
  const long g = (long)B * cap * chunks;
  gather_rows_kernel<T><<<(g + 255) / 256, 256, 0, st>>>(x, src, xc, S, cap, chunks, g);
  VPT_TRY(cudaGetLastError());
  VPT_TRY(layer_forward<T>(xc, nullptr, counts, ln1g, ln1b, wqkv, bqkv, wo, bo, ln2g, ln2b, w1, b1,
                           w2, b2, nullptr, nullptr, false, yc, h, qkv, ctx, x1, m1, wplanes, B,
                           cap, D, H, HD, M, DN, eps, st));
  const long e = (long)B * S * chunks;
  expand_rows_kernel<T><<<(e + 255) / 256, 256, 0, st>>>(x, yc, dest, kept, out, S, cap, chunks, e);
  return cudaGetLastError();
}

bool shapes_ok(int dtype, int B, int S, int D, int H, int HD, int M, int DN) {
  return (dtype == 0 || dtype == 1) && layer_head_dim_ok(HD) && B > 0 && B <= 65535 && S > 0 &&
         H > 0 && D % 8 == 0 && M % 8 == 0 && DN > 0 && DN <= D;
}

}  // namespace vpt

using namespace vpt;

extern "C" {

const char* vpt_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int vpt_layer_head_dim_ok(int hd) { return layer_head_dim_ok(hd); }

// dtype: 0 = float32, 1 = bfloat16. mask: [B, S] bytes (torch.bool) or null.
// Workspaces: h [B*S, D], qkv [B*S, 3KW], ctx [B*S, KW], m1 [B*S, M] in the
// dtype; x1 [B*S, D] float32; wplanes, float32 only (else null): 3 max(3 D KW,
// D M, 3 B S KW) bf16, each f32 weight's three bf16 planes in turn (gemm.cu)
// and, between the QKV and O products, the attention's planes of q, k and v
// (split_attention.cuh). DN: the
// width the layer norms run over, D unless the caller zero-padded x and the
// weights from DN up to D (every entry point below takes it the same way).
// ls1, ls2 [D] (or null) and gated (w1 [D, 2M], b1 [2M] interleaved):
// DINOv2's LayerScale and SwiGLU (layer_forward), bf16 alone.
int vpt_vit_layer_forward(int dtype, const void* x, const void* mask, const void* ln1g,
                          const void* ln1b, const void* wqkv, const void* bqkv, const void* wo,
                          const void* bo, const void* ln2g, const void* ln2b, const void* w1,
                          const void* b1, const void* w2, const void* b2, const void* ls1,
                          const void* ls2, void* out, void* h, void* qkv, void* ctx, void* x1,
                          void* m1, void* wplanes, int B, int S, int D, int H, int HD, int M,
                          int DN, int gated, float eps, void* stream) {
  if (!shapes_ok(dtype, B, S, D, H, HD, M, DN) || (!ls1 != !ls2) ||
      (dtype == 0 && (ls1 || gated)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
#define VPT_LAYER(T)                                                                              \
  layer_forward<T>((const T*)x, mk, nullptr, (const T*)ln1g, (const T*)ln1b, (const T*)wqkv,      \
                   (const T*)bqkv, (const T*)wo, (const T*)bo, (const T*)ln2g, (const T*)ln2b,    \
                   (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, (const T*)ls1,         \
                   (const T*)ls2, gated != 0, (T*)out, (T*)h, (T*)qkv, (T*)ctx, (float*)x1,       \
                   (T*)m1, (bf16*)wplanes, B, S, D, H, HD, M, DN, eps, st)
  return dtype == 0 ? VPT_LAYER(float) : VPT_LAYER(bf16);
#undef VPT_LAYER
}

// dest [B, S] int32 compacted row ids (kept first, stable), kept [B, S]
// bytes, 1 <= cap <= S. Workspaces: src [B, cap] and counts [B] int32; xc,
// yc, h [B*cap, D], qkv [B*cap, 3KW], ctx [B*cap, KW], m1 [B*cap, M] in the
// dtype; x1 [B*cap, D] float32; wplanes as vpt_vit_layer_forward's. out [B,
// S, D] in the dtype.
int vpt_vit_layer_bucketed_forward(int dtype, const void* x, const void* dest, const void* kept,
                                   const void* ln1g, const void* ln1b, const void* wqkv,
                                   const void* bqkv, const void* wo, const void* bo,
                                   const void* ln2g, const void* ln2b, const void* w1,
                                   const void* b1, const void* w2, const void* b2, void* out,
                                   void* src, void* counts, void* xc, void* yc, void* h, void* qkv,
                                   void* ctx, void* x1, void* m1, void* wplanes, int B, int S,
                                   int cap, int D, int H, int HD, int M, int DN, float eps,
                                   void* stream) {
  if (!shapes_ok(dtype, B, S, D, H, HD, M, DN) || cap < 1 || cap > S) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VPT_BUCKETED(T)                                                                            \
  bucketed_forward<T>((const T*)x, (const int*)dest, (const unsigned char*)kept, (const T*)ln1g,   \
                      (const T*)ln1b, (const T*)wqkv, (const T*)bqkv, (const T*)wo, (const T*)bo,  \
                      (const T*)ln2g, (const T*)ln2b, (const T*)w1, (const T*)b1, (const T*)w2,    \
                      (const T*)b2, (T*)out, (int*)src, (int*)counts, (T*)xc, (T*)yc, (T*)h,       \
                      (T*)qkv, (T*)ctx, (float*)x1, (T*)m1, (bf16*)wplanes, B, S, cap, D, H, HD, \
                      M, DN, eps, st)
  return dtype == 0 ? VPT_BUCKETED(float) : VPT_BUCKETED(bf16);
#undef VPT_BUCKETED
}

}  // extern "C"
