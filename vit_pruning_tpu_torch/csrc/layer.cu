// Hand-written Hopper kernels for the ViT serving path (sm_90a).
//
// Three C entry points, each launching a short fixed sequence of kernels on
// the caller's stream (the caller allocates every buffer):
//
//   vpt_vit_layer_forward           replaces vit_pruning_tpu/ops/pallas/layer.py
//                                   ::fused_vit_layer (B1, staged2 numerics)
//   vpt_vit_cls_logits_forward      replaces ::fused_vit_layer_cls_logits (B2)
//   vpt_vit_layer_bucketed_forward  replaces ::fused_vit_layer_bucketed (B3):
//                                   gather -> B1 at the capacity -> scatter
//
// What bounds them on an H100: at DeiT-S width the four layer products
// (QKV, O, fc1, fc2) are ~90% of a layer's operations and, at batch 512,
// well above the bf16 ridge (~295 FLOP/byte), so they are bound by tensor-core
// throughput; attention (S 197, hd 64) is a few percent of the FLOPs, and
// its softmax runs on the CUDA cores. The TPU kernel kept the whole layer in 100 MB
// of VMEM; an SM has 227 KB, so the layer is split into LN -> GEMM ->
// attention -> GEMM -> LN -> GEMM -> GEMM, each GEMM with its epilogue (bias,
// GELU, residual, cast) fused so that no elementwise pass touches memory on
// its own. The residual stream after attention (x1) is kept in f32 between
// kernels, as the TPU kernel kept it in f32 in VMEM.
//
// Numerics kept from the TPU kernels: LN in f32 with var = mean((x-mean)^2)
// and eps from the caller; products accumulate in f32 and add the bias before
// the cast; masked keys get -1e30 (not -inf); B1 keeps the softmax numerators
// unnormalised in the input dtype and scales the PV sum by 1/rowsum; B2
// normalises before PV; GELU is the tanh form for bf16 and erf for f32.
//
// The GEMMs are gemm.cu's: in bf16 wgmma.cuh's wgmma + TMA body for every
// layer product (the WMMA body only for a classifier whose label count is
// not a multiple of 8), in f32 FMA tiles (no TF32, so f32 matches a f32
// reference closely). The attention below runs WMMA (mma.sync) tiles for
// both products in bf16 and FMA in f32, at head dims 16, 32, 64 and 80.

#include <mma.h>

#include "common.cuh"

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

// ---------------------------------------------------------------------------
// B1 attention, two implementations with the staged2 numerics: float32 on
// the CUDA cores (common.cuh's attention_f32, shared with B6) and bfloat16
// on the tensor cores (below). Each keeps a (head, image)'s keys resident in
// shared memory up to kResidentSeq tokens and streams them in chunks past
// it, with the same numerics.

// 1/sqrt(hd) as the TPU wrapper computes it (in double, then f32)
inline float attn_scale(int hd) { return static_cast<float>(1.0 / sqrt(static_cast<double>(hd))); }

cudaError_t attention(const float* qkv, const unsigned char* mask, const int* counts, float* ctx,
                      int B, int S, int H, int KW, cudaStream_t st, bool normalized) {
  // q, k, v are the three KW-wide thirds of each qkv row, the context is [B*S, KW]
  const int hd = KW / H;
  const AttnLayout in{(long)S * 3 * KW, hd, 3L * KW}, ol{(long)S * KW, hd, KW};
#define VPT_F32(HD, NORM)                                                                         \
  attention_f32<float, HD, NORM>(qkv, qkv + KW, qkv + 2 * KW, in, mask, counts, ctx, ol, B, H, S, \
                                 hd, st)
  if (hd == 64) return normalized ? VPT_F32(64, true) : VPT_F32(64, false);
  if (hd == 80) return normalized ? VPT_F32(80, true) : VPT_F32(80, false);
  // the short head dims share one instance that reads hd at run time
  if (hd == 16 || hd == 32) return normalized ? VPT_F32(0, true) : VPT_F32(0, false);
#undef VPT_F32
  return cudaErrorInvalidValue;
}

// bf16: WMMA 16x16x16 tiles, one instance per head dim HD (16: one k-tile
// of 16, 32: two, 64: four, 80: five). K, V of the image's head sit in smem as
// [S16][HD] (S16 = S rounded up to 16, zero rows beyond S); each warp takes
// 16 query rows at a time. Pass 1 runs QK^T over all key tiles for the row
// maxima; pass 2 runs it again, forms the numerators exp(l - max) rounded
// to bf16 (as the TPU kernel stores them), sums the rounded values and
// feeds them to the PV product; the context is scaled by 1/sum at the end.
// Recomputing QK^T (cheap on the tensor cores) keeps only a 16x16 logits
// tile per warp instead of the [16, S] rows, so two blocks fit in an H100
// SM's 228 KB at hd 64 and S 197 (86,784 bytes a block); at hd 80 and S 257
// a block takes 128,896 bytes and only one fits.
// Past kResidentSeq, attention_tc_stream_kernel (below) streams K and V.
// NORM (B5's numerics): pass 1 also sums the f32 numerators (a running sum,
// rescaled when the row max grows), so that pass 2 forms P = exp(l - max) /
// sum and rounds it to bf16 before PV.
namespace ta {
constexpr int WARPS = 4, THREADS = WARPS * 32;
constexpr int LDP = 16 + 8;      // bf16 numerator tile
constexpr int kStreamKeys = 64;  // K/V rows of one streamed chunk: four key tiles
template <int HD>
struct Geo {
  static_assert(HD % 16 == 0 && layer_head_dim_ok(HD), "a head dim the layer kernels take");
  static constexpr int LDKV = HD + 8;  // bf16; +8 staggers the banks
  static constexpr int LDO = HD + 4;   // f32 output tile
  // per-warp region: logits tile [16][16] f32 at 0, numerator tile
  // [16][LDP] bf16 at P_OFF, both reused for the output tile [16][LDO] f32
  // at the end; the query tile [16][LDKV] bf16 after that
  static constexpr size_t P_OFF = 16 * 16 * sizeof(float);
  // past both the output tile and the numerator tile (at HD 16 the output
  // tile [16][20] f32 ends before the numerators [16][24] bf16 do)
  static constexpr size_t Q_OFF = (16 * LDO * sizeof(float) > P_OFF + 16 * LDP * sizeof(bf16)
                                       ? 16 * LDO * sizeof(float)
                                       : P_OFF + 16 * LDP * sizeof(bf16));
  static constexpr size_t WARP_BYTES = Q_OFF + 16 * LDKV * sizeof(bf16);
  static_assert(P_OFF + 16 * LDP * sizeof(bf16) <= Q_OFF, "tiles overlap");
  static_assert(Q_OFF % 32 == 0 && WARP_BYTES % 32 == 0, "WMMA needs 256-bit aligned tiles");

  // K and V [kv rows][LDKV] bf16 (all S16 rows resident, or one chunk of
  // kStreamKeys rows streamed), the key flags [S16], the warps' regions
  __host__ __device__ static int s16(int s) { return (s + 15) / 16 * 16; }
  __host__ __device__ static size_t kv_bytes(int s) { return size_t(2) * s16(s) * LDKV * sizeof(bf16); }
  __host__ __device__ static size_t warp_base(int s) { return (kv_bytes(s) + s16(s) + 127) / 128 * 128; }
  __host__ __device__ static size_t smem_bytes(int s) { return warp_base(s) + WARPS * WARP_BYTES; }
  static constexpr size_t STREAM_KV_BYTES = size_t(2) * kStreamKeys * LDKV * sizeof(bf16);
  __host__ __device__ static size_t stream_warp_base(int s) {
    return (STREAM_KV_BYTES + s16(s) + 127) / 128 * 128;
  }
  __host__ __device__ static size_t stream_smem_bytes(int s) {
    return stream_warp_base(s) + WARPS * WARP_BYTES;
  }
};
}  // namespace ta

template <int HD, bool NORM>
__global__ void __launch_bounds__(ta::THREADS)
attention_tc_kernel(const bf16* __restrict__ qkv, const unsigned char* __restrict__ mask,
                    const int* __restrict__ counts, bf16* __restrict__ ctx, int S, int KW,
                    float scale) {
  using namespace nvcuda;
  using namespace ta;
  using G = Geo<HD>;
  constexpr int LDKV = G::LDKV, LDO = G::LDO, KT = HD / 16, CH = HD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = G::s16(S), ntiles = sp / 16;
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [sp][LDKV]
  bf16* Vs = Ks + sp * LDKV;                 // [sp][LDKV]
  unsigned char* flag = smem + G::kv_bytes(S);  // [sp]: 0 absent, 1 valid, 2 masked
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* wbase = smem + G::warp_base(S) + warp * G::WARP_BYTES;
  float* Lt = reinterpret_cast<float*>(wbase);
  bf16* Pt = reinterpret_cast<bf16*>(wbase + G::P_OFF);
  float* Ot = reinterpret_cast<float*>(wbase);
  bf16* Qt = reinterpret_cast<bf16*>(wbase + G::Q_OFF);

  const long row_stride = 3L * KW;
  const bf16* base = qkv + (long)b * S * row_stride + h * HD;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < sp * CH; c += THREADS) {  // 16-byte chunks
    const int j = c / CH, d = (c % CH) * 8;
    const bf16* r = base + j * row_stride + d;
    *reinterpret_cast<uint4*>(Ks + j * LDKV + d) = j < S ? *reinterpret_cast<const uint4*>(r + KW) : zero;
    *reinterpret_cast<uint4*>(Vs + j * LDKV + d) = j < S ? *reinterpret_cast<const uint4*>(r + 2 * KW) : zero;
  }
  for (int j = tid; j < sp; j += THREADS) flag[j] = key_flag(mask, counts, b, S, j);
  __syncthreads();

  const int r = lane >> 1, c0 = (lane & 1) * 8;  // softmax: two lanes per row
  for (int qt = warp; qt < ntiles; qt += WARPS) {
    const int q0 = qt * 16;
    for (int c = lane; c < 16 * CH; c += 32) {
      const int i = c / CH, d = (c % CH) * 8;
      *reinterpret_cast<uint4*>(Qt + i * LDKV + d) =
          q0 + i < S ? *reinterpret_cast<const uint4*>(base + (q0 + i) * row_stride + d) : zero;
    }
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[KT];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) wmma::load_matrix_sync(qa[kk], Qt + kk * 16, LDKV);

    // logits tile jt -> Lt (f32, unscaled)
    auto logits_tile = [&](int jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> l;
      wmma::fill_fragment(l, 0.f);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;  // K^T
        wmma::load_matrix_sync(kb, Ks + jt * 16 * LDKV + kk * 16, LDKV);
        wmma::mma_sync(l, qa[kk], kb, l);
      }
      wmma::store_matrix_sync(Lt, l, 16, wmma::mem_row_major);
      __syncwarp();
    };

    // pass 1: the row max and, for NORM, the row's sum of f32 numerators,
    // kept as a running sum rescaled whenever the max grows (-INFINITY: no
    // key seen yet by this lane)
    float mx = -INFINITY, rowsum = 1.f;
    if (NORM) rowsum = 0.f;
    for (int jt = 0; jt < ntiles; ++jt) {
      logits_tile(jt);
      float l8[8], tmax = -INFINITY;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int f = flag[jt * 16 + c0 + t];
        l8[t] = f == 2 ? kNegInf : Lt[r * 16 + c0 + t] * scale;
        if (f) tmax = fmaxf(tmax, l8[t]);
      }
      __syncwarp();
      if (NORM && tmax > -INFINITY) {
        const float m = fmaxf(mx, tmax);
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (flag[jt * 16 + c0 + t]) s += expf(l8[t] - m);
        rowsum = (mx > -INFINITY ? rowsum * expf(mx - m) : 0.f) + s;
      }
      mx = fmaxf(mx, tmax);
    }
    const float mo = __shfl_xor_sync(0xffffffffu, mx, 1);
    if (NORM) {  // the two lanes of the row, each rescaled to the row max
      const float so = __shfl_xor_sync(0xffffffffu, rowsum, 1), m = fmaxf(mx, mo);
      rowsum = (mx > -INFINITY ? rowsum * expf(mx - m) : 0.f) +
               (mo > -INFINITY ? so * expf(mo - m) : 0.f);
    }
    mx = fmaxf(mx, mo);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[KT];
#pragma unroll
    for (int dt = 0; dt < KT; ++dt) wmma::fill_fragment(o[dt], 0.f);
    float sum = 0.f;
    for (int jt = 0; jt < ntiles; ++jt) {
      logits_tile(jt);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int f = flag[jt * 16 + c0 + t];
        const float l = f == 2 ? kNegInf : Lt[r * 16 + c0 + t] * scale;
        const float e = f ? expf(l - mx) : 0.f;
        const bf16 p = __float2bfloat16(NORM ? e / rowsum : e);
        sum += __bfloat162float(p);
        Pt[r * LDP + c0 + t] = p;
      }
      __syncwarp();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, Pt, LDP);
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + jt * 16 * LDKV + dt * 16, LDKV);
        wmma::mma_sync(o[dt], pa, vb, o[dt]);
      }
      __syncwarp();
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float rinv = NORM ? 1.0f : 1.0f / sum;

#pragma unroll
    for (int dt = 0; dt < KT; ++dt)
      wmma::store_matrix_sync(Ot + dt * 16, o[dt], LDO, wmma::mem_row_major);
    __syncwarp();
    if (q0 + r < S) {  // each lane of the row's pair writes half of it (HD / 2, a multiple of 8)
      bf16* out = ctx + ((long)b * S + q0 + r) * KW + h * HD + (lane & 1) * (HD / 2);
      const float* src = Ot + r * LDO + (lane & 1) * (HD / 2);
#pragma unroll
      for (int c = 0; c < HD / 2; c += 8) {
        float v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = src[c + t] * rinv;
        store8(out + c, v);
      }
    }
    __syncwarp();
  }
}

// The streamed kernel, for S > kResidentSeq (K and V of a whole head no
// longer fit): the resident kernel's per-tile steps, in the same key order,
// so the same sums. A block takes one 16-row query tile a warp, four in all
// (grid z walks the tiles), and streams K (pass 1) or K and V (pass 2)
// through shared memory in chunks of kStreamKeys rows that the whole block
// loads between two barriers; K and V are read from L2 once per pass and
// block. Every warp stages equally often, past S included (its query rows
// are zeros and nothing is written).
template <int HD, bool NORM>
__global__ void __launch_bounds__(ta::THREADS)
attention_tc_stream_kernel(const bf16* __restrict__ qkv, const unsigned char* __restrict__ mask,
                           const int* __restrict__ counts, bf16* __restrict__ ctx, int S, int KW,
                           float scale) {
  using namespace nvcuda;
  using namespace ta;
  using G = Geo<HD>;
  constexpr int LDKV = G::LDKV, LDO = G::LDO, KT = HD / 16, CH = HD / 8;
  constexpr int kChunkTiles = kStreamKeys / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = G::s16(S), ntiles = sp / 16;
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [kStreamKeys][LDKV]
  bf16* Vs = Ks + kStreamKeys * LDKV;        // [kStreamKeys][LDKV]
  unsigned char* flag = smem + G::STREAM_KV_BYTES;  // [sp]: 0 absent, 1 valid, 2 masked
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* wbase = smem + G::stream_warp_base(S) + warp * G::WARP_BYTES;
  float* Lt = reinterpret_cast<float*>(wbase);
  bf16* Pt = reinterpret_cast<bf16*>(wbase + G::P_OFF);
  float* Ot = reinterpret_cast<float*>(wbase);
  bf16* Qt = reinterpret_cast<bf16*>(wbase + G::Q_OFF);

  const long row_stride = 3L * KW;
  const bf16* base = qkv + (long)b * S * row_stride + h * HD;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int j = tid; j < sp; j += THREADS) flag[j] = key_flag(mask, counts, b, S, j);
  // keys [t0 * 16, t0 * 16 + n) into rows [0, n) of Ks (and Vs), zeros past S,
  // between two barriers
  auto stage = [&](int t0, bool with_v) {
    __syncthreads();  // every warp is done with the previous chunk
    const int n = min(kChunkTiles, ntiles - t0) * 16;
    for (int c = tid; c < n * CH; c += THREADS) {
      const int jj = c / CH, d = (c % CH) * 8, j = t0 * 16 + jj;
      const bf16* r = base + (long)j * row_stride + d;
      *reinterpret_cast<uint4*>(Ks + jj * LDKV + d) = j < S ? *reinterpret_cast<const uint4*>(r + KW) : zero;
      if (with_v)
        *reinterpret_cast<uint4*>(Vs + jj * LDKV + d) = j < S ? *reinterpret_cast<const uint4*>(r + 2 * KW) : zero;
    }
    __syncthreads();
  };

  const int r = lane >> 1, c0 = (lane & 1) * 8;  // softmax: two lanes per row
  const int q0 = (blockIdx.z * WARPS + warp) * 16;
  for (int c = lane; c < 16 * CH; c += 32) {
    const int i = c / CH, d = (c % CH) * 8;
    *reinterpret_cast<uint4*>(Qt + i * LDKV + d) =
        q0 + i < S ? *reinterpret_cast<const uint4*>(base + (q0 + i) * row_stride + d) : zero;
  }
  __syncwarp();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[KT];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) wmma::load_matrix_sync(qa[kk], Qt + kk * 16, LDKV);

  // logits of the key tile in rows [16 lt, 16 lt + 16) of Ks -> Lt (f32, unscaled)
  auto logits_tile = [&](int lt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> l;
    wmma::fill_fragment(l, 0.f);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;  // K^T
      wmma::load_matrix_sync(kb, Ks + lt * 16 * LDKV + kk * 16, LDKV);
      wmma::mma_sync(l, qa[kk], kb, l);
    }
    wmma::store_matrix_sync(Lt, l, 16, wmma::mem_row_major);
    __syncwarp();
  };

  // pass 1, as the resident kernel's
  float mx = -INFINITY, rowsum = 1.f;
  if (NORM) rowsum = 0.f;
  for (int t0 = 0; t0 < ntiles; t0 += kChunkTiles) {
    stage(t0, false);
    for (int jt = t0; jt < min(t0 + kChunkTiles, ntiles); ++jt) {
      logits_tile(jt - t0);
      float l8[8], tmax = -INFINITY;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int f = flag[jt * 16 + c0 + t];
        l8[t] = f == 2 ? kNegInf : Lt[r * 16 + c0 + t] * scale;
        if (f) tmax = fmaxf(tmax, l8[t]);
      }
      __syncwarp();
      if (NORM && tmax > -INFINITY) {
        const float m = fmaxf(mx, tmax);
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (flag[jt * 16 + c0 + t]) s += expf(l8[t] - m);
        rowsum = (mx > -INFINITY ? rowsum * expf(mx - m) : 0.f) + s;
      }
      mx = fmaxf(mx, tmax);
    }
  }
  const float mo = __shfl_xor_sync(0xffffffffu, mx, 1);
  if (NORM) {
    const float so = __shfl_xor_sync(0xffffffffu, rowsum, 1), m = fmaxf(mx, mo);
    rowsum = (mx > -INFINITY ? rowsum * expf(mx - m) : 0.f) +
             (mo > -INFINITY ? so * expf(mo - m) : 0.f);
  }
  mx = fmaxf(mx, mo);

  // pass 2, as the resident kernel's
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[KT];
#pragma unroll
  for (int dt = 0; dt < KT; ++dt) wmma::fill_fragment(o[dt], 0.f);
  float sum = 0.f;
  for (int t0 = 0; t0 < ntiles; t0 += kChunkTiles) {
    stage(t0, true);
    for (int jt = t0; jt < min(t0 + kChunkTiles, ntiles); ++jt) {
      logits_tile(jt - t0);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int f = flag[jt * 16 + c0 + t];
        const float l = f == 2 ? kNegInf : Lt[r * 16 + c0 + t] * scale;
        const float e = f ? expf(l - mx) : 0.f;
        const bf16 p = __float2bfloat16(NORM ? e / rowsum : e);
        sum += __bfloat162float(p);
        Pt[r * LDP + c0 + t] = p;
      }
      __syncwarp();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, Pt, LDP);
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + (jt - t0) * 16 * LDKV + dt * 16, LDKV);
        wmma::mma_sync(o[dt], pa, vb, o[dt]);
      }
      __syncwarp();
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  const float rinv = NORM ? 1.0f : 1.0f / sum;

#pragma unroll
  for (int dt = 0; dt < KT; ++dt)
    wmma::store_matrix_sync(Ot + dt * 16, o[dt], LDO, wmma::mem_row_major);
  __syncwarp();
  if (q0 + r < S) {
    bf16* out = ctx + ((long)b * S + q0 + r) * KW + h * HD + (lane & 1) * (HD / 2);
    const float* src = Ot + r * LDO + (lane & 1) * (HD / 2);
#pragma unroll
    for (int c = 0; c < HD / 2; c += 8) {
      float v[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = src[c + t] * rinv;
      store8(out + c, v);
    }
  }
}

// the resident kernel's dynamic shared memory limit, set once, at the
// longest resident sequence
template <int HD, bool NORM>
cudaError_t attention_tc_attr() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(attention_tc_kernel<HD, NORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)ta::Geo<HD>::smem_bytes(kResidentSeq));
  return attr;
}

template <int HD, bool NORM>
cudaError_t attention_tc(const bf16* qkv, const unsigned char* mask, const int* counts, bf16* ctx,
                         int B, int S, int H, int KW, cudaStream_t st) {
  using G = ta::Geo<HD>;
  if (S <= kResidentSeq) {
    VPT_TRY(attention_tc_attr<HD, NORM>());
    attention_tc_kernel<HD, NORM><<<dim3(H, B), ta::THREADS, G::smem_bytes(S), st>>>(
        qkv, mask, counts, ctx, S, KW, attn_scale(HD));
    return cudaGetLastError();
  }
  // streamed: the flags grow with S, so the limit is set per launch
  const size_t smem = G::stream_smem_bytes(S);
  VPT_TRY(cudaFuncSetAttribute(attention_tc_stream_kernel<HD, NORM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  const int blocks = (G::s16(S) / 16 + ta::WARPS - 1) / ta::WARPS;
  attention_tc_stream_kernel<HD, NORM><<<dim3(H, B, blocks), ta::THREADS, smem, st>>>(
      qkv, mask, counts, ctx, S, KW, attn_scale(HD));
  return cudaGetLastError();
}

cudaError_t attention(const bf16* qkv, const unsigned char* mask, const int* counts, bf16* ctx,
                      int B, int S, int H, int KW, cudaStream_t st, bool normalized) {
  const int hd = KW / H;
#define VPT_TC(HD, NORM) attention_tc<HD, NORM>(qkv, mask, counts, ctx, B, S, H, KW, st)
  if (hd == 16) return normalized ? VPT_TC(16, true) : VPT_TC(16, false);
  if (hd == 32) return normalized ? VPT_TC(32, true) : VPT_TC(32, false);
  if (hd == 64) return normalized ? VPT_TC(64, true) : VPT_TC(64, false);
  if (hd == 80) return normalized ? VPT_TC(80, true) : VPT_TC(80, false);
#undef VPT_TC
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// B2 attention: the CLS query only, one warp per (head, image); each lane
// reads its keys (j = lane, lane + 32, ...) straight from the K/V buffer
// (S*hd values per block). Up to kResidentSeq keys a lane keeps its logits
// in registers; past it (cls_attention_long_kernel) in a dynamic shared row
// ps [S]; both sum in the same order.

// the context row from P [S] (normalised, rounded to T) in shared memory
template <typename T, int HD>
__device__ __forceinline__ void cls_pv(const float* ps, const T* kb, T* ctx, int S, int KW) {
  const int h = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  for (int d = lane; d < HD; d += 32) {
    float o = 0.f;
    for (int j = 0; j < S; ++j) o = fmaf(ps[j], to_f(kb[(long)j * 2 * KW + KW + d]), o);
    ctx[(long)b * KW + h * HD + d] = from_f<T>(o);  // f32 ctx, cast for the O product
  }
}

template <typename T, int HD>
__device__ __forceinline__ float cls_logit(const float* qs, const T* kb, int j, int KW, float scale) {
  const T* kr = kb + (long)j * 2 * KW;
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) acc = fmaf(qs[d], to_f(kr[d]), acc);
  return acc * scale;
}

template <typename T, int HD>
__global__ void cls_attention_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                                     T* __restrict__ ctx, int S, int KW, float scale) {
  __shared__ float qs[HD];
  __shared__ float ps[kResidentSeq];
  const int h = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  for (int d = lane; d < HD; d += 32) qs[d] = to_f(q[(long)b * KW + h * HD + d]);
  __syncwarp();
  const T* kb = kv + (long)b * S * 2 * KW + h * HD;
  float l[kResidentChunks];
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < kResidentChunks; ++c) {
    const int j = c * 32 + lane;
    l[c] = 0.f;
    if (j < S) {
      l[c] = cls_logit<T, HD>(qs, kb, j, KW, scale);
      mx = fmaxf(mx, l[c]);
    }
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kResidentChunks; ++c) {
    l[c] = c * 32 + lane < S ? expf(l[c] - mx) : 0.f;
    sum += l[c];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int c = 0; c < kResidentChunks; ++c) {
    const int j = c * 32 + lane;
    if (j < S) ps[j] = round_to<T>(l[c] / sum);  // normalised, then cast (TPU B2)
  }
  __syncwarp();
  cls_pv<T, HD>(ps, kb, ctx, S, KW);
}

template <typename T, int HD>
__global__ void cls_attention_long_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                                          T* __restrict__ ctx, int S, int KW, float scale) {
  __shared__ float qs[HD];
  extern __shared__ float pl[];  // [S]
  const int h = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  for (int d = lane; d < HD; d += 32) qs[d] = to_f(q[(long)b * KW + h * HD + d]);
  __syncwarp();
  const T* kb = kv + (long)b * S * 2 * KW + h * HD;
  float mx = -INFINITY;
  for (int j = lane; j < S; j += 32) {
    pl[j] = cls_logit<T, HD>(qs, kb, j, KW, scale);
    mx = fmaxf(mx, pl[j]);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < S; j += 32) {
    pl[j] = expf(pl[j] - mx);
    sum += pl[j];
  }
  sum = warp_sum(sum);
  for (int j = lane; j < S; j += 32) pl[j] = round_to<T>(pl[j] / sum);
  __syncwarp();
  cls_pv<T, HD>(pl, kb, ctx, S, KW);
}

template <typename T, int HD>
cudaError_t cls_attention_launch(const T* q, const T* kv, T* ctx, int B, int S, int H, int KW,
                                 cudaStream_t st) {
  if (S <= kResidentSeq) {
    cls_attention_kernel<T, HD><<<dim3(H, B), 32, 0, st>>>(q, kv, ctx, S, KW, attn_scale(HD));
    return cudaGetLastError();
  }
  const size_t smem = sizeof(float) * S;  // past 48 KB (S > 12288) only with the opt-in
  if (smem > 48 * 1024)
    VPT_TRY(cudaFuncSetAttribute(cls_attention_long_kernel<T, HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  cls_attention_long_kernel<T, HD><<<dim3(H, B), 32, smem, st>>>(q, kv, ctx, S, KW,
                                                                 attn_scale(HD));
  return cudaGetLastError();
}

template <typename T>
cudaError_t cls_attention(const T* q, const T* kv, T* ctx, int B, int S, int H, int KW,
                          cudaStream_t st) {
  switch (KW / H) {
    case 16: return cls_attention_launch<T, 16>(q, kv, ctx, B, S, H, KW, st);
    case 32: return cls_attention_launch<T, 32>(q, kv, ctx, B, S, H, KW, st);
    case 64: return cls_attention_launch<T, 64>(q, kv, ctx, B, S, H, KW, st);
    case 80: return cls_attention_launch<T, 80>(q, kv, ctx, B, S, H, KW, st);
    default: return cudaErrorInvalidValue;
  }
}

// The B1 layer on x [B, S, D]; keys masked by `mask` [B, S] bytes or, for
// B3's compacted rows, by the kept counts [B] (either may be null).
template <typename T>
cudaError_t layer_forward(const T* x, const unsigned char* mask, const int* counts, const T* ln1g,
                          const T* ln1b, const T* wqkv, const T* bqkv, const T* wo, const T* bo,
                          const T* ln2g, const T* ln2b, const T* w1, const T* b1, const T* w2,
                          const T* b2, T* out, T* h, T* qkv, T* ctx, float* x1, T* m1, int B, int S,
                          int D, int H, int HD, int M, int DN, float eps, cudaStream_t st) {
  const int rows = B * S, KW = H * HD;
  const int act = sizeof(T) == 2 ? ACT_GELU_TANH : ACT_GELU_ERF;
  VPT_TRY(layer_norm<T, T>(x, D, ln1g, ln1b, h, D, rows, D, DN, eps, st));
  VPT_TRY(gemm(h, D, wqkv, rows, 3 * KW, D, epi(bqkv, ACT_NONE, nullptr, 0, false, qkv, 3 * KW, false), st));
  VPT_TRY(attention(qkv, mask, counts, ctx, B, S, H, KW, st));
  VPT_TRY(gemm(ctx, KW, wo, rows, D, KW, epi(bo, ACT_NONE, x, D, false, x1, D, true), st));
  VPT_TRY(layer_norm<float, T>(x1, D, ln2g, ln2b, h, D, rows, D, DN, eps, st));
  VPT_TRY(gemm(h, D, w1, rows, M, D, epi(b1, act, nullptr, 0, false, m1, M, false), st));
  VPT_TRY(gemm(m1, M, w2, rows, D, M, epi(b2, ACT_NONE, x1, D, true, out, D, false), st));
  return cudaSuccess;
}

template <typename T>
cudaError_t cls_logits_forward(const T* x, const T* ln1g, const T* ln1b, const T* wq, const T* bq,
                               const T* wkv, const T* bkv, const T* wo, const T* bo, const T* ln2g,
                               const T* ln2b, const T* w1, const T* b1, const T* w2, const T* b2,
                               const T* lnfg, const T* lnfb, const T* wh, const T* bh, T* logits,
                               T* h, T* kv, T* q, T* ctx, float* x1, T* m1, float* x2, int B, int S,
                               int D, int H, int HD, int M, int DN, int labels, float eps,
                               cudaStream_t st) {
  const int rows = B * S, KW = H * HD;
  const long cls_stride = (long)S * D;  // CLS rows of x and h
  const int act = sizeof(T) == 2 ? ACT_GELU_TANH : ACT_GELU_ERF;
  VPT_TRY(layer_norm<T, T>(x, D, ln1g, ln1b, h, D, rows, D, DN, eps, st));
  VPT_TRY(gemm(h, D, wkv, rows, 2 * KW, D, epi(bkv, ACT_NONE, nullptr, 0, false, kv, 2 * KW, false), st));
  VPT_TRY(gemm(h, cls_stride, wq, B, KW, D, epi(bq, ACT_NONE, nullptr, 0, false, q, KW, false), st));
  VPT_TRY(cls_attention<T>(q, kv, ctx, B, S, H, KW, st));
  VPT_TRY(gemm(ctx, KW, wo, B, D, KW, epi(bo, ACT_NONE, x, cls_stride, false, x1, D, true), st));
  VPT_TRY(layer_norm<float, T>(x1, D, ln2g, ln2b, h, D, B, D, DN, eps, st));
  VPT_TRY(gemm(h, D, w1, B, M, D, epi(b1, act, nullptr, 0, false, m1, M, false), st));
  VPT_TRY(gemm(m1, M, w2, B, D, M, epi(b2, ACT_NONE, x1, D, true, x2, D, true), st));
  VPT_TRY(layer_norm<float, T>(x2, D, lnfg, lnfb, h, D, B, D, DN, eps, st));
  VPT_TRY(gemm(h, D, wh, B, labels, D, epi(bh, ACT_NONE, nullptr, 0, false, logits, labels, false), st));
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
                             T* ctx, float* x1, T* m1, int B, int S, int cap, int D, int H, int HD,
                             int M, int DN, float eps, cudaStream_t st) {
  const int chunks = D * static_cast<int>(sizeof(T)) / 16;
  bucket_invert_kernel<<<B, kInvertThreads, 0, st>>>(dest, kept, src, counts, S, cap);
  VPT_TRY(cudaGetLastError());
  const long g = (long)B * cap * chunks;
  gather_rows_kernel<T><<<(g + 255) / 256, 256, 0, st>>>(x, src, xc, S, cap, chunks, g);
  VPT_TRY(cudaGetLastError());
  VPT_TRY(layer_forward<T>(xc, nullptr, counts, ln1g, ln1b, wqkv, bqkv, wo, bo, ln2g, ln2b, w1, b1,
                           w2, b2, yc, h, qkv, ctx, x1, m1, B, cap, D, H, HD, M, DN, eps, st));
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
// dtype; x1 [B*S, D] float32. DN: the width the layer norms run over, D
// unless the caller zero-padded x and the weights from DN up to D (every
// entry point below takes it the same way).
int vpt_vit_layer_forward(int dtype, const void* x, const void* mask, const void* ln1g,
                          const void* ln1b, const void* wqkv, const void* bqkv, const void* wo,
                          const void* bo, const void* ln2g, const void* ln2b, const void* w1,
                          const void* b1, const void* w2, const void* b2, void* out, void* h,
                          void* qkv, void* ctx, void* x1, void* m1, int B, int S, int D, int H,
                          int HD, int M, int DN, float eps, void* stream) {
  if (!shapes_ok(dtype, B, S, D, H, HD, M, DN)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
#define VPT_LAYER(T)                                                                              \
  layer_forward<T>((const T*)x, mk, nullptr, (const T*)ln1g, (const T*)ln1b, (const T*)wqkv,      \
                   (const T*)bqkv, (const T*)wo, (const T*)bo, (const T*)ln2g, (const T*)ln2b,    \
                   (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, (T*)out, (T*)h,        \
                   (T*)qkv, (T*)ctx, (float*)x1, (T*)m1, B, S, D, H, HD, M, DN, eps, st)
  return dtype == 0 ? VPT_LAYER(float) : VPT_LAYER(bf16);
#undef VPT_LAYER
}

// Workspaces: h [B*S, D], kv [B*S, 2KW], q [B, KW], ctx [B, KW], m1 [B, M]
// in the dtype; x1, x2 [B, D] float32. logits [B, labels] in the dtype.
int vpt_vit_cls_logits_forward(int dtype, const void* x, const void* ln1g, const void* ln1b,
                               const void* wq, const void* bq, const void* wkv, const void* bkv,
                               const void* wo, const void* bo, const void* ln2g, const void* ln2b,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               const void* lnfg, const void* lnfb, const void* wh, const void* bh,
                               void* logits, void* h, void* kv, void* q, void* ctx, void* x1,
                               void* m1, void* x2, int B, int S, int D, int H, int HD, int M,
                               int DN, int labels, float eps, void* stream) {
  if (!shapes_ok(dtype, B, S, D, H, HD, M, DN) || labels <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VPT_CLS(T)                                                                                \
  cls_logits_forward<T>((const T*)x, (const T*)ln1g, (const T*)ln1b, (const T*)wq, (const T*)bq,  \
                        (const T*)wkv, (const T*)bkv, (const T*)wo, (const T*)bo, (const T*)ln2g, \
                        (const T*)ln2b, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,   \
                        (const T*)lnfg, (const T*)lnfb, (const T*)wh, (const T*)bh, (T*)logits,   \
                        (T*)h, (T*)kv, (T*)q, (T*)ctx, (float*)x1, (T*)m1, (float*)x2, B, S, D,   \
                        H, HD, M, DN, labels, eps, st)
  return dtype == 0 ? VPT_CLS(float) : VPT_CLS(bf16);
#undef VPT_CLS
}

// dest [B, S] int32 compacted row ids (kept first, stable), kept [B, S]
// bytes, 1 <= cap <= S. Workspaces: src [B, cap] and counts [B] int32; xc,
// yc, h [B*cap, D], qkv [B*cap, 3KW], ctx [B*cap, KW], m1 [B*cap, M] in the
// dtype; x1 [B*cap, D] float32. out [B, S, D] in the dtype.
int vpt_vit_layer_bucketed_forward(int dtype, const void* x, const void* dest, const void* kept,
                                   const void* ln1g, const void* ln1b, const void* wqkv,
                                   const void* bqkv, const void* wo, const void* bo,
                                   const void* ln2g, const void* ln2b, const void* w1,
                                   const void* b1, const void* w2, const void* b2, void* out,
                                   void* src, void* counts, void* xc, void* yc, void* h, void* qkv,
                                   void* ctx, void* x1, void* m1, int B, int S, int cap, int D,
                                   int H, int HD, int M, int DN, float eps, void* stream) {
  if (!shapes_ok(dtype, B, S, D, H, HD, M, DN) || cap < 1 || cap > S) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VPT_BUCKETED(T)                                                                            \
  bucketed_forward<T>((const T*)x, (const int*)dest, (const unsigned char*)kept, (const T*)ln1g,   \
                      (const T*)ln1b, (const T*)wqkv, (const T*)bqkv, (const T*)wo, (const T*)bo,  \
                      (const T*)ln2g, (const T*)ln2b, (const T*)w1, (const T*)b1, (const T*)w2,    \
                      (const T*)b2, (T*)out, (int*)src, (int*)counts, (T*)xc, (T*)yc, (T*)h,       \
                      (T*)qkv, (T*)ctx, (float*)x1, (T*)m1, B, S, cap, D, H, HD, M, DN, eps, st)
  return dtype == 0 ? VPT_BUCKETED(float) : VPT_BUCKETED(bf16);
#undef VPT_BUCKETED
}

}  // extern "C"
