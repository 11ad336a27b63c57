// The float32 attention of kernels B1-B6 on Hopper's tensor cores (sm_90a):
// B1, B3, B4 and B5 in float32 (layer.cu's attention(const float*, ...))
// and B6 in float32 or at the bf16 shapes its wgmma body does not take
// (attention.cu). It replaces the attention core of
// vit_pruning_tpu/ops/pallas/layer.py::fused_vit_layer (staged2; B3 and,
// through layer_int8.py, B4 keep it), model.py::fused_vit_encoder and
// attention.py::fused_attention (normalised) in float32.
//
// Numerics, the plain versions' up to the order of sums: l = (q . k) *
// scale in f32, scale = (float)(1 / sqrt((double)hd)); masked keys -1e30,
// keys past S -inf (exactly 0 in P); staged2: e = exp(l - max), PV on e,
// the context times 1 / sum(e); normalised: P = e / sum, correctly rounded,
// then PV. A row whose keys are all masked averages them. The output is
// cast once to its dtype.
//
// Where the f32 accuracy comes from: each f32 value of q, k and v is split
// as hi + mid + lo, three bf16 values whose sum is the value exactly
// (wgmma.cuh's split_bf16x3), and QK^T runs split6.cuh's six bf16 passes
// (lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi: the small terms first)
// over the planes, each bf16 x bf16 product exact in f32. P (or e), f32 and
// unrounded, is split the same way in registers, and PV runs the same six
// passes over P's planes and V's. The tensor cores truncate what they add
// into an accumulator: one 64-key chunk's logits are one accumulator over
// hd, passes outer (the hi.hi pass last, so that the small terms are added
// while the sum is small), and each chunk's PV goes into an accumulator of
// its own that is added into the f32 context in registers. bf16 operands
// (B6's leftover shapes) have mid = lo = 0, so their passes are skipped at
// compile time: QK^T is the hi.hi pass, PV the three passes of P's planes
// on V's hi plane.
//
// What it replaced, and why this design: the first body ran both products as
// FMAs on the CUDA cores (67 TFLOP/s); six bf16 passes at 989 TFLOP/s are
// 165 TFLOP/s of f32 work. The design is B6's bf16 wgmma body (attention.cu)
// carried to three planes:
//   - split_attention_qkv_kernel splits q, k and v once into bf16 planes in a
//     workspace [tensor][plane][B H][S][hdp] (hdp = hd rounded up to 8,
//     zero-filled: TMA's rows are whole 16 bytes), so the attention body
//     reads its operands by TMA (splitting in the block was 74% of the
//     f32 QKV product's time in its first version, PERF.md);
//   - a block is one warpgroup and one 64-query tile of one (image, head),
//     the tiles of one head next to each other (they read its K and V from
//     L2 together); TMA brings Q's planes once, and K's and V's planes chunk
//     by chunk (64 keys, 128-byte swizzled 64 x 64 boxes, zeros past S and
//     hdp) through a ring of kRing slots, the next chunks in flight while
//     one computes;
//   - "resident" (hd <= 64 and S <= 256, split_attention_resident): one
//     pass, the logits of every chunk kept in registers (up to 128 a
//     thread), QK^T once;
//   - "streamed" (past it: ViT-H's S 257 or hd 80, DeiT-S at 384's 577,
//     B6's hd 65-128): two passes as B6's bf16 body, pass 1 the row max (and,
//     normalised, the sum rescaled as the max grows), pass 2 the logits again
//     and PV.
// Launches are counted per body by the callers; a shape this body cannot
// take (hd > 128) is refused, never sent to another body. Everything here
// is in an unnamed namespace: each unit that includes the file (layer.cu,
// attention.cu) has kernels of its own, so a library built with a stage of
// one unit's copy changed (kernel_variants.py) keeps the other's as it is.

#pragma once

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace vpt {
namespace {

namespace sa {
constexpr int BOX = 64 * 128;  // one TMA box: 64 rows of 128 bytes (64 bf16)
constexpr int kRing = 3;       // ring slots, each one chunk's K or V planes
__host__ __device__ constexpr int chunks(int S) { return (S + 63) / 64; }
__host__ __device__ constexpr int hd_pad(int hd) { return (hd + 7) / 8 * 8; }
// the six passes (A plane, B plane), 0 hi, 1 mid, 2 lo: lo.hi, hi.lo,
// mid.mid, mid.hi, hi.mid, hi.hi (split6.cuh's order)
__host__ __device__ constexpr int pass_a(int p) { return p == 0 ? 2 : p == 2 || p == 3 ? 1 : 0; }
__host__ __device__ constexpr int pass_b(int p) { return p == 1 ? 2 : p == 2 || p == 4 ? 1 : 0; }
// Q's boxes, the ring's, the barriers (Q's, then a slot's each) and the
// key flags, at a 1024-byte boundary (the 128-byte swizzle)
inline size_t smem_bytes(int set, int S) {
  return 1024 + size_t(set) * (1 + kRing) * BOX + (1 + kRing) * sizeof(uint64_t) + 64 * chunks(S);
}
}  // namespace sa

// --- the split pass -------------------------------------------------------------

// q, k and v (T, element (b, h, s, d) at b img + h head + s row + d) into
// their bf16 planes: tensor t (q, k, v), plane p (hi, mid, lo; NPL of them)
// of head bh = b H + h at planes + ((t NPL + p) BH + bh) S hdp. A thread
// takes 8 columns of one token and stores 16 bytes a plane; columns hd ..
// hdp - 1 are zeros. bf16 values are their own hi plane (NPL 1).
template <typename T, int NPL>
__global__ void split_attention_qkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                           const T* __restrict__ v, AttnLayout in, int H, int S,
                                           int hd, int hdp, long BH, long n8,
                                           bf16* __restrict__ planes) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const int g = hdp / 8, d0 = static_cast<int>(i % g) * 8;
  long r = i / g;  // (t BH + bh) S + s
  const int s = static_cast<int>(r % S);
  r /= S;
  const long bh = r % BH;
  const int t = static_cast<int>(r / BH);
  const T* src =
      (t == 0 ? q : t == 1 ? k : v) + (bh / H) * in.img + (bh % H) * in.head + s * in.row;
  float x[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) x[u] = d0 + u < hd ? to_f(src[d0 + u]) : 0.f;
  const long plane = BH * S * hdp;
  bf16* dst = planes + t * NPL * plane + (bh * S + s) * hdp + d0;
  uint4 w[3];
  uint32_t* wp = reinterpret_cast<uint32_t*>(w);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float h0, m0, l0, h1, m1, l1;
    split_bf16x3(x[2 * u], h0, m0, l0);
    split_bf16x3(x[2 * u + 1], h1, m1, l1);
    wp[u] = pack_bf16x2(h0, h1);
    wp[4 + u] = pack_bf16x2(m0, m1);
    wp[8 + u] = pack_bf16x2(l0, l1);
  }
#pragma unroll
  for (int p = 0; p < NPL; ++p) *reinterpret_cast<uint4*>(dst + p * plane) = w[p];
}

// --- the body -------------------------------------------------------------------

// QK^T of one 64-key chunk into l: the passes over Q's planes (at qa) and
// the chunk's K planes (at kb), each NHB boxes of 64 hd columns, KS steps
// of 16 columns a pass (32 bytes a step within a box). Committed, not
// waited for.
template <int KS, int NPL>
__device__ __forceinline__ void sa_logits(float (&l)[32], uint32_t qa, uint32_t kb) {
  constexpr int NHB = (KS + 3) / 4;
#pragma unroll
  for (int i = 0; i < 32; ++i) l[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    if (NPL == 1 && p != 5) continue;  // bf16: hi.hi alone
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int j = kk >> 2, off = (kk & 3) * 32;
      wgmma_m64n64k16<0>(l, gmma_desc(qa + (sa::pass_a(p) * NHB + j) * sa::BOX + off, 16, 1024),
                         gmma_desc(kb + (sa::pass_b(p) * NHB + j) * sa::BOX + off, 16, 1024));
    }
  }
  wgmma_commit();
}

// oc = P @ V over one 64-key chunk, into an accumulator of its own: P's
// planes from registers (split_fragments' layout), V's planes at vb (the
// MN-major B operand, box (plane, j) at vb + (plane NHB + j) boxes, 16 keys
// = 2 KB of a box a step). Committed, not waited for.
template <int NHB, int NPL>
__device__ __forceinline__ void sa_pv(float (&oc)[NHB][32], const uint32_t (&pl)[3][16],
                                      uint32_t vb) {
#pragma unroll
  for (int j = 0; j < NHB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) oc[j][i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    if (NPL == 1 && sa::pass_b(p) != 0) continue;  // bf16 V: its hi plane alone
    const int a = sa::pass_a(p);
#pragma unroll
    for (int j = 0; j < NHB; ++j) {
      const uint32_t box = vb + (sa::pass_b(p) * NHB + j) * sa::BOX;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_m64n64k16_ra(oc[j], pl[a][4 * s], pl[a][4 * s + 1], pl[a][4 * s + 2],
                           pl[a][4 * s + 3], gmma_desc(box + s * 2048, 8192, 1024));
    }
  }
  wgmma_commit();
}

template <int NHB>
__device__ __forceinline__ void sa_add(float (&o)[NHB][32], const float (&oc)[NHB][32]) {
#pragma unroll
  for (int j = 0; j < NHB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] += oc[j][i];
}

// KS: QK^T's steps of 16 hd columns (hd / 16 for the layer kernels, 4 or 8
// for B6, whose hd is read at run time), NPL: planes an operand (3 f32, 1
// bf16), NKC: the resident body's chunks (1-4), 0 the streamed body.
// Steps t of the ring: K chunk t (t < nkc); then the resident body's V
// chunk t - nkc, or the streamed body's K and V of chunk (t - nkc) / 2 in
// turn; step t into slot t % kRing (barrier 1 + slot, its (t / kRing)-th
// phase). Thread 0 starts step t + kRing once every thread is done with
// step t's slot.
// Shared memory holds two blocks an SM where a chunk's planes are one box
// wide (96 KB), one where they are two (192 KB); 128 threads of up to 255
// registers fit twice, so ptxas needs no bound on blocks.
template <int KS, int NPL, int NKC>
__global__ void __launch_bounds__(128)
split_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const unsigned char* __restrict__ mask, const int* __restrict__ counts,
                       typename std::conditional<NPL == 3, float, bf16>::type* __restrict__ out,
                       AttnLayout ol, int H, int S, int hd, float scale, bool normalized) {
  using namespace sa;
  using T = typename std::conditional<NPL == 3, float, bf16>::type;
  constexpr int NHB = (KS + 3) / 4, SET = NPL * NHB;  // boxes of one operand's chunk
  extern __shared__ unsigned char ssm[];
  const uint32_t raw = smem_u32(ssm);
  unsigned char* qs = ssm + (((raw + 1023) & ~1023u) - raw);  // [NPL][NHB] boxes
  unsigned char* ring = qs + SET * BOX;                        // [kRing][NPL][NHB]
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + kRing * SET * BOX);
  unsigned char* flag = reinterpret_cast<unsigned char*>(bar + 1 + kRing);
  const int nkc = NKC ? NKC : chunks(S);  // key chunks, and query tiles
  const int bh = blockIdx.x / nkc, qt = blockIdx.x % nkc, b = bh / H, h = bh % H;
  const int BH = gridDim.x / nkc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int steps = NKC ? 2 * NKC : 3 * nkc;

  if (tid == 0) {
    for (int i = 0; i < 1 + kRing; ++i) mbar_init(smem_u32(bar + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = tid; j < nkc * 64; j += 128) flag[j] = key_flag(mask, counts, b, S, j);
  __syncthreads();
  auto load_step = [&](int t) {
    if (t >= steps) return;
    const bool kstep = t < nkc || (!NKC && ((t - nkc) & 1) == 0);
    const int c = t < nkc ? t : NKC ? t - nkc : (t - nkc) >> 1;
    const int slot = t % kRing;
    const uint32_t sb = smem_u32(bar + 1 + slot);
    mbar_arrive_expect(sb, SET * BOX);
    for (int p = 0; p < NPL; ++p)
      for (int j = 0; j < NHB; ++j)
        tma_load_3d(smem_u32(ring + (slot * SET + p * NHB + j) * BOX), kstep ? &tk : &tv, sb,
                    j * 64, c * 64, p * BH + bh);
  };
  if (tid == 0) {
    mbar_arrive_expect(smem_u32(bar), SET * BOX);
    for (int p = 0; p < NPL; ++p)
      for (int j = 0; j < NHB; ++j)
        tma_load_3d(smem_u32(qs + (p * NHB + j) * BOX), &tq, smem_u32(bar), j * 64, qt * 64,
                    p * BH + bh);
    for (int t = 0; t < kRing; ++t) load_step(t);
  }
  auto acquire = [&](int t) -> uint32_t {
    mbar_wait(smem_u32(bar + 1 + t % kRing), (t / kRing) & 1);
    return smem_u32(ring + (t % kRing) * SET * BOX);
  };
  auto release = [&](int t) {
    __syncthreads();  // every warp is done reading step t's slot
    if (tid == 0) load_step(t + kRing);
  };
  mbar_wait(smem_u32(bar), 0);
  const uint32_t qa = smem_u32(qs);

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, rc[2] = {1.f, 1.f};
  float o[NHB][32], oc[NHB][32];
#pragma unroll
  for (int j = 0; j < NHB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  // P of a chunk from its exp values e: e (staged2) or e / sum (normalised)
  auto p_of = [&](int i, float e) {
    const int r = (i >> 1) & 1;
    return normalized ? attn_div(e, sum[r], rc[r]) : e;
  };

  if constexpr (NKC > 0) {
    // resident: every chunk's logits, the max over the whole row, e in
    // place and its sum, then P and PV chunk by chunk
    float l[NKC > 0 ? NKC : 1][32];
#pragma unroll
    for (int c = 0; c < NKC; ++c) {
      sa_logits<KS, NPL>(l[c], qa, acquire(c));
      wgmma_wait<0>();
      release(c);
      attn_flags(l[c], flag, c, scale);
      mx[0] = fmaxf(mx[0], attn_rowmax(l[c], 0));
      mx[1] = fmaxf(mx[1], attn_rowmax(l[c], 1));
    }
#pragma unroll
    for (int c = 0; c < NKC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        l[c][i] = expf(l[c][i] - mx[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += l[c][i];
      }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    rc[0] = __frcp_rn(sum[0]);
    rc[1] = __frcp_rn(sum[1]);
#pragma unroll
    for (int c = 0; c < NKC; ++c) {
      uint32_t pl[3][16];
      split_fragments(l[c], p_of, pl);
      sa_pv<NHB, NPL>(oc, pl, acquire(NKC + c));
      wgmma_wait<0>();
      release(NKC + c);
      sa_add<NHB>(o, oc);
    }
  } else {
    // streamed, pass 1: the row max and, normalised, the sum of exp(l - max),
    // rescaled whenever the max grows
    for (int c = 0; c < nkc; ++c) {
      float l[32];
      sa_logits<KS, NPL>(l, qa, acquire(c));
      wgmma_wait<0>();
      release(c);
      attn_flags(l, flag, c, scale);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = fmaxf(mx[r], attn_rowmax(l, r));
        if (normalized) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if (((i >> 1) & 1) == r) s += expf(l[i] - m);
          sum[r] = sum[r] * expf(mx[r] - m) + quad_sum(s);
        }
        mx[r] = m;
      }
    }
    rc[0] = __frcp_rn(sum[0]);
    rc[1] = __frcp_rn(sum[1]);
    // pass 2: each chunk's logits again, e (staged2: summed here, with the
    // final max), P, PV
    for (int c = 0; c < nkc; ++c) {
      const int t = nkc + 2 * c;
      float l[32];
      sa_logits<KS, NPL>(l, qa, acquire(t));
      wgmma_wait<0>();
      release(t);
      attn_flags(l, flag, c, scale);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        l[i] = expf(l[i] - mx[(i >> 1) & 1]);
        if (!normalized) sum[(i >> 1) & 1] += l[i];
      }
      uint32_t pl[3][16];
      split_fragments(l, p_of, pl);
      sa_pv<NHB, NPL>(oc, pl, acquire(t + 1));
      wgmma_wait<0>();
      release(t + 1);
      sa_add<NHB>(o, oc);
    }
    if (!normalized) {
      sum[0] = quad_sum(sum[0]);
      sum[1] = quad_sum(sum[1]);
    }
  }

  // the context: o (normalised) or o / sum (staged2), rows past S and
  // columns past hd left alone
  const float rs[2] = {normalized ? 1.f : 1.0f / sum[0], normalized ? 1.f : 1.0f / sum[1]};
  const int row = qt * 64 + warp * 16 + (lane >> 2);
  T* ob = out + b * ol.img + h * ol.head;
#pragma unroll
  for (int j = 0; j < NHB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = row + 8 * ((i >> 1) & 1), d = j * 64 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
      if (r < S && d < hd) ob[r * ol.row + d] = from_f<T>(o[j][i] * rs[(i >> 1) & 1]);
    }
}

template <int KS, int NPL, int NKC>
cudaError_t split_attention_launch(const CUtensorMap& tq, const CUtensorMap& tk,
                                   const CUtensorMap& tv, const unsigned char* mask,
                                   const int* counts,
                                   typename std::conditional<NPL == 3, float, bf16>::type* out,
                                   AttnLayout ol, int BH, int H, int S, int hd, bool normalized,
                                   cudaStream_t st) {
  constexpr int NHB = (KS + 3) / 4;
  auto kernel = split_attention_kernel<KS, NPL, NKC>;
  const size_t smem = sa::smem_bytes(NPL * NHB, S);
  VPT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  // 1/sqrt(hd) as the TPU wrappers compute it (in double, then f32)
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  kernel<<<(unsigned)((long)BH * sa::chunks(S)), 128, smem, st>>>(tq, tk, tv, mask, counts, out, ol,
                                                                  H, S, hd, scale, normalized);
  return cudaGetLastError();
}

// The attention of q, k, v (T: float, split into three planes, or bf16, its
// own hi plane; layout `in`) into out (layout ol), keys masked by `mask` [B,
// S] bytes or the kept counts [B] (either may be null). KS: QK^T's steps of
// 16 columns, at least hd / 16 (KS <= 4: hd <= 64, one box; else hd <= 128,
// two). planes: the workspace, 3 NPL B H S hd_pad(hd) bf16, 16-byte aligned.
template <int KS, typename T>
cudaError_t split_attention(const T* q, const T* k, const T* v, AttnLayout in,
                            const unsigned char* mask, const int* counts, T* out, AttnLayout ol,
                            int B, int H, int S, int hd, bool normalized, bf16* planes,
                            cudaStream_t st) {
  constexpr int NPL = sizeof(T) == 4 ? 3 : 1, NHB = (KS + 3) / 4;
  if (hd < 1 || hd > 16 * KS || hd > 64 * NHB || S < 1 || !planes || !aligned16(planes))
    return cudaErrorInvalidValue;
  const int hdp = sa::hd_pad(hd);
  const long BH = (long)B * H, plane = BH * S * hdp, n8 = 3 * BH * S * (hdp / 8);
  split_attention_qkv_kernel<T, NPL><<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
      q, k, v, in, H, S, hd, hdp, BH, n8, planes);
  VPT_TRY(cudaGetLastError());
  CUtensorMap tq, tk, tv;
  VPT_TRY(tma_map_3d_64(&tq, planes, hdp, S, NPL * BH));
  VPT_TRY(tma_map_3d_64(&tk, planes + NPL * plane, hdp, S, NPL * BH));
  VPT_TRY(tma_map_3d_64(&tv, planes + 2 * NPL * plane, hdp, S, NPL * BH));
#define VPT_SA(NKC)                                                                        \
  split_attention_launch<KS, NPL, NKC>(tq, tk, tv, mask, counts, out, ol, (int)BH, H, S, hd, \
                                       normalized, st)
  if (NHB == 1 && split_attention_resident(hd, S)) {
    switch (sa::chunks(S)) {
      case 1: return VPT_SA(NHB == 1 ? 1 : 0);
      case 2: return VPT_SA(NHB == 1 ? 2 : 0);
      case 3: return VPT_SA(NHB == 1 ? 3 : 0);
      default: return VPT_SA(NHB == 1 ? 4 : 0);
    }
  }
  return VPT_SA(0);
#undef VPT_SA
}

}  // namespace
}  // namespace vpt
