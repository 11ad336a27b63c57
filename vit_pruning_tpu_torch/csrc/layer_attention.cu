// The attention of kernels B1, B3, B4 and B5 (sm_90a): layer.cu's
// attention(), which every one of them calls between its QKV and O products.
//
//   attention(const bf16*, ...)  the bf16 body below (wgmma + TMA)
//   attention(const float*, ...) in layer.cu: split_attention.cuh's body
//                                (six bf16 wgmma passes over exact three-way
//                                splits of q, k, v and P: f32 accuracy)
//
// It replaces the attention core of vit_pruning_tpu/ops/pallas/layer.py::
// fused_vit_layer (B1, B3; B4's ops/pallas/layer_int8.py keeps it) and of
// ops/pallas/model.py::fused_vit_encoder (B5). Two numerics, both on the
// logits l = (q . k) / sqrt(hd) in f32 with masked keys at -1e30:
//   staged2 (B1, B3, B4): numerators e = exp(l - max) rounded to bf16, PV in
//     f32, the context scaled by 1 / (the f32 sum of the rounded e);
//   normalised (B5): P = e / sum(e) rounded to bf16, then PV in f32.
// The context is rounded once to bf16. Keys past S are exactly 0 in P; a
// row whose keys are all masked averages them (exp(-1e30 + 1e30) = 1).
//
// q, k and v are column slices of the QKV product's output [B*S, 3 KW]
// (head h at columns h*hd, KW + h*hd, 2 KW + h*hd); the context is written
// to [B*S, KW] at column h*hd. Each third is described to TMA as a 4-D
// tensor (hd, head, token, image) with byte strides (2 hd, 6 KW, 6 KW S):
// a box of 64 columns x 64 tokens reads zeros past hd and past S, never
// the next head's or the next image's values.
//
// What bounds it on an H100: at DeiT-S (hd 64, S 197, batch 512) the two
// products are ~4 S^2 hd FLOP a head against ~8 S hd bytes, so the least
// time is the bytes (~0.1 ms a layer); in practice the exp of every logit
// and the moves around it on the CUDA cores, and the latency of one
// warpgroup's load -> QK^T -> softmax -> PV chain, hidden only by the other
// blocks on the SM. The design (the tensor-core body of kernel B6,
// attention.cu, with bf16 P):
//   - A block is one warpgroup and one 64-query tile of one (image, head);
//     the grid is B * H * ceil(S / 64), the tiles of one head next to each
//     other so that they read its K and V from L2 together.
//   - QK^T of a 64-key chunk is wgmma m64n64k16 on K-major operands from
//     128-byte swizzled TMA boxes, hd / 16 steps (hd 80: one box of 64 and
//     one step into a second box, whose other 48 columns are zeros; PV
//     then fills a second 64-column accumulator of which 16 are kept).
//   - One pass where the registers hold the logits (the "resident" body,
//     S <= 64 kLogitChunks): Q, K and all of V arrive by TMA at once
//     (V on a barrier of its own, so the softmax overlaps its load); QK^T
//     of every chunk into registers (32 f32 a chunk a thread), the row max
//     over the whole row, e = exp(l - max) in place, the sum, P packed as
//     bf16 pairs in the accumulator's layout, which is wgmma's register A
//     fragment, then PV (wgmma with A from registers, V the MN-major B
//     operand) into 32 f32 a thread per 64 of hd. QK^T runs once, and the
//     max and the exp come in the reference's order.
//   - Past it (the "streamed" body: S 257, ViT-H's dense length; S 577,
//     DeiT-S at 384), two passes over a ring of two TMA stages, as B6's:
//     pass 1 takes each K chunk's logits for the row max (and, normalised,
//     a running sum rescaled when the max grows), pass 2 recomputes them
//     from K and V chunks, forms P and adds its PV product. (One pass over
//     five chunks at ViT-H's S 257 holds 176 KB, one block an SM, and B1
//     ran 1.99 ms against 1.81-1.88 streamed: kernel_variants.py b1.)
//   - The normalised quotient is Markstein's: with rc = RN(1 / sum) and
//     q = RN(e rc), q + RN(e - q sum) rc is the correctly rounded e / sum
//     (an IEEE division took 37% of B6's time).
//   - The context leaves through a quad transpose (each lane 8 consecutive
//     columns of one row) as 16-byte stores.
// Launches are counted per body (vpt_layer_attention_body_counts); no
// shape drops to another body: one the bf16 body cannot take is refused.

#include <atomic>

#include "common.cuh"
#include "wgmma.cuh"

namespace vpt {

namespace la {
constexpr int BOX = 64 * 128;  // one TMA box: 64 tokens x 64 columns of bf16
// the most 64-key chunks whose logits the resident body keeps in registers
constexpr int kLogitChunks = 4;
enum Body { RESIDENT = 0, STREAMED = 1, SPLIT_RESIDENT = 2, SPLIT_STREAMED = 3, BODIES = 4 };
__host__ __device__ constexpr int chunks(int S) { return (S + 63) / 64; }
template <int HD>
struct Geo {
  static_assert(layer_head_dim_ok(HD), "a head dim the layer kernels take");
  static constexpr int NHB = (HD + 63) / 64;  // boxes of 64 columns across hd
  static constexpr int KSTEPS = HD / 16;      // QK^T steps of 16
  // Q, then K and V: NKC chunks each (resident) or a ring of two (streamed);
  // then the barriers and the key flags
  static constexpr size_t smem_bytes(int kv_chunks, int flags) {
    return 1024 + size_t(NHB) * (1 + 2 * kv_chunks) * BOX + 3 * sizeof(uint64_t) + flags;
  }
};
}  // namespace la

// which body takes a layer attention: bf16 at a layer head dim, resident up
// to kLogitChunks chunks of keys, streamed past it; f32: split_attention.cuh's
// body, resident or streamed by split_attention_resident; -1: none
// (mirrored by ops/cuda/layer.py::attention_body)
int layer_attention_body(int dtype, int hd, int S) {
  if (!layer_head_dim_ok(hd) || S < 1) return -1;
  if (dtype == 0) return split_attention_resident(hd, S) ? la::SPLIT_RESIDENT : la::SPLIT_STREAMED;
  if (dtype != 1) return -1;
  return la::chunks(S) <= la::kLogitChunks ? la::RESIDENT : la::STREAMED;
}

std::atomic<long long> g_layer_attention_launches[la::BODIES];

// a 4-D tile at (c0 inner, .., c3 outer) of the tensor map into shared memory
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// QK^T of one 64-key chunk into l (zeroed by the caller): hd / 16 steps,
// K-major A (Q's boxes at qa) and B (the chunk's K box of hd box j at kb + j
// kstride boxes). The caller fences before and commits after.
template <int HD>
__device__ __forceinline__ void la_qk(float (&l)[32], uint32_t qa, uint32_t kb, int kstride) {
  using namespace la;
#pragma unroll
  for (int kk = 0; kk < Geo<HD>::KSTEPS; ++kk) {
    const int j = kk >> 2, off = (kk & 3) * 32;
    wgmma_m64n64k16<0>(l, gmma_desc(qa + j * BOX + off, 16, 1024),
                       gmma_desc(kb + j * kstride * BOX + off, 16, 1024));
  }
}

// P of one chunk as bf16 pairs, the A fragments of PV (register p holds
// accumulators 2p, 2p + 1; k-slice s is registers 4s .. 4s + 3): the
// numerators e (staged2, their rounded values summed into sum[r]) or e /
// sum (normalised, rc = RN(1 / sum))
__device__ __forceinline__ void la_pack(const float (&e)[32], bool normalized, float (&sum)[2],
                                        const float (&rc)[2], uint32_t (&p)[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int r = k & 1;  // accumulators 2k, 2k + 1 lie on row (k % 2)
    float a = e[2 * k], b = e[2 * k + 1];
    if (normalized) {
      a = attn_div(a, sum[r], rc[r]);
      b = attn_div(b, sum[r], rc[r]);
    }
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    if (!normalized) sum[r] += __low2float(h) + __high2float(h);
    p[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

// o[j] += P @ V over one 64-key chunk: V MN-major, its box of hd box j at
// vb + j kstride boxes, 16 keys (2 KB of the box) a step
template <int HD>
__device__ __forceinline__ void la_pv(float (&o)[la::Geo<HD>::NHB][32], const uint32_t (&p)[16],
                                      uint32_t vb, int kstride) {
  using namespace la;
#pragma unroll
  for (int j = 0; j < Geo<HD>::NHB; ++j)
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_m64n64k16_ra(o[j], p[4 * s], p[4 * s + 1], p[4 * s + 2], p[4 * s + 3],
                         gmma_desc(vb + (j * kstride) * BOX + s * 2048, 8192, 1024));
}

// ctx rows of this tile (rows past S left alone), o scaled by rs[row], as
// bf16. Per pair of 8-column blocks the quad's four lanes hold four (row,
// block) combinations, two columns of each; after the transpose (as the
// GEMM body's epilogue) lane q holds all 8 columns of combination q: row +
// 8 (q & 1), block + (q >> 1), stored as 16 bytes.
template <int HD>
__device__ __forceinline__ void la_store(const float (&o)[la::Geo<HD>::NHB][32],
                                         const float (&rs)[2], bf16* ctx, long row0, int row_in,
                                         int S, int KW) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int r = row_in + (lane >> 2) + 8 * (q & 1);
  const bool live = r < S;
  const float scl = (q & 1) ? rs[1] : rs[0];
  bf16* out = ctx + (row0 + r) * KW;
#pragma unroll
  for (int jb = 0; jb < la::Geo<HD>::NHB; ++jb)
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const float* a = o[jb] + 4 * j;
      float v[8];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int c = q ^ x;  // the combination this lane sends, and the pair it receives
        const float sx = c == 0 ? a[0] : c == 1 ? a[2] : c == 2 ? a[4] : a[6];
        const float sy = c == 0 ? a[1] : c == 1 ? a[3] : c == 2 ? a[5] : a[7];
        const float rx = __shfl_xor_sync(0xffffffffu, sx, x);
        const float ry = __shfl_xor_sync(0xffffffffu, sy, x);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (t == c) {
            v[2 * t] = rx * scl;
            v[2 * t + 1] = ry * scl;
          }
      }
      const int col = jb * 64 + (j + (q >> 1)) * 8;
      if (live && col < HD) store8(out + col, v);
    }
}

// Blocks an SM the resident body is compiled for (ptxas may then take 64K /
// (128 blocks) registers a thread): as many as shared memory holds, as far
// as the logits' registers allow. At four chunks up to hd 64 three blocks
// fit 72 KB each; unbound, ptxas takes 255 registers there (two blocks an
// SM), and B1 at DeiT-S took 1.81 and 1.98 ms against 1.75-1.78 bound
// (kernel_variants.py b1, two runs, H100 80GB at 700 W). A bound of one
// block would let it take up to 255 at two and three chunks too, where it
// takes 96 and 136 unbound.
constexpr int la_blocks(int hd, int nkc) {
  return hd <= 64 ? (nkc == 1 ? 6 : nkc == 2 ? 5 : 3) : (nkc == 1 ? 4 : nkc == 2 ? 2 : 1);
}

// The resident body: NKC chunks of keys (1 .. kLogitChunks), one pass.
template <int HD, int NKC>
__global__ void __launch_bounds__(128, la_blocks(HD, NKC))
layer_attention_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const unsigned char* __restrict__ mask, const int* __restrict__ counts,
                       bf16* __restrict__ ctx, int H, int S, int KW, float scale, bool normalized) {
  using namespace la;
  constexpr int NHB = Geo<HD>::NHB;
  extern __shared__ unsigned char lsmem[];
  const uint32_t raw = smem_u32(lsmem);
  unsigned char* qs = lsmem + (((raw + 1023) & ~1023u) - raw);  // [NHB] boxes
  unsigned char* ks = qs + NHB * BOX;                            // [NHB][NKC]
  unsigned char* vs = ks + NHB * NKC * BOX;                      // [NHB][NKC]
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + NHB * NKC * BOX);  // Q and K, V
  unsigned char* flag = reinterpret_cast<unsigned char*>(bar + 3);   // [NKC * 64]
  const int bh = blockIdx.x / NKC, qt = blockIdx.x % NKC, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(smem_u32(bar), 1);
    mbar_init(smem_u32(bar + 1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = tid; j < NKC * 64; j += 128) flag[j] = key_flag(mask, counts, b, S, j);
  __syncthreads();
  if (tid == 0) {
    const uint32_t b0 = smem_u32(bar), b1 = smem_u32(bar + 1);
    mbar_arrive_expect(b0, NHB * (1 + NKC) * BOX);
    mbar_arrive_expect(b1, NHB * NKC * BOX);
    for (int j = 0; j < NHB; ++j) {
      tma_load_4d(smem_u32(qs + j * BOX), &tq, b0, j * 64, h, qt * 64, b);
      for (int c = 0; c < NKC; ++c)
        tma_load_4d(smem_u32(ks + (j * NKC + c) * BOX), &tk, b0, j * 64, h, c * 64, b);
    }
    for (int j = 0; j < NHB; ++j)
      for (int c = 0; c < NKC; ++c)
        tma_load_4d(smem_u32(vs + (j * NKC + c) * BOX), &tv, b1, j * 64, h, c * 64, b);
  }
  const uint32_t qa = smem_u32(qs), ka = smem_u32(ks), va = smem_u32(vs);

  // every chunk's QK^T in one group
  float l[NKC][32];
#pragma unroll
  for (int c = 0; c < NKC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) l[c][i] = 0.f;
  mbar_wait(smem_u32(bar), 0);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NKC; ++c) la_qk<HD>(l[c], qa, ka + c * BOX, NKC);
  wgmma_commit();
  wgmma_wait<0>();

  // the row max over the whole row, then e = exp(l - max) in place
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < NKC; ++c) {
    attn_flags(l[c], flag, c, scale);
    mx[0] = fmaxf(mx[0], attn_rowmax(l[c], 0));
    mx[1] = fmaxf(mx[1], attn_rowmax(l[c], 1));
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NKC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      l[c][i] = expf(l[c][i] - mx[(i >> 1) & 1]);
      if (normalized) sum[(i >> 1) & 1] += l[c][i];
    }
  float rc[2] = {1.f, 1.f};
  if (normalized) {
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    rc[0] = __frcp_rn(sum[0]);
    rc[1] = __frcp_rn(sum[1]);
  }
  uint32_t p[NKC][16];
#pragma unroll
  for (int c = 0; c < NKC; ++c) la_pack(l[c], normalized, sum, rc, p[c]);

  float o[NHB][32];
#pragma unroll
  for (int j = 0; j < NHB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  mbar_wait(smem_u32(bar + 1), 0);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NKC; ++c) la_pv<HD>(o, p[c], va + c * BOX, NKC);
  wgmma_commit();
  wgmma_wait<0>();

  float rs[2] = {1.f, 1.f};
  if (!normalized) {
    rs[0] = 1.0f / quad_sum(sum[0]);
    rs[1] = 1.0f / quad_sum(sum[1]);
  }
  la_store<HD>(o, rs, ctx + h * HD, (long)b * S, qt * 64 + (tid >> 5) * 16, S, KW);
}

// The streamed body, past kLogitChunks chunks: steps t = 0 .. 2 nkc - 1
// are pass 1's K chunk t, then pass 2's K and V chunk t - nkc, into stage t
// & 1 of the ring (barrier 1 + (t & 1), its (t >> 1)-th phase); thread 0
// starts step t + 2 once every thread is done with step t's stage.
template <int HD>
__global__ void __launch_bounds__(128)
layer_attention_stream_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const unsigned char* __restrict__ mask,
                              const int* __restrict__ counts, bf16* __restrict__ ctx, int H,
                              int S, int KW, float scale, bool normalized) {
  using namespace la;
  constexpr int NHB = Geo<HD>::NHB;
  extern __shared__ unsigned char lsmem[];
  const uint32_t raw = smem_u32(lsmem);
  unsigned char* qs = lsmem + (((raw + 1023) & ~1023u) - raw);  // [NHB] boxes
  unsigned char* ks = qs + NHB * BOX;                            // [NHB][2]
  unsigned char* vs = ks + NHB * 2 * BOX;                        // [NHB][2]
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + NHB * 2 * BOX);  // Q, stage 0, 1
  unsigned char* flag = reinterpret_cast<unsigned char*>(bar + 3);  // [nkc * 64]
  const int nkc = chunks(S);
  const int bh = blockIdx.x / nkc, qt = blockIdx.x % nkc, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(smem_u32(bar + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = tid; j < nkc * 64; j += 128) flag[j] = key_flag(mask, counts, b, S, j);
  __syncthreads();
  auto load_step = [&](int t) {
    if (t >= 2 * nkc) return;
    const int st = t & 1, c = t < nkc ? t : t - nkc;
    const uint32_t sb = smem_u32(bar + 1 + st);
    mbar_arrive_expect(sb, NHB * (t < nkc ? 1 : 2) * BOX);
    for (int j = 0; j < NHB; ++j) {
      tma_load_4d(smem_u32(ks + (j * 2 + st) * BOX), &tk, sb, j * 64, h, c * 64, b);
      if (t >= nkc) tma_load_4d(smem_u32(vs + (j * 2 + st) * BOX), &tv, sb, j * 64, h, c * 64, b);
    }
  };
  if (tid == 0) {
    mbar_arrive_expect(smem_u32(bar), NHB * BOX);
    for (int j = 0; j < NHB; ++j)
      tma_load_4d(smem_u32(qs + j * BOX), &tq, smem_u32(bar), j * 64, h, qt * 64, b);
    load_step(0);
    load_step(1);
  }
  mbar_wait(smem_u32(bar), 0);
  const uint32_t qa = smem_u32(qs), ka = smem_u32(ks), va = smem_u32(vs);
  auto acquire = [&](int t) {
    mbar_wait(smem_u32(bar + 1 + (t & 1)), (t >> 1) & 1);
    return t & 1;
  };
  auto release = [&](int t) {
    __syncthreads();  // every warp is done reading step t's stage
    if (tid == 0) load_step(t + 2);
  };
  auto logits = [&](float (&l)[32], int slot, int c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) l[i] = 0.f;
    wgmma_fence();
    la_qk<HD>(l, qa, ka + slot * BOX, 2);
    wgmma_commit();
    wgmma_wait<0>();
    attn_flags(l, flag, c, scale);
  };

  // pass 1: the row max and, normalised, the sum of exp(l - max), rescaled
  // whenever the max grows
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int c = 0; c < nkc; ++c) {
    float l[32];
    logits(l, acquire(c), c);
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
    release(c);
  }

  // pass 2: P and PV
  float rc[2] = {1.f, 1.f};
  if (normalized) {
    rc[0] = __frcp_rn(sum[0]);
    rc[1] = __frcp_rn(sum[1]);
  }
  float o[NHB][32];
#pragma unroll
  for (int j = 0; j < NHB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  for (int c = 0; c < nkc; ++c) {
    float l[32];
    const int slot = acquire(nkc + c);
    logits(l, slot, c);
#pragma unroll
    for (int i = 0; i < 32; ++i) l[i] = expf(l[i] - mx[(i >> 1) & 1]);
    uint32_t p[16];
    la_pack(l, normalized, sum, rc, p);
    wgmma_fence();
    la_pv<HD>(o, p, va + slot * BOX, 2);
    wgmma_commit();
    wgmma_wait<0>();
    release(nkc + c);
  }

  float rs[2] = {1.f, 1.f};
  if (!normalized) {
    rs[0] = 1.0f / quad_sum(sum[0]);
    rs[1] = 1.0f / quad_sum(sum[1]);
  }
  la_store<HD>(o, rs, ctx + h * HD, (long)b * S, qt * 64 + (tid >> 5) * 16, S, KW);
}

// One third of qkv [B*S, 3 KW] (q, k or v at `base`, head dim HD) as the
// 4-D TMA map (hd, head, token, image), boxes of 64 columns x 64 tokens, the
// 128-byte swizzle, zeros past hd and S
inline cudaError_t tma_map_qkv(CUtensorMap* map, const bf16* base, int HD, int H, int S, int B,
                               int KW) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t row = 6ull * KW;  // bytes between tokens
  const cuuint64_t strides[3] = {2ull * HD, row, row * S};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds: zeros
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Kernel>
cudaError_t la_launch(Kernel kernel, size_t smem, int blocks, const bf16* qkv,
                      const unsigned char* mask, const int* counts, bf16* ctx, int B, int S, int H,
                      int KW, int HD, cudaStream_t st, bool normalized) {
  CUtensorMap tq, tk, tv;
  VPT_TRY(tma_map_qkv(&tq, qkv, HD, H, S, B, KW));
  VPT_TRY(tma_map_qkv(&tk, qkv + KW, HD, H, S, B, KW));
  VPT_TRY(tma_map_qkv(&tv, qkv + 2 * KW, HD, H, S, B, KW));
  VPT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  // 1/sqrt(hd) as the TPU wrapper computes it (in double, then f32)
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  kernel<<<blocks, 128, smem, st>>>(tq, tk, tv, mask, counts, ctx, H, S, KW, scale, normalized);
  return cudaGetLastError();
}

template <int HD>
cudaError_t layer_attention(const bf16* qkv, const unsigned char* mask, const int* counts,
                            bf16* ctx, int B, int S, int H, int KW, cudaStream_t st,
                            bool normalized) {
  using G = la::Geo<HD>;
  const int nkc = la::chunks(S), blocks = B * H * nkc;
  auto go = [&](auto kernel, int kv_chunks) {
    return la_launch(kernel, G::smem_bytes(kv_chunks, nkc * 64), blocks, qkv, mask, counts, ctx,
                     B, S, H, KW, HD, st, normalized);
  };
  switch (nkc) {
    case 1: return go(layer_attention_kernel<HD, 1>, 1);
    case 2: return go(layer_attention_kernel<HD, 2>, 2);
    case 3: return go(layer_attention_kernel<HD, 3>, 3);
    case 4: return go(layer_attention_kernel<HD, 4>, 4);
    default: return go(layer_attention_stream_kernel<HD>, 2);
  }
}
static_assert(la::kLogitChunks == 4, "one instance of the resident body per chunk count");

cudaError_t attention(const bf16* qkv, const unsigned char* mask, const int* counts, bf16* ctx,
                      int B, int S, int H, int KW, cudaStream_t st, bool normalized, bf16*) {
  const int hd = KW / H, body = layer_attention_body(1, hd, S);
  // TMA reads q, k, v from 16-byte aligned rows; the context leaves as 16-byte stores
  if (body < 0 || KW % H || !aligned16(qkv) || !aligned16(ctx)) return cudaErrorInvalidValue;
  cudaError_t rc;
  switch (hd) {
    case 16: rc = layer_attention<16>(qkv, mask, counts, ctx, B, S, H, KW, st, normalized); break;
    case 32: rc = layer_attention<32>(qkv, mask, counts, ctx, B, S, H, KW, st, normalized); break;
    case 64: rc = layer_attention<64>(qkv, mask, counts, ctx, B, S, H, KW, st, normalized); break;
    default: rc = layer_attention<80>(qkv, mask, counts, ctx, B, S, H, KW, st, normalized); break;
  }
  if (rc == cudaSuccess) count_layer_attention(body);
  return rc;
}

void count_layer_attention(int body) { g_layer_attention_launches[body]++; }

}  // namespace vpt

using namespace vpt;

extern "C" {

// the body layer.cu's attention() takes for (dtype 0 f32 / 1 bf16, hd, S):
// 0 wgmma resident, 1 wgmma streamed, 2 split resident, 3 split streamed,
// -1 refused
int vpt_layer_attention_body(int dtype, int hd, int S) { return layer_attention_body(dtype, hd, S); }

// launches of each body (in the order above) since the last reset
void vpt_layer_attention_body_counts(long long* out) {
  for (int i = 0; i < la::BODIES; ++i) out[i] = g_layer_attention_launches[i].load();
}

void vpt_layer_attention_body_reset() {
  for (int i = 0; i < la::BODIES; ++i) g_layer_attention_launches[i] = 0;
}

}  // extern "C"
