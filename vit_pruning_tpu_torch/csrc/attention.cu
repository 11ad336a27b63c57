// Kernel B6: multi-head attention on q, k, v [B, H, S, hd], all in f32
// (sm_90a).
//
//   vpt_attention_forward  replaces vit_pruning_tpu/ops/pallas/attention.py
//                          ::fused_attention
//
// out = softmax(q k^T / sqrt(hd), masked keys at -1e30) v: q, k and v are
// read in their dtype (f32 or bf16), the logits, the softmax (max, exp,
// sum, then P normalised by a division) and PV are f32, and the output is
// cast once to q's dtype. The TPU kernel took one image per grid step and
// every head of it in VMEM. Two bodies, both on wgmma + TMA, chosen by dtype
// and shape (attention_tc_takes), each launch counted per body
// (vpt_attention_body_counts):
//
// The tensor-core body (bf16 operands, hd a multiple of 8, q, k, v 16-byte
// aligned). What bounds it on an H100: at DeiT-S width (hd 64, S 197) the
// two products are ~2 S^2 hd FMAs per head against 4 S hd bf16 values
// moved, so the bound is the bytes (~0.09 ms at batch 512); in practice the
// exp and the division of every logit, twice, on the CUDA cores. QK^T
// takes bf16 operands, so bf16 wgmma with f32 accumulation computes it
// exactly; P is unrounded f32, so PV runs as three bf16 passes over
// wgmma.cuh's exact split P = hi + mid + lo (f32 up to the order of sums).
//   - A block (one warpgroup) owns a 64-query tile of one (image, head).
//     Thread 0 brings by TMA (3-D maps [B H, S, hd], boxes of 64 rows x 64
//     of hd, 128-byte swizzle, zeros past S and hd) the Q tile and, up to
//     S 257 (kAttnResidentSeq), all of that head's K and V: at most 22
//     boxes, 176 KB at S 257, hd 128; 72 KB, three blocks an SM, at DeiT-S.
//     Past S 257 (a resized position table: DeiT-S at 384 gives 577) K and
//     V stream: a ring of two stages of one 64-key chunk each, the K chunk
//     of every step of pass 1, the K and V chunks of every step of pass 2,
//     the next step's chunk in flight while this one computes; the steps
//     and the sums are the resident body's.
//   - Keys go in chunks of 64: QK^T of a chunk is one m64n64 wgmma per 16
//     of hd, the zeros past it included (K rows are the K-major B
//     operand; hd 80 runs 8 steps for 5), into 32 registers, then
//     scaled, masked keys set to -1e30 and keys past S to -inf (exactly 0
//     in P).
//   - Pass 1 takes the row max and sum over the chunks (the sum rescaled
//     when the max grows: a rounding apart from the plain version's sum).
//     Pass 2 recomputes each chunk's QK^T, forms P = exp(l - max) / sum in
//     f32 (the division's correctly rounded quotient, by a reciprocal and
//     one FMA correction: the IEEE division took 37% of the time), splits it in registers into A fragments (the accumulator's
//     layout is the A fragment's), and adds lo, mid and hi times V's
//     chunk (the MN-major B operand) into out's accumulators, 32 registers
//     per 64 of hd.
//
// The split body (f32 operands, and bf16 ones with hd % 8 != 0 or
// unaligned): split_attention.cuh's, which B1's f32 attention runs too,
// with the head dim read at run time (QK^T in 4 steps of 16 up to hd 64,
// 8 past it). A split pass writes q, k and v as bf16 planes (f32: hi, mid,
// lo, exact; bf16: the values themselves) into the workspace the op
// allocates; the body is this one carried to three planes, both products
// as six bf16 passes (f32 accuracy), the logits of up to four chunks in
// registers where hd <= 64, two passes over a ring of K and V chunks past
// it. It replaced an FMA body on the CUDA cores (67 TFLOP/s).

#include <atomic>

#include "split_attention.cuh"

namespace vpt {
constexpr int kAttnResidentSeq = 257;  // ViT-H at 224 (16 x 16 patches + CLS)
constexpr int kAttnMaxHD = 128;

namespace b6tc {
constexpr int BOX = 64 * 128;  // one TMA box: 64 rows of 128 bytes (64 bf16)
constexpr float kMasked = -1e30f;
__host__ __device__ constexpr int chunks(int S) { return (S + 63) / 64; }
// K and V boxes of one hd box: every chunk's (resident) or a ring of two
// chunks (streamed)
__host__ __device__ constexpr int kv_slots(int S, bool stream) { return stream ? 2 : chunks(S); }
// Q's boxes, K's and V's, the barriers (Q's, or all; then the two stages')
// and the key flags, at a 1024-byte boundary
inline size_t smem_bytes(int nhb, int S, bool stream) {
  return 1024 + size_t(nhb) * (1 + 2 * kv_slots(S, stream)) * BOX + 3 * sizeof(uint64_t) +
         64 * chunks(S);
}
}  // namespace b6tc

// logits of the 64-key chunk c for this warpgroup's 64 queries: q . k over
// the NHB boxes of hd in steps of 16 (32 bytes a step within a box; the
// zeros past hd too, so that the loop is fixed: with a trip count read at
// run time ptxas serialises the wgmmas), scaled, with the key flags applied
// (1 valid, 2 masked -> -1e30, 0 past S -> -inf). The chunk's K box of hd
// box j is at ka + j * kstride boxes.
template <int NHB>
__device__ __forceinline__ void attention_tc_logits(float (&l)[32], uint32_t qa, uint32_t ka,
                                                    int kstride, const unsigned char* flag, int c,
                                                    float scale) {
  using namespace b6tc;
#pragma unroll
  for (int i = 0; i < 32; ++i) l[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NHB; ++kk) {
    const int j = kk >> 2, off = (kk & 3) * 32;
    wgmma_m64n64k16<0>(l, gmma_desc(qa + j * BOX + off, 16, 1024),
                       gmma_desc(ka + j * kstride * BOX + off, 16, 1024));
  }
  wgmma_commit();
  wgmma_wait<0>();
  const int key0 = c * 64 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int f = flag[key0 + (i >> 2) * 8 + (i & 1)];
    l[i] = f == 1 ? l[i] * scale : f == 2 ? kMasked : -INFINITY;
  }
}

template <int NHB, bool STREAM>
__global__ void __launch_bounds__(128)
attention_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const unsigned char* __restrict__ mask,
                    bf16* __restrict__ out, int H, int S, int hd, float scale) {
  using namespace b6tc;
  extern __shared__ unsigned char asmem[];
  const uint32_t raw = smem_u32(asmem);
  unsigned char* qs = asmem + (((raw + 1023) & ~1023u) - raw);  // [NHB] boxes
  const int nkc = chunks(S);  // key chunks, and query tiles
  const int slots = kv_slots(S, STREAM);
  unsigned char* ks = qs + NHB * BOX;         // [NHB][slots]
  unsigned char* vs = ks + NHB * slots * BOX;  // [NHB][slots]
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + NHB * slots * BOX);  // Q (or all), stage 0, 1
  unsigned char* flag = reinterpret_cast<unsigned char*>(bar + 3);  // [nkc * 64]
  const int bh = blockIdx.x / nkc, qt = blockIdx.x % nkc, b = bh / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(smem_u32(bar + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = tid; j < nkc * 64; j += 128)
    flag[j] = j >= S ? 0 : (mask && !mask[(long)b * S + j]) ? 2 : 1;
  __syncthreads();
  // Streamed steps t = 0 .. 2 nkc - 1: pass 1's K chunk t, then pass 2's K
  // and V chunk t - nkc, into stage t & 1 (barrier 1 + (t & 1), its
  // (t >> 1)-th phase). Thread 0 starts step t + 2 once every thread is
  // done with step t's stage.
  auto load_step = [&](int t) {
    if (t >= 2 * nkc) return;
    const int st = t & 1, c = t < nkc ? t : t - nkc;
    const uint32_t sb = smem_u32(bar + 1 + st);
    mbar_arrive_expect(sb, NHB * (t < nkc ? 1 : 2) * BOX);
    for (int j = 0; j < NHB; ++j) {
      tma_load_3d(smem_u32(ks + (j * 2 + st) * BOX), &tk, sb, j * 64, c * 64, bh);
      if (t >= nkc) tma_load_3d(smem_u32(vs + (j * 2 + st) * BOX), &tv, sb, j * 64, c * 64, bh);
    }
  };
  if (tid == 0) {
    mbar_arrive_expect(smem_u32(bar), NHB * (STREAM ? 1 : 1 + 2 * nkc) * BOX);
    for (int j = 0; j < NHB; ++j) {
      tma_load_3d(smem_u32(qs + j * BOX), &tq, smem_u32(bar), j * 64, qt * 64, bh);
      if (!STREAM)
        for (int c = 0; c < nkc; ++c) {
          tma_load_3d(smem_u32(ks + (j * nkc + c) * BOX), &tk, smem_u32(bar), j * 64, c * 64, bh);
          tma_load_3d(smem_u32(vs + (j * nkc + c) * BOX), &tv, smem_u32(bar), j * 64, c * 64, bh);
        }
    }
    if (STREAM) {
      load_step(0);
      load_step(1);
    }
  }
  mbar_wait(smem_u32(bar), 0);
  const uint32_t qa = smem_u32(qs), ka = smem_u32(ks), va = smem_u32(vs);
  const int kstride = STREAM ? 2 : nkc;  // boxes between two hd boxes of one chunk
  // the K (V) box of hd box 0 for step t's chunk c, once it has arrived
  auto acquire = [&](int t, int c) -> int {
    if (!STREAM) return c;
    mbar_wait(smem_u32(bar + 1 + (t & 1)), (t >> 1) & 1);
    return t & 1;
  };
  auto release = [&](int t) {
    if (STREAM) {
      __syncthreads();  // every warp is done reading step t's stage
      if (tid == 0) load_step(t + 2);
    }
  };

  // pass 1: the max and the sum of each of this thread's two rows (r, r + 8),
  // over the quad of lanes that shares them
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int c = 0; c < nkc; ++c) {
    float l[32];
    const int slot = acquire(c, c);
    attention_tc_logits<NHB>(l, qa, ka + slot * BOX, kstride, flag, c, scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float cm = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == r) cm = fmaxf(cm, l[i]);
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
      const float m = fmaxf(mx[r], cm);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == r) s += expf(l[i] - m);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      sum[r] = sum[r] * expf(mx[r] - m) + s;
      mx[r] = m;
    }
    release(c);
  }

  // pass 2: P = exp(l - max) / sum, split, PV. The quotient is the correctly
  // rounded one that a division gives (Markstein: with rc = RN(1 / sum) and
  // q = RN(e rc), q + RN(e - q sum) rc rounds to RN(e / sum) wherever the
  // quotient is a normal number); __fdiv_rn took 37% of the kernel's time
  // at DeiT-S, this takes a multiply and two FMAs.
  const float rc[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
  float o[NHB][32];
#pragma unroll
  for (int j = 0; j < NHB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  for (int c = 0; c < nkc; ++c) {
    float l[32];
    const int slot = acquire(nkc + c, c);
    attention_tc_logits<NHB>(l, qa, ka + slot * BOX, kstride, flag, c, scale);
    uint32_t planes[3][16];
    split_fragments(l, [&](int i, float v) {
      const int r = (i >> 1) & 1;
      const float e = expf(v - mx[r]), q = e * rc[r];
      return __fmaf_rn(__fmaf_rn(-q, sum[r], e), rc[r], q);
    }, planes);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NHB; ++j) wgmma_split_k64(o[j], planes, va + (j * kstride + slot) * BOX);
    wgmma_commit();
    wgmma_wait<0>();
    release(nkc + c);
  }

  const int row = qt * 64 + warp * 16 + (lane >> 2);
  bf16* ob = out + (long)bh * S * hd;
#pragma unroll
  for (int j = 0; j < NHB; ++j)
#pragma unroll
    for (int p = 0; p < 16; ++p) {  // accumulators 2p, 2p + 1: one row, two columns
      const int r = row + 8 * (p & 1), d = j * 64 + (p >> 1) * 8 + 2 * (lane & 3);
      if (r < S && d < hd)  // hd is even: d + 1 < hd too
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)r * hd + d) =
            __floats2bfloat162_rn(o[j][2 * p], o[j][2 * p + 1]);
    }
}

// TMA can describe q, k and v (16-byte aligned, rows of whole 16 bytes)
inline bool attention_tc_takes(const void* q, const void* k, const void* v, const void* out,
                               int HD) {
  return HD % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
         (reinterpret_cast<uintptr_t>(out) & 3) == 0;
}

template <int NHB, bool STREAM>
cudaError_t attention_tc_launch(const bf16* q, const bf16* k, const bf16* v,
                                const unsigned char* mask, bf16* out, int B, int H, int S, int HD,
                                cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  const uint64_t bh = (uint64_t)B * H;
  VPT_TRY(tma_map_3d_64(&tq, q, HD, S, bh));
  VPT_TRY(tma_map_3d_64(&tk, k, HD, S, bh));
  VPT_TRY(tma_map_3d_64(&tv, v, HD, S, bh));
  auto kernel = attention_tc_kernel<NHB, STREAM>;
  const size_t smem = b6tc::smem_bytes(NHB, S, STREAM);
  VPT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  // 1/sqrt(hd) as the TPU wrappers compute it (in double, then f32)
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  kernel<<<(unsigned)(bh * b6tc::chunks(S)), 128, smem, st>>>(tq, tk, tv, mask, out, H, S, HD,
                                                              scale);
  return cudaGetLastError();
}

std::atomic<long long> g_attention_body_launches[2];  // wgmma body, split body
}  // namespace vpt

using namespace vpt;

extern "C" {

int vpt_attention_max_head_dim() { return kAttnMaxHD; }

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out [B, H, S, HD] contiguous
// in the dtype; mask [B, S] bytes (torch.bool) or null. planes: the split
// body's workspace (16-byte aligned), 3 P B H S hdp bf16 with P = 3 (f32) or
// 1 (bf16) and hdp = HD rounded up to 8; null where the wgmma body takes the
// call (attention_tc_takes, mirrored by ops/cuda/attention.py::body).
int vpt_attention_forward(int dtype, const void* q, const void* k, const void* v, const void* mask,
                          void* out, int B, int H, int S, int HD, void* planes, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || B > 65535 || H < 1 || S < 1 || HD < 1 ||
      HD > kAttnMaxHD)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  cudaError_t rc;
  if (dtype == 1 && attention_tc_takes(q, k, v, out, HD)) {
    const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
    const bool stream = S > kAttnResidentSeq;
#define VPT_B6(NHB, ST) attention_tc_launch<NHB, ST>(qb, kb, vb, mk, (bf16*)out, B, H, S, HD, st)
    if (HD <= 64)
      rc = stream ? VPT_B6(1, true) : VPT_B6(1, false);
    else
      rc = stream ? VPT_B6(2, true) : VPT_B6(2, false);
#undef VPT_B6
    if (rc == cudaSuccess) g_attention_body_launches[0]++;
    return rc;
  }
  const AttnLayout lay{(long)H * S * HD, (long)S * HD, HD};
  bf16* pl = static_cast<bf16*>(planes);
#define VPT_SPLIT(KS, T)                                                                        \
  split_attention<KS, T>((const T*)q, (const T*)k, (const T*)v, lay, mk, nullptr, (T*)out, lay, \
                         B, H, S, HD, true, pl, st)
  if (dtype == 0)
    rc = HD <= 64 ? VPT_SPLIT(4, float) : VPT_SPLIT(8, float);
  else
    rc = HD <= 64 ? VPT_SPLIT(4, bf16) : VPT_SPLIT(8, bf16);
#undef VPT_SPLIT
  if (rc == cudaSuccess) g_attention_body_launches[1]++;
  return rc;
}

// launches of the wgmma body and of the split body since the last reset
void vpt_attention_body_counts(long long* out) {
  out[0] = g_attention_body_launches[0].load();
  out[1] = g_attention_body_launches[1].load();
}

void vpt_attention_body_reset() {
  g_attention_body_launches[0] = 0;
  g_attention_body_launches[1] = 0;
}

}  // extern "C"
