// Kernels B8a and B8b: the fused patch embedding (sm_90a).
//
//   vpt_patch_embed_forward  replaces vit_pruning_tpu/ops/pallas/embed.py
//                            ::fused_patch_embed_u8 (B8a: uint8 patches,
//                            the image normalisation folded in) and
//                            ::fused_patch_embed_f (B8b: float patches);
//                            with patch > 0, B8a on the image itself: the
//                            port's served embed (serving.py::embed_from_u8
//                            on the card), which the TPU package left to XLA
//
// out[t, :] = round_w((A[t, :] as f32) * scale + shift) @ W + b + pos[t % N],
// cast once to W's dtype. A is the patch matrix [T = B*N, K = C*P*P] (uint8,
// float32 or bfloat16), W [K, D] and b [D] in W's dtype (float32 or
// bfloat16), pos [N, D] in W's dtype or float32. B8a's scale is
// 1/(255 std) and its shift -mean/std (computed in double by the caller,
// then f32); B8b's are 1 and 0. In the TPU kernel's order: the affine is a
// multiply, then an add, each rounded (__fmul_rn / __fadd_rn: no FMA
// contraction), the result is rounded to W's dtype, the product accumulates
// in f32, then + b and + pos in f32 and one cast. The TPU wrapper fed pos as
// broadcast [B*N, D] rows; here the epilogue reads row t % N of pos [N, D]:
// the same function with B times fewer bytes.
//
// What bounds it on an H100: 2 T K D operations against T K bytes of uint8
// patches (4 T K of float) + T D output values. At DeiT-S width (K 768,
// D 384) that is ~250 operations per byte in bf16, just under the ridge
// (~295), so the bound is the tensor cores' and the memory's alike; at
// ViT-H's (K 588, D 1280) it is operations. With f32 weights the product is
// six bf16 passes (164.8 TFLOP/s of f32 work): operations at both widths.
//
// bf16 weights (B8a and B8b): wgmma.cuh's wgmma + TMA body, one tiled
// product whose A producer applies the affine (B8a) and the rounding to
// bf16, so no normalised copy of the patches reaches device memory, and
// whose epilogue adds b and the position row in f32 and casts once, so the
// output is written once. The A producer is chosen by the patches' type and
// shape:
//   - uint8 (B8a): through the producer warps' registers (RegA<uint8_t>),
//     each row read 16 bytes at a time where the rows allow (DeiT-S's K
//     768), 4 bytes at a time where they are 4-byte multiples (ViT-H's K
//     588: 588-byte rows), else byte by byte; the affine in f32, rounded to
//     bf16, into the swizzled ring. The A operand that reaches the tensor
//     cores is the one the TPU kernel builds, bit for bit.
//   - bf16 whose rows TMA can describe (K % 8 == 0, 16-byte aligned:
//     DeiT-S's K 768): by TMA straight into the swizzled ring, on the
//     persistent body that the layer products run;
//   - bf16 rows that are 8-byte but not 16-byte multiples (ViT-H's K 588:
//     1,176 bytes): by 8-byte cp.async into the same layout;
//   - f32 patches (and bf16 rows of any other width): through the producer
//     warps' registers, rounded to bf16 there.
// The last three keep the per-tile body: their 4 or 8 producer warps need
// the registers that the persistent body gives its consumers.
// B8b has no affine to fold (scale 1, shift 0 are the identity). The K tail
// is zero filled in each.
//
// f32 weights (both): split6.cuh's split body, one launch (after the split
// of W into its bf16 planes), full f32 accuracy (no TF32). Its A source
// (AffineSplitA) reads the patches in their type (uint8: 8, 4 or 1 bytes at
// a time by the rows' width; bf16: 16, 8 or 2; f32: 32 or 4), applies the
// affine as above (round_w is the identity), zeros past K, and splits the
// f32 values into their three bf16 planes, so the A that reaches the
// products is the TPU kernel's bit for bit; the epilogue adds b and the
// position row in f32. The caller gives the planes' workspace (3 K D bf16).
//
// W, b, pos and out rows are read and written 8 values at a time: D % 8 ==
// 0 and 16-byte aligned pointers, checked by the wrapper. Each launch is
// counted per body (vpt_embed_body_counts).
//
// The image input (the served embed): B8a's producers read the uint8 image
// [B, C, H, W] where the patch matrix's values lie in it (ImagePix: a patch
// row's kw runs are P consecutive bytes of an image row; 16-byte loads at P
// 16, 2-byte at P 14, else single bytes), so neither the patch matrix nor a
// normalised copy of the image reaches device memory; the affine and the
// rounding are the patch matrix's, so the A that reaches the tensor cores
// is too, bit for bit. The epilogue writes each patch row in place in its
// image's sequence [CLS, R registers, N patches], and the thread that writes
// an image's first patch writes its CLS row (cls + pos[0] in f32, one cast)
// and register rows at the same columns: one launch, no concatenation. The
// TPU package took its kernel off its serving path because the patch
// shuffle in front of it went through HBM (5.44 against 1.07 ms for XLA's
// fused conv on v5e); here the shuffle is in the kernel's addressing. f32
// weights: the split body with the same addressing (ImageSplitA, byte by
// byte).

#include <atomic>

#include "common.cuh"
#include "split6.cuh"

namespace vpt {

// (x * scale) + shift, each step rounded on its own, as the TPU kernel's f32 ops
__device__ __forceinline__ float affine(float x, float scale, float shift) {
  return __fadd_rn(__fmul_rn(x, scale), shift);
}

// 8 consecutive position values, pos in f32 or bf16
__device__ __forceinline__ void load_pos8(const void* pos, int pos_f32, long i, float* v) {
  if (pos_f32)
    load8(static_cast<const float*>(pos) + i, v);
  else
    load8(static_cast<const bf16*>(pos) + i, v);
}

// 8 values of a patch row from k on as f32, zeros past K: the widest loads
// the rows allow (wide: the bytes of one aligned load, 0 for single values)
__device__ __forceinline__ void load8_in(const float* row, int k, int K, int wide, float (&v)[8]) {
  load8_f32(row, k, K, wide != 0, v);
}
__device__ __forceinline__ void load8_in(const bf16* row, int k, int K, int wide, float (&v)[8]) {
  if (wide == 16 && k + 8 <= K) {  // K % 8 == 0, 16-byte aligned
    load8(row + k, v);
    return;
  }
  if (wide == 8) {  // K % 4 == 0: four values are all in or all out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint2 u = make_uint2(0, 0);
      if (k + 4 * h < K) u = __ldg(reinterpret_cast<const uint2*>(row + k + 4 * h));
      const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float2 f = __bfloat1622float2(b[t]);
        v[4 * h + 2 * t] = f.x;
        v[4 * h + 2 * t + 1] = f.y;
      }
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = k + t < K ? __bfloat162float(row[k + t]) : 0.f;
}
__device__ __forceinline__ void load8_in(const uint8_t* row, int k, int K, int wide,
                                         float (&v)[8]) {
  uint32_t w[2] = {0u, 0u};
  if (wide == 8 && k + 8 <= K) {  // K % 8 == 0, 8-byte aligned
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + k));
    w[0] = u.x;
    w[1] = u.y;
  } else if (wide == 4) {  // K % 4 == 0: a word is all in or all out
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (k + 4 * h < K) w[h] = __ldg(reinterpret_cast<const unsigned int*>(row + k + 4 * h));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (k + i < K) w[i >> 2] |= static_cast<uint32_t>(row[k + i]) << (8 * (i & 3));
  }
  // each byte as 2^23 + byte in f32, less 2^23: exact, and no integer-to-float
  // conversion (an instruction at an eighth of the FMA rate)
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = __fsub_rn(__uint_as_float(__byte_perm(w[i >> 2], 0x4B000000u, 0x7540u | (i & 3))),
                     8388608.f);
}

// B8's A on the split body (f32 weights): the patches [M, K] (Tin, row-major)
// through the affine, zeros past M and K, split as SplitA splits; wide as
// load8_in takes it
template <typename Tin>
struct AffineSplitA {
  const Tin* A;
  int M, K, wide;
  float scale, shift;
  __device__ __forceinline__ void load(float (&a)[2][8], int pt, int m0, int k0) const {
    const int k = k0 + (pt & 3) * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + (pt >> 2) + 64 * i;
      if (m < M && k < K) {
        load8_in(A + (long)m * K, k, K, wide, a[i]);
#pragma unroll
        for (int t = 0; t < 8; ++t) a[i][t] = k + t < K ? affine(a[i][t], scale, shift) : 0.f;
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) a[i][t] = 0.f;
      }
    }
  }
  __device__ __forceinline__ void store(unsigned char* st, const float (&a)[2][8], int pt) const {
    store_split_share(st, a, pt);
  }
};

// B8a's A read from the image (the served embed): pixels [B, C, H, W] uint8,
// row m = (b, gh, gw) of the N = (H / P) (W / P) patches an image, column k =
// (c, kh, kw) of K = C P P, at pixels[b, c, gh P + kh, gw P + kw]: the patch
// matrix extract_patches builds, read where it lies in the image. Each kw
// run is P consecutive bytes of an image row; a load takes G of them, G
// dividing P, the width and the base's alignment, so that no load straddles
// two runs: 16 at P 16 (DeiT-S), 2 at P 14 (ViT-H, DINOv2: 14-byte runs on
// 2-byte boundaries), else 1.
template <int PK>  // P at compile time (16, 14), or 0: P at run time
struct ImagePix {
  static constexpr int G = PK == 16 ? 16 : PK == 14 ? 2 : 1;
  const uint8_t* img;
  int p, grid_w, n, width, plane, image;  // P, W / P, N, W, H W, C H W

  __device__ __forceinline__ int P() const { return PK ? PK : p; }
  // the offset of row m's column 0
  __device__ __forceinline__ long row(int m) const {
    const int b = m / n, t = m - b * n, gh = t / grid_w, gw = t - gh * grid_w;
    return (long)b * image + ((long)gh * width + gw) * P();
  }
  // the offsets from a row's column 0 of the groups of G columns from k on
  // (k % G == 0): the walk along kw, kh, c
  template <int NG>
  __device__ __forceinline__ void columns(int k, int (&off)[NG]) const {
    const int pp = P() * P(), c = k / pp, r = k - c * pp;
    int kh = r / P(), kw = r - kh * P(), o = c * plane + kh * width + kw;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      off[j] = o;
      kw += G;
      o += G;
      if (kw == P()) {
        kw = 0;
        o += width - P();
        if (++kh == P()) {
          kh = 0;
          o += plane - P() * width;
        }
      }
    }
  }
  // NV values of the row at offset r from column k on, at the offsets
  // columns() gave, into words (value t at bits 8 (t % 4) of word t / 4);
  // zeros past K (K % G == 0: a group is all in or all out)
  template <int NV>
  __device__ __forceinline__ void load(long r, int k, int K, const int (&off)[NV / G],
                                       uint32_t (&w)[NV / 4]) const {
    static_assert(NV % G == 0 && NV % 4 == 0, "whole groups, whole words");
#pragma unroll
    for (int i = 0; i < NV / 4; ++i) w[i] = 0u;
    const uint8_t* src = img + r;
#pragma unroll
    for (int j = 0; j < NV / G; ++j) {
      if (k + G * j >= K) continue;
      const uint8_t* q = src + off[j];
      if constexpr (G == 16) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(q));
        w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
      } else if constexpr (G == 2) {
        w[j >> 1] |= static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(q)))
                     << (16 * (j & 1));
      } else {
        w[j >> 2] |= static_cast<uint32_t>(__ldg(q)) << (8 * (j & 3));
      }
    }
  }
};

// B8a's A on the wgmma per-tile body from the image: RegA<uint8_t>'s thread
// layout (8 producer warps, each thread 2 rows of 16 columns a step) and its
// affine (stage_u8_affine), so the A that reaches the tensor cores is the
// patch matrix's bit for bit. begin() finds the thread's two rows in the
// image once; a step computes its columns' offsets once for both rows.
template <int PK>
struct ImageA {
  static constexpr int PRODUCER_WARPS = 8;
  static constexpr int NG = 16 / ImagePix<PK>::G;
  ImagePix<PK> px;
  float scale, shift;
  long rows[2];  // the thread's rows' offsets, -1 past M

  __device__ __forceinline__ void begin(int pt, int m0, int M) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + (pt >> 2) + 64 * i;
      rows[i] = m < M ? px.row(m) : -1;
    }
  }
  __device__ __forceinline__ void stage(unsigned char* st, int pt, int m0, int k0, int M,
                                        int K) const {
    const int k = k0 + (pt & 3) * 16;
    uint4 raw[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
    if (k < K) {
      int off[NG];
      px.columns(k, off);
#pragma unroll
      for (int i = 0; i < 2; ++i)  // every load in flight before the first use
        if (rows[i] >= 0) px.template load<16>(rows[i], k, K, off, reinterpret_cast<uint32_t(&)[4]>(raw[i]));
    }
    stage_u8_affine(st, raw, pt, m0, k, M, K, scale, shift);
  }
};

// B8a's A on the split body (f32 weights) from the image: AffineSplitA's
// values, read byte by byte through ImagePix
struct ImageSplitA {
  ImagePix<0> px;
  int M, K;
  float scale, shift;
  __device__ __forceinline__ void load(float (&a)[2][8], int pt, int m0, int k0) const {
    const int k = k0 + (pt & 3) * 8;
    int off[8];
    if (k < K) px.columns(k, off);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + (pt >> 2) + 64 * i;
      uint32_t w[2] = {0u, 0u};
      if (m < M && k < K) px.load<8>(px.row(m), k, K, off, w);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float x = __fsub_rn(
            __uint_as_float(__byte_perm(w[t >> 2], 0x4B000000u, 0x7540u | (t & 3))), 8388608.f);
        a[i][t] = m < M && k + t < K ? affine(x, scale, shift) : 0.f;
      }
    }
  }
  __device__ __forceinline__ void store(unsigned char* st, const float (&a)[2][8], int pt) const {
    store_split_share(st, a, pt);
  }
};

// B8's epilogue, out in T (bf16 on the wgmma body, f32 on the split body): +
// b (T), + pos[m % N] (f32 or bf16) in f32, one cast. D % 8 == 0: the 8
// columns are all in or all out. With seq > 0 (the image input) out holds
// each image's whole sequence of seq = 1 + R + N rows, and patch row m goes
// to row 1 + R + m % N of image m / N; the thread that writes an image's
// patch 0 also writes, at the same 8 columns, its CLS row (cls + pos0 in
// f32, one cast) and its R register rows (reg cast, no position).
template <typename T>
struct EmbedEpi {
  const T* bias;
  const void* pos;
  int pos_f32, tokens;  // pos rows: tokens = N patches an image
  T* out;
  int seq = 0;                 // 0: out [T, D], the patch rows alone
  const void* cls = nullptr;   // [D], pos's type
  const void* pos0 = nullptr;  // the CLS row's position [D], pos's type
  const T* reg = nullptr;      // [R, D], R = seq - 1 - tokens
  using Cols = Raw8<T>;
  __device__ __forceinline__ void operator()(int m, int n, float* v, int M, int D) const {
    Raw8<T> b{};
    float t[8];
    cols(n, b, D);
    fetch(m, n, t, M, D);
    finish(m, n, v, b, t, M, D);
  }
  // the persistent wgmma body's steps (LayerEpi's): b, the position row,
  // then the sums and the store
  __device__ __forceinline__ void cols(int n, Raw8<T>& b, int D) const {
    if (n < D) b = load_raw8(bias + n);
  }
  __device__ __forceinline__ void fetch(int m, int n, float* t, int M, int D) const {
    if (m < M && n < D) load_pos8(pos, pos_f32, (long)(m % tokens) * D + n, t);
  }
  __device__ __forceinline__ void finish(int m, int n, float* v, const Raw8<T>& b, const float* t,
                                         int M, int D) const {
    if (m >= M || n >= D) return;
    apply(n, v, b, t);
    long row = m;
    if (seq) {
      const int image = m / tokens, p = m - image * tokens;
      row = (long)image * seq + (seq - tokens) + p;
      if (p == 0) prefix((long)image * seq, n, D);
    }
    store8(out + row * D + n, v);
  }
  // an image's CLS and register rows from row `first` on, columns n .. n + 7
  __device__ __forceinline__ void prefix(long first, int n, int D) const {
    float c[8], q[8];
    load_pos8(cls, pos_f32, n, c);
    load_pos8(pos0, pos_f32, n, q);
#pragma unroll
    for (int u = 0; u < 8; ++u) c[u] += q[u];
    store8(out + first * D + n, c);
    for (int r = 1; r < seq - tokens; ++r) {
      load8(reg + (long)(r - 1) * D + n, c);
      store8(out + (first + r) * D + n, c);
    }
  }
  __device__ __forceinline__ void apply(int, float* v, const Raw8<T>& b, const float* t) const {
    float c[8];
    load8(reinterpret_cast<const T*>(&b), c);
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] += c[u];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] += t[u];
  }
  __device__ __forceinline__ bool out_f32() const { return false; }
  __device__ __forceinline__ void prefetch(int, int, int, int) const {}  // pos stays in L2
};

// f32 weights: the split body, W's planes in `planes` (3 K D bf16). pos is
// f32 (the entry point's rule for f32 weights).
template <typename Tin>
cudaError_t embed_split(const Tin* A, const float* W, const float* b, const float* pos, float* out,
                        int T, int N, int K, int D, float scale, float shift, bf16* planes,
                        cudaStream_t st) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(A);
  int wide = 0;  // the widest load the rows allow: 8 values, or 4, in one access
  if constexpr (std::is_same<Tin, float>::value)
    wide = K % 4 == 0 && a % 16 == 0 ? 16 : 0;
  else if (K % 8 == 0 && a % (8 * sizeof(Tin)) == 0)
    wide = 8 * sizeof(Tin);
  else if (K % 4 == 0 && a % (4 * sizeof(Tin)) == 0)
    wide = 4 * sizeof(Tin);
  return split6_gemm(AffineSplitA<Tin>{A, T, K, wide, scale, shift}, W, D,
                     EmbedEpi<float>{b, pos, 1, N, out}, planes, st);
}

template <typename Tin>
cudaError_t embed_wgmma(const Tin* A, const bf16* W, const bf16* b, const void* pos, int pos_f32,
                        bf16* out, int T, int N, int K, int D, float scale, float shift,
                        cudaStream_t st) {
  CUtensorMap tw;
  VPT_TRY(tma_map_w(&tw, W, D, K));
  const EmbedEpi<bf16> epi{b, pos, pos_f32, N, out};
  if constexpr (std::is_same<Tin, uint8_t>::value) {  // B8a
    const uintptr_t a = reinterpret_cast<uintptr_t>(A);
    const int wide = K % 16 == 0 && a % 16 == 0 ? 16 : K % 4 == 0 && a % 4 == 0 ? 4 : 1;
    return wgmma_gemm_per_tile(tw, RegA<uint8_t>{A, K, wide, scale, shift}, epi, T, D, K, st);
  } else if constexpr (std::is_same<Tin, bf16>::value) {  // B8b: scale 1, shift 0
    if (aligned16(A) && K % 8 == 0) {
      CUtensorMap ta, to;
      VPT_TRY(tma_map_a(&ta, A, K, T, K));
      VPT_TRY(tma_map_out(&to, out, D, T, D, 2));
      return wgmma_gemm(ta, tw, &to, epi, T, D, K, st);
    }
    if ((reinterpret_cast<uintptr_t>(A) & 7) == 0 && K % 4 == 0)
      return wgmma_gemm_per_tile(tw, CpAsyncA{A, K}, epi, T, D, K, st);
    return wgmma_gemm_per_tile(tw, RegA<bf16>{A, K, 0}, epi, T, D, K, st);
  } else {
    const int wide = K % 4 == 0 && aligned16(A);  // two 16-byte loads a chunk
    return wgmma_gemm_per_tile(tw, RegA<float>{A, K, wide}, epi, T, D, K, st);
  }
}

// launches per body: 0 wgmma (bf16 weights), 1 split (f32 weights)
std::atomic<long long> g_embed_launches[2];

template <typename Tin>
cudaError_t patch_embed(int w_dtype, const Tin* A, const void* W, const void* b, const void* pos,
                        int pos_f32, void* out, int T, int N, int K, int D, float scale,
                        float shift, bf16* wplanes, cudaStream_t st) {
  if (w_dtype == 1)
    VPT_TRY(embed_wgmma<Tin>(A, (const bf16*)W, (const bf16*)b, pos, pos_f32, (bf16*)out, T, N, K,
                             D, scale, shift, st));
  else
    VPT_TRY(embed_split<Tin>(A, (const float*)W, (const float*)b, (const float*)pos, (float*)out, T,
                             N, K, D, scale, shift, wplanes, st));
  g_embed_launches[w_dtype == 1 ? 0 : 1]++;
  return cudaSuccess;
}

// The image input (B8a reading [B, C, H, W] uint8; patch P > 0): the whole
// sequence [B, 1 + R + N, D] in one launch. pos [1 + N, D]: row 0 the CLS
// row's, rows 1.. the patches'.
template <int PK>
cudaError_t image_wgmma(const CUtensorMap& tw, const ImagePix<0>& g, float scale, float shift,
                        const EmbedEpi<bf16>& epi, int T, int D, int K, cudaStream_t st) {
  const ImagePix<PK> px{g.img, g.p, g.grid_w, g.n, g.width, g.plane, g.image};
  return wgmma_gemm_per_tile(tw, ImageA<PK>{px, scale, shift, {-1, -1}}, epi, T, D, K, st);
}

cudaError_t image_embed(int w_dtype, const uint8_t* img, const void* W, const void* b,
                        const void* pos, int pos_f32, void* out, int T, int N, int K, int D,
                        float scale, float shift, bf16* wplanes, int P, int width, const void* cls,
                        const void* reg, int R, cudaStream_t st) {
  const int grid_w = width / P, plane = N / grid_w * P * width;
  const ImagePix<0> px{img, P, grid_w, N, width, plane, K / (P * P) * plane};
  const int seq = 1 + R + N;
  if (w_dtype == 1) {
    CUtensorMap tw;
    VPT_TRY(tma_map_w(&tw, static_cast<const bf16*>(W), D, K));
    const void* patch_pos = pos_f32 ? static_cast<const void*>(static_cast<const float*>(pos) + D)
                                    : static_cast<const void*>(static_cast<const bf16*>(pos) + D);
    const EmbedEpi<bf16> epi{static_cast<const bf16*>(b), patch_pos, pos_f32, N,
                             static_cast<bf16*>(out), seq, cls, pos, static_cast<const bf16*>(reg)};
    const uintptr_t a = reinterpret_cast<uintptr_t>(img);
    if (P == 16 && a % 16 == 0) VPT_TRY(image_wgmma<16>(tw, px, scale, shift, epi, T, D, K, st));
    else if (P == 14 && a % 2 == 0) VPT_TRY(image_wgmma<14>(tw, px, scale, shift, epi, T, D, K, st));
    else VPT_TRY(image_wgmma<0>(tw, px, scale, shift, epi, T, D, K, st));
  } else {
    const float* pf = static_cast<const float*>(pos);
    VPT_TRY(split6_gemm(ImageSplitA{px, T, K, scale, shift}, static_cast<const float*>(W), D,
                        EmbedEpi<float>{static_cast<const float*>(b), pf + D, 1, N,
                                        static_cast<float*>(out), seq, cls, pf,
                                        static_cast<const float*>(reg)},
                        wplanes, st));
  }
  g_embed_launches[w_dtype == 1 ? 0 : 1]++;
  return cudaSuccess;
}

}  // namespace vpt

using namespace vpt;

extern "C" {

// in_dtype: 0 = float32, 1 = bfloat16, 2 = uint8 (patches [T, K], row-major,
// any alignment). w_dtype: 0 = float32, 1 = bfloat16 (W [K, D], b [D], out
// [T, D]). pos [N, D] in W's dtype, or float32 with pos_f32 = 1 (always for
// float32 weights). T a multiple of N (B images of N patches); D % 8 == 0;
// W, b, pos and out 16-byte aligned. wplanes: float32 weights only, a bf16
// workspace of 3 K D values, 16-byte aligned, for W's planes (null for
// bfloat16 weights).
// patch > 0: the image input (uint8 alone). `patches` is then the image
// [B, C, H, W] (any alignment), width its W, P = patch, with N = (H / P)
// (W / P) and K = C P P; out [B, 1 + R + N, D]; pos [1 + N, D] (row 0 the
// CLS row's); cls [D] in pos's type; registers [R, D] in W's type (R =
// num_registers, null where R is 0), 16-byte aligned. patch 0: the patch
// matrix, as above (cls and registers unused).
int vpt_patch_embed_forward(int in_dtype, int w_dtype, int pos_f32, const void* patches,
                            const void* w, const void* b, const void* pos, void* out, int T, int N,
                            int K, int D, float scale, float shift, void* wplanes, int patch,
                            int width, const void* cls, const void* registers, int num_registers,
                            void* stream) {
  // the grid's second dimension: either body's row tiles
  const int bm = w_dtype == 1 ? wgm::BM : f3::BM;
  const long grid_y = (T + bm - 1) / bm;
  if (in_dtype < 0 || in_dtype > 2 || (w_dtype != 0 && w_dtype != 1) || (pos_f32 != 0 && pos_f32 != 1) ||
      (w_dtype == 0 && (!pos_f32 || !wplanes)) || T < 1 || N < 1 || T % N || K < 1 || D < 8 ||
      D % 8 || grid_y > 65535 || patch < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* planes = static_cast<bf16*>(wplanes);
  if (patch > 0) {
    if (in_dtype != 2 || width < patch || width % patch || K % (patch * patch) ||
        N % (width / patch) || num_registers < 0 || !cls || (num_registers > 0 && !registers))
      return cudaErrorInvalidValue;
    return image_embed(w_dtype, static_cast<const uint8_t*>(patches), w, b, pos, pos_f32, out, T,
                       N, K, D, scale, shift, planes, patch, width, cls, registers, num_registers,
                       st);
  }
  switch (in_dtype) {
    case 0:
      return patch_embed<float>(w_dtype, (const float*)patches, w, b, pos, pos_f32, out, T, N, K, D,
                                scale, shift, planes, st);
    case 1:
      return patch_embed<bf16>(w_dtype, (const bf16*)patches, w, b, pos, pos_f32, out, T, N, K, D,
                               scale, shift, planes, st);
    default:
      return patch_embed<uint8_t>(w_dtype, (const uint8_t*)patches, w, b, pos, pos_f32, out, T, N,
                                  K, D, scale, shift, planes, st);
  }
}

// launches of the wgmma body and of the split body since the last reset
void vpt_embed_body_counts(long long* out) {
  out[0] = g_embed_launches[0].load();
  out[1] = g_embed_launches[1].load();
}

void vpt_embed_body_reset() {
  g_embed_launches[0] = 0;
  g_embed_launches[1] = 0;
}

}  // extern "C"
