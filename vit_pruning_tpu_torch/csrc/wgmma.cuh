// The bf16 GEMM bodies on Hopper's warpgroup MMA (wgmma) and Tensor Memory
// Accelerator (TMA), sm_90a. gemm.cu runs the persistent body for every bf16
// product of the layer kernels B1, B3 and B5 (with common.cuh's Epilogue),
// embed.cu runs it for B8b's bf16 patches that TMA can describe and the
// per-tile body for B8a and B8b's other patches (with + b + pos[t % N]). At
// the end of the file: the 64-column wgmma shapes (A from shared memory or
// from registers), the exact three-way bf16 split of an f32 operand and a
// 3-D TMA map, which the tensor-core bodies of B6 (attention.cu) and B7
// (mlp.cu) are built from, and the row helpers of the attention bodies (key
// flags, row max, quad sum, the corrected quotient) that layer_attention.cu
// and split_attention.cuh share. B4's int8 products run the s8 body of
// wgmma_s8.cuh, built from this file's barriers, TMA loads and descriptors.
//
//   out[M, N] = epilogue(A[M, K] @ W[K, N])
//
// A is bf16 [M, K] with row stride lda, or B8's patches that TMA cannot
// describe (CpAsyncA, RegA below); W is bf16 [K, N] row-major, as the
// param tree stores it, so it is wgmma's MN-major ("transposed") B operand.
// No copy of W is made. Both bodies read A in [128 rows x 64] boxes and W in
// two [64 k x 64 n] boxes a step of 64 k, with the 128-byte swizzle, into a
// ring of shared-memory stages that complete on mbarriers ("full": the bytes
// the TMA loads bring; "empty": the consumers' warps are done with it).
//
// The persistent body (A described by TMA), wgmma_gemm_persistent:
//   - one block an SM (the ring of 4 stages and the staging rows take 165
//     KB), as many blocks as the card has SMs (or output tiles, if fewer);
//     block b walks the 128 x 128 output tiles b, b + grid, b + 2 grid, ...,
//     in groups of 8 row tiles (rows fastest, so that a W column panel and
//     8 A row panels serve consecutive tiles from L2);
//   - producer warpgroup (setmaxnreg 40): one thread issues the TMA loads of
//     every step of every tile of the block in order, as soon as a stage is
//     free, so the next tile's stages fill while the consumers are still on
//     the last one's products and epilogue;
//   - two consumer warpgroups (setmaxnreg 232) take alternate tiles of the
//     block, each a whole 128 x 128 tile (two m64n128k16 a 16 k, 128
//     accumulators a thread), "ping-pong": a warpgroup starts its tile's
//     products when the other has issued its last ones (an mbarrier a
//     warpgroup, "turn"), then runs its epilogue while the other runs its
//     products. One step's wgmma group stays in flight (a stage goes back
//     when the next step's products are issued), and each tile's first
//     product drops the old accumulators (scale-d 0) instead of zeroing
//     them;
//   - the epilogue: the tile's bias is loaded before its products; its
//     residual rows are brought into L2 then; a warp's 16 rows go through
//     its own staging rows in shared memory, 64 columns at a time (written
//     where wgmma leaves them, read back 8 consecutive columns a lane), the
//     residual of four groups of 8 loaded before the first is finished,
//     and leave by one TMA store a 16 x 64 box where the output's rows are
//     16-byte aligned (else 16-byte stores); the activation is fixed at
//     compile time (one instance each), so that a group's eight
//     activations interleave.
// At DeiT-S's K 384 a tile has 6 steps of products; its epilogue (16,384
// outputs with bias, GELU or residual reads) runs under the other
// warpgroup's products. On an H100 the products of a tile take ~4,000
// cycles, the epilogue 7,000-20,000 (GELU and residual traffic): the
// epilogue still sets the pace at K 384, the products at ViT-H's K 5,120.
//
// The per-tile body (B8's register, image and cp.async producers),
// wgmma_gemm_kernel: one block a 128 x 128 output tile; four (or eight)
// producer warps bring A by cp.async (CpAsyncA) or through registers,
// rounding f32 to bf16 or applying B8a's affine to uint8 (RegA; embed.cu's
// ImageA reads B8a's uint8 straight from the image), into the same
// swizzled layout, while one thread brings W by TMA; two consumer
// warpgroups, 64 rows each, wait for each step's products before handing
// the stage back; each quad of lanes transposes its accumulator pairs by
// shuffles so that a lane holds 8 consecutive outputs of one row, then the
// caller's epilogue runs on them. Their producer warps take the registers
// that the persistent body gives its consumers, so they keep this body.
//
// TMA zero-fills what lies past M, N or K, and the epilogues mask their
// stores (a TMA store drops what lies past M and N), so ragged shapes
// (ViT-H's 8,256 rows, B3's B * cap) need nothing else. TMA needs a 16-byte
// aligned base and row strides that are multiples of 16 bytes: A's lda and
// W's N multiples of 8 elements.
//
// What bounds it on an H100: the layer products at batch 512 (DeiT-S) or 64
// (ViT-H) are above the bf16 ridge (~295 FLOP a byte) or near it (O and fc2
// at DeiT-S's widths write or read f32 rows), so tensor-core issue and the
// epilogue's traffic. wgmma is the only instruction that reaches the card's
// bf16 rate; TMA keeps the loads off the consumers' registers and
// instructions. The tile is 128 x 128, not 128 x 256, so that DeiT-S's N
// 384 wastes no half tile.

#pragma once

#include <cuda.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace vpt {

namespace wgm {
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int A_BYTES = BM * BK * 2;  // 128 rows of 128 bytes
constexpr int B_BOX = BK * 64 * 2;    // one W box: 64 k-rows of 64 columns (128 bytes)
constexpr int B_BYTES = 2 * B_BOX;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int CONSUMERS = 256;  // two warpgroups
template <int STAGES>
constexpr size_t smem_bytes() {  // the ring at a 1024-byte boundary, then the barriers
  return 1024 + size_t(STAGES) * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
}
}  // namespace wgm

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// one arrival that also announces the bytes the TMA loads will bring
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// a 2-D tile at (c0 inner, c1 outer) of the tensor map into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units. K-major A: SBO = 1024
// (the next 8 rows), LBO unused. MN-major W: LBO = the next 64 columns (the
// next TMA box), SBO = 1024 (the next 8 k-rows).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 128] += A[64 x 16] (K-major) @ B[16 x 128] (MN-major: trans-b 1);
// with scale_d 0, d = A @ B (what d held is dropped)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// How A reaches the per-tile body's ring (the persistent body's comes by
// TMA: bf16, lda % 8 == 0, 16-byte aligned; the host encodes the map).

// A uint8 A step (B8a) from a producer thread's raw bytes: rows pt / 4 + 64 i
// of the tile (i = 0, 1), the 16 values of columns k .. k + 15 in raw[i]
// (byte t of the 16 at bits 8 (t % 4) of word t / 4); the affine x * scale +
// shift in f32, each step rounded on its own (no FMA contraction), as the
// TPU kernel's f32 ops, then rounded to bf16 and stored where the 128-byte
// swizzle puts them; zeros past M and K
__device__ __forceinline__ void stage_u8_affine(unsigned char* st, const uint4 (&raw)[2], int pt,
                                                int m0, int k, int M, int K, float scale,
                                                float shift) {
  const int kp = pt & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (pt >> 2) + 64 * i;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw[i]);
    // value i8 of the 16: the byte as 2^23 + byte in f32, less 2^23 (exact,
    // and no integer-to-float conversion, an instruction at an eighth of
    // the FMA rate), then the affine
    auto affine_u8 = [&](int i8) {
      const float x = __fsub_rn(
          __uint_as_float(__byte_perm(w[i8 >> 2], 0x4B000000u, 0x7540u | (i8 & 3))), 8388608.f);
      return __fadd_rn(__fmul_rn(x, scale), shift);
    };
    uint4 u[2];  // two 8-value chunks: 2 kp, 2 kp + 1
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(u);
    if (m0 + row < M && k + 16 <= K) {
#pragma unroll
      for (int t = 0; t < 8; ++t) o[t] = __floats2bfloat162_rn(affine_u8(2 * t), affine_u8(2 * t + 1));
    } else {  // zeros past M and K
      const int n = m0 + row < M ? K - k : 0;
#pragma unroll
      for (int t = 0; t < 8; ++t)
        o[t] = __floats2bfloat162_rn(2 * t < n ? affine_u8(2 * t) : 0.f,
                                     2 * t + 1 < n ? affine_u8(2 * t + 1) : 0.f);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint4*>(st + row * 128 + (((2 * kp + h) ^ (row & 7)) << 4)) = u[h];
  }
}

// through registers (B8b's f32 patches, bf16 rows that are not 8-byte
// multiples, and B8a's uint8 patches): 4 producer warps, rounded to bf16 and
// stored where the 128-byte swizzle puts them; zeros past M and K.
//   f32 / bf16: each thread 8 chunks of 8 k-values a step; wide: f32 rows
//     whose 8-value chunks may be read as two 16-byte loads (lda % 4 == 0,
//     a 16-byte aligned base).
//   uint8 (B8a): 8 producer warps, each thread 2 rows of 16 k-values a
//     step, read with the widest load the rows allow (wide: 16 bytes where lda % 16 == 0 and
//     the base is 16-byte aligned, DeiT-S's K 768; 4 bytes where they are
//     4-byte multiples, ViT-H's K 588; else single bytes), then
//     stage_u8_affine.
// A producer keeps a copy of its loader and calls begin(pt, m0, M) on it
// once before its steps (a no-op but for embed.cu's ImageA, which keeps its
// rows' offsets in the image there), then stage(...) a step.
template <typename Tin>
struct RegA {
  // uint8: 8 warps, so that twice as many warps hide the affine's latency
  static constexpr bool kU8 = std::is_same<Tin, uint8_t>::value;
  static constexpr int PRODUCER_WARPS = kU8 ? 8 : 4;
  const Tin* A;
  long lda;
  int wide;
  float scale = 1.f, shift = 0.f;  // uint8 only

  __device__ __forceinline__ void chunk(const Tin* row, int k, int K, float* v) const {
    if constexpr (std::is_same<Tin, float>::value) {
      if (wide && k + 8 <= K) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(row + k));
        const float4 b = __ldg(reinterpret_cast<const float4*>(row + k + 4));
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
        return;
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = k + t < K ? to_f(row[k + t]) : 0.f;
  }

  // 16 bytes of a uint8 row from k on, zeros past K
  __device__ __forceinline__ uint4 bytes16(const uint8_t* row, int k, int K) const {
    uint4 u = make_uint4(0, 0, 0, 0);
    if (k >= K) return u;
    if (wide == 16) return __ldg(reinterpret_cast<const uint4*>(row + k));  // K % 16 == 0
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
    if (wide == 4) {  // K % 4 == 0: a word is all in or all out
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = k + 4 * i < K ? __ldg(reinterpret_cast<const unsigned int*>(row + k + 4 * i)) : 0u;
      return u;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (k + i < K) w[i >> 2] |= static_cast<uint32_t>(row[k + i]) << (8 * (i & 3));
    return u;
  }

  // 8 producer warps: each thread 2 rows (pt / 4 + 64 i) of 16 k-values
  __device__ __forceinline__ void stage_u8(unsigned char* st, int pt, int m0, int k0, int M,
                                           int K) const {
    const int k = k0 + (pt & 3) * 16;
    uint4 raw[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // every load in flight before the first use
      const int m = m0 + (pt >> 2) + 64 * i;
      raw[i] = m < M ? bytes16(reinterpret_cast<const uint8_t*>(A) + m * lda, k, K)
                     : make_uint4(0, 0, 0, 0);
    }
    stage_u8_affine(st, raw, pt, m0, k, M, K, scale, shift);
  }

  __device__ __forceinline__ void begin(int, int, int) {}

  // the A tile of step k0 into the stage; pt = the producer thread, 0..127
  __device__ __forceinline__ void stage(unsigned char* st, int pt, int m0, int k0, int M,
                                        int K) const {
    if constexpr (std::is_same<Tin, uint8_t>::value) {
      stage_u8(st, pt, m0, k0, M, K);
    } else {
      const int kc = pt & 7, k = k0 + kc * 8;
      float v[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + (pt >> 3) + 16 * i;
        if (m < M && k < K)
          chunk(A + m * lda, k, K, v[i]);
        else
#pragma unroll
          for (int t = 0; t < 8; ++t) v[i][t] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = (pt >> 3) + 16 * i;
        uint4 u;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int t = 0; t < 4; ++t) h[t] = __floats2bfloat162_rn(v[i][2 * t], v[i][2 * t + 1]);
        *reinterpret_cast<uint4*>(st + row * 128 + ((kc ^ (row & 7)) << 4)) = u;
      }
    }
  }
};

// by cp.async (bf16 rows that are 8-byte but not 16-byte multiples: ViT-H's
// K 588, 1,176-byte patch rows): 4 producer warps copy each 16-byte chunk of
// the swizzled tile as two 8-byte cp.async (zero-filled past M and K; K %
// 4 == 0 and an 8-byte aligned base), with no register round trip. A
// thread's copies of step kt form one group; it waits for the group of step
// kt - LAG, makes it visible to wgmma (proxy fence) and arrives on that
// step's full barrier, so LAG steps of copies stay in flight.
struct CpAsyncA {
  static constexpr int PRODUCER_WARPS = 4;
  // fewer than the ring's stages: the wait for a free stage never blocks on
  // a step this thread has not yet arrived for
  static constexpr int LAG = 2;
  const bf16* A;
  long lda;

  __device__ __forceinline__ void begin(int, int, int) {}

  __device__ __forceinline__ void stage(unsigned char* st, int pt, int m0, int k0, int M,
                                        int K) const {
    const int kc = pt & 7, k = k0 + kc * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = (pt >> 3) + 16 * i, m = m0 + row;
      const uint32_t dst = smem_u32(st + row * 128 + ((kc ^ (row & 7)) << 4));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = m < M && k + 4 * h + 4 <= K;
        const bf16* src = ok ? A + m * lda + k + 4 * h : A;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst + 8 * h), "l"(src),
                     "r"(ok ? 8 : 0)
                     : "memory");
      }
    }
  }
};

// The epilogue of a consumer warpgroup's m64n128 accumulators (rows m0w ..
// m0w + 63, columns n0 .. n0 + 127). Accumulator i of a thread: row (warp *
// 16 + lane / 4 + 8 * ((i / 2) % 2)), column (i / 4) * 8 + 2 * (lane % 4) + i
// % 2. For two 8-column blocks j, j + 1 the quad's four lanes hold four (row,
// block) combinations, two columns of each a lane; after the transpose lane q
// holds all 8 columns of combination q: row + 8 * (q & 1), block j + (q >>
// 1). Then epi(m, n, v, M, N) on them.
template <typename Epi>
__device__ __forceinline__ void wgmma_tile_epilogue(const float (&acc)[64], int m0w, int n0,
                                                    const Epi& epi, int M, int N) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int mrow = m0w + warp * 16 + (lane >> 2) + 8 * (q & 1);
#pragma unroll
  for (int j = 0; j < 16; j += 2) {
    float v[8];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int c = q ^ x;  // the combination this lane sends, and the pair it receives
      const float sx = c == 0 ? acc[4 * j] : c == 1 ? acc[4 * j + 2]
                     : c == 2 ? acc[4 * j + 4] : acc[4 * j + 6];
      const float sy = c == 0 ? acc[4 * j + 1] : c == 1 ? acc[4 * j + 3]
                     : c == 2 ? acc[4 * j + 5] : acc[4 * j + 7];
      const float rx = __shfl_xor_sync(0xffffffffu, sx, x);
      const float ry = __shfl_xor_sync(0xffffffffu, sy, x);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (p == c) {
          v[2 * p] = rx;
          v[2 * p + 1] = ry;
        }
    }
    epi(mrow, n0 + (j + (q >> 1)) * 8, v, M, N);
  }
}

// ---------------------------------------------------------------------------
// The kernels. The per-tile body calls epi(m, n, v, M, N) with v the 8
// outputs (m, n..n+7) in f32, n a multiple of 8, for every such group of a
// tile; it masks m >= M and n + t >= N itself. The persistent body, as a
// warpgroup takes tile (m0, n0), calls epi.prefetch(m0, n0, M, N) (what its
// epilogue will read by rows, into L2) and epi.cols(n, c, N) for each of
// the thread's two groups of 8 columns (what the epilogue reads by
// columns, into registers of type Epi::Cols: the bias); then, for each
// group of 8 outputs, epi.fetch(m, n, t, M, N) (what it reads by rows: the
// residual) and, once the fetches of four groups are in flight,
// epi.finish(m, n, v, c, t, M, N) (the rest of the epilogue and the store)
// or, where the body stores by TMA, epi.apply(n, v, c, t) (the rest of the
// epilogue, in place; whole groups of 8 only) and epi.out_f32() (the
// output's type: f32 or bf16).

// The persistent body's geometry. One block an SM: the ring and the staging
// rows take more than half of an SM's shared memory (4 stages measured
// faster than 3 or 5 on an H100). The registers: 40 a producer thread, 232
// a consumer thread (128 accumulators and the epilogue), 64,512 in all.
namespace wgp {
constexpr int STAGES = 4, GROUP_M = 8;
constexpr int THREADS = 384;  // the producer warpgroup, then two consumer warpgroups
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// a consumer warp's staging: its 16 rows of a 64-column quarter in f32, 72
// floats a row so that a quad's 8-byte writes of 4 rows fall in 4 bank
// groups; then, for TMA, the same rows finished in the output's type
constexpr int STAGE_LD = 72, WARP_STAGING = 16 * STAGE_LD * 4;
constexpr size_t SMEM = 1024 + size_t(STAGES) * wgm::STAGE_BYTES + 8 * WARP_STAGING +
                        (2 * STAGES + 2) * sizeof(uint64_t);
constexpr int BLOCKS_PER_SM = 1;
static_assert(SMEM <= 232448 && 2 * SMEM > 232448, "one block an SM");
static_assert(128 * (PRODUCER_REGS + 2 * CONSUMER_REGS) <= 65536, "one SM's registers");
}  // namespace wgp

// The walk: output tile t of tiles_m x tiles_n, in groups of GROUP_M row
// tiles (the last group may have fewer), rows fastest within a group
__host__ __device__ __forceinline__ void wgp_tile(int t, int tiles_m, int tiles_n, int& m0,
                                                  int& n0) {
  const int per_group = wgp::GROUP_M * tiles_n, group = t / per_group;
  const int first = group * wgp::GROUP_M, r = t - group * per_group;
  const int rows = tiles_m - first < wgp::GROUP_M ? tiles_m - first : wgp::GROUP_M;
  m0 = (first + r % rows) * wgm::BM;
  n0 = r / rows * wgm::BN;
}

// the bulk (TMA) stores from shared memory: a 2-D box at (c0 inner, c1
// outer) of the tensor map, the commit of a thread's stores so far, and the
// wait until at most N groups are still reading shared memory (or, with
// bulk_wait, still writing)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Whether an epilogue is a gated one (Epi::kGate): each group of 8 product
// columns gives 4 outputs, at column n / 2 of the output, so that a staged
// 64-column quarter leaves as a [16 x 32] box
template <typename Epi, typename = void>
struct EpiGate : std::false_type {};
template <typename Epi>
struct EpiGate<Epi, std::void_t<decltype(Epi::kGate)>> : std::bool_constant<Epi::kGate> {};

// The persistent body's epilogue of a warpgroup's m64n128 accumulators at
// (m0w, n0), a 64-column quarter at a time through the warp's staging rows:
// a thread's pair p (acc[2 p], acc[2 p + 1], where wgmma leaves them: row
// warp * 16 + lane / 4 + 8 (p % 2), columns 8 (p / 2) + 2 (lane % 4) and the
// next) written as 8 bytes, then read back as 8 consecutive columns a lane,
// 8 lanes a row. A warp reads back the 16 rows it wrote: no barrier but the
// warp's own. With tmO, the finished values go back into the staging rows
// in the output's type and leave as one TMA store of the warp's 16 x 64 box
// (TMA drops what lies past M and N); else each lane stores its 8.
template <typename Epi, typename C>
__device__ __forceinline__ void wgmma_staged_epilogue(const float (&acc)[64], float* stage,
                                                      int m0w, int n0, const C (&c)[2],
                                                      const CUtensorMap* tmO, const Epi& epi,
                                                      int M, int N) {
  const int lane = threadIdx.x & 31;
  const int wr = lane >> 2, wc = 2 * (lane & 3);  // a thread's pairs: rows wr, wr + 8
  const int rr = lane >> 3, rc = 8 * (lane & 7);  // read back: rows rr + 4 i, 8 columns
  const int row0 = m0w + ((threadIdx.x >> 5) & 3) * 16, m = row0 + rr;
  // lanes 4-7 of each 8 read their second 16 bytes first: 8 lanes, 32 banks
  const int sw = (lane >> 2) & 1;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int n = n0 + 64 * q + rc;
    float t[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) epi.fetch(m + 4 * i, n, t[i], M, N);
    if (tmO && lane == 0) bulk_wait_read<0>();  // the last store has read the staging rows
    __syncwarp();  // ... and the last quarter's reads are done
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 2 * (8 * q + jb) + r;
        *reinterpret_cast<float2*>(stage + (wr + 8 * r) * wgp::STAGE_LD + 8 * jb + wc) =
            make_float2(acc[2 * p], acc[2 * p + 1]);
      }
    __syncwarp();
    float v[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* row = stage + (rr + 4 * i) * wgp::STAGE_LD + rc;
      const float4 a = *reinterpret_cast<const float4*>(row + 4 * sw);
      const float4 b = *reinterpret_cast<const float4*>(row + 4 - 4 * sw);
      const float4 lo = sw ? b : a, hi = sw ? a : b;
      v[i][0] = lo.x, v[i][1] = lo.y, v[i][2] = lo.z, v[i][3] = lo.w;
      v[i][4] = hi.x, v[i][5] = hi.y, v[i][6] = hi.z, v[i][7] = hi.w;
    }
    if (!tmO) {
#pragma unroll
      for (int i = 0; i < 4; ++i) epi.finish(m + 4 * i, n, v[i], c[q], t[i], M, N);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) epi.apply(n, v[i], c[q], t[i]);
    __syncwarp();  // every read of the staging rows is done
    unsigned char* out = reinterpret_cast<unsigned char*>(stage);  // [16][64] in the output type
    if constexpr (EpiGate<Epi>::value) {  // [16][32] bf16: 4 outputs a group
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store4(reinterpret_cast<bf16*>(out) + (rr + 4 * i) * 32 + rc / 2, v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (epi.out_f32())
          store8(reinterpret_cast<float*>(out) + (rr + 4 * i) * 64 + rc, v[i]);
        else
          store8(reinterpret_cast<bf16*>(out) + (rr + 4 * i) * 64 + rc, v[i]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
    __syncwarp();
    if (lane == 0 && row0 < M && n0 + 64 * q < N) {  // a box wholly past M or N: nothing
      tma_store_2d(tmO, smem_u32(out), (n0 + 64 * q) / (EpiGate<Epi>::value ? 2 : 1), row0);
      bulk_commit();
    }
  }
}

// Block b walks tiles b, b + grid, ...; its j-th tile goes to consumer
// warpgroup j % 2. Step g of the block (over all its tiles, in order) takes
// stage g % STAGES, so the barriers' phases run on across tiles. A consumer
// waits for its turn before a tile's first step: then the other has waited
// for every step of the tile before, so no stage it waits on can be two
// phases behind.
template <typename Epi>
__global__ void __launch_bounds__(wgp::THREADS, 1)
wgmma_gemm_persistent(const __grid_constant__ CUtensorMap tmA,
                      const __grid_constant__ CUtensorMap tmW,
                      const __grid_constant__ CUtensorMap tmO, int out_tma, const Epi epi, int M,
                      int N, int K) {
  using namespace wgm;
  constexpr int STAGES = wgp::STAGES;
  extern __shared__ unsigned char wsm[];
  const uint32_t raw = smem_u32(wsm);
  unsigned char* ring = wsm + (((raw + 1023) & ~1023u) - raw);  // 128-byte swizzle: 1024-aligned
  float* staging = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES + 8 * wgp::WARP_STAGING);
  uint64_t* empty = full + STAGES;
  uint64_t* turn = empty + STAGES;  // turn[c]: consumer c may issue its next tile's products
  const int tid = threadIdx.x, wg = tid >> 7, b = blockIdx.x, grid = gridDim.x;
  const int nk = (K + BK - 1) / BK;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);   // + the TMA's expected bytes
      mbar_init(smem_u32(empty + s), 4);  // the consuming warpgroup's warps
    }
    mbar_init(smem_u32(turn), 4);  // the other warpgroup's warps
    mbar_init(smem_u32(turn + 1), 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // --- producer ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(wgp::PRODUCER_REGS));
    if (tid == 0) {
      int g = 0;
      for (int t = b; t < tiles; t += grid) {
        int m0, n0;
        wgp_tile(t, tiles_m, tiles_n, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(smem_u32(empty + s), ((g / STAGES) - 1) & 1);
          const uint32_t st = smem_u32(ring + s * STAGE_BYTES), fb = smem_u32(full + s);
          mbar_arrive_expect(fb, STAGE_BYTES);
          tma_load_2d(st, &tmA, fb, kt * BK, m0);
          tma_load_2d(st + A_BYTES, &tmW, fb, n0, kt * BK);
          tma_load_2d(st + A_BYTES + B_BOX, &tmW, fb, n0 + 64, kt * BK);
        }
      }
    }
    return;
  }

  // --- consumers: warpgroup c takes the block's tiles c, c + 2, ... whole ---
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wgp::CONSUMER_REGS));
  const int c = wg - 1, lane = tid & 31;
  float* stage = staging + (tid / 32 - 4) * (wgp::WARP_STAGING / 4);  // this warp's
  float acc[2][64];  // rows 0-63 and 64-127 of the tile
  int turns = 0;
  for (int j = c; b + j * grid < tiles; j += 2) {
    int m0, n0;
    wgp_tile(b + j * grid, tiles_m, tiles_n, m0, n0);
    epi.prefetch(m0, n0, M, N);
    // the bias of the columns this thread's epilogue reads back: n0 + 64 q + 8 (lane % 8)
    typename Epi::Cols cols[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) epi.cols(n0 + 64 * q + 8 * (lane & 7), cols[q], N);
    if (j > 0) mbar_wait(smem_u32(turn + c), turns++ & 1);  // the other's products are issued
    int g = j * nk;
    for (int kt = 0; kt < nk; ++kt, ++g) {
      const int s = g % STAGES;
      mbar_wait(smem_u32(full + s), (g / STAGES) & 1);
      const uint32_t a0 = smem_u32(ring + s * STAGE_BYTES), b0 = a0 + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // 16 k: 32 bytes along A's rows, 2 KB of W
        const uint64_t db = gmma_desc(b0 + kk * 2048, B_BOX, 1024);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_m64n128k16(acc[h], gmma_desc(a0 + h * (64 * 128) + kk * 32, 16, 1024), db,
                           kt > 0 || kk > 0);
      }
      wgmma_commit();
      if (kt > 0) {  // the step before is done: hand its stage back
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(smem_u32(empty + (g - 1) % STAGES));
      }
    }
    if (lane == 0) mbar_arrive(smem_u32(turn + (c ^ 1)));  // the other may issue its products
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(smem_u32(empty + (g - 1) % STAGES));
    const CUtensorMap* to = out_tma ? &tmO : nullptr;
    wgmma_staged_epilogue(acc[0], stage, m0, n0, cols, to, epi, M, N);
    wgmma_staged_epilogue(acc[1], stage, m0 + 64, n0, cols, to, epi, M, N);
  }
  if (out_tma && lane == 0) bulk_wait<0>();  // the last stores have left shared memory
}

// The per-tile body (B8's register, image and cp.async producers): one block a
// 128 x 128 output tile, 4 stages, one block an SM (the 4 or 8 producer
// warps take the registers a second block would need).
namespace wgm {
constexpr int TILE_STAGES = 4;
}
template <typename ALoad, typename Epi>
__global__ void __launch_bounds__(wgm::CONSUMERS + 32 * ALoad::PRODUCER_WARPS, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tmW, const ALoad aload, const Epi epi, int M,
                  int N, int K) {
  using namespace wgm;
  constexpr int STAGES = TILE_STAGES;
  constexpr bool kCpAsync = std::is_same<ALoad, CpAsyncA>::value;
  constexpr int kProducers = 32 * ALoad::PRODUCER_WARPS;
  extern __shared__ unsigned char wsm[];
  const uint32_t raw = smem_u32(wsm);
  unsigned char* ring = wsm + (((raw + 1023) & ~1023u) - raw);  // 128-byte swizzle: 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1 + kProducers);
      mbar_init(smem_u32(empty + s), CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // --- producer ---
    const int pt = tid - CONSUMERS;
    ALoad al = aload;
    al.begin(pt, m0, M);  // what the thread keeps over its steps (B8a's image rows)
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) mbar_wait(smem_u32(empty + s), ((kt / STAGES) - 1) & 1);
      unsigned char* st = ring + s * STAGE_BYTES;
      const uint32_t fb = smem_u32(full + s);
      if (pt == 0) {
        mbar_arrive_expect(fb, B_BYTES);
        tma_load_2d(smem_u32(st + A_BYTES), &tmW, fb, n0, kt * BK);
        tma_load_2d(smem_u32(st + A_BYTES + B_BOX), &tmW, fb, n0 + 64, kt * BK);
      }
      al.stage(st, pt, m0, kt * BK, M, K);
      if constexpr (kCpAsync) {
        cp_async_commit();
        if (kt >= CpAsyncA::LAG) {
          cp_async_wait<CpAsyncA::LAG>();  // step kt - LAG's copies have landed
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(smem_u32(full + (kt - CpAsyncA::LAG) % STAGES));
        }
      } else {
        // the generic-proxy stores become visible to wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(fb);
      }
    }
    if constexpr (kCpAsync) {  // the last LAG steps
      cp_async_wait<0>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int kt = nk > CpAsyncA::LAG ? nk - CpAsyncA::LAG : 0; kt < nk; ++kt)
        mbar_arrive(smem_u32(full + kt % STAGES));
    }
    return;
  }

  // --- consumers: warpgroup wg takes rows wg * 64 .. + 63 of the tile ---
  const int wg = tid >> 7, lane = tid & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_u32(full + s), (kt / STAGES) & 1);
    const uint32_t a0 = smem_u32(ring + s * STAGE_BYTES) + wg * (64 * 128);
    const uint32_t b0 = smem_u32(ring + s * STAGE_BYTES + A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // 16 k: 32 bytes along A's rows, 16 rows (2 KB) of W
      wgmma_m64n128k16(acc, gmma_desc(a0 + kk * 32, 16, 1024),
                       gmma_desc(b0 + kk * 2048, B_BOX, 1024));
    wgmma_commit();
    // this step's products are done: hand its stage back
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(smem_u32(empty + s));
  }

  wgmma_tile_epilogue(acc, m0 + wg * 64, n0, epi, M, N);
}

// ---------------------------------------------------------------------------
// Host side.

// A row-major matrix [outer, inner] (row stride row_bytes) of bf16 (or of
// `type`: B4's int8 codes) as a TMA map with box [box_outer, box_inner] and
// the 128-byte swizzle. Encoding costs host time on every launch, so the
// maps are kept per host thread, keyed by everything they encode (a map
// holds no data, only this).
inline cudaError_t tma_map_2d(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
                              uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
                              CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  struct Entry {
    const void* base;
    uint64_t inner, outer, row_bytes;
    uint32_t box_inner, box_outer;
    CUtensorMapDataType type;
    CUtensorMapSwizzle swizzle;
    CUtensorMap map;
  };
  constexpr int kEntries = 64;
  thread_local Entry cache[kEntries] = {};
  thread_local int next = 0;
  for (int i = 0; i < kEntries; ++i) {
    const Entry& c = cache[i];
    if (c.base == base && c.inner == inner && c.outer == outer && c.row_bytes == row_bytes &&
        c.box_inner == box_inner && c.box_outer == box_outer && c.type == type &&
        c.swizzle == swizzle) {
      *map = c.map;
      return cudaSuccess;
    }
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds: zeros
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  Entry& e = cache[next];
  next = (next + 1) % kEntries;
  e = Entry{base, inner, outer, row_bytes, box_inner, box_outer, type, swizzle, *map};
  return cudaSuccess;
}

// W [K, N] bf16 as the body's B operand: 64 x 64 boxes
inline cudaError_t tma_map_w(CUtensorMap* map, const bf16* W, int N, int K) {
  return tma_map_2d(map, W, N, K, static_cast<uint64_t>(N) * 2, 64, wgm::BK);
}
// A [M, K] bf16, row stride lda: 128 x 64 boxes
inline cudaError_t tma_map_a(CUtensorMap* map, const bf16* A, long lda, int M, int K) {
  return tma_map_2d(map, A, K, M, static_cast<uint64_t>(lda) * 2, wgm::BK, wgm::BM);
}

// out [M, N] (row stride ldc, el bytes a value: bf16 or f32), as the
// persistent body's epilogue stores it: [16 rows x box] boxes (64 columns;
// the gated epilogue's 32), no swizzle
inline cudaError_t tma_map_out(CUtensorMap* map, const void* out, long ldc, int M, int N, int el,
                               uint32_t box = 64) {
  return tma_map_2d(map, out, N, M, static_cast<uint64_t>(ldc) * el, box, 16,
                    el == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

// TMA can describe A and W: 16-byte aligned bases, rows of whole 16 bytes
inline bool wgmma_takes(const bf16* A, long lda, const bf16* W, int N, int K) {
  return aligned16(A) && aligned16(W) && lda % 8 == 0 && N % 8 == 0 && K % 8 == 0;
}

// The SMs of the current device, queried once a device
inline int device_sms() {
  constexpr int kDevices = 64;
  static std::atomic<int> sms[kDevices];
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kDevices) return 0;
  if ((n = sms[dev].load()) > 0) return n;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  sms[dev] = n;
  return n;
}

// The persistent body's walk of an [M, N] output: its 128 x 128 tiles and
// the blocks that walk them, as many as the card holds resident or as there
// are tiles, whichever is fewer
struct Walk {
  int tiles, blocks;
};
inline Walk wgmma_walk(int M, int N) {
  const int tiles = ((M + wgm::BM - 1) / wgm::BM) * ((N + wgm::BN - 1) / wgm::BN);
  const int resident = device_sms() * wgp::BLOCKS_PER_SM;
  return Walk{tiles, tiles < resident ? tiles : resident};
}

// The layer products and B8b's bf16 patches (A described by TMA): the
// persistent body, one launch; the epilogue stores by TMA through tmO, or
// value by value where tmO is null; its walk into *walk if asked.
template <typename Epi>
cudaError_t wgmma_gemm(const CUtensorMap& tmA, const CUtensorMap& tmW, const CUtensorMap* tmO,
                       const Epi& epi, int M, int N, int K, cudaStream_t st,
                       Walk* walk = nullptr) {
  auto kernel = wgmma_gemm_persistent<Epi>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wgp::SMEM);
  if (attr != cudaSuccess) return attr;
  const Walk w = wgmma_walk(M, N);
  if (w.blocks < 1) return cudaErrorInvalidDevice;
  kernel<<<w.blocks, wgp::THREADS, wgp::SMEM, st>>>(tmA, tmW, tmO ? *tmO : tmW, tmO != nullptr,
                                                     epi, M, N, K);
  if (walk) *walk = w;
  return cudaGetLastError();
}

// B8's cp.async and register producers: the per-tile body
template <typename ALoad, typename Epi>
cudaError_t wgmma_gemm_per_tile(const CUtensorMap& tmW, const ALoad& aload, const Epi& epi, int M,
                                int N, int K, cudaStream_t st) {
  constexpr size_t smem = wgm::smem_bytes<wgm::TILE_STAGES>();
  auto kernel = wgmma_gemm_kernel<ALoad, Epi>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + wgm::BN - 1) / wgm::BN, (M + wgm::BM - 1) / wgm::BM);
  kernel<<<grid, wgm::CONSUMERS + 32 * ALoad::PRODUCER_WARPS, smem, st>>>(tmW, aload, epi, M, N,
                                                                           K);
  return cudaGetLastError();
}

// The 64-column products of kernels B6 and B7 (attention.cu, mlp.cu).
// d[64 x 64] += A[64 x 16] @ B[16 x 64], A K-major in shared memory; B
// K-major (TB 0: B6's K rows) or MN-major (TB 1: B7's W1 and W2) in shared
// memory
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}
// d[64 x 192] += A[64 x 16] (K-major) @ B[16 x 192] (MN-major, three
// 64-column boxes LBO apart): kernel B7's second product, A from its planes
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}
// the same with A from registers, in the accumulator's layout (the four
// 32-bit registers of bf16 pairs that mma.sync's m16n8k16 A fragment has,
// warp w holding rows 16 w ..): B MN-major (B6's V)
__device__ __forceinline__ void wgmma_m64n64k16_ra(float (&d)[32], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// An unrounded f32 value a as hi + mid + lo, three bf16 values whose sum is
// a exactly (for finite |a| above ~2^-110, where lo is still a normal bf16
// number): hi = bf16(a), mid = bf16(a - hi), lo = a - hi - mid. Each
// residual is one f32 subtraction, exact, with nothing to contract into an
// FMA; lo then has at most 8 significant bits. Each bf16 x bf16 product is
// exact in f32, so three bf16 tensor-core passes compute an f32 product of
// a bf16 operand and an f32 one up to the order of the sums. A NaN stays a
// NaN in hi; an infinite hi leaves mid = lo = 0, so a * w stays what the
// plain f32 product gives.
__device__ __forceinline__ void split_bf16x3(float a, float& hi, float& mid, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(a));
  const float r1 = isinf(hi) ? 0.f : __fsub_rn(a, hi);
  mid = __bfloat162float(__float2bfloat16_rn(r1));
  lo = __fsub_rn(r1, mid);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo_col, float hi_col) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// B6: the 32 accumulators of an m64n64 product, each passed through f(i, v)
// and split, as the A fragments of a product whose 64-deep k runs over
// those 64 columns. Accumulator i of a thread is row warp * 16 + lane / 4 +
// 8 * ((i / 2) % 2), column (i / 4) * 8 + 2 * (lane % 4) + i % 2, which is
// the A fragment's layout: the pair (2 p, 2 p + 1) is register p of a
// plane, and k-slice s (columns 16 s ..) is registers 4 s .. 4 s + 3.
// plane[0] holds hi, [1] mid, [2] lo.
template <typename F>
__device__ __forceinline__ void split_fragments(const float (&acc)[32], F f,
                                                uint32_t (&plane)[3][16]) {
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    float h0, m0, l0, h1, m1, l1;
    split_bf16x3(f(2 * p, acc[2 * p]), h0, m0, l0);
    split_bf16x3(f(2 * p + 1, acc[2 * p + 1]), h1, m1, l1);
    plane[0][p] = pack_bf16x2(h0, h1);
    plane[1][p] = pack_bf16x2(m0, m1);
    plane[2][p] = pack_bf16x2(l0, l1);
  }
}

// B6: acc += (lo + mid + hi) @ B over one 64-deep k block: B MN-major at
// shared address b (64 k-rows of 128 bytes, 128-byte swizzle), the small
// planes first
__device__ __forceinline__ void wgmma_split_k64(float (&acc)[32], const uint32_t (&plane)[3][16],
                                                uint32_t b) {
#pragma unroll
  for (int pl = 2; pl >= 0; --pl)
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_m64n64k16_ra(acc, plane[pl][4 * s], plane[pl][4 * s + 1], plane[pl][4 * s + 2],
                         plane[pl][4 * s + 3], gmma_desc(b + s * 2048, 8192, 1024));
}

// a 3-D tile at (c0 inner, c1, c2 outer) of the tensor map into shared memory
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A contiguous bf16 tensor [outer, mid, inner] as a TMA map with boxes of
// [1, box_mid, 64] and the 128-byte swizzle (zeros past every edge); not
// cached
inline cudaError_t tma_map_3d_64(CUtensorMap* map, const void* base, uint64_t inner, uint64_t mid,
                                 uint64_t outer, uint32_t box_mid = 64) {
  const cuuint64_t dims[3] = {inner, mid, outer};
  const cuuint64_t strides[2] = {inner * 2, inner * mid * 2};
  const cuuint32_t box[3] = {64, box_mid, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// What the attention bodies on m64n64 accumulators share (layer_attention.cu's
// bf16 body, split_attention.cuh's f32 one): accumulator i of a thread is row
// warp * 16 + lane / 4 + 8 ((i / 2) % 2) of the 64-query tile, key c * 64 +
// (i / 4) * 8 + 2 (lane % 4) + i % 2 of chunk c; a row's 64 keys lie in the
// four lanes of a quad.
constexpr float kMaskedLogit = -1e30f;  // masked-key logit, as the TPU kernels

// scaled logits of chunk c with the key flags applied (1 valid, 2 masked ->
// -1e30, 0 past S -> -inf)
__device__ __forceinline__ void attn_flags(float (&l)[32], const unsigned char* flag, int c,
                                           float scale) {
  const int key0 = c * 64 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int f = flag[key0 + (i >> 2) * 8 + (i & 1)];
    l[i] = f == 1 ? l[i] * scale : f == 2 ? kMaskedLogit : -INFINITY;
  }
}

// the max of row r (0: lane / 4, 1: lane / 4 + 8) of l over the quad
__device__ __forceinline__ float attn_rowmax(const float (&l)[32], int r) {
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (((i >> 1) & 1) == r) m = fmaxf(m, l[i]);
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
}

__device__ __forceinline__ float quad_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

// Markstein's correctly rounded e / sum from rc = RN(1 / sum): with q =
// RN(e rc), q + RN(e - q sum) rc rounds to RN(e / sum) wherever the
// quotient is a normal number (an IEEE division took 37% of B6's time)
__device__ __forceinline__ float attn_div(float e, float sum, float rc) {
  const float q = e * rc;
  return __fmaf_rn(__fmaf_rn(-q, sum, e), rc, q);
}

}  // namespace vpt
