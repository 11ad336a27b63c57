// The bf16 GEMM body on Hopper's warpgroup MMA (wgmma) and Tensor Memory
// Accelerator (TMA), sm_90a. gemm.cu runs it for every bf16 product of the
// layer kernels B1, B2, B3 and B5 (with common.cuh's Epilogue), embed.cu for
// B8a and B8b (with + b + pos[t % N]). At the end of the file: the 64-column
// wgmma shapes (A from shared memory or from registers), the exact three-way
// bf16 split of an f32 operand and a 3-D TMA map, which the tensor-core
// bodies of B6 (attention.cu) and B7 (mlp.cu) are built from. B4's int8
// products run the s8 body of wgmma_s8.cuh, built from this file's
// barriers, TMA loads and descriptors.
//
//   out[M, N] = epilogue(A[M, K] @ W[K, N])
//
// A is bf16 [M, K] with row stride lda, or B8's patches that TMA cannot
// describe (CpAsyncA, RegA below); W is bf16 [K, N] row-major, as the
// param tree stores it, so it is wgmma's MN-major ("transposed") B operand.
// No copy of W is made.
//
// One block computes a 128 x 128 output tile, K in steps of 64:
//   - producer: one warp issues TMA loads of the A tile [128 rows x 64] and
//     two W boxes [64 k x 64 n] per step into a ring of shared-memory
//     stages, with the 128-byte swizzle, completing on an mbarrier ("full")
//     with the bytes it expects; or four warps bring A by cp.async
//     (CpAsyncA) or through registers, rounding f32 to bf16 or applying
//     B8a's affine to uint8 (RegA), into the same swizzled layout, while one
//     thread still brings W by TMA;
//   - consumers: two warpgroups, 64 rows each, run wgmma.mma_async
//     m64n128k16 on the stage that has arrived (four per step), f32
//     accumulators in registers (64 a thread), wait for them and hand the
//     stage back to the producer ("empty"), whose loads run stages ahead;
//   - epilogue: each quad of lanes transposes its accumulator pairs by
//     shuffles so that a lane holds 8 consecutive outputs of one row, then
//     the caller's epilogue runs on them (16-byte stores where it can).
// TMA zero-fills what lies past M, N or K, and the epilogue masks its
// stores, so ragged shapes (ViT-H's 16,448 rows, B2's M = B, B3's B * cap)
// need nothing else. TMA needs a 16-byte aligned base and row strides that
// are multiples of 16 bytes: A's lda and W's N multiples of 8 elements.
//
// What bounds it on an H100: the layer products at batch 512 (DeiT-S) or 64
// (ViT-H) are far above the bf16 ridge (~295 FLOP a byte), so tensor-core
// issue. wgmma is the only instruction that reaches the card's bf16 rate;
// TMA keeps the loads off the consumers' registers and instructions. The
// tile is 128 x 128, not 128 x 256, so that DeiT-S's N 384 wastes no half
// tile; the ring has 3 stages so that two blocks fit an SM (2 x 99 KB of
// shared memory, at most 112 registers a thread) and one block's epilogue
// overlaps the other's products. The block is not persistent: a block's
// prologue (the first loads) and epilogue are exposed where the other block
// of its SM does not cover them.

#pragma once

#include <cuda.h>
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

// d[64 x 128] += A[64 x 16] (K-major) @ B[16 x 128] (MN-major: trans-b 1)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// How A reaches the ring.

// by TMA: bf16, lda % 8 == 0, 16-byte aligned (the host encodes the map)
struct TmaA {};

// through registers (B8b's f32 patches, bf16 rows that are not 8-byte
// multiples, and B8a's uint8 patches): 4 producer warps, rounded to bf16 and
// stored where the 128-byte swizzle puts them; zeros past M and K.
//   f32 / bf16: each thread 8 chunks of 8 k-values a step; wide: f32 rows
//     whose 8-value chunks may be read as two 16-byte loads (lda % 4 == 0,
//     a 16-byte aligned base).
//   uint8 (B8a): 8 producer warps, each thread 2 rows of 16 k-values a
//     step, read with the widest load the rows allow (wide: 16 bytes where lda % 16 == 0 and
//     the base is 16-byte aligned, DeiT-S's K 768; 4 bytes where they are
//     4-byte multiples, ViT-H's K 588; else single bytes), then the affine
//     x * scale + shift in f32, each step rounded on its own (no FMA
//     contraction), as the TPU kernel's f32 ops, then rounded to bf16.
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
    const int kp = pt & 3, k = k0 + kp * 16;
    uint4 raw[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // every load in flight before the first use
      const int m = m0 + (pt >> 2) + 64 * i;
      raw[i] = m < M ? bytes16(reinterpret_cast<const uint8_t*>(A) + m * lda, k, K)
                     : make_uint4(0, 0, 0, 0);
    }
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

template <typename ALoad>
struct ProducerWarps {
  static constexpr int value = ALoad::PRODUCER_WARPS;
};
template <>
struct ProducerWarps<TmaA> {
  static constexpr int value = 1;
};

// ---------------------------------------------------------------------------
// The kernel. Epi is called as epi(m, n, v, M, N) with v the 8 outputs
// (m, n..n+7) in f32, n a multiple of 8, for every such group of the tile;
// it masks m >= M and n + t >= N itself.

template <int MINB, int STAGES, typename ALoad, typename Epi>
__global__ void __launch_bounds__(wgm::CONSUMERS + 32 * ProducerWarps<ALoad>::value, MINB)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW,
                  const ALoad aload, const Epi epi, int M, int N, int K) {
  using namespace wgm;
  constexpr bool kTmaA = std::is_same<ALoad, TmaA>::value;
  constexpr int kProducers = 32 * ProducerWarps<ALoad>::value;
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
      mbar_init(smem_u32(full + s), kTmaA ? 1 : 1 + kProducers);
      mbar_init(smem_u32(empty + s), CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // --- producer ---
    const int pt = tid - CONSUMERS;
    if (kTmaA && pt != 0) return;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) mbar_wait(smem_u32(empty + s), ((kt / STAGES) - 1) & 1);
      unsigned char* st = ring + s * STAGE_BYTES;
      const uint32_t fb = smem_u32(full + s);
      if (pt == 0) {
        mbar_arrive_expect(fb, kTmaA ? STAGE_BYTES : B_BYTES);
        if constexpr (kTmaA) tma_load_2d(smem_u32(st), &tmA, fb, kt * BK, m0);
        tma_load_2d(smem_u32(st + A_BYTES), &tmW, fb, n0, kt * BK);
        tma_load_2d(smem_u32(st + A_BYTES + B_BOX), &tmW, fb, n0 + 64, kt * BK);
      }
      if constexpr (std::is_same<ALoad, CpAsyncA>::value) {
        aload.stage(st, pt, m0, kt * BK, M, K);
        cp_async_commit();
        if (kt >= CpAsyncA::LAG) {
          cp_async_wait<CpAsyncA::LAG>();  // step kt - LAG's copies have landed
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(smem_u32(full + (kt - CpAsyncA::LAG) % STAGES));
        }
      } else if constexpr (!kTmaA) {
        aload.stage(st, pt, m0, kt * BK, M, K);
        // the generic-proxy stores become visible to wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(fb);
      }
    }
    if constexpr (std::is_same<ALoad, CpAsyncA>::value) {  // the last LAG steps
      cp_async_wait<0>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int kt = nk > CpAsyncA::LAG ? nk - CpAsyncA::LAG : 0; kt < nk; ++kt)
        mbar_arrive(smem_u32(full + kt % STAGES));
    }
    return;
  }

  // --- consumers: warpgroup wg takes rows wg * 64 .. + 63 of the tile ---
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
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
    // this step's products are done: hand its stage back. With one step's
    // group kept in flight instead, ptxas serialises the wgmmas (its warning
    // C7514) and the products ran up to 8% slower on an H100.
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(smem_u32(empty + s));
  }

  // Accumulator i of a thread: row (warp * 16 + lane / 4 + 8 * ((i / 2) % 2)),
  // column (i / 4) * 8 + 2 * (lane % 4) + i % 2. For two 8-column blocks j,
  // j + 1 the quad's four lanes hold four (row, block) combinations, two
  // columns of each a lane; after the transpose lane q holds all 8 columns
  // of combination q: row + 8 * (q & 1), block j + (q >> 1).
  const int q = lane & 3;
  const int mrow = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * (q & 1);
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
// Host side.

// A row-major matrix [outer, inner] (row stride row_bytes) of bf16 (or of
// `type`: B4's int8 codes) as a TMA map with box [box_outer, box_inner] and
// the 128-byte swizzle. Encoding costs host time on every launch, so the
// maps are kept per host thread, keyed by everything they encode (a map
// holds no data, only this).
inline cudaError_t tma_map_2d(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
                              uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
                              CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  struct Entry {
    const void* base;
    uint64_t inner, outer, row_bytes;
    uint32_t box_inner, box_outer;
    CUtensorMapDataType type;
    CUtensorMap map;
  };
  constexpr int kEntries = 64;
  thread_local Entry cache[kEntries] = {};
  thread_local int next = 0;
  for (int i = 0; i < kEntries; ++i) {
    const Entry& c = cache[i];
    if (c.base == base && c.inner == inner && c.outer == outer && c.row_bytes == row_bytes &&
        c.box_inner == box_inner && c.box_outer == box_outer && c.type == type) {
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
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds: zeros
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  Entry& e = cache[next];
  next = (next + 1) % kEntries;
  e = Entry{base, inner, outer, row_bytes, box_inner, box_outer, type, *map};
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

// TMA can describe A and W: 16-byte aligned bases, rows of whole 16 bytes
inline bool wgmma_takes(const bf16* A, long lda, const bf16* W, int N, int K) {
  return aligned16(A) && aligned16(W) && lda % 8 == 0 && N % 8 == 0 && K % 8 == 0;
}

// Layer products (TmaA): 3 stages, two blocks an SM. B8's cp.async and
// register producers: 4 stages, one block an SM (their 4 or 8 producer
// warps take the registers a second block would need).
template <typename ALoad, typename Epi>
cudaError_t wgmma_gemm(const CUtensorMap& tmA, const CUtensorMap& tmW, const ALoad& aload,
                       const Epi& epi, int M, int N, int K, cudaStream_t st) {
  constexpr bool kTmaA = std::is_same<ALoad, TmaA>::value;
  constexpr int MINB = kTmaA ? 2 : 1, STAGES = kTmaA ? 3 : 4;
  constexpr size_t smem = wgm::smem_bytes<STAGES>();
  auto kernel = wgmma_gemm_kernel<MINB, STAGES, ALoad, Epi>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + wgm::BN - 1) / wgm::BN, (M + wgm::BM - 1) / wgm::BM);
  kernel<<<grid, wgm::CONSUMERS + 32 * ProducerWarps<ALoad>::value, smem, st>>>(tmA, tmW, aload,
                                                                                 epi, M, N, K);
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
// [1, 64, 64] and the 128-byte swizzle (zeros past every edge); not cached
inline cudaError_t tma_map_3d_64(CUtensorMap* map, const void* base, uint64_t inner, uint64_t mid,
                                 uint64_t outer) {
  const cuuint64_t dims[3] = {inner, mid, outer};
  const cuuint64_t strides[2] = {inner * 2, inner * mid * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace vpt
