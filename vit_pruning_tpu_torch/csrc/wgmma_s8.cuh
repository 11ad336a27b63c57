// The int8 GEMM body of kernel B4 (layer_int8.cu) on Hopper's warpgroup MMA
// (wgmma, s8 x s8 -> s32) and TMA, sm_90a, built from wgmma.cuh's
// barriers, TMA loads and shared-memory descriptors.
//
//   out[M, N] = epilogue(A[M, K] @ W[K, N]), int32 sums
//
// 8-bit wgmma takes both operands K-major only, so W comes as its
// transpose Wt [N, K] (row-major, built once per forward by the wrapper's
// caller: ops/quant.py::kmajor_int8_weights) and A as int8 codes [M, K]
// (row stride lda), both by TMA. A stage holds a K step of 128: one
// 128-byte swizzled row of the A tile and of the W tile is 128 k-values,
// the bytes of the bf16 body's 64, so the ring, the TMA maps and the full /
// empty mbarriers are the bf16 body's with four m64n128k32 wgmmas a step.
//
// One block computes a [128, 128] output tile with two consumer warpgroups
// of 64 rows, two blocks an SM. There is no producer warp: one consumer
// thread issues the TMA loads (the first STAGES steps up front, then each
// freed stage's refill once every consumer warp has released it), so the
// block is 8 warps and two blocks an SM keep 128 registers a thread, where
// a ninth warp would cut every thread to 96 and spill the epilogue. The
// epilogue transposes the accumulators by shuffles as the bf16 body does
// and hands the caller's epilogue 8 consecutive int32 sums of one row, so
// that its stores are 16 bytes a lane. Measured against it (B4's whole
// layer on the card, DeiT-S batch 512, kernel_variants.py): persistent
// blocks that load the next tile during an epilogue were no faster;
// storing the 2 neighbouring sums the accumulator layout gives a lane,
// without the shuffles, made the layer 1.4 times slower; staging the tile
// in shared memory for whole-row stores, 1.13 times.
//
// What bounds it on an H100: B4's four products at batch 512 (DeiT-S) or
// 64 (ViT-H) are far above the int8 ridge (~590 operations a byte), so by
// operations tensor-core issue at 1,979 TOP/s dense, twice the bf16 rate;
// wgmma is the instruction that reaches it. DeiT-S's K 384 is only 3 steps,
// so a block's first loads and its epilogue (dequant, bias, GELU, residual,
// cast) weigh as much as its products: two blocks share each SM (3 stages
// of 32 KB, 2 x 97 KB of shared memory), so that one block's epilogue
// overlaps the other's products. Measured with stages taken out
// (kernel_variants.py), the epilogues and their stores bound the layer's
// products, not the wgmmas. TMA zero-fills past M, N and K; the epilogue
// masks its stores (ragged M: ViT-H's 16,448 rows, B * cap in the re-decide
// path). Needs K and lda multiples of 16 and 16-byte aligned bases.

#pragma once

#include "wgmma.cuh"

namespace vpt {

namespace w8 {
constexpr int BM = 128, BN = 128, BK = 128;  // a stage row: 128 int8 k-values, 128 bytes
constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK, STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int THREADS = 256, STAGES = 3;  // two consumer warpgroups
constexpr size_t SMEM = 1024 + size_t(STAGES) * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
}  // namespace w8

// d[64 x 128] += A[64 x 32] @ B[32 x 128], both s8 and K-major in shared
// memory (128-byte swizzle), s32 sums exact in any order
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// The kernel. Epi is called as epi(m, n, v, M, N) with v the 8 sums (m,
// n..n+7), n a multiple of 8, for every such group of the thread's row; it
// masks m >= M and n + t >= N itself.

template <typename Epi>
__global__ void __launch_bounds__(w8::THREADS, 2)
wgmma_s8_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW,
                const Epi epi, int M, int N, int K) {
  using namespace w8;
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
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), THREADS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step kt's A and W boxes into stage kt % STAGES (thread 0)
  auto issue = [&](int kt) {
    const int s = kt % STAGES;
    unsigned char* st = ring + s * STAGE_BYTES;
    const uint32_t fb = smem_u32(full + s);
    mbar_arrive_expect(fb, STAGE_BYTES);
    tma_load_2d(smem_u32(st), &tmA, fb, kt * BK, m0);
    tma_load_2d(smem_u32(st + A_BYTES), &tmW, fb, kt * BK, n0);
  };
  if (tid == 0)
    for (int kt = 0; kt < nk && kt < STAGES; ++kt) issue(kt);

  // warpgroup wg takes rows wg * 64 .. + 63 of the tile
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_u32(full + s), (kt / STAGES) & 1);
    const uint32_t a0 = smem_u32(ring + s * STAGE_BYTES) + wg * (64 * 128);
    const uint32_t b0 = smem_u32(ring + s * STAGE_BYTES + A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)  // 32 k: 32 bytes along the rows of A and of Wt
      wgmma_m64n128k32_s8(acc, gmma_desc(a0 + kk * 32, 16, 1024), gmma_desc(b0 + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();  // as the bf16 body: hand the stage back once its products are done
    if (lane == 0) mbar_arrive(smem_u32(empty + s));
    if (tid == 0 && kt + STAGES < nk) {  // refill the stage once every warp is done with it
      mbar_wait(smem_u32(empty + s), (kt / STAGES) & 1);
      issue(kt + STAGES);
    }
    __syncwarp();
  }

  // the accumulator layout and the quad transpose of wgmma.cuh's epilogue
  const int q = lane & 3;
  const int mrow = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * (q & 1);
#pragma unroll
  for (int j = 0; j < 16; j += 2) {
    int v[8];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int c = q ^ x;  // the combination this lane sends, and the pair it receives
      const int sx = c == 0 ? acc[4 * j] : c == 1 ? acc[4 * j + 2]
                   : c == 2 ? acc[4 * j + 4] : acc[4 * j + 6];
      const int sy = c == 0 ? acc[4 * j + 1] : c == 1 ? acc[4 * j + 3]
                   : c == 2 ? acc[4 * j + 5] : acc[4 * j + 7];
      const int rx = __shfl_xor_sync(0xffffffffu, sx, x);
      const int ry = __shfl_xor_sync(0xffffffffu, sy, x);
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

// int8 [outer, inner] (row stride row_bytes, a multiple of 16) as a TMA map
// with 128-byte swizzled boxes [128, 128]
inline cudaError_t tma_map_s8(CUtensorMap* map, const signed char* base, int inner, int outer,
                              long row_bytes) {
  return tma_map_2d(map, base, inner, outer, static_cast<uint64_t>(row_bytes), w8::BK, 128,
                    CU_TENSOR_MAP_DATA_TYPE_UINT8);
}

// out = epi(A codes [M, K] (row stride lda) @ Wt [N, K]^T)
template <typename Epi>
cudaError_t wgmma_s8(const signed char* A, long lda, const signed char* Wt, const Epi& epi, int M,
                     int N, int K, cudaStream_t st) {
  CUtensorMap ta, tw;
  VPT_TRY(tma_map_s8(&ta, A, K, M, lda));
  VPT_TRY(tma_map_s8(&tw, Wt, K, N, K));
  auto kernel = wgmma_s8_kernel<Epi>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)w8::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + w8::BN - 1) / w8::BN, (M + w8::BM - 1) / w8::BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, w8::THREADS, w8::SMEM, st>>>(ta, tw, epi, M, N, K);
  return cudaGetLastError();
}

}  // namespace vpt
