// Kernel B2 (sm_90a): the last layer for the CLS row, the final LayerNorm and
// the classifier, x [B, S, D] -> logits [B, labels].
//
//   vpt_vit_cls_logits_forward  replaces vit_pruning_tpu/ops/pallas/layer.py
//                               ::fused_vit_layer_cls_logits (its body is
//                               _cls_head_kernel)
//
// What it computes, with the TPU kernel's rounding points: h1 = LN1(x) in f32
// over the true width DN, rounded to x's dtype; K and V of every token and q
// of the CLS row from h1 (f32 products + bias, rounded to x's dtype); the CLS
// logits q.k in f32 times 1/sqrt(hd); the softmax over all S keys, normalised
// and then rounded to x's dtype before any P V (no online rescaling); ctx =
// P V in f32, rounded once for the O product; x1 = x_cls + ctx Wo + bo in f32;
// LN2; fc1 + GELU (tanh in bf16, erf in f32); x2 = x1 + m1 W2 + b2 in f32;
// LN_f; the classifier.
//
// What bounds it on an H100: the K/V product over every token is almost all
// of the operations (DeiT-S, S 99, batch 512: 2 B S D 2KW = 30 GFLOP) and x
// and the weights are its bytes, so the least time is that product at the
// bf16 peak (~0.03 ms; in float32 six bf16 passes, split6.cuh). Everything
// else works on the B CLS rows. Both dtypes keep K and V out of device
// memory (a first design wrote them there and read them back with one
// 32-thread block per (head, image) on the CUDA cores, in ten launches).
//
// bfloat16: three launches.
//   1. cls_ln1_stats: LN1's row statistics (mean, 1/sqrt(var + eps), as
//      layer.cu's layer_norm takes them) of every token into [B*S] f32 pairs,
//      a warp a row with the row in registers. A launch of its own: every head
//      group's block of launch 2 would otherwise redo each row's full-width
//      reduction, H / (heads a block) times over (6 at DeiT-S, 16 at ViT-H).
//   2. cls_kv_attention: persistent, one block an SM walking over items: one
//      image (two where S <= 64, one a warpgroup) of one group of heads (64 /
//      hd up to hd 64, one at hd 80). A TMA producer warp brings each
//      warpgroup's 64-row x box (a 3-D map over [B, S, D]: zeros past S and
//      B), its 64 rows of launch 1's statistics (a bulk copy) and the group's
//      K and V column boxes of kv.w [D, 2KW] (and, in an item's first pass,
//      q.w's) into a ring of as many stages as shared memory holds (up to
//      six), running ahead into the next item. Each consumer warpgroup applies
//      LN1 to its box in place (bf16 in the 128-byte swizzle wgmma reads; the
//      next box while this step's products run) and runs wgmma against K|V
//      (n128; hd 80: K and V each n80) and, where it holds the CLS row, q.w:
//      q comes from row 0. K and V never reach device memory: in the epilogue
//      K's rows (+ bias, rounded) are dotted with q in registers into the CLS
//      logits (a quad shuffle), kept in shared memory until the softmax is
//      complete. V's rows (+ bias, rounded) stay in the accumulators when the
//      image is one pass (S <= 128), else in shared memory while [tiles x 64
//      rows] x (64 or 80) bf16 fit in kVResident bytes, else a second sweep
//      over the tiles recomputes them; P V is taken from the registers (a
//      shuffle reduction over each column's rows, per-warp partials summed in
//      a fixed order) or from shared memory. The softmax runs over all S
//      logits (one warp a head), P is rounded to bf16, ctx = P V in f32 is
//      rounded into ctx [B, KW].
//   3. cls_tail: O + residual, LN2, fc1 + GELU, fc2 + residual, LN_f and the
//      classifier on the B rows, in one launch. A cluster of C blocks (8, or
//      16 where the batch is at most two 64-row tiles) shares one 64-row tile
//      of the rows; each block takes a share of every product's 128-column
//      tiles (wgmma m64n128k16, A and W by TMA through a six-stage ring) and
//      of the rows' LayerNorms, with cluster barriers between the phases.
//      Every output value is computed by one block in a fixed order: no
//      atomics, the same bits on every call (the serving export relies on it).
// float32: four launches, the bf16 design on split6.cuh's arithmetic (every
// f32 operand of a product split exactly into hi + mid + lo bf16 planes, six
// wgmma passes a 32-deep k-step, small terms first, each step's sum added to
// a running f32 sum in registers: f32 accuracy on the tensor cores).
//   1. cls_split_planes: the six f32 weights (q, kv, o, fc1, fc2, the
//      classifier) into their planes in the caller's workspace, one launch.
//   2. cls_ln1_stats, as bf16's, on f32 x.
//   3. cls_kv_attention_f32: persistent, the bf16 launch's items. Eight
//      producer warps read each step's x rows [128 x 32] in f32 straight from
//      device memory (the next step's loads in flight), apply LN1 from launch
//      1's statistics and split them into the stage's A planes (split6.cuh's
//      layout); one of their threads brings W's planes by TMA. Two sweeps an
//      item: K (and, in the pass that holds the CLS row, q) whose epilogue dots
//      K + bias with q into the logits in shared memory, then the softmax (P =
//      e / sum, correctly rounded), then V, whose epilogue adds P V into
//      per-warp partials summed in a fixed order. V is recomputed by its own
//      sweep at every length: the two sweeps together do the work of one K|V
//      product (each an n64 or n80 product where bf16's is n128 or two n80),
//      while keeping V (its f32 rows in registers or shared memory) would need
//      the registers or the ring that the split takes. K and V never reach
//      device memory; ctx [B, KW] is written as its three planes, the tail's A
//      operand.
//   4. cls_tail_f32: bf16's tail with split products: A's planes (ctx, LN2's
//      and LN_f's outputs, the GELU output: each written as planes by the
//      phase before) and W's by TMA, 64-deep stages of two 32-deep steps, two
//      consumer warpgroups (one a 64-column half of each tile); erf GELU; the
//      logits in f32. A product with fewer 128-column tiles than the cluster
//      has blocks splits its k-boxes over them (O, fc2, the classifier at
//      DeiT-S); the ranges' partial sums go through device memory and are
//      added in a fixed order after a cluster barrier: the same bits on every
//      call.
// Each launch is counted by kind (vpt_cls_logits_launch_counts), and
// vpt_cls_logits_plan gives the kinds a call launches (mirrored by
// ops/cuda/layer.py::cls_logits_launches).

#include <algorithm>
#include <atomic>
#include <initializer_list>

#include "common.cuh"
#include "split6.cuh"
#include "wgmma.cuh"

namespace vpt {

namespace cls {
constexpr int BOX = 64 * 128;  // 64 rows of 64 bf16 (128 bytes): one TMA box, 8 KB
constexpr size_t kMaxSmem = 232448;
// the launch kinds, in the counters' order (ops/cuda/layer.py::CLS_LAUNCH_KINDS)
enum Kind {
  LN1_STATS = 0,
  KV_V_REGISTERS = 1,
  KV_V_SHARED = 2,
  KV_V_RECOMPUTED = 3,
  TAIL = 4,
  F32_SPLIT_PLANES = 5,
  F32_KV_K_THEN_V = 6,
  F32_TAIL = 7,
  KINDS = 8
};
// where launch 2 keeps V: the accumulators (one pass), shared memory, or a
// second sweep that recomputes it
enum VMode { V_REGISTERS = 0, V_SHARED = 1, V_RECOMPUTED = 2 };
constexpr long kVResident = 64 * 1024;  // the most bytes of V kept in shared memory
// a warpgroup's LN1 statistics in a stage: 65 f32 pairs from an even row (a
// 16-byte aligned bulk copy of 528 bytes) in a slot of 640; the caller's
// statistics buffer holds 72 rows past the B * S so that the last tile's
// copy stays inside it
constexpr int kStatBytes = 528, kStatSlot = 640;

__host__ __device__ constexpr int kv_width(int hd) { return hd <= 64 ? 64 : 80; }
__host__ __device__ constexpr int kv_heads(int hd) { return hd <= 64 ? 64 / hd : 1; }
__host__ __device__ constexpr int kv_nbh(int hd) { return (kv_width(hd) + 63) / 64; }
__host__ __device__ constexpr int kv_tiles(int S) { return (S + 63) / 64; }
// an item is one image of one head group, or two where S <= 64 (one a warpgroup)
__host__ __device__ constexpr int kv_images(int S) { return kv_tiles(S) == 1 ? 2 : 1; }
// the item's passes of 128 rows (two 64-row tiles, one a warpgroup)
__host__ __device__ constexpr int kv_passes(int S) { return (kv_tiles(S) + 1) / 2; }
constexpr int kKvMaxStages = 6;

inline int v_mode(int hd, int S) {
  if (kv_passes(S) == 1) return V_REGISTERS;
  return (long)kv_tiles(S) * 64 * kv_width(hd) * 2 <= kVResident ? V_SHARED : V_RECOMPUTED;
}

// launch 2's shared memory, from a 1024-byte boundary: the ring of st stages
// [x box, x box, K, V and q.w boxes] (as many as fit, up to kKvMaxStages; a
// shape that leaves room for fewer than two is refused), its barriers (256
// bytes), each stage's LN1 statistics (two slots of kStatSlot bytes), the
// logits [2][heads][tiles * 64] f32, then V [tiles * 64][W] bf16 (V_SHARED) or
// the per-warp P V partials [8][W] and two sums [W] f32, then q [2][W], the
// group's K, V and q biases [3][W] f32 and LN1's g and b [D] in bf16
struct KvSmem {
  int st;
  size_t bars, stats, logits, v, q, bias, gb, total;
  __host__ __device__ KvSmem(int hd, int S, int mode, int D) {
    const int w = kv_width(hd), spad = kv_tiles(S) * 64;
    const size_t stage = (size_t)(2 + 3 * kv_nbh(hd)) * BOX;
    const size_t vbytes = mode == V_SHARED ? (size_t)spad * w * 2 : (size_t)10 * w * 4;
    const size_t fixed = 1024 + 256 + (size_t)2 * kv_heads(hd) * spad * 4 + vbytes +
                         (size_t)5 * w * 4 + (size_t)D * 4;
    const long room = (long)kMaxSmem - (long)fixed;
    const long fit = room > 0 ? room / (long)(stage + 2 * kStatSlot) : 0;
    st = static_cast<int>(fit < kKvMaxStages ? fit : kKvMaxStages);
    bars = (size_t)st * stage;
    stats = bars + 256;
    logits = stats + (size_t)st * 2 * kStatSlot;
    v = logits + (size_t)2 * kv_heads(hd) * spad * 4;
    q = v + vbytes;
    bias = q + (size_t)2 * w * 4;
    gb = bias + (size_t)3 * w * 4;
    total = 1024 + gb + (size_t)D * 4;
  }
  __host__ __device__ bool fits() const { return st >= 2 && total <= kMaxSmem; }
};

template <int HD>
struct Kv {
  static_assert(layer_head_dim_ok(HD), "a head dim the layer kernels take");
  static constexpr int NH = kv_heads(HD);    // heads a block (the last group may have fewer)
  static constexpr int W = kv_width(HD);     // K (and V, and q) columns a group: NH * HD
  static constexpr int NBH = kv_nbh(HD);     // 64-column boxes of each: 1 or 2
  static constexpr bool WIDE = HD > 64;      // hd 80: K, V and q each an n80 product
  static constexpr int NKV = WIDE ? 40 : 64;  // K|V in one n128 product, or K alone
  static constexpr int NV = WIDE ? 40 : 1;
  static constexpr int NQ = WIDE ? 40 : 32;
  static constexpr int NCP = WIDE ? 20 : 16;  // V columns a thread holds
  static constexpr int STAGE = (2 + 3 * NBH) * BOX;
};

// float32's launch 3 (cls_kv_attention_f32): a stage is one 32-deep k-step, A's three
// planes [128 rows][32 k] (split6.cuh's layout, 8 KB each), then the three planes of
// one operand, K or V (NBH boxes [32 k][64 n] of 4 KB each), and q.w's three; up to
// four stages, at least one
constexpr int F32_BK = 32;
constexpr int F32_WBOX = F32_BK * 64 * 2;
constexpr int kF32MaxStages = 4;
__host__ __device__ constexpr int f32_w_off() { return 3 * f3::PLANE_A; }
__host__ __device__ constexpr int f32_stage(int hd) {
  return f32_w_off() + 2 * 3 * kv_nbh(hd) * F32_WBOX;
}
// its shared memory from a 1024-byte boundary: the ring, the barriers (256
// bytes), the logits [images][heads][tiles * 64] f32, the P V partials [8][W]
// and sums [2][W], q [2][W] and the group's K, V and q biases [3][W], f32
struct KvF32Smem {
  int st;
  size_t bars, logits, part, q, bias, total;
  __host__ __device__ KvF32Smem(int hd, int S) {
    const int w = kv_width(hd), spad = kv_tiles(S) * 64;
    const size_t lbytes = (size_t)kv_images(S) * kv_heads(hd) * spad * 4;
    const size_t fixed = 1024 + 256 + lbytes + (size_t)15 * w * 4;
    const long room = (long)kMaxSmem - (long)fixed;
    const long fit = room > 0 ? room / f32_stage(hd) : 0;
    st = static_cast<int>(fit < kF32MaxStages ? fit : kF32MaxStages);
    bars = (size_t)st * f32_stage(hd);
    logits = bars + 256;
    part = logits + lbytes;
    q = part + (size_t)10 * w * 4;
    bias = q + (size_t)2 * w * 4;
    total = 1024 + bias + (size_t)3 * w * 4;
  }
  __host__ __device__ bool fits() const { return st >= 1 && total <= kMaxSmem; }
};
// the six passes of a k-step (A plane, W plane), 0 hi, 1 mid, 2 lo: lo.hi, hi.lo,
// mid.mid, mid.hi, hi.mid, hi.hi (split6.cuh's order, the small terms first)
__host__ __device__ constexpr int pass_a(int p) { return p == 0 ? 2 : p == 2 || p == 3 ? 1 : 0; }
__host__ __device__ constexpr int pass_w(int p) { return p == 1 ? 2 : p == 2 || p == 4 ? 1 : 0; }

template <int HD>
struct KvF32 {
  static_assert(layer_head_dim_ok(HD), "a head dim the layer kernels take");
  static constexpr int NH = kv_heads(HD), W = kv_width(HD), NBH = kv_nbh(HD);
  static constexpr bool WIDE = HD > 64;  // hd 80: n80 products
  static constexpr int NACC = W / 2;     // accumulators of an m64nW product a thread
  static constexpr int NCP = W / 4;      // V columns a thread holds in P V
  static constexpr int STAGE = f32_stage(HD);
  // two consumer warpgroups, eight producer warps (a 17th warp would cut every
  // warp's registers to 96: five warps on one of the SM's four register files)
  static constexpr int CONSUMERS = 256, PRODUCERS = 256, THREADS = CONSUMERS + PRODUCERS;
  // registers after setmaxnreg (the pair sums to 2 x 128, the launch's share): the
  // consumers hold a step's product, its running sum and q's running sum, the
  // producers two steps of x, statistics, g and b
  static constexpr int CONSUMER_REGS = WIDE ? 160 : 152, PRODUCER_REGS = 256 - CONSUMER_REGS;
};

// float32's launch 4 (cls_tail_f32): a stage is one 64-deep box of A's three planes
// [64 rows][64 k] and W's three [64 k][128 n] (nine boxes, 72 KB), three stages
constexpr int TAIL32_STAGES = 3;
constexpr int TAIL32_STAGE = 9 * BOX;
constexpr int TAIL32_THREADS = 288;  // two consumer warpgroups and a producer warp
constexpr size_t TAIL32_SMEM = 1024 + (size_t)TAIL32_STAGES * TAIL32_STAGE + 2 * TAIL32_STAGES * 8;

// launch 3
constexpr int TAIL_STAGES = 6;  // 144 KB: one block an SM
constexpr int TAIL_STAGE = 3 * BOX;  // the A box [64 rows x 64 k] and two W boxes [64 k x 64 n]
constexpr int TAIL_THREADS = 160;    // a consumer warpgroup and a producer warp
constexpr size_t TAIL_SMEM = 1024 + (size_t)TAIL_STAGES * TAIL_STAGE + 2 * TAIL_STAGES * 8;
inline int tail_cluster(int B) { return (B + 63) / 64 <= 2 ? 16 : 8; }
}  // namespace cls

std::atomic<long long> g_cls_launches[cls::KINDS];

// 1/sqrt(hd) as the TPU wrapper computes it (in double, then f32)
inline float cls_scale(int hd) { return static_cast<float>(1.0 / sqrt(static_cast<double>(hd))); }

// the sum over a quad of lanes (the four that hold one accumulator row)
__device__ __forceinline__ float cls_quad_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// Launch 1: LN1's statistics of every token. A warp takes ROWS rows at once
// (their loads all in flight together), a lane the 8-value chunks lane, lane +
// 32, .. of each (NCH of them: D <= 256 NCH), kept in registers; two passes
// (the mean, then mean((x - mean)^2) over the first dn values) as ln_stats.
template <typename Tin, int NCH, int ROWS>
__global__ void __launch_bounds__(256)
cls_ln1_stats_kernel(const Tin* __restrict__ x, float2* __restrict__ stats, long rows, int D,
                     int DN, float eps) {
  const long row0 = ((long)blockIdx.x * 8 + (threadIdx.x >> 5)) * ROWS;
  const int lane = threadIdx.x & 31;
  float v[ROWS][NCH][8];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int k = (c * 32 + lane) * 8;
      if (row0 + r < rows && k < D) {
        load8(x + (row0 + r) * D + k, v[r][c]);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) v[r][c][t] = 0.f;
      }
    }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int t = 0; t < 8; ++t) s += v[r][c][t];  // zeros past DN (the padding) add nothing
    const float mean = warp_sum(s) / DN;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float e = v[r][c][t] - mean;
        if ((c * 32 + lane) * 8 + t < DN) q += e * e;
      }
    const float rs = rsqrtf(warp_sum(q) / DN + eps);
    if (lane == 0 && row0 + r < rows) stats[row0 + r] = make_float2(mean, rs);
  }
}

// rows too wide for the registers: layer.cu's ln_stats, a warp a row
template <typename Tin>
__global__ void __launch_bounds__(256)
cls_ln1_stats_wide_kernel(const Tin* __restrict__ x, float2* __restrict__ stats, long rows, int D,
                          int DN, float eps) {
  const long row = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  float mean, rs;
  ln_stats(x + row * D, DN, eps, mean, rs);
  if ((threadIdx.x & 31) == 0) stats[row] = make_float2(mean, rs);
}

template <typename Tin>
cudaError_t ln1_stats(const Tin* x, float2* stats, long rows, int D, int DN, float eps,
                      cudaStream_t st) {
  const int nch = (D + 255) / 256;
  auto go = [&](auto kernel, int rows_a_warp) {
    const long warps = (rows + rows_a_warp - 1) / rows_a_warp;
    kernel<<<static_cast<unsigned>((warps + 7) / 8), 256, 0, st>>>(x, stats, rows, D, DN, eps);
    return cudaGetLastError();
  };
  switch (nch) {  // about 32 values a lane in flight
    case 1: return go(cls_ln1_stats_kernel<Tin, 1, 4>, 4);
    case 2: return go(cls_ln1_stats_kernel<Tin, 2, 2>, 2);
    case 3: return go(cls_ln1_stats_kernel<Tin, 3, 2>, 2);
    case 4: return go(cls_ln1_stats_kernel<Tin, 4, 1>, 1);
    case 5: return go(cls_ln1_stats_kernel<Tin, 5, 1>, 1);
    case 6: return go(cls_ln1_stats_kernel<Tin, 6, 1>, 1);
    default: return go(cls_ln1_stats_wide_kernel<Tin>, 1);
  }
}

// ---------------------------------------------------------------------------
// Launch 2: LN1, the K/V product, q and the CLS attention. Persistent: one
// block an SM walks over items (an item: one image of one head group, or two
// where S <= 64); threads: two consumer warpgroups, then the producer warp.
// Each stage holds both warpgroups' x boxes and LN1 statistics and the
// group's K, V (and, in an item's first pass, q.w) boxes; the producer runs
// ahead into the next item while the consumers finish one.

// `bytes` (a multiple of 16) from 16-byte aligned global memory into shared
// memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// d[64 x 80] += A[64 x 16] (K-major) @ B[16 x 80] (MN-major: a 64-column box and
// 16 columns of the next, LBO apart): hd 80's K, V and q
__device__ __forceinline__ void wgmma_m64n80k16(float (&d)[40], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39}, %40, %41, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(1));
}

// Accumulator i of an n-wide product: row wl * 16 + lane / 4 + 8 ((i / 2) % 2)
// of the warpgroup's 64, column 8 (i / 4) + 2 (lane % 4) + i % 2; an 8-column
// block lies in one head (hd is a multiple of 16)
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1); }

// an item's head group and the index of its (first) image: consecutive items
// take consecutive images of one group, so that the blocks at work at once
// read the same W boxes
__device__ __forceinline__ int item_group(int item, int nim, int groups) { return item / nim; }
__device__ __forceinline__ int item_image(int item, int nim, int groups) { return item % nim; }

template <int HD>
__global__ void __launch_bounds__(288, 1)
cls_kv_attention_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw,
                        const __grid_constant__ CUtensorMap twq,
                        const float2* __restrict__ stats,
                        const bf16* __restrict__ ln1g, const bf16* __restrict__ ln1b,
                        const bf16* __restrict__ bkv, const bf16* __restrict__ bq,
                        bf16* __restrict__ ctx, int B, int S, int D, int H, float scale, int mode) {
  using namespace cls;
  using G = Kv<HD>;
  constexpr int NH = G::NH, W = G::W, NBH = G::NBH, NCP = G::NCP;
  constexpr int STAGE = G::STAGE, CONSUMERS = 256;
  extern __shared__ unsigned char csm[];
  const uint32_t raw = smem_u32(csm);
  unsigned char* base = csm + (((raw + 1023) & ~1023u) - raw);
  const int ntiles = kv_tiles(S), spad = ntiles * 64, KW = H * HD;
  const KvSmem lay(HD, S, mode, D);
  const int ST = lay.st;
  unsigned char* ring = base;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bars);
  uint64_t* empty = full + ST;
  float* stbuf = reinterpret_cast<float*>(base + lay.stats);  // [ST][2][kStatSlot / 4]
  float* logit = reinterpret_cast<float*>(base + lay.logits);  // [2][NH][spad]: logits, then P
  bf16* vs = reinterpret_cast<bf16*>(base + lay.v);            // [spad][W] (V_SHARED)
  float* part = reinterpret_cast<float*>(base + lay.v);        // [8][W], then sums [2][W]
  float* qs = reinterpret_cast<float*>(base + lay.q);          // [2][W]
  float* bias = reinterpret_cast<float*>(base + lay.bias);     // the group's K, V, q biases [3][W]
  bf16* gb = reinterpret_cast<bf16*>(base + lay.gb);           // LN1's g [D], b [D]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int groups = (H + NH - 1) / NH, images = kv_images(S), packed = images == 2;
  const int npass = kv_passes(S), nk = (D + 63) / 64;
  const int nsets = mode == V_RECOMPUTED ? 2 : 1;
  const int nim = (B + images - 1) / images, nitems = groups * nim;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int k = tid; k < D; k += blockDim.x) {
    gb[k] = ln1g[k];
    gb[D + k] = ln1b[k];
  }
  __syncthreads();

  if (warp == 8) {  // --- producer ---
    if (lane == 0) {
      int step = 0;
      for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
        const int g = item_group(item, nim, groups), b0 = item_image(item, nim, groups) * images;
        for (int set = 0; set < nsets; ++set)
          for (int pass = 0; pass < npass; ++pass)
            for (int kc = 0; kc < nk; ++kc, ++step) {
              const int s = step % ST;
              if (step >= ST) mbar_wait(smem_u32(empty + s), ((step / ST) - 1) & 1);
              const bool withq = set == 0 && pass == 0;
              unsigned char* st = ring + s * STAGE;
              const uint32_t fb = smem_u32(full + s);
              mbar_arrive_expect(fb, (2 + (withq ? 3 : 2) * NBH) * BOX + 2 * kStatBytes);
              for (int w = 0; w < 2; ++w) {
                const int bw = b0 + (packed ? w : 0), tile = packed ? 0 : 2 * pass + w;
                // x: zeros past S or B, no memory traffic
                tma_load_3d(smem_u32(st + w * BOX), &tx, fb, kc * 64, tile * 64, bw);
                // the tile's 64 rows of statistics from the even row at or before its
                // first (16-byte aligned), 65 rows; row 0 where the tile is past B or S
                const long r0 = bw < B && tile < ntiles ? (long)bw * S + tile * 64 : 0;
                bulk_load(smem_u32(stbuf + (s * 2 + w) * (kStatSlot / 4)), stats + (r0 & ~1L),
                          kStatBytes, fb);
              }
              for (int j = 0; j < NBH; ++j) {
                tma_load_2d(smem_u32(st + (2 + j) * BOX), &tw, fb, g * W + j * 64, kc * 64);
                tma_load_2d(smem_u32(st + (2 + NBH + j) * BOX), &tw, fb, KW + g * W + j * 64,
                            kc * 64);
                if (withq)
                  tma_load_2d(smem_u32(st + (2 + 2 * NBH + j) * BOX), &twq, fb, g * W + j * 64,
                              kc * 64);
              }
            }
      }
    }
    return;
  }

  // --- consumers: warpgroup wg takes tile 2 pass + wg of the item's image, or
  // (packed) the one tile of the item's image wg ---
  const int wg = warp >> 2, wl = warp & 3, ct = tid & 127;
  const int nrow0 = ct >> 3, nchunk = ct & 7;  // this thread's 4 rows (+ 16 i) and 8-column chunk
  // the named barrier and the threads that take one image's epilogue together
  const int sid = packed ? 1 + wg : 3, sthreads = packed ? 128 : CONSUMERS;
  const int stid = packed ? ct : tid;
  float* lg = logit + (packed ? wg : 0) * NH * spad;
  float* qw = qs + (packed ? wg : 0) * W;
  float* cacc = part + 8 * W + (packed ? wg : 0) * W;
  float acc[G::NKV], accv[G::NV], accq[G::NQ];
  int step = 0, gprev = -1;
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int g = item_group(item, nim, groups);
    const int b = item_image(item, nim, groups) * images + (packed ? wg : 0);
    const bool real = b < B;
    const int hv = min(NH, H - g * NH), wv = hv * HD;  // heads and columns of this group
    if (mode != V_SHARED)
      for (int c = stid; c < W; c += sthreads) cacc[c] = 0.f;
    if (g != gprev) {  // the group's biases, f32 (the previous item's readers are past the
                       // syncs of its epilogue; CONSUMERS-wide below)
      named_sync(3, CONSUMERS);
      for (int c = tid; c < W; c += CONSUMERS) {
        const bool in = c < wv;
        bias[c] = in ? to_f(bkv[g * W + c]) : 0.f;
        bias[W + c] = in ? to_f(bkv[KW + g * W + c]) : 0.f;
        bias[2 * W + c] = in ? to_f(bq[g * W + c]) : 0.f;
      }
      named_sync(3, CONSUMERS);
      gprev = g;
    }
    named_sync(sid, sthreads);
    for (int set = 0; set < nsets; ++set) {
      for (int pass = 0; pass < npass; ++pass) {
        const int tile = packed ? 0 : 2 * pass + wg;
        const bool active = real && tile < ntiles;
        const bool withq = set == 0 && tile == 0;  // this warpgroup holds the CLS row
#pragma unroll
        for (int i = 0; i < G::NKV; ++i) acc[i] = 0.f;
#pragma unroll
        for (int i = 0; i < G::NV; ++i) accv[i] = 0.f;
#pragma unroll
        for (int i = 0; i < G::NQ; ++i) accq[i] = 0.f;
        int s = step % ST;
        // LN1 in place on this warpgroup's x box of stage st_ (k-chunk kc_): (x -
        // mean) * rs * g + b, rounded to bf16, in the 128-byte swizzle wgmma reads
        auto norm_box = [&](int st_, int kc_) {
          unsigned char* xb = ring + st_ * STAGE + wg * BOX;
          // the statistics' first row is the even row at or before the tile's first
          const float* sr = stbuf + (st_ * 2 + wg) * (kStatSlot / 4) + 2 * ((b * S + tile * 64) & 1);
          const int k = kc_ * 64 + nchunk * 8;
          float gg[8], bv[8];
          if (k < D) {
            load8(gb + k, gg);
            load8(gb + D + k, bv);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = nrow0 + 16 * i;
            const float2 m = *reinterpret_cast<const float2*>(sr + 2 * row);
            bf16* p = reinterpret_cast<bf16*>(xb + row * 128 + ((nchunk ^ (row & 7)) << 4));
            float v[8];
            if (k < D) {
              load8(p, v);
#pragma unroll
              for (int t = 0; t < 8; ++t) v[t] = (v[t] - m.x) * m.y * gg[t] + bv[t];
            } else {
#pragma unroll
              for (int t = 0; t < 8; ++t) v[t] = 0.f;
            }
            store8(p, v);
          }
        };
        mbar_wait(smem_u32(full + s), (step / ST) & 1);
        if (active) norm_box(s, 0);
        for (int kc = 0; kc < nk; ++kc, ++step) {
          if (active) {
            // the generic-proxy stores become visible to wgmma, then the whole box is done
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            named_sync(1 + wg, 128);
            const uint32_t a0 = smem_u32(ring + s * STAGE + wg * BOX);
            const uint32_t w0 = smem_u32(ring + s * STAGE + 2 * BOX);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t da = gmma_desc(a0 + kk * 32, 16, 1024);
              if constexpr (G::WIDE) {
                wgmma_m64n80k16(acc, da, gmma_desc(w0 + kk * 2048, BOX, 1024));
                wgmma_m64n80k16(accv, da, gmma_desc(w0 + 2 * BOX + kk * 2048, BOX, 1024));
                if (withq) wgmma_m64n80k16(accq, da, gmma_desc(w0 + 4 * BOX + kk * 2048, BOX, 1024));
              } else {
                wgmma_m64n128k16(acc, da, gmma_desc(w0 + kk * 2048, BOX, 1024));
                if (withq)
                  wgmma_m64n64k16<1>(accq, da, gmma_desc(w0 + 2 * BOX + kk * 2048, BOX, 1024));
              }
            }
            wgmma_commit();
          }
          // the next box is normalised while this step's products run
          const int s1 = (step + 1) % ST;
          if (kc + 1 < nk) {
            mbar_wait(smem_u32(full + s1), ((step + 1) / ST) & 1);
            if (active) norm_box(s1, kc + 1);
          }
          if (active) wgmma_wait<0>();
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(empty + s));
          s = s1;
        }

        const int rbase = tile * 64 + wl * 16 + (lane >> 2);  // + 8 ((i / 2) % 2)
        if (set == 0) {
          if (withq && active && wl == 0 && lane < 4)  // q of the CLS row (row 0), rounded
#pragma unroll
            for (int i = 0; i < G::NQ; ++i)
              if (((i >> 1) & 1) == 0 && acc_col(i) < wv)
                qw[acc_col(i)] = round_to<bf16>(accq[i] + bias[2 * W + acc_col(i)]);
          named_sync(sid, sthreads);
          if (active) {
            float lp[2][NH];
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int h = 0; h < NH; ++h) lp[r][h] = 0.f;
#pragma unroll
            for (int i = 0; i < G::NKV; ++i) {
              const int cb = 8 * (i >> 2), col = acc_col(i), r = (i >> 1) & 1;
              if (G::WIDE || cb < 64) {  // K
                const int h = cb / HD;
                if (h < NH && col < wv) {
                  const float kv = round_to<bf16>(acc[i] + bias[col]);
                  lp[r][h] = fmaf(qw[col], kv, lp[r][h]);
                }
              } else if (mode == V_SHARED) {  // hd <= 64: V, kept in shared memory
                const int vc = col - 64, j = rbase + 8 * r;
                if (vc < wv && j < S) vs[(long)j * W + vc] = __float2bfloat16(acc[i] + bias[W + vc]);
              }
            }
            if constexpr (G::WIDE) {
              if (mode == V_SHARED)
#pragma unroll
                for (int i = 0; i < G::NV; ++i) {
                  const int vc = acc_col(i), j = rbase + 8 * ((i >> 1) & 1);
                  if (vc < wv && j < S) vs[(long)j * W + vc] = __float2bfloat16(accv[i] + bias[W + vc]);
                }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int h = 0; h < NH; ++h) {
                const float l = cls_quad_sum(lp[r][h]);
                const int j = rbase + 8 * r;
                if ((lane & 3) == 0 && h < hv && j < S) lg[h * spad + j] = l * scale;
              }
          }
        }
        if (set == 0 && pass == npass - 1) {  // every logit is in: the softmax, P rounded
          named_sync(sid, sthreads);
          const int sw = packed ? wl : warp;  // the warp's index in its image's warps
          if (real && sw < hv) {
            float* l = lg + sw * spad;
            float mx = -INFINITY;
            for (int j = lane; j < S; j += 32) mx = fmaxf(mx, l[j]);
            mx = warp_max(mx);
            float sum = 0.f;
            for (int j = lane; j < S; j += 32) {
              const float e = expf(l[j] - mx);
              l[j] = e;
              sum += e;
            }
            sum = warp_sum(sum);
            for (int j = lane; j < S; j += 32) l[j] = round_to<bf16>(__fdiv_rn(l[j], sum));
          }
          named_sync(sid, sthreads);
        }
        if ((mode == V_REGISTERS && set == 0) || (mode == V_RECOMPUTED && set == 1)) {
          // P V from the accumulators: each column's sum over this thread's two
          // rows, then over the warp's rows (lanes of equal lane % 4), per warp
          float cp[NCP];
#pragma unroll
          for (int c = 0; c < NCP; ++c) cp[c] = 0.f;
          if (active) {
            if constexpr (G::WIDE) {
#pragma unroll
              for (int i = 0; i < G::NV; ++i) {
                const int vc = acc_col(i), j = rbase + 8 * ((i >> 1) & 1);
                if (vc < wv && j < S) {
                  const float v = round_to<bf16>(accv[i] + bias[W + vc]);
                  cp[(i >> 2) * 2 + (i & 1)] = fmaf(lg[j], v, cp[(i >> 2) * 2 + (i & 1)]);
                }
              }
            } else {
#pragma unroll
              for (int i = 0; i < G::NKV; ++i) {
                const int cb = 8 * (i >> 2);
                if (cb >= 64) {
                  const int vc = acc_col(i) - 64, h = (cb - 64) / HD;
                  const int j = rbase + 8 * ((i >> 1) & 1);
                  if (h < NH && vc < wv && j < S) {
                    const float v = round_to<bf16>(acc[i] + bias[W + vc]);
                    cp[((cb - 64) >> 3) * 2 + (i & 1)] =
                        fmaf(lg[h * spad + j], v, cp[((cb - 64) >> 3) * 2 + (i & 1)]);
                  }
                }
              }
            }
          }
#pragma unroll
          for (int c = 0; c < NCP; ++c) {
            cp[c] += __shfl_xor_sync(0xffffffffu, cp[c], 4);
            cp[c] += __shfl_xor_sync(0xffffffffu, cp[c], 8);
            cp[c] += __shfl_xor_sync(0xffffffffu, cp[c], 16);
          }
          if (lane < 4)
#pragma unroll
            for (int c = 0; c < NCP; ++c) {
              const int vc = 8 * (c >> 1) + 2 * lane + (c & 1);
              if (vc < W) part[warp * W + vc] = cp[c];
            }
          named_sync(sid, sthreads);
          const int w0 = packed ? 4 * wg : 0, nw = packed ? 4 : 8;
          for (int c = stid; c < W; c += sthreads) {  // the warps' partials in a fixed order
            float sacc = cacc[c];
            for (int w = 0; w < nw; ++w) sacc += part[(w0 + w) * W + c];
            cacc[c] = sacc;
          }
          named_sync(sid, sthreads);
        }
      }
    }
    if (real) {
      bf16* out = ctx + (long)b * KW + g * W;
      if (mode == V_SHARED) {
        for (int c = stid; c < wv; c += sthreads) {
          const float* p = lg + (c / HD) * spad;
          float o = 0.f;
          for (int j = 0; j < S; ++j) o = fmaf(p[j], __bfloat162float(vs[(long)j * W + c]), o);
          out[c] = __float2bfloat16(o);
        }
      } else {
        for (int c = stid; c < wv; c += sthreads) out[c] = __float2bfloat16(cacc[c]);
      }
    }
  }
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <int HD>
cudaError_t kv_attention_hd(const bf16* x, const bf16* ln1g, const bf16* ln1b, const bf16* wq,
                            const bf16* bq, const bf16* wkv, const bf16* bkv, const float2* stats,
                            bf16* ctx, int B, int S, int D, int H, int mode, cudaStream_t st) {
  using namespace cls;
  const KvSmem lay(HD, S, mode, D);
  if (!lay.fits()) return cudaErrorInvalidValue;
  CUtensorMap tx, tw, twq;
  VPT_TRY(tma_map_3d_64(&tx, x, D, S, B));
  VPT_TRY(tma_map_w(&tw, wkv, 2 * H * HD, D));
  VPT_TRY(tma_map_w(&twq, wq, H * HD, D));
  auto kernel = cls_kv_attention_kernel<HD>;
  VPT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)lay.total));
  const int groups = (H + Kv<HD>::NH - 1) / Kv<HD>::NH;
  const int nitems = groups * ((B + kv_images(S) - 1) / kv_images(S));
  kernel<<<std::min(nitems, sm_count()), 288, lay.total, st>>>(
      tx, tw, twq, stats, ln1g, ln1b, bkv, bq, ctx, B, S, D, H, cls_scale(HD), mode);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Launch 3: the tail on the B rows. One 64-row tile per cluster; block `rank`
// of the cluster's C takes the product tiles rank, rank + C, ... and rows
// rank, rank + C, ... of each LayerNorm.

struct TailArgs {
  const bf16* x;  // the CLS rows: x + m * x_row
  long x_row;
  const bf16 *bo, *ln2g, *ln2b, *b1, *b2, *lnfg, *lnfb, *bh;
  float *x1, *x2;
  bf16 *h, *m1, *logits;
  int B, D, M, L, DN;
  float eps;
};

__device__ __forceinline__ void tail_cluster_sync() {
  // this thread's stores, then the cluster's barrier; the phase after it
  // reads them through TMA (the async proxy) on other blocks of the cluster
  __threadfence();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// out[64 rows from m0, N] = A[., K] @ W[K, N], this block's 128-column tiles,
// the epilogue epi(row, col, v0, v1) on each pair of columns (col, col + 1)
template <typename Epi>
__device__ __forceinline__ void tail_gemm(const CUtensorMap* ta, const CUtensorMap* tw, int N,
                                          int K, int B, int m0, unsigned char* ring,
                                          uint64_t* full, uint64_t* empty, int& step, Epi epi) {
  using namespace cls;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x, C = gridDim.x;
  const int ntiles = (N + 127) / 128, nk = (K + 63) / 64;
  if (warp == 4) {  // producer
    if (lane == 0)
      for (int tile = rank; tile < ntiles; tile += C)
        for (int kc = 0; kc < nk; ++kc, ++step) {
          const int s = step % TAIL_STAGES;
          if (step >= TAIL_STAGES) mbar_wait(smem_u32(empty + s), ((step / TAIL_STAGES) - 1) & 1);
          unsigned char* st = ring + s * TAIL_STAGE;
          const uint32_t fb = smem_u32(full + s);
          mbar_arrive_expect(fb, TAIL_STAGE);
          tma_load_2d(smem_u32(st), ta, fb, kc * 64, m0);
          tma_load_2d(smem_u32(st + BOX), tw, fb, tile * 128, kc * 64);
          tma_load_2d(smem_u32(st + 2 * BOX), tw, fb, tile * 128 + 64, kc * 64);
        }
    __syncwarp();
    return;
  }
  for (int tile = rank; tile < ntiles; tile += C) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < nk; ++kc, ++step) {
      const int s = step % TAIL_STAGES;
      mbar_wait(smem_u32(full + s), (step / TAIL_STAGES) & 1);
      const uint32_t a0 = smem_u32(ring + s * TAIL_STAGE), b0 = a0 + BOX;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16(acc, gmma_desc(a0 + kk * 32, 16, 1024),
                         gmma_desc(b0 + kk * 2048, BOX, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(empty + s));
    }
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = m0 + warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int col = tile * 128 + 8 * (i >> 2) + 2 * (lane & 3);
      if (row < B && col < N) epi(row, col, acc[i], acc[i + 1]);
    }
  }
}

// y[row] = LN(x[row]) rounded to bf16 for this block's rows of the tile: a
// warp a row, as layer.cu's layer_norm<float, bf16>
__device__ __forceinline__ void tail_ln(const float* x, const bf16* g, const bf16* bb, bf16* y,
                                        int B, int D, int DN, float eps, int m0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = blockIdx.x, C = gridDim.x;
  for (int r = rank + C * warp; r < 64 && m0 + r < B; r += C * 4) {
    const float* xr = x + (long)(m0 + r) * D;
    float mean, rs;
    ln_stats(xr, DN, eps, mean, rs);
    bf16* yr = y + (long)(m0 + r) * D;
    for (int i = lane; i < D; i += 32)
      yr[i] = __float2bfloat16((xr[i] - mean) * rs * to_f(g[i]) + to_f(bb[i]));
  }
}

__global__ void __launch_bounds__(cls::TAIL_THREADS, 1)
cls_tail_kernel(const __grid_constant__ CUtensorMap tctx, const __grid_constant__ CUtensorMap two,
                const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tw1,
                const __grid_constant__ CUtensorMap tm1, const __grid_constant__ CUtensorMap tw2,
                const __grid_constant__ CUtensorMap twh, const __grid_constant__ TailArgs a,
                int KW) {
  using namespace cls;
  extern __shared__ unsigned char tsm[];
  const uint32_t raw = smem_u32(tsm);
  unsigned char* ring = tsm + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + TAIL_STAGES * TAIL_STAGE);
  uint64_t* empty = full + TAIL_STAGES;
  const int m0 = blockIdx.y * 64, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TAIL_STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int step = 0;
  // 1. x1 = (ctx Wo + bo) + x_cls, f32
  tail_gemm(&tctx, &two, a.D, KW, a.B, m0, ring, full, empty, step,
            [&](int r, int c, float v0, float v1) {
              const bf16* xr = a.x + r * a.x_row + c;
              *reinterpret_cast<float2*>(a.x1 + (long)r * a.D + c) =
                  make_float2(v0 + to_f(a.bo[c]) + to_f(xr[0]), v1 + to_f(a.bo[c + 1]) + to_f(xr[1]));
            });
  tail_cluster_sync();
  // 2. h = LN2(x1)
  if (warp < 4) tail_ln(a.x1, a.ln2g, a.ln2b, a.h, a.B, a.D, a.DN, a.eps, m0);
  tail_cluster_sync();
  // 3. m1 = GELU(h W1 + b1), tanh form, bf16
  tail_gemm(&th, &tw1, a.M, a.D, a.B, m0, ring, full, empty, step,
            [&](int r, int c, float v0, float v1) {
              *reinterpret_cast<__nv_bfloat162*>(a.m1 + (long)r * a.M + c) =
                  __floats2bfloat162_rn(gelu(v0 + to_f(a.b1[c]), ACT_GELU_TANH),
                                        gelu(v1 + to_f(a.b1[c + 1]), ACT_GELU_TANH));
            });
  tail_cluster_sync();
  // 4. x2 = (m1 W2 + b2) + x1, f32
  tail_gemm(&tm1, &tw2, a.D, a.M, a.B, m0, ring, full, empty, step,
            [&](int r, int c, float v0, float v1) {
              const float2 x1 = *reinterpret_cast<const float2*>(a.x1 + (long)r * a.D + c);
              *reinterpret_cast<float2*>(a.x2 + (long)r * a.D + c) =
                  make_float2(v0 + to_f(a.b2[c]) + x1.x, v1 + to_f(a.b2[c + 1]) + x1.y);
            });
  tail_cluster_sync();
  // 5. h = LN_f(x2)
  if (warp < 4) tail_ln(a.x2, a.lnfg, a.lnfb, a.h, a.B, a.D, a.DN, a.eps, m0);
  tail_cluster_sync();
  // 6. logits = h Wh + bh, bf16
  tail_gemm(&th, &twh, a.L, a.D, a.B, m0, ring, full, empty, step,
            [&](int r, int c, float v0, float v1) {
              *reinterpret_cast<__nv_bfloat162*>(a.logits + (long)r * a.L + c) =
                  __floats2bfloat162_rn(v0 + to_f(a.bh[c]), v1 + to_f(a.bh[c + 1]));
            });
}

// A [rows, K] bf16 (row stride K) as the tail's A operand: 64 x 64 boxes
inline cudaError_t tma_map_rows64(CUtensorMap* map, const bf16* A, int rows, int K) {
  return tma_map_2d(map, A, K, rows, static_cast<uint64_t>(K) * 2, 64, 64);
}

cudaError_t cls_tail(const TailArgs& a, const bf16* ctx, const bf16* wo, const bf16* w1,
                     const bf16* w2, const bf16* wh, int KW, cudaStream_t st) {
  using namespace cls;
  CUtensorMap tctx, two, th, tw1, tm1, tw2, twh;
  VPT_TRY(tma_map_rows64(&tctx, ctx, a.B, KW));
  VPT_TRY(tma_map_w(&two, wo, a.D, KW));
  VPT_TRY(tma_map_rows64(&th, a.h, a.B, a.D));
  VPT_TRY(tma_map_w(&tw1, w1, a.M, a.D));
  VPT_TRY(tma_map_rows64(&tm1, a.m1, a.B, a.M));
  VPT_TRY(tma_map_w(&tw2, w2, a.D, a.M));
  VPT_TRY(tma_map_w(&twh, wh, a.L, a.D));
  const int C = tail_cluster(a.B);
  VPT_TRY(cudaFuncSetAttribute(cls_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)TAIL_SMEM));
  if (C > 8)
    VPT_TRY(cudaFuncSetAttribute(cls_tail_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (a.B + 63) / 64, 1);
  cfg.blockDim = dim3(TAIL_THREADS, 1, 1);
  cfg.dynamicSmemBytes = TAIL_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  VPT_TRY(cudaLaunchKernelEx(&cfg, cls_tail_kernel, tctx, two, th, tw1, tm1, tw2, twh, a, KW));
  return cudaGetLastError();
}

// the bf16 route: launches 1-3
cudaError_t cls_logits_bf16(const bf16* x, const bf16* ln1g, const bf16* ln1b, const bf16* wq,
                            const bf16* bq, const bf16* wkv, const bf16* bkv, const bf16* wo,
                            const bf16* bo, const bf16* ln2g, const bf16* ln2b, const bf16* w1,
                            const bf16* b1, const bf16* w2, const bf16* b2, const bf16* lnfg,
                            const bf16* lnfb, const bf16* wh, const bf16* bh, bf16* logits, bf16* h,
                            float2* stats, bf16* ctx, float* x1, bf16* m1, float* x2,
                            int B, int S, int D, int H, int HD, int M, int DN, int labels,
                            float eps, cudaStream_t st) {
  using namespace cls;
  const int KW = H * HD, mode = v_mode(HD, S);
  if (labels % 8 || !KvSmem(HD, S, mode, D).fits()) return cudaErrorInvalidValue;
  for (const void* p : {(const void*)x, (const void*)wq, (const void*)wkv, (const void*)stats,
                        (const void*)ctx, (const void*)h, (const void*)m1, (const void*)wo,
                        (const void*)w1, (const void*)w2, (const void*)wh, (const void*)x1,
                        (const void*)x2})
    if (!aligned16(p)) return cudaErrorInvalidValue;
  VPT_TRY(ln1_stats(x, stats, (long)B * S, D, DN, eps, st));
  g_cls_launches[LN1_STATS]++;
  cudaError_t rc;
  switch (HD) {
#define VPT_KV(N) \
  kv_attention_hd<N>(x, ln1g, ln1b, wq, bq, wkv, bkv, stats, ctx, B, S, D, H, mode, st)
    case 16: rc = VPT_KV(16); break;
    case 32: rc = VPT_KV(32); break;
    case 64: rc = VPT_KV(64); break;
    default: rc = VPT_KV(80); break;
#undef VPT_KV
  }
  VPT_TRY(rc);
  g_cls_launches[mode == V_REGISTERS ? KV_V_REGISTERS : mode == V_SHARED ? KV_V_SHARED
                                                                         : KV_V_RECOMPUTED]++;
  const TailArgs a{x, (long)S * D, bo, ln2g, ln2b, b1, b2, lnfg, lnfb, bh, x1, x2, h, m1, logits,
                   B, D, M, labels, DN, eps};
  VPT_TRY(cls_tail(a, ctx, wo, w1, w2, wh, KW, st));
  g_cls_launches[TAIL]++;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// float32, launch 1: the six weights' planes. Weight y of `jobs` (blockIdx.y)
// [K, N] into its hi, mid and lo planes [3][K][ldp] (ldp: N rounded up to 8,
// zeros past N), four values a thread over a grid-strided loop, as split6.cuh's
// split_planes_kernel does for one weight.
struct PlaneJob {
  const float* w;
  bf16* planes;
  long ldp;
  int K, N, wide;
};
struct PlaneJobs {
  PlaneJob j[6];
};

__global__ void __launch_bounds__(256)
cls_split_planes_kernel(const __grid_constant__ PlaneJobs jobs) {
  const PlaneJob& J = jobs.j[blockIdx.y];
  const long n = (long)J.K * J.ldp;
  for (long i = 4 * ((long)blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 4L * gridDim.x * blockDim.x) {
    const long k = i / J.ldp;
    const int c = static_cast<int>(i - k * J.ldp);  // a multiple of 4, as ldp is
    const float* row = J.w + k * J.N;
    float v[4];
    if (J.wide && c + 4 <= J.N) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(row + c));
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) v[t] = c + t < J.N ? __ldg(row + c + t) : 0.f;
    }
    float pl[3][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) split_bf16x3(v[t], pl[0][t], pl[1][t], pl[2][t]);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      uint2 u;
      u.x = pack_bf16x2(pl[p][0], pl[p][1]);
      u.y = pack_bf16x2(pl[p][2], pl[p][3]);
      *reinterpret_cast<uint2*>(J.planes + p * n + i) = u;
    }
  }
}

// ---------------------------------------------------------------------------
// float32, launch 3: LN1, the K and V products, q and the CLS attention. The
// bf16 launch's items (one image of one head group, two where S <= 64, one a
// warpgroup), two sweeps each: set 0 runs K (and, in the pass that holds the
// CLS row, q), set 1 runs V; each sweep its passes of 128 rows (two 64-row
// tiles), each pass its 32-deep k-steps. Threads: two consumer warpgroups,
// then eight producer warps.

struct KvF32Args {
  const float* x;
  const float2* stats;
  const float *ln1g, *ln1b, *bkv, *bq;
  bf16* ctxp;  // ctx's planes [3][B][KW]
  int B, S, D, H;
  float scale;
};

// d = the six passes of one 32-deep step over A's planes at a (this
// warpgroup's 64 rows) and W's at w (NBH boxes a plane), from zero; waited for
template <int HD>
__device__ __forceinline__ void kv_f32_step(float (&d)[cls::KvF32<HD>::NACC], uint32_t a,
                                            uint32_t w) {
  using G = cls::KvF32<HD>;
#pragma unroll
  for (int i = 0; i < G::NACC; ++i) d[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const uint32_t ap = a + cls::pass_a(p) * f3::PLANE_A;
    const uint32_t wp = w + cls::pass_w(p) * G::NBH * cls::F32_WBOX;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t da = gmma_desc64(ap + kk * 32);
      const uint64_t dw = gmma_desc(wp + kk * 2048, cls::F32_WBOX, 1024);
      if constexpr (G::WIDE)
        wgmma_m64n80k16(d, da, dw);
      else
        wgmma_m64n64k16<1>(d, da, dw);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
}

template <int HD>
__global__ void __launch_bounds__(cls::KvF32<HD>::THREADS, 1)
cls_kv_attention_f32_kernel(const __grid_constant__ CUtensorMap tw,
                            const __grid_constant__ CUtensorMap twq, const KvF32Args a) {
  using namespace cls;
  using G = KvF32<HD>;
  constexpr int NH = G::NH, W = G::W, NBH = G::NBH, NACC = G::NACC, NCP = G::NCP;
  constexpr int STAGE = G::STAGE, CONSUMERS = G::CONSUMERS, PRODUCERS = G::PRODUCERS;
  extern __shared__ unsigned char csm[];
  const uint32_t raw = smem_u32(csm);
  unsigned char* base = csm + (((raw + 1023) & ~1023u) - raw);
  const int B = a.B, S = a.S, D = a.D, H = a.H, KW = H * HD;
  const int ntiles = kv_tiles(S), spad = ntiles * 64;
  const KvF32Smem lay(HD, S);
  const int ST = lay.st;
  unsigned char* ring = base;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bars);
  uint64_t* empty = full + ST;
  float* logit = reinterpret_cast<float*>(base + lay.logits);  // [images][NH][spad]: logits, then P
  float* part = reinterpret_cast<float*>(base + lay.part);     // [8][W], then sums [2][W]
  float* qs = reinterpret_cast<float*>(base + lay.q);          // [2][W]
  float* bias = reinterpret_cast<float*>(base + lay.bias);     // the group's K, V, q biases [3][W]
  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup, as a value the compiler knows to be the same across the warp: a
  // wgmma under a condition it cannot prove uniform is serialized (ptxas C7520)
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int groups = (H + NH - 1) / NH, images = kv_images(S), packed = images == 2;
  const int npass = kv_passes(S), nk = (D + F32_BK - 1) / F32_BK;
  const int nim = (B + images - 1) / images, nitems = groups * nim;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(smem_u32(full + s), 1 + PRODUCERS);  // + the TMA's expected bytes
      mbar_init(smem_u32(empty + s), CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi >= CONSUMERS / 128) {  // --- producers ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::PRODUCER_REGS));
    // thread pt takes rows pt / 4 and pt / 4 + 64 of a pass's 128 (one in each
    // warpgroup's tile) and the 8 values from k = 8 (pt % 4) of each step
    const int pt = tid - CONSUMERS, rw = pt >> 2, ch = pt & 3;
    struct Step {
      int item, set, pass, kc;
    };
    auto advance = [&](Step& c) {
      if (++c.kc < nk) return;
      c.kc = 0;
      if (++c.pass < npass) return;
      c.pass = 0;
      if (++c.set < 2) return;
      c.set = 0;
      c.item += gridDim.x;
    };
    // a step's x values, its rows' statistics (rs < 0: a row past S or B, whose
    // values are zeros) and its 8 columns of LN1's g and b (zeros past D)
    struct Loaded {
      float v[2][8], g[8], b[8];
      float2 m[2];
    };
    auto load = [&](const Step& c, Loaded& l) {
      const int b0 = (c.item % nim) * images, k = c.kc * F32_BK + ch * 8;
      load8_f32(a.ln1g, k, D, true, l.g);
      load8_f32(a.ln1b, k, D, true, l.b);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int bw = b0 + (packed ? i : 0), tile = packed ? 0 : 2 * c.pass + i;
        const int tok = tile * 64 + rw;
        if (bw < B && tile < ntiles && tok < S) {
          const long row = (long)bw * S + tok;
          load8_f32(a.x + row * D, k, D, true, l.v[i]);
          l.m[i] = a.stats[row];
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t) l.v[i][t] = 0.f;
          l.m[i] = make_float2(0.f, -1.f);
        }
      }
    };
    int step = 0;
    // LN1 applied, split into the stage's A planes; W's planes by TMA (thread 0)
    auto produce = [&](const Step& c, const Loaded& l) {
      const int s = step % ST;
      if (step >= ST) mbar_wait(smem_u32(empty + s), ((step / ST) - 1) & 1);
      unsigned char* st = ring + s * STAGE;
      const uint32_t fb = smem_u32(full + s);
      if (pt == 0) {  // W's planes: K or V, and q.w in the K sweep's first pass
        const int g = c.item / nim;
        const bool withq = c.set == 0 && c.pass == 0;
        mbar_arrive_expect(fb, (withq ? 2 : 1) * 3 * NBH * F32_WBOX);
        const int col0 = (c.set ? KW : 0) + g * W;
        for (int p = 0; p < 3; ++p)
          for (int j = 0; j < NBH; ++j) {
            tma_load_3d(smem_u32(st + f32_w_off() + (p * NBH + j) * F32_WBOX), &tw, fb,
                        col0 + j * 64, c.kc * F32_BK, p);
            if (withq)
              tma_load_3d(smem_u32(st + f32_w_off() + ((3 + p) * NBH + j) * F32_WBOX), &twq,
                          fb, g * W + j * 64, c.kc * F32_BK, p);
          }
      }
      float h[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int t = 0; t < 8; ++t)  // LN1
          h[i][t] = l.m[i].y < 0.f ? 0.f : (l.v[i][t] - l.m[i].x) * l.m[i].y * l.g[t] + l.b[t];
      store_split_share(st, h, pt);
      // the generic-proxy stores become visible to wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(fb);
      ++step;
    };
    // two steps of loads in flight: the next one's while this one is split
    Step c{static_cast<int>(blockIdx.x), 0, 0, 0};
    Loaded l0, l1;
    load(c, l0);
    for (;;) {
      Step n = c;
      advance(n);
      const bool more = n.item < nitems;
      if (more) load(n, l1);
      produce(c, l0);
      if (!more) break;
      c = n;
      advance(c);
      const bool more2 = c.item < nitems;
      if (more2) load(c, l0);
      produce(n, l1);
      if (!more2) break;
    }
    return;
  }

  // --- consumers: warpgroup wg takes tile 2 pass + wg of the item's image, or
  // (packed) the one tile of the item's image wg ---
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::CONSUMER_REGS));
  const int warp = tid >> 5, wg = wgi, wl = warp & 3, ct = tid & 127;
  // the named barrier and the threads that take one image's epilogue together
  const int sid = packed ? 1 + wg : 3, sthreads = packed ? 128 : CONSUMERS;
  const int stid = packed ? ct : tid;
  float* lg = logit + (packed ? wg : 0) * NH * spad;
  float* qw = qs + (packed ? wg : 0) * W;
  float* cacc = part + 8 * W + (packed ? wg : 0) * W;
  float acc[NACC], sum[NACC], sumq[NACC];
  int step = 0, gprev = -1;
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int g = item / nim, b = (item % nim) * images + (packed ? wg : 0);
    const bool real = b < B;
    const int hv = min(NH, H - g * NH), wv = hv * HD;  // heads and columns of this group
    for (int c = stid; c < W; c += sthreads) cacc[c] = 0.f;
    if (g != gprev) {  // the group's biases (the previous item's readers are past the
                       // syncs of its epilogue; CONSUMERS-wide below)
      named_sync(3, CONSUMERS);
      for (int c = tid; c < W; c += CONSUMERS) {
        const bool in = c < wv;
        bias[c] = in ? a.bkv[g * W + c] : 0.f;
        bias[W + c] = in ? a.bkv[KW + g * W + c] : 0.f;
        bias[2 * W + c] = in ? a.bq[g * W + c] : 0.f;
      }
      named_sync(3, CONSUMERS);
      gprev = g;
    }
    named_sync(sid, sthreads);
    for (int set = 0; set < 2; ++set) {
      for (int pass = 0; pass < npass; ++pass) {
        const int tile = packed ? 0 : 2 * pass + wg;
        const bool active = real && tile < ntiles;
        const bool withq = set == 0 && tile == 0;  // this warpgroup holds the CLS row
#pragma unroll
        for (int i = 0; i < NACC; ++i) sum[i] = sumq[i] = 0.f;
        for (int kc = 0; kc < nk; ++kc, ++step) {
          const int s = step % ST;
          mbar_wait(smem_u32(full + s), (step / ST) & 1);
          if (active) {
            const uint32_t st = smem_u32(ring + s * STAGE);
            const uint32_t ap = st + wg * (64 * 64), wp = st + 3 * f3::PLANE_A;
            // each step's passes start from zero, added into the running sum in f32
            kv_f32_step<HD>(acc, ap, wp);
#pragma unroll
            for (int i = 0; i < NACC; ++i) sum[i] += acc[i];
            if (withq) {
              kv_f32_step<HD>(acc, ap, wp + 3 * NBH * F32_WBOX);
#pragma unroll
              for (int i = 0; i < NACC; ++i) sumq[i] += acc[i];
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(empty + s));
        }

        // the thread's rows: rbase + 8 ((i / 2) % 2)
        const int rbase = tile * 64 + wl * 16 + (lane >> 2);
        if (set == 0) {
          if (withq && active && wl == 0 && lane < 4)  // q of the CLS row (row 0)
#pragma unroll
            for (int i = 0; i < NACC; ++i)
              if (((i >> 1) & 1) == 0 && acc_col(i) < wv)
                qw[acc_col(i)] = sumq[i] + bias[2 * W + acc_col(i)];
          named_sync(sid, sthreads);
          if (active) {
            float lp[2][NH];
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int h = 0; h < NH; ++h) lp[r][h] = 0.f;
#pragma unroll
            for (int i = 0; i < NACC; ++i) {
              // an 8-column block lies in one head: h is known at compile time
              const int col = acc_col(i), h = 8 * (i >> 2) / HD, r = (i >> 1) & 1;
              if (col < wv) lp[r][h] = fmaf(qw[col], sum[i] + bias[col], lp[r][h]);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int h = 0; h < NH; ++h) {
                const float l = cls_quad_sum(lp[r][h]);
                const int j = rbase + 8 * r;
                if ((lane & 3) == 0 && h < hv && j < S) lg[h * spad + j] = l * a.scale;
              }
          }
          if (pass == npass - 1) {  // every logit is in: the softmax, one warp a head
            named_sync(sid, sthreads);
            const int sw = packed ? wl : warp;  // the warp's index in its image's warps
            if (real && sw < hv) {
              float* l = lg + sw * spad;
              float mx = -INFINITY;
              for (int j = lane; j < S; j += 32) mx = fmaxf(mx, l[j]);
              mx = warp_max(mx);
              float se = 0.f;
              for (int j = lane; j < S; j += 32) {
                const float e = expf(l[j] - mx);
                l[j] = e;
                se += e;
              }
              se = warp_sum(se);
              for (int j = lane; j < S; j += 32) l[j] = __fdiv_rn(l[j], se);
            }
            named_sync(sid, sthreads);
          }
        } else {
          // P V from this pass's V rows: each column's sum over this thread's two
          // rows, then over the warp's rows (lanes of equal lane % 4), per warp
          float cp[NCP];
#pragma unroll
          for (int c = 0; c < NCP; ++c) cp[c] = 0.f;
          if (active) {
#pragma unroll
            for (int i = 0; i < NACC; ++i) {
              const int vc = acc_col(i), j = rbase + 8 * ((i >> 1) & 1), h = 8 * (i >> 2) / HD;
              if (vc < wv && j < S)
                cp[(i >> 2) * 2 + (i & 1)] =
                    fmaf(lg[h * spad + j], sum[i] + bias[W + vc], cp[(i >> 2) * 2 + (i & 1)]);
            }
          }
#pragma unroll
          for (int c = 0; c < NCP; ++c) {
            cp[c] += __shfl_xor_sync(0xffffffffu, cp[c], 4);
            cp[c] += __shfl_xor_sync(0xffffffffu, cp[c], 8);
            cp[c] += __shfl_xor_sync(0xffffffffu, cp[c], 16);
          }
          if (lane < 4)
#pragma unroll
            for (int c = 0; c < NCP; ++c)
              part[warp * W + 8 * (c >> 1) + 2 * lane + (c & 1)] = cp[c];
          named_sync(sid, sthreads);
          const int w0 = packed ? 4 * wg : 0, nw = packed ? 4 : 8;
          for (int c = stid; c < W; c += sthreads) {  // the warps' partials in a fixed order
            float sacc = cacc[c];
            for (int w = 0; w < nw; ++w) sacc += part[(w0 + w) * W + c];
            cacc[c] = sacc;
          }
          named_sync(sid, sthreads);
        }
      }
    }
    if (real) {  // ctx as its three planes, the tail's A operand
      const long plane = (long)B * KW;
      bf16* out = a.ctxp + (long)b * KW + g * W;
      for (int c = stid; c < wv; c += sthreads) {
        float hi, mid, lo;
        split_bf16x3(cacc[c], hi, mid, lo);
        out[c] = __float2bfloat16(hi);
        out[plane + c] = __float2bfloat16(mid);
        out[2 * plane + c] = __float2bfloat16(lo);
      }
    }
  }
}

// bf16 planes [3][mid][inner] (a weight's or an activation's) as a TMA map with
// boxes [1][box_mid][64] and the 128-byte swizzle (zeros past every edge), kept
// per host thread as tma_map_2d keeps its maps
inline cudaError_t tma_map_planes(CUtensorMap* map, const bf16* base, uint64_t inner, uint64_t mid,
                                  uint32_t box_mid) {
  struct Entry {
    const bf16* base;
    uint64_t inner, mid;
    uint32_t box_mid;
    CUtensorMap map;
  };
  constexpr int kEntries = 32;
  thread_local Entry cache[kEntries] = {};
  thread_local int next = 0;
  for (const Entry& c : cache)
    if (c.base == base && c.inner == inner && c.mid == mid && c.box_mid == box_mid) {
      *map = c.map;
      return cudaSuccess;
    }
  VPT_TRY(tma_map_3d_64(map, base, inner, mid, 3, box_mid));
  cache[next] = Entry{base, inner, mid, box_mid, *map};
  next = (next + 1) % kEntries;
  return cudaSuccess;
}

template <int HD>
cudaError_t kv_attention_f32_hd(const KvF32Args& a, const bf16* wqp, const bf16* wkvp,
                                cudaStream_t st) {
  using namespace cls;
  const KvF32Smem lay(HD, a.S);
  if (!lay.fits()) return cudaErrorInvalidValue;
  const int KW = a.H * HD;
  CUtensorMap tw, twq;
  VPT_TRY(tma_map_planes(&tw, wkvp, f3::plane_width(2 * KW), a.D, F32_BK));
  VPT_TRY(tma_map_planes(&twq, wqp, f3::plane_width(KW), a.D, F32_BK));
  auto kernel = cls_kv_attention_f32_kernel<HD>;
  VPT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)lay.total));
  const int groups = (a.H + KvF32<HD>::NH - 1) / KvF32<HD>::NH;
  const int nitems = groups * ((a.B + kv_images(a.S) - 1) / kv_images(a.S));
  kernel<<<std::min(nitems, sm_count()), KvF32<HD>::THREADS, lay.total, st>>>(tw, twq, a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32, launch 4: the tail on the B rows, as launch 3 of bf16 (one 64-row
// tile a cluster, block `rank` of C taking product tiles rank, rank + C, ...
// and rows rank, rank + C, ... of each LayerNorm), every product split.

struct TailF32Args {
  const float* x;  // the CLS rows: x + m * x_row
  long x_row;
  const float *bo, *ln2g, *ln2b, *b1, *b2, *lnfg, *lnfb, *bh;
  float *x1, *x2, *logits;
  bf16 *hp, *m1p;  // LN2's (then LN_f's) output [3][B][D] and the GELU output [3][B][M], planes
  float* partial;  // the products' partial sums, [row tiles][kTailUnits][64][128]
  int B, D, M, L, DN;
  float eps;
};

// How a product's k-boxes are split over the cluster: each 128-column tile's
// nk 64-deep boxes in ks ranges (unit u: tile u / ks, boxes [p nk / ks, (p + 1)
// nk / ks) with p = u % ks), units rank, rank + C, ... to block `rank`; ks
// (at most kTailUnits / ntiles ranges) the least stages on the busiest block.
// ks > 1: the units' sums are partials, added in a fixed order after a cluster
// barrier.
constexpr int kTailUnits = 64;
__device__ __forceinline__ int tail_ksplit(int ntiles, int nk, int C) {
  int best = 1, cost = (ntiles + C - 1) / C * nk;
  for (int ks = 2; ks <= nk && ntiles * ks <= kTailUnits; ++ks) {
    const int c = (ntiles * ks + C - 1) / C * ((nk + ks - 1) / ks);
    if (c < cost) {
      cost = c;
      best = ks;
    }
  }
  return best;
}

// out[64 rows from m0, N] = A[., K] @ W[K, N] from A's planes (ta) and W's (tw),
// this block's units (tail_ksplit); two consumer warpgroups, one a 64-column half
// of each 128-column tile, issuing their products side by side;
// each 64-deep stage two 32-deep steps of six passes, each step's sum added to
// the running one in f32; the epilogue epi(row, col, v0, v1) on each pair of
// columns (col, col + 1) of a unit's sum where ks is 1, else the sums stored as
// the ranges' partials [units][64][128] (this row tile's, at `partial`). The
// producer warp returns at the end of its loads, as in tail_gemm
template <typename Epi>
__device__ __forceinline__ void tail32_gemm(const CUtensorMap* ta, const CUtensorMap* tw, int N,
                                            int K, int ks, int B, int m0, unsigned char* ring,
                                            uint64_t* full, uint64_t* empty, int& step,
                                            float* partial, Epi epi) {
  using namespace cls;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), wl = warp & 3;
  const int rank = blockIdx.x, C = gridDim.x;
  const int nk = (K + 63) / 64, units = (N + 127) / 128 * ks;
  if (wg == 2) {  // producer
    if (lane == 0)
      for (int u = rank; u < units; u += C) {
        const int tile = u / ks, p = u % ks;
        for (int kc = p * nk / ks; kc < (p + 1) * nk / ks; ++kc, ++step) {
          const int s = step % TAIL32_STAGES;
          if (step >= TAIL32_STAGES)
            mbar_wait(smem_u32(empty + s), ((step / TAIL32_STAGES) - 1) & 1);
          unsigned char* st = ring + s * TAIL32_STAGE;
          const uint32_t fb = smem_u32(full + s);
          mbar_arrive_expect(fb, TAIL32_STAGE);
          for (int pl = 0; pl < 3; ++pl) {
            tma_load_3d(smem_u32(st + pl * BOX), ta, fb, kc * 64, m0, pl);
            tma_load_3d(smem_u32(st + (3 + 2 * pl) * BOX), tw, fb, tile * 128, kc * 64, pl);
            tma_load_3d(smem_u32(st + (4 + 2 * pl) * BOX), tw, fb, tile * 128 + 64, kc * 64, pl);
          }
        }
      }
    __syncwarp();
    return;
  }
  for (int u = rank; u < units; u += C) {
    const int tile = u / ks, p = u % ks;
    float acc[32], sum[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[i] = 0.f;
    for (int kc = p * nk / ks; kc < (p + 1) * nk / ks; ++kc, ++step) {
      const int s = step % TAIL32_STAGES;
      mbar_wait(smem_u32(full + s), (step / TAIL32_STAGES) & 1);
      const uint32_t st = smem_u32(ring + s * TAIL32_STAGE);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const uint32_t ap = st + pass_a(q) * BOX, wp = st + (3 + 2 * pass_w(q) + wg) * BOX;
#pragma unroll
          for (int kk = 2 * half; kk < 2 * half + 2; ++kk)
            wgmma_m64n64k16<1>(acc, gmma_desc(ap + kk * 32, 16, 1024),
                               gmma_desc(wp + kk * 2048, BOX, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) sum[i] += acc[i];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(empty + s));
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = wl * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int c = 64 * wg + 8 * (i >> 2) + 2 * (lane & 3);
      if (m0 + r >= B) continue;
      if (ks == 1) {
        if (tile * 128 + c < N) epi(m0 + r, tile * 128 + c, sum[i], sum[i + 1]);
      } else {
        *reinterpret_cast<float2*>(partial + (long)u * 8192 + r * 128 + c) =
            make_float2(sum[i], sum[i + 1]);
      }
    }
  }
}

// a product of the tail: tail32_gemm, then (ks > 1) the partials of each tile's
// ranges added in their order, after a cluster barrier, and the epilogue
template <typename Epi>
__device__ __forceinline__ void tail32_product(const CUtensorMap* ta, const CUtensorMap* tw, int N,
                                               int K, int B, int m0, unsigned char* ring,
                                               uint64_t* full, uint64_t* empty, int& step,
                                               float* partial, Epi epi) {
  const int rank = blockIdx.x, C = gridDim.x;
  const int ks = tail_ksplit((N + 127) / 128, (K + 63) / 64, C);
  tail32_gemm(ta, tw, N, K, ks, B, m0, ring, full, empty, step, partial, epi);
  if (ks == 1) return;
  tail_cluster_sync();
  const int rows = min(64, B - m0), pairs = N / 2;
  for (int e = rank * cls::TAIL32_THREADS + threadIdx.x; e < rows * pairs;
       e += C * cls::TAIL32_THREADS) {
    const int r = e / pairs, c = 2 * (e - r * pairs), tile = c >> 7;
    const float* src = partial + (long)tile * ks * 8192 + r * 128 + (c & 127);
    float2 v = make_float2(0.f, 0.f);
#pragma unroll 8
    for (int p = 0; p < ks; ++p) {
      const float2 w = *reinterpret_cast<const float2*>(src + (long)p * 8192);
      v.x += w.x;
      v.y += w.y;
    }
    epi(m0 + r, c, v.x, v.y);
  }
}

// the three planes of v0, v1 at columns (c, c + 1) of row r of planes p [3][B][n]
__device__ __forceinline__ void store_split2(bf16* p, long plane, long o, float v0, float v1) {
  float h0, m0, l0, h1, m1, l1;
  split_bf16x3(v0, h0, m0, l0);
  split_bf16x3(v1, h1, m1, l1);
  *reinterpret_cast<uint32_t*>(p + o) = pack_bf16x2(h0, h1);
  *reinterpret_cast<uint32_t*>(p + plane + o) = pack_bf16x2(m0, m1);
  *reinterpret_cast<uint32_t*>(p + 2 * plane + o) = pack_bf16x2(l0, l1);
}

// y = LN(x[row]) in f32 as its planes [3][B][D], this block's rows of the tile,
// a warp a row; ln_stats' two passes with eight loads of a lane in flight (the rows
// come from L2, written by the other blocks of the cluster)
__device__ __forceinline__ void tail32_ln(const float* x, const float* g, const float* bb, bf16* yp,
                                          int B, int D, int DN, float eps, int m0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = blockIdx.x, C = gridDim.x;
  const long plane = (long)B * D;
  for (int r = rank + C * warp; r < 64 && m0 + r < B; r += C * 8) {
    const float* xr = x + (long)(m0 + r) * D;
    float s = 0.f;
#pragma unroll 8
    for (int i = lane; i < DN; i += 32) s += xr[i];
    const float mean = warp_sum(s) / DN;
    float v = 0.f;
#pragma unroll 8
    for (int i = lane; i < DN; i += 32) {
      const float e = xr[i] - mean;
      v += e * e;
    }
    const float rs = rsqrtf(warp_sum(v) / DN + eps);
    bf16* yr = yp + (long)(m0 + r) * D;
#pragma unroll 8
    for (int i = lane; i < D; i += 32) {
      float hi, mid, lo;
      split_bf16x3((xr[i] - mean) * rs * g[i] + bb[i], hi, mid, lo);
      yr[i] = __float2bfloat16(hi);
      yr[plane + i] = __float2bfloat16(mid);
      yr[2 * plane + i] = __float2bfloat16(lo);
    }
  }
}

__global__ void __launch_bounds__(cls::TAIL32_THREADS, 1)
cls_tail_f32_kernel(const __grid_constant__ CUtensorMap tctx,
                    const __grid_constant__ CUtensorMap two,
                    const __grid_constant__ CUtensorMap th,
                    const __grid_constant__ CUtensorMap tw1,
                    const __grid_constant__ CUtensorMap tm1,
                    const __grid_constant__ CUtensorMap tw2,
                    const __grid_constant__ CUtensorMap twh, const __grid_constant__ TailF32Args a,
                    int KW) {
  using namespace cls;
  extern __shared__ unsigned char tsm[];
  const uint32_t raw = smem_u32(tsm);
  unsigned char* ring = tsm + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + TAIL32_STAGES * TAIL32_STAGE);
  uint64_t* empty = full + TAIL32_STAGES;
  const int m0 = blockIdx.y * 64, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TAIL32_STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int step = 0;
  const long mplane = (long)a.B * a.M;
  float* partial = a.partial + (long)blockIdx.y * kTailUnits * 8192;
  // 1. x1 = x_cls + (ctx Wo + bo)
  tail32_product(&tctx, &two, a.D, KW, a.B, m0, ring, full, empty, step, partial,
                 [&](int r, int c, float v0, float v1) {
                   const float* xr = a.x + r * a.x_row + c;
                   *reinterpret_cast<float2*>(a.x1 + (long)r * a.D + c) =
                       make_float2(xr[0] + (v0 + a.bo[c]), xr[1] + (v1 + a.bo[c + 1]));
                 });
  tail_cluster_sync();
  // 2. h = LN2(x1)
  if (warp < 8) tail32_ln(a.x1, a.ln2g, a.ln2b, a.hp, a.B, a.D, a.DN, a.eps, m0);
  tail_cluster_sync();
  // 3. m1 = GELU(h W1 + b1), erf form
  tail32_product(&th, &tw1, a.M, a.D, a.B, m0, ring, full, empty, step, partial,
                 [&](int r, int c, float v0, float v1) {
                   store_split2(a.m1p, mplane, (long)r * a.M + c, gelu(v0 + a.b1[c], ACT_GELU_ERF),
                                gelu(v1 + a.b1[c + 1], ACT_GELU_ERF));
                 });
  tail_cluster_sync();
  // 4. x2 = x1 + (m1 W2 + b2)
  tail32_product(&tm1, &tw2, a.D, a.M, a.B, m0, ring, full, empty, step, partial,
                 [&](int r, int c, float v0, float v1) {
                   const float2 x1 = *reinterpret_cast<const float2*>(a.x1 + (long)r * a.D + c);
                   *reinterpret_cast<float2*>(a.x2 + (long)r * a.D + c) =
                       make_float2(x1.x + (v0 + a.b2[c]), x1.y + (v1 + a.b2[c + 1]));
                 });
  tail_cluster_sync();
  // 5. h = LN_f(x2)
  if (warp < 8) tail32_ln(a.x2, a.lnfg, a.lnfb, a.hp, a.B, a.D, a.DN, a.eps, m0);
  tail_cluster_sync();
  // 6. logits = h Wh + bh, f32
  tail32_product(&th, &twh, a.L, a.D, a.B, m0, ring, full, empty, step, partial,
                 [&](int r, int c, float v0, float v1) {
                   *reinterpret_cast<float2*>(a.logits + (long)r * a.L + c) =
                       make_float2(v0 + a.bh[c], v1 + a.bh[c + 1]);
                 });
}

cudaError_t cls_tail_f32(const TailF32Args& a, const bf16* ctxp, const bf16* wop, const bf16* w1p,
                         const bf16* w2p, const bf16* whp, int KW, cudaStream_t st) {
  using namespace cls;
  CUtensorMap tctx, two, th, tw1, tm1, tw2, twh;
  VPT_TRY(tma_map_planes(&tctx, ctxp, KW, a.B, 64));
  VPT_TRY(tma_map_planes(&two, wop, f3::plane_width(a.D), KW, 64));
  VPT_TRY(tma_map_planes(&th, a.hp, a.D, a.B, 64));
  VPT_TRY(tma_map_planes(&tw1, w1p, f3::plane_width(a.M), a.D, 64));
  VPT_TRY(tma_map_planes(&tm1, a.m1p, a.M, a.B, 64));
  VPT_TRY(tma_map_planes(&tw2, w2p, f3::plane_width(a.D), a.M, 64));
  VPT_TRY(tma_map_planes(&twh, whp, f3::plane_width(a.L), a.D, 64));
  const int C = tail_cluster(a.B);
  VPT_TRY(cudaFuncSetAttribute(cls_tail_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)TAIL32_SMEM));
  if (C > 8)
    VPT_TRY(cudaFuncSetAttribute(cls_tail_f32_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (a.B + 63) / 64, 1);
  cfg.blockDim = dim3(TAIL32_THREADS, 1, 1);
  cfg.dynamicSmemBytes = TAIL32_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  VPT_TRY(cudaLaunchKernelEx(&cfg, cls_tail_f32_kernel, tctx, two, th, tw1, tm1, tw2, twh, a, KW));
  return cudaGetLastError();
}

// the elements of the six weights' planes in the workspace, in their order (q,
// kv, o, fc1, fc2, the classifier): 3 K plane_width(N) each
inline long f32_plane_elems(int K, int N) { return 3L * K * f3::plane_width(N); }

// the float32 route: launches 1-4
cudaError_t cls_logits_f32(const float* x, const float* ln1g, const float* ln1b, const float* wq,
                           const float* bq, const float* wkv, const float* bkv, const float* wo,
                           const float* bo, const float* ln2g, const float* ln2b, const float* w1,
                           const float* b1, const float* w2, const float* b2, const float* lnfg,
                           const float* lnfb, const float* wh, const float* bh, float* logits,
                           bf16* hp, float2* stats, float* partial, bf16* ctxp, float* x1,
                           bf16* m1p, float* x2, bf16* wplanes, int B, int S, int D, int H, int HD,
                           int M, int DN, int labels, float eps, cudaStream_t st) {
  using namespace cls;
  const int KW = H * HD;
  if (labels % 8 || !KvF32Smem(HD, S).fits()) return cudaErrorInvalidValue;
  for (const void* p :
       {(const void*)x, (const void*)ln1g, (const void*)ln1b, (const void*)stats,
        (const void*)partial, (const void*)hp, (const void*)ctxp, (const void*)m1p, (const void*)x1,
        (const void*)x2, (const void*)wplanes, (const void*)logits})
    if (!p || !aligned16(p)) return cudaErrorInvalidValue;
  // 1. the planes of q, kv, o, fc1, fc2 and the classifier, in that order
  const float* ws[6] = {wq, wkv, wo, w1, w2, wh};
  const int ks[6] = {D, D, KW, D, M, D}, ns[6] = {KW, 2 * KW, D, M, D, labels};
  PlaneJobs jobs;
  bf16* wp[6];
  long off = 0, most = 0;
  for (int i = 0; i < 6; ++i) {
    wp[i] = wplanes + off;
    jobs.j[i] = PlaneJob{ws[i], wp[i], f3::plane_width(ns[i]), ks[i], ns[i],
                         aligned16(ws[i]) && ns[i] % 4 == 0};
    off += f32_plane_elems(ks[i], ns[i]);
    most = std::max(most, (long)ks[i] * f3::plane_width(ns[i]));
  }
  const long blocks = std::min((most / 4 + 255) / 256, 4L * sm_count());
  cls_split_planes_kernel<<<dim3(static_cast<unsigned>(blocks), 6), 256, 0, st>>>(jobs);
  VPT_TRY(cudaGetLastError());
  g_cls_launches[F32_SPLIT_PLANES]++;
  // 2. LN1's statistics
  VPT_TRY(ln1_stats(x, stats, (long)B * S, D, DN, eps, st));
  g_cls_launches[LN1_STATS]++;
  // 3. K, V, q and the CLS attention
  const KvF32Args ka{x, stats, ln1g, ln1b, bkv, bq, ctxp, B, S, D, H, cls_scale(HD)};
  cudaError_t rc;
  switch (HD) {
    case 16: rc = kv_attention_f32_hd<16>(ka, wp[0], wp[1], st); break;
    case 32: rc = kv_attention_f32_hd<32>(ka, wp[0], wp[1], st); break;
    case 64: rc = kv_attention_f32_hd<64>(ka, wp[0], wp[1], st); break;
    default: rc = kv_attention_f32_hd<80>(ka, wp[0], wp[1], st); break;
  }
  VPT_TRY(rc);
  g_cls_launches[F32_KV_K_THEN_V]++;
  // 4. the tail
  const TailF32Args ta{x, (long)S * D, bo, ln2g, ln2b, b1, b2, lnfg, lnfb, bh, x1, x2, logits, hp,
                       m1p, partial, B, D, M, labels, DN, eps};
  VPT_TRY(cls_tail_f32(ta, ctxp, wp[2], wp[3], wp[4], wp[5], KW, st));
  g_cls_launches[F32_TAIL]++;
  return cudaSuccess;
}

}  // namespace vpt

using namespace vpt;

extern "C" {

// The launches a call makes, by kind (cls::Kind, KINDS counts), for dtype 0
// (float32) or 1 (bfloat16) at head dim hd, S tokens and hidden width D (the
// kernel's, padded): 0, or -1 where the kernel refuses the shape. Mirrored by ops/cuda/layer.py::
// cls_logits_launches.
int vpt_cls_logits_plan(int dtype, int hd, int S, int D, long long* out) {
  using namespace cls;
  for (int k = 0; k < KINDS; ++k) out[k] = 0;
  if (!layer_head_dim_ok(hd) || S < 1 || (dtype != 0 && dtype != 1)) return -1;
  if (dtype == 0) {
    if (!KvF32Smem(hd, S).fits()) return -1;
    out[F32_SPLIT_PLANES] = out[LN1_STATS] = out[F32_KV_K_THEN_V] = out[F32_TAIL] = 1;
    return 0;
  }
  const int mode = v_mode(hd, S);
  if (!KvSmem(hd, S, mode, D).fits()) return -1;
  out[LN1_STATS] = 1;
  out[mode == V_REGISTERS ? KV_V_REGISTERS : mode == V_SHARED ? KV_V_SHARED : KV_V_RECOMPUTED] = 1;
  out[TAIL] = 1;
  return 0;
}

// launches of each kind since the last reset
void vpt_cls_logits_launch_counts(long long* out) {
  for (int k = 0; k < cls::KINDS; ++k) out[k] = g_cls_launches[k].load();
}

void vpt_cls_logits_launch_reset() {
  for (int k = 0; k < cls::KINDS; ++k) g_cls_launches[k] = 0;
}

// dtype: 0 = float32, 1 = bfloat16. x [B, S, D]; 18 weights (LN1, Q, the
// fused KV [D, 2KW], O, LN2, fc1, fc2, LN_f, the classifier [D, labels]);
// logits [B, labels] in the dtype, labels a multiple of 8. Workspaces,
// bfloat16: h [B, D], kv: LN1's statistics [B*S + 72] f32 pairs, q unused
// (null), ctx [B, KW] and m1 [B, M] in bf16, x1 and x2 [B, D] f32, wplanes
// null; float32: h, ctx and m1 as their three bf16 planes ([3][B][D],
// [3][B][KW], [3][B][M]), kv: LN1's statistics as bf16's, q: the tail's
// partial sums [ceil(B / 64)][64][64][128] f32, x1
// and x2 [B, D] f32, and wplanes the six weights' planes in turn (q, kv, o,
// fc1, fc2, the classifier: 3 K plane_width(N) bf16 each, split6.cuh). Every
// buffer 16-byte aligned. DN: the layer norms' width, as
// vpt_vit_layer_forward's.
int vpt_vit_cls_logits_forward(int dtype, const void* x, const void* ln1g, const void* ln1b,
                               const void* wq, const void* bq, const void* wkv, const void* bkv,
                               const void* wo, const void* bo, const void* ln2g, const void* ln2b,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               const void* lnfg, const void* lnfb, const void* wh, const void* bh,
                               void* logits, void* h, void* kv, void* q, void* ctx, void* x1,
                               void* m1, void* x2, void* wplanes, int B, int S, int D, int H,
                               int HD, int M, int DN, int labels, float eps, void* stream) {
  if (!shapes_ok(dtype, B, S, D, H, HD, M, DN) || labels <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
#define F(p) static_cast<const float*>(p)
    return cls_logits_f32(F(x), F(ln1g), F(ln1b), F(wq), F(bq), F(wkv), F(bkv), F(wo), F(bo),
                          F(ln2g), F(ln2b), F(w1), F(b1), F(w2), F(b2), F(lnfg), F(lnfb), F(wh),
                          F(bh), (float*)logits, (bf16*)h, (float2*)kv, (float*)q, (bf16*)ctx,
                          (float*)x1, (bf16*)m1, (float*)x2, static_cast<bf16*>(wplanes), B, S,
                          D, H, HD, M, DN, labels, eps, st);
#undef F
  }
#define T(p) static_cast<const bf16*>(p)
  return cls_logits_bf16(T(x), T(ln1g), T(ln1b), T(wq), T(bq), T(wkv), T(bkv), T(wo), T(bo),
                         T(ln2g), T(ln2b), T(w1), T(b1), T(w2), T(b2), T(lnfg), T(lnfb), T(wh),
                         T(bh), (bf16*)logits, (bf16*)h, (float2*)kv, (bf16*)ctx,
                         (float*)x1, (bf16*)m1, (float*)x2, B, S, D, H, HD, M, DN, labels, eps,
                         st);
#undef T
}

}  // extern "C"
