#!/usr/bin/env python3
"""Where the hand-written bodies of kernels B1, B2, B4, B6, B7 and B8a, the f32 split
GEMM body and the f32 attention body spend their time, on one GPU; whether phases 3m, 4
and 3n of chip_smoke.py catch faults planted in B1-B5's attention bodies, in B2's
launches and in the split body; and the layer kernels' times for a checkout.

    python3 kernel_variants.py [b7] [b6] [b4] [b8a] [b1] [b2] [split]
                                                                (no argument: the first six)

Each kernel is built again from its sources (vit_pruning_tpu_torch/csrc) with one
stage taken out or swapped: a diagnostic variant, not a kernel of the port. Each
variant is built into a library of its own, the libraries are loaded side by side,
and every variant is timed at the main path's shapes in bf16, the real kernel first
and last (CUDA events, mean of 20 after 3 warm-ups):
  - B7: DeiT-S's MLP on 100,864 rows;
  - B6: 512 x 6 heads of 64 at S 197, masked;
  - B4: the whole int8 layer at DeiT-S, batch 512, S 197, unmasked;
  - B8a: the uint8 patch embedding at DeiT-S batch 512 (K 768) and ViT-H batch 64
    (K 588);
  - B1, for the attention body it shares with B3, B4 and B5 (csrc/layer_attention.cu):
    the whole bf16 layer at DeiT-S, batch 512, S 197 and 99 (the resident body) and
    ViT-H, batch 64, S 257 (the streamed one), unmasked; each variant of the attention
    body is also compiled with ptxas -v, and the registers and spills of its
    instances are printed;
  - B2 (csrc/cls_logits.cu), through its C entry at B2_SHAPES (DeiT-S batch 512 at S 99,
    33, 17, full and composed width; ViT-H batch 64 at S 129): where V lives (the
    accumulators, shared memory, recomputed), the K/V launch's ring (three stages), the
    items by head group, its CLS attention epilogue, LN1 or q left out, the tail's
    cluster (8, 16); every variant compiled with
    ptxas -v, the registers and spills of every instance printed;
  - split: the f32 attention body (csrc/split_attention.cuh, under B1-B5's f32
    attention and B6's f32 route), through B6's C entry in f32 at DeiT-S batch 32 (6
    heads of 64, S 197, masked: the work of B1's f32 attention at ViT-B/16 batch 16),
    ViT-H's hd 80 at S 257 (batch 8) and S 577 (DeiT-S at 384, batch 8): the split
    pass alone, the body alone, two passes where one does; every variant compiled
    with ptxas -v, the registers and spills of the split kernels printed.
Each line gives the variant's time and its largest distance from the real kernel's
output: 0 where a variant computes the same numbers another way.

    python3 kernel_variants.py faults

builds the attention body again with a fault planted in it (ATTENTION_FAULTS: masked
keys taken as valid, a uniform softmax, a misplaced chunk of V, a wrong normaliser),
loads each library in the package's place and runs chip_smoke.py's isolated attention
cases (phase 3m's attention_isolated) through the wrappers; then the same for the f32
attention body (SPLIT_FAULTS: masked keys taken as valid, the mid.hi pass of QK^T
dropped, the lo planes of q, k and v zeroed, a wrong normaliser); then the same for B2's
launches (B2_FAULTS: a uniform softmax, the last key tile dropped, another head's V, P
left unnormalised) with phase 4's cls_attention_isolated, and for B2's float32 launches
(B2_F32_FAULTS: a uniform softmax, the last key tile dropped, another head's V, the
weights' lo planes zeroed, one accumulator over K) with its f32 cases
(cls_attention_isolated_f32). The real kernels must pass every case and each fault must
fail some; it exits non-zero otherwise.

    python3 kernel_variants.py f32

builds csrc/gemm.cu again with one stage of the f32 split body (the body under every f32
product of B1, B2, B3 and B5) taken out (F32_VARIANTS: no wgmma, no split of A, no loads
of A, no TMA loads of W's planes, one pass) and times each through vpt_gemm_f32 at ViT-B/16's four products (batch 16, S 197),
the kernel first and last; ptxas's registers and spills for each. Then it plants the
faults of F32_FAULTS (hi.hi alone, the mid.hi pass dropped, both lo planes zeroed) and
runs phase 3n's cases (chip_smoke.py::f32_split_products) through ops/cuda/gemm.py's
gemm_f32 on each library: the real body must pass every case and each fault must fail
some; it exits non-zero otherwise.

    python3 kernel_variants.py times [CHECKOUT] [f32]

times the layer kernels B1, B2, B3, B4 and B5 and the dense forward's attention family in
bf16 for the package of CHECKOUT (default: this one; another commit unpacked with `git
archive`, say, whose kernels are then built there), alone in its process. To compare
two commits, run parent, change, change, parent in one call on one card. The shapes
are the main path's: DeiT-S at batch 512 (S 197 and 99; B3 at S 197 with capacity 99,
every image full; B1 at S 577, batch 128: DeiT-S at 384), ViT-H at batch 64 (S 257
and 129), random weights and inputs from fixed seeds; CUDA events, the mean of 10
launches after 3 (5 after 3 for the longer ones); the dense forward's device time by
kernel family (attention or not) from torch.profiler over 3 forwards; B2 at B2_SHAPES
(CUDA events, and each of its launches' device us with the gap before it, from
torch.profiler); the headline, composed and ultra forwards (serving_forward from uint8,
DeiT-S batch 512, ending in B2). It prints one JSON object of the times (ms) with the
card's name and power limit. It also times the f32 routes (f32_times: B1 launch by launch at
ViT-B/16 batch 16, DeiT-S batch 32 and the gate model, B2 (launch by launch too, beside
chip_smoke.py's CLS-only composition), B3, B5 and B6 at DeiT-S batch 32;
B7 at DeiT-S batch 32 and ViT-H width, B8b and B8a with f32 weights at DeiT-S and ViT-H
batch 32, each launch by launch, with its body and its PyTorch composition; the f32
head_mask forward and the CLI's f32 eval forward on both paths); with `f32` last, only
those.

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda), like chip_smoke.py; the
last line is the card's name and power limit.
"""

import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke  # this checkout's, before `times` puts another package first on the path

# (name, what it shows, [(source file, its text, the replacement)])
B7_VARIANTS = [
    ("kernel", "the kernel as it is", []),
    ("no GELU", "h + b1 split as it is: the cost of the erf GELU",
     [("mlp.cu", "gelu(h[2 * p + t] + __bfloat162float(b1[m + t]), ACT_GELU_ERF)",
       "h[2 * p + t] + __bfloat162float(b1[m + t])")]),
    ("hi pass only", "one bf16 pass of the second product instead of three",
     [("mlp.cu", "    for (int pl = 2; pl >= 0; --pl)  // lo, mid, hi\n",
       "    for (int pl = 0; pl >= 0; --pl)  // hi\n")]),
    ("no second product", "the output warpgroups wait and release, no wgmma",
     [("mlp.cu", "        wgmma_out<NB>(acc,", "        if (ch < 0) wgmma_out<NB>(acc,")]),
    ("no first product", "h = 0, no x W1 wgmma",
     [("mlp.cu", "          wgmma_m64n64k16<1>(h, gmma_desc(xa + kk * 32, 16, 1024),",
       "          if (kb < 0) wgmma_m64n64k16<1>(h, gmma_desc(xa + kk * 32, 16, 1024),")]),
]
B6_DIVIDE = """      const float e = expf(v - mx[r]), q = e * rc[r];
      return __fmaf_rn(__fmaf_rn(-q, sum[r], e), rc[r], q);"""
B6_VARIANTS = [
    ("kernel", "the kernel as it is (P by Markstein's correction)", []),
    ("IEEE division", "P = __fdiv_rn(e, sum): the same quotient",
     [("attention.cu", B6_DIVIDE, "      return __fdiv_rn(expf(v - mx[r]), sum[r]);")]),
    ("reciprocal multiply", "P = e * (1 / sum): not the division's quotient",
     [("attention.cu", B6_DIVIDE, "      return expf(v - mx[r]) * rc[r];")]),
    ("fast exp", "__expf in pass 2: not expf's value",
     [("attention.cu", B6_DIVIDE, B6_DIVIDE.replace("expf(", "__expf("))]),
]
B4_VARIANTS = [
    ("kernel", "the kernel as it is", []),
    ("no products", "every wgmma of the four int8 products left out (the sums stay 0)",
     [("wgmma_s8.cuh", "      wgmma_m64n128k32_s8(acc, gmma_desc(a0",
       "      if (kk < 0) wgmma_m64n128k32_s8(acc, gmma_desc(a0")]),
    ("no row passes", "ctx's and the GELU output's row quantization left out (O and fc2 "
     "read the codes an earlier call left)",
     [("layer_int8.cu", "  VPT_TRY(rowquant<T>(ctx, KW, q_ctx, s_ctx, rows, KW, st));\n", ""),
      ("layer_int8.cu", "  VPT_TRY(rowquant<T>(m1, M, q_gelu, s_gelu, rows, M, st));\n", "")]),
    ("no attention", "ctx left as it was",
     [("layer_int8.cu", "  VPT_TRY(attention(qkv, mask, nullptr, ctx, B, S, H, KW, st, false, aplanes));\n", "")]),
    ("no product epilogues", "the four products' dequant, bias, GELU, residual and stores left "
     "out",
     [("layer_int8.cu", "    if (m >= M || n >= N) return;\n    const float r = __ldg(rs + m);",
       "    if (m >= M || n >= N || M > 0) return;\n    const float r = __ldg(rs + m);")]),
]
B8A_VARIANTS = [
    ("kernel", "the kernel as it is", []),
    ("no affine", "the uint8 value rounded to bf16 as it is, no x * scale + shift",
     [("wgmma.cuh", "      return __fadd_rn(__fmul_rn(x, scale), shift);",
       "      return x;")]),
]
LA_EXP = "      l[c][i] = expf(l[c][i] - mx[(i >> 1) & 1]);\n"
LA_EXP2 = "    for (int i = 0; i < 32; ++i) l[i] = expf(l[i] - mx[(i >> 1) & 1]);\n"
B1_VARIANTS = [
    ("kernel", "the attention body as it is", []),
    ("registers unbound", "the resident body's launch bound left to ptxas (255 registers at 4 "
     "chunks: two blocks an SM)",
     [("layer_attention.cu", "__launch_bounds__(128, la_blocks(HD, NKC))",
       "__launch_bounds__(128)")]),
    ("one pass to 320 keys", "the resident body up to 5 chunks: S 257 in one pass, not two",
     [("layer_attention.cu", "constexpr int kLogitChunks = 4;", "constexpr int kLogitChunks = 5;"),
      ("layer_attention.cu", "    default: return go(layer_attention_stream_kernel<HD>, 2);",
       "    case 5: return go(layer_attention_kernel<HD, 5>, 5);\n"
       "    default: return go(layer_attention_stream_kernel<HD>, 2);"),
      ("layer_attention.cu", "static_assert(la::kLogitChunks == 4,", "static_assert(la::kLogitChunks == 5,")]),
    ("streamed at 4 chunks", "S 193-256 on the streamed body (two passes, no logits held) "
     "instead of the resident one, which spills at 4 chunks up to hd 64",
     [("layer_attention.cu", "    case 4: return go(layer_attention_kernel<HD, 4>, 4);\n", "")]),
    ("fast exp", "__expf for P's numerators: not expf's value",
     [("layer_attention.cu", LA_EXP, LA_EXP.replace("expf(", "__expf(")),
      ("layer_attention.cu", LA_EXP2, LA_EXP2.replace("expf(", "__expf("))]),
]
# Faults planted in the attention body, each of which chip_smoke.py's phase 3m
# must catch in its isolated cases (attention_isolated): `faults` runs those
# cases through the package's wrappers on each library and counts the failures
# (the key flags and the quad sums are wgmma.cuh's, shared by both attention bodies: a
# fault planted there reaches only the unit built from the variant's copy)
ATTN_FLAG = "    l[i] = f == 1 ? l[i] * scale : f == 2 ? kMaskedLogit : -INFINITY;\n"
QUAD_SUM = "  return s + __shfl_xor_sync(0xffffffffu, s, 2);"
ATTENTION_FAULTS = [
    ("kernel", "the attention body as it is: no case may fail", []),
    ("mask ignored", "masked keys taken as valid",
     [("wgmma.cuh", ATTN_FLAG, ATTN_FLAG.replace("f == 2 ? kMaskedLogit", "f == 2 ? l[i] * scale"))]),
    ("uniform softmax", "every valid key's logit 0: the average of the valid keys",
     [("wgmma.cuh", ATTN_FLAG, ATTN_FLAG.replace("f == 1 ? l[i] * scale", "f == 1 ? 0.f"))]),
    ("chunk misplaced", "the resident body's PV takes the next chunk's V for each chunk",
     [("layer_attention.cu", "  for (int c = 0; c < NKC; ++c) la_pv<HD>(o, p[c], va + c * BOX, NKC);",
       "  for (int c = 0; c < NKC; ++c) la_pv<HD>(o, p[c], va + (c + 1) % NKC * BOX, NKC);")]),
    ("wrong normaliser", "each row's sum over two of its quad's four lanes only",
     [("wgmma.cuh", QUAD_SUM, "  return s;")]),
]
# Faults planted in the f32 attention body (csrc/split_attention.cuh, built into layer.cu:
# B1, B3, B4 and B5), each of which phase 3m's f32 isolated cases must catch
SPLIT_FAULTS = [
    ("kernel", "the f32 attention body as it is: no case may fail", []),
    ("mask ignored", "masked keys taken as valid",
     [("wgmma.cuh", ATTN_FLAG, ATTN_FLAG.replace("f == 2 ? kMaskedLogit", "f == 2 ? l[i] * scale"))]),
    ("mid.hi dropped", "QK^T's mid.hi pass left out (five of the six)",
     [("split_attention.cuh", "    if (NPL == 1 && p != 5) continue;  // bf16: hi.hi alone",
       "    if ((NPL == 1 && p != 5) || p == 3) continue;")]),
    ("lo planes zeroed", "the split pass stores q's, k's and v's lo planes as zeros",
     [("split_attention.cuh", "    wp[8 + u] = pack_bf16x2(l0, l1);", "    wp[8 + u] = 0u;")]),
    ("wrong normaliser", "each row's sum over two of its quad's four lanes only",
     [("wgmma.cuh", QUAD_SUM, "  return s;")]),
]
# The f32 attention body's stages (built into attention.cu, timed through B6's entry)
SA_BODY = "  if (NHB == 1 && split_attention_resident(hd, S)) {"
SPLIT_VARIANTS = [
    ("kernel", "the split pass and the body as they are", []),
    ("split pass alone", "q, k, v into their bf16 planes, no attention body",
     [("split_attention.cuh", SA_BODY, "  if (hd > 0) return cudaSuccess;\n" + SA_BODY)]),
    ("body alone", "the attention body on the planes left in the workspace, no split pass",
     [("split_attention.cuh", "  split_attention_qkv_kernel<T, NPL><<<",
       "  if (hd < 0) split_attention_qkv_kernel<T, NPL><<<")]),
    ("two passes at S <= 256", "the streamed body where the resident one runs: QK^T twice, "
     "no logits held",
     [("split_attention.cuh", SA_BODY, "  if (false) {")]),
]
# B2's bf16 launches (csrc/cls_logits.cu): where V lives, the K/V ring's depth, the
# order of the items, the tail's cluster
CLS_V_RULE = "  if (kv_passes(S) == 1) return V_REGISTERS;\n"
CLS_V_SIZE = ("  return (long)kv_tiles(S) * 64 * kv_width(hd) * 2 <= kVResident ? V_SHARED : "
              "V_RECOMPUTED;\n")
CLS_TAIL_C = "inline int tail_cluster(int B) { return (B + 63) / 64 <= 2 ? 16 : 8; }"
B2_VARIANTS = [
    ("kernel", "B2's launches as they are", []),
    ("V in shared memory", "V kept in shared memory wherever an item is one image (S > 64), "
     "not in the accumulators",
     [("cls_logits.cu", CLS_V_RULE, "  if (kv_images(S) == 2) return V_REGISTERS;\n"),
      ("cls_logits.cu", CLS_V_SIZE, "  return V_SHARED;\n")]),
    ("V recomputed", "V recomputed by a second sweep over the tiles at every length",
     [("cls_logits.cu", CLS_V_RULE, ""), ("cls_logits.cu", CLS_V_SIZE, "  return V_RECOMPUTED;\n")]),
    ("three stages", "the K/V launch's ring at three stages (not as many as fit, up to six)",
     [("cls_logits.cu", "constexpr int kKvMaxStages = 6;", "constexpr int kKvMaxStages = 3;")]),
    ("groups fastest", "consecutive items take one image's head groups (x read by them at once), "
     "not consecutive images of one group",
     [("cls_logits.cu", "int item_group(int item, int nim, int groups) { return item / nim; }",
       "int item_group(int item, int nim, int groups) { return item % groups; }"),
      ("cls_logits.cu", "int item_image(int item, int nim, int groups) { return item % nim; }",
       "int item_image(int item, int nim, int groups) { return item / groups; }")]),
    ("no CLS attention", "the K/V launch's epilogue left out (logits, softmax, P V): its loads, "
     "LN1 and products alone",
     [("cls_logits.cu", "        const int rbase = tile * 64 + wl * 16 + (lane >> 2);  // + 8 ((i / 2) % 2)\n"
       "        if (set == 0) {",
       "        const int rbase = tile * 64 + wl * 16 + (lane >> 2);  // + 8 ((i / 2) % 2)\n"
       "        if (set == 0 && S < 0) {"),
      ("cls_logits.cu", "        if (set == 0 && pass == npass - 1) {", "        if (set == 0 && pass == npass - 1 && S < 0) {"),
      ("cls_logits.cu", "        if ((mode == V_REGISTERS && set == 0) || (mode == V_RECOMPUTED && set == 1)) {",
       "        if (S < 0) {")]),
    ("no LN1", "x reaches wgmma as it arrives, not normalised",
     [("cls_logits.cu", "        if (active) norm_box(s, 0);\n", ""),
      ("cls_logits.cu", "            if (active) norm_box(s1, kc + 1);\n", "")]),
    ("no q", "no q.w boxes and no q product (q = 0)",
     [("cls_logits.cu", "(2 + (withq ? 3 : 2) * NBH) * BOX", "(2 + 2 * NBH) * BOX"),
      ("cls_logits.cu", "                if (withq)\n                  tma_load_2d(", "                if (withq && S < 0)\n                  tma_load_2d("),
      ("cls_logits.cu", "                if (withq) wgmma_m64n80k16(accq,", "                if (withq && S < 0) wgmma_m64n80k16(accq,"),
      ("cls_logits.cu", "                if (withq)\n                  wgmma_m64n64k16<1>(accq,", "                if (withq && S < 0)\n                  wgmma_m64n64k16<1>(accq,")]),
    ("tail in clusters of 8", "the tail's cluster of 8 blocks at every batch",
     [("cls_logits.cu", CLS_TAIL_C, "inline int tail_cluster(int B) { return 8; }")]),
    ("tail in clusters of 16", "the tail's cluster of 16 blocks at every batch",
     [("cls_logits.cu", CLS_TAIL_C, "inline int tail_cluster(int B) { return 16; }")]),
]
# Faults planted in B2's bf16 launches, each of which chip_smoke.py's phase 4 must
# catch in its isolated cases (cls_attention_isolated)
CLS_LOGIT = "if ((lane & 3) == 0 && h < hv && j < S) lg[h * spad + j] = l * scale;"
B2_FAULTS = [
    ("kernel", "B2's launches as they are: no case may fail", []),
    ("uniform softmax", "every logit 0: P V the average of V",
     [("cls_logits.cu", CLS_LOGIT, CLS_LOGIT.replace("= l * scale;", "= 0.f * l;"))]),
    ("last key tile dropped", "the logits of the image's last 64-row tile -inf (where it has "
     "more than one)",
     [("cls_logits.cu", CLS_LOGIT,
       CLS_LOGIT.replace("= l * scale;", "= tile == ntiles - 1 && ntiles > 1 ? -INFINITY : l * scale;"))]),
    ("another head's V", "the V boxes of the next head group",
     [("cls_logits.cu", "KW + g * W + j * 64,", "KW + ((g + 1) % ((H + NH - 1) / NH)) * W + j * 64,")]),
    ("P unnormalised", "P = exp(l - max), rounded, without the division by the sum",
     [("cls_logits.cu", "l[j] = round_to<bf16>(__fdiv_rn(l[j], sum));", "l[j] = round_to<bf16>(l[j]);")]),
]
# Faults planted in B2's float32 launches (cls_logits.cu's f32 route), each of which
# chip_smoke.py's phase 4 must catch in its isolated f32 cases (cls_attention_isolated_f32,
# against a float64 reference at twice the f32 plain version's error)
CLS_LOGIT_F32 = "if ((lane & 3) == 0 && h < hv && j < S) lg[h * spad + j] = l * a.scale;"
CLS_K_STEP = """            kv_f32_step<HD>(acc, ap, wp);
#pragma unroll
            for (int i = 0; i < NACC; ++i) sum[i] += acc[i];
"""
# the same passes straight into the running sum (kv_f32_step without its zeroing)
CLS_K_ONE_ACC = """            wgmma_fence();
#pragma unroll
            for (int p = 0; p < 6; ++p)
#pragma unroll
              for (int kk = 0; kk < 2; ++kk) {
                const uint64_t da = gmma_desc64(ap + pass_a(p) * f3::PLANE_A + kk * 32);
                const uint64_t dw = gmma_desc(wp + pass_w(p) * NBH * F32_WBOX + kk * 2048,
                                              F32_WBOX, 1024);
                if constexpr (G::WIDE)
                  wgmma_m64n80k16(sum, da, dw);
                else
                  wgmma_m64n64k16<1>(sum, da, dw);
              }
            wgmma_commit();
            wgmma_wait<0>();
"""
B2_F32_FAULTS = [
    ("kernel", "B2's f32 launches as they are: no case may fail", []),
    ("uniform softmax", "every logit 0: P V the average of V",
     [("cls_logits.cu", CLS_LOGIT_F32, CLS_LOGIT_F32.replace("= l * a.scale;", "= 0.f * l;"))]),
    ("last key tile dropped", "the logits of the image's last 64-row tile -inf (where it has "
     "more than one)",
     [("cls_logits.cu", CLS_LOGIT_F32, CLS_LOGIT_F32.replace(
         "= l * a.scale;", "= tile == ntiles - 1 && ntiles > 1 ? -INFINITY : l * a.scale;"))]),
    ("another head's V", "the V planes of the next head group",
     [("cls_logits.cu", "const int col0 = (c.set ? KW : 0) + g * W;",
       "const int col0 = c.set ? KW + (g + 1) % groups * W : g * W;")]),
    ("lo plane zeroed", "every weight's lo plane stored as zeros",
     [("cls_logits.cu", "    for (int t = 0; t < 4; ++t) split_bf16x3(v[t], pl[0][t], pl[1][t], pl[2][t]);",
       "    for (int t = 0; t < 4; ++t) split_bf16x3(v[t], pl[0][t], pl[1][t], pl[2][t]), pl[2][t] = 0.f;")]),
    ("one accumulator over K", "K's and V's products into one accumulator over all of D, not a "
     "sum of per-step sums",
     [("cls_logits.cu", CLS_K_STEP, CLS_K_ONE_ACC)]),
]
# The f32 split body (csrc/split6.cuh's gemm_split6_kernel, built through gemm.cu): a stage taken out, each
# variant timed through vpt_gemm_f32 at ViT-B/16's four products (batch 16, S 197)
F32_SPLIT = ("    split_bf16x3(v[2 * t], h0, m0, l0);\n"
             "    split_bf16x3(v[2 * t + 1], h1, m1, l1);\n")
F32_STEP = """  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    mbar_wait(smem_u32(full + s), (kt / STAGES) & 1);
    const uint32_t base = smem_u32(ring + s * STAGE_BYTES);
    wgmma_fence();"""
F32_STEP_PAIR = """  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    if (kt % 2 == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    }
    mbar_wait(smem_u32(full + s), (kt / STAGES) & 1);
    const uint32_t base = smem_u32(ring + s * STAGE_BYTES);
    wgmma_fence();"""
F32_PAIR_TAIL = """    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(smem_u32(empty + s));
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
  }"""
F32_PAIR_TAIL_NEW = """    wgmma_commit();
    if (kt % 2 == 0 && kt + 1 < nk) continue;
    if (kt % 2 == 1) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(smem_u32(empty + (kt - 1) % STAGES));
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(smem_u32(empty + s));
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
  }"""
F32_VARIANTS = [
    ("kernel", "the split body as it is", []),
    ("no products", "the consumers wait and release, no wgmma (W's split and TMA loads stay)",
     [("split6.cuh", "        wgmma_m64n128k16(acc, gmma_desc64(a0 + kk * 32),",
       "        if (kt < 0) wgmma_m64n128k16(acc, gmma_desc64(a0 + kk * 32),")]),
    ("no split", "each A value stored as hi = the value rounded, mid = lo = 0: the producer's "
     "split arithmetic left out",
     [("split6.cuh", F32_SPLIT, "    h0 = v[2 * t]; m0 = l0 = 0.f;\n    h1 = v[2 * t + 1]; m1 = l1 = 0.f;\n")]),
    ("no loads", "the producer reads no A from device memory (constants)",
     [("split6.cuh", "                                          float (&v)[8]) {\n  if (wide && c + 8 <= cols) {",
       "                                          float (&v)[8]) {\n#pragma unroll\n"
       "  for (int t = 0; t < 8; ++t) v[t] = 0.5f + t;\n  if (cols > 0) return;\n"
       "  if (wide && c + 8 <= cols) {")]),
    ("no W loads", "no TMA loads of W's planes (the stage's W boxes hold what they held)",
     [("split6.cuh", "        mbar_arrive_expect(fb, 3 * PLANE_W);", "        mbar_arrive(fb);"),
      ("split6.cuh", "            tma_load_3d(smem_u32(st + 3 * PLANE_A",
       "            if (kt < 0) tma_load_3d(smem_u32(st + 3 * PLANE_A")]),
    ("two steps in flight", "each pair of steps issued back to back into one accumulator "
     "(a stage released when its passes are done: wait<1>), the running sum every 64 k",
     [("split6.cuh", F32_STEP, F32_STEP_PAIR), ("split6.cuh", F32_PAIR_TAIL, F32_PAIR_TAIL_NEW)]),
    ("one pass", "hi.hi alone: a sixth of the tensor-core work",
     [("split6.cuh", "  constexpr int kPasses[][2] = {{2, 0}, {0, 2}, {1, 1}, {1, 0}, {0, 1}, {0, 0}};",
       "  constexpr int kPasses[][2] = {{0, 0}};")]),
]
# Faults planted in the split body, each of which chip_smoke.py's phase 3n must catch
# (f32_split_products)
F32_FAULTS = [
    ("kernel", "the split body as it is: no case may fail", []),
    ("hi.hi only", "one pass, hi.hi, instead of six",
     [("split6.cuh", "  constexpr int kPasses[][2] = {{2, 0}, {0, 2}, {1, 1}, {1, 0}, {0, 1}, {0, 0}};",
       "  constexpr int kPasses[][2] = {{0, 0}};")]),
    ("mid.hi dropped", "one cross term of the six left out",
     [("split6.cuh", "{{2, 0}, {0, 2}, {1, 1}, {1, 0}, {0, 1}, {0, 0}}", "{{2, 0}, {0, 2}, {1, 1}, {0, 1}, {0, 0}}")]),
    ("lo plane zeroed", "both operands' lo planes stored as zeros",
     [("split6.cuh", "    lo[t] = pack_bf16x2(l0, l1);", "    lo[t] = 0u;"),
      ("split6.cuh", "  for (int t = 0; t < 4; ++t) split_bf16x3(v[t], pl[0][t], pl[1][t], pl[2][t]);",
       "  for (int t = 0; t < 4; ++t) split_bf16x3(v[t], pl[0][t], pl[1][t], pl[2][t]), pl[2][t] = 0.f;")]),
]
# Every variant of a source is loaded into one process: a static local of an
# inline or template function is one symbol across the libraries, so the
# attribute call must run in each.
SHARED_STATIC = ("static const cudaError_t attr", "const cudaError_t attr")


def build_variants(build, src: str, variants, out_dir: Path, extra=(), ptxas=False) -> dict:
    """One library per variant: csrc/{src}.cu (and every source it includes)
    with the variant's replacements, linked with the objects of `extra`
    (csrc sources the main one calls into), built once for all variants.
    ptxas: compile the variants with -Xptxas -v and print the registers and
    spills of each of their kernels."""
    nvcc = build.find_nvcc()
    links = [f"-L{d}" for d in build.cuda_stub_dirs(nvcc)] + ["-lcuda"]

    def copy_tree(dst: Path, reps=()) -> Path:
        dst.mkdir(parents=True)
        for f in sorted(build.CSRC_DIR.iterdir()):
            if f.suffix in (".cu", ".cuh"):
                (dst / f.name).write_text(f.read_text().replace(*SHARED_STATIC))
        for name, old, new in reps:
            text = (dst / name).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace is not there once: {old[:60]!r}")
            (dst / name).write_text(text.replace(old, new))
        return dst

    def nvcc_proc(args):
        return subprocess.Popen([nvcc, *build.NVCC_FLAGS, *args], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def wait(procs: dict) -> dict:
        failed, outs = [], {}
        for what, proc in procs.items():
            outs[what], _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{what}:\n{outs[what][-2000:]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        return outs

    common = copy_tree(out_dir / f"{src}_common")
    extra_objs = [common / f"{e}.o" for e in extra]
    procs = {f"{e}.cu": nvcc_proc(["-c", "-o", str(common / f"{e}.o"), str(common / f"{e}.cu")])
             for e in extra}
    objs = {}
    for i, (name, _, reps) in enumerate(variants):
        d = copy_tree(out_dir / f"{src}_{i}", reps)
        objs[name] = d / f"{src}.o"
        procs[f"{src}.cu variant {name!r}"] = nvcc_proc(
            ["-c", *(["-Xptxas", "-v"] if ptxas else []), "-o", str(objs[name]),
             str(d / f"{src}.cu")])
    outs = wait(procs)
    if ptxas:
        for name, _, _ in variants:
            print_ptxas(f"{src}.cu variant {name!r}", outs[f"{src}.cu variant {name!r}"],
                        PTXAS_KERNELS.get(src, ""))
    sos = {name: obj.with_suffix(".so") for name, obj in objs.items()}
    wait({f"link {name!r}": nvcc_proc(["-shared", "-o", str(sos[name]), str(obj),
                                       *map(str, extra_objs), *links])
          for name, obj in objs.items()})
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
        libs[name] = lib
    return libs


# the kernels whose registers and spills a variant mode prints (B2: its bf16 launches)
PTXAS_KERNELS = {"layer_attention": "", "cls_logits": "cls_(ln1_stats|kv_attention|tail)",
                 "gemm": "gemm_split6", "attention": "split_attention"}


def print_ptxas(what: str, text: str, only: str = ""):
    """Registers and spills of every kernel in ptxas -v's output (those whose
    name matches the regular expression `only`)."""
    kernel = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                                    text=True).stdout.strip()
            kernel = kernel.replace("(anonymous namespace)::", "").split("(")[0]
        elif kernel and ("registers" in line or "spill" in line) and re.search(only, kernel):
            print(f"{what}: {kernel}: {line.split(':', 1)[-1].strip()}", flush=True)


def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def report(kernel: str, variants, calls: dict, out: torch.Tensor):
    """Time each variant, the real kernel first and last; print time and the
    largest distance of its output from the real kernel's."""
    rc = calls["kernel"]()
    if rc:
        raise RuntimeError(f"{kernel}: the kernel returned CUDA error {rc}")
    torch.cuda.synchronize()
    ref = out.clone()
    times = {"kernel": [time_ms(calls["kernel"])]}
    for name, what, _ in variants[1:]:
        out.zero_()
        rc = calls[name]()
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"{kernel} {name}: CUDA error {rc}")
        d = (out.float() - ref.float()).abs().max().item()
        times[name] = [time_ms(calls[name])]
        print(f"{kernel} {name}: {times[name][0]:.4f} ms, max |out - kernel's| {d:.3e} ({what})",
              flush=True)
    times["kernel"].append(time_ms(calls["kernel"]))
    print(f"{kernel} kernel: {times['kernel'][0]:.4f} ms before, {times['kernel'][1]:.4f} ms "
          f"after the variants", flush=True)


def b4_calls(libs: dict, gen, dev, stream):
    """B4's C entry at DeiT-S, batch 512, S 197, bf16, random weights: one
    call per variant library, and the output they write."""
    from vit_pruning_tpu_torch.configs import deit_small
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_slice
    from vit_pruning_tpu_torch.ops.quant import kmajor_int8_weights, quantize_layer_params

    cfg = deit_small(num_labels=100)
    lp = layer_slice(init_vit_params(cfg.replace(num_layers=1), gen, "cpu")["layers"], 0)
    qp = quantize_layer_params(tree_to(lp, dev, torch.bfloat16))
    nk = kmajor_int8_weights(qp)
    a, mlp = qp["attn"], qp["mlp"]
    w = [qp["ln1"]["g"], qp["ln1"]["b"], nk["qkv"]["wq"], nk["qkv"]["wscale"], nk["qkv"]["b"],
         nk["o"]["wq"], a["o"]["wscale"], a["o"]["b"], qp["ln2"]["g"], qp["ln2"]["b"],
         nk["fc1"]["wq"], mlp["fc1"]["wscale"], mlp["fc1"]["b"], nk["fc2"]["wq"],
         mlp["fc2"]["wscale"], mlp["fc2"]["b"]]
    b, s, d, h, m = 512, 197, cfg.hidden_size, cfg.num_heads, cfg.mlp_dim
    kw, rows = cfg.attn_width, 512 * 197
    x = torch.randn(b, s, d, generator=gen).to(dev, torch.bfloat16)
    out = torch.empty_like(x)
    bufs = []
    for n in (d, kw, d, m):  # the codes and row scales of LN1, ctx, LN2, GELU
        bufs += [torch.empty((rows, n), dtype=torch.int8, device=dev),
                 torch.empty(rows, dtype=torch.float32, device=dev)]
    bufs += [torch.empty((rows, 3 * kw), dtype=x.dtype, device=dev),
             torch.empty((rows, kw), dtype=x.dtype, device=dev),
             torch.empty((rows, d), dtype=torch.float32, device=dev),
             torch.empty((rows, m), dtype=x.dtype, device=dev)]
    aplanes = None  # bf16: the f32 attention's workspace is not needed

    def call(lib):
        return lib.vpt_vit_layer_int8_forward(
            1, x.data_ptr(), None, *(t.data_ptr() for t in w), out.data_ptr(),
            *(t.data_ptr() for t in bufs), aplanes, b, s, d, h, kw // h, m, d,
            cfg.layernorm_eps, stream)

    return {name: (lambda lib=lib: call(lib)) for name, lib in libs.items()}, out


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: no CUDA device (torch.cuda.is_available() is False)")
    if sys.argv[1:2] == ["times"]:
        rest = sys.argv[2:]
        only_f32 = rest[-1:] == ["f32"]
        rest = rest[:-1] if only_f32 else rest
        layer_times(rest[0] if rest else ".", only_f32)
        return
    from vit_pruning_tpu_torch.ops.cuda import build

    chosen = sys.argv[1:] or ["b7", "b6", "b4", "b8a", "b1", "b2"]

    def others(stem):
        return tuple(f.stem for f in sorted(build.CSRC_DIR.glob("*.cu")) if f.stem != stem)

    plans = {"b7": ("mlp", B7_VARIANTS, ()), "b6": ("attention", B6_VARIANTS, ()),
             "b4": ("layer_int8", B4_VARIANTS, ("layer", "layer_attention", "gemm")),
             "b8a": ("embed", B8A_VARIANTS, ()),
             "b1": ("layer_attention", B1_VARIANTS, ("layer", "gemm")),
             "b2": ("cls_logits", B2_VARIANTS, others("cls_logits")),
             "faults": ("layer_attention", ATTENTION_FAULTS, others("layer_attention")),
             "faults_split": ("layer", SPLIT_FAULTS, others("layer")),
             "split": ("attention", SPLIT_VARIANTS, ()),
             "faults_b2": ("cls_logits", B2_FAULTS, others("cls_logits")),
             "faults_b2_f32": ("cls_logits", B2_F32_FAULTS, others("cls_logits")),
             "f32": ("gemm", F32_VARIANTS, ()),
             "faults_f32": ("gemm", F32_FAULTS, others("gemm"))}
    if "faults" in chosen:
        chosen = chosen + ["faults_split", "faults_b2", "faults_b2_f32"]
    if "f32" in chosen:
        chosen = chosen + ["faults_f32"]
    if not set(chosen) <= set(plans):
        sys.exit(f"kernel_variants: kernels {chosen}; it knows {sorted(plans)}")
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(chosen)) as pool:  # every nvcc process at once
            futures = {key: pool.submit(build_variants, build, src, variants, Path(tmp) / key,
                                        extra, key in ("b1", "b2", "f32", "split"))
                       for key, (src, variants, extra) in plans.items() if key in chosen}
            libs = {key: f.result() for key, f in futures.items()}
        dev, gen = "cuda", torch.Generator().manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream

        if "b7" in libs:
            b7_report(libs["b7"], gen, dev, stream)
        if "b6" in libs:
            b6_report(libs["b6"], gen, dev, stream)
        if "b4" in libs:
            calls, out = b4_calls(libs["b4"], gen, dev, stream)
            report("B4", B4_VARIANTS, calls, out)
            del calls, out
        if "b8a" in libs:
            b8a_report(libs["b8a"], gen, dev, stream)
        if "b1" in libs:
            b1_report(libs["b1"], gen, dev, stream)
        if "b2" in libs:
            b2_report(libs["b2"], gen, dev, stream)
        if "split" in libs:
            split_report(libs["split"], gen, dev, stream)
        if "faults" in libs:
            faults_report(build, libs["faults"], dev, ATTENTION_FAULTS, "attention_isolated")
            faults_report(build, libs["faults_split"], dev, SPLIT_FAULTS, "attention_isolated")
            faults_report(build, libs["faults_b2"], dev, B2_FAULTS, "cls_attention_isolated")
            faults_report(build, libs["faults_b2_f32"], dev, B2_F32_FAULTS,
                          "cls_attention_isolated_f32")
        if "f32" in libs:
            f32_report(libs["f32"], gen, dev, stream)
            faults_report(build, libs["faults_f32"], dev, F32_FAULTS, "f32_split_products")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])


def b7_report(libs: dict, gen, dev, stream):
    bf = torch.bfloat16
    t, d, m = 100864, 384, 1536
    x = torch.randn(t, d, generator=gen).to(dev, bf)
    w1, b1, w2, b2 = ((s * torch.randn(shape, generator=gen)).to(dev, bf)
                      for s, shape in ((0.05, (d, m)), (0.05, (m,)), (0.05, (m, d)), (0.1, (d,))))
    out = torch.empty_like(x)
    report("B7", B7_VARIANTS, {
        name: (lambda lib=lib: lib.vpt_mlp_forward(
            1, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), t, d, m, stream)) for name, lib in libs.items()}, out)


def b6_report(libs: dict, gen, dev, stream):
    bf = torch.bfloat16
    b, h, s, hd = 512, 6, 197, 64
    q, k, v = (torch.randn(b, h, s, hd, generator=gen).to(dev, bf) for _ in range(3))
    mask = torch.rand(b, s, generator=gen) > 0.3
    mask[:, 0] = True
    mask = mask.to(dev)
    out = torch.empty_like(q)
    report("B6", B6_VARIANTS, {
        name: (lambda lib=lib: lib.vpt_attention_forward(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, h, s, hd, None, stream)) for name, lib in libs.items()}, out)


def split_report(libs: dict, gen, dev, stream):
    """The f32 attention body's variants (SPLIT_VARIANTS) through B6's C
    entry in f32, masked: DeiT-S batch 32 (6 heads of 64, S 197; the
    resident body), ViT-H's hd 80 at S 257 and DeiT-S at 384's S 577 (batch
    8; the streamed body). The workspace keeps the planes of the last call,
    so 'body alone' reads the kernel's."""
    for tag, b, h, s, hd in (("DeiT-S batch 32, S 197", 32, 6, 197, 64),
                             ("ViT-H hd 80 batch 8, S 257", 8, 16, 257, 80),
                             ("DeiT-S at 384 batch 8, S 577", 8, 6, 577, 64)):
        q, k, v = (torch.randn(b, h, s, hd, generator=gen).to(dev) for _ in range(3))
        mask = torch.rand(b, s, generator=gen) > 0.3
        mask[:, 0] = True
        mask = mask.to(dev)
        out = torch.empty_like(q)
        planes = torch.empty(9 * b * h * s * hd, dtype=torch.bfloat16, device=dev)
        report(f"f32 attention body, {tag}", SPLIT_VARIANTS, {
            name: (lambda lib=lib: lib.vpt_attention_forward(
                0, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                b, h, s, hd, planes.data_ptr(), stream)) for name, lib in libs.items()}, out)
        del q, k, v, out, planes


def b8a_report(libs: dict, gen, dev, stream):
    """B8a's uint8 patches with bf16 weights, the affine of the serving
    normalisation, at DeiT-S's and ViT-H's patch widths."""
    from vit_pruning_tpu_torch.data.preprocess import VIT_MEAN, VIT_STD

    bf = torch.bfloat16
    scale, shift = 1.0 / (255.0 * VIT_STD), -VIT_MEAN / VIT_STD
    for tag, bsz, n_p, kk, dd in (("DeiT-S batch 512", 512, 196, 768, 384),
                                  ("ViT-H batch 64", 64, 256, 588, 1280)):
        patches = torch.randint(0, 256, (bsz, n_p, kk), generator=gen, dtype=torch.uint8).to(dev)
        w = (0.02 * torch.randn(kk, dd, generator=gen)).to(dev, bf)
        bias, pos = torch.zeros(dd, device=dev, dtype=bf), torch.zeros(n_p, dd, device=dev, dtype=bf)
        out = torch.empty((bsz, n_p, dd), device=dev, dtype=bf)
        report(f"B8a {tag} (K {kk}, D {dd})", B8A_VARIANTS, {
            name: (lambda lib=lib: lib.vpt_patch_embed_forward(
                2, 1, 0, patches.data_ptr(), w.data_ptr(), bias.data_ptr(), pos.data_ptr(),
                out.data_ptr(), bsz * n_p, n_p, kk, dd, scale, shift, None, 0, 0, None, None, 0,
                stream))
            for name, lib in libs.items()}, out)


def b1_report(libs: dict, gen, dev, stream):
    """B1's C entry, bf16, random weights, unmasked: DeiT-S at batch 512, S 197
    and 99 (the resident attention body at 4 and 2 chunks) and ViT-H at batch
    64, S 257 (streamed)."""
    from vit_pruning_tpu_torch.configs import deit_small, vit_huge
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_slice
    from vit_pruning_tpu_torch.ops.cuda.layer import _layer_weights

    bf = torch.bfloat16
    for cfg, b, s in ((deit_small(num_labels=100), 512, 197), (deit_small(num_labels=100), 512, 99),
                      (vit_huge(num_labels=100), 64, 257)):
        tag = f"{'ViT-H' if cfg.head_dim == 80 else 'DeiT-S'} batch {b}, S {s}"
        lp = layer_slice(init_vit_params(cfg.replace(num_layers=1), gen, "cpu")["layers"], 0)
        w = list(_layer_weights(tree_to(lp, dev, bf)).values())
        d, h, m, kw = cfg.hidden_size, cfg.num_heads, cfg.mlp_dim, cfg.attn_width
        rows = b * s
        x = torch.randn(b, s, d, generator=gen).to(dev, bf)
        out = torch.empty_like(x)
        ws = [torch.empty((rows, d), dtype=bf, device=dev),
              torch.empty((rows, 3 * kw), dtype=bf, device=dev),
              torch.empty((rows, kw), dtype=bf, device=dev),
              torch.empty((rows, d), dtype=torch.float32, device=dev),
              torch.empty((rows, m), dtype=bf, device=dev)]
        report(f"B1 {tag}", B1_VARIANTS, {
            name: (lambda lib=lib: lib.vpt_vit_layer_forward(
                1, x.data_ptr(), None, *(t.data_ptr() for t in w), out.data_ptr(),
                *(t.data_ptr() for t in ws), None, b, s, d, h, kw // h, m, d, cfg.layernorm_eps,
                stream)) for name, lib in libs.items()}, out)
        del x, out, ws, w


def f32_report(libs: dict, gen, dev, stream):
    """The split body's variants (F32_VARIANTS) through vpt_gemm_f32 at
    ViT-B/16's four f32 products, batch 16 x S 197 (random operands, bias,
    the residual where the layer adds one)."""
    m, d, mm = 16 * 197, 768, 3072
    for tag, k, n, act, res in (("qkv", d, 3 * d, 0, False), ("o", d, d, 0, True),
                                ("fc1", d, mm, 1, False), ("fc2", mm, d, 0, True)):
        a = torch.randn(m, k, generator=gen).to(dev)
        w = (torch.randn(k, n, generator=gen) / math.sqrt(k)).to(dev)
        b = (0.1 * torch.randn(n, generator=gen)).to(dev)
        r = torch.randn(m, n, generator=gen).to(dev) if res else None
        out = torch.empty((m, n), device=dev)
        planes = torch.empty(3 * k * n, dtype=torch.bfloat16, device=dev)
        report(f"f32 split body, ViT-B batch 16 {tag} (M {m}, K {k}, N {n})", F32_VARIANTS, {
            name: (lambda lib=lib: lib.vpt_gemm_f32(
                a.data_ptr(), k, w.data_ptr(), m, n, k, b.data_ptr(), act,
                None if r is None else r.data_ptr(), n, out.data_ptr(), n, planes.data_ptr(),
                stream))
            for name, lib in libs.items()}, out)
        del a, w, b, r, out, planes


def faults_report(build, libs: dict, dev, faults, cases: str):
    """chip_smoke.py's isolated cases (`cases`: phase 3m's attention_isolated
    or phase 4's cls_attention_isolated) through the package's wrappers with
    each library of `faults` in the package's place: the real kernel must
    pass every case, each fault must fail at least one."""
    real, wrong = build.load_library, []
    try:
        for name, what, _ in faults:
            build.load_library = lambda lib=libs[name]: lib
            recs = getattr(chip_smoke, cases)(dev, lambda msg: None)
            ratio = [r.get("ratio", r["d"] / r["tol"]) if math.isfinite(r["d"]) else math.inf
                     for r in recs]
            bad = sum(not q <= 1.0 for q in ratio)
            worst = max(range(len(recs)), key=lambda i: ratio[i])
            print(f"{cases} fault {name!r}: {bad} of {len(recs)} isolated cases fail, worst "
                  f"err / tol {ratio[worst]:.3g} ({recs[worst]['tag']}) ({what})", flush=True)
            if (bad > 0) != (name != "kernel"):
                wrong.append(name)
    finally:
        build.load_library = real
    if wrong:
        raise RuntimeError(f"{cases} misjudges {wrong}")


def b2_report(libs: dict, gen, dev, stream):
    """B2's C entry at B2_SHAPES in bf16 (100 labels, padded to 104 as the
    wrapper pads them), random weights: each variant of B2_VARIANTS timed
    beside the kernel, the kernel first and last."""
    from vit_pruning_tpu_torch.configs import deit_small, vit_huge
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_slice
    from vit_pruning_tpu_torch.ops.cuda.layer import _cls_weights
    from vit_pruning_tpu_torch.ops.cuda.widths import pad_dim
    from vit_pruning_tpu_torch.ops.structured import prune_heads, prune_mlp_channels

    bf = torch.bfloat16
    for tag, model, heads, mlp, b, s in B2_SHAPES:
        cfg = (deit_small if model == "deit_s" else vit_huge)(num_labels=100)
        p = init_vit_params(cfg.replace(num_layers=1), gen, "cpu")
        if heads < cfg.num_heads:
            bb, cfg = prune_heads(p, cfg, [list(range(heads))])
            p = prune_mlp_channels(bb, [list(range(mlp))])
        p = tree_to(p, dev, bf)
        head = {"w": pad_dim(p["head"]["w"], 1, 104), "b": pad_dim(p["head"]["b"], 0, 104)}
        w = list(_cls_weights(layer_slice(p["layers"], 0), p["ln_f"], head).values())
        d, h, m, kw = cfg.hidden_size, cfg.num_heads, mlp, cfg.attn_width
        x = torch.randn(b, s, d, generator=gen).to(dev, bf)
        out = torch.empty((b, 104), dtype=bf, device=dev)
        f32 = {"dtype": torch.float32, "device": dev}
        ws = [torch.empty((b, d), dtype=bf, device=dev), torch.empty((b * s + 72, 2), **f32),
              None, torch.empty((b, kw), dtype=bf, device=dev), torch.empty((b, d), **f32),
              torch.empty((b, m), dtype=bf, device=dev), torch.empty((b, d), **f32)]
        report(f"B2 {tag}", B2_VARIANTS, {
            name: (lambda lib=lib: lib.vpt_vit_cls_logits_forward(
                1, x.data_ptr(), *(t.data_ptr() for t in w), out.data_ptr(),
                *(None if t is None else t.data_ptr() for t in ws), None, b, s, d, h, kw // h, m,
                d, 104, cfg.layernorm_eps, stream)) for name, lib in libs.items()}, out)
        del x, out, ws, w


def launch_profile(fn, calls: int = 3) -> dict:
    """The device kernels of one call of fn, in order, from torch.profiler
    over `calls` calls (each synchronised): each launch's name, device us and
    the gap before it (from the previous launch's end), and the call's span
    (first start to last end) and busy us (the launches' sum); the last of
    the calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile that saw no device kernel is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
                torch.cuda.synchronize()
        ks = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        if ks:
            break
    per = len(ks) // calls
    last = ks[len(ks) - per:]
    out, prev = [], None
    for e in last:
        name = re.sub(r"^void ", "", e.name)[:70]
        gap = 0.0 if prev is None else e.time_range.start - prev
        out.append([name, round(e.time_range.end - e.time_range.start, 3), round(gap, 3)])
        prev = e.time_range.end
    span = last[-1].time_range.end - last[0].time_range.start if last else 0.0
    return {"launches": len(last), "span_us": round(span, 3),
            "busy_us": round(sum(k[1] for k in out), 3), "by_launch": out}


# B2's shapes on the main path: (tag, model, heads kept of 6 (DeiT-S) or 16, MLP
# kept, batch, S): the last layer of headline (S 99), composed (33) and ultra (17)
# at DeiT-S batch 512, at full width and at composed / ultra's pruned width (3 of 6
# heads, MLP 768); ViT-H/14's headline at batch 64 (S 129)
B2_SHAPES = (("deit_s_s99", "deit_s", 6, 1536, 512, 99),
             ("deit_s_s33", "deit_s", 6, 1536, 512, 33),
             ("deit_s_s17", "deit_s", 6, 1536, 512, 17),
             ("composed_s33", "deit_s", 3, 768, 512, 33),
             ("composed_s17", "deit_s", 3, 768, 512, 17),
             ("vit_h_s129_b64", "vit_h", 16, 5120, 64, 129))


def b2_times(res: dict, gen, dev):
    """B2 (fused_vit_layer_cls_logits) at B2_SHAPES in bf16, 100 labels:
    CUDA events (mean of 10 after 3) and launch_profile's launches."""
    from vit_pruning_tpu_torch.configs import deit_small, vit_huge
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_slice
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.structured import prune_heads, prune_mlp_channels

    bf = torch.bfloat16
    for tag, model, heads, mlp, b, s in B2_SHAPES:
        cfg = (deit_small if model == "deit_s" else vit_huge)(num_labels=100)
        p = init_vit_params(cfg.replace(num_layers=1), gen, "cpu")
        if heads < cfg.num_heads:
            bb, cfg = prune_heads(p, cfg, [list(range(heads))])
            p = prune_mlp_channels(bb, [list(range(mlp))])
        p = tree_to(p, dev, bf)
        lp = layer_slice(p["layers"], 0)
        x = torch.randn(b, s, cfg.hidden_size, generator=gen).to(dev, bf)

        def call():
            return kl.fused_vit_layer_cls_logits(x, lp, p["ln_f"], p["head"], cfg.num_heads)

        res[f"b2_{tag}"] = time_ms(call, iters=10)
        res[f"b2_{tag}_profile"] = launch_profile(call)
        del x


def serving_times(res: dict, gen, dev):
    """The progressive forwards that end in B2 (serving_forward, kernel mode
    auto, bf16, DeiT-S batch 512 from uint8 images, 100 labels): headline,
    composed and ultra (3 of 6 heads, MLP 768), random weights with the
    cls_mlp predictor; CUDA events, the mean of 10 after 3."""
    from vit_pruning_tpu_torch.configs import (PruneConfig, composed_schedule, deit_small,
                                               ultra_schedule)
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params
    from vit_pruning_tpu_torch.ops.dispatch import kernel_mode
    from vit_pruning_tpu_torch.ops.structured import prune_heads, prune_mlp_channels
    from vit_pruning_tpu_torch.serving import serving_forward

    cfg = deit_small(num_labels=100)
    n, L = cfg.num_patches, cfg.num_layers
    base = init_pruned_vit_params(cfg, PruneConfig(mode="topk_prog", predictor="cls_mlp"), gen,
                                  "cpu")
    bb, c_cfg = prune_heads(base["backbone"], cfg, [list(range(0, cfg.num_heads, 2))] * L)
    pruned = dict(base, backbone=prune_mlp_channels(bb, [list(range(0, cfg.mlp_dim, 2))] * L))

    def pc(sched):
        return PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention",
                           top_k=sched[0], keep_schedule=sched)

    u8 = torch.randint(0, 256, (512, 3, 224, 224), generator=gen, dtype=torch.uint8).to(dev)
    for name, gcfg, pcfg, params in (
            ("headline", cfg, PruneConfig(mode="topk_prog", predictor="cls_mlp",
                                          loss="mse_attention", top_k=98), base),
            ("composed", c_cfg, pc(composed_schedule(n, L)), pruned),
            ("ultra", c_cfg, pc(ultra_schedule(n, L)), pruned)):
        p = tree_to(params, dev, torch.bfloat16)
        with kernel_mode("auto"):
            res[f"{name}_ms"] = time_ms(lambda: serving_forward(p, u8, gcfg, pcfg), iters=10)


def by_family(profile: dict) -> dict:
    """launch_profile's launches summed by what they do: LN, the products
    (every GEMM body), the attention and the rest; device us a call."""
    fams = (("ln", ("layer_norm",)), ("products", ("gemm",)), ("attention", ("attention",)))
    out = dict.fromkeys([f for f, _ in fams] + ["other"], 0.0)
    for name, us, _ in profile["by_launch"]:
        fam = next((f for f, keys in fams if any(k in name for k in keys)), "other")
        out[fam] = round(out[fam] + us, 3)
    return out


def gate_config():
    """quality_torch.py's gate model: 32x32, patch 4 (S 65), D 128, 4 heads of
    32, MLP 256, 6 layers, 128 classes."""
    from vit_pruning_tpu_torch.configs import ViTConfig

    return ViTConfig(image_size=32, patch_size=4, hidden_size=128, num_layers=6, num_heads=4,
                     mlp_dim=256, num_labels=128)


def f32_times(res: dict, gen, dev):
    """The float32 routes (what cli.py train / eval, quality_torch.py and the
    train steps run by default), each timed with CUDA events (the mean of 10
    after 3) and the layer kernels also launch by launch (launch_profile,
    summed by by_family): B1 at ViT-B/16 batch 16 (the CLI's eval), DeiT-S
    batch 32 (the train steps) and the gate model at its batch 128, S 197 /
    197 / 65, 30% of the keys masked; B5 (12 layers) at DeiT-S batch 32; B2 at
    DeiT-S batch 32, S 99, launch by launch too, beside chip_smoke.py's CLS-only
    composition (cls_library); B3 at DeiT-S batch 32, S 197, capacity 99; B6 (6
    heads of 64, S 197) at DeiT-S batch 32, launch by launch too, beside f32
    scaled_dot_product_attention; B7 at DeiT-S batch 32 (6,304 rows)
    and ViT-H width (514 rows, D 1280, M 5120), B8b (f32 patches) and B8a
    (uint8 patches) with f32 weights at DeiT-S (K 768) and ViT-H (K 588) batch
    32, each also launch by launch, with the body it ran and the PyTorch
    composition of the same function (addmm, F.gelu, addmm; the affine,
    addmm, + pos); the head_mask forward (B7 x 12, DeiT-S batch 32) and the
    CLI's eval forward (ViT-B/16, mode mask, cls_mlp, batch 16) on the kernel
    path and the eager one."""
    from vit_pruning_tpu_torch.configs import (PruneConfig, deit_small, vit_base_patch16_224,
                                               vit_huge)
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params, pruned_vit_forward
    from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_slice, vit_forward
    from vit_pruning_tpu_torch.ops.cuda import attention as ka
    from vit_pruning_tpu_torch.ops.cuda import embed as kemb
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.cuda import mlp as kmlp
    from vit_pruning_tpu_torch.ops.cuda import model as kmod
    from vit_pruning_tpu_torch.ops.dispatch import kernel_mode
    from vit_pruning_tpu_torch.ops.masking import compact_dest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32

    def masked(b, s):
        m = torch.rand(b, s, generator=gen) > 0.3
        m[:, 0] = True
        return m.to(dev)

    for tag, cfg, b in (("vit_b_b16", vit_base_patch16_224(), 16),
                        ("deit_s_b32", deit_small(num_labels=100), 32),
                        ("gate_b128", gate_config(), 128)):
        s = cfg.seq_len
        lp = tree_to(layer_slice(init_vit_params(cfg.replace(num_layers=1), gen, "cpu")["layers"],
                                 0), dev, f32)
        x = torch.randn(b, s, cfg.hidden_size, generator=gen).to(dev)
        mask = masked(b, s)

        def b1():
            return kl.fused_vit_layer(x, lp, cfg.num_heads, cfg.layernorm_eps, mask)

        res[f"f32_b1_{tag}"] = time_ms(b1, iters=10)
        prof = launch_profile(b1)
        res[f"f32_b1_{tag}_by_family_us"] = by_family(prof)
        res[f"f32_b1_{tag}_profile"] = prof
    cfg = deit_small(num_labels=100)
    params = tree_to(init_vit_params(cfg, gen, "cpu"), dev, f32)
    nh, d = cfg.num_heads, cfg.hidden_size
    x = torch.randn(32, 197, d, generator=gen).to(dev)

    def b5():
        return kmod.fused_vit_encoder(x, params["layers"], nh, cfg.layernorm_eps)

    res["f32_b5_deit_s_b32"] = time_ms(b5, iters=10)
    res["f32_b5_deit_s_b32_by_family_us"] = by_family(launch_profile(b5))
    lp = layer_slice(params["layers"], 0)
    x99 = torch.randn(32, 99, d, generator=gen).to(dev)

    def b2():
        return kl.fused_vit_layer_cls_logits(x99, lp, params["ln_f"], params["head"], nh)

    res["f32_b2_deit_s_b32_s99"] = time_ms(b2, iters=10)
    res["f32_b2_deit_s_b32_s99_profile"] = launch_profile(b2)
    composition = chip_smoke.cls_library(cfg, lp, params["ln_f"], params["head"])
    res["f32_b2_deit_s_b32_s99_library"] = time_ms(lambda: composition(x99), iters=10)
    mask = masked(32, 197)
    dest = compact_dest(mask)
    res["f32_b3_deit_s_b32_cap99"] = time_ms(
        lambda: kl.fused_vit_layer_bucketed(x, lp, dest, mask, 99, nh), iters=10)
    q, k, v = (torch.randn(32, nh, 197, cfg.head_dim, generator=gen).to(dev) for _ in range(3))
    res["f32_b6_deit_s_b32"] = time_ms(lambda: ka.fused_attention(q, k, v, mask), iters=10)
    res["f32_b6_deit_s_b32_profile"] = launch_profile(lambda: ka.fused_attention(q, k, v, mask))
    res["f32_b6_deit_s_b32_sdpa"] = time_ms(  # the library call: f32 SDPA, the same mask
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, mask[:, None, None, :]),
        iters=10)
    mlp = lp["mlp"]
    xm = x.reshape(-1, d)
    hcfg = vit_huge(num_labels=100)
    hd, hm_ = hcfg.hidden_size, hcfg.mlp_dim
    wh = [(0.03 * torch.randn(shape, generator=gen)).to(dev)
          for shape in ((hd, hm_), (hm_,), (hm_, hd), (hd,))]
    xh = torch.randn(514, hd, generator=gen).to(dev)
    b7_cases = (("deit_s_b32", xm, (mlp["fc1"]["w"], mlp["fc1"]["b"], mlp["fc2"]["w"],
                                    mlp["fc2"]["b"])),
                ("vit_h_r514", xh, wh))
    for tag, xr, w in b7_cases:
        def b7(xr=xr, w=w):
            return kmlp.fused_mlp(xr, *w)

        def library(xr=xr, w=w):  # eager mlp_block: addmm, F.gelu, addmm (cuBLAS f32)
            return torch.addmm(w[3], torch.nn.functional.gelu(torch.addmm(w[1], xr, w[0])), w[2])

        res[f"f32_b7_{tag}"] = time_ms(b7, iters=10)
        res[f"f32_b7_{tag}_library"] = time_ms(library, iters=10)
        res[f"f32_b7_{tag}_profile"] = launch_profile(b7)
        kmlp.reset_body_counts()
        b7()
        torch.cuda.synchronize()
        res[f"f32_b7_{tag}_bodies"] = kmlp.body_counts()
    del xh, wh
    # B8b (f32 patches) and B8a (uint8 patches) with f32 weights, batch 32: DeiT-S (K 768,
    # D 384) and ViT-H (K 588, D 1280); the library: the affine (B8a), one addmm, + pos
    scale, shift = kemb._affine(kemb.VIT_MEAN, kemb.VIT_STD)
    for tag, mcfg in (("deit_s_b32", cfg), ("vit_h_b32", hcfg)):
        n_p, pd, dm = mcfg.num_patches, mcfg.patch_dim, mcfg.hidden_size
        we, be, pe = (torch.randn(pd, dm, generator=gen).to(dev) * 0.02,
                      torch.randn(dm, generator=gen).to(dev) * 0.1,
                      torch.randn(n_p, dm, generator=gen).to(dev) * 0.02)
        fp = torch.randn(32, n_p, pd, generator=gen).to(dev)
        u8p = torch.randint(0, 256, (32, n_p, pd), generator=gen, dtype=torch.uint8).to(dev)
        for key, fn, patches, lib in (
                ("b8b", lambda p: kemb.fused_patch_embed_f(p, we, be, pe), fp,
                 lambda p: torch.addmm(be, p.view(-1, pd), we).view(32, n_p, dm) + pe),
                ("b8a", lambda p: kemb.fused_patch_embed_u8(p, we, be, pe), u8p,
                 lambda p: torch.addmm(be, p.view(-1, pd).float() * scale + shift, we)
                 .view(32, n_p, dm) + pe)):
            res[f"f32_{key}_{tag}"] = time_ms(lambda: fn(patches), iters=10)
            res[f"f32_{key}_{tag}_library"] = time_ms(lambda: lib(patches), iters=10)
            res[f"f32_{key}_{tag}_profile"] = launch_profile(lambda: fn(patches))
            kemb.reset_body_counts()
            fn(patches)
            torch.cuda.synchronize()
            res[f"f32_{key}_{tag}_bodies"] = kemb.body_counts()
    # the head_mask forward (the mask-search route: B7 x 12 beside plain attention) in f32 at
    # DeiT-S batch 32, kernel path against eager
    hmask = torch.ones(cfg.num_layers, nh)
    hmask[:, 1] = 0.0
    hmask = hmask.to(dev)
    pix32 = torch.randn(32, 3, cfg.image_size, cfg.image_size, generator=gen).to(dev)

    def head_masked(mode):
        with torch.no_grad(), kernel_mode(mode):
            return vit_forward(params, pix32, cfg, head_mask=hmask)

    hm_ms = {"auto": [], "eager": []}
    for mode in ("auto", "eager", "eager", "auto"):
        hm_ms[mode].append(time_ms(lambda: head_masked(mode), iters=10))
    res["f32_head_mask_deit_s_b32_ms"] = {m: sum(v) / len(v) for m, v in hm_ms.items()}
    b_cfg = vit_base_patch16_224()
    pcfg = PruneConfig(mode="mask", predictor="cls_mlp")
    pp = tree_to(init_pruned_vit_params(b_cfg, pcfg, gen, "cpu"), dev, f32)
    pix = torch.randn(16, 3, 224, 224, generator=gen).to(dev)

    def evaluate(mode):
        with torch.no_grad(), kernel_mode(mode):
            return pruned_vit_forward(pp, pix, b_cfg, pcfg)

    eval_ms = {"auto": [], "eager": []}
    for mode in ("auto", "eager", "eager", "auto"):
        eval_ms[mode].append(time_ms(lambda: evaluate(mode), iters=10))
    res["f32_eval_vit_b_b16_ms"] = {m: sum(v) / len(v) for m, v in eval_ms.items()}


def layer_times(checkout: str, only_f32: bool = False):
    """The `times` mode (module docstring) for the package of `checkout`;
    only_f32: f32_times alone."""
    sys.path.insert(0, checkout)
    from vit_pruning_tpu_torch.configs import deit_small, vit_huge
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_slice, vit_forward
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.cuda import layer_int8 as k8
    from vit_pruning_tpu_torch.ops.cuda import model as kmod
    from vit_pruning_tpu_torch.ops.cuda.build import load_library
    from vit_pruning_tpu_torch.ops.dispatch import encoder_fusion, kernel_mode, quant_mode
    from vit_pruning_tpu_torch.ops.masking import compact_dest
    from vit_pruning_tpu_torch.ops.quant import quantize_layer_params, with_kmajor_int8_weights

    def family_ms(fn, reps=3) -> dict:
        """Device ms per call of the kernels named *attention* and of the rest."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        tot = {"attention": 0.0, "other": 0.0}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0.0) or 0.0
            tot["attention" if "attention" in ev.key else "other"] += us / 1e3 / reps
        return tot

    res = {"checkout": checkout, "library": load_library()._name}
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator().manual_seed(7)
    if only_f32:
        f32_times(res, gen, dev)
        res["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
        print(json.dumps(res))
        return
    cfg = deit_small(num_labels=100)
    params = tree_to(init_vit_params(cfg, gen, "cpu"), dev, bf)
    lp, nh = layer_slice(params["layers"], 0), cfg.num_heads
    qlp = with_kmajor_int8_weights(quantize_layer_params(lp))
    for s in (197, 99):
        x = torch.randn(512, s, cfg.hidden_size, generator=gen).to(dev, bf)
        res[f"b1_s{s}"] = time_ms(lambda: kl.fused_vit_layer(x, lp, nh), iters=10)
        res[f"b5_s{s}"] = time_ms(lambda: kmod.fused_vit_encoder(x, params["layers"], nh), iters=10)
        res[f"b4_s{s}"] = time_ms(lambda: k8.fused_vit_layer_int8(x, qlp, nh), iters=10)
    x = torch.randn(512, 197, cfg.hidden_size, generator=gen).to(dev, bf)
    keep = torch.rand(512, 196, generator=gen).argsort(-1) < 98
    mask = torch.cat([torch.ones(512, 1, dtype=torch.bool), keep], 1).to(dev)
    dest = compact_dest(mask)
    res["b3_s197_cap99"] = time_ms(lambda: kl.fused_vit_layer_bucketed(x, lp, dest, mask, 99, nh),
                                   iters=10)
    x = torch.randn(128, 577, cfg.hidden_size, generator=gen).to(dev, bf)
    res["b1_s577_b128"] = time_ms(lambda: kl.fused_vit_layer(x, lp, nh), iters=5)
    hcfg = vit_huge(num_labels=100)
    hlp = tree_to(layer_slice(init_vit_params(hcfg.replace(num_layers=1), gen, "cpu")["layers"],
                              0), dev, bf)
    for s in (257, 129):
        x = torch.randn(64, s, hcfg.hidden_size, generator=gen).to(dev, bf)
        res[f"vit_h_b1_s{s}_b64"] = time_ms(lambda: kl.fused_vit_layer(x, hlp, hcfg.num_heads),
                                            iters=5)
    b2_times(res, gen, dev)
    serving_times(res, gen, dev)
    pix = torch.randn(512, 3, 224, 224, generator=gen).to(dev, bf)

    def fwd():
        return vit_forward(params, pix, cfg)

    with kernel_mode("auto"):
        res["dense_ms"] = time_ms(fwd, iters=10)
        res["dense_device_ms"] = family_ms(fwd)
        with encoder_fusion(True):
            res["dense_fused_ms"] = time_ms(fwd, iters=10)
            res["dense_fused_device_ms"] = family_ms(fwd)
        with quant_mode("int8"):
            res["dense_int8_ms"] = time_ms(fwd, iters=10)
            res["dense_int8_device_ms"] = family_ms(fwd)
    q, k, v = (torch.randn(512, 6, 197, 64, generator=gen).to(dev, bf) for _ in range(3))
    res["sdpa_bf16_512x6x197x64"] = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), iters=10)
    del q, k, v, params, x, pix
    torch.cuda.empty_cache()
    f32_times(res, gen, dev)
    res["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(res))


if __name__ == "__main__":
    main()
