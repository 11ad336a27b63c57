#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vit_pruning_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda); builds the
kernels from csrc/ itself. Phases:

  1. the card's name and power limit (nvidia-smi)
  2. build the kernels, print the seconds
  3. kernel B1 (fused_vit_layer) against its plain version: DeiT-S and
     composed geometry, S in {197, 131, 99, 66, 33, 17}, batch 8, and
     ViT-B/16 (phase 8's model) at S 197, batch 16; masked and not,
     float32 and bfloat16
  3c. kernel B4 (fused_vit_layer_int8) against its plain version on the
     same cases, with the int8 codes of every quantized activation compared
     (the count that differ is printed), and a row whose scaled values land
     on k + 0.5 through the row-quantization kernel (half to even); every
     B4 call's four products on the wgmma s8 body (its launch counter)
  3d. kernel B6 (fused_attention) against its plain version: DeiT-S heads
     (hd 64), S in {197, 99, 17}, hd 128 and hd 80 (ViT-H) at S 257, hd 16
     at S 17, unmasked, masked, and masked with one image's keys all
     masked (every row compared), float32 and bfloat16, and bf16 at hd 20
     and 12 (no multiple of 8), with the body each case took (the wgmma
     body for every bf16 case it takes, the split body for the rest); each
     f32 case also against a float64 attention, at no more than 4x the
     plain version's own error
  3e. kernel B7 (fused_mlp) against its plain version: the rows of S in
     {197, 99, 17} at DeiT-S width (MLP 1536) and composed width (MLP 768),
     136 rows at ViT-L width (D 1024, MLP 4096), 514 rows at ViT-H width
     (D 1280, MLP 5120) and 137 rows at D 100 (MLP 300), with the body each
     case took (float32: the split body; bfloat16: the tensor-core body, the
     FMA body at D 100)
  3f. kernel B5 (fused_vit_encoder) against its plain version: DeiT-S at 12
     layers and a 3-layer segment, composed geometry at a 3-layer segment,
     S in {197, 99, 17}, masked and not, float32 and bfloat16
  4. kernel B2 (fused_vit_layer_cls_logits) against its plain version:
     DeiT-S and composed geometry, S in {197, 99, 33, 17}, batch 8, float32
     and bfloat16, each call's launches by kind (the C counters, the
     wrapper's tally and the plan of ops/cuda/layer.py::cls_logits_launches
     equal; at most 4), the plan's mirror against the C rule; then the CLS
     attention isolated (cls_attention_isolated: O = I, fc2 = 0, LN_f = (1,
     0), the classifier the identity, a peaked softmax, x ~ 1e-5) at hd
     16-80 and widths D 100 / M 1000, S 2-577, batch 4 and 9, bf16 (three
     launches) held to LN_f of the plain version's CLS context, f32 (four)
     to LN_f of the CLS context in float64 at F32_SPLIT_ERR times the f32
     plain version's error
  4b. kernel B3 (fused_vit_layer_bucketed) against its plain version: S 197
     with cap 99 / 131 / 197 and S 99 with cap 50, random kept counts up to
     the cap and an image with only CLS kept; skipped rows must be x
     bit for bit
  3g. kernels B8a / B8b (fused_patch_embed_u8 / _f) against their plain
     versions at DeiT-S's (K 768, D 384) and ViT-H's (K 588, D 1280) patch
     embedding, batch 64, float32 and bfloat16 weights, uint8 / float
     patches, pos in the weights' dtype and in float32, with the body each
     case ran (the wgmma body for bf16 weights, the split body for f32; bf16
     patches with f32 weights too); B8a and B8b at patch width 75 (rows no
     4- or 8-byte multiple) with bf16 and f32 weights (uint8 rows from an
     odd address too); bad inputs raise
  3h. ViT-H/14's geometry (head dim 80, S 257) in B1-B5 against their plain
     versions at every length phase 5e gives them: B1 and B4 at S 257 / 171
     / 129 / 86 / 43 / 22 with KW 1280 and 640, B2 at S 129 / 43 / 22, B3 at
     S 257 with cap 129 and the last token kept, B5 on two layers at S 257;
     masked and not, float32 at batch 4 and bfloat16 at batch 32; the head
     dims the C predicate takes equal the wrappers'; head dim 128 raises,
     naming the dims taken; then the short head dims of the repo's configs,
     vit_tiny's 16 (S 17, D 64, MLP 128) and the quality gate model's 32
     (S 65, D 128, MLP 256): B1-B5 masked and not, float32 and bfloat16,
     batch 8; B4's products on the wgmma s8 body in every case
  3i. the bf16 GEMM bodies under B1, B2, B3 and B5 (ops/cuda/gemm.py)
     against their plain version at every product shape of the main paths
     (DeiT-S and composed widths at S 197 / 131 / 99 / 66 / 33 / 17, ViT-H
     and its composed width at S 257 / 171 / 129 / 86 / 43 / 22, B2's
     strided CLS rows and N 100 classifier, every epilogue; B1's four
     products at ViT-B/16, batch 16 x S 197; DINOv2's gated fc1 and
     LayerScale epilogues at batch 32 x S 689, with their gated and scaled
     tile counts), with the body each took
     (wgmma where TMA can describe the operands, else WMMA) and the tiles
     and blocks of the wgmma body's walk; the four products at the bf16
     cells' rows (DeiT-S 512 x 99 and 512 x 197, ViT-H 64 x 129) and at 64 x
     257, at least 2 tiles a block, timed beside torch.matmul and their bound
  3k. sequences past the attention bodies' resident limit (K and V
     streamed): B1, B2, B3 (cap S // 2 + 1, the last token kept), B4, B5
     (two layers) and B6 against their plain versions at S 577 with hd 64
     (DeiT-S at 384) and hd 80 (ViT-H/14 at 336, full width) and at S 785
     (DeiT-S at 448), masked and not, float32 at batch 2, bfloat16 at 4
  3m. B1-B5's attention body (csrc/layer_attention.cu) at the edges of its
     64-key chunks, 64-query tiles and residency, S in {63, 64, 65, 128,
     129, 197, 256, 257, 288, 289}, at head dims 16, 32, 64 and 80 (ViT-H
     at full width): B1 (staged2), B5 on one layer (normalised) and B4,
     unmasked and masked (a whole chunk of keys blanked, one image's keys
     all masked; every row compared), B3 at a capacity of each length with
     per-image counts; bfloat16 and float32 (B4: S 65, 257) at batch 4; each call's
     attention on the body ops/cuda/layer.py::attention_body names, by the
     C counters and the wrappers' tally; then the attention isolated
     (attention_isolated: O = I, an MLP adding 0, a peaked softmax, x ~
     1e-5) for B1, B3, B4 and B5 at the same edges, in bf16 held to x +
     staged2_attention at two bf16 steps of the context, in f32 (B1, B3,
     B5) to x + a float64 context at no more than 4x the plain version's
     own error against it (B4: its plain version, one int8 step)
  3j. B4's int8 product body (wgmma s8 + TMA) one product at a time at
     every product shape of B4 at DeiT-S (batch 512 x 197) and ViT-H (64 x
     257), and at vit_tiny's (136 rows, N 192, K 64) and a ragged one, the
     output bit-equal to the exact int32 product's dequant (+ bias), timed
     beside torch._int_mm on the same operands (TOP/s)
  5. end to end, DeiT-S @224 with 100 labels at batch 64: dense vit_forward
     and headline / composed / ultra through serving_forward, kernels
     (mode 'auto') against plain PyTorch (mode 'eager'; a served forward's
     plain path from the served embed on, plain_after_the_served_embed, so
     that both decide the drop on one embedding; the whole eager route
     logged beside), with the launch counts of every forward (a served
     call: the embed once, B8a on the image); vit_tiny (hd 16) dense and
     headline the same way
  5b. the re-decide path end to end, same model and batch: pruned_vit_forward
     in modes topk (top_k 98), mask with mask_budget 98, mask without a
     budget (per-layer median thresholds from a measure_only probe) and
     random (top_k 98, a seeded generator), kernels against plain PyTorch
  5c. int8 serving end to end (quant_mode('int8')), same model and batch:
     dense vit_forward, headline / composed / ultra through serving_forward
     (logits_only=False in both modes, then logits_only=True in 'auto', whose
     last layer is the float B2), topk50 / mask_budget50 / mask / random50
     through pruned_vit_forward, kernels against plain PyTorch with the
     launch counts of every forward (and four wgmma s8 products for each B4
     launch), and the int8 logits against the float ones
  5d. the dense model's remaining routes end to end, same model and batch,
     with encoder fusion on: vit_forward with a head_mask (B7 x 12, no B1),
     with output_hidden_states (B1 x 12, no B5), and plain (B5 x 1);
     headline / composed / ultra through serving_forward (B5 once per
     non-empty segment, B2 x 1); pruned_vit_forward mode 'none' (B5 x 1);
     dense and headline under int8 (the float B5, equal to float); mha with
     use_kernel in mode 'kernel' (B6 x 1), with B6's and B7's launches per
     body (the bf16 forwards on the tensor-core bodies, the f32 ones on B6's
     and B7's split bodies); kernels against
     plain PyTorch,
     and in bfloat16 every B5 route also against itself with B5's plain
     version in the kernel's place
  5e. ViT-H/14 @224 end to end at full width and depth (32 layers), random
     weights from a seed: dense vit_forward, headline / composed / ultra
     through serving_forward, topk50 through pruned_vit_forward, f32 at
     batch 4 and bf16 at batch 32, kernels against plain PyTorch with the
     launch counts (B1 x 32; B1 x 31 + B2; B3 x 32), and dense / headline
     under int8 (B4 x 32; B4 x 31 + the float B2, four wgmma s8 products
     each) held as in 5c
  5f. the served embed (embed_from_u8 in mode 'auto': B8a reading the
     image, one launch a call) against the eager route (mode 'eager') and
     bit for bit against embed_u8 (B8a on extract_patches, CLS and
     registers concatenated); embed_fused (B8b) against the model's embed;
     DeiT-S and ViT-H at batch 64, DINOv2-g at 518 px with 4 registers at
     batch 16, f32 and bf16, with their launch counts and bodies (bf16
     weights: wgmma)
  5g. DeiT-S at 384 (interpolate_pos_embed: S 577) end to end, dense and the
     headline (288 of 576 patches) through serving_forward, kernels against
     plain PyTorch with the launch counts, float32 and bfloat16, batch 32
  5h. training at DeiT-S width (12 layers, batch 32, cls_mlp predictor,
     float32): one B1 layer's and one two-layer B5 call's backward against
     the eager layers' for one upstream gradient; three train steps of each
     phase (cosine, then classification) in modes mask and topk and one
     classification step of mode none under encoder fusion (B5), kernel
     path against the eager path (losses within 1e-4 relative, first keep
     masks equal, B1 / B5 launched in the steps); remat against no remat;
     bf16 compute finite; ms/step of each phase on both paths (host clock,
     the mean of 5 steps after the compared ones)
  6. which body ran B1-B5's attention on phases 5-5h (the C counters per
     body equal to the wrappers' tally by the Python mirror of the C rule:
     every bf16 launch on a wgmma body, the streamed one included; checked
     again for 3l and 5i after them); which GEMM body ran the bf16 products
     of phases 5-5f (launches per
     body, the shapes that took the WMMA body); times at batch 512 in
     bfloat16, kernel path and plain path (float and
     int8), and each kernel beside its plain version and its eager PyTorch
     equivalent (info only; B2 also beside a CLS-only composition of
     PyTorch calls, and its launches by kind on 5-5h held to the wrapper's
     tally); each kernel's bound from its shapes and its
     share of it (B6 and B7 must stay within theirs); the head_mask forward
     (B7 x 12), kernel path and plain path, in bf16 at batch 512 and in f32
     at batch 32; the device
     time of the dense, headline, topk50, mask, dense_int8, topk50_int8 and
     dense-with-encoder-fusion forwards by kernel family and of the
     once-per-forward weight quantization (torch.profiler); dense and ultra
     with encoder fusion on and off; B8a / B8b at DeiT-S batch 512 and ViT-H
     batch 64 beside the library (cuBLAS addmm) on the same patches, their
     entry points and the eager equivalents on the images; B8a on the image
     (the served embed) at DeiT-S batch 512 and 1024, ViT-H 64 and DINOv2-g
     32 beside B8a on the patch matrix, the served embed_from_u8, the eager
     one and the bound; ViT-H at
     batch 64: B1-B5 at its geometry beside their eager equivalents, and
     dense / headline / composed / ultra, kernel path and plain path (mean
     of 5 after 2 warm-ups); B1 and B6 at DeiT-S S 577, batch 128, beside
     the cuBLAS layer and f32 SDPA; B1-B5's attention a layer in the dense
     forward beside bf16 SDPA at its shape (info: another rounding); the
     f32 routes (B1 at ViT-B/16 batch 16; B2, B3, B5, B6, B7, B8b and B8a
     with f32 weights at DeiT-S batch 32) beside their plain versions, the
     f32 PyTorch call and bound_split6, with each row's f32 attention
     launches by body (B2: each of its four launches' device us)
  3l. (after 6, so that 6's GEMM body counts stay those of 5-5h) widths
     that are not multiples of the kernels' (ROADMAP C.1), zero-padded by
     the wrappers: B1, B2, B3, B4 and B5 (two layers) at DeiT-S with 1000
     of 1536 MLP channels kept and at hidden width 100 (4 heads of 16, MLP
     300), B8a / B8b and B8a on the image at D 100, float32 and bfloat16,
     against their plain versions on the unpadded weights; every kernel
     launched
  5i. the serving export (serving.py::export_serving / load_exported) of
     the DeiT-S headline, bf16 at batch 512, float32 and int8 at batch 64:
     the program's vpt:: operators (the embed + B1 x 11 + B2, or the embed
     + B4 x 11 + B2), its
     logits bit-equal to the direct kernel-path forward's, the same
     launches, a wrong batch refused, the float32 program loaded and run in
     a fresh process that imports the port alone; ms/batch of the loaded
     program and of the direct forward (median of 10), info
  8. the user's CLI (vit_pruning_tpu_torch/cli.py) at ViT-B/16 @224, the
     reference's own model: the native preprocessing library built from
     the checkout and held against vit_preprocess on the card; `train
     --model vit_base --dataset synthetic --train_size 64 --test_size 32
     --train_batch_size 16 --num_epochs 1 1 --bf16` from a random ViT-B
     given as --torch_checkpoint (the CLI writes its best checkpoint; B1
     launched inside the train steps; the first step of each phase within
     1e-4 relative of the same command under kernel mode 'eager'), `eval`
     of that checkpoint through its config sidecar (every batch's logits
     against the eager path's), `export` (the checkpoint's tensors); ms
     per train step and per eval batch
  9. the quality gates on the card: quality_torch.main on the gate model
     with --kernels auto, epochs cut (GATE_ARGV): quality.py's own checks
     (dense baseline at least 5x chance, the JSON schema), finite
     accuracies, B1 / B3 / B4 launched
 10. parallelism (vit_pruning_tpu_torch/parallel/) at DeiT-S width on 2
     gloo ranks sharing the card, spawned after the build (parallel_rank):
     the data 2 train step (bce_oracle, f32, batch 32), its ZeRO-1 twin and
     the data 1 x model 2 step against the single-process step through
     dryrun_multichip_torch.py's helpers (loss 1e-5 relative, params 1e-5
     where |grad| >= GRAD_FLOOR, Adam's first moments 1e-3 of each leaf's
     largest; ZeRO's moments halved); dp uint8 serving of the headline in
     bf16 at batch 512 and data 1 x model 2 serving of 256 rows against
     serving_forward (bit-equal, else two bf16 steps); pipeline_forward (2
     stages of 6 layers, batch 64) and pruned_pipeline_forward (headline +
     merge_dropped) within 2e-5 of the single-process forwards. B1 and B2
     launched on every rank; the backend, the hops staged through the
     host, times and peak memory are printed
 11. the nn.Module adapter (models/torch_module.py::PrunedViT) at DeiT-S
     width (module_path): under torch.inference_mode(), bf16, batch 512,
     the headline (B1), the headline under encoder fusion (B5), mode topk
     (B3) and both under int8 (B4), each bit-equal to the functional
     forward on param_tree() with equal launches, ms/batch of both; one
     f32 train step (mode mask, batch 32) through the module's Parameters
     and masked_adam against harness.make_train_step (loss within 1e-4, B1
     under RecomputedBackward); a grad-enabled topk call raises
 5j. (after 11) DINOv2 ViT-g/14 with registers (dinov2_path) at full width
     and depth, served from uint8 through serving_forward as the
     benchmark's DINOv2 cell: bf16, batch 32, S 689, fc1 interleaved at
     set-up; one call's counts from 0: the embed once, B1 x 40, no B2-B8b,
     gated tiles 40 x
     the fc1 product's, scaled tiles 80 x O's and fc2's; its logits within
     5% of the float32 plain forward, the first keep masks equal to bf16
     plain's; one B1 layer at [32, 689, 1536] against fused_vit_layer_ref
     at bf16_tol; fc1 in checkpoint order and the float32 route refused
  7. records: before 8, importing every module of the port and
     quality_torch.py loads neither pandas nor transformers (8 and 9 print
     the metrics tables, which import pandas where it is installed); after
     9, nothing of jax or of the JAX package was loaded (by module name or
     by file) and no line of quality_torch.py or of this script imports
     them; the kernels'
     JSON line (launches: B1-B7 on the DeiT-S paths of 5-5d, B8 on 5f's;
     B4's, B6's, B7's and B8's also per body, and B1's, B3's, B4's and
     B5's attention launches per body on 5-5h, a wider window than
     launches', as attention_5_to_5h; ViT-H's are logged in 5e;
     B1's and B5's also launches_train, those of 5h's train steps; every
     row launches_cli, by command of phase 8, and launches_gate, phase
     9's; train_steps_* count only the launches inside phase 8's train
     steps; launches_widths, phase 3l's; launches_export, each of 5i's
     loaded programs' calls; launches_parallel, phase 10's by rank;
     launches_module, phase 11's module calls by run; launches_dinov2,
     5j's served call), the device line

Any failed check raises, so the exit code is non-zero. The line before the
last is the kernels' JSON record; the last line is the device record.
Weights are random, from a torch.Generator seed; images from a numpy seed.
"""

import contextlib
import ctypes
import functools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
# the cls_mlp predictor's random init puts every score within ~1e-3 of 0.5;
# this gain on its weights spreads the scores (sigmoid inputs of a few
# units at DeiT-S width) so that the f32 top-k cuts are not near ties
PREDICTOR_GAIN = 10.0
F32_ATOL = 1e-4  # kernel vs plain, both f32-accumulated; sums in another order
# the f32 attention (csrc/split_attention.cuh) against a float64 one: its error at most
# F64_FACTOR times the plain f32 version's, or F64_FACTOR f32 steps (F32_ULP relative) of
# the largest output where the plain version's is below one
F64_FACTOR = 4.0
F32_ULP = 2.0 ** -23
# the f32 split body (csrc/gemm.cu) against a float64 product: its relative error
# may be this many times the f32 plain version's own (cuBLAS f32 on the same
# operands), so that it is an f32 product in accuracy and not only within F32_ATOL
F32_SPLIT_ERR = 2.0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): bf16 and
# int8 tensor cores and device memory; a kernel's bound is the larger of its
# operations and its bytes over these
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
# and the CUDA cores' float32 rate. B6's PV and B7's second product take an
# unrounded f32 operand by contract; split exactly into three bf16 parts it
# runs as three bf16 tensor-core passes, so such a product's least time is
# the smaller of its FLOP at this rate and three times its FLOP at the bf16
# peak (bound_split)
PEAK_FP32_FLOPS = 67e12
# the codes of a quantized row that the half-to-even check expects: amax 127
# makes the row scale exactly 1, so each code is the value rounded half to even
HALF_EVEN_ROW = [127.0, 0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 126.5, -126.5, 0.49, 2.51,
                 -127.0, 64.5, -64.5, 7.0]
HALF_EVEN_CODES = [127, 0, 2, 2, 4, 0, -2, -2, 126, -126, 0, 3, -127, 64, -64, 7]
# phase 9: quality_torch.py on the gate model with the kernels, its epochs cut so
# that the phase stays short (the full default runs are recorded in PERF.md)
GATE_ARGV = ["--kernels", "auto", "--preset", "both", "--epochs", "4", "--pred_epochs", "3",
             "--recover_epochs", "2"]


def bound_split6(flops: float, nbytes: float):
    """The least time of f32 work at f32 accuracy: its FLOP at the CUDA cores'
    f32 rate, or six bf16 tensor-core passes (both operands split into three
    exact bf16 parts, the cross terms down to 2^-16 kept), whichever is less;
    against the bytes. (least ms, what bounds it)"""
    t_op = min(flops / PEAK_FP32_FLOPS, 6 * flops / PEAK_BF16_FLOPS) * 1e3
    t_mem = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def log(msg: str):
    print(msg, flush=True)


def cls_library(gcfg, glp, gf, gh):
    """B2's function as a CLS-only composition of PyTorch calls (bf16: cuBLAS, the
    fused layer norm, SDPA; another rounding): LN1 over every row, one addmm for K
    and V, scaled_dot_product_attention with one query an image, then addmm /
    layer_norm / gelu for the tail on the B rows. The fused K/V weights are made
    once, outside the timed call. Phase 6's yardstick for B2 (library_ms), and
    kernel_variants.py's."""
    fn = torch.nn.functional
    a, mlp, eps = glp["attn"], glp["mlp"], gcfg.layernorm_eps
    nh, hd, d = gcfg.num_heads, gcfg.head_dim, gcfg.hidden_size
    kvw = torch.cat([a["k"]["w"], a["v"]["w"]], 1)
    kvb = torch.cat([a["k"]["b"], a["v"]["b"]])

    def run(x):
        b, s, _ = x.shape
        h1 = fn.layer_norm(x, (d,), glp["ln1"]["g"], glp["ln1"]["b"], eps)
        kv = torch.addmm(kvb, h1.view(b * s, d), kvw).view(b, s, 2, nh, hd)
        q = torch.addmm(a["q"]["b"], h1[:, 0], a["q"]["w"]).view(b, nh, 1, hd)
        ctx = fn.scaled_dot_product_attention(q, kv[:, :, 0].transpose(1, 2),
                                              kv[:, :, 1].transpose(1, 2))
        x1 = torch.addmm(a["o"]["b"], ctx.reshape(b, nh * hd), a["o"]["w"]) + x[:, 0]
        m = fn.gelu(torch.addmm(mlp["fc1"]["b"], fn.layer_norm(
            x1, (d,), glp["ln2"]["g"], glp["ln2"]["b"], eps), mlp["fc1"]["w"]),
            approximate="tanh")
        x2 = torch.addmm(mlp["fc2"]["b"], m, mlp["fc2"]["w"]) + x1
        return torch.addmm(gh["b"], fn.layer_norm(x2, (d,), gf["g"], gf["b"], eps), gh["w"])
    return run



def launch_profile(fn, calls: int = 3):
    """The device kernels of one call of fn, in order, from torch.profiler
    over `calls` synchronised calls (the last call's): [name, device us] a
    launch and their sum; None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    ks = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    if not ks:
        return None
    last = ks[len(ks) - len(ks) // calls:]
    by = [[e.name.replace("void ", "")[:60], round(e.time_range.end - e.time_range.start, 3)]
          for e in last]
    return {"by_launch": by, "busy_us": round(sum(us for _, us in by), 3)}


def bf16_tol(ref) -> float:
    """Two bf16 steps at the reference's largest magnitude: kernel and plain
    version round to bf16 at the same places, but an f32 sum taken in
    another order can land a value on the neighbouring bf16 number, once in
    an intermediate and once in the output."""
    top = max(float(ref.abs().max()), 1e-30)
    return 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7)


def int8_step(ref, x) -> float:
    """One int8 step of a layer's residual update, max|ref - x| / 127. An
    activation within float noise of k + 0.5 may be rounded to different
    codes by the kernel and its plain version (their sums run in another
    order); one code apart moves that product's output by about one such
    step, which is the tolerance an int8 comparison adds to the float one."""
    return float((ref.float() - x.float()).abs().max()) / 127.0


def rel_err(a, b) -> float:
    """||a - b|| / ||b||, over the whole batch."""
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


class Checks:
    """Collects failures of one phase and raises them together."""

    def __init__(self, phase: str):
        self.phase, self.failed = phase, []

    def __call__(self, ok: bool, msg: str):
        if not ok:
            self.failed.append(msg)
            log(f"  FAIL {msg}")

    def done(self):
        if self.failed:
            raise AssertionError(f"{self.phase}: {len(self.failed)} check(s) failed: "
                                 + "; ".join(self.failed))
        log(f"{self.phase}: ok")


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def perturbed_layer(lp: dict, gen: torch.Generator) -> dict:
    """Random LN gains/biases and linear biases (the init leaves them 1 and
    0, which would hide a bias or gain bug)."""
    out = {}
    for k, v in lp.items():
        if isinstance(v, dict):
            out[k] = perturbed_layer(v, gen)
        elif k in ("g", "b"):
            out[k] = v + 0.1 * torch.randn(v.shape, generator=gen).to(v.device)
        else:
            out[k] = v
    return out


def vit_h_params(cfg, pcfg, dev, seed: int = SEED) -> dict:
    """ViT-H/14 with its predictor, random from a seed, in float32 on the
    card. init_pruned_vit_params draws on the CPU, ~1.4 s per 10M values
    here, so 632M would take minutes: it draws a one-layer model (the embed,
    the head and the init's rules), and every per-layer leaf is then drawn
    again for all layers on the card by the same rule: trunc-normal(0.02)
    weights ('w'); biases and LN gains copied (0 and 1)."""
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params

    one = init_pruned_vit_params(cfg.replace(num_layers=1), pcfg,
                                 torch.Generator().manual_seed(seed), "cpu")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_layers = cfg.num_layers

    def grow(tree, key=""):
        if isinstance(tree, dict):
            return {k: grow(v, k) for k, v in tree.items()}
        if key != "w":
            return tree.to(dev).expand(n_layers, *tree.shape[1:]).contiguous()
        w = torch.empty((n_layers, *tree.shape[1:]), device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w * 0.02

    backbone = dict(tree_to(one["backbone"], dev), layers=grow(one["backbone"]["layers"]))
    return {"backbone": backbone, "predictor": grow(one["predictor"])}


def dinov2_path(dev) -> dict:
    """Phase 5j: DINOv2 ViT-g/14 with registers (configs.py::dinov2_giant_reg:
    D 1536, 40 layers of 24 heads of 64, a SwiGLU MLP of M 4096, LayerScale,
    4 registers, S 1374 at 518 px, the head on CLS ⊕ the patch mean) at full
    width and depth, served from uint8 pixels through serving_forward as the
    benchmark's DINOv2 cell serves it: bf16, batch 32, 684 of 1369 patches
    kept before layer 0 (S 689 in every layer), fc1 interleaved once at
    set-up (ops/swiglu.py::with_gated_fc1). Random weights from the seed as
    vit_h_params draws them, biases and LN parameters perturbed, LayerScale's
    gains per channel (0.5 + 0.25 N(0, 1)), the predictor's gain as ViT-H's.
      - one served call with every launch count and the GEMM body's counts
        set to 0 just before it: the embed once (B8a on the image), B1 x 40
        and no B2-B8b; gated tiles 40 x the
        fc1 product's tiles (N 8192), scaled tiles 80 x the O / fc2
        product's (N 1536), by ops/cuda/gemm.py::wgmma_walk over 22,048 rows;
      - its logits against the plain path (mode 'eager') in bf16 and in
        float32: finite, the first keep masks equal to bf16 plain's (the one
        drop is decided from the embedding: the plain path from the served
        embed, plain_after_the_served_embed), and within 5% (relative L2) of
        the float32 plain forward, as phase 5c holds int8;
      - one B1 layer at [32, 689, 1536] against fused_vit_layer_ref on fc1 in
        checkpoint order, at bf16_tol, with its tile counts;
      - the refusals: layers_for with fc1 in checkpoint order on the card,
        and the float32 kernel route (B1's f32 body has no gated epilogue).
    Returns the served call's launches by kernel and its body counts."""
    from vit_pruning_tpu_torch.configs import PruneConfig, dinov2_giant_reg
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.vit import layer_slice, layers_for
    from vit_pruning_tpu_torch.ops.cuda import gemm as kg
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.dispatch import kernel_mode
    from vit_pruning_tpu_torch.ops.swiglu import with_gated_fc1
    from vit_pruning_tpu_torch.serving import serving_forward

    check = Checks("phase 5j (DINOv2 ViT-g/14 with registers, served end to end)")
    t0 = time.perf_counter()
    dcfg = dinov2_giant_reg(num_labels=1000)
    n, L, batch, top_k = dcfg.num_patches, dcfg.num_layers, 32, 684
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", predictor_hidden=64, top_k=top_k)
    f32_params = vit_h_params(dcfg, pcfg, dev, seed=SEED + 518)
    gen = torch.Generator().manual_seed(SEED + 519)
    bb = f32_params["backbone"]
    lay = perturbed_layer(bb["layers"], gen)
    for key in ("ls1", "ls2"):
        lay[key] = (0.5 + 0.25 * torch.randn(lay[key].shape, generator=gen)).to(dev)
    gain = PREDICTOR_GAIN * math.sqrt(384 / dcfg.hidden_size)
    f32_params = {"backbone": dict(bb, layers=lay, ln_f=perturbed_layer(bb["ln_f"], gen),
                                   head=perturbed_layer(bb["head"], gen)),
                  "predictor": dict(f32_params["predictor"], mlp={
                      k: {"w": p["w"] * gain, "b": p["b"]}
                      for k, p in f32_params["predictor"]["mlp"].items()})}
    plain = tree_to(f32_params, dev, torch.bfloat16)  # fc1 in checkpoint order
    served = dict(plain, backbone=dict(plain["backbone"],
                                       layers=with_gated_fc1(plain["backbone"]["layers"])))
    served_f32 = dict(f32_params, backbone=dict(
        f32_params["backbone"], layers=with_gated_fc1(f32_params["backbone"]["layers"])))
    u8 = torch.from_numpy(np.random.RandomState(SEED + 518).randint(
        0, 256, (batch, 3, dcfg.image_size, dcfg.image_size), dtype=np.uint8)).to(dev)
    torch.cuda.synchronize()
    log(f"  DINOv2-g params (random, seed {SEED + 518}) built in {time.perf_counter() - t0:.1f} s")

    def serve(params):
        return serving_forward(params, u8, dcfg, pcfg, logits_only=True, quant="none")

    with kernel_mode("auto"):
        serve(served)  # builds nothing: the kernels were built in phase 2; a warm call
        torch.cuda.synchronize()
        reset_launches()
        kg.reset_body_counts()
        got = serve(served)
        torch.cuda.synchronize()
        launches, bodies = read_launches(), kg.body_counts()
        ms = median_ms(lambda: serve(served), iters=5, warmup=1)
    with plain_after_the_served_embed():
        ref = serve(plain)
        fl = serve(f32_params)
    torch.cuda.synchronize()
    rows = batch * (dcfg.seq_len - n + top_k)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = {w: kg.wgmma_walk(rows, w, sms)["tiles"] for w in (2 * dcfg.mlp_dim, dcfg.hidden_size)}
    fc1_tiles, d_tiles = tiles[2 * dcfg.mlp_dim], tiles[dcfg.hidden_size]
    want = {"gated_tiles": L * fc1_tiles, "scaled_tiles": 2 * L * d_tiles}
    counted = {k: bodies[k] for k in want}
    tag = f"dinov2_g14_reg headline bfloat16 batch {batch} (S {rows // batch})"
    others = {k: v for k, v in launches.items()
              if k in ("b2", "b3", "b4", "b5", "b6", "b7", "b8a", "b8b")}
    check(launches["b1"] == L and launches["b8a_image"] == 1 and not any(others.values()),
          f"{tag}: launches B1 {launches['b1']} (want {L}), the embed {launches['b8a_image']} "
          f"(want 1), B2-B8b {others} (want 0)")
    check(counted == want, f"{tag}: body counts {counted}, want {want}")
    lg, lr, lf = got["logits"].float(), ref["logits"].float(), fl["logits"].float()
    check(lg.shape == (batch, 1000) and bool(torch.isfinite(lg).all()),
          f"{tag}: logits not finite [{batch}, 1000]")
    kernel_err, plain_err = rel_err(lg, lf), rel_err(lr, lf)
    check(kernel_err < 0.05, f"{tag}: logits {kernel_err:.4f} relative from float32 plain")
    check(bool(torch.equal(got["keep_masks"][0], ref["keep_masks"][0])),
          f"{tag}: first keep masks differ")
    log(f"  {tag}: launches {dict((k, v) for k, v in launches.items() if v)}; body counts "
        f"{dict(bodies)}; logits from float32 plain {kernel_err:.4f} relative (bf16 plain "
        f"{plain_err:.4f}), kernel vs bf16 plain {rel_err(lg, lr):.4f}, argmax agree with "
        f"float32 {(lg.argmax(-1) == lf.argmax(-1)).float().mean().item():.3f}; served call "
        f"{ms:.2f} ms ({batch / ms * 1e3:.1f} img/s, event median of 5)")

    # one B1 layer at the cell's shape against its plain version on checkpoint order
    x = torch.randn(batch, rows // batch, dcfg.hidden_size,
                    generator=torch.Generator().manual_seed(SEED + 520)).to(dev, torch.bfloat16)
    kg.reset_body_counts()
    one = kl.fused_vit_layer(x, layer_slice(served["backbone"]["layers"], 0), dcfg.num_heads,
                             dcfg.layernorm_eps)
    torch.cuda.synchronize()
    one_counts = kg.body_counts()
    one_ref = kl.fused_vit_layer_ref(x, layer_slice(plain["backbone"]["layers"], 0),
                                     dcfg.num_heads, dcfg.layernorm_eps).float()
    d = (one.float() - one_ref).abs().max().item()
    tol = bf16_tol(one_ref)
    log(f"  B1 dinov2 layer [{batch}, {rows // batch}, {dcfg.hidden_size}]: max_abs_err {d:.3e} "
        f"(tol {tol:.1e}), gated tiles {one_counts['gated_tiles']}, scaled tiles "
        f"{one_counts['scaled_tiles']}")
    check(bool(torch.isfinite(one).all()) and d <= tol, f"B1 dinov2 layer: err {d:.3e} > {tol:.1e}")
    check((one_counts["gated_tiles"], one_counts["scaled_tiles"])
          == (fc1_tiles, 2 * d_tiles), f"B1 dinov2 layer: counts {one_counts}")

    # the routes that refuse: fc1 not interleaved at load, and float32 on the kernels
    for what, fn, match in (
            ("layers_for on fc1 in checkpoint order",
             lambda: layers_for(plain["backbone"]["layers"], "none"), "checkpoint order"),
            ("the float32 kernel route", lambda: serve(served_f32), "bfloat16 alone")):
        try:
            with kernel_mode("auto"):
                fn()
            raised = ""
        except ValueError as e:
            raised = str(e)
        check(match in raised, f"{what}: did not raise ({raised[:80]!r})")
        if raised:
            log(f"  {what}: refused ({raised[:90]}...)")
    del f32_params, plain, served, served_f32
    torch.cuda.empty_cache()
    check.done()
    return {"launches": launches, "bodies": dict(bodies), "ms": ms}


def long_sequences(dev, err: dict):
    """Phase 3k: sequences past the resident limits (C.1): B1-B6 against their
    plain versions at S 577 with hd 64 (DeiT-S at 384) and hd 80 (ViT-H/14 at
    336, full width) and at S 785 (DeiT-S at 448). B1, B4 and B5 (two layers)
    masked and not, B2, B3 at cap S // 2 + 1 with the last token kept, B6 on
    [B, H, S, hd] masked and not; float32 at batch 2, bfloat16 at batch 4,
    with phase 3h's tolerances. Random layers from a generator of its own."""
    from vit_pruning_tpu_torch.configs import deit_small, vit_huge
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_slice
    from vit_pruning_tpu_torch.ops.cuda import attention as ka
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.cuda import layer_int8 as k8
    from vit_pruning_tpu_torch.ops.cuda import model as kmod
    from vit_pruning_tpu_torch.ops.masking import compact_dest
    from vit_pruning_tpu_torch.ops.quant import quantize_layer_params

    check = Checks("phase 3k (long sequences in B1-B6 vs plain)")
    gen = torch.Generator().manual_seed(SEED + 577)
    geos = (("deit_s@384 (hd 64)", deit_small(num_labels=100).replace(image_size=384)),
            ("deit_s@448 (hd 64)", deit_small(num_labels=100).replace(image_size=448)),
            ("vit_h@336 (hd 80)", vit_huge(num_labels=100).replace(image_size=336)))
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    batch = {torch.float32: 2, torch.bfloat16: 4}

    def valid_rows(got, ref, mask):
        d = (got.float() - ref.float()).abs()
        return (d if mask is None else d[mask]).max().item()

    for gname, gcfg in geos:
        s, nh = gcfg.seq_len, gcfg.num_heads
        sp = init_vit_params(gcfg.replace(num_layers=2), gen, "cpu")
        stack = perturbed_layer(sp["layers"], gen)
        lp_cpu, f_cpu, h_cpu = (layer_slice(stack, 0), perturbed_layer(sp["ln_f"], gen),
                                perturbed_layer(sp["head"], gen))
        for dname, dt in dtypes.items():
            lp, f, h, st = (tree_to(t, dev, dt) for t in (lp_cpu, f_cpu, h_cpu, stack))
            qp = quantize_layer_params(lp)
            ftol = (lambda ref: F32_ATOL) if dt == torch.float32 else bf16_tol
            hb = batch[dt]
            x = torch.randn(hb, s, gcfg.hidden_size, generator=gen).to(dev, dt)
            m = torch.rand(hb, s, generator=gen) > 0.3
            m[:, 0] = True
            for mask in (None, m.to(dev)):
                mtag = "mask" if mask is not None else "nomask"
                cases = (
                    ("B1", lambda: kl.fused_vit_layer(x, lp, nh, gcfg.layernorm_eps, mask),
                     lambda: kl.fused_vit_layer_ref(x, lp, nh, gcfg.layernorm_eps, mask), 0.0),
                    ("B4", lambda: k8.fused_vit_layer_int8(x, qp, nh, gcfg.layernorm_eps, mask),
                     lambda: k8.fused_vit_layer_int8_ref(x, qp, nh, gcfg.layernorm_eps, mask),
                     None),
                    ("B5", lambda: kmod.fused_vit_encoder(x, st, nh, gcfg.layernorm_eps, mask),
                     lambda: kmod.fused_vit_encoder_ref(x, st, nh, gcfg.layernorm_eps, mask),
                     0.0),
                )
                for key, fn, ref_fn, extra in cases:
                    got, ref = fn(), ref_fn()
                    torch.cuda.synchronize()
                    d = valid_rows(got, ref, mask)
                    tol = ftol(ref.float()) + (int8_step(ref, x) if extra is None else extra)
                    if dt == torch.float32:
                        err[key.lower()] = max(err[key.lower()], d)
                    tag = f"{key} {gname} {dname} B={hb} S={s} {mtag}"
                    log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.2e})")
                    check(bool(torch.isfinite(got).all()) and d <= tol, tag)
            got = kl.fused_vit_layer_cls_logits(x, lp, f, h, nh, gcfg.layernorm_eps)
            ref = kl.fused_vit_layer_cls_logits_ref(x, lp, f, h, nh, gcfg.layernorm_eps)
            torch.cuda.synchronize()
            d, tol = (got.float() - ref.float()).abs().max().item(), ftol(ref.float())
            if dt == torch.float32:
                err["b2"] = max(err["b2"], d)
            tag = f"B2 {gname} {dname} B={hb} S={s}"
            log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.1e})")
            check(got.shape == (hb, 100) and bool(torch.isfinite(got).all()) and d <= tol, tag)
            # B3 at about half: CLS, the last token and count - 2 random others kept
            cap = s // 2 + 1
            counts = torch.tensor([cap, 2, cap // 3, cap - 7] * (hb // 2))[:hb]
            rank = torch.rand(hb, s - 2, generator=gen).argsort(-1).argsort(-1)
            ends = torch.ones(hb, 1, dtype=torch.bool)
            kmask = torch.cat([ends, rank < (counts[:, None] - 2), ends], 1).to(dev)
            dest = compact_dest(kmask)
            got = kl.fused_vit_layer_bucketed(x, lp, dest, kmask, cap, nh, gcfg.layernorm_eps)
            ref = kl.fused_vit_layer_bucketed_ref(x, lp, dest, kmask, cap, nh,
                                                  gcfg.layernorm_eps)
            torch.cuda.synchronize()
            d, tol = (got.float() - ref.float()).abs()[kmask].max().item(), ftol(ref.float())
            moved = bool((got[:, -1] != x[:, -1]).any(-1).all())
            skipped_exact = bool(torch.equal(got[~kmask], x[~kmask]))
            if dt == torch.float32:
                err["b3"] = max(err["b3"], d)
            tag = f"B3 {gname} {dname} B={hb} S={s} cap={cap} (last token kept)"
            log(f"  {tag}: kept rows max_abs_err {d:.3e} (tol {tol:.1e}); the last token went "
                f"through the layer: {moved}; skipped rows bit-identical to x: {skipped_exact}")
            check(bool(torch.isfinite(got).all()) and d <= tol and moved and skipped_exact, tag)
            q, k, v = (torch.randn(hb, nh, s, gcfg.head_dim, generator=gen).to(dev, dt)
                       for _ in range(3))
            for mask in (None, m.to(dev)):
                ka.reset_body_counts()
                got = ka.fused_attention(q, k, v, mask)
                torch.cuda.synchronize()
                n = ka.body_counts()
                body = "wgmma" if n["wgmma"] else "split"
                ref = ka.fused_attention_ref(q, k, v, mask)
                torch.cuda.synchronize()
                d = valid_rows(got.transpose(1, 2), ref.transpose(1, 2), mask)
                tol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
                if dt == torch.float32:
                    err["b6"] = max(err["b6"], d)
                tag = f"B6 {gname} {dname} B={hb} S={s} {'mask' if mask is not None else 'nomask'}"
                log(f"  {tag}: {body} body, max_abs_err {d:.3e} (tol {tol:.1e})")
                check(bool(torch.isfinite(got).all()) and d <= tol
                      and body == ka.body(q, k, v), tag)
    check.done()


# phase 3m: the sequence lengths around every edge of B1-B5's bf16 attention body:
# 64-key chunks, 64-query tiles, the resident body's 256 keys, the old 288 limit
EDGE_LENGTHS = (63, 64, 65, 128, 129, 197, 256, 257, 288, 289)


def edge_geometries() -> tuple:
    """Phase 3m's geometries, one at each head dim the layer kernels take:
    vit_tiny 16, the gate model 32, DeiT-S 64, ViT-H 80 at full width."""
    from vit_pruning_tpu_torch.configs import ViTConfig, deit_small, vit_huge, vit_tiny

    return (("vit_tiny (hd 16)", vit_tiny(num_labels=100)),
            ("gate (hd 32)", ViTConfig(image_size=32, patch_size=4, hidden_size=128, num_layers=3,
                                       num_heads=4, mlp_dim=256, num_labels=100)),
            ("deit_s (hd 64)", deit_small(num_labels=100)),
            ("vit_h (hd 80)", vit_huge(num_labels=100)))


def attention_edges(dev):
    """Phase 3m: B1-B5's attention body (csrc/layer_attention.cu) at the
    edges of its chunks, tiles and residency (EDGE_LENGTHS), at every head
    dim the layer kernels take (vit_tiny 16, the gate model 32, DeiT-S 64,
    ViT-H 80 at full width): B1 (staged2), B5 on one layer (normalised) and
    B4, unmasked and masked (one whole 64-key chunk blanked, one image's
    keys all masked), and B3 at a capacity of each length with per-image
    counts (1, the capacity, two random); bfloat16 and float32 at batch 4
    (B4 in float32 at S 65 and 257).
    Every row is compared, masked ones included, with phases
    3 / 3f / 4b / 3c's tolerances (two bf16 steps; B4 one int8 step more),
    and each call's attention must have run the body attention_body names,
    once a layer, by the C counters and by the wrappers' tally. First the
    mirror itself: attention_body equal to the C rule for f32, bf16 and
    f16, head dims 8-128 and S 0-785. Last the cases of
    attention_isolated, which see the attention at its own magnitude (in
    f32 against a float64 context)."""
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_slice
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.cuda import layer_int8 as k8
    from vit_pruning_tpu_torch.ops.cuda import model as kmod
    from vit_pruning_tpu_torch.ops.cuda.build import load_library
    from vit_pruning_tpu_torch.ops.masking import compact_dest
    from vit_pruning_tpu_torch.ops.quant import quantize_layer_params

    check = Checks("phase 3m (the attention body's edges in B1, B3, B4, B5 vs plain)")
    c_rule = load_library().vpt_layer_attention_body
    names = {**dict(enumerate(kl.ATTENTION_BODIES)), -1: None}
    apart = [(dt, hd, s) for code, dt in enumerate((torch.float32, torch.bfloat16, torch.float16))
             for hd in (8, 16, 32, 48, 64, 80, 96, 128) for s in range(786)
             if names[c_rule(code, hd, s)] != kl.attention_body(dt, hd, s)]
    log(f"  attention_body against the C rule on {3 * 8 * 786} inputs: {len(apart)} apart")
    check(not apart, f"attention_body differs from the C rule at {apart[:3]}")
    gen = torch.Generator().manual_seed(SEED + 13)
    geos = edge_geometries()
    batch, bodies = 4, {}
    for gname, gcfg in geos:
        nh, hd, eps = gcfg.num_heads, gcfg.head_dim, gcfg.layernorm_eps
        stack_cpu = perturbed_layer(init_vit_params(gcfg.replace(num_layers=1), gen, "cpu")["layers"],
                                    gen)
        for dname, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            st = tree_to(stack_cpu, dev, dt)
            lp = layer_slice(st, 0)
            qp = quantize_layer_params(lp)
            ftol = (lambda ref: F32_ATOL) if dt == torch.float32 else bf16_tol
            for s in EDGE_LENGTHS:
                want = kl.attention_body(dt, hd, s)
                x = torch.randn(batch, s, gcfg.hidden_size, generator=gen).to(dev, dt)
                m = torch.rand(batch, s, generator=gen) > 0.3
                m[:, 0] = True
                m[:, 64:128] = False  # keys 64-127: a whole chunk where S reaches it
                m[1] = False  # every key of image 1
                for mask in (None, m.to(dev)):
                    mtag = "mask" if mask is not None else "nomask"
                    cases = (
                        ("B1", lambda: kl.fused_vit_layer(x, lp, nh, eps, mask),
                         lambda: kl.fused_vit_layer_ref(x, lp, nh, eps, mask), 0.0),
                        ("B4", lambda: k8.fused_vit_layer_int8(x, qp, nh, eps, mask),
                         lambda: k8.fused_vit_layer_int8_ref(x, qp, nh, eps, mask), None),
                        ("B5", lambda: kmod.fused_vit_encoder(x, st, nh, eps, mask),
                         lambda: kmod.fused_vit_encoder_ref(x, st, nh, eps, mask), 0.0),
                    )
                    for key, fn, ref_fn, extra in cases:
                        if key == "B4" and dt == torch.float32 and s not in (65, 257):
                            # B4's whole f32 layer moves by int8 code flips in four stages,
                            # which its one-int8-step tolerance bounds only by chance at ViT-H
                            # width; its attention is held at every length by
                            # attention_isolated, where only ctx's codes can flip
                            continue
                        kl.reset_attention_body_counts()
                        got = fn()
                        torch.cuda.synchronize()
                        ran, tally = kl.attention_body_counts(), dict(kl.attention_launches)
                        ref = ref_fn()
                        torch.cuda.synchronize()
                        d = (got.float() - ref.float()).abs().max().item()
                        tol = ftol(ref.float()) + (int8_step(ref, x) if extra is None else extra)
                        one = {b: int(b == want) for b in kl.ATTENTION_BODIES}
                        bodies[want] = bodies.get(want, 0) + 1
                        tag = f"{key} {gname} {dname} B={batch} S={s} {mtag}"
                        log(f"  {tag}: {want}, max_abs_err {d:.3e} (tol {tol:.2e})")
                        check(bool(torch.isfinite(got).all()) and d <= tol, tag)
                        check(ran == one and tally == {key.lower(): one},
                              f"{tag}: attention bodies {ran}, tally {tally}, want {want}")
                # B3 at a capacity of s: CLS and count - 1 random tokens of s + 7 kept
                counts = torch.randint(1, s + 1, (batch,), generator=gen)
                counts[0], counts[1] = 1, s  # only CLS kept; a full bucket
                rank = torch.rand(batch, s + 6, generator=gen).argsort(-1).argsort(-1)
                kmask = torch.cat([torch.ones(batch, 1, dtype=torch.bool),
                                   rank < (counts[:, None] - 1)], 1).to(dev)
                xb = torch.randn(batch, s + 7, gcfg.hidden_size, generator=gen).to(dev, dt)
                dest = compact_dest(kmask)
                kl.reset_attention_body_counts()
                got = kl.fused_vit_layer_bucketed(xb, lp, dest, kmask, s, nh, eps)
                torch.cuda.synchronize()
                ran, tally = kl.attention_body_counts(), dict(kl.attention_launches)
                ref = kl.fused_vit_layer_bucketed_ref(xb, lp, dest, kmask, s, nh, eps)
                torch.cuda.synchronize()
                d, tol = (got.float() - ref.float()).abs()[kmask].max().item(), ftol(ref.float())
                skipped_exact = bool(torch.equal(got[~kmask], xb[~kmask]))
                one = {b: int(b == want) for b in kl.ATTENTION_BODIES}
                bodies[want] = bodies.get(want, 0) + 1
                tag = f"B3 {gname} {dname} B={batch} S={s + 7} cap={s}"
                log(f"  {tag}: {want}, kept rows max_abs_err {d:.3e} (tol {tol:.1e}); skipped "
                    f"rows bit-identical to x: {skipped_exact}")
                check(bool(torch.isfinite(got).all()) and d <= tol and skipped_exact, tag)
                check(ran == one and tally == {"b3": one},
                      f"{tag}: attention bodies {ran}, tally {tally}, want {want}")
    log(f"  phase 3m calls by attention body: {bodies}")
    check(set(bodies) == set(kl.ATTENTION_BODIES), f"a body never ran: {bodies}")
    for r in attention_isolated(dev, log):
        check(r["d"] <= r["tol"] and r["finite"],
              f"{r['tag']}: err {r['d']:.3e} > tol {r['tol']:.2e} or not finite")
        one = {b: int(b == r["want"]) for b in kl.ATTENTION_BODIES}
        check(r["ran"] == one and r["tally"] == {r["key"].lower(): one},
              f"{r['tag']}: attention bodies {r['ran']}, tally {r['tally']}, want {r['want']}")
    check.done()


# phase 3m's isolated cases: W_q and W_k redrawn at this std times 1/sqrt(D),
# so that q and k have about this std and the logits about its square (~2.6):
# the init's 0.02 leaves them within ~0.15 of each other at DeiT-S, and a
# softmax that flat averages every key almost alike
ISOLATED_QK_STD = 1.6


def identity_tail(stack: dict, gen: torch.Generator) -> dict:
    """A stacked one-layer tree with O = I and no O bias, the MLP's second
    product zero (weights and bias: the MLP adds exactly 0), and W_q, W_k
    redrawn at ISOLATED_QK_STD / sqrt(D). A layer (or the one-layer
    encoder) then returns x + ctx rounded once to its dtype."""
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in stack.items()}
    out["attn"] = {n: dict(p) for n, p in stack["attn"].items()}
    out["mlp"] = {n: dict(p) for n, p in stack["mlp"].items()}
    o = out["attn"]["o"]
    d = o["w"].shape[-1]
    o["w"] = torch.eye(d, dtype=o["w"].dtype, device=o["w"].device).expand_as(o["w"]).clone()
    o["b"] = torch.zeros_like(o["b"])
    out["mlp"]["fc2"] = {n: torch.zeros_like(t) for n, t in stack["mlp"]["fc2"].items()}
    for n in "qk":
        w = out["attn"][n]["w"]
        out["attn"][n]["w"] = (ISOLATED_QK_STD / math.sqrt(d)
                               * torch.randn(w.shape, generator=gen)).to(w.device, w.dtype)
    return out


def attention_isolated(dev, say) -> list:
    """Phase 3m's cases that isolate the attention body through the real
    wrappers: a layer with identity_tail (O = I, the MLP adding 0, q and k
    spread so that the softmax is peaked) on x ~ 1e-5, so that the output
    is x + ctx rounded once and its size is the context's, not the residual
    stream's. B1 and B5 (one layer) against x + staged2_attention (staged2
    and normalised) on the plain version's q, k, v; B3 (per-image counts)
    on its kept rows against the same on the compacted bucket; B4 against
    its plain version (staged2_attention on its int8 q, k, v, the context's
    row quantization, O = I). Every EDGE_LENGTHS length at head dims 16, 32,
    64 and 80, bfloat16 and float32 at batch 4, unmasked and masked (one
    64-key chunk blanked, one image's keys all masked). Tolerance in bf16:
    two bf16 steps of the largest |x + ctx| (B4: one int8 step of the
    context more). In f32 B1, B3 and B5 are held to x + the context in
    float64 (LN, the products and the attention in float64 from the same
    weights and x): their error at most F64_FACTOR times the plain
    version's against it (TF32 off), both printed; B4 to its plain version
    at F32_ATOL and one int8 step. Returns one record per call: tag,
    kernel, the body attention_body names, the bodies the C counters and
    the wrappers' tally saw, err and tol, whether the output is finite.
    Also run by kernel_variants.py's `faults`, on libraries with faults
    planted in the bodies."""
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_slice
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.cuda import layer_int8 as k8
    from vit_pruning_tpu_torch.ops.cuda import model as kmod
    from vit_pruning_tpu_torch.ops.masking import compact_dest
    from vit_pruning_tpu_torch.ops.quant import quantize_layer_params

    gen = torch.Generator().manual_seed(SEED + 17)
    geos = edge_geometries()
    batch, bf, out = 4, torch.bfloat16, []

    def ctx_of(xs, lp, nh, eps, mask, normalized=False):
        h = kl._ln_f32(xs.float(), lp["ln1"], eps)
        q, k, v = (kl._linear_f32(h, lp["attn"][n]["w"], lp["attn"][n]["b"]).to(bf) for n in "qkv")
        return kl.staged2_attention(q, k, v, nh, mask, normalized=normalized).float()

    def ctx64(xs, lp, nh, eps, mask):
        """x + the layer's context in float64 (LN, the products, the softmax),
        keys masked by mask [B, S] (or none); in float64 staged2 and
        normalised are one function"""
        x64 = xs.double()
        mu = x64.mean(-1, keepdim=True)
        var = ((x64 - mu) ** 2).mean(-1, keepdim=True)
        h = (x64 - mu) / torch.sqrt(var + eps) * lp["ln1"]["g"].double() + lp["ln1"]["b"].double()
        b, s, _ = xs.shape
        q, k, v = ((h @ lp["attn"][n]["w"].double() + lp["attn"][n]["b"].double())
                   .reshape(b, s, nh, -1).transpose(1, 2) for n in "qkv")
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        if mask is not None:
            logits = torch.where(mask[:, None, None, :], logits,
                                 torch.tensor(-1e30, dtype=torch.float64, device=xs.device))
        ctx = (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(b, s, -1)
        return x64 + ctx

    def f64_err(got, plain, exact, rows=None):
        """(the kernel's error against float64, its tolerance, the plain
        version's error): at most F64_FACTOR times the plain version's, or
        F64_FACTOR f32 steps of the largest output where that is below one"""
        ek, ep = (got.double() - exact).abs(), (plain.double() - exact).abs()
        if rows is not None:
            ek, ep = ek[rows], ep[rows]
        e_p = float(ep.max())
        return float(ek.max()), F64_FACTOR * max(e_p, F32_ULP * float(exact.abs().max())), e_p

    def record(tag, key, want, run, d_and_tol):
        kl.reset_attention_body_counts()
        got = run()
        torch.cuda.synchronize()
        ran, tally = kl.attention_body_counts(), dict(kl.attention_launches)
        d, tol, *plain = d_and_tol(got)
        also = f", plain version's {plain[0]:.3e}" if plain else ""
        say(f"  isolated {tag}: {want}, max_abs_err {d:.3e} (tol {tol:.2e}{also})")
        out.append({"tag": f"isolated {tag}", "key": key, "want": want, "ran": ran,
                    "tally": tally, "d": d, "tol": tol, "finite": bool(torch.isfinite(got).all())})

    for gname, gcfg in geos:
        nh, hd, eps = gcfg.num_heads, gcfg.head_dim, gcfg.layernorm_eps
        stack = perturbed_layer(init_vit_params(gcfg.replace(num_layers=1), gen, "cpu")["layers"],
                                gen)
        tail = identity_tail(stack, gen)
        for dname, dt in (("bfloat16", bf), ("float32", torch.float32)):
            st = tree_to(tail, dev, dt)
            lp = layer_slice(st, 0)
            qp = quantize_layer_params(lp)
            for s in EDGE_LENGTHS:
                want = kl.attention_body(dt, hd, s)
                x = (1e-5 * torch.randn(batch, s, gcfg.hidden_size, generator=gen)).to(dev, dt)
                m = torch.rand(batch, s, generator=gen) > 0.3
                m[:, 0] = True
                m[:, 64:128] = False
                m[1] = False
                for mask in (None, m.to(dev)):
                    tag = (f"{gname} {dname} B={batch} S={s} "
                           f"{'mask' if mask is not None else 'nomask'}")
                    for key, normalized, run, plain in (
                            ("B1", False, lambda: kl.fused_vit_layer(x, lp, nh, eps, mask),
                             lambda: kl.fused_vit_layer_ref(x, lp, nh, eps, mask)),
                            ("B5", True, lambda: kmod.fused_vit_encoder(x, st, nh, eps, mask),
                             lambda: kmod.fused_vit_encoder_ref(x, st, nh, eps, mask))):
                        if dt == bf:
                            ref = x.float() + ctx_of(x, lp, nh, eps, mask, normalized)
                            d_tol = (lambda got: ((got.float() - ref).abs().max().item(),
                                                  bf16_tol(ref)))
                        else:
                            exact, p_out = ctx64(x, lp, nh, eps, mask), plain()
                            d_tol = (lambda got: f64_err(got, p_out, exact))
                        record(f"{key} {tag}", key, want, run, d_tol)
                    ref8 = k8.fused_vit_layer_int8_ref(x, qp, nh, eps, mask).float()
                    tol8 = (bf16_tol(ref8) if dt == bf
                            else F32_ATOL * max(1.0, float(ref8.abs().max()))) + int8_step(ref8, x)
                    record(f"B4 {tag}", "B4", want,
                           lambda: k8.fused_vit_layer_int8(x, qp, nh, eps, mask),
                           lambda got: ((got.float() - ref8).abs().max().item(), tol8))
                # B3 at a capacity of s with per-image counts, as the cases above
                counts = torch.randint(1, s + 1, (batch,), generator=gen)
                counts[0], counts[1] = 1, s
                rank = torch.rand(batch, s + 6, generator=gen).argsort(-1).argsort(-1)
                kmask = torch.cat([torch.ones(batch, 1, dtype=torch.bool),
                                   rank < (counts[:, None] - 1)], 1).to(dev)
                xb = (1e-5 * torch.randn(batch, s + 7, gcfg.hidden_size, generator=gen)).to(dev, dt)
                dest = compact_dest(kmask)
                xc, key_ok = kl.bucket_compact(xb, dest, kmask, s)
                if dt == bf:
                    refc = xc.float() + ctx_of(xc, lp, nh, eps, key_ok)

                    def b3_err(got):
                        gc, _ = kl.bucket_compact(got, dest, kmask, s)
                        return ((gc.float() - refc).abs()[key_ok].max().item(),
                                bf16_tol(refc[key_ok]))
                else:
                    exact = ctx64(xc, lp, nh, eps, key_ok)
                    p_out, _ = kl.bucket_compact(
                        kl.fused_vit_layer_bucketed_ref(xb, lp, dest, kmask, s, nh, eps), dest,
                        kmask, s)

                    def b3_err(got):
                        gc, _ = kl.bucket_compact(got, dest, kmask, s)
                        return f64_err(gc, p_out, exact, key_ok)

                record(f"B3 {gname} {dname} B={batch} S={s + 7} cap={s}", "B3", want,
                       lambda: kl.fused_vit_layer_bucketed(xb, lp, dest, kmask, s, nh, eps),
                       b3_err)
    return out


# phase 4's isolated cases (cls_attention_isolated): the lengths around every edge of
# B2's bf16 launches (csrc/cls_logits.cu): one token, the 64-row tiles, the 128-row
# passes (V in the accumulators up to 128 tokens, in shared memory past them), the old
# 288 limit, S 577 (DeiT-S at 384: V recomputed at hd 64 and 80)
CLS_EDGE_LENGTHS = (2, 17, 33, 63, 64, 65, 99, 128, 129, 257, 289, 577)


def cls_isolated_geometries() -> tuple:
    """Phase 4's isolated geometries: edge_geometries' four head dims, and the
    widths the wrappers pad, DeiT-S with MLP 1000 and a model of hidden
    width 100 (4 heads of 16, MLP 300; labels 100 = D, no multiple of 8)."""
    from vit_pruning_tpu_torch.configs import ViTConfig, deit_small

    return edge_geometries() + (
        ("deit_s M 1000", deit_small(num_labels=100).replace(mlp_dim=1000)),
        ("D 100 (4 heads of 16)", ViTConfig(hidden_size=100, num_layers=1, num_heads=4,
                                            attn_head_dim=16, mlp_dim=300, num_labels=100)))


def cls_identity_tail(lp: dict, lnf: dict, gen: torch.Generator):
    """B2's weights with the CLS attention isolated: O the identity [KW, D]
    (no bias), fc2 zero (weights and bias: the MLP adds exactly 0), W_q and
    W_k redrawn at ISOLATED_QK_STD / sqrt(D) (a peaked softmax), LN_f (1, 0)
    and the classifier the identity [D, D] (D labels, no bias). The logits
    are then LN_f(x_cls + ctx) rounded once. Returns (layer, ln_f, head)."""
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in lp.items()}
    out["attn"] = {n: dict(p) for n, p in lp["attn"].items()}
    out["mlp"] = {n: dict(p) for n, p in lp["mlp"].items()}
    kw, d = out["attn"]["o"]["w"].shape
    dev, dt = out["attn"]["o"]["w"].device, out["attn"]["o"]["w"].dtype
    out["attn"]["o"] = {"w": torch.eye(kw, d, dtype=dt, device=dev),
                        "b": torch.zeros(d, dtype=dt, device=dev)}
    out["mlp"]["fc2"] = {n: torch.zeros_like(t) for n, t in lp["mlp"]["fc2"].items()}
    for n in "qk":
        w = out["attn"][n]["w"]
        out["attn"][n]["w"] = (ISOLATED_QK_STD / math.sqrt(d)
                               * torch.randn(w.shape, generator=gen)).to(dev, dt)
    f = {"g": torch.ones_like(lnf["g"]), "b": torch.zeros_like(lnf["b"])}
    head = {"w": torch.eye(d, dtype=dt, device=dev), "b": torch.zeros(d, dtype=dt, device=dev)}
    return out, f, head


def cls_context64(x, lp: dict, nh: int, eps: float):
    """B2's CLS context [B, KW] in float64 from the same x and weights: LN1, K
    and V of every token, q of the CLS row, the softmax, P V."""
    x64 = x.double()
    mu = x64.mean(-1, keepdim=True)
    var = ((x64 - mu) ** 2).mean(-1, keepdim=True)
    h = (x64 - mu) / torch.sqrt(var + eps) * lp["ln1"]["g"].double() + lp["ln1"]["b"].double()
    a = lp["attn"]
    b, s, _ = x.shape
    k, v = ((h @ a[n]["w"].double() + a[n]["b"].double()).reshape(b, s, nh, -1).transpose(1, 2)
            for n in "kv")
    q = (h[:, :1] @ a["q"]["w"].double() + a["q"]["b"].double()).reshape(b, 1, nh, -1).transpose(1, 2)
    p = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1]), -1)
    return (p @ v).transpose(1, 2).reshape(b, -1)


def cls_attention_isolated(dev, say, dtype=torch.bfloat16) -> list:
    """Phase 4's cases that isolate B2's CLS attention through the real
    wrapper: cls_identity_tail's weights on x ~ 1e-5, so that the logits are
    LN_f(x_cls + ctx) and a softmax dropped, made uniform, cut short or left
    unnormalised moves them by far more than a rounding. bfloat16: held to
    LN_f(x_cls + the plain version's context rounded to bf16) (ops/cuda/
    layer.py::cls_context_ref) at two bf16 steps of its largest magnitude.
    float32: held to LN_f(x_cls + the context in float64) (cls_context64, LN_f
    in float64): the kernel's error against it (the norm of the difference
    over the reference's) at most F32_SPLIT_ERR times the f32 plain
    version's (TF32 off). Every CLS_EDGE_LENGTHS length at head dims 16, 32,
    64 and 80 and at the padded widths (cls_isolated_geometries), batch 4 and
    a ragged batch of 9 (a cluster of the K/V launch part empty, the q blocks
    part full). Returns one record per call: tag, err and tol (and, f32, the
    max abs errors of both), and B2's launches by kind as the C counters and
    the wrapper's tally saw them and as the mirror (cls_logits_launches) plans
    them. Also run by kernel_variants.py's `faults`, on libraries with faults
    planted in B2 (cls_attention_isolated_f32 for the f32 route)."""
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_norm, layer_slice
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.cuda.widths import LAYER_MULTIPLE, round_up

    gen = torch.Generator().manual_seed(SEED + 19)
    f32, out = dtype == torch.float32, []
    dname = "float32" if f32 else "bfloat16"
    for gname, gcfg in cls_isolated_geometries():
        nh, eps, d = gcfg.num_heads, gcfg.layernorm_eps, gcfg.hidden_size
        p = init_vit_params(gcfg.replace(num_layers=1, attn_head_dim=None), gen, "cpu")
        st = perturbed_layer(p["layers"], gen)
        if gcfg.attn_head_dim:  # the attention narrower than D
            st = narrow_attention(st, nh * gcfg.attn_head_dim)
        lp, f, h = cls_identity_tail(tree_to(layer_slice(st, 0), dev, dtype),
                                     tree_to(p["ln_f"], dev, dtype), gen)
        ones = {"g": torch.ones(d, device=dev), "b": torch.zeros(d, device=dev)}
        for s in CLS_EDGE_LENGTHS:
            for batch in (4, 9):
                x = (1e-5 * torch.randn(batch, s, d, generator=gen)).to(dev, dtype)
                kl.reset_cls_launch_counts()
                got = kl.fused_vit_layer_cls_logits(x, lp, f, h, nh, eps)
                torch.cuda.synchronize()
                ran, tally = kl.cls_launch_counts(), dict(kl.cls_launches)
                tag = f"isolated B2 {gname} {dname} B={batch} S={s}"
                rec = {"tag": tag, "ran": ran, "tally": tally,
                       "plan": kl.cls_logits_launches(dtype, gcfg.head_dim, s,
                                                      round_up(d, LAYER_MULTIPLE))}
                if f32:
                    x1 = x[:, 0].double()
                    ctx = cls_context64(x, lp, nh, eps)
                    x1[:, :ctx.shape[1]] += ctx
                    mu = x1.mean(-1, keepdim=True)
                    exact = (x1 - mu) / torch.sqrt(((x1 - mu) ** 2).mean(-1, keepdim=True) + eps)
                    plain = kl.fused_vit_layer_cls_logits_ref(x, lp, f, h, nh, eps)
                    norm = torch.linalg.vector_norm(exact).item()
                    e64 = torch.linalg.vector_norm(got.double() - exact).item() / norm
                    pe64 = torch.linalg.vector_norm(plain.double() - exact).item() / norm
                    dd = e64 if math.isfinite(e64) else math.inf
                    tol = F32_SPLIT_ERR * max(pe64, F32_ULP)
                    rec.update(d_max=(got.double() - exact).abs().max().item(),
                               plain_max=(plain.double() - exact).abs().max().item())
                    say(f"  {tag}: relative to float64 {dd:.3e} (tol {tol:.2e}; the f32 plain "
                        f"version's {pe64:.3e}), max abs {rec['d_max']:.3e} (plain "
                        f"{rec['plain_max']:.3e}), launches {ran}")
                else:
                    ctx = kl.cls_context_ref(x, lp, nh, eps).to(dtype).float()
                    pad = torch.nn.functional.pad(ctx, (0, d - ctx.shape[1]))
                    ref = layer_norm(x[:, 0].float() + pad, ones, eps)
                    dd = (got.float() - ref).abs().max().item()
                    if not math.isfinite(dd):
                        dd = math.inf
                    tol = bf16_tol(ref)
                    say(f"  {tag}: max_abs_err {dd:.3e} (tol {tol:.2e}), launches {ran}")
                rec.update(d=dd, tol=tol)
                out.append(rec)
    return out


def cls_attention_isolated_f32(dev, say) -> list:
    """cls_attention_isolated on B2's float32 route."""
    return cls_attention_isolated(dev, say, torch.float32)


def f32_product_shapes() -> tuple:
    """Every f32 product shape of B1 / B3 / B5 and B2 on the paths, for phase 3n:
    (tag, M, K, N, act, residual, lda, ldr); lda / ldr None for dense rows. The
    layers' four products (QKV; O + the f32 residual; fc1 + erf GELU; fc2 + the
    residual) at ViT-B/16 batch 16 (the CLI's eval), DeiT-S batch 32 (the train
    steps), the gate model's D 128 at batch 128 (S 65), ViT-H at phase 5e's f32
    batch 4, the padded widths D 100 (104 in the kernel: 4 heads of 16, MLP 300 ->
    304) and M 1000 at batch 8 (1,576 rows, ragged), DeiT-S at S 131 (1,048 rows);
    B2's six at DeiT-S S 99, batch 8 (the CLS rows of x as A and residual, row
    stride S * D; the classifier padded to 104 labels): B2's f32 route runs its
    products in its own launches (csrc/cls_logits.cu), so these six now test
    gemm() alone, at the strided shapes no layer product gives it."""
    out = []
    for tag, m, d, kw, mm in (("vit_b batch 16", 16 * 197, 768, 768, 3072),
                              ("deit_s batch 32", 32 * 197, 384, 384, 1536),
                              ("gate batch 128", 128 * 65, 128, 128, 256),
                              ("vit_h batch 4", 4 * 257, 1280, 1280, 5120),
                              ("D 100 batch 8", 8 * 197, 104, 64, 304)):
        out += [(f"{tag} qkv", m, d, 3 * kw, "none", False, None, None),
                (f"{tag} o", m, kw, d, "none", True, None, None),
                (f"{tag} fc1", m, d, mm, "gelu_erf", False, None, None),
                (f"{tag} fc2", m, mm, d, "none", True, None, None)]
    out += [("M 1000 batch 8 fc1", 8 * 197, 384, 1000, "gelu_erf", False, None, None),
            ("M 1000 batch 8 fc2", 8 * 197, 1000, 384, "none", True, None, None),
            ("deit_s S 131 batch 8 qkv", 8 * 131, 384, 1152, "none", False, None, None),
            ("B2 S 99 kv", 8 * 99, 384, 768, "none", False, None, None),
            ("B2 S 99 q (CLS rows)", 8, 384, 384, "none", False, 99 * 384, None),
            ("B2 S 99 o (CLS residual)", 8, 384, 384, "none", True, None, 99 * 384),
            ("B2 S 99 fc1", 8, 384, 1536, "gelu_erf", False, None, None),
            ("B2 S 99 fc2", 8, 1536, 384, "none", True, None, None),
            ("B2 S 99 classifier", 8, 384, 104, "none", False, None, None)]
    return tuple(out)


def f32_split_products(dev, say) -> list:
    """Phase 3n's cases: every shape of f32_product_shapes through
    ops/cuda/gemm.py::gemm_f32 (the split body the layer kernels run), random
    operands from SEED + 3 (A ~ N(0, 1), W ~ N(0, 1/K), bias and residual),
    held two ways: against the f32 plain version (cuBLAS, TF32 off) at
    F32_ATOL * max(1, max|ref|), as phase 3i holds f32 outputs; and against
    the same product in float64 on the card, where the kernel's relative
    error (the norm of the difference over the norm of the float64 result)
    may be at most F32_SPLIT_ERR times the f32 plain version's own. One
    record a case: tag, d / tol (the first), e64 / pe64 / tol64 (the second)
    and their worse ratio."""
    from vit_pruning_tpu_torch.ops.cuda import gemm as kg

    gen = torch.Generator().manual_seed(SEED + 3)
    out = []
    for tag, m, k, n, act, res, lda, ldr in f32_product_shapes():
        a = torch.randn(m, lda or k, generator=gen).to(dev)[:, :k]
        w = (torch.randn(k, n, generator=gen) / math.sqrt(k)).to(dev)
        b = (0.1 * torch.randn(n, generator=gen)).to(dev)
        r = torch.randn(m, ldr or n, generator=gen).to(dev)[:, :n] if res else None
        got = kg.gemm_f32(a, w, b, act, r)
        ref = kg.gemm_f32_ref(a, w, b, act, r)
        r64 = a.double() @ w.double() + b.double()
        if act != "none":
            r64 = torch.nn.functional.gelu(r64)
        if r is not None:
            r64 = r64 + r.double()
        torch.cuda.synchronize()
        top = ref.abs().max().item()
        d = (got - ref).abs().max().item() if bool(torch.isfinite(got).all()) else math.inf
        tol = F32_ATOL * max(1.0, top)
        norm = torch.linalg.vector_norm(r64).item()
        e64 = torch.linalg.vector_norm(got.double() - r64).item() / norm
        pe64 = torch.linalg.vector_norm(ref.double() - r64).item() / norm
        tol64 = F32_SPLIT_ERR * pe64
        e64 = e64 if math.isfinite(e64) else math.inf
        say(f"  f32 split {tag} M={m} N={n} K={k}: max_abs_err {d:.3e} (tol {tol:.1e}); "
            f"relative to float64 {e64:.3e}, the f32 plain version's {pe64:.3e} (tol {tol64:.2e})")
        out.append({"tag": tag, "d": d, "tol": tol, "e64": e64, "pe64": pe64, "tol64": tol64,
                    "ratio": max(d / tol, e64 / tol64)})
        del a, w, b, r, got, ref, r64
    return out


def serve_at_384(dev, base: dict, cfg):
    """Phase 5g: DeiT-S at 384 (its position table resized by
    interpolate_pos_embed, S 577) end to end: dense vit_forward and the
    headline (288 of 576 patches kept before layer 0) through
    serving_forward, kernels (mode 'auto') against plain PyTorch ('eager'),
    as phase 5 holds them, float32 and bfloat16 at batch 32, with the launch
    counts (B1 x 12; B1 x 11 + B2)."""
    from vit_pruning_tpu_torch.configs import PruneConfig
    from vit_pruning_tpu_torch.models.convert import interpolate_pos_embed, tree_to
    from vit_pruning_tpu_torch.models.vit import vit_forward
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.dispatch import kernel_mode
    from vit_pruning_tpu_torch.serving import serving_forward

    check = Checks("phase 5g (DeiT-S at 384, S 577, end to end)")
    params384, c384 = interpolate_pos_embed(base, cfg, 384)
    check(c384.seq_len == 577, f"DeiT-S at 384 runs S {c384.seq_len}")
    head = PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention", top_k=288)
    u8 = torch.from_numpy(np.random.RandomState(SEED + 384).randint(
        0, 256, (32, 3, 384, 384), dtype=np.uint8)).to(dev)
    L = c384.num_layers
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        params = tree_to(params384, dev, dt)
        pix = ((u8.float() / 255.0 - 0.5) / 0.5).to(dt)
        for name, pcfg, fwd, want in (
                ("dense", None, lambda: {"logits": vit_forward(params["backbone"], pix,
                                                                c384)["logits"]}, (L, 0)),
                ("headline", head, lambda: serving_forward(params, u8, c384, head), (L - 1, 1))):
            n1, n2 = kl.fused_vit_layer.launches, kl.fused_vit_layer_cls_logits.launches
            with kernel_mode("auto"):
                got = fwd()
            torch.cuda.synchronize()
            l1 = kl.fused_vit_layer.launches - n1
            l2 = kl.fused_vit_layer_cls_logits.launches - n2
            with plain_after_the_served_embed():
                ref = fwd()
            torch.cuda.synchronize()
            tag = f"deit_s@384 {name} {dname}"
            check((l1, l2) == want, f"{tag}: launches B1={l1} B2={l2}, want {want}")
            lg, lr = got["logits"].float(), ref["logits"].float()
            check(lg.shape == (32, 100) and bool(torch.isfinite(lg).all()),
                  f"{tag}: logits not finite [32, 100]")
            d = (lg - lr).abs().max().item()
            line = (f"  {tag}: launches B1={l1} B2={l2}; logits max_abs_err {d:.3e} (max|ref| "
                    f"{lr.abs().max().item():.3f}), argmax agree "
                    f"{(lg.argmax(-1) == lr.argmax(-1)).float().mean().item():.3f}")
            if pcfg is not None:  # the only drop comes before any layer kernel runs
                same = bool(torch.equal(got["keep_masks"], ref["keep_masks"]))
                line += f"; keep masks equal {same}"
                check(same, f"{tag}: keep masks differ")
            log(line)
            if dt == torch.float32:
                check(d <= F32_ATOL + 1e-4 * lr.abs().max().item(), f"{tag}: logits differ")
    check.done()


def median_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Median ms of fn() on the card over `iters` calls after `warmup`, each
    call between two CUDA events of its own (the card idle before each)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def narrow_attention(lp: dict, kw: int) -> dict:
    """A layer tree (one layer or stacked) whose q, k, v project to the first
    kw columns and whose o reads them: the geometry of ViTConfig(
    attn_head_dim=...), where the attention width is heads x head dim and
    not the hidden width."""
    a = lp["attn"]
    attn = {n: {"w": a[n]["w"][..., :kw].contiguous(), "b": a[n]["b"][..., :kw].contiguous()}
            for n in "qkv"}
    attn["o"] = {"w": a["o"]["w"][..., :kw, :].contiguous(), "b": a["o"]["b"]}
    return dict(lp, attn=attn)


def widths_path(dev, base: dict, cfg) -> dict:
    """Phase 3l (ROADMAP C.1): widths that are not multiples of the kernels'
    own, zero-padded by the wrappers (ops/cuda/widths.py), held to the plain
    versions on the unpadded weights with the tolerances of phases 3-4b and
    3g. Two geometries, two layers each, float32 and bfloat16, batch 8, S
    197, masked and not: DeiT-S with 1000 of its 1536 MLP channels a layer
    kept (prune_mlp_channels; M 1000 is a multiple of 8 and not of 16, so
    only B4 pads it) and a model of hidden width 100 with 4 heads of 16 and
    MLP 300 (D and M no multiple of 8); B1, B2, B3 (cap 99), B4, B5; then
    B8a / B8b at D 100 (DeiT-S's patches, K 768, batch 64). No ValueError
    for a width; every kernel launched. A generator of its own, so that the
    other phases draw as before. Returns the launches by kernel."""
    from vit_pruning_tpu_torch.configs import ViTConfig
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_range, layer_slice
    from vit_pruning_tpu_torch.ops.cuda import embed as kemb
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.cuda import layer_int8 as k8
    from vit_pruning_tpu_torch.ops.cuda import model as kmod
    from vit_pruning_tpu_torch.ops.masking import compact_dest
    from vit_pruning_tpu_torch.ops.quant import quantize_layer_params
    from vit_pruning_tpu_torch.ops.structured import prune_mlp_channels

    check = Checks("phase 3l (C.1: widths no multiple of 8 or 16 in B1-B5, B8a, B8b)")
    g = torch.Generator().manual_seed(SEED + 11)
    keep = sorted(torch.randperm(cfg.mlp_dim, generator=g)[:1000].tolist())
    m1000 = prune_mlp_channels(base["backbone"], [keep] * cfg.num_layers)
    d_cfg = ViTConfig(hidden_size=100, num_layers=2, num_heads=4, attn_head_dim=16, mlp_dim=300,
                      num_labels=100)
    d100 = init_vit_params(d_cfg.replace(attn_head_dim=None), g, "cpu")
    shapes = {  # name -> (config, two stacked layers, final LN, classifier), on the CPU
        "deit_s M 1000": (cfg, layer_range(m1000["layers"], 0, 2), m1000["ln_f"],
                          m1000["head"]),
        "D 100 M 300 (4 heads of 16)": (d_cfg, narrow_attention(d100["layers"], 64),
                                        d100["ln_f"], d100["head"]),
    }
    reset_launches()
    b, s, cap = 8, cfg.seq_len, 99
    for sname, (gcfg, st_cpu, lnf_cpu, head_cpu) in shapes.items():
        st_cpu, lnf_cpu = perturbed_layer(st_cpu, g), perturbed_layer(lnf_cpu, g)
        head_cpu = perturbed_layer(head_cpu, g)
        dd = gcfg.hidden_size
        for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            st, f, h = (tree_to(t, dev, dt) for t in (st_cpu, lnf_cpu, head_cpu))
            lp = layer_slice(st, 0)
            qp = quantize_layer_params(lp)
            x = torch.randn(b, s, dd, generator=g).to(dev, dt)
            m = torch.rand(b, s, generator=g) > 0.3
            m[:, 0] = True
            m = m.to(dev)
            ftol = F32_ATOL if dt == torch.float32 else None
            cases = []
            for mask in (None, m):
                mt = "mask" if mask is not None else "nomask"
                cases += [
                    (f"B1 {mt}", mask,
                     kl.fused_vit_layer(x, lp, gcfg.num_heads, gcfg.layernorm_eps, mask),
                     kl.fused_vit_layer_ref(x, lp, gcfg.num_heads, gcfg.layernorm_eps, mask), 0),
                    (f"B4 {mt}", mask,
                     k8.fused_vit_layer_int8(x, qp, gcfg.num_heads, gcfg.layernorm_eps, mask),
                     k8.fused_vit_layer_int8_ref(x, qp, gcfg.num_heads, gcfg.layernorm_eps,
                                                 mask), 1),
                    (f"B5 (2 layers) {mt}", mask,
                     kmod.fused_vit_encoder(x, st, gcfg.num_heads, gcfg.layernorm_eps, mask),
                     kmod.fused_vit_encoder_ref(x, st, gcfg.num_heads, gcfg.layernorm_eps, mask),
                     0)]
            cases.append(("B2", None,
                          kl.fused_vit_layer_cls_logits(x, lp, f, h, gcfg.num_heads,
                                                        gcfg.layernorm_eps),
                          kl.fused_vit_layer_cls_logits_ref(x, lp, f, h, gcfg.num_heads,
                                                            gcfg.layernorm_eps), 0))
            counts = torch.randint(1, cap + 1, (b,), generator=g)
            rank = torch.rand(b, s - 1, generator=g).argsort(-1).argsort(-1)
            kept = torch.cat([torch.ones(b, 1, dtype=torch.bool), rank < (counts[:, None] - 1)],
                             1).to(dev)
            dest = compact_dest(kept)
            cases.append(("B3 cap 99", kept,
                          kl.fused_vit_layer_bucketed(x, lp, dest, kept, cap, gcfg.num_heads,
                                                      gcfg.layernorm_eps),
                          kl.fused_vit_layer_bucketed_ref(x, lp, dest, kept, cap,
                                                          gcfg.num_heads, gcfg.layernorm_eps), 0))
            torch.cuda.synchronize()
            for what, rows, got, ref, int8 in cases:
                diff = (got.float() - ref.float()).abs()
                d = (diff if rows is None else diff[rows]).max().item()
                tol = (ftol if ftol is not None else bf16_tol(ref.float()))
                tol += int8_step(ref, x) if int8 else 0.0
                tag = f"{what} {sname} {dname}"
                log(f"  {tag}: shape {tuple(got.shape)}; max_abs_err {d:.3e} (tol {tol:.2e})")
                check(got.shape == ref.shape and bool(torch.isfinite(got).all()) and d <= tol,
                      tag)
    # B8a / B8b at D 100: DeiT-S's patches (K 768), batch 64
    w0 = 0.02 * torch.randn(cfg.patch_dim, 100, generator=g)
    b0 = 0.1 * torch.randn(100, generator=g)
    pos0 = 0.02 * torch.randn(cfg.num_patches, 100, generator=g)
    u8p = torch.randint(0, 256, (64, cfg.num_patches, cfg.patch_dim), generator=g,
                        dtype=torch.uint8).to(dev)
    fp = torch.randn(64, cfg.num_patches, cfg.patch_dim, generator=g).to(dev)
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        w, bb, pos = (t.to(dev, dt) for t in (w0, b0, pos0))
        for key, fn, ref_fn, patches in (
                ("B8a", kemb.fused_patch_embed_u8, kemb.fused_patch_embed_u8_ref, u8p),
                ("B8b", kemb.fused_patch_embed_f, kemb.fused_patch_embed_f_ref, fp.to(dt))):
            got, ref = fn(patches, w, bb, pos), ref_fn(patches, w, bb, pos)
            torch.cuda.synchronize()
            d = (got.float() - ref.float()).abs().max().item()
            top = float(ref.float().abs().max())
            tol = 1e-5 * top + 1e-5 if dt == torch.float32 else bf16_tol(ref.float())
            tag = f"{key} D 100 {dname}"
            log(f"  {tag}: shape {tuple(got.shape)}; max_abs_err {d:.3e} (tol {tol:.1e})")
            check(got.shape == (64, cfg.num_patches, 100) and got.dtype == dt
                  and bool(torch.isfinite(got).all()) and d <= tol, tag)
    # B8a on the image at D 100: DeiT-S's images, batch 64, one register row
    u8i = torch.randint(0, 256, (64, 3, cfg.image_size, cfg.image_size), generator=g,
                        dtype=torch.uint8).to(dev)
    cls0, full0 = torch.randn(100, generator=g), 0.02 * torch.randn(1 + cfg.num_patches, 100,
                                                                     generator=g)
    reg0 = torch.randn(1, 100, generator=g)
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = tuple(t.to(dev, dt) for t in (w0, b0, cls0, full0, reg0)) + (cfg.patch_size,)
        got = kemb.fused_image_embed_u8(u8i, *args)
        ref = kemb.fused_image_embed_u8_ref(u8i, *args)
        torch.cuda.synchronize()
        d = (got.float() - ref.float()).abs().max().item()
        top = float(ref.float().abs().max())
        tol = 1e-5 * top + 1e-5 if dt == torch.float32 else bf16_tol(ref.float())
        tag = f"B8a on the image D 100 {dname}"
        log(f"  {tag}: shape {tuple(got.shape)}; max_abs_err {d:.3e} (tol {tol:.1e})")
        check(got.shape == (64, cfg.seq_len + 1, 100) and got.dtype == dt
              and bool(torch.isfinite(got).all()) and d <= tol, tag)
    launches = read_launches()
    log("  launches: " + ", ".join(f"{k.upper()} {v}" for k, v in launches.items() if v))
    for key in ("b1", "b2", "b3", "b4", "b5", "b8a", "b8b", "b8a_image"):
        check(launches[key] > 0, f"{key.upper()} never launched in phase 3l")
    check.done()
    return launches


# a fresh process that imports the port alone, loads an exported program and runs it:
# argv = program, inputs (torch.save of params and pixels), where to write the logits
FRESH_LOAD = """
import json, sys
import torch
from vit_pruning_tpu_torch.serving import load_exported
from vit_pruning_tpu_torch.ops.cuda import layer as kl
f = load_exported(sys.argv[1])
inputs = torch.load(sys.argv[2], map_location="cuda")
logits = f(inputs["params"], inputs["u8"])
torch.save(logits.cpu(), sys.argv[3])
print(json.dumps({"b1": kl.fused_vit_layer.launches, "b2": kl.fused_vit_layer_cls_logits.launches,
                  "foreign": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "vit_pruning_tpu"))}))
"""


def export_path(dev, base: dict, cfg, smi: str) -> dict:
    """Phase 5i: the serving export (serving.py::export_serving /
    load_exported) at DeiT-S @224, the headline (98 patches kept before layer
    0, cls_mlp), random weights from SEED: bf16 at batch 512, float32 at
    batch 64, int8 (bf16 weights) at batch 64. The program holds the kernels
    as vpt:: operators (B1 x 11 and B2 x 1 in float, B4 x 11 and B2 x 1
    under int8); the loaded program's logits equal the direct kernel-path
    serving_forward's bit for bit, and its launches the direct call's; the
    float32 program also loads and runs in a fresh process that imports the
    port alone. ms/batch of the loaded program and the direct forward
    (median of 10 CUDA-event timings after 3 warm-up calls), info. Returns
    the launches of each loaded program's call, and the times."""
    import os
    from collections import Counter
    from pathlib import Path

    from vit_pruning_tpu_torch.configs import PruneConfig
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.ops.dispatch import kernel_mode
    from vit_pruning_tpu_torch.serving import export_serving, load_exported, serving_forward

    check = Checks("phase 5i (the serving export: DeiT-S headline)")
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention", top_k=98)
    L = cfg.num_layers
    want = {"none": {"vpt.fused_image_embed_u8.default": 1, "vpt.fused_vit_layer.default": L - 1,
                     "vpt.fused_vit_layer_cls_logits.default": 1},
            "int8": {"vpt.fused_image_embed_u8.default": 1,
                     "vpt.fused_vit_layer_int8.default": L - 1,
                     "vpt.fused_vit_layer_cls_logits.default": 1}}
    rs = np.random.RandomState(SEED + 5)
    tmp = tempfile.mkdtemp(prefix="vpt_export_")
    launches, times = {}, {}
    for tag, dt, batch, quant in (("bfloat16", torch.bfloat16, 512, "none"),
                                  ("float32", torch.float32, 64, "none"),
                                  ("int8", torch.bfloat16, 64, "int8")):
        params = tree_to(base, dev, dt)
        u8 = torch.from_numpy(rs.randint(0, 256, (batch, 3, 224, 224), dtype=np.uint8)).to(dev)
        path = os.path.join(tmp, f"serving_{tag}.pt2")
        with kernel_mode("auto"):
            t0 = time.perf_counter()
            program = export_serving(params, cfg, pcfg, batch, path=path, quant=quant)
            t_export = time.perf_counter() - t0
            ops = dict(Counter(str(n.target) for n in program.graph.nodes
                               if n.op == "call_function" and str(n.target).startswith("vpt.")))
            check(ops == want[quant], f"{tag}: the program's kernel operators {ops}, want "
                                      f"{want[quant]}")
            served = load_exported(path)

            def direct():
                return serving_forward(params, u8, cfg, pcfg, quant=quant)["logits"]

            reset_launches()
            ref = direct()
            torch.cuda.synchronize()
            n_direct = read_launches()
            reset_launches()
            got = served(params, u8)
            torch.cuda.synchronize()
            n_loaded = read_launches()
            same = bool(torch.equal(got, ref))
            check(same and got.shape == (batch, 100) and bool(torch.isfinite(got).all()),
                  f"{tag}: the loaded program's logits differ from the direct forward's")
            check(n_loaded == n_direct, f"{tag}: launches {n_loaded} loaded, {n_direct} direct")
            layer_key = "b4" if quant == "int8" else "b1"
            check(n_loaded[layer_key] == L - 1 and n_loaded["b2"] == 1,
                  f"{tag}: {layer_key.upper()} {n_loaded[layer_key]}, B2 {n_loaded['b2']}")
            try:
                served(params, u8[: batch // 2])
                check(False, f"{tag}: the program took a batch of {batch // 2}")
            except Exception as e:  # the program's input checks
                log(f"  {tag}: a batch of {batch // 2} refused ({type(e).__name__})")
            ms_loaded, ms_direct = median_ms(lambda: served(params, u8)), median_ms(direct)
        launches[tag] = n_loaded
        times[tag] = (ms_loaded, ms_direct)
        log(f"  {tag} batch {batch}: exported in {t_export:.1f} s, {os.path.getsize(path)} bytes; "
            f"operators {ops}; logits bit-equal {same}; launches loaded "
            + ", ".join(f"{k.upper()} {v}" for k, v in n_loaded.items() if v)
            + f" (direct the same: {n_loaded == n_direct}); ms/batch loaded {ms_loaded:.3f}, "
            f"direct {ms_direct:.3f} ({smi})")
        if tag == "float32":  # the same program in a fresh process
            inputs, out = os.path.join(tmp, "inputs.pt"), os.path.join(tmp, "logits.pt")
            torch.save({"params": params, "u8": u8}, inputs)
            root = str(Path(__file__).resolve().parent)
            proc = subprocess.run([sys.executable, "-c", FRESH_LOAD, path, inputs, out],
                                  capture_output=True, text=True, timeout=600, cwd=root,
                                  env={**os.environ, "PYTHONPATH": root})
            if proc.returncode != 0:
                check(False, f"fresh process failed: {proc.stderr[-2000:]}")
            else:
                rec = json.loads(proc.stdout.strip().splitlines()[-1])
                fresh_same = bool(torch.equal(torch.load(out), ref.cpu()))
                log(f"  float32 in a fresh process: logits bit-equal {fresh_same}; launches B1 "
                    f"{rec['b1']}, B2 {rec['b2']}; jax or the JAX package loaded: "
                    f"{rec['foreign'] or 'no'}")
                check(fresh_same and rec["b1"] == L - 1 and rec["b2"] == 1
                      and not rec["foreign"], "the fresh process's run")
    check.done()
    return {"launches": launches, "times": times}


def fresh_copy(tree: dict, dev) -> dict:
    """A copy of a tree on `dev` (a train step updates it in place)."""
    return {k: fresh_copy(v, dev) if isinstance(v, dict) else None if v is None
            else v.detach().to(dev, copy=True) for k, v in tree.items()}


def train_path(dev, base: dict, cfg) -> dict:
    """Phase 5h: training at DeiT-S's full width (12 layers, batch 32,
    cls_mlp predictor, float32), the kernel path (mode 'auto': B1 and B5
    under their autograd Functions) against the eager path:
      - one B1 layer and one two-layer B5 call, each backward against the
        eager layer's (loop's) for the same upstream gradient;
      - three steps of each phase (cosine, then classification) in modes
        mask and topk: the losses within 1e-4 relative, the first step's
        keep masks equal; a classification step of mode 'none' under
        encoder fusion (B5);
      - remat=True gives remat=False's loss; bf16 compute gives finite
        losses; ms/step of both phases, kernel path and eager path (host
        clock, the mean of 5 steps after the compared ones).
    Every launch count is set to 0 just before the train steps run and read
    just after; returns {'b1': ..., 'b5': ...} and the times."""
    from vit_pruning_tpu_torch.configs import PruneConfig
    from vit_pruning_tpu_torch.models.convert import flatten_tree
    from vit_pruning_tpu_torch.models.pruned_vit import pruned_vit_forward
    from vit_pruning_tpu_torch.models.vit import layer_range, layer_slice
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.cuda import model as kmod
    from vit_pruning_tpu_torch.ops.dispatch import encoder_fusion, kernel_mode
    from vit_pruning_tpu_torch.train.freeze import masked_adam
    from vit_pruning_tpu_torch.train.harness import make_train_step, total_loss_fn

    check = Checks("phase 5h (training at DeiT-S width)")

    def fresh(tree):
        return fresh_copy(tree, dev)

    gen = torch.Generator().manual_seed(SEED + 5)
    rs = np.random.RandomState(SEED + 5)
    B, L, nh, eps = 32, cfg.num_layers, cfg.num_heads, cfg.layernorm_eps
    pix = ((torch.from_numpy(rs.randint(0, 256, (B, 3, 224, 224))).float() / 255.0 - 0.5)
           / 0.5).to(dev)
    batch = {"pixel_values": pix, "labels": torch.from_numpy(rs.randint(0, 100, B)).to(dev)}

    # backward of B1 (one layer) and B5 (two layers) against the eager layers', for the same
    # upstream gradient
    x = torch.randn(B, 197, cfg.hidden_size, generator=gen)
    m = torch.rand(B, 197, generator=gen) > 0.3
    m[:, 0] = True
    g = torch.randn(B, 197, cfg.hidden_size, generator=gen).to(dev)
    trees = {"B1": perturbed_layer(layer_slice(base["backbone"]["layers"], 0), gen),
             "B5": perturbed_layer(layer_range(base["backbone"]["layers"], 0, 2), gen)}
    for key, kern, eager in (("B1", kl.fused_vit_layer, kl.eager_layer),
                             ("B5", kmod.fused_vit_encoder, kmod.eager_encoder)):
        grads, n = [], []
        for fn in (kern, eager):
            xt = x.to(dev).requires_grad_(True)
            p = fresh(trees[key])
            leaves = [t.requires_grad_(True) for _, t in flatten_tree(p)]
            n0 = kl.fused_vit_layer.launches + kmod.fused_vit_encoder.launches
            y = fn(xt, p, nh, eps, m.to(dev))
            n.append(kl.fused_vit_layer.launches + kmod.fused_vit_encoder.launches - n0)
            grads.append(torch.autograd.grad(y, [xt] + leaves, g))
        torch.cuda.synchronize()
        diff = max((a - b).abs().max().item() for a, b in zip(*grads))
        top = max(b.abs().max().item() for b in grads[1])
        log(f"  {key} backward (f32, B={B}, S 197, masked) against the eager "
            f"{'layer' if key == 'B1' else 'two-layer loop'}'s, one upstream gradient: largest "
            f"difference {diff:.3e} over {len(grads[0])} tensors (max|grad| {top:.3e}); "
            f"kernel launches {n[0]} (eager {n[1]})")
        check(n == [1, 0] and all(bool(torch.isfinite(a).all()) for a in grads[0])
              and diff <= 1e-6 * top, f"{key} backward differs from the eager one's")

    # the train steps: DeiT-S with its cls_mlp predictor (PREDICTOR_GAIN), f32 master params.
    # The decisions are made far from their cuts in the eager path's own first forward, so
    # that numerics a rounding apart cannot flip them: mask mode's threshold of layer i
    # is the middle of the widest gap among the middle fifth of layer i's scores (given
    # the thresholds before it); topk's k (90..106) is the one whose smallest gap
    # between the k-th and (k+1)-th score, over images and layers, is widest.
    tpl = fresh(base)

    def train_scores(pcfg):
        with torch.no_grad(), kernel_mode("eager"):
            return pruned_vit_forward(tpl, pix, cfg, pcfg, train=True,
                                      oracle=False)["scores"].float()

    thresholds = [0.5] * L
    for i in range(L):
        mcfg = PruneConfig(mode="mask", predictor="cls_mlp", mlp_threshold=tuple(thresholds))
        srt = train_scores(mcfg)[i].flatten().sort().values
        band = srt[int(0.4 * srt.numel()):int(0.6 * srt.numel())]
        j = int((band[1:] - band[:-1]).argmax())
        thresholds[i] = float((band[j] + band[j + 1]) / 2)
    mcfg = PruneConfig(mode="mask", predictor="cls_mlp", mlp_threshold=tuple(thresholds))
    margin = min((sc - t).abs().min().item() for sc, t in zip(train_scores(mcfg), thresholds))
    gaps = {}
    for k in range(90, 107):
        top = train_scores(PruneConfig(mode="topk", predictor="cls_mlp", top_k=k)).topk(
            k + 1, dim=-1).values
        gaps[k] = (top[..., k - 1] - top[..., k]).min().item()
    top_k = max(gaps, key=gaps.get)
    modes = {"mask": PruneConfig(mode="mask", predictor="cls_mlp", loss="mse_cosine",
                                 mlp_threshold=tuple(thresholds)),
             "topk": PruneConfig(mode="topk", predictor="cls_mlp", loss="mse_cosine",
                                 top_k=top_k)}
    log(f"  mask: smallest |score - threshold| {margin:.2e}; topk: k {top_k}, smallest "
        f"k-th / (k+1)-th gap {gaps[top_k]:.2e}")
    phases = (("cosine", "mlp_train", 1e-3), ("classification", "vit_train", 1e-5))

    def run(pcfg, kmode, compute_dtype=None, steps=3, fusion=False, phase_list=phases, timed=5):
        """(losses per step, first keep masks, B1 / B5 launches in the steps, ms/step per
        phase: host clock over `timed` more steps, after the compared ones)"""
        p = fresh(base)
        losses, n, ms = [], {"b1": 0, "b5": 0}, {}
        with kernel_mode(kmode), encoder_fusion(fusion):
            with torch.no_grad():
                masks = pruned_vit_forward(p, pix, cfg, pcfg, train=True,
                                           oracle=False)["keep_masks"]
            for phase, policy, lr in phase_list:
                step = make_train_step(cfg, pcfg, phase, masked_adam(p, policy, lr),
                                       compute_dtype=compute_dtype)
                for s in range(steps):
                    kl.fused_vit_layer.launches = kmod.fused_vit_encoder.launches = 0
                    metrics = step(p, batch, torch.Generator(device=dev).manual_seed(s))
                    n["b1"] += kl.fused_vit_layer.launches
                    n["b5"] += kmod.fused_vit_encoder.launches
                    losses.append(float(metrics["loss"]))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for s in range(timed):
                    step(p, batch, torch.Generator(device=dev).manual_seed(steps + s))
                torch.cuda.synchronize()
                ms[phase] = (time.perf_counter() - t0) * 1e3 / timed
        return losses, masks, n, ms

    launches, times = {"b1": 0, "b5": 0}, {}
    for mname, pcfg in modes.items():
        kl_, km, kn, kms = run(pcfg, "auto")
        el, em, en, ems = run(pcfg, "eager")
        rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(kl_, el))
        same = bool(torch.equal(km, em))
        launches["b1"] += kn["b1"]
        log(f"  {mname}: losses (cosine x 3, classification x 3) kernel path "
            f"{[f'{v:.6f}' for v in kl_]}, eager {[f'{v:.6f}' for v in el]}; largest relative "
            f"difference {rel:.2e}; first keep masks equal {same}; B1 launches in the steps "
            f"{kn['b1']} (eager {en['b1']}); ms/step kernel / eager: cosine "
            f"{kms['cosine']:.2f} / {ems['cosine']:.2f}, classification "
            f"{kms['classification']:.2f} / {ems['classification']:.2f}")
        check(rel <= 1e-4 and all(math.isfinite(v) for v in kl_), f"{mname}: losses differ")
        check(same, f"{mname}: first keep masks differ")
        check(kn["b1"] > 0 and en["b1"] == 0, f"{mname}: B1 launches {kn['b1']} / {en['b1']}")
        times[mname] = (kms, ems)
    dense = PruneConfig(mode="none", predictor="none")
    cls_only = (phases[1],)
    kl_, _, kn, kms = run(dense, "auto", steps=2, fusion=True, phase_list=cls_only)
    el, _, en, ems = run(dense, "eager", steps=2, fusion=True, phase_list=cls_only)
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(kl_, el))
    launches["b5"] += kn["b5"]
    log(f"  none under encoder fusion: classification losses kernel {kl_}, eager {el}, largest "
        f"relative difference {rel:.2e}; B5 launches in the steps {kn['b5']} (B1 {kn['b1']}); "
        f"ms/step kernel / eager {kms['classification']:.2f} / {ems['classification']:.2f}")
    check(rel <= 1e-4 and kn["b5"] > 0 and kn["b1"] == 0, "none under encoder fusion")

    p = fresh(base)
    for _, t in flatten_tree(p):
        t.requires_grad_(True)
    res = []
    for remat in (False, True):
        kl.fused_vit_layer.launches = 0
        loss, _ = total_loss_fn(p, batch, cfg, modes["mask"], "both",
                                torch.Generator(device=dev).manual_seed(0), remat=remat)
        loss.backward()
        res.append((float(loss.detach()), kl.fused_vit_layer.launches,
                    float(p["backbone"]["layers"]["attn"]["q"]["w"].grad.norm())))
        for _, t in flatten_tree(p):
            t.grad = None
    log(f"  remat: loss {res[0][0]:.7f} without, {res[1][0]:.7f} with; B1 launches {res[0][1]} / "
        f"{res[1][1]} (the recompute launches again); |grad q.w| {res[0][2]:.6e} / {res[1][2]:.6e}")
    check(res[0][0] == res[1][0] and res[1][1] > res[0][1]
          and abs(res[0][2] - res[1][2]) <= 1e-5 * res[0][2], "remat changes the loss")

    bl, _, bn, bms = run(modes["topk"], "auto", compute_dtype=torch.bfloat16, steps=2)
    log(f"  bf16 compute, topk: losses {bl}; B1 launches {bn['b1']}; ms/step cosine "
        f"{bms['cosine']:.2f}, classification {bms['classification']:.2f}")
    check(all(math.isfinite(v) for v in bl) and bn["b1"] > 0, "bf16 training losses not finite")
    times["topk_bf16"] = bms
    check.done()
    return {"launches": launches, "times": times}


def graph_nodes(root, name: str) -> int:
    """The nodes called `name` in the autograd graph behind `root`."""
    seen, stack, n = set(), [root], 0
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        n += f.name() == name
        stack.extend(g for g, _ in f.next_functions)
    return n


def module_path(dev, base: dict, cfg, smi: str, batch: int = 512,
                train_batch: int = 32) -> dict:
    """Phase 11: models/torch_module.py::PrunedViT at DeiT-S's full width (the
    cls_mlp predictor, PREDICTOR_GAIN), kernel mode 'auto':
      - serving under torch.inference_mode() at batch `batch` in bf16: the
        headline (topk_prog, k 98: B1), the headline under encoder fusion
        (B5), mode topk (k 98: B3 at cap 99), and the headline and topk under
        quant_mode('int8') (B4); each against the functional forward on
        param_tree(): logits and keep masks bit-equal, every kernel's
        launches equal; ms/batch of both (CUDA events, mean of 10 after 3
        warm-up, run functional, module, module, functional);
      - one f32 train=True step at `train_batch` in mode mask (cross-entropy
        plus the predictor losses, policy vit_mlp_train), masked_adam over
        param_tree() (the optimizer holds module.parameters()), against
        harness.make_train_step on a copy of the tree: the loss within 1e-4
        relative, every Parameter given a gradient, B1 launched and the
        graph holding one RecomputedBackward a layer;
      - a grad-enabled inference call in mode topk raises B3's refusal.
    Every launch count is set to 0 just before each module call and read
    just after; returns {'launches': {run: {key: n}}, 'times': ...}."""
    from vit_pruning_tpu_torch.configs import PruneConfig
    from vit_pruning_tpu_torch.models.convert import flatten_tree, tree_to
    from vit_pruning_tpu_torch.models.pruned_vit import (
        progressive_topk_forward, pruned_vit_forward)
    from vit_pruning_tpu_torch.models.torch_module import PrunedViT
    from vit_pruning_tpu_torch.ops.dispatch import encoder_fusion, kernel_mode, quant_mode
    from vit_pruning_tpu_torch.train.freeze import masked_adam
    from vit_pruning_tpu_torch.train.harness import COSINE_LOSS_RATIO, make_train_step
    from vit_pruning_tpu_torch.train.losses import cross_entropy

    check = Checks("phase 11 (the nn.Module adapter, DeiT-S)")
    rs = np.random.RandomState(SEED + 11)
    u8 = torch.from_numpy(rs.randint(0, 256, (batch, 3, 224, 224), dtype=np.uint8)).to(dev)
    pix = ((u8.float() / 255.0 - 0.5) / 0.5).to(torch.bfloat16)
    bf = tree_to(base, dev, torch.bfloat16)  # one tree on the card; the modules hold it
    headline = PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention", top_k=98)
    topk = PruneConfig(mode="topk", predictor="cls_mlp", top_k=98)
    runs = (  # name, prune config, quant, encoder fusion, the kernel each layer runs
        ("topk_prog_bf16", headline, "none", False, "b1"),
        ("topk_prog_fused_bf16", headline, "none", True, "b5"),
        ("topk_bf16", topk, "none", False, "b3"),
        ("topk_prog_int8", headline, "int8", False, "b4"),
        ("topk_int8", topk, "int8", False, "b4"),
    )
    launches, times = {}, {}
    log(f"phase 11: DeiT-S, bf16, batch {batch}, under torch.inference_mode(); {smi}")
    for name, pcfg, quant, fused, need in runs:
        module = PrunedViT(cfg, pcfg, params=bf, device=dev, dtype=torch.bfloat16)
        with torch.inference_mode(), kernel_mode("auto"), quant_mode(quant), \
                encoder_fusion(fused):
            reset_launches()
            got = module(pix)
            torch.cuda.synchronize()
            launches[name] = read_launches()

            def functional(pcfg=pcfg, module=module):
                tree = module.param_tree()
                if pcfg.mode == "topk_prog":
                    return progressive_topk_forward(tree, pix, cfg, pcfg)
                return pruned_vit_forward(tree, pix, cfg, pcfg)

            reset_launches()
            want = functional()
            torch.cuda.synchronize()
            n_fun = read_launches()
            ms = {"functional": [], "module": []}
            for who in ("functional", "module", "module", "functional"):
                ms[who].append(event_ms(functional if who == "functional"
                                        else lambda module=module: module(pix)))
        times[name] = ms
        lg = got["logits"]
        same = (bool(torch.equal(lg, want["logits"]))
                and bool(torch.equal(got["keep_masks"], want["keep_masks"])))
        log(f"  {name}: module launches {launches[name]}, functional {n_fun}; logits and keep "
            f"masks bit-equal {same}; patches kept "
            f"{got['keep_masks'][:, :, 1:].float().mean().item():.4f}; ms/batch module "
            f"{[round(v, 4) for v in ms['module']]}, functional "
            f"{[round(v, 4) for v in ms['functional']]}")
        check(tuple(lg.shape) == (batch, 100) and bool(torch.isfinite(lg.float()).all()),
              f"{name}: logits not finite [{batch}, 100]")
        check(same, f"{name}: logits or keep masks differ from the functional forward's")
        check(launches[name] == n_fun, f"{name}: launches {launches[name]} against {n_fun}")
        check(launches[name][need] > 0, f"{name}: {need.upper()} never launched")

    # one f32 train step through the module's Parameters against the functional step
    gen_rs = np.random.RandomState(SEED + 12)
    tpix = ((torch.from_numpy(gen_rs.randint(0, 256, (train_batch, 3, 224, 224))).float()
             / 255.0 - 0.5) / 0.5).to(dev)
    labels = torch.from_numpy(gen_rs.randint(0, 100, train_batch)).to(dev)
    mcfg = PruneConfig(mode="mask", predictor="cls_mlp")
    module = PrunedViT(cfg, mcfg, params=fresh_copy(base, dev), device=dev)
    with kernel_mode("auto"):
        opt = masked_adam(module.param_tree(), "vit_mlp_train", 1e-4)
        held = {id(p) for g in opt.param_groups for p in g["params"]}
        own = {id(p) for p in module.parameters()}
        opt.zero_grad(set_to_none=True)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = module(tpix, train=True)
        loss = (cross_entropy(out["logits"], labels)
                + COSINE_LOSS_RATIO * out["aux"]["pred_loss"].sum())
        recomputed = graph_nodes(loss.grad_fn, "RecomputedBackwardBackward")
        loss.backward()
        graded = sum(p.grad is not None for p in module.parameters())
        opt.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launches["train_f32"] = read_launches()
        ftree = fresh_copy(base, dev)
        step = make_train_step(cfg, mcfg, "both", masked_adam(ftree, "vit_mlp_train", 1e-4))
        metrics = step(ftree, {"pixel_values": tpix, "labels": labels})
        torch.cuda.synchronize()
    ml, fl = float(loss.detach()), float(metrics["loss"])
    rel = abs(ml - fl) / max(abs(fl), 1e-30)
    pdiff = max((a.detach() - b.detach()).abs().max().item() for (_, a), (_, b) in
                zip(flatten_tree(module.param_tree()), flatten_tree(ftree)))
    L = cfg.num_layers
    log(f"  train_f32 (mode mask, batch {train_batch}, 'both', masked_adam over param_tree()): "
        f"loss module {ml:.7f}, functional step {fl:.7f}, relative difference {rel:.2e}; "
        f"params after the step largest difference {pdiff:.3e}; Parameters with a gradient "
        f"{graded} of {len(own)}; RecomputedBackward nodes {recomputed} (layers {L}); "
        f"launches {launches['train_f32']}; step {step_ms:.1f} ms (host clock, the first)")
    check(held == own, "the optimizer does not hold module.parameters()")
    check(math.isfinite(ml) and rel <= 1e-4, f"train: loss {ml} against {fl}")
    check(graded == len(own), f"train: {len(own) - graded} Parameters got no gradient")
    check(launches["train_f32"]["b1"] > 0 and recomputed == L,
          f"train: B1 launches {launches['train_f32']['b1']}, RecomputedBackward nodes "
          f"{recomputed}")
    times["train_f32_step_ms"] = step_ms

    # a grad-enabled inference call through B3 raises its refusal
    module = PrunedViT(cfg, topk, params=bf, device=dev, dtype=torch.bfloat16)
    try:
        with kernel_mode("auto"):
            module(pix[:64])
        refusal = "no error"
    except RuntimeError as e:
        refusal = str(e)
    log(f"  topk with grad enabled: {refusal}")
    check("this kernel has no backward" in refusal, "topk with grad enabled did not raise")
    check.done()
    return {"launches": launches, "times": times}


@contextlib.contextmanager
def plain_after_the_served_embed():
    """Mode 'eager' from the served embed on: serving.embed_from_u8 keeps its
    card route (B8a reading the image, as in mode 'auto') and every later
    stage runs its plain version. The phases that hold a served forward to
    the plain path take it as their plain path, so that the drop, the
    layers and the head are compared on one embedding: the kernel rounds
    the embed once where the eager route rounds it three times, which moves
    a top-k cut that is tied in bf16. Phase 5f holds the embed itself to the
    eager route."""
    from vit_pruning_tpu_torch import serving
    from vit_pruning_tpu_torch.ops.dispatch import kernel_mode

    eager_route = serving.embed_from_u8

    def card_route(*args, **kw):
        with kernel_mode("auto"):
            return eager_route(*args, **kw)

    serving.embed_from_u8 = card_route
    try:
        with kernel_mode("eager"):
            yield
    finally:
        serving.embed_from_u8 = eager_route


def kernel_wrappers() -> dict:
    """Every kernel's wrapper by its JSON key; each counts its launches."""
    from vit_pruning_tpu_torch.ops.cuda import attention as ka
    from vit_pruning_tpu_torch.ops.cuda import embed as kemb
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.cuda import layer_int8 as k8
    from vit_pruning_tpu_torch.ops.cuda import mlp as kmlp
    from vit_pruning_tpu_torch.ops.cuda import model as kmod

    return {"b1": kl.fused_vit_layer, "b2": kl.fused_vit_layer_cls_logits,
            "b3": kl.fused_vit_layer_bucketed, "b4": k8.fused_vit_layer_int8,
            "b5": kmod.fused_vit_encoder, "b6": ka.fused_attention, "b7": kmlp.fused_mlp,
            "b8a": kemb.fused_patch_embed_u8, "b8b": kemb.fused_patch_embed_f,
            "b8a_image": kemb.fused_image_embed_u8}


def reset_launches(keys=None):
    """Sets the launch counts of `keys` (default: every kernel) to 0."""
    for k, w in kernel_wrappers().items():
        if keys is None or k in keys:
            w.launches = 0


def read_launches(keys=None) -> dict:
    """The launch counts of `keys` (default: every kernel), by JSON key."""
    return {k: w.launches for k, w in kernel_wrappers().items() if keys is None or k in keys}


class StepRecorder:
    """Wraps train/harness.py's make_train_step and make_eval_step for the
    length of a `with`: records each train step's loss, the kernel launches
    made inside the train steps, each eval step's logits and keep masks, and
    each step's wall time (the card synchronised before and after it)."""

    def __init__(self):
        self.losses, self.train_ms, self.eval_ms = [], [], []
        self.step_launches = dict.fromkeys(kernel_wrappers(), 0)
        self.eval_logits, self.eval_masks = [], []
        self.params = None

    def __enter__(self):
        from vit_pruning_tpu_torch.train import harness

        self.harness = harness
        self.make_train, self.make_eval = harness.make_train_step, harness.make_eval_step

        def timed(step, on_metrics, times):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*a, **kw)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                on_metrics(out)
                return out
            return run

        def make_train(*a, **kw):
            phase = []
            self.losses.append(phase)
            self.train_ms.append([])
            step = timed(self.make_train(*a, **kw), lambda m: phase.append(float(m["loss"])),
                         self.train_ms[-1])

            def counted(params, *rest, **kw2):
                self.params = params  # updated in place by every step
                c0 = read_launches()
                out = step(params, *rest, **kw2)
                for k, n in read_launches().items():
                    self.step_launches[k] += n - c0[k]
                return out
            return counted

        def make_eval(*a, **kw):
            step = self.make_eval(*a, **kw)

            def captured(*ea, **ekw):
                real = harness.pruned_vit_forward

                def forward(*fa, **fkw):
                    out = real(*fa, **fkw)
                    self.eval_logits.append(out["logits"].float().cpu())
                    self.eval_masks.append(out["keep_masks"].cpu())
                    return out

                harness.pruned_vit_forward = forward
                try:
                    return step(*ea, **ekw)
                finally:
                    harness.pruned_vit_forward = real
            return timed(captured, lambda m: None, self.eval_ms)

        harness.make_train_step, harness.make_eval_step = make_train, make_eval
        return self

    def __exit__(self, *exc):
        self.harness.make_train_step = self.make_train
        self.harness.make_eval_step = self.make_eval


def cli_path(dev) -> dict:
    """Phase 8: the user's CLI (python -m vit_pruning_tpu_torch.cli) at the
    reference's own model, ViT-B/16 at 224 (D 768, 12 heads of 64, 12 layers,
    1000 labels), through cli.main on the card (the default device):
      - the native preprocessing library built from the checkout, its fused
        preprocess held against vit_preprocess on the card (the tolerance of
        tests/test_data.py: mean < 0.02, max < 0.5 after normalisation);
      - `train -d ... --model vit_base --dataset synthetic --train_size 64
        --test_size 32 --train_batch_size 16 --num_epochs 1 1 --bf16` (mode
        mask, cls_mlp, the predictor phase then the backbone phase) from a
        random ViT-B given as an HF state dict (--torch_checkpoint) whose
        classifier bias favours the first test image's class, so that the
        first epoch's accuracy beats 0 and the CLI writes its best checkpoint:
        rc 0, finite losses, the checkpoint written, B1 launched inside the
        train steps; the same command under kernel mode 'eager': the first
        step of each phase within 1e-4 relative (as phase 5h holds its
        losses), no kernel launched;
      - `eval` of the CLI's checkpoint through its config sidecar (float32),
        kernel path and eager path: every batch's logits held against the
        eager path's within F32_ATOL + 1e-4 max|logits| on the images whose
        keep masks agree at every layer (a score within float noise of the
        threshold may decide a token the other way; at least half must
        agree), and the same accuracy line; `export` to an HF state dict
        whose tensors equal the checkpoint's.
    The launch counts are set to 0 just before each command and read just
    after. Returns the launches and the times (ms per train step, the
    median of each phase's steps after its first; ms per eval batch)."""
    import contextlib
    import io
    import os
    import tempfile

    from vit_pruning_tpu_torch import cli, native
    from vit_pruning_tpu_torch.checkpoint import restore_checkpoint
    from vit_pruning_tpu_torch.data.datasets import synthetic_dataset
    from vit_pruning_tpu_torch.data.preprocess import vit_preprocess
    from vit_pruning_tpu_torch.models.convert import (
        flatten_tree, params_to_torch_state_dict, torch_state_dict_to_params)
    from vit_pruning_tpu_torch.models.vit import init_vit_params
    from vit_pruning_tpu_torch.ops.cuda import gemm as kg
    from vit_pruning_tpu_torch.ops.dispatch import kernel_mode

    check = Checks("phase 8 (the CLI at ViT-B/16 width)")
    t0 = time.perf_counter()
    built = native.available()
    log(f"  native preprocessing library built from the checkout: {built} "
        f"({time.perf_counter() - t0:.1f} s, in {native.build_dir()})")
    check(built, "the native preprocessing library did not build")
    if built:
        u8 = np.random.RandomState(SEED + 8).randint(0, 256, (8, 32, 32, 3), dtype=np.uint8)
        host = torch.from_numpy(native.preprocess(u8, size=224)).to(dev)
        card = vit_preprocess(torch.from_numpy(u8).to(dev), 224)
        diff = (host - card).abs()
        log(f"  native preprocess (PIL numerics) vs vit_preprocess on the card, 32 -> 224: mean "
            f"|diff| {float(diff.mean()):.4f}, max {float(diff.max()):.4f}")
        check(float(diff.mean()) < 0.02 and float(diff.max()) < 0.5,
              "native preprocess far from vit_preprocess")

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    b_cfg = cli.MODELS["vit_base"]()
    backbone = init_vit_params(b_cfg, torch.Generator().manual_seed(SEED + 9), "cpu")
    label0 = int(synthetic_dataset(n=32, image_size=b_cfg.image_size,
                                   num_labels=b_cfg.num_labels, seed=1)[1][0])
    backbone["head"]["b"][label0] += 8.0
    init_pth = os.path.join(work, "init_vit_b.pth")
    torch.save(params_to_torch_state_dict(backbone, b_cfg), init_pth)
    del backbone
    common = ["--model", "vit_base", "--dataset", "synthetic", "--train_size", "64",
              "--test_size", "32", "--train_batch_size", "16", "--num_epochs", "1", "1",
              "--bf16", "--torch_checkpoint", init_pth, "--quiet",
              "--csv_path", os.path.join(work, "stats.csv"), "--log_dir", os.path.join(work, "logs")]
    runs, launches = {}, {}
    for mode in ("auto", "eager"):
        models = os.path.join(work, f"models_{mode}")
        reset_launches()
        t1 = time.perf_counter()
        with StepRecorder() as rec, kernel_mode(mode):
            rc = cli.main(["train", "-d", f"smoke_{mode}", "--models_dir", models] + common)
        torch.cuda.synchronize()
        launches[f"train_{mode}"] = read_launches()
        launches[f"train_steps_{mode}"] = dict(rec.step_launches)
        side = [f for f in os.listdir(models) if f.endswith(".config.json")]
        ckpt = os.path.join(models, side[0][:-len(".config.json")]) if side else None
        wrote = bool(ckpt) and os.path.exists(ckpt)
        runs[mode] = (rc, rec, ckpt, wrote)
        ms = [statistics.median(p[1:]) for p in rec.train_ms]
        log(f"  train ({mode}): rc {rc} in {time.perf_counter() - t1:.1f} s; best checkpoint "
            f"written by the CLI: {wrote}; losses by phase "
            + "; ".join(", ".join(f"{v:.6f}" for v in p) for p in rec.losses)
            + f"; ms/step by phase (median after the first) {', '.join(f'{m:.2f}' for m in ms)}; "
            f"eval ms/batch (median) {statistics.median(rec.eval_ms):.2f}; launches in the "
            "train steps " + ", ".join(f"{k.upper()} {v}" for k, v in rec.step_launches.items()
                                       if v)
            + "; in the whole command "
            + ", ".join(f"{k.upper()} {v}" for k, v in launches[f'train_{mode}'].items() if v))
    (rc_k, rec_k, ckpt, wrote_k), (rc_e, rec_e, _, wrote_e) = runs["auto"], runs["eager"]
    check(rc_k == 0 and rc_e == 0, f"train rc {rc_k} / {rc_e}")
    check(wrote_k and wrote_e, "the CLI wrote no best checkpoint")
    flat_k = [v for p in rec_k.losses for v in p]
    check(len(flat_k) == 8 and all(math.isfinite(v) for v in flat_k),
          f"train losses not 8 finite values: {flat_k}")
    firsts = [(pk[0], pe[0]) for pk, pe in zip(rec_k.losses, rec_e.losses)]
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in firsts)
    log(f"  first step of each phase, kernel path against eager: {firsts}; largest relative "
        f"difference {rel:.2e}")
    check(len(firsts) == 2 and rel <= 1e-4, "the first steps' losses differ from the eager path's")
    check(launches["train_steps_auto"]["b1"] > 0, "B1 not launched in the CLI's train steps")
    check(not any(launches["train_eager"].values()), "the eager run launched a kernel")
    times = {"train_ms_by_phase": [statistics.median(p[1:]) for p in rec_k.train_ms],
             "train_eval_ms": statistics.median(rec_k.eval_ms)}

    # eval from the CLI's best checkpoint (its sidecar rebuilds ViT-B and the mask config)
    evals, f32_products = {}, {}
    for mode in ("auto", "eager"):
        out = io.StringIO()
        reset_launches()
        kg.reset_body_counts()
        with StepRecorder() as rec, kernel_mode(mode), contextlib.redirect_stdout(out):
            rc = cli.main(["eval", "--checkpoint", ckpt, "--test_batch_size", "16"])
        torch.cuda.synchronize()
        launches[f"eval_{mode}"] = read_launches()
        bodies, tally = kg.body_counts(), dict(kg.f32_products)
        f32_products[f"eval_{mode}"] = tally
        log(f"  eval ({mode}): GEMM launches by body {dict(bodies, wmma_shapes=None)}, the f32 "
            f"products' tally {tally}")
        check(bodies["f32_split"] == sum(tally.values()) and not bodies["wgmma"]
              and not bodies["wmma"] and (mode == "eager") == (bodies["f32_split"] == 0),
              f"eval ({mode}): f32 products on the split body {bodies} against the tally {tally}")
        line = [ln for ln in out.getvalue().splitlines() if ln.startswith("accuracy=")]
        evals[mode] = (rc, line[-1] if line else None, rec)
        log(f"  eval ({mode}): rc {rc}, {evals[mode][1]}, {len(rec.eval_ms)} batches, ms/batch "
            f"(median) {statistics.median(rec.eval_ms):.2f}; launches "
            + ", ".join(f"{k.upper()} {v}" for k, v in launches[f'eval_{mode}'].items() if v))
    (rc_k, line_k, rec_k), (rc_e, line_e, rec_e) = evals["auto"], evals["eager"]
    check(rc_k == 0 and rc_e == 0 and line_k is not None and line_k == line_e,
          f"eval: rc {rc_k} / {rc_e}, {line_k} / {line_e}")
    # eval reads the CLI's default synthetic test split: 128 images, 8 batches of 16
    check(len(rec_k.eval_logits) == 8 and len(rec_e.eval_logits) == 8,
          f"eval batches {len(rec_k.eval_logits)} / {len(rec_e.eval_logits)}, want 8")
    for i, (lk, le, mk, me) in enumerate(zip(rec_k.eval_logits, rec_e.eval_logits,
                                             rec_k.eval_masks, rec_e.eval_masks)):
        agree = (mk == me).flatten(2).all(-1).all(0)  # [L, B, S] -> [B]
        n_agree = int(agree.sum())
        d = (lk - le)[agree].abs().max().item() if n_agree else float("inf")
        tol = F32_ATOL + 1e-4 * le.abs().max().item()
        log(f"  eval batch {i}, kernel path against eager: logits [{', '.join(map(str, lk.shape))}]"
            f", keep masks agree on {n_agree}/{lk.shape[0]} images, logits max_abs_err there "
            f"{d:.3e} (tol {tol:.1e}, max|ref| {le.abs().max().item():.3f})")
        check(lk.shape == (16, 1000) and bool(torch.isfinite(lk).all()) and n_agree * 2 >= 16
              and d <= tol, f"eval batch {i}: {n_agree} images agree, err {d:.3e}")
    check(launches["eval_auto"]["b1"] > 0, "eval launched no B1")
    check(not any(launches["eval_eager"].values()), "the eager eval launched a kernel")
    times["eval_ms"] = statistics.median(rec_k.eval_ms)

    out_pth = os.path.join(work, "export", "vit_b.pth")
    reset_launches()
    rc = cli.main(["export", "--checkpoint", ckpt, "--out", out_pth])
    launches["export"] = read_launches()
    sd = torch.load(out_pth, map_location="cpu", weights_only=True)
    saved = dict(flatten_tree(restore_checkpoint(ckpt)["backbone"]))
    back = dict(flatten_tree(torch_state_dict_to_params(sd, b_cfg, device="cpu")))
    same = back.keys() == saved.keys() and all(torch.equal(v, saved[k]) for k, v in back.items())
    log(f"  export: rc {rc}, {len(sd)} tensors, equal to the checkpoint's: {same}")
    check(rc == 0 and len(sd) == 200 and same, "export")

    # B1 alone at the shapes of eval (float32) and of the train steps (bfloat16), masked as
    # mode mask runs it, beside its plain version: info for the kernel path's ms/batch
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.vit import layer_slice
    from vit_pruning_tpu_torch.ops.cuda import layer as kl

    gen = torch.Generator().manual_seed(SEED + 10)
    lp_cpu = layer_slice(init_vit_params(b_cfg.replace(num_layers=1), gen, "cpu")["layers"], 0)
    m = (torch.rand(16, 197, generator=gen) > 0.3).to(dev)
    m[:, 0] = True
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        lp = tree_to(lp_cpu, dev, dt)
        x = torch.randn(16, 197, b_cfg.hidden_size, generator=gen).to(dev, dt)
        k_ms, p_ms = (event_ms(lambda f=f: f(x, lp, b_cfg.num_heads, b_cfg.layernorm_eps, m))
                      for f in (kl.fused_vit_layer, kl.fused_vit_layer_ref))
        times[f"b1_{dname}_ms"] = (k_ms, p_ms)
        log(f"  B1 at ViT-B/16, batch 16, S 197, masked, {dname}: kernel {k_ms:.3f} ms, plain "
            f"version {p_ms:.3f} ms (mean of 10 after 3)")
    check.done()
    return {"launches": launches, "times": times, "f32_products": f32_products}


def event_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Mean ms of fn() on the card over `iters` calls after `warmup`, from CUDA events."""
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


def gate_path(dev, argv) -> dict:
    """Phase 9: the quality gates on the card, quality_torch.main(argv) on
    the gate model (32x32, patch 4, D 128, 4 heads of 32, 6 layers, 128
    classes), kernels 'auto' (B1 / B5 under autograd in training; B1-B4 in
    evaluation), epochs cut to keep the phase short. Held to the checks
    quality.py makes itself: the dense baseline at least 5x chance (else it
    exits 2), the JSON record's current schema (quality.py's
    validate_section), finite accuracies; exit code 0 or 1 (a gate that
    fails at cut epochs is reported, not hidden). The launch counts are set
    to 0 just before and read just after."""
    import contextlib
    import io

    import quality_torch

    from vit_pruning_tpu_torch.ops.cuda import gemm as kg

    check = Checks("phase 9 (the quality gates on the card)")
    out, err = io.StringIO(), io.StringIO()
    reset_launches()
    kg.reset_body_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = quality_torch.main(argv)
    finally:
        from vit_pruning_tpu_torch.ops.dispatch import set_kernel_mode

        set_kernel_mode("auto")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    bodies, f32_tally = kg.body_counts(), dict(kg.f32_products)
    log(f"  gates: GEMM launches by body {dict(bodies, wmma_shapes=None)}, the f32 products' "
        f"tally {f32_tally}")
    check(bodies["f32_split"] == sum(f32_tally.values()) > 0,
          f"gates: f32 products on the split body {bodies} against the tally {f32_tally}")
    lines = err.getvalue().splitlines()
    for ln in [ln for ln in lines if not ln.startswith(("epoch", "Test acc", "Overall"))
               and ln.strip() and "  " not in ln[:2]][-12:]:
        log(f"  | {ln[:200]}")
    record = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"  quality_torch.main({' '.join(argv)}): rc {rc} in {seconds:.1f} s; launches "
        + ", ".join(f"{k.upper()} {v}" for k, v in launches.items() if v))
    log(f"  gate JSON: {json.dumps(record)}")
    problems = quality_torch.validate_section(record) if "presets" in record else ["no presets"]
    accs = [record.get("dense_top1"), record.get("dense_top1_int8")] + [
        p[k] for p in record.get("presets", {}).values()
        for k in ("pruned_top1", "pruned_top1_int8")]
    check(rc in (0, 1), f"quality_torch exit code {rc} (2: dense baseline at chance)")
    check(not problems, f"gate JSON schema: {problems}")
    check(all(a is not None and math.isfinite(a) for a in accs), f"accuracies {accs}")
    check(record.get("dense_top1", 0.0) >= 5.0 / 128, "dense baseline within 5x chance")
    for key in ("b1", "b3", "b4"):
        check(launches[key] > 0, f"{key.upper()} not launched by the gates")
    check.done()
    return {"launches": launches, "record": record, "rc": rc, "seconds": seconds,
            "f32_products": f32_tally}


# phase 10: parallelism on 2 gloo ranks of the one card (parallel/), at DeiT-S width
PARALLEL_RANKS = 2
# Adam's first update is -lr g / (|g| + 1e-8): where |g| is near 1e-8 it
# turns the rounding of a gradient (two summation orders: one batch of 32
# or two of 16 added) into up to lr, so phase 10 holds params to 1e-5 where
# the single-process |grad| >= GRAD_FLOOR (there the update is lr sign(g)
# to 1%) and the gradients themselves through Adam's first moments
GRAD_FLOOR = 1e-6


def parallel_rank(smi: str) -> dict:
    """One rank of phase 10, run by parallel/launch.py::run_ranks. At
    DeiT-S @224 width (random weights from SEED, cls_mlp with
    PREDICTOR_GAIN), against the single-process call on the card, on every
    rank:
      - the data 2 train step (mode mask, bce_oracle, 'both', f32, batch 32,
        16 a rank), its ZeRO-1 twin and the data 1 x model 2 step (weights
        gathered before the layers), through dryrun_multichip_torch.py's
        parallel_train / single_train / train_checks: loss within 1e-5
        relative; params after the step within 1e-5 where the single-process
        |grad| >= 1e-6 (GRAD_FLOOR), the count left out printed; Adam's first
        moments (0.1 g) within 1e-3 of each leaf's largest (MU_RTOL), which
        holds the gradients' scale; ZeRO-1 within 1e-5 of the data 2 step and each
        rank's moments half of every leaf with an even dim;
      - dp serving, the headline in bf16 (uint8 batch 512, 256 a rank):
        logits bit-equal to serving_forward's rows, else within two bf16
        steps; and the same 256 rows at data 1 x model 2, with the step's
        peak memory beside the single-process call's;
      - pipeline_forward over 2 stages of 6 layers (f32, batch 64, 4
        microbatches) within 2e-5 of vit_forward, and pruned_pipeline_forward
        (the headline's drop with merge_dropped) within 2e-5 of
        progressive_topk_forward.
    Counts B1 / B2 launches inside the parallel calls only; returns the
    checks (ok, detail), the counts, the backend, the host-staged hops,
    times (host clock, the card synchronised) and peak memory (MiB above
    what was allocated before the call; params' MiB resident)."""
    import torch.distributed as dist

    from dryrun_multichip_torch import parallel_train, single_train, train_checks
    from vit_pruning_tpu_torch.configs import PruneConfig, deit_small
    from vit_pruning_tpu_torch.models.convert import flatten_tree, tree_to
    from vit_pruning_tpu_torch.models.pruned_vit import (
        init_pruned_vit_params, progressive_topk_forward)
    from vit_pruning_tpu_torch.models.vit import init_vit_params, vit_forward
    from vit_pruning_tpu_torch.parallel import (
        make_mesh, make_parallel_serving_step, shard_batch, shard_params)
    from vit_pruning_tpu_torch.parallel import collectives
    from vit_pruning_tpu_torch.parallel.pipeline import (
        make_stage_mesh, pipeline_forward, pruned_pipeline_forward)
    from vit_pruning_tpu_torch.serving import serving_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = deit_small(num_labels=100)
    checks, ms, peak, launches = {}, {}, {}, {"b1": 0, "b2": 0}
    collectives.reset_host_staged()

    def timed(fn, name=None):
        """fn() and its host-clock time (ms); its peak memory under `name`."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t = (time.perf_counter() - t0) * 1e3
        if name is not None:
            peak[name] = (torch.cuda.max_memory_allocated() - before) / 2**20
        return out, t

    def counted(fn, name=None):
        """timed(fn) with its B1 / B2 launches added to this rank's counts."""
        reset_launches(("b1", "b2"))
        out, t = timed(fn, name)
        for k, v in read_launches(("b1", "b2")).items():
            launches[k] += v
        return out, t

    def mib(tree):
        return sum(t.numel() * t.element_size() for _, t in flatten_tree(tree)) / 2**20

    def pruned_params(pcfg, dtype=torch.float32):
        p = init_pruned_vit_params(cfg, pcfg, torch.Generator().manual_seed(SEED), "cpu")
        p["predictor"]["mlp"] = {name: {"w": q["w"] * PREDICTOR_GAIN, "b": q["b"]}
                                 for name, q in p["predictor"]["mlp"].items()}
        return tree_to(p, dev, dtype)

    rs = np.random.RandomState(SEED + 10)
    u8 = torch.from_numpy(rs.randint(0, 256, (512, 3, 224, 224), dtype=np.uint8)).to(dev)
    batch = {"pixel_values": ((u8[:32].float() / 255.0 - 0.5) / 0.5),
             "labels": torch.from_numpy(rs.randint(0, 100, 32)).long().to(dev)}

    # train steps: data 2, its ZeRO-1 twin, data 1 x model 2; the single-process step
    pcfg = PruneConfig(mode="mask", predictor="cls_mlp", loss="bce_oracle")
    want = single_train(cfg, pcfg, pruned_params(pcfg), batch, timer=timed)
    ms["train_single"] = want["ms"]
    got = {}
    for name, data, model, zero1 in (("dp2", 2, 1, False), ("dp2_zero1", 2, 1, True),
                                     ("mp2", 1, 2, False)):
        got[name] = parallel_train(cfg, pcfg, pruned_params(pcfg), batch, data, model,
                                   zero1=zero1, timer=counted)
        ms[f"train_{name}"] = got[name]["ms"]
        checks.update(train_checks(name, got[name], want, grad_floor=GRAD_FLOOR))
    # ZeRO-1 halves a moment where the leaf has an even dim that its spec
    # leaves unsharded ('model' of size 1 still names its dim)
    z = got["dp2_zero1"]
    halved = [p for p, (m, _) in z["moments"].items()
              if math.prod(m) * 2 == math.prod(z["local"][p])]
    even = [p for p in z["moments"] if any(
        n >= 2 and n % 2 == 0 and (i >= len(z["specs"][p]) or z["specs"][p][i] is None)
        for i, n in enumerate(z["local"][p]))]
    checks["dp2_zero1 moments"] = (sorted(halved) == sorted(even) and len(even) > 0,
                                   f"{len(halved)} of {len(z['moments'])} moments halved")
    d = max(float((t - got["dp2"]["params"][k]).abs().max()) for k, t in z["params"].items())
    checks["dp2_zero1 vs dp2 params"] = (d < 1e-5, f"max |diff| {d:.2e}")
    del got, want, z
    torch.cuda.empty_cache()

    # dp serving: the headline, bf16, uint8 batch 512 (256 a rank); then 256
    # rows at data 1 x model 2
    head = PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention", top_k=98)
    params = pruned_params(head, torch.bfloat16)
    full, ms["serve_single_512"] = timed(lambda: serving_forward(params, u8, cfg, head)["logits"])
    for name, data, model in (("dp2", PARALLEL_RANKS, 1), ("mp2", 1, PARALLEL_RANKS)):
        mesh = make_mesh(data=data, model=model, device=dev.type)
        local, specs = shard_params(params, mesh)
        rows = shard_batch({"u8": u8[:512 // model]}, mesh)["u8"]
        step = make_parallel_serving_step(cfg, head, mesh, specs)
        got, ms[f"serve_{name}_{rows.shape[0]}"] = counted(lambda: step(local, rows),
                                                           f"serve_{name}")
        peak[f"params_{name}"] = mib(local)
        ref = shard_batch({"l": full[:512 // model]}, mesh)["l"]
        d = float((got.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        checks[f"serving {name} bf16 {rows.shape[0]} a rank"] = (
            d <= tol, "bit-equal to serving_forward" if d == 0 else
            f"max |diff| {d:.3e}, two bf16 steps {tol:.3e}")
        del local
    _, ms["serve_single_256"] = timed(
        lambda: serving_forward(params, u8[:256], cfg, head)["logits"], "serve_single")
    peak["params_single"] = mib(params)
    del params, full

    # the GPipe pipelines: 2 stages of 6 layers, f32, batch 64 in 4 microbatches
    x = torch.from_numpy(rs.randn(64, 3, 224, 224).astype(np.float32)).to(dev)
    stage_mesh = make_stage_mesh(PARALLEL_RANKS, device=dev.type)
    dense = init_vit_params(cfg, torch.Generator().manual_seed(SEED + 1), dev)
    got, ms["pipeline_dense"] = counted(lambda: pipeline_forward(dense, x, cfg, stage_mesh))
    want_l, ms["single_dense"] = timed(lambda: vit_forward(dense, x, cfg)["logits"])
    ok = torch.allclose(got, want_l, rtol=2e-5, atol=2e-5)
    checks["pipeline_forward"] = (ok, f"max |diff| {float((got - want_l).abs().max()):.2e}")
    merged = head.replace(merge_dropped=True)
    pp = pruned_params(merged)
    got, ms["pipeline_headline_merge"] = counted(
        lambda: pruned_pipeline_forward(pp, x, cfg, merged, stage_mesh))
    want_l, ms["single_headline_merge"] = timed(
        lambda: progressive_topk_forward(pp, x, cfg, merged)["logits"])
    ok = torch.allclose(got, want_l, rtol=2e-5, atol=2e-5)
    checks["pruned_pipeline_forward"] = (ok, f"max |diff| {float((got - want_l).abs().max()):.2e}")
    dist.barrier()
    return {"rank": dist.get_rank(), "backend": dist.get_backend(), "checks": checks,
            "launches": launches, "host_staged": collectives.host_staged, "ms": ms,
            "peak_mib": peak}


def parallel_path(smi: str) -> dict:
    """Phase 10: parallel_rank on PARALLEL_RANKS gloo ranks sharing the one
    card (NCCL takes one rank a card), spawned after the kernels were built
    in this process. Fails on any rank's failed check and unless B1 and B2
    launched on every rank. Times are information only: two ranks on one
    card measure no scaling."""
    from vit_pruning_tpu_torch.parallel import run_ranks

    check = Checks(f"phase 10 (parallel: {PARALLEL_RANKS} gloo ranks on one card, DeiT-S)")
    t0 = time.perf_counter()
    results = run_ranks(parallel_rank, PARALLEL_RANKS, smi, device="cuda", timeout_s=900)
    seconds = time.perf_counter() - t0
    for res in results:
        r = res["rank"]
        for name, (ok, detail) in res["checks"].items():
            log(f"  rank {r} {name}: {detail}")
            check(bool(ok), f"rank {r}: {name}: {detail}")
        for key in ("b1", "b2"):
            check(res["launches"][key] > 0, f"rank {r}: {key.upper()} never launched")
        log(f"  rank {r}: backend {res['backend']}, host-staged hops {res['host_staged']}, "
            f"launches B1 {res['launches']['b1']}, B2 {res['launches']['b2']}")
        log(f"  rank {r} ms (host clock, {smi}): "
            + ", ".join(f"{k} {v:.1f}" for k, v in res["ms"].items()))
        log(f"  rank {r} MiB (peak above the allocation before the call; params resident): "
            + ", ".join(f"{k} {v:.1f}" for k, v in res["peak_mib"].items()))
    log(f"  phase 10: {seconds:.1f} s, spawn included ({smi})")
    check.done()
    return {"launches": [res["launches"] for res in results], "seconds": seconds,
            "backend": results[0]["backend"],
            "host_staged": [res["host_staged"] for res in results]}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vit_pruning_tpu_torch.configs import (
        PruneConfig, ViTConfig, composed_schedule, deit_small, ultra_schedule,
        vit_base_patch16_224, vit_huge, vit_tiny)
    from vit_pruning_tpu_torch.data.preprocess import VIT_MEAN, VIT_STD
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models import pruned_vit as tp
    from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params, pruned_vit_forward
    from vit_pruning_tpu_torch.models.vit import (
        embed, init_vit_params, layer_norm, layer_range, layer_slice, layers_for, mlp_block,
        vit_forward, vit_layer)
    from vit_pruning_tpu_torch.ops.attention import mha
    from vit_pruning_tpu_torch.ops.cuda import attention as ka
    from vit_pruning_tpu_torch.ops.cuda import embed as kemb
    from vit_pruning_tpu_torch.ops.cuda import gemm as kg
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.cuda import layer_int8 as k8
    from vit_pruning_tpu_torch.ops.cuda import mlp as kmlp
    from vit_pruning_tpu_torch.ops.cuda import model as kmod
    from vit_pruning_tpu_torch.ops.cuda.build import load_library
    from vit_pruning_tpu_torch.ops.dispatch import encoder_fusion, kernel_mode, quant_mode
    from vit_pruning_tpu_torch.ops.quant import quantize_layer_params, with_kmajor_int8_weights
    from vit_pruning_tpu_torch.ops.masking import compact_dest
    from vit_pruning_tpu_torch.ops.patch_embed import extract_patches
    from vit_pruning_tpu_torch.ops.structured import prune_heads, prune_mlp_channels
    from vit_pruning_tpu_torch.serving import embed_from_u8, serving_forward

    dev = torch.device("cuda", 0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # --- 1. device ---------------------------------------------------------------
    smi = device_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # --- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    lib = load_library()
    log(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    # --- models (CPU init from one seed, then to the card) -------------------------
    gen = torch.Generator().manual_seed(SEED)
    cfg = deit_small(num_labels=100)
    n, L = cfg.num_patches, cfg.num_layers
    base = init_pruned_vit_params(cfg, PruneConfig(mode="topk_prog", predictor="cls_mlp"), gen,
                                  "cpu")
    base["predictor"]["mlp"] = {
        name: {"w": p["w"] * PREDICTOR_GAIN, "b": p["b"]}
        for name, p in base["predictor"]["mlp"].items()
    }
    bb, c_cfg = prune_heads(base["backbone"], cfg, [list(range(0, cfg.num_heads, 2))] * L)
    pruned = dict(base, backbone=prune_mlp_channels(
        bb, [list(range(0, cfg.mlp_dim, 2))] * L))

    def prune_cfg(sched):
        return PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention",
                           top_k=sched[0], keep_schedule=sched)

    presets = {  # name -> (config, prune config or None for dense, CPU params)
        "dense": (cfg, None, base),
        "headline": (cfg, PruneConfig(mode="topk_prog", predictor="cls_mlp",
                                      loss="mse_attention", top_k=98), base),
        "composed": (c_cfg, prune_cfg(composed_schedule(n, L)), pruned),
        "ultra": (c_cfg, prune_cfg(ultra_schedule(n, L)), pruned),
    }
    geometries = {  # kernel phases: (config, one perturbed layer on the CPU)
        "deit_s": (cfg, perturbed_layer(layer_slice(base["backbone"]["layers"], 0), gen)),
        "composed": (c_cfg, perturbed_layer(layer_slice(pruned["backbone"]["layers"], 0), gen)),
    }
    lnf = perturbed_layer(base["backbone"]["ln_f"], gen)
    head = {"w": base["backbone"]["head"]["w"],
            "b": base["backbone"]["head"]["b"] + 0.1 * torch.randn(100, generator=gen)}
    err = {"b1": 0.0, "b2": 0.0, "b3": 0.0, "b4": 0.0}

    # ViT-H/14 @224 (D 1280, 16 heads of 80, MLP 5120, 32 layers, S 257), f32 on the
    # card; its composed / ultra geometry keeps 8 of 16 heads (KW 640) and MLP 2560.
    # The cls_mlp predictor's gain is scaled by sqrt(384 / D) so that its inputs'
    # spread stays DeiT-S's and the scores do not saturate at 1.
    t0 = time.perf_counter()
    hcfg = vit_huge(num_labels=100)
    hn, hL = hcfg.num_patches, hcfg.num_layers
    base_h = vit_h_params(hcfg, PruneConfig(mode="topk_prog", predictor="cls_mlp"), dev)
    h_gain = PREDICTOR_GAIN * math.sqrt(384 / hcfg.hidden_size)
    base_h["predictor"]["mlp"] = {
        name: {"w": p["w"] * h_gain, "b": p["b"]} for name, p in base_h["predictor"]["mlp"].items()
    }
    hbb, hc_cfg = prune_heads(base_h["backbone"], hcfg, [list(range(0, hcfg.num_heads, 2))] * hL)
    pruned_h = dict(base_h, backbone=prune_mlp_channels(
        hbb, [list(range(0, hcfg.mlp_dim, 2))] * hL))
    geometries_h = {  # ViT-H kernel phases: (config, one perturbed layer on the card)
        "vit_h": (hcfg, perturbed_layer(layer_slice(base_h["backbone"]["layers"], 0), gen)),
        "vit_h composed": (hc_cfg, perturbed_layer(
            layer_slice(pruned_h["backbone"]["layers"], 0), gen)),
    }
    lnf_h = perturbed_layer(base_h["backbone"]["ln_f"], gen)
    head_h = perturbed_layer(base_h["backbone"]["head"], gen)
    torch.cuda.synchronize()
    log(f"ViT-H params (random, seed {SEED}, f32 on the card) built in "
        f"{time.perf_counter() - t0:.1f} s")

    # ViT-B/16 @224 (D 768, 12 heads of 64, MLP 3072), the CLI's model in phase 8: one
    # perturbed layer, from a generator of its own so that the other phases draw as before
    gen_b = torch.Generator().manual_seed(SEED + 8)
    b_cfg = vit_base_patch16_224()
    b_layer = perturbed_layer(layer_slice(
        init_vit_params(b_cfg.replace(num_layers=1), gen_b, "cpu")["layers"], 0), gen_b)

    # --- 3. B1 against its plain version ------------------------------------------------
    # DeiT-S and composed geometry at batch 8 and every length of the pruned paths; ViT-B at
    # the shapes phase 8's train and eval steps give B1 (batch 16, S 197)
    check = Checks("phase 3 (B1 vs plain)")
    b1_cases = [(gname, gcfg, lp_cpu, 8, (197, 131, 99, 66, 33, 17), gen)
                for gname, (gcfg, lp_cpu) in geometries.items()]
    b1_cases.append(("vit_b", b_cfg, b_layer, 16, (197,), gen_b))
    for gname, gcfg, lp_cpu, batch, lens, g in b1_cases:
        for dname, dt in dtypes.items():
            lp = tree_to(lp_cpu, dev, dt)
            for s in lens:
                x = torch.randn(batch, s, gcfg.hidden_size, generator=g).to(dev, dt)
                m = torch.rand(batch, s, generator=g) > 0.3
                m[:, 0] = True
                for mask in (None, m.to(dev)):
                    got = kl.fused_vit_layer(x, lp, gcfg.num_heads, gcfg.layernorm_eps, mask)
                    ref = kl.fused_vit_layer_ref(x, lp, gcfg.num_heads, gcfg.layernorm_eps, mask)
                    torch.cuda.synchronize()
                    rows = torch.ones_like(m) if mask is None else m  # masked rows: don't care
                    d = (got.float() - ref.float()).abs()[rows.to(dev)].max().item()
                    tol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
                    if dt == torch.float32:
                        err["b1"] = max(err["b1"], d)
                    tag = f"B1 {gname} {dname} S={s} {'mask' if mask is not None else 'nomask'}"
                    log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.1e})")
                    check(bool(torch.isfinite(got).all()) and d <= tol, tag)
    # what the kernel does not take must raise, not run
    gcfg, lp_cpu = geometries["deit_s"]
    lp = tree_to(lp_cpu, dev, torch.bfloat16)
    bad = {
        "float16": torch.zeros(2, 17, gcfg.hidden_size, device=dev, dtype=torch.float16),
        "non-contiguous": torch.zeros(2, gcfg.hidden_size, 17, device=dev,
                                      dtype=torch.bfloat16).transpose(1, 2),
    }
    for what, x in bad.items():
        try:
            kl.fused_vit_layer(x, lp, gcfg.num_heads)
            check(False, f"B1 accepted {what}")
        except (TypeError, ValueError) as e:
            log(f"  B1 rejects {what}: {e}")
    check.done()

    # --- 3c. B4 against its plain version ------------------------------------------------
    check = Checks("phase 3c (B4 vs plain)")

    def s8_products_since(n_b4: int, tag: str):
        """Every B4 launch since the counters read n_b4 (its wrapper's count)
        and 0 (the s8 body's, reset then) ran its four products on the
        wgmma s8 body."""
        calls, s8 = k8.fused_vit_layer_int8.launches - n_b4, k8.body_launches()
        log(f"  {tag}: B4's products on the wgmma s8 body: {s8} launches for {calls} B4 calls")
        check(calls > 0 and s8 == 4 * calls, f"{tag}: {s8} s8 products for {calls} B4 calls")

    k8.reset_body_launches()
    n_b4 = k8.fused_vit_layer_int8.launches
    flipped = {k: 0 for k in k8.STAGES}
    n_codes = {k: 0 for k in k8.STAGES}
    for gname, (gcfg, lp_cpu) in geometries.items():
        for dname, dt in dtypes.items():
            qp = quantize_layer_params(tree_to(lp_cpu, dev, dt))
            for s in (197, 131, 99, 66, 33, 17):
                x = torch.randn(8, s, gcfg.hidden_size, generator=gen).to(dev, dt)
                m = torch.rand(8, s, generator=gen) > 0.3
                m[:, 0] = True
                for mask in (None, m.to(dev)):
                    got, gc = k8.fused_vit_layer_int8(x, qp, gcfg.num_heads, gcfg.layernorm_eps,
                                                      mask, return_codes=True)
                    ref, rc = k8.fused_vit_layer_int8_ref(x, qp, gcfg.num_heads,
                                                          gcfg.layernorm_eps, mask,
                                                          return_codes=True)
                    torch.cuda.synchronize()
                    rows = torch.ones_like(m) if mask is None else m  # masked rows: don't care
                    d = (got.float() - ref.float()).abs()[rows.to(dev)].max().item()
                    ftol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
                    tol = ftol + int8_step(ref, x)
                    flips = {k: int((gc[k][0] != rc[k][0]).sum()) for k in k8.STAGES}
                    for k in k8.STAGES:
                        flipped[k] += flips[k]
                        n_codes[k] += gc[k][0].numel()
                    if dt == torch.float32:
                        err["b4"] = max(err["b4"], d)
                    tag = f"B4 {gname} {dname} S={s} {'mask' if mask is not None else 'nomask'}"
                    log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.2e}); codes apart "
                        + " ".join(f"{k} {v}" for k, v in flips.items()))
                    check(bool(torch.isfinite(got).all()) and d <= tol, tag)
    log("  int8 codes the kernel and its plain version round apart, all cases: "
        + ", ".join(f"{k} {flipped[k]} of {n_codes[k]}" for k in k8.STAGES))
    s8_products_since(n_b4, "phase 3c")
    for dname, dt in dtypes.items():  # half to even, on the card
        q, sc = k8.rowquant(torch.tensor([HALF_EVEN_ROW], device=dev, dtype=dt))
        codes = q.cpu().tolist()[0]
        log(f"  row quantization {dname} of {HALF_EVEN_ROW}: scale {sc.item()}, codes {codes}")
        check(codes == HALF_EVEN_CODES and sc.item() == 1.0, f"half to even ({dname})")
    gcfg, lp_cpu = geometries["deit_s"]
    qp = quantize_layer_params(tree_to(lp_cpu, dev, torch.bfloat16))
    bad["head dim 96"] = torch.zeros(2, 17, gcfg.hidden_size, device=dev, dtype=torch.bfloat16)
    for what, x in bad.items():  # what the kernel does not take must raise, not run
        try:
            k8.fused_vit_layer_int8(x, qp, 4 if what == "head dim 96" else gcfg.num_heads)
            check(False, f"B4 accepted {what}")
        except (TypeError, ValueError) as e:
            log(f"  B4 rejects {what}: {e}")
    check.done()

    def valid_rows(got, ref, mask):
        """max |got - ref| over the rows of valid tokens (masked rows are
        garbage by contract); got / ref [B, S, ...], mask [B, S] or None."""
        d = (got.float() - ref.float()).abs()
        return (d if mask is None else d[mask]).max().item()

    time_ms = event_ms

    def abba(kernel_fn, plain_fn, **kw):
        """plain, kernel, kernel, plain; mean of each pair (ms)."""
        p1 = time_ms(plain_fn, **kw)
        k1, k2 = time_ms(kernel_fn, **kw), time_ms(kernel_fn, **kw)
        p2 = time_ms(plain_fn, **kw)
        return (k1 + k2) / 2, (p1 + p2) / 2

    # --- 3d. B6 against its plain version ------------------------------------------------
    check = Checks("phase 3d (B6 vs plain)")
    err.update(b5=0.0, b6=0.0, b7=0.0)
    # the cases added with the tensor-core bodies draw from a generator of their own, so
    # that every later phase sees the inputs it saw before them
    gen67 = torch.Generator().manual_seed(SEED + 67)

    def body_took(mod, want: str, tag: str) -> str:
        """The body of the one call since mod.reset_body_counts(); it must
        be `want`, the body the C rule picks for the case."""
        n = mod.body_counts()
        ran = [b for b, c in n.items() if c]
        check(sum(n.values()) == 1 and ran == [want], f"{tag}: bodies {n}, {want} expected")
        return ran[0] if ran else "none"

    # DeiT-S's heads; hd 128 at S 257 (two hd boxes: the split body streams); ViT-H's hd 80
    # at S 257 (two 64-wide hd boxes and five key chunks in the tensor-core body) and
    # vit_tiny's hd 16 (a box wider than the head); bf16 at hd 20 and 12, which only the
    # split body takes (their own generator, so that the cases before see what they saw);
    # each unmasked, masked, and masked with image 0's keys all masked (uniform attention,
    # every row compared)
    shapes = [("deit_s", 8, cfg.num_heads, s, cfg.head_dim, gen) for s in (197, 99, 17)]
    shapes += [("hd128", 2, 3, 257, 128, gen), ("vit_h", 2, 16, 257, 80, gen67),
               ("vit_tiny", 4, 3, 17, 16, gen67)]
    gen17 = torch.Generator().manual_seed(SEED + 171)
    leftovers = [("hd20", 2, 3, 129, 20, gen17), ("hd12", 3, 2, 300, 12, gen17)]

    def f64_attention(q, k, v, mask):
        logits = (q.double() @ k.double().transpose(-1, -2)) / math.sqrt(q.shape[-1])
        if mask is not None:
            logits = torch.where(mask[:, None, None, :], logits,
                                 torch.tensor(-1e30, dtype=torch.float64, device=q.device))
        return torch.softmax(logits, -1) @ v.double()

    for dname, dt in dtypes.items():
        for gname, b, h, s, hd, g in shapes + (leftovers if dt == torch.bfloat16 else []):
            q, k, v = (torch.randn(b, h, s, hd, generator=g).to(dev, dt) for _ in range(3))
            m = torch.rand(b, s, generator=g) > 0.3
            m[:, 0] = True
            empty = m.clone()
            empty[0] = False
            for mname, mask in (("nomask", None), ("mask", m.to(dev)),
                                ("empty image", empty.to(dev))):
                tag = f"B6 {gname} {dname} S={s} {mname}"
                ka.reset_body_counts()
                got = ka.fused_attention(q, k, v, mask)
                torch.cuda.synchronize()
                body = body_took(ka, ka.body(q, k, v), tag)
                ref = ka.fused_attention_ref(q, k, v, mask)
                torch.cuda.synchronize()
                d = valid_rows(got.transpose(1, 2), ref.transpose(1, 2),
                               mask if mname == "mask" else None)
                tol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
                f64 = ""
                if dt == torch.float32:
                    err["b6"] = max(err["b6"], d)
                    # against float64: the valid rows' error at most 4x the plain version's
                    exact = f64_attention(q, k, v, mask)
                    rows = (torch.ones(b, s, dtype=torch.bool, device=dev) if mname != "mask"
                            else mask)[:, None, :, None]
                    e_k = float(((got.double() - exact).abs() * rows).max())
                    e_p = float(((ref.double() - exact).abs() * rows).max())
                    tol64 = F64_FACTOR * max(e_p, F32_ULP * float(exact.abs().max()))
                    f64 = f"; against float64 {e_k:.3e}, plain {e_p:.3e} (tol {tol64:.2e})"
                    check(e_k <= tol64, f"{tag}: float64 error {e_k:.3e} > {tol64:.2e}")
                log(f"  {tag}: {body} body, max_abs_err {d:.3e} (tol {tol:.1e}){f64}")
                check(bool(torch.isfinite(got).all()) and d <= tol, tag)
    bad = {  # what the kernel does not take must raise, not run
        "head dim 160": torch.zeros(2, 2, 17, 160, device=dev),
        "float16": torch.zeros(2, 2, 17, 64, device=dev, dtype=torch.float16),
        "non-contiguous": torch.zeros(2, 17, 2, 64, device=dev).transpose(1, 2),
    }
    for what, q in bad.items():
        try:
            ka.fused_attention(q, q, q)
            check(False, f"B6 accepted {what}")
        except (TypeError, ValueError) as e:
            log(f"  B6 rejects {what}: {e}")
    check.done()

    # --- 3e. B7 against its plain version ------------------------------------------------
    check = Checks("phase 3e (B7 vs plain)")

    def b7_case(tag, x, w, dt):
        kmlp.reset_body_counts()
        got = kmlp.fused_mlp(x, *w)
        torch.cuda.synchronize()
        body = body_took(kmlp, kmlp.body(x, w[0], w[2]), tag)
        ref = kmlp.fused_mlp_ref(x, *w)
        torch.cuda.synchronize()
        d = valid_rows(got, ref, None)
        tol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
        if dt == torch.float32:
            err["b7"] = max(err["b7"], d)
        log(f"  {tag}: {body} body, max_abs_err {d:.3e} (tol {tol:.1e})")
        check(bool(torch.isfinite(got).all()) and d <= tol, tag)

    for gname, (gcfg, lp_cpu) in geometries.items():
        for dname, dt in dtypes.items():
            mlp = tree_to(lp_cpu["mlp"], dev, dt)
            w = (mlp["fc1"]["w"], mlp["fc1"]["b"], mlp["fc2"]["w"], mlp["fc2"]["b"])
            for s in (197, 99, 17):
                x = torch.randn(8 * s, gcfg.hidden_size, generator=gen).to(dev, dt)
                b7_case(f"B7 {gname} (MLP {gcfg.mlp_dim}) {dname} rows={8 * s}", x, w, dt)
    # ViT-L width, 136 = 8 x 17 rows (the FMA body's 16-row tile; a partial row tile in
    # both bodies); ViT-H width, 514 = 2 x 257 rows (the tensor-core body's 64-row
    # blocks, seven column blocks)
    for d_, m_, rows, g in ((1024, 4096, 136, gen), (1280, 5120, 514, gen67)):
        for dname, dt in dtypes.items():
            x = torch.randn(rows, d_, generator=g).to(dev, dt)
            w = [(0.03 * torch.randn(shape, generator=g)).to(dev, dt)
                 for shape in ((d_, m_), (m_,), (m_, d_), (d_,))]
            b7_case(f"B7 D={d_} (MLP {m_}) {dname} rows={rows}", x, w, dt)
    # widths no multiple of 8 (phase 3l's D 100, MLP 300) at a ragged row count: f32 on the
    # split body (W's planes padded to 104 / 304 columns), bf16 on the FMA body; a
    # generator of its own, so that every later phase sees the inputs it saw before
    gen_w = torch.Generator().manual_seed(SEED + 16)
    for dname, dt in dtypes.items():
        x = torch.randn(137, 100, generator=gen_w).to(dev, dt)
        w = [(0.1 * torch.randn(shape, generator=gen_w)).to(dev, dt)
             for shape in ((100, 300), (300,), (300, 100), (100,))]
        b7_case(f"B7 D=100 (MLP 300) {dname} rows=137", x, w, dt)
    mlp = tree_to(geometries["deit_s"][1]["mlp"], dev, torch.bfloat16)
    w = (mlp["fc1"]["w"], mlp["fc1"]["b"], mlp["fc2"]["w"], mlp["fc2"]["b"])
    wide = torch.zeros(4, 2048, device=dev, dtype=torch.bfloat16)
    bad = {  # what the kernel does not take must raise, not run
        "hidden 2048": (wide, (wide.new_zeros(2048, 8), wide.new_zeros(8), wide.new_zeros(8, 2048),
                               wide.new_zeros(2048))),
        "float16": (torch.zeros(4, cfg.hidden_size, device=dev, dtype=torch.float16), w),
        "x [B, S, D]": (torch.zeros(2, 4, cfg.hidden_size, device=dev, dtype=torch.bfloat16), w),
    }
    for what, (x, ws) in bad.items():
        try:
            kmlp.fused_mlp(x, *ws)
            check(False, f"B7 accepted {what}")
        except (TypeError, ValueError) as e:
            log(f"  B7 rejects {what}: {e}")
    check.done()

    # --- 3f. B5 against its plain version ------------------------------------------------
    check = Checks("phase 3f (B5 vs plain)")
    stack_s = perturbed_layer(base["backbone"]["layers"], gen)  # all 12 layers, on the CPU
    stacks = {  # name -> (config, stacked layers on the CPU)
        "deit_s layers 0-12": (cfg, stack_s),
        "deit_s layers 2-5": (cfg, layer_range(stack_s, 2, 5)),
        "composed layers 2-5": (c_cfg, layer_range(perturbed_layer(
            pruned["backbone"]["layers"], gen), 2, 5)),
    }
    for sname, (gcfg, st_cpu) in stacks.items():
        for dname, dt in dtypes.items():
            st = tree_to(st_cpu, dev, dt)
            for s in (197, 99, 17):
                x = torch.randn(8, s, gcfg.hidden_size, generator=gen).to(dev, dt)
                m = torch.rand(8, s, generator=gen) > 0.3
                m[:, 0] = True
                for mask in (None, m.to(dev)):
                    got = kmod.fused_vit_encoder(x, st, gcfg.num_heads, gcfg.layernorm_eps, mask)
                    ref = kmod.fused_vit_encoder_ref(x, st, gcfg.num_heads, gcfg.layernorm_eps,
                                                     mask)
                    torch.cuda.synchronize()
                    d = valid_rows(got, ref, mask)
                    tol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
                    if dt == torch.float32:
                        err["b5"] = max(err["b5"], d)
                    tag = f"B5 {sname} {dname} S={s} {'mask' if mask is not None else 'nomask'}"
                    log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.1e})")
                    check(bool(torch.isfinite(got).all()) and d <= tol, tag)
    st = tree_to(layer_range(stack_s, 0, 2), dev, torch.bfloat16)
    bad = {  # what the kernel does not take must raise, not run
        "head dim 96": (torch.zeros(2, 17, cfg.hidden_size, device=dev, dtype=torch.bfloat16), 4),
        "float16": (torch.zeros(2, 17, cfg.hidden_size, device=dev, dtype=torch.float16),
                    cfg.num_heads),
    }
    for what, (x, heads) in bad.items():
        try:
            kmod.fused_vit_encoder(x, st, heads)
            check(False, f"B5 accepted {what}")
        except (TypeError, ValueError) as e:
            log(f"  B5 rejects {what}: {e}")
    check.done()

    # --- 4. B2 against its plain version ------------------------------------------------
    check = Checks("phase 4 (B2 vs plain)")
    # the launch plan's mirror against the C rule (csrc/cls_logits.cu::vpt_cls_logits_plan)
    plan_c = (ctypes.c_longlong * len(kl.CLS_LAUNCH_KINDS))()
    apart = []
    for code, dt in enumerate((torch.float32, torch.bfloat16, torch.float16)):
        for hd in (8, 16, 32, 48, 64, 80, 96, 128):
            for s in list(range(0, 800)) + [9000, 30000]:
                for d in (104, 384, 1280):
                    rc = lib.vpt_cls_logits_plan(code, hd, s, d, plan_c)
                    c_plan = None if rc else dict(zip(kl.CLS_LAUNCH_KINDS, plan_c))
                    if c_plan != kl.cls_logits_launches(dt, hd, s, d):
                        apart.append((code, hd, s, d))
    log(f"  cls_logits_launches against the C plan on {3 * 8 * 802 * 3} inputs: {len(apart)} apart")
    check(not apart, f"cls_logits_launches differs from the C plan at {apart[:3]}")
    for gname, (gcfg, lp_cpu) in geometries.items():
        for dname, dt in dtypes.items():
            lp, f, h = (tree_to(t, dev, dt) for t in (lp_cpu, lnf, head))
            for s in (197, 99, 33, 17):
                x = torch.randn(8, s, gcfg.hidden_size, generator=gen).to(dev, dt)
                kl.reset_cls_launch_counts()
                got = kl.fused_vit_layer_cls_logits(x, lp, f, h, gcfg.num_heads,
                                                    gcfg.layernorm_eps)
                torch.cuda.synchronize()
                ran, tally = kl.cls_launch_counts(), dict(kl.cls_launches)
                plan = kl.cls_logits_launches(dt, gcfg.head_dim, s, gcfg.hidden_size)
                ref = kl.fused_vit_layer_cls_logits_ref(x, lp, f, h, gcfg.num_heads,
                                                        gcfg.layernorm_eps)
                torch.cuda.synchronize()
                d = (got.float() - ref.float()).abs().max().item()
                tol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
                if dt == torch.float32:
                    err["b2"] = max(err["b2"], d)
                tag = f"B2 {gname} {dname} S={s}"
                log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.1e}); launches "
                    f"{ {k: v for k, v in ran.items() if v} }")
                check(got.shape == (8, 100) and bool(torch.isfinite(got).all()) and d <= tol, tag)
                check(ran == tally == plan, f"{tag}: launches {ran}, tally {tally}, plan {plan}")
                check(sum(ran.values()) <= 4, f"{tag}: {sum(ran.values())} launches")
    # the CLS attention isolated: bf16 three launches a call, f32 four (its weights'
    # planes, LN1's statistics, K / q / the attention / V, the tail)
    for dt, n in ((torch.bfloat16, 3), (torch.float32, 4)):
        for r in cls_attention_isolated(dev, log, dt):
            check(r["d"] <= r["tol"], f"{r['tag']}: err {r['d']:.3e} > tol {r['tol']:.2e}")
            check(r["ran"] == r["tally"] == r["plan"] and sum(r["ran"].values()) == n,
                  f"{r['tag']}: launches {r['ran']}, tally {r['tally']}, plan {r['plan']}")
    check.done()

    # --- 4b. B3 against its plain version -----------------------------------------------
    def random_mask(b, s, counts):
        """CLS + counts[i] - 1 random patches of image i, on the card."""
        rank = torch.rand(b, s - 1, generator=gen).argsort(-1).argsort(-1)
        keep = rank < (counts[:, None] - 1)
        return torch.cat([torch.ones(b, 1, dtype=torch.bool), keep], 1).to(dev)

    check = Checks("phase 4b (B3 vs plain)")
    for gname, (gcfg, lp_cpu) in geometries.items():
        for dname, dt in dtypes.items():
            lp = tree_to(lp_cpu, dev, dt)
            for s, cap in ((197, 99), (197, 131), (197, 197), (99, 50)):
                x = torch.randn(8, s, gcfg.hidden_size, generator=gen).to(dev, dt)
                counts = torch.randint(1, cap + 1, (8,), generator=gen)
                counts[0], counts[1] = 1, cap  # only CLS kept; a full bucket
                mask = random_mask(8, s, counts)
                dest = compact_dest(mask)
                got = kl.fused_vit_layer_bucketed(x, lp, dest, mask, cap, gcfg.num_heads,
                                                  gcfg.layernorm_eps)
                ref = kl.fused_vit_layer_bucketed_ref(x, lp, dest, mask, cap, gcfg.num_heads,
                                                      gcfg.layernorm_eps)
                torch.cuda.synchronize()
                d = (got.float() - ref.float()).abs()[mask].max().item()
                skipped_exact = bool(torch.equal(got[~mask], x[~mask]))
                tol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
                if dt == torch.float32:
                    err["b3"] = max(err["b3"], d)
                tag = f"B3 {gname} {dname} S={s} cap={cap}"
                log(f"  {tag}: kept rows max_abs_err {d:.3e} (tol {tol:.1e}); skipped rows "
                    f"bit-identical to x: {skipped_exact}")
                check(bool(torch.isfinite(got).all()) and d <= tol and skipped_exact, tag)
    gcfg, lp_cpu = geometries["deit_s"]
    lp = tree_to(lp_cpu, dev, torch.bfloat16)
    m17 = random_mask(2, 17, torch.tensor([5, 9]))
    x17 = torch.zeros(2, 17, gcfg.hidden_size, device=dev, dtype=torch.bfloat16)
    bad = {  # what the kernel does not take must raise, not run
        "cap 18 > S 17": (x17, 18, gcfg.num_heads),
        "head dim 96": (x17, 9, 4),
        "float16": (x17.half(), 9, gcfg.num_heads),
    }
    for what, (x, cap, heads) in bad.items():
        try:
            kl.fused_vit_layer_bucketed(x, lp, compact_dest(m17), m17, cap, heads)
            check(False, f"B3 accepted {what}")
        except (TypeError, ValueError) as e:
            log(f"  B3 rejects {what}: {e}")
    check.done()

    # --- 3g. B8a and B8b against their plain versions -------------------------------------
    check = Checks("phase 3g (B8a, B8b vs plain)")
    err.update(b8a=0.0, b8b=0.0)
    embed_shapes = {  # patches a image, patch width C*P*P, D
        "deit_s": (cfg.num_patches, cfg.patch_dim, cfg.hidden_size),
        "vit_h": (hn, hcfg.patch_dim, hcfg.hidden_size),
    }

    def embed_tol(ref, dt):
        top = float(ref.float().abs().max())
        return 1e-5 * top + 1e-5 if dt == torch.float32 else bf16_tol(ref.float())

    for gname, (n_p, pd, d) in embed_shapes.items():
        w0, b0 = 0.02 * torch.randn(pd, d, generator=gen), 0.1 * torch.randn(d, generator=gen)
        pos0 = 0.02 * torch.randn(n_p, d, generator=gen)
        u8p = torch.randint(0, 256, (64, n_p, pd), generator=gen, dtype=torch.uint8).to(dev)
        fp = torch.randn(64, n_p, pd, generator=gen).to(dev)
        for dname, dt in dtypes.items():
            w, b, pos = (t.to(dev, dt) for t in (w0, b0, pos0))
            cases = [("b8a", kemb.fused_patch_embed_u8, kemb.fused_patch_embed_u8_ref, u8p, pos),
                     ("b8b", kemb.fused_patch_embed_f, kemb.fused_patch_embed_f_ref, fp.to(dt), pos)]
            if dt == torch.float32:  # bf16 patches through the split body's A source
                cases += [("b8b", kemb.fused_patch_embed_f, kemb.fused_patch_embed_f_ref,
                           fp.to(torch.bfloat16), pos)]
            if dt == torch.bfloat16:  # embed_u8's pos may be f32; embed_fused's pixels too
                cases += [("b8a", kemb.fused_patch_embed_u8, kemb.fused_patch_embed_u8_ref, u8p,
                           pos.float()),
                          ("b8b", kemb.fused_patch_embed_f, kemb.fused_patch_embed_f_ref, fp, pos)]
            for key, fn, ref_fn, patches, ps in cases:
                kemb.reset_body_counts()
                got = fn(patches, w, b, ps)
                torch.cuda.synchronize()
                bodies = kemb.body_counts()
                ref = ref_fn(patches, w, b, ps)
                dmax = (got.float() - ref.float()).abs().max().item()
                tol = embed_tol(ref, dt)
                if dt == torch.float32:
                    err[key] = max(err[key], dmax)
                tag = (f"{key.upper()} {gname} (K {pd}, D {d}) {dname} weights, {patches.dtype} "
                       f"patches, {ps.dtype} pos")
                want = "wgmma" if dt == torch.bfloat16 else "split"  # by the weights' dtype
                log(f"  {tag}: max_abs_err {dmax:.3e} (tol {tol:.1e}); {want} body "
                    f"(launches by body {bodies})")
                check(got.shape == (64, n_p, d) and got.dtype == dt
                      and bool(torch.isfinite(got).all()) and dmax <= tol
                      and bodies[want] == 1 and sum(bodies.values()) == 1, tag)
    w, b, pos = (t.to(dev, torch.bfloat16) for t in (w0, b0, pos0))  # ViT-H's
    bad = {  # what the kernels do not take must raise, not run
        "B8a float patches": (kemb.fused_patch_embed_u8, fp, w, b, pos),
        "B8b uint8 patches": (kemb.fused_patch_embed_f, u8p, w, b, pos),
        "float16 weights": (kemb.fused_patch_embed_u8, u8p, w.half(), b.half(), pos.half()),
        "pos of another length": (kemb.fused_patch_embed_u8, u8p, w, b, pos[1:]),
    }
    for what, (fn, patches, *ws) in bad.items():
        try:
            fn(patches, *ws)
            check(False, f"B8 accepted {what}")
        except (TypeError, ValueError) as e:
            log(f"  B8 rejects {what}: {e}")
    try:
        with kernel_mode("kernel"):
            kemb.fused_patch_embed_u8(u8p.cpu(), w0, b0, pos0)
        check(False, "B8a ran a CPU tensor in mode 'kernel'")
    except RuntimeError as e:
        log(f"  B8a rejects a CPU tensor in mode 'kernel': {e}")
    # B8b's third A producer: patch rows that are no 8-byte multiple (patch 5: K 75), bf16
    # and f32 patches through the producer warps' registers; a generator of its own
    gen_o = torch.Generator().manual_seed(SEED + 4)
    w, b, pos = (0.02 * torch.randn(75, 128, generator=gen_o),
                 0.1 * torch.randn(128, generator=gen_o),
                 0.02 * torch.randn(49, 128, generator=gen_o))
    w, b = w.to(dev, torch.bfloat16), b.to(dev, torch.bfloat16)
    fp = torch.randn(16, 49, 75, generator=gen_o).to(dev)
    for patches in (fp.to(torch.bfloat16), fp):
        got = kemb.fused_patch_embed_f(patches, w, b, pos.to(dev))
        ref = kemb.fused_patch_embed_f_ref(patches, w, b, pos.to(dev))
        torch.cuda.synchronize()
        dmax, tol = (got.float() - ref.float()).abs().max().item(), bf16_tol(ref.float())
        tag = f"B8B K 75, D 128 bfloat16 weights, {patches.dtype} patches"
        log(f"  {tag}: max_abs_err {dmax:.3e} (tol {tol:.1e})")
        check(bool(torch.isfinite(got).all()) and dmax <= tol, tag)
    # B8a's uint8 rows of 75 bytes: read byte by byte, the K tail masked in registers
    u8o = torch.randint(0, 256, (16, 49, 75), generator=gen_o, dtype=torch.uint8).to(dev)
    got = kemb.fused_patch_embed_u8(u8o, w, b, pos.to(dev))
    ref = kemb.fused_patch_embed_u8_ref(u8o, w, b, pos.to(dev))
    torch.cuda.synchronize()
    dmax, tol = (got.float() - ref.float()).abs().max().item(), bf16_tol(ref.float())
    log(f"  B8A K 75, D 128 bfloat16 weights, uint8 patches: max_abs_err {dmax:.3e} "
        f"(tol {tol:.1e})")
    check(bool(torch.isfinite(got).all()) and dmax <= tol, "B8A K 75")
    # f32 weights on the split body at K 75: the A source's loads one value at a time, the K
    # tail masked after the affine; uint8 rows from an odd address too
    w, b, pos = (t.to(dev) for t in (0.02 * torch.randn(75, 128, generator=gen_o),
                                     0.1 * torch.randn(128, generator=gen_o),
                                     0.02 * torch.randn(49, 128, generator=gen_o)))
    u8_odd = torch.randint(0, 256, (16 * 49 * 75 + 1,), generator=gen_o,
                           dtype=torch.uint8).to(dev)[1:].view(16, 49, 75)
    for fn, ref_fn, patches in ((kemb.fused_patch_embed_f, kemb.fused_patch_embed_f_ref, fp),
                                (kemb.fused_patch_embed_f, kemb.fused_patch_embed_f_ref,
                                 fp.to(torch.bfloat16)),
                                (kemb.fused_patch_embed_u8, kemb.fused_patch_embed_u8_ref, u8o),
                                (kemb.fused_patch_embed_u8, kemb.fused_patch_embed_u8_ref, u8_odd)):
        kemb.reset_body_counts()
        got = fn(patches, w, b, pos)
        torch.cuda.synchronize()
        bodies = kemb.body_counts()
        ref = ref_fn(patches, w, b, pos)
        dmax, tol = (got - ref).abs().max().item(), embed_tol(ref, torch.float32)
        key = "b8a" if patches.dtype == torch.uint8 else "b8b"
        err[key] = max(err[key], dmax)
        tag = (f"B8 K 75, D 128 float32 weights, {patches.dtype} patches"
               + (" (odd address)" if patches is u8_odd else ""))
        log(f"  {tag}: max_abs_err {dmax:.3e} (tol {tol:.1e}); launches by body {bodies}")
        check(bool(torch.isfinite(got).all()) and dmax <= tol
              and bodies == {"wgmma": 0, "split": 1}, tag)
    check.done()

    # --- 3h. ViT-H's geometry (hd 80, S 257) in B1-B5 against their plain versions ----------
    check = Checks("phase 3h (ViT-H geometry in B1-B5 vs plain)")
    k8.reset_body_launches()
    n_b4 = k8.fused_vit_layer_int8.launches
    taken = tuple(h for h in range(1, 257) if lib.vpt_layer_head_dim_ok(h))
    log(f"  head dims the layer kernels take: {taken}")
    check(taken == kl.LAYER_HEAD_DIMS, f"the wrappers' head dims {kl.LAYER_HEAD_DIMS}")

    def last_kept_mask(b, s, counts):
        """CLS, the last token and counts[i] - 2 random others of image i."""
        rank = torch.rand(b, s - 2, generator=gen).argsort(-1).argsort(-1)
        mid = rank < (counts[:, None] - 2)
        ends = torch.ones(b, 1, dtype=torch.bool)
        return torch.cat([ends, mid, ends], 1).to(dev)

    # every length phase 5e gives these kernels: dense 257, headline / ultra /
    # topk50's cap 129, composed 171 / 86 / 43, ultra 43 / 22; B2 the last of
    # headline / composed / ultra; phase 5e's batches (f32 4, bf16 32)
    h_lens, h_tails = (257, 171, 129, 86, 43, 22), (129, 43, 22)
    h_batch = {torch.float32: 4, torch.bfloat16: 32}
    for gname, (gcfg, lp_src) in geometries_h.items():
        for dname, dt in dtypes.items():
            lp = tree_to(lp_src, dev, dt)
            qp = quantize_layer_params(lp)
            ftol = (lambda ref: F32_ATOL) if dt == torch.float32 else bf16_tol
            hb = h_batch[dt]
            for s in h_lens:
                x = torch.randn(hb, s, gcfg.hidden_size, generator=gen).to(dev, dt)
                m = torch.rand(hb, s, generator=gen) > 0.3
                m[:, 0] = True
                for mask in (None, m.to(dev)):
                    mtag = "mask" if mask is not None else "nomask"
                    got = kl.fused_vit_layer(x, lp, gcfg.num_heads, gcfg.layernorm_eps, mask)
                    ref = kl.fused_vit_layer_ref(x, lp, gcfg.num_heads, gcfg.layernorm_eps, mask)
                    torch.cuda.synchronize()
                    d, tol = valid_rows(got, ref, mask), ftol(ref.float())
                    if dt == torch.float32:
                        err["b1"] = max(err["b1"], d)
                    tag = f"B1 {gname} (KW {gcfg.attn_width}) {dname} B={hb} S={s} {mtag}"
                    log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.1e})")
                    check(bool(torch.isfinite(got).all()) and d <= tol, tag)
                    got = k8.fused_vit_layer_int8(x, qp, gcfg.num_heads, gcfg.layernorm_eps, mask)
                    ref = k8.fused_vit_layer_int8_ref(x, qp, gcfg.num_heads, gcfg.layernorm_eps,
                                                      mask)
                    torch.cuda.synchronize()
                    d, tol = valid_rows(got, ref, mask), ftol(ref.float()) + int8_step(ref, x)
                    if dt == torch.float32:
                        err["b4"] = max(err["b4"], d)
                    tag = f"B4 {gname} (KW {gcfg.attn_width}) {dname} B={hb} S={s} {mtag}"
                    log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.2e})")
                    check(bool(torch.isfinite(got).all()) and d <= tol, tag)
            f, h = tree_to(lnf_h, dev, dt), tree_to(head_h, dev, dt)
            for s in h_tails:
                x = torch.randn(hb, s, gcfg.hidden_size, generator=gen).to(dev, dt)
                got = kl.fused_vit_layer_cls_logits(x, lp, f, h, gcfg.num_heads,
                                                    gcfg.layernorm_eps)
                ref = kl.fused_vit_layer_cls_logits_ref(x, lp, f, h, gcfg.num_heads,
                                                        gcfg.layernorm_eps)
                torch.cuda.synchronize()
                d, tol = (got.float() - ref.float()).abs().max().item(), ftol(ref.float())
                if dt == torch.float32:
                    err["b2"] = max(err["b2"], d)
                tag = f"B2 {gname} {dname} B={hb} S={s}"
                log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.1e})")
                check(got.shape == (hb, 100) and bool(torch.isfinite(got).all()) and d <= tol, tag)
            # B3 at topk50's bucket: S 257, cap 129, the last token kept in every image
            x = torch.randn(hb, 257, gcfg.hidden_size, generator=gen).to(dev, dt)
            counts = torch.tensor([129, 2, 60, 100] * (hb // 4))
            mask = last_kept_mask(hb, 257, counts)
            dest = compact_dest(mask)
            got = kl.fused_vit_layer_bucketed(x, lp, dest, mask, 129, gcfg.num_heads,
                                              gcfg.layernorm_eps)
            ref = kl.fused_vit_layer_bucketed_ref(x, lp, dest, mask, 129, gcfg.num_heads,
                                                  gcfg.layernorm_eps)
            torch.cuda.synchronize()
            d, tol = (got.float() - ref.float()).abs()[mask].max().item(), ftol(ref.float())
            last = (got[:, -1].float() - ref[:, -1].float()).abs().max().item()
            moved = bool((got[:, -1] != x[:, -1]).any(-1).all())
            skipped_exact = bool(torch.equal(got[~mask], x[~mask]))
            if dt == torch.float32:
                err["b3"] = max(err["b3"], d)
            tag = f"B3 {gname} {dname} B={hb} S=257 cap=129 (last token kept)"
            log(f"  {tag}: kept rows max_abs_err {d:.3e} (tol {tol:.1e}), last token's "
                f"{last:.3e}, the last token went through the layer in every image: {moved}; "
                f"skipped rows bit-identical to x: {skipped_exact}")
            check(bool(torch.isfinite(got).all()) and d <= tol and moved and skipped_exact, tag)
    st_h = perturbed_layer(layer_range(base_h["backbone"]["layers"], 0, 2), gen)
    for dname, dt in dtypes.items():  # B5 on two ViT-H layers: a direct call
        st, hb = tree_to(st_h, dev, dt), h_batch[dt]
        x = torch.randn(hb, 257, hcfg.hidden_size, generator=gen).to(dev, dt)
        m = torch.rand(hb, 257, generator=gen) > 0.3
        m[:, 0] = True
        for mask in (None, m.to(dev)):
            got = kmod.fused_vit_encoder(x, st, hcfg.num_heads, hcfg.layernorm_eps, mask)
            ref = kmod.fused_vit_encoder_ref(x, st, hcfg.num_heads, hcfg.layernorm_eps, mask)
            torch.cuda.synchronize()
            d = valid_rows(got, ref, mask)
            tol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
            if dt == torch.float32:
                err["b5"] = max(err["b5"], d)
            tag = (f"B5 vit_h layers 0-2 {dname} B={hb} S=257 "
                   f"{'mask' if mask is not None else 'nomask'}")
            log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.1e})")
            check(bool(torch.isfinite(got).all()) and d <= tol, tag)
    lp = tree_to(geometries_h["vit_h"][1], dev, torch.bfloat16)
    x = torch.zeros(2, 17, hcfg.hidden_size, device=dev, dtype=torch.bfloat16)
    try:  # head dim 128: not taken, must raise naming the head dims taken, not run
        kl.fused_vit_layer(x, lp, 10)
        check(False, "B1 accepted head dim 128")
    except ValueError as e:
        log(f"  B1 rejects head dim 128: {e}")
        check("16, 32, 64, 80" in str(e), "the error does not name the head dims taken")

    # the short head dims of the repo's own configs: vit_tiny's 16 (D 64, 4 heads, MLP
    # 128, S 17) and the quality gate model's 32 (D 128, 4 heads, MLP 256, S 65), B1-B5
    # masked and not, f32 and bf16, batch 8; drawn from a generator of their own so that
    # every later phase sees the inputs it saw before these cases existed
    gen_s = torch.Generator().manual_seed(SEED + 1)
    short = {"vit_tiny (hd 16)": vit_tiny(num_labels=100),
             "gate (hd 32)": ViTConfig(image_size=32, patch_size=4, hidden_size=128,
                                       num_layers=3, num_heads=4, mlp_dim=256, num_labels=100)}
    for gname, gcfg in short.items():
        sp = init_vit_params(gcfg, gen_s, "cpu")
        stack = perturbed_layer(sp["layers"], gen_s)
        lp_cpu, f_cpu, h_cpu = (layer_slice(stack, 0), perturbed_layer(sp["ln_f"], gen_s),
                                perturbed_layer(sp["head"], gen_s))
        s = gcfg.seq_len
        for dname, dt in dtypes.items():
            lp, f, h, st = (tree_to(t, dev, dt) for t in (lp_cpu, f_cpu, h_cpu, stack))
            qp = quantize_layer_params(lp)
            ftol = (lambda ref: F32_ATOL) if dt == torch.float32 else bf16_tol
            x = torch.randn(8, s, gcfg.hidden_size, generator=gen_s).to(dev, dt)
            m = torch.rand(8, s, generator=gen_s) > 0.3
            m[:, 0] = True
            for mask in (None, m.to(dev)):
                mtag = "mask" if mask is not None else "nomask"
                cases = (
                    ("B1", lambda: kl.fused_vit_layer(x, lp, gcfg.num_heads, gcfg.layernorm_eps,
                                                      mask),
                     lambda: kl.fused_vit_layer_ref(x, lp, gcfg.num_heads, gcfg.layernorm_eps,
                                                    mask), 0.0),
                    ("B4", lambda: k8.fused_vit_layer_int8(x, qp, gcfg.num_heads,
                                                           gcfg.layernorm_eps, mask),
                     lambda: k8.fused_vit_layer_int8_ref(x, qp, gcfg.num_heads,
                                                         gcfg.layernorm_eps, mask), None),
                    ("B5", lambda: kmod.fused_vit_encoder(x, st, gcfg.num_heads,
                                                          gcfg.layernorm_eps, mask),
                     lambda: kmod.fused_vit_encoder_ref(x, st, gcfg.num_heads,
                                                        gcfg.layernorm_eps, mask), 0.0),
                )
                for key, fn, ref_fn, extra in cases:
                    got, ref = fn(), ref_fn()
                    torch.cuda.synchronize()
                    d = valid_rows(got, ref, mask)
                    tol = ftol(ref.float()) + (int8_step(ref, x) if extra is None else extra)
                    if dt == torch.float32:
                        err[key.lower()] = max(err[key.lower()], d)
                    tag = f"{key} {gname} {dname} B=8 S={s} {mtag}"
                    log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.2e})")
                    check(bool(torch.isfinite(got).all()) and d <= tol, tag)
            got = kl.fused_vit_layer_cls_logits(x, lp, f, h, gcfg.num_heads, gcfg.layernorm_eps)
            ref = kl.fused_vit_layer_cls_logits_ref(x, lp, f, h, gcfg.num_heads,
                                                    gcfg.layernorm_eps)
            torch.cuda.synchronize()
            d, tol = (got.float() - ref.float()).abs().max().item(), ftol(ref.float())
            if dt == torch.float32:
                err["b2"] = max(err["b2"], d)
            tag = f"B2 {gname} {dname} B=8 S={s}"
            log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.1e})")
            check(got.shape == (8, 100) and bool(torch.isfinite(got).all()) and d <= tol, tag)
            cap = s // 2 + 1
            counts = torch.randint(1, cap + 1, (8,), generator=gen_s)
            counts[0], counts[1] = 1, cap  # only CLS kept; a full bucket
            rank = torch.rand(8, s - 1, generator=gen_s).argsort(-1).argsort(-1)
            kmask = torch.cat([torch.ones(8, 1, dtype=torch.bool), rank < (counts[:, None] - 1)],
                              1).to(dev)
            dest = compact_dest(kmask)
            got = kl.fused_vit_layer_bucketed(x, lp, dest, kmask, cap, gcfg.num_heads,
                                              gcfg.layernorm_eps)
            ref = kl.fused_vit_layer_bucketed_ref(x, lp, dest, kmask, cap, gcfg.num_heads,
                                                  gcfg.layernorm_eps)
            torch.cuda.synchronize()
            d, tol = (got.float() - ref.float()).abs()[kmask].max().item(), ftol(ref.float())
            skipped_exact = bool(torch.equal(got[~kmask], x[~kmask]))
            if dt == torch.float32:
                err["b3"] = max(err["b3"], d)
            tag = f"B3 {gname} {dname} B=8 S={s} cap={cap}"
            log(f"  {tag}: kept rows max_abs_err {d:.3e} (tol {tol:.1e}); skipped rows "
                f"bit-identical to x: {skipped_exact}")
            check(bool(torch.isfinite(got).all()) and d <= tol and skipped_exact, tag)
    s8_products_since(n_b4, "phase 3h")
    check.done()

    # --- 3k. sequences past the resident limits in B1-B6 against their plain versions ------
    long_sequences(dev, err)

    # --- 3m. B1-B5's bf16 attention body at the edges of its chunks, tiles and residency --
    attention_edges(dev)

    # --- 3i. the bf16 GEMM bodies against their plain version ----------------------------
    # Every product shape of the main paths, one product at a time through ops/cuda/gemm.py
    # (the C gemm() the layer kernels call): B1 / B3's four products and B5's variants (f32
    # residual stream, erf GELU) at DeiT-S and composed width, S 197/131/99/66/33/17, and at
    # ViT-H and its composed width, S 257/171/129/86/43/22, batch 8 (ragged M); B2's
    # products at the tails (DeiT-S 99/33/17, ViT-H 129/43/22) with A's and the residual's
    # strided CLS rows and the classifier's N 100. The body each product took is read from
    # the launch counters: the wgmma body wherever TMA can describe A and W, the WMMA body
    # only where it cannot; on the wgmma body the output tiles it walked and the blocks it
    # launched, against the walk's rule (ops/cuda/gemm.py::wgmma_walk). Then the four
    # products at the benchmark cells' row counts (DeiT-S headline 512 x 99 and dense 512 x
    # 197, ViT-H headline 64 x 129) and at ViT-H 64 x 257, each against its plain version,
    # at least 2 tiles a block, timed beside torch.matmul's bf16 product on the same
    # operands (a yardstick only) and against its bound, max(FLOP / 989 TFLOP/s, bytes /
    # 3.35 TB/s).
    check = Checks("phase 3i (bf16 GEMM bodies vs plain)")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen_g = torch.Generator().manual_seed(SEED + 2)
    bfl, f32 = torch.bfloat16, torch.float32

    def gemm_operands(m, k, n, res=None, lda=None, ldr=None):
        a = torch.randn(m, lda or k, generator=gen_g).to(dev, bfl)[:, :k]
        w = (torch.randn(k, n, generator=gen_g) / math.sqrt(k)).to(dev, bfl)
        b = (0.1 * torch.randn(n, generator=gen_g)).to(dev, bfl)
        r = None if res is None else torch.randn(m, ldr or n, generator=gen_g).to(dev, res)[:, :n]
        return a, w, b, r

    def gemm_check(tag, ops, act="none", out=bfl):
        a, w, b, r = ops
        c0 = kg.body_counts()
        got = kg.gemm_bf16(a, w, b, act, r, out)
        torch.cuda.synchronize()
        c1 = kg.body_counts()
        ref = kg.gemm_bf16_ref(a, w, b, act, r, out)
        body = "wgmma" if c1["wgmma"] > c0["wgmma"] else "wmma"
        want = "wgmma" if kg.takes_wgmma(a, w) else "wmma"
        walk = {k: c1[f"wgmma_{k}"] - c0[f"wgmma_{k}"] for k in ("tiles", "blocks")}
        want_walk = (kg.wgmma_walk(a.shape[0], w.shape[1], sms) if want == "wgmma"
                     else {"tiles": 0, "blocks": 0})
        d = (got.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        tol = bf16_tol(ref.float()) if out == bfl else F32_ATOL * max(1.0, top)
        log(f"  GEMM {tag} M={a.shape[0]} N={w.shape[1]} K={a.shape[1]} (lda {a.stride(0)}"
            f"{'' if r is None else f', residual {r.dtype} ldr {r.stride(0)}'}, {act}, out "
            f"{out}): body {body}, {walk['tiles']} tiles on {walk['blocks']} blocks; "
            f"max_abs_err {d:.3e} (tol {tol:.1e})")
        check(got.shape == ref.shape and bool(torch.isfinite(got).all()) and d <= tol
              and body == want and c1["wgmma"] + c1["wmma"] == c0["wgmma"] + c0["wmma"] + 1
              and walk == want_walk,
              f"GEMM {tag}: err {d:.3e}, body {body} (want {want}), walk {walk} (want "
              f"{want_walk})")
        return a, w, got, walk

    gemm_geoms = (("deit_s", cfg, (197, 131, 99, 66, 33, 17), (99, 33, 17)),
                  ("composed", c_cfg, (197, 131, 99, 66, 33, 17), (33, 17)),
                  ("vit_h", hcfg, h_lens, (129,)),
                  ("vit_h composed", hc_cfg, h_lens, (43, 22)))
    for gname, gcfg, lens, tails in gemm_geoms:
        d, kw, mm = gcfg.hidden_size, gcfg.attn_width, gcfg.mlp_dim
        for s in lens:
            r8 = 8 * s
            for tag, (m, k, n, res, act, out) in {
                    "qkv": (r8, d, 3 * kw, None, "none", bfl),
                    "o": (r8, kw, d, bfl, "none", f32),
                    "fc1": (r8, d, mm, None, "gelu_tanh", bfl),
                    "fc2": (r8, mm, d, f32, "none", bfl),
                    "B5 o": (r8, kw, d, f32, "none", f32),
                    "B5 fc1": (r8, d, mm, None, "gelu_erf", bfl),
                    "B5 fc2": (r8, mm, d, f32, "none", f32)}.items():
                gemm_check(f"{gname} S={s} {tag}", gemm_operands(m, k, n, res), act, out)
        for s in tails:
            gemm_check(f"{gname} B2 S={s} kv", gemm_operands(8 * s, d, 2 * kw))
            gemm_check(f"{gname} B2 S={s} q (CLS rows)", gemm_operands(8, d, kw, lda=s * d))
            gemm_check(f"{gname} B2 S={s} o (CLS residual)",
                       gemm_operands(8, kw, d, bfl, ldr=s * d), out=f32)
            gemm_check(f"{gname} B2 S={s} fc1", gemm_operands(8, d, mm), "gelu_tanh")
            gemm_check(f"{gname} B2 S={s} fc2", gemm_operands(8, mm, d, f32), out=f32)
            gemm_check(f"{gname} B2 S={s} classifier", gemm_operands(8, d, 100))
    # ViT-B/16's four B1 products at phase 8's batch 16 x S 197 (K 768 / 3072, N 2304 / 3072)
    d, kw, mm, r16 = b_cfg.hidden_size, b_cfg.attn_width, b_cfg.mlp_dim, 16 * 197
    for tag, (k, n, res, act, out) in {"qkv": (d, 3 * kw, None, "none", bfl),
                                       "o": (kw, d, bfl, "none", f32),
                                       "fc1": (d, mm, None, "gelu_tanh", bfl),
                                       "fc2": (mm, d, f32, "none", bfl)}.items():
        gemm_check(f"vit_b batch 16 S=197 {tag}", gemm_operands(r16, k, n, res), act, out)
    gemm_rates = []
    for gname, gcfg, batch, s in (("deit_s headline", cfg, 512, 99), ("deit_s dense", cfg, 512, 197),
                                  ("vit_h headline", hcfg, 64, 129), ("vit_h", hcfg, 64, 257)):
        d, kw, mm = gcfg.hidden_size, gcfg.attn_width, gcfg.mlp_dim
        rows = batch * s
        for tag, (k, n, res, act, out) in {"qkv": (d, 3 * kw, None, "none", bfl),
                                           "o": (kw, d, bfl, "none", f32),
                                           "fc1": (d, mm, None, "gelu_tanh", bfl),
                                           "fc2": (mm, d, f32, "none", bfl)}.items():
            ops = gemm_operands(rows, k, n, res)
            a, w, _, walk = gemm_check(f"{gname} batch {batch} S={s} {tag}", ops, act, out)
            check(walk["tiles"] >= 2 * walk["blocks"],
                  f"GEMM {gname} {tag}: {walk['tiles']} tiles on {walk['blocks']} blocks, fewer "
                  f"than 2 a block")
            k_ms = time_ms(lambda: kg.gemm_bf16(a, w, ops[2], act, ops[3], out))
            l_ms = time_ms(lambda: torch.matmul(a, w))
            flops = 2.0 * rows * k * n
            nbytes = (2 * rows * k + 2 * k * n + rows * n * out.itemsize
                      + (0 if res is None else rows * n * res.itemsize))
            bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
            gemm_rates.append((f"{gname} {tag}", rows, n, k, k_ms, l_ms))
            log(f"  GEMM {gname} batch {batch} S={s} {tag} M={rows} N={n} K={k}: kernel {k_ms:.4f} "
                f"ms ({flops / k_ms / 1e9:.1f} TFLOP/s, {100 * bound / k_ms:.1f}% of its bound "
                f"{bound:.4f} ms), {walk['tiles']} tiles on {walk['blocks']} blocks; torch.matmul "
                f"bf16 {l_ms:.4f} ms ({flops / l_ms / 1e9:.1f} TFLOP/s); {smi}")
            del ops, a, w
    # DINOv2's epilogue variants at the DINOv2 cell's widths (batch 32 x S 689, D 1536,
    # SwiGLU M 4096): the gated fc1 (N 8192 of (u1, u2) pairs -> silu(u1) * u2, 4096 wide)
    # and LayerScale's gain on O and fc2, each against its plain version, every output tile
    # counted as a gated or a scaled tile (body_counts' gated_tiles, scaled_tiles)
    rows = 32 * 689
    for tag, (k, n, res, out, gate) in {"fc1 gated": (1536, 8192, None, bfl, True),
                                        "o scaled": (1536, 1536, bfl, f32, False),
                                        "fc2 scaled": (4096, 1536, f32, bfl, False)}.items():
        a, w, b, r = gemm_operands(rows, k, n, res)
        gamma = None if gate else (0.5 + 0.25 * torch.randn(n, generator=gen_g)).to(dev, bfl)
        c0 = kg.body_counts()
        got = kg.gemm_bf16(a, w, b, "none", r, out, gamma=gamma, gate=gate)
        torch.cuda.synchronize()
        c1 = kg.body_counts()
        ref = kg.gemm_bf16_ref(a, w, b, "none", r, out, gamma=gamma, gate=gate)
        d = (got.float() - ref.float()).abs().max().item()
        tol = (bf16_tol(ref.float()) if out == bfl
               else F32_ATOL * max(1.0, ref.float().abs().max().item()))
        tiles = kg.wgmma_walk(rows, n, sms)["tiles"]
        counted = {k_: c1[k_] - c0[k_] for k_ in ("gated_tiles", "scaled_tiles")}
        want = {"gated_tiles": tiles if gate else 0, "scaled_tiles": 0 if gate else tiles}
        log(f"  GEMM dinov2 {tag} M={rows} N={n} K={k}: max_abs_err {d:.3e} (tol {tol:.1e}), "
            f"{counted}")
        check(bool(torch.isfinite(got).all()) and d <= tol and counted == want,
              f"GEMM dinov2 {tag}: err {d:.3e}, counted {counted} (want {want})")
        del a, w, got, ref
    check.done()

    # --- 3n. the f32 split body against its plain version and a float64 product ---------
    # Every f32 product shape of B1 / B3 / B5 and B2 on the paths (f32_product_shapes), one
    # product at a time through ops/cuda/gemm.py::gemm_f32 (the C gemm() the layer kernels
    # call in f32), each held against the f32 plain version and a float64 product
    # (f32_split_products) and run on the split body (the launch counters); then ViT-B's
    # four products at phase 8's batch 16 timed beside torch.matmul's f32 product (TF32
    # off) on the same operands (a yardstick only), each against its bound_split6.
    check = Checks("phase 3n (f32 split body vs plain and float64)")
    c0 = kg.body_counts()
    split_recs = f32_split_products(dev, log)
    c1 = kg.body_counts()
    for r in split_recs:
        check(r["ratio"] <= 1.0, f"f32 split {r['tag']}: err {r['d']:.3e} (tol {r['tol']:.1e}), "
                                 f"relative to float64 {r['e64']:.3e} (tol {r['tol64']:.2e})")
    ran = {k: c1[k] - c0[k] for k in ("wgmma", "wmma", "f32_split")}
    check(ran == {"wgmma": 0, "wmma": 0, "f32_split": len(split_recs)},
          f"f32 split: launches by body {ran}, want {len(split_recs)} on the split body")
    log(f"  f32 split: {len(split_recs)} products, launches by body {ran}; worst err / tol "
        f"{max(r['ratio'] for r in split_recs):.3f}")
    err["f32_split"] = max(r["d"] for r in split_recs)
    f32_gemm_rates = []
    d, kw, mm, r16 = b_cfg.hidden_size, b_cfg.attn_width, b_cfg.mlp_dim, 16 * 197
    for tag, (k, n, res, act) in {"qkv": (d, 3 * kw, False, "none"), "o": (kw, d, True, "none"),
                                  "fc1": (d, mm, False, "gelu_erf"),
                                  "fc2": (mm, d, True, "none")}.items():
        a = torch.randn(r16, k, generator=gen_g).to(dev)
        w = (torch.randn(k, n, generator=gen_g) / math.sqrt(k)).to(dev)
        b = (0.1 * torch.randn(n, generator=gen_g)).to(dev)
        r = torch.randn(r16, n, generator=gen_g).to(dev) if res else None
        k_ms = time_ms(lambda: kg.gemm_f32(a, w, b, act, r))
        l_ms = time_ms(lambda: torch.matmul(a, w))
        flops = 2.0 * r16 * k * n
        b_ms, b_by = bound_split6(flops, 4.0 * (r16 * k + k * n + (2 if res else 1) * r16 * n))
        f32_gemm_rates.append((tag, r16, n, k, k_ms, l_ms, b_ms))
        log(f"  f32 split vit_b batch 16 S=197 {tag} M={r16} N={n} K={k}: kernel {k_ms:.4f} ms "
            f"({flops / k_ms / 1e9:.1f} TFLOP/s), torch.matmul f32 {l_ms:.4f} ms "
            f"({flops / l_ms / 1e9:.1f} TFLOP/s); bound {b_ms:.4f} ms ({b_by}, "
            f"{100 * b_ms / k_ms:.1f}%); {smi}")
        del a, w, b, r
    check.done()

    # --- 3j. B4's int8 product body against its plain version ----------------------------
    # Every product shape of B4 at the timed batches (DeiT-S 512 x 197, ViT-H 64 x 257), and
    # vit_tiny's QKV (136 rows, N 192, K 64: a K step and a column tile past the edges) and a
    # ragged one, one product at a time through ops/cuda/layer_int8.py::gemm_s8 (the C body the
    # layer runs): int8 codes and row scales as a row quantization gives them, K-major int8
    # weights with column scales, + bias, f32 out. The output must equal the exact int32
    # product's dequant bit for bit (int sums are exact in any order, and the dequant is the
    # same f32 multiplies and add); the timed shapes also run beside torch._int_mm (cuBLASLt
    # int8) on the same operands, a yardstick only.
    check = Checks("phase 3j (B4's int8 product body vs plain)")
    gen_j = torch.Generator(device=dev).manual_seed(SEED + 5)  # drawn on the card

    def s8_operands(m, k, n):
        codes, rs = k8.rowquant_ref(torch.randn(m, k, generator=gen_j, device=dev))
        wt = torch.randint(-127, 128, (n, k), generator=gen_j, dtype=torch.int8, device=dev)
        ws = torch.rand(n, generator=gen_j, device=dev) * 2e-3 + 1e-4
        return codes, rs, wt, ws, 0.1 * torch.randn(n, generator=gen_j, device=dev)

    shapes_j = [("vit_tiny qkv", 136, 64, 192), ("ragged", 1000, 1280, 640)]
    for gname, gcfg, batch, s in (("deit_s", cfg, 512, 197), ("vit_h", hcfg, 64, 257)):
        d, kw, mm = gcfg.hidden_size, gcfg.attn_width, gcfg.mlp_dim
        shapes_j += [(f"{gname} batch {batch} S={s} {tag}", batch * s, k, n) for tag, (k, n) in
                     {"qkv": (d, 3 * kw), "o": (kw, d), "fc1": (d, mm), "fc2": (mm, d)}.items()]
    for tag, m, k, n in shapes_j:
        ops = s8_operands(m, k, n)
        n0 = k8.body_launches()
        got = k8.gemm_s8(*ops)
        torch.cuda.synchronize()
        ran = k8.body_launches() - n0
        exact = bool(torch.equal(got, k8.gemm_s8_ref(*ops)))
        line = (f"  int8 GEMM {tag} M={m} N={n} K={k}: wgmma s8 body launches {ran}; bit-equal "
                f"to the exact int product's dequant: {exact}")
        if "batch" in tag:
            wkn = ops[2].t().contiguous()  # torch._int_mm's [K, N]
            k_ms = time_ms(lambda: k8.gemm_s8(*ops))
            l_ms = time_ms(lambda: torch._int_mm(ops[0], wkn))
            tops = 2.0 * m * n * k / 1e9
            line += (f"; kernel {k_ms:.4f} ms ({tops / k_ms:.1f} TOP/s), torch._int_mm "
                     f"{l_ms:.4f} ms ({tops / l_ms:.1f} TOP/s); {smi}")
            del wkn
        log(line)
        check(exact and ran == 1 and got.shape == (m, n),
              f"int8 GEMM {tag}: bit-equal {exact}, s8 launches {ran}")
        del ops, got
    check.done()

    # --- 5. end to end: kernels vs plain PyTorch, launch counts -------------------------
    # B1-B5's attention launches per body and B2's launches by kind from here to phase
    # 5h's end, read in phase 6
    kl.reset_attention_body_counts()
    kl.reset_cls_launch_counts()
    rs = np.random.RandomState(SEED)

    def images(batch):
        u8 = torch.from_numpy(rs.randint(0, 256, (batch, 3, 224, 224), dtype=np.uint8)).to(dev)
        return u8

    def forward_fn(name, params, dt, u8):
        pcfg_cfg, pcfg, _ = presets[name]
        if pcfg is None:
            pix = ((u8.float() / 255.0 - 0.5) / 0.5).to(dt)
            return lambda: {"logits": vit_forward(params["backbone"], pix, pcfg_cfg)["logits"]}
        return lambda: serving_forward(params, u8, pcfg_cfg, pcfg)

    def cut_gap(out, pcfg):
        """Smallest gap between the k-th and (k+1)-th live score at any drop."""
        gaps = []
        for i, k in enumerate(pcfg.keep_schedule or (pcfg.top_k,)):
            sc = out["scores"][i].float()
            live = torch.isfinite(sc)
            if not k or not live.any():
                continue
            top = sc.masked_fill(~live, float("-inf")).topk(k + 1, dim=-1).values
            gaps.append((top[:, k - 1] - top[:, k]).min().item())
        return min(gaps, default=float("inf"))

    check = Checks("phase 5 (end to end)")
    u8 = images(64)
    wrappers = (kl.fused_vit_layer, kl.fused_vit_layer_cls_logits, kl.fused_vit_layer_bucketed)
    for k in wrappers:  # the counts of this path's run only
        k.launches = 0
    kg.reset_body_counts()  # the GEMM bodies' launches on the paths of phases 5-5f
    for dname, dt in dtypes.items():
        for name, (pc, pcfg, cpu_params) in presets.items():
            params = tree_to(cpu_params, dev, dt)
            fwd = forward_fn(name, params, dt, u8)
            n1, n2 = kl.fused_vit_layer.launches, kl.fused_vit_layer_cls_logits.launches
            n8 = kemb.fused_image_embed_u8.launches
            with kernel_mode("auto"):
                got = fwd()
            torch.cuda.synchronize()
            l1 = kl.fused_vit_layer.launches - n1
            l2 = kl.fused_vit_layer_cls_logits.launches - n2
            l8 = kemb.fused_image_embed_u8.launches - n8
            with plain_after_the_served_embed():
                ref = fwd()
            torch.cuda.synchronize()
            tag = f"{name} {dname}"
            # a served call: the embed once (B8a on the image), B1 x (L - 1), B2 once
            want = (L, 0, 0) if pcfg is None else (L - 1, 1, 1)
            check((l1, l2, l8) == want,
                  f"{tag}: launches B1={l1} B2={l2} embed={l8}, want {want}")
            lg, lr = got["logits"].float(), ref["logits"].float()
            check(lg.shape == (64, 100) and bool(torch.isfinite(lg).all()),
                  f"{tag}: logits not finite [64, 100]")
            d = (lg - lr).abs().max().item()
            agree = (lg.argmax(-1) == lr.argmax(-1)).float().mean().item()
            line = (f"  {tag}: launches B1={l1} B2={l2} embed={l8}; logits max_abs_err {d:.3e} "
                    f"(max|ref| {lr.abs().max().item():.3f}), argmax agree {agree:.3f}")
            same_masks = True
            if pcfg is not None:
                km, em = got["keep_masks"], ref["keep_masks"]
                same_masks = bool(torch.equal(km, em))
                frac = (km == em).all(-1).float().mean().item()
                line += (f"; keep masks equal {same_masks} (images x layers agreeing "
                         f"{frac:.4f}); min cut gap (plain) {cut_gap(ref, pcfg):.2e}")
                with kernel_mode("eager"):  # the whole eager route, the eager embed's (info)
                    whole = fwd()
                line += (f"; against the whole eager route: logits max_abs_err "
                         f"{(lg - whole['logits'].float()).abs().max().item():.3e}, images x "
                         f"layers agreeing "
                         f"{(km == whole['keep_masks']).all(-1).float().mean().item():.4f}")
            log(line)
            if dt == torch.float32:
                check(same_masks, f"{tag}: keep masks differ")
                check(d <= F32_ATOL + 1e-4 * lr.abs().max().item(), f"{tag}: logits differ")
            elif name == "headline":
                # the only drop comes before any layer kernel, on one embedding: masks must agree
                check(same_masks, f"{tag}: keep masks differ")
    # vit_tiny (hd 16, S 17) through the same entry points: dense vit_forward (B1 x 3) and
    # the headline, 8 of 16 patches kept before layer 0, through serving_forward (B1 x 2 +
    # B2); weights and images from seeds of their own
    tcfg = vit_tiny(num_labels=100)
    tiny = init_pruned_vit_params(tcfg, PruneConfig(mode="topk_prog", predictor="cls_mlp"),
                                  torch.Generator().manual_seed(SEED + 3), "cpu")
    t_gain = PREDICTOR_GAIN * math.sqrt(384 / tcfg.hidden_size)
    tiny["predictor"]["mlp"] = {name: {"w": p["w"] * t_gain, "b": p["b"]}
                                for name, p in tiny["predictor"]["mlp"].items()}
    u8t = torch.from_numpy(np.random.RandomState(SEED + 3).randint(
        0, 256, (64, 3, tcfg.image_size, tcfg.image_size), dtype=np.uint8)).to(dev)
    t_head = PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention", top_k=8)
    for dname, dt in dtypes.items():
        tparams = tree_to(tiny, dev, dt)
        pix_t = ((u8t.float() / 255.0 - 0.5) / 0.5).to(dt)
        for name, pcfg, fwd, want in (
                ("dense", None,
                 lambda: {"logits": vit_forward(tparams["backbone"], pix_t, tcfg)["logits"]},
                 (tcfg.num_layers, 0, 0)),
                ("headline", t_head, lambda: serving_forward(tparams, u8t, tcfg, t_head),
                 (tcfg.num_layers - 1, 1, 1))):
            n1, n2 = kl.fused_vit_layer.launches, kl.fused_vit_layer_cls_logits.launches
            n8 = kemb.fused_image_embed_u8.launches
            with kernel_mode("auto"):
                got = fwd()
            torch.cuda.synchronize()
            l1 = kl.fused_vit_layer.launches - n1
            l2 = kl.fused_vit_layer_cls_logits.launches - n2
            l8 = kemb.fused_image_embed_u8.launches - n8
            with plain_after_the_served_embed():
                ref = fwd()
            torch.cuda.synchronize()
            tag = f"vit_tiny {name} {dname}"
            check((l1, l2, l8) == want,
                  f"{tag}: launches B1={l1} B2={l2} embed={l8}, want {want}")
            lg, lr = got["logits"].float(), ref["logits"].float()
            check(lg.shape == (64, 100) and bool(torch.isfinite(lg).all()),
                  f"{tag}: logits not finite [64, 100]")
            d = (lg - lr).abs().max().item()
            line = (f"  {tag}: launches B1={l1} B2={l2}; logits max_abs_err {d:.3e} (max|ref| "
                    f"{lr.abs().max().item():.3f}), argmax agree "
                    f"{(lg.argmax(-1) == lr.argmax(-1)).float().mean().item():.3f}")
            same_masks = True
            if pcfg is not None:
                same_masks = bool(torch.equal(got["keep_masks"], ref["keep_masks"]))
                line += (f"; keep masks equal {same_masks}; min cut gap (plain) "
                         f"{cut_gap(ref, pcfg):.2e}")
                # the only drop comes before any layer kernel, on one embedding: masks must agree
                check(same_masks, f"{tag}: keep masks differ")
            log(line)
            if dt == torch.float32:
                check(d <= F32_ATOL + 1e-4 * lr.abs().max().item(), f"{tag}: logits differ")
    launches = {"b1": kl.fused_vit_layer.launches, "b2": kl.fused_vit_layer_cls_logits.launches}
    log(f"  progressive path launches: B1 {launches['b1']}, B2 {launches['b2']}, "
        f"B3 {kl.fused_vit_layer_bucketed.launches}")
    check(launches["b1"] > 0 and launches["b2"] > 0, "a kernel of the path never launched")
    check.done()

    # --- 5b. re-decide path end to end: kernels vs plain PyTorch, launch counts ----------
    redecide = {  # name -> (prune config, kernel that runs each layer)
        "topk50": (PruneConfig(mode="topk", predictor="cls_mlp", top_k=98), "b3"),
        "mask_budget50": (PruneConfig(mode="mask", predictor="cls_mlp", mask_budget=98), "b3"),
        "mask": (PruneConfig(mode="mask", predictor="cls_mlp"), "b1"),
        "random50": (PruneConfig(mode="random", predictor="cls_mlp", top_k=98), "b3"),
    }

    def calibrated(params, pix):
        """Per-layer median-score thresholds from a measure_only probe on the
        plain path (dense execution, masks and scores per layer)."""
        probe = PruneConfig(mode="mask", predictor="cls_mlp", measure_only=True)
        with kernel_mode("eager"):
            scores = pruned_vit_forward(params, pix, cfg, probe)["scores"]
        return tuple(float(np.median(sc.float().cpu().numpy())) for sc in scores)

    def redecide_fn(name, params, pix, thresholds):
        pcfg = redecide[name][0]
        if pcfg.mode == "mask":
            pcfg = pcfg.replace(mlp_threshold=thresholds)

        def fwd():
            gen_r = torch.Generator(device=dev).manual_seed(SEED)  # the same noise every run
            return pruned_vit_forward(params, pix, cfg, pcfg, generator=gen_r)
        return fwd, pcfg

    def rank_gap(sc, k):
        """Smallest gap between the k-th and (k+1)-th largest finite score."""
        top = sc.topk(k + 1, dim=-1).values
        live = torch.isfinite(top[:, k])
        return (top[:, k - 1] - top[:, k])[live].min().item() if live.any() else float("inf")

    def decision_gap(out, pcfg):
        """Smallest gap between a score and its threshold or rank cut."""
        gaps = [float("inf")]
        for i, sc in enumerate(out["scores"].float()):
            if pcfg.mode == "topk":
                gaps.append(rank_gap(sc, pcfg.top_k))
            elif pcfg.mode == "mask":
                thr = pcfg.mlp_threshold[i]
                gaps.append((sc - thr).abs().min().item())
                if pcfg.mask_budget is not None:
                    gaps.append(rank_gap(sc.masked_fill(sc < thr, float("-inf")),
                                         pcfg.mask_budget))
        return min(gaps)

    check = Checks("phase 5b (re-decide end to end)")
    for k in wrappers:  # the counts of this path's run only
        k.launches = 0
    for dname, dt in dtypes.items():
        params = tree_to(base, dev, dt)
        pix = ((u8.float() / 255.0 - 0.5) / 0.5).to(dt)
        thresholds = calibrated(params, pix)
        log(f"  {dname} calibrated mlp_threshold per layer: "
            + ", ".join(f"{t:.4f}" for t in thresholds))
        for name, (_, kname) in redecide.items():
            fwd, pcfg = redecide_fn(name, params, pix, thresholds)
            n1, n3 = kl.fused_vit_layer.launches, kl.fused_vit_layer_bucketed.launches
            with kernel_mode("auto"):
                got = fwd()
            torch.cuda.synchronize()
            l1 = kl.fused_vit_layer.launches - n1
            l3 = kl.fused_vit_layer_bucketed.launches - n3
            with kernel_mode("eager"):
                ref = fwd()
            torch.cuda.synchronize()
            tag = f"{name} {dname}"
            want = (L, 0) if kname == "b1" else (0, L)
            check((l1, l3) == want, f"{tag}: launches B1={l1} B3={l3}, want {want}")
            lg, lr = got["logits"].float(), ref["logits"].float()
            check(lg.shape == (64, 100) and bool(torch.isfinite(lg).all()),
                  f"{tag}: logits not finite [64, 100]")
            d = (lg - lr).abs().max().item()
            km, em = got["keep_masks"], ref["keep_masks"]
            same_masks = bool(torch.equal(km, em))
            kept = km[:, :, 1:].float().mean().item()
            log(f"  {tag}: launches B1={l1} B3={l3}; logits max_abs_err {d:.3e} (max|ref| "
                f"{lr.abs().max().item():.3f}); keep masks equal {same_masks} (images x layers "
                f"agreeing {(km == em).all(-1).float().mean().item():.4f}); patches kept "
                f"{kept:.3f}; min threshold/cut gap (plain) {decision_gap(ref, pcfg):.2e}")
            if dt == torch.float32:
                check(same_masks, f"{tag}: keep masks differ")
                check(d <= F32_ATOL + 1e-4 * lr.abs().max().item(), f"{tag}: logits differ")
            else:
                # layer 0 decides from the embedding, before any kernel; the
                # random masks never depend on a layer's output
                check(bool(torch.equal(km[0], em[0])), f"{tag}: layer-0 keep masks differ")
                if name == "random50":
                    check(same_masks, f"{tag}: keep masks differ")
            if pcfg.mode in ("topk", "random") or pcfg.mask_budget is not None:
                budget = pcfg.mask_budget if pcfg.mode == "mask" else pcfg.top_k
                most = int(km.sum(-1).max())
                check(most <= budget + 1, f"{tag}: {most} kept, over the budget {budget} + 1")
    launches["b1_redecide"] = kl.fused_vit_layer.launches
    launches["b3"] = kl.fused_vit_layer_bucketed.launches
    log(f"  re-decide path launches: B1 {launches['b1_redecide']}, "
        f"B2 {kl.fused_vit_layer_cls_logits.launches}, B3 {launches['b3']}")
    check(launches["b3"] > 0 and launches["b1_redecide"] > 0, "a kernel of the path never launched")
    check.done()

    # --- 5c. int8 serving end to end: kernels vs plain PyTorch, launch counts ------------
    # The kernel path (B4, the TPU kernel's numerics) and the plain path (ops/quant.py's)
    # are two roundings of one int8 scheme. Where float noise puts an activation near
    # k + 0.5 they pick neighbouring codes, a whole quantization step apart (phase 3c
    # counts such codes), so from the first int8 layer on they drift apart by steps of
    # int8's own error, and a later keep decision near its cut can go either way. So:
    # decisions taken before any int8 layer (the headline's drop, the first drop of
    # every schedule, every re-decide layer 0, random50's noise) must agree exactly;
    # the kernel path must be as accurate an int8 as the plain path: its logits'
    # distance from float within 10% of the plain path's (relative, over the batch:
    # a wrong scale, bias or rounding would add to it, while the codes the routes
    # round apart only move which samples of the same error they draw); and where
    # no decision depends on an int8 layer (dense, headline, random50) the int8
    # logits must be within 5% of float (the JAX package's bound,
    # tests/test_pallas.py:241).
    check = Checks("phase 5c (int8 end to end)")
    wrappers = (*wrappers, k8.fused_vit_layer_int8)

    def counts():
        return tuple(k.launches for k in wrappers)  # B1, B2, B3, B4

    def compare(tag, got, ref, fl, fixed_layers, batch=64):
        """got / ref: the int8 kernel / plain path's outputs, fl the float plain
        path's logits; keep masks must agree on the first `fixed_layers` layers
        (all of them: None)."""
        lg, lr = got["logits"].float(), ref["logits"].float()
        check(lg.shape == (batch, 100) and bool(torch.isfinite(lg).all()),
              f"{tag}: logits not finite [{batch}, 100]")
        routes, int8_err, kernel_err = rel_err(lg, lr), rel_err(lr, fl), rel_err(lg, fl)
        agree = (lg.argmax(-1) == lr.argmax(-1)).float().mean().item()
        line = (f"logits kernel vs plain {routes:.4f} relative (max_abs {(lg - lr).abs().max():.3e}"
                f"), int8 vs float {int8_err:.4f} (plain) {kernel_err:.4f} (kernel), argmax "
                f"agree {agree:.3f}")
        check(kernel_err > 0.0, f"{tag}: the kernel path's logits equal float's")
        check(abs(kernel_err - int8_err) <= 0.1 * int8_err,
              f"{tag}: int8 from float {kernel_err:.4f} on the kernel path, {int8_err:.4f} on "
              f"the plain path")
        if fixed_layers is None:
            check(max(kernel_err, int8_err) < 0.05, f"{tag}: int8 over 5% from float")
        if "keep_masks" in got:
            km, em = got["keep_masks"], ref["keep_masks"]
            line += (f"; keep masks equal {bool(torch.equal(km, em))} (images x layers "
                     f"agreeing {(km == em).all(-1).float().mean().item():.4f})")
            n_fixed = len(km) if fixed_layers is None else fixed_layers
            check(bool(torch.equal(km[:n_fixed], em[:n_fixed])),
                  f"{tag}: keep masks differ in the first {n_fixed} layers")
        return line

    for k in wrappers:  # the counts of this path's run only
        k.launches = 0
    k8.reset_body_launches()
    for dname, dt in dtypes.items():
        for name, (pc, pcfg, cpu_params) in presets.items():
            params = tree_to(cpu_params, dev, dt)
            if pcfg is None:
                pix = ((u8.float() / 255.0 - 0.5) / 0.5).to(dt)

                def fwd(logits_only=False, params=params, pix=pix, pc=pc):
                    return {"logits": vit_forward(params["backbone"], pix, pc)["logits"]}
            else:
                def fwd(logits_only=False, params=params, pc=pc, pcfg=pcfg):
                    return serving_forward(params, u8, pc, pcfg, logits_only=logits_only)
            with plain_after_the_served_embed():
                fl = fwd()["logits"]  # float (quant 'none'), the plain path
            with quant_mode("int8"):
                c0 = counts()
                with kernel_mode("auto"):
                    got = fwd()
                torch.cuda.synchronize()
                c1 = counts()
                with plain_after_the_served_embed():
                    ref = fwd()
                if pcfg is not None:
                    with kernel_mode("auto"):
                        tail = fwd(logits_only=True)  # the last layer as the float B2
                torch.cuda.synchronize()
                c2 = counts()
            tag = f"{name}_int8 {dname}"
            n = tuple(b - a for a, b in zip(c0, c1))
            check(n == (0, 0, 0, L), f"{tag}: launches B1/B2/B3/B4 {n}, want (0, 0, 0, {L})")
            if pcfg is None or pcfg.keep_schedule is None:
                fixed = None  # dense, headline: no decision follows an int8 layer
            else:  # the masks before the second drop are decided before any layer
                fixed = next(i for i, k in enumerate(pcfg.keep_schedule) if i and k)
            log(f"  {tag}: launches B4={n[3]}; " + compare(tag, got, ref, fl, fixed))
            if pcfg is not None:
                n = tuple(b - a for a, b in zip(c1, c2))
                rel = rel_err(tail["logits"], got["logits"])
                same = bool(torch.equal(tail["keep_masks"], got["keep_masks"]))
                log(f"  {tag} logits_only (float B2 tail): launches B4={n[3]} B2={n[1]}; keep "
                    f"masks equal {same}; logits {rel:.4f} relative from the int8 last layer's")
                check(n == (0, 1, 0, L - 1), f"{tag} logits_only: launches B1/B2/B3/B4 {n}, "
                      f"want (0, 1, 0, {L - 1})")
                check(same and rel < 0.05, f"{tag} logits_only: masks or logits differ")
        params = tree_to(base, dev, dt)
        pix = ((u8.float() / 255.0 - 0.5) / 0.5).to(dt)
        with quant_mode("int8"):
            thresholds = calibrated(params, pix)  # int8 medians
        for name in redecide:
            fwd, pcfg = redecide_fn(name, params, pix, thresholds)
            with kernel_mode("eager"):
                fl = fwd()["logits"]  # float, the plain path
            with quant_mode("int8"):
                c0 = counts()
                with kernel_mode("auto"):
                    got = fwd()
                torch.cuda.synchronize()
                c1 = counts()
                with kernel_mode("eager"):
                    ref = fwd()
                torch.cuda.synchronize()
            tag = f"{name}_int8 {dname}"
            n = tuple(b - a for a, b in zip(c0, c1))
            check(n == (0, 0, 0, L), f"{tag}: launches B1/B2/B3/B4 {n}, want (0, 0, 0, {L})")
            # layer 0 decides from the embedding; random50's noise never reads a layer
            line = compare(tag, got, ref, fl, None if name == "random50" else 1)
            log(f"  {tag}: launches B4={n[3]}; {line}; min threshold/cut gap (plain) "
                f"{decision_gap(ref, pcfg):.2e}")
    launches["b4"] = k8.fused_vit_layer_int8.launches
    launches["b4_s8"] = k8.body_launches()
    s8_products_since(0, "phase 5c")
    launches["b2"] += kl.fused_vit_layer_cls_logits.launches
    log(f"  int8 path launches: B1 {kl.fused_vit_layer.launches}, B2 "
        f"{kl.fused_vit_layer_cls_logits.launches} (the float tail), B3 "
        f"{kl.fused_vit_layer_bucketed.launches}, B4 {launches['b4']}")
    check(launches["b4"] > 0, "a kernel of the path never launched")
    check.done()

    # --- 5d. the dense model's remaining routes end to end -----------------------------------
    # Every forward runs with encoder fusion on, in mode 'auto' (kernels) against 'eager'
    # (plain PyTorch), and its launches are counted. The head_mask route's MLP is B7 (f32
    # arithmetic) in 'auto' and a bf16 product in 'eager', and the encoder route's numerics
    # are B5's (normalised P, erf GELU, f32 residual), so in bf16 the two paths are two
    # roundings: checked finite, with the masks of decisions taken before any layer equal.
    check = Checks("phase 5d (head_mask, hidden states, encoder route, mha)")
    keys_5d = ("b1", "b2", "b3", "b4", "b5", "b6", "b7")
    snapshot = functools.partial(read_launches, keys_5d)

    def ran(c0):
        c1 = snapshot()
        return {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}

    def segments(pcfg, s, logits_only):
        """Non-empty fixed-length stretches of layers between the drops of
        the schedule (the last layer left to B2 under logits_only)."""
        sched = pcfg.keep_schedule or (pcfg.top_k,) + (0,) * (L - 1)
        cur, cuts = s, [0]
        for i, k in enumerate(sched):
            k = min(k, s - 1) if k else 0
            if k and k < cur - 1:
                cuts.append(i)
                cur = k + 1
        cuts.append(L - 1 if logits_only else L)
        return sum(1 for a, b in zip(cuts, cuts[1:]) if b > a)

    hm = torch.ones(L, cfg.num_heads)
    hm[:, 1] = 0.0  # head 1 off everywhere
    hm[3] = 0.0     # layer 3's attention off
    hm[5, 2] = 0.5
    reset_launches(keys_5d)  # the counts of this path's run only
    ka.reset_body_counts()
    kmlp.reset_body_counts()
    for dname, dt in dtypes.items():
        pix = ((u8.float() / 255.0 - 0.5) / 0.5).to(dt)
        dense_p = tree_to(base, dev, dt)
        bb, hmd = dense_p["backbone"], hm.to(dev, dt)
        routes = {  # name -> (forward, launches wanted in 'auto')
            "head_mask": (lambda: vit_forward(bb, pix, cfg, head_mask=hmd), {"b7": L}),
            "hidden_states": (lambda: vit_forward(bb, pix, cfg, output_hidden_states=True),
                              {"b1": L}),
            "dense": (lambda: vit_forward(bb, pix, cfg), {"b5": 1}),
            "none": (lambda: pruned_vit_forward(dense_p, pix, cfg,
                                                PruneConfig(mode="none", predictor="cls_mlp")),
                     {"b5": 1}),
        }
        for name in ("headline", "composed", "ultra"):
            pc, pcfg, cpu_params = presets[name]
            routes[name] = (functools.partial(serving_forward, tree_to(cpu_params, dev, dt), u8,
                                              pc, pcfg),
                            {"b5": segments(pcfg, pc.seq_len, True), "b2": 1})
        outs = {}
        for name, (fwd, want) in routes.items():
            with encoder_fusion(True):
                c0 = snapshot()
                with kernel_mode("auto"):
                    got = fwd()
                torch.cuda.synchronize()
                n = ran(c0)
                with plain_after_the_served_embed():
                    ref = fwd()
                torch.cuda.synchronize()
            outs[name] = got
            tag = f"{name} {dname}"
            check(n == want, f"{tag}: launches {n}, want {want}")
            lg, lr = got["logits"].float(), ref["logits"].float()
            check(lg.shape == (64, 100) and bool(torch.isfinite(lg).all()),
                  f"{tag}: logits not finite [64, 100]")
            d = (lg - lr).abs().max().item()
            line = (f"  {tag}: launches {n}; logits max_abs_err {d:.3e} (max|ref| "
                    f"{lr.abs().max().item():.3f}), relative {rel_err(lg, lr):.4f}")
            same_masks = True
            if "keep_masks" in got and name != "none":
                km_, em = got["keep_masks"], ref["keep_masks"]
                same_masks = bool(torch.equal(km_, em))
                line += f"; keep masks equal {same_masks}"
                # the first drop is decided from the embedding, before any layer
                check(bool(torch.equal(km_[0], em[0])), f"{tag}: first keep masks differ")
            if name == "hidden_states":
                hs = max((g.float() - r.float()).abs().max().item()
                         for g, r in zip(got["hidden_states"], ref["hidden_states"]))
                check(len(got["hidden_states"]) == L + 1, f"{tag}: {len(got['hidden_states'])} "
                      f"hidden states")
                line += f"; {L + 1} hidden states, max_abs_err {hs:.3e}"
            log(line)
            if dt == torch.float32:
                check(same_masks, f"{tag}: keep masks differ")
                check(d <= F32_ATOL + 1e-4 * lr.abs().max().item(), f"{tag}: logits differ")
            elif "b5" in want:
                # bf16: the same route with B5's plain version in the kernel's place, every
                # other launch as it was; held on the images whose keep masks agree at every
                # layer (a score within one rounding of the cut may pick another token)
                real, c1 = kmod.fused_vit_encoder, snapshot()
                kmod.fused_vit_encoder = kmod.fused_vit_encoder_ref
                try:
                    with encoder_fusion(True), kernel_mode("auto"):
                        alt = fwd()
                finally:
                    kmod.fused_vit_encoder = real
                    for k, w in kernel_wrappers().items():  # comparison launches do not count
                        w.launches = c1.get(k, w.launches)
                la = alt["logits"].float()
                agree = torch.ones(lg.shape[0], dtype=torch.bool, device=dev)
                if "keep_masks" in got:
                    agree = (got["keep_masks"] == alt["keep_masks"]).flatten(2).all(-1).all(0)
                n_agree = int(agree.sum())
                d5 = (lg - la)[agree].abs().max().item() if n_agree else float("inf")
                tol = bf16_tol(la)
                log(f"    against B5's plain version in the route: keep masks agree on {n_agree}"
                    f"/{lg.shape[0]} images, logits max_abs_err there {d5:.3e} (tol {tol:.1e})")
                check(n_agree * 2 >= lg.shape[0] and d5 <= tol,
                      f"{tag}: B5 route against its plain version: {n_agree} images agree, "
                      f"err {d5:.3e}")
        for name in ("dense", "headline"):  # int8 under fusion: the float B5 route
            fwd = routes[name][0]
            with encoder_fusion(True), quant_mode("int8"), kernel_mode("auto"):
                c0 = snapshot()
                got = fwd()
                torch.cuda.synchronize()
                n = ran(c0)
            want = routes[name][1]
            same = bool(torch.equal(got["logits"], outs[name]["logits"]))
            log(f"  {name}_int8 {dname} (fusion): launches {n}; logits equal to float {same}")
            check(n == want and same, f"{name}_int8 {dname}: launches {n} (want {want}) or "
                  f"logits not the float route's")
        # mha with use_kernel in mode 'kernel': the attention core as B6 (f32 arithmetic;
        # the plain mha's softmax runs in the input dtype, so bf16 is two roundings)
        attn = tree_to(geometries["deit_s"][1]["attn"], dev, dt)
        h = torch.randn(64, 197, cfg.hidden_size, generator=gen).to(dev, dt)
        c0 = snapshot()
        with kernel_mode("kernel"):
            got = mha(h, attn, cfg.num_heads, use_kernel=True)
        torch.cuda.synchronize()
        n = ran(c0)
        ref = mha(h, attn, cfg.num_heads)
        d, rel = (got.float() - ref.float()).abs().max().item(), rel_err(got, ref)
        log(f"  mha(use_kernel) {dname}: launches {n}; against the plain mha max_abs_err "
            f"{d:.3e}, relative {rel:.2e}")
        close = d <= F32_ATOL if dt == torch.float32 else rel < 0.02
        check(n == {"b6": 1} and bool(torch.isfinite(got).all()) and close,
              f"mha(use_kernel) {dname}: launches {n} or err {d:.3e} / {rel:.2e}")
    launches.update(read_launches(("b5", "b6", "b7")))
    # B6 and B7 per body: the bfloat16 forwards on the tensor-core bodies (DeiT-S's shapes
    # are theirs), the float32 ones on B6's and B7's split bodies (no f32 launch on an FMA
    # body)
    bodies67 = {"b6": ka.body_counts(), "b7": kmlp.body_counts()}
    log(f"  phase 5d launches per body: B6 {bodies67['b6']}, B7 {bodies67['b7']}")
    for k, f32_body in (("b6", "split"), ("b7", "split")):
        n = bodies67[k]
        check(n["wgmma"] > 0 and n[f32_body] > 0 and n["wgmma"] + n[f32_body] == launches[k]
              and sum(n.values()) == launches[k], f"{k.upper()} bodies {n} on {launches[k]} launches")
    launches["b1"] += kl.fused_vit_layer.launches
    launches["b2"] += kl.fused_vit_layer_cls_logits.launches
    log("  phase 5d launches: " + ", ".join(f"{k.upper()} {n}" for k, n in snapshot().items()))
    check(all(launches[k] > 0 for k in ("b5", "b6", "b7")), "a kernel of the path never launched")
    check.done()

    # --- 5e. ViT-H/14 end to end: kernels vs plain PyTorch, launch counts -----------------
    # Full width and depth (32 layers), random weights; f32 at batch 4 and bf16 at batch 32,
    # mode 'auto' against mode 'eager', as phases 5, 5b and 5c hold DeiT-S.
    check = Checks("phase 5e (ViT-H end to end)")
    h_presets = {  # name -> (config, prune config or None for dense, f32 params on the card)
        "dense": (hcfg, None, base_h),
        "headline": (hcfg, PruneConfig(mode="topk_prog", predictor="cls_mlp",
                                       loss="mse_attention", top_k=hn // 2), base_h),
        "composed": (hc_cfg, prune_cfg(composed_schedule(hn, hL)), pruned_h),
        "ultra": (hc_cfg, prune_cfg(ultra_schedule(hn, hL)), pruned_h),
        "topk50": (hcfg, PruneConfig(mode="topk", predictor="cls_mlp", top_k=hn // 2), base_h),
    }

    def h_forward(name, params, u8, logits_only=True):
        pc, pcfg, _ = h_presets[name]
        pix = ((u8.float() / 255.0 - 0.5) / 0.5).to(params["backbone"]["head"]["w"].dtype)
        if pcfg is None:
            return lambda: {"logits": vit_forward(params["backbone"], pix, pc)["logits"]}
        if pcfg.mode == "topk":
            return lambda: pruned_vit_forward(params, pix, pc, pcfg)
        return lambda: serving_forward(params, u8, pc, pcfg, logits_only=logits_only)

    h_params = {}

    def h_tree(tree, dt):
        """The f32 tree in dtype dt, converted once."""
        key = (id(tree), dt)
        if key not in h_params:
            h_params[key] = tree_to(tree, dev, dt)
        return h_params[key]

    want_h = {"dense": (hL, 0, 0, 0), "topk50": (0, 0, hL, 0)}  # B1, B2, B3, B4
    for k in wrappers:  # the counts of this path's run only
        k.launches = 0
    k8.reset_body_launches()
    for dname, dt, batch in (("float32", torch.float32, 4), ("bfloat16", torch.bfloat16, 32)):
        u8h = images(batch)
        for name, (pc, pcfg, f32_params) in h_presets.items():
            fwd = h_forward(name, h_tree(f32_params, dt), u8h)
            c0 = counts()
            with kernel_mode("auto"):
                got = fwd()
            torch.cuda.synchronize()
            n = tuple(b - a for a, b in zip(c0, counts()))
            with plain_after_the_served_embed():
                ref = fwd()
            torch.cuda.synchronize()
            tag = f"vit_h {name} {dname} batch {batch}"
            want = want_h.get(name, (hL - 1, 1, 0, 0))
            check(n == want, f"{tag}: launches B1/B2/B3/B4 {n}, want {want}")
            lg, lr = got["logits"].float(), ref["logits"].float()
            check(lg.shape == (batch, 100) and bool(torch.isfinite(lg).all()),
                  f"{tag}: logits not finite [{batch}, 100]")
            d = (lg - lr).abs().max().item()
            line = (f"  {tag}: launches B1/B2/B3/B4 {n}; logits max_abs_err {d:.3e} (max|ref| "
                    f"{lr.abs().max().item():.3f}), relative {rel_err(lg, lr):.2e}, argmax agree "
                    f"{(lg.argmax(-1) == lr.argmax(-1)).float().mean().item():.3f}")
            same_masks = True
            if pcfg is not None:
                km_, em = got["keep_masks"], ref["keep_masks"]
                same_masks = bool(torch.equal(km_, em))
                gap = (decision_gap(ref, pcfg) if pcfg.mode == "topk"
                       else cut_gap(ref, pcfg))
                line += (f"; keep masks equal {same_masks} (images x layers agreeing "
                         f"{(km_ == em).all(-1).float().mean().item():.4f}); min cut gap "
                         f"(plain) {gap:.2e}")
                # the first decision is taken from the embedding, before any kernel
                check(bool(torch.equal(km_[0], em[0])), f"{tag}: first keep masks differ")
            log(line)
            if dt == torch.float32:
                check(same_masks, f"{tag}: keep masks differ")
                check(d <= F32_ATOL + 1e-4 * lr.abs().max().item(), f"{tag}: logits differ")
        for name in ("dense", "headline"):  # int8 serving, held as phase 5c holds it
            pc, pcfg, f32_params = h_presets[name]
            fwd = h_forward(name, h_tree(f32_params, dt), u8h, logits_only=False)
            with plain_after_the_served_embed():
                fl = fwd()["logits"]  # float, the plain path
            with quant_mode("int8"):
                c0 = counts()
                with kernel_mode("auto"):
                    got = fwd()
                torch.cuda.synchronize()
                c1 = counts()
                with plain_after_the_served_embed():
                    ref = fwd()
                if pcfg is not None:
                    with kernel_mode("auto"):
                        tail = h_forward(name, h_tree(f32_params, dt), u8h)()
                torch.cuda.synchronize()
                c2 = counts()
            tag = f"vit_h {name}_int8 {dname} batch {batch}"
            n = tuple(b - a for a, b in zip(c0, c1))
            check(n == (0, 0, 0, hL), f"{tag}: launches B1/B2/B3/B4 {n}, want (0, 0, 0, {hL})")
            log(f"  {tag}: launches B4={n[3]}; " + compare(tag, got, ref, fl, None, batch))
            if pcfg is not None:
                n = tuple(b - a for a, b in zip(c1, c2))
                rel = rel_err(tail["logits"], got["logits"])
                same = bool(torch.equal(tail["keep_masks"], got["keep_masks"]))
                log(f"  {tag} logits_only (float B2 tail): launches B4={n[3]} B2={n[1]}; keep "
                    f"masks equal {same}; logits {rel:.4f} relative from the int8 last layer's")
                check(n == (0, 1, 0, hL - 1), f"{tag} logits_only: launches B1/B2/B3/B4 {n}, "
                      f"want (0, 1, 0, {hL - 1})")
                check(same and rel < 0.05, f"{tag} logits_only: masks or logits differ")
    # logged here only: the kernels line's launches are the DeiT-S paths' (phases 5-5d)
    h_launches = dict(zip(("b1", "b2", "b3", "b4"), counts()))
    log("  ViT-H path launches: " + ", ".join(f"{k.upper()} {v}" for k, v in h_launches.items()))
    check(all(v > 0 for v in h_launches.values()), "a kernel of the path never launched")
    s8_products_since(0, "phase 5e")
    check.done()

    # --- 5f. the served embed and the fused embed entry points end to end --------------------
    # The served embed (embed_from_u8 in mode 'auto': B8a reading the image, one launch a call)
    # against the eager route (mode 'eager'): in f32 within test_pallas.py's bound (the u8
    # normalisation rounds differently: 2e-4), in bf16 two roundings of one function (within
    # 1% relative over the batch); and bit for bit against embed_u8 (B8a on extract_patches,
    # CLS and registers concatenated). embed_fused (B8b) against the model's embed as before.
    # DeiT-S and ViT-H at batch 64, DINOv2-g at 518 px with its 4 registers at batch 16.
    from vit_pruning_tpu_torch.configs import dinov2_giant_reg

    check = Checks("phase 5f (the served embed; embed_u8 / embed_fused end to end)")
    b8 = (kemb.fused_patch_embed_u8, kemb.fused_patch_embed_f, kemb.fused_image_embed_u8)
    for k in b8:  # the counts of this path's run only
        k.launches = 0
    b8_bodies = {key: {"wgmma": 0, "split": 0} for key in ("b8a", "b8b", "b8a_image")}

    def bodies_of(key, fn):
        """fn's output, its launches per body added to b8_bodies[key]"""
        kemb.reset_body_counts()
        out = fn()
        for body, n_ in kemb.body_counts().items():
            b8_bodies[key][body] += n_
        return out

    dcfg = dinov2_giant_reg(num_labels=100)
    d_embed = init_vit_params(dcfg.replace(num_layers=1), torch.Generator().manual_seed(SEED + 5),
                              "cpu")["embed"]
    d_embed["patch"]["b"] = 0.1 * torch.randn(dcfg.hidden_size,
                                              generator=torch.Generator().manual_seed(SEED + 6))
    u8_518 = torch.from_numpy(rs.randint(0, 256, (16, 3, 518, 518), dtype=np.uint8)).to(dev)
    calls = 0
    u8 = images(64)
    for mname, (mcfg, m_embed, mu8) in {
            "deit_s": (cfg, base["backbone"]["embed"], u8),
            "vit_h": (hcfg, base_h["backbone"]["embed"], u8),
            "dinov2_g (518, 4 registers)": (dcfg, d_embed, u8_518)}.items():
        for dname, dt in dtypes.items():
            ep = tree_to(m_embed, dev, dt)
            pix = ((mu8.float() / 255.0 - 0.5) / 0.5).to(dt)
            with kernel_mode("auto"):
                served = bodies_of("b8a_image", lambda: embed_from_u8(mu8, ep, mcfg))
            with kernel_mode("eager"):
                eager_u = embed_from_u8(mu8, ep, mcfg)
            got_u = bodies_of("b8a", lambda: kemb.embed_u8(mu8, ep, mcfg))
            got_f = bodies_of("b8b", lambda: kemb.embed_fused(pix, ep, mcfg))
            want_f = embed(pix, ep, mcfg)
            torch.cuda.synchronize()
            calls += 1
            shape = (mu8.shape[0], mcfg.seq_len, mcfg.hidden_size)
            du = (served.float() - eager_u.float()).abs().max().item()
            df = (got_f.float() - want_f.float()).abs().max().item()
            same = bool(torch.equal(served, got_u))
            if dt == torch.float32:
                tol_u, tol_f = 2e-4, 1e-5 * float(want_f.abs().max()) + 1e-5
                ok = du <= tol_u and df <= tol_f
                bounds_ = f"(tol {tol_u:.1e}, {tol_f:.1e})"
            else:
                ok = rel_err(served, eager_u) < 0.01 and rel_err(got_f, want_f) < 0.01
                bounds_ = "(bf16: within 1% relative)"
            tag = f"{mname} {dname}"
            log(f"  {tag}: served (auto) vs eager embed_from_u8 max_abs_err {du:.3e}, relative "
                f"{rel_err(served, eager_u):.2e}; served bit-equal to embed_u8 {same}; "
                f"embed_fused vs embed max_abs_err {df:.3e}, relative {rel_err(got_f, want_f):.2e} "
                f"{bounds_}")
            check(served.shape == got_u.shape == got_f.shape == eager_u.shape == shape
                  and served.dtype == got_f.dtype == dt
                  and bool(torch.isfinite(served).all() and torch.isfinite(got_f).all()) and ok,
                  tag)
            check(same, f"{tag}: the served embed is not embed_u8's bit for bit")
        del pix
    del u8_518
    launches["b8a"], launches["b8b"], launches["b8a_image"] = (k.launches for k in b8)
    log(f"  embed path launches: B8a {launches['b8a']}, B8b {launches['b8b']}, B8a on the image "
        f"(served) {launches['b8a_image']} ({calls} calls each); by body B8a {b8_bodies['b8a']}, "
        f"B8b {b8_bodies['b8b']}, served {b8_bodies['b8a_image']} (bf16 weights: wgmma, f32: "
        f"split)")
    check(all(k.launches == calls for k in b8), "a kernel of the path did not launch once per call")
    for key in b8_bodies:  # half the calls in each dtype
        check(b8_bodies[key] == {"wgmma": calls // 2, "split": calls // 2},
              f"{key.upper()} bodies {b8_bodies[key]} on {calls} calls")
    check.done()

    # --- 5g. DeiT-S at 384 (S 577) end to end ---------------------------------------------
    serve_at_384(dev, base, cfg)

    # --- 5h. training at DeiT-S width through B1 and B5 under autograd ----------------------
    trained = train_path(dev, base, cfg)

    # --- 6. times at batch 512, bf16 (info) --------------------------------------------
    def device_breakdown(tag, fn, wall_ms, reps=3):
        """Device time per forward by kernel family (torch.profiler, CUDA
        activity only), and the idle share against the CUDA-event wall time."""
        from torch.profiler import ProfilerActivity, profile

        families = (("GEMM", ("gemm_bf16", "gemm_f32", "wgmma_gemm")), ("int8 GEMM", ("wgmma_s8",)),
                    ("attention", ("attention",)), ("MLP (B7)", ("mlp_kernel", "mlp_tc_kernel")),
                    ("LN", ("layer_norm_kernel",)),
                    ("row-quant", ("rowquant",)),
                    ("B3 rows", ("bucket_invert", "gather_rows", "expand_rows")))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        sums, other = {name: 0.0 for name, _ in families}, {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0.0) or 0.0
            fam = next((n for n, keys in families if any(k in ev.key for k in keys)), None)
            if fam:
                sums[fam] += us / 1e3 / reps
            elif us:
                other[ev.key[:48]] = us / 1e3 / reps
        busy = sum(sums.values()) + sum(other.values())
        if not busy:
            log(f"  {tag} device breakdown: not measured (the profiler saw no device time)")
            return None
        top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
        log(f"  {tag} device ms/forward: " + ", ".join(f"{k} {v:.3f}" for k, v in sums.items())
            + f", other {sum(other.values()):.3f} (top: "
            + "; ".join(f"{k} {v:.3f}" for k, v in top) + f"); busy {busy:.3f} of wall "
            f"{wall_ms:.3f}, idle share {max(0.0, 1 - busy / wall_ms):.3f}")
        return sums

    def attention_bodies_agree(phases: str) -> dict:
        """B1-B5's attention launches since the counters' last reset: the C
        counters per body equal to the wrappers' tally by kl.attention_body
        (the Python mirror of the C rule, which maps every bfloat16 launch to
        a wgmma body and every float32 launch to a split body). Returns the
        tally by kernel."""
        ran = kl.attention_body_counts()
        tally = {k: dict(v) for k, v in kl.attention_launches.items()}
        mirror = {b: sum(per[b] for per in tally.values()) for b in kl.ATTENTION_BODIES}
        log(f"  B1-B5's attention on phases {phases}, launches per body: C {ran}, the "
            f"wrappers' tally {mirror}; by kernel {tally}")
        if ran != mirror or not ran["wgmma_resident"]:
            raise AssertionError(f"phases {phases}: attention bodies {ran} against the mirror's "
                                 f"{mirror}")
        return tally

    # B1-B5's attention on phases 5-5h: every bf16 launch on a wgmma body, the streamed one
    # included (5e's S 257, 5g's S 577), as the mirror says
    attn_tally = attention_bodies_agree("5-5h")
    # B2's launches by kind on phases 5-5h: the C counters equal to the wrapper's tally by
    # the mirror of the C plan (every bf16 call three launches, every f32 call four), the
    # bf16 tail and every f32 kind among them
    b2_kinds, b2_tally = kl.cls_launch_counts(), dict(kl.cls_launches)
    log(f"  B2's launches on phases 5-5h by kind: C {b2_kinds}, the wrapper's tally {b2_tally}")
    if b2_kinds != b2_tally or not all(b2_kinds[k] for k in (
            "tail", "f32_split_planes", "f32_kv_attention_k_then_v", "f32_tail")):
        raise AssertionError(f"phase 6: B2's launches {b2_kinds} against the tally {b2_tally}")
    if not sum(per["wgmma_streamed"] for per in attn_tally.values()):
        raise AssertionError("phase 6: the streamed attention body never ran on phases 5-5h")
    # the f32 launches (5e's ViT-H at S 257, 5h's train steps) on both split bodies
    if not all(sum(per[b] for per in attn_tally.values()) for b in ("split_resident",
                                                                    "split_streamed")):
        raise AssertionError(f"phase 6: an f32 attention body never ran on phases 5-5h: "
                             f"{attn_tally}")
    dense_fam = None
    # which bf16 GEMM body ran the products of phases 5-5f: the wgmma body wherever TMA
    # can describe A and W; the WMMA body only for a product whose N is no multiple of 8
    bodies = kg.body_counts()
    log(f"  GEMM bodies on the paths of phases 5-5f: wgmma {bodies['wgmma']} launches, WMMA "
        f"{bodies['wmma']} launches, at (M, N, K) "
        + (", ".join(map(str, bodies["wmma_shapes"])) or "none"))
    if bodies["wgmma"] == 0 or any(n % 8 == 0 for _, n, _ in bodies["wmma_shapes"]):
        raise AssertionError(f"phase 6: a product TMA can describe took the WMMA body: {bodies}")
    # every f32 product of phases 5-5h on the split body, the only f32 body of gemm(): the
    # C counter equal to the ops' tally (B1 and B3 four a call, B5 four a layer; B2's run
    # in its own launches, counted by kind above)
    f32_tally = dict(kg.f32_products)
    log(f"  f32 products on the paths of phases 5-5h: split body {bodies['f32_split']} "
        f"launches, the ops' tally {f32_tally}")
    if (bodies["f32_split"] != sum(f32_tally.values())
            or not all(f32_tally.get(k) for k in ("b1", "b5"))):
        raise AssertionError(f"phase 6: f32 products {bodies['f32_split']} on the split body "
                             f"against the tally {f32_tally}")
    # DeiT-S is timed first, without ViT-H's bf16 copies and on an emptied allocator
    # cache: after phases 5e/5f, composed ran 25% slower here than alone in a process
    h_params.clear()
    torch.cuda.empty_cache()
    log(f"phase 6 (bf16, batch 512, CUDA events, mean of 10 after 3 warm-up; {smi})")
    bf = torch.bfloat16
    u8 = images(512)
    for name, (pc, pcfg, cpu_params) in presets.items():
        fwd = forward_fn(name, tree_to(cpu_params, dev, bf), bf, u8)

        def run(mode, fwd=fwd):
            with kernel_mode(mode):
                fwd()

        k_ms, p_ms = abba(lambda: run("auto"), lambda: run("eager"))
        log(f"  {name}: kernel path {k_ms:.3f} ms/batch ({512 / k_ms * 1e3:.0f} img/s), "
            f"plain path {p_ms:.3f} ms/batch ({512 / p_ms * 1e3:.0f} img/s)")
        if name in ("dense", "headline"):
            fam = device_breakdown(name, lambda: run("auto"), k_ms)
            dense_fam = fam if name == "dense" else dense_fam
    params = tree_to(base, dev, bf)
    pix = ((u8.float() / 255.0 - 0.5) / 0.5).to(bf)
    thresholds = calibrated(params, pix)  # at the timed shape, as bench.py probes
    for name in redecide:
        fwd, _ = redecide_fn(name, params, pix, thresholds)

        def run(mode, fwd=fwd):
            with kernel_mode(mode):
                fwd()

        k_ms, p_ms = abba(lambda: run("auto"), lambda: run("eager"))
        log(f"  re-decide {name}: kernel path {k_ms:.3f} ms/batch ({512 / k_ms * 1e3:.0f} "
            f"img/s), plain path {p_ms:.3f} ms/batch ({512 / p_ms * 1e3:.0f} img/s)")
        if name in ("topk50", "mask"):
            device_breakdown(f"re-decide {name}", lambda: run("auto"), k_ms)
    for name in ("dense", "headline", "ultra", "topk50"):  # int8 serving
        if name in presets:
            fwd = forward_fn(name, tree_to(presets[name][2], dev, bf), bf, u8)
        else:
            fwd, _ = redecide_fn(name, params, pix, thresholds)

        def run(mode, fwd=fwd):
            with kernel_mode(mode), quant_mode("int8"):
                fwd()

        k_ms, p_ms = abba(lambda: run("auto"), lambda: run("eager"))
        log(f"  {name}_int8: kernel path {k_ms:.3f} ms/batch ({512 / k_ms * 1e3:.0f} img/s), "
            f"plain path {p_ms:.3f} ms/batch ({512 / p_ms * 1e3:.0f} img/s)")
        if name in ("dense", "topk50"):
            device_breakdown(f"{name}_int8", lambda: run("auto"), k_ms)
    layers = params["backbone"]["layers"]
    q_ms = time_ms(lambda: layers_for(layers, "int8"))
    log(f"  weight quantization and B4's K-major layout, once per int8 forward (12 layers, bf16 "
        f"-> int8): {q_ms:.3f} ms")
    device_breakdown("weight quantization", lambda: layers_for(layers, "int8"), q_ms)

    def bound(flops: float, nbytes: float):
        """(least ms for the work on this card, what bounds it)."""
        t_op, t_mem = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")

    def layer_work(gcfg, rows: int, attn_rows2: int) -> float:
        """Operations of the layer's four products over `rows` rows and of
        QK^T and PV over sum_b(H * S_b^2) query-key pairs."""
        d, kw, m = gcfg.hidden_size, gcfg.attn_width, gcfg.mlp_dim
        return 2.0 * rows * (3 * d * kw + kw * d + 2 * d * m) + 4.0 * attn_rows2 * gcfg.head_dim

    def weight_bytes(tree) -> int:
        if isinstance(tree, dict):
            return sum(weight_bytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()

    kernel_ms, bounds = {}, {}
    lp = tree_to(geometries["deit_s"][1], dev, bf)
    f, h = tree_to(lnf, dev, bf), tree_to(head, dev, bf)
    for gname, s in (("deit_s", 197), ("deit_s", 99), ("composed", 131), ("composed", 33)):
        gcfg = geometries[gname][0]
        glp = tree_to(geometries[gname][1], dev, bf)
        x = torch.randn(512, s, gcfg.hidden_size, generator=gen).to(dev, bf)
        k_ms, p_ms = abba(lambda: kl.fused_vit_layer(x, glp, gcfg.num_heads),
                          lambda: kl.fused_vit_layer_ref(x, glp, gcfg.num_heads))
        with kernel_mode("eager"):
            e_ms = time_ms(lambda: vit_layer(x, glp, gcfg))
        b_ms, b_by = bound(layer_work(gcfg, 512 * s, 512 * gcfg.num_heads * s * s),
                           2 * x.numel() * x.element_size() + weight_bytes(glp))
        log(f"  B1 {gname} S={s}: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, "
            f"eager layer (bf16 cuBLAS) {e_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
        if (gname, s) == ("deit_s", 197):
            kernel_ms["b1"], bounds["b1"] = (k_ms, p_ms, e_ms), (b_ms, b_by)
    def cls_work(gcfg, b: int, s: int, labels: int = 100) -> float:
        """B2's operations: the K/V product over every token, q, O, fc1, fc2 and the
        classifier on the CLS rows, QK^T and PV of the CLS query."""
        d, kw, m = gcfg.hidden_size, gcfg.attn_width, gcfg.mlp_dim
        return (2.0 * b * s * d * 2 * kw + 2.0 * b * (d * kw + kw * d + 2 * d * m + d * labels)
                + 4.0 * b * gcfg.num_heads * s * gcfg.head_dim)

    b2_lines = {}
    for gname, s in (("deit_s", 99), ("deit_s", 197), ("composed", 33), ("composed", 17)):
        gcfg = geometries[gname][0]
        glp = tree_to(geometries[gname][1], dev, bf)
        x = torch.randn(512, s, gcfg.hidden_size, generator=gen).to(dev, bf)
        k_ms, p_ms = abba(
            lambda: kl.fused_vit_layer_cls_logits(x, glp, f, h, gcfg.num_heads),
            lambda: kl.fused_vit_layer_cls_logits_ref(x, glp, f, h, gcfg.num_heads))
        lib_fn = cls_library(gcfg, glp, f, h)
        c_ms = time_ms(lambda: lib_fn(x))
        c_err = rel_err(lib_fn(x), kl.fused_vit_layer_cls_logits_ref(x, glp, f, h, gcfg.num_heads))

        def eager_cls():  # the plain path's tail: whole last layer, LN_f, head on CLS
            y = layer_norm(vit_layer(x, glp, gcfg), f, gcfg.layernorm_eps)[:, 0]
            return y @ h["w"] + h["b"]

        with kernel_mode("eager"):
            e_ms = time_ms(eager_cls)
        nbytes = (x.numel() * x.element_size() + 512 * 100 * 2 + weight_bytes(glp)
                  + weight_bytes(f) + weight_bytes(h))
        b_ms, b_by = bound(cls_work(gcfg, 512, s), nbytes)
        log(f"  B2 {gname} S={s}: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, CLS-only "
            f"library composition {c_ms:.3f} ms (relative {c_err:.2e} from the plain version), "
            f"eager last layer + LN_f + head {e_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}, "
            f"{100 * b_ms / k_ms:.1f}%)")
        b2_lines[f"{gname}_s{s}"] = {"ms": k_ms, "library_ms": c_ms, "eager_whole_layer_ms": e_ms}
        if (gname, s) == ("deit_s", 99):
            kernel_ms["b2"], bounds["b2"] = (k_ms, p_ms, c_ms), (b_ms, b_by)
    x = torch.randn(512, 197, cfg.hidden_size, generator=gen).to(dev, bf)
    mask = random_mask(512, 197, torch.full((512,), 99))  # topk50's bucket, every image full
    dest = compact_dest(mask)
    k_ms, p_ms = abba(
        lambda: kl.fused_vit_layer_bucketed(x, lp, dest, mask, 99, cfg.num_heads),
        lambda: kl.fused_vit_layer_bucketed_ref(x, lp, dest, mask, 99, cfg.num_heads))
    with kernel_mode("eager"):  # index gather, cuBLAS bf16 masked layer at 99, scatter
        e_ms = time_ms(lambda: tp.bucketed_masked_layer(x, lp, mask, cfg, cap_hint=99))
    counts = mask.sum(-1).long()
    b_ms, b_by = bound(layer_work(cfg, int(counts.sum()), cfg.num_heads * int((counts ** 2).sum())),
                       2 * x.numel() * x.element_size() + dest.numel() * 5 + weight_bytes(lp))
    log(f"  B3 deit_s S=197 cap=99: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, eager "
        f"bucketed layer {e_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
    kernel_ms["b3"], bounds["b3"] = (k_ms, p_ms, e_ms), (b_ms, b_by)

    def bound_int8(gcfg, rows: int, attn_pairs: int, nbytes: float):
        """int8 products at the int8 peak plus attention at the bf16 peak,
        against the bytes; (least ms, what bounds it)."""
        d, kw, m = gcfg.hidden_size, gcfg.attn_width, gcfg.mlp_dim
        ops = 2.0 * rows * (3 * d * kw + kw * d + 2 * d * m)
        t_op = (ops / PEAK_INT8_OPS + 4.0 * attn_pairs * gcfg.head_dim / PEAK_BF16_FLOPS) * 1e3
        t_mem = nbytes / PEAK_HBM_BYTES * 1e3
        return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")

    qlp = with_kmajor_int8_weights(quantize_layer_params(lp))  # as a forward lays them out
    for s in (197, 99):  # the dense length and the capacity of topk50's bucket
        x = torch.randn(512, s, cfg.hidden_size, generator=gen).to(dev, bf)
        k_ms, p_ms = abba(lambda: k8.fused_vit_layer_int8(x, qlp, cfg.num_heads),
                          lambda: k8.fused_vit_layer_int8_ref(x, qlp, cfg.num_heads))
        with kernel_mode("eager"):  # torch._int_mm for the four products, bf16 attention
            e_ms = time_ms(lambda: vit_layer(x, qlp, cfg, quant="int8"))
        b_ms, b_by = bound_int8(cfg, 512 * s, 512 * cfg.num_heads * s * s,
                                2 * x.numel() * x.element_size() + weight_bytes(qlp))
        log(f"  B4 deit_s S={s}: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, eager int8 "
            f"layer (torch._int_mm) {e_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
        if s == 197:
            kernel_ms["b4"], bounds["b4"] = (k_ms, p_ms, e_ms), (b_ms, b_by)

    # B5 (12 layers), B6 and B7 at the dense forward's shapes
    st = tree_to(stack_s, dev, bf)
    x = torch.randn(512, 197, cfg.hidden_size, generator=gen).to(dev, bf)
    k_ms, p_ms = abba(lambda: kmod.fused_vit_encoder(x, st, cfg.num_heads),
                      lambda: kmod.fused_vit_encoder_ref(x, st, cfg.num_heads))

    def eager_encoder():  # the plain path's layer loop, bf16 cuBLAS
        y = x
        for i in range(L):
            y = vit_layer(y, layer_slice(st, i), cfg)
        return y

    with kernel_mode("eager"):
        e_ms = time_ms(eager_encoder)
    flops = L * layer_work(cfg, 512 * 197, 512 * cfg.num_heads * 197 * 197)
    b_ms, b_by = bound(flops, 2 * x.numel() * x.element_size() + weight_bytes(st))
    log(f"  B5 deit_s 12 layers S=197: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, eager "
        f"layer loop {e_ms:.3f} ms; {flops:.3e} FLOP, bound {b_ms:.4f} ms ({b_by}, bf16 peak)")
    kernel_ms["b5"], bounds["b5"] = (k_ms, p_ms, e_ms), (b_ms, b_by)

    def bound_split(flops_bf16: float, flops_fp32: float, nbytes: float):
        """B6 / B7: the first product multiplies bf16 inputs, exact in f32, so
        bf16 tensor cores with f32 accumulation compute it; the second takes
        an unrounded f32 operand, which an exact split into three bf16 parts
        turns into three bf16 passes: the least of the FP32 rate and three
        times the bf16 work at the bf16 peak. (least ms, what bounds it)"""
        t_split = min(flops_fp32 / PEAK_FP32_FLOPS, 3 * flops_fp32 / PEAK_BF16_FLOPS)
        t_op = (flops_bf16 / PEAK_BF16_FLOPS + t_split) * 1e3
        t_mem = nbytes / PEAK_HBM_BYTES * 1e3
        return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")

    def within_bound(key, k_ms, b_ms):
        """B6 / B7 at their bound's share; a time under the least time the
        card could take means a wrong bound or a wrong time"""
        log(f"  {key.upper()} at {100 * b_ms / k_ms:.1f}% of its bound")
        if k_ms < b_ms:
            raise AssertionError(f"phase 6: {key.upper()} took {k_ms:.4f} ms, under its bound "
                                 f"{b_ms:.4f} ms")

    q, k, v = (torch.randn(512, cfg.num_heads, 197, cfg.head_dim, generator=gen).to(dev, bf)
               for _ in range(3))
    k_ms, p_ms = abba(lambda: ka.fused_attention(q, k, v), lambda: ka.fused_attention_ref(q, k, v))
    qf, kf, vf = q.float(), k.float(), v.float()
    e_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qf, kf, vf))
    half = 2.0 * q.numel() * 197  # QK^T on bf16 inputs, then PV on f32 P
    b_ms, b_by = bound_split(half, half, 4 * q.numel() * q.element_size())
    log(f"  B6 deit_s S=197 (512 x 6 heads): kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, "
        f"f32 scaled_dot_product_attention {e_ms:.3f} ms; {2 * half:.3e} FLOP, bound {b_ms:.4f} ms "
        f"({b_by}, QK^T at the bf16 peak, PV as three bf16 passes); kernel / f32 SDPA "
        f"{k_ms / e_ms:.3f}")
    within_bound("b6", k_ms, b_ms)
    kernel_ms["b6"], bounds["b6"] = (k_ms, p_ms, e_ms), (b_ms, b_by)
    # B1-B5's attention against bf16 SDPA at the same shape (info: SDPA normalises P in
    # another order and rounds it elsewhere, so it computes another function)
    s_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    log(f"  B1-B5's attention body in the dense forward: "
        + (f"{dense_fam['attention'] / L:.4f} ms a layer (device, 512 x 6 heads x S 197 x 64)"
           if dense_fam else "not measured")
        + f"; bf16 scaled_dot_product_attention at that shape {s_ms:.4f} ms (info, not the "
        f"same rounding)")
    del q, k, v, qf, kf, vf
    # past the resident limit: DeiT-S at 384 (S 577, K and V streamed), batch 128
    x = torch.randn(128, 577, cfg.hidden_size, generator=gen).to(dev, bf)
    k_ms, p_ms = abba(lambda: kl.fused_vit_layer(x, lp, cfg.num_heads),
                      lambda: kl.fused_vit_layer_ref(x, lp, cfg.num_heads), iters=5)
    with kernel_mode("eager"):
        e_ms = time_ms(lambda: vit_layer(x, lp, cfg), iters=5)
    b_ms, b_by = bound(layer_work(cfg, 128 * 577, 128 * cfg.num_heads * 577 * 577),
                       2 * x.numel() * x.element_size() + weight_bytes(lp))
    log(f"  B1 deit_s@384 S=577 (batch 128): kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, "
        f"eager layer (bf16 cuBLAS) {e_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
    q, k, v = (torch.randn(128, cfg.num_heads, 577, cfg.head_dim, generator=gen).to(dev, bf)
               for _ in range(3))
    k_ms, p_ms = abba(lambda: ka.fused_attention(q, k, v), lambda: ka.fused_attention_ref(q, k, v),
                      iters=5)
    qf, kf, vf = q.float(), k.float(), v.float()
    e_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qf, kf, vf), iters=5)
    half = 2.0 * q.numel() * 577
    b_ms, b_by = bound_split(half, half, 4 * q.numel() * q.element_size())
    log(f"  B6 deit_s@384 S=577 (128 x 6 heads, K/V streamed): kernel {k_ms:.3f} ms, plain "
        f"version {p_ms:.3f} ms, f32 scaled_dot_product_attention {e_ms:.3f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}); kernel / f32 SDPA {k_ms / e_ms:.3f}")
    within_bound("b6", k_ms, b_ms)
    del q, k, v, qf, kf, vf, x

    mlp = layer_slice(st, 0)["mlp"]
    w = (mlp["fc1"]["w"], mlp["fc1"]["b"], mlp["fc2"]["w"], mlp["fc2"]["b"])
    xm = torch.randn(512 * 197, cfg.hidden_size, generator=gen).to(dev, bf)
    k_ms, p_ms = abba(lambda: kmlp.fused_mlp(xm, *w), lambda: kmlp.fused_mlp_ref(xm, *w))
    with kernel_mode("eager"):
        e_ms = time_ms(lambda: mlp_block(xm, mlp))
    half = 2.0 * xm.shape[0] * cfg.hidden_size * cfg.mlp_dim  # x.W1 on bf16, then GELU.W2 on f32
    b_ms, b_by = bound_split(half, half, 2 * xm.numel() * xm.element_size() + weight_bytes(mlp))
    log(f"  B7 deit_s rows={xm.shape[0]}: kernel {k_ms:.3f} ms, plain version (f32 cuBLAS) "
        f"{p_ms:.3f} ms, eager mlp_block (bf16 cuBLAS + F.gelu) {e_ms:.3f} ms; {2 * half:.3e} "
        f"FLOP, bound {b_ms:.4f} ms ({b_by}, x.W1 at the bf16 peak, GELU.W2 as three bf16 "
        f"passes); kernel / plain version {k_ms / p_ms:.3f}")
    within_bound("b7", k_ms, b_ms)
    kernel_ms["b7"], bounds["b7"] = (k_ms, p_ms, e_ms), (b_ms, b_by)
    del xm

    # the head_mask forward (the mask-search route: B7 x 12 and the plain attention with
    # the head mask), kernels against plain PyTorch
    bb = tree_to(base, dev, bf)["backbone"]
    hmd = hm.to(dev, bf)
    pix = ((u8.float() / 255.0 - 0.5) / 0.5).to(bf)

    def run_head_mask(mode):
        with kernel_mode(mode):
            vit_forward(bb, pix, cfg, head_mask=hmd)

    k_ms, p_ms = abba(lambda: run_head_mask("auto"), lambda: run_head_mask("eager"))
    log(f"  head_mask forward (B7 x 12): kernel path {k_ms:.3f} ms/batch ({512 / k_ms * 1e3:.0f} "
        f"img/s), plain path {p_ms:.3f} ms/batch ({512 / p_ms * 1e3:.0f} img/s)")
    device_breakdown("head_mask", lambda: run_head_mask("auto"), k_ms)
    del bb

    for name in ("dense", "ultra"):  # the encoder route against the per-layer one (info)
        fwd = forward_fn(name, tree_to(presets[name][2], dev, bf), bf, u8)

        def run(on, fwd=fwd):
            with kernel_mode("auto"), encoder_fusion(on):
                fwd()

        f_ms, u_ms = abba(lambda: run(True), lambda: run(False))
        log(f"  {name}: encoder fusion on {f_ms:.3f} ms/batch ({512 / f_ms * 1e3:.0f} img/s), "
            f"off {u_ms:.3f} ms/batch ({512 / u_ms * 1e3:.0f} img/s)")
        if name == "dense":
            device_breakdown("dense, encoder fusion on", lambda: run(True), f_ms)

    # B8a / B8b at DeiT-S batch 512 and ViT-H batch 64: the kernel on the patch matrix, its
    # plain version, the library on the same patch matrix (the affine and cast, then one
    # cuBLAS addmm, then + pos), the entry point on the images (extract + kernel + CLS) and
    # the eager equivalent on the images (embed_from_u8 for B8a, the model's embed for B8b)
    scale, shift = 1.0 / (255.0 * VIT_STD), -VIT_MEAN / VIT_STD
    for mname, mcfg, mparams, batch in (("deit_s", cfg, base, 512), ("vit_h", hcfg, base_h, 64)):
        ep = tree_to(mparams["backbone"]["embed"], dev, bf)
        w, b, pos = ep["patch"]["w"], ep["patch"]["b"], ep["pos"][0][1:]
        u8b = u8[:batch] if batch <= len(u8) else images(batch)
        pix = ((u8b.float() / 255.0 - 0.5) / 0.5).to(bf)
        n_p, pd, d = mcfg.num_patches, mcfg.patch_dim, mcfg.hidden_size
        rows = batch * n_p
        const_bytes = (pd * d + d + n_p * d) * 2  # W, b, pos [N, D] once, bf16
        library = {
            "b8a": lambda p: (torch.addmm(b, (p.view(rows, pd).float() * scale + shift).to(bf), w)
                              .view(batch, n_p, d) + pos),
            "b8b": lambda p: torch.addmm(b, p.view(rows, pd), w).view(batch, n_p, d) + pos,
        }
        for key, fn, ref_fn, entry, eager, src, in_bytes in (
                ("b8a", kemb.fused_patch_embed_u8, kemb.fused_patch_embed_u8_ref, kemb.embed_u8,
                 embed_from_u8, u8b, 1),
                ("b8b", kemb.fused_patch_embed_f, kemb.fused_patch_embed_f_ref, kemb.embed_fused,
                 embed, pix, 2)):
            patches = extract_patches(src, mcfg.patch_size)
            k_ms, p_ms = abba(lambda: fn(patches, w, b, pos), lambda: ref_fn(patches, w, b, pos))
            l_ms = time_ms(lambda: library[key](patches))
            l_err = rel_err(library[key](patches), ref_fn(patches, w, b, pos))
            en_ms = time_ms(lambda: entry(src, ep, mcfg))
            with kernel_mode("eager"):  # embed_from_u8's plain route
                e_ms = time_ms(lambda: eager(src, ep, mcfg))
            b_ms, b_by = bound(2.0 * rows * pd * d, rows * pd * in_bytes + const_bytes + rows * d * 2)
            log(f"  {key.upper()} {mname} batch {batch} (K {pd}, D {d}): kernel {k_ms:.4f} ms, plain "
                f"version {p_ms:.3f} ms, library on the patches {l_ms:.4f} ms (relative "
                f"{l_err:.2e} from the plain version), entry point {entry.__name__} {en_ms:.4f} "
                f"ms, eager {eager.__name__} {e_ms:.4f} ms; {2.0 * rows * pd * d:.3e} FLOP, bound "
                f"{b_ms:.4f} ms ({b_by})")
            if mname == "deit_s":
                kernel_ms[key], bounds[key] = (k_ms, p_ms, l_ms), (b_ms, b_by)
        del pix

    # B8a on the image, the served embed: DeiT-S at batch 512 and 1024, ViT-H at 64, DINOv2-g
    # at 32 (518 px, 4 registers): the kernel beside B8a on the patch matrix (extracted
    # beforehand), the served embed (embed_from_u8 in mode 'auto': the same launch behind its
    # wrapper), the eager route (mode 'eager') and the bound (the image read once, the
    # sequence written once, W, b, pos, CLS and registers once)
    served_embed = {}
    for mname, mcfg, m_embed, batch in (("deit_s", cfg, base["backbone"]["embed"], 512),
                                        ("deit_s", cfg, base["backbone"]["embed"], 1024),
                                        ("vit_h", hcfg, base_h["backbone"]["embed"], 64),
                                        ("dinov2_g", dcfg, d_embed, 32)):
        ep = tree_to(m_embed, dev, bf)
        side, p_sz = mcfg.image_size, mcfg.patch_size
        imgs = torch.from_numpy(rs.randint(0, 256, (batch, 3, side, side), dtype=np.uint8)).to(dev)
        w, b, full = ep["patch"]["w"], ep["patch"]["b"], ep["pos"][0]
        cls, reg = ep["cls"].reshape(-1), ep.get("registers")
        reg = None if reg is None else reg[0]
        patches = extract_patches(imgs, p_sz)
        k_ms, m_ms = abba(lambda: kemb.fused_image_embed_u8(imgs, w, b, cls, full, reg, p_sz),
                          lambda: kemb.fused_patch_embed_u8(patches, w, b, full[1:]))
        s_ms = time_ms(lambda: embed_from_u8(imgs, ep, mcfg))
        with kernel_mode("eager"):
            e_ms = time_ms(lambda: embed_from_u8(imgs, ep, mcfg))
        n_p, pd, d = mcfg.num_patches, mcfg.patch_dim, mcfg.hidden_size
        r = mcfg.seq_len - 1 - n_p
        flops = 2.0 * batch * n_p * pd * d
        b_ms, b_by = bound(flops, imgs.numel() + (pd * d + d + (2 + n_p + r) * d) * 2
                           + batch * mcfg.seq_len * d * 2)
        tag = f"{mname} batch {batch}"
        log(f"  B8a on the image (served embed) {tag} (P {p_sz}, K {pd}, D {d}, R {r}): kernel "
            f"{k_ms:.4f} ms, B8a on the patch matrix {m_ms:.4f} ms, served embed_from_u8 "
            f"{s_ms:.4f} ms, eager embed_from_u8 {e_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
            f"{100 * b_ms / k_ms:.1f}%)")
        served_embed[tag] = {"ms": k_ms, "patch_matrix_ms": m_ms, "served_ms": s_ms,
                             "eager_ms": e_ms, "bound_ms": b_ms, "bound_by": b_by}
        del imgs, patches

    # ViT-H/14 at batch 64: the kernels at its geometry and the end-to-end rows (mean of 5
    # after 2 warm-ups: a dense forward is ~21 TFLOP)
    hbatch, quick = 64, {"iters": 5, "warmup": 2}
    log(f"  ViT-H/14, bf16, batch {hbatch}, CUDA events, mean of 5 after 2 warm-ups")
    hlp = tree_to(geometries_h["vit_h"][1], dev, bf)
    for s in (257, 129):  # dense's length and headline's
        x = torch.randn(hbatch, s, hcfg.hidden_size, generator=gen).to(dev, bf)
        k_ms, p_ms = abba(lambda: kl.fused_vit_layer(x, hlp, hcfg.num_heads),
                          lambda: kl.fused_vit_layer_ref(x, hlp, hcfg.num_heads), **quick)
        with kernel_mode("eager"):
            e_ms = time_ms(lambda: vit_layer(x, hlp, hcfg), **quick)
        b_ms, b_by = bound(layer_work(hcfg, hbatch * s, hbatch * hcfg.num_heads * s * s),
                           2 * x.numel() * x.element_size() + weight_bytes(hlp))
        log(f"  B1 vit_h S={s}: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, eager layer "
            f"{e_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
    fh, hh = tree_to(lnf_h, dev, bf), tree_to(head_h, dev, bf)
    x = torch.randn(hbatch, 129, hcfg.hidden_size, generator=gen).to(dev, bf)
    k_ms, p_ms = abba(lambda: kl.fused_vit_layer_cls_logits(x, hlp, fh, hh, hcfg.num_heads),
                      lambda: kl.fused_vit_layer_cls_logits_ref(x, hlp, fh, hh, hcfg.num_heads),
                      **quick)
    b_ms, b_by = bound(cls_work(hcfg, hbatch, 129), x.numel() * 2 + hbatch * 200
                       + weight_bytes(hlp) + weight_bytes(fh) + weight_bytes(hh))
    lib_fn = cls_library(hcfg, hlp, fh, hh)
    c_ms = time_ms(lambda: lib_fn(x), **quick)

    def eager_cls_h():  # the plain path's tail: whole last layer, LN_f, head on CLS
        y = layer_norm(vit_layer(x, hlp, hcfg), fh, hcfg.layernorm_eps)[:, 0]
        return y @ hh["w"] + hh["b"]

    with kernel_mode("eager"):
        e_ms = time_ms(eager_cls_h, **quick)
    log(f"  B2 vit_h S=129: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, CLS-only library "
        f"composition {c_ms:.3f} ms, eager last layer + LN_f + head {e_ms:.3f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / k_ms:.1f}%)")
    b2_lines["vit_h_s129_b64"] = {"ms": k_ms, "library_ms": c_ms, "eager_whole_layer_ms": e_ms}
    x = torch.randn(hbatch, 257, hcfg.hidden_size, generator=gen).to(dev, bf)
    mask = random_mask(hbatch, 257, torch.full((hbatch,), 129))  # topk50's bucket, full
    dest = compact_dest(mask)
    k_ms, p_ms = abba(
        lambda: kl.fused_vit_layer_bucketed(x, hlp, dest, mask, 129, hcfg.num_heads),
        lambda: kl.fused_vit_layer_bucketed_ref(x, hlp, dest, mask, 129, hcfg.num_heads), **quick)
    b_ms, b_by = bound(layer_work(hcfg, hbatch * 129, hbatch * hcfg.num_heads * 129 * 129),
                       2 * x.numel() * 2 + dest.numel() * 5 + weight_bytes(hlp))
    with kernel_mode("eager"):  # index gather, cuBLAS bf16 masked layer at 129, scatter
        e_ms = time_ms(lambda: tp.bucketed_masked_layer(x, hlp, mask, hcfg, cap_hint=129), **quick)
    log(f"  B3 vit_h S=257 cap=129: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, eager "
        f"bucketed layer {e_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
    hqlp = with_kmajor_int8_weights(quantize_layer_params(hlp))
    k_ms, p_ms = abba(lambda: k8.fused_vit_layer_int8(x, hqlp, hcfg.num_heads),
                      lambda: k8.fused_vit_layer_int8_ref(x, hqlp, hcfg.num_heads), **quick)
    b_ms, b_by = bound_int8(hcfg, hbatch * 257, hbatch * hcfg.num_heads * 257 * 257,
                            2 * x.numel() * 2 + weight_bytes(hqlp))
    with kernel_mode("eager"):  # torch._int_mm for the four products, bf16 attention
        e_ms = time_ms(lambda: vit_layer(x, hqlp, hcfg, quant="int8"), **quick)
    log(f"  B4 vit_h S=257: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, eager int8 layer "
        f"(torch._int_mm) {e_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
    hst = tree_to(st_h, dev, bf)
    k_ms, p_ms = abba(lambda: kmod.fused_vit_encoder(x, hst, hcfg.num_heads),
                      lambda: kmod.fused_vit_encoder_ref(x, hst, hcfg.num_heads), **quick)
    b_ms, b_by = bound(2 * layer_work(hcfg, hbatch * 257, hbatch * hcfg.num_heads * 257 * 257),
                       2 * x.numel() * 2 + weight_bytes(hst))

    def eager_encoder_h():  # the plain path's layer loop over the same two layers
        y = x
        for i in range(2):
            y = vit_layer(y, layer_slice(hst, i), hcfg)
        return y

    with kernel_mode("eager"):
        e_ms = time_ms(eager_encoder_h, **quick)
    log(f"  B5 vit_h 2 layers S=257: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, eager "
        f"layer loop {e_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
    del x, hqlp
    u8h = images(hbatch)
    for name in ("dense", "headline", "composed", "ultra"):
        fwd = h_forward(name, h_tree(h_presets[name][2], bf), u8h)

        def run(mode, fwd=fwd):
            with kernel_mode(mode):
                fwd()

        k_ms, p_ms = abba(lambda: run("auto"), lambda: run("eager"), **quick)
        log(f"  vit_h {name}: kernel path {k_ms:.3f} ms/batch ({hbatch / k_ms * 1e3:.1f} img/s), "
            f"plain path {p_ms:.3f} ms/batch ({hbatch / p_ms * 1e3:.1f} img/s)")
        if name == "dense":
            device_breakdown("vit_h dense", lambda: run("auto"), k_ms, reps=2)

    # The f32 routes (what cli.py train / eval, quality_torch.py and the train steps run by
    # default; TF32 off): each kernel at a shape an f32 entry point gives it, beside its
    # plain version (abba), the f32 PyTorch call or composition for the same function and
    # its bound_split6. B1 at ViT-B/16 batch 16, S 197, 30% of keys masked (the CLI's
    # eval); B2 (S 99), B3 (S 197, cap 99), B5 (12 layers), B6 (6 heads, S 197, masked),
    # B7 (32 x 197 rows), B8b (f32 patches and weights) and B8a (uint8 patches, f32
    # weights) at DeiT-S batch 32 (the train steps' batch); B7 and B8 on the split body
    log(f"  f32 routes, CUDA events, mean of 10 after 3 warm-ups; {smi}")
    f32_rows = {}

    def f32_row(key, shape, k_fn, p_fn, l_fn, library, flops, nbytes, profile=False):
        k_ms, p_ms = abba(k_fn, p_fn)
        l_ms = time_ms(l_fn)
        b_ms, b_by = bound_split6(flops, nbytes)
        # B2: each launch's device us (torch.profiler)
        prof = launch_profile(k_fn) if profile else None
        # the f32 attention launches of one call, by body (B1-B5's counters, B6's)
        kl.reset_attention_body_counts()
        ka.reset_body_counts()
        k_fn()
        torch.cuda.synchronize()
        attn = {b: n for b, n in kl.attention_body_counts().items() if n}
        attn.update({f"b6_{b}": n for b, n in ka.body_counts().items() if n})
        f32_rows[key] = {"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": l_ms, "library": library,
                         "attention_launches": attn,
                         **({"device_us_by_launch": prof} if profile else {})}
        log(f"  {key.upper()} f32 {shape}: kernel {k_ms:.4f} ms, plain version {p_ms:.4f} ms, "
            f"{library} {l_ms:.4f} ms; {flops:.3e} FLOP, bound {b_ms:.4f} ms ({b_by}, "
            f"{100 * b_ms / k_ms:.1f}%); f32 attention launches a call {attn}"
            + (f"; device us by launch {prof}" if profile else ""))

    f32 = torch.float32
    m32 = random_mask(32, 197, torch.full((32,), 138))
    blp = tree_to(b_layer, dev, f32)
    xb = torch.randn(16, 197, b_cfg.hidden_size, generator=gen).to(dev)
    mb = random_mask(16, 197, torch.full((16,), 138))
    with kernel_mode("eager"):
        f32_row("b1", "ViT-B/16 batch 16, S 197, masked",
                lambda: kl.fused_vit_layer(xb, blp, b_cfg.num_heads, b_cfg.layernorm_eps, mb),
                lambda: kl.fused_vit_layer_ref(xb, blp, b_cfg.num_heads, b_cfg.layernorm_eps, mb),
                lambda: vit_layer(xb, blp, b_cfg, token_mask=mb), "eager vit_layer (cuBLAS f32)",
                layer_work(b_cfg, 16 * 197, 16 * b_cfg.num_heads * 197 * 197),
                2 * xb.numel() * 4 + weight_bytes(blp))
        glp = tree_to(geometries["deit_s"][1], dev, f32)
        f, h = tree_to(lnf, dev, f32), tree_to(head, dev, f32)
        x = torch.randn(32, 99, cfg.hidden_size, generator=gen).to(dev)
        lib_fn = cls_library(cfg, glp, f, h)
        f32_row("b2", "DeiT-S batch 32, S 99",
                lambda: kl.fused_vit_layer_cls_logits(x, glp, f, h, cfg.num_heads),
                lambda: kl.fused_vit_layer_cls_logits_ref(x, glp, f, h, cfg.num_heads),
                lambda: lib_fn(x), "CLS-only composition (layer_norm, addmm, SDPA)",
                cls_work(cfg, 32, 99), x.numel() * 4 + 32 * 100 * 4 + weight_bytes(glp)
                + weight_bytes(f) + weight_bytes(h), profile=True)
        x = torch.randn(32, 197, cfg.hidden_size, generator=gen).to(dev)
        m99 = random_mask(32, 197, torch.full((32,), 99))  # topk50's bucket, every image full
        dest = compact_dest(m99)
        counts = m99.sum(-1).long()
        f32_row("b3", "DeiT-S batch 32, S 197, cap 99",
                lambda: kl.fused_vit_layer_bucketed(x, glp, dest, m99, 99, cfg.num_heads),
                lambda: kl.fused_vit_layer_bucketed_ref(x, glp, dest, m99, 99, cfg.num_heads),
                lambda: tp.bucketed_masked_layer(x, glp, m99, cfg, cap_hint=99),
                "eager bucketed layer", layer_work(cfg, int(counts.sum()),
                                                   cfg.num_heads * int((counts ** 2).sum())),
                2 * x.numel() * 4 + dest.numel() * 5 + weight_bytes(glp))
        st32 = tree_to(stack_s, dev, f32)

        def eager_encoder32():
            y = x
            for i in range(L):
                y = vit_layer(y, layer_slice(st32, i), cfg)
            return y

        f32_row("b5", "DeiT-S batch 32, 12 layers, S 197",
                lambda: kmod.fused_vit_encoder(x, st32, cfg.num_heads),
                lambda: kmod.fused_vit_encoder_ref(x, st32, cfg.num_heads), eager_encoder32,
                "eager layer loop", L * layer_work(cfg, 32 * 197, 32 * cfg.num_heads * 197 * 197),
                2 * x.numel() * 4 + weight_bytes(st32))
        del st32
        q, k, v = (torch.randn(32, cfg.num_heads, 197, cfg.head_dim, generator=gen).to(dev)
                   for _ in range(3))
        sdpa_mask = m32[:, None, None, :]
        f32_row("b6", "DeiT-S batch 32, 6 heads, S 197, masked",
                lambda: ka.fused_attention(q, k, v, m32), lambda: ka.fused_attention_ref(q, k, v, m32),
                lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, sdpa_mask),
                "f32 scaled_dot_product_attention", 4.0 * q.numel() * 197, 4 * q.numel() * 4)
        del q, k, v
        mlp32 = glp["mlp"]
        xm = x.reshape(-1, cfg.hidden_size)
        w = (mlp32["fc1"]["w"], mlp32["fc1"]["b"], mlp32["fc2"]["w"], mlp32["fc2"]["b"])
        f32_row("b7", f"DeiT-S batch 32, {xm.shape[0]} rows",
                lambda: kmlp.fused_mlp(xm, *w), lambda: kmlp.fused_mlp_ref(xm, *w),
                lambda: mlp_block(xm, mlp32), "eager mlp_block (cuBLAS f32 + F.gelu)",
                4.0 * xm.shape[0] * cfg.hidden_size * cfg.mlp_dim,
                2 * xm.numel() * 4 + weight_bytes(mlp32))
        ep = tree_to(base["backbone"]["embed"], dev, f32)
        w, b, pos = ep["patch"]["w"], ep["patch"]["b"], ep["pos"][0][1:]
        n_p, pd, d = cfg.num_patches, cfg.patch_dim, cfg.hidden_size
        patches = extract_patches(((images(32).float() / 255.0 - 0.5) / 0.5), cfg.patch_size)
        f32_row("b8b", "DeiT-S batch 32, f32 patches and weights (K 768)",
                lambda: kemb.fused_patch_embed_f(patches, w, b, pos),
                lambda: kemb.fused_patch_embed_f_ref(patches, w, b, pos),
                lambda: torch.addmm(b, patches.view(-1, pd), w).view(32, n_p, d) + pos,
                "addmm f32 + pos", 2.0 * 32 * n_p * pd * d,
                4 * (patches.numel() + pd * d + d + n_p * d + 32 * n_p * d))
        u8p = extract_patches(images(32), cfg.patch_size)
        f32_row("b8a", "DeiT-S batch 32, uint8 patches, f32 weights (K 768)",
                lambda: kemb.fused_patch_embed_u8(u8p, w, b, pos),
                lambda: kemb.fused_patch_embed_u8_ref(u8p, w, b, pos),
                lambda: torch.addmm(b, u8p.view(-1, pd).float() * scale + shift, w)
                .view(32, n_p, d) + pos, "the affine, addmm f32 + pos", 2.0 * 32 * n_p * pd * d,
                u8p.numel() + 4 * (pd * d + d + n_p * d + 32 * n_p * d))
        del x, xm, patches, u8p
    # the head_mask forward (the mask-search route: B7 x 12 beside the plain head-masked
    # attention) in f32 at DeiT-S batch 32, the kernel path against the eager one
    bb32, hm32 = tree_to(base, dev, f32)["backbone"], hm.to(dev, f32)
    pix32 = ((images(32).float() / 255.0 - 0.5) / 0.5)

    def run_head_mask32(mode):
        with kernel_mode(mode):
            vit_forward(bb32, pix32, cfg, head_mask=hm32)

    k_ms, p_ms = abba(lambda: run_head_mask32("auto"), lambda: run_head_mask32("eager"))
    f32_rows["b7"]["head_mask_forward_ms"] = {"kernel": k_ms, "eager": p_ms}
    log(f"  head_mask forward f32, DeiT-S batch 32 (B7 x 12): kernel path {k_ms:.3f} ms/batch, "
        f"eager path {p_ms:.3f} ms/batch")
    del bb32

    # --- 3l. widths no multiple of the kernels' (C.1), after 6 so that 6's body counts
    # stay those of phases 5-5h ----------------------------------------------------------
    torch.cuda.empty_cache()
    kl.reset_attention_body_counts()
    widths_launches = widths_path(dev, base, cfg)

    # --- 5i. the serving export: DeiT-S headline, float and int8 ---------------------------
    exported = export_path(dev, base, cfg, smi)
    attention_bodies_agree("3l and 5i")

    # --- 7 (first half). importing every module of the port, and quality_torch, loads
    # neither pandas nor transformers: they are imported only when called (phases 8 and 9
    # print the metrics tables, which import pandas where it is installed)
    import importlib
    import pkgutil
    from pathlib import Path

    import quality_torch  # noqa: F401
    import vit_pruning_tpu_torch as port

    for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        importlib.import_module(mod.name)
    lazy = [m for m in ("pandas", "transformers") if m in sys.modules]
    if lazy:
        raise AssertionError(f"importing the port loaded {lazy}, which it imports only when used")

    # --- 8. the CLI at ViT-B/16 width: train, eval, export -----------------------------
    torch.cuda.empty_cache()
    cli_run = cli_path(dev)

    # --- 9. the quality gates on the card (gate model, kernels auto, cut epochs) ----------
    gate_run = gate_path(dev, GATE_ARGV + ["--cache_dir", tempfile.mkdtemp(prefix="gate_cache_")])

    # --- 10. parallelism: data / model steps, ZeRO-1, dp serving, the pipelines on
    # PARALLEL_RANKS gloo ranks sharing the card, the kernels built above --------------
    torch.cuda.empty_cache()
    par_run = parallel_path(smi)

    # --- 11. the nn.Module adapter (models/torch_module.py) at DeiT-S width ----------------
    torch.cuda.empty_cache()
    module_run = module_path(dev, base, cfg, smi)

    # --- 5j. DINOv2 ViT-g/14 with registers served end to end at full size -----------------
    torch.cuda.empty_cache()
    dino_run = dinov2_path(dev)

    # --- 7. records: after every phase, nothing of jax or of the JAX package was loaded ---
    port_dir = Path(port.__file__).resolve().parent
    jax_dir = port_dir.parent / "vit_pruning_tpu"
    jax_loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.split(".")[0] in ("jax", "vit_pruning_tpu"))
    jax_files = sorted(n for n, m in list(sys.modules.items())
                       if jax_dir in Path(getattr(m, "__file__", None) or "/").resolve().parents)
    if jax_loaded or jax_files:
        raise AssertionError(f"the port loaded jax or the JAX package: {(jax_loaded + jax_files)[:5]}")
    for src in sorted(port_dir.rglob("*.py")):
        text = src.read_text()
        for needle in ('"vit_pruning_tpu"', "'vit_pruning_tpu'", '"vit_pruning_tpu/',
                       "spec_from_file_location", "exec_module"):
            if needle in text:
                raise AssertionError(f"{src}: builds a path into the JAX package ({needle})")
    for src in (port_dir.parent / "quality_torch.py", port_dir.parent / "chip_smoke.py"):
        bad = [ln for ln in src.read_text().splitlines()
               if ln.strip().startswith(("import jax", "from jax", "import vit_pruning_tpu ",
                                         "import vit_pruning_tpu.", "from vit_pruning_tpu ",
                                         "from vit_pruning_tpu."))]
        if bad:
            raise AssertionError(f"{src.name} imports jax or the JAX package: {bad[:3]}")
    log(f"  phase 8 (CLI, ViT-B/16, bf16, batch 16): ms/step by phase "
        f"{[round(v, 3) for v in cli_run['times']['train_ms_by_phase']]}, eval ms/batch "
        f"{cli_run['times']['eval_ms']:.3f}; phase 9 (gates, kernels auto): rc {gate_run['rc']} "
        f"in {gate_run['seconds']:.1f} s; phase 10 (parallel, {par_run['backend']}, host-staged "
        f"hops by rank {par_run['host_staged']}): {par_run['seconds']:.1f} s")
    log(f"  phase 11 (PrunedViT module, bf16, batch 512): ms/batch module / functional "
        + ", ".join(f"{run} {statistics.mean(t['module']):.4f} / "
                    f"{statistics.mean(t['functional']):.4f}"
                    for run, t in module_run["times"].items() if isinstance(t, dict))
        + f"; {smi}")
    pkg = "vit_pruning_tpu_torch"
    rows = (  # key, wrapper, csrc file, the TPU kernel's file and line, launches
        ("b1", "fused_vit_layer", "layer", "layer", 359, launches["b1"] + launches["b1_redecide"]),
        ("b2", "fused_vit_layer_cls_logits", "cls_logits", "layer", 561, launches["b2"]),
        ("b3", "fused_vit_layer_bucketed", "layer", "layer", 761, launches["b3"]),
        ("b4", "fused_vit_layer_int8", "layer_int8", "layer_int8", 154, launches["b4"]),
        ("b5", "fused_vit_encoder", "encoder", "model", 150, launches["b5"]),
        ("b6", "fused_attention", "attention", "attention", 58, launches["b6"]),
        ("b7", "fused_mlp", "mlp", "mlp", 85, launches["b7"]),
        ("b8a", "fused_patch_embed_u8", "embed", "embed", 48, launches["b8a"]),
        ("b8b", "fused_patch_embed_f", "embed", "embed", 125, launches["b8b"]),
    )
    # B4: every launch on the wgmma s8 body, four products each; B8: bf16 weights on wgmma
    # B1, B3, B4, B5: their attention's launches per body on phases 5-5h (B5: one a layer),
    # a wider window than `launches` (5-5d and 5f): it adds ViT-H (5e), S 577 (5g) and the
    # train steps (5h), so the key names it
    by_body = {**bodies67, **b8_bodies, "b4": {"wgmma_s8": launches["b4"]},
               "b2": {"by_kind_5_to_5h": b2_kinds}}
    for key in ("b1", "b3", "b4", "b5"):
        by_body[key] = {**by_body.get(key, {}), "attention_5_to_5h": attn_tally.get(key, {})}
    kernels = [
        {"name": name, "route": "cuda", "source": f"{pkg}/csrc/{src}.cu",
         "replaces": f"vit_pruning_tpu/ops/pallas/{tpu}.py:{line}", "launches": n,
         "max_abs_err": err[key], "ms": kernel_ms[key][0], "plain_ms": kernel_ms[key][1],
         "bound_ms": bounds[key][0], "bound_by": bounds[key][1], "library_ms": kernel_ms[key][2],
         **({"launches_by_body": by_body[key]} if key in by_body else {}),
         **({"products_on_wgmma_s8": launches["b4_s8"]} if key == "b4" else {}),
         **({"served_image": {"launches_5f": launches["b8a_image"], "times": served_embed}}
            if key == "b8a" else {}),
         **({"library": "CLS-only composition (layer_norm, addmm, SDPA)",
             "times_by_shape": b2_lines} if key == "b2" else {}),
         **({"launches_train": trained["launches"][key]} if key in trained["launches"] else {}),
         "launches_cli": {run: c[key] for run, c in cli_run["launches"].items()},
         "launches_gate": gate_run["launches"][key],
         "launches_widths": widths_launches[key],
         "launches_parallel": [c.get(key, 0) for c in par_run["launches"]],
         "launches_export": {run: c[key] for run, c in exported["launches"].items()},
         "launches_module": {run: c[key] for run, c in module_run["launches"].items()},
         "launches_dinov2": dino_run["launches"][key],
         # the f32 routes: the kernel at an f32 entry point's shape (phase 6); B1, B3, B5:
         # their f32 products on the split body (csrc/gemm.cu) on phases 5-5h, the CLI's
         # f32 eval (8) and the gates (9)
         **({"f32": f32_rows[key]} if key in f32_rows else {}),
         # the f32 attention of B1, B3, B4, B5 and B6's f32 route (the split body)
         **({"f32_attention_source": f"{pkg}/csrc/split_attention.cuh"}
            if key in ("b1", "b3", "b4", "b5", "b6") else {}),
         **({"f32_split_products": {"5_to_5h": f32_tally.get(key, 0),
                                    "cli_eval": cli_run["f32_products"]["eval_auto"].get(key, 0),
                                    "gates": gate_run["f32_products"].get(key, 0)}}
            if key in ("b1", "b3", "b5") else {}),
         # B2's f32 route: its four launches (cls_logits.cu) on split-bf16 wgmma
         **({"f32_route": {"source": f"{pkg}/csrc/cls_logits.cu",
                           "kinds": [k for k in kl.CLS_LAUNCH_KINDS if k.startswith("f32_")]
                           + ["ln1_stats"],
                           "launches_by_kind_5_to_5h": {k: v for k, v in b2_kinds.items()
                                                        if k.startswith("f32_")}}}
            if key == "b2" else {})}
        for key, name, src, tpu, line, n in rows
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
