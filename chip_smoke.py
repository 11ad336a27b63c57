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
     masked (every row compared), float32 and bfloat16, with the body each
     case took (the tensor-core body for every bf16 case it takes)
  3e. kernel B7 (fused_mlp) against its plain version: the rows of S in
     {197, 99, 17} at DeiT-S width (MLP 1536) and composed width (MLP 768),
     136 rows at ViT-L width (D 1024, MLP 4096) and 514 rows at ViT-H width
     (D 1280, MLP 5120), with the body each case took, as in 3d
  3f. kernel B5 (fused_vit_encoder) against its plain version: DeiT-S at 12
     layers and a 3-layer segment, composed geometry at a 3-layer segment,
     S in {197, 99, 17}, masked and not, float32 and bfloat16
  4. kernel B2 (fused_vit_layer_cls_logits) against its plain version
  4b. kernel B3 (fused_vit_layer_bucketed) against its plain version: S 197
     with cap 99 / 131 / 197 and S 99 with cap 50, random kept counts up to
     the cap and an image with only CLS kept; skipped rows must be x
     bit for bit
  3g. kernels B8a / B8b (fused_patch_embed_u8 / _f) against their plain
     versions at DeiT-S's (K 768, D 384) and ViT-H's (K 588, D 1280) patch
     embedding, batch 64, float32 and bfloat16 weights, uint8 / float
     patches, pos in the weights' dtype and in float32, with the body each
     case ran (the wgmma body for bf16 weights, FMA tiles for f32); B8a and
     B8b at patch width 75 (rows no 4- or 8-byte multiple); bad inputs
     raise
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
     products at ViT-B/16, batch 16 x S 197), with the body each took
     (wgmma where TMA can describe the operands, else WMMA); the
     main shapes at batch 512 x 197 and 64 x 257 timed beside torch.matmul
  3k. sequences past the attention bodies' resident limit (K and V
     streamed): B1, B2, B3 (cap S // 2 + 1, the last token kept), B4, B5
     (two layers) and B6 against their plain versions at S 577 with hd 64
     (DeiT-S at 384) and hd 80 (ViT-H/14 at 336, full width) and at S 785
     (DeiT-S at 448), masked and not, float32 at batch 2, bfloat16 at 4
  3j. B4's int8 product body (wgmma s8 + TMA) one product at a time at
     every product shape of B4 at DeiT-S (batch 512 x 197) and ViT-H (64 x
     257), and at vit_tiny's (136 rows, N 192, K 64) and a ragged one, the
     output bit-equal to the exact int32 product's dequant (+ bias), timed
     beside torch._int_mm on the same operands (TOP/s)
  5. end to end, DeiT-S @224 with 100 labels at batch 64: dense vit_forward
     and headline / composed / ultra through serving_forward, kernels
     (mode 'auto') against plain PyTorch (mode 'eager'), with the launch
     counts of every forward; vit_tiny (hd 16) dense and headline the same
     way
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
     body (the bf16 forwards on the tensor-core bodies); kernels against
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
  5f. the fused embed entry points embed_u8 / embed_fused (B8a / B8b) at
     DeiT-S and ViT-H, batch 64, against embed_from_u8 and the model's
     embed, with their launch counts and bodies (bf16 weights: wgmma)
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
  6. which GEMM body ran the bf16 products of phases 5-5f (launches per
     body, the shapes that took the WMMA body); times at batch 512 in
     bfloat16, kernel path and plain path (float and
     int8), and each kernel beside its plain version and its eager PyTorch
     equivalent (info only); each kernel's bound from its shapes and its
     share of it (B6 and B7 must stay within theirs); the head_mask forward
     (B7 x 12), kernel path and plain path; the device
     time of the dense, headline, topk50, mask, dense_int8, topk50_int8 and
     dense-with-encoder-fusion forwards by kernel family and of the
     once-per-forward weight quantization (torch.profiler); dense and ultra
     with encoder fusion on and off; B8a / B8b at DeiT-S batch 512 and ViT-H
     batch 64 beside the library (cuBLAS addmm) on the same patches, their
     entry points and the eager equivalents on the images; ViT-H at
     batch 64: B1-B5 at its geometry beside their eager equivalents, and
     dense / headline / composed / ultra, kernel path and plain path (mean
     of 5 after 2 warm-ups); B1 and B6 at DeiT-S S 577, batch 128, beside
     the cuBLAS layer and f32 SDPA
  3l. (after 6, so that 6's GEMM body counts stay those of 5-5h) widths
     that are not multiples of the kernels' (ROADMAP C.1), zero-padded by
     the wrappers: B1, B2, B3, B4 and B5 (two layers) at DeiT-S with 1000
     of 1536 MLP channels kept and at hidden width 100 (4 heads of 16, MLP
     300), B8a / B8b at D 100, float32 and bfloat16, against their plain
     versions on the unpadded weights; every kernel launched
  5i. the serving export (serving.py::export_serving / load_exported) of
     the DeiT-S headline, bf16 at batch 512, float32 and int8 at batch 64:
     the program's vpt:: operators (B1 x 11 + B2, or B4 x 11 + B2), its
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
  7. records: before 8, importing every module of the port and
     quality_torch.py loads neither pandas nor transformers (8 and 9 print
     the metrics tables, which import pandas where it is installed); after
     9, nothing of jax or of the JAX package was loaded (by module name or
     by file) and no line of quality_torch.py or of this script imports
     them; the kernels'
     JSON line (launches: B1-B7 on the DeiT-S paths of 5-5d, B8 on 5f's;
     B4's, B6's, B7's and B8's also per body; ViT-H's are logged in 5e;
     B1's and B5's also launches_train, those of 5h's train steps; every
     row launches_cli, by command of phase 8, and launches_gate, phase
     9's; train_steps_* count only the launches inside phase 8's train
     steps; launches_widths, phase 3l's; launches_export, each of 5i's
     loaded programs' calls), the device line

Any failed check raises, so the exit code is non-zero. The line before the
last is the kernels' JSON record; the last line is the device record.
Weights are random, from a torch.Generator seed; images from a numpy seed.
"""

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


def log(msg: str):
    print(msg, flush=True)


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
                body = "wgmma" if n["wgmma"] else "fma"
                ref = ka.fused_attention_ref(q, k, v, mask)
                torch.cuda.synchronize()
                d = valid_rows(got.transpose(1, 2), ref.transpose(1, 2), mask)
                tol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
                if dt == torch.float32:
                    err["b6"] = max(err["b6"], d)
                tag = f"B6 {gname} {dname} B={hb} S={s} {'mask' if mask is not None else 'nomask'}"
                log(f"  {tag}: {body} body, max_abs_err {d:.3e} (tol {tol:.1e})")
                check(bool(torch.isfinite(got).all()) and d <= tol
                      and (body == "wgmma") == ka.takes_tensor_cores(q, k, v), tag)
    check.done()


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
            with kernel_mode("eager"):
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
            if pcfg is not None:  # the only drop comes before any kernel runs
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
    launches = read_launches()
    log("  launches: " + ", ".join(f"{k.upper()} {v}" for k, v in launches.items() if v))
    for key in ("b1", "b2", "b3", "b4", "b5", "b8a", "b8b"):
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
    want = {"none": {"vpt.fused_vit_layer.default": L - 1,
                     "vpt.fused_vit_layer_cls_logits.default": 1},
            "int8": {"vpt.fused_vit_layer_int8.default": L - 1,
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
        """A copy of a CPU tree on the card (a train step updates it in place)."""
        return {k: fresh(v) if isinstance(v, dict) else None if v is None
                else v.detach().to(dev, copy=True) for k, v in tree.items()}

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
            "b8a": kemb.fused_patch_embed_u8, "b8b": kemb.fused_patch_embed_f}


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
    evals = {}
    for mode in ("auto", "eager"):
        out = io.StringIO()
        reset_launches()
        with StepRecorder() as rec, kernel_mode(mode), contextlib.redirect_stdout(out):
            rc = cli.main(["eval", "--checkpoint", ckpt, "--test_batch_size", "16"])
        torch.cuda.synchronize()
        launches[f"eval_{mode}"] = read_launches()
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
    return {"launches": launches, "times": times}


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

    check = Checks("phase 9 (the quality gates on the card)")
    out, err = io.StringIO(), io.StringIO()
    reset_launches()
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
    return {"launches": launches, "record": record, "rc": rc, "seconds": seconds}


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

    def body_took(mod, tc: bool, tag: str) -> str:
        """The body of the one launch since mod.reset_body_counts(); a case
        the tensor-core body takes must have taken it."""
        n = mod.body_counts()
        body = "wgmma" if n["wgmma"] else "fma"
        check(n["wgmma"] + n["fma"] == 1 and (body == "wgmma") == tc,
              f"{tag}: bodies {n}, tensor-core body expected {tc}")
        return body

    # DeiT-S's heads; hd 128 at S 257, where the FMA body reads V from L2; ViT-H's hd 80
    # at S 257 (two 64-wide hd boxes and five key chunks in the tensor-core body) and
    # vit_tiny's hd 16 (a box wider than the head); each unmasked, masked, and masked
    # with image 0's keys all masked (uniform attention, every row compared)
    shapes = [("deit_s", 8, cfg.num_heads, s, cfg.head_dim, gen) for s in (197, 99, 17)]
    shapes += [("hd128", 2, 3, 257, 128, gen), ("vit_h", 2, 16, 257, 80, gen67),
               ("vit_tiny", 4, 3, 17, 16, gen67)]
    for dname, dt in dtypes.items():
        for gname, b, h, s, hd, g in shapes:
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
                body = body_took(ka, ka.takes_tensor_cores(q, k, v), tag)
                ref = ka.fused_attention_ref(q, k, v, mask)
                torch.cuda.synchronize()
                d = valid_rows(got.transpose(1, 2), ref.transpose(1, 2),
                               mask if mname == "mask" else None)
                tol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
                if dt == torch.float32:
                    err["b6"] = max(err["b6"], d)
                log(f"  {tag}: {body} body, max_abs_err {d:.3e} (tol {tol:.1e})")
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
        body = body_took(kmlp, kmlp.takes_tensor_cores(x, w[0], w[2]), tag)
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
    for gname, (gcfg, lp_cpu) in geometries.items():
        for dname, dt in dtypes.items():
            lp, f, h = (tree_to(t, dev, dt) for t in (lp_cpu, lnf, head))
            for s in (197, 99, 33, 17):
                x = torch.randn(8, s, gcfg.hidden_size, generator=gen).to(dev, dt)
                got = kl.fused_vit_layer_cls_logits(x, lp, f, h, gcfg.num_heads,
                                                    gcfg.layernorm_eps)
                ref = kl.fused_vit_layer_cls_logits_ref(x, lp, f, h, gcfg.num_heads,
                                                        gcfg.layernorm_eps)
                torch.cuda.synchronize()
                d = (got.float() - ref.float()).abs().max().item()
                tol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
                if dt == torch.float32:
                    err["b2"] = max(err["b2"], d)
                tag = f"B2 {gname} {dname} S={s}"
                log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.1e})")
                check(got.shape == (8, 100) and bool(torch.isfinite(got).all()) and d <= tol, tag)
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
                want = "wgmma" if dt == torch.bfloat16 else "fma"  # bf16 weights: the wgmma body
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

    # --- 3i. the bf16 GEMM bodies against their plain version ----------------------------
    # Every product shape of the main paths, one product at a time through ops/cuda/gemm.py
    # (the C gemm() the layer kernels call): B1 / B3's four products and B5's variants (f32
    # residual stream, erf GELU) at DeiT-S and composed width, S 197/131/99/66/33/17, and at
    # ViT-H and its composed width, S 257/171/129/86/43/22, batch 8 (ragged M); B2's
    # products at the tails (DeiT-S 99/33/17, ViT-H 129/43/22) with A's and the residual's
    # strided CLS rows and the classifier's N 100. The body each product took is read from
    # the launch counters: the wgmma body wherever TMA can describe A and W, the WMMA body
    # only where it cannot. Then the main shapes at the timed batches (DeiT-S 512 x 197,
    # ViT-H 64 x 257), each against its plain version and timed beside torch.matmul's bf16
    # product on the same operands (a yardstick only).
    check = Checks("phase 3i (bf16 GEMM bodies vs plain)")
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
        d = (got.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        tol = bf16_tol(ref.float()) if out == bfl else F32_ATOL * max(1.0, top)
        log(f"  GEMM {tag} M={a.shape[0]} N={w.shape[1]} K={a.shape[1]} (lda {a.stride(0)}"
            f"{'' if r is None else f', residual {r.dtype} ldr {r.stride(0)}'}, {act}, out "
            f"{out}): body {body}; max_abs_err {d:.3e} (tol {tol:.1e})")
        check(got.shape == ref.shape and bool(torch.isfinite(got).all()) and d <= tol
              and body == want and c1["wgmma"] + c1["wmma"] == c0["wgmma"] + c0["wmma"] + 1,
              f"GEMM {tag}: err {d:.3e}, body {body} (want {want})")
        return a, w, got

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
    for gname, gcfg, batch, s in (("deit_s", cfg, 512, 197), ("vit_h", hcfg, 64, 257)):
        d, kw, mm = gcfg.hidden_size, gcfg.attn_width, gcfg.mlp_dim
        rows = batch * s
        for tag, (k, n, res, act, out) in {"qkv": (d, 3 * kw, None, "none", bfl),
                                           "o": (kw, d, bfl, "none", f32),
                                           "fc1": (d, mm, None, "gelu_tanh", bfl),
                                           "fc2": (mm, d, f32, "none", bfl)}.items():
            ops = gemm_operands(rows, k, n, res)
            a, w, _ = gemm_check(f"{gname} batch {batch} S={s} {tag}", ops, act, out)
            k_ms = time_ms(lambda: kg.gemm_bf16(a, w, ops[2], act, ops[3], out))
            l_ms = time_ms(lambda: torch.matmul(a, w))
            flops = 2.0 * rows * k * n
            gemm_rates.append((f"{gname} {tag}", rows, n, k, k_ms, l_ms))
            log(f"  GEMM {gname} batch {batch} S={s} {tag} M={rows} N={n} K={k}: kernel {k_ms:.4f} "
                f"ms ({flops / k_ms / 1e9:.1f} TFLOP/s), torch.matmul bf16 {l_ms:.4f} ms "
                f"({flops / l_ms / 1e9:.1f} TFLOP/s); {smi}")
            del ops, a, w
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
            with kernel_mode("auto"):
                got = fwd()
            torch.cuda.synchronize()
            l1 = kl.fused_vit_layer.launches - n1
            l2 = kl.fused_vit_layer_cls_logits.launches - n2
            with kernel_mode("eager"):
                ref = fwd()
            torch.cuda.synchronize()
            tag = f"{name} {dname}"
            want = (L, 0) if pcfg is None else (L - 1, 1)
            check((l1, l2) == want, f"{tag}: launches B1={l1} B2={l2}, want {want}")
            lg, lr = got["logits"].float(), ref["logits"].float()
            check(lg.shape == (64, 100) and bool(torch.isfinite(lg).all()),
                  f"{tag}: logits not finite [64, 100]")
            d = (lg - lr).abs().max().item()
            agree = (lg.argmax(-1) == lr.argmax(-1)).float().mean().item()
            line = (f"  {tag}: launches B1={l1} B2={l2}; logits max_abs_err {d:.3e} "
                    f"(max|ref| {lr.abs().max().item():.3f}), argmax agree {agree:.3f}")
            same_masks = True
            if pcfg is not None:
                km, em = got["keep_masks"], ref["keep_masks"]
                same_masks = bool(torch.equal(km, em))
                frac = (km == em).all(-1).float().mean().item()
                line += (f"; keep masks equal {same_masks} (images x layers agreeing "
                         f"{frac:.4f}); min cut gap (plain) {cut_gap(ref, pcfg):.2e}")
            log(line)
            if dt == torch.float32:
                check(same_masks, f"{tag}: keep masks differ")
                check(d <= F32_ATOL + 1e-4 * lr.abs().max().item(), f"{tag}: logits differ")
            elif name == "headline":
                # the only drop comes before any kernel runs: masks must agree
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
                 (tcfg.num_layers, 0)),
                ("headline", t_head, lambda: serving_forward(tparams, u8t, tcfg, t_head),
                 (tcfg.num_layers - 1, 1))):
            n1, n2 = kl.fused_vit_layer.launches, kl.fused_vit_layer_cls_logits.launches
            with kernel_mode("auto"):
                got = fwd()
            torch.cuda.synchronize()
            l1 = kl.fused_vit_layer.launches - n1
            l2 = kl.fused_vit_layer_cls_logits.launches - n2
            with kernel_mode("eager"):
                ref = fwd()
            torch.cuda.synchronize()
            tag = f"vit_tiny {name} {dname}"
            check((l1, l2) == want, f"{tag}: launches B1={l1} B2={l2}, want {want}")
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
                # the only drop comes before any kernel runs: masks must agree
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
            with kernel_mode("eager"):
                fl = fwd()["logits"]  # float (quant 'none'), the plain path
            with quant_mode("int8"):
                c0 = counts()
                with kernel_mode("auto"):
                    got = fwd()
                torch.cuda.synchronize()
                c1 = counts()
                with kernel_mode("eager"):
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
                with kernel_mode("eager"):
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
    # B6 and B7 per body: the float32 forwards on the FMA bodies, the bfloat16 ones on the
    # tensor-core bodies (DeiT-S's shapes are theirs)
    bodies67 = {"b6": ka.body_counts(), "b7": kmlp.body_counts()}
    log(f"  phase 5d launches per body: B6 {bodies67['b6']}, B7 {bodies67['b7']}")
    for k, n in bodies67.items():
        check(n["wgmma"] > 0 and n["fma"] > 0 and n["wgmma"] + n["fma"] == launches[k],
              f"{k.upper()} bodies {n} on {launches[k]} launches")
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
            with kernel_mode("eager"):
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

    # --- 5f. the fused embed entry points end to end ------------------------------------------
    # embed_u8 and embed_fused (kernels B8a and B8b) at DeiT-S and ViT-H, batch 64, against
    # the plain serving embed (embed_from_u8) and the model's embed: in f32 within
    # test_pallas.py's bounds (the u8 normalisation rounds differently: 2e-4), in bf16 two
    # roundings of one function (within 1% relative over the batch).
    check = Checks("phase 5f (embed_u8 / embed_fused end to end)")
    b8 = (kemb.fused_patch_embed_u8, kemb.fused_patch_embed_f)
    for k in b8:  # the counts of this path's run only
        k.launches = 0
    b8_bodies = {"b8a": {"wgmma": 0, "fma": 0}, "b8b": {"wgmma": 0, "fma": 0}}

    def bodies_of(key, fn):
        """fn's output, its launches per body added to b8_bodies[key]"""
        kemb.reset_body_counts()
        out = fn()
        for body, n_ in kemb.body_counts().items():
            b8_bodies[key][body] += n_
        return out

    calls = 0
    u8 = images(64)
    for mname, (mcfg, mparams) in {"deit_s": (cfg, base), "vit_h": (hcfg, base_h)}.items():
        for dname, dt in dtypes.items():
            ep = tree_to(mparams["backbone"]["embed"], dev, dt)
            pix = ((u8.float() / 255.0 - 0.5) / 0.5).to(dt)
            got_u = bodies_of("b8a", lambda: kemb.embed_u8(u8, ep, mcfg))
            got_f = bodies_of("b8b", lambda: kemb.embed_fused(pix, ep, mcfg))
            want_u, want_f = embed_from_u8(u8, ep, mcfg), embed(pix, ep, mcfg)
            torch.cuda.synchronize()
            calls += 1
            shape = (64, mcfg.seq_len, mcfg.hidden_size)
            du = (got_u.float() - want_u.float()).abs().max().item()
            df = (got_f.float() - want_f.float()).abs().max().item()
            if dt == torch.float32:
                tol_u, tol_f = 2e-4, 1e-5 * float(want_f.abs().max()) + 1e-5
                ok = du <= tol_u and df <= tol_f
                bounds_ = f"(tol {tol_u:.1e}, {tol_f:.1e})"
            else:
                ok = rel_err(got_u, want_u) < 0.01 and rel_err(got_f, want_f) < 0.01
                bounds_ = "(bf16: within 1% relative)"
            tag = f"{mname} {dname}"
            log(f"  {tag}: embed_u8 vs embed_from_u8 max_abs_err {du:.3e}, relative "
                f"{rel_err(got_u, want_u):.2e}; embed_fused vs embed max_abs_err {df:.3e}, "
                f"relative {rel_err(got_f, want_f):.2e} {bounds_}")
            check(got_u.shape == got_f.shape == shape and got_u.dtype == got_f.dtype == dt
                  and bool(torch.isfinite(got_u).all() and torch.isfinite(got_f).all()) and ok,
                  tag)
    launches["b8a"], launches["b8b"] = (k.launches for k in b8)
    log(f"  embed path launches: B8a {launches['b8a']}, B8b {launches['b8b']} ({calls} calls each); "
        f"by body B8a {b8_bodies['b8a']}, B8b {b8_bodies['b8b']} (bf16 weights: wgmma)")
    check(launches["b8a"] == calls and launches["b8b"] == calls,
          "a kernel of the path did not launch once per call")
    for key in b8_bodies:  # half the calls in each dtype
        check(b8_bodies[key] == {"wgmma": calls // 2, "fma": calls // 2},
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
            return
        top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
        log(f"  {tag} device ms/forward: " + ", ".join(f"{k} {v:.3f}" for k, v in sums.items())
            + f", other {sum(other.values()):.3f} (top: "
            + "; ".join(f"{k} {v:.3f}" for k, v in top) + f"); busy {busy:.3f} of wall "
            f"{wall_ms:.3f}, idle share {max(0.0, 1 - busy / wall_ms):.3f}")

    # which bf16 GEMM body ran the products of phases 5-5f: the wgmma body wherever TMA
    # can describe A and W; the WMMA body only for a product whose N is no multiple of 8
    bodies = kg.body_counts()
    log(f"  GEMM bodies on the paths of phases 5-5f: wgmma {bodies['wgmma']} launches, WMMA "
        f"{bodies['wmma']} launches, at (M, N, K) "
        + (", ".join(map(str, bodies["wmma_shapes"])) or "none"))
    if bodies["wgmma"] == 0 or any(n % 8 == 0 for _, n, _ in bodies["wmma_shapes"]):
        raise AssertionError(f"phase 6: a product TMA can describe took the WMMA body: {bodies}")
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
            device_breakdown(name, lambda: run("auto"), k_ms)
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
    for s in (99, 197):
        x = torch.randn(512, s, cfg.hidden_size, generator=gen).to(dev, bf)
        k_ms, p_ms = abba(
            lambda: kl.fused_vit_layer_cls_logits(x, lp, f, h, cfg.num_heads),
            lambda: kl.fused_vit_layer_cls_logits_ref(x, lp, f, h, cfg.num_heads))

        def eager_cls():  # the plain path's tail: whole last layer, LN_f, head on CLS
            y = layer_norm(vit_layer(x, lp, cfg), f, cfg.layernorm_eps)[:, 0]
            return y @ h["w"] + h["b"]

        with kernel_mode("eager"):
            e_ms = time_ms(eager_cls)
        d, kw, m = cfg.hidden_size, cfg.attn_width, cfg.mlp_dim
        flops = (2.0 * 512 * s * d * 2 * kw + 2.0 * 512 * (d * kw + kw * d + 2 * d * m + d * 100)
                 + 4.0 * 512 * cfg.num_heads * s * cfg.head_dim)
        nbytes = (x.numel() * x.element_size() + 512 * 100 * 2 + weight_bytes(lp)
                  + weight_bytes(f) + weight_bytes(h))
        b_ms, b_by = bound(flops, nbytes)
        log(f"  B2 deit_s S={s}: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, eager "
            f"last layer + LN_f + head {e_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
        if s == 99:
            kernel_ms["b2"], bounds["b2"] = (k_ms, p_ms, e_ms), (b_ms, b_by)
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
    d, kw, m = hcfg.hidden_size, hcfg.attn_width, hcfg.mlp_dim
    flops = (2.0 * hbatch * 129 * d * 2 * kw + 2.0 * hbatch * (d * kw + kw * d + 2 * d * m + d * 100)
             + 4.0 * hbatch * hcfg.num_heads * 129 * hcfg.head_dim)
    b_ms, b_by = bound(flops, x.numel() * 2 + hbatch * 200 + weight_bytes(hlp) + weight_bytes(fh)
                       + weight_bytes(hh))

    def eager_cls_h():  # the plain path's tail: whole last layer, LN_f, head on CLS
        y = layer_norm(vit_layer(x, hlp, hcfg), fh, hcfg.layernorm_eps)[:, 0]
        return y @ hh["w"] + hh["b"]

    with kernel_mode("eager"):
        e_ms = time_ms(eager_cls_h, **quick)
    log(f"  B2 vit_h S=129: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, eager last layer + "
        f"LN_f + head {e_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
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

    # --- 3l. widths no multiple of the kernels' (C.1), after 6 so that 6's body counts
    # stay those of phases 5-5h ----------------------------------------------------------
    torch.cuda.empty_cache()
    widths_launches = widths_path(dev, base, cfg)

    # --- 5i. the serving export: DeiT-S headline, float and int8 ---------------------------
    exported = export_path(dev, base, cfg, smi)

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
        f"in {gate_run['seconds']:.1f} s")
    pkg = "vit_pruning_tpu_torch"
    rows = (  # key, wrapper, csrc file, the TPU kernel's file and line, launches
        ("b1", "fused_vit_layer", "layer", "layer", 359, launches["b1"] + launches["b1_redecide"]),
        ("b2", "fused_vit_layer_cls_logits", "layer", "layer", 561, launches["b2"]),
        ("b3", "fused_vit_layer_bucketed", "layer", "layer", 761, launches["b3"]),
        ("b4", "fused_vit_layer_int8", "layer_int8", "layer_int8", 154, launches["b4"]),
        ("b5", "fused_vit_encoder", "encoder", "model", 150, launches["b5"]),
        ("b6", "fused_attention", "attention", "attention", 58, launches["b6"]),
        ("b7", "fused_mlp", "mlp", "mlp", 85, launches["b7"]),
        ("b8a", "fused_patch_embed_u8", "embed", "embed", 48, launches["b8a"]),
        ("b8b", "fused_patch_embed_f", "embed", "embed", 125, launches["b8b"]),
    )
    # B4: every launch on the wgmma s8 body, four products each; B8: bf16 weights on wgmma
    by_body = {**bodies67, "b4": {"wgmma_s8": launches["b4"]}, **b8_bodies}
    kernels = [
        {"name": name, "route": "cuda", "source": f"{pkg}/csrc/{src}.cu",
         "replaces": f"vit_pruning_tpu/ops/pallas/{tpu}.py:{line}", "launches": n,
         "max_abs_err": err[key], "ms": kernel_ms[key][0], "plain_ms": kernel_ms[key][1],
         "bound_ms": bounds[key][0], "bound_by": bounds[key][1], "library_ms": kernel_ms[key][2],
         **({"launches_by_body": by_body[key]} if key in by_body else {}),
         **({"products_on_wgmma_s8": launches["b4_s8"]} if key == "b4" else {}),
         **({"launches_train": trained["launches"][key]} if key in trained["launches"] else {}),
         "launches_cli": {run: c[key] for run, c in cli_run["launches"].items()},
         "launches_gate": gate_run["launches"][key],
         "launches_widths": widths_launches[key],
         "launches_export": {run: c[key] for run, c in exported["launches"].items()}}
        for key, name, src, tpu, line, n in rows
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
