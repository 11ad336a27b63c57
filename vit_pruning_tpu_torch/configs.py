"""Typed configuration for models, pruning, and runs — the port's own copy.

The same definitions as vit_pruning_tpu/configs.py (dataclasses, presets and
schedules), kept here so that the port imports and reads nothing of the JAX
package. tests/test_torch_configs.py holds the two copies equal: fields and
defaults, presets, schedules, validation errors and JSON round trips.

The variant of the model *is* a config value (`PruneConfig.predictor` /
`PruneConfig.mode`), and configs are frozen hashable dataclasses.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Architecture of a ViT/DeiT image classifier.

    Numerically matches HuggingFace `ViTModel` + a linear classifier on the
    CLS token (the reference's ModifiedViTModel, himanshu/model_utils.py:183-259):
    pre-LN blocks, erf-exact GELU, layernorm eps 1e-12.
    """

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    num_labels: int = 1000
    layernorm_eps: float = 1e-12
    # qkv_bias matches HF ViT default (qkv_bias=True)
    qkv_bias: bool = True
    # dtype for activations; params are kept in float32 master copy
    dtype: str = "float32"
    # per-head dimension when it is NOT hidden_size // num_heads — set by
    # ops/structured.py::prune_heads (head pruning keeps the original
    # per-head width, so q/k/v project hidden -> num_heads * attn_head_dim
    # < hidden). None = the standard derivation. Keeping this explicit lets
    # key-based predictors reshape correctly and lets the forward path
    # reject a params/config geometry mismatch instead of silently
    # splitting heads at the wrong width.
    attn_head_dim: Optional[int] = None
    # The port's own fields (the JAX package has none of them; their
    # defaults are the plain ViT above, and `to_json` leaves them out where
    # they hold their defaults, so that a plain ViT's JSON is the JAX
    # package's): the MLP ("gelu": Linear -> GELU -> Linear; "swiglu":
    # W_in to 2 mlp_dim, silu(u1) * u2, W_out), LayerScale (a learned
    # per-channel gain on each residual branch), register tokens (learned,
    # after CLS, with no position embedding; never scored, never dropped)
    # and the head ("cls": a linear classifier on CLS; "cls_mean": on CLS
    # concatenated with the mean of the patch tokens, registers left out).
    # The forwards read the block from the layer tree alone (ops/swiglu.py);
    # mlp_kind and layerscale say what init_vit_params draws, what
    # utils/flops.py counts and which tree a config describes, and
    # models/vit.py::check_block raises where tree and config disagree.
    mlp_kind: str = "gelu"
    layerscale: bool = False
    num_registers: int = 0
    head_pool: str = "cls"

    def __post_init__(self):
        if self.mlp_kind not in MLP_KINDS:
            raise ValueError(f"unknown mlp_kind {self.mlp_kind!r} (one of {MLP_KINDS})")
        if self.head_pool not in HEAD_POOLS:
            raise ValueError(f"unknown head_pool {self.head_pool!r} (one of {HEAD_POOLS})")
        if self.num_registers < 0:
            raise ValueError(f"num_registers must be >= 0, got {self.num_registers}")

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1 + self.num_registers  # + CLS (+ registers)

    @property
    def head_dim(self) -> int:
        if self.attn_head_dim is not None:
            return self.attn_head_dim
        return self.hidden_size // self.num_heads

    @property
    def attn_width(self) -> int:
        """Total q/k/v projection width (== hidden_size unless heads were
        physically pruned)."""
        return self.num_heads * self.head_dim

    @property
    def patch_dim(self) -> int:
        return self.num_channels * self.patch_size * self.patch_size

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if k not in PORT_FIELDS or v != PORT_FIELDS[k]}
        return json.dumps(d, indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "ViTConfig":
        return ViTConfig(**json.loads(s))


MLP_KINDS = ("gelu", "swiglu")
HEAD_POOLS = ("cls", "cls_mean")
# the fields of ViTConfig that the JAX package's lacks, with their defaults
PORT_FIELDS = {"mlp_kind": "gelu", "layerscale": False, "num_registers": 0, "head_pool": "cls"}


def port_field(config, name: str):
    """One of PORT_FIELDS of a model config, or its default where the config
    lacks it: the port's functions take the JAX package's ViTConfig too."""
    return getattr(config, name, PORT_FIELDS[name])


def prefix_len(config) -> int:
    """The leading tokens of a model config's sequence that are never scored
    and never dropped: CLS and the registers."""
    return 1 + port_field(config, "num_registers")


# --- Model presets -------------------------------------------------------
# DeiT-T/S/B are the same architecture family at smaller widths (the
# reference's "deit.py" loads the ViT CIFAR-100 checkpoint, mukunda/deit.py:693-700).

def vit_base_patch16_224(num_labels: int = 1000) -> ViTConfig:
    return ViTConfig(num_labels=num_labels)


def deit_tiny(num_labels: int = 1000) -> ViTConfig:
    return ViTConfig(hidden_size=192, num_heads=3, mlp_dim=768, num_labels=num_labels)


def deit_small(num_labels: int = 1000) -> ViTConfig:
    return ViTConfig(hidden_size=384, num_heads=6, mlp_dim=1536, num_labels=num_labels)


def deit_base(num_labels: int = 1000) -> ViTConfig:
    return ViTConfig(num_labels=num_labels)


def vit_large(num_labels: int = 1000) -> ViTConfig:
    """ViT-L/16 @224. Beyond the reference's largest model (ViT-B) — the
    composed preset's speedup grows with width/depth, so this row extends
    the scaling story; same architecture family, no new code paths."""
    return ViTConfig(
        hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096,
        num_labels=num_labels,
    )


def vit_huge(num_labels: int = 1000) -> ViTConfig:
    """ViT-H/14 @224 (632M params, 1.26 GB of bf16 weights); patch 14 ->
    16x16 = 256 patches, seq 257, head dim 80. The port's layer kernels
    (B1-B5) take this geometry, so it serves on the kernel path. Like
    vit_large, beyond the reference's largest model (ViT-B)."""
    return ViTConfig(
        patch_size=14, hidden_size=1280, num_layers=32, num_heads=16,
        mlp_dim=5120, num_labels=num_labels,
    )


def swiglu_hidden(hidden_size: int) -> int:
    """DINOv2's SwiGLU width: 2/3 of 4 D, rounded up to a multiple of 8."""
    return (int(4 * hidden_size * 2 / 3) + 7) // 8 * 8


def dinov2_giant_reg(num_labels: int = 1000) -> ViTConfig:
    """DINOv2 ViT-g/14 with four registers at 518 px
    (facebook/dinov2-with-registers-giant; arXiv:2304.07193, 2309.16588):
    D 1536, 40 layers of 24 heads of 64, a SwiGLU MLP (1536 -> 2 x 4096,
    silu(u1) * u2, 4096 -> 1536), LayerScale, LN eps 1e-6, 4 registers
    after CLS, 37 x 37 patches (S 1374), and the linear-evaluation head on
    CLS ⊕ the patch mean. 1,136,485,376 backbone parameters."""
    return ViTConfig(
        image_size=518, patch_size=14, hidden_size=1536, num_layers=40, num_heads=24,
        mlp_dim=swiglu_hidden(1536), num_labels=num_labels, layernorm_eps=1e-6,
        mlp_kind="swiglu", layerscale=True, num_registers=4, head_pool="cls_mean",
    )


def vit_tiny(num_labels: int = 10) -> ViTConfig:
    """A tiny CPU-testable config (not a published model)."""
    return ViTConfig(
        image_size=32,
        patch_size=8,
        hidden_size=64,
        num_layers=3,
        num_heads=4,
        mlp_dim=128,
        num_labels=num_labels,
    )


# --- Pruning configuration ------------------------------------------------

PRUNE_MODES = (
    "none",      # dense forward, no pruning (reference mlp_needed=False)
    "mask",      # threshold mask on predictor scores; masked attention
                 #   (reference M1/M2 semantics, himanshu/model_utils.py:62-91)
    "topk",      # fixed top-k gather-compaction (M7, pradeep/using_attention.py:136-152)
    "topk_prog", # progressive compaction: dropped tokens never rejoin, the
                 #   sequence physically shrinks per keep_schedule — the
                 #   serving-optimized variant of M7 (no per-layer
                 #   scatter-back; logits only need CLS)
    "oracle",    # ground-truth masking from the similarity oracle itself
                 #   (M3/M11 upper-bound experiments)
    "random",    # random per-layer token pruning baseline
                 #   (M14, pradeep/old codes/random_pruning.py:22-69)
)

PREDICTOR_KINDS = (
    "cls_mlp",       # MLP([CLS ⊕ token]) -> sigmoid score       (M1/M2, cls_mlp.py:45-54)
    "token_mlp",     # MLP(token) -> sigmoid score, no CLS concat (M12, pradeep/final.py:36-45)
    "common_mlp",    # one token MLP shared across all layers     (M6, common_mlp_model_utils.py:76-87)
    "compressor",    # per-token 768->16 compressor + flat MLP over all tokens (M4, all_in_one_model_utils.py:14-51)
    "shared_compressor",  # M5: one compressor shared across layers
    "cnn",           # token->16ch, reshape to 14x14 grid, conv scorer (M16, recap/convprad3.py:507-557)
    "bottleneck",    # MLP [D,32,D,32,1]; middle activation approximates the
                     #   layer output for skipped tokens (M17, recap/prad_final_code.py:146-245)
    "cls_cosine",    # parameter-free heuristic: keep tokens LEAST similar to
                     #   CLS (M10, pradeep/adv_testing_ideas.py:51-100)
    "key_mlp",       # MLP on per-token head-averaged attention-key vectors
                     #   (M8/M9 plumbing, himanshu/midlayer.py:250-330,
                     #    pradeep/key_considerations.py:148-175)
    "key_cosine",    # M9's actual decision rule (parameter-free): PROCESS
                     #   tokens whose head-averaged key vector stays SIMILAR
                     #   between this layer's input and its dense output —
                     #   cosine of find_k_values(layer(x)) vs find_k_values(x)
                     #   > threshold = process (pradeep/key_considerations.py:
                     #   280-298 MaskIt, :330-346 wiring). Score = (cos+1)/2,
                     #   so set mlp_threshold = (reference sim_threshold+1)/2.
    "none",          # no learned predictor (oracle / random / heuristic modes)
)

LOSS_KINDS = (
    "bce_oracle",    # class-balanced BCEWithLogits vs oracle labels (M2, model_utils.py:103-108)
    "mse_cosine",    # MSE(score, 1 - similarity)                    (M1, cls_mlp.py:91-96)
    "mse_attention", # MSE(score, mean CLS->patch attention)         (M7, using_attention.py:209-220)
    "focal",         # focal-weighted BCE, gamma=2                   (M12, pradeep/final.py:79-86)
)


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    """How tokens are scored, selected, and skipped at each layer.

    Mirrors the reference's (sim_threshold, mlp_threshold, avg_threshold,
    top_k) hyperparameters (himanshu/hi_main.py:99-101,
    pradeep/using_attention.py:97 `top_k=150`).
    """

    mode: str = "mask"
    predictor: str = "cls_mlp"
    loss: str = "bce_oracle"
    # similarity oracle threshold: tokens with similarity >= sim_threshold
    # "would not change much" and should be skipped. Either one float (the
    # reference's single st, hi_main.py:96) or a per-layer tuple — layer
    # similarity distributions differ wildly (early layers change every
    # token, late layers almost none), so per-layer calibration keeps the
    # oracle keep-rate comparable across layers (quality.py calibrates to
    # per-layer medians).
    sim_threshold: Union[float, Tuple[float, ...]] = 0.9
    # predictor score threshold for the boolean keep-mask; one float or a
    # per-layer tuple (quality.py calibrates per-layer thresholds so the
    # predicted keep-rate matches each layer's oracle keep-rate — BCE scores
    # are not calibrated probabilities, see losses.py double-sigmoid note)
    mlp_threshold: Union[float, Tuple[float, ...]] = 0.5
    # neighbor-averaging mixing weight for previously-skipped tokens
    # (0 disables; himanshu/model_utils.py:47-51)
    avg_threshold: float = 0.0
    # mode='mask' per-image density cap: after thresholding, keep at most
    # this many highest-scoring above-threshold patch tokens per image
    # (None = uncapped). The reference's typical image keeps the same token
    # set; only fat-tail images get score-ranked truncation — this pins the
    # bucketed execution capacity at budget+1 instead of the batch-max
    # kept-count (a fat binomial tail at ~50% density otherwise sets the
    # bucket ~25% above the mean; see RESULTS.md mask-mode table).
    mask_budget: Optional[int] = None
    # number of patch tokens kept in topk mode (CLS kept in addition)
    top_k: int = 150
    # oracle mixing weight: alpha*cos + (1-alpha)*dist (model_utils.py:100)
    oracle_alpha: float = 0.3
    # predictor hidden width (layer_sizes = [in, hidden, 1], model_utils.py:28)
    predictor_hidden: int = 64
    # which layers get a predictor; None = all (mlp_needed_arr, model_utils.py:126-131)
    active_layers: Optional[Tuple[int, ...]] = None
    # per-layer token-keep budgets for mode="random" (None = use top_k for all)
    random_keep: Optional[Tuple[int, ...]] = None
    # mode="topk_prog": patch tokens kept after each layer's selection
    # (non-increasing; None = drop to top_k at layer 0, keep thereafter)
    keep_schedule: Optional[Tuple[int, ...]] = None
    # what skipped tokens carry forward instead of pure identity:
    #   'none'          — identity residual (M1/M2/M7)
    #   'cls_direction' — x + cls/||cls|| error term (M15 DHSLayer,
    #                     recap/convprad.py:507-548)
    #   'updatenet'     — learned residual update from [token ⊕ CLS]
    #                     (M18, pradeep/old codes/updateNet.py:26-144)
    # (the bottleneck predictor's approximation (M17) is implied by
    #  predictor='bottleneck')
    skip_correction: str = "none"
    # M15 semantics (recap/convprad.py:188-190): prune only QUERY rows —
    # skipped tokens still serve as keys/values for the kept tokens.
    # False = M1/M2 semantics (skipped tokens fully absent from attention).
    query_only: bool = False
    # M13 measurement mode (pradeep/mid2.py:64-70): compute masks and stats
    # but run the full dense layer for all tokens.
    measure_only: bool = False
    # OUR EXTENSION (not in the reference): when the mean keep-score of an
    # image falls below this threshold, that image bypasses the CURRENT
    # layer (identity). 0 disables. For the reference's M8 semantics use
    # skip_next_threshold. Note: in a static XLA program the layer is still
    # computed and deselected per image; FLOP savings need serving-level
    # dynamic batching.
    layer_skip_threshold: float = 0.0
    # M8 whole-layer skipping, reference semantics (himanshu/midlayer.py:
    # 471-523): after each active layer, images whose mean THRESHOLDED keep
    # mask exceeds this value skip the ENTIRE NEXT layer (hidden_states
    # reuse); the skipped layer records an all-ones mask and computes no
    # scores, so two consecutive layers are never skipped. The reference
    # compares torch.mean(boolean_mask) > sim_threshold batch-globally; we
    # generalize to per-image. 0 disables.
    skip_next_threshold: float = 0.0
    # oracle teacher trajectory: 'local' = dense pass from the pruned
    # stream's layer input (M2); 'parallel' = maintain a separate unpruned
    # stream through the whole encoder as the teacher (M19,
    # mukunda/deit.py:241-343 `original` kwarg).
    oracle_stream: str = "local"
    # OUR EXTENSION (ToMe-flavored; not in the reference, whose closest
    # relative is M2's neighbor averaging): in mode='topk_prog', each
    # dropped patch token MERGES (size-weighted average) into its most
    # cosine-similar kept patch token at the compaction point instead of
    # vanishing — information-preserving compaction at identical layer cost
    # (the merge itself is three batched matmuls per drop layer). Token
    # "sizes" accumulate across drops so later merges weight correctly.
    # Read ONLY by the progressive serving paths (progressive_topk_forward,
    # pruned_pipeline_forward); every other mode ignores it — the re-decide
    # modes never physically drop tokens, so internal mode swaps
    # (.replace(mode='oracle'/'mask')) are safe no-ops rather than errors.
    # CLS never merges in either direction.
    merge_dropped: bool = False
    # focal loss parameters (main_model_utils.py:15-38)
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0

    def replace(self, **kw) -> "PruneConfig":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        if self.mode not in PRUNE_MODES:
            raise ValueError(f"mode {self.mode!r} not in {PRUNE_MODES}")
        if self.predictor not in PREDICTOR_KINDS:
            raise ValueError(f"predictor {self.predictor!r} not in {PREDICTOR_KINDS}")
        if self.loss not in LOSS_KINDS:
            raise ValueError(f"loss {self.loss!r} not in {LOSS_KINDS}")
        if self.skip_correction not in ("none", "cls_direction", "updatenet"):
            raise ValueError(f"skip_correction {self.skip_correction!r}")
        if self.oracle_stream not in ("local", "parallel"):
            raise ValueError(f"oracle_stream {self.oracle_stream!r}")
        if self.mode == "topk_prog" and self.predictor in (
            "compressor", "shared_compressor", "cnn"
        ):
            # these heads need the full fixed-N token set (flat MLP over
            # N*16 features / the 14x14 patch grid); progressive compaction
            # shrinks the sequence after the first drop, so any schedule
            # with a later drop would feed them a wrong-sized input
            sched = self.keep_schedule
            if sched is not None and any(sched[1:]):
                raise ValueError(
                    f"predictor {self.predictor!r} requires the full token "
                    "grid and cannot re-score a progressively compacted "
                    "sequence; with mode='topk_prog' use a keep_schedule "
                    "that only drops at layer 0, or a per-token predictor "
                    "(cls_mlp/token_mlp/common_mlp/bottleneck/cls_cosine/"
                    "key_mlp/key_cosine)"
                )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "PruneConfig":
        d = json.loads(s)
        for k in ("active_layers", "random_keep", "keep_schedule",
                  "sim_threshold", "mlp_threshold"):
            if isinstance(d.get(k), list):
                d[k] = tuple(d[k])
        return PruneConfig(**d)


DENSE = PruneConfig(mode="none", predictor="none", loss="bce_oracle")


def composed_schedule(num_patches: int, num_layers: int) -> Tuple[int, ...]:
    """The composed preset's keep schedule (single source of truth for
    bench.py, quality.py and examples): keep 2/3 of patches at layer 0,
    1/3 for the next up-to-4 layers, 1/6 thereafter."""
    n, L = num_patches, num_layers
    return tuple([n * 2 // 3] + [n // 3] * min(4, L - 1)
                 + [n // 6] * max(0, L - 5))


def ultra_schedule(num_patches: int, num_layers: int) -> Tuple[int, ...]:
    """A deeper keep schedule than composed_schedule: keep 1/2 of patches at
    layer 0, 1/6 for the next up-to-4 layers, 1/12 thereafter — roughly
    halves composed's live token counts at every depth. Passes the accuracy
    gate UNMERGED (zero token delta at gate scale, quality.py --preset
    ultra); pairing it with merge_dropped=True is optional and measured
    NEGATIVE on the synthetic gate task (RESULTS.md §merge_dropped)."""
    n, L = num_patches, num_layers
    return tuple([max(1, n // 2)] + [max(1, n // 6)] * min(4, L - 1)
                 + [max(1, n // 12)] * max(0, L - 5))


def _live_to_schedule(live, num_patches: int) -> Tuple[int, ...]:
    """Per-layer live-patch targets -> keep_schedule entries (0 = no drop).
    Live counts must be non-increasing (progressive compaction never re-adds
    tokens); equal-or-larger targets become no-drop entries."""
    sched, cur = [], num_patches
    for v in live:
        if v < cur:
            sched.append(int(v))
            cur = int(v)
        else:
            sched.append(0)
    return tuple(sched)


def token50_schedules(num_patches: int, num_layers: int):
    """Candidate PURE token-skip schedules at mean 50% skip (VERDICT r3 #1):
    every candidate's mean live-patch count over the encoder is num_patches/2
    (up to integer rounding, reported by the bench), with NO head/MLP
    pruning — the configuration the north-star target literally names
    (BASELINE.json: >=3x at 50% skip; reference top-k semantics
    pradeep/using_attention.py:136-152).

    Note the FLOP geometry: at a fixed arithmetic-mean live count, the
    UNIFORM schedule minimizes total FLOPs (the attention term is quadratic
    in S, so E[S^2] >= E[S]^2 — any non-uniform schedule pays a Jensen
    penalty), and it also pays only one scoring/compaction pass. The
    non-uniform candidates exist to MEASURE that argument rather than assert
    it; bench.py --token50_sweep records the matrix."""
    n, L = num_patches, num_layers
    half = n // 2
    out = {"uniform": tuple([half] + [0] * (L - 1))}
    if L % 3 == 0:
        t = L // 3
        # three equal phases at 3n/4 -> n/2 -> n/4 (mean n/2)
        out["stepped"] = _live_to_schedule(
            [3 * n // 4] * t + [half] * t + [n // 4] * t, n)
        # delay all drops: dense first third, deep tail (mean n/2)
        out["late"] = _live_to_schedule([n] * t + [n // 4] * (L - t), n)
    if L % 6 == 0:
        t = L // 6
        # the VERDICT-suggested progressive shape: dense start, deep tail
        out["progressive"] = _live_to_schedule(
            [n] * t + [3 * n // 4] * t + [half] * t + [3 * n // 8] * t
            + [n // 4] * t + [n // 8] * t, n)
    return out


def token50_schedule(num_patches: int, num_layers: int) -> Tuple[int, ...]:
    """The pinned best pure-token-skip schedule at mean 50% skip — the
    config bench.py's token50_* JSON fields measure. Pinned to 'uniform'
    (single drop to n/2 at layer 0 == the headline config) by the round-4
    TPU sweep: measured fastest of the candidates, consistent with the
    Jensen argument in token50_schedules (see RESULTS.md token50 table)."""
    return token50_schedules(num_patches, num_layers)["uniform"]


def schedule_live(schedule: Tuple[int, ...], num_patches: int) -> Tuple[int, ...]:
    """Per-layer live token counts (CLS included) for a keep_schedule:
    0 = no further drop; drops only ever shrink the sequence."""
    live, cur = [], num_patches
    for s in schedule:
        if s and s < cur:
            cur = s
        live.append(cur + 1)
    return tuple(live)
