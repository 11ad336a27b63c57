"""The `dinov2` model family on the CPU: its sizes and operation count at the
benchmark's configuration, a tiny DINOv2 cell (D 64, 2 heads, SwiGLU M 176,
3 layers, 16 patches, 4 registers) added as files and run through the
program's plain versions judged `correct`, the family's reference against
the program's own (vit_pruning_tpu_torch/reference/dinov2.py), and faults
planted in the program that the output check has to catch: LayerScale's
gains ignored, the gate's halves swapped, a register dropped at the
selection, the registers in the head's mean, another image's logits."""

import json

import pytest
import torch

from portbench import cells, harness, work
from portbench.tests.test_portbench_harness import BENCH, MIX, run_tiny, tiny_root

TINY = {"source": "a tiny DINOv2 for the CPU tests", "family": "dinov2", "hidden_size": 64,
        "num_hidden_layers": 3, "num_attention_heads": 2, "mlp_ratio": 4,
        "use_swiglu_ffn": True, "layerscale_value": 1.0, "num_register_tokens": 4,
        "image_size": 56, "patch_size": 14, "num_channels": 3, "layer_norm_eps": 1e-6,
        "qkv_bias": True, "num_labels": 16, "predictor": {"kind": "cls_mlp", "hidden": 16},
        "image_mean": 0.5, "image_std": 0.5, "reduced": []}


def test_the_configuration_reads_its_published_sizes():
    cell = cells.load_cell("dinov2_g14_reg.headline.bf16.b32")
    m, fam = cell["model"], cell["family"]
    assert fam is cells.family(BENCH, "dinov2")
    assert (m["hidden"], m["layers"], m["heads"], m["head_dim"], m["mlp"]) == (1536, 40, 24, 64,
                                                                               4096)
    assert (m["patches"], m["prefix"], m["labels"], m["patch_dim"]) == (1369, 5, 1000, 588)
    sched = harness.prune_schedule(cell)
    assert sched[0] == 684 and work.live_tokens(m, sched) == ([689] * 40, [(0, 1374)])
    # 40 x 39.0 GFLOP of products and 40 x 2.92 of attention at S 689, the embed, the
    # predictor over 1369 patches and the 3072-wide head
    assert fam.model_flops(m, sched) == pytest.approx(1.680e12, rel=1e-3)
    assert [p["name"] for p in cell["per_layer"]] == ["dispatch_ms", "other_device_ms", "step_mfu",
                                                     "device_idle_share", "b1_swiglu_roofline"]


def test_b1_swiglu_roofline_counts_the_gated_fc1_twice_as_wide():
    m = cells.load_cell("dinov2_g14_reg.headline.bf16.b32")["model"]
    fam = cells.family(BENCH, "dinov2")
    d, mlp = 1536, 4096
    flops = 2.0 * 32 * 689 * (4 * d * d + 3 * d * mlp) + 4.0 * 32 * 24 * 689 ** 2 * 64
    assert fam.b1_bound(m, 32, 689) == pytest.approx(flops / work.PEAK_BF16_FLOPS)
    read = cells.reader(BENCH, "b1_swiglu_roofline")
    assert read({"trace": None, "model": m}) is None
    rec = {"ops": [{"name": "vpt::fused_vit_layer", "dims": [[32, 689, d]]}],
           "device_ops": [{"op": 0, "start": 0.0, "end": 2 * fam.b1_bound(m, 32, 689)}]}
    assert read({"trace": rec, "model": m}) == pytest.approx(50.0)


def dino_root(tmp):
    return tiny_root(tmp, cfg=TINY)


def test_a_tiny_dinov2_cell_runs_correct(tmp_path):
    cell = cells.load_cell("tiny.mix", dino_root(tmp_path))
    m = cell["model"]
    assert (m["prefix"], m["patches"], m["mlp"]) == (5, 16, 176)
    result, info = run_tiny(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and info["checked_images"] == MIX["pool"] * MIX["batch"]


def test_the_familys_reference_is_the_programs():
    """families/dinov2.py's frozen copy against the package's plain reference
    on the same float32 weights, with the reference's own top k."""
    from vit_pruning_tpu_torch.configs import ViTConfig
    from vit_pruning_tpu_torch.reference import dinov2 as ref

    fam = cells.family(BENCH, "dinov2")
    m = fam.dims(TINY)
    params = fam.make_params(m, 2 ** 31 + 3, "cpu", torch.float32)
    pixels = harness.weights.make_pool(m, MIX, 3, "cpu")[0]
    sched = work.schedule(m, 0.5)
    cfg = ViTConfig(image_size=56, patch_size=14, hidden_size=64, num_layers=3, num_heads=2,
                    mlp_dim=176, layernorm_eps=1e-6, num_registers=4)
    a = fam.forward(params, pixels, m, sched)
    b = ref.forward(params, pixels, cfg, sched)
    assert torch.equal(a["keep_masks"], b["keep_masks"])
    torch.testing.assert_close(a["logits"], b["logits"], atol=1e-5, rtol=0)


def _ones_for_gains(cell, params):
    lay = params["backbone"]["layers"]
    lay = dict(lay, ls1=torch.ones_like(lay["ls1"]), ls2=torch.ones_like(lay["ls2"]))
    return harness.program_call(cell, dict(params, backbone=dict(params["backbone"], layers=lay)))


def _halves_swapped(cell, params):
    lay = params["backbone"]["layers"]
    fc1 = lay["mlp"]["fc1"]
    w1, w2 = fc1["w"].chunk(2, dim=-1)
    b1, b2 = fc1["b"].chunk(2, dim=-1)
    mlp = dict(lay["mlp"], fc1={"w": torch.cat([w2, w1], -1), "b": torch.cat([b2, b1], -1)})
    return harness.program_call(cell, dict(params, backbone=dict(
        params["backbone"], layers=dict(lay, mlp=mlp))))


def _another_images_logits(cell, params):
    call = harness.program_call(cell, params)

    def served(pixels):
        out = call(pixels)
        out["logits"][1] = out["logits"][0]
        return out
    return served


def _register_dropped(monkeypatch):
    """The selection keeps CLS and three registers, and one more patch in the
    fourth register's place."""
    from vit_pruning_tpu_torch.models import pruned_vit
    from vit_pruning_tpu_torch.ops.masking import rank_keep_mask

    def faulty(scores, k, prefix=1):
        b = scores.shape[0]
        lead = torch.ones((b, prefix), dtype=torch.bool)
        lead[:, -1] = False
        mask = torch.cat([lead, rank_keep_mask(scores, k + 1)], dim=1)
        cidx = torch.sort((~mask).long() * mask.shape[1] + torch.arange(mask.shape[1]),
                          dim=1).indices[:, :k + prefix]
        return mask, cidx
    monkeypatch.setattr(pruned_vit, "_keep_projection", faulty)


def _registers_in_the_mean(monkeypatch):
    from vit_pruning_tpu_torch.models import pruned_vit

    monkeypatch.setattr(pruned_vit, "pooled", lambda x, config: torch.cat(
        [x[:, 0], x[:, 1:].mean(dim=1)], dim=-1))


SERVED_FAULTS = {"gains_ignored": _ones_for_gains, "gate_halves_swapped": _halves_swapped,
                 "another_images_logits": _another_images_logits}
PATCHED_FAULTS = {"register_dropped": _register_dropped,
                  "registers_in_the_mean": _registers_in_the_mean}


@pytest.mark.parametrize("fault", sorted(SERVED_FAULTS) + sorted(PATCHED_FAULTS))
def test_faults_planted_in_the_program_make_the_run_incorrect(tmp_path, monkeypatch, fault):
    cell = cells.load_cell("tiny.mix", dino_root(tmp_path))
    serve = SERVED_FAULTS.get(fault)
    if fault in PATCHED_FAULTS:
        PATCHED_FAULTS[fault](monkeypatch)
    broken, _ = run_tiny(cell, serve=serve)
    assert not broken["correct"], broken["checks"]
    assert broken["failed"] > 0
    if fault == "register_dropped":  # the keep masks show it, whatever the logits
        assert broken["checks"]["mask_faults"]["value"] > 0


def test_the_benchmark_lists_the_dinov2_cell_and_its_metric():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    metric = {p["name"]: p for p in bench["per_layer"]}["b1_swiglu_roofline"]
    assert metric["workloads"] == ["dinov2_g14_reg.headline.bf16.b32"]
    work_ = {w["name"]: w for w in bench["workloads"]}["dinov2_g14_reg.headline.bf16.b32"]
    assert (work_["config"], work_["traffic"], work_["chips"]) == ("dinov2_g14_reg",
                                                                  "headline.bf16.b32", 1)
