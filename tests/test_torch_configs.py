"""The port's own configs (vit_pruning_tpu_torch/configs.py) against the JAX
package's: the same fields and defaults, presets, schedules, validation
errors and JSON."""

import dataclasses

import pytest

import vit_pruning_tpu.configs as jc
import vit_pruning_tpu_torch.configs as tc


def _fields(cls):
    return [(f.name, f.default, f.type) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ViTConfig", "PruneConfig"])
def test_dataclass_fields_equal(name):
    """The JAX package's fields, in its order; the port's ViTConfig adds its
    own after them (tc.PORT_FIELDS: the MLP kind, LayerScale, registers,
    the head), whose defaults are the JAX package's plain ViT."""
    own = _fields(getattr(tc, name))
    extra = tc.PORT_FIELDS if name == "ViTConfig" else {}
    assert own[:len(own) - len(extra)] == _fields(getattr(jc, name))
    assert {n: d for n, d, _ in own[len(own) - len(extra):]} == extra


def test_kinds_and_dense_equal():
    for name in ("PRUNE_MODES", "PREDICTOR_KINDS", "LOSS_KINDS"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert dataclasses.asdict(tc.DENSE) == dataclasses.asdict(jc.DENSE)


@pytest.mark.parametrize("preset", ["deit_tiny", "deit_small", "deit_base",
                                    "vit_base_patch16_224", "vit_large", "vit_huge", "vit_tiny"])
def test_presets_equal(preset):
    for labels in (10, 100, 1000):
        t, j = getattr(tc, preset)(labels), getattr(jc, preset)(labels)
        own = dataclasses.asdict(t)
        assert {k: own.pop(k) for k in tc.PORT_FIELDS} == tc.PORT_FIELDS
        assert own == dataclasses.asdict(j)
        assert t.to_json() == j.to_json()
        assert (t.grid_size, t.num_patches, t.seq_len, t.head_dim, t.attn_width, t.patch_dim) == \
            (j.grid_size, j.num_patches, j.seq_len, j.head_dim, j.attn_width, j.patch_dim)


@pytest.mark.parametrize("n,L", [(196, 12), (16, 3), (256, 32), (196, 24), (49, 6), (4, 1)])
def test_schedules_equal(n, L):
    for fn in ("composed_schedule", "ultra_schedule", "token50_schedule", "token50_schedules"):
        assert getattr(tc, fn)(n, L) == getattr(jc, fn)(n, L), fn
    sched = tc.composed_schedule(n, L)
    assert tc.schedule_live(sched, n) == jc.schedule_live(sched, n)
    live = [n, 3 * n // 4, 3 * n // 4, n // 2, n, n // 8][: L]
    assert tc._live_to_schedule(live, n) == jc._live_to_schedule(live, n)


BAD = [dict(mode="nope"), dict(predictor="nope"), dict(loss="nope"),
       dict(skip_correction="nope"), dict(oracle_stream="nope"),
       dict(mode="topk_prog", predictor="cnn", keep_schedule=(8, 4, 0))]


@pytest.mark.parametrize("kw", BAD, ids=[next(iter(k)) + ("_prog" if len(k) > 1 else "")
                                          for k in BAD])
def test_validation_errors_equal(kw):
    with pytest.raises(ValueError) as want:
        jc.PruneConfig(**kw)
    with pytest.raises(ValueError) as got:
        tc.PruneConfig(**kw)
    assert str(got.value) == str(want.value)


def test_json_round_trips_agree():
    pcfg = dict(mode="mask", predictor="bottleneck", mlp_threshold=(0.4, 0.5, 0.6),
                sim_threshold=0.8, mask_budget=7, active_layers=(0, 2), random_keep=(3, 4, 5),
                keep_schedule=(8, 4, 0), skip_correction="cls_direction", query_only=True)
    t, j = tc.PruneConfig(**pcfg), jc.PruneConfig(**pcfg)
    assert t.to_json() == j.to_json()
    assert dataclasses.asdict(tc.PruneConfig.from_json(j.to_json())) == dataclasses.asdict(t)
    assert dataclasses.asdict(jc.PruneConfig.from_json(t.to_json())) == dataclasses.asdict(j)
    v = tc.vit_tiny().replace(attn_head_dim=8)
    assert v.to_json() == jc.vit_tiny().replace(attn_head_dim=8).to_json()
    assert tc.ViTConfig.from_json(v.to_json()) == v
