"""The port's span recorder (vit_pruning_tpu_torch/utils/profiling.py) and
the spans of the served forward, on the CPU: off it records nothing and
costs no clock read; on, spans nest under one call id per served call, lie
on torch.profiler's exported clock, and stay out of an exported program."""

import json
import time
import tracemalloc

import pytest
import torch

from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode
from vit_pruning_tpu_torch.serving import export_serving, serving_forward
from vit_pruning_tpu_torch.utils import profiling

CFG = ViTConfig(image_size=32, patch_size=8, hidden_size=32, num_layers=3, num_heads=2,
                mlp_dim=64, num_labels=4)
TOP_K = 8  # of 16 patches, before layer 0


@pytest.fixture(autouse=True)
def _clean_recorder():
    profiling.take()
    yield
    profiling.set_tracing(False)
    profiling.take()


def _setup(top_k=TOP_K):
    pcfg = (PruneConfig(mode="topk_prog", predictor="cls_mlp", top_k=top_k) if top_k
            else PruneConfig(mode="topk_prog", keep_schedule=(0,) * CFG.num_layers))
    params = init_pruned_vit_params(CFG, pcfg, torch.Generator().manual_seed(0), device="cpu")
    pixels = torch.randint(0, 256, (2, 3, 32, 32), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    return pcfg, params, pixels


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def test_off_records_nothing_reads_no_clock_and_allocates_nothing(monkeypatch):
    shared = profiling.span("serve")  # recording is off by default
    assert profiling.span("layers", rows=34) is shared

    def refused(*args, **kwargs):
        raise AssertionError("a span did work while recording was off")
    monkeypatch.setattr(time, "time_ns", refused)
    monkeypatch.setattr(profiling, "_Span", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    for _ in range(3):
        with profiling.span("layers", rows=36):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with profiling.span("layers", rows=36):
                pass
        after = tracemalloc.take_snapshot().compare_to(before, "filename")
    finally:
        tracemalloc.stop()
    grown = [d for d in after if d.traceback[0].filename == profiling.__file__ and d.size_diff]
    assert grown == []
    assert profiling.take() == {"spans": [], "dropped": 0}


def test_on_spans_nest_share_a_call_id_and_take_clears():
    with profiling.tracing():
        for _ in range(2):
            with profiling.span("serve"):
                with profiling.span("layers", rows=4356):
                    with profiling.span("prep"):
                        pass
                with profiling.span("outputs"):
                    pass
    taken = profiling.take()
    assert taken["dropped"] == 0
    spans = taken["spans"]
    assert [s["name"] for s in spans] == ["serve", "layers", "prep", "outputs"] * 2
    assert [s["parent"] for s in spans] == [None, 0, 1, 0, None, 4, 5, 4]
    assert [s["call"] for s in spans[:4]] == [spans[0]["call"]] * 4
    assert spans[4]["call"] == spans[0]["call"] + 1
    assert spans[1]["rows"] == 4356
    assert spans[0]["rows"] is None
    for s in spans:
        assert s["start"] <= s["end"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start"] <= s["start"] and s["end"] <= p["end"]
    assert profiling.take() == {"spans": [], "dropped": 0}


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAPACITY", 3)
    with profiling.tracing():
        with profiling.span("serve"):
            for _ in range(4):
                with profiling.span("outputs"):
                    pass
        with profiling.span("serve"):
            pass
    taken = profiling.take()
    assert len(taken["spans"]) == 3 and taken["dropped"] == 3
    assert all(s["end"] is not None for s in taken["spans"])


def test_no_span_takes_the_kernel_operators_prefix():
    with profiling.tracing():
        with pytest.raises(ValueError, match="vpt::"):
            profiling.span("vpt::fused_vit_layer")


@pytest.mark.parametrize("top_k", [TOP_K, 0], ids=["headline", "dense"])
def test_serving_forward_records_its_stages_in_one_call(top_k):
    """One serve span per call, its stages inside it in order; the layers
    after `select` run the kept tokens (the schedule's top k and CLS); the
    last layer runs in `head` (B2's route, its plain version here); the
    logits are those of the call unrecorded."""
    pcfg, params, pixels = _setup(top_k)
    want = serving_forward(params, pixels, CFG, pcfg)["logits"]
    with profiling.tracing():
        got = [serving_forward(params, pixels, CFG, pcfg)["logits"] for _ in range(2)]
    for g in got:
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    spans = profiling.take()["spans"]
    roots = [i for i, s in enumerate(spans) if s["parent"] is None]
    assert [spans[i]["name"] for i in roots] == ["serve", "serve"]
    one = [s for s in spans if s["call"] == spans[roots[0]]["call"]]
    names = [s["name"] for s in one]
    L = CFG.num_layers
    if top_k:
        assert names == (["serve", "embed", "prep", "select"] + ["outputs"] * L
                         + ["layers", "head", "outputs"])
        assert one[4 + L]["rows"] == 2 * (TOP_K + 1) * (L - 1)
    else:
        assert names == ["serve", "embed", "prep"] + ["outputs"] * L + ["layers", "head",
                                                                        "outputs"]
        assert one[3 + L]["rows"] == 2 * (CFG.num_patches + 1) * (L - 1)
    assert all(s["parent"] == 0 for s in one[1:])


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_the_kernel_route_records_each_wrappers_preparation(quant):
    """In kernel mode on meta tensors (the operators' fake implementations),
    each layer kernel's call prepares its weights in a `prep` span inside
    `layers`, and B2's inside `head`."""
    pcfg, params, pixels = _setup()
    with kernel_mode("kernel"), profiling.tracing():
        serving_forward(_meta(params), pixels.to("meta"), CFG, pcfg, quant=quant)
    spans = profiling.take()["spans"]
    under = [spans[s["parent"]]["name"] for s in spans if s["name"] == "prep"]
    assert under == ["serve"] + ["layers"] * (CFG.num_layers - 1) + ["head"]


def test_spans_lie_on_the_profilers_exported_clock(tmp_path):
    """Inside a CPU torch.profiler run, the `select` span's own stamps hold
    the operators it runs on the exported clock (ts x 1000 +
    baseTimeNanoseconds): its keep selection's cumsum, and every operator
    inside starts and ends within 100 us of the stamps."""
    from torch.profiler import ProfilerActivity, profile

    pcfg, params, pixels = _setup()
    serving_forward(params, pixels, CFG, pcfg)
    with profiling.tracing():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            serving_forward(params, pixels, CFG, pcfg)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    exported = json.loads(path.read_text())
    base = exported["baseTimeNanoseconds"]
    ops = [(e["name"], e["ts"] * 1000 + base, (e["ts"] + e["dur"]) * 1000 + base)
           for e in exported["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    (sel,) = [s for s in profiling.take()["spans"] if s["name"] == "select"]
    inside = [(name, a, b) for name, a, b in ops if sel["start"] <= a and b <= sel["end"]]
    cumsum = [op for op in ops if op[0] == "aten::cumsum"]
    assert cumsum and all(op in inside for op in cumsum)
    assert min(a for _, a, _ in inside) - sel["start"] <= 100_000
    assert sel["end"] - max(b for _, _, b in inside) <= 100_000


def test_an_exported_serving_program_holds_no_span():
    """Recording on while torch.export traces: nothing is recorded and the
    graph is the one traced with recording off, with no profiler node."""
    pcfg, params, _ = _setup()

    def targets(program):
        return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    with kernel_mode("kernel"):
        plain = export_serving(_meta(params), CFG, pcfg, batch_size=2)
        with profiling.tracing():
            traced = export_serving(_meta(params), CFG, pcfg, batch_size=2)
    assert profiling.take() == {"spans": [], "dropped": 0}
    assert targets(traced) == targets(plain)
    assert not [t for t in targets(traced) if "profiler" in t or "record_function" in t]
