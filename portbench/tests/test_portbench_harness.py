"""The harness on the CPU at a tiny size: finding cells by files, the
yardstick's counts, the reference against the program, the import check,
the result line, the trace's attribution, and planted faults that the
output check has to catch."""

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench import cells, harness, reference, run, trace, work

BENCH = Path(__file__).resolve().parents[1]
TINY = {"source": "a tiny ViT for the CPU tests", "hidden_act": "gelu", "hidden_size": 64,
        "image_size": 32, "intermediate_size": 128, "layer_norm_eps": 1e-12,
        "num_attention_heads": 4, "num_channels": 3, "num_hidden_layers": 3, "patch_size": 8,
        "qkv_bias": True, "num_labels": 16, "predictor": {"kind": "cls_mlp", "hidden": 16},
        "image_mean": 0.5, "image_std": 0.5, "reduced": []}
MIX = {"batch": 4, "pool": 3, "in_flight": 2, "dtype": "float32",
       "quant": "none", "keep_fraction": 0.5, "trace_batches": 4}
# float32 against float32: the two sides differ by the order of their sums
F32_LIMITS = {"logit_err": 1e-4, "logit_err_median": 1e-4, "score_err": 1e-4,
              "cut_violation": 1e-4, "mask_faults": 0}
NEW_METRIC = '''
def read(records):
    return float(records["window"]["batches"])
'''


def tiny_root(tmp: Path, mix: dict = MIX, limits: dict = F32_LIMITS, cfg: dict = TINY) -> Path:
    """A checkout holding only a tiny cell, a metric of its own and a copy of
    the benchmark's metric readers and model families: everything added as
    files."""
    pb = tmp / "bench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True)
    shutil.copytree(BENCH / "metrics", pb / "metrics")
    shutil.copytree(BENCH / "families", pb / "families")
    (pb / "metrics" / "batches_served.py").write_text(NEW_METRIC)
    (pb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "mix.json").write_text(json.dumps(mix))
    (pb / "limits" / "tiny.mix.json").write_text(json.dumps(limits))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "x", "file": "bench/configs/tiny.json",
                         "reduced": [], "why": "tests"}]
    bench["workloads"] = [{"name": "tiny.mix", "config": "tiny", "traffic": "mix", "chips": 1,
                           "why": "tests"}]
    bench["per_layer"] = [{"name": "batches_served", "unit": "1", "better": "higher",
                           "source": "host_clock", "layer": "entry", "moves": "img_per_s"}]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run_tiny(cell, seed=2 ** 31 + 5, serve=None, seconds=0.2):
    return harness.run_cell(cell, seed, seconds, False, torch.device("cpu"), time.perf_counter(),
                            serve=serve)


def test_a_cell_added_as_files_is_found_and_run(tmp_path):
    cell = cells.load_cell("tiny.mix", tiny_root(tmp_path))
    assert cell["model"]["patches"] == 16 and cell["traffic"]["batch"] == 4
    assert [m["name"] for m in cell["per_layer"]] == ["batches_served"]
    result, info = run_tiny(cell)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"img_per_s", "batch_p95_ms", "setup_s"}
    records = {"window": {"batches": 7}}
    assert cells.reader(cell["bench_dir"], "batches_served")(records) == 7.0


def test_result_line_has_the_contract_keys_and_checks_last(tmp_path):
    result, _ = run_tiny(cells.load_cell("tiny.mix", tiny_root(tmp_path)))
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["attempted"] > 0 and result["failed"] == 0
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_model_flops_match_the_served_path():
    def dims(name):
        return cells.model_dims(json.loads((BENCH / "configs" / f"{name}.json").read_text()))

    deit, vith = dims("deit_s"), dims("vit_h14")
    assert work.model_flops(deit, work.schedule(deit, 0.5)) == pytest.approx(4.2167e9, rel=1e-3)
    assert work.model_flops(deit, work.schedule(deit, None)) == pytest.approx(8.5603e9, rel=1e-3)
    assert work.model_flops(vith, work.schedule(vith, 0.5)) == pytest.approx(161.24e9, rel=1e-3)
    # the last layer as B2 computes it: K and V over the live tokens, the rest on CLS
    whole = work.layer_flops(deit, 1, 197)
    assert whole - work.cls_flops(deit, 1, 197) + 2 * 384 * 1000 == pytest.approx(
        work.products(deit, 196) + work.attention(deit, 6 * 196 * 197) - 2 * 196 * 384 * 768)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_reference_agrees_with_the_programs_plain_path(quant):
    """The port's entry on CPU tensors (the kernels' plain versions, in the
    default kernel mode) against the reference: float32 weights, so the two
    differ by rounding alone; under int8 both quantize the same float32
    values, and codes that round apart move the logits by about an int8 step."""
    m = cells.model_dims(TINY)
    cell = {"model": m, "traffic": dict(MIX, quant=quant)}
    params = harness.weights.make_params(m, 11, "cpu", torch.float32)
    pixels = harness.weights.make_pool(m, MIX, 11, "cpu")[0]
    sched = work.schedule(m, 0.5)
    got = harness.program_call(cell, params)(pixels)
    ref = reference.forward(params, pixels, m, sched, "int8" if quant == "int8" else "f32")
    assert torch.equal(got["keep_masks"], ref["keep_masks"])
    live = torch.isfinite(ref["scores"])
    assert torch.equal(torch.isfinite(got["scores"]), live)
    assert torch.allclose(got["scores"][live], ref["scores"][live], atol=1e-5)
    rel = (got["logits"] - ref["logits"]).norm() / ref["logits"].norm()
    assert rel < (1e-4 if quant == "int8" else 1e-5), rel


def test_import_check_compares_whole_top_level_names():
    loaded = ["jax.numpy", "jaxlib.xla_client", "flax.linen", "vit_pruning_tpu.models",
              "vit_pruning_tpu_torch.serving", "jaxtyping", "vit_pruning_tpu_torch", "torch"]
    assert harness.forbidden_modules(loaded) == ["flax", "jax", "jaxlib", "vit_pruning_tpu"]
    assert harness.forbidden_modules(["vit_pruning_tpu_torch.ops", "jaxtyping", "numpy"]) == []


def test_run_without_a_card_exits_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "deit_s.headline.bf16.b512", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def _answer_altered(cell, params):
    call = harness.program_call(cell, params)

    def fault(pixels):
        out = dict(call(pixels))
        out["logits"] = out["logits"].clone()
        out["logits"][1] = out["logits"][0]  # one image gets another's answer
        return out
    return fault


def _selection_inverted(monkeypatch):
    from vit_pruning_tpu_torch.models import pruned_vit

    keep = pruned_vit.rank_keep_mask
    monkeypatch.setattr(pruned_vit, "rank_keep_mask", lambda s, k: keep(-s, k))


def _rows_swapped(monkeypatch):
    """Compaction gathers the first dropped token in place of the last kept one."""
    from vit_pruning_tpu_torch.models import pruned_vit

    drop = pruned_vit.progressive_drop

    def fault(x, pred, i, k, config, pcfg, layer_params=None):
        xc, scores, cidx = drop(x, pred, i, k, config, pcfg, layer_params=layer_params)
        kept = torch.zeros(x.shape[:2], dtype=torch.bool).scatter(1, cidx, True)
        other = (~kept).to(torch.int64).argmax(1)
        xc = xc.clone()
        xc[:, -1] = x[torch.arange(x.shape[0]), other]
        return xc, scores, cidx
    monkeypatch.setattr(pruned_vit, "progressive_drop", fault)



@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("fault", ["answer_altered", "selection_inverted", "layer_skipped",
                                   "rows_swapped"])
def test_planted_faults_make_the_run_incorrect(tmp_path, monkeypatch, fault, quant):
    """A run with the timed path broken underneath comes out not correct
    (the look for a card skipped: the program on CPU tensors)."""
    cell = cells.load_cell("tiny.mix", tiny_root(tmp_path, dict(MIX, quant=quant)))
    if quant == "int8":  # the int8 reference and the program round codes apart
        cell["limits"] = dict(F32_LIMITS, logit_err=2e-3, logit_err_median=2e-3)
    sound, _ = run_tiny(cell)
    assert sound["correct"], sound["checks"]
    serve = None
    if fault == "answer_altered":
        serve = _answer_altered
    elif fault == "selection_inverted":
        _selection_inverted(monkeypatch)
    elif fault == "rows_swapped":
        _rows_swapped(monkeypatch)
    else:
        from vit_pruning_tpu_torch.models import pruned_vit

        layer = pruned_vit.vit_layer
        calls = []

        def skip_second(x, p, c, **kw):  # the last whole layer of every forward
            calls.append(1)
            return x if len(calls) % (c.num_layers - 1) == 0 else layer(x, p, c, **kw)
        monkeypatch.setattr(pruned_vit, "vit_layer", skip_second)
    broken, _ = run_tiny(cell, serve=serve)
    assert not broken["correct"], broken["checks"]
    assert broken["failed"] > 0


def test_trace_attribution_from_a_chrome_trace():
    """Device operations are placed by their launch's host time: in the batch
    span and in the vpt:: operator span around it."""
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
                "args": args}
    ev = [x("user_annotation", "portbench.batch", 0, 100),
          x("user_annotation", "portbench.batch", 200, 100),
          x("cpu_op", "vpt::fused_vit_layer", 210, 20, **{"Input Dims": [[8, 99, 384]]}),
          x("cuda_runtime", "cudaLaunchKernel", 215, 2, correlation=7),
          x("kernel", "layer_kernel", 230, 50, tid=7, correlation=7),
          x("cuda_runtime", "cudaLaunchKernel", 240, 2, correlation=8),
          x("kernel", "topk_kernel", 290, 10, tid=7, correlation=8),
          x("user_annotation", "portbench.copy", 250, 10),
          x("cuda_runtime", "cudaMemcpyAsync", 252, 2, correlation=9),
          x("gpu_memcpy", "Memcpy DtoH", 300, 5, tid=7, correlation=9),
          x("kernel", "early_kernel", 150, 40, tid=7, correlation=3)]
    rec = trace.records(ev, 1)
    assert rec["stretch"]["batches"] == 1 and rec["unplaced"] == 1
    by = {d["name"]: d for d in rec["device_ops"]}
    assert by["layer_kernel"]["op"] == 0 and by["layer_kernel"]["batch"] == 0
    assert by["topk_kernel"]["op"] is None and not by["topk_kernel"]["harness"]
    assert by["Memcpy DtoH"]["harness"]
    assert by["early_kernel"]["batch"] is None
    assert rec["stretch"]["t1"] == pytest.approx(105e-6)
    share = trace.op_share(rec, "vpt::fused_vit_layer", lambda dims: 25e-6 * dims[0][0] / 8)
    assert share == pytest.approx(50.0)


def test_device_timeline_counts_batches_by_their_answer_copies():
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 7, "args": {}}
    copy = trace.ANSWER_COPY
    ev = [x("kernel", "a", 0, 40), x("gpu_memcpy", copy, 40, 10),  # the filling batch
          x("kernel", "a", 50, 40), x("kernel", "b", 100, 20), x("gpu_memcpy", copy, 120, 10),
          x("kernel", "a", 140, 40), x("gpu_memcpy", copy, 180, 20)]
    tl = trace.device_timeline(ev, 1)
    assert tl["batches"] == 2 and tl["t1"] == pytest.approx(150e-6)
    assert trace.busy(tl) == pytest.approx(130e-6)  # idle 90-100 and 130-140 us
    host = {"device_ops": [{"start": 0.0, "end": 1e-5}, {"start": 2e-5, "end": 3e-5}],
            "stretch": {"t0": 0.0, "t1": 3e-5},
            "host": [(0.0, 3e-5, "portbench.batch"), (1e-5, 2e-5, "aten::topk")]}
    bd = trace.breakdown(tl, host)
    assert bd["device_ops"][0] == ["a", pytest.approx(80e-6)]
    assert bd["idle_gaps"] == [["aten::topk", pytest.approx(1e-5)]]


def test_a_batch_waits_behind_the_batches_in_flight_ahead():
    from portbench.serve import Server

    def call(pixels):
        time.sleep(0.002)
        return {"logits": pixels.float().sum(1, keepdim=True), "keep_masks": [], "scores": []}

    w = Server(call, torch.zeros(3, 4, 5, dtype=torch.uint8), 2).run(batches=7)
    lat, svc = w["latency_ms"], w["service_ms"]
    assert len(lat) == len(svc) == 7
    assert lat[:2] == svc[:2]  # nothing ahead of the window's first two
    # batch n runs from batch n-2's answer: its own service, batch n-1's and the gaps
    for n in range(2, 7):
        assert lat[n] >= svc[n] + svc[n - 1]


# limits of the tiny cell in bf16, set as the benchmark's are: between the
# largest reading of 12 sound seeds (2**31 + 1..12) and the smallest of the
# control on 3 (2**31 + 101..103), on this CPU: logit_err 0.0080 / 0.069,
# logit_err_median 0.0050 / 0.053, score_err 0.0041 / 0.017, cut_violation
# 0.0028 / 0.0070; under int8 logit_err 0.019 / 0.198, median 0.011 / 0.114
TINY_LIMITS = {"none": {"logit_err": 0.02, "logit_err_median": 0.012, "score_err": 0.008,
                        "cut_violation": 0.005, "mask_faults": 0},
               "int8": {"logit_err": 0.05, "logit_err_median": 0.03, "score_err": 0.008,
                        "cut_violation": 0.005, "mask_faults": 0}}


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_the_control_fails_where_the_program_passes(tmp_path, quant):
    """The tiny cell served in bf16: the program passes its limits, and the
    reference one precision step below in its place (float8 e4m3; 4-bit
    weights in the int8 layers) fails them."""
    from portbench import control

    cell = cells.load_cell("tiny.mix", tiny_root(tmp_path, dict(MIX, dtype="bfloat16", quant=quant),
                                                  TINY_LIMITS[quant]))
    for seed in (1, 2, 3):
        sound, _ = run_tiny(cell, 2 ** 31 + seed, seconds=0.05)
        assert sound["correct"], sound["checks"]
    for seed in (101, 102, 103):
        ctl, _ = run_tiny(cell, 2 ** 31 + seed, serve=control.control(cell), seconds=0.05)
        assert not ctl["correct"], ctl["checks"]


# the model family seam: the sizes the parent's cells.model_dims gave the two
# configurations, before the family's `prefix` was added
PARENT_DIMS = {
    "deit_s": {"hidden": 384, "heads": 6, "head_dim": 64, "attn_width": 384, "mlp": 1536,
               "layers": 12, "labels": 1000, "eps": 1e-12, "image": 224, "patch": 16,
               "channels": 3, "patches": 196, "patch_dim": 768, "predictor": "cls_mlp",
               "predictor_hidden": 64, "image_mean": 0.5, "image_std": 0.5},
    "vit_h14": {"hidden": 1280, "heads": 16, "head_dim": 80, "attn_width": 1280, "mlp": 5120,
                "layers": 32, "labels": 1000, "eps": 1e-12, "image": 224, "patch": 14,
                "channels": 3, "patches": 256, "patch_dim": 588, "predictor": "cls_mlp",
                "predictor_hidden": 64, "image_mean": 0.5, "image_std": 0.5},
}
CELL_FLOPS = {"deit_s.headline.bf16.b512": 4.2167e9, "vit_h14.headline.bf16.b64": 161.24e9,
              "deit_s.dense.bf16.b512": 8.5603e9, "deit_s.headline.int8.b1024": 4.2167e9}


@pytest.mark.parametrize("name", sorted(CELL_FLOPS))
def test_the_vit_family_reads_the_cells_as_before(name):
    """Each cell's configuration is a `vit` (it names no family): the same
    sizes as before plus `prefix` 1, the same operations per image."""
    cell = cells.load_cell(name)
    assert cell["family"] is cells.family(BENCH, "vit")
    assert cell["model"] == dict(PARENT_DIMS[cell["workload"]["config"]], prefix=1)
    assert cells.model_dims(cell["config"]) == cell["model"]
    sched = harness.prune_schedule(cell)
    assert cell["family"].model_flops(cell["model"], sched) == pytest.approx(CELL_FLOPS[name],
                                                                             rel=1e-3)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, path + (key,))
    else:
        yield path, tree


def test_the_vit_family_route_is_bitwise_the_frozen_copies(tmp_path):
    """The weights and the reference through a cell's family (loaded by path)
    against portbench/weights.py and reference.py called directly."""
    from portbench import weights

    cell = cells.load_cell("tiny.mix", tiny_root(tmp_path))
    m, fam = cell["model"], cell["family"]
    got = dict(_leaves(fam.make_params(m, 2 ** 31 + 7, "cpu", torch.float32)))
    want = dict(_leaves(weights.make_params(m, 2 ** 31 + 7, "cpu", torch.float32)))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert (leaf is None and got[path] is None) or torch.equal(got[path], leaf), path
    params = weights.make_params(m, 3, "cpu", torch.float32)
    pixels = weights.make_pool(m, MIX, 3, "cpu")[0]
    sched = harness.prune_schedule(cell)
    for products in ("f32", "fp8"):
        a = fam.forward(params, pixels, m, sched, products, products)
        b = reference.forward(params, pixels, m, sched, products, products)
        for key in ("logits", "keep_masks", "scores"):
            assert torch.equal(a[key], b[key]), (products, key)


# A model family added as a file alone: a pre-LN ViT with register tokens
# after CLS (no position embedding on them), whose head reads CLS ⊕ the mean
# of the live patch tokens after the final LN. Its program is its own float32
# forward, with the faults the tests plant in it.
TOY_FAMILY = '''
import math

import torch

from portbench import reference, work

FAULT = None  # a fault planted in `program` (the tests' FAULTS)


def dims(cfg):
    d, heads, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_register_tokens"]
    grid = cfg["image_size"] // cfg["patch_size"]
    return {"hidden": d, "heads": heads, "head_dim": d // heads, "attn_width": d,
            "mlp": cfg["intermediate_size"], "layers": cfg["num_hidden_layers"],
            "labels": cfg["num_labels"], "eps": cfg["layer_norm_eps"],
            "image": cfg["image_size"], "patch": cfg["patch_size"],
            "channels": cfg["num_channels"], "patches": grid * grid,
            "patch_dim": cfg["num_channels"] * cfg["patch_size"] ** 2,
            "predictor": "cls_mlp", "predictor_hidden": cfg["predictor"]["hidden"],
            "image_mean": cfg["image_mean"], "image_std": cfg["image_std"],
            "registers": r, "prefix": 1 + r}


def make_params(m, seed, device, dtype):
    gen = torch.Generator(device=device).manual_seed(seed)
    d, mlp, L, h = m["hidden"], m["mlp"], m["layers"], m["predictor_hidden"]

    def mat(*shape):
        return torch.randn(shape, generator=gen, device=device) / math.sqrt(shape[-2])

    def vec(*shape, base=0.0):
        return base + 0.1 * torch.randn(shape, generator=gen, device=device)

    lin = lambda k, n: {"w": mat(L, k, n), "b": vec(L, n)}
    tree = {"backbone": {
        "embed": {"patch": {"w": mat(m["patch_dim"], d), "b": vec(d)}, "cls": vec(1, 1, d),
                  "reg": vec(1, m["registers"], d), "pos": vec(1, m["patches"] + 1, d)},
        "layers": {"ln1": {"g": vec(L, d, base=1.0), "b": vec(L, d)},
                   "ln2": {"g": vec(L, d, base=1.0), "b": vec(L, d)},
                   "attn": {n: lin(d, d) for n in "qkvo"},
                   "mlp": {"fc1": lin(d, mlp), "fc2": lin(mlp, d)}},
        "ln_f": {"g": vec(d, base=1.0), "b": vec(d)},
        "head": {"w": mat(2 * d, m["labels"]), "b": vec(m["labels"])}},
        "predictor": {"mlp": {"l0": lin(2 * d, h), "l1": lin(h, 1)}}}

    def cast(t):
        return {k: cast(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dtype)
    return cast(tree)


def _scores(x, pred, i, p, products):
    get = reference._layer(pred["mlp"], i)
    t = x[:, p:]
    z = torch.cat([x[:, :1].expand(-1, t.shape[1], -1), t], dim=-1)
    hid = torch.relu(reference.linear(z, get("l0", "w"), get("l0", "b"), products))
    return torch.sigmoid(reference.linear(hid, get("l1", "w"), get("l1", "b"), products))[..., 0]


def _model(params, pixels_u8, m, sched, layers, other, follow, fault):
    bb, L, p = params["backbone"], m["layers"], m["prefix"]
    with reference.exact_f32():
        x = reference.embed(pixels_u8, bb["embed"], m, other)
        b = x.shape[0]
        x = torch.cat([x[:, :1], bb["embed"]["reg"].float().expand(b, -1, -1), x[:, 1:]], dim=1)
        s = cur = x.shape[1]
        orig = torch.arange(s, device=x.device).expand(b, s)
        masks, all_scores = [], []
        for i in range(L):
            k = sched[i]
            sc = torch.full((b, s - p), float("-inf"), device=x.device)
            if k and k < cur - p:
                s_live = _scores(x, params["predictor"], i, p, other)
                sc.scatter_(1, orig[:, p:] - p, s_live)
                keep = (torch.gather(follow[i], 1, orig) if follow is not None else
                        torch.cat([torch.ones_like(s_live[:, :p], dtype=torch.bool),
                                   reference.top_k(s_live, k)], dim=1))
                n = k + p
                if fault == "register_dropped":
                    keep[:, 1:p], n = False, k + 1
                elif fault == "register_for_a_patch":  # the count kept
                    keep[:, 1:p] = False
                    keep[:, p:] = reference.top_k(s_live, k + p - 1)
                rank = (~keep).to(torch.int64) * cur + torch.arange(cur, device=x.device)
                idx = torch.sort(rank, dim=1).indices[:, :n]
                x = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
                orig, cur = torch.gather(orig, 1, idx), n
            all_scores.append(sc)
            masks.append(torch.zeros((b, s), dtype=torch.bool, device=x.device)
                         .scatter(1, orig, True))
            x = reference.block(x, reference._layer(bb["layers"], i), m, layers)
        x = reference.layer_norm(x, bb["ln_f"]["g"], bb["ln_f"]["b"], m["eps"])
        pooled = x.mean(1) if fault == "mean_over_prefix" else x[:, p:].mean(1)
        logits = reference.linear(torch.cat([x[:, 0], pooled], dim=-1), bb["head"]["w"],
                                  bb["head"]["b"], other)
    return {"logits": logits, "keep_masks": torch.stack(masks), "scores": torch.stack(all_scores)}


def forward(params, pixels_u8, m, sched, layers="f32", other="f32", follow=None):
    return _model(params, pixels_u8, m, sched, layers, other, follow, None)


def model_flops(m, sched):
    live, drops = work.live_tokens(m, sched)
    d, h = m["hidden"], m["predictor_hidden"]
    total = 2.0 * m["patches"] * m["patch_dim"] * d + 2.0 * 2 * d * m["labels"]
    total += sum(work.layer_flops(m, 1, t) for t in live)
    return total + sum(2.0 * (cur - m["prefix"]) * (2 * d * h + h) for _, cur in drops)


def program(cell, params, quant=None):
    m, fault = cell["model"], FAULT
    sched = work.schedule(m, cell["traffic"]["keep_fraction"])

    def call(pixels):
        out = _model(params, pixels, m, sched, "f32", "f32", None, fault)
        if fault == "answer_altered":
            out["logits"][1] = out["logits"][0]
        return out
    return call
'''
TOY_CFG = dict(TINY, family="toy_reg", num_register_tokens=1)


def toy_root(tmp: Path) -> Path:
    root = tiny_root(tmp, cfg=TOY_CFG)
    (root / "bench" / "families" / "toy_reg.py").write_text(TOY_FAMILY)
    return root


def test_a_family_added_as_a_file_is_found_and_runs_correct(tmp_path):
    cell = cells.load_cell("tiny.mix", toy_root(tmp_path))
    m, fam = cell["model"], cell["family"]
    assert fam.__file__ == str(tmp_path / "bench" / "families" / "toy_reg.py")
    assert m["prefix"] == 2 and m["patches"] == 16
    sched = harness.prune_schedule(cell)
    assert work.live_tokens(m, sched) == ([10, 10, 10], [(0, 18)])
    assert fam.model_flops(m, sched) > 0
    result, info = run_tiny(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and info["checked_images"] == MIX["pool"] * MIX["batch"]
    assert result["checks"]["mask_faults"]["value"] == 0


@pytest.mark.parametrize("fault", ["register_dropped", "register_for_a_patch", "mean_over_prefix",
                                   "answer_altered"])
def test_faults_planted_in_a_familys_program_make_the_run_incorrect(tmp_path, monkeypatch, fault):
    """A register dropped at the selection (with the count short, or with a
    patch in its place), the head's mean over the prefix tokens too, and
    another image's logits."""
    cell = cells.load_cell("tiny.mix", toy_root(tmp_path))
    monkeypatch.setattr(cell["family"], "FAULT", fault)
    broken, _ = run_tiny(cell)
    assert not broken["correct"], broken["checks"]
    assert broken["failed"] > 0
    if fault.startswith("register"):  # the keep masks show it, whatever the logits
        assert broken["checks"]["mask_faults"]["value"] > 0


def test_a_configuration_naming_a_family_with_no_file_is_refused(tmp_path):
    root = tiny_root(tmp_path, cfg=dict(TINY, family="no_such_family"))
    path = root / "bench" / "families" / "no_such_family.py"
    with pytest.raises(FileNotFoundError, match=str(path)):
        cells.load_cell("tiny.mix", root)
