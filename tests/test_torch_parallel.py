"""The port's parallel package (vit_pruning_tpu_torch/parallel/) against the
JAX package's, case by case as tests/test_parallel.py, on the CPU.

The port runs in gloo ranks spawned by run_ranks (at most 4 a case, grouped
into one spawn of 4 ranks and one of 2, each rank running the functions of
tests/torch_parallel_ranks.py); the JAX package runs its own parallel
functions on the 8 virtual CPU devices of tests/conftest.py. Both take the
same numpy-seeded inputs and the JAX package's init through
models/convert.py::params_from_jax. Bounds are test_parallel.py's: the
train step's loss rtol 1e-5 and its params within 1e-5, forwards rtol =
atol = 2e-5, counts and masks equal. Mode 'random' draws from torch's
generator, so it is held against the port's own single-process step.
A rank that raises or hangs makes run_ranks raise within its deadline.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from dryrun_multichip_torch import MU_FLOOR, MU_RTOL
from vit_pruning_tpu.configs import PruneConfig, ViTConfig
from vit_pruning_tpu.data.datasets import Batches, synthetic_dataset
from vit_pruning_tpu.models.pruned_vit import init_pruned_vit_params
from vit_pruning_tpu.models.vit import init_vit_params
from vit_pruning_tpu.parallel import (
    init_sharded_opt_state,
    make_mesh,
    make_parallel_eval_step,
    make_parallel_serving_step,
    make_parallel_train_step,
    param_pspecs as jax_param_pspecs,
    shard_batch,
    shard_params,
    zero1_pspecs,
)
from vit_pruning_tpu.parallel.pipeline import (
    make_stage_mesh,
    pipeline_forward,
    pruned_pipeline_forward,
)
from vit_pruning_tpu.parallel.sharding import resolve_pspecs
from vit_pruning_tpu.train.freeze import masked_adam
from vit_pruning_tpu_torch.models.convert import flatten_tree, params_from_jax
from vit_pruning_tpu_torch.parallel import param_pspecs, run_ranks
from vit_pruning_tpu_torch.parallel import pipeline as tpipe

CFG = dict(image_size=16, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
           mlp_dim=64, num_labels=4)
PCFG = dict(mode="mask", predictor="cls_mlp", loss="bce_oracle")
# the default sim_threshold (0.9) labels every token of this init alike, so
# every shard's label mean is the batch's; this cut lies inside the layers'
# similarities (none within 6.9e-5 of it) and mixes the labels unequally
# over the data shards: pos_weight taken per rank changes the loss
MIXED = dict(PCFG, sim_threshold=0.99497)
SERVE = dict(mode="topk_prog", predictor="cls_mlp", top_k=2)
RANDOM = dict(mode="random", predictor="cls_mlp", loss="bce_oracle", top_k=2)
PIPE = dict(image_size=16, patch_size=8, hidden_size=32, num_layers=4, num_heads=2,
            mlp_dim=64, num_labels=5)
PIPE_TP = dict(PIPE, num_heads=4)
PRUNED = dict(image_size=16, patch_size=4, hidden_size=32, num_layers=4, num_heads=2,
              mlp_dim=64, num_labels=5)  # 16 patches
DROPS = dict(mode="topk_prog", predictor="cls_mlp", keep_schedule=(10, 0, 6, 0))
CLIP = 0.05
SEED = 7  # mode random's generator


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {"/".join(p): np.asarray(t) for p, t in flatten_tree(_np(tree))}


def _batch(bs=16):
    images, labels = synthetic_dataset(n=bs, image_size=16, num_labels=4)
    return _np(next(iter(Batches(images, labels, batch_size=bs, image_size=16))))


def _x(seed, b, cfg=PIPE):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (b, 3, cfg["image_size"], cfg["image_size"])))


def _pruned(pcfg, cfg=CFG, seed=0):
    return _np(init_pruned_vit_params(jax.random.PRNGKey(seed), ViTConfig(**cfg),
                                      PruneConfig(**pcfg)))


@pytest.fixture(scope="module")
def inputs():
    pp_dp = dict(DROPS, keep_schedule=(10, 6, 0, 0))
    return {
        "params": _pruned(PCFG), "batch": _batch(),
        "random": _pruned(RANDOM),
        "serve": _pruned(SERVE),
        "u8": np.random.RandomState(0).randint(0, 256, (8, 3, 16, 16), np.uint8),
        "head10": _pruned(PCFG, dict(CFG, num_labels=10)),
        "pipe": _np(init_vit_params(jax.random.PRNGKey(0), ViTConfig(**PIPE))),
        "pipe2": _np(init_vit_params(jax.random.PRNGKey(0), ViTConfig(**dict(PIPE,
                                                                             num_layers=2)))),
        "pipe_tp": _np(init_vit_params(jax.random.PRNGKey(0), ViTConfig(**PIPE_TP))),
        "x8": _x(1, 8), "x6": _x(1, 6), "x16": _x(1, 16),
        "drops": (DROPS, _pruned(DROPS, PRUNED)),
        "merge": (dict(DROPS, merge_dropped=True),
                  _pruned(dict(DROPS, merge_dropped=True), PRUNED)),
        # common_mlp with predictor_hidden == num_layers: a [L]-shaped shared leaf
        "shared": (dict(DROPS, predictor="common_mlp", predictor_hidden=4),
                   _pruned(dict(DROPS, predictor="common_mlp", predictor_hidden=4), PRUNED)),
        "pp_dp": (pp_dp, _pruned(pp_dp, PRUNED)),
    }


def _cases4(i):
    p, b = i["params"], i["batch"]
    return [
        ("mesh", "meshes", (), {}),
        ("resolve", "resolve", (i["head10"], 1, 4), {}),
        ("zero1_specs", "resolve", (p, 2, 2), {}),
        ("dp4", "train", (CFG, PCFG, p, b, 4, 1), {}),
        ("dp4_mixed", "train", (CFG, MIXED, p, b, 4, 1), {}),
        ("dp2_mp2", "train", (CFG, PCFG, p, b, 2, 2), {}),
        ("zero1", "train", (CFG, PCFG, p, b, 2, 2), {"zero1": True}),
        ("zero1_clip", "train", (CFG, PCFG, p, b, 2, 2), {"zero1": True, "clip_norm": CLIP}),
        ("eval", "evaluate", (CFG, PCFG, p, b, 4, 1), {}),
        ("serve", "serve", (CFG, SERVE, i["serve"], i["u8"], 2, 2), {}),
        ("random", "train", (CFG, RANDOM, i["random"], b, 2, 2), {"seed": SEED}),
        ("random_single", "train_single", (CFG, RANDOM, i["random"], b), {"seed": SEED}),
        ("random_eval", "evaluate", (CFG, RANDOM, i["random"], b, 4, 1), {}),
        ("pp_dp", "pipeline", (PIPE, i["pipe"], i["x16"], 2, 2), {"data": 2}),
        ("pp_tp", "pipeline", (PIPE_TP, i["pipe_tp"], i["x8"], 2, 4), {"model": 2}),
        ("pruned_pp_dp", "pruned_pipeline", (PRUNED, i["pp_dp"][0], i["pp_dp"][1], i["x16"],
                                             2, 2), {"data": 2}),
    ]


def _cases2(i):
    return [
        ("mp2", "train", (CFG, PCFG, i["params"], i["batch"], 1, 2), {}),
        ("pipe", "pipeline", (PIPE, i["pipe"], i["x8"], 2, 4), {}),
        ("pipe_uneven", "pipeline", (dict(PIPE, num_layers=2), i["pipe2"], i["x6"], 2, 3),
         {}),
    ] + [(name, "pruned_pipeline", (PRUNED, i[name][0], i[name][1], i["x8"], 2, 4), {})
         for name in ("drops", "merge", "shared")]


@pytest.fixture(scope="module")
def spawns(inputs):
    """Both spawns, started at once in the background: the JAX references
    compile while the ranks run."""
    with ThreadPoolExecutor(2) as pool:
        yield {n: pool.submit(run_ranks, ranks.run_cases, n, cases(inputs), device="cpu",
                              timeout_s=200)
               for n, cases in ((4, _cases4), (2, _cases2))}


@pytest.fixture(scope="module")
def jax_steps(inputs):
    """The JAX package's parallel train steps, compiled and run once."""
    for key in ((4, 1), (2, 2), (1, 2), (2, 2, True), (2, 2, True, CLIP), (4, 1, False, None,
                                                                          True)):
        _jax_train(inputs, *key)


@pytest.fixture(scope="module")
def world4(spawns, jax_steps):
    return spawns[4].result()


@pytest.fixture(scope="module")
def world2(spawns, jax_steps):
    return spawns[2].result()


_JAX_STEPS = {}


def _jax_train(inputs, data, model, zero1=False, clip_norm=None, mixed=False):
    """The JAX package's parallel train step on the inputs (once per
    mesh and options in this module); mixed: MIXED's oracle cut."""
    key = (data, model, zero1, clip_norm, mixed)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = _jax_train_once(inputs, *key)
    return _JAX_STEPS[key]


def _jax_train_once(inputs, data, model, zero1, clip_norm, mixed):
    config, pcfg = ViTConfig(**CFG), PruneConfig(**(MIXED if mixed else PCFG))
    mesh = make_mesh(data=data, model=model)
    params = shard_params(jax.tree.map(jnp.asarray, inputs["params"]), mesh)
    opt = masked_adam(params, "vit_mlp_train", 1e-3, clip_norm=clip_norm)
    step = make_parallel_train_step(config, pcfg, "both", opt, mesh, params, zero1=zero1)
    state = (init_sharded_opt_state(opt, params, mesh, zero1=True) if zero1
             else opt.init(params))
    new, state, metrics = step(params, state, shard_batch(inputs["batch"], mesh),
                               jax.random.PRNGKey(1))
    return new, state, metrics


def _moment(state):
    """Adam's mu tree in an optax state."""
    if isinstance(state, dict):
        return state if "backbone" in state else next(
            (m for m in map(_moment, state.values()) if m is not None), None)
    if hasattr(state, "_fields") or isinstance(state, (tuple, list)):
        return next((m for m in map(_moment, state) if m is not None), None)
    return None


def _spec_paths(specs):
    """A JAX PartitionSpec tree as {path: tuple}."""
    return {"/".join(p): tuple(s) for p, s in flatten_tree(jax.tree.map(
        tuple, specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))}


def _tuples(specs):
    return {k: tuple(v) for k, v in specs.items()}


def _same_params(got, want, tol=1e-5):
    want = _flat(want)
    assert got.keys() == want.keys()
    d = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert d < tol, d


def _jax_mu(state):
    """The first moments of a JAX step's optax state by path (frozen
    leaves, empty there, left out)."""
    return {k: v for k, v in _flat(_moment(state)).items() if v.size}


def _same_moments(got, want):
    """Adam's first moments (0.1 g after one step) leaf for leaf, as
    dryrun_multichip_torch.train_checks holds them: within MU_RTOL of the
    leaf's largest |mu|, or of MU_FLOOR of the tree's largest where the
    leaf lies below that (rounding). A gradient summed over the ranks
    instead of averaged misses by 0.5."""
    assert got.keys() == want.keys()
    tops = {k: float(np.abs(v).max()) for k, v in want.items()}
    floor = MU_FLOOR * max(tops.values())
    for k, v in want.items():
        d = float(np.abs(got[k] - v).max())
        assert d <= MU_RTOL * max(tops[k], floor), (k, d, tops[k])


def _ranks_agree(results, name):
    """Every rank ends the step with the same whole params."""
    ref = results[0][name]["params"]
    for r in results[1:]:
        for k in ref:
            np.testing.assert_array_equal(r[name]["params"][k], ref[k])


def test_mesh_shapes(world4):
    res = world4[0]["mesh"]
    assert res["2x2"] == {"data": 2, "model": 2}
    assert res["default"] == {"data": 4, "model": 1}
    assert res["refused"]
    assert "no CUDA device" in res["no_card"]


def test_entry_points_default_to_the_card():
    """run_ranks, like make_mesh in a rank, defaults to device 'cuda' and
    raises at once on a host without a card."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(ranks.meshes, 2)


def test_param_pspecs_cover_tree(inputs, world4):
    """The spec tree is the JAX package's, P(...) as a tuple, leaf for
    leaf; resolve_pspecs replicates a 10-class head on a 4-way model axis
    as there."""
    params = params_from_jax(inputs["params"], "cpu")
    got = {"/".join(p): s for p, s in flatten_tree(param_pspecs(params))}
    assert _tuples(got) == _spec_paths(jax_param_pspecs(jax.tree.map(jnp.asarray,
                                                                     inputs["params"])))
    jres = _spec_paths(resolve_pspecs(jax.tree.map(jnp.asarray, inputs["head10"]),
                                      make_mesh(1, 4)))
    assert _tuples(world4[0]["resolve"]["resolve"]) == jres
    assert jres["backbone/head/w"] == ()


def test_zero1_and_moment_pspecs_match_jax(inputs, world4):
    """zero1_pspecs at data 2 x model 2 is the JAX package's leaf for leaf
    ('data' on the first free divisible axis, beside 'model'), and
    opt_state_shardings gives the params' own specs or ZeRO-1's."""
    params = jax.tree.map(jnp.asarray, inputs["params"])
    mesh = make_mesh(2, 2)
    got = world4[0]["zero1_specs"]
    want = _spec_paths(zero1_pspecs(params, mesh))
    assert _tuples(got["zero1"]) == want == _tuples(got["opt_zero1"])
    assert _tuples(got["opt"]) == _spec_paths(resolve_pspecs(params, mesh))
    assert want["backbone/layers/mlp/fc1/w"] == ("data", None, "model")


@pytest.mark.parametrize("data,model,mixed", [(4, 1, False), (2, 2, False), (1, 2, False),
                                              (4, 1, True)])
def test_parallel_train_step_matches_jax(inputs, world4, world2, data, model, mixed):
    """The bce_oracle train step, loss rtol 1e-5, params within 1e-5, the
    same on every rank, Adam's first moments those of the JAX step's
    state; with MIXED's labels pos_weight per rank fails it."""
    name, results = {(4, 1, False): ("dp4", world4), (2, 2, False): ("dp2_mp2", world4),
                     (1, 2, False): ("mp2", world2),
                     (4, 1, True): ("dp4_mixed", world4)}[(data, model, mixed)]
    new, state, metrics = _jax_train(inputs, data, model, mixed=mixed)
    got = results[0][name]
    np.testing.assert_allclose(float(got["metrics"]["loss"]), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["metrics"]["accuracy"]), float(metrics["accuracy"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(got["metrics"]["confusion"], np.asarray(metrics["confusion"]))
    _same_params(got["params"], new)
    _same_moments(got["mu"], _jax_mu(state))
    _ranks_agree(results, name)


def test_opt_state_moments_co_sharded_with_params(inputs, world4):
    """Without ZeRO a moment has the shape of its param's slice on every
    rank: the JAX step's moment shards, fc1 column-sharded over 'model'."""
    _, state, _ = _jax_train(inputs, 2, 2)
    mu = _moment(state)["backbone"]["layers"]["mlp"]["fc1"]["w"]
    assert mu.sharding.spec == jax.sharding.PartitionSpec(None, None, "model")
    for r in world4:
        res = r["dp2_mp2"]
        assert res["moments"].keys() <= res["local"].keys()
        for k, (m, v) in res["moments"].items():
            assert m == v == res["local"][k]
        assert res["local"]["backbone/layers/mlp/fc1/w"] == mu.sharding.shard_shape(mu.shape)


@pytest.mark.parametrize("clip", [False, True])
def test_zero1_moments_shard_over_data_and_match(inputs, world4, clip):
    """ZeRO-1 at data 2 x model 2: each rank's moments are the JAX zero1
    step's shards (fc1 over 'data' and 'model', the LN gain over 'data');
    params within 1e-5 of JAX's zero1 step and of the port's non-ZeRO step,
    the gathered first moments those of JAX's state.
    With clip_norm the clip takes the global norm."""
    res = world4
    name = "zero1_clip" if clip else "zero1"
    new, state, metrics = _jax_train(inputs, 2, 2, zero1=True, clip_norm=CLIP if clip else None)
    got = res[0][name]
    np.testing.assert_allclose(float(got["metrics"]["loss"]), float(metrics["loss"]), rtol=1e-5)
    _same_params(got["params"], new)
    _same_moments(got["mu"], _jax_mu(state))
    if not clip:
        _same_params(got["params"], res[0]["dp2_mp2"]["params"])
    _ranks_agree(res, name)
    mu = _moment(state)["backbone"]["layers"]
    for r in res:
        moments = r[name]["moments"]
        for key, leaf in (("mlp/fc1/w", mu["mlp"]["fc1"]["w"]), ("ln1/g", mu["ln1"]["g"])):
            shard = leaf.sharding.shard_shape(leaf.shape)
            assert shard != leaf.shape
            assert moments[f"backbone/layers/{key}"] == (shard, shard)


def test_parallel_eval_step(inputs, world4):
    """correct, confusion and the gathered keep_masks equal the JAX
    package's data-8 eval step on the same batch."""
    config, pcfg = ViTConfig(**CFG), PruneConfig(**PCFG)
    mesh = make_mesh(data=4, model=1)
    params = shard_params(jax.tree.map(jnp.asarray, inputs["params"]), mesh)
    step = make_parallel_eval_step(config, pcfg, mesh, params, full_testing=True)
    want = step(params, shard_batch(inputs["batch"], mesh))
    for r in world4:
        got = r["eval"]["parallel"]
        assert int(got["correct"]) == int(want["correct"])
        np.testing.assert_array_equal(got["confusion"], np.asarray(want["confusion"]))
        np.testing.assert_array_equal(got["keep_masks"], np.asarray(want["keep_masks"]))
        assert got["confusion"].shape == (CFG["num_layers"], 2, 2)


def test_parallel_serving_step_matches_jax(inputs, world4):
    """Batch-sharded uint8 serving (data 2 x model 2) == the JAX package's
    serving step, rtol = atol = 2e-5."""
    config, pcfg = ViTConfig(**CFG), PruneConfig(**SERVE)
    mesh = make_mesh(data=2, model=4)
    params = jax.tree.map(jnp.asarray, inputs["serve"])
    want = make_parallel_serving_step(config, pcfg, mesh, params)(
        shard_params(params, mesh), jnp.asarray(inputs["u8"]))
    np.testing.assert_allclose(world4[0]["serve"], np.asarray(want), rtol=2e-5, atol=2e-5)


def test_mode_random_matches_single_process(world4):
    """Mode random at data 2 x model 2 draws the whole batch's noise on
    every rank and keeps its rows: the port's single-process step and eval
    (torch's generator; JAX's draws other bits)."""
    res = world4[0]
    got, want = res["random"], res["random_single"]
    np.testing.assert_allclose(float(got["metrics"]["loss"]), float(want["metrics"]["loss"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(got["metrics"]["confusion"], want["metrics"]["confusion"])
    _same_params(got["params"], {k: v for k, v in want["params"].items()})
    _same_moments(got["mu"], want["mu"])
    ev = res["random_eval"]
    np.testing.assert_array_equal(ev["parallel"]["keep_masks"], ev["single"]["keep_masks"])
    assert int(ev["parallel"]["correct"]) == int(ev["single"]["correct"])


def _jax_pipeline(cfg, params, x, mesh, microbatches):
    return np.asarray(jax.jit(lambda p, v: pipeline_forward(
        p, v, ViTConfig(**cfg), mesh, num_microbatches=microbatches))(params, jnp.asarray(x)))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["pipe", "pipe_uneven", "pp_dp", "pp_tp"])
def test_pipeline_forward_matches_jax(inputs, world4, world2, case):
    """GPipe over 2 stages: 4 layers in 4 microbatches, 2 layers in 3
    (uneven), pp x dp (stage 2 x data 2) and pp x tp (stage 2 x model 2),
    against the JAX package's pipeline and the port's single-process
    forward, on every rank of the mesh."""
    cfg, params, x, mesh, m = {
        "pipe": (PIPE, inputs["pipe"], inputs["x8"], make_stage_mesh(2), 4),
        "pipe_uneven": (dict(PIPE, num_layers=2), inputs["pipe2"], inputs["x6"],
                        make_stage_mesh(2), 3),
        "pp_dp": (PIPE, inputs["pipe"], inputs["x16"], make_stage_mesh(2, data=2), 2),
        "pp_tp": (PIPE_TP, inputs["pipe_tp"], inputs["x8"], make_stage_mesh(2, model=2), 4),
    }[case]
    want = _jax_pipeline(cfg, params, x, mesh, m)
    results = world4 if case in ("pp_dp", "pp_tp") else world2
    for r in results:
        _close(r[case]["got"], want)
        _close(r[case]["got"], r[case]["want"])


@pytest.mark.parametrize("case", ["drops", "merge", "shared", "pp_dp"])
def test_pruned_pipeline_matches_jax(inputs, world4, world2, case):
    """The topk_prog pipeline over 2 stages: drops at layers 0 and 2 (the
    second at stage 1's first layer), the same with merge_dropped (sizes
    cross the hop), a common_mlp predictor whose shared leaf has leading
    dim L, and pp x dp (stage 2 x data 2) with drops at layers 0 and 1;
    against the JAX package's pruned pipeline and the port's
    single-process progressive forward."""
    pcfg, params = inputs[case]
    mesh, m, x = ((make_stage_mesh(2, data=2), 2, inputs["x16"]) if case == "pp_dp"
                  else (make_stage_mesh(2), 4, inputs["x8"]))
    want = np.asarray(jax.jit(lambda p, v: pruned_pipeline_forward(
        p, v, ViTConfig(**PRUNED), PruneConfig(**pcfg), mesh, num_microbatches=m))(
        params, jnp.asarray(x)))
    results = world4 if case == "pp_dp" else world2
    key = "pruned_pp_dp" if case == "pp_dp" else case
    for r in results:
        _close(r[key]["got"], want)
        _close(r[key]["got"], r[key]["want"])


def test_stage_mesh_rejects_data_and_model_together():
    with pytest.raises(ValueError, match="not both"):
        tpipe.make_stage_mesh(2, data=2, model=2, device="cpu")


def test_a_failing_rank_fails_the_run():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*fails on purpose"):
        run_ranks(ranks.fail_on_rank, 2, 1, device="cpu", timeout_s=60)
    assert time.perf_counter() - t0 < 60


def test_a_hanging_rank_times_out():
    t0 = time.perf_counter()
    # rank 0 returns at once, unless this host is so loaded that it has not
    # started within the deadline either
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\] of 2 did not finish"):
        run_ranks(ranks.hang_on_rank, 2, 1, device="cpu", timeout_s=8)
    assert time.perf_counter() - t0 < 8 + 15
