"""The port's re-decide serving path (vit_pruning_tpu_torch/models/pruned_vit.py::
pruned_vit_forward) against the JAX package's (use_pallas=False,
quant='none'), float32 on the CPU: keep masks exact, scores atol 1e-5,
logits atol 1e-4 + rtol 1e-4, layer inputs where asked.

A keep mask is only comparable where no score sits on its cut: every case
asserts that the smallest gap between a score and its threshold, its rank
cut or its layer-skip threshold is above 1e-6 in the JAX run. Random
predictor weights put every score near 0.5, so each kind's weights are
scaled (GAIN) to spread them; mask-mode thresholds are per-layer medians of
a measure_only probe, as bench.py calibrates them.

mode='random' cannot share JAX's random bits, so it is held to properties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, as_torch, init_pruned, jax_and_torch_params, randn
from vit_pruning_tpu.configs import PREDICTOR_KINDS, PruneConfig, vit_tiny
from vit_pruning_tpu.models.pruned_vit import pruned_vit_forward as jax_forward
from vit_pruning_tpu.models.vit import vit_layer as jax_vit_layer
from vit_pruning_tpu.ops.masking import similarity_oracle
from vit_pruning_tpu_torch.models import pruned_vit as tp
from vit_pruning_tpu_torch.models.vit import layer_slice, vit_layer
from vit_pruning_tpu_torch.ops.cuda import layer as tl
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode

MIN_GAP = 1e-6
GAIN = {"cls_mlp": 10.0, "token_mlp": 10.0, "common_mlp": 10.0, "compressor": 10.0,
        "shared_compressor": 10.0, "cnn": 3.0, "bottleneck": 10.0, "key_mlp": 30.0}
CFG = vit_tiny()
N, L = CFG.num_patches, CFG.num_layers


def _params(pcfg, seed=0):
    params = init_pruned(CFG, pcfg, seed)
    g = GAIN.get(pcfg.predictor, 1.0)
    if params["predictor"] is not None:
        params["predictor"] = jax.tree.map(lambda a: a * g, params["predictor"])
    return params


def _pixels(seed=1, b=4):
    return randn(seed, (b, 3, CFG.image_size, CFG.image_size))


def _run_jax(jparams, x, pcfg, **kw):
    return jax_forward(jparams, jnp.asarray(x), CFG, pcfg, use_pallas=False, quant="none", **kw)


def _calibrated(jparams, x, pcfg):
    """Per-layer median thresholds from a measure_only probe."""
    probe = _run_jax(jparams, x, pcfg.replace(mlp_threshold=0.5, mask_budget=None,
                                              measure_only=True, skip_next_threshold=0.0))
    return pcfg.replace(mlp_threshold=tuple(float(np.median(s))
                                            for s in np.asarray(probe["scores"])))


def _rank_gap(vals: np.ndarray, k: int) -> float:
    """Gap between the k-th and (k+1)-th largest finite value of each row
    (inf where a row has no (k+1)-th)."""
    srt = -np.sort(-vals, axis=-1)
    if k >= vals.shape[-1]:
        return np.inf
    top, nxt = srt[:, k - 1], srt[:, k]
    with np.errstate(invalid="ignore"):  # rows with fewer than k + 1 finite values
        gap = np.where(np.isfinite(nxt), top - nxt, np.inf)
    return float(gap.min())


def _min_gap(want, pcfg, jparams) -> float:
    scores = np.asarray(want["scores"])
    gaps = [np.inf]
    for i in range(L):
        if pcfg.mode == "none" or (pcfg.active_layers is not None and i not in pcfg.active_layers):
            continue
        sc = scores[i]
        if pcfg.mode == "mask":
            thr = pcfg.mlp_threshold[i] if isinstance(pcfg.mlp_threshold, tuple) \
                else pcfg.mlp_threshold
            gaps.append(float(np.abs(sc - thr).min()))
            if pcfg.mask_budget is not None:
                gaps.append(_rank_gap(np.where(sc >= thr, sc, -np.inf), pcfg.mask_budget))
        elif pcfg.mode == "topk":
            gaps.append(_rank_gap(sc, pcfg.top_k))
        elif pcfg.mode == "oracle":
            xi = want["layer_inputs"][i]
            dense = jax_vit_layer(xi, jax.tree.map(lambda a: a[i], jparams["backbone"]["layers"]),
                                  CFG, use_pallas=False, quant="none")
            sim = np.asarray(similarity_oracle(xi[:, 1:], dense[:, 1:], pcfg.oracle_alpha))
            gaps.append(float(np.abs(sim - pcfg.sim_threshold[i]).min()))
        if pcfg.layer_skip_threshold > 0:
            gaps.append(float(np.abs(sc.mean(1) - pcfg.layer_skip_threshold).min()))
    return min(gaps)


def _oracle_thresholds(jparams, x):
    """Per-layer median similarity along the dense trajectory."""
    dense = _run_jax(jparams, x, PruneConfig(mode="none", predictor="none"),
                     return_layer_inputs=True)
    out = []
    for i in range(L):
        xi = dense["layer_inputs"][i]
        y = jax_vit_layer(xi, jax.tree.map(lambda a: a[i], jparams["backbone"]["layers"]), CFG,
                          use_pallas=False, quant="none")
        out.append(float(np.median(np.asarray(similarity_oracle(xi[:, 1:], y[:, 1:])))))
    return tuple(out)


def _compare(pcfg, *, layer_inputs=False, calibrate=False, mode="auto", seed=0):
    params = _params(pcfg, seed)
    jparams, tparams = jax_and_torch_params(params)
    x = _pixels()
    if calibrate:
        pcfg = _calibrated(jparams, x, pcfg)
    if pcfg.mode == "oracle":
        pcfg = pcfg.replace(sim_threshold=_oracle_thresholds(jparams, x))
        layer_inputs = True
    if pcfg.layer_skip_threshold > 0:
        # between the images' mean scores at layer 0, so that some images skip
        means = np.asarray(_run_jax(jparams, x, pcfg.replace(layer_skip_threshold=0.0))
                           ["scores"][0]).mean(-1)
        pcfg = pcfg.replace(layer_skip_threshold=float(np.median(means)))
    want = _run_jax(jparams, x, pcfg, return_layer_inputs=layer_inputs)
    gap = _min_gap(want, pcfg, jparams)
    assert gap > MIN_GAP, gap
    with kernel_mode(mode):
        got = tp.pruned_vit_forward(tparams, as_torch(x), CFG, pcfg,
                                    return_layer_inputs=layer_inputs)
    np.testing.assert_array_equal(got["keep_masks"].numpy(), np.asarray(want["keep_masks"]))
    np.testing.assert_allclose(as_numpy(got["scores"]), np.asarray(want["scores"]), atol=1e-5)
    np.testing.assert_allclose(as_numpy(got["logits"]), np.asarray(want["logits"]),
                               atol=1e-4, rtol=1e-4)
    if layer_inputs:
        np.testing.assert_allclose(as_numpy(got["layer_inputs"]),
                                   np.asarray(want["layer_inputs"]), atol=1e-4)
    return got, want


MODES = {
    "mask": (PruneConfig(mode="mask"), True),
    "mask_budget": (PruneConfig(mode="mask", mask_budget=6), True),
    "topk": (PruneConfig(mode="topk", top_k=8), False),
    "oracle": (PruneConfig(mode="oracle", predictor="none"), False),
    "none": (PruneConfig(mode="none", predictor="none"), False),
    "measure_only": (PruneConfig(mode="mask", measure_only=True), True),
    "query_only": (PruneConfig(mode="mask", query_only=True), True),
    "cls_direction": (PruneConfig(mode="topk", top_k=8, skip_correction="cls_direction"), False),
    "updatenet": (PruneConfig(mode="mask", mask_budget=6, skip_correction="updatenet"), True),
    "bottleneck": (PruneConfig(mode="topk", top_k=7, predictor="bottleneck"), False),
    "avg_threshold": (PruneConfig(mode="topk", top_k=8, avg_threshold=0.3), False),
    "layer_skip": (PruneConfig(mode="topk", top_k=8, layer_skip_threshold=0.5), False),
    "skip_next": (PruneConfig(mode="mask", skip_next_threshold=0.45), True),
    "active_layers": (PruneConfig(mode="mask", active_layers=(0, 2)), True),
}


@pytest.mark.parametrize("name", list(MODES))
def test_redecide_matches_jax(name):
    pcfg, calibrate = MODES[name]
    _compare(pcfg, calibrate=calibrate, layer_inputs=name in ("mask", "none", "skip_next"))


@pytest.mark.parametrize("kind", [k for k in PREDICTOR_KINDS if k != "none"])
def test_every_predictor_kind_matches_jax(kind):
    _compare(PruneConfig(mode="topk", top_k=8, predictor=kind))


@pytest.mark.parametrize("mode", ["mask_budget", "topk"])
def test_eager_mode_matches_jax(mode):
    """kernel mode 'eager': the capped layers take the plain gather route."""
    pcfg, calibrate = MODES[mode]
    _compare(pcfg, calibrate=calibrate, mode="eager")


def test_topk_prog_with_merge_matches_jax():
    pcfg = PruneConfig(mode="topk_prog", top_k=8, keep_schedule=(10, 6, 0), merge_dropped=True)
    params = _params(pcfg)
    jparams, tparams = jax_and_torch_params(params)
    x = _pixels()
    want = _run_jax(jparams, x, pcfg)
    got = tp.pruned_vit_forward(tparams, as_torch(x), CFG, pcfg)
    scores = np.asarray(want["scores"])
    for i, k in enumerate(pcfg.keep_schedule):
        if k:
            assert _rank_gap(scores[i], k) > MIN_GAP
    np.testing.assert_array_equal(got["keep_masks"].numpy(), np.asarray(want["keep_masks"]))
    for key in ("logits", "cls", "last_hidden"):
        np.testing.assert_allclose(as_numpy(got[key]), np.asarray(want[key]), atol=1e-4,
                                   rtol=1e-4)


def test_merge_conserves_size_weighted_mass():
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 9, 4).astype(np.float32))
    sizes = torch.from_numpy(rs.randint(1, 4, (2, 9)).astype(np.float32))
    scores = torch.from_numpy(rs.rand(2, 8).astype(np.float32))
    _, cidx = tp._keep_projection(scores, 3)
    xc = torch.gather(x, 1, cidx[..., None].expand(-1, -1, 4))
    merged, new_sz = tp.merge_dropped_tokens(x, xc, scores, 3, sizes)
    torch.testing.assert_close((merged * new_sz[..., None]).sum(1), (x * sizes[..., None]).sum(1))


# --- mode='random': properties ------------------------------------------------------

def _random_run(seed, budgets=None, mode="auto"):
    pcfg = PruneConfig(mode="random", top_k=7, random_keep=budgets)
    _, tparams = jax_and_torch_params(_params(pcfg))
    with kernel_mode(mode):
        out = tp.pruned_vit_forward(tparams, as_torch(_pixels()), CFG, pcfg,
                                    generator=torch.Generator().manual_seed(seed),
                                    return_layer_inputs=True)
    return tparams, out


def test_random_budget_and_seed():
    _, a = _random_run(5, budgets=(4, 7, 11))
    kept = a["keep_masks"].sum(-1)  # [L, B]
    assert kept.tolist() == [[5] * 4, [8] * 4, [12] * 4]
    assert a["keep_masks"][:, :, 0].all()
    _, b = _random_run(5, budgets=(4, 7, 11))
    assert torch.equal(a["keep_masks"], b["keep_masks"])
    torch.testing.assert_close(a["logits"], b["logits"], rtol=0, atol=0)
    _, c = _random_run(6, budgets=(4, 7, 11))
    assert not torch.equal(a["keep_masks"], c["keep_masks"])


@pytest.mark.parametrize("mode", ["auto", "eager"])
def test_random_bucketed_equals_full_length_masked(mode):
    """Each layer's B3 route (plain version on the CPU; the plain gather in
    'eager') equals the full-length masked layer with the same mask."""
    tparams, out = _random_run(3, mode=mode)
    xs, masks = out["layer_inputs"], out["keep_masks"]
    for i in range(L):
        with kernel_mode("eager"):
            y = vit_layer(xs[i], layer_slice(tparams["backbone"]["layers"], i), CFG,
                          token_mask=masks[i])
        want = torch.where(masks[i][..., None], y, xs[i])
        got = xs[i + 1] if i + 1 < L else None
        if got is not None:
            torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_random_requires_a_generator():
    pcfg = PruneConfig(mode="random", top_k=7)
    _, tparams = jax_and_torch_params(_params(pcfg))
    with pytest.raises(ValueError, match="generator"):
        tp.pruned_vit_forward(tparams, as_torch(_pixels()), CFG, pcfg)


def test_redecide_layers_launch_nothing_on_the_cpu():
    """On CPU tensors the wrappers run their plain versions: no launch."""
    counts = (tl.fused_vit_layer.launches, tl.fused_vit_layer_bucketed.launches)
    _random_run(1)
    assert (tl.fused_vit_layer.launches, tl.fused_vit_layer_bucketed.launches) == counts


def test_skip_ratio():
    m = torch.tensor([[[1, 1, 0, 0]], [[1, 1, 1, 1]]], dtype=torch.bool)
    assert tp.skip_ratio(m).tolist() == [0.5, 0.0]
