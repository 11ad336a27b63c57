"""The port's masking ops (vit_pruning_tpu_torch/ops/masking.py) against their
JAX twins in vit_pruning_tpu/ops/masking.py, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, as_torch, randn
from vit_pruning_tpu.ops import masking as jm
from vit_pruning_tpu_torch.ops import masking as tm


def test_similarity_oracle_equals_jax():
    x_in, x_out = randn(0, (3, 9, 16)), randn(1, (3, 9, 16))
    x_out[0, 0] = 0.0  # the eps clamp of a zero-norm output
    for alpha in (0.0, 0.3, 1.0):
        got = tm.similarity_oracle(as_torch(x_in), as_torch(x_out), alpha)
        want = jm.similarity_oracle(jnp.asarray(x_in), jnp.asarray(x_out), alpha)
        np.testing.assert_allclose(as_numpy(got), np.asarray(want), atol=1e-6)


def test_threshold_keep_mask_is_inclusive():
    s = np.array([[0.1, 0.5, 0.7, 0.5]], np.float32)
    got = tm.threshold_keep_mask(torch.from_numpy(s), 0.5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.threshold_keep_mask(jnp.asarray(s), 0.5)))
    assert got.tolist() == [[False, True, True, True]]


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_topk_keep_mask_order_equals_jax(ties):
    rs = np.random.RandomState(4)
    scores = (rs.randint(0, 4, (5, 30)) if ties else rs.rand(5, 30)).astype(np.float32)
    for k in (1, 6, 29):
        mask, idx = tm.topk_keep_mask(torch.from_numpy(scores), k)
        jmask, jidx = jm.topk_keep_mask(jnp.asarray(scores), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))  # same order
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        # serving's rank_keep_mask selects the same set
        np.testing.assert_array_equal(tm.rank_keep_mask(torch.from_numpy(scores), k).numpy(),
                                      mask.numpy())


def test_random_keep_mask_on_the_same_noise():
    """The port's mask is rank_keep_mask of the generator's noise, which is
    the JAX rule applied to that noise; and JAX's own random_keep_mask is
    the same rule on its own noise."""
    b, n, keep = 4, 16, 5
    got = tm.random_keep_mask(torch.Generator().manual_seed(9), b, n, keep)
    noise = torch.rand((b, n), generator=torch.Generator().manual_seed(9)).numpy()
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jm.rank_keep_mask(jnp.asarray(noise), keep)))
    assert (got.sum(-1) == keep).all()
    key = jax.random.PRNGKey(3)
    jnoise = np.array(jax.random.uniform(key, (b, n)))
    np.testing.assert_array_equal(tm.rank_keep_mask(torch.from_numpy(jnoise), keep).numpy(),
                                  np.asarray(jm.random_keep_mask(key, b, n, keep)))


def test_neighbor_index_table_equals_jax():
    for g in (2, 4, 14):
        np.testing.assert_array_equal(tm.neighbor_index_table(g), jm.neighbor_index_table(g))


@pytest.mark.parametrize("with_source", [False, True], ids=["all", "source_mask"])
def test_neighbor_average_equals_jax(with_source):
    g = 4
    patches = randn(2, (3, g * g, 8))
    src = np.random.RandomState(3).rand(3, g * g) > 0.6
    src[0] = False  # empty neighbourhoods keep their own value
    idx = tm.neighbor_index_table(g)
    got = tm.neighbor_average(as_torch(patches), torch.from_numpy(idx).long(), 0.4,
                              torch.from_numpy(src) if with_source else None)
    want = jm.neighbor_average(jnp.asarray(patches), jnp.asarray(idx), 0.4,
                               jnp.asarray(src) if with_source else None)
    np.testing.assert_allclose(as_numpy(got), np.asarray(want), atol=1e-6)


def test_compaction_equals_jax():
    rs = np.random.RandomState(5)
    mask = rs.rand(3, 12) > 0.5
    mask[:, 0] = True
    x = randn(6, (3, 12, 4))
    k = int(mask.sum(-1).min())
    cidx = tm.compact_indices(torch.from_numpy(mask), k)
    np.testing.assert_array_equal(cidx.numpy(), np.asarray(jm.compact_indices(jnp.asarray(mask), k)))
    np.testing.assert_array_equal(  # the full permutation too (k = S)
        tm.compact_indices(torch.from_numpy(mask), 12).numpy(),
        np.asarray(jm.compact_indices(jnp.asarray(mask), 12)))
    xc = tm.gather_compact(as_torch(x), cidx)
    np.testing.assert_array_equal(as_numpy(xc), np.asarray(jm.gather_compact(jnp.asarray(x),
                                                                             jnp.asarray(cidx))))
    vals = randn(7, (3, k, 4))
    got = tm.scatter_back(as_torch(x), cidx, as_torch(vals))
    want = jm.scatter_back(jnp.asarray(x), jnp.asarray(cidx.numpy()), jnp.asarray(vals))
    np.testing.assert_array_equal(as_numpy(got), np.asarray(want))


def test_confusion_counts_equal_jax():
    rs = np.random.RandomState(8)
    t, p = rs.rand(4, 50) > 0.3, rs.rand(4, 50) > 0.5
    got = tm.confusion_counts(torch.from_numpy(t), torch.from_numpy(p))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jm.confusion_counts(jnp.asarray(t), jnp.asarray(p))))
