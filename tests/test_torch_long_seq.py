"""Sequences past the layer kernels' old limits (S 288, B6's 257), which a
resized position table reaches: DeiT-S/16 at 384 gives S 577, at 448 S 785.

On the CPU: the plain versions of B1 (hd 64 and hd 80) and B6 at S 577 / 785
against the JAX package's Pallas kernels in interpret mode (which pad any S),
f32 atol 2e-5 on valid rows as tests/test_torch_layer.py; the wrappers'
shape checks take any S; and the whole path at 384 (interpolate_pos_embed,
vit_forward, serving_forward) against the JAX package's, logits atol 1e-4 +
rtol 1e-4 as tests/test_torch_vit.py. The CUDA kernels' long-sequence paths
(K/V streamed through shared memory) run in chip_smoke.py phase 3k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, as_torch, jax_and_torch_params, randn
from vit_pruning_tpu.configs import PruneConfig, ViTConfig
from vit_pruning_tpu.models.convert import interpolate_pos_embed as jax_interpolate
from vit_pruning_tpu.models.pruned_vit import init_pruned_vit_params
from vit_pruning_tpu.models.vit import init_vit_params
from vit_pruning_tpu.models.vit import vit_forward as jax_vit_forward
from vit_pruning_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from vit_pruning_tpu.ops.pallas.layer import fused_vit_layer as jax_fused_vit_layer
from vit_pruning_tpu.serving import serving_forward as jax_serving_forward
from vit_pruning_tpu_torch.configs import ViTConfig as TViTConfig
from vit_pruning_tpu_torch.configs import PruneConfig as TPruneConfig
from vit_pruning_tpu_torch.models.convert import interpolate_pos_embed
from vit_pruning_tpu_torch.models.vit import vit_forward
from vit_pruning_tpu_torch.ops.cuda import attention as tatt
from vit_pruning_tpu_torch.ops.cuda import layer as tl
from vit_pruning_tpu_torch.serving import serving_forward

F32_ATOL = 2e-5
NARROW = dict(image_size=224, patch_size=16, hidden_size=64, num_layers=2, num_heads=2,
              mlp_dim=128, num_labels=10)


def _tcfg(cfg):
    return TViTConfig(**{f: getattr(cfg, f) for f in ("image_size", "patch_size",
                                                      "hidden_size", "num_layers", "num_heads",
                                                      "mlp_dim", "num_labels")})


@pytest.mark.parametrize("s,d,heads", [(577, 128, 2), (577, 160, 2), (785, 128, 2)],
                         ids=["s577-hd64", "s577-hd80", "s785-hd64"])
def test_b1_plain_matches_pallas_at_long_sequences(s, d, heads):
    cfg = ViTConfig(hidden_size=d, num_heads=heads, mlp_dim=2 * d, num_layers=1)
    params = init_vit_params(jax.random.PRNGKey(0), cfg)
    jlp, tlp = jax_and_torch_params(jax.tree.map(lambda a: a[0], params["layers"]))
    x = randn(1, (2, s, d))
    mask = np.random.RandomState(2).rand(2, s) > 0.3
    mask[:, 0] = True
    got = as_numpy(tl.fused_vit_layer_ref(as_torch(x), tlp, heads, cfg.layernorm_eps,
                                          torch.from_numpy(mask)))
    want = np.asarray(jax_fused_vit_layer(jnp.asarray(x), jlp, heads, eps=cfg.layernorm_eps,
                                          token_mask=jnp.asarray(mask), interpret=True))
    assert np.abs(got - want)[mask].max() < F32_ATOL


@pytest.mark.parametrize("s", [577, 785])
def test_b6_plain_matches_pallas_at_long_sequences(s):
    q, k, v = (randn(i, (2, 3, s, 64)) for i in range(3))
    mask = np.random.RandomState(4).rand(2, s) > 0.3
    mask[:, 0] = True
    got = as_numpy(tatt.fused_attention_ref(as_torch(q), as_torch(k), as_torch(v),
                                            torch.from_numpy(mask)))
    want = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(mask), interpret=True))
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_layer_wrappers_take_any_sequence_length():
    """The wrappers' shape check (what runs before a launch) takes S 577
    and S 4097; only the head dim is the kernel's to refuse."""

    class Lib:
        @staticmethod
        def vpt_layer_head_dim_ok(hd):
            return int(hd in tl.LAYER_HEAD_DIMS)

    params = init_vit_params(jax.random.PRNGKey(0), ViTConfig(hidden_size=64, num_heads=1,
                                                              num_layers=1, mlp_dim=128))
    lp = jax_and_torch_params(jax.tree.map(lambda a: a[0], params["layers"]))[1]
    for s in (577, 4097):
        got = tl._geometry(Lib, torch.zeros(1, s, 64), lp, 1, "test")
        assert got == (1, s, 64, 64, 64, 128)
    with pytest.raises(ValueError, match="head dim"):
        tl._geometry(Lib, torch.zeros(1, 577, 64), lp, 8, "test")  # hd 8


def test_vit_and_serving_at_384_match_jax():
    """DeiT-S-shaped narrow model at 224, its position table resized to 384
    (S 577) in both packages, then vit_forward and the headline serving
    path (one drop to 288 patches at layer 0) against the JAX package's."""
    cfg = ViTConfig(**NARROW)
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention", top_k=288)
    params = init_pruned_vit_params(jax.random.PRNGKey(0), cfg, pcfg)
    params["predictor"] = jax.tree.map(lambda a: a * 10.0, params["predictor"])
    jp, jc = jax_interpolate(params, cfg, 384)
    tp0 = jax_and_torch_params(params)[1]
    tp, tc = interpolate_pos_embed(tp0, _tcfg(cfg), 384)
    assert tc.seq_len == jc.seq_len == 577
    x = randn(3, (2, 3, 384, 384))
    want = np.asarray(jax_vit_forward(jp["backbone"], jnp.asarray(x), jc,
                                      use_pallas=False)["logits"])
    with torch.no_grad():
        got = as_numpy(vit_forward(tp["backbone"], torch.from_numpy(x), tc)["logits"])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    u8 = np.random.RandomState(5).randint(0, 256, (2, 3, 384, 384)).astype(np.uint8)
    jout = jax_serving_forward(jp, jnp.asarray(u8), jc, pcfg, use_pallas=False, quant="none")
    tpcfg = TPruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention",
                         top_k=288)
    with torch.no_grad():
        tout = serving_forward(tp, torch.from_numpy(u8), tc, tpcfg, logits_only=False)
    np.testing.assert_array_equal(tout["keep_masks"].numpy(), np.asarray(jout["keep_masks"]))
    np.testing.assert_allclose(as_numpy(tout["logits"]), np.asarray(jout["logits"]),
                               atol=1e-4, rtol=1e-4)
