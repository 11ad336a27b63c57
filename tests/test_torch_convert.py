"""The port's HF checkpoint bridge (vit_pruning_tpu_torch/models/convert.py)
against the JAX package's and against HF transformers, on the CPU.

Every function against its JAX twin on a locally built, randomly
initialised HF ViTForImageClassification (eager attention, as
tests/test_vit_parity.py): converted leaves equal exactly, the inverse
loadable with strict=True, interpolate_pos_embed up (224 -> 384) and down
(224 -> 160) within atol 2e-5 of jax.image.resize(method='bicubic') (the
port builds its resize matrices in float64, JAX in float32), load_hf_vit
from a live model and from a local directory. The port's vit_forward on the
converted weights against HF's logits (atol 2e-5 + rtol 1e-5, as
test_vit_parity.py holds the JAX package), head_mask included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import ViTConfig as HFViTConfig
from transformers import ViTForImageClassification, ViTModel

from torch_parity import as_numpy
from vit_pruning_tpu.configs import ViTConfig
from vit_pruning_tpu.models import convert as jconv
from vit_pruning_tpu_torch.configs import ViTConfig as TViTConfig
from vit_pruning_tpu_torch.models import convert as tconv
from vit_pruning_tpu_torch.models.vit import vit_forward

HF = dict(image_size=32, patch_size=8, num_channels=3, hidden_size=64, num_hidden_layers=3,
          num_attention_heads=4, intermediate_size=128, num_labels=10,
          hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _hf(cls=ViTForImageClassification, seed=0, **kw):
    torch.manual_seed(seed)
    model = cls(HFViTConfig(**{**HF, **kw}, attn_implementation="eager"))
    return model.eval()


def _configs(hf):
    c = hf.config
    kw = dict(image_size=c.image_size, patch_size=c.patch_size, num_channels=c.num_channels,
              hidden_size=c.hidden_size, num_layers=c.num_hidden_layers,
              num_heads=c.num_attention_heads, mlp_dim=c.intermediate_size,
              num_labels=getattr(c, "num_labels", 10), layernorm_eps=c.layer_norm_eps)
    return ViTConfig(**kw), TViTConfig(**kw)


@pytest.fixture(scope="module")
def hf_model():
    return _hf()


def _assert_tree_equal(port_tree, jax_tree, skip=()):
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jax_tree)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tconv.params_to_numpy(port_tree))[0])
    assert flat_j.keys() == flat_t.keys()
    for k, v in flat_j.items():
        if jax.tree_util.keystr(k) in skip:
            assert flat_t[k].shape == np.shape(v)
        else:
            np.testing.assert_array_equal(flat_t[k], np.asarray(v), err_msg=str(k))


def test_strip_prefix_matches_jax(hf_model):
    sd = hf_model.state_dict()
    assert list(tconv.strip_prefix(sd)) == list(jconv.strip_prefix(sd))
    assert list(tconv.strip_prefix(sd, "vit.encoder.")) == list(jconv.strip_prefix(sd, "vit.encoder."))


def test_state_dict_to_params_matches_jax(hf_model):
    jcfg, tcfg = _configs(hf_model)
    sd = hf_model.state_dict()
    _assert_tree_equal(tconv.torch_state_dict_to_params(sd, tcfg, device="cpu"),
                       jconv.torch_state_dict_to_params(sd, jcfg))


def test_bare_backbone_gets_a_random_head():
    """A ViTModel state dict (no 'vit.' prefix, no classifier): the leaves
    it has equal JAX's, the head is random of the right shape (the
    strict=False load)."""
    bare = _hf(ViTModel)
    jcfg, tcfg = _configs(bare)
    sd = bare.state_dict()
    got = tconv.torch_state_dict_to_params(sd, tcfg, device="cpu")
    _assert_tree_equal(got, jconv.torch_state_dict_to_params(sd, jcfg),
                       skip=("['head']['w']", "['head']['b']"))
    assert float(got["head"]["w"].std()) > 0


def test_params_to_torch_state_dict_matches_jax_and_loads_strict(hf_model):
    jcfg, tcfg = _configs(hf_model)
    sd = hf_model.state_dict()
    jparams = jconv.torch_state_dict_to_params(sd, jcfg)
    tparams = tconv.torch_state_dict_to_params(sd, tcfg, device="cpu")
    got = tconv.params_to_torch_state_dict({"backbone": tparams, "predictor": None}, tcfg)
    want = jconv.params_to_torch_state_dict(jparams, jcfg)
    assert list(got) == list(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    fresh = _hf(seed=1)
    fresh.load_state_dict(got, strict=True)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    assert "classifier.weight" not in tconv.params_to_torch_state_dict(tparams, tcfg,
                                                                       classifier=False)


@pytest.mark.parametrize("new_size", [384, 160])
def test_interpolate_pos_embed_matches_jax_resize(new_size):
    """DeiT-S/16's grid of 14 to 24 (S 577) and to 10 (S 101; JAX
    antialiases when it shrinks), on a pruned-model tree and a backbone."""
    jcfg = ViTConfig(image_size=224, patch_size=16, hidden_size=32, num_layers=1, num_heads=2,
                     mlp_dim=64, num_labels=10)
    tcfg = TViTConfig(**{f: getattr(jcfg, f) for f in ("image_size", "patch_size",
                                                       "hidden_size", "num_layers",
                                                       "num_heads", "mlp_dim", "num_labels")})
    pos = np.random.RandomState(0).randn(1, 197, 32).astype(np.float32)
    jtree = {"embed": {"pos": jnp.asarray(pos)}}
    ttree = {"embed": {"pos": torch.from_numpy(pos)}}
    jout, jc = jconv.interpolate_pos_embed({"backbone": jtree, "predictor": None}, jcfg,
                                           new_size)
    tout, tc = tconv.interpolate_pos_embed({"backbone": ttree, "predictor": None}, tcfg,
                                           new_size)
    grid = new_size // 16
    assert tc.image_size == jc.image_size == new_size and tc.seq_len == grid * grid + 1
    got = as_numpy(tout["backbone"]["embed"]["pos"])
    assert got.shape == (1, grid * grid + 1, 32)
    np.testing.assert_allclose(got, np.asarray(jout["backbone"]["embed"]["pos"]), atol=2e-5,
                               rtol=0)
    np.testing.assert_array_equal(got[:, 0], pos[:, 0])  # CLS kept
    bare, _ = tconv.interpolate_pos_embed(ttree, tcfg, new_size)
    torch.testing.assert_close(bare["embed"]["pos"], tout["backbone"]["embed"]["pos"],
                               rtol=0, atol=0)
    # F.interpolate's bicubic is another kernel (a = -0.75, no antialias)
    other = torch.nn.functional.interpolate(
        torch.from_numpy(pos[0, 1:]).reshape(1, 14, 14, 32).permute(0, 3, 1, 2),
        size=(grid, grid), mode="bicubic", align_corners=False)
    assert np.abs(other.permute(0, 2, 3, 1).reshape(-1, 32).numpy() - got[0, 1:]).max() > 1e-3


def test_vit_forward_matches_hf(hf_model):
    _, tcfg = _configs(hf_model)
    params = tconv.torch_state_dict_to_params(hf_model.state_dict(), tcfg, device="cpu")
    x = np.random.RandomState(0).randn(4, 3, 32, 32).astype(np.float32)
    hm = (np.arange(12).reshape(3, 4) % 2).astype(np.float32)
    with torch.no_grad():
        ref = hf_model(pixel_values=torch.from_numpy(x)).logits.numpy()
        ref_hm = hf_model(pixel_values=torch.from_numpy(x),
                          head_mask=torch.from_numpy(hm)).logits.numpy()
        got = vit_forward(params, torch.from_numpy(x), tcfg)["logits"]
        got_hm = vit_forward(params, torch.from_numpy(x), tcfg,
                             head_mask=torch.from_numpy(hm))["logits"]
    np.testing.assert_allclose(as_numpy(got), ref, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(as_numpy(got_hm), ref_hm, atol=2e-5, rtol=1e-5)


def test_load_hf_vit_live_and_local_directory(hf_model, tmp_path):
    params, cfg = tconv.load_hf_vit(hf_model, device="cpu")
    jparams, jcfg = jconv.load_hf_vit(hf_model)
    assert cfg.to_json() == jcfg.to_json()
    _assert_tree_equal(params, jparams)
    hf_model.save_pretrained(tmp_path / "vit")
    again, cfg2 = tconv.load_hf_vit(str(tmp_path / "vit"), device="cpu")
    assert cfg2 == cfg
    _assert_tree_equal(again, jparams)
    with pytest.raises(ValueError, match="not a local directory"):
        tconv.load_hf_vit(str(tmp_path / "no-such-model"), device="cpu")
