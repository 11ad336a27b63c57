"""Package-level contracts of the port: no jax at import, lazy kernel build,
and the kernel wrappers' CPU behaviour."""

import subprocess
import sys

import pytest
import torch

from vit_pruning_tpu_torch.configs import vit_tiny
from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_slice
from vit_pruning_tpu_torch.ops.cuda import layer as tl
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode, set_kernel_mode

IMPORT_ALL = """
import importlib, pkgutil, sys
import vit_pruning_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]
for n in names:
    importlib.import_module(n)
assert len(names) >= 15, names
jax_pkg = [m for m in sys.modules if m == 'vit_pruning_tpu' or m.startswith('vit_pruning_tpu.')]
print('jax' in sys.modules, jax_pkg)
"""


def test_import_leaves_jax_out():
    """Neither jax nor the JAX package is imported by the port (it shares
    the JAX package's configs.py source without importing the package)."""
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "False []", out.stdout + out.stderr


def _layer_and_head():
    cfg = vit_tiny()
    params = init_vit_params(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(2, 9, cfg.hidden_size, generator=torch.Generator().manual_seed(1))
    return cfg, params, layer_slice(params["layers"], 0), x


def test_cpu_tensors_run_plain_versions_without_launching():
    cfg, params, lp, x = _layer_and_head()
    b1, b2 = tl.fused_vit_layer.launches, tl.fused_vit_layer_cls_logits.launches
    y = tl.fused_vit_layer(x, lp, cfg.num_heads, cfg.layernorm_eps)
    torch.testing.assert_close(y, tl.fused_vit_layer_ref(x, lp, cfg.num_heads,
                                                         cfg.layernorm_eps), rtol=0, atol=0)
    z = tl.fused_vit_layer_cls_logits(x, lp, params["ln_f"], params["head"], cfg.num_heads,
                                      cfg.layernorm_eps)
    assert z.shape == (2, cfg.num_labels)
    assert (tl.fused_vit_layer.launches, tl.fused_vit_layer_cls_logits.launches) == (b1, b2)


def test_kernel_mode_rejects_cpu_tensors():
    cfg, params, lp, x = _layer_and_head()
    with kernel_mode("kernel"):
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tl.fused_vit_layer(x, lp, cfg.num_heads)
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tl.fused_vit_layer_cls_logits(x, lp, params["ln_f"], params["head"], cfg.num_heads)


def test_kernel_mode_names_are_checked():
    with pytest.raises(ValueError, match="kernel mode"):
        set_kernel_mode("pallas")


def test_unported_options_raise():
    from vit_pruning_tpu_torch.configs import PruneConfig
    from vit_pruning_tpu_torch.models.predictors import init_predictor_params
    from vit_pruning_tpu_torch.models.vit import vit_layer

    cfg, _, lp, x = _layer_and_head()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vit_layer(x, lp, cfg, return_probs=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vit_layer(x, lp, cfg, quant="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_predictor_params(cfg, PruneConfig(predictor="token_mlp"), torch.Generator())
