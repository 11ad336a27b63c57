"""dryrun_multichip_torch.py, the port's counterpart of __graft_entry__.py's
multi-device dry run, on 8 gloo ranks on the CPU (--device cpu): the data 2 x model 4
train step and its ZeRO-1 twin, dp x tp uint8 serving and the 2-stage
pipelines, each against its single-process path, ending in the line of
MULTICHIP_r05.json's tail."""

import subprocess
import sys
from pathlib import Path

import pytest

import dryrun_multichip_torch

ROOT = Path(__file__).resolve().parents[1]


def test_dryrun_multichip_torch_on_8_cpu_ranks():
    out = subprocess.run([sys.executable, "dryrun_multichip_torch.py", "--device", "cpu"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("dryrun_multichip ok: mesh={'data': 2, 'model': 4} loss="), last
    assert last.endswith("(+zero1 opt-state sharding) (+dp-sharded uint8 serving) (+2-stage "
                         "pipeline verified, dense and pruned topk_prog+merge over "
                         "('stage','data')=2x4, dense over pp x tp ('stage','model')=2x2)"), last


def test_dryrun_multichip_torch_defaults_to_the_card():
    """Without --device the dry run asks for the card, and raises on a host
    without one before it spawns a rank."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip_torch.main([])
