"""Model and pruning configs, shared with the JAX package.

The port uses the JAX package's own definitions, not a copy that could
drift: `vit_pruning_tpu/configs.py` is pure Python (dataclasses and json).
Its source file is loaded here under this package's name, so the JAX
package itself is never imported — its `__init__` and every other module
of it may import jax, and the port runs where jax is not installed.
"""

import importlib.util
import sys
from pathlib import Path

_SOURCE = Path(__file__).resolve().parents[1] / "vit_pruning_tpu" / "configs.py"
_NAME = __name__ + "._shared"


def _load_shared():
    spec = importlib.util.spec_from_file_location(_NAME, _SOURCE)
    module = importlib.util.module_from_spec(spec)
    sys.modules[_NAME] = module  # dataclasses resolve annotations through sys.modules
    spec.loader.exec_module(module)
    return module


_shared = sys.modules.get(_NAME) or _load_shared()

ViTConfig = _shared.ViTConfig
PruneConfig = _shared.PruneConfig
deit_small = _shared.deit_small
vit_tiny = _shared.vit_tiny
composed_schedule = _shared.composed_schedule
ultra_schedule = _shared.ultra_schedule
schedule_live = _shared.schedule_live
