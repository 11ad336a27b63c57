"""Utilities: run logging, FLOPs accounting, housekeeping, profiling and
sweeps (mirrors vit_pruning_tpu/utils)."""

from vit_pruning_tpu_torch.utils.run_logging import RunLogger, encode_run_name, append_stats  # noqa: F401
from vit_pruning_tpu_torch.utils.flops import vit_flops, pruned_vit_flops  # noqa: F401
