"""Parallelism over torch.distributed ranks: the ('data', 'model') train,
eval and serving steps with ZeRO-1 (steps.py) and the GPipe pipelines
(pipeline.py). Mirrors vit_pruning_tpu/parallel; launch.py::run_ranks
spawns the ranks of a run."""

from vit_pruning_tpu_torch.parallel.mesh import init_distributed, make_mesh  # noqa: F401
from vit_pruning_tpu_torch.parallel.sharding import (  # noqa: F401
    param_pspecs,
    batch_pspecs,
    shard_params,
    shard_batch,
)
from vit_pruning_tpu_torch.parallel.steps import (  # noqa: F401
    make_parallel_train_step,
    make_parallel_eval_step,
    make_parallel_serving_step,
    init_sharded_opt_state,
    zero1_pspecs,
)
from vit_pruning_tpu_torch.parallel.launch import run_ranks  # noqa: F401
