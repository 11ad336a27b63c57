"""The CUDA kernels as registered PyTorch operators: vpt::<kernel>.

Each wrapper module (layer.py: B1-B3, layer_int8.py: B4, model.py: B5,
attention.py: B6, mlp.py: B7, embed.py: B8a / B8b) registers its kernel's
launch with `kernel_op`, as torch.library.custom_op("vpt::<name>",
mutates_args=(), device_types="cuda"). The op's implementation is the launch
through ctypes into the library ops/cuda/build.py builds, and it counts the
launch on the wrapper (its `launches`); its fake implementation gives the
output's shape and dtype. So:

  * torch.export traces a wrapper on fake tensors, which have no storage
    and no data pointer, and the graph holds the vpt:: ops: the serving
    export (serving.py::export_serving) carries its kernels in the program
    as the JAX export carries its Pallas kernels as tpu_custom_call;
  * a loaded program's launches are counted as a direct call's;
  * CUDA graphs and torch.compile see the kernels as operators.

No CPU implementation is registered, so a CPU tensor that reaches an op
raises; the wrappers run their plain versions for CPU tensors before the op
(ops/dispatch.py::launch_kernel_for). A wrapper checks shapes and dtypes,
which a fake tensor has; what needs memory (alignment, the library, the
stream) is checked or touched only inside an op's implementation, so
nothing here builds or loads the library until an op runs on the card.
"""

from __future__ import annotations

import importlib

import torch

NAMESPACE = "vpt"
# the modules that register the ops; load_ops() imports them
OP_MODULES = ("layer", "layer_int8", "model", "attention", "mlp", "embed")


def kernel_op(name: str, fake):
    """Register the decorated launch as the operator vpt::`name`, with
    `fake` (the same signature) as its fake implementation."""
    def register(launch):
        op = torch.library.custom_op(f"{NAMESPACE}::{name}", launch, mutates_args=(),
                                     device_types="cuda")
        op.register_fake(fake)
        return op
    return register


def load_ops():
    """Import every wrapper module, so that every vpt:: operator exists:
    what a loaded exported program needs before it runs."""
    for name in OP_MODULES:
        importlib.import_module(f"vit_pruning_tpu_torch.ops.cuda.{name}")


def check_aligned(who: str, **tensors):
    """The kernels read 16-byte vectors: raise for a tensor (or None) that
    does not start on a 16-byte boundary."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must be 16-byte aligned")


def run(who: str, device: torch.device, entry: str, *args):
    """Call the library's C entry `entry` with `args` and the current stream
    of `device`, on that device; raise on the CUDA error it returns."""
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{who}: CUDA error {rc}: {lib.vpt_error_string(rc).decode()}")


def ptr(t) -> int:
    """A tensor's data pointer, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()
