"""The collectives of the parallel steps and the pipeline.

The JAX package writes none of these: XLA inserts them from the shardings
(parallel/steps.py there), and its pipeline names lax.ppermute / lax.psum
(parallel/pipeline.py there). Here they are explicit calls on a process
group, two of them as autograd Functions:

  gather_with_grad      all-gather of each rank's slice along a dim; its
                        backward sums the full gradient over the group
                        (every rank's output fed that rank's loss) and
                        keeps the rank's slice — a reduce-scatter
  all_reduce_with_grad  sum over the group; its backward is the same sum
                        of the gradients

and plain ones: all_reduce_ / all_gather (no graph), and the pipeline's
send / recv / broadcast. torch.distributed.nn.functional.all_gather is not
used: its backward hands a group rank to dist.scatter as the global source
and fails on any subgroup that does not start at rank 0.

gloo takes CUDA tensors in all-reduce, all-gather, reduce-scatter and
broadcast, and runs them on host copies itself; its point-to-point send and
recv do not (a CUDA tensor aborts the process: torch 2.11 on an H100).
Under gloo the pipeline's hops therefore go through an explicit host copy,
counted in `host_staged` (`reset_host_staged` sets it to 0); NCCL and CPU
tensors need none.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# point-to-point operations staged through a host copy under gloo since the
# process started (or the last reset_host_staged)
host_staged = 0


def reset_host_staged():
    global host_staged
    host_staged = 0


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _stages_on_host(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place (no graph); None is a group of one."""
    if _size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim` in group-rank order (no
    graph). bool travels as uint8 (gloo has no bool type)."""
    n = _size(group)
    if n == 1:
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.bool() if t.dtype == torch.bool else out


class _GatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group, ctx.width = dim, group, t.shape[dim]
        return all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, grad):
        chunks = [c.contiguous() for c in grad.split(ctx.width, dim=ctx.dim)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=ctx.group)
        return out, None, None


def gather_with_grad(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather of equal slices along `dim`, differentiable: the gradient
    of a rank's slice is the sum over the group of the gradients of the
    gathered tensor at that slice."""
    if _size(group) == 1:
        return t
    return _GatherWithGrad.apply(t, dim, group)


class _AllReduceWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_with_grad(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group`, differentiable (the backward sums the gradients
    over the group the same way)."""
    if _size(group) == 1:
        return t
    return _AllReduceWithGrad.apply(t, group)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """`t` of global rank `src` on every rank of `group`, in place."""
    if _size(group) > 1:
        dist.broadcast(t, src=src, group=group)
    return t


def send(t: torch.Tensor, dst: int):
    """Start sending `t` to global rank `dst`. Returns the pending work and
    the buffer it reads (keep both until `wait`); under gloo a CUDA tensor
    is sent from a host copy."""
    global host_staged
    buf = t.contiguous()
    if _stages_on_host(buf):
        buf = buf.cpu()
        host_staged += 1
    return dist.isend(buf, dst=dst), buf


def recv(shape, dtype, device, src: int) -> torch.Tensor:
    """Receive a tensor of `shape` and `dtype` from global rank `src` onto
    `device` (under gloo into a host buffer, then copied to the card)."""
    global host_staged
    out = torch.empty(shape, dtype=dtype, device=device)
    if _stages_on_host(out):
        host = torch.empty(shape, dtype=dtype)
        dist.recv(host, src=src)
        host_staged += 1
        return out.copy_(host)
    dist.recv(out, src=src)
    return out
