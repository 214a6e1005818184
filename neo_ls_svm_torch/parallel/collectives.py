"""The port's cross-rank sums, in one place.

The JAX package runs one process over many devices and lets GSPMD or ``shard_map`` place
its collectives (``psum``, the tiled ``all_gather``). The port runs one process per GPU,
so every sum across ranks is an explicit call here. Each is an ``all_reduce(SUM)`` or a
``broadcast``: the two collectives that every backend (NCCL, and gloo on CUDA tensors as
well as CPU tensors) runs.

A group of size 1, or no process group at all, returns its input untouched, so a
single-GPU fit runs exactly the code it ran before these hooks existed.
"""

import torch
import torch.distributed as dist


def group_size(group: "dist.ProcessGroup | None") -> int:
    """Ranks in ``group`` (the world when None); 1 when no process group exists."""
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def sum_over(t: torch.Tensor, group: "dist.ProcessGroup | None") -> torch.Tensor:
    """The elementwise sum of ``t`` over the ranks of ``group``: the port's ``psum``.

    Every rank receives the same bits: the reduction's result is computed once and sent.
    """
    if group_size(group) == 1:
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _gather(local: torch.Tensor, group: "dist.ProcessGroup | None", dim: int) -> torch.Tensor:
    size = group_size(group)
    if size == 1:
        return local
    width = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = size * width
    out = local.new_zeros(shape)
    start = dist.get_rank(group) * width
    out.narrow(dim, start, width).copy_(local)
    # Each rank's block is its own values plus zeros from every other rank: x + 0 = x,
    # so the gather is exact.
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def gather_rows(local: torch.Tensor, group: "dist.ProcessGroup | None") -> torch.Tensor:
    """The ranks' row blocks of equal height stacked in rank order (dim 0): the
    counterpart of a row-sharded output coming back whole."""
    return _gather(local, group, 0)


def gather_columns(local: torch.Tensor, group: "dist.ProcessGroup | None") -> torch.Tensor:
    """The ranks' column blocks of equal width side by side in rank order (dim 1): the
    counterpart of ``jax.lax.all_gather(..., axis=1, tiled=True)``."""
    return _gather(local, group, 1)


def broadcast_from_first(t: torch.Tensor, group: "dist.ProcessGroup | None") -> torch.Tensor:
    """The first rank of ``group``'s ``t`` on every rank (``t`` gives the shape and
    dtype elsewhere)."""
    if group_size(group) == 1:
        return t
    out = t.contiguous().clone()
    src = dist.get_global_rank(group, 0) if group is not None else 0
    dist.broadcast(out, src=src, group=group)
    return out
