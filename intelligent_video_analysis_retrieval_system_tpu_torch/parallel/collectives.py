"""Collectives of the trainer over a mesh that spans processes.

In one process the trainer moves tensors between a mesh's devices with
``.to(device)`` and autograd sums what several readers of one tensor send
back. Across ranks each of those moves is a ``torch.distributed`` collective
over a :class:`Group` of ranks, written out here with its backward:

- :func:`enter_parallel` is Megatron's "f", the entry of a column-parallel
  region: the identity forward; the backward sums the input gradients of
  every rank of the group (each holds the gradient of its own shards).
- :func:`reduce_in_order` is Megatron's "g", the exit of a row-parallel
  region: every rank gets the sum of the partial sums of all shards, added
  in shard order (gathered, then added one by one, so the result is the
  same on every rank and does not depend on timing); the gradient passes
  to every partial unchanged.
- :func:`gather_rows` assembles the global batch's embeddings on every rank
  for a loss that every rank computes alike; its backward hands each rank
  ITS OWN rows' gradient, not a sum over ranks (the loss is already the
  global one, so a sum would count it once per rank).
- :func:`sum_over` (no autograd) adds a tensor over a group in rank order:
  the data-parallel gradient sum.
- :func:`counted_elsewhere` reads a tensor whose gradient another rank
  keeps (a replicated weight that several ranks apply to the same rows):
  the identity forward, no gradient. It is not ``detach``: what is computed
  from it still records a backward, so every rank runs the same backward
  collectives in the same order.

Every collective is an ``all_gather``, so the sums are added in a fixed
order on every rank. Items of unequal count per rank travel padded with
zeros to the largest count. Gloo takes CUDA tensors as they are (it stages
them through host memory itself); NCCL needs each rank on a card of its
own. A group of one rank is never built: the trainer takes its one-process
path there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import torch

__all__ = ["Group", "new_group", "all_gather", "sum_in_order", "sum_over", "gather_items",
           "counted_elsewhere", "enter_parallel", "reduce_in_order", "gather_rows"]


@dataclass(frozen=True)
class Group:
    """The ranks of a process group in order, this rank among them, and
    the ``torch.distributed`` group (``None``: the default group)."""

    ranks: tuple[int, ...]
    rank: int
    pg: Any = None


def new_group(ranks: Sequence[int]) -> Group:
    """A process group over ``ranks``: collective over the whole world, as
    ``torch.distributed.new_group`` is (every rank calls it, in one order)."""
    dist = torch.distributed
    ranks = tuple(sorted(int(r) for r in ranks))
    pg = None if ranks == tuple(range(dist.get_world_size())) else dist.new_group(list(ranks))
    return Group(ranks, dist.get_rank(), pg)


def all_gather(t: torch.Tensor, group: Group) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape and dtype on all), in rank order, on
    ``t``'s device."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in group.ranks]
    torch.distributed.all_gather(out, t, group=group.pg)
    return out


def sum_in_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, added left to right."""
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def sum_over(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``t`` summed over the group's ranks in rank order (the same tensor,
    bit for bit, on every rank)."""
    return sum_in_order(all_gather(t, group))


def gather_items(parts: Sequence[torch.Tensor], owners: Sequence[int], group: Group,
                 like: torch.Tensor, device: torch.device) -> list[torch.Tensor]:
    """Items ``0..len(owners)-1``, item n held by rank ``owners[n]``, all of
    ``like``'s shape and dtype: ``parts`` are this rank's items in item
    order; returns every item, in item order, on ``device`` (one
    ``all_gather`` over ``group``)."""
    counts = {r: list(owners).count(r) for r in group.ranks}
    if len(parts) != counts[group.rank]:
        raise ValueError(f"rank {group.rank} holds {counts[group.rank]} of the items, "
                         f"was given {len(parts)}")
    send = torch.zeros((max(counts.values()),) + tuple(like.shape), dtype=like.dtype,
                       device=device)
    for n, part in enumerate(parts):
        send[n] = part
    gathered = all_gather(send, group)
    seen = dict.fromkeys(group.ranks, 0)
    out = []
    for r in owners:
        out.append(gathered[group.ranks.index(r)][seen[r]])
        seen[r] += 1
    return out


class _CountedElsewhere(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return None


def counted_elsewhere(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient dropped (another rank keeps it); unlike
    ``x.detach()``, what is computed from it still requires a gradient."""
    return _CountedElsewhere.apply(x)


class _EnterParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return sum_over(grad, ctx.group), None


def enter_parallel(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The input of a column-parallel region (Megatron's "f"): ``x`` as it
    is; its gradient is summed over the group's ranks."""
    return _EnterParallel.apply(x, group)


class _ReduceInOrder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, owners, group, device, *parts):
        ctx.devices = [p.device for p in parts]
        return sum_in_order(gather_items(parts, owners, group, parts[0], device))

    @staticmethod
    def backward(ctx, grad):
        return (None, None, None) + tuple(grad.to(d) for d in ctx.devices)


def reduce_in_order(parts: Sequence[torch.Tensor], owners: Sequence[int], group: Group,
                    device: torch.device) -> torch.Tensor:
    """The output of a row-parallel region (Megatron's "g"): the partial
    sums of every shard (shard n held by rank ``owners[n]``; ``parts`` this
    rank's, in shard order) added in shard order on ``device``, on every
    rank of the group; each partial's gradient is the sum's gradient."""
    return _ReduceInOrder.apply(tuple(owners), group, device, *parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, owners, computed, group, device, *parts):
        sent = [p for n, p in zip(computed, parts) if owners[n] == group.rank]
        ctx.computed, ctx.devices = computed, [p.device for p in parts]
        ctx.rows = parts[0].shape[0]
        return torch.cat(gather_items(sent, owners, group, parts[0], device))

    @staticmethod
    def backward(ctx, grad):
        rows = ctx.rows
        return (None, None, None, None) + tuple(
            grad[n * rows:(n + 1) * rows].to(d) for n, d in zip(ctx.computed, ctx.devices))


def gather_rows(parts: Sequence[torch.Tensor], computed: Sequence[int], owners: Sequence[int],
                group: Group, device: torch.device) -> torch.Tensor:
    """Blocks ``0..len(owners)-1`` of a batch, each ``(rows, ...)``,
    concatenated on every rank of the group. This rank computed the blocks
    ``computed`` (``parts``, in that order); block n is taken from rank
    ``owners[n]``, which must be among those that computed it. The
    gradient of a computed block is its own rows of the output's gradient."""
    return _GatherRows.apply(tuple(owners), tuple(computed), group, device, *parts)
