"""The collectives of the sharded computations: sums over a mesh axis or
the world, a zero-filled gather, a broadcast and a barrier.

Only ``all_reduce`` (SUM) and ``broadcast`` are used, which both NCCL and
gloo carry for CUDA tensors. :func:`all_sum` is differentiable: its
backward sums the cotangents over the same group, so every rank of the
group must reach it in its backward pass as in its forward. A ``group`` of
None is a group of one rank: the collective is the identity.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist


class _AllSum(torch.autograd.Function):
    """``y = Σ_ranks x``; its pullback is the same sum of the cotangents
    (each rank's ``x`` feeds every rank's ``y``)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllSum.apply(grad, ctx.group), None


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group``, differentiable."""
    if group is None:
        return t
    return _AllSum.apply(t, group)


def all_sums(ts: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """:func:`all_sum` of each tensor of ``ts`` through one collective."""
    if group is None:
        return list(ts)
    flat = all_sum(torch.cat([t.reshape(-1) for t in ts]), group)
    out, i = [], 0
    for t in ts:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def gather(t: torch.Tensor, n: int, start: int, dim: int, group) -> torch.Tensor:
    """The whole axis ``dim`` (length ``n``) from each rank's block ``t``
    starting at ``start``: a sum of zero-filled buffers, differentiable."""
    if group is None:
        return t
    before = list(t.shape)
    before[dim] = start
    after = list(t.shape)
    after[dim] = n - start - t.shape[dim]
    buf = torch.cat([t.new_zeros(before), t, t.new_zeros(after)], dim=dim)
    return all_sum(buf, group)


@torch.no_grad()
def sum_into(tensors: Iterable[torch.Tensor], group) -> None:
    """Replace each tensor by its sum over ``group``, in place, through one
    flat buffer (the gradients before the optimizer step)."""
    tensors = list(tensors)
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


@torch.no_grad()
def broadcast_(tensors: Iterable[torch.Tensor], group, src: int = 0) -> None:
    """Overwrite each tensor with global rank ``src``'s, in place."""
    tensors = list(tensors)
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src=src, group=group)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def barrier(group, device: Optional[torch.device]) -> None:
    """Wait until every rank of ``group`` reaches this point (an
    ``all_reduce`` of one element, which both backends carry)."""
    if group is None:
        return
    flag = torch.zeros(1, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.SUM, group=group)
    if flag.is_cuda:
        torch.cuda.current_stream(flag.device).synchronize()
