"""Collectives that reduce only when asked (``dissc_tpu.parallel.collectives``).

The reference's ``sr/modules/dist.py`` wrappers do nothing when
``torch.distributed`` is not initialised, so the same model code runs on
one card; the JAX package's take an optional axis name.  Here each takes
an optional process group: ``None``, or no initialised group, returns the
input unchanged.  :func:`psum_if` is differentiable (its backward sums the
incoming gradients over the group), which the synced BatchNorm of the
prosody models needs.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def active(group) -> bool:
    """True when ``group`` is given and a process group is initialised."""
    return group is not None and dist.is_available() and dist.is_initialized()


class _PSum(torch.autograd.Function):
    """All-reduce sum whose gradient is the all-reduce sum of the gradients."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def psum_if(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group``; ``x`` itself without one."""
    if not active(group):
        return x
    return _PSum.apply(x, group)


def pmean_if(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``group``; ``x`` itself without one."""
    if not active(group):
        return x
    return psum_if(x, group) / dist.get_world_size(group)


@torch.no_grad()
def all_gather_rows_if(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along dim 0
    in rank order: the global batch's rows when each rank holds its
    contiguous block.  No gradient flows through it."""
    if not active(group):
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


@torch.no_grad()
def pmin_if(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Element-wise minimum of ``x`` over the ranks of ``group``."""
    if not active(group):
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=group)
    return out
