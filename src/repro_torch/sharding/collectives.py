"""The collectives of the sharded train step as autograd Functions, each
with its adjoint:

  ``all_gather``   gather the shards of a dim (an FSDP weight before its
                   layer); backward: reduce-scatter (sum) of the gradient;
  ``to_model``     identity (a column-parallel site's replicated input);
                   backward: all-reduce of dX over the model axis;
  ``from_model``   the partial sums of a row-parallel site combined by
                   ``flextree.reduce_psum``; backward: identity.

A group of None (an axis of size 1) makes every one of them the identity,
so a mesh of one rank runs the unsharded arithmetic.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.flextree import ReduceConfig, reduce_psum


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order (no
    gradient)."""
    n = group_size(group)
    if n == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * front.shape[0],) + front.shape[1:],
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)


def scatter_sum_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` of the group's sum of ``x`` (no
    gradient)."""
    n = group_size(group)
    if n == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] // n,) + front.shape[1:],
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, front, group=group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """The group's ``op`` of ``x``, into a new tensor (no gradient)."""
    if group_size(group) == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return scatter_sum_dim(g, ctx.group, ctx.dim), None, None


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg, group):
        return reduce_psum(x, cfg, group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim % x.dim())


def to_model(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _ToModel.apply(x, group)


def from_model(x: torch.Tensor, cfg: ReduceConfig, group) -> torch.Tensor:
    if group_size(group) == 1 or cfg.ic_p <= 1:
        return x
    if cfg.strategy == "scatter":
        raise ValueError("a row-parallel site's consumer is replicated: its "
                         "combine cannot be a reduce-scatter")
    return _FromModel.apply(x, cfg, group)
