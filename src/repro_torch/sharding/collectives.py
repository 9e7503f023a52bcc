"""The collectives of the sharded train step as autograd Functions, each
with its adjoint:

  ``all_gather``   gather the shards of a dim (an FSDP weight before its
                   layer); backward: reduce-scatter (sum) of the gradient;
  ``to_model``     identity (a column-parallel site's replicated input);
                   backward: all-reduce of dX over the model axis;
  ``from_model``   the partial sums of a row-parallel site combined by
                   ``flextree.reduce_psum``; backward: identity;
  ``psum``         the group's sum, for a value whose every rank then uses
                   it on its own share (the SSM's gated norm over its
                   channels); backward: the sum of the gradient;
  ``all_to_all``   chunk r of a dim to rank r, the received chunks in
                   rank order (``jax.lax.all_to_all(..., tiled=True)``,
                   expert parallelism's dispatch and return); backward:
                   the same exchange of the gradient;
  ``sp_in``        this rank's block of a dim of a tensor replicated over
                   the group (the sequence entering the expert-parallel
                   body); backward: all-gather of the gradient blocks;
  ``sp_out``       the group's blocks gathered along a dim for a use that
                   is the same on every rank (the expert-parallel body's
                   output; the experts gathered for the replicated local
                   path); backward: this rank's block of the gradient;
  ``fetch_columns`` the columns each rank uses of a leaf whose last dim is
                   cut in blocks over the group, sent by their owners (an
                   all-to-all of uneven parts: no rank holds more than its
                   own columns and its blocks); backward: each column's
                   gradient sent back to its owner and summed there over
                   the ranks that used it.

A group of None (an axis of size 1) makes every one of them the identity,
so a mesh of one rank runs the unsharded arithmetic.

Counters.  Under ``counting()`` every collective that moves data —
``gather_dim``, ``scatter_sum_dim``, ``exchange``, ``_exchange_parts``,
``all_reduce`` and FlexTree's combines (``core.flextree.reduce_psum``) —
appends a ``CollectiveOp`` (kind, result bytes, group size) to the
``CollectiveSummary`` it yields; the operand and wire bytes follow the
reference's conventions (``roofline/hlo.py``: per-rank bytes sent, ring
algorithms).  The reference reads the same records out of XLA's
post-SPMD HLO text (``parse_collectives``) and corrects an XLA:CPU
float-normalisation artifact in it (``f32_upcast_bytes``); eager PyTorch
issues each collective itself, so the counters see them where they run
and there is no HLO, and no such artifact, to read.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.flextree import ReduceConfig, reduce_psum


@dataclass
class CollectiveOp:
    """One collective: per-rank bytes sent, by the reference's table

      op                  operand            ring wire bytes
      all-reduce          result             2·(g-1)/g · result
      all-gather          result / g         (g-1)/g · result
      reduce-scatter      result · g         (g-1) · result
      all-to-all          result             (g-1)/g · result
      collective-permute  result             result
    """
    kind: str
    result_bytes: int
    group_size: int

    @property
    def operand_bytes(self) -> float:
        if self.kind == "all-gather":
            return self.result_bytes / max(self.group_size, 1)
        if self.kind == "reduce-scatter":
            return self.result_bytes * self.group_size
        return float(self.result_bytes)

    @property
    def wire_bytes(self) -> float:
        """Per-rank ring traffic."""
        g = max(self.group_size, 1)
        if g == 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * self.result_bytes * (g - 1) / g
        if self.kind == "all-gather":
            return self.result_bytes * (g - 1) / g
        if self.kind == "reduce-scatter":
            return self.result_bytes * (g - 1)      # operand·(g-1)/g
        if self.kind == "all-to-all":
            return self.result_bytes * (g - 1) / g
        return float(self.result_bytes)             # permute: one hop


@dataclass
class CollectiveSummary:
    ops: List[CollectiveOp] = field(default_factory=list)

    @property
    def operand_bytes(self) -> float:
        return sum(o.operand_bytes for o in self.ops)

    @property
    def wire_bytes(self) -> float:
        return sum(o.wire_bytes for o in self.ops)

    def by_kind(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0, "operand_bytes": 0.0, "wire_bytes": 0.0})
        for o in self.ops:
            d = out[o.kind]
            d["count"] += 1
            d["operand_bytes"] += o.operand_bytes
            d["wire_bytes"] += o.wire_bytes
        return dict(out)


_summaries: List[CollectiveSummary] = []


@contextlib.contextmanager
def counting():
    """Record every collective issued inside into the yielded summary."""
    summary = CollectiveSummary()
    _summaries.append(summary)
    try:
        yield summary
    finally:
        _summaries.remove(summary)


def record(kind: str, result: torch.Tensor, group) -> None:
    """Count one collective of ``kind`` whose result (on this rank) is
    ``result``, over ``group``."""
    if _summaries:
        op = CollectiveOp(kind, result.numel() * result.element_size(),
                          group_size(group))
        for summary in _summaries:
            summary.ops.append(op)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order (no
    gradient), contiguous: the kernels take a weight row-major or as the
    transposed view of a row-major matrix, never a gathered dim's
    interleaved strides."""
    n = group_size(group)
    if n == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * front.shape[0],) + front.shape[1:],
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, front, group=group)
    record("all-gather", out, group)
    return out.movedim(0, dim).contiguous()


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
    record("reduce-scatter", out, group)
    return out.movedim(0, dim)


def exchange(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``dim`` cut into the group's size of equal chunks, chunk r sent to
    rank r; the received chunks concatenated in rank order (no
    gradient)."""
    if group_size(group) == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty_like(front)
    dist.all_to_all_single(out, front, group=group)
    record("all-to-all", out, group)
    return out.movedim(0, dim)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` cut over the group."""
    n = x.shape[dim] // group_size(group)
    return x.narrow(dim, dist.get_rank(group) * n, n)


def _host_indices(w) -> np.ndarray:
    """Column indices as a host int64 array (a plan is worked out on the
    host, so it needs no device data — a trace has none)."""
    if isinstance(w, torch.Tensor):
        w = w.cpu().numpy()
    return np.asarray(w, dtype=np.int64)


def _column_plan(want, n: int, rank: int):
    """For ``fetch_columns``: this rank's block [rank·n, rank·n + n) of
    the columns, the local indices it sends to each rank (in that rank's
    order, host arrays) and the count it receives from each."""
    want = [_host_indices(w) for w in want]
    lo = rank * n
    send = [w[(w >= lo) & (w < lo + n)] - lo for w in want]
    mine = want[rank]
    recv = [int(((mine >= q * n) & (mine < q * n + n)).sum())
            for q in range(len(want))]
    return send, recv


def _exchange_parts(x: torch.Tensor, send_sizes, recv_sizes, group):
    """The rows of ``x`` cut into ``send_sizes`` parts, part r sent to rank
    r; what comes back, ``recv_sizes[q]`` rows from rank q, in rank
    order."""
    out = x.new_empty((sum(recv_sizes),) + x.shape[1:])
    dist.all_to_all_single(out, x.contiguous(), list(recv_sizes),
                           list(send_sizes), group=group)
    record("all-to-all", out, group)
    return out


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """The group's ``op`` of ``x``, into a new tensor (no gradient)."""
    if group_size(group) == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    record("all-reduce", out, group)
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


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return exchange(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, ctx.group, ctx.dim), None, None


class _SPIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.group, ctx.dim), None, None


class _SPOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim).contiguous(), None, None


class _FetchColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, want):
        n = x.shape[-1]
        send, recv = _column_plan(want, n, dist.get_rank(group))
        send = [torch.as_tensor(i, device=x.device) for i in send]
        ctx.group, ctx.n, ctx.send, ctx.recv = group, n, send, recv
        rows = x.movedim(-1, 0)
        parts = torch.cat([rows.index_select(0, i) for i in send])
        out = _exchange_parts(parts, [len(i) for i in send], recv, group)
        return out.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        sizes = [len(i) for i in ctx.send]
        back = _exchange_parts(g.movedim(-1, 0), ctx.recv, sizes, ctx.group)
        gx = back.new_zeros((ctx.n,) + back.shape[1:])
        # rank by rank, so a column used by several ranks sums in rank order
        for idx, part in zip(ctx.send, back.split(sizes)):
            gx.index_add_(0, idx, part)
        return gx.movedim(0, -1), None, None


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


def psum(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _PSum.apply(x, group)


def all_to_all(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    if x.shape[dim] % group_size(group):
        raise ValueError(f"all_to_all: dim {dim} of {tuple(x.shape)} over "
                         f"{group_size(group)} ranks")
    return _AllToAll.apply(x, group, dim % x.dim())


def sp_in(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _SPIn.apply(x, group, dim % x.dim())


def sp_out(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _SPOut.apply(x, group, dim % x.dim())


def fetch_columns(x: torch.Tensor, group, want) -> torch.Tensor:
    """``x``: this rank's block of a leaf's last dim, cut in equal blocks
    over ``group``; ``want[r]``: the ascending column indices (of the
    whole leaf) that rank r uses, the same list on every rank (tensors or
    host arrays).  Returns this rank's columns, in their order, each sent
    by the rank that holds it."""
    if group_size(group) == 1:
        return x.index_select(-1, torch.as_tensor(_host_indices(want[0]),
                                                  device=x.device))
    return _FetchColumns.apply(x, group, list(want))
