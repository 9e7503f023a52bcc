"""FlexTree's analytic half (FlexNN §III-B), ported from the JAX package's
``core/flextree.py``:

1. the cycle model of the hardware adder tree — flexible output tap points
   at every level (``IC_P`` 1..16, non-powers-of-2 zero-padded) against a
   neighbor-to-neighbor psum chain and a fixed root-only tree;
2. the mesh-level reduction strategies: their link-traffic model, the
   strategy choice the descriptor compiler records per site, and the
   combine itself (``reduce_psum``) over a ``torch.distributed`` group.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

MAX_EXTRACT_PER_ROUND = 4     # ≤4 OF points drained from FlexTree per round
TREE_FANIN = 16               # 16 PEs per column feed the tree


def _tap_points(ic_p: int) -> int:
    """Output tap points per round for a given IC_P (§III-B: [8,8,4,2,1]
    for IC_P = [1,2,4,8,16])."""
    ic_p_pow2 = 1 << max(0, math.ceil(math.log2(max(ic_p, 1))))
    return max(TREE_FANIN // max(ic_p_pow2, 2), 1)


def flextree_cycles(n_outputs: int, ic_p: int) -> float:
    """Cycles to reduce+drain ``n_outputs`` OF points with IC_P-deep taps."""
    per_round = min(_tap_points(ic_p), MAX_EXTRACT_PER_ROUND)
    depth = math.ceil(math.log2(max(ic_p, 2)))
    rounds = math.ceil(n_outputs / per_round)
    return rounds + depth          # pipelined: depth fills once


def fixed_tree_cycles(n_outputs: int, ic_p: int) -> float:
    """Fixed root-only tree: every output serializes through the single
    root tap and re-traverses the full depth (no level taps, no multi-
    extract) — the fixed-depth baseline of §III-B whose layer-level gap is
    the paper's 4–16× band."""
    depth = math.ceil(math.log2(TREE_FANIN))
    return n_outputs * (depth + 1)


def neighbor_chain_cycles(n_outputs: int, ic_p: int) -> float:
    """Neighbor-to-neighbor psum forwarding (Eyeriss-style), pipelined:
    successive outputs overlap their IC_P hops, so the chain drains one
    output per cycle after an IC_P-cycle fill."""
    return n_outputs + max(ic_p, 1)


def flextree_speedup_vs_fixed(n_outputs: int, ic_p: int) -> float:
    return fixed_tree_cycles(n_outputs, ic_p) / flextree_cycles(n_outputs, ic_p)


def flextree_speedup_vs_chain(n_outputs: int, ic_p: int) -> float:
    return neighbor_chain_cycles(n_outputs, ic_p) / flextree_cycles(n_outputs, ic_p)


@dataclass(frozen=True)
class ReduceConfig:
    axis_name: str
    ic_p: int                     # devices participating (1 = no reduction)
    strategy: str = "allreduce"   # allreduce | scatter | tree


def reduce_psum(x: torch.Tensor, cfg: ReduceConfig, scatter_dim: int = 0,
                *, group=None) -> torch.Tensor:
    """Combine the partial sums ``x`` of the ``cfg.ic_p`` ranks of ``group``
    (the world when None) under the strategy, into a new tensor:
    ``allreduce`` → every rank the sum; ``scatter`` → this rank's block of
    the sum along ``scatter_dim``; ``tree`` → FlexTree's log-depth combine
    as recursive doubling (``_tree_allreduce``).  ``ic_p <= 1`` returns
    ``x``."""
    if cfg.ic_p <= 1:
        return x
    from repro_torch.sharding.collectives import record
    if cfg.strategy == "allreduce":
        out = x.clone()
        dist.all_reduce(out, group=group)
        record("all-reduce", out, group)
        return out
    if cfg.strategy == "scatter":
        front = x.movedim(scatter_dim, 0).contiguous()
        out = torch.empty((front.shape[0] // cfg.ic_p,) + front.shape[1:],
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, front, group=group)
        record("reduce-scatter", out, group)
        return out.movedim(0, scatter_dim)
    if cfg.strategy == "tree":
        return _tree_allreduce(x, group, cfg.ic_p)
    raise ValueError(f"unknown strategy {cfg.strategy!r}")


def _tree_allreduce(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Log-depth recursive-doubling all-reduce: round d exchanges with the
    group rank at XOR distance 2^d (one ``batch_isend_irecv`` pair) and
    adds — the adder-tree levels of Fig 7.  Partners add the same two
    values, so every rank ends with the same bits.  A size that is not a
    power of 2 falls back to ``all_reduce``, as in the reference."""
    from repro_torch.sharding.collectives import record
    if size & (size - 1):
        out = x.clone()
        dist.all_reduce(out, group=group)
        record("all-reduce", out, group)
        return out
    me = dist.get_rank(group)
    x = x.contiguous()
    for d in range(int(math.log2(size))):
        peer = dist.get_global_rank(group, me ^ (1 << d)) \
            if group is not None else me ^ (1 << d)
        buf = torch.empty_like(x)
        for req in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x, peer, group=group),
                 dist.P2POp(dist.irecv, buf, peer, group=group)]):
            req.wait()
        record("collective-permute", buf, group)
        x = x + buf
    return x


def link_bytes(strategy: str, payload_bytes: float, ic_p: int) -> float:
    """Per-device link traffic of each combine strategy."""
    if ic_p <= 1:
        return 0.0
    g = ic_p
    if strategy == "allreduce":      # ring: 2·(g-1)/g
        return 2.0 * payload_bytes * (g - 1) / g
    if strategy == "scatter":        # reduce-scatter half of the ring
        return payload_bytes * (g - 1) / g
    if strategy == "tree":           # recursive doubling: log2(g) full sends
        return payload_bytes * math.ceil(math.log2(g))
    raise ValueError(strategy)


def best_strategy(payload_bytes: float, ic_p: int,
                  consumer_sharded: bool) -> str:
    """FlexTree's depth selection re-targeted: pick the cheapest combine."""
    if ic_p <= 1:
        return "allreduce"
    candidates = ["allreduce", "tree"]
    if consumer_sharded:
        candidates.append("scatter")
    return min(candidates, key=lambda s: link_bytes(s, payload_bytes, ic_p))
