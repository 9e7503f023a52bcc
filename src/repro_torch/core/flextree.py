"""FlexTree's analytic half (FlexNN §III-B): the mesh-level reduction
strategies' link-traffic model and the strategy choice the descriptor
compiler records per site.  The collectives themselves (the JAX package's
``reduce_psum``) belong to the distribution slice of the port."""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ReduceConfig:
    axis_name: str
    ic_p: int                     # devices participating (1 = no reduction)
    strategy: str = "allreduce"   # allreduce | scatter | tree


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
