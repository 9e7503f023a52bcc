"""Pipeline parallelism over a mesh axis (GPipe-style microbatch pipeline),
the reference's ``sharding/pipeline.py`` on ``torch.distributed``.

Split the layer stack into S contiguous stages, one per rank of the
pipeline axis, and stream M microbatches through them with neighbour
``send`` / ``recv`` hops; each rank runs only its stage's layers.

Schedule: plain GPipe — M + S − 1 ticks, bubble fraction (S−1)/(M+S−1).
Forward-oriented (activation streaming), as the reference's.

    y = pipeline_apply(layer_fn, stage_params, x, mesh=mesh,
                       axis_name="pod", n_micro=M)
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import collectives


def split_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (S, L/S, ...) stage-major params."""
    def reshape(x):
        if isinstance(x, dict):
            return {k: reshape(v) for k, v in x.items()}
        n = x.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             f"stages")
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])
    return reshape(stacked_params)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _hop(h: torch.Tensor, mesh: Mesh, axis_name: str) -> torch.Tensor:
    """Every stage sends ``h`` to the next (the last to the first) and
    returns what the previous one sent."""
    group = mesh.group(axis_name)
    n = collectives.group_size(group)
    if n == 1:
        return h
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    h = h.contiguous()
    buf = torch.empty_like(h)
    for req in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, h, nxt, group=group),
             dist.P2POp(dist.irecv, buf, prv, group=group)]):
        req.wait()
    return buf


def pipeline_apply(layer_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh: Mesh, axis_name: str = "pod",
                   n_micro: int = 4) -> torch.Tensor:
    """Run ``x`` through all S×(L/S) layers, pipelined over ``axis_name``.

    layer_fn(layer_params, h) -> h — one layer.
    stage_params: (S, L/S, ...) tree; this rank runs its stage's slice.
    x: (B, ...) global batch, the same on every rank; B % n_micro == 0.
    Every rank returns the (B, ...) output: the last stage's, summed over
    the pipeline axis (the other stages contribute zeros)."""
    n_stages = mesh.shape[axis_name]
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"microbatches")
    mb = b // n_micro
    stage = mesh.axis_index(axis_name)
    local = _index(stage_params, stage)
    n_layers = next(iter(_leaves(local))).shape[0]
    micro = x.reshape(n_micro, mb, *x.shape[1:])

    def run_stage(h):
        for i in range(n_layers):
            h = layer_fn(_index(local, i), h)
        return h

    inflight = torch.zeros_like(micro[0])
    outputs = torch.zeros_like(micro)
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t (the last again past the end)
        h_in = micro[min(t, n_micro - 1)] if stage == 0 else inflight
        h_out = run_stage(h_in)
        out_idx = t - (n_stages - 1)      # the last stage emits this one
        if stage == n_stages - 1 and 0 <= out_idx < n_micro:
            outputs[out_idx] = h_out
        inflight = _hop(h_out, mesh, axis_name)
    outputs = collectives.all_reduce(outputs, mesh.group(axis_name))
    return outputs.reshape(b, *x.shape[1:])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead — the schedule-selection napkin number."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
