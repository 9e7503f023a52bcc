"""AdamW and its schedule, the reference's ``train/optimizer.py`` on
PyTorch tensors: float32 moments whatever the parameter's dtype, decoupled
weight decay on matrices only, global-norm clipping, a cosine schedule
with linear warmup.

Parameters, gradients and moments are nested dicts of tensors, walked in
sorted key order (the reference's pytree order, so the global norm sums
its leaves in the same order).  The step counter, the learning rate and
the bias corrections are tensors on the parameters' device, never Python
numbers: a step makes no host sync.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Tuple

import torch

from repro_torch.sharding import collectives


class OptState(NamedTuple):
    step: torch.Tensor          # () int32
    mu: Dict                    # first moment  (float32, param-shaped)
    nu: Dict                    # second moment (float32, param-shaped)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> OptState:
    dev = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params))


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """The L2 norm of every leaf together.  On local shards (``mesh`` and
    the tree's ``specs``) each leaf's sum of squares is summed over the
    mesh axes it is split on and counted once over those it is
    replicated on; the leaves are then added in tree order, as on one
    device."""
    leaves = tree_leaves(tree)
    sums = [torch.sum(torch.square(x.float())) for x in leaves]
    if mesh is not None:
        sums = _sum_over_shards(sums, tree_leaves(specs), mesh)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in sums:
        total = total + x
    return torch.sqrt(total)


def _sum_over_shards(sums, specs, mesh) -> List[torch.Tensor]:
    """Each leaf's ``sums`` entry summed over the ranks of the mesh axes
    its spec splits it on: one all-reduce per set of axes."""
    by_axes: Dict[Tuple[str, ...], List[int]] = {}
    for i, spec in enumerate(specs):
        axes = tuple(a for a in mesh.axis_names if any(
            a == ax or (isinstance(ax, tuple) and a in ax) for ax in spec))
        if mesh.axis_size(axes) > 1:
            by_axes.setdefault(axes, []).append(i)
    sums = list(sums)
    for axes, idx in by_axes.items():
        red = collectives.all_reduce(torch.stack([sums[i] for i in idx]),
                                     mesh.group(axes))
        for j, i in enumerate(idx):
            sums[i] = red[j]
    return sums


def clip_by_global_norm(grads, max_norm: float
                        ) -> Tuple[Dict, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(cfg: AdamWConfig, params, grads, state: OptState, *,
                 mesh=None, specs=None
                 ) -> Tuple[Dict, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics).  The
    gradients are clipped as ``clip_by_global_norm`` clips them, one leaf
    at a time inside the update, so that no clipped copy of the whole
    tree is held beside the old and the new moments.  On local shards
    (``mesh``, ``specs``) the norm is the whole tree's and every leaf is
    updated where it lies."""
    gnorm = global_norm(grads, mesh, specs)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        # the reference's arithmetic, operation for operation; the
        # in-place steps act on fresh temporaries only, so that a large
        # leaf (an embedding) holds few float32 copies at once
        gf = (g * scale.to(g.dtype)).float()
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * gf * gf
        del gf
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        if p.dim() >= 2:           # decay matrices only (standard practice)
            delta.add_(p.to(torch.float32, copy=True).mul_(cfg.weight_decay))
        new = p.to(torch.float32, copy=True).sub_(delta.mul_(lr))
        return new.to(p.dtype), m, v

    out = tree_map(lambda p, g, m, v: upd(p, g, m, v), params, grads,
                   state.mu, state.nu)

    def pick(i):
        return tree_map(lambda o: o[i], out)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return pick(0), OptState(step=step, mu=pick(1), nu=pick(2)), metrics
