"""The train step, the reference's ``train/train_step.py``:
``loss_for``, ``_microbatch``, ``make_step_fn`` with gradient
accumulation over ``n_micro`` microbatches, ``build_train_step`` (on one
device, or sharded over a ``Mesh``: FSDP over the batch axes, tensor
parallelism over ``model`` and expert parallelism over the MoE's expert
axis, for every family) and ``build_dp_compressed_step`` (pure data
parallelism over ``grad_compress``'s wire formats).

The step is eager PyTorch: ``torch.autograd.grad`` of ``train_loss`` for
each microbatch, accumulated in ``acc_dtype`` (float32, or bf16 under
``grad_dtype="bf16"``), then ``adamw_update``.  The routes the model's
matmuls and attention take — and their backwards — follow the ExecConfig
installed around the call (``ops.exec_config``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as model_lib
from repro_torch.sharding import collectives, partition
from repro_torch.sharding.partition import Rules, partition_params
from repro_torch.train.grad_compress import CompressConfig, compressed_mean
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         tree_leaves, tree_map)


def loss_for(cfg: ArchConfig, shape: ShapeConfig) -> Callable:
    def loss_fn(params, batch):
        return model_lib.train_loss(
            params, cfg, batch, remat=shape.remat,
            loss_chunk=shape.loss_chunk, q_chunk=shape.attn_chunk)
    return loss_fn


def _microbatch(batch: Dict, n_micro: int) -> Dict:
    """Split the global batch's leading batch dim into (n_micro, b/n, ...).

    ``mrope_positions`` carries its batch dim at axis 1.
    """
    def split(name, x):
        if name == "mrope_positions":
            b = x.shape[1]
            return torch.movedim(
                x.reshape(x.shape[0], n_micro, b // n_micro, *x.shape[2:]),
                1, 0)
        b = x.shape[0]
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])
    return {k: split(k, v) for k, v in batch.items()}


def _unflatten(like, leaves: List[torch.Tensor]):
    """``leaves`` (in ``tree_leaves`` order) back into ``like``'s dicts.
    No closure refers to itself here: a recursive inner function is a
    reference cycle, which would hold ``leaves`` (a step's gradients)
    until the garbage collector runs."""
    return _build(like, iter(leaves))


def _build(t, it):
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    return next(it)


def value_and_grad(loss_fn, params, batch) -> Tuple[torch.Tensor, Dict]:
    """(loss, gradient tree in the parameters' dtypes) of ``loss_fn`` at
    ``params``; a parameter the loss does not reach gets zeros."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _unflatten(params, grads)


def _accumulate(loss_fn, params, batch, n_micro: int, acc_dtype
                ) -> Tuple[torch.Tensor, Dict]:
    """(loss, gradients) of ``loss_fn`` at ``params`` over ``batch``, in
    ``n_micro`` microbatches: the gradients summed in ``acc_dtype`` and
    divided by ``n_micro``, the loss the mean of the microbatches'."""
    if n_micro == 1:
        loss, g = value_and_grad(loss_fn, params, batch)
        return loss, _unflatten(params, [x.to(acc_dtype)
                                         for x in tree_leaves(g)])
    micro = _microbatch(batch, n_micro)
    grads = None
    loss = torch.zeros((), dtype=torch.float32,
                       device=tree_leaves(params)[0].device)
    for i in range(n_micro):
        l, g = value_and_grad(loss_fn, params,
                              {k: v[i] for k, v in micro.items()})
        if grads is None:
            grads = [torch.zeros(x.shape, dtype=acc_dtype, device=x.device)
                     for x in tree_leaves(params)]
        # in place: the same sums as the reference's a + b
        for a, b in zip(grads, tree_leaves(g)):
            a.add_(b.to(acc_dtype))
        loss = loss + l
        del g                  # held no longer than its sums need
    return loss / n_micro, _unflatten(params, [g / n_micro for g in grads])


def _acc_dtype(shape: ShapeConfig) -> torch.dtype:
    # grad accumulation dtype: bf16 halves the reduction bytes, the
    # optimizer's float32 moments restore precision downstream
    return torch.bfloat16 if shape.grad_dtype == "bf16" else torch.float32


def make_step_fn(cfg: ArchConfig, shape: ShapeConfig, opt_cfg: AdamWConfig):
    """The step: (params, opt_state, batch) -> (params, opt_state, m)."""
    grad_fn = build_grad_fn(cfg, shape)

    def step(params, opt_state: OptState, batch):
        loss, grads = grad_fn(params, batch)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def param_specs(cfg: ArchConfig, rules: Rules):
    """The spec of every parameter of ``cfg`` under ``rules``
    (``partition_params`` over the full-width shapes)."""
    return partition_params(model_lib.param_shapes(cfg), rules)


def _batch_mean(g: torch.Tensor, spec, mesh: Mesh, batch_axes) -> torch.Tensor:
    """A leaf's gradient summed over this rank's batch rows → the global
    batch's mean: summed over the batch axes the leaf is not split on
    (those it is split on were reduce-scattered by its FSDP gather) and
    divided by the batch ranks."""
    split = {a for ax in spec if ax is not None
             for a in ((ax,) if isinstance(ax, str) else ax)}
    missing = tuple(a for a in batch_axes if a not in split)
    g = collectives.all_reduce(g, mesh.group(missing))
    n = mesh.axis_size(batch_axes)
    return g / n if n > 1 else g


def build_train_step(cfg: ArchConfig, shape: ShapeConfig,
                     opt_cfg: AdamWConfig, mesh: Optional[Mesh] = None,
                     rules: Optional[Rules] = None, *,
                     donate: bool = True, batch_specs=None):
    """The train step.  Without a mesh, the step on one device.

    With ``mesh`` and ``rules`` (the reference's pjit step) the parameters
    and moments it takes and returns are this rank's shards as
    ``param_specs`` places them (``partition.shard_tree``); the global
    batch, the same on every rank, is cut to this rank's rows by
    ``batch_shardings``; every layer gathers its FSDP shards and, over a
    model axis above 1, runs its heads, MLP columns, vocabulary rows,
    SSD heads, RG-LRU channels and shared-expert columns on this rank,
    and a MoE layer its experts under expert parallelism (``models.moe``)
    where the reference's ``_ep_applicable`` holds — every family.  The
    gradients are reduce-scattered to their shards and averaged over the
    batch axes; a leaf the ranks of ``model`` share but each use in part
    (``sharding.partition``'s list) has its gradient summed over
    ``model`` inside the backward.
    The metrics are global.  A mesh of one rank runs the unsharded
    arithmetic.  ``donate`` is accepted for the reference's signature —
    an eager step frees the old state as soon as the caller drops it.
    ``batch_specs`` (``batch_shardings`` over the global batch's shapes):
    the caller hands each rank its own rows of the batch already, cut
    under them (the dry-run's traced step)."""
    del donate
    if mesh is None or rules is None:
        return make_step_fn(cfg, shape, opt_cfg)
    specs = param_specs(cfg, rules)
    grad_fn = build_grad_fn(cfg, shape, mesh, rules, batch_specs)

    def step(params, opt_state: OptState, batch):
        loss, grads = grad_fn(params, batch)
        params, opt_state, metrics = adamw_update(
            opt_cfg, params, grads, opt_state, mesh=mesh, specs=specs)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def build_grad_fn(cfg: ArchConfig, shape: ShapeConfig,
                  mesh: Optional[Mesh] = None,
                  rules: Optional[Rules] = None, batch_specs=None):
    """The step's first half, (params, batch) -> (loss, gradients): over
    ``shape.n_micro`` microbatches, summed in the accumulation dtype; with
    ``mesh`` and ``rules`` on this rank's shards (``build_train_step``,
    whose ``batch_specs`` it takes), the gradients reduced to their shards
    and averaged over the batch axes, the loss the global batch's."""
    loss_fn = loss_for(cfg, shape)
    n_micro = max(shape.n_micro, 1)
    acc_dtype = _acc_dtype(shape)
    if mesh is None or rules is None:
        return lambda params, batch: _accumulate(loss_fn, params, batch,
                                                 n_micro, acc_dtype)
    specs = param_specs(cfg, rules)
    batch_axes = _axes(rules.logical["batch"])

    def grads_of(params, batch):
        if batch_specs is None:
            rows = partition.batch_shardings(batch, mesh)
            local = {k: partition.shard_leaf(v, rows[k], mesh)
                     for k, v in batch.items()}
        else:
            rows, local = batch_specs, batch
        with partition.use_rules(rules, specs, rows["tokens"][0]):
            loss, grads = _accumulate(loss_fn, params, local, n_micro,
                                      acc_dtype)
        grads = tree_map(lambda g, s: _batch_mean(g, s, mesh, batch_axes),
                         grads, specs)
        return _batch_mean(loss, (), mesh, batch_axes), grads

    return grads_of


def _axes(ax) -> Tuple[str, ...]:
    return (ax,) if isinstance(ax, str) else tuple(ax)


# ---------------------------------------------------------------------------
# The data-parallel step with compressed gradient collectives
# ---------------------------------------------------------------------------

def build_dp_compressed_step(cfg: ArchConfig, shape: ShapeConfig,
                             opt_cfg: AdamWConfig, mesh: Mesh,
                             compress: CompressConfig):
    """Pure data parallelism: parameters replicated, the global batch cut
    over every mesh axis, each rank's gradients combined by the compressed
    wire format (``grad_compress.compressed_mean``).  Runs every family.

    State = (params, opt_state, err) — err is the error-feedback carry
    (``init_error_state``); the step returns (params, opt_state, err,
    metrics), the loss the mean over the ranks."""
    loss_fn = loss_for(cfg, shape)
    axes = tuple(mesh.axis_names)
    compress = CompressConfig(mode=compress.mode,
                              topk_frac=compress.topk_frac, axis_name=axes)
    group = mesh.group(axes)

    def step(params, opt_state: OptState, err, batch):
        local = {k: partition.shard_leaf(
            v, (None, axes) if k == "mrope_positions" else (axes,), mesh)
            for k, v in batch.items()}
        loss, grads = value_and_grad(loss_fn, params, local)
        red, new_e = [], []
        for g, e in zip(tree_leaves(grads), tree_leaves(err)):
            r, ne = compressed_mean(g, e, compress, group)
            red.append(r.to(g.dtype))
            new_e.append(ne)
        grads = _unflatten(params, red)
        err = _unflatten(params, new_e)
        loss = collectives.all_reduce(loss, group) / mesh.size
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
        metrics["loss"] = loss
        return params, opt_state, err, metrics

    return step
