"""The train step, the reference's ``train/train_step.py`` (its
single-device path): ``loss_for``, ``_microbatch``, ``make_step_fn`` with
gradient accumulation over ``n_micro`` microbatches, and
``build_train_step``.

The step is eager PyTorch: ``torch.autograd.grad`` of ``train_loss`` for
each microbatch, accumulated in ``acc_dtype`` (float32, or bf16 under
``grad_dtype="bf16"``), then ``adamw_update``.  The routes the model's
matmuls and attention take — and their backwards — follow the ExecConfig
installed around the call (``ops.exec_config``).  The sharded step and
the compressed data-parallel step (``build_dp_compressed_step``,
``train/grad_compress.py``) are collectives and wait for distribution
(ROADMAP queue A).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import model as model_lib
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         tree_leaves)


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
    """``leaves`` (in ``tree_leaves`` order) back into ``like``'s dicts."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


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


def make_step_fn(cfg: ArchConfig, shape: ShapeConfig, opt_cfg: AdamWConfig):
    """The step: (params, opt_state, batch) -> (params, opt_state, m)."""
    loss_fn = loss_for(cfg, shape)
    n_micro = max(shape.n_micro, 1)
    # grad accumulation dtype: bf16 halves the reduction bytes, the
    # optimizer's float32 moments restore precision downstream
    acc_dtype = torch.bfloat16 if shape.grad_dtype == "bf16" \
        else torch.float32

    def step(params, opt_state: OptState, batch):
        if n_micro > 1:
            micro = _microbatch(batch, n_micro)
            grads = None
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(n_micro):
                l, g = value_and_grad(loss_fn, params,
                                      {k: v[i] for k, v in micro.items()})
                if grads is None:
                    grads = [torch.zeros(x.shape, dtype=acc_dtype,
                                         device=x.device)
                             for x in tree_leaves(params)]
                # in place: the same sums as the reference's a + b
                for a, b in zip(grads, tree_leaves(g)):
                    a.add_(b.to(acc_dtype))
                loss = loss + l
                del g              # held no longer than its sums need
            grads = _unflatten(params, [g / n_micro for g in grads])
            loss = loss / n_micro
        else:
            loss, g = value_and_grad(loss_fn, params, batch)
            grads = _unflatten(params, [x.to(acc_dtype)
                                        for x in tree_leaves(g)])
            del g
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def build_train_step(cfg: ArchConfig, shape: ShapeConfig,
                     opt_cfg: AdamWConfig, mesh=None, rules=None, *,
                     donate: bool = True):
    """The step on one device.  ``mesh`` / ``rules`` (the sharded step)
    raise until distribution is ported; ``donate`` is accepted for the
    reference's signature — an eager step frees the old state as soon as
    the caller drops it."""
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "the sharded train step waits for distribution (ROADMAP A4)")
    del donate
    return make_step_fn(cfg, shape, opt_cfg)
