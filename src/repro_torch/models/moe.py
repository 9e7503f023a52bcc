"""Mixture-of-Experts: routed top-k experts plus shared experts (the JAX
package's ``models/moe.py``, local sort-based path and GShard oracle).

Dispatch is capacity-bounded and sort-based: the (token, slot) assignments
are grouped by expert with a stable argsort, gathered into a
capacity-padded (E, C, D) buffer, run through the expert FFN as batched
expert contractions (``ops.flex_expert_matmul``: one kernel launch per site
over all E experts on the card at decode) and scattered back.  The router's
choice plays the CSB role of FlexNN's two-sided sparsity: capacity rows no
token was routed to are zero, so their activation blocks are dead and the
block-sparse kernel skips them.

Routing is batch-coupled: capacity slots are competed for across every row
of the step, the token-0 filler rows of idle serving slots included, so the
fused decode block and the per-token ``step()`` must feed identical rows
(they do: both run ``models.model.masked_decode_step`` on the whole batch).

The reference's semantics are matched by hand where the frameworks differ:
``jax.lax.top_k`` keeps the lower index first among ties — here a stable
descending sort; ``jnp.bincount(length=n)`` drops ids >= n — here a
scatter-add into n + 1 bins whose last is dropped (no host sync on the
card); ``.at[idx].set(mode="drop")`` — here a write into n_rows + 1 rows
whose last is dropped; and the top-k combine forms its products and sums
in float32 and rounds once, as XLA fuses it.

Under autograd (training) the expert contractions run as
``ops.flex_expert_matmul``'s dense Function; gradients reach the router
only through the gate values, as in the reference: the dispatch indices
carry none.  ``load_balance_loss`` is ported as the reference has it, a
function that its ``train_loss`` does not call (nor does the port's).

Under the sharding rules of a sharded step (``sharding.partition
.use_rules`` with specs) ``apply_moe`` takes the reference's expert-
parallel path exactly where its ``_ep_applicable`` holds: ``_apply_moe_ep``
runs on this rank's block of the sequence and its E / ep experts, with
``collectives.all_to_all`` dispatch and return; each shard drops tokens
against its own capacities, as the reference's ``shard_map`` body does,
so the layer is not the unsharded one.  Otherwise, at a model axis above
1, the experts are gathered over it and the local path runs replicated.
The shared experts are column- / row-parallel like the dense MLP.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sparsity import PlannedWeight
from repro_torch.kernels import ops
from repro_torch.models.layers import normal
from repro_torch.quant.quantize import QuantizedLinear, dequantize_leaf
from repro_torch.sharding import collectives, partition

Params = Dict[str, torch.Tensor]


def _dense_w(w) -> torch.Tensor:
    """A ``PlannedWeight`` / ``QuantizedLinear`` unwrapped to its dense
    contraction-oriented tensor (the oracle's raw weights)."""
    if isinstance(w, PlannedWeight):
        return w.w_kn
    if isinstance(w, QuantizedLinear):
        return dequantize_leaf(w, torch.float32)
    return w


def init_moe(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16,
             lead=()) -> Params:
    """Router (float32), routed experts (E, D, F) / (E, F, D) and the
    shared experts' gated MLP, with the reference's distributions;
    ``lead`` stacks them (e.g. (L,) for the layer axis)."""
    d = cfg.d_model
    m = cfg.moe
    s_in, s_ff = d ** -0.5, m.expert_d_ff ** -0.5
    e, f = m.n_experts, m.expert_d_ff
    p = {
        "router": normal(gen, lead + (d, e), s_in, torch.float32),
        "experts_in": normal(gen, lead + (e, d, f), s_in, dtype),
        "experts_gate": normal(gen, lead + (e, d, f), s_in, dtype),
        "experts_out": normal(gen, lead + (e, f, d), s_ff, dtype),
    }
    if m.n_shared:
        fs = f * m.n_shared
        p["shared"] = {
            "w_in": normal(gen, lead + (d, fs), s_in, dtype),
            "w_gate": normal(gen, lead + (d, fs), s_in, dtype),
            "w_out": normal(gen, lead + (fs, d), s_ff, dtype),
        }
    return p


# ---------------------------------------------------------------------------
# Routing + sort-based dispatch primitives
# ---------------------------------------------------------------------------

def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, ties to the lower index
    (``jax.lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router, xt: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xt (T, D) → (gates (T, k) float32 renormalised, idx (T, k) int64).
    The router is the float32 dispatch site ``moe.router``."""
    logits = ops.flex_matmul(xt.float(), router, site="moe.router")
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    return gate_vals, gate_idx


def _dispatch_indices(fid: torch.Tensor, n_bins: int, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group flat assignments by bin with a per-bin capacity.

    ``fid`` (F,) bin ids (ids >= n_bins are sentinels, never dispatched).
    Returns (f_sel (n_bins, C) indices into F, valid bool): first come,
    first served — within a bin the lower flat index wins."""
    f = fid.shape[0]
    dev = fid.device
    order = torch.argsort(fid, stable=True)
    counts = torch.zeros(n_bins + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, torch.clamp(fid.long(), max=n_bins),
                        torch.ones(f, dtype=torch.int64, device=dev))
    counts = counts[:n_bins]                              # sentinels dropped
    start = torch.cumsum(counts, 0) - counts
    ar = torch.arange(capacity, device=dev)
    slot = start[:, None] + ar[None]                      # (n_bins, C)
    valid = ar[None] < counts[:, None]
    f_sel = order[torch.clamp(slot, 0, f - 1)]
    return f_sel, valid


def _act_mul(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return F.silu(g) * h


def _expert_ffn(xe: torch.Tensor, p: Params) -> torch.Tensor:
    """Batched expert MLP (E, C, D) → (E, C, D); every contraction is a
    ``moe.experts_*`` dispatch site."""
    h = ops.flex_expert_matmul(xe, p["experts_in"], site="moe.experts_in")
    g = ops.flex_expert_matmul(xe, p["experts_gate"],
                               site="moe.experts_gate")
    return ops.flex_expert_matmul(_act_mul(g, h), p["experts_out"],
                                  site="moe.experts_out")


def _einsum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, K) @ (E, K, N) in float32, cast back to x's dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _expert_ffn_dense(xe: torch.Tensor, p: Params) -> torch.Tensor:
    """Plain batched expert MLP, the oracle's, independent of the dispatch
    under test."""
    h = _einsum(xe, _dense_w(p["experts_in"]))
    g = _einsum(xe, _dense_w(p["experts_gate"]))
    return _einsum(_act_mul(g, h), _dense_w(p["experts_out"]))


def _scatter_rows(n_rows: int, idx: torch.Tensor, valid: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """Rows (..., D) written to (n_rows, D) at ``idx``; invalid slots go to
    an extra row that is dropped."""
    d = rows.shape[-1]
    flat_idx = torch.where(valid, idx, n_rows).reshape(-1)
    out = torch.zeros((n_rows + 1, d), dtype=rows.dtype, device=rows.device)
    out[flat_idx] = rows.reshape(-1, d)
    return out[:n_rows]


def _capacity(tokens: int, k: int, n_bins: int, cf: float) -> int:
    return min(int(tokens * k / n_bins * cf) + 1, tokens * k)


def _combine(out_flat: torch.Tensor, gates: torch.Tensor, t: int, k: int,
             dtype) -> torch.Tensor:
    """Σ over each token's k slots of gate × expert output: the products
    of the outputs and the gates rounded to the outputs' dtype are formed
    and summed in float32 and rounded once, as XLA fuses the reference's
    ``(out * gates).sum(1)``."""
    d = out_flat.shape[-1]
    g = gates.to(out_flat.dtype).float()
    y = (out_flat.reshape(t, k, d).float() * g[..., None]).sum(1)
    return y.to(dtype)


def _apply_moe_local(p: Params, cfg: ArchConfig,
                     xt: torch.Tensor) -> torch.Tensor:
    t, d = xt.shape
    m = cfg.moe
    gates, gate_idx = _route(p["router"], xt, m.top_k)
    f = t * m.top_k
    fid = gate_idx.reshape(f)
    cap = _capacity(t, m.top_k, m.n_experts, m.capacity_factor)
    f_sel, valid = _dispatch_indices(fid, m.n_experts, cap)
    xe = torch.where(valid[..., None], xt[f_sel // m.top_k],
                     torch.zeros((), dtype=xt.dtype, device=xt.device))
    ye = _expert_ffn(xe, p)                                   # (E, C, D)
    out_flat = _scatter_rows(f, f_sel, valid, ye)             # (F, D)
    return _combine(out_flat, gates, t, m.top_k, xt.dtype)


# ---------------------------------------------------------------------------
# Expert parallelism (SP in → all_to_all dispatch → all_to_all return →
# combine → SP out), the reference's shard_map body
# ---------------------------------------------------------------------------

def _apply_moe_ep(p: Params, cfg: ArchConfig, x: torch.Tensor, rules
                  ) -> torch.Tensor:
    """x (b, s, D), this rank's batch rows and the whole sequence (the
    same on every rank of the expert axis) → y (b, s, D), the same on
    every rank.  The body runs on this rank's s / ep positions and its
    E / ep experts (``p``'s expert leaves are this rank's block of them,
    gathered over the FSDP axes only); the router's gradient, partial on
    each rank, is summed over the expert axis."""
    mesh = rules.mesh
    m = cfg.moe
    k = m.top_k
    ep_axis = rules.logical.get("expert") or "model"
    ep = mesh.shape[ep_axis]
    group = mesh.group(ep_axis)
    e_loc = m.n_experts // ep
    cf = m.capacity_factor
    xb = collectives.sp_in(x, group, 1)              # (b, s / ep, D)
    bl, sl, d = xb.shape
    t_l = bl * sl
    xt = xb.reshape(t_l, d)
    zero = torch.zeros((), dtype=xt.dtype, device=xt.device)
    gates, gate_idx = _route(collectives.to_model(_dense_w(p["router"]),
                                                  group), xt, k)
    f = t_l * k
    fid = gate_idx.reshape(f)
    gflat = gates.reshape(f)

    # ---- bucket by destination shard, exchange ----
    dest = fid // e_loc
    c_send = _capacity(t_l, k, ep, cf)
    f_sel, valid = _dispatch_indices(dest, ep, c_send)         # (ep, C_s)
    send_x = torch.where(valid[..., None], xt[f_sel // k], zero)
    send_le = torch.where(valid, fid[f_sel] % e_loc, e_loc)    # sentinel
    recv_x = collectives.all_to_all(send_x, group, 0)
    recv_le = collectives.exchange(send_le, group, 0)

    # ---- this rank's experts ----
    n_recv = ep * c_send
    rf = recv_x.reshape(n_recv, d)
    c_loc = min(int(t_l * k / e_loc * cf) + 1, n_recv)
    r_sel, valid2 = _dispatch_indices(recv_le.reshape(n_recv), e_loc, c_loc)
    xe = torch.where(valid2[..., None], rf[r_sel], zero)      # (E_l, C, D)
    ye = _expert_ffn(xe, p)

    # ---- back to the source shard, combine ----
    out_rf = _scatter_rows(n_recv, r_sel, valid2, ye)
    back = collectives.all_to_all(out_rf.reshape(ep, c_send, d), group, 0)
    y = _combine_sent(back, valid, f_sel, gflat, dest, t_l, k)
    return collectives.sp_out(y.reshape(bl, sl, d).to(x.dtype), group, 1)


def _combine_sent(back: torch.Tensor, valid: torch.Tensor,
                  f_sel: torch.Tensor, gflat: torch.Tensor,
                  dest: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """Σ over each token's returned slots of gate × row, in ``back``'s
    dtype, added in the reference's order — its scatter-add takes the
    (ep, C_s) send buffer in order, so a token's slots come by destination
    shard, then slot — as a fixed sequence of k adds (a scatter-add's
    atomics on the card would order them by chance).  A dropped slot adds
    an exact zero."""
    d = back.shape[-1]
    f = t * k
    pos = torch.full((f + 1,), valid.numel(), dtype=torch.int64,
                     device=back.device)
    pos[torch.where(valid, f_sel, f).reshape(-1)] = torch.arange(
        valid.numel(), device=back.device)
    pos = pos[:f]                                  # flat slot → send row
    rows = torch.cat([back.reshape(-1, d),
                      torch.zeros((1, d), dtype=back.dtype,
                                  device=back.device)])
    contrib = rows[pos] * gflat.to(back.dtype)[:, None]           # (F, D)
    order = torch.argsort((dest * k + torch.arange(
        f, device=back.device) % k).reshape(t, k), dim=-1, stable=True)
    contrib = contrib.reshape(t, k, d).gather(
        1, order[..., None].expand(t, k, d))
    y = torch.zeros((t, d), dtype=back.dtype, device=back.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y


def _ep_applicable(cfg: ArchConfig, x: torch.Tensor, rules) -> bool:
    """The reference's condition on the global batch: rules with a mesh and
    installed specs, an expert axis above 1 that divides E, and a distinct
    token block per rank (the batch over the batch axes, the sequence over
    the expert axis).  ``x`` holds this rank's rows; the global batch is
    them times the ranks of the axes the step cut its rows over
    (``partition.batch_rows``: none where every rank holds the whole
    batch)."""
    if (rules is None or rules.mesh is None
            or partition.current_specs() is None):
        return False
    mesh = rules.mesh
    ep_axis = rules.logical.get("expert")
    if ep_axis is None or ep_axis not in mesh.axis_names:
        return False
    ep = mesh.shape[ep_axis]
    if ep <= 1 or cfg.moe.n_experts % ep:
        return False
    b, s, _ = x.shape
    b *= mesh.axis_size(partition.batch_rows())
    dp = mesh.axis_size(rules.logical.get("batch"))
    return b % dp == 0 and s % ep == 0 and (b // dp) * (s // ep) >= 1


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

EXPERT_LEAVES = ("experts_in", "experts_gate", "experts_out")


def apply_moe(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) → (B, S, D): routed experts plus shared experts (the
    ``moe.shared_*`` sites).  Under a sharded step's rules: the expert-
    parallel path where ``_ep_applicable`` holds, else at a model axis
    above 1 the local path on the experts gathered over it (its gradient
    whole on every rank: each takes its own block); the shared experts on
    this rank's columns (module docstring)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    rules = partition.current_rules()
    tp = partition.tensor_parallel()
    if _ep_applicable(cfg, x, rules):
        y = _apply_moe_ep(p, cfg, x, rules)
    else:
        if tp is not None:
            p = {**p, **{n: collectives.sp_out(p[n], tp.group, 0)
                         for n in EXPERT_LEAVES
                         if partition.model_dim(p, n) == 0}}
        y = _apply_moe_local(p, cfg, xt).reshape(b, s, d)
    if "shared" in p:
        sp = p["shared"]
        split = tp is not None and partition.model_dim(sp, "w_in") == 1
        xs = collectives.to_model(xt, tp.group) if split else xt
        hs = _act_mul(ops.flex_matmul(xs, sp["w_gate"],
                                      site="moe.shared_gate"),
                      ops.flex_matmul(xs, sp["w_in"], site="moe.shared_in"))
        y = y + ops.flex_matmul(hs, sp["w_out"], site="moe.shared_out",
                                partial=split).reshape(b, s, d)
    return y


def apply_moe_rows(p: Params, cfg: ArchConfig, x: torch.Tensor
                   ) -> torch.Tensor:
    """``apply_moe`` of the global batch, for a decode step: where the
    installed step cut its batch rows over mesh axes
    (``partition.batch_rows``), this rank's rows are gathered over them
    (no gradient), the layer routes them all — capacities are competed
    for across the whole batch, as the reference's decode step routes
    it — and this rank's rows of the result are taken back."""
    rules, specs, rows, cache = partition.installed()
    mesh = None if rules is None else rules.mesh
    if mesh is None or rows is None or mesh.axis_size(rows) == 1:
        return apply_moe(p, cfg, x)
    full = collectives.gather_dim(x.contiguous(), mesh.group(rows), 0)
    with partition.use_rules(rules, specs, None, cache):
        y = apply_moe(p, cfg, full)
    n = x.shape[0]
    return y.narrow(0, mesh.axis_index(rows) * n, n)


# ---------------------------------------------------------------------------
# GShard one-hot oracle (smoke scale; the reference the sort-based path is
# tested against)
# ---------------------------------------------------------------------------

def _top_k_gating(logits: torch.Tensor, k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, E) → (dispatch (T, E, C), combine (T, E, C)): first come,
    first served over the flat (token, slot) order, as
    ``_dispatch_indices``."""
    t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    onehot = F.one_hot(gate_idx, e).to(torch.int64)           # (T, k, E)
    flat = onehot.reshape(t * k, e)
    pos = torch.cumsum(flat, 0) * flat                        # 1-based
    pos = (pos.sum(-1) - 1).reshape(t, k)                     # (T, k)
    keep = pos < capacity
    oh_cap = F.one_hot(torch.where(keep, pos, capacity),
                       capacity + 1).to(probs.dtype)[..., :capacity]
    d_slot = onehot.to(probs.dtype)[..., None] * oh_cap[:, :, None, :]
    dispatch = d_slot.sum(1)                                  # (T, E, C)
    combine = (d_slot * gate_vals[..., None, None]).sum(1)
    return dispatch, combine


def apply_moe_gshard(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                     router_logits: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """O(T·E·C) one-hot dispatch with plain products and dense weights —
    the oracle of the sort-based path, bypassing the site dispatch.
    ``router_logits`` (T, E) replaces the plain router product, so that the
    oracle routes as a path under test did (a one-ulp difference in a
    logit can pick another expert)."""
    b, s, d = x.shape
    m = cfg.moe
    t = b * s
    xt = x.reshape(t, d)
    capacity = _capacity(t, m.top_k, m.n_experts, m.capacity_factor)
    logits = (torch.matmul(xt.float(), _dense_w(p["router"]).float())
              if router_logits is None else router_logits)
    dispatch, combine = _top_k_gating(logits, m.top_k, capacity)
    xe = torch.einsum("tec,td->ecd", dispatch.to(x.dtype).float(),
                      xt.float()).to(x.dtype)
    ye = _expert_ffn_dense(xe, p)
    y = torch.einsum("tec,ecd->td", combine.to(x.dtype).float(),
                     ye.float()).to(x.dtype)
    if "shared" in p:
        sp = p["shared"]
        hs = _act_mul(_einsum(xt[None], _dense_w(sp["w_gate"])[None])[0],
                      _einsum(xt[None], _dense_w(sp["w_in"])[None])[0])
        y = y + _einsum(hs[None], _dense_w(sp["w_out"])[None])[0]
    return y.reshape(b, s, d)


def load_balance_loss(logits: torch.Tensor,
                      dispatch: torch.Tensor) -> torch.Tensor:
    """Auxiliary load-balancing loss (Switch §2.2): E · Σ_e (share of the
    dispatched (token, slot) pairs that expert e holds) · (mean router
    probability of e).  ``logits`` (T, E), ``dispatch`` (T, E, C) as
    ``_top_k_gating`` gives it."""
    probs = torch.softmax(logits, dim=-1)
    e = probs.shape[-1]
    frac_tokens = dispatch.sum((0, 2)) / torch.clamp_min(dispatch.sum(),
                                                         1e-9)
    frac_probs = probs.mean(0)
    return e * torch.sum(frac_tokens * frac_probs)
