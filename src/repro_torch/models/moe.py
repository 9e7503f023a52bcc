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

Out of scope: the expert-parallel ``shard_map`` path (distribution).
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


def apply_moe(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) → (B, S, D): routed experts plus shared experts (the
    ``moe.shared_*`` sites)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    y = _apply_moe_local(p, cfg, xt).reshape(b, s, d)
    if "shared" in p:
        sp = p["shared"]
        hs = _act_mul(ops.flex_matmul(xt, sp["w_gate"],
                                      site="moe.shared_gate"),
                      ops.flex_matmul(xt, sp["w_in"], site="moe.shared_in"))
        y = y + ops.flex_matmul(hs, sp["w_out"],
                                site="moe.shared_out").reshape(b, s, d)
    return y


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
