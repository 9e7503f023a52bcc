"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427 §2.4).

The recurrence  h_t = a_t ⊙ h_{t-1} + √(1-a_t²) ⊙ (i_t ⊙ x_t)  with
a_t = exp(-c·softplus(Λ)·r_t),  r_t / i_t input-dependent sigmoid gates, is
linear (diagonal) in h.  The reference runs the full sequence as a
``jax.lax.associative_scan``; here it is a log-depth (Hillis–Steele) scan
in float32 over the same combine, so the two agree to float32 rounding, not
bit for bit.

Block layout (Griffin "recurrent block"): two d_model → lru_width branches;
the x-branch goes conv1d(d_conv) → RG-LRU, the gate branch through GeLU;
their product projects back to d_model.  The three projections are the
matmul sites ``rglru.in`` / ``rglru.gate`` / ``rglru.out``; the gate
products ``xw @ w_a`` and ``xw @ w_i`` are plain matmuls, as the reference
computes them outside any kernel.

Under tensor parallelism (a model axis above 1) the block is channel-
parallel over ``lru_width``: ``w_x`` / ``w_gate`` column-parallel, the
conv, the gates' biases, Λ and the scan on this rank's channels, and
``rglru.out`` row-parallel with FlexTree's combine.  The gates read the
whole conv'd ``xw``: it is all-gathered over the model axis and meets
this rank's columns of the replicated ``w_a`` / ``w_i``
(``_local_params``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import normal
from repro_torch.sharding import collectives, partition

Params = Dict[str, torch.Tensor]
C_FACTOR = 8.0


def init_rglru(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16,
               lead=()) -> Params:
    """The reference's distributions, drawn leaf by leaf for all ``lead``
    stacked blocks."""
    d, w = cfg.d_model, cfg.rglru.lru_width
    dev = gen.device
    s = d ** -0.5
    lam = torch.linspace(2.0, 6.0, w, dtype=torch.float32, device=dev)
    return {
        "w_x": normal(gen, lead + (d, w), s, dtype),
        "w_gate": normal(gen, lead + (d, w), s, dtype),
        "conv_w": normal(gen, lead + (cfg.rglru.d_conv, w), 0.1, dtype),
        "conv_b": torch.zeros(lead + (w,), dtype=dtype, device=dev),
        "w_a": normal(gen, lead + (w, w), w ** -0.5, dtype),
        "b_a": torch.zeros(lead + (w,), dtype=torch.float32, device=dev),
        "w_i": normal(gen, lead + (w, w), w ** -0.5, dtype),
        "b_i": torch.zeros(lead + (w,), dtype=torch.float32, device=dev),
        # Λ so that a^c ∈ (0.9, 0.999) at r = 1 (paper §2.4)
        "lam": lam.expand(lead + (w,)).contiguous(),
        "w_out": normal(gen, lead + (w, d), w ** -0.5, dtype),
    }


def _gates(p: Params, xw: torch.Tensor, xg: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gate values for the conv'd x-branch ``xw`` (..., W): (a, gated_in),
    both float32.  ``xg`` (tensor parallelism: the whole ``xw`` gathered
    over the model axis) is what the gate products read, else ``xw``."""
    xg = xw if xg is None else xg
    r = torch.sigmoid(torch.matmul(xg, p["w_a"]).float() + p["b_a"])
    i = torch.sigmoid(torch.matmul(xg, p["w_i"]).float() + p["b_i"])
    log_a = -C_FACTOR * F.softplus(p["lam"]) * r          # log a_t
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)) \
        * i * xw.float()
    return a, gated


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence axis: x (B, S, W), w (K, W)."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + s] * w[i]
    return out + b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t from h_{-1} = 0 along axis 1: the inclusive
    scan of the combine (a1, b1)∘(a2, b2) = (a1·a2, b1·a2 + b2) in
    ⌈log2 S⌉ doubling steps."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def _local_params(cfg: ArchConfig, p: Params, tp) -> Params:
    """This rank's ``lru_width`` channels of every leaf (module docstring),
    as the installed specs store them (``partition.model_block``): a leaf
    stored otherwise — ``conv_w`` split over its taps, the replicated
    ``w_a`` / ``w_i`` / ``b_i`` / Λ — is made whole with its gradient
    summed over ``model`` and cut."""
    w = cfg.rglru.lru_width
    if w % tp.size:
        raise NotImplementedError(f"{cfg.name}: lru_width {w} over "
                                  f"{tp.size} model shards")
    out = {name: partition.model_block(p, name, tp, -1)
           for name in ("w_x", "w_gate", "conv_w", "conv_b", "w_a", "b_a",
                        "w_i", "b_i", "lam")}
    out["w_out"] = partition.model_block(p, "w_out", tp, 0)
    return out


def rglru_forward(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence recurrent block.  x (B, S, D) → (B, S, D); under
    tensor parallelism on this rank's channels (module docstring)."""
    tp = partition.tensor_parallel()
    if tp is not None:
        p = _local_params(cfg, p, tp)
        x = collectives.to_model(x, tp.group)
    xb = ops.flex_matmul(x, p["w_x"], site="rglru.in")
    gate = ops.flex_matmul(x, p["w_gate"], site="rglru.gate")
    xb = _causal_conv(xb, p["conv_w"], p["conv_b"])
    xg = None if tp is None else collectives.all_gather(xb, tp.group, -1)
    a, gated = _gates(p, xb, xg)
    h = linear_scan(a, gated)
    h = h.to(x.dtype) * F.gelu(gate, approximate="tanh")
    return ops.flex_matmul(h, p["w_out"], site="rglru.out",
                           partial=tp is not None)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_rglru_state(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                     device="cpu", lead=()) -> Params:
    w = cfg.rglru.lru_width
    return {
        "h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(lead + (batch, cfg.rglru.d_conv - 1, w),
                            dtype=dtype, device=device),
    }


def rglru_decode_step(p: Params, cfg: ArchConfig, x: torch.Tensor,
                      state: Params, *, active: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Params]:
    """x (B, 1, D); state {h (B, W), conv (B, K-1, W)}, updated **in
    place** at the ``active`` (B,) rows (every row when None); the other
    rows keep their state bit for bit.  The matmuls take the site names of
    the full-sequence path, so the descriptor table and the weight plan
    apply to decode as well.  Under tensor parallelism on this rank's
    channels, as ``rglru_forward``: its block of ``h`` and of the conv
    window, the gates reading the conv'd x gathered over the model axis,
    ``rglru.out`` row-parallel with the combine."""
    tp = partition.tensor_parallel()
    if tp is not None:
        p = _local_params(cfg, p, tp)
    xb = ops.flex_matmul(x[:, 0], p["w_x"], site="rglru.in")
    gate = ops.flex_matmul(x[:, 0], p["w_gate"], site="rglru.gate")
    win = torch.cat([state["conv"], xb[:, None].to(state["conv"].dtype)],
                    dim=1)
    xc = (win * p["conv_w"][None]).sum(dim=1) + p["conv_b"]
    xg = (None if tp is None
          else collectives.gather_dim(xc.contiguous(), tp.group, -1))
    a, gated = _gates(p, xc, xg)
    h = a * state["h"] + gated
    y = h.to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = ops.flex_matmul(y, p["w_out"], site="rglru.out",
                          partial=tp is not None)[:, None]
    conv = win[:, 1:]
    if active is not None:
        h = torch.where(active[:, None], h, state["h"])
        conv = torch.where(active[:, None, None], conv, state["conv"])
    state["h"].copy_(h)
    state["conv"].copy_(conv)
    return out, state
