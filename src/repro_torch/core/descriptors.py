"""Per-layer configuration descriptors (FlexNN §III-A/§VI), ported from the
JAX package's ``core/descriptors.py``.

One ``SiteDescriptor`` per matmul *site* (attn.q / attn.kv / attn.out /
mlp.in / mlp.gate / mlp.out / lm_head ...) binds the site's dims to

  * a ``MatmulSchedule`` (stationarity + kernel block shapes),
  * a ``ReduceConfig`` (FlexTree: contraction partition + combine strategy),
  * the sparsity mode in force.

``compile_network_schedule`` is the compiler pass: it walks an ArchConfig,
derives every site's (M, N, K) for a given input shape and runs the schedule
selector per site.  ``kernels.ops.flex_matmul`` consults the table by site
name: ``dense`` sites run the schedule-flexible matmul kernel,
``weight``/``two_sided`` sites the block-sparse kernel at the schedule's
(bm, bk, bn) granularity.  Bitmaps derived from the data make every mode
numerically identical to dense — zero blocks are skipped, never
approximated.  Densities start from config priors
(``sparsity_densities_for``) and are replaced by measured values
(``compile_network_schedule(wt_densities=..., act_densities=...)``).
``site_plan_estimate`` models what a compiled plan would measure at a site
from the config's density prior alone.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.energy_model import zvc_weight_bytes
from repro_torch.core.flextree import ReduceConfig, best_strategy
from repro_torch.core.scheduler import (MatmulSchedule, TPUHardware, TPU_V5E,
                                        select_matmul_schedule)


@dataclass(frozen=True)
class SiteDescriptor:
    site: str
    m: int
    n: int
    k: int
    schedule: MatmulSchedule
    reduce: ReduceConfig
    sparsity_mode: str = "dense"      # dense | weight | two_sided

    def describe(self) -> str:
        s = self.schedule
        return (f"{self.site}: M={self.m} N={self.n} K={self.k} "
                f"{s.stationarity}-stationary ({s.bm}x{s.bn}x{s.bk}) "
                f"ic_p={self.reduce.ic_p}/{self.reduce.strategy} "
                f"[{self.sparsity_mode}]")


@dataclass
class NetworkSchedule:
    arch: str
    shape: str
    sites: Dict[str, SiteDescriptor] = field(default_factory=dict)

    def describe(self) -> str:
        lines = [f"# NetworkSchedule {self.arch} @ {self.shape}"]
        lines += ["  " + d.describe() for d in self.sites.values()]
        return "\n".join(lines)


def matmul_sites(cfg: ArchConfig, shape: ShapeConfig,
                 model_shards: int = 1) -> List[Tuple[str, int, int, int]]:
    """Every matmul site (name, M, N, K) as lowered per device-row.

    M = tokens per step; TP sharding divides N (or K) by ``model_shards`` —
    the per-device matmul is what the schedule applies to.
    """
    if shape.kind == "train" or shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
    else:
        tokens = shape.global_batch            # one new token per sequence
    d = cfg.d_model
    hd = cfg.head_dim
    ms = model_shards
    sites: List[Tuple[str, int, int, int]] = [
        ("attn.q", tokens, cfg.n_heads * hd // ms, d),
        ("attn.kv", tokens, 2 * max(cfg.n_kv_heads // ms, 1) * hd, d),
        ("attn.out", tokens, d, cfg.n_heads * hd // ms),
    ]

    def mlp_sites() -> List[Tuple[str, int, int, int]]:
        out = [("mlp.in", tokens, 3 * cfg.d_ff // ms, d)]
        if cfg.act != "gelu_plain":    # gated MLPs: gate shares mlp.in dims
            out.append(("mlp.gate", tokens, 3 * cfg.d_ff // ms, d))
        out.append(("mlp.out", tokens, d, cfg.d_ff // ms))
        return out

    if cfg.moe.enabled:
        sites.append(("moe.router", tokens, cfg.moe.n_experts, d))
        cap = int(tokens * cfg.moe.top_k / cfg.moe.n_experts
                  * cfg.moe.capacity_factor) + 1
        f = cfg.moe.expert_d_ff
        # batched-expert einsum sites (E, C, K) × (E, K, N): per-expert
        # (M, N, K) with M = capacity-padded tokens per expert; one schedule
        # (and one PlannedWeight max_nnz) shared across the E experts
        sites.append(("moe.experts_in", cap, f, d))
        sites.append(("moe.experts_gate", cap, f, d))
        sites.append(("moe.experts_out", cap, d, f))
        if cfg.moe.n_shared:
            fs = f * cfg.moe.n_shared
            sites.append(("moe.shared_in", tokens, fs // ms, d))
            sites.append(("moe.shared_gate", tokens, fs // ms, d))
            sites.append(("moe.shared_out", tokens, d, fs // ms))
        if cfg.moe.first_dense_layers and cfg.d_ff:
            # leading dense layers (DeepSeek-MoE) use the ordinary MLP sites
            sites += mlp_sites()
    elif cfg.d_ff:
        sites += mlp_sites()
    if cfg.ssm.enabled:
        d_in = cfg.ssm.expand * d
        sites = [("ssm.in_proj", tokens, (2 * d_in) // ms, d),
                 ("ssm.out_proj", tokens, d, d_in // ms)]
    if cfg.rglru.enabled:
        w = cfg.rglru.lru_width
        sites.append(("rglru.in", tokens, 2 * w // ms, d))
        sites.append(("rglru.gate", tokens, 2 * w // ms, d))
        sites.append(("rglru.out", tokens, d, w // ms))
    sites.append(("lm_head", tokens, cfg.vocab // ms, d))
    return sites


def sparsity_mode_for(cfg: ArchConfig) -> str:
    """ArchConfig.sparsity → sparsity_mode (the §III-D capability ladder).

    weight sparsity alone → ``weight`` (FL-side skipping only); an
    activation threshold (with or without pruned weights) → ``two_sided``
    (CSB = IF ∧ FL — a dense FL bitmap degenerates to IF-side skipping).
    """
    sp = cfg.sparsity
    if sp.activation_threshold > 0.0:
        return "two_sided"
    if sp.weight_sparsity > 0.0:
        return "weight"
    return "dense"


def sparsity_densities_for(cfg: ArchConfig) -> Tuple[float, float]:
    """(act_density, wt_density) estimates for schedule costing.

    wt_density is exactly the unpruned fraction; act_density under a
    threshold uses the ReLU-ish half-live prior (§II-B) — runtime bitmaps
    refine it, the scheduler only needs the expectation.
    """
    sp = cfg.sparsity
    wt = 1.0 - sp.weight_sparsity
    act = 0.5 if sp.activation_threshold > 0.0 else 1.0
    return act, wt


def compile_network_schedule(cfg: ArchConfig, shape: ShapeConfig, *,
                             model_shards: int = 1,
                             contraction_axis: str = "model",
                             hw: TPUHardware = TPU_V5E,
                             wt_densities: Optional[Dict[str, float]] = None,
                             act_densities: Optional[Dict[str, float]] = None,
                             quantize: bool = False,
                             ) -> NetworkSchedule:
    """The compiler pass: optimal schedule per site (§III-A role).

    ``wt_densities``/``act_densities`` override the config-level priors with
    *measured* per-site densities — weight side from a compiled
    ``WeightSparsityPlan`` (``plan.wt_densities()``), activation side from
    runtime bitmap popcounts fed back by the engine
    (``ServeEngine.activation_densities()``).

    ``quantize`` costs every site's weight operand at int8 width
    (``wt_bytes=1`` into the selector; activations stay ``in_bytes``), so
    the argmin ranks schedules by the compounded int8 × ZVC traffic — the
    byte model the quantized serving path actually executes under.
    """
    ns = NetworkSchedule(arch=cfg.name, shape=shape.name)
    spars = sparsity_mode_for(cfg)
    act_d, wt_d = sparsity_densities_for(cfg)
    wt_bytes = 1 if quantize else None
    for site, m, n, k in matmul_sites(cfg, shape, model_shards):
        # tied head = the (never-pruned, never-planned) embedding table: its
        # FL bitmap is always all-live, so sparse dispatch would pay the
        # trace-time metadata build on the vocab-sized weight every token
        # for zero skipping — keep the site dense (mirrors the plan-layer
        # tie_embeddings guard in core.sparsity)
        mode = "dense" if (site == "lm_head" and cfg.tie_embeddings) \
            else spars
        # FlexTree decision: partition the contraction if K is large and the
        # site's weight is K-sharded (attn.out / mlp.out style sites).
        k_sharded = site.endswith(".out") or site.endswith("out_proj")
        ic_p = model_shards if (k_sharded and model_shards > 1) else 1
        # a tied (never-quantized) head also keeps the bf16 weight bytes
        site_wb = None if (site == "lm_head" and cfg.tie_embeddings) \
            else wt_bytes
        sched = select_matmul_schedule(
            m, n, k, hw=hw, ic_p=ic_p, sparsity_mode=mode,
            act_density=(act_densities or {}).get(site, act_d),
            wt_density=(wt_densities or {}).get(site, wt_d),
            wt_bytes=site_wb)
        payload = m * n * 4.0     # f32 psums
        strat = best_strategy(payload, ic_p, consumer_sharded=False)
        ns.sites[site] = SiteDescriptor(
            site=site, m=m, n=n, k=k, schedule=sched,
            reduce=ReduceConfig(axis_name=contraction_axis, ic_p=ic_p,
                                strategy=strat),
            sparsity_mode=mode,
        )
    return ns


def site_plan_estimate(d: SiteDescriptor, cfg: ArchConfig,
                       in_bytes: int = 2,
                       model_shards: int = 1) -> Dict[str, object]:
    """Modeled weight-plan stats for one site: what ``compile_weight_plan``
    would measure, estimated from the config's density prior.

    Records per-site plan economics where there are no param tensors to
    compile a real plan from: K-block count at the schedule granularity,
    the expected tight ``max_nnz``, and ZVC bytes saved at rest.  Engines
    with real params get measured numbers via ``SitePlan.stats``.
    """
    act_d, wt_d = sparsity_densities_for(cfg)
    bk = max(min(d.schedule.bk, d.k), 1)
    tk = -(-d.k // bk)
    sparse = d.sparsity_mode in ("weight", "two_sided")
    est_nnz = max(1, min(tk, math.ceil(tk * wt_d))) if sparse else tk
    # batched-expert sites carry E per-expert (K, N) matrices behind one
    # descriptor — the plan economics scale by the *per-device* expert
    # count: like matmul_sites, the estimate is per device-row; expert
    # tensors are EP-sharded over the model axis (ceil for uneven splits —
    # the worst-loaded device)
    n_mats = 1
    if d.site.startswith("moe.experts") and cfg.moe.enabled:
        n_mats = -(-cfg.moe.n_experts // model_shards)
    dense_bytes = d.k * d.n * in_bytes * n_mats
    zvc_bytes = (dense_bytes * wt_d + n_mats * d.k * d.n / 8.0 if sparse
                 else float(dense_bytes))
    # int8 columns: the same at-rest economics with a 1-byte payload plus
    # the per-output-channel f32 scales — reported unconditionally so the
    # estimate records the quantization headroom even for bf16 plans
    n_elems = n_mats * d.k * d.n
    nnz = n_elems * (wt_d if sparse else 1.0)
    n_channels = n_mats * d.n
    int8_zvc = (zvc_weight_bytes(n_elems, nnz, quantized=True,
                                 n_channels=n_channels) if sparse
                else float(nnz) + 4.0 * n_channels)
    out = {
        "sparsity_mode": d.sparsity_mode,
        "wt_density": wt_d if sparse else 1.0,
        "tk": tk,
        "est_max_nnz": est_nnz,
        "dense_bytes": dense_bytes,
        "zvc_bytes": zvc_bytes,
        "bytes_saved": max(dense_bytes - zvc_bytes, 0.0),
        "int8_zvc_bytes": int8_zvc,
        "bytes_saved_int8": max(dense_bytes - int8_zvc, 0.0),
        "int8_vs_sparse_reduction": zvc_bytes / int8_zvc if int8_zvc else 1.0,
    }
    if n_mats > 1:
        out["experts"] = n_mats
        out["per_expert_dense_bytes"] = d.k * d.n * in_bytes
        out["per_expert_zvc_bytes"] = zvc_bytes / n_mats
    return out
