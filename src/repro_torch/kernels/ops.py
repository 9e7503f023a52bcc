"""Per-site matmul dispatch (the JAX package's ``kernels/ops.py``).

Every matmul of the model routes through ``flex_matmul`` (2-D or stacked
leaves), ``flex_expert_matmul`` (the MoE expert contraction (E, C, K) @
(E, K, N)) or ``head_matmul`` (the lm_head contraction).  A
thread-local ``ExecConfig`` carries the descriptor table and decides:

  1. ``w`` is a ``PlannedWeight`` (a precompiled plan was attached at
     bring-up) → the block-sparse kernel with the plan's tight ``max_nnz``;
     only the activation bitmap is derived per step (two_sided).  A
     quantized plan runs the scaled kernel on its int8 payload.  A pruned
     plan tier (``gather``) runs the same kernels with its own lists; on
     the CPU it contracts just its listed blocks
     (``_gathered_planned_matmul``);
  2. ``w`` is an unplanned ``QuantizedLinear`` → with ``use_kernels``, a 2-D
     leaf and a dense (or absent) descriptor, the int8 matmul kernel;
     otherwise it is dequantized to the activation's dtype and dispatched
     on as a dense weight;
  3. the site's descriptor says ``weight`` / ``two_sided`` → the
     block-sparse kernel with metadata built from the operands;
  4. ``use_kernels`` → the schedule-flexible matmul kernel under the site's
     (stationarity, blocks);
  5. otherwise a plain float32-accumulated ``torch.matmul``.

``ExecConfig.sparse_dispatch=False`` switches routes 1 and 3 off, as in the
reference: a ``PlannedWeight`` takes its dense fallback (``w_kn``: the
weight, or the int8 payload dequantized to float32, in which case the
product is taken in float32), no descriptor sends a site to the
block-sparse kernel and no activation popcount is recorded.  The dense
fallback still runs at the site's scheduled stationarity and blocks
(``site_schedule`` ignores the switch).

``flex_expert_matmul`` takes the same routes over a leading expert axis —
a planned (L, E, K, N) leaf's layer slice, trace-time metadata, the dense
kernel, and an unplanned int8 stack dequantized first — with the metadata
built once for all E experts and, at decode, one kernel launch per site
over all of them (the reference launches one Pallas kernel per expert).

The flash branch of full-sequence attention routes through
``flash_attention``: the flash-attention kernel with ``use_kernels``, else
its plain online softmax.

The kernel wrappers launch CUDA kernels for CUDA tensors and run their plain
versions for CPU tensors.  Bitmaps derived from the data make every mode
equal to the dense product: zero blocks are skipped, never approximated.
All metadata is built with device ops — nothing here waits on the device.

Runtime feedback: under ``sparsity_stats(collector)`` every two-sided site
(planned or operand-derived) adds its activation popcount to a per-site
device counter; ``active_rows`` restricts the count to live rows.  The
counters are read only by ``SparsityStatsCollector.densities`` — recording
adds no host sync to a step.

Gradients.  Under autograd (grad mode on and an operand that requires
grad) the dense route (4 or 5) of ``flex_matmul`` and of
``flex_expert_matmul`` and the flash branch run as
``torch.autograd.Function``s: the forward is the same call as without
grad; the backward of a matmul is dX = dY·Wᵀ and dW = Xᵀ·dY (per expert
over a leading expert axis) through the same route (the schedule-flexible
kernel at the site's schedule, Wᵀ read in place as the transposed view of
the row-major weight, Xᵀ copied row-major; or the plain float32-accumulated
product), and the flash branch's is ``fa_backward`` (or its plain
version), both counted in the wrappers' ``LAUNCHES``.  Operands of two
dtypes meet in the promoted one, as without grad, and the casts carry the
gradients back.  Each Function keeps the route it took in its context, so
its backward, which PyTorch may run on another thread, does not read the
thread-local config.  Routes with no backward raise
``NotImplementedError`` naming the site: a ``PlannedWeight``, a
``weight`` / ``two_sided`` descriptor and an int8 leaf, in both entry
points; so does the flash kernel at a head dim ``fa_backward`` does not
take.  ``DotsTape`` (``recording`` / ``replaying``) is how
``remat="dots"`` keeps the matmul and flash outputs of a layer's forward
and hands them back, in order, to its recomputation.

Tensor parallelism.  Under a model axis above 1
(``sharding.partition.tensor_parallel``) the layers pass this rank's
shard of a weight: a column-parallel site (``attn.q``, ``attn.kv``,
``mlp.in``, ``mlp.gate``) runs the same routes on its N columns (its
input entered through ``collectives.to_model``, whose backward
all-reduces dX); a row-parallel site (``attn.out``, ``mlp.out``: the
descriptor's ``reduce.ic_p`` above 1) runs them on its K rows and,
with ``partial=True``, combines the partial sums by
``flextree.reduce_psum`` under the descriptor's strategy (the table must
be compiled for as many shards, ``ExecConfig.model_shards``); the
combine's backward passes dY through.

``decode_rows`` cuts every site's rows into chunks of at most
``flex_matmul.OS_SKINNY_ROWS``: a speculative verify window scores B·(k+1)
rows, and the kernels pick their regime (and so each element's summation
order) from the row count, so under it every row is summed as in a decode
step.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import sparsity as sparsity_lib
from repro_torch.core.flextree import ReduceConfig
from repro_torch.core.sparsity import PlannedWeight
from repro_torch.kernels import block_sparse as bs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flex_matmul as fm
from repro_torch.kernels.flex_matmul import DEFAULT_BLOCKS, pad_to_blocks
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.ref import (block_sparse_matmul_ref,
                                     flash_attention_backward_plain,
                                     flash_attention_plain,
                                     windowed_attention)
from repro_torch.quant.quantize import QuantizedLinear, dequantize_leaf
from repro_torch.sharding import collectives, partition

_state = threading.local()


@dataclass(frozen=True)
class ExecConfig:
    use_kernels: bool = False         # flex / int8 / flash kernels
    schedules: Optional[object] = None   # NetworkSchedule (descriptor table)
    sparse_dispatch: bool = True      # honour plans and sparsity modes
    plan: Optional[object] = None     # WeightSparsityPlan (engine bring-up)
    quantize: bool = False            # params int8-quantized at bring-up
    collect_stats: bool = False       # count activation popcounts per site
    # the per-site activation densities the table was selected under (None
    # = the 0.5 prior: the drift baseline of ``maybe_recalibrate``) and the
    # ArchConfig it was compiled from, so the engine can recompile it
    act_densities: Optional[Dict[str, float]] = None
    arch_cfg: Optional[object] = None
    model_shards: int = 1             # TP degree the table was compiled for


def _cfg() -> ExecConfig:
    return getattr(_state, "cfg", None) or ExecConfig()


def current_exec_config() -> ExecConfig:
    """The ExecConfig installed on this thread (the default without one);
    a recomputation on another thread installs it again."""
    return _cfg()


@contextlib.contextmanager
def exec_config(cfg: ExecConfig):
    prev = getattr(_state, "cfg", None)
    _state.cfg = cfg
    try:
        yield cfg
    finally:
        _state.cfg = prev


class SparsityStatsCollector:
    """Per-site activation popcounts, accumulated on the device: each site
    holds one int64 (live, total) tensor, added to in place by every
    recorded matmul and read only by ``densities``.  A site's tensor lives
    as long as the collector, so a captured CUDA graph that adds into it
    keeps adding into the tensor ``densities`` reads: ``reset`` zeroes the
    counts in place."""

    def __init__(self):
        self._acc: Dict[str, torch.Tensor] = {}

    def reset(self) -> None:
        for acc in self._acc.values():
            acc.zero_()

    def snapshot(self) -> Dict[str, torch.Tensor]:
        """A copy of every site's counts, for ``restore``."""
        return {s: acc.clone() for s, acc in self._acc.items()}

    def restore(self, snap: Dict[str, torch.Tensor]) -> None:
        """Put back the counts of ``snapshot``; sites created since then
        count nothing."""
        for site, acc in self._acc.items():
            if site in snap:
                acc.copy_(snap[site])
            else:
                acc.zero_()

    def record(self, site: str, live: torch.Tensor, total) -> None:
        acc = self._acc.get(site)
        if acc is None:
            acc = self._acc[site] = torch.zeros(2, dtype=torch.int64,
                                                device=live.device)
        acc[0].add_(live)
        acc[1].add_(total)

    def densities(self) -> Dict[str, float]:
        """Measured element-level activation density per site (one device
        read for all sites); sites with no counted element are skipped."""
        if not self._acc:
            return {}
        sites = list(self._acc)
        counts = torch.stack([self._acc[s] for s in sites]).cpu().tolist()
        return {s: live / total for s, (live, total) in zip(sites, counts)
                if total}


@contextlib.contextmanager
def sparsity_stats(collector: SparsityStatsCollector):
    """Install ``collector``: two-sided sites record their activation
    popcounts into it."""
    prev = getattr(_state, "collector", None)
    _state.collector = collector
    try:
        yield collector
    finally:
        _state.collector = prev


@contextlib.contextmanager
def active_rows(mask: Optional[torch.Tensor]):
    """Install a (B,) bool row mask: popcounts count only these rows, so
    dead slots' and mid-prefill rows' filler tokens do not skew the
    measured density (a 1-live-of-N engine measures what a 1-slot engine
    measures).  Operands whose row count is not B count every row."""
    prev = getattr(_state, "rows", None)
    _state.rows = mask
    try:
        yield mask
    finally:
        _state.rows = prev


@contextlib.contextmanager
def decode_rows():
    """Run every matmul site in chunks of at most ``OS_SKINNY_ROWS`` rows,
    the kernels' decode regime (module docstring)."""
    prev = getattr(_state, "row_cap", None)
    _state.row_cap = fm.OS_SKINNY_ROWS
    try:
        yield
    finally:
        _state.row_cap = prev


def _record_act_stats(site: str, x2: torch.Tensor) -> None:
    col = getattr(_state, "collector", None)
    if col is None or not site:
        return
    rows = getattr(_state, "rows", None)
    nz = x2 != 0
    if rows is not None and x2.dim() == 2 and rows.shape[0] == x2.shape[0]:
        live = (nz & rows[:, None]).sum()
        total = rows.sum() * x2.shape[1]
    else:
        live = nz.sum()
        total = x2.numel()
    col.record(site, live, total)


def _site_descriptor(site: str, cfg: ExecConfig):
    if cfg.schedules is not None and site in cfg.schedules.sites:
        return cfg.schedules.sites[site]
    return None


def site_schedule(site: str):
    """The site's ``MatmulSchedule`` in the active table (None without
    one), whether or not sparse dispatch is on."""
    desc = _site_descriptor(site, _cfg())
    return desc.schedule if desc is not None else None


def site_sparsity_mode(site: str) -> str:
    """The sparsity mode the site dispatches under: its descriptor's, or
    ``dense`` without one or with sparse dispatch off."""
    cfg = _cfg()
    desc = _site_descriptor(site, cfg)
    if desc is None or not cfg.sparse_dispatch:
        return "dense"
    return desc.sparsity_mode


def common_dtype(x: torch.Tensor, w: torch.Tensor):
    """Both operands in their promoted dtype, as a jnp product of two
    dtypes computes: a bf16 activation meets the float32 weight of a
    quantized plan's dense fallback in float32, a float32 activation (an
    encoder over float32 frames) bf16 weights in float32."""
    if x.dtype == w.dtype:
        return x, w
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def _run_block_sparse(xp: torch.Tensor, wp: torch.Tensor, meta, m: int,
                      n: int, scale=None) -> torch.Tensor:
    """Kernel dispatch + unpad tail shared by both metadata sources
    (``scale``: the padded per-column scales of an int8 ``wp``); (E, M, K)
    operands carry per-expert metadata."""
    out = bs.block_sparse_matmul(xp, wp, meta, out_dtype=torch.float32,
                                 scale=scale, rows=m)
    return out[..., :n]


def _sparse_site_matmul(x2: torch.Tensor, w: torch.Tensor, mode: str,
                        sched, site: str = "") -> torch.Tensor:
    """(M, K) @ (K, N), or (E, M, K) @ (E, K, N) expert by expert, through
    the CSB path with metadata built from the operands at the site
    schedule's (bm, bk, bn) granularity (inputs zero-padded to block
    multiples; padding blocks are dead).  Returns float32."""
    m, k = x2.shape[-2:]
    n = w.shape[-1]
    if mode == "two_sided":
        _record_act_stats(site, x2)
    if sched is not None:
        bm, bn, bk = sched.bm, sched.bn, sched.bk
    else:
        bm, bn, bk = DEFAULT_BLOCKS
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    xp = pad_to_blocks(x2, bm, bk)
    wp = pad_to_blocks(w, bk, bn)
    tm, tk = xp.shape[-2] // bm, xp.shape[-1] // bk
    b_bitmap = sparsity_lib.block_bitmap(wp, bk, bn)
    if mode == "two_sided":
        a_bitmap = sparsity_lib.block_bitmap(xp, bm, bk)
    else:                             # weight-sided: IF bitmap all ones
        a_bitmap = torch.ones(xp.shape[:-2] + (tm, tk), dtype=torch.bool,
                              device=x2.device)
    meta = sparsity_lib.build_block_sparse_meta(a_bitmap, b_bitmap,
                                                site=site)
    return _run_block_sparse(xp, wp, meta, m, n)


def planned_operands(x2: torch.Tensor, pw: PlannedWeight):
    """(xp, wp, meta, scale) of (M, K) @ planned (K, N), or of (E, C, K) @
    one layer's planned (E, K, N) experts: both operands padded to the
    plan's blocks; the weight-side metadata comes from the plan and only
    the activation bitmap is derived (two_sided; every expert's in one
    pass, the metadata carrying the leading E axis).  A quantized plan
    gives its int8 payload and its scales ((N,) or (E, N)) padded alike;
    ``scale`` is None otherwise."""
    k = x2.shape[-1]
    xp = pad_to_blocks(x2, pw.bm, pw.bk)
    wp = pw.kn_padded
    scale = None
    if pw.quantized:
        scale = pad_to_blocks(pw.qscale[..., None, :], 1,
                              pw.bn)[..., 0, :].contiguous()
    tm, tk = xp.shape[-2] // pw.bm, xp.shape[-1] // pw.bk
    if tk != pw.tk:
        raise ValueError(
            f"{pw.site}: plan compiled for tk={pw.tk} K-blocks of {pw.bk}, "
            f"operand K={k} gives {tk} — rebuild the plan for these shapes")
    if pw.mode == "two_sided":
        a_bitmap = sparsity_lib.block_bitmap(xp, pw.bm, pw.bk)
        meta = sparsity_lib.combine_with_activation_meta(
            a_bitmap, pw.wkidx, pw.wkcnt, pw.b_bitmap)
    else:
        meta = sparsity_lib.weight_plan_meta(pw.wkidx, pw.wkcnt,
                                             pw.b_bitmap, tm)
    return xp, wp, meta, scale


def _gathered_planned_matmul(x2: torch.Tensor,
                             pw: PlannedWeight) -> torch.Tensor:
    """(M, K) @ a pruned tier's (K, N) on the CPU, in float32: each output
    column contracts only its ≤ ``max_nnz`` listed K-blocks, gathered from
    the activation and taken from ``pw.wgather`` (or gathered from the
    weight here when it is absent; empty list slots point at block 0 and
    are zeroed), as one batched matmul over the tn columns.  The sums are
    grouped unlike the dense product's, so the last bits may differ."""
    m, k = x2.shape
    tn = pw.wkcnt.shape[-1]
    kp, np_ = pw.tk * pw.bk, tn * pw.bn
    n = pw.kn.shape[-1]
    idx = pw.wkidx.long()
    xg = F.pad(x2, (0, kp - k)).reshape(m, pw.tk, pw.bk)[:, idx]
    if pw.wgather is not None:
        wg = pw.wgather.float()                     # (tn, nnz, bk, bn)
    else:
        wb = F.pad(pw.kn, (0, np_ - n, 0, kp - k)).reshape(
            pw.tk, pw.bk, tn, pw.bn).permute(2, 0, 1, 3)
        live = (torch.arange(pw.max_nnz, device=x2.device)[None, :]
                < pw.wkcnt[:, None])
        wg = (wb[torch.arange(tn, device=x2.device)[:, None], idx].float()
              * live[:, :, None, None])
    lhs = xg.float().reshape(m, tn, pw.max_nnz * pw.bk).transpose(0, 1)
    out = torch.bmm(lhs, wg.reshape(tn, pw.max_nnz * pw.bk, pw.bn))
    out = out.transpose(0, 1).reshape(m, np_)[:, :n]
    if pw.quantized:
        out = out * pw.qscale[None, :]
    return out


def _planned_matmul(x2: torch.Tensor, pw: PlannedWeight) -> torch.Tensor:
    """(M, K) @ planned (K, N), or (E, C, K) @ one layer's planned experts,
    through the block-sparse kernel (the scaled one for a quantized plan);
    a pruned tier on the CPU through ``_gathered_planned_matmul``.  Returns
    float32."""
    if pw.mode == "two_sided":
        _record_act_stats(pw.site, x2)
    if pw.gather and x2.device.type == "cpu":
        if x2.dim() == 3:
            return torch.stack([_gathered_planned_matmul(x2[e], pw.index(e))
                                for e in range(x2.shape[0])])
        return _gathered_planned_matmul(x2, pw)
    if pw.gather and (pw.bk % fm.OS_CHUNK or pw.bn % fm.OS_COLS):
        raise ValueError(
            f"{pw.site}: a pruned plan tier at blocks (bk={pw.bk}, "
            f"bn={pw.bn}) is not walked exactly by the block-sparse kernel, "
            f"which skips {fm.OS_CHUNK}-wide K chunks per {fm.OS_COLS} "
            f"output columns")
    xp, wp, meta, scale = planned_operands(x2, pw)
    return _run_block_sparse(xp, wp, meta, x2.shape[-2], pw.kn.shape[-1],
                             scale=scale)


def _plain_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32-accumulated x @ w, cast back to x's dtype."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


class DotsTape:
    """The matmul and flash outputs of one ``remat="dots"`` segment: its
    forward appends them (``recording``) and its recomputation takes them
    back in the same order (``replaying``) instead of computing them."""

    def __init__(self):
        self.saved = []
        self.pos = 0
        self.replay = False

    def take(self):
        out = self.saved[self.pos]
        self.pos += 1
        return out


@contextlib.contextmanager
def recording(tape: DotsTape):
    prev = getattr(_state, "tape", None)
    tape.replay = False
    _state.tape = tape
    try:
        yield tape
    finally:
        _state.tape = prev


@contextlib.contextmanager
def replaying(tape: DotsTape):
    prev = getattr(_state, "tape", None)
    tape.replay, tape.pos = True, 0
    _state.tape = tape
    try:
        yield tape
    finally:
        _state.tape = prev


def _tape_saved():
    """What the active tape hands back (under replay), else None."""
    tape = getattr(_state, "tape", None)
    return tape.take() if tape is not None and tape.replay else None


def _tape_record(value) -> None:
    tape = getattr(_state, "tape", None)
    if tape is not None and not tape.replay:
        tape.saved.append(value)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


def _no_backward(site: str, route: str):
    return NotImplementedError(
        f"{site or 'matmul'}: {route} has no backward; train with no plan, "
        f"no sparsity descriptor and unquantized weights")


def _dense_product(x2: torch.Tensor, w: torch.Tensor, sched,
                   kernels: bool) -> torch.Tensor:
    """(M, K) @ (K, N), or (E, M, K) @ (E, K, N), → float32 through the
    dense route: the schedule-flexible kernel under ``sched``, or the plain
    product."""
    if kernels:
        return fm.flex_matmul(*common_dtype(x2, w), schedule=sched,
                              out_dtype=torch.float32)
    return torch.matmul(x2.float(), w.float())


class _DenseMatmul(torch.autograd.Function):
    """x2 (M, K) @ w (K, N) → float32 (M, N) on the dense route, or x2
    (E, C, K) @ w (E, K, N) → (E, C, N) over the experts, with dX and dW
    through the same route (module docstring).  ``saved``: the output a
    ``remat="dots"`` recomputation is handed back."""

    @staticmethod
    def forward(ctx, x2, w, sched, kernels, saved):
        ctx.save_for_backward(x2, w)
        ctx.sched, ctx.kernels = sched, kernels
        if saved is not None:
            return saved
        return _dense_product(x2, w, sched, kernels)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        dx = dw = None
        if ctx.kernels:
            gk = g.to(x2.dtype).contiguous()
            if ctx.needs_input_grad[0]:
                dx = fm.flex_matmul(gk, w.transpose(-1, -2),
                                    schedule=ctx.sched,
                                    out_dtype=torch.float32)
            if ctx.needs_input_grad[1]:
                dw = fm.flex_matmul(x2.transpose(-1, -2).contiguous(), gk,
                                    schedule=ctx.sched,
                                    out_dtype=torch.float32)
        else:
            if ctx.needs_input_grad[0]:
                dx = torch.matmul(g, w.float().transpose(-1, -2))
            if ctx.needs_input_grad[1]:
                dw = torch.matmul(x2.float().transpose(-1, -2), g)
        return (None if dx is None else dx.to(x2.dtype),
                None if dw is None else dw.to(w.dtype), None, None, None)


def _dense_site(x: torch.Tensor, w: torch.Tensor, site: str,
                cfg: ExecConfig) -> torch.Tensor:
    """Routes 4 and 5 under autograd or a dots tape: ``_DenseMatmul`` over
    the flattened rows (a 2-D ``w``) or over the experts (a 3-D one), in
    x's dtype; operands of two dtypes meet in the promoted one."""
    dtype = x.dtype
    x, w = common_dtype(x, w)
    sched = site_schedule(site) if cfg.use_kernels else None
    x2 = x.reshape(-1, x.shape[-1]) if w.dim() == 2 else x
    out = _DenseMatmul.apply(x2.contiguous() if cfg.use_kernels else x2, w,
                             sched, cfg.use_kernels, _tape_saved())
    _tape_record(out.detach())
    return out.reshape(*x.shape[:-1], w.shape[-1]).to(dtype)


def flex_matmul(x: torch.Tensor, w, *, site: str = "",
                partial: bool = False) -> torch.Tensor:
    """x (..., K) @ w (K, N) through the site dispatch (module docstring).

    ``partial``: ``w`` holds this rank's K rows of a row-parallel site
    (tensor parallelism, ``sharding.partition.tensor_parallel``), so the
    product is a partial sum, combined over the model axis by
    ``flextree.reduce_psum`` under the site descriptor's ``reduce``
    strategy (all-reduce without a table); the backward passes dY
    through."""
    if partial:
        return _row_parallel(flex_matmul(x, w, site=site), site)
    cap = getattr(_state, "row_cap", None)
    rows = x.numel() // max(x.shape[-1], 1)
    if cap is not None and rows > cap:
        x2 = x.reshape(rows, x.shape[-1])
        out = torch.cat([flex_matmul(x2[i:i + cap], w, site=site)
                         for i in range(0, rows, cap)])
        return out.reshape(*x.shape[:-1], out.shape[-1])
    cfg = _cfg()
    lead = x.shape[:-1]
    grad = _needs_grad(x, w)
    if isinstance(w, PlannedWeight):
        if cfg.sparse_dispatch:
            if grad:
                raise _no_backward(site, "a planned weight")
            out = _planned_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)
            return out.reshape(*lead, out.shape[-1]).to(x.dtype)
        w = w.w_kn                     # plan disabled → dense fallback
    desc = _site_descriptor(site, cfg) if cfg.sparse_dispatch else None
    if isinstance(w, QuantizedLinear):
        if grad:
            raise _no_backward(site, "an int8 weight")
        if (cfg.use_kernels and w.q.dim() == 2
                and (desc is None or desc.sparsity_mode == "dense")):
            out = int8_matmul(x.reshape(-1, x.shape[-1]), w,
                              out_dtype=torch.float32)
            return out.reshape(*lead, out.shape[-1]).to(x.dtype)
        # the plain path's semantics: the weight rounded to x's dtype
        w = dequantize_leaf(w, x.dtype)
    sparse = (desc is not None and w.dim() == 2
              and desc.sparsity_mode in ("weight", "two_sided"))
    if grad or getattr(_state, "tape", None) is not None:
        if sparse:
            raise _no_backward(site, f"a {desc.sparsity_mode} descriptor")
        if w.dim() != 2:
            raise _no_backward(site, f"a {w.dim()}-D weight")
        return _dense_site(x, w, site, cfg)
    if sparse or cfg.use_kernels:
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        if sparse:
            out = _sparse_site_matmul(x2, w, desc.sparsity_mode,
                                      desc.schedule, site)
        else:
            out = fm.flex_matmul(*common_dtype(x2, w),
                                 schedule=site_schedule(site),
                                 out_dtype=torch.float32)
        return out.reshape(*lead, w.shape[-1]).to(x.dtype)
    return _plain_matmul(x, w)


def _row_parallel(out: torch.Tensor, site: str) -> torch.Tensor:
    tp = partition.tensor_parallel()
    if tp is None:
        raise ValueError(f"{site}: a partial product needs a model axis "
                         f"above 1 (sharding.partition.use_rules)")
    cfg = _cfg()
    desc = _site_descriptor(site, cfg)
    red = ReduceConfig(axis_name="model", ic_p=tp.size)
    if desc is not None:
        if cfg.model_shards != tp.size:
            raise ValueError(
                f"{site}: the table was compiled for {cfg.model_shards} "
                f"model shards, the mesh has {tp.size}")
        # a site the table does not count as K-sharded (the reference's
        # rule takes ``*.out`` names only: ``moe.shared_out`` is not one)
        # keeps the plain all-reduce
        if desc.reduce.ic_p == tp.size:
            red = desc.reduce
    return collectives.from_model(out, red, tp.group)


def flex_expert_matmul(x: torch.Tensor, w, *, site: str = "") -> torch.Tensor:
    """x (E, C, K) @ w (E, K, N) → (E, C, N) in x's dtype, through the
    site dispatch (the reference's four routes):

      1. ``w`` is a ``PlannedWeight`` of one layer's (E, K, N) experts → the
         batched block-sparse kernel with the plan's per-expert lists and
         site-wide ``max_nnz``;
      2. ``w`` is an unplanned ``QuantizedLinear`` → dequantized to x's
         dtype first, then as a dense weight;
      3. the descriptor says ``weight`` / ``two_sided`` → the batched
         block-sparse kernel with metadata built from the operands;
      4. ``use_kernels`` → the schedule-flexible matmul over the experts
         (one launch at decode, output-stationary); otherwise a plain
         float32-accumulated batched product.

    ``x`` is the capacity-padded dispatch buffer: rows no token was routed
    to are zero, so under two-sided sparsity their activation blocks are
    dead and skipped; the recorded popcounts fold routing occupancy into
    the activation density, as the reference's do.  Under autograd (or a
    dots tape) route 4 (and the plain product) runs as ``_DenseMatmul``
    over the experts; routes 1–3 raise ``NotImplementedError``."""
    cfg = _cfg()
    grad = _needs_grad(x, w)
    if isinstance(w, PlannedWeight):
        if w.w.dim() != 3 or x.dim() != 3 or x.shape[0] != w.w.shape[0]:
            raise ValueError(f"{w.site}: expert operands {tuple(x.shape)} "
                             f"@ {tuple(w.w.shape)}")
        if cfg.sparse_dispatch:
            if grad:
                raise _no_backward(site, "a planned expert weight")
            return _planned_matmul(x.contiguous(), w).to(x.dtype)
        w = w.w_kn                     # plan disabled → dense fallback
    if isinstance(w, QuantizedLinear):
        if grad:
            raise _no_backward(site, "an int8 expert weight")
        w = dequantize_leaf(w, x.dtype)
    if w.dim() != 3 or x.dim() != 3 or x.shape[0] != w.shape[0]:
        raise ValueError(f"{site}: expert operands {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    desc = _site_descriptor(site, cfg) if cfg.sparse_dispatch else None
    if desc is not None and desc.sparsity_mode in ("weight", "two_sided"):
        if grad:
            raise _no_backward(site, f"a {desc.sparsity_mode} descriptor")
        return _sparse_site_matmul(x.contiguous(), w, desc.sparsity_mode,
                                   desc.schedule, site).to(x.dtype)
    if grad or getattr(_state, "tape", None) is not None:
        return _dense_site(x, w, site, cfg)
    if cfg.use_kernels:
        return fm.flex_matmul(
            *common_dtype(x.contiguous(), w), schedule=site_schedule(site),
            out_dtype=torch.float32).to(x.dtype)
    return _plain_matmul(x, w)


class _FlashAttention(torch.autograd.Function):
    """The flash branch with its gradient: the kernel (``kernels``) or the
    plain online softmax over (bq, bkv) blocks forward, keeping the rows'
    log-sum-exp, and ``fa_backward`` or its plain version backward.
    Returns (o, lse); lse has no gradient.  ``saved``: the (o, lse) a
    ``remat="dots"`` recomputation is handed back."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kernels, bq, bkv, saved):
        if saved is not None:
            o, lse = saved
        elif kernels:
            o, lse = fa.flash_attention(q, k, v, causal=causal,
                                        window=window, return_lse=True)
        else:
            o, lse = flash_attention_plain(q, k, v, causal=causal,
                                           window=window, bq=bq, bkv=bkv,
                                           return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, kernels, bq, bkv)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, kernels, bq, bkv = ctx.args
        if kernels:
            dq, dk, dv = fa.flash_attention_backward(
                q, k, v, o, lse, do.contiguous(), causal=causal,
                window=window)
        else:
            dq, dk, dv = flash_attention_backward_plain(
                q, k, v, o, lse, do, causal=causal, window=window, bq=bq,
                bkv=bkv)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, bq: int = fa.BQ,
                    bkv: int = fa.BKV) -> torch.Tensor:
    """Attention of flattened heads, q (BH, Sq, hd), k / v (BH, Skv, hd),
    causal and / or within a sliding ``window`` (0: none): with
    ``use_kernels`` the flash-attention kernel (its blocks are fixed at
    64); otherwise, for a causal window over one sequence, the
    reference's ``windowed_attention`` in query chunks of ``bq``, else the
    plain online softmax over blocks of (bq, bkv).  Under autograd (or a
    dots tape) the kernel and the online softmax run as
    ``_FlashAttention``; the windowed plain branch is differentiated by
    autograd itself."""
    kernels = _cfg().use_kernels
    windowed = window and causal and q.shape[1] == k.shape[1]
    grad = _needs_grad(q, k, v)
    if (grad or getattr(_state, "tape", None) is not None) and (
            kernels or not windowed):
        if kernels and grad and q.shape[-1] not in fa.BACKWARD_HEAD_DIMS:
            raise NotImplementedError(
                f"flash_attention: the kernel's backward takes head dims "
                f"{fa.BACKWARD_HEAD_DIMS}, not {q.shape[-1]} (ROADMAP)")
        if kernels:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _FlashAttention.apply(q, k, v, causal, window, kernels, bq,
                                       bkv, _tape_saved())
        _tape_record((o.detach(), lse))
        return o
    if kernels:
        return fa.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window)
    if windowed:
        return windowed_attention(q[:, :, None, None], k[:, :, None],
                                  v[:, :, None], window=window,
                                  q_chunk=bq)[:, :, 0, 0]
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 bq=bq, bkv=bkv)


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor, meta, *,
                        site: str = "") -> torch.Tensor:
    """Two-sided block-sparse matmul with *precomputed* metadata (a
    ``core.sparsity.BlockSparseMeta`` over x's and w's block bitmaps; the
    operands block multiples): with ``use_kernels`` the block-sparse
    kernel (its plain version on CPU tensors), else the plain version
    (``ref.block_sparse_matmul_ref``).  ``meta`` None falls back to the
    descriptor-driven ``flex_matmul`` dispatch of ``site``."""
    if meta is None:
        return flex_matmul(x, w, site=site)
    if _cfg().use_kernels:
        return bs.block_sparse_matmul(x, w, meta)
    return block_sparse_matmul_ref(x, w, meta).to(x.dtype)


def head_matmul(x: torch.Tensor, head, *,
                site: str = "lm_head") -> torch.Tensor:
    """x (..., D) @ head (V, D)ᵀ → (..., V): the logits contraction routed
    through the same per-site dispatch.  A raw head is passed as its
    transposed view (the kernels read it in place); a ``PlannedWeight`` was
    compiled on that view, and a ``QuantizedLinear`` is stored (D, V)."""
    if isinstance(head, (PlannedWeight, QuantizedLinear)):
        return flex_matmul(x, head, site=site)
    return flex_matmul(x, head.t(), site=site)
