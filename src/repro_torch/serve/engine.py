"""Batched serving engine: slot-based continuous batching over the fused
decode block (the JAX package's ``serve/engine.py``).

A fixed decode batch of ``n_slots`` sequences; finished sequences free
their slot and queued requests are prefilled into it
(``models.model.prefill_into_slot``), whole or — with ``prefill_chunk`` —
in chunks interleaved one per tick with decode blocks, round-robin over the
slots mid-prefill.  ``run_until_drained`` / ``decode_block_step`` drive
fused blocks (``models.model.decode_many``): per-row budgets, EOS and the
NaN quarantine stop each row on the device, and greedy or sampled tokens
(``SamplingParams``, position-keyed) are picked there.  ``step()`` is the
per-token oracle — the fused block is computation-identical to T steps.

**Entry points** (``serve.executables``): every model call the engine
makes — the oracle step, a fused block of T steps, a prompt feed of P
positions, a verify block — goes through an ``Executable`` per (entry
point, static shape), the counterpart of the reference's jitted
executables.  On CUDA each is captured as a CUDA graph at ``warmup`` or at
its first use and replayed after that; a capture failure raises.  The
decode state is written in place (``donate_state``); prompt-feed segments
are padded to powers of two, as the reference pads them.  On the CPU the
entry points run eagerly.

**Async dispatch** (``async_dispatch``, the default): block k+1 launches
from block k's device (token, pos, rem) carries before block k's token
block reaches the host, so block k's host accounting overlaps block k+1's
device work.  The carries are valid only while the live set is unchanged,
keyed by (slot, uid) pairs.  Every launch and every state write (admission,
the zero-reset on re-admission, ``faults.poison_slot_state``) is queued in
order on the current CUDA stream; a block's token block is copied
``non_blocking`` into pinned memory behind it, and ``_account_one`` waits
on the event recorded after that copy.  On the CPU every call completes
before it returns, so the engine syncs plainly.

**Admission** is policy (``AdmissionPolicy``): which queued request a freed
slot takes, the prefill chunk, and which request a full bounded queue
(``max_queue``) sheds.  Policies reorder scheduling only; streams are
schedule-invariant.

**Lifecycle**: a request ends in exactly one of ``TERMINAL_STATES`` —
``cancel``, deadlines on the engine ``clock``, the ``nan_guard``
quarantine (the -2 sentinel) and shedding end it early; ``status``,
``results`` and ``health`` report it.

**Plan tiers** (``plan_tiers``): the plan compiled again at each pruning
ratio (``core.sparsity.compile_weight_plan(prune_ratio=...)``), every tier
attached to the same weights.  A block decodes under the tier of the least
relaxed ``Request.latency_class`` among its live rows; under deadline
pressure (``deadline_demotion``) a request that cannot finish in time at
the measured service rate moves one class down.  **Self-speculative
decoding** (``speculate_k``): a block drafts k tokens on the last (most
pruned) tier, scores the k + 1 positions under its own tier in one verify
window (``models.model.verify_block``) and keeps the prefix that tier
confirms, so the streams are those of plain decoding under that tier.
Speculation runs only where a window is bit-equal to k + 1 steps: plain
dense full-cache stacks with weight-only (not two-sided) sparsity.

A MoE config (``deepseek-moe-16b``) is served like a dense one — fused
blocks, async dispatch, chunked prefill, sampling and admission policies —
except for speculation, which it gates off as the reference does: its
expert capacity is competed for by every row of a step, so the fused block
and ``step()`` feed the same rows, idle slots' filler included.

An ``ExecConfig`` (``decode_exec_config``) is installed around every model
call, so every matmul site consults its ``SiteDescriptor``: dense sites run
the schedule-flexible kernels (``use_kernels``) and ``weight`` /
``two_sided`` sites the block-sparse kernel, with the precompiled
``WeightSparsityPlan`` attached into the params at bring-up.  With
``collect_stats`` the two-sided sites count activation popcounts on the
device (``activation_densities``), and ``maybe_recalibrate`` recompiles the
table when they drift from the densities it was selected under.

``quantize`` serves int8 weights (``quant.quantize_params``): planned sites
run the scaled block-sparse kernel on the int8 payload, unplanned dense
sites the int8 matmul kernel (``use_kernels``) or, without kernels, the
weight dequantized to the activation dtype.  An SSM stack, and an
unplanned encoder-decoder, refuse it (``_check_quantizable``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.scheduler import H100, TPU_V5E
from repro_torch.core.sparsity import iter_leaves, map_leaves
from repro_torch.device import resolve_device
from repro_torch.kernels import build, ops
from repro_torch.models import model as model_lib
from repro_torch.quant.quantize import quantize_params
from repro_torch.serve.executables import Executable


def shape_exec_config(cfg: ArchConfig, shape: ShapeConfig, *,
                      model_shards: int = 1,
                      use_kernels: bool = False, params=None, hw=None,
                      quantize: bool = False, collect_stats: bool = False,
                      act_densities: Optional[Dict[str, float]] = None,
                      wt_densities: Optional[Dict[str, float]] = None,
                      device="cuda") -> ops.ExecConfig:
    """ExecConfig carrying the descriptor table for ``cfg`` at ``shape``
    (M = global_batch for a decode shape, global_batch · seq_len for a
    prefill or train shape), selected under ``hw`` — ``H100`` on CUDA and
    the reference's ``TPU_V5E`` on the CPU unless given.  ``model_shards``
    compiles it at one tensor-parallel rank's shapes (N or K divided by
    it, the K-sharded sites' FlexTree combine over that many ranks).

    With ``params`` and a sparse config, the weight densities are measured,
    the table re-selected under them, and a ``WeightSparsityPlan`` compiled
    once at the final block granularity.  ``act_densities`` (measured
    activation densities, ``ServeEngine.activation_densities``) and
    ``wt_densities`` (already-measured weight densities, e.g. a plan's
    ``wt_densities()``) replace the selector's priors; ``collect_stats``
    makes an engine count activation popcounts.

    ``quantize`` costs the table at int8 weight width and quantizes
    ``params`` before measuring and planning (quantization rounds tiny
    weights to 0, so the plan comes from the quantized tree — the one the
    engine, quantizing the same params deterministically, serves)."""
    from repro_torch.core.descriptors import (compile_network_schedule,
                                              sparsity_mode_for)
    from repro_torch.core.sparsity import (compile_weight_plan,
                                           measure_weight_densities)
    dev = resolve_device(device)
    if hw is None:
        hw = H100 if dev.type == "cuda" else TPU_V5E
    ns = compile_network_schedule(cfg, shape, model_shards=model_shards,
                                  hw=hw, quantize=quantize,
                                  act_densities=act_densities,
                                  wt_densities=wt_densities)
    if quantize and params is not None:
        params, _ = quantize_params(params,
                                    tie_embeddings=cfg.tie_embeddings)
    plan = None
    if params is not None and sparsity_mode_for(cfg) != "dense":
        measured = measure_weight_densities(params, ns)
        if measured:
            ns = compile_network_schedule(cfg, shape,
                                          model_shards=model_shards, hw=hw,
                                          wt_densities=measured,
                                          act_densities=act_densities,
                                          quantize=quantize)
            plan = compile_weight_plan(
                params, ns, ref_elem_bytes=2 if quantize else None)
    return ops.ExecConfig(use_kernels=use_kernels, schedules=ns, plan=plan,
                          quantize=quantize, collect_stats=collect_stats,
                          act_densities=(dict(act_densities)
                                         if act_densities else None),
                          arch_cfg=cfg, model_shards=model_shards)


def decode_exec_config(cfg: ArchConfig, n_slots: int, **kw) -> ops.ExecConfig:
    """``shape_exec_config`` at the serving decode shape (one new token for
    each of ``n_slots`` slots: M = n_slots); keywords as there."""
    shape = ShapeConfig(name="serve_decode", kind="decode", seq_len=1,
                        global_batch=n_slots)
    return shape_exec_config(cfg, shape, **kw)


def _check_quantizable(cfg: ArchConfig, quantize: bool, plan) -> None:
    """int8 serving where the reference cannot serve it raises here, not
    with an answer the reference cannot give.  Its ``quantize_params``
    turns the SSM's ``in_proj`` / ``out_proj`` and the encoder-decoder's
    cross-attention ``wq`` / ``wo`` into ``QuantizedLinear`` leaves, which
    its bare ``@`` products cannot take (``TypeError``; ROADMAP queue C).
    A plan wraps the cross-attention leaves in ``PlannedWeight``s, whose
    dense route takes them, so a planned encoder-decoder serves int8;
    nothing plans the SSM's projections."""
    if not quantize:
        return
    if cfg.ssm.enabled or (cfg.encoder_decoder and plan is None):
        what = ("the SSD block's in_proj / out_proj" if cfg.ssm.enabled
                else "the unplanned cross-attention's wq / wo")
        raise NotImplementedError(
            f"{cfg.name}: int8 serving is not available: the reference "
            f"multiplies {what} with a bare '@', which a QuantizedLinear "
            f"leaf does not take (TypeError in the reference)")


def activation_density_drift(baseline: Optional[Dict[str, float]],
                             measured: Dict[str, float], *,
                             prior: float = 0.5) -> float:
    """Max |measured − selected-under| activation density over sites;
    sites absent from ``baseline`` were selected under ``prior``."""
    drift = 0.0
    for site, m in (measured or {}).items():
        drift = max(drift, abs(m - (baseline or {}).get(site, prior)))
    return drift


def _next_pow2(n: int) -> int:
    """The least power of two >= n (1 for n <= 1): a prompt-feed segment's
    padded length."""
    return 1 << max(n - 1, 0).bit_length()


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling: ``temperature`` 0 (the default) is greedy
    argmax; above 0 the request samples from the temperature-scaled
    distribution, truncated to the ``top_k`` highest logits when
    ``top_k > 0``.  Row r at position p draws from
    ``fold_in(PRNGKey(seed), p)``, so a sampled stream is reproducible
    from ``seed`` and invariant to how decode steps are blocked."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


# Terminal ``Request.status`` values; a request ends in exactly one:
#   done            — EOS / budget / sequence-wall completion
#   cancelled       — ServeEngine.cancel(uid)
#   deadline_missed — submit(deadline=...) expired before completion
#   failed          — on-device NaN/Inf quarantine (-2 sentinel)
#   shed            — bounded-queue overload eviction / rejection
TERMINAL_STATES = ("done", "cancelled", "deadline_missed", "failed", "shed")


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int = 16
    sampling: Optional[SamplingParams] = None   # None = greedy
    # plan-tier class: 0 = the full plan, c > 0 decodes under tier
    # min(c, n_tiers - 1) (more pruned, cheaper, less exact)
    latency_class: int = 0
    # PriorityAdmission ordering class (lower = sooner); schedule-only
    priority: int = 0
    # absolute deadline on the engine clock (None = none)
    deadline: Optional[float] = None
    out: List[int] = field(default_factory=list)
    done: bool = False            # True for every terminal status
    # queued -> prefill -> decode -> one of TERMINAL_STATES
    status: str = "queued"
    # deadline-pressure demotions applied (latency_class increments)
    demotions: int = 0


@dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                  # next position to write
    prefill_cursor: int = 0       # prompt-feed tokens already prefilled


@dataclass
class _InflightBlock:
    """A dispatched block whose tokens the host has not read: ``key`` is
    the (slot, uid) live set it was launched for, ``host`` its (T, n_slots)
    token block (pinned host memory on CUDA, filled by a copy queued
    behind the block) and ``ready`` the event recorded after that copy
    (None on the CPU).  ``spec_k`` > 0 marks a verify block that drafted
    ``spec_k`` tokens (read for the acceptance counts only)."""
    key: tuple
    live: List[int]
    t_block: int
    host: torch.Tensor
    ready: Optional[torch.cuda.Event]
    spec_k: int = 0


class AdmissionPolicy:
    """Pluggable admission: queue ordering, prefill chunk sizing and the
    overload valve.  ``pick`` returns the index of the queued request the
    next freed slot takes (FIFO here); ``chunk`` the prefill chunk of the
    next feed (None = whole prompt); ``chunk_cap`` the largest chunk
    ``chunk`` may return (None = unbounded: ``warmup`` then prepares feeds
    up to ``max_seq``); ``shed`` — asked only when a bounded queue is
    full at submit — the index of a queued request to evict for
    ``incoming``, or None to reject ``incoming`` (the base policy).
    Policies read the engine and never change what a stream is."""

    def pick(self, queue: Deque[Request], engine: "ServeEngine") -> int:
        return 0

    def chunk(self, engine: "ServeEngine") -> Optional[int]:
        return engine.prefill_chunk

    def chunk_cap(self, engine: "ServeEngine") -> Optional[int]:
        return engine.prefill_chunk

    def shed(self, queue: Deque[Request], engine: "ServeEngine",
             incoming: Request) -> Optional[int]:
        return None


def _lowest_priority_victim(queue: Deque[Request],
                            incoming: Request) -> Optional[int]:
    """Evict the least important queued request (highest ``priority``
    number, newest within a class) when ``incoming`` strictly outranks
    it; otherwise reject ``incoming``."""
    if not queue:
        return None
    worst = max(range(len(queue)), key=lambda i: (queue[i].priority, i))
    return worst if incoming.priority < queue[worst].priority else None


class ShedLowestPriority(AdmissionPolicy):
    """FIFO admission; under overload an incoming request evicts the least
    important queued one if it strictly outranks it."""

    def shed(self, queue: Deque[Request], engine: "ServeEngine",
             incoming: Request) -> Optional[int]:
        return _lowest_priority_victim(queue, incoming)


class FIFOAdmission(AdmissionPolicy):
    """The explicit baseline: queue order, the constructor's chunk."""


@dataclass(frozen=True)
class AdaptiveAdmission(AdmissionPolicy):
    """Occupancy-adaptive chunking and shortest-prompt-first under burst.

    The chunk scales geometrically from ``max_chunk`` (no live decode) to
    ``min_chunk`` (every slot decoding), always a power of two; while the
    queue holds more than ``burst_depth`` requests a freed slot takes the
    shortest prompt."""
    min_chunk: int = 32
    max_chunk: int = 256
    burst_depth: int = 4

    def __post_init__(self):
        for name in ("min_chunk", "max_chunk"):
            v = getattr(self, name)
            if v < 1 or (v & (v - 1)) != 0:
                raise ValueError(f"{name} must be a power of two >= 1, "
                                 f"got {v}")
        if self.min_chunk > self.max_chunk:
            raise ValueError(
                f"min_chunk={self.min_chunk} > max_chunk={self.max_chunk}")

    def pick(self, queue: Deque[Request], engine: "ServeEngine") -> int:
        if len(queue) > self.burst_depth:
            return min(range(len(queue)),
                       key=lambda i: len(queue[i].prompt))
        return 0

    def chunk(self, engine: "ServeEngine") -> Optional[int]:
        occ = len(engine._live()) / max(engine.n_slots, 1)
        span = (self.max_chunk // self.min_chunk).bit_length() - 1
        return max(self.min_chunk, self.max_chunk >> round(occ * span))

    def chunk_cap(self, engine: "ServeEngine") -> Optional[int]:
        return self.max_chunk


@dataclass(frozen=True)
class PriorityAdmission(AdmissionPolicy):
    """Strict priority classes: a freed slot takes the oldest request of
    the numerically lowest ``priority``; sheds like
    ``ShedLowestPriority``."""

    def pick(self, queue: Deque[Request], engine: "ServeEngine") -> int:
        return min(range(len(queue)),
                   key=lambda i: (queue[i].priority, i))

    def shed(self, queue: Deque[Request], engine: "ServeEngine",
             incoming: Request) -> Optional[int]:
        return _lowest_priority_victim(queue, incoming)


@contextlib.contextmanager
def _model_scope(exec_cfg, stats, dead: bool = False):
    """``no_grad``, the exec config and the stats collector around a model
    call.  ``dead`` marks a warm run (every row dead): the popcounts are
    put back after it, so a capture leaves the measured densities as they
    were."""
    snap = stats.snapshot() if dead and stats is not None else None
    with contextlib.ExitStack() as scopes:
        scopes.enter_context(torch.no_grad())
        if exec_cfg is not None:
            scopes.enter_context(ops.exec_config(exec_cfg))
        if stats is not None:
            scopes.enter_context(ops.sparsity_stats(stats))
        yield
    if snap is not None:
        stats.restore(snap)


def _dead_rows(n_slots: int, device, sampled: bool) -> tuple:
    """(tokens, pos, live, rem[, temp, top_k, seeds]) with every row dead:
    the inputs of a block that leaves the state as it was."""
    z = torch.zeros((n_slots,), dtype=torch.int64, device=device)
    args = (z, z, torch.zeros_like(z, dtype=torch.bool),
            torch.zeros_like(z, dtype=torch.int32))
    if sampled:
        args += (torch.zeros_like(z, dtype=torch.float32), z, z)
    return args


def _dead_feed(n_slots: int, device, p_len: int) -> tuple:
    """A prompt feed's inputs (tokens, valid, slot, slot_pos, start,
    reset) of ``p_len`` padding positions and no reset."""
    z = torch.zeros((), dtype=torch.int64, device=device)
    return (torch.zeros((p_len,), dtype=torch.int32, device=device),
            torch.zeros((p_len,), dtype=torch.bool, device=device),
            z, torch.zeros((n_slots,), dtype=torch.int64, device=device),
            z, torch.zeros((), dtype=torch.bool, device=device))


def _check_in_place(state, buffers) -> None:
    if state is not buffers:
        raise RuntimeError("a model entry point returned a new state tree; "
                           "the engine's entry points write the state in "
                           "place")


class ServeEngine:
    """Continuous-batching engine over the fused decode block.

    ``fused`` selects the block loop in ``run_until_drained`` (False = the
    per-token ``step()`` oracle loop); ``decode_block`` caps the block
    length T (and a prompt feed's graph, ``warmup``); ``donate_state``
    (default True) lets the entry points write ``state`` in place — False
    hands back a copy after every call, so a state tree the caller holds
    is never written (``_run``); ``prefill_chunk`` feeds prompts in chunks
    (None = whole);
    ``async_dispatch`` double-buffers blocks (module docstring);
    ``admission`` plugs the policy (default ``FIFOAdmission``);
    ``max_queue`` bounds the queue; ``clock`` is the engine clock of
    deadlines (default ``time.monotonic``); ``nan_guard`` quarantines rows
    whose logits go non-finite.  ``params`` must already live on
    ``device``.

    ``quantize`` (implied by an exec config built with ``quantize=True``)
    serves the params int8-quantized: ``_serve_params`` holds the quantized
    tree, ``quant_stats`` its byte counts, and the plan attaches onto it
    (``verify_plan=False`` skips the plan's coverage re-check).  ``params``
    keeps the original tree.

    ``plan_tiers`` (non-decreasing pruning ratios from 0.0; needs a
    planned ``exec_cfg``) compiles the plan tiers, ``speculate_k`` > 0
    drafts that many tokens per verify block on the last tier (with one
    tier, on the full plan itself: every draft is then accepted), and
    ``deadline_demotion`` with ``demote_margin`` demotes a request whose
    remaining tokens × seconds per token × margin exceed its time left
    (module docstring)."""

    def __init__(self, cfg: ArchConfig, params, *, n_slots: int = 4,
                 max_seq: int = 256, dtype=torch.float32,
                 exec_cfg: Optional[ops.ExecConfig] = None,
                 verify_plan: bool = True, fused: bool = True,
                 decode_block: int = 16, donate_state: bool = True,
                 eos_id: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 async_dispatch: bool = True,
                 admission: Optional[AdmissionPolicy] = None,
                 quantize: bool = False,
                 plan_tiers: Optional[Sequence[float]] = None,
                 speculate_k: int = 0,
                 max_queue: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 nan_guard: bool = True, deadline_demotion: bool = True,
                 demote_margin: float = 1.0, device="cuda"):
        self.device = resolve_device(device)
        leaf = params["embed"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, engine on "
                             f"{self.device}")
        self.cfg, self.params = cfg, params
        self.n_slots, self.max_seq = n_slots, max_seq
        self.exec_cfg = exec_cfg
        self.fused = fused
        self.decode_block = decode_block
        self.donate_state = bool(donate_state)
        self.eos_id = eos_id
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        self._prefill_rr = 0          # round-robin over mid-prefill slots
        self.async_dispatch = async_dispatch
        if admission is not None and not isinstance(admission,
                                                    AdmissionPolicy):
            raise TypeError(f"admission must be an AdmissionPolicy, got "
                            f"{type(admission).__name__}")
        self.admission = admission if admission is not None \
            else FIFOAdmission()
        # dispatched-but-unread blocks (oldest first; depth <= 2) and the
        # device (token, pos, rem) carries keyed by their (slot, uid) set
        self._inflight: List[_InflightBlock] = []
        self._carry: Optional[tuple] = None
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self._clock = clock if clock is not None else time.monotonic
        self.nan_guard = bool(nan_guard)
        self.deadline_demotion = bool(deadline_demotion)
        self.demote_margin = float(demote_margin)
        # lifetime counters per terminal state and of demotions, and
        # bounded uid -> status / tokens maps
        self.counters = {s: 0 for s in TERMINAL_STATES}
        self.counters["demotions"] = 0
        self._terminal: "collections.OrderedDict[int, str]" = \
            collections.OrderedDict()
        self._outputs: "collections.OrderedDict[int, List[int]]" = \
            collections.OrderedDict()
        # EMA of clock seconds per credited token (None until two blocks)
        self._tok_ema: Optional[float] = None
        self._last_account: Optional[float] = None
        self.state = model_lib.init_decode_state(cfg, n_slots, max_seq,
                                                 dtype=dtype,
                                                 device=self.device)
        # the buffers every entry point writes in place (``_run``); an
        # undonating engine hands out copies of them only
        self._state_buffers = self.state
        if not self.donate_state:
            self.state = map_leaves(lambda _, t: t.clone(), self.state)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: Deque[Request] = collections.deque()
        self._uid = 0
        self._mask_cache: Dict[tuple, torch.Tensor] = {}
        self.quantize = bool(quantize) or bool(getattr(exec_cfg, "quantize",
                                                       False))
        _check_quantizable(cfg, self.quantize, getattr(exec_cfg, "plan",
                                                       None))
        if self.quantize:
            self._serve_params, self.quant_stats = quantize_params(
                params, tie_embeddings=cfg.tie_embeddings)
        else:
            self._serve_params, self.quant_stats = params, None
        self.plan = getattr(exec_cfg, "plan", None)
        self._exec_params = (self.plan.attach(self._serve_params,
                                              verify=verify_plan)
                             if self.plan is not None
                             else self._serve_params)
        if speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        self.speculate_k = int(speculate_k)
        self.tier_ratios = (tuple(float(r) for r in plan_tiers)
                            if plan_tiers is not None else (0.0,))
        if plan_tiers is not None:
            if self.plan is None or exec_cfg is None:
                raise ValueError(
                    "plan_tiers requires a planned engine (exec_cfg built "
                    "by decode_exec_config with params)")
            if not self.tier_ratios or self.tier_ratios[0] != 0.0:
                raise ValueError(
                    f"plan_tiers must start at ratio 0.0 (the full-quality "
                    f"tier every class-0 request decodes under), got "
                    f"{self.tier_ratios}")
            if any(b < a for a, b in zip(self.tier_ratios,
                                         self.tier_ratios[1:])):
                raise ValueError(
                    f"plan_tiers ratios must be non-decreasing, got "
                    f"{self.tier_ratios}")
        self._compile_tiers(verify=verify_plan)
        # lifetime draft / accept counts, and (drafted, accepted) per slot
        self.spec_stats = {"drafted": 0, "accepted": 0, "emitted": 0,
                           "verify_blocks": 0}
        self.spec_slot_stats = np.zeros((n_slots, 2), np.int64)
        # a verify window is bit-equal to k + 1 decode steps only for plain
        # dense full-cache stacks (MoE capacity couples the window's rows,
        # recurrent state and sliding windows need a scan); two-sided sites
        # are left out as the reference leaves them out (their activation
        # bitmaps see the window's rows, not a step's).  Elsewhere
        # ``speculate_k`` is a no-op.
        self._spec_windowed = not (cfg.moe.enabled or cfg.ssm.enabled
                                   or cfg.rglru.enabled
                                   or cfg.encoder_decoder or cfg.window
                                   or cfg.sparsity.activation_threshold > 0)
        self._stats = (ops.SparsityStatsCollector()
                       if exec_cfg is not None and exec_cfg.collect_stats
                       else None)
        self.last_logits: Optional[torch.Tensor] = None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._build_executables()

    def _compile_tiers(self, *, verify: bool = False) -> None:
        """(Re)compile the pruned tiers of ``tier_ratios`` over the served
        params and attach each onto them (no weight is copied).  Tier 0 is
        ``self.plan`` / ``self._exec_params`` as they are (ratio 0 compiles
        to the same plan)."""
        if len(self.tier_ratios) <= 1 or self.plan is None:
            self.plan_tiers = [self.plan] if self.plan is not None else []
            self._tier_params = [self._exec_params]
            return
        from repro_torch.core.sparsity import compile_weight_plan
        tiers, tier_params = [self.plan], [self._exec_params]
        for r in self.tier_ratios[1:]:
            p = compile_weight_plan(self._serve_params,
                                    self.exec_cfg.schedules,
                                    ref_elem_bytes=2 if self.quantize
                                    else None, prune_ratio=r)
            tiers.append(p)
            tier_params.append(p.attach(self._serve_params, verify=verify))
        self.plan_tiers = tiers
        self._tier_params = tier_params

    def _scope(self):
        """The exec config and stats collector around a model call."""
        return _model_scope(self.exec_cfg, self._stats)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, in its own shape (a 0-d
        array stays 0-d: an entry point's inputs have static shapes); on
        CUDA through pinned memory, queued on the stream without waiting
        for it."""
        t = torch.from_numpy(np.ascontiguousarray(a).reshape(np.shape(a)))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ---- the entry points (``serve.executables``) ----
    def _build_executables(self) -> None:
        """(Re)start the registry of entry points, one ``Executable`` per
        (entry point, static shape), each built at its first use.  Called
        at bring-up and after ``maybe_recalibrate`` swaps the table: a
        captured graph bakes in the descriptor table and the plan tiers'
        lists it was captured under, so every graph is dropped with them,
        with a new graph pool; the live masks and device carries of the old
        executables go too (callers flush in-flight blocks first)."""
        self._executables: Dict[tuple, Executable] = {}
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self._mask_cache.clear()
        self._carry = None

    def _entry(self, key: tuple, fn, warm) -> Executable:
        ex = self._executables.get(key)
        if ex is None:
            ex = self._executables[key] = Executable(
                key[0], key[1:], fn, warm, self.device, pool=self._pool,
                stream=self._stream)
        return ex

    def _dead_rows(self, sampled: bool) -> tuple:
        return _dead_rows(self.n_slots, self.device, sampled)

    def _dead_feed(self, p_len: int) -> tuple:
        return _dead_feed(self.n_slots, self.device, p_len)

    # The entry points' functions close over what they read (params, the
    # state buffers, the exec config), never over the engine: an engine
    # is freed when its last reference goes, graphs and all.
    def _step_exec(self, tier: int, sampled: bool) -> Executable:
        """The oracle step under ``tier``: (tokens (B, 1), pos, live[,
        temp, top_k, seeds]) → (logits (B, V), next tokens, finite rows or
        None)."""
        p, cfg, st = self._tier_params[tier], self.cfg, self._state_buffers
        nan_guard, n, dev = self.nan_guard, self.n_slots, self.device
        ec, stats = self.exec_cfg, self._stats

        def fn(toks, pos, live, temp=None, top_k=None, seeds=None):
            with _model_scope(ec, stats):
                logits, state = model_lib.masked_decode_step(
                    p, cfg, toks, st, pos, live)
                lg = logits[:, 0, :]
                if temp is None:
                    nxt = torch.argmax(lg, dim=-1)
                else:
                    nxt = model_lib.sample_tokens(lg, temp, top_k, seeds,
                                                  pos)
                finite = (torch.isfinite(lg).all(dim=-1) if nan_guard
                          else None)
            _check_in_place(state, st)
            return lg, nxt, finite

        def warm():
            toks, pos, live, _, *samp = _dead_rows(n, dev, sampled)
            with _model_scope(ec, stats, dead=True):
                fn(toks[:, None], pos, live, *samp)
        return self._entry(("step", tier, sampled), fn, warm)

    def _block_exec(self, tier: int, t_block: int, sampled: bool,
                    spec_k: int = 0) -> Executable:
        """A fused block under ``tier``: ``t_block`` decode steps
        (``decode_many``), or with ``spec_k`` a verify block drafting
        ``spec_k`` tokens on the last tier (``verify_block``, windowed).
        (tokens, pos, live, rem[, temp, top_k, seeds]) → (token block,
        token, position and budget carries)."""
        p, draft = self._tier_params[tier], self._tier_params[-1]
        cfg, st, n, dev = self.cfg, self._state_buffers, self.n_slots, \
            self.device
        ec, stats = self.exec_cfg, self._stats
        common = dict(eos_id=self.eos_id, nan_guard=self.nan_guard)

        def run(n_steps, toks, pos, live, rem, temp=None, top_k=None,
                seeds=None):
            with _model_scope(ec, stats):
                if spec_k:
                    block, state, tok, ps, rm = model_lib.verify_block(
                        p, draft, cfg, toks, st, pos, live, spec_k,
                        rem=rem, temp=temp, top_k=top_k, seeds=seeds,
                        windowed=True, **common)
                else:
                    block, state, tok, ps, rm = model_lib.decode_many(
                        p, cfg, toks, st, pos, live, n_steps, rem=rem,
                        temp=temp, top_k=top_k, seeds=seeds, **common)
            _check_in_place(state, st)
            return block, tok, ps, rm

        def warm():       # one step reaches every site T steps reach
            with _model_scope(ec, stats, dead=True):
                run(1, *_dead_rows(n, dev, sampled))
        key = (("verify", tier, spec_k, True, sampled) if spec_k
               else ("decode_many", tier, t_block, sampled))
        return self._entry(key, lambda *a: run(t_block, *a), warm)

    def _feed_exec(self, p_len: int) -> Executable:
        """The prompt feed of ``p_len`` positions (``prefill_into_slot``
        under the full plan): (tokens, valid, slot, slot_pos, start,
        reset) → ()."""
        p, cfg, st, n, dev = (self._exec_params, self.cfg,
                              self._state_buffers, self.n_slots, self.device)
        ec, stats = self.exec_cfg, self._stats

        def fn(toks, valid, slot, slot_pos, start, reset):
            with _model_scope(ec, stats):
                state = model_lib.prefill_into_slot(
                    p, cfg, toks, valid, slot, st, slot_pos, start, reset)
            _check_in_place(state, st)
            return ()

        def warm():
            with _model_scope(ec, stats, dead=True):
                fn(*_dead_feed(n, dev, 1))
        return self._entry(("feed", p_len), fn, warm)

    def _run(self, ex: Executable, *args) -> tuple:
        """Call an entry point on the engine's state buffers.  A
        ``self.state`` that is another tree (a copy the caller installed,
        or the copy ``donate_state=False`` handed out) is copied into them
        first; with ``donate_state`` the buffers are ``self.state`` and are
        written in place, without it ``self.state`` becomes a copy of them,
        so a tree the caller holds is never written (the reference's
        undonated calls)."""
        if self.state is not self._state_buffers:
            for (_, dst), (_, src) in zip(iter_leaves(self._state_buffers),
                                          iter_leaves(self.state)):
                dst.copy_(src)
        out = ex(*args)
        self.state = (self._state_buffers if self.donate_state
                      else map_leaves(lambda _, t: t.clone(),
                                      self._state_buffers))
        return out

    def _feed_cap(self) -> int:
        """The longest prompt-feed graph: the largest power of two within
        ``decode_block``."""
        return 1 << (max(self.decode_block, 1).bit_length() - 1)

    def warmup(self) -> None:
        """Prepare every entry point the serving loop can dispatch, with
        every row dead so that the decode state is left bit for bit as it
        was: each power-of-two block length up to ``decode_block`` under
        every tier, the greedy verify block of every tier a block can
        verify under (with speculation), the oracle step and each
        power-of-two prompt feed up to ``_next_pow2`` of the policy's
        ``chunk_cap`` (``max_seq`` for whole prompts), but no longer than
        ``decode_block`` positions.  On CUDA this builds every kernel
        (``build.build_all``) and captures each entry point as a CUDA graph
        (sampled variants are captured at their first dispatch); on the
        CPU it runs each once.  A graph holds every launch of every step
        it runs (a StableLM-1.6B step is ~5.7k kernels), so a feed graph
        of thousands of positions could not be instantiated: a longer
        segment is fed as consecutive replays of the longest feed plus one
        power-of-two remainder (``_feed_prefill``), which leaves the same
        state bit for bit.  Flushes any in-flight block first."""
        self.flush()
        if self.device.type == "cuda":
            build.build_all()
        dead = self._dead_rows(False)
        for tier in range(len(self._tier_params)):
            t = 1
            while t <= self.decode_block:
                self._run(self._block_exec(tier, t, False), *dead)
                t *= 2
        if self.speculate_k and self._spec_windowed:
            for tier in range(max(len(self._tier_params) - 1, 1)):
                self._run(self._block_exec(tier, self.speculate_k + 1, False,
                                           self.speculate_k), *dead)
        toks, pos, live, _ = dead
        self._run(self._step_exec(0, False), toks[:, None], pos, live)
        cap = min(_next_pow2(self.admission.chunk_cap(self) or self.max_seq),
                  self._feed_cap())
        p_len = 1
        while p_len <= cap:
            self._run(self._feed_exec(p_len), *self._dead_feed(p_len))
            p_len *= 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- density feedback ----
    def activation_densities(self) -> Dict[str, float]:
        """Measured per-site activation densities from the device popcount
        counters (needs ``ExecConfig.collect_stats``); live rows only."""
        if self._stats is None:
            return {}
        return self._stats.densities()

    def maybe_recalibrate(self, drift_threshold: float = 0.15, *,
                          recompile: bool = True
                          ) -> Optional[Dict[str, float]]:
        """When the measured activation densities drift more than
        ``drift_threshold`` from those the table was selected under,
        recompile the table (``decode_exec_config(act_densities=...)``) and
        swap it in; state and requests carry over.  The plan (and every
        plan tier) is reused when every planned site keeps its blocks, else
        rebuilt.  Each probe with measurements consumes the popcount
        window.  Returns the measured
        densities when the threshold tripped, else None;
        ``recompile=False`` answers only the trigger question."""
        if self.exec_cfg is None or self._stats is None:
            return None
        self.flush()
        measured = self.activation_densities()
        if not measured:
            return None
        if recompile and self.exec_cfg.arch_cfg is None:
            raise ValueError(
                "maybe_recalibrate(recompile=True) needs an ExecConfig "
                "built by decode_exec_config (arch_cfg is unset on this "
                "hand-built config) — pass recompile=False to only probe "
                "the trigger, or rebuild the config via decode_exec_config")
        self._stats.reset()
        drift = activation_density_drift(self.exec_cfg.act_densities,
                                         measured)
        if drift <= drift_threshold:
            return None
        if recompile:
            old = self.exec_cfg
            common = dict(use_kernels=old.use_kernels,
                          collect_stats=old.collect_stats,
                          act_densities=measured, quantize=old.quantize,
                          model_shards=old.model_shards, device=self.device)
            new_ec = decode_exec_config(
                old.arch_cfg, self.n_slots,
                wt_densities=(self.plan.wt_densities()
                              if self.plan is not None and self.plan.entries
                              else None), **common)
            plan_sites = ({e.site for e in self.plan.entries.values()}
                          if self.plan is not None else set())

            def blocks(ec, s):
                d = ec.schedules.sites.get(s)
                return None if d is None else (d.schedule.bm, d.schedule.bn,
                                               d.schedule.bk)
            if self.plan is None or all(
                    blocks(new_ec, s) is not None
                    and blocks(new_ec, s) == blocks(old, s)
                    for s in plan_sites):
                self.exec_cfg = dataclasses.replace(new_ec, plan=self.plan)
            else:
                self.exec_cfg = decode_exec_config(
                    old.arch_cfg, self.n_slots, params=self.params, **common)
                self.plan = self.exec_cfg.plan
                self._exec_params = (
                    self.plan.attach(self._serve_params, verify=False)
                    if self.plan is not None else self._serve_params)
                # new blocks invalidate every tier's lists: rebuild them all
                self._compile_tiers()
            # nothing captured under the old table survives (flushed above)
            self._build_executables()
        return measured

    # ---- request management ----
    def _finish(self, req: Request, status: str = "done") -> None:
        """Move a request to a terminal status — the only place a request
        ends; the first terminal status wins."""
        if req.done:
            return
        req.status = status
        req.done = True
        self.counters[status] += 1
        self._terminal[req.uid] = status
        self._outputs[req.uid] = req.out
        while len(self._terminal) > 4096:
            self._terminal.popitem(last=False)
        while len(self._outputs) > 4096:
            self._outputs.popitem(last=False)

    def submit(self, prompt: np.ndarray, max_new: int = 16,
               sampling: Optional[SamplingParams] = None, *,
               latency_class: int = 0, priority: int = 0,
               deadline: Optional[float] = None) -> int:
        """Queue a request; returns its uid.

        ``priority`` is the ``PriorityAdmission`` class; ``deadline`` a
        completion budget in engine-clock seconds from now, after which
        the request ends ``deadline_missed`` wherever it is.  With a full
        bounded queue the policy's ``shed`` picks a queued victim or
        rejects this request; either loser ends ``shed`` (a rejected
        request still gets its uid).  Empty or non-1-D prompts, prompts
        needing more than ``max_seq`` positions, a negative
        ``latency_class`` and a non-positive ``deadline`` are refused."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(
                f"prompt must be a non-empty 1-D token array, got shape "
                f"{prompt.shape}")
        if len(prompt) + 1 > self.max_seq:
            raise ValueError(
                f"prompt of {len(prompt)} tokens needs {len(prompt) + 1} "
                f"cache positions (prompt + first generated token) but "
                f"max_seq={self.max_seq}")
        if latency_class < 0:
            raise ValueError(
                f"latency_class must be >= 0, got {latency_class}")
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be > 0 seconds, got {deadline}")
        self._uid += 1
        req = Request(self._uid, prompt, max_new=max_new, sampling=sampling,
                      latency_class=int(latency_class),
                      priority=int(priority),
                      deadline=(self._clock() + deadline
                                if deadline is not None else None))
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            victim = self.admission.shed(self.queue, self, req)
            if victim is None:
                self._finish(req, "shed")
                return req.uid
            if not 0 <= victim < len(self.queue):
                raise ValueError(
                    f"shed() returned index {victim} for a queue of "
                    f"{len(self.queue)}")
            evicted = self.queue[victim]
            del self.queue[victim]
            self._finish(evicted, "shed")
        self.queue.append(req)
        return self._uid

    def cancel(self, uid: int) -> bool:
        """Cancel a queued, mid-prefill or mid-decode request: True when it
        was live and is now ``cancelled``.  Ending it drops it from the
        live set, which invalidates the carry key, and an in-flight block
        read later never credits a terminal request."""
        for idx, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[idx]
                self._finish(r, "cancelled")
                return True
        for s in self.slots:
            if s.req is not None and s.req.uid == uid and not s.req.done:
                self._finish(s.req, "cancelled")
                return True
        return False

    def status(self, uid: int) -> Optional[str]:
        """``queued`` / ``prefill`` / ``decode`` while live, a terminal
        status after, None for unknown uids.  Under async dispatch an
        unread block may already have finished it: ``flush()`` first."""
        for r in self.queue:
            if r.uid == uid:
                return r.status
        for s in self.slots:
            if s.req is not None and s.req.uid == uid:
                return s.req.status
        return self._terminal.get(uid)

    def results(self) -> Dict[int, List[int]]:
        """Credited tokens of every terminal request, whatever its status
        (bounded to the most recent 4096)."""
        return dict(self._outputs)

    def _expire_deadlines(self) -> bool:
        """End every request whose deadline has passed on the engine
        clock, queued or slot-bound; True when any expired."""
        now = self._clock()
        expired = False
        survivors = []
        for r in self.queue:
            if r.deadline is not None and r.deadline <= now:
                self._finish(r, "deadline_missed")
                expired = True
            else:
                survivors.append(r)
        if expired:
            self.queue = collections.deque(survivors)
        for s in self.slots:
            r = s.req
            if (r is not None and not r.done and r.deadline is not None
                    and r.deadline <= now):
                self._finish(r, "deadline_missed")
                expired = True
        return expired

    def _maybe_demote(self) -> None:
        """Deadline-pressure demotion: a live request whose remaining
        tokens × ``_tok_ema`` (seconds per token) × ``demote_margin``
        exceed its time left moves one latency class down (to a more
        pruned tier), at most one class per tick and not past the last
        tier; ``Request.demotions`` and ``counters["demotions"]`` count it.
        Needs tiers, ``deadline_demotion`` and a service-rate estimate.
        A block runs under its least relaxed live class, so a demotion
        speeds the request's blocks only once its batchmates allow it."""
        if (not self.deadline_demotion or len(self._tier_params) <= 1
                or self._tok_ema is None):
            return
        now = self._clock()
        hi = len(self._tier_params) - 1
        for i in self._live():
            r = self.slots[i].req
            if r.deadline is None or r.latency_class >= hi:
                continue
            need = ((r.max_new - len(r.out)) * self._tok_ema
                    * self.demote_margin)
            if need > r.deadline - now:
                r.latency_class += 1
                r.demotions += 1
                self.counters["demotions"] += 1

    def health(self) -> Dict[str, object]:
        """Snapshot without a flush or a device sync: queue depth, slot
        occupancy, in-flight blocks (and how many are verify blocks), live
        requests' statuses, the lifetime counters, the speculation counters
        and the service-rate estimate."""
        requests = {r.uid: r.status for r in self.queue}
        requests.update({s.req.uid: s.req.status for s in self.slots
                         if s.req is not None})
        return {
            "queue_depth": len(self.queue),
            "max_queue": self.max_queue,
            "free_slots": len(self._free_slots()),
            "decoding": len(self._live()),
            "prefilling": len(self._prefilling()),
            "inflight_blocks": len(self._inflight),
            "inflight_speculative": sum(1 for b in self._inflight
                                        if b.spec_k),
            "requests": requests,
            "counters": dict(self.counters),
            "spec": dict(self.spec_stats),
            "tok_ema_s": self._tok_ema,
        }

    # ---- admission and prefill ----
    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s.req is None or s.req.done]

    def _slot_positions(self) -> np.ndarray:
        return np.asarray([s.pos for s in self.slots], np.int64)

    @staticmethod
    def _feed_len(req: Request) -> int:
        """``prompt[:-1]``'s length: the last prompt token is the first
        decode input (0 for a length-1 prompt: only the zero-reset)."""
        return len(req.prompt) - 1

    def _feed_prefill(self, i: int, start: int, count: int) -> None:
        """Feed ``count`` prompt-feed tokens from ``start`` into slot ``i``
        (the row zero-reset on the first segment); the other rows run as
        masked filler and keep their state.  The segment is padded to a
        power of two with masked positions, as the reference pads it (a
        length-1 prompt's empty segment runs one padding position: only the
        zero-reset); a segment longer than the longest feed (``warmup``)
        runs as consecutive feeds of that length and one padded
        remainder."""
        s = self.slots[i]
        seg = np.asarray(s.req.prompt[:-1], np.int32)[start:start + count]
        slot_pos = self._to_device(self._slot_positions())
        slot = self._to_device(np.asarray(i, np.int64))
        cap, off = self._feed_cap(), 0
        while True:
            piece = seg[off:off + cap]
            p_len = _next_pow2(len(piece))
            toks = np.zeros((p_len,), np.int32)
            toks[:len(piece)] = piece
            self._run(self._feed_exec(p_len), self._to_device(toks),
                      self._to_device(np.arange(p_len) < len(piece)), slot,
                      slot_pos, self._to_device(np.asarray(start + off,
                                                           np.int64)),
                      self._to_device(np.asarray(start + off == 0)))
            off += len(piece)
            if off >= len(seg):
                break
        s.prefill_cursor = start + len(seg)
        s.pos = s.prefill_cursor
        if not s.req.done:
            s.req.status = ("decode"
                            if s.prefill_cursor >= self._feed_len(s.req)
                            else "prefill")

    def _admit(self) -> bool:
        """Move queued requests into free slots (the policy picks which),
        feeding each its first chunk (or whole prompt) now."""
        admitted = False
        for i in self._free_slots():
            if not self.queue:
                break
            idx = self.admission.pick(self.queue, self)
            req = self.queue[idx]
            del self.queue[idx]
            self.slots[i] = _Slot(req=req, pos=0, prefill_cursor=0)
            feed_len = self._feed_len(req)
            chunk = self.admission.chunk(self)
            count = feed_len if chunk is None else min(feed_len, chunk)
            self._feed_prefill(i, 0, count)
            admitted = True
        return admitted

    def _prefilling(self) -> List[int]:
        """Slots whose prompt feed is not fully prefilled yet."""
        return [i for i, s in enumerate(self.slots)
                if s.req is not None and not s.req.done
                and s.prefill_cursor < self._feed_len(s.req)]

    def _advance_prefill(self) -> bool:
        """Feed one pending chunk, round-robin over mid-prefill slots;
        True when a chunk was fed."""
        pend = self._prefilling()
        if not pend:
            return False
        i = pend[self._prefill_rr % len(pend)]
        self._prefill_rr += 1
        s = self.slots[i]
        chunk = self.admission.chunk(self)
        count = (self._feed_len(s.req) - s.prefill_cursor
                 if chunk is None else chunk)
        self._feed_prefill(i, s.prefill_cursor, count)
        return True

    # ---- decode ----
    def _live(self) -> List[int]:
        """Decode-ready slots: occupied, not done, prompt fully fed."""
        return [i for i, s in enumerate(self.slots)
                if s.req is not None and not s.req.done
                and s.prefill_cursor >= self._feed_len(s.req)]

    def _live_mask(self, live: List[int]) -> torch.Tensor:
        """Device (n_slots,) bool mask of ``live``, cached per live set."""
        key = tuple(live)
        if key not in self._mask_cache:
            m = np.zeros((self.n_slots,), bool)
            m[list(live)] = True
            self._mask_cache[key] = self._to_device(m)
        return self._mask_cache[key]

    def _current_tokens(self, live: List[int]) -> np.ndarray:
        toks = np.zeros((self.n_slots,), np.int64)
        for i in live:
            s = self.slots[i]
            hist = list(s.req.prompt) + s.req.out
            toks[i] = hist[s.pos] if s.pos < len(hist) else hist[-1]
        return toks

    def _finish_check(self, s: _Slot) -> None:
        """Done on EOS, on budget exhaustion, or at the ``max_seq - 1``
        sequence wall."""
        r = s.req
        if (self.eos_id is not None and r.out and r.out[-1] == self.eos_id) \
                or len(r.out) >= r.max_new or s.pos >= self.max_seq - 1:
            self._finish(r, "done")

    def _append_block(self, live: List[int], block: np.ndarray,
                      t_block: int) -> Dict[int, List[int]]:
        """Credit a read (T, n_slots) token block: each column is cut at
        its first sentinel; -2 marks the request ``failed``.  Rows whose
        request is already terminal are skipped."""
        out: Dict[int, List[int]] = {}
        for i in live:
            s = self.slots[i]
            if s.req.done:
                continue
            toks = block[:t_block, i].tolist()
            quarantined = False
            for j, t in enumerate(toks):
                if t < 0:
                    quarantined = t == model_lib.QUARANTINE_SENTINEL
                    toks = toks[:j]
                    break
            s.req.out.extend(toks)
            s.pos += len(toks)
            out[s.req.uid] = toks
            if quarantined:
                self._finish(s.req, "failed")
            else:
                self._finish_check(s)
        return out

    def _sampling_arrays(self, live: List[int]):
        """Per-slot (temperature, top_k, seed) arrays, or None when every
        live slot is greedy (the block then runs no sampling work)."""
        if all(self.slots[i].req.sampling is None
               or self.slots[i].req.sampling.temperature <= 0
               for i in live):
            return None
        temp = np.zeros((self.n_slots,), np.float32)
        topk = np.zeros((self.n_slots,), np.int64)
        seeds = np.zeros((self.n_slots,), np.int64)
        for i in live:
            sp = self.slots[i].req.sampling
            if sp is not None:
                temp[i], topk[i], seeds[i] = sp.temperature, sp.top_k, sp.seed
        return temp, topk, seeds

    def step(self) -> Dict[int, int]:
        """One decode step for every live slot (the per-token oracle);
        returns {uid: new_token}.  Flushes any in-flight block first
        (crediting, not returning, its tokens); expires deadlines; under
        ``nan_guard`` a row with non-finite logits ends ``failed`` with no
        token.  It runs under the block's tier, as a fused block would.
        The step's (n_slots, V) float32 logits stay in ``last_logits``."""
        self.flush()
        self._expire_deadlines()
        self._maybe_demote()
        self._admit()
        self._advance_prefill()
        live = self._live()
        if not live:
            return {}
        samp = self._sampling_arrays(live)
        lg, nxt, finite = self._run(
            self._step_exec(self._block_tier(live), samp is not None),
            self._to_device(self._current_tokens(live)[:, None]),
            self._to_device(self._slot_positions()), self._live_mask(live),
            *(self._to_device(a) for a in samp or ()))
        self.last_logits = lg
        self._carry = None            # the device carries are a step behind
        nxt = nxt.cpu().numpy()
        finite = finite.cpu().numpy() if finite is not None else None
        out: Dict[int, int] = {}
        for i in live:
            s = self.slots[i]
            if finite is not None and not finite[i]:
                self._finish(s.req, "failed")
                continue
            s.req.out.append(int(nxt[i]))
            s.pos += 1
            out[s.req.uid] = int(nxt[i])
            self._finish_check(s)
        return out

    def _block_len(self, live: List[int], budget: int) -> int:
        """Block length: the largest live remaining budget (request budget
        and sequence room), clamped to [1, budget] and rounded down to a
        power of two (the reference's trace-count bound, kept so the two
        engines cut their blocks identically)."""
        rem = max(
            max(min(s.req.max_new - len(s.req.out),
                    (self.max_seq - 1) - s.pos), 1)
            for s in (self.slots[i] for i in live))
        t = max(1, min(rem, budget))
        return 1 << (t.bit_length() - 1)

    def _slot_budgets(self, live: List[int]) -> np.ndarray:
        rem = np.zeros((self.n_slots,), np.int32)
        for i in live:
            s = self.slots[i]
            rem[i] = max(min(s.req.max_new - len(s.req.out),
                             (self.max_seq - 1) - s.pos), 0)
        return rem

    # ---- async double-buffered blocks ----
    def _live_key(self, live: List[int]) -> tuple:
        return tuple((i, self.slots[i].req.uid) for i in live)

    def _block_tier(self, live: List[int]) -> int:
        """The tier a block over ``live`` runs under: the least relaxed
        live latency class, clamped to the tier count, so no request is
        served below its class."""
        if len(self._tier_params) <= 1:
            return 0
        hi = len(self._tier_params) - 1
        return min(min(self.slots[i].req.latency_class, hi) for i in live)

    def _spec_k_for(self, t_block: int, tier: int) -> int:
        """Draft length of the next block, 0 to decode plainly: speculate
        when enabled, windowed-exact and the block has at least 2 steps of
        budget, unless the block's tier is itself the draft tier (of
        several).  A single-tier engine drafts on its full plan."""
        if not self.speculate_k or not self._spec_windowed or t_block < 2:
            return 0
        n = len(self._tier_params)
        if n > 1 and tier >= n - 1:
            return 0
        return self.speculate_k

    def _dispatch_block(self, live: List[int], t_block: int, toks_in,
                        pos_in, rem_in) -> int:
        """Launch one block without reading its tokens — a verify block of
        ``speculate_k`` + 1 rows (``_spec_k_for``) or ``t_block`` fused
        decode steps, under the block's tier: the carries are kept for the
        next launch and the block is parked on ``_inflight`` behind a
        non-blocking copy to pinned memory and an event.  Returns the
        launched block length."""
        tier = self._block_tier(live)
        spec_k = self._spec_k_for(t_block, tier)
        samp = self._sampling_arrays(live)
        if spec_k:
            t_block = spec_k + 1
        block, tok, pos, rem = self._run(
            self._block_exec(tier, t_block, samp is not None, spec_k),
            toks_in, pos_in, self._live_mask(live), rem_in,
            *(self._to_device(a) for a in samp or ()))
        key = self._live_key(live)
        self._carry = (key, tok, pos, rem)
        if self.device.type == "cuda":
            host = torch.empty(block.shape, dtype=block.dtype,
                               pin_memory=True)
            host.copy_(block, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = block, None
        self._inflight.append(_InflightBlock(key, list(live), t_block, host,
                                             ready, spec_k))
        return t_block

    def _launch(self, live: List[int], t_block: int) -> int:
        """Launch a block for ``live`` from the device carries when they
        belong to this exact live set, else from host state."""
        if self._carry is not None and self._carry[0] == self._live_key(live):
            _, tok, pos, rem = self._carry
            return self._dispatch_block(live, t_block, tok, pos, rem)
        return self._dispatch_block(
            live, t_block, self._to_device(self._current_tokens(live)),
            self._to_device(self._slot_positions()),
            self._to_device(self._slot_budgets(live)))

    def _account_one(self, out: Optional[Dict[int, List[int]]] = None
                     ) -> bool:
        """Wait for the oldest in-flight block's tokens and credit them
        (merged into ``out`` when given).  True when any of its requests
        finished — the occupancy change that invalidates a successor
        launched from its carries.  A verify block's row that emitted n ≥ 1
        tokens accepted n − 1 of its drafts (the last token is the full
        plan's correction or bonus)."""
        blk = self._inflight.pop(0)
        if blk.ready is not None:
            blk.ready.synchronize()
        uid_slot = {self.slots[i].req.uid: i for i in blk.live}
        credited = self._append_block(blk.live, blk.host.numpy(),
                                      blk.t_block)
        now = self._clock()
        n_tok = sum(len(t) for t in credited.values())
        if self._last_account is not None and n_tok:
            dt = now - self._last_account
            if dt > 0:
                per = dt / n_tok
                self._tok_ema = (per if self._tok_ema is None
                                 else 0.8 * self._tok_ema + 0.2 * per)
        self._last_account = now
        if blk.spec_k:
            self.spec_stats["verify_blocks"] += 1
            for uid, toks in credited.items():
                if not toks:
                    continue
                acc = len(toks) - 1
                self.spec_stats["drafted"] += blk.spec_k
                self.spec_stats["accepted"] += acc
                self.spec_stats["emitted"] += len(toks)
                i = uid_slot[uid]
                self.spec_slot_stats[i, 0] += blk.spec_k
                self.spec_slot_stats[i, 1] += acc
        if out is not None:
            for uid, toks in credited.items():
                out.setdefault(uid, []).extend(toks)
        return any(self.slots[i].req.done for i in blk.live)

    def flush(self) -> Dict[int, List[int]]:
        """Read and credit every in-flight block; returns {uid: [tokens]}
        they produced ({} when nothing was pending)."""
        out: Dict[int, List[int]] = {}
        while self._inflight:
            self._account_one(out)
        return out

    def speculative_acceptance(self) -> float:
        """Accepted over drafted tokens of every verify block read so far
        (0.0 before any); per slot in ``spec_slot_stats``.  ``flush()``
        first to count the blocks in flight."""
        d = self.spec_stats["drafted"]
        return self.spec_stats["accepted"] / d if d else 0.0

    def _joinable(self) -> bool:
        """True when a request could join the live set this tick: a slot
        mid-prefill, or a queued request and a free slot."""
        return bool(self._prefilling()
                    or (self.queue and self._free_slots()))

    def _block_len_ahead(self, live: List[int], budget: int,
                         inflight_t: int) -> int:
        """Block length of a launch ahead of the pending block's
        accounting: host budgets are stale by its ``inflight_t`` steps.
        0 when every live row exhausts its budget inside it."""
        rem = max(
            min(s.req.max_new - len(s.req.out),
                (self.max_seq - 1) - s.pos) - inflight_t
            for s in (self.slots[i] for i in live))
        if rem <= 0:
            return 0
        t = max(1, min(rem, budget))
        return 1 << (t.bit_length() - 1)

    def decode_block_step(self, n_steps: Optional[int] = None
                          ) -> Dict[int, List[int]]:
        """One serving tick: expire deadlines, admit, feed one pending
        prefill chunk, decode one block of at most ``n_steps`` (default
        ``decode_block``).  Returns {uid: [tokens]} credited this tick.

        With ``async_dispatch`` the tick launches the next block from the
        device carries before reading the previous one, so it returns the
        previous block's tokens — except that a block carrying some
        request's first token is read in its own tick, and nothing is
        launched ahead while a request could join the live set."""
        budget = max(1, self.decode_block if n_steps is None else n_steps)
        out: Dict[int, List[int]] = {}
        self._expire_deadlines()
        self._maybe_demote()
        launched = False
        if self.async_dispatch and self._inflight:
            live = self._live()
            if live and not self._joinable() and self._carry is not None \
                    and self._carry[0] == self._live_key(live):
                t_ahead = self._block_len_ahead(
                    live, budget, self._inflight[-1].t_block)
                if t_ahead > 0:
                    self._launch(live, t_ahead)
                    launched = True
            if self._account_one(out) and launched:
                # occupancy changed under the block launched ahead: read
                # it too (its tokens are exact) and relaunch from host state
                self._account_one(out)
                launched = False
        elif self._inflight:
            out = self.flush()
        self._admit()
        self._advance_prefill()
        live = self._live()
        if not live or launched:
            return out
        self._launch(live, self._block_len(live, budget))
        if not self.async_dispatch \
                or any(not self.slots[i].req.out for i in live):
            self._account_one(out)
        return out

    def _collect(self, results: Dict[int, List[int]]) -> None:
        for s in self.slots:
            if s.req is not None and s.req.done:
                results[s.req.uid] = s.req.out

    def _drained(self) -> bool:
        return (not self.queue and not self._prefilling()
                and all(s.req is None or s.req.done for s in self.slots))

    def run_until_drained(self, max_steps: int = 1024
                          ) -> Dict[int, List[int]]:
        """Serve until queue and slots drain (or ``max_steps`` decode
        steps); returns {uid: tokens} of the requests finished.  With
        ``async_dispatch`` block k+1 launches from the carries before
        block k is read, whenever the carries are valid (a drain has no
        first token to protect); an occupancy change revealed by block
        k's accounting reads block k+1 at once and the next launch comes
        from host state.  ``fused=False`` runs the ``step()`` oracle."""
        if not self.fused:
            return self._run_per_token(max_steps)
        results: Dict[int, List[int]] = {}
        steps = 0
        while True:
            self._expire_deadlines()
            self._maybe_demote()
            if not self._inflight:
                self._collect(results)
                self._admit()
                fed = self._advance_prefill()
                live = self._live()
                if not live:
                    if (fed or self._prefilling()) and steps < max_steps:
                        steps += 1      # a prefill-only iteration
                        continue
                    self._collect(results)
                    break
                if steps >= max_steps:
                    break
                t_block = self._block_len(
                    live, min(self.decode_block, max_steps - steps))
                steps += self._launch(live, t_block)
                if not self.async_dispatch:
                    self._account_one()
                    self._collect(results)
                    if self._drained():
                        break
                continue
            self._advance_prefill()
            live = self._live()
            ahead = False
            if steps < max_steps and live and self._carry is not None \
                    and self._carry[0] == self._live_key(live):
                t_ahead = self._block_len_ahead(
                    live, min(self.decode_block, max_steps - steps),
                    self._inflight[-1].t_block)
                if t_ahead > 0:
                    steps += self._launch(live, t_ahead)
                    ahead = True
            changed = self._account_one()
            self._collect(results)
            if changed and ahead:
                self._account_one()
                self._collect(results)
            if not self._inflight and self._drained():
                break
        return results

    def _run_per_token(self, max_steps: int) -> Dict[int, List[int]]:
        results: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            self._collect(results)
            self.step()
            self._collect(results)
            if not self.queue and all(s.req is None or s.req.done
                                      for s in self.slots):
                break
        return results


def build_serve_step(cfg: ArchConfig) -> Callable:
    """The serving step of the dry-run's decode cells (the reference's
    lowered serving step): (params, tokens (B, 1), state, pos) → (logits
    (B, 1, V), state), ``pos`` a scalar — every row at one position, the
    reference's lockstep — or (B,).  Under installed rules it runs on
    local shards (``models.model.decode_step``)."""
    def serve_step(params, tokens, state, pos):
        if pos.dim() == 0:
            pos = pos.expand(tokens.shape[0])
        return model_lib.decode_step(params, cfg, tokens, state,
                                     pos.to(torch.int64))
    return serve_step
