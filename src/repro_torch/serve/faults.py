"""Deterministic fault injection for the serving engine (the JAX package's
``serve/faults.py``).

Faults fire at engine *ticks* (one ``decode_block_step`` call each), never
at wall-clock times, and time is injectable: ``VirtualClock`` moves only
when told to, so deadline expiry is a scheduled event.  Fault kinds:

* ``"nan"`` — ``poison_slot_state`` on the target's slot while it is
  decode-live (deferred while it is queued or mid-prefill): its next block
  goes non-finite and ``nan_guard`` ends it ``failed``;
* ``"cancel"`` — ``engine.cancel(uid)``;
* ``"delay"`` — advance the injector's ``VirtualClock`` by ``dt`` seconds;
* ``"recalibrate"`` — ``engine.maybe_recalibrate(drift_threshold=-1)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Fault:
    """One scheduled fault: ``kind`` fires at engine tick ``tick``; ``uid``
    targets a request (``nan`` / ``cancel``), ``dt`` is the clock advance
    in seconds (``delay``)."""
    tick: int
    kind: str                     # "nan" | "cancel" | "delay" | "recalibrate"
    uid: Optional[int] = None
    dt: float = 0.0

    def __post_init__(self):
        if self.kind not in ("nan", "cancel", "delay", "recalibrate"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind in ("nan", "cancel") and self.uid is None:
            raise ValueError(f"{self.kind!r} fault needs a target uid")


class VirtualClock:
    """An engine clock that moves only on ``advance`` (pass it as
    ``ServeEngine(clock=...)``)."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += float(dt)
        return self.now


def poison_slot_state(engine, slot: int) -> None:
    """Write NaN, in place, into row ``slot`` of every floating-point
    decode-state leaf ((L, B, ...), batch at axis 1).  The write is queued
    on the stream behind every block already launched, so a block in
    flight computes from the state before the poison and the next one
    launched reads it."""
    def visit(tree):
        for leaf in tree.values():
            if isinstance(leaf, dict):
                visit(leaf)
            elif (leaf.dim() >= 2 and leaf.shape[1] == engine.n_slots
                  and leaf.is_floating_point()):
                leaf[:, slot] = float("nan")
    visit(engine.state)


class FaultInjector:
    """Applies a schedule of ``Fault``s tick by tick: call
    ``apply(engine, tick)`` before each ``decode_block_step``.  Due faults
    fire in schedule order; a ``nan`` fault whose target is not decode-live
    yet waits for a later tick, and a fault whose target is terminal is
    dropped (``dropped``).  ``applied`` lists (tick, fault) pairs."""

    def __init__(self, faults: Sequence[Fault], *,
                 clock: Optional[VirtualClock] = None):
        self.pending: List[Fault] = sorted(faults, key=lambda f: f.tick)
        self.clock = clock
        self.applied: List[Tuple[int, Fault]] = []
        self.dropped: List[Fault] = []

    def apply(self, engine, tick: int) -> List[Fault]:
        """Fire every due fault; returns the ones applied this call."""
        fired: List[Fault] = []
        still: List[Fault] = []
        for f in self.pending:
            if f.tick > tick:
                still.append(f)
                continue
            verdict = self._apply_one(engine, f)
            if verdict == "applied":
                self.applied.append((tick, f))
                fired.append(f)
            elif verdict == "defer":
                still.append(f)
            else:
                self.dropped.append(f)
        self.pending = still
        return fired

    def _apply_one(self, engine, f: Fault) -> str:
        if f.kind == "delay":
            if self.clock is None:
                return "drop"
            self.clock.advance(f.dt)
            return "applied"
        if f.kind == "recalibrate":
            if engine.exec_cfg is None or engine._stats is None:
                return "drop"
            engine.maybe_recalibrate(drift_threshold=-1.0)
            return "applied"
        status = engine.status(f.uid)
        if status is None or status in ("done", "cancelled",
                                        "deadline_missed", "failed", "shed"):
            return "drop"
        if f.kind == "cancel":
            return "applied" if engine.cancel(f.uid) else "drop"
        for i in engine._live():
            if engine.slots[i].req.uid == f.uid:
                poison_slot_state(engine, i)
                return "applied"
        return "defer"


def drive(engine, injector: Optional[FaultInjector] = None, *,
          on_tick: Optional[Callable[[int], object]] = None,
          max_ticks: int = 2000) -> int:
    """Deterministic serving loop: each tick runs ``on_tick(tick)`` (submit
    arrivals there; truthy while more are pending), fires due faults, then
    one ``decode_block_step``.  Returns the tick count once no arrivals
    are pending and the engine is drained (a final ``flush`` credits the
    tail); raises ``RuntimeError`` past ``max_ticks``."""
    for tick in range(max_ticks):
        arrivals_pending = False
        if on_tick is not None:
            arrivals_pending = bool(on_tick(tick))
        if injector is not None:
            injector.apply(engine, tick)
        engine.decode_block_step()
        if not arrivals_pending and engine._drained():
            engine.flush()
            if engine._drained() and not engine._inflight:
                return tick + 1
    raise RuntimeError(f"engine did not drain within {max_ticks} ticks "
                       f"(queue={len(engine.queue)}, "
                       f"inflight={len(engine._inflight)})")


def random_schedule(seed: int, uids: Sequence[int], n_ticks: int, *,
                    kinds: Sequence[str] = ("nan", "cancel", "delay"),
                    n_faults: int = 3, delay_dt: float = 1.0) -> List[Fault]:
    """Seeded fault schedule over ``uids`` within ``n_ticks`` — the same
    (seed, uids, n_ticks) give the same schedule, at most one fault per
    target uid."""
    rng = np.random.default_rng(seed)
    uids = list(uids)
    faults: List[Fault] = []
    targets = rng.permutation(len(uids))[:max(n_faults, 0)]
    for t in targets:
        kind = str(kinds[int(rng.integers(len(kinds)))])
        tick = int(rng.integers(1, max(n_ticks, 2)))
        if kind == "delay":
            faults.append(Fault(tick=tick, kind="delay", dt=delay_dt))
        elif kind == "recalibrate":
            faults.append(Fault(tick=tick, kind="recalibrate"))
        else:
            faults.append(Fault(tick=tick, kind=kind, uid=uids[int(t)]))
    return faults
