"""The port's fault injection (``repro_torch.serve.faults``): seeded
schedules equal the JAX package's, and a driven engine under a
``FaultInjector`` ends exactly one request per applied targeted fault."""
import numpy as np
import pytest
import torch

from repro.serve import faults as ref_faults
from repro_torch.configs import base as pt_base
from repro_torch.models import model as pt_model
from repro_torch.serve import TERMINAL_STATES, ServeEngine
from repro_torch.serve import faults as pt_faults

KINDS = (("nan", "cancel", "delay"), ("cancel", "recalibrate"),
         ("nan",), ("delay", "recalibrate", "nan", "cancel"))


@pytest.mark.parametrize("seed", range(6))
def test_random_schedule_equals_reference(seed):
    for kinds in KINDS:
        for uids, n_ticks, n_faults in (([1, 2, 3, 4, 5], 10, 3),
                                        (list(range(7, 19)), 1, 5),
                                        ([4], 30, 2)):
            got = pt_faults.random_schedule(seed, uids, n_ticks, kinds=kinds,
                                            n_faults=n_faults, delay_dt=2.5)
            want = ref_faults.random_schedule(seed, uids, n_ticks,
                                              kinds=kinds, n_faults=n_faults,
                                              delay_dt=2.5)
            assert [(f.tick, f.kind, f.uid, f.dt) for f in got] == \
                [(f.tick, f.kind, f.uid, f.dt) for f in want]


def test_fault_validation():
    with pytest.raises(ValueError, match="unknown"):
        pt_faults.Fault(tick=1, kind="boom")
    with pytest.raises(ValueError, match="target uid"):
        pt_faults.Fault(tick=1, kind="cancel")
    clk = pt_faults.VirtualClock(3.0)
    assert clk() == 3.0 and clk.advance(1.5) == 4.5 and clk() == 4.5


_PARAMS = {}


def _engine(clock):
    cfg = pt_base.get_smoke_config("edge-tiny")
    if "p" not in _PARAMS:
        gen = torch.Generator().manual_seed(0)
        _PARAMS["p"] = pt_model.init_params(cfg, gen, dtype=torch.float32,
                                            device="cpu")
    return ServeEngine(cfg, _PARAMS["p"], n_slots=2, max_seq=64,
                       decode_block=4, prefill_chunk=4, clock=clock,
                       device="cpu")


@pytest.mark.parametrize("seed", range(4))
def test_drive_one_casualty_per_fault(seed):
    """Staggered arrivals, a seeded nan / cancel schedule over the
    requests (each target's budget far beyond the fault tick) and one
    deadline-bound request with a clock jump: ``drive`` ends, every
    request is terminal, and each applied fault maps to one request of
    its status."""
    rng = np.random.default_rng(seed)
    n_req = 6
    prompts = [rng.integers(1, 127, size=int(rng.integers(2, 12)))
               for _ in range(n_req)]
    arrive = sorted(int(rng.integers(0, 5)) for _ in range(n_req))
    uids = list(range(1, n_req + 1))
    faults = pt_faults.random_schedule(seed, uids[:-1], 6,
                                       kinds=("nan", "cancel"), n_faults=2)
    faults.append(pt_faults.Fault(tick=arrive[-1] + 1, kind="delay",
                                  dt=100.0))
    targets = {f.uid for f in faults if f.uid is not None}
    clock = pt_faults.VirtualClock()
    eng = _engine(clock)
    submitted = []

    def on_tick(t):
        while len(submitted) < n_req and arrive[len(submitted)] <= t:
            k = len(submitted)
            submitted.append(eng.submit(
                prompts[k], max_new=40 if uids[k] in targets else 5,
                deadline=50.0 if k == n_req - 1 else None))
        return len(submitted) < n_req

    inj = pt_faults.FaultInjector(faults, clock=clock)
    ticks = pt_faults.drive(eng, inj, on_tick=on_tick)
    assert ticks > 0 and submitted == uids and not inj.pending
    statuses = {u: eng.status(u) for u in uids}
    assert all(s in TERMINAL_STATES for s in statuses.values())
    applied = [f for _, f in inj.applied]
    assert len(applied) + len(inj.dropped) == len(faults)
    n = {k: sum(f.kind == k for f in applied) for k in ("nan", "cancel")}
    assert eng.counters["failed"] == n["nan"]
    assert eng.counters["cancelled"] == n["cancel"]
    for f in applied:
        if f.uid is not None:
            assert statuses[f.uid] == ("failed" if f.kind == "nan"
                                       else "cancelled")
    assert statuses[uids[-1]] == "deadline_missed"
    assert eng.counters["deadline_missed"] == 1
    assert eng.counters["done"] == n_req - n["nan"] - n["cancel"] - 1
    assert set(eng.results()) == set(uids)


def test_drive_raises_past_max_ticks():
    eng = _engine(None)
    eng.submit([1, 2, 3], max_new=40)
    with pytest.raises(RuntimeError, match="did not drain"):
        pt_faults.drive(eng, max_ticks=2)
