"""The port's full serving surface against the JAX package's ``ServeEngine``
at edge-tiny, dense and planned two-sided, on the same weights (the
reference's init, converted) and the same traffic.

One staggered arrival schedule of mixed greedy and sampled requests (ticks
of ``decode_block_step``, then a drain) runs through both engines under
each dispatch / admission variant: chunked and whole prefill, async and
sync dispatch, the four admission policies and a bounded queue.  Streams
are compared token for token and statuses exactly.  Logits agree to ~1e-6
(float32 summed in different orders) and sampled rows add Gumbel noise
within one ulp of the reference's (``test_torch_sampling.py``), so a
flipped token would need a near-tie at that scale: none occurs on these
pinned seeds.  Lifecycle (cancel, deadline, shed), ``results``, ``health``
and the NaN quarantine are compared under one ``VirtualClock`` schedule;
activation densities are compared count for count."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as ref_sp
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro.serve import faults as ref_faults
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.serve import engine as pt_engine
from repro_torch.serve import faults as pt_faults
from test_torch_serve import ref_config

SPARSE = pt_base.SparsityConfig(weight_sparsity=0.5,
                                activation_threshold=0.05)
N_SLOTS, MAX_SEQ = 2, 48
_CACHE = {}


def setup(planned, n_slots=N_SLOTS, collect_stats=False, seed=0):
    """(port cfg, ref cfg, ref params, port params, ref exec, port exec) of
    edge-tiny; planned setups prune the weights at (16, 16) with the
    reference's pruner and compile both plans."""
    key = (planned, n_slots, collect_stats, seed)
    if key not in _CACHE:
        cfg = pt_base.get_smoke_config("edge-tiny")
        if planned:
            cfg = dataclasses.replace(cfg, sparsity=SPARSE)
        rcfg = ref_config(cfg)
        rp = ref_model.init_params(rcfg, jax.random.PRNGKey(seed),
                                   dtype=jnp.float32)
        if planned:
            rp = jax.tree.map(
                lambda leaf: ref_sp.prune_stacked_magnitude(leaf, 0.5,
                                                            (16, 16)), rp)
        pp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
        rec = pec = None
        if planned:
            rec = ref_engine.decode_exec_config(
                rcfg, n_slots, params=rp, collect_stats=collect_stats)
            pec = pt_engine.decode_exec_config(
                cfg, n_slots, params=pp, collect_stats=collect_stats,
                device="cpu")
        _CACHE[key] = (cfg, rcfg, rp, pp, rec, pec)
    return _CACHE[key]


def both(planned, **kw):
    """A reference and a port engine over the same weights and options
    (``sampling`` objects are built per side by the traffic driver)."""
    cfg, rcfg, rp, pp, rec, pec = setup(planned)
    kw.setdefault("n_slots", N_SLOTS)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("decode_block", 4)
    ref_kw = dict(kw)
    port_kw = dict(kw)
    for name in ("admission",):
        if name in kw:
            ref_kw[name] = getattr(ref_engine, type(kw[name]).__name__)(
                **dataclasses.asdict(kw[name])
                if dataclasses.is_dataclass(kw[name]) else {})
    if "clock" in kw:
        ref_kw["clock"] = ref_faults.VirtualClock()
        port_kw["clock"] = pt_faults.VirtualClock()
    return (ref_engine.ServeEngine(rcfg, rp, exec_cfg=rec, **ref_kw),
            pt_engine.ServeEngine(cfg, pp, exec_cfg=pec, device="cpu",
                                  **port_kw))


# (prompt length, max_new, (temperature, top_k, seed) or None, priority,
# arrival tick): three greedy and three sampled requests
TRAFFIC = [(9, 6, None, 2, 0), (3, 8, (0.8, 40, 1), 0, 0),
           (12, 5, None, 1, 1), (1, 7, (1.0, 0, 2), 0, 2),
           (6, 4, (0.7, 5, 3), 2, 2), (10, 6, None, 1, 4)]


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=n).astype(np.int32)
            for n, *_ in TRAFFIC]


def serve(eng, mod, traffic=TRAFFIC, on_tick=None):
    """Submit ``traffic`` (entries as in ``TRAFFIC``, optionally with a
    deadline after the arrival tick) at its arrival ticks through
    ``decode_block_step`` ticks, then drain; returns ({uid: tokens},
    {uid: status})."""
    prompts = _prompts()
    uids, k = [], 0
    for tick in range(max(t[4] for t in traffic) + 3):
        while k < len(traffic) and traffic[k][4] <= tick:
            _, max_new, samp, prio, _, *deadline = traffic[k]
            sp = mod.SamplingParams(*samp) if samp else None
            uids.append(eng.submit(prompts[k], max_new=max_new, sampling=sp,
                                   priority=prio,
                                   deadline=deadline[0] if deadline
                                   else None))
            k += 1
        if on_tick is not None:
            on_tick(eng, tick, uids)
        eng.decode_block_step()
    eng.run_until_drained()
    eng.flush()
    res = eng.results()
    return ({u: res.get(u) for u in uids}, {u: eng.status(u) for u in uids})


VARIANTS = {
    "async-chunked-fifo": dict(prefill_chunk=4,
                               admission=pt_engine.FIFOAdmission()),
    "sync-chunked": dict(prefill_chunk=4, async_dispatch=False),
    "async-whole": dict(),
    "sync-whole": dict(async_dispatch=False),
    "adaptive": dict(admission=pt_engine.AdaptiveAdmission(
        min_chunk=2, max_chunk=8, burst_depth=1)),
    "priority": dict(prefill_chunk=4,
                     admission=pt_engine.PriorityAdmission()),
    "shed-lowest": dict(prefill_chunk=4, max_queue=1,
                        admission=pt_engine.ShedLowestPriority()),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
def test_streams_equal_reference_engine(planned, variant):
    reng, peng = both(planned, **VARIANTS[variant])
    rres, rstat = serve(reng, ref_engine)
    pres, pstat = serve(peng, pt_engine)
    assert pstat == rstat
    assert pres == rres
    if variant == "shed-lowest":
        assert "shed" in pstat.values()
    else:
        assert set(pstat.values()) == {"done"}
        assert [len(t) for t in pres.values()] == [m for _, m, *_ in TRAFFIC]


def test_fused_variants_equal_step_oracle():
    """Chunked async, whole sync and the per-token ``step()`` oracle give
    one set of streams (the port alone: the oracle is its own)."""
    cfg, _, _, pp, _, _ = setup(True)
    out = []
    for kw in (dict(prefill_chunk=4), dict(async_dispatch=False),
               dict(fused=False)):
        eng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS,
                                    max_seq=MAX_SEQ, decode_block=4,
                                    exec_cfg=setup(True)[5], device="cpu",
                                    **kw)
        uids = [eng.submit(p, max_new=m,
                           sampling=pt_engine.SamplingParams(*s) if s
                           else None)
                for p, (_, m, s, _, _) in zip(_prompts(), TRAFFIC)]
        res = eng.run_until_drained()
        out.append([res[u] for u in uids])
    assert out[0] == out[1] == out[2]


# the lifecycle schedule: request 2 is cancelled in mid-decode at tick 3,
# request 3 (deadline 50 s) is in a slot when the clock jumps 100 s at
# tick 5, and request 5 finds the bounded queue (2) full at tick 2
LIFECYCLE = [(9, 20, None, 2, 0), (3, 40, (0.8, 40, 1), 0, 0),
             (12, 20, None, 1, 1, 50.0), (1, 20, (1.0, 0, 2), 0, 2),
             (6, 20, (0.7, 5, 3), 2, 2), (10, 20, None, 1, 4)]


def _lifecycle(eng, tick, uids):
    if tick == 3:
        assert eng.status(uids[1]) == "decode"
        assert eng.cancel(uids[1])
        assert not eng.cancel(uids[1])
    if tick == 5:
        assert eng.status(uids[2]) in ("prefill", "decode")
        eng._clock.advance(100.0)


@pytest.mark.parametrize("async_dispatch", [True, False],
                         ids=["async", "sync"])
def test_lifecycle_equals_reference(async_dispatch):
    """Cancel in mid-decode, a missed deadline and shedding at max_queue 2
    under a ``VirtualClock``: statuses, ``results``, counters and
    ``health`` equal the reference's."""
    reng, peng = both(False, prefill_chunk=4, max_queue=2, clock=True,
                      async_dispatch=async_dispatch)
    rres, rstat = serve(reng, ref_engine, LIFECYCLE, _lifecycle)
    pres, pstat = serve(peng, pt_engine, LIFECYCLE, _lifecycle)
    assert pstat == rstat
    assert list(pstat.values()) == ["done", "cancelled", "deadline_missed",
                                    "done", "shed", "done"]
    assert pres == rres
    assert peng.counters == reng.counters
    assert peng.results() == reng.results()
    assert peng.health() == reng.health()
    assert peng.status(10 ** 6) is None and not peng.cancel(10 ** 6)


def test_health_mid_traffic_equals_reference():
    reng, peng = both(False, prefill_chunk=4, max_queue=8, clock=True)
    for eng, mod in ((reng, ref_engine), (peng, pt_engine)):
        eng.submit(_prompts()[0], max_new=12)
        eng.submit(_prompts()[1], max_new=4,
                   sampling=mod.SamplingParams(0.8, 40, 1))
        eng.submit(_prompts()[2], max_new=4)
        for _ in range(3):
            eng.decode_block_step()
    h = peng.health()
    assert h == reng.health()
    assert set(h) == {"queue_depth", "max_queue", "free_slots", "decoding",
                      "prefilling", "inflight_blocks",
                      "inflight_speculative", "requests", "counters",
                      "spec", "tok_ema_s"}
    assert h["max_queue"] == 8 and h["counters"]["done"] >= 1


@pytest.mark.parametrize("async_dispatch", [True, False],
                         ids=["async", "sync"])
def test_nan_quarantine_equals_reference(async_dispatch):
    """A poisoned decoding slot ends ``failed`` with a clean prefix and the
    batch's other streams are unchanged, as in the reference (the dense
    engine: a two-sided bitmap reads a NaN block as dead, in both
    packages)."""
    out = []
    for mod, faults, eng in zip((ref_engine, pt_engine),
                                (ref_faults, pt_faults),
                                both(False, prefill_chunk=4,
                                     async_dispatch=async_dispatch)):
        a = eng.submit(_prompts()[0], max_new=30)
        b = eng.submit(_prompts()[1], max_new=10,
                       sampling=mod.SamplingParams(0.8, 40, 1))
        for _ in range(5):
            eng.decode_block_step()
        slot = next(i for i, s in enumerate(eng.slots)
                    if s.req is not None and s.req.uid == a)
        faults.poison_slot_state(eng, slot)
        faults.drive(eng)
        out.append((eng.results(), eng.status(a), eng.status(b),
                    dict(eng.counters)))
    assert out[1] == out[0]
    res, sa, sb, counters = out[1]
    assert (sa, sb) == ("failed", "done") and counters["failed"] == 1
    assert 0 < len(res[a]) < 30 and len(res[b]) == 10


def test_quarantine_stops_only_the_poisoned_row():
    """Against the port's own unpoisoned run: the failed stream is a prefix
    of its clean stream and the other stream is untouched."""
    cfg, _, _, pp, _, _ = setup(False)
    runs = []
    for poison in (False, True):
        eng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS,
                                    max_seq=MAX_SEQ, decode_block=4,
                                    device="cpu")
        a = eng.submit(_prompts()[0], max_new=30)
        b = eng.submit(_prompts()[1], max_new=10)
        for _ in range(3):
            eng.decode_block_step()
        if poison:
            pt_faults.poison_slot_state(eng, 0)
        pt_faults.drive(eng)
        runs.append(eng.results())
    clean, bad = runs
    assert bad[b] == clean[b]
    assert bad[a] == clean[a][:len(bad[a])] and len(bad[a]) < 30


def _densities(side, n_slots):
    cfg, rcfg, rp, pp, rec, pec = setup(True, n_slots=n_slots,
                                        collect_stats=True)
    if side == "ref":
        eng = ref_engine.ServeEngine(rcfg, rp, n_slots=n_slots,
                                     max_seq=MAX_SEQ, exec_cfg=rec)
    else:
        eng = pt_engine.ServeEngine(cfg, pp, n_slots=n_slots,
                                    max_seq=MAX_SEQ, exec_cfg=pec,
                                    device="cpu")
    eng.submit(_prompts()[0], max_new=6)
    eng.run_until_drained()
    return eng.activation_densities()


def test_activation_densities_equal_reference():
    """Same prompts, same counts: the port's device popcounts equal the
    reference's host callbacks site for site, and 1 live row of 4 measures
    what a 1-slot engine measures."""
    d_ref = _densities("ref", 4)
    d4 = _densities("port", 4)
    d1 = _densities("port", 1)
    assert d4 and set(d4) == set(d_ref)
    assert all(0.0 < v <= 1.0 for v in d4.values())
    assert d4 == d_ref
    assert d1 == d4


def test_activation_density_drift():
    cases = [(None, {}), (None, {"a": 0.9}), ({"a": 0.4}, {"a": 0.9}),
             ({"a": 0.5}, {"a": 0.45, "b": 0.1})]
    for base, meas in cases:
        assert (pt_engine.activation_density_drift(base, meas)
                == ref_engine.activation_density_drift(base, meas))
    assert pt_engine.activation_density_drift({"a": 0.4}, {"a": 0.9}) \
        == pytest.approx(0.5)


def test_maybe_recalibrate():
    """``recompile=False`` answers the trigger only and consumes the
    window; ``recompile=True`` swaps in a table selected under the
    measured densities, and the streams do not change."""
    cfg, _, _, pp, _, pec = setup(True, collect_stats=True)
    prompts = _prompts()

    def engine():
        return pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS,
                                     max_seq=MAX_SEQ, exec_cfg=pec,
                                     device="cpu")

    eng = engine()
    eng.submit(prompts[0], max_new=5)
    eng.run_until_drained()
    assert eng.maybe_recalibrate(drift_threshold=1.0) is None
    assert eng.maybe_recalibrate(drift_threshold=-1.0) is None   # consumed
    eng.submit(prompts[1], max_new=5)
    eng.run_until_drained()
    measured = eng.maybe_recalibrate(drift_threshold=-1.0, recompile=False)
    assert measured and eng.exec_cfg is pec

    base, recal = engine(), engine()
    for e in (base, recal):
        e.submit(prompts[2], max_new=4)
        e.run_until_drained()
    measured = recal.maybe_recalibrate(drift_threshold=-1.0)
    assert measured and recal.exec_cfg is not pec
    assert recal.exec_cfg.act_densities == measured
    assert recal.exec_cfg.plan is not None
    streams = []
    for e in (base, recal):
        uids = [e.submit(p, max_new=6) for p in prompts[3:]]
        res = e.run_until_drained()
        streams.append([res[u] for u in uids])
    assert streams[0] == streams[1]


def test_recalibrate_needs_arch_cfg():
    cfg, _, _, pp, _, pec = setup(True, collect_stats=True)
    ec = dataclasses.replace(pec, arch_cfg=None)
    eng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                exec_cfg=ec, device="cpu")
    eng.submit(_prompts()[0], max_new=3)
    eng.run_until_drained()
    with pytest.raises(ValueError, match="arch_cfg"):
        eng.maybe_recalibrate(drift_threshold=-1.0)


def _state_bits(eng):
    return {k: v.clone().view(torch.int32)
            for k, v in eng.state["layers"].items()}


def test_warmup_leaves_state_unchanged():
    """Mid-traffic (two slots holding KV rows), ``warmup`` leaves every
    state bit as it was, and serving carries on to the same streams."""
    cfg, _, _, pp, _, pec = setup(True)
    prompts = _prompts()
    streams = []
    for warm in (False, True):
        eng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS,
                                    max_seq=MAX_SEQ, decode_block=4,
                                    exec_cfg=pec, prefill_chunk=4,
                                    device="cpu")
        uids = [eng.submit(p, max_new=8) for p in prompts[:3]]
        for _ in range(3):
            eng.decode_block_step()
        if warm:
            eng.flush()
            before = _state_bits(eng)
            eng.warmup()
            after = _state_bits(eng)
            assert all(torch.equal(before[k], after[k]) for k in before)
        res = eng.run_until_drained()
        eng.flush()
        streams.append([eng.results()[u] for u in uids])
    assert streams[0] == streams[1]


def test_attach_verify():
    """A plan compiled from other weights of the same shapes (here with
    ``w_in`` zeroed, so its blocks are planned dead) is refused when
    verified and attaches unchecked with ``verify=False``."""
    cfg, _, _, pp, _, _ = setup(False)
    sp_cfg = dataclasses.replace(cfg, sparsity=SPARSE)
    zeroed = {**pp, "stack": {"layers": {
        **pp["stack"]["layers"],
        "mlp": {**pp["stack"]["layers"]["mlp"],
                "w_in": torch.zeros_like(
                    pp["stack"]["layers"]["mlp"]["w_in"])}}}}
    plan = pt_engine.decode_exec_config(sp_cfg, N_SLOTS, params=zeroed,
                                        device="cpu").plan
    plan.attach(zeroed)
    with pytest.raises(ValueError, match="does not cover"):
        plan.attach(pp)
    plan.attach(pp, verify=False)


def test_submit_and_engine_validation():
    cfg, _, _, pp, _, _ = setup(False)
    eng = pt_engine.ServeEngine(cfg, pp, n_slots=2, max_seq=8, device="cpu")
    with pytest.raises(ValueError, match="latency_class"):
        eng.submit([1, 2], latency_class=-1)
    with pytest.raises(ValueError, match="deadline"):
        eng.submit([1, 2], deadline=0)
    uid = eng.submit([1, 2], max_new=3, latency_class=2)
    assert eng.run_until_drained()[uid] and eng.status(uid) == "done"
    assert eng.flush() == {} and eng.flush() == {}
    for bad in (dict(prefill_chunk=0), dict(max_queue=0)):
        with pytest.raises(ValueError):
            pt_engine.ServeEngine(cfg, pp, device="cpu", **bad)
    with pytest.raises(TypeError, match="AdmissionPolicy"):
        pt_engine.ServeEngine(cfg, pp, device="cpu", admission=object())
    with pytest.raises(ValueError, match="power of two"):
        pt_engine.AdaptiveAdmission(min_chunk=3)
