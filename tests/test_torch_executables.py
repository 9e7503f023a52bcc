"""The serve executables (``repro_torch.serve.executables`` and the engine's
entry points) against the JAX package's ``ServeEngine`` at edge-tiny.

Admission's ``chunk_cap`` and ``_next_pow2`` equal the reference's; the
padded (and, past ``decode_block``, split) prompt feed leaves the state the
reference's feed leaves, within the repo's decode parity bar (atol = rtol =
1e-4, float32 summed in other orders), and the unpadded eager feed's bit for
bit; ``donate_state`` writes in place or leaves a held tree intact, with
the reference's streams either way; ``maybe_recalibrate`` drops every
executable; ``warmup`` prepares the shapes the reference's warmup compiles,
the prompt feed bounded by ``decode_block``.  On the CPU an entry point is
its eager function, so these tests hold the engine's wiring; the captured
graphs are held by ``test_torch_cuda.py`` and ``chip_smoke.py`` phase 23."""
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.serve import engine as ref_engine
from repro_torch.core.sparsity import iter_leaves
from repro_torch.kernels import ops
from repro_torch.models import model as pt_model
from repro_torch.serve import engine as pt_engine
from test_torch_engine import MAX_SEQ, setup

PARITY = dict(rtol=1e-4, atol=1e-4)
# prompt lengths 1, 2, 5 and 9: feeds of 0, 1, 4 and 8 tokens
PROMPT_LENS = (1, 2, 5, 9)


def _prompts(lens=PROMPT_LENS, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=n).astype(np.int32) for n in lens]


def _engines(planned=True, adaptive=None, **kw):
    """A reference and a port engine over the same weights (4 slots), with
    ``AdaptiveAdmission(*adaptive)`` when given."""
    cfg, rcfg, rp, pp, rec, pec = setup(planned, n_slots=4)
    kw.setdefault("max_seq", MAX_SEQ)
    ref_kw, port_kw = dict(kw), dict(kw)
    if adaptive is not None:
        ref_kw["admission"] = ref_engine.AdaptiveAdmission(*adaptive)
        port_kw["admission"] = pt_engine.AdaptiveAdmission(*adaptive)
    return (ref_engine.ServeEngine(rcfg, rp, exec_cfg=rec, n_slots=4,
                                   **ref_kw),
            pt_engine.ServeEngine(cfg, pp, exec_cfg=pec, n_slots=4,
                                  device="cpu", **port_kw))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

POLICIES = [(name, chunk) for name in ("AdmissionPolicy", "FIFOAdmission",
                                       "PriorityAdmission",
                                       "ShedLowestPriority")
            for chunk in (None, 8)]


@pytest.mark.parametrize("name,chunk", POLICIES)
def test_chunk_cap_equals_the_reference(name, chunk):
    ref, port = _engines(prefill_chunk=chunk)
    assert (getattr(pt_engine, name)().chunk_cap(port)
            == getattr(ref_engine, name)().chunk_cap(ref) == chunk)


@pytest.mark.parametrize("bounds", [(32, 256), (4, 16)])
def test_adaptive_chunk_cap_equals_the_reference(bounds):
    ref, port = _engines(prefill_chunk=8)
    lo, hi = bounds
    assert (pt_engine.AdaptiveAdmission(lo, hi).chunk_cap(port)
            == ref_engine.AdaptiveAdmission(lo, hi).chunk_cap(ref) == hi)


def test_next_pow2_equals_the_reference():
    assert all(pt_engine._next_pow2(n) == ref_engine._next_pow2(n)
               for n in range(0, 300))


# ---------------------------------------------------------------------------
# the prompt feed
# ---------------------------------------------------------------------------

def _admit_all(eng):
    """Admit every queued request and feed every prompt to its end."""
    eng._admit()
    while eng._advance_prefill():
        pass


@pytest.mark.parametrize("chunk", [None, 4])
def test_padded_feed_equals_the_reference_and_the_unpadded_feed(chunk):
    """Prompts of 1, 2, 5 and 9 tokens admitted whole or in chunks of 4 at
    ``decode_block`` 4, so a whole 8-token feed runs as two feeds of 4:
    the port's state is the reference's within the parity bar, and equal
    bit for bit to one unpadded eager ``prefill_into_slot`` per segment."""
    ref, port = _engines(prefill_chunk=chunk, decode_block=4)
    calls = []
    feed = port._feed_prefill

    def recording(i, start, count):
        calls.append((i, start, count, port._slot_positions()))
        feed(i, start, count)
    port._feed_prefill = recording
    for p in _prompts():
        ref.submit(p, max_new=4)
        port.submit(p, max_new=4)
    _admit_all(ref)
    _admit_all(port)
    assert [s.pos for s in port.slots] == [s.pos for s in ref.slots]
    assert max(count for _, _, count, _ in calls) == (8 if chunk is None
                                                       else 4)
    rstate = jax.tree.map(np.asarray, ref.state)
    for path, leaf in iter_leaves(port.state):
        want = rstate
        for k in path:
            want = want[k]
        np.testing.assert_allclose(leaf.numpy(), want, **PARITY,
                                   err_msg=str(path))

    state = pt_model.init_decode_state(port.cfg, 4, MAX_SEQ,
                                       dtype=torch.float32, device="cpu")
    with ops.exec_config(port.exec_cfg), torch.no_grad():
        for i, start, count, pos in calls:
            seg = port.slots[i].req.prompt[:-1][start:start + count]
            pt_model.prefill_into_slot(
                port._exec_params, port.cfg, seg, np.ones(len(seg), bool),
                i, state, torch.from_numpy(pos), start, start == 0)
    for (path, a), (_, b) in zip(iter_leaves(port.state),
                                 iter_leaves(state)):
        assert torch.equal(_bits(a), _bits(b)), path


def test_feed_is_called_with_power_of_two_lengths():
    _, port = _engines(prefill_chunk=None, decode_block=4)
    lens = []
    feed_exec = port._feed_exec

    def recording(p_len):
        lens.append(p_len)
        return feed_exec(p_len)
    port._feed_exec = recording
    for p in _prompts((1, 2, 5, 14)):
        port.submit(p, max_new=2)
    _admit_all(port)
    # feeds of 0, 1, 4 and 13 tokens: 13 runs as 4 + 4 + 4 + 1
    assert lens == [1, 1, 4, 4, 4, 4, 1]


# ---------------------------------------------------------------------------
# donate_state
# ---------------------------------------------------------------------------

def test_donate_state_behaves_as_the_reference():
    """The same streams donated or not; donated, the state leaves are
    written in place; undonated, a state tree held across the calls keeps
    its values, as the reference's undonated calls keep their inputs
    alive."""
    prompts = _prompts((3, 7, 5))
    ref, port = _engines(decode_block=4, donate_state=False)
    _, donating = _engines(decode_block=4)
    held_ref, held = ref.state, port.state
    snap = {p: t.clone() for p, t in iter_leaves(held)}
    leaves = [t for _, t in iter_leaves(donating.state)]
    streams = []
    for eng in (ref, port, donating):
        uids = [eng.submit(p, max_new=5) for p in prompts]
        res = eng.run_until_drained()
        streams.append([res[u] for u in uids])
    assert streams[1] == streams[2] == streams[0]
    assert not any(a.is_deleted() for a in jax.tree.leaves(held_ref))
    assert all(torch.equal(t, snap[p]) for p, t in iter_leaves(held))
    assert not any(bool(t.any()) for _, t in iter_leaves(held))
    assert [t for _, t in iter_leaves(donating.state)] == leaves
    assert any(bool(t.any()) for t in leaves)
    for (_, a), (_, b) in zip(iter_leaves(port.state),
                              iter_leaves(donating.state)):
        assert a is not b and torch.equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# recalibration and warmup
# ---------------------------------------------------------------------------

def test_recalibrate_drops_every_executable():
    cfg, _, _, pp, _, pec = setup(True, collect_stats=True)
    eng = pt_engine.ServeEngine(cfg, pp, n_slots=2, max_seq=MAX_SEQ,
                                exec_cfg=pec, decode_block=4, device="cpu")
    uids = [eng.submit(p, max_new=4) for p in _prompts((5, 3))]
    first = eng.run_until_drained()
    assert eng._executables and eng._mask_cache
    old = eng.exec_cfg
    assert eng.maybe_recalibrate(drift_threshold=-1.0) is not None
    assert eng.exec_cfg is not old
    assert not eng._executables and not eng._mask_cache
    assert eng._carry is None
    again = [eng.submit(p, max_new=4) for p in _prompts((5, 3))]
    res = eng.run_until_drained()
    assert eng._executables
    assert [res[u] for u in again] == [first[u] for u in uids]


def _record_ref_warmup(ref):
    """The shapes the reference's ``warmup`` compiles: its four jitted
    entry points replaced by recorders that return the state unchanged."""
    seen = {"decode_many": set(), "step": set(), "verify": set(),
            "feed": set()}
    tier = {id(p): i for i, p in enumerate(ref._tier_params)}

    def decode_many(p, s, *args):
        seen["decode_many"].add((tier[id(p)], args[-1], False))
        return None, s, None, None, None

    def decode(p, *args):
        seen["step"].add((tier[id(p)], False))

    def verify(p, draft, s, *args):
        seen["verify"].add((tier[id(p)], args[-2], args[-1], False))
        return None, s, None, None, None

    def prefill(p, s, toks, *args):
        seen["feed"].add((len(toks),))
        return s
    ref._decode_many, ref._decode = decode_many, decode
    ref._verify, ref._prefill = verify, prefill
    ref.warmup()
    return seen


WARMUPS = {
    "whole-prompts": dict(decode_block=4),
    "chunk-2": dict(decode_block=16, prefill_chunk=2),
    "adaptive": dict(decode_block=8, adaptive=(4, 16)),
    "tiers-speculative": dict(decode_block=4, plan_tiers=(0.0, 0.5),
                              speculate_k=2),
}


@pytest.mark.parametrize("name", list(WARMUPS))
def test_warmup_prepares_the_reference_shapes(name):
    kw = WARMUPS[name]
    ref, port = _engines(**kw)
    seen = _record_ref_warmup(ref)
    before = {p: t.clone() for p, t in iter_leaves(port.state)}
    port.warmup()
    assert all(torch.equal(t, before[p]) for p, t in iter_leaves(port.state))
    got = {k: set() for k in seen}
    for key in port._executables:
        got[key[0]].add(key[1:])
    cap = port._feed_cap()
    assert cap == 1 << (kw["decode_block"].bit_length() - 1)
    want = dict(seen, feed={p for p in seen["feed"] if p[0] <= cap})
    assert got == want


def test_an_engine_is_freed_with_its_last_reference():
    """The entry points close over what they read, not over the engine, so
    no reference cycle keeps an engine (its graphs, state and weights on
    the card) alive until a garbage collection."""
    _, port = _engines(decode_block=4)
    port.submit(_prompts((5,))[0], max_new=3)
    port.run_until_drained()
    assert port._executables
    ref = weakref.ref(port)
    gc.disable()
    try:
        del port
        assert ref() is None
    finally:
        gc.enable()


def test_stats_reset_keeps_the_counters():
    col = ops.SparsityStatsCollector()
    col.record("mlp.in", torch.tensor(3), 8)
    acc = col._acc["mlp.in"]
    snap = col.snapshot()
    col.record("mlp.in", torch.tensor(1), 8)
    col.record("attn.qkv", torch.tensor(2), 4)
    col.restore(snap)
    assert col.densities() == {"mlp.in": 3 / 8}
    col.reset()
    assert col._acc["mlp.in"] is acc and col.densities() == {}
    col.record("mlp.in", torch.tensor(4), 8)
    assert col.densities() == {"mlp.in": 0.5}


def test_warm_run_leaves_the_densities():
    """A capture's warm run puts the popcounts back
    (``_model_scope(dead=True)``)."""
    cfg, _, _, pp, _, pec = setup(True, collect_stats=True)
    eng = pt_engine.ServeEngine(cfg, pp, n_slots=2, max_seq=MAX_SEQ,
                                exec_cfg=pec, decode_block=4, device="cpu")
    eng.submit(_prompts((5,))[0], max_new=3)
    eng.run_until_drained()
    dens = eng.activation_densities()
    assert dens
    for key in list(eng._executables):
        eng._executables[key].warm()
    assert eng.activation_densities() == dens
