"""The port's plan tiers and self-speculative decoding against the JAX
package's, on the same weights (the reference's init, converted).

Setup as the reference's ``tests/test_speculative.py``: the StableLM smoke
config (d_ff 256) with weight-only sparsity 0.5, float32 weights pruned at
(16, 16), 3 slots.  The tier metadata is compared at the decode table's
blocks and, where the smoke blocks hold one K-block per column, at (16, 16)
blocks too (up to 16 K-blocks per column, so every ratio prunes).

Tolerances: tier metadata (lists, counts, bitmaps, densities) and the
packed gather payload are exact.  The gathered dispatch sums the listed
blocks in another order than the reference's and the masked dense product:
float32 ``allclose`` at rtol 1e-5, atol 1e-6.  Logits of a verify window
agree with the reference's to 1e-5 and the states to float32 rounding;
inside the port, a window's logits equal the decode steps' bit for bit.
Token blocks and engine streams are compared token for token on pinned
seeds, and the rows a verify block must not touch bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import given, settings, strategies as st
from repro.core import sparsity as ref_sp
from repro.kernels import ops as ref_ops
from repro.models import model as ref_model
from repro.quant import quantize as ref_q
from repro.serve import engine as ref_engine
from repro.serve import faults as ref_faults
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.core import sparsity as pt_sp
from repro_torch.kernels import ops as pt_ops
from repro_torch.models import model as pt_model
from repro_torch.quant import quantize as pt_q
from repro_torch.serve import engine as pt_engine
from repro_torch.serve import faults as pt_faults
from test_torch_serve import ref_config

WEIGHT_ONLY = pt_base.SparsityConfig(weight_sparsity=0.5,
                                     activation_threshold=0.0)
TWO_SIDED = pt_base.SparsityConfig(weight_sparsity=0.5,
                                   activation_threshold=0.05)
N_SLOTS = 3
TOL = dict(rtol=1e-5, atol=1e-6)
_CACHE = {}


def _prune(leaf):
    """The reference test's pruner: (16, 16) blocks on every matrix."""
    if leaf.ndim >= 2 and leaf.shape[-1] >= 16 and leaf.shape[-2] >= 16:
        return ref_sp.prune_stacked_magnitude(leaf, 0.5,
                                              block=(16, 16)).astype(leaf.dtype)
    return leaf


def setup(sparsity=WEIGHT_ONLY, tied=False, d_ff=256):
    """(port cfg, ref cfg, ref params, port params, ref exec, port exec)."""
    key = (sparsity, tied, d_ff)
    if key not in _CACHE:
        cfg = dataclasses.replace(pt_base.get_smoke_config("stablelm-1.6b"),
                                  sparsity=sparsity, tie_embeddings=tied,
                                  **({"d_ff": d_ff} if d_ff else {}))
        rcfg = ref_config(cfg)
        rp = jax.tree.map(_prune, ref_model.init_params(
            rcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
        pp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
        rec = ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp)
        pec = pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                           device="cpu")
        _CACHE[key] = (cfg, rcfg, rp, pp, rec, pec)
    return _CACHE[key]


def _fine(ns):
    """``ns`` with every site's blocks at bk = bn = 16."""
    sites = {s: dataclasses.replace(d, schedule=dataclasses.replace(
        d.schedule, bk=16, bn=16)) for s, d in ns.sites.items()}
    return dataclasses.replace(ns, sites=sites)


def _trees(quantized):
    """(ref params, port params): the float trees, or both quantized."""
    _, _, rp, pp, _, _ = setup()
    if quantized:
        return (ref_q.quantize_params(rp, tie_embeddings=False)[0],
                pt_q.quantize_params(pp, tie_embeddings=False)[0])
    return rp, pp


def _planned(tree):
    """{path: PlannedWeight} of an attached port tree."""
    return {"/".join(k): v for k, v in pt_sp.iter_leaves(tree)
            if isinstance(v, pt_sp.PlannedWeight)}


def _ref_planned(tree):
    is_pw = lambda x: hasattr(x, "wkidx")       # noqa: E731
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree,
                                                          is_leaf=is_pw):
        if is_pw(leaf):
            out["/".join(str(getattr(k, "key", k)) for k in path)] = leaf
    return out


# ---------------------------------------------------------------------------
# tier metadata
# ---------------------------------------------------------------------------

def test_tier_max_live_and_prune_k_blocks_equal_the_reference():
    for tk in (1, 2, 3, 7, 16):
        for r in (0.0, 0.1, 0.25, 0.5, 0.75, 0.99):
            assert pt_sp.tier_max_live(tk, r) == ref_sp.tier_max_live(tk, r)
    rng = np.random.default_rng(0)
    for k, n, bk, bn, live in ((64, 48, 16, 16, 2), (70, 33, 16, 8, 3),
                               (128, 256, 32, 64, 1), (64, 64, 16, 16, 4)):
        w = rng.standard_normal((k, n)).astype(np.float32)
        w[16:32] = 0.0                          # tied (zero) norms
        np.testing.assert_array_equal(
            pt_sp.prune_k_blocks(w, bk, bn, live),
            ref_sp.prune_k_blocks(w, bk, bn, live))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("ratio", [0.0, 0.25, 0.5])
@pytest.mark.parametrize("fine", [False, True])
def test_tier_metadata_equals_the_reference(fine, ratio, quantized):
    _, _, _, _, rec, pec = setup()
    rp, pp = _trees(quantized)
    rns, pns = ((_fine(rec.schedules), _fine(pec.schedules)) if fine
                else (rec.schedules, pec.schedules))
    ref = ref_sp.compile_weight_plan(rp, rns, prune_ratio=ratio)
    port = pt_sp.compile_weight_plan(pp, pns, prune_ratio=ratio)
    assert port.prune_ratio == ref.prune_ratio == ratio
    assert set(port.entries) == set(ref.entries)
    for key, r in ref.entries.items():
        p = port.entries[key]
        assert (p.bm, p.bk, p.bn, p.tk, p.tn, p.max_nnz, p.prune_ratio) == \
            (r.bm, r.bk, r.bn, r.tk, r.tn, r.max_nnz, r.prune_ratio), key
        np.testing.assert_array_equal(p.wkidx, r.wkidx)
        np.testing.assert_array_equal(p.wkcnt, r.wkcnt)
        np.testing.assert_array_equal(p.b_bitmap, r.b_bitmap)
        assert p.wt_density == r.wt_density, key
        assert p.block_density == r.block_density, key


def test_tier_zero_is_bitwise_the_unpruned_plan():
    _, _, _, pp, _, pec = setup()
    tiers = pt_sp.compile_plan_tiers(pp, _fine(pec.schedules), (0.0, 0.5))
    base = pt_sp.compile_weight_plan(pp, _fine(pec.schedules))
    assert set(tiers[0].entries) == set(base.entries)
    for key, e in base.entries.items():
        t = tiers[0].entries[key]
        for f in dataclasses.fields(e):
            np.testing.assert_array_equal(getattr(t, f.name),
                                          getattr(e, f.name))


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6))
def test_tiers_are_monotone_live_subsets(seed):
    cfg, _, _, _, _, pec = setup()
    gen = torch.Generator().manual_seed(seed % 97)
    params = pt_sp.map_leaves(
        lambda _, leaf: pt_sp.prune_stacked_magnitude(leaf, 0.5, (16, 16)),
        pt_model.init_params(cfg, gen, dtype=torch.float32, device="cpu"))
    ratios = (0.0, 0.25, 0.5, 0.75)
    tiers = pt_sp.compile_plan_tiers(params, _fine(pec.schedules), ratios)
    for lo, hi in zip(tiers, tiers[1:]):
        for key in lo.entries:
            a, b = lo.entries[key], hi.entries[key]
            assert np.all(~b.b_bitmap | a.b_bitmap), key
            assert b.max_nnz <= a.max_nnz
            assert b.wt_density <= a.wt_density
    for t, r in zip(tiers, ratios):
        assert t.prune_ratio == r
        assert all(e.prune_ratio == r for e in t.entries.values())


def test_compile_plan_tiers_validates_ratios():
    _, _, _, pp, _, pec = setup()
    for bad in ((), (0.5, 0.25)):
        with pytest.raises(ValueError):
            pt_sp.compile_plan_tiers(pp, pec.schedules, ratios=bad)
    with pytest.raises(ValueError):
        pt_sp.compile_weight_plan(pp, pec.schedules, prune_ratio=1.0)


def test_attached_tiers_share_weight_leaves():
    _, _, _, pp, _, pec = setup()
    tiers = pt_sp.compile_plan_tiers(pp, _fine(pec.schedules), (0.0, 0.5))
    p0 = _planned(tiers[0].attach(pp, verify=True))
    p1 = _planned(tiers[1].attach(pp, verify=True))   # planned ⊆ live
    assert p0 and p0.keys() == p1.keys()
    for key in p0:
        assert p0[key].w is p1[key].w
        assert p0[key].w.data_ptr() == p1[key].w.data_ptr()
    # the inverted check still catches a tier from other weights
    other = pt_sp.map_leaves(
        lambda path, leaf: torch.zeros_like(leaf)
        if path[-1] == "w_out" else leaf, pp)
    with pytest.raises(ValueError, match="pruned-tier"):
        tiers[1].attach(other, verify=True)


@pytest.mark.parametrize("quantized", [False, True])
def test_gather_payload_equals_the_reference(quantized):
    _, _, _, _, rec, pec = setup()
    rp, pp = _trees(quantized)
    ref = ref_sp.compile_plan_tiers(rp, _fine(rec.schedules), (0.0, 0.5))
    port = pt_sp.compile_plan_tiers(pp, _fine(pec.schedules), (0.0, 0.5))
    for pw in _planned(port[0].attach(pp)).values():
        assert not pw.gather and pw.wgather is None
    got = _planned(port[1].attach(pp))
    want = _ref_planned(ref[1].attach(rp))
    assert got.keys() == want.keys() and got
    for key, pw in got.items():
        assert pw.gather
        assert pw.wgather.shape[-4:] == (pw.wkcnt.shape[-1], pw.max_nnz,
                                         pw.bk, pw.bn)
        assert pw.wgather.dtype == pw.w.dtype
        np.testing.assert_array_equal(pw.wgather.numpy(),
                                      np.asarray(want[key].wgather))


@pytest.mark.parametrize("quantized", [False, True])
def test_gathered_matmul_matches_reference_and_masked_dense(quantized):
    _, _, _, _, rec, pec = setup()
    rp, pp = _trees(quantized)
    port = pt_sp.compile_weight_plan(pp, _fine(pec.schedules),
                                     prune_ratio=0.5)
    ref = ref_sp.compile_weight_plan(rp, _fine(rec.schedules),
                                     prune_ratio=0.5)
    want_all = _ref_planned(ref.attach(rp))
    rng = np.random.default_rng(1)
    for key, pw in _planned(port.attach(pp)).items():
        rpw = want_all[key]
        if pw.w.dim() > 2:                       # layer 0 of a stack
            pw = pw.index(0)
            rpw = jax.tree.map(lambda a: a[0], rpw)
        k, n = pw.kn.shape
        x = rng.standard_normal((3, k)).astype(np.float32)
        mask = np.repeat(np.repeat(pw.b_bitmap.numpy(), pw.bk, 0),
                         pw.bn, 1)[:k, :n]
        dense = x @ (pw.w_kn.float().numpy() * mask)
        ref_out = np.asarray(ref_ops._gathered_planned_matmul(
            jnp.asarray(x), rpw))
        for cand in (pw, dataclasses.replace(pw, wgather=None)):
            got = pt_ops._gathered_planned_matmul(torch.from_numpy(x),
                                                  cand).numpy()
            np.testing.assert_allclose(got, ref_out, **TOL)
            np.testing.assert_allclose(got, dense, **TOL)
        # a CPU tensor reaches the gathered version through the dispatch
        np.testing.assert_array_equal(
            pt_ops.flex_matmul(torch.from_numpy(x), pw).numpy(),
            pt_ops._gathered_planned_matmul(torch.from_numpy(x),
                                            pw).numpy())


def test_off_cpu_tier_takes_the_kernel_route_and_refuses_inexact_blocks():
    """A gather leaf on any other device goes to the block-sparse kernel,
    never the gathered version; blocks the kernel cannot walk exactly
    (bk not a multiple of 64 or bn of 128, as at these smoke blocks) raise
    before any launch."""
    _, _, _, pp, _, pec = setup()
    tier = pt_sp.compile_weight_plan(pp, pec.schedules, prune_ratio=0.5)
    pw = _planned(tier.attach(pp))["stack/layers/mlp/w_out"].index(0)
    x = torch.empty((4, pw.kn.shape[0]), device="meta")
    with pytest.raises(ValueError, match="pruned plan tier"):
        pt_ops._planned_matmul(x, pw)


# ---------------------------------------------------------------------------
# verify window and verify block (model level)
# ---------------------------------------------------------------------------

def _tier_params():
    """(ref full, ref draft, port full, port draft) attached tier trees."""
    if "tiers" not in _CACHE:
        _, _, rp, pp, rec, pec = setup()
        ref = ref_sp.compile_plan_tiers(rp, rec.schedules, (0.0, 0.5))
        port = pt_sp.compile_plan_tiers(pp, pec.schedules, (0.0, 0.5))
        _CACHE["tiers"] = (ref[0].attach(rp), ref[1].attach(rp),
                           port[0].attach(pp), port[1].attach(pp))
    return _CACHE["tiers"]


def _states(b, seed, steps=3):
    """Equal (ref, port) states after ``steps`` greedy full-plan decode
    steps from random tokens (the port's state copied from the reference's,
    so both start from the same bits), and the token / position carries.
    The port's state is a fresh copy at each call."""
    key = ("states", b, seed)
    if key not in _CACHE:
        _CACHE[key] = _decoded_state(b, seed, steps)
    state, port, tok, pos = _CACHE[key]
    return (state, {"layers": {n: t.clone() for n, t in
                               port["layers"].items()}}, tok, pos)


def _decoded_state(b, seed, steps):
    cfg, rcfg, _, _, _, _ = setup()
    rf, _, _, _ = _tier_params()
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab - 1, b).astype(np.int32)
    state = ref_model.init_decode_state(rcfg, b, 32, dtype=jnp.float32)
    _, state, tok, pos, _ = ref_model.decode_many(
        rf, rcfg, jnp.asarray(toks), state, jnp.zeros((b,), jnp.int32),
        jnp.ones((b,), bool), steps)
    port = params_from_numpy(jax.tree.map(np.asarray, state), device="cpu")
    return state, port, np.asarray(tok), np.asarray(pos)


def _np_state(s):
    return {n: np.asarray(s["layers"][n]) for n in ("k", "v")}


def test_verify_window_matches_reference_and_the_decode_steps():
    cfg, rcfg, _, _, _, _ = setup()
    rf, _, pf, _ = _tier_params()
    b, w = 3, 5
    rst, pst, _, pos = _states(b, seed=0)
    win = np.random.default_rng(3).integers(1, cfg.vocab - 1, (b, w))
    active = np.asarray([True, True, False])
    act = torch.from_numpy(active)
    rlg, rst = ref_model.verify_window(rf, rcfg, jnp.asarray(win, jnp.int32),
                                       rst, jnp.asarray(pos),
                                       jnp.asarray(active))
    before = {n: t.clone() for n, t in pst["layers"].items()}
    with torch.no_grad():
        lg, pst = pt_model.verify_window(
            pf, cfg, torch.from_numpy(win.copy()), pst, torch.from_numpy(pos).long(),
            torch.from_numpy(active))
    np.testing.assert_allclose(lg[act].numpy(), np.asarray(rlg)[active],
                               rtol=1e-5, atol=1e-5)
    for n, arr in _np_state(rst).items():
        np.testing.assert_allclose(pst["layers"][n].numpy(), arr, **TOL)
    assert torch.equal(pst["layers"]["k"][:, 2], before["k"][:, 2])
    # each window position's logits are a masked decode step's, bit for bit
    steps = {n: t.clone() for n, t in before.items()}
    sst = {"layers": steps}
    with torch.no_grad():
        for i in range(w):
            lg_i, sst = pt_model.masked_decode_step(
                pf, cfg, torch.from_numpy(win[:, i:i + 1]), sst,
                torch.from_numpy(pos).long() + i, act)
            assert torch.equal(lg_i[act, 0], lg[act, i]), i
    for n in ("k", "v"):
        assert torch.equal(sst["layers"][n], pst["layers"][n])


def _prefix_check(emitted, oracle):
    for r in range(emitted.shape[1]):
        col = emitted[:, r]
        n = int((col >= 0).sum())
        assert np.all(col[:n] >= 0), f"row {r}: sentinel not a suffix"
        np.testing.assert_array_equal(col[:n], oracle[:n, r])


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("sampled", [False, True])
def test_verify_block_matches_reference(sampled, windowed):
    """Rows: live with budget, live stopping inside the window, live with
    no budget left (its state must stay as it was: the draft wrote there)
    and dead."""
    cfg, rcfg, _, _, _, _ = setup()
    rf, rd, pf, pd = _tier_params()
    b, k = 4, 4
    rst, pst, tok, pos = _states(b, seed=5)
    live = np.asarray([True, True, True, False])
    rem = np.asarray([9, 2, 0, 9], np.int32)
    samp = {}
    if sampled:
        samp = dict(temp=np.asarray([0.8, 0.0, 1.0, 0.7], np.float32),
                    top_k=np.asarray([20, 0, 5, 0], np.int64),
                    seeds=np.asarray([1, 2, 3, 4], np.int64))
    rout = ref_model.verify_block(
        rf, rd, rcfg, jnp.asarray(tok), rst, jnp.asarray(pos),
        jnp.asarray(live), k, rem=jnp.asarray(rem), eos_id=5,
        windowed=windowed,
        **{n: jnp.asarray(a if n == "temp" else a.astype(np.int32))
           for n, a in samp.items()})
    targs = {n: torch.from_numpy(a) for n, a in samp.items()}
    before = {n: t.clone() for n, t in pst["layers"].items()}
    oracle_state = {"layers": {n: t.clone() for n, t in before.items()}}
    with torch.no_grad():
        pout = pt_model.verify_block(
            pf, pd, cfg, torch.from_numpy(tok), pst,
            torch.from_numpy(pos).long(), torch.from_numpy(live), k,
            rem=torch.from_numpy(rem), eos_id=5, windowed=windowed, **targs)
        oracle, *_ = pt_model.decode_many(
            pf, cfg, torch.from_numpy(tok), oracle_state,
            torch.from_numpy(pos).long(), torch.from_numpy(live), k + 1,
            rem=torch.from_numpy(rem), eos_id=5, **targs)
    np.testing.assert_array_equal(pout[0].numpy(), np.asarray(rout[0]))
    _prefix_check(pout[0].numpy(), oracle.numpy())
    for got, want in zip(pout[2:], rout[2:]):        # tok, pos, rem carries
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for n, arr in _np_state(rout[1]).items():
        np.testing.assert_allclose(pout[1]["layers"][n].numpy(), arr, **TOL)
        for r in (2, 3):
            assert torch.equal(pout[1]["layers"][n][:, r], before[n][:, r])


def test_verify_block_self_draft_accepts_everything():
    cfg, _, _, _, _, _ = setup()
    _, _, pf, _ = _tier_params()
    b, k = 3, 3
    _, pst, tok, pos = _states(b, seed=7)
    other = {"layers": {n: t.clone() for n, t in pst["layers"].items()}}
    toks, ps = torch.from_numpy(tok), torch.from_numpy(pos).long()
    live = torch.ones(b, dtype=torch.bool)
    with torch.no_grad():
        emitted, state, ptok, pps, _ = pt_model.verify_block(
            pf, pf, cfg, toks, pst, ps, live, k)
        oracle, ostate, otok, ops_, _ = pt_model.decode_many(
            pf, cfg, toks, other, ps, live, k + 1)
    assert torch.equal(emitted, oracle)
    assert torch.equal(ptok, otok) and torch.equal(pps, ops_)
    for n in ("k", "v"):
        assert torch.equal(state["layers"][n], ostate["layers"][n])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _serve(mod, cfg, params, ec, prompts, *, sampled=(), max_new=10,
           stagger=None, **kw):
    """Submit ``prompts`` (the ones at ``sampled`` indices with sampling)
    and drain; with ``stagger`` (a numpy generator) interleave submits
    with ``decode_block_step`` ticks and random flushes.  Returns (engine,
    {uid: tokens})."""
    kw.setdefault("n_slots", N_SLOTS)
    kw.setdefault("eos_id", 5)
    extra = {"device": "cpu"} if mod is pt_engine else {}
    eng = mod.ServeEngine(cfg, params, max_seq=48, exec_cfg=ec,
                          decode_block=8, **extra, **kw)

    def submit(j):
        sp = (mod.SamplingParams(temperature=0.8, top_k=20, seed=j)
              if j in sampled else None)
        eng.submit(prompts[j], max_new=max_new, sampling=sp)

    if stagger is None:
        for j in range(len(prompts)):
            submit(j)
        return eng, eng.run_until_drained()
    out, j = {}, 0
    while j < len(prompts) or not eng._drained() or eng._inflight:
        if j < len(prompts) and stagger.random() < 0.6:
            submit(j)
            j += 1
        for uid, toks in eng.decode_block_step().items():
            out.setdefault(uid, []).extend(toks)
        if stagger.random() < 0.2:
            for uid, toks in eng.flush().items():
                out.setdefault(uid, []).extend(toks)
    return eng, out


def _prompts(cfg, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab - 1, size=rng.integers(lo, hi))
            .astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("family", ["dense", "quant", "tied"])
def test_speculative_streams_equal_reference_and_oracle(family):
    cfg, rcfg, rp, pp, _, _ = setup(tied=family == "tied", d_ff=None)
    q = family == "quant"
    rec = ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp, quantize=q)
    pec = pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp, quantize=q,
                                       device="cpu")
    prompts = _prompts(cfg, 5, 1, 7, {"dense": 11, "quant": 12,
                                      "tied": 13}[family])
    tiers = dict(plan_tiers=(0.0, 0.5), speculate_k=3, quantize=q)
    es, spec = _serve(pt_engine, cfg, pp, pec, prompts, sampled=(1, 3),
                      **tiers)
    _, oracle = _serve(pt_engine, cfg, pp, pec, prompts, sampled=(1, 3),
                       fused=False, quantize=q)
    er, ref = _serve(ref_engine, rcfg, rp, rec, prompts, sampled=(1, 3),
                     **tiers)
    assert spec == oracle == ref
    assert es.spec_stats["verify_blocks"] > 0
    assert es.spec_stats == er.spec_stats
    assert es.health()["spec"] == es.spec_stats


def test_two_sided_config_disables_speculation():
    cfg, _, _, pp, _, pec = setup(TWO_SIDED)
    prompts = _prompts(cfg, 6, 3, 9, 7)
    es, spec = _serve(pt_engine, cfg, pp, pec, prompts,
                      plan_tiers=(0.0, 0.5), speculate_k=3)
    _, oracle = _serve(pt_engine, cfg, pp, pec, prompts, fused=False)
    assert not es._spec_windowed
    assert es.spec_stats["verify_blocks"] == 0
    assert spec == oracle


def test_speculative_staggered_arrivals_equal_the_oracle():
    cfg, _, _, pp, _, pec = setup()
    prompts = _prompts(cfg, 6, 1, 9, 21)
    _, oracle = _serve(pt_engine, cfg, pp, pec, prompts, sampled=(2,),
                       fused=False)
    es, spec = _serve(pt_engine, cfg, pp, pec, prompts, sampled=(2,),
                      stagger=np.random.default_rng(22),
                      plan_tiers=(0.0, 0.5), speculate_k=3)
    assert spec == oracle
    assert es.spec_stats["verify_blocks"] > 0


def test_self_draft_engine_accepts_everything():
    """One tier, drafting on the full plan: every draft is accepted.  No
    EOS and budgets of two windows of k + 1 keep rows from stopping inside
    a window (a stop reads as a rejection in the counts)."""
    cfg, _, _, pp, _, pec = setup()
    prompts = _prompts(cfg, 4, 4, 5, 2)
    eng, out = _serve(pt_engine, cfg, pp, pec, prompts, sampled=(1,),
                      max_new=8, n_slots=4, eos_id=None, speculate_k=3)
    _, oracle = _serve(pt_engine, cfg, pp, pec, prompts, sampled=(1,),
                       max_new=8, n_slots=4, eos_id=None, fused=False)
    assert out == oracle
    assert eng.spec_stats["drafted"] > 0
    assert eng.speculative_acceptance() == 1.0
    assert (eng.spec_slot_stats[:, 0] == eng.spec_slot_stats[:, 1]).all()


def test_verify_blocks_drain_on_occupancy_change():
    cfg, _, _, pp, _, pec = setup()
    prompts = _prompts(cfg, 5, 2, 3, 4)

    def run(**kw):
        eng = pt_engine.ServeEngine(cfg, pp, n_slots=2, max_seq=48,
                                    exec_cfg=pec, decode_block=8,
                                    eos_id=None, device="cpu", **kw)
        for j, p in enumerate(prompts):
            eng.submit(p, max_new=3 + 4 * j)
        out = eng.run_until_drained()
        assert not eng._inflight
        return eng, out

    eng, out = run(plan_tiers=(0.0, 0.5), speculate_k=3)
    _, oracle = run(fused=False)
    assert out == oracle
    assert eng.spec_stats["verify_blocks"] > 0


def test_latency_class_routes_to_the_pruned_tier():
    """A class-1 request decodes under tier 1: its stream equals an engine
    whose only plan is that tier (a 1-token prompt: admission prefills
    under the full plan).  Class 0 stays on the full plan, and a class
    past the tier count is clamped to the last tier."""
    cfg, _, _, pp, _, pec = setup()
    tier1 = pt_sp.compile_weight_plan(pp, pec.schedules, prune_ratio=0.5)
    prompt = np.asarray([11], np.int32)

    def run(ec, cls=0, **kw):
        eng = pt_engine.ServeEngine(cfg, pp, n_slots=2, max_seq=48,
                                    exec_cfg=ec, device="cpu", **kw)
        eng.submit(prompt, max_new=8, latency_class=cls)
        return list(eng.run_until_drained().values())

    pruned = run(dataclasses.replace(pec, plan=tier1), verify_plan=False)
    full = run(pec)
    assert pruned != full
    assert run(pec, 1, plan_tiers=(0.0, 0.5)) == pruned
    assert run(pec, 5, plan_tiers=(0.0, 0.5)) == pruned
    assert run(pec, 0, plan_tiers=(0.0, 0.5)) == full


def test_deadline_demotion_matches_the_reference():
    """Under a ``VirtualClock`` that advances between ticks, the requests
    whose deadlines the service rate cannot meet are demoted one class per
    tick, as the reference demotes them: counters, classes and streams
    equal."""
    cfg, rcfg, rp, pp, rec, pec = setup()
    prompts = _prompts(cfg, 3, 2, 4, 9)
    runs = []
    for mod, faults, c, p, ec in ((ref_engine, ref_faults, rcfg, rp, rec),
                                  (pt_engine, pt_faults, cfg, pp, pec)):
        clock = faults.VirtualClock()
        extra = {"device": "cpu"} if mod is pt_engine else {}
        eng = mod.ServeEngine(c, p, n_slots=2, max_seq=48, exec_cfg=ec,
                              decode_block=2, eos_id=None, clock=clock,
                              plan_tiers=(0.0, 0.25, 0.5), **extra)
        uids = [eng.submit(pr, max_new=12, deadline=d)
                for pr, d in zip(prompts, (5.0, 40.0, None))]
        out = {}
        for _ in range(40):
            for uid, toks in eng.decode_block_step().items():
                out.setdefault(uid, []).extend(toks)
            clock.advance(1.0)
            if eng._drained() and not eng._inflight:
                break
        for uid, toks in eng.flush().items():
            out.setdefault(uid, []).extend(toks)
        runs.append((dict(eng.counters), {u: eng.status(u) for u in uids},
                     out, eng.health()["counters"]))
    assert runs[0] == runs[1]
    assert runs[1][0]["demotions"] > 0


def test_priority_admission_is_schedule_invariant():
    cfg, _, _, pp, _, pec = setup()
    prompts = _prompts(cfg, 6, 1, 6, 5)

    def run(pol):
        eng = pt_engine.ServeEngine(cfg, pp, n_slots=2, max_seq=48,
                                    exec_cfg=pec, decode_block=8, eos_id=5,
                                    admission=pol, plan_tiers=(0.0, 0.5),
                                    speculate_k=3, device="cpu")
        for j, p in enumerate(prompts):
            eng.submit(p, max_new=8, priority=len(prompts) - j)
        return eng.run_until_drained()

    assert run(pt_engine.FIFOAdmission()) == \
        run(pt_engine.PriorityAdmission())


def test_maybe_recalibrate_rebuilds_the_tiers():
    cfg, _, _, pp, _, _ = setup(TWO_SIDED)
    ec = pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                      collect_stats=True, device="cpu")
    eng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=48,
                                exec_cfg=ec, decode_block=8,
                                plan_tiers=(0.0, 0.5), speculate_k=2,
                                device="cpu")
    eng.submit(np.asarray([3, 7, 11], np.int32), max_new=4)
    eng.run_until_drained()
    assert eng.maybe_recalibrate(drift_threshold=-1.0) is not None
    assert len(eng.plan_tiers) == 2 and len(eng._tier_params) == 2
    assert eng.plan_tiers[1].prune_ratio == 0.5
    uid = eng.submit(np.asarray([5, 9], np.int32), max_new=6)
    out = eng.run_until_drained()
    ref = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=48,
                                exec_cfg=eng.exec_cfg, fused=False,
                                device="cpu")
    ref.submit(np.asarray([5, 9], np.int32), max_new=6)
    assert out[uid] == list(ref.run_until_drained().values())[0]


def test_warmup_leaves_the_state_bit_for_bit():
    cfg, _, _, pp, _, pec = setup()
    eng = pt_engine.ServeEngine(cfg, pp, n_slots=2, max_seq=16,
                                exec_cfg=pec, decode_block=4,
                                plan_tiers=(0.0, 0.5), speculate_k=2,
                                device="cpu")
    eng.submit(np.asarray([3, 4, 5], np.int32), max_new=2)
    eng.run_until_drained()
    before = {n: t.clone() for n, t in eng.state["layers"].items()}
    eng.warmup()
    for n, t in eng.state["layers"].items():
        assert torch.equal(t, before[n])
    eng.submit(np.asarray([3], np.int32), max_new=4)
    assert eng.run_until_drained()


@pytest.mark.parametrize("bad", [dict(plan_tiers=(0.5, 0.0)),
                                 dict(plan_tiers=(0.25,)),
                                 dict(plan_tiers=(0.0, 0.5, 0.25)),
                                 dict(speculate_k=-1),
                                 dict(plan_tiers=(0.0, 0.5), planned=False)])
def test_engine_validates_tier_args_as_the_reference(bad):
    cfg, rcfg, rp, pp, rec, pec = setup()
    bad = dict(bad)
    planned = bad.pop("planned", True)
    errors = []
    for mod, c, p, ec, extra in ((ref_engine, rcfg, rp, rec, {}),
                                 (pt_engine, cfg, pp, pec,
                                  {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            mod.ServeEngine(c, p, exec_cfg=ec if planned else None,
                            **bad, **extra)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
