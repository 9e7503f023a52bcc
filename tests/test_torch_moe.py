"""The port's MoE family (``models/moe.py``, the expert dispatch of
``kernels/ops.py``, 4-D plans and int8 leaves, the MoE stack and engine)
against the JAX package's, on numpy-seeded inputs and the
``deepseek-moe-16b`` smoke config (2 layers: 1 dense, 1 MoE; d 64, 8
experts, top-2, 1 shared).

Tolerances, stated per comparison:
  * routing indices, capacities, dispatch indices and validity, 4-D plan
    and tier metadata (``wkidx``, ``wkcnt``, ``b_bitmap``, ``max_nnz``,
    the per-expert stats), int8 payloads and scales: exactly equal;
  * router gates: rtol 1e-6 (both softmaxes are float32, with exp
    implementations that differ in the last ulp);
  * float32 layer and matmul outputs: rtol = atol = 1e-5 (the same float32
    products summed in another order), 2e-4 absolute against the one-hot
    oracle, which contracts through extra (zero) terms;
  * bf16 layer outputs: 2⁻⁶ relative to max |y|, two bf16 ulps of the
    largest element: XLA's and torch's silu round differently in the last
    bf16 bit, and such a difference in the gated hidden values passes
    through the output contraction (bf16 matmul outputs: 2⁻⁷, one ulp);
  * greedy engine streams: token for token; logits atol = rtol = 1e-4.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import base as ref_base
from repro.core import sparsity as ref_sp
from repro.kernels import ops as ref_ops
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.quant import quantize as ref_q
from repro.serve import engine as ref_engine
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.core import sparsity as pt_sp
from repro_torch.core.scheduler import MatmulSchedule
from repro_torch.core import stacks as pt_stacks
from repro_torch.kernels import block_sparse as pt_bs
from repro_torch.kernels import build
from repro_torch.kernels import flex_matmul as pt_fm
from repro_torch.kernels import ops as pt_ops
from repro_torch.models import model as pt_model
from repro_torch.models import moe as pt_moe
from repro_torch.models import transformer as pt_tr
from repro_torch.quant import quantize as pt_q
from repro_torch.serve import engine as pt_engine

ARCH = "deepseek-moe-16b"
SPARSE = pt_base.SparsityConfig(weight_sparsity=0.5,
                                activation_threshold=0.05)
N_SLOTS, MAX_SEQ = 2, 32
TOL = dict(rtol=1e-5, atol=1e-5)


def ref_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, cls in (("moe", ref_base.MoEConfig), ("ssm", ref_base.SSMConfig),
                      ("rglru", ref_base.RGLRUConfig),
                      ("sparsity", ref_base.SparsityConfig)):
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return ref_base.ArchConfig(**kw)


def smoke(cf=None, sparse=False):
    cfg = pt_base.get_smoke_config(ARCH)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    if sparse:
        cfg = dataclasses.replace(cfg, sparsity=SPARSE)
    return cfg


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, np.float32)).astype(dtype)


def moe_params(cfg, dtype, seed=0):
    """(reference MoE params, the port's converted copy)."""
    rp = ref_moe.init_moe(ref_config(cfg), jax.random.PRNGKey(seed),
                          dtype=dtype)
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")


# ---------------------------------------------------------------------------
# routing and dispatch primitives: exactly equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_equals_reference_ties_included(dtype):
    rng = np.random.default_rng(0)
    d, e, t, k = 64, 8, 24, 2
    router = rng.normal(size=(d, e)).astype(np.float32) * d ** -0.5
    router[:, 5] = router[:, 2]          # experts 2 and 5 always tie
    router[:, 7] = router[:, 0]
    xt = rng.normal(size=(t, d)).astype(np.float32)
    rg, ri = ref_moe._route(jnp.asarray(router),
                            _j(xt, getattr(jnp, dtype)), k)
    pg, pi = pt_moe._route(torch.from_numpy(router),
                           _t(xt, getattr(torch, dtype)), k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=1e-6)
    # a tie keeps the lower index first
    assert np.any((pi.numpy() == 2).any(1) | (pi.numpy() == 0).any(1))
    assert not np.any((pi[:, 0] == 5).numpy() | (pi[:, 0] == 7).numpy())


@pytest.mark.parametrize("tokens,k,bins,cf", [
    (4, 6, 64, 1.25), (16, 6, 64, 1.25), (136, 6, 64, 1.25), (1, 1, 16, 1.0),
    (32, 2, 8, 8.0), (32, 2, 8, 0.5), (3, 2, 8, 1.25), (8, 1, 1, 1.25)])
def test_capacity_equals_reference(tokens, k, bins, cf):
    assert (pt_moe._capacity(tokens, k, bins, cf)
            == ref_moe._capacity(tokens, k, bins, cf))


@settings(deadline=None, max_examples=40)
@given(st.lists(st.integers(0, 5), min_size=1, max_size=40),
       st.integers(1, 6))
def test_dispatch_indices_equal_reference(fid, capacity):
    """Bins 0-4, id 5 a sentinel: indices and validity exactly equal."""
    fid = np.asarray(fid, np.int32)
    rs, rv = ref_moe._dispatch_indices(jnp.asarray(fid), 5, capacity)
    ps, pv = pt_moe._dispatch_indices(torch.from_numpy(fid), 5, capacity)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))


def test_dispatch_first_come_and_sentinels():
    """The reference's own examples (tests/test_moe.py)."""
    f_sel, valid = pt_moe._dispatch_indices(
        torch.tensor([1, 0, 1, 1, 2, 0]), 3, 2)
    assert f_sel[0].tolist() == [1, 5] and f_sel[1].tolist()[:2] == [0, 2]
    assert bool(valid[1, 1]) and not bool(valid[2, 1])
    f_sel, valid = pt_moe._dispatch_indices(torch.tensor([3, 3, 1, 3]), 3, 4)
    assert int(valid.sum()) == 1 and int(f_sel[1, 0]) == 2


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no-drops", "drops"])
def test_top_k_gating_equals_reference(cf):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(32, 8)).astype(np.float32)
    cap = ref_moe._capacity(32, 2, 8, cf)
    rd, rc = ref_moe._top_k_gating(jnp.asarray(logits), 2, cap)
    pd, pc = pt_moe._top_k_gating(torch.from_numpy(logits), 2, cap)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), rtol=1e-6)


# ---------------------------------------------------------------------------
# the MoE layer: sort-based path against the reference and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no-drops", "drops"])
def test_apply_moe_matches_reference_and_gshard(cf, dtype):
    cfg = smoke(cf)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    rp, pp = moe_params(cfg, jd)
    x = np.random.default_rng(2).normal(size=(2, 16, cfg.d_model))
    y_ref = _np(ref_moe.apply_moe(rp, ref_config(cfg), _j(x, jd)))
    y = pt_moe.apply_moe(pp, cfg, _t(x, td))
    y_oracle = pt_moe.apply_moe_gshard(pp, cfg, _t(x, td))
    assert y.dtype == td and y.shape == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(y), y_ref, **TOL)
        np.testing.assert_allclose(_np(y), _np(y_oracle), rtol=1e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(
            _np(y_oracle),
            _np(ref_moe.apply_moe_gshard(rp, ref_config(cfg), _j(x))),
            rtol=1e-4, atol=2e-4)
    else:
        bar = 2.0 ** -6 * np.abs(y_ref).max()
        assert np.abs(_np(y) - y_ref).max() <= bar
        assert np.abs(_np(y) - _np(y_oracle)).max() <= 2 * bar


def test_combine_rounds_once_in_float32():
    """The bf16 combine equals the reference's fused one bit for bit."""
    rng = np.random.default_rng(3)
    t, k, d = 16, 6, 128
    out = rng.normal(size=(t * k, d)).astype(np.float32)
    g = rng.random(size=(t, k)).astype(np.float32)
    want = jax.jit(lambda o, g: (o.reshape(t, k, d) * g[..., None].astype(
        o.dtype)).sum(axis=1))(_j(out, jnp.bfloat16), jnp.asarray(g))
    got = pt_moe._combine(_t(out, torch.bfloat16), torch.from_numpy(g), t,
                          k, torch.bfloat16)
    np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# flex_expert_matmul: the four routes
# ---------------------------------------------------------------------------

def _expert_operands(seed=4, e=4, c=8, k=64, n=48):
    rng = np.random.default_rng(seed)
    w = np.stack([ref_sp.prune_k_blocks(
        rng.normal(size=(k, n)).astype(np.float32), 16, 16, 2)
        for _ in range(e)])
    x = rng.normal(size=(e, c, k)).astype(np.float32)
    return np.where(np.abs(x) > 0.6, x, 0.0).astype(np.float32), w


@pytest.mark.parametrize("mode", ["weight", "two_sided"])
def test_planned_expert_route_equals_reference(mode):
    x, w = _expert_operands()
    rpw = ref_sp.plan_weight(w, site="moe.experts_in", mode=mode, bm=8,
                             bk=16, bn=16)
    ppw = pt_sp.plan_weight(torch.from_numpy(w), site="moe.experts_in",
                            mode=mode, bm=8, bk=16, bn=16)
    assert ppw.max_nnz == rpw.max_nnz < ppw.tk
    for a in ("wkidx", "wkcnt", "b_bitmap"):
        np.testing.assert_array_equal(getattr(ppw, a).numpy(),
                                      np.asarray(getattr(rpw, a)))
    ec = ref_engine.decode_exec_config(ref_config(smoke(sparse=True)), 8)
    with ref_ops.exec_config(ec):
        want = ref_ops.flex_expert_matmul(jnp.asarray(x), rpw,
                                          site="moe.experts_in")
    with ref_ops.exec_config(ref_ops.ExecConfig(use_pallas=True,
                                                interpret=True)):
        pallas = ref_ops.flex_expert_matmul(jnp.asarray(x), rpw,
                                            site="moe.experts_in")
    got = pt_ops.flex_expert_matmul(torch.from_numpy(x), ppw,
                                    site="moe.experts_in")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.einsum("eck,ekn->ecn", x, w),
                               rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("mode", ["weight", "two_sided"])
def test_trace_time_expert_route_equals_reference_and_plan(mode):
    """Metadata built from the operands, every expert at once: the
    reference's result, and the planned route's bit for bit."""
    x, w = _expert_operands(seed=5)
    cfg = smoke(sparse=True)
    if mode == "weight":
        cfg = dataclasses.replace(cfg, sparsity=pt_base.SparsityConfig(
            weight_sparsity=0.5))
    rec = ref_engine.decode_exec_config(ref_config(cfg), 8)
    pec = pt_engine.decode_exec_config(cfg, 8, device="cpu")
    assert pec.schedules.sites["moe.experts_in"].sparsity_mode == mode
    with ref_ops.exec_config(rec):
        want = ref_ops.flex_expert_matmul(jnp.asarray(x), jnp.asarray(w),
                                          site="moe.experts_in")
    with pt_ops.exec_config(pec):
        got = pt_ops.flex_expert_matmul(torch.from_numpy(x),
                                        torch.from_numpy(w),
                                        site="moe.experts_in")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    sched = pec.schedules.sites["moe.experts_in"].schedule
    ppw = pt_sp.plan_weight(torch.from_numpy(w), site="moe.experts_in",
                            mode=mode, bm=min(sched.bm, 8),
                            bk=min(sched.bk, 64), bn=min(sched.bn, 48))
    planned = pt_ops.flex_expert_matmul(torch.from_numpy(x), ppw)
    assert torch.equal(planned, got)


def test_dense_expert_route_equals_pallas_reference():
    """``use_kernels`` dense sites against the reference's Pallas kernel
    per expert (interpret mode)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 8, 64)).astype(np.float32)
    w = rng.normal(size=(3, 64, 32)).astype(np.float32)
    cfg = smoke()
    rec = ref_engine.decode_exec_config(ref_config(cfg), 8, use_pallas=True,
                                        interpret=True)
    pec = pt_engine.decode_exec_config(cfg, 8, use_kernels=True,
                                       device="cpu")
    assert pec.schedules.sites["moe.experts_in"].sparsity_mode == "dense"
    with ref_ops.exec_config(rec):
        want = ref_ops.flex_expert_matmul(jnp.asarray(x), jnp.asarray(w),
                                          site="moe.experts_in")
    with pt_ops.exec_config(pec):
        got = pt_ops.flex_expert_matmul(torch.from_numpy(x),
                                        torch.from_numpy(w),
                                        site="moe.experts_in")
    plain = pt_ops.flex_expert_matmul(torch.from_numpy(x),
                                      torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unplanned_int8_expert_route_dequantizes_first(dtype):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 2, 64)).astype(np.float32)
    w = rng.normal(size=(4, 64, 48)).astype(np.float32)
    rq = jax.vmap(ref_q.quantize_weight)(jnp.asarray(w))
    pq = pt_q.quantize_weight(torch.from_numpy(w))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_ops.flex_expert_matmul(_j(x, jd), rq, site="moe.experts_in")
    got = pt_ops.flex_expert_matmul(_t(x, td), pq, site="moe.experts_in")
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    else:
        assert np.abs(_np(got) - _np(want)).max() <= \
            2.0 ** -7 * np.abs(_np(want)).max()


def test_planned_int8_expert_route_equals_dequantized_product():
    x, w = _expert_operands(seed=8)
    pq = pt_q.quantize_weight(torch.from_numpy(w))
    ppw = pt_sp.plan_weight(pq, site="moe.experts_gate", mode="two_sided",
                            bm=8, bk=16, bn=16)
    rpw = ref_sp.plan_weight(jax.vmap(ref_q.quantize_weight)(jnp.asarray(w)),
                             site="moe.experts_gate", mode="two_sided",
                             bm=8, bk=16, bn=16)
    np.testing.assert_array_equal(ppw.wkidx.numpy(), np.asarray(rpw.wkidx))
    got = pt_ops.flex_expert_matmul(torch.from_numpy(x), ppw)
    want = ref_ops.flex_expert_matmul(jnp.asarray(x), rpw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_expert_kernel_wrappers_take_the_plain_version_on_cpu():
    """The wrappers over a leading expert axis on CPU tensors: the 2-D
    plain versions per expert, rows and scales honoured; operands of
    differing expert counts are refused."""
    x, w = _expert_operands(seed=9, c=4)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    pw = pt_sp.plan_weight(wt, mode="two_sided", bm=4, bk=16, bn=16)
    xp, wp, meta, scale = pt_ops.planned_operands(xt, pw)
    assert scale is None and meta.kidx.shape[:2] == (4, 1)
    out = pt_bs.block_sparse_matmul(xp, wp, meta, rows=3)
    assert out.shape == (4, 3, 48)
    for e in range(4):
        one = pt_bs.block_sparse_matmul(
            xp[e], wp[e], pt_sp.build_block_sparse_meta(
                meta.a_bitmap[e], meta.b_bitmap[e], meta.max_nnz), rows=3)
        assert torch.equal(out[e], one)
    with pytest.raises(ValueError):
        pt_bs.block_sparse_matmul(xp[:2], wp, meta)


@pytest.mark.parametrize("blocks", [(4, 16, 16), (3, 20, 24)])
def test_flex_matmul_over_experts_is_the_2d_call_per_expert_on_cpu(blocks):
    """``kernels.flex_matmul`` over a leading expert axis equals the 2-D
    call per expert bit for bit (ragged blocks padded alike) and refuses
    operands whose expert counts differ."""
    x, w = _expert_operands(seed=11, c=4)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    sched = MatmulSchedule("output", *blocks)
    out = pt_fm.flex_matmul(xt, wt, schedule=sched)
    assert out.shape == (4, 4, 48)
    for e in range(4):
        assert torch.equal(out[e], pt_fm.flex_matmul(xt[e], wt[e],
                                                     schedule=sched))
    with pytest.raises(ValueError):
        pt_fm.flex_matmul(xt[:2], wt, schedule=sched)


def test_record_act_stats_counts_every_expert_row():
    x, w = _expert_operands(seed=10)
    pw = pt_sp.plan_weight(torch.from_numpy(w), site="moe.experts_in",
                           mode="two_sided", bm=8, bk=16, bn=16)
    col = pt_ops.SparsityStatsCollector()
    rows = torch.tensor([True, False, True, False])   # as many as experts
    with pt_ops.sparsity_stats(col), pt_ops.active_rows(rows):
        pt_ops.flex_expert_matmul(torch.from_numpy(x), pw)
    assert col.densities()["moe.experts_in"] == pytest.approx(
        float((x != 0).mean()))


# ---------------------------------------------------------------------------
# the 4-D plan layer and int8 leaves
# ---------------------------------------------------------------------------

_TREES = {}


def trees(quantize=False, dtype=jnp.float32):
    """(cfg, ref cfg, ref params, port params), pruned at (16, 16) by the
    reference's pruner (smoke config, sparse)."""
    key = (quantize, dtype)
    if key not in _TREES:
        cfg = smoke(sparse=True)
        rcfg = ref_config(cfg)
        rp = ref_model.init_params(rcfg, jax.random.PRNGKey(0), dtype=dtype)
        rp = jax.tree.map(
            lambda leaf: ref_sp.prune_stacked_magnitude(leaf, 0.5, (16, 16)),
            rp)
        pp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
        _TREES[key] = (cfg, rcfg, rp, pp)
    return _TREES[key]


@pytest.mark.parametrize("ratio", [0.0, 0.5])
@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_4d_plan_and_tier_metadata_equal_reference(quantize, ratio):
    cfg, rcfg, rp, pp = trees()
    rec = ref_engine.decode_exec_config(rcfg, N_SLOTS)
    if quantize:
        rp, _ = ref_q.quantize_params(rp)
        pp, _ = pt_q.quantize_params(pp)
    rplan = ref_sp.compile_weight_plan(rp, rec.schedules, prune_ratio=ratio)
    pplan = pt_sp.compile_weight_plan(pp, rec.schedules, prune_ratio=ratio)
    assert sorted(pplan.entries) == sorted(rplan.entries)
    expert_keys = [k for k in pplan.entries if "experts_" in k]
    assert len(expert_keys) == 3 and {"stack/layers/moe/router",
                                      "stack/layers/moe/shared/w_in",
                                      "stack/dense_layers/mlp/w_out"} \
        <= set(pplan.entries)
    for key, r in rplan.entries.items():
        p = pplan.entries[key]
        assert (p.site, p.mode, p.bm, p.bk, p.bn, p.tk, p.tn, p.max_nnz,
                p.lead, p.quantized) == (r.site, r.mode, r.bm, r.bk, r.bn,
                                         r.tk, r.tn, r.max_nnz, r.lead,
                                         r.quantized), key
        for a in ("wkidx", "wkcnt", "b_bitmap"):
            np.testing.assert_array_equal(getattr(p, a), getattr(r, a),
                                          err_msg=f"{key} {a}")
        ps, rs = p.stats(), r.stats()
        for field in ("lead", "layers", "blocks", "max_nnz", "tk",
                      "dense_bytes", "experts", "expert_max_nnz"):
            assert ps.get(field) == rs.get(field), (key, field)
        if "experts" in rs:
            np.testing.assert_allclose(ps["expert_wt_density"],
                                       rs["expert_wt_density"], rtol=1e-12)
            assert p.lead == (cfg.n_layers - 1, cfg.moe.n_experts)


def test_4d_planned_weight_slices_per_layer():
    cfg, rcfg, rp, pp = trees()
    ec = pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp, device="cpu")
    att = ec.plan.attach(pp)
    pw = att["stack"]["layers"]["moe"]["experts_out"]
    e = cfg.moe.n_experts
    one = pw.index(0)
    assert one.w.shape == (e, cfg.moe.expert_d_ff, cfg.d_model)
    assert one.wkidx.shape == (e, pw.wkidx.shape[-2], pw.max_nnz)
    assert one.b_bitmap.shape == (e, pw.tk, pw.b_bitmap.shape[-1])
    q = pt_q.quantize_params(pp)[0]["stack"]["layers"]["moe"]["experts_in"]
    assert q.index(0).q.shape == q.q.shape[1:]
    assert q.index(0).scale.shape == (e, cfg.moe.expert_d_ff)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_4d_int8_payload_and_scales_equal_reference(dtype):
    cfg = smoke()
    rp = ref_model.init_params(ref_config(cfg), jax.random.PRNGKey(3),
                               dtype=dtype)
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    rq, rstats = ref_q.quantize_params(rp)
    pq, pstats = pt_q.quantize_params(pp)
    assert pstats == rstats
    for name in ("router", "experts_in", "experts_gate", "experts_out"):
        r = rq["stack"]["layers"]["moe"][name]
        p = pq["stack"]["layers"]["moe"][name]
        assert isinstance(p, pt_q.QuantizedLinear)
        np.testing.assert_array_equal(p.q.numpy(), np.asarray(r.q))
        np.testing.assert_array_equal(p.scale.numpy().view(np.int32),
                                      np.asarray(r.scale).view(np.int32))
    assert pq["stack"]["layers"]["moe"]["experts_in"].scale.shape == (
        cfg.n_layers - 1, cfg.moe.n_experts, cfg.moe.expert_d_ff)


def test_sliced_pruning_quantizing_and_counts_equal_whole_leaf(monkeypatch):
    """Slicing the leading axes changes no number: each result is per
    (K, N) matrix.  Whole-leaf runs (a slice budget above the leaf) against
    one-matrix slices."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((3, 4, 40, 36), generator=gen).to(torch.bfloat16)
    whole = {}
    for budget in (1 << 30, 1):
        monkeypatch.setattr(pt_stacks, "SLICE_ELEMS", budget)
        pruned = pt_sp.prune_stacked_magnitude(w, 0.5, (8, 12))
        q = pt_q.quantize_weight(pruned.float())
        kn = pruned.reshape(-1, 40, 36)
        got = (pruned, q.q, q.scale, pt_sp.stack_block_bitmap(kn, 8, 12),
               torch.tensor(pt_sp.count_nonzero(pruned)),
               torch.from_numpy(pt_sp._block_nonzeros(kn, 8, 12)))
        if not whole:
            whole = got
        else:
            for a, b in zip(whole, got):
                assert torch.equal(a, b)
    assert 0 < int(whole[4]) < w.numel()
    # the whole-leaf results are the reference's, matrix by matrix
    ref = ref_sp.prune_stacked_magnitude(
        jnp.asarray(w.float().numpy()), 0.5, (8, 12))
    np.testing.assert_array_equal(whole[0].float().numpy() != 0,
                                  np.asarray(ref) != 0)


def test_attach_pads_a_ragged_weight_once():
    """A weight that is not a block multiple (the dense layer's mlp.out,
    K 192 at bk 128) is padded once at attach, and the dispatch reads that
    copy; a ragged weight without one is refused, never copied per call."""
    cfg, rcfg, rp, pp = trees()
    ec = pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp, device="cpu")
    att = ec.plan.attach(pp)
    pw = att["stack"]["dense_layers"]["mlp"]["w_out"]
    assert pw.kn.shape[-2] % pw.bk and pw.wpad is not None
    assert pw.wpad.shape[-2] == pw.tk * pw.bk
    one = pw.index(0)
    assert one.kn_padded is one.wpad
    x = torch.randn((N_SLOTS, pw.kn.shape[-2]),
                    generator=torch.Generator().manual_seed(1))
    got = pt_ops._planned_matmul(x, one)
    # float32 products of K terms: √K·2⁻²⁴·max(|x|@|w|) bounds the reorder
    tol = (one.kn.shape[-2] ** 0.5 * 2.0 ** -24
           * float((x.abs() @ one.kn.float().abs()).max()))
    assert float((got - x @ one.kn.float()).abs().max()) <= tol
    with pytest.raises(ValueError, match="not a multiple"):
        pt_ops._planned_matmul(x, dataclasses.replace(one, wpad=None))
    assert att["stack"]["layers"]["moe"]["experts_in"].wpad is None


# ---------------------------------------------------------------------------
# the stack, the model and the engine
# ---------------------------------------------------------------------------

def test_converted_tree_carries_the_moe_layout():
    cfg = smoke()
    rp = ref_model.init_params(ref_config(cfg), jax.random.PRNGKey(0),
                               dtype=jnp.bfloat16)
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    moe = pp["stack"]["layers"]["moe"]
    e, f, d = cfg.moe.n_experts, cfg.moe.expert_d_ff, cfg.d_model
    assert moe["router"].dtype == torch.float32
    assert moe["experts_in"].dtype == torch.bfloat16
    assert moe["experts_in"].shape == (1, e, d, f)
    assert moe["experts_out"].shape == (1, e, f, d)
    assert moe["shared"]["w_out"].shape == (1, f * cfg.moe.n_shared, d)
    assert pp["stack"]["dense_layers"]["mlp"]["w_in"].shape == (1, d,
                                                                 cfg.d_ff)
    ours = pt_model.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), rp)
    assert jax.tree.map(lambda a: tuple(a.shape), ours) == shapes
    np.testing.assert_array_equal(
        moe["experts_gate"].view(torch.int16).numpy(),
        np.asarray(rp["stack"]["layers"]["moe"]["experts_gate"]).view(
            np.int16))


def test_unported_families_still_refuse():
    # the Griffin family (rglru), the SSM and the encoder-decoder are
    # ported (tests/test_torch_griffin.py, test_torch_ssm.py,
    # test_torch_whisper.py) and build their stacks and states; what they
    # and the MoE stack still refuse is the dense-only cache-filling
    # prefill and verify window, and vision inputs are not ported at all
    cfg = smoke()
    others = {
        "ssm": dataclasses.replace(cfg, moe=pt_base.MoEConfig(),
                                   ssm=pt_base.SSMConfig(d_state=16)),
        "whisper": dataclasses.replace(cfg, moe=pt_base.MoEConfig(),
                                       encoder_decoder=True),
    }
    pp = pt_model.init_params(cfg, torch.Generator().manual_seed(0),
                              dtype=torch.float32, device="cpu")
    tokens = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    for name, other in others.items():
        assert other.ssm.enabled or other.encoder_decoder
        pt_tr.init_stack(other, torch.Generator())
        pt_tr.init_decode_state(other, 1, 8)
        with pytest.raises(NotImplementedError):
            pt_model.prefill_with_cache(pp, other, tokens, 8)
        with pytest.raises(ValueError):
            pt_tr.decode_stack_window(None, other,
                                      torch.zeros((1, 2, cfg.d_model)), None,
                                      torch.zeros(1, dtype=torch.long))
    with pytest.raises(NotImplementedError):
        pt_model.prefill_with_cache(pp, cfg, tokens, 8)
    with pytest.raises(NotImplementedError, match="token input"):
        pt_model.prefill(pp, cfg, {**tokens, "vis_embeds": torch.zeros(1)})
    st = pt_model.init_decode_state(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError):
        pt_tr.decode_stack_window(pp["stack"], cfg,
                                  torch.zeros((1, 2, cfg.d_model)), st,
                                  torch.zeros(1, dtype=torch.long))
    assert set(st) == {"layers", "dense_layers"}


@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
def test_decode_logits_and_state_match_reference(planned):
    cfg, rcfg, rp, pp = trees()
    if planned:
        rparams = ref_engine.decode_exec_config(rcfg, 4, params=rp)
        pparams = pt_engine.decode_exec_config(cfg, 4, params=pp,
                                               device="cpu")
        rec, pec = rparams, pparams
        rparams, pparams = rec.plan.attach(rp), pec.plan.attach(pp)
    else:
        rec, pec, rparams, pparams = None, None, rp, pp
    rstate = ref_model.init_decode_state(rcfg, 4, MAX_SEQ, dtype=jnp.float32)
    pstate = pt_model.init_decode_state(cfg, 4, MAX_SEQ, dtype=torch.float32,
                                        device="cpu")
    rng = np.random.default_rng(11)
    pos = np.array([0, 3, 1, 5], np.int32)
    active = np.array([True, True, False, True])
    step = jax.jit(lambda p, t, s, q, a: ref_model.masked_decode_step(
        p, rcfg, t, s, q, a))
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab, size=(4, 1)).astype(np.int32)
        with ref_ops.exec_config(rec or ref_ops.ExecConfig()):
            rlog, rstate = step(rparams, toks, rstate, pos, active)
        with pt_ops.exec_config(pec or pt_ops.ExecConfig()):
            plog, pstate = pt_model.masked_decode_step(
                pparams, cfg, torch.from_numpy(toks).long(), pstate,
                torch.from_numpy(pos).long(), torch.from_numpy(active))
        np.testing.assert_allclose(plog.numpy()[active],
                                   np.asarray(rlog)[active], rtol=1e-4,
                                   atol=1e-4)
        for group in ("layers", "dense_layers"):
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    pstate[group][name].numpy(),
                    np.asarray(rstate[group][name]), rtol=1e-4, atol=1e-4)
        pos = pos + active


def test_prefill_logits_match_reference():
    cfg, rcfg, rp, pp = trees()
    toks = np.random.default_rng(12).integers(0, cfg.vocab, size=(2, 8))
    want = ref_model.prefill(rp, rcfg, {"tokens": jnp.asarray(toks)})
    got = pt_model.prefill(pp, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _prompts(cfg, seed=0, n=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(2, 10)))
            .astype(np.int32) for _ in range(n)]


def _drain(eng, prompts, max_new=6):
    uids = [eng.submit(p, max_new=max_new) for p in prompts]
    res = eng.run_until_drained()
    return [res[u] for u in uids]


@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
def test_engine_streams_equal_reference_engine(planned):
    """Greedy streams token for token against the reference engine, 2
    slots (idle slots' filler rows compete for capacity on both sides)."""
    cfg, rcfg, rp, pp = trees()
    rec = (ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp)
           if planned else None)
    pec = (pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                        device="cpu") if planned else None)
    reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  exec_cfg=rec, decode_block=4)
    peng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                 exec_cfg=pec, decode_block=4, device="cpu")
    prompts = _prompts(cfg)
    got, want = _drain(peng, prompts), _drain(reng, prompts)
    assert got == want and all(len(s) == 6 for s in got)


@pytest.mark.parametrize("variant", ["planned", "int8", "kernels"])
def test_fused_engine_equals_step_oracle(variant):
    """Fused blocks against per-token ``step()`` inside the port: the
    bf16-free float32 planned engine, the planned int8 engine and the dense
    kernel table; the int8 one also against the reference's."""
    cfg, rcfg, rp, pp = trees()
    kw = dict(device="cpu")
    if variant == "kernels":
        ec = pt_engine.decode_exec_config(smoke(), N_SLOTS, use_kernels=True,
                                          **kw)
    else:
        ec = pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                          quantize=variant == "int8", **kw)
    prompts = _prompts(cfg, seed=3, n=4)

    def drain(fused):
        eng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS,
                                    max_seq=MAX_SEQ, exec_cfg=ec,
                                    fused=fused, decode_block=4,
                                    device="cpu")
        return _drain(eng, prompts, max_new=7)

    fused = drain(True)
    assert fused == drain(False)
    if variant == "int8":
        rec = ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp,
                                            quantize=True)
        reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS,
                                      max_seq=MAX_SEQ, exec_cfg=rec,
                                      decode_block=4)
        assert fused == _drain(reng, prompts, max_new=7)
        assert isinstance(ec.plan.attach(pt_q.quantize_params(pp)[0])[
            "stack"]["layers"]["moe"]["router"], pt_sp.PlannedWeight)


def test_engine_gates_speculation_off_for_moe():
    cfg, rcfg, rp, pp = trees()
    ec = pt_engine.decode_exec_config(
        dataclasses.replace(cfg, sparsity=pt_base.SparsityConfig(
            weight_sparsity=0.5)), N_SLOTS, params=pp, device="cpu")
    eng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                exec_cfg=ec, speculate_k=2, device="cpu")
    assert not eng._spec_windowed
    out = _drain(eng, _prompts(cfg, n=2), max_new=4)
    assert eng.spec_stats["verify_blocks"] == 0 and all(
        len(s) == 4 for s in out)


# ---------------------------------------------------------------------------
# the C entry points against their ctypes signatures
# ---------------------------------------------------------------------------

_KIND = {"int": build.ctypes.c_int, "long long": build.ctypes.c_longlong,
         "float": build.ctypes.c_float}


def _c_params(text: str, name: str):
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", text, re.S)
    assert m, name
    kinds = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if "*" in param:
            kinds.append(build.ctypes.c_void_p)
        else:
            kinds.append(_KIND[param.rsplit(" ", 1)[0]])
    return kinds


def test_every_entry_point_matches_its_ctypes_signature():
    """The kernels build only on the card; their C parameter lists are held
    to ``build.SIGNATURES`` here (pointer, int, long long, float in order),
    the expert-batched entry points included."""
    for lib, fns in build.SIGNATURES.items():
        text = (build.CSRC / f"{lib}.cu").read_text()
        for fn, argtypes in fns.items():
            assert _c_params(text, fn) == argtypes, (lib, fn)
    # the expert axis is part of the 2-D entry points (experts, strides)
    longs = [build.ctypes.c_longlong] * 4
    for fn in ("bs_matmul", "bs_matmul_scaled"):
        assert build.SIGNATURES["block_sparse"][fn][-5:-1] == longs
    assert build.SIGNATURES["flex_matmul"]["fm_output"][-3:-1] == longs[:2]
    assert Path(build.CSRC / "os_mma.cuh").read_text().count(
        "blockIdx.y") >= 2
