"""``ExecConfig.sparse_dispatch`` in the port against the JAX package's: with
the switch off a ``PlannedWeight`` takes its dense fallback, no descriptor
routes a site to the block-sparse path, no activation popcount is recorded,
and the dense fallback keeps the site's scheduled stationarity.  The
public two-sided entry point ``ops.block_sparse_matmul`` (precomputed
metadata, or None for the site's dispatch) equals the reference's.

Tolerances: float32 products that the two sides sum in another order,
rtol = 2e-5 / atol = 2e-4 against the dense product (the reference tests'
bar) and rtol = atol = 1e-5 against the reference's own output (the bar of
``test_torch_quant.py``); engines token for token.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import descriptors as ref_desc
from repro.core import sparsity as ref_sp
from repro.core.flextree import ReduceConfig as RefReduce
from repro.core.scheduler import MatmulSchedule as RefSchedule
from repro.kernels import ops as ref_ops
from repro.quant import quantize as ref_q
from repro.serve import engine as ref_engine
from repro_torch.core import descriptors as pt_desc
from repro_torch.core import sparsity as pt_sp
from repro_torch.core.flextree import ReduceConfig
from repro_torch.core.scheduler import MatmulSchedule
from repro_torch.kernels import block_sparse as pt_bs
from repro_torch.kernels import flex_matmul as pt_fm
from repro_torch.kernels import ops as pt_ops
from repro_torch.quant import quantize as pt_q
from repro_torch.serve import engine as pt_engine
from test_torch_serve import MAX_SEQ, N_SLOTS, _prompts, setup

DENSE_TOL = dict(rtol=2e-5, atol=2e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
SITE = "mlp.in"


def _operands(seed, m, k, n, max_live=2, act_thr=0.8, blocks=(32, 32)):
    rng = np.random.default_rng(seed)
    w = ref_sp.prune_k_blocks(rng.normal(size=(k, n)).astype(np.float32),
                              *blocks, max_live)
    x = rng.normal(size=(m, k)).astype(np.float32)
    return np.where(np.abs(x) > act_thr, x, 0.0).astype(np.float32), w


def _tables(mode, stationarity, m, n, k, blocks=(32, 32, 32)):
    """(reference, port) one-site descriptor tables."""
    bm, bn, bk = blocks
    out = []
    for desc, sched, red in ((ref_desc, RefSchedule, RefReduce),
                             (pt_desc, MatmulSchedule, ReduceConfig)):
        ns = desc.NetworkSchedule(arch="test", shape="test")
        ns.sites[SITE] = desc.SiteDescriptor(
            site=SITE, m=m, n=n, k=k,
            schedule=sched(stationarity=stationarity, bm=bm, bn=bn, bk=bk,
                           sparsity_mode=mode),
            reduce=red(axis_name="model", ic_p=1, strategy="psum"),
            sparsity_mode=mode)
        out.append(ns)
    return out


@pytest.fixture
def no_block_sparse(monkeypatch):
    """Fail any block-sparse launch; record the schedule every dense
    flex-matmul call is given."""
    def refuse(*a, **kw):
        raise AssertionError("block-sparse route taken with the switch off")
    monkeypatch.setattr(pt_bs, "block_sparse_matmul", refuse)
    seen = []
    real = pt_fm.flex_matmul

    def record(a, b, *, schedule=None, out_dtype=None):
        seen.append(schedule)
        return real(a, b, schedule=schedule, out_dtype=out_dtype)
    monkeypatch.setattr(pt_fm, "flex_matmul", record)
    return seen


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_plan_disabled_falls_back_dense(use_kernels, no_block_sparse):
    """The reference's ``test_weight_plan.py::
    test_plan_disabled_falls_back_dense``, against the same call there."""
    m, k, n = 32, 64, 32
    x, w = _operands(0, m, k, n)
    rpw = ref_sp.plan_weight(w, site=SITE, mode="two_sided", bm=32, bk=32,
                             bn=32)
    ppw = pt_sp.plan_weight(torch.from_numpy(w), site=SITE, mode="two_sided",
                            bm=32, bk=32, bn=32)
    with ref_ops.exec_config(ref_ops.ExecConfig(sparse_dispatch=False)):
        want = ref_ops.flex_matmul(jnp.asarray(x), rpw, site=SITE)
    col = pt_ops.SparsityStatsCollector()
    with pt_ops.exec_config(pt_ops.ExecConfig(use_kernels=use_kernels,
                                              sparse_dispatch=False)), \
            pt_ops.sparsity_stats(col):
        got = pt_ops.flex_matmul(torch.from_numpy(x), ppw, site=SITE)
        head = pt_ops.head_matmul(torch.from_numpy(x), ppw, site=SITE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), x @ w, **DENSE_TOL)
    assert torch.equal(head, got)
    assert col.densities() == {}
    assert no_block_sparse == ([None, None] if use_kernels else [])


@pytest.mark.parametrize("stationarity", ["output", "weight", "input"])
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_sparse_dispatch_flag_disables_routing(use_kernels, stationarity,
                                               no_block_sparse):
    """The reference's ``test_sparse_dispatch.py::
    test_sparse_dispatch_flag_disables_routing``: a two-sided site runs
    dense, at its scheduled stationarity and blocks."""
    m, k, n = 32, 64, 32
    x, w = _operands(1, m, k, n)
    rns, pns = _tables("two_sided", stationarity, m, n, k)
    with ref_ops.exec_config(ref_ops.ExecConfig(schedules=rns,
                                                sparse_dispatch=False)):
        assert ref_ops.site_sparsity_mode(SITE) == "dense"
        want = ref_ops.flex_matmul(jnp.asarray(x), jnp.asarray(w), site=SITE)
    col = pt_ops.SparsityStatsCollector()
    cfg = pt_ops.ExecConfig(schedules=pns, use_kernels=use_kernels,
                            sparse_dispatch=False)
    with pt_ops.exec_config(cfg), pt_ops.sparsity_stats(col):
        assert pt_ops.site_sparsity_mode(SITE) == "dense"
        assert pt_ops.site_sparsity_mode("attn.q") == "dense"
        assert pt_ops.site_schedule(SITE) is pns.sites[SITE].schedule
        assert pt_ops.site_schedule("attn.q") is None
        got = pt_ops.flex_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                 site=SITE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), x @ w, **DENSE_TOL)
    assert col.densities() == {}
    assert no_block_sparse == ([pns.sites[SITE].schedule] if use_kernels
                               else [])
    # the switch on: the site's mode again
    with pt_ops.exec_config(dataclasses.replace(cfg, sparse_dispatch=True)):
        assert pt_ops.site_sparsity_mode(SITE) == "two_sided"


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_expert_stack_switch_off_equals_reference(use_kernels,
                                                  no_block_sparse):
    e, c, k, n = 4, 8, 64, 48
    rng = np.random.default_rng(4)
    w = np.stack([ref_sp.prune_k_blocks(
        rng.normal(size=(k, n)).astype(np.float32), 16, 16, 2)
        for _ in range(e)])
    x = rng.normal(size=(e, c, k)).astype(np.float32)
    x = np.where(np.abs(x) > 0.6, x, 0.0).astype(np.float32)
    rpw = ref_sp.plan_weight(w, site="moe.experts_in", mode="two_sided",
                             bm=8, bk=16, bn=16)
    ppw = pt_sp.plan_weight(torch.from_numpy(w), site="moe.experts_in",
                            mode="two_sided", bm=8, bk=16, bn=16)
    with ref_ops.exec_config(ref_ops.ExecConfig(sparse_dispatch=False)):
        want = ref_ops.flex_expert_matmul(jnp.asarray(x), rpw,
                                          site="moe.experts_in")
    col = pt_ops.SparsityStatsCollector()
    with pt_ops.exec_config(pt_ops.ExecConfig(use_kernels=use_kernels,
                                              sparse_dispatch=False)), \
            pt_ops.sparsity_stats(col):
        got = pt_ops.flex_expert_matmul(torch.from_numpy(x), ppw,
                                        site="moe.experts_in")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.einsum("eck,ekn->ecn", x, w),
                               **DENSE_TOL)
    assert col.densities() == {}
    assert len(no_block_sparse) == int(use_kernels)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_int8_plan_switch_off_equals_reference(use_kernels, dtype,
                                               no_block_sparse):
    """A quantized plan's fallback dequantizes to float32, as the
    reference's ``PlannedWeight.w_kn`` does: a bf16 activation meets it in
    float32 and the product is rounded to bf16 once."""
    m, k, n = 8, 64, 48
    x, w = _operands(2, m, k, n, blocks=(16, 16))
    rq = ref_q.quantize_weight(jnp.asarray(w))
    pq = pt_q.quantize_weight(torch.from_numpy(w))
    rpw = ref_sp.plan_weight(rq, site=SITE, mode="weight", bm=8, bk=16,
                             bn=16)
    ppw = pt_sp.plan_weight(pq, site=SITE, mode="weight", bm=8, bk=16, bn=16)
    assert ppw.quantized and ppw.w_kn.dtype == torch.float32
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    with ref_ops.exec_config(ref_ops.ExecConfig(sparse_dispatch=False)):
        want = ref_ops.flex_matmul(jnp.asarray(x).astype(dtype), rpw,
                                   site=SITE)
    with pt_ops.exec_config(pt_ops.ExecConfig(use_kernels=use_kernels,
                                              sparse_dispatch=False)):
        got = pt_ops.flex_matmul(xt, ppw, site=SITE)
    assert got.dtype == xt.dtype
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:                  # one bf16 rounding of nearly equal float32 sums
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=2 ** -8, atol=1e-5)
    dense = xt.double() @ (pq.q.double() * pq.scale.double())
    np.testing.assert_allclose(got.double().numpy(), dense.numpy(),
                               rtol=2 ** -8 if dtype == "bfloat16" else 1e-5,
                               atol=1e-5)


def test_engine_switch_off_equals_reference_engine():
    """A planned smoke engine with the switch off emits the reference
    engine's tokens under ``sparse_dispatch=False`` and records no
    activation density; with the switch on it records every two-sided
    site."""
    cfg, rcfg, rp, pp, _, _ = setup("stablelm-1.6b", True)
    rec = dataclasses.replace(
        ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp,
                                      collect_stats=True),
        sparse_dispatch=False)
    pec = pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                       collect_stats=True, device="cpu")
    prompts = _prompts(cfg, seed=7)
    reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  exec_cfg=rec, decode_block=8)
    ruids = [reng.submit(p, max_new=6) for p in prompts]
    rres = reng.run_until_drained()
    assert reng.activation_densities() == {}
    outs, dens = [], []
    for switch in (False, True):
        eng = pt_engine.ServeEngine(
            cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ, decode_block=8,
            exec_cfg=dataclasses.replace(pec, sparse_dispatch=switch),
            device="cpu")
        uids = [eng.submit(p, max_new=6) for p in prompts]
        res = eng.run_until_drained()
        outs.append([res[u] for u in uids])
        dens.append(eng.activation_densities())
    assert outs[0] == [rres[u] for u in ruids]
    assert dens[0] == {}
    assert set(dens[1]) == {s for s, d in pec.schedules.sites.items()
                            if d.sparsity_mode == "two_sided"}


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("with_meta", [True, False], ids=["meta", "none"])
def test_public_block_sparse_matmul_equals_reference(use_kernels, with_meta):
    """``ops.block_sparse_matmul``, the reference's public two-sided entry
    point: with precomputed metadata (dead blocks on both sides) and with
    None (the site's ``flex_matmul`` dispatch), against the reference's
    and against the dense product."""
    rng = np.random.default_rng(3)
    bm = bk = bn = 16
    x = rng.standard_normal((32, 64)).astype(np.float32)
    x[:16, :32] = 0.0
    w = rng.standard_normal((64, 48)).astype(np.float32)
    w[16:32] = 0.0
    ref_meta = (ref_sp.build_block_sparse_meta(x, w, bm, bk, bn)
                if with_meta else None)
    want = np.asarray(ref_ops.block_sparse_matmul(
        jnp.asarray(x), jnp.asarray(w), ref_meta, site=SITE))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    meta = (pt_sp.build_block_sparse_meta(pt_sp.block_bitmap(xt, bm, bk),
                                          pt_sp.block_bitmap(wt, bk, bn))
            if with_meta else None)
    with pt_ops.exec_config(pt_ops.ExecConfig(use_kernels=use_kernels)):
        got = pt_ops.block_sparse_matmul(xt, wt, meta, site=SITE).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, x @ w, **DENSE_TOL)
