"""The port's plan layer is integer-exact against the JAX package: block
bitmaps, per-column live-K lists, the combined (activation ∧ weight)
metadata and whole compiled weight plans; over-tight bounds raise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.core import sparsity as ref_sp
from repro.models import model as ref_model
from repro.serve.engine import decode_exec_config as ref_exec_config
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.core import sparsity as pt_sp
from repro_torch.serve.engine import decode_exec_config as pt_exec_config

SPARSE = dict(weight_sparsity=0.5, activation_threshold=0.05)


def ref_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, cls in (("moe", ref_base.MoEConfig), ("ssm", ref_base.SSMConfig),
                      ("rglru", ref_base.RGLRUConfig),
                      ("sparsity", ref_base.SparsityConfig)):
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return ref_base.ArchConfig(**kw)


def _block_sparse_matrix(rng, shape, blocks, live):
    """A float32 matrix whose (bk, bn) blocks are zero with prob 1-live
    (plus a few exact zeros inside live blocks)."""
    k, n = shape
    bk, bn = blocks
    tk, tn = -(-k // bk), -(-n // bn)
    keep = rng.random((tk, tn)) < live
    mask = np.repeat(np.repeat(keep, bk, 0), bn, 1)[:k, :n]
    w = rng.standard_normal(shape).astype(np.float32) * mask
    w[rng.random(shape) < 0.05] = 0.0
    return w


@pytest.mark.parametrize("shape,blocks", [((64, 96), (16, 32)),
                                          ((50, 70), (16, 16)),
                                          ((4, 256), (4, 64))])
@pytest.mark.parametrize("live", [0.0, 0.4, 1.0])
def test_block_bitmap_equals_reference(shape, blocks, live):
    rng = np.random.default_rng(7)
    w = _block_sparse_matrix(rng, shape, blocks, live)
    ours = pt_sp.block_bitmap(torch.from_numpy(w), *blocks).numpy()
    np.testing.assert_array_equal(ours, ref_sp.block_bitmap(w, *blocks))


@pytest.mark.parametrize("live", [0.0, 0.3, 0.8, 1.0])
def test_weight_side_lists_equal_reference(live):
    rng = np.random.default_rng(11)
    bmap = rng.random((12, 9)) < live
    k_ours, c_ours = pt_sp.weight_side_lists(bmap)
    k_ref, c_ref = ref_sp.weight_side_lists(bmap)
    np.testing.assert_array_equal(k_ours, k_ref)
    np.testing.assert_array_equal(c_ours, c_ref)
    if c_ref.max() > 1:
        with pytest.raises(ValueError, match="max_nnz"):
            pt_sp.weight_side_lists(bmap, int(c_ref.max()) - 1, site="s")


@pytest.mark.parametrize("a_live,b_live", [(0.5, 0.5), (1.0, 0.3),
                                           (0.2, 1.0), (0.0, 0.7)])
def test_combined_meta_equals_reference(a_live, b_live):
    rng = np.random.default_rng(3)
    a_bm = rng.random((3, 10)) < a_live
    b_bm = rng.random((10, 7)) < b_live
    wkidx, wkcnt = ref_sp.weight_side_lists(b_bm)
    ref = ref_sp.combine_with_activation_meta(
        jnp.asarray(a_bm), jnp.asarray(wkidx), jnp.asarray(wkcnt),
        jnp.asarray(b_bm))
    ours = pt_sp.combine_with_activation_meta(
        torch.from_numpy(a_bm), torch.from_numpy(wkidx),
        torch.from_numpy(wkcnt), torch.from_numpy(b_bm))
    np.testing.assert_array_equal(ours.kidx.numpy(), np.asarray(ref.kidx))
    np.testing.assert_array_equal(ours.kcnt.numpy(), np.asarray(ref.kcnt))
    assert ours.max_nnz == ref.max_nnz
    # the trace-time builder gives the same lists entry for entry
    built = pt_sp.build_block_sparse_meta(torch.from_numpy(a_bm),
                                          torch.from_numpy(b_bm),
                                          max_nnz=ours.max_nnz)
    ref_built = ref_sp.build_block_sparse_meta_jnp(
        jnp.asarray(a_bm), jnp.asarray(b_bm), max_nnz=ref.max_nnz)
    np.testing.assert_array_equal(built.kidx.numpy(),
                                  np.asarray(ref_built.kidx))
    np.testing.assert_array_equal(ours.kidx.numpy(), built.kidx.numpy())
    np.testing.assert_array_equal(ours.kcnt.numpy(), built.kcnt.numpy())


def test_weight_plan_meta_broadcasts_lists():
    rng = np.random.default_rng(5)
    b_bm = rng.random((6, 4)) < 0.5
    wkidx, wkcnt = ref_sp.weight_side_lists(b_bm)
    ref = ref_sp.weight_plan_meta(jnp.asarray(wkidx), jnp.asarray(wkcnt),
                                  jnp.asarray(b_bm), 3)
    ours = pt_sp.weight_plan_meta(torch.from_numpy(wkidx),
                                  torch.from_numpy(wkcnt),
                                  torch.from_numpy(b_bm), 3)
    np.testing.assert_array_equal(ours.kidx.numpy(), np.asarray(ref.kidx))
    np.testing.assert_array_equal(ours.kcnt.numpy(), np.asarray(ref.kcnt))
    assert bool(ours.a_bitmap.all())


def test_build_meta_overtight_bound_raises():
    a_bm = torch.ones((2, 5), dtype=torch.bool)
    b_bm = torch.ones((5, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="mi=0, ni=0"):
        pt_sp.build_block_sparse_meta(a_bm, b_bm, max_nnz=4, site="attn.q")


@pytest.fixture(scope="module")
def pruned_smoke():
    """The stablelm smoke params, block-pruned by the reference."""
    cfg = pt_base.get_smoke_config("stablelm-1.6b")
    params = ref_model.init_params(ref_config(cfg), jax.random.PRNGKey(0),
                                   dtype=jnp.float32)
    params = jax.tree.map(
        lambda leaf: ref_sp.prune_stacked_magnitude(leaf, 0.5, (16, 16)),
        params)
    return cfg, params


def test_compiled_plan_equals_reference(pruned_smoke):
    cfg, ref_params = pruned_smoke
    sp_cfg = dataclasses.replace(cfg, sparsity=pt_base.SparsityConfig(**SPARSE))
    ref_ec = ref_exec_config(ref_config(sp_cfg), 4, params=ref_params)
    pt_params = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                  device="cpu")
    pt_ec = pt_exec_config(sp_cfg, 4, params=pt_params, device="cpu")
    ours, theirs = pt_ec.plan, ref_ec.plan
    assert sorted(ours.entries) == sorted(theirs.entries)
    assert "lm_head" in ours.entries
    for key, e in ours.entries.items():
        r = theirs.entries[key]
        assert (e.site, e.mode, e.bm, e.bk, e.bn, e.tk, e.tn, e.max_nnz,
                e.lead, e.transpose) == \
            (r.site, r.mode, r.bm, r.bk, r.bn, r.tk, r.tn, r.max_nnz,
             r.lead, r.transpose), key
        np.testing.assert_array_equal(e.wkidx, r.wkidx)
        np.testing.assert_array_equal(e.wkcnt, r.wkcnt)
        np.testing.assert_array_equal(e.b_bitmap, r.b_bitmap)
        assert e.nnz == r.zvc_values.size and e.size == r.zvc_bitmap.size
        assert e.block_density == r.block_density
        assert e.dense_bytes == r.dense_bytes and e.zvc_bytes == r.zvc_bytes
        assert e.int8_zvc_bytes == r.int8_zvc_bytes and not e.quantized
    assert ours.wt_densities() == pytest.approx(theirs.wt_densities(),
                                                rel=0, abs=1e-15)
    for s, d in pt_ec.schedules.sites.items():
        assert d.describe() == ref_ec.schedules.sites[s].describe()


def test_overtight_plan_cap_raises(pruned_smoke):
    cfg, ref_params = pruned_smoke
    sp_cfg = dataclasses.replace(cfg, sparsity=pt_base.SparsityConfig(**SPARSE))
    pt_params = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                  device="cpu")
    table = pt_exec_config(sp_cfg, 4, device="cpu").schedules
    with pytest.raises(ValueError, match=r"mlp\.out\[0\]: max_nnz=0"):
        pt_sp.compile_weight_plan(pt_params, table, max_nnz={"mlp.out": 0})


def test_attach_refuses_foreign_plan(pruned_smoke):
    cfg, ref_params = pruned_smoke
    sp_cfg = dataclasses.replace(cfg, sparsity=pt_base.SparsityConfig(**SPARSE))
    pt_params = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                  device="cpu")
    plan = pt_exec_config(sp_cfg, 4, params=pt_params, device="cpu").plan
    attached = plan.attach(pt_params)
    wq = attached["stack"]["layers"]["attn"]["wq"]
    assert isinstance(wq, pt_sp.PlannedWeight) and wq.w is \
        pt_params["stack"]["layers"]["attn"]["wq"]
    head = attached["lm_head"]
    assert head.transpose and head.w_kn.shape == (cfg.d_model, cfg.vocab)
    # a plan compiled with wq all-zero must refuse the live wq
    layers = pt_params["stack"]["layers"]
    zeroed = {**pt_params, "stack": {"layers": {
        **layers, "attn": {**layers["attn"],
                           "wq": torch.zeros_like(layers["attn"]["wq"])}}}}
    foreign = pt_exec_config(sp_cfg, 4, params=zeroed, device="cpu").plan
    with pytest.raises(ValueError, match="does not cover"):
        foreign.attach(pt_params)
