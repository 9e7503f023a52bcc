"""The port's descriptor tables equal the JAX package's field for field
(same hardware object), and under the port's H100 object every chosen
block fits the 232,448-byte per-block shared-memory budget."""
import dataclasses

import pytest

from repro.configs import base as ref_base
from repro.core import descriptors as ref_desc
from repro.core import flextree as ref_flextree
from repro.core import scheduler as ref_sched
from repro_torch.configs import base as pt_base
from repro_torch.core import descriptors as pt_desc
from repro_torch.core import flextree as pt_flextree
from repro_torch.core import scheduler as pt_sched

SPARSE = dict(weight_sparsity=0.5, activation_threshold=0.05)


def ref_config(cfg):
    """The reference ArchConfig with the same fields as a port config."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, cls in (("moe", ref_base.MoEConfig), ("ssm", ref_base.SSMConfig),
                      ("rglru", ref_base.RGLRUConfig),
                      ("sparsity", ref_base.SparsityConfig)):
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return ref_base.ArchConfig(**kw)


def _configs():
    out = []
    for arch, full in (("stablelm-1.6b", False), ("stablelm-1.6b", True),
                       ("edge-tiny", False)):
        cfg = (pt_base.get_config(arch) if full
               else pt_base.get_smoke_config(arch))
        out.append(cfg)
        out.append(dataclasses.replace(
            cfg, sparsity=pt_base.SparsityConfig(**SPARSE)))
    return out


CONFIGS = _configs()


def _schedule_fields(s):
    return (s.stationarity, s.bm, s.bn, s.bk, s.ic_p, s.hbm_bytes, s.flops,
            s.sparsity_mode, s.wt_bytes)


@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=[f"{c.name}-{c.sparsity.enabled}" for c in CONFIGS])
@pytest.mark.parametrize("batch", [1, 4])
def test_table_equals_reference(cfg, batch):
    shape = pt_base.ShapeConfig("serve_decode", "decode", 1, batch)
    rshape = ref_base.ShapeConfig("serve_decode", "decode", 1, batch)
    ours = pt_desc.compile_network_schedule(cfg, shape,
                                          hw=pt_sched.TPU_V5E)
    theirs = ref_desc.compile_network_schedule(ref_config(cfg), rshape,
                                               hw=ref_sched.TPU_V5E)
    assert list(ours.sites) == list(theirs.sites)
    for site, d in ours.sites.items():
        r = theirs.sites[site]
        assert (d.m, d.n, d.k, d.sparsity_mode) == \
            (r.m, r.n, r.k, r.sparsity_mode), site
        assert _schedule_fields(d.schedule) == _schedule_fields(r.schedule), \
            site
        assert (d.reduce.axis_name, d.reduce.ic_p, d.reduce.strategy) == \
            (r.reduce.axis_name, r.reduce.ic_p, r.reduce.strategy), site
        assert d.describe() == r.describe()


def test_table_with_measured_densities_equals_reference():
    cfg = dataclasses.replace(pt_base.get_config("stablelm-1.6b"),
                              sparsity=pt_base.SparsityConfig(**SPARSE))
    wt = {"attn.q": 0.3, "mlp.in": 0.45, "mlp.out": 0.7, "lm_head": 1.0}
    act = {"attn.kv": 0.9, "mlp.gate": 0.2}
    ours = pt_desc.compile_network_schedule(
        cfg, pt_base.ShapeConfig("d", "decode", 1, 4), wt_densities=wt,
        act_densities=act)
    theirs = ref_desc.compile_network_schedule(
        ref_config(cfg), ref_base.ShapeConfig("d", "decode", 1, 4),
        wt_densities=wt, act_densities=act)
    for site, d in ours.sites.items():
        assert _schedule_fields(d.schedule) == \
            _schedule_fields(theirs.sites[site].schedule), site


@pytest.mark.parametrize("mode,act,wt", [("dense", 1.0, 1.0),
                                         ("weight", 1.0, 0.5),
                                         ("two_sided", 0.5, 0.25)])
@pytest.mark.parametrize("mnk", [(4, 2048, 2048), (4, 100352, 2048),
                                 (512, 4096, 1024), (64, 96, 5632)])
def test_selector_equals_reference(mode, act, wt, mnk):
    m, n, k = mnk
    kw = dict(sparsity_mode=mode, act_density=act, wt_density=wt)
    ours = pt_sched.select_matmul_schedule(m, n, k, hw=pt_sched.TPU_V5E, **kw)
    theirs = ref_sched.select_matmul_schedule(m, n, k, hw=ref_sched.TPU_V5E,
                                              **kw)
    assert _schedule_fields(ours) == _schedule_fields(theirs)
    assert pt_sched.roofline_time(ours) == ref_sched.roofline_time(theirs)


@pytest.mark.parametrize("ic_p", [1, 2, 3, 8])
@pytest.mark.parametrize("sharded", [False, True])
def test_flextree_strategy_equals_reference(ic_p, sharded):
    for payload in (1.0, 4096.0, 3e6):
        assert pt_flextree.best_strategy(payload, ic_p, sharded) == \
            ref_flextree.best_strategy(payload, ic_p, sharded)
        for s in ("allreduce", "scatter", "tree"):
            assert pt_flextree.link_bytes(s, payload, ic_p) == \
                ref_flextree.link_bytes(s, payload, ic_p)


@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=[f"{c.name}-{c.sparsity.enabled}" for c in CONFIGS])
def test_h100_blocks_fit_shared_memory(cfg):
    hw = pt_sched.H100
    table = pt_desc.compile_network_schedule(
        cfg, pt_base.ShapeConfig("serve_decode", "decode", 1, 4), hw=hw)
    for site, d in table.sites.items():
        s = d.schedule
        need = (s.bm * s.bk * 2 + s.bk * s.bn * s.wt_bytes) * 2 \
            + s.bm * s.bn * 4
        assert need <= hw.vmem_bytes == 232_448, site
        assert max(s.bm, s.bn, s.bk) <= 256, site
