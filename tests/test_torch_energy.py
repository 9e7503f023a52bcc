"""The port's analytic core against the JAX package's: the access-count
energy model, the vectorized schedule grid, the schedule search, the CNN
zoo, the §V-C sparsity profiles and FlexTree's cycle models, on the CPU.

Tolerances: the scalar model, the profiles, the zoo and the cycle models
are copies and must be equal (floats compared as floats).  The grid's
energies are built from ``+``, ``*``, ``min`` and ``max`` in the
reference's order and must be bit-equal; its cycles take one ``log`` and
one ``sqrt`` from torch's libm, which may differ from numpy's by an ulp,
so they are held within a relative 2⁻⁴⁹.  The search re-scores its winner
with the scalar model, so ``optimize_layer`` must return the reference's
``Cost`` exactly: schedule, energy, cycles and breakdown.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import given, settings, strategies as st

from repro.configs import cnn_zoo as ref_zoo
from repro.core import _vectorized as ref_vec
from repro.core import energy_model as ref_em
from repro.core import flextree as ref_ft
from repro.core import scheduler as ref_sched
from repro.core import sparsity_profiles as ref_prof
from repro_torch.configs import cnn_zoo as pt_zoo
from repro_torch.core import _vectorized as pt_vec
from repro_torch.core import energy_model as pt_em
from repro_torch.core import flextree as pt_ft
from repro_torch.core import scheduler as pt_sched
from repro_torch.core import sparsity_profiles as pt_prof

CPU = torch.device("cpu")
NETS = list(ref_zoo.NETWORKS)
PROFILED = list(ref_prof._NETWORK_STATS)


def _pt(obj, mod=pt_em):
    """A reference dataclass as the port's (same fields)."""
    return getattr(mod, type(obj).__name__)(**dataclasses.asdict(obj))


def _accs(mod):
    """The Fig 16 accelerators, built as ``bench_energy_vs_fixed`` builds
    them, from ``mod``'s base descriptions."""
    flex = mod.FLEXNN
    return {
        "flex_dense": dataclasses.replace(flex, sparsity_support="none"),
        "eyeriss_scaled": dataclasses.replace(mod.EYERISS,
                                              sram_bytes=flex.sram_bytes),
        "tpu_scaled": dataclasses.replace(
            mod.TPU, sram_bytes=flex.sram_bytes, rf_if=16, rf_fl=32,
            rf_of=16, cost_inter_pe=0.12, cost_mac=1.06),
        "flexnn": flex,
        "flexnn_weight": mod.flexnn_variant("weight"),
        "flexnn_none": mod.flexnn_variant("none"),
    }


REF_ACCS, PT_ACCS = _accs(ref_em), _accs(pt_em)


def _same_cost(got, want):
    assert dataclasses.asdict(got.schedule) == dataclasses.asdict(
        want.schedule)
    assert got.energy == want.energy
    assert got.cycles == want.cycles
    assert got.breakdown == want.breakdown


def _profiles(net):
    layers = ref_zoo.NETWORKS[net]()
    return [_pt(s) for s in ref_prof.profiles_for(net, layers)]


# ---------------------------------------------------------------------------
# the scalar model and the data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", NETS)
def test_zoo_equals_reference(net):
    want = [dataclasses.asdict(l) for l in ref_zoo.NETWORKS[net]()]
    assert [dataclasses.asdict(l) for l in pt_zoo.NETWORKS[net]()] == want
    assert list(pt_zoo.NETWORKS) == NETS


def test_accelerators_equal_reference():
    for name in ("FLEXNN", "EYERISS", "TPU"):
        assert dataclasses.asdict(getattr(pt_em, name)) == \
            dataclasses.asdict(getattr(ref_em, name))
    for v in ("none", "weight", "two_sided"):
        assert dataclasses.asdict(pt_em.flexnn_variant(v)) == \
            dataclasses.asdict(ref_em.flexnn_variant(v))
    for name in ("PSUM_BYTES", "DATA_BYTES", "BITMAP_OVERHEAD",
                 "SCALE_BYTES", "DIMS", "_RELEVANT"):
        assert getattr(pt_em, name) == getattr(ref_em, name)
    layer = pt_em.ConvLayer.from_matmul("mm", 8, 96, 64)
    assert dataclasses.asdict(layer) == dataclasses.asdict(
        ref_em.ConvLayer.from_matmul("mm", 8, 96, 64))
    assert (layer.ix, layer.iy, layer.macs, layer.if_size, layer.fl_size,
            layer.of_size) == (8, 1, 8 * 96 * 64, 8 * 64, 96 * 64, 8 * 96)


@settings(max_examples=60, deadline=None)
@given(ox=st.integers(1, 64), oy=st.integers(1, 64), oc=st.integers(1, 512),
       icm=st.integers(1, 64), f=st.sampled_from([1, 3, 5, 7]),
       stride=st.integers(1, 2), depthwise=st.booleans(),
       b=st.lists(st.integers(0, 5), min_size=4, max_size=4),
       p=st.lists(st.integers(0, 4), min_size=5, max_size=5),
       order=st.permutations(["oc", "ic", "oy", "ox"]),
       act=st.floats(0.05, 1.0), wt=st.floats(0.05, 1.0),
       acc=st.sampled_from(sorted(REF_ACCS)), dram=st.booleans())
def test_evaluate_and_rf_feasible_equal_reference(ox, oy, oc, icm, f, stride,
                                                  depthwise, b, p, order, act,
                                                  wt, acc, dram):
    ic = oc if depthwise else icm * 4
    layer = ref_em.ConvLayer("l", ox=ox, oy=oy, oc=oc, ic=ic, fx=f, fy=f,
                             stride=stride, groups=ic if depthwise else 1)
    sched = ref_em.Schedule(order=tuple(order), b_ic=2 ** b[0],
                            b_oc=2 ** b[1], b_ox=2 ** b[2], b_oy=2 ** b[3],
                            p_ic=2 ** p[0], p_oc=2 ** p[1], p_ox=2 ** p[2],
                            p_oy=2 ** p[3], p_fy=min(2 ** p[4], f))
    sp = ref_em.SparsityStats(act_density=act, wt_density=wt)
    want = ref_em.evaluate(layer, sched, REF_ACCS[acc], sp, count_dram=dram)
    got = pt_em.evaluate(_pt(layer), _pt(sched), PT_ACCS[acc], _pt(sp),
                         count_dram=dram)
    _same_cost(got, want)
    assert got.edp == want.edp
    assert pt_em.rf_feasible(_pt(layer), _pt(sched), PT_ACCS[acc], _pt(sp)) \
        == ref_em.rf_feasible(layer, sched, REF_ACCS[acc], sp)
    assert _pt(sched).describe() == sched.describe()
    assert pt_em._expected_max_binomial(oc, wt, ox) == \
        ref_em._expected_max_binomial(oc, wt, ox)


@pytest.mark.parametrize("net", NETS)
def test_zoo_layers_under_default_schedule_equal_reference(net):
    for layer in ref_zoo.NETWORKS[net]():
        for acc in ("flexnn", "eyeriss_scaled", "tpu_scaled"):
            want = ref_em.evaluate(layer, ref_em.Schedule(), REF_ACCS[acc])
            got = pt_em.evaluate(_pt(layer), pt_em.Schedule(), PT_ACCS[acc])
            _same_cost(got, want)
            assert pt_em.rf_feasible(_pt(layer), pt_em.Schedule(),
                                     PT_ACCS[acc]) == ref_em.rf_feasible(
                layer, ref_em.Schedule(), REF_ACCS[acc])


@pytest.mark.parametrize("net", PROFILED)
def test_profiles_equal_reference(net):
    """In one process the port's profiles are the reference's (both seed
    numpy from ``hash(network)``)."""
    layers = ref_zoo.NETWORKS[net]()
    want = ref_prof.profiles_for(net, layers)
    got = pt_prof.profiles_for(net, pt_zoo.NETWORKS[net]())
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    assert pt_prof.network_sparsity(got, pt_zoo.NETWORKS[net]()) == \
        ref_prof.network_sparsity(want, layers)
    np.testing.assert_array_equal(
        pt_prof._profile(9, 0.1, 0.8, 0.5, range(1, 10), seed=3),
        ref_prof._profile(9, 0.1, 0.8, 0.5, range(1, 10), seed=3))
    with pytest.raises(KeyError):
        pt_prof.profiles_for("yolov2", [])


@pytest.mark.parametrize("n_out", [1, 3, 4, 17, 64, 1000])
def test_flextree_cycles_equal_reference(n_out):
    assert (pt_ft.MAX_EXTRACT_PER_ROUND, pt_ft.TREE_FANIN) == \
        (ref_ft.MAX_EXTRACT_PER_ROUND, ref_ft.TREE_FANIN)
    for ic_p in range(1, 17):
        assert pt_ft._tap_points(ic_p) == ref_ft._tap_points(ic_p)
        for fn in ("flextree_cycles", "fixed_tree_cycles",
                   "neighbor_chain_cycles", "flextree_speedup_vs_fixed",
                   "flextree_speedup_vs_chain"):
            assert getattr(pt_ft, fn)(n_out, ic_p) == \
                getattr(ref_ft, fn)(n_out, ic_p), (fn, ic_p)


# ---------------------------------------------------------------------------
# the vectorized grid
# ---------------------------------------------------------------------------

STATS = {"dense": ref_em.DENSE,
         "weight": ref_em.SparsityStats(act_density=1.0, wt_density=0.35),
         "two_sided": ref_em.SparsityStats(act_density=0.45,
                                           wt_density=0.35)}


@pytest.mark.parametrize("stats", sorted(STATS))
@pytest.mark.parametrize("net,idx", [("resnet50", 5), ("resnet50", 40),
                                     ("mobilenet_v2", 4), ("yolov2", 0),
                                     ("googlenet", 20),
                                     ("inception_v3", 60)])
def test_evaluate_grid_equals_reference(net, idx, stats):
    layer = ref_zoo.NETWORKS[net]()[idx]
    acc = ref_em.FLEXNN if stats == "two_sided" else \
        ref_em.flexnn_variant(stats if stats == "weight" else "none")
    sp = STATS[stats]
    ic_g = layer.ic // layer.groups
    p_sets = ref_sched._partition_sets(layer, acc, None)
    blocks = (ref_sched._pow2_factors(ic_g, acc.rf_if),
              ref_sched._pow2_factors(layer.oc, acc.rf_of),
              ref_sched._pow2_factors(layer.ox, 16),
              ref_sched._pow2_factors(layer.oy, 16))
    grid = ref_vec._candidate_grid(layer, acc, p_sets, *blocks, sp)
    pgrid = pt_vec._candidate_grid(_pt(layer), _pt(acc), p_sets, *blocks,
                                   _pt(sp), CPU)
    assert sorted(pgrid) == sorted(grid)
    for key, want in grid.items():
        assert pgrid[key].dtype == torch.int64
        np.testing.assert_array_equal(pgrid[key].numpy(), want)
    for order in ref_sched._ORDERS:
        for dram in (True, False):
            energy, cycles = ref_vec.evaluate_grid(layer, acc, grid, order,
                                                   sp, dram)
            pe, pc = pt_vec.evaluate_grid(_pt(layer), _pt(acc), pgrid, order,
                                          _pt(sp), dram)
            assert pe.dtype == pc.dtype == torch.float64
            np.testing.assert_array_equal(pe.numpy(), energy)
            assert np.all(np.abs(pc.numpy() - cycles)
                          <= 2.0 ** -49 * np.abs(cycles))


def test_grid_without_a_feasible_candidate_is_none():
    layer = ref_em.ConvLayer("wide", ox=8, oy=8, oc=8, ic=8, fx=11, fy=11)
    acc = dataclasses.replace(ref_em.TPU, rf_fl=4)
    p_sets = ref_sched._partition_sets(layer, acc, "nlr")
    assert ref_vec._candidate_grid(layer, acc, p_sets, [1], [1], [1], [1],
                                   ref_em.DENSE) is None
    assert pt_vec._candidate_grid(_pt(layer), _pt(acc), p_sets, [1], [1],
                                  [1], [1], pt_em.DENSE, CPU) is None
    _same_cost(pt_sched.optimize_layer(_pt(layer), _pt(acc), device="cpu"),
               ref_sched.optimize_layer(layer, acc))


def test_ceil_log2_is_exact():
    p = torch.arange(1, 1 << 12)
    want = torch.tensor([(int(v) - 1).bit_length() for v in p],
                        dtype=torch.float64)
    assert torch.equal(pt_vec._ceil_log2(p), want)
    assert torch.equal(pt_vec._ceil_log2(p),
                       torch.from_numpy(np.ceil(np.log2(p.numpy()))))


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("acc", ["flex_dense", "eyeriss_scaled",
                                 "tpu_scaled"])
def test_optimize_network_yolov2_fig16_equals_reference(acc):
    """All 23 yolov2 layers: ties between candidates at the minimum energy
    are the rule here, so this pins the candidate order too."""
    layers = ref_zoo.yolov2()
    want = ref_sched.optimize_network(layers, REF_ACCS[acc])
    got = pt_sched.optimize_network(pt_zoo.yolov2(), PT_ACCS[acc],
                                    device="cpu")
    assert len(got) == len(want) == 23
    for g, w in zip(got, want):
        _same_cost(g, w)


@pytest.mark.parametrize("net", ["resnet50", "resnet101", "mobilenet_v2",
                                 "googlenet", "inception_v3"])
def test_optimize_layer_sparse_profiles_equal_reference(net):
    layers = ref_zoo.NETWORKS[net]()
    sps = ref_prof.profiles_for(net, layers) if net in PROFILED else \
        [ref_em.SparsityStats(0.6, 0.4)] * len(layers)
    for i in range(0, len(layers), 7):
        want = ref_sched.optimize_layer(layers[i], ref_em.FLEXNN, sps[i])
        got = pt_sched.optimize_layer(_pt(layers[i]), pt_em.FLEXNN,
                                      _pt(sps[i]), device="cpu")
        _same_cost(got, want)


@pytest.mark.parametrize("objective", ["cycles", "edp"])
def test_optimize_layer_objectives_equal_reference(objective):
    for layer in ref_zoo.resnet50()[1:12:5]:
        sp = ref_em.SparsityStats(0.5, 0.4)
        want = ref_sched.optimize_layer(layer, ref_em.FLEXNN, sp,
                                        objective=objective,
                                        count_dram=False)
        got = pt_sched.optimize_layer(_pt(layer), pt_em.FLEXNN, _pt(sp),
                                      objective=objective, count_dram=False,
                                      device="cpu")
        _same_cost(got, want)


@pytest.mark.parametrize("dataflow", ["ws", "os", "is", "rs", "nlr"])
def test_optimize_layer_fixed_dataflows_equal_reference(dataflow):
    layers = ref_zoo.resnet50()[::9] + ref_zoo.mobilenet_v2()[2:4]
    for layer in layers:
        for acc in ("flexnn", "eyeriss_scaled"):
            want = ref_sched.optimize_layer(layer, REF_ACCS[acc],
                                            dataflow=dataflow)
            got = pt_sched.optimize_layer(_pt(layer), PT_ACCS[acc],
                                          dataflow=dataflow, device="cpu")
            _same_cost(got, want)
        assert pt_sched._partition_sets(_pt(layer), pt_em.FLEXNN,
                                        dataflow) == \
            ref_sched._partition_sets(layer, ref_em.FLEXNN, dataflow)


@pytest.mark.parametrize("dataflow", [None, "ws", "os", "is", "rs", "nlr"])
def test_enumerate_schedules_equals_reference(dataflow):
    layer = ref_em.ConvLayer("small", ox=6, oy=5, oc=24, ic=12, fx=3, fy=3)
    sp = ref_em.SparsityStats(0.7, 0.5)
    for acc in ("flexnn", "tpu_scaled"):
        want = [dataclasses.asdict(s) for s in ref_sched.enumerate_schedules(
            layer, REF_ACCS[acc], sp, dataflow=dataflow)]
        got = [dataclasses.asdict(s) for s in pt_sched.enumerate_schedules(
            _pt(layer), PT_ACCS[acc], _pt(sp), dataflow=dataflow)]
        assert got == want and len(got) > 0
    assert pt_sched._pow2_factors(24, 16) == ref_sched._pow2_factors(24, 16)
    assert pt_sched._ORDERS == ref_sched._ORDERS
    assert pt_sched._DATAFLOW_ORDERS == ref_sched._DATAFLOW_ORDERS


def test_search_entry_points_refuse_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    layer = pt_zoo.yolov2()[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_sched.optimize_layer(layer, pt_em.FLEXNN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_sched.optimize_network([layer], pt_em.FLEXNN)
