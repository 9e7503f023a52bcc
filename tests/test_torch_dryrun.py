"""The dry-run and roofline tooling of the port against the JAX package's
on everything whose answer the reference defines (no card, no JAX in the
port):

- the cell grid: ``cells`` (with and without the skipped cells),
  ``shape_applicable``, ``scaled_shape``, ``cell_shape``, ``cell_flags``
  and ``clamp_micro`` at dp 1, 2, 16, 32, for every cell;
- ``model.input_specs``: shapes and dtypes of every arch × shape at full
  width (meta tensors, the decode state traced without storage);
- the roofline arithmetic: ``structure_points`` and
  ``model_flops_per_device`` for every arch, ``fit_and_extrapolate`` on a
  synthetic case and on random points, ``micro_points`` (the port's grid
  starts at 2 microbatches);
- the collective counters of ``sharding.collectives`` on a fake process
  group of 2, 4 and 16 ranks: each primitive's counted operand and wire
  bytes are the reference's ``CollectiveOp`` of the same result;
- ``roofline.memory.MemoryTracker`` on a hand-computed sequence, and a
  traced train step's bytes equal to the same step's on real tensors;
- ``build_cell_step`` + ``trace_cell`` on a fake (2, 4) mesh for a smoke
  config of every family (dense, MoE, SSM, Griffin, Whisper, VLM) in
  train, prefill and decode (SP off and on): the argument bytes of the
  rank equal the shard sizes that the reference's ``partition_params``
  and ``batch_shardings`` give its own shapes;
- ``analyze_cell``'s fit at full depth and microbatch count equals a
  direct trace there, for every metric;
- the dry-run CLI on a small cell in a subprocess writes its record.
"""
import contextlib
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import base as ref_base
from repro.models import model as ref_model
from repro.roofline import analysis as ref_analysis
from repro.roofline.hlo import CollectiveOp as RefCollectiveOp
from repro.sharding import partition as ref_part
from repro_torch.configs import base as pt_base
from repro_torch.configs import cells as pt_cells
from repro_torch.core.flextree import ReduceConfig, reduce_psum
from repro_torch.launch import step_builders as sb
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as pt_model
from repro_torch.roofline import analysis as pt_analysis
from repro_torch.roofline.memory import MemoryTracker
from repro_torch.sharding import collectives
from repro_torch.train.optimizer import init_opt_state

# the package's ``configs`` exports a function named ``cells`` too
ref_cells = importlib.import_module("repro.configs.cells")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_CELLS = list(ref_base.cells(include_skipped=True))


@contextlib.contextmanager
def fake_group(world):
    """This process as rank 0 of a fake process group of ``world``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _asdict(x):
    return dataclasses.asdict(x)


# ---------------------------------------------------------------------------
# the cell grid
# ---------------------------------------------------------------------------

def test_cells_are_the_references():
    assert list(pt_base.cells()) == list(ref_base.cells())
    assert list(pt_base.cells(include_skipped=True)) == ALL_CELLS
    assert len(list(pt_base.cells())) == 32 and len(ALL_CELLS) == 40
    assert pt_base.CELL_ARCH_IDS == ref_base.ARCH_IDS
    for arch, shape in ALL_CELLS:
        assert pt_base.shape_applicable(
            pt_base.get_config(arch), pt_base.SHAPES[shape]) == \
            ref_base.shape_applicable(ref_base.get_config(arch),
                                      ref_base.SHAPES[shape])
    for kw in ({}, {"seq": 64}, {"batch": 8}, {"seq": 128, "batch": 2,
                                                "n_micro": 4}):
        for name in pt_base.SHAPES:
            assert _asdict(pt_base.scaled_shape(pt_base.SHAPES[name], **kw)) \
                == _asdict(ref_base.scaled_shape(ref_base.SHAPES[name], **kw))


@pytest.mark.parametrize("arch,shape", ALL_CELLS)
def test_cell_knobs_are_the_references(arch, shape):
    got, want = pt_cells.cell_shape(arch, shape), ref_cells.cell_shape(
        arch, shape)
    assert _asdict(got) == _asdict(want)
    assert _asdict(pt_cells.cell_flags(arch, shape)) == _asdict(
        ref_cells.cell_flags(arch, shape))
    for dp in (1, 2, 16, 32):
        assert _asdict(pt_cells.clamp_micro(got, dp)) == _asdict(
            ref_cells.clamp_micro(want, dp))


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace(
        "torch.", ""))}


@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_input_specs_are_the_references(arch):
    cfg, rcfg = pt_base.get_config(arch), ref_base.get_config(arch)
    for name in pt_base.SHAPES:
        got = pt_model.input_specs(cfg, pt_base.SHAPES[name])
        assert all(t.device.type == "meta"
                   for t in jax.tree.leaves(got) if hasattr(t, "device"))
        want = ref_model.input_specs(rcfg, ref_base.SHAPES[name])
        assert _leaves(got) == _leaves(want), name


# ---------------------------------------------------------------------------
# roofline arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_structure_grid_and_model_flops_are_the_references(arch):
    cfg, rcfg = pt_base.get_config(arch), ref_base.get_config(arch)
    pts, full = pt_analysis.structure_points(cfg)
    rpts, rfull = ref_analysis.structure_points(rcfg)
    assert full == rfull
    assert [(c.n_layers, phi) for c, phi in pts] == \
        [(c.n_layers, phi) for c, phi in rpts]
    for name in pt_base.SHAPES:
        shape = pt_cells.cell_shape(arch, name)
        rshape = ref_cells.cell_shape(arch, name)
        for n in (1, 256, 512):
            assert pt_analysis.model_flops_per_device(cfg, shape, n) == \
                ref_analysis.model_flops_per_device(rcfg, rshape, n)
        # the port traces the cell's own microbatch count, the count the
        # reference's grid is fitted to (roofline.analysis docstring)
        ms, m_full = pt_analysis.micro_points(shape)
        rms, rm_full = ref_analysis.micro_points(rshape)
        assert m_full == rm_full and ms == [m_full]


def test_fit_and_extrapolate_is_the_references():
    assert pt_analysis.METRICS == ref_analysis.METRICS
    # synthetic: metric = 3 + 5·L exactly
    pts = [([1.0, float(L)], {m: 3.0 + 5.0 * L for m in pt_analysis.METRICS})
           for L in (1, 2)]
    got = pt_analysis.fit_and_extrapolate(pts, [1.0, 24.0])
    assert all(v == pytest.approx(123.0) for v in got.values())
    rng = np.random.default_rng(0)
    for n_feat, n_pts in ((2, 2), (4, 4), (3, 3), (6, 6)):
        pts = [(list(rng.random(n_feat)),
                {m: float(rng.random() * 1e12) for m in pt_analysis.METRICS})
               for _ in range(n_pts)]
        phi = list(rng.random(n_feat) * 10)
        assert pt_analysis.fit_and_extrapolate(pts, phi) == \
            ref_analysis.fit_and_extrapolate(pts, phi)


# ---------------------------------------------------------------------------
# collective counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [2, 4, 16])
def test_collective_counters_follow_the_reference(g):
    x = torch.zeros((g * 3, 5), dtype=torch.bfloat16)
    nb = x.numel() * x.element_size()
    with fake_group(g), collectives.counting() as summary:
        grp = dist.group.WORLD
        collectives.gather_dim(x, grp, 1)            # result g·nb
        collectives.scatter_sum_dim(x, grp, 0)       # result nb / g
        collectives.exchange(x, grp, 0)              # result nb
        collectives._exchange_parts(x, [3] * g, [3] * g, grp)
        collectives.all_reduce(x, grp)               # result nb
        reduce_psum(x, ReduceConfig("model", g, "allreduce"), group=grp)
        reduce_psum(x, ReduceConfig("model", g, "scatter"), group=grp)
    want = [RefCollectiveOp("all-gather", g * nb, g),
            RefCollectiveOp("reduce-scatter", nb // g, g),
            RefCollectiveOp("all-to-all", nb, g),
            RefCollectiveOp("all-to-all", nb, g),
            RefCollectiveOp("all-reduce", nb, g),
            RefCollectiveOp("all-reduce", nb, g),
            RefCollectiveOp("reduce-scatter", nb // g, g)]
    assert [(o.kind, o.result_bytes, o.group_size) for o in summary.ops] == \
        [(o.kind, o.result_bytes, o.group_size) for o in want]
    for got, ref in zip(summary.ops, want):
        assert got.operand_bytes == ref.operand_bytes
        assert got.wire_bytes == ref.wire_bytes
    assert summary.operand_bytes == sum(o.operand_bytes for o in want)
    assert summary.wire_bytes == sum(o.wire_bytes for o in want)
    kinds = summary.by_kind()
    assert kinds["all-to-all"]["count"] == 2
    assert kinds["all-gather"]["operand_bytes"] == nb
    # nothing is counted outside ``counting``
    with fake_group(g):
        collectives.all_reduce(x, dist.group.WORLD)
    assert len(summary.ops) == len(want)


# ---------------------------------------------------------------------------
# the memory tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_memory_tracker_peak_by_hand(fake):
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode() if fake else contextlib.nullcontext()
    with mode:
        a = torch.empty(1024)                          # 4096 B argument
        with MemoryTracker(granule=1) as mt:
            assert mt.add_args(a, a.view(2, 512)) == 4096
            b = torch.empty(256)                       # 5120
            c = a * 2                                  # 9216
            del b                                      # 8192
            c.add_(1)                                  # in place: 8192
            a[:10].copy_(c[:10])                       # in place
            d = c.view(-1)                             # a view: 8192
            e = torch.cat([c, c])                      # 16384: the peak
            del e, c                                   # 8192 (d holds c)
            assert (mt.live, mt.peak) == (8192, 16384)
            assert mt.outputs({"d": d, "a": a}) == 4096
        with MemoryTracker() as mt:                    # 512-byte blocks
            mt.add_args(a)
            x = torch.empty(3)                         # 12 B -> 512
            y = torch.empty(200)                       # 800 B -> 1024
            assert mt.peak == 4096 + 512 + 1024
            del x, y


def test_traced_peak_is_the_real_steps():
    """A train step traced on fake tensors and the same step run on real
    ones, both under the tracker: the same argument, peak and output
    bytes (the step holds no reference cycle that keeps a microbatch's
    gradients alive until the garbage collector runs)."""
    cfg = dataclasses.replace(pt_base.get_smoke_config("stablelm-1.6b"),
                              n_layers=2)
    shape = pt_base.ShapeConfig("t", "train", 32, 4, n_micro=2,
                                loss_chunk=16, attn_chunk=16)
    step = sb.build_cell_step("stablelm-1.6b", "train_4k",
                              Mesh((1, 1), ("data", "model")), cfg=cfg,
                              shape=shape, exec_cfg=None)
    traced = sb.trace_cell(step, device="cpu")["memory"]
    params = pt_model.init_params(cfg, torch.Generator().manual_seed(0),
                                  dtype=torch.bfloat16, device="cpu")
    opt = init_opt_state(params)
    batch = {k: torch.randint(0, cfg.vocab, (4, 32), dtype=torch.int32)
             for k in ("tokens", "labels")}
    with MemoryTracker() as mt:
        mt.add_args(params, opt, batch)
        out = step.fn(params, opt, batch)
        out_bytes = mt.outputs(out)
        del out
    assert (mt.argument_bytes, mt.peak, out_bytes) == (
        traced["argument_bytes"], traced["peak_bytes"],
        traced["output_bytes"])


# ---------------------------------------------------------------------------
# argument bytes of a traced cell, against the reference's shard sizes
# ---------------------------------------------------------------------------

FAMILIES = ("stablelm-1.6b", "deepseek-moe-16b", "mamba2-1.3b",
            "recurrentgemma-9b", "whisper-tiny", "qwen2-vl-72b")
KINDS = (("train", False), ("prefill", False), ("decode", False),
         ("decode", True))
SMALL = {"train": dict(seq_len=32, global_batch=8, n_micro=2, loss_chunk=16,
                       attn_chunk=16),
         "prefill": dict(seq_len=32, global_batch=8, attn_chunk=16),
         "decode": dict(seq_len=64, global_batch=8)}
_NAMES = {"train": "train_4k", "prefill": "prefill_32k",
          "decode": "decode_32k"}
_DTYPE_BYTES = {"bfloat16": 2, "float32": 4, "int32": 4}


def _shard_bytes(sds_tree, spec_tree, mesh_shape):
    total = 0
    sds = ref_part.tree_paths(sds_tree)
    specs = ref_part.tree_paths(spec_tree)
    for path, leaf in sds.items():
        split = 1
        for ax in tuple(specs[path].spec):
            for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                split *= mesh_shape[a]
        total += math.prod(leaf.shape) // split * _DTYPE_BYTES[
            str(leaf.dtype)]
    return total


def _reference_argument_bytes(arch, kind, seq_shard):
    rcfg = ref_base.get_smoke_config(arch)
    shape = dataclasses.replace(ref_base.SHAPES[_NAMES[kind]], **SMALL[kind])
    mshape = {"data": 2, "model": 4}
    rmesh = AbstractMesh((2, 4), ("data", "model"))
    fsdp = kind == "train" or ref_cells.cell_flags(
        arch, _NAMES[kind]).fsdp
    rules = ref_part.make_rules(rmesh, kind=kind, n_heads=rcfg.n_heads,
                                n_kv_heads=rcfg.n_kv_heads,
                                seq_shard=seq_shard, fsdp=fsdp)
    p = jax.eval_shape(lambda: ref_model.init_params(
        rcfg, jax.random.PRNGKey(0)))
    p_specs = ref_part.partition_params(p, rules)
    specs = ref_model.input_specs(rcfg, shape)
    total = _shard_bytes(p, p_specs, mshape)
    total += _shard_bytes(specs, ref_part.batch_shardings(
        specs, rmesh, seq_shard=seq_shard), mshape)
    if kind == "train":             # AdamW: two float32 moments and a step
        f32 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape,
                                                          jnp.float32), p)
        total += 2 * _shard_bytes(f32, p_specs, mshape) + 4
    return total, shape


@pytest.mark.parametrize("kind,seq_shard", KINDS,
                         ids=["train", "prefill", "decode-tp", "decode-sp"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_traced_argument_bytes_are_the_reference_shards(arch, kind,
                                                        seq_shard):
    want, rshape = _reference_argument_bytes(arch, kind, seq_shard)
    cfg = pt_base.get_smoke_config(arch)
    shape = pt_base.ShapeConfig(**dataclasses.asdict(rshape))
    flags = pt_cells.CellFlags(
        seq_shard=seq_shard,
        fsdp=kind == "train" or pt_cells.cell_flags(arch, _NAMES[kind]).fsdp)
    with fake_group(8):
        step = sb.build_cell_step(arch, _NAMES[kind],
                                  Mesh((2, 4), ("data", "model")), cfg=cfg,
                                  shape=shape, flags=flags)
        got = sb.trace_cell(step)
    mem = got["memory"]
    assert mem["argument_bytes"] == want
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert got["flops"] > 0 and got["bytes"] > 0
    # the kernels' traced route (an SSM's training step has no kernel
    # site: its projections are bare products and its head the loss's)
    assert got["kernel_calls"] > 0 or (cfg.ssm.enabled and kind == "train")
    if kind == "decode":                      # only the logits come out
        assert mem["output_bytes"] == (shape.global_batch // 2) * cfg.vocab * 4


# ---------------------------------------------------------------------------
# the fit is exact at full depth
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layers,micro", [("stablelm-1.6b", 4, 2),
                                               ("recurrentgemma-9b", 8, 1)])
def test_fit_at_full_depth_is_a_direct_trace(arch, layers, micro, tmp_path):
    """On the single-pod mesh: 4 layers from the points at 1 and 2;
    Griffin's 2 groups and 2 trailing layers from (1, 0), (2, 0),
    (1, 1) — each equal to a direct trace at full depth."""
    cfg = dataclasses.replace(pt_base.get_smoke_config(arch),
                              n_layers=layers)
    shape = pt_base.ShapeConfig("t", "train", 32, 64, n_micro=micro,
                                loss_chunk=32, attn_chunk=32)
    rec = pt_analysis.analyze_cell(arch, "train_4k", str(tmp_path),
                                   cfg_override=cfg, shape_override=shape)
    try:
        from repro_torch.launch.mesh import make_production_mesh
        step = sb.build_cell_step(arch, "train_4k", make_production_mesh(),
                                  cfg=cfg,
                                  shape=pt_analysis.coarse_shape(shape))
        direct = pt_analysis.point_metrics(sb.trace_cell(step))
    finally:
        dist.destroy_process_group()
    assert rec["n_micro"] == micro and len(rec["points"]) >= 2
    for m in pt_analysis.METRICS:
        assert rec["metrics_per_device"][m] == pytest.approx(
            direct[m], rel=1e-9, abs=1e-3), m
    assert direct["flops"] > 0 and direct["coll_wire"] > 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.timeout(300)
def test_dryrun_cli_writes_its_record(tmp_path):
    out = tmp_path / "dryrun"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=280,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads((out / "single" / "whisper-tiny@decode_32k.json")
                     .read_text())
    assert rec["ok"] and rec["fits_hbm"] and rec["devices"] == 256
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["cost"]["flops"] > 0 and rec["collectives"]["count"] > 0
    assert rec["sites"]
    assert "1/1 cells passed" in proc.stdout
