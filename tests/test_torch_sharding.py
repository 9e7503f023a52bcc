"""The port's partition rules and local shards against the JAX package's,
in one process (no process group): every config's parameter specs and
decode-state / input specs equal the reference's ``partition_params`` /
``batch_shardings`` on ``jax.sharding.AbstractMesh`` (2, 4), (1, 8),
(16, 16) and (2, 16, 16), with ``fsdp`` on and off; ``shard_leaf`` /
``assemble_leaf`` round trips (the head-aligned ``wkv`` among them); the
analytic helpers (``bubble_fraction``, ``wire_bytes_per_element``) and
``quantize_int8``'s bits; ``decode_exec_config(model_shards=4)`` site by
site; the sharded step on a mesh of one rank bit-equal to the unsharded
step; and the refusals (a non-dense family over a model axis above 1).
The multi-rank collectives are in ``test_torch_dist.py`` and
``test_torch_dist_train.py``.  Everything compared here is exact."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import base as ref_base
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro.sharding import partition as ref_part
from repro.sharding import pipeline as ref_pipe
from repro.train import grad_compress as ref_gc
from repro_torch.configs import base as pt_base
from repro_torch.data.pipeline import with_frontend_inputs
from repro_torch.launch import mesh as pt_mesh
from repro_torch.models import model as pt_model
from repro_torch.serve import engine as pt_engine
from repro_torch.sharding import partition as pt_part
from repro_torch.sharding import pipeline as pt_pipe
from repro_torch.train import grad_compress as pt_gc
from repro_torch.train import train_step as pt_step
from repro_torch.train.optimizer import (AdamWConfig, init_opt_state,
                                         tree_leaves)

MESHES = [((2, 4), ("data", "model")), ((1, 8), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work (set back after):
    next to the suite's other workers and the spawned ranks, more threads
    only contend for the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_specs(tree):
    return {path: tuple(s.spec) for path, s in ref_part.tree_paths(tree).items()}


def _meta(tree):
    """The reference's ShapeDtypeStruct tree as nested dicts of meta
    tensors (what the port's rules read: shapes)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), device="meta")


@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_param_specs_equal_the_reference(arch):
    """``param_shapes`` is the reference's tree; ``make_rules`` and
    ``partition_params`` give every leaf the reference's spec."""
    cfg = pt_base.get_config(arch)
    rcfg = ref_base.get_config(arch)
    ref_sds = jax.eval_shape(
        lambda: ref_model.init_params(rcfg, jax.random.PRNGKey(0)))
    shapes = pt_model.param_shapes(cfg)
    assert {p: tuple(x.shape) for p, x in pt_part.tree_paths(shapes).items()} \
        == {p: tuple(x.shape) for p, x in ref_part.tree_paths(ref_sds).items()}
    for shape, names in MESHES:
        rmesh = AbstractMesh(shape, names)
        pmesh = pt_mesh.Mesh(shape, names)
        for fsdp in (True, False):
            kw = dict(kind="train", n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, fsdp=fsdp)
            rrules = ref_part.make_rules(rmesh, **kw)
            prules = pt_part.make_rules(pmesh, **kw)
            assert prules.logical == rrules.logical
            got = pt_part.tree_paths(pt_part.partition_params(shapes, prules))
            want = _ref_specs(ref_part.partition_params(ref_sds, rrules))
            assert got == want, (shape, fsdp)


@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_input_and_state_specs_equal_the_reference(arch):
    """``batch_shardings`` of the train inputs and of the decode inputs
    (the nested decode state), with and without ``seq_shard``."""
    rcfg = ref_base.get_config(arch)
    cells = [ref_model.input_specs(rcfg, ref_base.SHAPES["train_4k"]),
             ref_model.input_specs(rcfg, ref_base.SHAPES["decode_32k"])]
    for shape, names in MESHES:
        rmesh = AbstractMesh(shape, names)
        pmesh = pt_mesh.Mesh(shape, names)
        for specs in cells:
            for seq_shard in (False, True):
                got = pt_part.tree_paths(pt_part.batch_shardings(
                    _meta(specs), pmesh, seq_shard=seq_shard))
                want = _ref_specs(ref_part.batch_shardings(
                    specs, rmesh, seq_shard=seq_shard))
                assert got == want, (shape, seq_shard)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1), (2, 2, 2)])
def test_shard_and_assemble_round_trip(shape):
    """Every leaf of every smoke config's tree: the ranks' blocks assemble
    into the leaf (``gather_leaf`` all-gathers the blocks and assembles
    them so); a split ``wkv`` holds the K and V columns of the same kv
    heads."""
    names = ("pod", "data", "model")[-len(shape):]
    mesh = pt_mesh.Mesh(shape, names)
    for arch in ref_base.ARCH_IDS:
        cfg = pt_base.get_smoke_config(arch)
        params = pt_model.init_params(cfg, torch.Generator().manual_seed(1),
                                      dtype=torch.float32, device="cpu")
        rules = pt_part.make_rules(mesh, kind="train", n_heads=cfg.n_heads,
                                   n_kv_heads=cfg.n_kv_heads)
        specs = pt_part.partition_params(params, rules)
        for path, x in pt_part.tree_paths(params).items():
            spec = pt_part.tree_paths(specs)[path]
            pieces = [pt_part.shard_leaf(x, spec, mesh, path=path, rank=r)
                      for r in range(mesh.size)]
            assert torch.equal(pt_part.assemble_leaf(pieces, spec, mesh,
                                                     path=path), x), path
            if path.endswith("wkv") and "model" in spec:
                m, hd, kvh = mesh.shape["model"], cfg.head_dim, cfg.n_kv_heads
                per = kvh * hd // m
                for r in range(mesh.size):
                    j = mesh.axis_index("model", r)
                    rows = pt_part.shard_leaf(
                        x, tuple(a if a == "model" else None for a in spec),
                        mesh, path=path, rank=r)
                    k = x[..., j * per:(j + 1) * per]
                    v = x[..., kvh * hd + j * per:kvh * hd + (j + 1) * per]
                    assert torch.equal(rows, torch.cat([k, v], -1)), path


def test_shard_leaf_of_an_unsplit_leaf_is_the_leaf():
    mesh = pt_mesh.Mesh((1, 1), ("data", "model"))
    x = torch.randn(4, 6)
    assert pt_part.shard_leaf(x, ("data", "model"), mesh) is x
    assert pt_part.shard(x, "batch", None) is x


def test_bubble_fraction_and_wire_bytes():
    for s, m in ((2, 4), (4, 12), (1, 8), (4, 3)):
        assert pt_pipe.bubble_fraction(s, m) == ref_pipe.bubble_fraction(s, m)
    for mode in ("none", "int8", "zvc_topk"):
        for frac in (0.05, 0.25):
            for b in (2, 4):
                assert pt_gc.wire_bytes_per_element(
                    pt_gc.CompressConfig(mode=mode, topk_frac=frac), b) == \
                    ref_gc.wire_bytes_per_element(
                        ref_gc.CompressConfig(mode=mode, topk_frac=frac), b)


def test_split_stages_equals_the_reference():
    x = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    got = pt_pipe.split_stages({"w": torch.from_numpy(x)}, 4)["w"]
    want = ref_pipe.split_stages({"w": x}, 4)["w"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_int8_bits_equal_the_reference():
    rng = np.random.default_rng(0)
    for scale in (1e-6, 1.0, 3e3):
        x = (rng.standard_normal((64, 48)) * scale).astype(np.float32)
        x[0, :5] = [0.5, -0.5, 1.5, 2.5, -2.5]       # ties round to even
        q, s = pt_gc.quantize_int8(torch.from_numpy(x))
        rq, rs = ref_gc.quantize_int8(jax.numpy.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert s.numpy().tobytes() == np.asarray(rs).tobytes()
        np.testing.assert_array_equal(
            pt_gc.dequantize_int8(q, s).numpy(),
            np.asarray(ref_gc.dequantize_int8(rq, rs)))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "yi-9b", "gemma-2b",
                                  "chatglm3-6b", "deepseek-moe-16b",
                                  "recurrentgemma-9b", "mamba2-1.3b"])
def test_decode_exec_config_model_shards(arch):
    """``decode_exec_config(cfg, 4, model_shards=4)`` is the reference's
    table site by site (shard shapes, K-sharded combines over 4)."""
    cfg = pt_base.get_config(arch)
    pt = pt_engine.decode_exec_config(cfg, 4, model_shards=4, device="cpu")
    ref = ref_engine.decode_exec_config(ref_base.get_config(arch), 4,
                                        model_shards=4)
    assert pt.model_shards == ref.model_shards == 4
    assert list(pt.schedules.sites) == list(ref.schedules.sites)
    for s, d in pt.schedules.sites.items():
        assert d.describe() == ref.schedules.sites[s].describe()
    assert all(d.reduce.ic_p == (4 if s.endswith((".out", "out_proj")) else 1)
               for s, d in pt.schedules.sites.items())


def test_recalibration_keeps_model_shards():
    cfg = dataclasses.replace(
        pt_base.get_smoke_config("edge-tiny"),
        sparsity=pt_base.SparsityConfig(activation_threshold=0.05))
    ec = pt_engine.decode_exec_config(cfg, 2, collect_stats=True,
                                      model_shards=2, device="cpu")
    params = pt_model.init_params(cfg, torch.Generator().manual_seed(0),
                                  dtype=torch.float32, device="cpu")
    eng = pt_engine.ServeEngine(cfg, params, n_slots=2, max_seq=32,
                                exec_cfg=ec, device="cpu")
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new=3)
    eng.run_until_drained()
    assert eng.maybe_recalibrate(drift_threshold=-1.0) is not None
    assert eng.exec_cfg is not ec and eng.exec_cfg.model_shards == 2


def _smoke_step_inputs(cfg, seed=0):
    shape = pt_base.ShapeConfig(name="t", kind="train", seq_len=32,
                                global_batch=4, loss_chunk=16,
                                attn_chunk=16, remat="full", n_micro=2)
    params = pt_model.init_params(cfg, torch.Generator().manual_seed(seed),
                                  dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    return shape, params, batch


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma-2b"])
def test_step_on_one_rank_is_the_unsharded_step(arch):
    """A mesh of one rank takes the unsharded arithmetic: two sharded
    steps equal two ``make_step_fn`` steps bit for bit (loss, metrics,
    parameters, moments); one perturbed weight moves the loss."""
    cfg = pt_base.get_smoke_config(arch)
    shape, params, batch = _smoke_step_inputs(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    mesh = pt_mesh.make_host_mesh(model=1)
    rules = pt_part.make_rules(mesh, kind="train", n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads)
    runs = []
    for step in (pt_step.make_step_fn(cfg, shape, opt),
                 pt_step.build_train_step(cfg, shape, opt, mesh, rules)):
        p, st = params, init_opt_state(params)
        for _ in range(2):
            p, st, m = step(p, st, batch)
        runs.append((p, st, m))
    (p0, st0, m0), (p1, st1, m1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for a, b in zip(tree_leaves({"p": p0, "mu": st0.mu, "nu": st0.nu}),
                    tree_leaves({"p": p1, "mu": st1.mu, "nu": st1.nu})):
        assert torch.equal(a, b)
    moved = {**params, "final_norm": {
        k: v + (0.01 if k == "scale" else 0.0)
        for k, v in params["final_norm"].items()}}
    step = pt_step.build_train_step(cfg, shape, opt, mesh, rules)
    _, _, mc = step(moved, init_opt_state(moved), batch)
    _, _, m_first = step(params, init_opt_state(params), batch)
    assert not torch.equal(mc["loss"], m_first["loss"])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "recurrentgemma-9b",
                                  "mamba2-1.3b", "whisper-tiny",
                                  "qwen2-vl-72b", "llama4-scout-17b-a16e"])
def test_other_families_refuse_a_model_axis(arch):
    """Every family beyond the dense one builds its sharded step at a
    model axis above 1 (the 4-rank runs are ``test_torch_dist_families
    .py``), and on a one-rank mesh the sharded step's gradients equal the
    unsharded ones bit for bit."""
    cfg = pt_base.get_smoke_config(arch)
    shape, params, batch = _smoke_step_inputs(cfg)
    batch = {k: torch.from_numpy(v) for k, v in with_frontend_inputs(
        {k: v.numpy() for k, v in batch.items()}, cfg,
        n_vis=pt_model.n_vis(cfg, 32)).items()}
    for grid in ((2, 2), (4, 1)):
        mesh = pt_mesh.Mesh(grid, ("data", "model"))
        pt_step.build_train_step(cfg, shape, AdamWConfig(), mesh,
                                 pt_part.make_rules(mesh, kind="train",
                                                    n_heads=cfg.n_heads,
                                                    n_kv_heads=cfg.n_kv_heads))
    mesh = pt_mesh.make_host_mesh(model=1)
    rules = pt_part.make_rules(mesh, kind="train", n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads)
    l0, g0 = pt_step.build_grad_fn(cfg, shape)(params, batch)
    l1, g1 = pt_step.build_grad_fn(cfg, shape, mesh, rules)(params, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_production_meshes():
    single = pt_mesh.make_production_mesh()
    multi = pt_mesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert pt_mesh.mesh_chips(single) == 256 and pt_mesh.mesh_chips(multi) == 512
    assert not single.distributed
    assert multi.axis_index(("pod", "data"), rank=16 * 17 + 3) == 17
    with pytest.raises(ValueError):
        pt_mesh.make_host_mesh(model=2)       # one process: no 2 shards
