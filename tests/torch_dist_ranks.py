"""The rank side of ``test_torch_dist.py``, ``test_torch_dist_train.py``
and ``test_torch_dist_families.py``: functions that
``torch.multiprocessing`` starts on gloo ranks of one ``FileStore``.
They import the port only (never JAX): the parent writes every input to
``inputs.pt`` and reads what rank 0 writes to ``out.pt``.
"""
import datetime
import os
import time

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=60)


def spawn(fn, world: int, workdir: str, inputs):
    """Start ``fn(rank, world, workdir)`` on ``world`` ranks (not joined)
    with ``inputs`` saved for them; ``collect`` joins and reads."""
    import torch.multiprocessing as mp
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    return mp.start_processes(fn, args=(world, workdir), nprocs=world,
                              join=False, start_method="spawn")


def collect(ctx, workdir: str, timeout: float = 170.0):
    """Join the ranks (a rank's exception is raised here) and read rank 0's
    results; ranks still running after ``timeout`` seconds are killed."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")
    return torch.load(os.path.join(workdir, "out.pt"), weights_only=False)


def _init(rank, world, workdir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world, timeout=TIMEOUT)
    return torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)


def _finish(rank, workdir, out):
    if rank == 0:
        torch.save(out, os.path.join(workdir, "out.tmp"))
        os.replace(os.path.join(workdir, "out.tmp"),
                   os.path.join(workdir, "out.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _gathered(t):
    """Every rank's ``t`` (a list in rank order)."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t.contiguous())
    return out


# ---------------------------------------------------------------------------
# collectives (test_torch_dist.py)
# ---------------------------------------------------------------------------

def collectives_rank(rank, world, workdir):
    from repro_torch.core.flextree import ReduceConfig, reduce_psum
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import collectives
    from repro_torch.sharding.pipeline import pipeline_apply
    from repro_torch.train import grad_compress as gc

    inp = _init(rank, world, workdir)
    out = {}
    x = torch.from_numpy(inp["x"][rank])
    for strategy in ("allreduce", "scatter", "tree"):
        for dim in (0, 1):
            y = reduce_psum(x, ReduceConfig("model", world, strategy),
                            scatter_dim=dim)
            out[(strategy, dim)] = _gathered(y.contiguous())
    g = torch.from_numpy(inp["g"][rank])
    err = torch.from_numpy(inp["err"][rank])
    for mode in ("int8", "zvc_topk"):
        cfg = gc.CompressConfig(mode=mode, topk_frac=0.1)
        mean, new_err = gc.compressed_mean(g, err, cfg, dist.group.WORLD)
        out[mode] = (_gathered(mean), _gathered(new_err))
    # the adjoints: all_gather's is a reduce-scatter, to_model's an
    # all-reduce, from_model's the identity
    c = torch.from_numpy(inp["c"])
    for name in ("all_gather", "to_model", "from_model"):
        xr = x.clone().requires_grad_(True)
        if name == "all_gather":
            y = collectives.all_gather(xr, dist.group.WORLD, 1)
            w = c
        elif name == "to_model":
            y = collectives.to_model(xr, dist.group.WORLD)
            w = c[:, rank * x.shape[1]:(rank + 1) * x.shape[1]]
        else:
            y = collectives.from_model(xr, ReduceConfig("model", world),
                                       dist.group.WORLD)
            w = c[:, :x.shape[1]]
        (gx,) = torch.autograd.grad((y * w).sum(), xr)
        out[name] = (_gathered(y.detach()), _gathered(gx))
    if "pipe" in inp:
        pipe = inp["pipe"]
        for stages in pipe["stages"]:
            mesh = Mesh((stages, world // stages), ("pod", "data"))
            stacked = {k: torch.from_numpy(v) for k, v in pipe["params"].items()}
            n = stacked["w"].shape[0]
            staged = {k: v.reshape(stages, n // stages, *v.shape[1:])
                      for k, v in stacked.items()}
            y = pipeline_apply(
                lambda lp, h: torch.tanh(h @ lp["w"] + lp["b"]), staged,
                torch.from_numpy(pipe["x"]), mesh=mesh, axis_name="pod",
                n_micro=pipe["n_micro"])
            out[("pipe", stages)] = _gathered(y)
    _finish(rank, workdir, out)


# ---------------------------------------------------------------------------
# the sharded train steps (test_torch_dist_train.py)
# ---------------------------------------------------------------------------

def _params(tree):
    from repro_torch.convert import params_from_numpy
    return params_from_numpy(tree, device="cpu")


def _batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _sharded_steps(inp, arch, shape_axes):
    """2 sharded steps from the parent's parameters: losses, grad norms
    and the gathered params, mu and nu after each step."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import partition
    from repro_torch.train import train_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    case = inp["train"][arch]
    cfg, shape = case["cfg"], inp["shape"]
    mesh = Mesh(*shape_axes)
    rules = partition.make_rules(mesh, kind="train", n_heads=cfg.n_heads,
                                 n_kv_heads=cfg.n_kv_heads)
    step = train_step.build_train_step(cfg, shape, AdamWConfig(**inp["opt"]),
                                       mesh, rules)
    specs = train_step.param_specs(cfg, rules)
    p = partition.shard_tree(_params(case["params"]), specs, mesh)
    st = init_opt_state(p)
    rec = []
    for b in case["batches"]:
        p, st, m = step(p, st, _batch(b))
        rec.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "params": partition.gather_tree(p, specs, mesh),
                    "mu": partition.gather_tree(st.mu, specs, mesh),
                    "nu": partition.gather_tree(st.nu, specs, mesh)})
    return rec


def _dp_steps(inp, arch, mode, steps):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train import train_step
    from repro_torch.train.grad_compress import (CompressConfig,
                                                 init_error_state)
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    case = inp["dp"][arch]
    mesh = Mesh((dist.get_world_size() // 2, 2), ("data", "model"))
    step = train_step.build_dp_compressed_step(
        case["cfg"], inp["dp_shape"], AdamWConfig(**inp["opt"]), mesh,
        CompressConfig(mode=mode, topk_frac=0.1))
    p = _params(case["params"])
    st, err = init_opt_state(p), init_error_state(p)
    rec = []
    for b in case["batches"][:steps]:
        p, st, err, m = step(p, st, err, _batch(b))
        rec.append({"loss": float(m["loss"]), "params": p, "err": err})
    return rec


def _resume(inp, workdir):
    """Trainer on a (2, 2) mesh: 2 steps and a checkpoint, a fresh trainer
    resumed to 4, a straight 4-step run."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import partition
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    case = inp["train"]["stablelm-1.6b"]
    cfg, shape = case["cfg"], inp["shape"]
    mesh = Mesh((2, 2), ("data", "model"))
    rules = partition.make_rules(mesh, kind="train", n_heads=cfg.n_heads,
                                 n_kv_heads=cfg.n_kv_heads)
    ckpt = os.path.join(workdir, "ckpt")

    def trainer(steps, d):
        data = DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                          global_batch=shape.global_batch, seed=3)
        tc = TrainerConfig(steps=steps, ckpt_dir=d, ckpt_every=100, keep=2,
                           log_every=100, seed=2)
        return Trainer(cfg, shape, AdamWConfig(**inp["opt"]), tc,
                       mesh=mesh, rules=rules, pipeline=TokenPipeline(data),
                       device="cpu")

    trainer(2, ckpt).run()
    resumed = trainer(4, ckpt)
    log_r = resumed.run()
    straight = trainer(4, None)
    log_s = straight.run()
    full = [partition.gather_tree(t.params, t.specs, mesh)
            for t in (resumed, straight)]
    mu = [partition.gather_tree(t.opt_state.mu, t.specs, mesh)
          for t in (resumed, straight)]
    return {"steps": [r["step"] for r in log_r],
            "loss": (log_r[-1]["loss"], log_s[-1]["loss"]),
            "params": full, "mu": mu, "ckpt": ckpt}


def train_rank(rank, world, workdir):
    from repro_torch.launch import train as launch

    inp = _init(rank, world, workdir)
    out = {"sharded": {}, "dp": {}}
    for arch in inp["train"]:
        for mesh in inp["meshes"]:
            out["sharded"][(arch, mesh)] = _sharded_steps(
                inp, arch, (mesh, ("data", "model")))
    for arch, steps in inp["dp_steps"].items():
        for mode in ("int8", "zvc_topk"):
            out["dp"][(arch, mode)] = _dp_steps(inp, arch, mode, steps)
    out["resume"] = _resume(inp, workdir)
    out["launcher"] = [r["loss"] for r in launch.main(inp["launcher"])]
    _finish(rank, workdir, out)



# ---------------------------------------------------------------------------
# expert parallelism and the other families' sharded steps
# (test_torch_dist_families.py)
# ---------------------------------------------------------------------------

def _exchange_case(a2a, rank):
    """``collectives.all_to_all`` of this rank's x along each dim, and the
    gradient of Σ y·c."""
    from repro_torch.sharding import collectives
    out = {}
    for dim in (0, 1):
        x = torch.from_numpy(a2a["x"][rank]).requires_grad_(True)
        y = collectives.all_to_all(x, dist.group.WORLD, dim)
        c = torch.from_numpy(a2a["c"][dim][rank])
        (gx,) = torch.autograd.grad((y * c).sum(), x)
        out[dim] = (_gathered(y.detach()), _gathered(gx))
    return out


def _fetch_case(fetch, rank):
    """``collectives.fetch_columns`` of this rank's column block of the
    whole leaf: the columns it fetched and its block's gradient of
    Σ y·c."""
    from repro_torch.sharding import collectives
    w = torch.from_numpy(fetch["w"])
    n = w.shape[-1] // dist.get_world_size()
    x = w[:, rank * n:(rank + 1) * n].clone().requires_grad_(True)
    want = [torch.from_numpy(c) for c in fetch["want"]]
    y = collectives.fetch_columns(x, dist.group.WORLD, want)
    (gx,) = torch.autograd.grad((y * torch.from_numpy(
        fetch["c"][rank])).sum(), x)
    ys = [None] * dist.get_world_size()      # one width a rank
    dist.all_gather_object(ys, y.detach())
    return ys, _gathered(gx)


def _summed_over_batch(g, spec, mesh, rows):
    """A gradient of this rank's rows summed over the batch axes its leaf
    is not split on (those it is split on its FSDP gather summed); a
    gradient of the whole batch (``rows`` None: every rank holds it) over
    none, and its FSDP gather's sum divided out."""
    from repro_torch.sharding import collectives
    split = {a for ax in spec if ax is not None
             for a in ((ax,) if isinstance(ax, str) else ax)}
    if rows is None:
        return g / mesh.axis_size(tuple(a for a in ("data",) if a in split))
    return collectives.all_reduce(
        g, mesh.group(tuple(a for a in ("data",) if a not in split)))


def _moe_case(case):
    """``apply_moe`` on this rank's shards under the rules: y, and the
    gradients of Σ y·gy for every leaf and x, gathered whole.  The rows
    of x are cut over ``data`` where it divides the batch, else whole on
    every rank (``batch_shardings``' choice)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe
    from repro_torch.sharding import collectives, partition
    from repro_torch.train import train_step
    from repro_torch.train.optimizer import tree_map

    cfg = case["cfg"]
    mesh = Mesh(case["mesh"], ("data", "model"))
    rules = partition.make_rules(mesh, kind="train", n_heads=cfg.n_heads,
                                 n_kv_heads=cfg.n_kv_heads)
    full = _params(case["params"])
    specs = partition.partition_params(full, rules)
    split = case["x"].shape[0] % mesh.shape["data"] == 0
    rows = ("data" if split else None, None, None)
    x, gy = (partition.shard_leaf(torch.from_numpy(case[k]), rows, mesh)
             for k in ("x", "gy"))
    tree = {"p": partition.shard_tree(full, specs, mesh), "x": x}
    with partition.use_rules(rules, specs, rows[0]):
        fn = partition.fsdp_gathered(moe.apply_moe, specs)
        ep = moe._ep_applicable(cfg, x, rules)
        y = fn(tree["p"], cfg, x)
        _, g = train_step.value_and_grad(
            lambda t, _: (fn(t["p"], cfg, t["x"]) * gy).sum(), tree, None)
    gp = tree_map(lambda a, s: _summed_over_batch(a, s, mesh, rows[0]),
                  g["p"], specs)
    data = mesh.group("data") if split else None
    return {"ep": ep, "y": collectives.gather_dim(y, data, 0),
            "gx": collectives.gather_dim(g["x"], data, 0),
            "gp": partition.gather_tree(gp, specs, mesh)}


def _launcher_direct(argv):
    """The launcher's run, and the same steps built directly: its config,
    shape, optimizer and data through ``build_train_step`` on
    ``make_host_mesh`` from ``init_params`` at its seed."""
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as model_lib
    from repro_torch.sharding import partition
    from repro_torch.train import train_step
    from repro_torch.train.optimizer import init_opt_state

    losses = [r["loss"] for r in launch.main(argv)]
    args = launch.parse_args(argv)
    trainer = launch.make_trainer(args)
    mesh = make_host_mesh(model=args.model_shards)
    cfg = trainer.cfg
    rules = partition.make_rules(mesh, kind="train", n_heads=cfg.n_heads,
                                 n_kv_heads=cfg.n_kv_heads)
    step = train_step.build_train_step(cfg, trainer.shape, trainer.opt_cfg,
                                       mesh, rules)
    specs = train_step.param_specs(cfg, rules)
    p = partition.shard_tree(model_lib.init_params(
        cfg, torch.Generator().manual_seed(args.seed), dtype=torch.float32,
        device="cpu"), specs, mesh)
    st = init_opt_state(p)
    direct = []
    for _ in range(args.steps):
        p, st, m = step(p, st, trainer._next_batch())
        direct.append(float(m["loss"]))
    return losses, direct


def families_rank(rank, world, workdir):
    inp = _init(rank, world, workdir)
    out = {"a2a": _exchange_case(inp["a2a"], rank),
           "fetch": _fetch_case(inp["fetch"], rank),
           "moe": {k: _moe_case(c) for k, c in inp["moe"].items()},
           "sharded": {}}
    for arch in inp["train"]:
        for mesh in inp["meshes"]:
            out["sharded"][(arch, mesh)] = _sharded_steps(
                inp, arch, (mesh, ("data", "model")))
    out["launcher"] = _launcher_direct(inp["launcher"])
    _finish(rank, workdir, out)


# ---------------------------------------------------------------------------
# the sharded decode step of every family (test_torch_dist_decode.py)
# ---------------------------------------------------------------------------

def _sharded_decode(case, mesh_shape, seq_shard):
    """``case["steps"]`` decode steps of the sharded serve step from the
    parent's weights and state: every step's logits (all rows) and the
    gathered state after the last."""
    from repro_torch.configs.cells import cell_flags
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serve.engine import build_serve_step
    from repro_torch.sharding import partition
    from repro_torch.train.train_step import param_specs

    cfg = case["cfg"]
    mesh = Mesh(mesh_shape, ("data", "model"))
    flags = cell_flags(case["arch"], "decode_32k")
    rules = partition.make_rules(mesh, kind="decode", n_heads=cfg.n_heads,
                                 n_kv_heads=cfg.n_kv_heads,
                                 seq_shard=seq_shard, fsdp=flags.fsdp)
    specs = param_specs(cfg, rules)
    p = partition.shard_tree(_params(case["params"]), specs, mesh)
    state = _params(case["state"])
    st_specs = partition.batch_shardings({"state": state}, mesh,
                                         seq_shard=seq_shard)["state"]
    st = partition.shard_tree(state, st_specs, mesh)
    cache = partition.cache_axis(st_specs)
    serve = build_serve_step(cfg)
    rows = partition.batch_shardings(
        {"tokens": torch.from_numpy(case["tokens"][0])}, mesh)["tokens"]
    logits = []
    for t in range(case["tokens"].shape[0]):
        tok = partition.shard_leaf(torch.from_numpy(case["tokens"][t]),
                                   rows, mesh)
        pos = partition.shard_leaf(torch.from_numpy(case["pos"] + t),
                                   rows[:1], mesh)
        with partition.use_rules(rules, specs, rows[0], cache):
            lg, st = serve(p, tok, st, pos)
        logits.append(partition.gather_leaf(lg, rows + (None,), mesh))
    return {"logits": logits,
            "state": partition.gather_tree(st, st_specs, mesh),
            "cache": cache}


def decode_rank(rank, world, workdir):
    inp = _init(rank, world, workdir)
    out = {}
    for arch, case in inp["cases"].items():
        for mesh in inp["meshes"]:
            for seq_shard in (False, True):
                out[(arch, mesh, seq_shard)] = _sharded_decode(
                    case, mesh, seq_shard)
    _finish(rank, workdir, out)
