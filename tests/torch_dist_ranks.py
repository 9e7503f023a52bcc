"""The rank side of ``test_torch_dist.py`` and ``test_torch_dist_train.py``:
functions that ``torch.multiprocessing`` starts on gloo ranks of one
``FileStore``.  They import the port only (never JAX): the parent writes
every input to ``inputs.pt`` and reads what rank 0 writes to ``out.pt``.
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

