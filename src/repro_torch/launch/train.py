"""End-to-end training launcher, the reference's ``launch/train.py`` with
``--device`` (default ``cuda``):

    python -m repro_torch.launch.train --arch stablelm-1.6b --steps 4 \\
        --batch 4 --seq 4096 --n-micro 2 --remat full

``--smoke`` selects the reduced config of the same family (CPU-scale; with
``--device cpu``).  Every ported family trains: dense, MoE, Griffin, SSM
and the Whisper encoder-decoder (its ``frames`` are the pipeline's stub
frontend inputs).  On CUDA the parameters are bf16 and every matmul site
and the flash branch run the hand-written kernels, forward and backward,
under the descriptor table compiled for the train shape (M = batch · seq,
the H100 selector); on the CPU the parameters are float32 and the plain
path runs, as in the reference.  The trainer provides auto-resume, atomic
keep-k checkpoints and the step watchdog (``train.trainer``).

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``) the process group is initialised —
``nccl`` on CUDA (device ``cuda:LOCAL_RANK``), ``gloo`` on the CPU — unless
the caller already did; with more than one rank, or ``--model-shards``
above 1, the step is sharded over ``make_host_mesh(model=model_shards)``
(FSDP over ``data``, tensor parallelism over ``model`` for every
family, expert parallelism over ``model`` for a MoE whose experts and
sequence split over it), as the reference builds its mesh:

    torchrun --nproc_per_node 4 -m repro_torch.launch.train \
        --arch deepseek-moe-16b --smoke --device cpu --model-shards 2
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-shards", type=int, default=1,
                    help="TP degree over the ranks")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def make_trainer(args: argparse.Namespace, cfg=None):
    """The ``Trainer`` the command line describes (not yet run); ``cfg``,
    when given, is trained in place of the config ``--arch`` names (the
    same model at a cut depth, say)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import (ShapeConfig, get_config,
                                          get_smoke_config)
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.engine import shape_exec_config
    from repro_torch.sharding.partition import make_rules
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    elif dev.type == "cuda" and dist.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    if cfg is None:
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))
    shape = ShapeConfig(name="cli", kind="train", seq_len=args.seq,
                        global_batch=args.batch, n_micro=args.n_micro,
                        remat=args.remat, loss_chunk=min(128, args.seq),
                        attn_chunk=min(128, args.seq))
    mesh = rules = None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.model_shards > 1 or world > 1:
        mesh = make_host_mesh(model=args.model_shards)
        rules = make_rules(mesh, kind="train", n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads)
    exec_cfg = None
    if dev.type == "cuda":
        exec_cfg = shape_exec_config(cfg, shape, use_kernels=True,
                                     model_shards=args.model_shards,
                                     device=dev)
    pipeline = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch,
                                        seed=args.seed))
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every,
                         log_every=args.log_every, seed=args.seed)
    return Trainer(cfg, shape, opt, tcfg, mesh=mesh, rules=rules,
                   pipeline=pipeline,
                   dtype=torch.bfloat16 if dev.type == "cuda"
                   else torch.float32,
                   exec_cfg=exec_cfg, device=dev)


def main(argv: Optional[List[str]] = None) -> list:
    trainer = make_trainer(parse_args(argv))
    log = trainer.run()
    if trainer.rank0:
        print(f"done: {len(log)} steps, "
              f"final loss {log[-1]['loss']:.4f}" if log else "no steps run")
    return log


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
