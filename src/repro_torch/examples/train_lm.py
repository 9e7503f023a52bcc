"""End-to-end training driver, the JAX package's ``examples/train_lm.py``
on PyTorch: train a ~100M-parameter dense LM for a few hundred steps with
checkpoints, auto-resume, the step watchdog and the deterministic data
pipeline — the production loop at a small scale.

Run:  python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]

The config is a scaled stablelm-family decoder (8 layers × d 512 with the
full 100352-token vocabulary).  On CUDA (the default) the weights are bf16
and every matmul site runs the train table's hand-written kernels,
forward and backward (as ``launch.train``); on the CPU the weights are
float32 and the plain path runs, as in the reference.  Checkpoints go to
``--ckpt-dir`` (default: ``flexnn_train_lm`` under the temporary
directory).  ``make_trainer(args, cfg=None)`` builds the trainer without
running it (``cfg`` replaces the ~100M model).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional


def lm_100m():
    """~100M-parameter stablelm-family decoder (8L × 512d × 100352 vocab)."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(
        name="stablelm-100m", family="dense",
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=8, d_ff=1408,
        vocab=100_352, norm="layernorm", act="silu", rope="partial25",
    )


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "flexnn_train_lm"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def make_trainer(args: argparse.Namespace, cfg=None):
    """The ``Trainer`` of the command line (not yet run)."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.serve.engine import shape_exec_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    cfg = cfg or lm_100m()
    shape = ShapeConfig(name="train", kind="train", seq_len=args.seq,
                        global_batch=args.batch, n_micro=2, remat="dots",
                        loss_chunk=min(128, args.seq),
                        attn_chunk=min(128, args.seq))
    pipeline = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch, seed=17))
    opt = AdamWConfig(lr=6e-4, warmup_steps=args.steps // 10,
                      total_steps=args.steps)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=100, log_every=20)
    cuda = dev.type == "cuda"
    return Trainer(cfg, shape, opt, tcfg, pipeline=pipeline,
                   dtype=torch.bfloat16 if cuda else torch.float32,
                   exec_cfg=(shape_exec_config(cfg, shape, use_kernels=True,
                                               device=dev) if cuda else None),
                   device=dev)


def main(argv: Optional[List[str]] = None, cfg=None) -> list:
    args = parse_args(argv)
    trainer = make_trainer(args, cfg)
    print(f"arch {trainer.cfg.name}: {trainer.cfg.param_count()/1e6:.0f}M "
          f"params")
    t0 = time.time()
    log = trainer.run()
    dt = time.time() - t0
    tokens = args.steps * args.batch * args.seq
    print(f"\n{len(log)} steps, {tokens/dt:.0f} tok/s, "
          f"loss {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f}")
    if trainer.watchdog.events:
        print(f"watchdog flagged {len(trainer.watchdog.events)} slow steps")
    assert log[-1]["loss"] < log[0]["loss"], "loss must decrease"
    return log


if __name__ == "__main__":
    main()
