"""Quickstart — the FlexNN port in five steps, the JAX package's
``examples/quickstart.py`` on PyTorch:

  1. per-layer flexible schedule search + energy model (the core idea)
  2. two-sided sparsity: ZVC codec, CSB, the block-sparse matmul kernel
  3. FlexTree: configurable-depth psum reduction
  4. schedule descriptors lowered onto a real LM matmul site
  5. a few training steps of a reduced gemma-2b

Run:  python -m repro_torch.examples.quickstart [--device cpu]

On CUDA (the default) the schedule search runs on the card, the
block-sparse product launches the hand-written kernel and the training
steps run the train table's kernels on bf16 weights (as
``launch.train``); on the CPU everything takes its plain path.
``main`` returns the figures it prints.
"""
from __future__ import annotations

import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=10)
    return ap.parse_args(argv)


def _banner(title: str) -> None:
    print("=" * 64)
    print(title)
    print("=" * 64)


def schedules(device) -> dict:
    """Step 1: the flexible optimum of one ResNet-50 layer against the
    best schedule of each fixed dataflow."""
    from repro_torch.core.energy_model import DENSE, FLEXNN, ConvLayer
    from repro_torch.core.scheduler import optimize_layer

    layer = ConvLayer("resnet50.conv2_1x1", ox=56, oy=56, oc=256, ic=64)
    flex = optimize_layer(layer, FLEXNN, DENSE, device=device)
    print(f"layer {layer.name}: {layer.macs/1e6:.0f} M MACs")
    print(f"  optimal schedule : {flex.schedule.describe()}")
    print(f"  energy {flex.energy/1e6:.1f}M units, {flex.cycles/1e3:.0f}k "
          f"cycles")
    out = {"schedule": flex.schedule.describe(), "energy": flex.energy,
           "cycles": flex.cycles, "fixed": {}}
    for df in ("ws", "os", "is"):
        fixed = optimize_layer(layer, FLEXNN, DENSE, dataflow=df,
                               device=device)
        out["fixed"][df] = fixed.energy
        print(f"  fixed {df.upper():>3}: {fixed.energy/1e6:.1f}M units "
              f"(+{100*(fixed.energy/flex.energy-1):.1f}% vs flexible)")
    return out


def two_sided(device) -> dict:
    """Step 2: ZVC, the CSB popcount and one block-sparse product."""
    import numpy as np
    import torch

    from repro_torch.core.sparsity import (block_bitmap,
                                           build_block_sparse_meta,
                                           csb_popcount, prune_magnitude,
                                           zvc_decode, zvc_encode)
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    # element-wise magnitude pruning is the (1, 1)-block case
    x = prune_magnitude(torch.from_numpy(
        rng.normal(size=(8, 16)).astype(np.float32)), 0.6, (1, 1)).to(device)
    packed, bitmap, nnz = zvc_encode(x)
    assert torch.equal(zvc_decode(packed, bitmap), x)
    print(f"ZVC: {x.numel()} elements -> {int(nnz)} packed + "
          f"{x.numel()/8:.0f}B bitmap")

    a_bm = torch.from_numpy(rng.random(128) < 0.5).to(device)
    w_bm = torch.from_numpy(rng.random(128) < 0.4).to(device)
    pairs = int(csb_popcount(a_bm, w_bm))
    print(f"CSB popcount: IF {int(a_bm.sum())} nz × FL {int(w_bm.sum())} nz "
          f"-> {pairs} surviving MAC pairs")

    a = prune_magnitude(torch.from_numpy(
        rng.normal(size=(256, 256)).astype(np.float32)), 0.6, (64, 64))
    b = prune_magnitude(torch.from_numpy(
        rng.normal(size=(256, 256)).astype(np.float32)), 0.6, (64, 64))
    a, b = a.to(device), b.to(device)
    meta = build_block_sparse_meta(block_bitmap(a, 64, 64),
                                   block_bitmap(b, 64, 64))
    with ops.exec_config(ops.ExecConfig(use_kernels=True)):
        out = ops.block_sparse_matmul(a, b, meta)
    exact = (a.double() @ b.double()).float()
    err = float((out - exact).abs().max())
    skip = 1.0 - int(meta.kcnt.sum()) / meta.kcnt.numel() / meta.max_nnz
    print(f"block-sparse matmul: skip {skip*100:.0f}% of block MACs, max err "
          f"{err:.1e}")
    return {"nnz": int(nnz), "if_nz": int(a_bm.sum()),
            "fl_nz": int(w_bm.sum()), "pairs": pairs, "skip": skip,
            "err": err}


def flextree() -> dict:
    """Step 3: FlexTree's cycles against the neighbour chain."""
    from repro_torch.core.flextree import (flextree_cycles,
                                           flextree_speedup_vs_chain,
                                           neighbor_chain_cycles)

    out = {}
    for ic_p in (2, 4, 8, 16):
        out[ic_p] = (neighbor_chain_cycles(256, ic_p),
                     flextree_cycles(256, ic_p),
                     flextree_speedup_vs_chain(256, ic_p))
        print(f"  IC_P={ic_p:>2}: chain {out[ic_p][0]:.0f} vs FlexTree "
              f"{out[ic_p][1]:.0f} cycles ({out[ic_p][2]:.2f}x)")
    return out


def descriptors() -> dict:
    """Step 4: yi-9b's train_4k sites at 16 model shards."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.core.descriptors import compile_network_schedule

    ns = compile_network_schedule(get_config("yi-9b"), SHAPES["train_4k"],
                                  model_shards=16)
    out = {}
    for site in ("attn.q", "mlp.in", "mlp.out", "lm_head"):
        out[site] = ns.sites[site].describe()
        print("  " + out[site])
    return out


def train(device, steps: int) -> list:
    """Step 5: ``steps`` AdamW steps of gemma-2b's smoke config."""
    import torch

    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.serve.engine import shape_exec_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config("gemma-2b")
    shape = ShapeConfig(name="qs", kind="train", seq_len=64, global_batch=4,
                        loss_chunk=32, attn_chunk=32, remat="none")
    cuda = device.type == "cuda"
    trainer = Trainer(
        cfg, shape, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps),
        TrainerConfig(steps=steps, log_every=2),
        pipeline=TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=64,
                                          global_batch=4)),
        dtype=torch.bfloat16 if cuda else torch.float32,
        exec_cfg=(shape_exec_config(cfg, shape, use_kernels=True,
                                    device=device) if cuda else None),
        device=device)
    log = trainer.run()
    print(f"loss {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f} over "
          f"{len(log)} steps")
    return log


def main(argv: Optional[List[str]] = None) -> dict:
    from repro_torch.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    _banner("1. Flexible dataflow: per-layer optimal schedule vs fixed "
            "dataflows")
    out["schedules"] = schedules(dev)
    print()
    _banner("2. Two-sided sparsity: ZVC + combined sparsity bitmap + kernel")
    out["two_sided"] = two_sided(dev)
    print()
    _banner("3. FlexTree: configurable-depth psum accumulation")
    out["flextree"] = flextree()
    print()
    _banner("4. Schedule descriptors on a real LM matmul site")
    out["descriptors"] = descriptors()
    print()
    _banner(f"5. Train a reduced gemma-2b for {args.steps} steps")
    out["train"] = train(dev, args.steps)
    print("\nquickstart complete.")
    return out


if __name__ == "__main__":
    main()
