"""Batched serving driver (continuous batching), the reference's
``launch/serve.py`` with ``--device`` (default ``cuda``):

    python -m repro_torch.launch.serve --arch gemma-2b --requests 8 \\
        --max-new 16

``--smoke`` selects the reduced config of the same family (CPU-scale; with
``--device cpu``).  Random weights from ``--seed``; prompts of
``--prompt-len`` tokens drawn from ``numpy.random.default_rng(seed)``, as
in the reference.  On CUDA the parameters and the decode state are bf16
and the engine runs under ``decode_exec_config(cfg, slots,
use_kernels=True)``: every matmul site launches the hand-written kernels
(the dense descriptor table).  On the CPU the parameters are float32 and
the plain path runs, as in the reference.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def make_engine(args: argparse.Namespace):
    """The ``ServeEngine`` the command line describes (random weights,
    nothing submitted)."""
    import torch

    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import ServeEngine, decode_exec_config

    dev = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_lib.init_params(cfg, gen, dtype=dtype, device=dev)
    exec_cfg = None
    if dev.type == "cuda":
        exec_cfg = decode_exec_config(cfg, args.slots, use_kernels=True,
                                      device=dev)
    return ServeEngine(cfg, params, n_slots=args.slots,
                       max_seq=args.max_seq, dtype=dtype, exec_cfg=exec_cfg,
                       device=dev)


def main(argv: Optional[List[str]] = None) -> Dict[int, list]:
    """Serve ``--requests`` random prompts to the end; prints the
    reference's summary lines and returns {request id: tokens}."""
    import numpy as np

    args = parse_args(argv)
    engine = make_engine(args)
    rs = np.random.default_rng(args.seed)
    t0 = time.time()
    for _ in range(args.requests):
        prompt = rs.integers(0, engine.cfg.vocab, size=args.prompt_len)
        engine.submit(prompt, max_new=args.max_new)
    results = engine.run_until_drained()
    dt = time.time() - t0
    total_new = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s)")
    for uid, toks in sorted(results.items())[:4]:
        print(f"  req {uid}: {toks[:8]}{'...' if len(toks) > 8 else ''}")
    return results


if __name__ == "__main__":
    main()
