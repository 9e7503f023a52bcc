"""Batched serving example, the JAX package's ``examples/serve_batched.py``
on PyTorch: continuous batching with slot reuse over a reduced gemma-2b —
requests arrive mid-flight, finished slots are re-admitted from the
queue, greedy tokens stream back per request.

The same queue drains through the per-token ``step()`` oracle, the
synchronous fused block loop and the asynchronous one (block k+1
dispatched before block k's tokens are read), with identical token
streams; a sampling wave mixes a temperature / top-k request with a
greedy neighbour (reproducible per seed, the greedy row untouched); a
last wave runs under ``AdaptiveAdmission`` with unchanged streams.

Run:  python -m repro_torch.examples.serve_batched [--device cpu]

Float32 weights, as in the reference.  On CUDA (the default) every engine
runs under ``decode_exec_config(cfg, 4, use_kernels=True)``, so each
matmul site launches the hand-written kernels and each entry point is a
replayed CUDA graph; on the CPU the plain path runs.  ``main`` returns
the streams and rates.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

N_SLOTS, MAX_SEQ, MAX_NEW = 4, 96, 12


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def _sync(engine) -> None:
    import torch
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def serve_wave(engine, prompts, max_new: int = MAX_NEW):
    t0 = time.time()
    for p in prompts[:4]:
        engine.submit(p, max_new=max_new)
    # stream the first few blocks (fused) / steps (oracle)
    for step in range(3):
        out = (engine.decode_block_step(4) if engine.fused
               else engine.step())
        print(f"  burst {step}: {len(out)} slots emitted "
              f"{dict(list(out.items())[:2])}")
    # the second wave arrives while the first is decoding
    for p in prompts[4:]:
        engine.submit(p, max_new=max_new)
    results = engine.run_until_drained()
    dt = time.time() - t0
    total = sum(len(v) for v in results.values())
    return results, total, dt


def warm_wave(engine, prompts, max_new: int = MAX_NEW) -> float:
    """A second identical wave on the warm engine: steady-state tokens/s,
    counting only this wave's requests."""
    uids = [engine.submit(p, max_new=max_new) for p in prompts]
    _sync(engine)
    t0 = time.time()
    results = engine.run_until_drained()
    _sync(engine)
    dt = time.time() - t0
    return sum(len(results[u]) for u in uids) / dt


def main(argv: Optional[List[str]] = None) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import (AdaptiveAdmission, SamplingParams,
                                          ServeEngine, decode_exec_config)

    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config("gemma-2b")
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.float32,
        device=dev)
    exec_cfg = (decode_exec_config(cfg, N_SLOTS, use_kernels=True,
                                   device=dev)
                if dev.type == "cuda" else None)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=8) for _ in range(8)]

    def engine(**kw):
        return ServeEngine(cfg, params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                           exec_cfg=exec_cfg, device=dev, **kw)

    print("per-token oracle loop:")
    oracle = engine(fused=False)
    res_o, total_o, dt_o = serve_wave(oracle, prompts)
    tps_o = warm_wave(oracle, prompts)
    print(f"  {len(res_o)} requests / {total_o} tokens in {dt_o:.2f}s "
          f"(warm: {tps_o:.0f} tok/s)")

    print("fused block loop (decode_many, sync dispatch):")
    fused_sync = engine(fused=True, decode_block=8, async_dispatch=False)
    res_s, total_s, dt_s = serve_wave(fused_sync, prompts)
    tps_s = warm_wave(fused_sync, prompts)
    print(f"  {len(res_s)} requests / {total_s} tokens in {dt_s:.2f}s "
          f"(warm: {tps_s:.0f} tok/s, {tps_s/tps_o:.1f}x the oracle)")

    print("async double-buffered dispatch (block k+1 before block k's "
          "sync):")
    fused = engine(fused=True, decode_block=8)      # async is the default
    res_f, total_f, dt_f = serve_wave(fused, prompts)
    tps_f = warm_wave(fused, prompts)
    print(f"  {len(res_f)} requests / {total_f} tokens in {dt_f:.2f}s "
          f"(warm: {tps_f:.0f} tok/s, {tps_f/tps_o:.1f}x the oracle, "
          f"{tps_f/tps_s:.2f}x sync)")

    assert list(res_o.values()) == list(res_s.values()) \
        == list(res_f.values()), \
        "fused loops diverged from the per-token oracle"
    for uid, toks in sorted(res_f.items()):
        print(f"  req {uid}: {len(toks)} tokens, first 6 = {toks[:6]}")
    assert len(res_f) == 8 and all(len(v) == MAX_NEW
                                   for v in res_f.values())

    # per-request sampling: a sampled stream is a pure function of (seed,
    # position), so a re-run reproduces it; greedy neighbours are untouched
    print("mixed sampling (per-request SamplingParams):")
    sp = SamplingParams(temperature=0.8, top_k=16, seed=7)
    streams = []
    for _ in range(2):
        uid_s = fused.submit(prompts[0], max_new=MAX_NEW, sampling=sp)
        uid_g = fused.submit(prompts[1], max_new=MAX_NEW)
        res = fused.run_until_drained()
        streams.append((res[uid_s], res[uid_g]))
    (samp_a, greedy_a), (samp_b, greedy_b) = streams
    assert samp_a == samp_b, "sampling must be reproducible per seed"
    baseline = res_f[sorted(res_f)[1]]
    assert greedy_a == greedy_b == baseline, \
        "greedy rows must be unaffected by sampled neighbors"
    print(f"  sampled (T=0.8, top_k=16, seed=7): first 6 = {samp_a[:6]}")
    print(f"  greedy neighbor unchanged:          first 6 = {greedy_a[:6]}")

    # adaptive admission reorders scheduling only: every stream is the
    # FIFO oracle's (uids align by submit order)
    print("adaptive admission (policy-invariant streams):")
    adaptive = engine(fused=True, decode_block=8, prefill_chunk=8,
                      admission=AdaptiveAdmission(min_chunk=4, max_chunk=16,
                                                  burst_depth=2))
    uids_a = [adaptive.submit(p, max_new=MAX_NEW) for p in prompts]
    res_a = adaptive.run_until_drained()
    assert [res_a[u] for u in uids_a] == [res_o[u] for u in sorted(res_o)]
    print(f"  {len(uids_a)} requests drained under AdaptiveAdmission, "
          f"streams unchanged")
    return {"oracle": res_o, "sync": res_s, "async": res_f,
            "sampled": samp_a, "adaptive": [res_a[u] for u in uids_a],
            "tokens_per_s": {"oracle": tps_o, "sync": tps_s,
                             "async": tps_f}}


if __name__ == "__main__":
    main()
