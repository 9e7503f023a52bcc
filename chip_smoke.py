#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main path — sparse decode serving of StableLM-1.6B at its
published width and depth (24 layers, d_model 2048, vocab 100352) in bf16
with four slots — through ``repro_torch.serve.ServeEngine``, with random
weights from a seeded generator, block-magnitude-pruned at (256, 256):

  1. the card (``torch.cuda``, ``nvidia-smi``);
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (nvcc);
  3. bring-up (weights, the weight-sparsity plan, the dense descriptor
     table), then every matmul site the main path runs, on layer 0's pruned
     weight at M = 4: the block-sparse kernel under the plan's blocks and
     metadata, and the flex kernels (all three stationarities) under the
     dense table's schedule, each held against its plain PyTorch version in
     bf16 and float32, with the activation dense (as the path gives it) and
     with half its K-blocks zero; the block-sparse run bitwise against an
     all-live run of the same inputs; and a TF32 control that the float32
     tolerance must reject;
  4. the planned two-sided engine: 8 requests (prompts of 8-48 tokens,
     32 new tokens each, fused blocks of 16), tokens/s, ms per decode step,
     the plan's weight-block skip fraction and each kernel's launches; the
     fused streams must equal the engine's per-token ``step()`` oracle;
  5. on the same weights and prompts, one decode step of: the dense
     descriptor-table engine (flex-matmul kernels), whose logits must equal
     the planned engine's bit for bit — skipping never approximates; the
     same with every site forced to the weight- and input-stationary
     dataflows; and the plain engine (float32-accumulated ``torch.matmul``,
     no kernels) — the last three within a stated tolerance;
  6. int8 serving on the same weights (``quantize=True``): every site of
     the int8 path at layer 0 with the quantized plan's blocks and
     metadata — the scaled block-sparse kernel and the int8 matmul kernel
     held against their plain versions in bf16 and float32, dense and
     half-dead activations, under √K·2⁻²⁴·max(|A|@|Q·s|); the scaled
     block-sparse run bitwise against its all-live run and against the
     int8 matmul kernel; the TF32 control rejected; bf16 times beside
     each bound;
  7. the planned two-sided int8 engine (the first 4 prompts, 16 new tokens,
     fused blocks): tokens/s and ms per decode step, fused streams equal to
     its ``step()`` oracle; one step of the dense int8 descriptor-table
     engine (``int8_matmul`` at every site), whose logits must equal the
     planned int8 engine's bit for bit; one step of the plain int8 engine
     (weights dequantized to bf16, float32-accumulated ``torch.matmul``)
     within 5% of max |logit|; and, for information, the int8 engine
     against the bf16 one (first-step logits, greedy tokens);
  8. a ``kernels`` JSON line: per kernel its launches on its main path
     (phases 4-5 for the bf16 kernels, phase 7 for the int8 ones), its
     worst error over phase 3 or 6, and its time, bound, plain-version
     time and library time at the mlp.in site (none exists for bf16 x
     int8; the int8 rows add ``bf16_matmul_ms``, ``torch.matmul`` on the
     dequantized bf16 weight, as a reference point).

Exits non-zero on any failure, without a CUDA device, or outside a checkout
of the repository.  The last line is the device JSON.

    python3 chip_smoke.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BPS = 3.35e12          # H100 SXM device-memory bandwidth (data sheet)
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
N_SLOTS = 4
SLICE1_KERNELS = ("block_sparse", "output", "weight", "input")
INT8_KERNELS = ("block_sparse_scaled", "int8_matmul")


class SmokeFailure(Exception):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events, warmed)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float):
    t_b, t_f = n_bytes / HBM_BPS, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def bs_bound_ms(a, meta, blocks, w_elem=None, scale_bytes=0):
    """Block-sparse bound: A once, each weight block some live pair needs
    once (``w_elem`` bytes per element, default A's), the scales once, the
    float32 output once; the MACs of the live block pairs."""
    bm, bk, bn = blocks
    csb = meta.a_bitmap[:, None, :] & meta.b_bitmap.t()[None]
    live_b = int(csb.any(0).sum())
    elem = a.element_size()
    n_bytes = (a.numel() * elem + live_b * bk * bn * (w_elem or elem)
               + scale_bytes + a.shape[0] * meta.b_bitmap.shape[1] * bn * 4)
    return bound_ms(n_bytes, 2.0 * int(meta.kcnt.sum()) * bm * bk * bn)


def matmul_tol(a, b) -> float:
    """Float32 tolerance for K products: √K·2⁻²⁴·max(|A|@|B|).  Two float32
    sums of the same products in different orders differ by roundings of
    random sign, which grow like √K; operands cut to TF32's 10-bit mantissa
    err by ~2⁻¹⁰ per product and land far outside it (phase 3's control)."""
    import torch
    k = a.shape[1]
    mag = torch.matmul(a.abs().float(), b.abs().float()).max().item()
    return k ** 0.5 * 2.0 ** -24 * mag


def tf32(x):
    """float32 ``x`` with its mantissa cut to TF32's 10 bits: the operand a
    TF32 tensor-core product would see."""
    import torch
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def all_live(meta):
    """``meta`` with every K-block listed for every tile (nothing skipped)."""
    import torch
    tk = meta.a_bitmap.shape[1]
    return dataclasses.replace(
        meta, max_nnz=tk,
        kidx=torch.arange(tk, dtype=torch.int32, device=meta.kcnt.device)
        .expand(meta.kcnt.shape + (tk,)).contiguous(),
        kcnt=torch.full_like(meta.kcnt, tk))


def reset_launches(counts=None) -> None:
    """Set every wrapper's launch count to 0, or back to ``counts``."""
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels import int8_matmul as i8
    for d in (bs.LAUNCHES, fm.LAUNCHES, i8.LAUNCHES):
        for key in d:
            d[key] = 0 if counts is None else counts[key]


def launch_counts() -> dict:
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels import int8_matmul as i8
    return {**bs.LAUNCHES, **fm.LAUNCHES, **i8.LAUNCHES}


# ---------------------------------------------------------------------------
# bring-up
# ---------------------------------------------------------------------------

def bring_up(report):
    import torch
    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.core.sparsity import map_leaves, prune_stacked_magnitude
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import decode_exec_config

    cfg = get_config("stablelm-1.6b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model_lib.init_params(cfg, gen, dtype=torch.bfloat16,
                                   device="cuda")
    params = map_leaves(
        lambda _, leaf: prune_stacked_magnitude(leaf, 0.5, (256, 256)),
        params)
    sp_cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
        weight_sparsity=0.5, activation_threshold=0.05))
    planned = decode_exec_config(sp_cfg, N_SLOTS, params=params,
                                 device="cuda")
    dense = decode_exec_config(cfg, N_SLOTS, use_kernels=True, device="cuda")
    torch.cuda.synchronize()
    report(f"params + plan bring-up ({cfg.n_layers} layers): "
           f"{time.perf_counter() - t0:.1f} s; weight-block skip fraction "
           f"{planned.plan.block_skip_fraction():.4f}")
    report(planned.schedules.describe())
    report(dense.schedules.describe())
    return cfg, sp_cfg, params, planned, dense


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions at every site of the main path
# ---------------------------------------------------------------------------

def check_sites(params, planned, dense, report) -> dict:
    """Every planned weight leaf (one per site) at layer 0, the shapes and
    blocks the main path launches.  Returns the worst error per kernel and
    the bf16 mlp.in operands for the ``kernels`` line."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels.ops import planned_operands
    from repro_torch.kernels.ref import block_sparse_matmul_ref, matmul_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    attached = planned.plan.attach(params)
    stats = ("output", "weight", "input")
    worst = dict.fromkeys(("block_sparse",) + stats, 0.0)
    keep = {}
    for e in planned.plan.entries.values():
        pw = attached
        for key in e.path:
            pw = pw[key]
        if e.lead:
            pw = pw.index(0)
        desc = dense.schedules.sites[e.site]
        sched = desc.schedule
        k, n = pw.w_kn.shape
        a_full = torch.randn((desc.m, k), generator=gen, device=dev)
        kb = torch.rand(-(-k // e.bk), generator=gen, device=dev) < 0.5
        a_half = a_full * kb.repeat_interleave(e.bk)[:k]
        for dtype in (torch.bfloat16, torch.float32):
            w = pw.w.to(dtype)
            pwd = dataclasses.replace(pw, w=w)
            w_kn = pwd.w_kn                  # transposed view for the head
            errs = dict.fromkeys(worst, 0.0)
            tol = 0.0
            for act, a32 in (("dense", a_full), ("half", a_half)):
                a = a32.to(dtype)
                tol_a = matmul_tol(a, w_kn)
                tol = max(tol, tol_a)
                xp, wp, meta, _ = planned_operands(a, pwd)
                out = bs.block_sparse_matmul(xp, wp, meta,
                                             out_dtype=torch.float32)
                err = (out - block_sparse_matmul_ref(xp, wp, meta)) \
                    .abs().max().item()
                same = torch.equal(out, bs.block_sparse_matmul(
                    xp, wp, all_live(meta), out_dtype=torch.float32))
                need(err <= tol_a, f"block_sparse {e.site} {dtype} {act}: "
                     f"error {err} > {tol_a}")
                need(same, f"block_sparse {e.site} {dtype} {act}: sparse "
                     f"!= all-live run")
                errs["block_sparse"] = max(errs["block_sparse"], err)
                plain = matmul_ref(a, w_kn)
                for stat in stats:
                    s = dataclasses.replace(sched, stationarity=stat)
                    err = (fm.flex_matmul(a, w_kn, schedule=s,
                                          out_dtype=torch.float32)
                           - plain).abs().max().item()
                    need(err <= tol_a, f"flex_{stat} {e.site} {dtype} {act}"
                         f": error {err} > {tol_a}")
                    errs[stat] = max(errs[stat], err)
                if dtype is torch.bfloat16 and act == "dense" \
                        and e.site == "mlp.in":
                    keep.update(a=a, w=w_kn, meta=meta, sched=sched,
                                blocks=(e.bm, e.bk, e.bn))
            line = (f"{e.site} {str(dtype)[6:]} M={desc.m} K={k} N={n}"
                    f"{' (B read transposed)' if e.transpose else ''}: "
                    f"block_sparse ({e.bm},{e.bk},{e.bn}) "
                    f"{errs['block_sparse']:.3e}, flex ({sched.bm},"
                    f"{sched.bn},{sched.bk}) output/weight/input "
                    f"{errs['output']:.3e}/{errs['weight']:.3e}/"
                    f"{errs['input']:.3e}; tol {tol:.3e}; sparse == "
                    f"all-live bitwise")
            if dtype is torch.float32:
                a = a_full
                plain = matmul_ref(a, w_kn)
                ctrl = (matmul_ref(tf32(a), tf32(w_kn)) - plain) \
                    .abs().max().item()
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    lib = (torch.matmul(a, w_kn) - plain).abs().max().item()
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                line += (f"; TF32 control {ctrl:.3e} (must exceed tol), "
                         f"torch.matmul with allow_tf32 {lib:.3e}")
                need(ctrl > matmul_tol(a, w_kn),
                     f"{e.site}: the float32 tolerance does not reject "
                     f"TF32 operands ({ctrl})")
            report(line)
            for key in worst:
                worst[key] = max(worst[key], errs[key])
        # bf16 times at this site, activation dense as on the path
        a, w_kn = a_full.to(torch.bfloat16), pw.w_kn
        xp, wp, meta, _ = planned_operands(a, pw)
        b_ms, _ = bs_bound_ms(xp, meta, (e.bm, e.bk, e.bn))
        t_bs = cuda_ms(lambda: bs.block_sparse_matmul(
            xp, wp, meta, out_dtype=torch.float32))
        t_fm = cuda_ms(lambda: fm.flex_matmul(
            a, w_kn, schedule=sched, out_dtype=torch.float32))
        t_plain = cuda_ms(lambda: matmul_ref(a, w_kn))
        t_lib = cuda_ms(lambda: torch.matmul(a, w_kn))
        report(f"  {e.site} bf16 ms: block_sparse {t_bs:.4f} (bound "
               f"{b_ms:.5f}), flex_{sched.stationarity} {t_fm:.4f}, plain "
               f"{t_plain:.4f}, torch.matmul {t_lib:.4f}")
    need(bool(keep), "no mlp.in site in the plan")
    torch.cuda.synchronize()
    keep["errs"] = worst
    return keep


def time_kernels(t, launches) -> list:
    """The ``kernels`` line: bf16 x @ w_in at decode shape (M=4, K=2048,
    N=5632), the weight block-pruned at (256, 256), the activation dense."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels.ref import block_sparse_matmul_ref, matmul_ref

    a, w, meta, sched = t["a"], t["w"], t["meta"], t["sched"]
    m, k = a.shape
    n = w.shape[1]
    saved = launch_counts()
    lib_ms = cuda_ms(lambda: torch.matmul(a, w))
    rows = []
    b_ms, b_by = bs_bound_ms(a, meta, t["blocks"])
    rows.append({
        "name": "block_sparse", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_sparse.cu",
        "replaces": "src/repro/kernels/block_sparse.py:49",
        "launches": launches["block_sparse"],
        "max_abs_err": t["errs"]["block_sparse"],
        "ms": cuda_ms(lambda: bs.block_sparse_matmul(
            a, w, meta, out_dtype=torch.float32)),
        "plain_ms": cuda_ms(lambda: block_sparse_matmul_ref(a, w, meta)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    b_ms, b_by = bound_ms(a.numel() * 2 + w.numel() * 2 + m * n * 4,
                          2.0 * m * n * k)
    replaces = {"output": "src/repro/kernels/flex_matmul.py:52",
                "weight": "src/repro/kernels/flex_matmul.py:68",
                "input": "src/repro/kernels/flex_matmul.py:68"}
    plain_ms = cuda_ms(lambda: matmul_ref(a, w))
    for stat in ("output", "weight", "input"):
        s = dataclasses.replace(sched, stationarity=stat)
        rows.append({
            "name": f"flex_{stat}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flex_matmul.cu",
            "replaces": replaces[stat],
            "launches": launches[stat],
            "max_abs_err": t["errs"][stat],
            "ms": cuda_ms(lambda: fm.flex_matmul(
                a, w, schedule=s, out_dtype=torch.float32)),
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    reset_launches(saved)
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: the serving engine at full width
# ---------------------------------------------------------------------------

def profile_step(engine, report, label="planned") -> None:
    """One decode step under ``torch.profiler``: wall time, device busy
    time (sum of kernel time) and the block-sparse kernel's share.  A
    measurement only — a profiler that records nothing is reported, not
    fatal."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy = ours = 0.0
    n_kernels = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy += ev.device_time_total
            n_kernels += 1
            if "tile_kernel" in ev.name:
                ours += ev.device_time_total
    if not busy:
        report(f"profiled {label} decode step: the profiler recorded no "
               "device time (not measured)")
        return
    report(f"profiled {label} decode step: wall {wall * 1e3:.2f} ms, device "
           f"busy {busy / 1e3:.2f} ms ({100 * busy / 1e3 / (wall * 1e3):.1f}%"
           f" of wall, {n_kernels} kernels), block-sparse kernel "
           f"{ours / 1e3:.2f} ms")


def make_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(8, 49)))
            for _ in range(8)]


def make_engine(cfg, params, exec_cfg, fused, **kw):
    import torch
    from repro_torch.serve.engine import ServeEngine
    return ServeEngine(cfg, params, n_slots=N_SLOTS, max_seq=96,
                       dtype=torch.bfloat16, exec_cfg=exec_cfg, fused=fused,
                       decode_block=16, device="cuda", **kw)


def drain_timed(eng, prompts, max_new):
    """Serve ``prompts`` to the end through ``eng``'s fused blocks; returns
    (streams, wall seconds, {prefill s, decode s, decode steps})."""
    import torch
    timing = {"prefill": 0.0, "decode": 0.0, "steps": 0}
    feed, run_block = eng._feed_prefill, eng._run_block

    def timed_feed(i):
        torch.cuda.synchronize()
        t = time.perf_counter()
        feed(i)
        torch.cuda.synchronize()
        timing["prefill"] += time.perf_counter() - t

    def timed_block(live, t_block):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_block(live, t_block)
        timing["decode"] += time.perf_counter() - t
        timing["steps"] += t_block

    eng._feed_prefill, eng._run_block = timed_feed, timed_block
    uids = [eng.submit(p, max_new=max_new) for p in prompts]
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    streams = [res[u] for u in uids]
    need(all(len(st) == max_new for st in streams), "fused run lost tokens")
    return streams, wall, timing


def rate_line(streams, wall, timing) -> str:
    n_tok = sum(len(st) for st in streams)
    return (f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tokens/s "
            f"(prefill {timing['prefill']:.2f} s, decode "
            f"{timing['decode']:.2f} s over {timing['steps']} steps = "
            f"{1e3 * timing['decode'] / timing['steps']:.2f} ms per decode "
            f"step)")


def run_engines(cfg, params, planned, dense, report):
    """Phases 4-5.  Returns the main-path launches and the bf16 planned
    engine's prompts, streams and first-step logits."""
    import torch

    prompts = make_prompts(cfg)
    max_new = 32

    # --- phase 4: planned engine, fused vs oracle ---
    reset_launches()
    eng = make_engine(cfg, params, planned, True)
    fused, wall, timing = drain_timed(eng, prompts, max_new)
    counts = launch_counts()
    planned_counts = {k: counts[k] for k in SLICE1_KERNELS}
    report(f"planned engine: {rate_line(fused, wall, timing)}; launches "
           f"{planned_counts}")

    oracle = make_engine(cfg, params, planned, False)
    ouids = [oracle.submit(p, max_new=max_new) for p in prompts]
    oracle.step()                          # admits 4, decodes one step
    logits0 = oracle.last_logits.clone()
    profile_step(oracle, report)
    ores = oracle.run_until_drained()
    same = all(ores[o] == fused[i] for i, o in enumerate(ouids))
    report(f"fused streams == step() oracle: {same}")
    need(same, "fused streams differ from the step() oracle")
    need(bool(torch.isfinite(logits0).all()), "non-finite logits")
    need(logits0.shape == (N_SLOTS, cfg.vocab), "bad logits shape")

    # --- phase 5: dense descriptor-table engines and the plain engine ---
    # Tolerance for a different float32 summation order: 5% of max |logit|.
    # Every matmul's bf16 output is re-rounded, so 1-ulp (2⁻⁸) differences
    # compound through 24 layers' residual stream; the per-site checks of
    # phase 3 are the tight ones.
    tol = 0.05 * logits0.abs().max().item()

    def forced(stat):
        sites = {s: dataclasses.replace(d, schedule=dataclasses.replace(
            d.schedule, stationarity=stat))
            for s, d in dense.schedules.sites.items()}
        return dataclasses.replace(dense, schedules=dataclasses.replace(
            dense.schedules, sites=sites))

    for label, ec in (("dense, selected schedule", dense),
                      ("dense, all sites weight-stationary", forced("weight")),
                      ("dense, all sites input-stationary", forced("input")),
                      ("plain torch.matmul, no kernels", None)):
        e = make_engine(cfg, params, ec, False)
        for p in prompts[:N_SLOTS]:
            e.submit(p, max_new=max_new)
        e.step()
        diff = (e.last_logits - logits0).abs().max().item()
        if ec is dense:
            report(f"{label}: step logits vs planned max |diff| = "
                   f"{diff:.3e} (must be 0)")
            need(diff == 0.0, "dense engine differs from the planned one")
        else:
            report(f"{label}: step logits vs planned max |diff| = "
                   f"{diff:.3e}, tol {tol:.3e}")
            need(diff <= tol, f"{label}: logits off by {diff}")
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = {k: counts[k] for k in SLICE1_KERNELS}
    report(f"main-path launches (phases 4-5): {launches}")
    for name, count in launches.items():
        need(count > 0, f"kernel {name} never launched on the main path")
    return launches, {"prompts": prompts, "streams": fused,
                      "logits0": logits0}


# ---------------------------------------------------------------------------
# phases 6-7: int8 serving (quantize=True) on the same weights
# ---------------------------------------------------------------------------

def check_sites_int8(cfg, params, q8, report) -> dict:
    """Every site of the int8 path at layer 0: the quantized plan's blocks
    and metadata, the decode shape.  Returns the worst error per kernel
    and the bf16 mlp.in operands for the ``kernels`` line."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.ops import planned_operands
    from repro_torch.kernels.ref import (block_sparse_matmul_ref,
                                         int8_matmul_plain)
    from repro_torch.quant.quantize import QuantizedLinear, quantize_params

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    qparams, _ = quantize_params(params, tie_embeddings=cfg.tie_embeddings)
    attached = q8.plan.attach(qparams)
    worst = dict.fromkeys(INT8_KERNELS, 0.0)
    keep = {}
    for e in q8.plan.entries.values():
        pw = attached
        for key in e.path:
            pw = pw[key]
        if e.lead:
            pw = pw.index(0)
        need(pw.quantized and not e.transpose,
             f"{e.site}: the int8 plan did not attach an int8 payload")
        qw = QuantizedLinear(pw.w, pw.qscale)
        w_deq = pw.w_kn                       # float32 Q·s
        k, n = pw.kn.shape
        m = q8.schedules.sites[e.site].m
        a_full = torch.randn((m, k), generator=gen, device=dev)
        kb = torch.rand(-(-k // e.bk), generator=gen, device=dev) < 0.5
        a_half = a_full * kb.repeat_interleave(e.bk)[:k]
        for dtype in (torch.bfloat16, torch.float32):
            errs = dict.fromkeys(worst, 0.0)
            tol = 0.0
            for act, a32 in (("dense", a_full), ("half", a_half)):
                a = a32.to(dtype)
                tol_a = matmul_tol(a, w_deq)
                tol = max(tol, tol_a)
                what = f"{e.site} {dtype} {act}"
                xp, wp, meta, scale = planned_operands(a, pw)
                out = bs.block_sparse_matmul(xp, wp, meta, scale=scale,
                                             out_dtype=torch.float32)
                err = (out - block_sparse_matmul_ref(xp, wp, meta, scale)) \
                    .abs().max().item()
                need(err <= tol_a, f"block_sparse_scaled {what}: error "
                     f"{err} > {tol_a}")
                need(torch.equal(out, bs.block_sparse_matmul(
                    xp, wp, all_live(meta), scale=scale,
                    out_dtype=torch.float32)),
                    f"block_sparse_scaled {what}: sparse != all-live run")
                errs["block_sparse_scaled"] = max(
                    errs["block_sparse_scaled"], err)
                d = int8_matmul(a, qw, out_dtype=torch.float32)
                err = (d - int8_matmul_plain(a, qw.q, qw.scale)) \
                    .abs().max().item()
                need(err <= tol_a, f"int8_matmul {what}: error {err} > "
                     f"{tol_a}")
                need(torch.equal(d, out[:m, :n]), f"{what}: int8_matmul "
                     f"!= block_sparse_scaled bitwise")
                errs["int8_matmul"] = max(errs["int8_matmul"], err)
                if dtype is torch.bfloat16 and act == "dense" \
                        and e.site == "mlp.in":
                    keep.update(a=a, qw=qw, xp=xp, wp=wp, meta=meta,
                                scale=scale, blocks=(e.bm, e.bk, e.bn),
                                w_bf16=w_deq.to(torch.bfloat16))
            line = (f"int8 {e.site} {str(dtype)[6:]} M={m} K={k} N={n}: "
                    f"block_sparse_scaled ({e.bm},{e.bk},{e.bn}) "
                    f"{errs['block_sparse_scaled']:.3e}, int8_matmul "
                    f"{errs['int8_matmul']:.3e}; tol {tol:.3e}; sparse == "
                    f"all-live == int8_matmul bitwise")
            if dtype is torch.float32:
                a = a_full
                xp, wp, meta, scale = planned_operands(a, pw)
                tol_a = matmul_tol(a, w_deq)
                ctrl_bs = (block_sparse_matmul_ref(tf32(xp), wp, meta, scale)
                           - block_sparse_matmul_ref(xp, wp, meta, scale)) \
                    .abs().max().item()
                ctrl_i8 = (int8_matmul_plain(tf32(a), qw.q, qw.scale)
                           - int8_matmul_plain(a, qw.q, qw.scale)) \
                    .abs().max().item()
                line += (f"; TF32 control {ctrl_bs:.3e} / {ctrl_i8:.3e} "
                         f"(must exceed tol)")
                need(min(ctrl_bs, ctrl_i8) > tol_a,
                     f"int8 {e.site}: the float32 tolerance does not reject "
                     f"a TF32 activation ({ctrl_bs}, {ctrl_i8})")
            report(line)
            for key in worst:
                worst[key] = max(worst[key], errs[key])
        # bf16 times at this site, activation dense as on the path
        a = a_full.to(torch.bfloat16)
        xp, wp, meta, scale = planned_operands(a, pw)
        b_bs, _ = bs_bound_ms(xp, meta, (e.bm, e.bk, e.bn), w_elem=1,
                              scale_bytes=4 * n)
        b_i8, _ = bound_ms(a.numel() * 2 + k * n + 4 * n + m * n * 4,
                           2.0 * m * n * k)
        t_bs = cuda_ms(lambda: bs.block_sparse_matmul(
            xp, wp, meta, scale=scale, out_dtype=torch.float32))
        t_i8 = cuda_ms(lambda: int8_matmul(a, qw, out_dtype=torch.float32))
        t_pbs = cuda_ms(lambda: block_sparse_matmul_ref(xp, wp, meta, scale))
        t_pi8 = cuda_ms(lambda: int8_matmul_plain(a, qw.q, qw.scale))
        w_bf16 = w_deq.to(torch.bfloat16)
        t_bf16 = cuda_ms(lambda: torch.matmul(a, w_bf16))
        report(f"  int8 {e.site} bf16 ms: block_sparse_scaled {t_bs:.4f} "
               f"(bound {b_bs:.5f}), int8_matmul {t_i8:.4f} (bound "
               f"{b_i8:.5f}), plain {t_pbs:.4f} / {t_pi8:.4f}, bf16 "
               f"torch.matmul on the dequantized weight {t_bf16:.4f}")
    need(bool(keep), "no mlp.in site in the int8 plan")
    torch.cuda.synchronize()
    keep["errs"] = worst
    return keep


def run_int8_engines(cfg, params, q8, dense8, bf16, report) -> dict:
    """Phase 7: the int8 engines on the first 4 prompts.  Returns the int8
    path's launches."""
    import torch

    prompts = bf16["prompts"][:N_SLOTS]
    max_new = 16
    reset_launches()
    eng = make_engine(cfg, params, q8, True)
    streams, wall, timing = drain_timed(eng, prompts, max_new)
    report(f"planned int8 engine: {rate_line(streams, wall, timing)}; "
           f"weights {eng.quant_stats['quantized_bytes']} bytes int8 + "
           f"scales vs {eng.quant_stats['original_bytes']} bf16")

    oracle = make_engine(cfg, params, q8, False)
    ouids = [oracle.submit(p, max_new=max_new) for p in prompts]
    oracle.step()
    logits8 = oracle.last_logits.clone()
    profile_step(oracle, report, "planned int8")
    ores = oracle.run_until_drained()
    same = all(ores[o] == streams[i] for i, o in enumerate(ouids))
    report(f"int8 fused streams == step() oracle: {same}")
    need(same, "int8 fused streams differ from the step() oracle")
    need(bool(torch.isfinite(logits8).all()), "non-finite int8 logits")
    need(logits8.shape == (N_SLOTS, cfg.vocab), "bad int8 logits shape")

    # the dense table runs int8_matmul at every site: same tile template,
    # same per-element summation order (K ascending), dead blocks add exact
    # zeros, the scale applied to the same accumulator — so the same bits
    tol = 0.05 * logits8.abs().max().item()
    for label, ec, kw in (("dense int8 table (int8_matmul)", dense8, {}),
                          ("plain int8 (bf16 dequantized, torch.matmul)",
                           None, {"quantize": True})):
        e = make_engine(cfg, params, ec, False, **kw)
        for p in prompts:
            e.submit(p, max_new=max_new)
        e.step()
        diff = (e.last_logits - logits8).abs().max().item()
        if ec is dense8:
            report(f"{label}: step logits vs planned int8 max |diff| = "
                   f"{diff:.3e} (must be 0)")
            need(diff == 0.0, "dense int8 engine differs from the planned "
                 "int8 one")
        else:
            report(f"{label}: step logits vs planned int8 max |diff| = "
                   f"{diff:.3e}, tol {tol:.3e}")
            need(diff <= tol, f"{label}: logits off by {diff}")
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = {k: counts[k] for k in INT8_KERNELS}
    report(f"main-path launches (phase 7): {counts}")
    for name, count in launches.items():
        need(count > 0, f"kernel {name} never launched on the int8 path")

    ref = [st[:max_new] for st in bf16["streams"][:N_SLOTS]]
    agree = sum(x == y for st, rt in zip(streams, ref)
                for x, y in zip(st, rt))
    prefix = [next((i for i, (x, y) in enumerate(zip(st, rt)) if x != y),
                   max_new) for st, rt in zip(streams, ref)]
    report(f"information: int8 vs bf16 planned first-step logits max |diff| "
           f"= {(logits8 - bf16['logits0']).abs().max().item():.3e}; greedy "
           f"tokens equal at {agree}/{N_SLOTS * max_new} positions, common "
           f"prefixes {prefix}")
    return launches


def time_int8_kernels(t, launches) -> list:
    """The int8 rows of the ``kernels`` line: bf16 x @ w_in at the decode
    shape (M=4, K=2048, N=5632), the weight block-pruned at (256, 256) and
    quantized, the activation dense."""
    import torch
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels.ref import (block_sparse_matmul_ref,
                                         int8_matmul_plain)

    a, qw, meta = t["a"], t["qw"], t["meta"]
    xp, wp, scale = t["xp"], t["wp"], t["scale"]
    m, k = a.shape
    n = qw.q.shape[1]
    saved = launch_counts()
    b_bs, by_bs = bs_bound_ms(xp, meta, t["blocks"], w_elem=1,
                              scale_bytes=4 * n)
    b_i8, by_i8 = bound_ms(a.numel() * 2 + k * n + 4 * n + m * n * 4,
                           2.0 * m * n * k)
    rows = [{
        "name": "block_sparse_scaled", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_sparse.cu",
        "replaces": "src/repro/kernels/block_sparse.py:69",
        "launches": launches["block_sparse_scaled"],
        "max_abs_err": t["errs"]["block_sparse_scaled"],
        "ms": cuda_ms(lambda: bs.block_sparse_matmul(
            xp, wp, meta, scale=scale, out_dtype=torch.float32)),
        "plain_ms": cuda_ms(lambda: block_sparse_matmul_ref(xp, wp, meta,
                                                            scale)),
        "bound_ms": b_bs, "bound_by": by_bs, "library_ms": None}, {
        "name": "int8_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:24",
        "launches": launches["int8_matmul"],
        "max_abs_err": t["errs"]["int8_matmul"],
        "ms": cuda_ms(lambda: int8_matmul(a, qw, out_dtype=torch.float32)),
        "plain_ms": cuda_ms(lambda: int8_matmul_plain(a, qw.q, qw.scale)),
        "bound_ms": b_i8, "bound_by": by_i8, "library_ms": None}]
    # reference point, not a library time: bf16 x bf16 on the dequantized
    # weight (timed last, after the kernels have warmed the card)
    bf16_ms = cuda_ms(lambda: torch.matmul(a, t["w_bf16"]))
    for row in rows:
        row["bf16_matmul_ms"] = bf16_ms
    reset_launches(saved)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def report(msg):
        print(msg, flush=True)

    try:
        t_start = time.perf_counter()
        # phase 1: the card
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        report(f"device: {name}, torch {torch.__version__}, "
               f"CUDA {torch.version.cuda}")
        # phase 2: build
        from repro_torch.kernels import build
        secs = build.build_all()
        report(f"kernel build: {secs:.1f} s")
        for lib, log in build.BUILD_LOG.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    report(f"  [{lib}] {line.strip()}")
        # phase 3: bring-up, then the kernels vs plain versions
        cfg, sp_cfg, params, planned, dense = bring_up(report)
        checked = check_sites(params, planned, dense, report)
        # phases 4-5: the engines
        launches, bf16 = run_engines(cfg, params, planned, dense, report)
        rows = time_kernels(checked, launches)
        # phase 6: int8 bring-up and the int8 kernels vs plain versions
        from repro_torch.serve.engine import decode_exec_config
        t0 = time.perf_counter()
        q8 = decode_exec_config(sp_cfg, N_SLOTS, params=params,
                                quantize=True, device="cuda")
        dense8 = decode_exec_config(cfg, N_SLOTS, use_kernels=True,
                                    quantize=True, device="cuda")
        torch.cuda.synchronize()
        report(f"int8 plan bring-up: {time.perf_counter() - t0:.1f} s; "
               f"weight-block skip fraction "
               f"{q8.plan.block_skip_fraction():.4f}")
        report(q8.schedules.describe())
        checked8 = check_sites_int8(cfg, params, q8, report)
        # phase 7: the int8 engines
        launches8 = run_int8_engines(cfg, params, q8, dense8, bf16, report)
        # phase 8: the kernels line
        rows += time_int8_kernels(checked8, launches8)
        report(f"smoke wall time: {time.perf_counter() - t_start:.1f} s")
        for line in smi:
            report(line)
        report(json.dumps({"kernels": rows}))
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
