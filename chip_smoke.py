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
  6. a ``kernels`` JSON line: per kernel its launches on the main path
     (phases 4-5), its worst error over phase 3, and its time, bound,
     plain-version time and ``torch.matmul`` time at the mlp.in site.

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


def bs_bound_ms(a, meta, blocks):
    """Block-sparse bound: A once, each weight block some live pair needs
    once, the float32 output once; the MACs of the live block pairs."""
    bm, bk, bn = blocks
    csb = meta.a_bitmap[:, None, :] & meta.b_bitmap.t()[None]
    live_b = int(csb.any(0).sum())
    elem = a.element_size()
    n_bytes = (a.numel() * elem + live_b * bk * bn * elem
               + a.shape[0] * meta.b_bitmap.shape[1] * bn * 4)
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
    return cfg, params, planned, dense


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
                xp, wp, meta = planned_operands(a, pwd)
                out = bs.block_sparse_matmul(xp, wp, meta,
                                             out_dtype=torch.float32)
                err = (out - block_sparse_matmul_ref(xp, wp, meta)) \
                    .abs().max().item()
                tk = meta.a_bitmap.shape[1]
                live = dataclasses.replace(
                    meta, max_nnz=tk,
                    kidx=torch.arange(tk, dtype=torch.int32, device=dev)
                    .expand(meta.kcnt.shape + (tk,)).contiguous(),
                    kcnt=torch.full_like(meta.kcnt, tk))
                same = torch.equal(out, bs.block_sparse_matmul(
                    xp, wp, live, out_dtype=torch.float32))
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
        xp, wp, meta = planned_operands(a, pw)
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
    saved_bs, saved_fm = dict(bs.LAUNCHES), dict(fm.LAUNCHES)
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
    bs.LAUNCHES.update(saved_bs)
    fm.LAUNCHES.update(saved_fm)
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: the serving engine at full width
# ---------------------------------------------------------------------------

def profile_step(engine, report) -> None:
    """One planned decode step under ``torch.profiler``: wall time, device
    busy time (sum of kernel time) and the block-sparse kernel's share.  A
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
        report("profiled decode step: the profiler recorded no device time "
               "(not measured)")
        return
    report(f"profiled planned decode step: wall {wall * 1e3:.2f} ms, device "
           f"busy {busy / 1e3:.2f} ms ({100 * busy / 1e3 / (wall * 1e3):.1f}%"
           f" of wall, {n_kernels} kernels), block-sparse kernel "
           f"{ours / 1e3:.2f} ms")


def run_engines(cfg, params, planned, dense, report) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.serve.engine import ServeEngine

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(8, 49)))
               for _ in range(8)]
    max_new = 32

    def engine(exec_cfg, fused):
        return ServeEngine(cfg, params, n_slots=N_SLOTS, max_seq=96,
                           dtype=torch.bfloat16, exec_cfg=exec_cfg,
                           fused=fused, decode_block=16, device="cuda")

    # --- phase 4: planned engine, fused vs oracle ---
    for d in (bs.LAUNCHES, fm.LAUNCHES):
        for key in d:
            d[key] = 0
    eng = engine(planned, True)
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
    fused = [res[u] for u in uids]
    n_tok = sum(len(s) for s in fused)
    need(all(len(s) == max_new for s in fused), "fused run lost tokens")
    planned_counts = {"block_sparse": bs.LAUNCHES["block_sparse"],
                      **fm.LAUNCHES}
    report(f"planned engine: {n_tok} tokens in {wall:.2f} s = "
           f"{n_tok / wall:.1f} tokens/s (prefill {timing['prefill']:.2f} s,"
           f" decode {timing['decode']:.2f} s over {timing['steps']} "
           f"steps = {1e3 * timing['decode'] / timing['steps']:.2f} ms per "
           f"decode step); launches {planned_counts}")

    oracle = engine(planned, False)
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
        e = engine(ec, False)
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
    launches = {"block_sparse": bs.LAUNCHES["block_sparse"], **fm.LAUNCHES}
    report(f"main-path launches (phases 4-5): {launches}")
    for name, count in launches.items():
        need(count > 0, f"kernel {name} never launched on the main path")
    return launches


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
        cfg, params, planned, dense = bring_up(report)
        checked = check_sites(params, planned, dense, report)
        # phases 4-5: the engines
        launches = run_engines(cfg, params, planned, dense, report)
        # phase 6: the kernels line
        rows = time_kernels(checked, launches)
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
