"""Two-sided sparse inference, the JAX package's
``examples/sparse_serving.py`` on PyTorch: magnitude-prune a smoke LM's
MLP weight block-wise, build the CSB block-sparse metadata from the
weight × a runtime activation bitmap, run the product through the
two-sided kernel, and report accuracy and skip economics (FlexNN §III-D
at tile granularity); then a precompiled weight plan through
``ops.flex_matmul``, and a MoE smoke LM's per-expert plan, whose planned
engine emits the unplanned engine's tokens.

Run:  python -m repro_torch.examples.sparse_serving [--device cpu]

Float32, as in the reference.  On CUDA (the default) the products launch
the hand-written block-sparse kernel and the two MoE engines run under
the descriptor table with ``use_kernels=True`` (planned, and dense); on
the CPU the plain path runs.  ``main`` returns the figures it prints.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def _skip(meta) -> float:
    """The share of (tile, K-block) pairs the CSB lists leave out."""
    tm, tk = meta.a_bitmap.shape[-2:]
    tn = meta.b_bitmap.shape[-1]
    return 1.0 - int(meta.kcnt.sum()) / max(tm * tn * tk, 1)


def two_sided(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.sparsity import (block_bitmap,
                                           build_block_sparse_meta,
                                           prune_magnitude,
                                           simulate_pe_cycles,
                                           zvc_compressed_bytes)
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import block_sparse_matmul_ref

    cfg = get_smoke_config("yi-9b")
    rng = np.random.default_rng(0)
    bm = bk = bn = 16
    d, f = cfg.d_model, cfg.d_ff

    # weight side: block-magnitude pruning (the NNCF stand-in)
    w_in = prune_magnitude(torch.from_numpy(
        rng.normal(size=(d, f)).astype(np.float32) * 0.05), 0.6,
        (bk, bn)).to(dev)
    w_bitmap = block_bitmap(w_in, bk, bn)
    zvc_ratio = zvc_compressed_bytes(w_in, 4) / (w_in.numel() * 4)
    print(f"w_in ({d}x{f}): 60% block-pruned, "
          f"{100*(1-w_bitmap.float().mean().item()):.0f}% blocks dead, "
          f"ZVC at rest {zvc_ratio:.2f}x")

    # activation side: runtime ReLU-style sparsity
    t = 64
    x = rng.normal(size=(t, d)).astype(np.float32)
    x = torch.from_numpy(np.where(x > 0.3, x, 0.0).astype(np.float32)).to(dev)
    a_bitmap = block_bitmap(x, bm, bk)
    print(f"activations ({t}x{d}): {100*(x == 0).float().mean().item():.0f}% "
          f"zero element-wise, "
          f"{100*(1-a_bitmap.float().mean().item()):.0f}% blocks dead")

    # the combined (CSB) dispatch
    meta = build_block_sparse_meta(a_bitmap, w_bitmap)
    with ops.exec_config(ops.ExecConfig(use_kernels=True)):
        out = ops.block_sparse_matmul(x, w_in, meta)
    ref = block_sparse_matmul_ref(x, w_in, meta)
    err = float((out - ref).abs().max())
    exact = float((out - (x.double() @ w_in.double()).float()).abs().max())
    skip = _skip(meta)
    print(f"\nCSB skip fraction: {skip*100:.1f}% of block MACs never "
          f"fetched or multiplied")
    print(f"kernel vs skip-semantics oracle: {err:.2e} (must be ~0)")
    print(f"kernel vs dense product:        {exact:.2e} "
          f"(exact — bitmaps derived from the data)")
    assert err < 1e-4 and exact < 1e-4
    # cycle-model economics at the paper's element granularity
    dense_c = simulate_pe_cycles(256, 16, 64, 1.0)
    sparse_c = simulate_pe_cycles(
        256, 16, 64, float((x != 0).float().mean()) * float(
            (w_in != 0).float().mean()))
    print(f"element-granular PE cycle model: {dense_c/sparse_c:.2f}x speedup")
    return {"x": x, "w_in": w_in, "skip": skip, "err": err, "exact": exact,
            "zvc_ratio": zvc_ratio, "pe_speedup": dense_c / sparse_c}


def weight_plan(dev, x, w_in) -> dict:
    """The weight-side metadata compiled once into a ``PlannedWeight`` and
    dispatched through ``ops.flex_matmul``: only the activation bitmap is
    derived per call, and the grid runs the tight ``max_nnz``."""
    import torch

    from repro_torch.core.sparsity import plan_weight, prune_k_blocks
    from repro_torch.kernels import ops

    bm = bk = bn = 16
    d = w_in.shape[0]
    # per-column structured pruning along K makes the tight bound
    # strictly below tk
    w_plan = torch.from_numpy(prune_k_blocks(
        w_in.cpu().numpy(), bk, bn, max_live=d // bk // 2)).to(dev)
    pw = plan_weight(w_plan, site="mlp.in", mode="two_sided", bm=bm, bk=bk,
                     bn=bn)
    with ops.exec_config(ops.ExecConfig(use_kernels=dev.type == "cuda")):
        planned = ops.flex_matmul(x, pw, site="mlp.in")
    exact = float((planned - (x.double() @ w_plan.double()).float())
                  .abs().max())
    print(f"\nweight plan: max_nnz={pw.max_nnz} of tk={pw.tk} K-blocks "
          f"({100 * (1 - pw.max_nnz / pw.tk):.0f}% grid shrink), "
          f"planned vs dense: {exact:.2e}")
    assert exact < 1e-4
    return {"max_nnz": pw.max_nnz, "tk": pw.tk, "exact": exact}


def moe_plan(dev) -> dict:
    """Total site coverage: the batched-expert products are planned sites
    too.  A smoke MoE LM's plan, its per-expert stats, and its planned
    engine against the unplanned one."""
    import numpy as np
    import torch

    from repro_torch.configs.base import SparsityConfig, get_smoke_config
    from repro_torch.core.sparsity import map_leaves, prune_stacked_magnitude
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import ServeEngine, decode_exec_config

    moe_cfg = get_smoke_config("deepseek-moe-16b")
    params = model_lib.init_params(
        moe_cfg, torch.Generator(device=dev).manual_seed(0),
        dtype=torch.float32, device=dev)
    params = {**params, "stack": map_leaves(          # 3-D + 4-D leaves
        lambda path, leaf: prune_stacked_magnitude(leaf, 0.6),
        params["stack"])}
    sp_cfg = dataclasses.replace(moe_cfg, sparsity=SparsityConfig(
        weight_sparsity=0.6, activation_threshold=0.05))
    kernels = dev.type == "cuda"
    ec = decode_exec_config(sp_cfg, 2, params=params, use_kernels=kernels,
                            device=dev)
    print(f"\nMoE plan ({moe_cfg.name}): {len(ec.plan.entries)} planned "
          f"leaves")
    experts = {}
    for e in ec.plan.entries.values():
        st = e.stats()
        if "experts" not in st:
            continue
        dens = st["expert_wt_density"]
        experts[e.site] = (st["experts"], e.max_nnz, e.tk, min(dens),
                           max(dens), st["bytes_saved"])
        print(f"  {e.site}: E={st['experts']} experts, "
              f"max_nnz={e.max_nnz}/{e.tk}, "
              f"per-expert density {min(dens):.2f}–{max(dens):.2f}, "
              f"zvc saves {st['bytes_saved']/2**10:.0f} KiB")

    dense_ec = (decode_exec_config(moe_cfg, 2, use_kernels=True, device=dev)
                if kernels else None)
    toks = {}
    for label, cfg_ec in (("dense", dense_ec), ("planned", ec)):
        eng = ServeEngine(moe_cfg, params, n_slots=2, max_seq=32,
                          exec_cfg=cfg_ec, device=dev)
        eng.submit(np.array([3, 5, 7], np.int32), max_new=4)
        toks[label] = list(eng.run_until_drained().values())
    same = toks["planned"] == toks["dense"]
    print(f"planned MoE tokens == dense: {same}")
    assert same
    return {"leaves": len(ec.plan.entries), "experts": experts,
            "tokens": toks["planned"]}


def main(argv: Optional[List[str]] = None) -> dict:
    from repro_torch.device import resolve_device

    dev = resolve_device(parse_args(argv).device)
    out = two_sided(dev)
    out["plan"] = weight_plan(dev, out.pop("x"), out.pop("w_in"))
    out["moe"] = moe_plan(dev)
    return out


if __name__ == "__main__":
    main()
