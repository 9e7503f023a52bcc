"""Three-term roofline analysis (deliverable (g)) of the port.

Method.  Each cell's step is traced at a few reduced depths
(``structure_points``) at its microbatch count (``micro_points``) on one
rank of the single-pod (16, 16) mesh (``lower_point``: a fake process
group and fake tensors, ``launch.step_builders.trace_cell``), and the
per-rank metrics are fitted to

    metric(structure) = φ(structure) · θ

and evaluated at the full depth.  The fit is exact: eager PyTorch runs,
and the trace counts, every layer with the same operators, so each metric
is an affine function of the layer counts (the reference fits the same
grid because XLA's ``cost_analysis`` counts a scanned body once; here it
keeps a 72 B cell's traces to one or two layers).  ``models/unroll.py`` has no
counterpart: there is no scan to unroll.

Structure features per family (the reference's):
    dense/ssm/whisper : φ = [1, L]             points L ∈ {1, 2}
    moe (f dense)     : φ = [1, L_moe]         points L_moe ∈ {1, 2}
    recurrentgemma    : φ = [1, groups, trail] points (1,0), (2,0), (1,1)

Microbatches: the reference also fits m ∈ {1, 2} to the cell's count.
The port traces each point at the cell's own count: eager PyTorch runs m
microbatches of B / m rows, and with the rows the kernels' block padding
changes (and at one microbatch the step takes a route without
accumulation buffers), so a metric is not affine in m; tracing all of
them at one or two layers costs little.

Roofline terms per (arch × shape) on the single-pod mesh, per rank, for
an H100 SXM's datasheet constants (``core.scheduler.H100``):
    compute_s    = FLOPs / 989 TFLOP/s (dense bf16 tensor cores)
    memory_s     = bytes / 3.35 TB/s (HBM3); ``bytes`` sums every traced
                   operator's inputs and outputs plus the kernels'
                   operands and outputs: an upper bound on the device-
                   memory traffic (fusion and caches only lower it)
    collective_s = wire bytes / 450 GB/s (NVLink, per direction; a mesh of
                   more than 8 ranks leaves one NVLink domain, which the
                   term does not model)
plus MODEL_FLOPS (6·N_active·tokens for train, 2·N_active·tokens for
prefill / decode) and the usefulness ratio MODEL_FLOPS / FLOPs.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.scheduler import H100

PEAK_FLOPS = H100.peak_flops      # 989e12 bf16 FLOP/s, H100 SXM datasheet
HBM_BW = H100.hbm_bw              # 3.35e12 bytes/s, HBM3
ICI_BW = H100.ici_bw              # 450e9 bytes/s, NVLink per direction


# ---------------------------------------------------------------------------
# Structure grids
# ---------------------------------------------------------------------------

def structure_points(cfg) -> Tuple[List[Tuple[object, List[float]]],
                                   List[float]]:
    """[(cfg_variant, φ)], φ_full: the reduced-depth grid and the
    full-depth features."""
    if cfg.rglru.enabled:
        glen = len(cfg.rglru.block_pattern)
        n_groups, n_trail = divmod(cfg.n_layers, glen)
        pts = [
            (dataclasses.replace(cfg, n_layers=glen), [1.0, 1.0, 0.0]),
            (dataclasses.replace(cfg, n_layers=2 * glen), [1.0, 2.0, 0.0]),
        ]
        if n_trail:
            pts.append((dataclasses.replace(cfg, n_layers=glen + n_trail),
                        [1.0, 1.0, 1.0]))
        full = [1.0, float(n_groups), 1.0 if n_trail else 0.0]
        return pts, full
    if cfg.moe.enabled:
        f = cfg.moe.first_dense_layers
        pts = [
            (dataclasses.replace(cfg, n_layers=f + 1), [1.0, 1.0]),
            (dataclasses.replace(cfg, n_layers=f + 2), [1.0, 2.0]),
        ]
        return pts, [1.0, float(cfg.n_layers - f)]
    pts = [
        (dataclasses.replace(cfg, n_layers=1), [1.0, 1.0]),
        (dataclasses.replace(cfg, n_layers=2), [1.0, 2.0]),
    ]
    return pts, [1.0, float(cfg.n_layers)]


def micro_points(shape) -> Tuple[List[int], int]:
    """(microbatch counts to trace, the cell's count): the cell's own
    (module docstring); 1 for prefill and decode."""
    m = max(shape.n_micro, 1) if shape.kind == "train" else 1
    return [m], m


METRICS = ("flops", "bytes", "transcendentals", "coll_operand", "coll_wire",
           "coll_ag", "coll_ar", "coll_rs", "coll_a2a", "coll_perm")


def point_metrics(trace: Dict) -> Dict[str, float]:
    """``METRICS`` of one ``trace_cell`` reading."""
    coll = trace["collectives"]
    kinds = coll.by_kind()

    def kind(k):
        return kinds.get(k, {}).get("wire_bytes", 0.0)

    return {
        "flops": trace["flops"],
        "bytes": trace["bytes"],
        "transcendentals": trace["transcendentals"],
        "coll_operand": coll.operand_bytes,
        "coll_wire": coll.wire_bytes,
        "coll_ag": kind("all-gather"),
        "coll_ar": kind("all-reduce"),
        "coll_rs": kind("reduce-scatter"),
        "coll_a2a": kind("all-to-all"),
        "coll_perm": kind("collective-permute"),
    }


def lower_point(arch_id: str, shape_name: str, mesh, cfg_variant, m: int,
                base_shape, flags=None) -> Dict[str, float]:
    """Trace one reduced point; its per-rank metrics."""
    from repro_torch.launch.step_builders import build_cell_step, trace_cell

    shape = dataclasses.replace(base_shape, n_micro=m)
    step = build_cell_step(arch_id, shape_name, mesh, cfg=cfg_variant,
                           shape=shape, flags=flags)
    return point_metrics(trace_cell(step))


def fit_and_extrapolate(points: List[Tuple[List[float], Dict[str, float]]],
                        phi_full: List[float]) -> Dict[str, float]:
    """Least-squares fit metric = φ·θ per metric; evaluate at φ_full."""
    X = np.array([phi for phi, _ in points])
    out = {}
    for m in METRICS:
        y = np.array([vals[m] for _, vals in points])
        theta, *_ = np.linalg.lstsq(X, y, rcond=None)
        out[m] = float(np.dot(phi_full, theta))
    return out


def model_flops_per_device(cfg, shape, n_devices: int) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:
        total = 2.0 * n_active * shape.global_batch
    return total / n_devices


def roofline_terms(metrics: Dict[str, float]) -> Dict[str, float]:
    """The three terms (seconds) of per-rank ``metrics``."""
    return {"compute_s": metrics["flops"] / PEAK_FLOPS,
            "memory_s": metrics["bytes"] / HBM_BW,
            "collective_s": metrics["coll_wire"] / ICI_BW}


# ---------------------------------------------------------------------------
# Per-cell analysis
# ---------------------------------------------------------------------------

def coarse_shape(shape):
    """The reference's coarsened chunks for the reduced traces: at most 8
    attention and loss chunks a sequence (FLOPs and collectives do not
    depend on the chunking; the production dry-run keeps the real
    chunks)."""
    coarse = max(shape.seq_len // 8, 512)
    return dataclasses.replace(
        shape, attn_chunk=max(shape.attn_chunk, coarse),
        loss_chunk=max(shape.loss_chunk, coarse))


def analyze_cell(arch_id: str, shape_name: str, out_dir: str,
                 flags=None, shape_override=None,
                 cfg_override=None, tag: str = "") -> Dict:
    from repro_torch.configs.base import get_config
    from repro_torch.configs.cells import cell_shape, clamp_micro
    from repro_torch.launch.dryrun import MESH_SIZES, join_fake_group
    from repro_torch.launch.mesh import make_production_mesh

    join_fake_group(MESH_SIZES["single"])
    mesh = make_production_mesh(multi_pod=False)
    cfg = cfg_override or get_config(arch_id)
    base_shape = shape_override or cell_shape(arch_id, shape_name)
    if base_shape.kind == "train":
        base_shape = clamp_micro(base_shape, mesh.shape["data"])
    base_shape = coarse_shape(base_shape)

    pts, phi_full = structure_points(cfg)
    ms, m_full = micro_points(base_shape)

    t0 = time.time()
    measured = []
    for cfg_v, phi in pts:
        for m in ms:
            vals = lower_point(arch_id, shape_name, mesh, cfg_v, m,
                               base_shape, flags=flags)
            feat = [p * mm for p in phi for mm in ([1.0, m] if len(ms) > 1
                                                   else [1.0])]
            measured.append((feat, vals))
    phi_eval = [p * mm for p in phi_full
                for mm in ([1.0, m_full] if len(ms) > 1 else [1.0])]
    full = fit_and_extrapolate(measured, phi_eval)

    n_dev = mesh.size
    mf = model_flops_per_device(cfg, base_shape, n_dev)
    terms = roofline_terms(full)
    dominant = max(terms, key=terms.get)
    bound_s = terms[dominant]
    record = {
        "arch": arch_id, "shape": shape_name, "tag": tag,
        "devices": n_dev, "n_micro": base_shape.n_micro,
        "constants": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                      "link_bw": ICI_BW,
                      "source": "H100 SXM datasheet"},
        "metrics_per_device": full,
        "terms": terms,
        "dominant": dominant,
        "model_flops_per_device": mf,
        "useful_flops_ratio": mf / full["flops"] if full["flops"] else 0.0,
        "roofline_fraction": ((mf / PEAK_FLOPS) / bound_s) if bound_s else 0.0,
        "points": [{"phi": f, **v} for f, v in measured],
        "seconds": round(time.time() - t0, 1),
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"@{tag}" if tag else ""
    with open(os.path.join(out_dir, f"{arch_id}@{shape_name}{suffix}.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None) -> int:
    import argparse
    import traceback
    import warnings

    from repro_torch.configs.base import cells

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/torch/roofline")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    warnings.filterwarnings("ignore", category=FutureWarning)

    todo = list(cells()) if args.all else [(args.arch, args.shape)]
    failed = 0
    for arch_id, shape_name in todo:
        path = os.path.join(args.out, f"{arch_id}@{shape_name}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {arch_id}@{shape_name}")
            continue
        try:
            r = analyze_cell(arch_id, shape_name, args.out)
            t = r["terms"]
            print(f"[ok] {arch_id}@{shape_name} "
                  f"compute={t['compute_s']*1e3:.1f}ms "
                  f"memory={t['memory_s']*1e3:.1f}ms "
                  f"coll={t['collective_s']*1e3:.1f}ms "
                  f"dom={r['dominant']} useful={r['useful_flops_ratio']:.2f} "
                  f"roofline={r['roofline_fraction']:.2f} "
                  f"({r['seconds']}s)", flush=True)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            failed += 1
            print(f"[FAIL] {arch_id}@{shape_name}: {e}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
