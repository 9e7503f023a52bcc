"""Multi-pod dry-run (deliverable (e)) of the port.

Proves the distribution config is coherent without the hardware: for
every assigned (architecture × input-shape) cell, one rank's step must
run on the single-pod (16, 16) mesh and the two-pod (2, 16, 16) mesh.
The process joins a fake process group of the mesh's size as rank 0
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once, moving nothing) and runs the step on fake tensors
(``step_builders.trace_cell``): nothing is allocated and no card is
needed.  Per cell it records

  * ``memory`` — the rank's argument, output, temporary and peak bytes
    (``roofline.memory``), and whether the peak fits one H100's memory
    (``fits_hbm``: the card's ``total_memory`` where there is one, else
    80 GiB for the "H100 80GB HBM3");
  * ``cost`` — the rank's FLOPs (operators plus the kernels' counts) and
    ``bytes accessed`` (every operator's inputs and outputs plus the
    kernels' operands: an upper bound on device-memory traffic);
  * ``collectives`` — every collective the rank issued, with the
    reference's operand and wire-byte conventions;
  * ``sites`` — the descriptor table the cell's kernels ran under.

Records land in ``artifacts/torch/dryrun/<mesh>/<arch>@<shape>.json``
(the JAX package's own records, with their TPU keys, stay in
``artifacts/dryrun/``).  A failed cell, or one whose peak exceeds the
card's memory, makes the run exit 1.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k \\
        --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import warnings
from typing import List, Optional

H100_80GB = 80 * 1024**3          # an H100 SXM's HBM3
MESH_SIZES = {"single": 256, "multi": 512}


def card_memory():
    """(name, bytes) of the card the budget is checked against: this
    machine's first CUDA device, else an H100 80GB HBM3."""
    import torch
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return props.name, int(props.total_memory)
    return "NVIDIA H100 80GB HBM3 (not present: datasheet size)", H100_80GB


def join_fake_group(world: int) -> None:
    """Be rank 0 of a fake process group of ``world`` ranks (leaving any
    other group this process joined first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _sites(exec_cfg, cfg, model_shards: int) -> dict:
    from repro_torch.core.descriptors import site_plan_estimate
    if exec_cfg is None or exec_cfg.schedules is None:
        return {}
    return {
        name: {
            "m": d.m, "n": d.n, "k": d.k,
            "stationarity": d.schedule.stationarity,
            "blocks": [d.schedule.bm, d.schedule.bn, d.schedule.bk],
            "ic_p": d.reduce.ic_p, "reduce_strategy": d.reduce.strategy,
            "sparsity_mode": d.sparsity_mode,
            "hbm_bytes": d.schedule.hbm_bytes,
            "flops": d.schedule.flops,
            "plan": site_plan_estimate(d, cfg, model_shards=model_shards),
        } for name, d in exec_cfg.schedules.sites.items()}


def run_cell(arch_id: str, shape_name: str, mesh_kind: str,
             out_dir: str) -> dict:
    """Trace one rank's step of the cell on the production mesh and write
    its record."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.step_builders import build_cell_step, trace_cell

    join_fake_group(MESH_SIZES[mesh_kind])
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    t0 = time.perf_counter()
    step = build_cell_step(arch_id, shape_name, mesh)
    t_build = time.perf_counter() - t0
    tr = trace_cell(step)
    mem = tr["memory"]
    coll = tr["collectives"]
    card, budget = card_memory()
    live = mem["peak_bytes"]
    record = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
        "devices": mesh.size,
        "mesh_shape": dict(mesh.shape),
        "n_micro": step.shape.n_micro, "remat": step.shape.remat,
        "flags": {"seq_shard": step.flags.seq_shard,
                  "fsdp": step.flags.fsdp},
        "sites": _sites(step.exec_cfg, step.cfg,
                        mesh.shape.get("model", 1)),
        "seconds": {"build": round(t_build, 2),
                    "trace": round(tr["seconds"], 2)},
        "memory": {"argument_size_in_bytes": mem["argument_bytes"],
                   "output_size_in_bytes": mem["output_bytes"],
                   "temp_size_in_bytes": mem["temp_bytes"],
                   "peak_bytes": mem["peak_bytes"]},
        "live_bytes_per_device": int(live),
        "card": card, "card_bytes": budget,
        "fits_hbm": bool(live <= budget),
        "cost": {"flops": tr["flops"], "bytes accessed": tr["bytes"],
                 "transcendentals": tr["transcendentals"],
                 "kernel_flops": tr["kernel_flops"]},
        "collectives": {
            "operand_bytes": coll.operand_bytes,
            "wire_bytes": coll.wire_bytes,
            "by_kind": coll.by_kind(),
            "count": len(coll.ops),
        },
        "ok": True,
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch_id}@{shape_name}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.configs.base import CELL_ARCH_IDS, SHAPES, cells

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=CELL_ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/torch/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        todo = list(cells())
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]
    warnings.filterwarnings("ignore", category=FutureWarning)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = []
    for mesh_kind in meshes:
        out_dir = os.path.join(args.out, mesh_kind)
        for arch_id, shape_name in todo:
            path = os.path.join(out_dir, f"{arch_id}@{shape_name}.json")
            tag = f"{arch_id}@{shape_name} ({mesh_kind})"
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {tag}")
                continue
            try:
                r = run_cell(arch_id, shape_name, mesh_kind, out_dir)
                print(f"[ok]   {tag}  "
                      f"live={r['live_bytes_per_device'] / 2**30:.2f}GiB "
                      f"fits={r['fits_hbm']} "
                      f"flops/dev={r['cost']['flops']:.3e} "
                      f"coll={r['collectives']['wire_bytes'] / 2**30:.3f}GiB"
                      f" trace={r['seconds']['trace']}s", flush=True)
                if not r["fits_hbm"]:
                    failures.append(
                        (tag, f"{r['live_bytes_per_device'] / 2**30:.2f} GiB"
                              f" exceeds {r['card']}"))
            except Exception as e:  # noqa: BLE001 — record and continue
                traceback.print_exc()
                failures.append((tag, repr(e)[:200]))
                os.makedirs(out_dir, exist_ok=True)
                with open(path, "w") as f:
                    json.dump({"arch": arch_id, "shape": shape_name,
                               "mesh": mesh_kind, "ok": False,
                               "error": traceback.format_exc()[-2000:]},
                              f, indent=1)
                print(f"[FAIL] {tag}: {e}", flush=True)

    n = len(todo) * len(meshes)
    print(f"\n{n - len(failures)}/{n} cells passed")
    for tag, err in failures:
        print(f"  FAIL {tag}: {err}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
