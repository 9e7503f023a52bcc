"""Hillclimb CLI: re-analyze a cell under knob overrides and diff its
roofline terms against the recorded baseline (``roofline.analysis``'s
record of the same cell).

    python -m repro_torch.roofline.hillclimb --arch qwen2-vl-72b \\
        --shape train_4k --tag bf16grad --set grad_dtype=bf16
    python -m repro_torch.roofline.hillclimb ... --tag micro8 --set n_micro=8
    python -m repro_torch.roofline.hillclimb ... --tag nofsdp --flag fsdp=false

Writes artifacts/torch/roofline/<arch>@<shape>@<tag>.json and prints the
before / after of every term.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="ShapeConfig field override, e.g. n_micro=8")
    ap.add_argument("--flag", action="append", default=[],
                    help="CellFlags override, e.g. fsdp=false")
    ap.add_argument("--cf", type=float, default=None,
                    help="MoE capacity-factor override")
    ap.add_argument("--out", default="artifacts/torch/roofline")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_config
    from repro_torch.configs.cells import cell_flags, cell_shape
    from repro_torch.roofline.analysis import analyze_cell

    cfg_override = None
    if args.cf is not None:
        cfg = get_config(args.arch)
        cfg_override = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=args.cf))

    shape = cell_shape(args.arch, args.shape)
    for kv in args.set:
        k, v = kv.split("=")
        field_t = type(getattr(shape, k))
        shape = dataclasses.replace(shape, **{k: field_t(v) if field_t is not
                                              bool else v == "true"})
    flags = cell_flags(args.arch, args.shape)
    for kv in args.flag:
        k, v = kv.split("=")
        flags = dataclasses.replace(flags, **{k: v.lower() == "true"})

    base_path = os.path.join(args.out, f"{args.arch}@{args.shape}.json")
    base = None
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)

    rec = analyze_cell(args.arch, args.shape, args.out,
                       flags=flags, shape_override=shape,
                       cfg_override=cfg_override, tag=args.tag)
    print(f"\n=== {args.arch}@{args.shape} [{args.tag}] ===")
    for term in ("compute_s", "memory_s", "collective_s"):
        new = rec["terms"][term]
        if base:
            old = base["terms"][term]
            delta = 100.0 * (new / old - 1.0) if old else float("nan")
            print(f"  {term:<14} {old*1e3:10.1f} ms -> {new*1e3:10.1f} ms "
                  f"({delta:+.1f}%)")
        else:
            print(f"  {term:<14} {new*1e3:10.1f} ms")
    print(f"  dominant: {base['dominant'] if base else '?'} -> "
          f"{rec['dominant']}; roofline fraction "
          f"{base['roofline_fraction'] if base else 0:.3f} -> "
          f"{rec['roofline_fraction']:.3f}")
    if base:
        for k in ("coll_ag", "coll_ar", "coll_rs", "coll_a2a"):
            o = base["metrics_per_device"][k] / 2**30
            n = rec["metrics_per_device"][k] / 2**30
            if max(o, n) > 0.01:
                print(f"    {k}: {o:.2f} -> {n:.2f} GiB/device")
    return rec


if __name__ == "__main__":
    main()
