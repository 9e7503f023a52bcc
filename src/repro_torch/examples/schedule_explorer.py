"""Schedule-space explorer, the JAX package's
``examples/schedule_explorer.py`` on PyTorch: FlexNN's core argument as an
experiment — sweep a whole network, layer by layer, over the fixed
dataflows against the flexible per-layer optimum, dense or under the
per-layer sparsity profiles, and show that no fixed choice wins
everywhere.

Run:  python -m repro_torch.examples.schedule_explorer [--net resnet50]
      [--sparse] [--device cpu]

The searches run on the card unless ``--device cpu`` (the vectorized grid
search of ``core.scheduler.optimize_layer``).  ``main`` returns the
figures it prints.
"""
from __future__ import annotations

import argparse
from collections import Counter
from typing import List, Optional

DATAFLOWS = ("ws", "os", "is", "nlr", "rs")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    from repro_torch.configs.cnn_zoo import NETWORKS

    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="resnet50", choices=sorted(NETWORKS))
    ap.add_argument("--sparse", action="store_true",
                    help="use the NNCF-style per-layer sparsity profiles")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    from repro_torch.configs.cnn_zoo import NETWORKS
    from repro_torch.core.energy_model import DENSE, FLEXNN
    from repro_torch.core.scheduler import optimize_layer
    from repro_torch.core.sparsity_profiles import profiles_for
    from repro_torch.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    layers = NETWORKS[args.net]()
    stats = (profiles_for(args.net, layers) if args.sparse
             else [DENSE] * len(layers))

    win_counts = Counter()
    losses = {df: [] for df in DATAFLOWS}
    total = {df: 0.0 for df in DATAFLOWS}
    total_flex = 0.0
    rows = []

    print(f"{args.net}: {len(layers)} layers "
          f"({'sparse profiles' if args.sparse else 'dense'})\n")
    print(f"{'layer':<24}{'best fixed':>10}{'flex gain':>10}  chosen schedule")
    for layer, sp in zip(layers, stats):
        flex = optimize_layer(layer, FLEXNN, sp, device=dev)
        fixed = {df: optimize_layer(layer, FLEXNN, sp, dataflow=df,
                                    device=dev).energy
                 for df in DATAFLOWS}
        best_df = min(fixed, key=fixed.get)
        win_counts[best_df] += 1
        total_flex += flex.energy
        for df in DATAFLOWS:
            total[df] += fixed[df]
            losses[df].append(fixed[df] / flex.energy)
        gain = 100 * (1 - flex.energy / fixed[best_df])
        rows.append({"layer": layer.name, "best_fixed": best_df,
                     "gain": gain, "schedule": flex.schedule.describe(),
                     "energy": flex.energy, "fixed": fixed})
        print(f"{layer.name:<24}{best_df:>10}{gain:>9.1f}%  "
              f"{flex.schedule.describe()}")

    print("\nbest-fixed-dataflow wins per layer:", dict(win_counts))
    print("\nnetwork energy vs flexible (=1.0):")
    ratios = {}
    for df in DATAFLOWS:
        ratios[df] = total[df] / total_flex
        print(f"  {df:>4}: {ratios[df]:.3f}x  "
              f"(worst layer {max(losses[df]):.2f}x)")
    n_best = max(win_counts.values())
    print(f"\nNo fixed dataflow is optimal everywhere: the most common "
          f"winner covers only {n_best}/{len(layers)} layers — "
          f"per-layer flexibility is what closes the gap (paper §II-A).")
    return {"layers": rows, "wins": dict(win_counts), "ratios": ratios,
            "total_flex": total_flex}


if __name__ == "__main__":
    main()
