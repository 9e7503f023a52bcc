"""Per-layer sparsity profiles for the paper's sparse-CNN benchmarks (§IV),
ported from the JAX package's ``core/sparsity_profiles.py``.

The paper measures per-layer weight sparsity from NNCF-compressed models and
activation sparsity over the ImageNet-2012 validation set.  Neither the
models nor the dataset ship with this container, so we *synthesize*
deterministic per-layer profiles that reproduce every statistic the paper
reports (§V-C):

  network        weight_sp(net)  act_sp(net)  layer ranges
  ResNet50       61%             55%          wt 5–88%, act 14–83%
  MobileNetV2    52%             30%          wt ≤70% (most conv <50%)
  GoogLeNet      24%             58%          wt ≤30% (filter-pruned), act ≤91%
  InceptionV3    61%             63%          wt ≤96%, act ≤78%

The shapes of the profiles follow the paper's qualitative description: act
sparsity grows with depth (ReLU compounding, §II-B); weight sparsity is low
in stem/1x1-reduce layers and high in wide mid/late convs.

The jitter comes from numpy's ``default_rng``, seeded as the reference
seeds it — from ``hash(network)``, which Python randomizes per process for
``str`` (``PYTHONHASHSEED``): the profiles equal the reference's within one
process, and change from one process to the next in both.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.energy_model import ConvLayer, SparsityStats


def _profile(n: int, lo: float, hi: float, net_avg: float,
             weights: Sequence[float], seed: int) -> np.ndarray:
    """Deterministic per-layer values in [lo, hi] whose MAC-weighted mean is
    ``net_avg``: depth-increasing base + seeded jitter, then affine-corrected.
    """
    rng = np.random.default_rng(seed)
    depth = np.linspace(0.0, 1.0, n)
    base = lo + (hi - lo) * (0.25 + 0.75 * depth)
    jitter = rng.uniform(-0.12, 0.12, size=n)
    prof = np.clip(base + jitter * (hi - lo), lo, hi)
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    # affine shift toward target weighted mean, staying in [lo, hi]
    for _ in range(64):
        cur = float((prof * w).sum())
        if abs(cur - net_avg) < 1e-4:
            break
        prof = np.clip(prof + (net_avg - cur), lo, hi)
    return prof


_NETWORK_STATS = {
    #                (wt_lo, wt_hi, wt_net), (act_lo, act_hi, act_net)
    "resnet50":     ((0.05, 0.88, 0.61), (0.14, 0.83, 0.55)),
    "mobilenet_v2": ((0.02, 0.70, 0.52), (0.05, 0.74, 0.30)),
    "googlenet":    ((0.00, 0.30, 0.24), (0.10, 0.91, 0.58)),
    "inception_v3": ((0.05, 0.96, 0.61), (0.10, 0.78, 0.63)),
}


def profiles_for(network: str, layers: Sequence[ConvLayer]
                 ) -> List[SparsityStats]:
    """Per-layer SparsityStats whose MAC-weighted means match §V-C."""
    if network not in _NETWORK_STATS:
        raise KeyError(network)
    (wlo, whi, wnet), (alo, ahi, anet) = _NETWORK_STATS[network]
    macs = [l.macs for l in layers]
    n = len(layers)
    wt = _profile(n, wlo, whi, wnet, macs, seed=hash(network) % 2**31)
    act = _profile(n, alo, ahi, anet, macs, seed=(hash(network) + 1) % 2**31)
    # first conv inputs are dense images (§V-C1: "except before the first
    # conv layer")
    act[0] = min(act[0], 0.05)
    return [SparsityStats(act_density=1.0 - float(a), wt_density=1.0 - float(w))
            for a, w in zip(act, wt)]


def network_sparsity(stats: Sequence[SparsityStats],
                     layers: Sequence[ConvLayer]) -> Tuple[float, float]:
    """MAC-weighted (weight_sp, act_sp) at network level."""
    macs = np.asarray([l.macs for l in layers], dtype=np.float64)
    macs /= macs.sum()
    wt = sum((1.0 - s.wt_density) * m for s, m in zip(stats, macs))
    act = sum((1.0 - s.act_density) * m for s, m in zip(stats, macs))
    return float(wt), float(act)
