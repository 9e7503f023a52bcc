"""Schedule search — the "compiler" role of FlexNN (§III-A), ported from
the JAX package's ``core/scheduler.py``.

FlexNN's hardware accepts *any* schedule; the per-layer optimal schedule is
found by software.  The first half enumerates the schedule space (loop
order × blocking × partitioning) and returns the minimum-energy point of
the access-count model (``core.energy_model``); fixed-dataflow baselines
(Eyeriss-RS, TPU-WS, OS, IS) are the same search constrained to their
dataflow family — exactly the framing of §II-A / Fig 3.  The search is one
float64 tensor program per layer on a device (``core._vectorized``).

The second half is the matmul schedule selector of the serving path: the
same stationarity/blocking decision per matmul site, minimising modelled
device-memory traffic under the per-block fast-memory budget of the target
(``TPU_V5E`` or ``H100``).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import _vectorized
from repro_torch.core.energy_model import (
    Accelerator,
    ConvLayer,
    Cost,
    DENSE,
    Schedule,
    SparsityStats,
    evaluate,
    rf_feasible,
)
from repro_torch.device import resolve_device


def _pow2_factors(n: int, cap: int) -> List[int]:
    out = [1]
    f = 2
    while f <= min(n, cap):
        out.append(f)
        f *= 2
    if n <= cap and n not in out:
        out.append(n)
    return out


# Representative loop orders: the canonical dataflows + rotations.  (Full 24
# permutations change results <1% in practice; these 8 span the reuse space.)
_ORDERS: Tuple[Tuple[str, ...], ...] = (
    ("oc", "ic", "oy", "ox"),   # IF-ish stationary inner spatial
    ("ic", "oc", "oy", "ox"),   # WS: FL loops outermost → FL loaded once
    ("oc", "oy", "ox", "ic"),   # OS: reduction innermost → no psum spill
    ("oy", "ox", "oc", "ic"),   # OS spatial-major
    ("ox", "oy", "ic", "oc"),   # IS: IF loops outermost
    ("ic", "oy", "ox", "oc"),
    ("oy", "ox", "ic", "oc"),
    ("oc", "ox", "oy", "ic"),
)

_DATAFLOW_ORDERS: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    "ws": (("ic", "oc", "oy", "ox"), ("oc", "ic", "oy", "ox")),
    "os": (("oc", "oy", "ox", "ic"), ("oy", "ox", "oc", "ic")),
    "is": (("ox", "oy", "ic", "oc"), ("oy", "ox", "ic", "oc")),
    "rs": (("oc", "oy", "ic", "ox"),),
    "nlr": (("ic", "oc", "oy", "ox"),),
}


def enumerate_schedules(layer: ConvLayer, acc: Accelerator,
                        sp: SparsityStats = DENSE,
                        orders: Optional[Sequence[Tuple[str, ...]]] = None,
                        dataflow: Optional[str] = None,
                        ) -> Iterable[Schedule]:
    """Yield RF-feasible schedules.  ``dataflow`` constrains to a fixed
    family (order + partitioning style); None = full flexible space.  The
    partition sets are ``_partition_sets``' (the reference spells the same
    sets out a second time here)."""
    ic_g = layer.ic // layer.groups
    if orders is None:
        orders = _DATAFLOW_ORDERS[dataflow] if dataflow else _ORDERS

    p_sets = _partition_sets(layer, acc, dataflow)

    # blocking candidates -----------------------------------------------------
    b_ics = _pow2_factors(ic_g, acc.rf_if)
    b_ocs = _pow2_factors(layer.oc, acc.rf_of)
    b_oxs = _pow2_factors(layer.ox, 16)
    b_oys = _pow2_factors(layer.oy, 16)

    seen = set()
    for ps in p_sets:
        for b_ic, b_oc, b_ox, b_oy in itertools.product(b_ics, b_ocs,
                                                        b_oxs, b_oys):
            sched = Schedule(order=orders[0], b_ic=b_ic, b_oc=b_oc,
                             b_ox=b_ox, b_oy=b_oy, **ps)
            if not rf_feasible(layer, sched, acc, sp):
                continue
            for order in orders:
                key = (order, b_ic, b_oc, b_ox, b_oy,
                       tuple(sorted(ps.items())))
                if key in seen:
                    continue
                seen.add(key)
                yield Schedule(order=order, b_ic=b_ic, b_oc=b_oc, b_ox=b_ox,
                               b_oy=b_oy, **ps)


def _partition_sets(layer: ConvLayer, acc: Accelerator,
                    dataflow: Optional[str]) -> List[dict]:
    ic_g = layer.ic // layer.groups
    rows, cols = acc.pe_rows, acc.pe_cols
    if dataflow == "rs":
        return [dict(p_fy=min(layer.fy, rows), p_oy=min(layer.oy, cols),
                     p_ic=1, p_oc=1, p_ox=1)]
    if dataflow == "ws":
        p_ic = min(rows, 1 << int(math.log2(ic_g))) if ic_g > 1 else 1
        p_oc = min(cols, 1 << int(math.log2(layer.oc))) if layer.oc > 1 else 1
        return [dict(p_ic=p_ic, p_oc=p_oc, p_ox=1, p_oy=1, p_fy=1)]
    if dataflow == "os":
        return [dict(p_ox=min(layer.ox, cols), p_oy=min(layer.oy, rows),
                     p_ic=1, p_oc=1, p_fy=1)]
    if dataflow == "is":
        return [dict(p_ox=min(layer.ox, cols), p_oc=min(layer.oc, rows),
                     p_ic=1, p_oy=1, p_fy=1)]
    if dataflow == "nlr":
        return [dict(p_oc=min(layer.oc, cols), p_ic=min(ic_g, rows),
                     p_ox=1, p_oy=1, p_fy=1)]
    p_sets = []
    for p_oc in _pow2_factors(layer.oc, cols):
        for p_ic in _pow2_factors(ic_g, rows):
            rem = (rows * cols) // max(p_oc * p_ic, 1)
            if rem < 1:
                continue
            for p_ox in _pow2_factors(layer.ox, rem):
                p_oy = min(rem // p_ox, layer.oy)
                p_oy = 1 << int(math.log2(p_oy)) if p_oy >= 1 else 1
                p_sets.append(dict(p_oc=p_oc, p_ic=p_ic, p_ox=p_ox,
                                   p_oy=max(p_oy, 1), p_fy=1))
    return p_sets


def optimize_layer(layer: ConvLayer, acc: Accelerator,
                   sp: SparsityStats = DENSE, *,
                   dataflow: Optional[str] = None,
                   objective: str = "energy",
                   count_dram: bool = True,
                   device: Union[str, torch.device, None] = "cuda") -> Cost:
    """Best schedule for ``layer`` on ``acc``.

    ``dataflow=None`` + ``acc.flexible`` searches the full space (FlexNN);
    otherwise the accelerator's fixed family is used.  Uses the vectorized
    grid search (``core._vectorized``: one float64 tensor program on
    ``device``, CUDA unless the caller names the CPU); semantics are
    pinned to the scalar ``evaluate`` by re-scoring the winner.
    """
    if dataflow is None and not acc.flexible:
        dataflow = acc.fixed_dataflow
    orders = _DATAFLOW_ORDERS[dataflow] if dataflow else _ORDERS
    p_sets = _partition_sets(layer, acc, dataflow)
    ic_g = layer.ic // layer.groups
    best = _vectorized.search(
        layer, acc, sp, orders, p_sets,
        _pow2_factors(ic_g, acc.rf_if), _pow2_factors(layer.oc, acc.rf_of),
        _pow2_factors(layer.ox, 16), _pow2_factors(layer.oy, 16),
        objective=objective, count_dram=count_dram,
        device=resolve_device(device))
    if best is None:
        best = evaluate(layer, Schedule(), acc, sp, count_dram=count_dram)
    return best


def optimize_network(layers: Sequence[ConvLayer], acc: Accelerator,
                     sps: Optional[Sequence[SparsityStats]] = None, *,
                     dataflow: Optional[str] = None,
                     objective: str = "energy",
                     count_dram: bool = True,
                     device: Union[str, torch.device, None] = "cuda"
                     ) -> List[Cost]:
    device = resolve_device(device)
    sps = sps or [DENSE] * len(layers)
    return [optimize_layer(l, acc, s, dataflow=dataflow, objective=objective,
                           count_dram=count_dram, device=device)
            for l, s in zip(layers, sps)]


# ---------------------------------------------------------------------------
# Matmul schedule selection (the serving path's twin)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TPUHardware:
    """One chip's constants for the schedule selector: v5e-class by default
    (the reference's table, kept for parity), ``H100`` for the card."""
    peak_flops: float = 197e12          # bf16 FLOP/s
    hbm_bw: float = 819e9               # bytes/s
    ici_bw: float = 50e9                # bytes/s/link
    vmem_bytes: int = 96 * 2**20        # usable VMEM budget (of ~128MB)
    mxu: int = 128                      # systolic tile edge


TPU_V5E = TPUHardware()

# NVIDIA H100 SXM data-sheet figures (dense bf16 tensor-core rate, HBM3
# bandwidth, NVLink per direction).  ``vmem_bytes`` is the shared memory
# one CUDA block may use (227 KB), so the budget formula in
# ``select_matmul_schedule`` keeps blocks at 128-256 a side; ``mxu`` is the
# widest ``wgmma`` tile edge.
H100 = TPUHardware(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
                   vmem_bytes=232_448, mxu=256)


@dataclass(frozen=True)
class MatmulSchedule:
    """Stationarity + blocking for one matmul site: the FlexNN schedule
    descriptor lowered to kernel block shapes.

    ``sparsity_mode`` records the skip capability the schedule was costed
    under (dense | weight | two_sided); ``hbm_bytes``/``flops`` already carry
    the ZVC/CSB discounts for that mode.  ``wt_bytes`` is the weight element
    width the traffic model used (1 for int8-quantized weights — activations
    keep ``in_bytes``), so int8 × ZVC savings compound in the argmin."""
    stationarity: str          # 'output' | 'weight' | 'input'
    bm: int
    bn: int
    bk: int
    ic_p: int = 1              # contraction partition across mesh axis
    hbm_bytes: float = 0.0
    flops: float = 0.0
    sparsity_mode: str = "dense"
    wt_bytes: int = 2

    @property
    def grid_order(self) -> Tuple[str, ...]:
        # innermost last; mirrors core.Schedule.order semantics
        return {
            "output": ("m", "n", "k"),   # k innermost: acc stays on chip
            "weight": ("n", "k", "m"),   # m innermost: B block resident
            "input": ("m", "k", "n"),    # n innermost: A block resident
        }[self.stationarity]


def _mm_hbm_bytes(m: int, n: int, k: int, bm: int, bn: int, bk: int,
                  stat: str, in_bytes: int = 2, out_bytes: int = 2,
                  acc_bytes: int = 4, a_scale: float = 1.0,
                  b_scale: float = 1.0,
                  wt_bytes: Optional[int] = None) -> float:
    """HBM traffic for a tiled matmul under a stationarity choice — the same
    refetch counting as FlexNN's energy model, with the per-block fast
    memory playing the RF role.

    ``a_scale``/``b_scale`` discount operand fetches for ZVC-compressed
    sparse operands (density + the 1 bit/element bitmap overhead); psum/
    output traffic is never discounted (results are dense).  ``wt_bytes``
    overrides the B-operand element width (int8 weights = 1 byte while
    activations stay ``in_bytes``); None = same as ``in_bytes``."""
    tm, tn, tk = -(-m // bm), -(-n // bn), -(-k // bk)
    wb = in_bytes if wt_bytes is None else wt_bytes
    a_tile, b_tile, o_tile = bm * bk * in_bytes, bk * bn * wb, bm * bn
    if stat == "output":          # loops m>n>k : A refetched per n, B per m
        a_reads = tm * tn * tk * a_tile
        b_reads = tm * tn * tk * b_tile
        o_traffic = m * n * out_bytes
    elif stat == "weight":        # loops n>k>m : B read once, A per n, psum spills per k
        a_reads = tn * tk * tm * a_tile
        b_reads = tn * tk * b_tile
        spills = (tk - 1) * m * n * acc_bytes * 2
        o_traffic = m * n * out_bytes + spills
    else:                         # input-stationary: A read once, B per m
        a_reads = tm * tk * a_tile
        b_reads = tm * tk * tn * b_tile
        spills = (tk - 1) * m * n * acc_bytes * 2
        o_traffic = m * n * out_bytes + spills
    return a_reads * a_scale + b_reads * b_scale + o_traffic


def _sparsity_scales(sparsity_mode: str, act_density: float,
                     wt_density: float, in_bytes: int,
                     wt_bytes: Optional[int] = None
                     ) -> Tuple[float, float, float]:
    """(a_scale, b_scale, flop_scale) for a sparsity capability.

    ZVC-compressed fetches cost density + 1 bit/element bitmap (§IV); MACs
    scale with the surviving-pair fraction — wt_density for weight-sided
    skipping, act·wt (the expected CSB popcount of Fig 13) for two-sided.
    The bitmap overhead is *relative to the operand's own element width*, so
    an int8 weight (``wt_bytes=1``) pays 1/8 per element, not 1/16.
    """
    wb = in_bytes if wt_bytes is None else wt_bytes
    bitmap_a = 1.0 / (8.0 * in_bytes)
    bitmap_b = 1.0 / (8.0 * wb)
    if sparsity_mode == "weight":
        return 1.0, min(1.0, wt_density + bitmap_b), wt_density
    if sparsity_mode == "two_sided":
        return (min(1.0, act_density + bitmap_a),
                min(1.0, wt_density + bitmap_b),
                act_density * wt_density)
    return 1.0, 1.0, 1.0


def select_matmul_schedule(m: int, n: int, k: int, *,
                           hw: TPUHardware = TPU_V5E,
                           in_bytes: int = 2,
                           ic_p: int = 1,
                           sparsity_mode: str = "dense",
                           act_density: float = 1.0,
                           wt_density: float = 1.0,
                           wt_bytes: Optional[int] = None) -> MatmulSchedule:
    """Pick (stationarity, bm, bn, bk) minimizing HBM traffic s.t. VMEM.

    This is FlexNN's per-layer schedule selection re-targeted at an
    accelerator memory hierarchy (``hw``: ``TPU_V5E`` or ``H100``);
    consumed by ``kernels.ops.flex_matmul``.

    Stationarity × sparsity are co-optimized: under ``weight``/``two_sided``
    modes the operand fetch traffic and MAC count are discounted by the ZVC/
    CSB skip fractions before the argmin, so a sparse weight tilts the choice
    away from weight-stationary reuse (the B operand is cheap to refetch when
    most of its blocks are dead) — the Flexagon/Eyeriss-v2 co-design point.

    ``wt_bytes=1`` costs the weight operand at int8 width (the quantized
    serving path): the B-fetch term and its bitmap overhead shrink together
    with the ZVC density discount, so the selector ranks int8 × sparse
    schedules by their *compounded* traffic.
    """
    best: Optional[MatmulSchedule] = None
    wb = in_bytes if wt_bytes is None else wt_bytes
    a_scale, b_scale, flop_scale = _sparsity_scales(
        sparsity_mode, act_density, wt_density, in_bytes, wb)
    blocks = (128, 256, 512, 1024)
    for stat in ("output", "weight", "input"):
        for bm in blocks:
            if bm > m and bm != blocks[0]:
                continue
            for bn in blocks:
                if bn > n and bn != blocks[0]:
                    continue
                for bk in blocks:
                    if bk > k and bk != blocks[0]:
                        continue
                    cbm, cbn, cbk = min(bm, m), min(bn, n), min(bk, k)
                    vmem = (cbm * cbk * in_bytes + cbk * cbn * wb) * 2 \
                        + cbm * cbn * 4           # dbl-buffered ins + f32 acc
                    if vmem > hw.vmem_bytes:
                        continue
                    bytes_ = _mm_hbm_bytes(m, n, -(-k // ic_p), cbm, cbn, cbk,
                                           stat, in_bytes, a_scale=a_scale,
                                           b_scale=b_scale, wt_bytes=wb)
                    if best is None or bytes_ < best.hbm_bytes:
                        best = MatmulSchedule(
                            stationarity=stat, bm=cbm, bn=cbn, bk=cbk,
                            ic_p=ic_p, hbm_bytes=bytes_,
                            flops=2.0 * m * n * k / ic_p * flop_scale,
                            sparsity_mode=sparsity_mode, wt_bytes=wb)
    if best is None:
        raise ValueError(f"no block shape fits {hw.vmem_bytes} bytes for "
                         f"M={m} N={n} K={k}")
    return best


def roofline_time(s: MatmulSchedule, hw: TPUHardware = TPU_V5E) -> float:
    return max(s.flops / hw.peak_flops, s.hbm_bytes / hw.hbm_bw)
