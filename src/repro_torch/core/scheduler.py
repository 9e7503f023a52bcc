"""Matmul schedule selection — the "compiler" role of FlexNN (§III-A),
ported from the JAX package's ``core/scheduler.py``: stationarity + blocking
per matmul site, minimising modelled device-memory traffic under the
per-block fast-memory budget of the target (``TPU_V5E`` or ``H100``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


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
