"""Hierarchical access-count energy/latency model (FlexNN §II, §IV, Table I),
ported from the JAX package's ``core/energy_model.py``.

This is the analytical framework the paper itself uses for its evaluation:
given a conv/matmul loop nest, an accelerator description (PE array, RF
sizes, per-level energy cost ratios) and a *schedule* (loop order, blocking,
partitioning), count data movement at each memory level and effective MAC
cycles under dense / weight-sided / two-sided sparsity.

Model structure (3-level hierarchy, matching §III-A):

    DRAM  →  SRAM  →  per-PE RF  →  MAC

* Spatial partitioning spreads dims over the PE array (`p_oc` across
  columns, `p_ic` across rows — accumulated by FlexTree —, `p_ox/p_oy/p_fy`
  spatially).  The NoC multicasts: an SRAM read is counted once per
  *distinct* datum per fetch round (§III-C Fig 9).
* RF blocking (`b_*`) fixes each PE's tile; the RF holds one (double-
  buffered) tile per tensor, in ZVC-compressed form (§III-D), so capacity
  constraints apply to *compressed* footprints.
* The SRAM-level temporal loop order determines refetches: a tensor's tile
  must be re-read from SRAM once per iteration of every loop at or outside
  its innermost *relevant* loop (the classical uniform-reuse counting; this
  is what makes IS/WS/OS schedules differ).

Energy = Σ_level accesses × cost_ratio + effective_MACs × cost_mac, with
Table I cost ratios (PE : RF : SRAM : DRAM).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

PSUM_BYTES = 4       # psum precision (32-bit, §III-B external psum bypass)
DATA_BYTES = 1       # INT8 activations/weights (§IV)
BITMAP_OVERHEAD = 1.0 / 8.0   # 1 bit of bitmap per data byte (§IV)
SCALE_BYTES = 4      # f32 per-output-channel dequant scale (int8 path)


def zvc_weight_bytes(n_elems: float, nnz: float, *, elem_bytes: float = 2,
                     quantized: bool = False, n_channels: float = 0
                     ) -> float:
    """Weight storage under ZVC (§IV), optionally compounded with int8.

    The ASIC model above is int8-native (``DATA_BYTES = 1``); the serving
    path stores bf16/f32 weights unless quantized.  This is the shared byte
    model for that path (``core.sparsity``'s plans use it): packed
    non-zeros at ``elem_bytes`` (1 when ``quantized``) + the 1-bit/element
    ZVC bitmap + the f32 per-output-channel scales the int8 representation
    adds.  Quantization
    is zero-preserving (``quant.quantize_weight``), so ``nnz`` — and the
    bitmap — are the same in both representations: the ZVC and int8
    savings *compound*, the paper's §IV + §III-A claim.
    """
    data = nnz * (1.0 if quantized else float(elem_bytes))
    scales = SCALE_BYTES * float(n_channels) if quantized else 0.0
    return data + n_elems / 8.0 + scales


# ---------------------------------------------------------------------------
# Workload: conv loop nest (matmul = 1x1 conv)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ConvLayer:
    name: str
    ox: int
    oy: int
    oc: int
    ic: int
    fx: int = 1
    fy: int = 1
    stride: int = 1
    groups: int = 1          # depthwise: groups == ic == oc

    @property
    def ix(self) -> int:
        return (self.ox - 1) * self.stride + self.fx

    @property
    def iy(self) -> int:
        return (self.oy - 1) * self.stride + self.fy

    @property
    def macs(self) -> int:
        return self.ox * self.oy * self.oc * (self.ic // self.groups) \
            * self.fx * self.fy

    @property
    def if_size(self) -> int:
        return self.ix * self.iy * self.ic

    @property
    def fl_size(self) -> int:
        return self.fx * self.fy * (self.ic // self.groups) * self.oc

    @property
    def of_size(self) -> int:
        return self.ox * self.oy * self.oc

    @staticmethod
    def from_matmul(name: str, m: int, n: int, k: int) -> "ConvLayer":
        """A matmul C[M,N] = A[M,K]·B[K,N] as a 1x1 'conv': OX=M, OC=N, IC=K."""
        return ConvLayer(name=name, ox=m, oy=1, oc=n, ic=k)


# ---------------------------------------------------------------------------
# Accelerator descriptions (Table I)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Accelerator:
    name: str
    pe_rows: int = 16
    pe_cols: int = 16
    macs_per_pe: int = 8
    rf_if: int = 64              # bytes (FlexNN: 4x16B IF CD RF)
    rf_fl: int = 64
    rf_of: int = 64
    sram_bytes: int = 1_572_864  # 1.5 MB
    # energy cost ratios per byte-access: PE(MAC) : RF : SRAM : DRAM
    cost_mac: float = 1.0
    cost_rf: float = 0.125
    cost_sram: float = 6.0
    cost_dram: float = 200.0
    cost_inter_pe: float = 0.0   # Eyeriss inter-PE psum forwarding (RF:PE=1:2)
    # dataflow capability
    flexible: bool = True
    fixed_dataflow: Optional[str] = None   # 'rs' | 'ws' | 'os' | 'is' | 'nlr'
    # sparsity capability: 'two_sided' | 'weight' | 'none'
    sparsity_support: str = "two_sided"
    # FlexTree (configurable-depth adder tree). False = neighbor psum chain.
    flextree: bool = True
    # effective load bandwidth: FlexNN has separate IF and FL NoCs fed by
    # 32-byte SRAM read ports (Fig 8) → 64 B/cycle aggregate into the array.
    sram_port_bytes: int = 64

    @property
    def n_pes(self) -> int:
        return self.pe_rows * self.pe_cols


FLEXNN = Accelerator(name="flexnn")

# Eyeriss: 168 PEs (12x14), 512B RF/PE, RS dataflow, 1:1:6:200 ratios,
# inter-PE psum forwarding at 2x RF cost (Table I footnote).
EYERISS = Accelerator(
    name="eyeriss", pe_rows=12, pe_cols=14, macs_per_pe=1,
    rf_if=170, rf_fl=224, rf_of=118,          # 512B RF split (Eyeriss paper)
    cost_rf=1.0, cost_inter_pe=2.0,
    flexible=False, fixed_dataflow="rs", sparsity_support="none",
    flextree=False, sram_port_bytes=32,       # single GLB read port
)

# TPU-like: 256 PEs, 32B RF/PE, weight-stationary systolic, 1:0.06:6:200.
TPU = Accelerator(
    name="tpu", pe_rows=16, pe_cols=16, macs_per_pe=1,
    rf_if=8, rf_fl=16, rf_of=8,
    cost_rf=0.06,
    flexible=False, fixed_dataflow="nlr", sparsity_support="none",
    flextree=False, sram_port_bytes=32,       # unified buffer port
)


def flexnn_variant(sparsity_support: str) -> Accelerator:
    """Dense / weight-sided variants of FlexNN for the §V-C comparison."""
    return replace(FLEXNN, name=f"flexnn-{sparsity_support}",
                   sparsity_support=sparsity_support)


# ---------------------------------------------------------------------------
# Schedule (loop order + blocking + partitioning — Fig 3)
# ---------------------------------------------------------------------------

DIMS = ("oc", "ic", "oy", "ox")          # SRAM-level temporal dims
_RELEVANT = {
    "if": frozenset({"ic", "oy", "ox"}),
    "fl": frozenset({"ic", "oc"}),
    "of": frozenset({"oc", "oy", "ox"}),
}


@dataclass(frozen=True)
class Schedule:
    """One point in FlexNN's schedule space (§II-A Fig 3).

    order   : SRAM-level temporal loop order, outermost first.
    b_*     : RF blocking factors (points of each dim per PE tile).
    p_*     : spatial partitioning across the PE array.  ``p_ic`` is the
              FlexTree input-channel partition factor IC_P (§III-B).
    """
    order: Tuple[str, ...] = ("oc", "ic", "oy", "ox")
    b_ic: int = 1
    b_oc: int = 1
    b_ox: int = 1
    b_oy: int = 1
    p_ic: int = 1
    p_oc: int = 1
    p_ox: int = 1
    p_oy: int = 1
    p_fy: int = 1     # Eyeriss-RS filter-row spatial mapping

    def blocking(self, d: str) -> int:
        return getattr(self, "b_" + d)

    def partition(self, d: str) -> int:
        return getattr(self, "p_" + d)

    @property
    def n_spatial(self) -> int:
        return self.p_ic * self.p_oc * self.p_ox * self.p_oy * self.p_fy

    def describe(self) -> str:
        return (f"order={'>'.join(self.order)} "
                f"B(ic={self.b_ic},oc={self.b_oc},ox={self.b_ox},oy={self.b_oy}) "
                f"P(ic={self.p_ic},oc={self.p_oc},ox={self.p_ox},"
                f"oy={self.p_oy},fy={self.p_fy})")


@dataclass(frozen=True)
class SparsityStats:
    """Per-layer density statistics (1 - sparsity)."""
    act_density: float = 1.0
    wt_density: float = 1.0

    @property
    def pair_density(self) -> float:
        """Expected CSB density: P(both operands non-zero) (§III-D)."""
        return self.act_density * self.wt_density


DENSE = SparsityStats()


# ---------------------------------------------------------------------------
# Cost evaluation
# ---------------------------------------------------------------------------

@dataclass
class Cost:
    energy: float = 0.0
    cycles: float = 0.0
    breakdown: Dict[str, float] = field(default_factory=dict)
    schedule: Optional[Schedule] = None

    @property
    def edp(self) -> float:
        return self.energy * self.cycles


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _expected_max_binomial(n: float, p: float, m: int) -> float:
    """E[max of m iid Binomial(n, p)] — normal-tail upper estimate.

    Models the PE-lockstep workload imbalance of §II-B: each PE processes the
    popcount of its own combined sparsity bitmap; a round costs the max.
    """
    if p >= 1.0 or n <= 0:
        return n * p
    mean = n * p
    var = n * p * (1.0 - p)
    if m <= 1 or var <= 0:
        return mean
    return min(float(n), mean + math.sqrt(2.0 * var * math.log(m)))


def evaluate(layer: ConvLayer, sched: Schedule, acc: Accelerator,
             sp: SparsityStats = DENSE, *,
             count_dram: bool = True) -> Cost:
    """Energy + cycle cost of running ``layer`` under ``sched`` on ``acc``."""
    # --- effective densities as seen by this accelerator -------------------
    if acc.sparsity_support == "two_sided":
        d_store_if, d_store_fl = sp.act_density, sp.wt_density
        pair_p = sp.pair_density
    elif acc.sparsity_support == "weight":
        d_store_if, d_store_fl = 1.0, sp.wt_density
        pair_p = sp.wt_density
    else:
        d_store_if = d_store_fl = 1.0
        pair_p = 1.0
    # ZVC with raw-mode bypass: the sparse encoder transmits the raw line
    # when packed+bitmap would exceed it (density > 7/8), so the compressed
    # footprint never exceeds dense (§III-C2 sparse-encoder behaviour).
    zvc_if = min(d_store_if + BITMAP_OVERHEAD, 1.0) if d_store_if < 1.0 else 1.0
    zvc_fl = min(d_store_fl + BITMAP_OVERHEAD, 1.0) if d_store_fl < 1.0 else 1.0

    # --- per-PE tile footprints --------------------------------------------
    ic_g = layer.ic // layer.groups
    b_ic = min(sched.b_ic, ic_g)
    b_oc = min(sched.b_oc, layer.oc)
    b_ox = min(sched.b_ox, layer.ox)
    b_oy = min(sched.b_oy, layer.oy)
    fy_pe = _ceil(layer.fy, sched.p_fy)

    b_ixt = (b_ox - 1) * layer.stride + layer.fx
    b_iyt = (b_oy - 1) * layer.stride + fy_pe
    if_tile = b_ixt * b_iyt * b_ic * DATA_BYTES
    fl_tile = layer.fx * fy_pe * b_ic * b_oc * DATA_BYTES
    of_tile = b_ox * b_oy * b_oc

    # --- temporal trip counts at SRAM level ---------------------------------
    trips = {
        "ic": _ceil(ic_g, b_ic * sched.p_ic),
        "oc": _ceil(layer.oc, b_oc * sched.p_oc),
        "ox": _ceil(layer.ox, b_ox * sched.p_ox),
        "oy": _ceil(layer.oy, b_oy * sched.p_oy),
    }
    rounds = 1
    for d in DIMS:
        rounds *= trips[d]

    def _fetches(tensor: str) -> float:
        """Tile loads per PE-group = Π trips of loops at/outside the
        innermost relevant loop (loops with trip 1 never force refetch)."""
        rel = _RELEVANT[tensor]
        j = -1
        for i, d in enumerate(sched.order):
            if d in rel and trips[d] > 1:
                j = i
        if j < 0:
            return 1.0
        f = 1.0
        for i in range(j + 1):
            f *= trips[sched.order[i]]
        return f

    # --- SRAM traffic (multicast-aware distinct copies: Fig 9 NoC) ----------
    if_copies = sched.p_ic * sched.p_ox * sched.p_oy          # bcast over p_oc
    fl_copies = sched.p_ic * sched.p_oc * sched.p_fy          # bcast over p_ox/oy
    sram_if = _fetches("if") * if_tile * zvc_if * if_copies
    sram_fl = _fetches("fl") * fl_tile * zvc_fl * fl_copies
    # groups>1 (depthwise): each group has its own FL/IF slice; traffic scales
    # with groups through trips (ic_g) already; OC loop covers groups.

    # OF / psum traffic: visits per distinct tile beyond the first are psum
    # spills (write + later read-back at PSUM_BYTES); final drain writes the
    # activation once at DATA_BYTES (ZVC-compressed by the Sparse Encoder).
    of_visits = _fetches("of")
    of_distinct = trips["oc"] * trips["ox"] * trips["oy"]
    of_copies = sched.p_oc * sched.p_ox * sched.p_oy
    spill_rounds = max(of_visits - of_distinct, 0.0)
    sram_of = (spill_rounds * of_tile * of_copies * 2 * PSUM_BYTES
               + layer.of_size * DATA_BYTES * min(zvc_if, 1.0))

    # --- RF traffic ----------------------------------------------------------
    n_active = min(acc.n_pes, sched.n_spatial)
    rf_fill = (_fetches("if") * if_tile * zvc_if
               + _fetches("fl") * fl_tile * zvc_fl) * n_active
    macs_eff = layer.macs * pair_p
    rf_mac_reads = 2.0 * macs_eff * DATA_BYTES      # IF + FL per MAC
    rf_of_writes = of_visits * of_tile * of_copies * PSUM_BYTES
    rf_bytes = rf_fill + rf_mac_reads + rf_of_writes

    # --- inter-PE / FlexTree psum movement ----------------------------------
    inter_pe = 0.0
    red_factor = sched.p_ic * sched.p_fy
    if red_factor > 1:
        # each output point's psums cross the column/array once per reduction
        inter_pe = layer.of_size * PSUM_BYTES * (red_factor - 1)

    # --- DRAM (compulsory; §III-A assumes SRAM holds working set) -----------
    dram = 0.0
    if count_dram:
        dram = (layer.fl_size * zvc_fl + layer.if_size * zvc_if
                + layer.of_size * min(zvc_if, 1.0)) * DATA_BYTES

    energy = (macs_eff * acc.cost_mac
              + rf_bytes * acc.cost_rf
              + (sram_if + sram_fl + sram_of) * acc.cost_sram
              + inter_pe * (acc.cost_inter_pe or acc.cost_rf)
              + dram * acc.cost_dram)

    # --- cycles --------------------------------------------------------------
    tile_macs = b_ic * b_oc * b_ox * b_oy * layer.fx * fy_pe
    # lockstep imbalance group = one PE column (drain + FlexTree are
    # per-column, §III-C2); the column's slowest PE gates the round.
    per_pe = _expected_max_binomial(tile_macs, pair_p,
                                    min(n_active, acc.pe_rows))
    compute_cyc = per_pe / acc.macs_per_pe
    # load/compute overlap via double-buffered (active+shadow) RFs: the SRAM
    # port gates the *average* per-round refill traffic, not a full tile.
    load_cyc = (sram_if + sram_fl) / rounds / acc.sram_port_bytes
    # FlexTree vs neighbor-chain psum accumulation (§III-B)
    accum_cyc = 0.0
    if sched.p_ic > 1:
        if acc.flextree:
            accum_cyc = math.ceil(math.log2(sched.p_ic)) \
                + _ceil(of_tile, 4)      # ≤4 OF extracted per round
        else:
            accum_cyc = sched.p_ic + of_tile
    cycles = rounds * (max(compute_cyc, load_cyc) + accum_cyc)

    return Cost(
        energy=energy, cycles=cycles,
        breakdown={
            # pure MAC-array cycles — Fig 17/18 "compute acceleration"
            "compute_cycles": rounds * compute_cyc,
            "mac": macs_eff * acc.cost_mac,
            "rf": rf_bytes * acc.cost_rf,
            "sram": (sram_if + sram_fl + sram_of) * acc.cost_sram,
            "inter_pe": inter_pe * (acc.cost_inter_pe or acc.cost_rf),
            "dram": dram * acc.cost_dram,
            "sram_if": sram_if, "sram_fl": sram_fl, "sram_of": sram_of,
            "macs_eff": macs_eff, "rounds": float(rounds),
        },
        schedule=sched,
    )


def rf_feasible(layer: ConvLayer, sched: Schedule, acc: Accelerator,
                sp: SparsityStats = DENSE) -> bool:
    """RF capacity check — compressed tiles must fit the per-PE RFs."""
    ic_g = layer.ic // layer.groups
    b_ic = min(sched.b_ic, ic_g)
    b_oc = min(sched.b_oc, layer.oc)
    b_ox = min(sched.b_ox, layer.ox)
    b_oy = min(sched.b_oy, layer.oy)
    fy_pe = _ceil(layer.fy, sched.p_fy)
    b_ixt = (b_ox - 1) * layer.stride + layer.fx
    b_iyt = (b_oy - 1) * layer.stride + fy_pe
    d_if = sp.act_density if sp.act_density < 1.0 else 1.0
    d_fl = sp.wt_density if sp.wt_density < 1.0 else 1.0
    if_ok = b_ixt * b_iyt * b_ic * d_if <= acc.rf_if
    fl_ok = layer.fx * fy_pe * b_ic * b_oc * d_fl <= acc.rf_fl
    of_ok = b_ox * b_oy * b_oc <= acc.rf_of   # OF RF holds of_tile psum slots
    return if_ok and fl_ok and of_ok
