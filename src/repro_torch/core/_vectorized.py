"""Vectorized schedule-space evaluation in PyTorch (float64, on a device),
ported from the JAX package's numpy ``core/_vectorized.py``.

Semantics mirror ``energy_model.evaluate`` exactly — the scalar version is
the readable specification, this is the fast path used by the search.  The
grid is built on ``device`` and each loop order's energies and cycles are
whole-tensor ops over every candidate.

Three things keep it equal to the reference:

* **dtypes.** Every float quantity is float64 from the start: in torch an
  int64 tensor times a Python float, divided by an int, or mixed with a
  float in ``where`` gives float32, where numpy gives float64.  Integer
  quantities (tiles, trips, partitions) stay int64 until the reference
  turns them into floats.
* **order.** Candidates are laid out as the reference lays them out
  (``meshgrid(indexing="ij")``, then each blocking repeated over the
  partition sets), products and sums are associated as there and nothing
  is fused, so the energies are bit-equal; ``argmin`` keeps the first
  minimum within an order and the first order wins across orders, so ties
  — the rule here, not the exception — resolve to the same ``Schedule``.
* **transcendentals.** ``ceil(log2(p_ic))`` is taken exactly (``frexp`` of
  ``p_ic - 1``: its bit length); the one ``log`` and ``sqrt`` of the cycle
  model come from the device's libm and may differ from numpy's by an ulp.

The search reads the device twice per layer: once for the feasible
candidates' count, once for the winner.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.energy_model import (
    Accelerator, BITMAP_OVERHEAD, ConvLayer, DATA_BYTES, PSUM_BYTES,
    Schedule, SparsityStats, _RELEVANT, evaluate,
)

_DIM_IDX = {"oc": 0, "ic": 1, "oy": 2, "ox": 3}
_F64 = torch.float64
_FIELDS = ("b_ic", "b_oc", "b_ox", "b_oy", "p_ic", "p_oc", "p_ox", "p_oy",
           "p_fy")


def _cdiv(a, b):
    """Ceiling division of positive integers (tensors or ints)."""
    return (a + b - 1) // b


def _ceil_log2(p: torch.Tensor) -> torch.Tensor:
    """ceil(log2(p)) of positive integers, exactly: the bit length of
    ``p - 1``, which is ``frexp``'s exponent (0 for p = 1)."""
    return torch.frexp((p - 1).to(_F64)).exponent.to(_F64)


def _candidate_grid(layer: ConvLayer, acc: Accelerator,
                    p_sets: Sequence[dict],
                    b_ics, b_ocs, b_oxs, b_oys,
                    sp: SparsityStats, device: torch.device
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """Cartesian grid of (partition × blocking), RF-feasibility filtered."""
    i64 = dict(dtype=torch.int64, device=device)
    P = torch.tensor([[p["p_ic"], p["p_oc"], p["p_ox"], p["p_oy"],
                       p.get("p_fy", 1)] for p in p_sets], **i64)
    B = torch.stack(torch.meshgrid(
        torch.tensor(b_ics, **i64), torch.tensor(b_ocs, **i64),
        torch.tensor(b_oxs, **i64), torch.tensor(b_oys, **i64),
        indexing="ij")).reshape(4, -1).T            # (nb, 4): ic, oc, ox, oy
    nb, npart = B.shape[0], P.shape[0]
    b = B.repeat_interleave(npart, dim=0)           # (nb*npart, 4)
    p = P.repeat(nb, 1)

    ic_g = layer.ic // layer.groups
    b_ic = b[:, 0].clamp_max(ic_g)
    b_oc = b[:, 1].clamp_max(layer.oc)
    b_ox = b[:, 2].clamp_max(layer.ox)
    b_oy = b[:, 3].clamp_max(layer.oy)
    p_ic, p_oc, p_ox, p_oy, p_fy = p.unbind(1)

    fy_pe = _cdiv(layer.fy, p_fy)
    b_ixt = (b_ox - 1) * layer.stride + layer.fx
    b_iyt = (b_oy - 1) * layer.stride + fy_pe
    if_tile = b_ixt * b_iyt * b_ic * DATA_BYTES
    fl_tile = layer.fx * fy_pe * b_ic * b_oc * DATA_BYTES
    of_tile = b_ox * b_oy * b_oc

    d_if = min(sp.act_density, 1.0)
    d_fl = min(sp.wt_density, 1.0)
    feas = (((b_ixt * b_iyt * b_ic).to(_F64) * d_if <= acc.rf_if)
            & ((layer.fx * fy_pe * b_ic * b_oc).to(_F64) * d_fl
               <= acc.rf_fl)
            & (of_tile <= acc.rf_of))
    keep = feas.nonzero()[:, 0]                     # the one sync
    if keep.numel() == 0:
        return None

    sel = lambda a: a.index_select(0, keep)
    out = dict(
        b_ic=sel(b_ic), b_oc=sel(b_oc), b_ox=sel(b_ox), b_oy=sel(b_oy),
        p_ic=sel(p_ic), p_oc=sel(p_oc), p_ox=sel(p_ox), p_oy=sel(p_oy),
        p_fy=sel(p_fy), if_tile=sel(if_tile), fl_tile=sel(fl_tile),
        of_tile=sel(of_tile), fy_pe=sel(fy_pe),
    )
    out["trips"] = torch.stack([
        _cdiv(layer.oc, out["b_oc"] * out["p_oc"]),
        _cdiv(ic_g, out["b_ic"] * out["p_ic"]),
        _cdiv(layer.oy, out["b_oy"] * out["p_oy"]),
        _cdiv(layer.ox, out["b_ox"] * out["p_ox"]),
    ], dim=1)   # (n, 4) in _DIM_IDX order
    return out


def _fetches(trips: torch.Tensor, order: Tuple[str, ...],
             relevant: frozenset) -> torch.Tensor:
    """Π trips of loops at/outside the innermost relevant loop (trip>1),
    float64: walking the order outermost first, the running product is
    taken at every relevant loop with more than one trip, so the last one
    taken is the innermost's."""
    out = torch.ones(trips.shape[0], dtype=_F64, device=trips.device)
    prefix = None
    for d in order:
        t = trips[:, _DIM_IDX[d]]
        prefix = t if prefix is None else prefix * t
        if d in relevant:
            out = torch.where(t > 1, prefix.to(_F64), out)
    return out


def evaluate_grid(layer: ConvLayer, acc: Accelerator,
                  grid: Dict[str, torch.Tensor], order: Tuple[str, ...],
                  sp: SparsityStats, count_dram: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(energy, cycles) float64 tensors for all grid candidates under
    ``order``."""
    if acc.sparsity_support == "two_sided":
        d_if, d_fl, pair_p = sp.act_density, sp.wt_density, sp.pair_density
    elif acc.sparsity_support == "weight":
        d_if, d_fl, pair_p = 1.0, sp.wt_density, sp.wt_density
    else:
        d_if = d_fl = pair_p = 1.0
    # ZVC raw-mode bypass — mirrors energy_model.evaluate exactly
    zvc_if = min(d_if + BITMAP_OVERHEAD, 1.0) if d_if < 1.0 else 1.0
    zvc_fl = min(d_fl + BITMAP_OVERHEAD, 1.0) if d_fl < 1.0 else 1.0

    trips = grid["trips"]
    rounds = trips.prod(dim=1)
    f_if = _fetches(trips, order, _RELEVANT["if"])
    f_fl = _fetches(trips, order, _RELEVANT["fl"])
    f_of = _fetches(trips, order, _RELEVANT["of"])

    if_copies = grid["p_ic"] * grid["p_ox"] * grid["p_oy"]
    fl_copies = grid["p_ic"] * grid["p_oc"] * grid["p_fy"]
    sram_if = f_if * grid["if_tile"] * zvc_if * if_copies
    sram_fl = f_fl * grid["fl_tile"] * zvc_fl * fl_copies

    of_distinct = trips[:, 0] * trips[:, 2] * trips[:, 3]
    of_copies = grid["p_oc"] * grid["p_ox"] * grid["p_oy"]
    spill = (f_of - of_distinct).clamp_min(0.0)
    sram_of = (spill * grid["of_tile"] * of_copies * 2 * PSUM_BYTES
               + layer.of_size * DATA_BYTES * min(zvc_if, 1.0))

    n_spatial = (grid["p_ic"] * grid["p_oc"] * grid["p_ox"] * grid["p_oy"]
                 * grid["p_fy"])
    n_active = n_spatial.clamp_max(acc.n_pes)
    rf_fill = (f_if * grid["if_tile"] * zvc_if
               + f_fl * grid["fl_tile"] * zvc_fl) * n_active
    macs_eff = layer.macs * pair_p
    rf_mac_reads = 2.0 * macs_eff * DATA_BYTES
    rf_of_writes = f_of * grid["of_tile"] * of_copies * PSUM_BYTES
    rf_bytes = rf_fill + rf_mac_reads + rf_of_writes

    red = grid["p_ic"] * grid["p_fy"]
    inter = torch.where(red > 1,
                        (layer.of_size * PSUM_BYTES * (red - 1)).to(_F64),
                        0.0)

    dram = 0.0
    if count_dram:
        dram = (layer.fl_size * zvc_fl + layer.if_size * zvc_if
                + layer.of_size * min(zvc_if, 1.0)) * DATA_BYTES

    energy = (macs_eff * acc.cost_mac
              + rf_bytes * acc.cost_rf
              + (sram_if + sram_fl + sram_of) * acc.cost_sram
              + inter * (acc.cost_inter_pe or acc.cost_rf)
              + dram * acc.cost_dram)

    tile_macs = (grid["b_ic"] * grid["b_oc"] * grid["b_ox"] * grid["b_oy"]
                 * layer.fx * grid["fy_pe"]).to(_F64)
    if pair_p >= 1.0:
        per_pe = tile_macs
    else:
        mean = tile_macs * pair_p
        var = tile_macs * pair_p * (1 - pair_p)
        logm = torch.log(n_active.clamp_max(acc.pe_rows).clamp_min(2)
                         .to(_F64))
        per_pe = torch.minimum(tile_macs, mean + torch.sqrt(2 * var * logm))
    compute_cyc = per_pe / acc.macs_per_pe
    load_cyc = (sram_if + sram_fl) / rounds / acc.sram_port_bytes
    p_ic = grid["p_ic"]
    if acc.flextree:
        accum = (_ceil_log2(p_ic)
                 + torch.ceil(grid["of_tile"].to(_F64) / 4))
    else:
        accum = (p_ic + grid["of_tile"]).to(_F64)
    accum = torch.where(p_ic > 1, accum, 0.0)
    cycles = rounds * (torch.maximum(compute_cyc, load_cyc) + accum)
    assert energy.dtype == _F64 and cycles.dtype == _F64
    return energy, cycles


def search(layer: ConvLayer, acc: Accelerator, sp: SparsityStats,
           orders: Sequence[Tuple[str, ...]], p_sets: Sequence[dict],
           b_ics, b_ocs, b_oxs, b_oys, objective: str = "energy",
           count_dram: bool = True, *, device: torch.device):
    """Return the best Schedule's ``Cost`` (re-scored via the scalar
    ``evaluate``), or None when no candidate fits the RFs."""
    grid = _candidate_grid(layer, acc, p_sets, b_ics, b_ocs, b_oxs, b_oys,
                           sp, device)
    if grid is None:
        return None
    vals = []
    for order in orders:
        energy, cycles = evaluate_grid(layer, acc, grid, order, sp,
                                       count_dram)
        vals.append({"energy": energy, "cycles": cycles,
                     "edp": energy * cycles}[objective])
    vals = torch.stack(vals)                         # (orders, n)
    first_i = vals.argmin(dim=1)                     # first min per order
    best_o = vals.gather(1, first_i[:, None])[:, 0].argmin()  # first order
    best_i = first_i[best_o]
    picked = torch.stack([grid[f][best_i] for f in _FIELDS]
                         + [best_o]).tolist()       # the second sync
    sched = Schedule(order=tuple(orders[picked[-1]]),
                     **dict(zip(_FIELDS, picked[:-1])))
    return evaluate(layer, sched, acc, sp, count_dram=count_dram)
