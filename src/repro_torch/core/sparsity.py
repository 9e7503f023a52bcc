"""Two-sided sparsity machinery (FlexNN §III-D), ported from the JAX
package's ``core/sparsity.py``.

1. **ZVC codec** — zero-value compression: a dense tensor → (packed
   non-zeros, 1-bit/element bitmap, nnz) in a fixed-size buffer on the
   tensor's own device, with no host read (``zvc_encode``/``zvc_decode``);
   ``zvc_compressed_bytes`` is its storage cost (§IV).

2. **Combined sparsity bitmap (CSB)** — ``IF_bitmap AND FL_bitmap`` and its
   popcount: the number of MAC pairs that actually fire (Fig 13).

3. **PE cycle model** — lockstep rounds gated by the busiest PE's
   surviving MACs (§II-B, §V-C): closed form or Monte Carlo.

4. **Block-sparse metadata** — per-tile bitmaps for A (M×K) and B (K×N),
   the combined sparsity bitmap (CSB) per (m, n) output tile = AND across
   the K blocks, compressed into the K-index lists the block-sparse kernel
   walks (``BlockSparseMeta``; the CAG unit analogue).

5. **Precompiled weight-sparsity plans** — weights are static at serving
   time, so their block bitmaps and per-output-column live-K index lists
   are compiled *once* at engine bring-up (``compile_weight_plan``) with a
   tight ``max_nnz``.  In the decode step only the activation bitmap is
   derived; ``combine_with_activation_meta`` ANDs it into the precomputed
   weight metadata without re-deriving the weight side.

Bitmaps and live counts are computed with torch on the weights' own device
(at full width the weights never round-trip through the host); the small
index lists are built on the host.  The plan keeps element counts for its
ZVC byte model instead of packed value arrays.

Stacks are processed in slices of their leading axis
(``stacks.leading_slices``), so a full-width expert leaf — (L, E, K, N),
10 GB in bf16 — never gets a whole-leaf temporary; every result is per
(K, N) matrix, so slicing changes no number.

A quantized params tree (``quant.quantize_params``) plans its
``QuantizedLinear`` leaves on their int8 payload — quantization is
zero-preserving, so the bitmaps are the float weight's — and the attached
``PlannedWeight`` carries the payload with its per-channel scales.

6. **Elastic plan tiers** — ``compile_weight_plan(prune_ratio=r)`` compiles
   the lists as if ``prune_k_blocks`` had dropped the weakest fraction
   ``r`` of each output column's K-blocks, without touching the weight:
   a tier is a second schedule over the same weights (``compile_plan_tiers``
   builds one per ratio, all attaching to the same leaves).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.energy_model import zvc_weight_bytes
from repro_torch.core.stacks import leading_slices, pad_to_blocks
from repro_torch.quant.quantize import QuantizedLinear, dequantize_leaf


SITE_KEYS: Dict[str, Dict[str, str]] = {
    "mlp": {"w_in": "mlp.in", "w_gate": "mlp.gate", "w_out": "mlp.out"},
    "attn": {"wq": "attn.q", "wkv": "attn.kv", "wo": "attn.out"},
    # the encoder-decoder's cross-attention shares the attention sites
    "xattn": {"wq": "attn.q", "wkv": "attn.kv", "wo": "attn.out"},
    "rglru": {"w_x": "rglru.in", "w_gate": "rglru.gate",
              "w_out": "rglru.out"},
    "moe": {"router": "moe.router", "experts_in": "moe.experts_in",
            "experts_gate": "moe.experts_gate",
            "experts_out": "moe.experts_out"},
    "shared": {"w_in": "moe.shared_in", "w_gate": "moe.shared_gate",
               "w_out": "moe.shared_out"},
}
# top-level leaves (no parent key); ``embed`` is deliberately absent — a
# tied head *is* the embedding table and is never planned
TOP_SITE_KEYS: Dict[str, str] = {"lm_head": "lm_head"}
# sites whose leaf is stored (N, K): planned on the transposed view
TRANSPOSED_SITES = frozenset({"lm_head"})


# ---------------------------------------------------------------------------
# ZVC codec
# ---------------------------------------------------------------------------

def zvc_encode_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact variable-length ZVC on the host: (non-zero values, bool
    bitmap) — the reference's codec, which checkpoints store at rest."""
    flat = x.reshape(-1)
    bitmap = flat != 0
    return flat[bitmap], bitmap.reshape(x.shape)


def zvc_decode_np(values: np.ndarray, bitmap: np.ndarray) -> np.ndarray:
    out = np.zeros(bitmap.size, dtype=values.dtype)
    out[bitmap.reshape(-1)] = values
    return out.reshape(bitmap.shape)


def zvc_encode(x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ZVC with a fixed-size output buffer, on ``x``'s device.

    Returns (packed, bitmap, nnz): ``packed`` has ``x.numel()`` slots; the
    first ``nnz`` hold the non-zeros in scan order (the SRAM layout of
    Fig 12), the rest are zero.  ``bitmap = x != 0``, so a ``-0.0`` is
    dropped (it decodes as ``+0.0``) and a NaN is kept.  Every zero is
    scattered to the last slot; those colliding writes are all ``+0.0``, so
    the order the device makes them in cannot change the buffer.
    """
    flat = x.reshape(-1)
    bitmap = flat != 0
    # position of each non-zero in the packed stream
    pos = torch.cumsum(bitmap, 0) - 1
    dump = torch.full_like(pos, flat.shape[0] - 1)
    packed = torch.zeros_like(flat).scatter_(
        0, torch.where(bitmap, pos, dump), torch.where(bitmap, flat, 0))
    nnz = bitmap.sum(dtype=torch.int32)
    return packed, bitmap.reshape(x.shape), nnz


def zvc_decode(packed: torch.Tensor, bitmap: torch.Tensor) -> torch.Tensor:
    flat_bm = bitmap.reshape(-1)
    pos = torch.cumsum(flat_bm, 0) - 1
    gathered = packed[pos.clamp(0, packed.shape[0] - 1)]
    return torch.where(flat_bm, gathered, 0).reshape(bitmap.shape).to(
        packed.dtype)


def zvc_compressed_bytes(x: torch.Tensor, elem_bytes: int = 1) -> float:
    """Storage cost: packed non-zeros + 1 bit/element bitmap (§IV)."""
    nnz = int(torch.count_nonzero(x))
    return nnz * elem_bytes + x.numel() / 8.0


# ---------------------------------------------------------------------------
# Combined sparsity bitmap
# ---------------------------------------------------------------------------

def combined_bitmap(if_bitmap: torch.Tensor,
                    fl_bitmap: torch.Tensor) -> torch.Tensor:
    """CSB = IF ∧ FL (Fig 13) — positions where a MAC actually fires."""
    return torch.logical_and(if_bitmap, fl_bitmap)


def csb_popcount(if_bitmap: torch.Tensor,
                 fl_bitmap: torch.Tensor) -> torch.Tensor:
    return combined_bitmap(if_bitmap, fl_bitmap).sum(dtype=torch.int32)


def relu_activation_bitmap(x: torch.Tensor,
                           threshold: float = 0.0) -> torch.Tensor:
    """Activation bitmap after thresholding (§II-B ReLU-induced sparsity)."""
    return torch.abs(x) > threshold


# ---------------------------------------------------------------------------
# Monte-Carlo / closed-form PE cycle simulation (§V-C model)
# ---------------------------------------------------------------------------

def simulate_pe_cycles(block_macs: int, n_pes: int, rounds: int,
                       pair_density: float, macs_per_pe: int = 8,
                       seed: int = 0, mc: bool = False) -> float:
    """Cycles for `rounds` lockstep rounds where each of ``n_pes`` PEs
    processes Binomial(block_macs, pair_density) surviving MACs.

    The *max* across PEs gates each round (§II-B workload imbalance).  The
    Monte-Carlo branch draws from numpy's ``default_rng(seed)``, the
    reference's stream: these are the paper's statistics, not device
    randomness.
    """
    if pair_density >= 1.0:
        return rounds * block_macs / macs_per_pe
    if mc:
        rng = np.random.default_rng(seed)
        n_sim = min(rounds, 256)
        draws = rng.binomial(block_macs, pair_density, size=(n_sim, n_pes))
        per_round = draws.max(axis=1).mean()
        return rounds * float(per_round) / macs_per_pe
    mean = block_macs * pair_density
    var = block_macs * pair_density * (1 - pair_density)
    exp_max = min(block_macs, mean + math.sqrt(
        max(2 * var * math.log(max(n_pes, 2)), 0.0)))
    return rounds * exp_max / macs_per_pe


# ---------------------------------------------------------------------------
# Block-sparse metadata
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BlockSparseMeta:
    """Metadata for the two-sided block-sparse matmul.

    For each output tile (mi, ni): ``kidx[mi, ni, :]`` lists the K-block
    indices where *both* A[mi, k] and B[k, ni] blocks are non-zero (the
    CSB), ascending, zero-padded up to ``max_nnz``; ``kcnt[mi, ni]`` is the
    live count."""
    kidx: torch.Tensor      # (tm, tn, max_nnz) int32
    kcnt: torch.Tensor      # (tm, tn) int32
    a_bitmap: torch.Tensor  # (tm, tk) bool
    b_bitmap: torch.Tensor  # (tk, tn) bool
    max_nnz: int


def block_bitmap(x: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """(..., M, K) -> (..., ceil(M/bm), ceil(K/bk)) bool: True where the
    block holds any non-zero (ragged edges zero-padded)."""
    m, k = x.shape[-2:]
    tm, tk = -(-m // bm), -(-k // bk)
    if tm * bm != m or tk * bk != k:
        x = torch.nn.functional.pad(x, (0, tk * bk - k, 0, tm * bm - m))
    blocks = x.reshape(*x.shape[:-2], tm, bm, tk, bk)
    return blocks.abs().amax(dim=(-3, -1)) > 0


def stack_block_bitmap(kn: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """``block_bitmap`` of a (P, K, N) stack, (P, tk, tn) on its device,
    computed slice by slice (``leading_slices``)."""
    p, k, n = kn.shape
    return torch.cat([block_bitmap(kn[s], bk, bn)
                      for s in leading_slices(p, k * n)])


def count_nonzero(w: torch.Tensor) -> int:
    """Non-zero elements of ``w``, counted slice by slice of its leading
    axis (no whole-tensor temporary)."""
    if w.dim() < 3:
        return int(torch.count_nonzero(w))
    flat = w.reshape(-1, *w.shape[-2:])
    p, k, n = flat.shape
    return sum(int(torch.count_nonzero(flat[s]))
               for s in leading_slices(p, k * n))


def _live_first(dead: torch.Tensor) -> torch.Tensor:
    """Indices that put live entries first, each group in ascending order:
    a *stable* sort of an integer key (0 = live, 1 = dead)."""
    return torch.sort(dead.to(torch.int32), dim=-1, stable=True).indices


def build_block_sparse_meta(a_bitmap: torch.Tensor, b_bitmap: torch.Tensor,
                            max_nnz: Optional[int] = None, *,
                            site: str = "") -> BlockSparseMeta:
    """CSB → compressed K-index lists (the JAX package's
    ``build_block_sparse_meta_jnp`` semantics).  ``max_nnz`` defaults to
    the K-block count tk (the safe bound); a smaller value is checked
    against every tile's live count and raises ``ValueError`` when it would
    drop live blocks (the check reads the counts on the host).  Bitmaps
    with leading (expert) axes, (..., tm, tk) and (..., tk, tn), give
    lists per leading index."""
    tm, tk = a_bitmap.shape[-2:]
    tk2, tn = b_bitmap.shape[-2:]
    if tk != tk2:
        raise ValueError(f"bitmap K-blocks differ: {tk} vs {tk2}")
    max_nnz = tk if max_nnz is None else int(max_nnz)
    # (..., tm, tn, tk)
    csb = (a_bitmap[..., :, None, :]
           & b_bitmap.transpose(-1, -2)[..., None, :, :])
    kcnt = csb.sum(-1, dtype=torch.int32)
    if max_nnz < tk:
        worst = int(kcnt.max())
        if worst > max_nnz:
            at = np.unravel_index(int(kcnt.argmax()), tuple(kcnt.shape))
            raise ValueError(
                f"{site + ': ' if site else ''}max_nnz={max_nnz} < live "
                f"K-blocks ({worst}) at output tile (mi={int(at[-2])}, "
                f"ni={int(at[-1])}) — a truncated kidx would silently drop "
                f"live MACs")
    kidx = _live_first(~csb)[..., :max_nnz]
    pad = torch.arange(max_nnz, device=kcnt.device) < kcnt[..., None]
    kidx = torch.where(pad, kidx, 0).to(torch.int32).contiguous()
    return BlockSparseMeta(kidx=kidx, kcnt=kcnt.contiguous(),
                           a_bitmap=a_bitmap, b_bitmap=b_bitmap,
                           max_nnz=max_nnz)


def weight_side_lists(b_bitmap: np.ndarray,
                      max_nnz: Optional[int] = None, *,
                      site: str = "") -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-column live-K index lists from a (tk, tn) weight block
    bitmap: ``wkidx[ni, :wkcnt[ni]]`` ascending, zero-padded.  ``max_nnz``
    below the tightest bound raises ``ValueError``."""
    b = np.asarray(b_bitmap, bool)
    wkcnt = b.sum(axis=0).astype(np.int32)
    tight = max(int(wkcnt.max()), 1)
    if max_nnz is None:
        max_nnz = tight
    elif max_nnz < tight:
        ni = int(wkcnt.argmax())
        raise ValueError(
            f"{site + ': ' if site else ''}max_nnz={max_nnz} < live K-blocks "
            f"({tight}) at output column ni={ni} — a truncated kidx would "
            f"silently drop live MACs")
    order = np.argsort(~b, axis=0, kind="stable")[:max_nnz].T     # (tn, s)
    live = np.arange(max_nnz)[None, :] < wkcnt[:, None]
    if order.shape[1] < max_nnz:                    # max_nnz > tk: pad
        order = np.pad(order, ((0, 0), (0, max_nnz - order.shape[1])))
    wkidx = np.where(live, order, 0).astype(np.int32)
    return wkidx, wkcnt


def weight_plan_meta(wkidx: torch.Tensor, wkcnt: torch.Tensor,
                     b_bitmap: torch.Tensor, tm: int) -> BlockSparseMeta:
    """Weight-mode metadata from a plan: a broadcast, no sort (the
    activation bitmap is all ones).  Leading (expert) axes of the plan's
    lists carry through."""
    tn, max_nnz = wkidx.shape[-2:]
    lead = tuple(wkidx.shape[:-2])
    tk = b_bitmap.shape[-2]
    kidx = wkidx[..., None, :, :].expand(*lead, tm, tn, max_nnz).contiguous()
    kcnt = wkcnt[..., None, :].expand(*lead, tm, tn).contiguous()
    return BlockSparseMeta(kidx=kidx, kcnt=kcnt,
                           a_bitmap=torch.ones(lead + (tm, tk),
                                               dtype=torch.bool,
                                               device=wkidx.device),
                           b_bitmap=b_bitmap, max_nnz=int(max_nnz))


def combine_with_activation_meta(a_bitmap: torch.Tensor, wkidx: torch.Tensor,
                                 wkcnt: torch.Tensor, b_bitmap: torch.Tensor
                                 ) -> BlockSparseMeta:
    """AND a fresh activation bitmap into precomputed weight metadata.

    Only the activation bits at each column's live weight K-blocks are
    gathered and compacted (a stable live-first sort over ``max_nnz``
    slots); the weight side is never re-derived.  Produces entry for entry
    ``build_block_sparse_meta(a_bitmap, b_bitmap, max_nnz)``.  Leading
    (expert) axes, a_bitmap (..., tm, tk) against lists (..., tn, s), are
    combined in one pass: every expert's lists at once."""
    tn, max_nnz = wkidx.shape[-2:]
    tm, tk = a_bitmap.shape[-2:]
    lead = tuple(wkidx.shape[:-2])
    dev = wkidx.device
    slot_live = (torch.arange(max_nnz, device=dev)
                 < wkcnt[..., None])                          # (..., tn, s)
    shape = lead + (tm, tn, max_nnz)
    alive = torch.gather(
        a_bitmap[..., :, None, :].expand(lead + (tm, tn, tk)), -1,
        wkidx.long()[..., None, :, :].expand(shape))
    alive = alive & slot_live[..., None, :, :]               # (..., tm, tn, s)
    kcnt = alive.sum(-1, dtype=torch.int32)
    order = _live_first(~alive)
    kidx = torch.gather(wkidx[..., None, :, :].expand(shape), -1, order)
    pad = torch.arange(max_nnz, device=dev) < kcnt[..., None]
    kidx = torch.where(pad, kidx, 0).to(torch.int32).contiguous()
    return BlockSparseMeta(kidx=kidx, kcnt=kcnt.contiguous(),
                           a_bitmap=a_bitmap, b_bitmap=b_bitmap,
                           max_nnz=int(max_nnz))


# ---------------------------------------------------------------------------
# Pruning (gives the planner real zeros to skip)
# ---------------------------------------------------------------------------

def prune_magnitude(w: torch.Tensor, sparsity: float,
                    block: Tuple[int, int]) -> torch.Tensor:
    """Block-magnitude pruning of the trailing (K, N) matrices of ``w``:
    per matrix, zero every (bk, bn) block whose L2 norm is at or below the
    ``sparsity`` quantile of the matrix's block norms.  The matrices are
    pruned a slice of the leading axes at a time (``leading_slices``) into
    the output, so the temporaries stay a slice's size."""
    if sparsity <= 0:
        return w
    bk, bn = block
    k, n = w.shape[-2:]
    tk, tn = -(-k // bk), -(-n // bn)
    flat = w.reshape(-1, k, n)
    out = torch.empty_like(flat)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    for s in leading_slices(flat.shape[0], k * n):
        part = flat[s]
        pad = torch.nn.functional.pad(part.float(), (0, tn * bn - n,
                                                     0, tk * bk - k))
        norms = pad.reshape(-1, tk, bk, tn, bn).square().sum((2, 4)).sqrt()
        del pad
        thr = torch.quantile(norms.reshape(norms.shape[0], -1).double(),
                             sparsity, dim=1)
        keep = norms.double() > thr[:, None, None]            # (p, tk, tn)
        mask = keep.repeat_interleave(bk, 1).repeat_interleave(bn, 2)
        out[s] = torch.where(mask[:, :k, :n], part, zero)
    return out.reshape(w.shape)


def prune_stacked_magnitude(leaf, sparsity: float,
                            block: Tuple[int, int] = (16, 16)):
    """Prune every (K, N) slice of a stacked (L, K, N) weight leaf or 4-D
    (L, E, K, N) expert leaf; leaves with fewer than three dims
    (embeddings, norms, the lm_head) are returned untouched."""
    if not isinstance(leaf, torch.Tensor) or leaf.dim() < 3:
        return leaf
    return prune_magnitude(leaf, sparsity, block)


def prune_k_blocks(w: np.ndarray, bk: int, bn: int,
                   max_live: int) -> np.ndarray:
    """Structured prune of a host (K, N) matrix: keep the ``max_live``
    highest-L2 (bk, bn) K-blocks of each output-block column (norms in
    float64, ties in index order: a stable argsort), zero the rest.  Every
    output column then has at most ``max_live`` live K-blocks."""
    k, n = w.shape
    tk, tn = -(-k // bk), -(-n // bn)
    if max_live >= tk:
        return w
    pad = np.zeros((tk * bk, tn * bn), dtype=w.dtype)
    pad[:k, :n] = w
    blocks = pad.reshape(tk, bk, tn, bn)
    norms = np.sqrt((blocks.astype(np.float64) ** 2).sum(axis=(1, 3)))
    mask = np.zeros((tk, tn), dtype=w.dtype)
    np.put_along_axis(mask, _keep_order(norms)[:max_live], 1, axis=0)
    return (blocks * mask[:, None, :, None]).reshape(tk * bk,
                                                     tn * bn)[:k, :n]


def _keep_order(norms: np.ndarray) -> np.ndarray:
    """(tk, tn) block norms → each column's K-blocks strongest first, ties
    in index order.  Stable, so a smaller keep count keeps a prefix of a
    larger one's blocks: a higher tier ratio keeps a subset."""
    return np.argsort(-norms, axis=0, kind="stable")


def tier_max_live(tk: int, ratio: float) -> int:
    """Live K-block cap of a pruning ``ratio`` over ``tk`` K-blocks:
    ``max(tk - floor(ratio * tk), 1)``, non-increasing in ``ratio``, ``tk``
    at ratio 0, never below one block per output column."""
    return max(tk - int(ratio * tk + 1e-9), 1)


def _prune_stack_blocks(kn: torch.Tensor, scale: Optional[torch.Tensor],
                        bk: int, bn: int, ratio: float
                        ) -> Optional[np.ndarray]:
    """The (P, tk, tn) bool mask of the K-blocks that ``prune_k_blocks`` at
    ``tier_max_live(tk, ratio)`` keeps in each slice of the (P, K, N) stack
    ``kn`` (its values times the per-column ``scale`` (P, N) of an int8
    payload, in float32, as the dequantized weight), or None when it keeps
    them all.  The block norms are taken in float64 on the weight's device
    (a full-width stack never comes to the host); only the (tk, tn) norms
    are sorted on the host, as ``prune_k_blocks`` sorts them."""
    p, k, n = kn.shape
    tk, tn = -(-k // bk), -(-n // bn)
    max_live = tier_max_live(tk, ratio)
    if max_live >= tk:
        return None
    keep = np.zeros((p, tk, tn), bool)
    for i in range(p):
        v = kn[i].float()
        if scale is not None:
            v = v * scale[i][None, :]
        v = torch.nn.functional.pad(v.double(), (0, tn * bn - n,
                                                 0, tk * bk - k))
        norms = v.square().reshape(tk, bk, tn, bn).sum((1, 3)).sqrt()
        np.put_along_axis(keep[i], _keep_order(norms.cpu().numpy())[
            :max_live], True, axis=0)
    return keep


def _block_nonzeros(kn: torch.Tensor, bk: int, bn: int) -> np.ndarray:
    """(P, tk, tn) non-zero element counts of each (bk, bn) block, slice
    by slice of the stack."""
    p, k, n = kn.shape
    tk, tn = -(-k // bk), -(-n // bn)
    out = []
    for s in leading_slices(p, k * n):
        nz = torch.nn.functional.pad((kn[s] != 0).to(torch.int32),
                                     (0, tn * bn - n, 0, tk * bk - k))
        out.append(nz.reshape(-1, tk, bk, tn, bn).sum((2, 4)).cpu().numpy())
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# Precompiled weight-sparsity plans
# ---------------------------------------------------------------------------

@dataclass
class PlannedWeight:
    """A weight bundled with its precompiled weight-side CSB metadata.

    It rides inside the params tree in place of the weight leaf; the model
    slices it per layer like any other leaf (``index``), and
    ``kernels.ops.flex_matmul`` / ``head_matmul`` dispatch it through the
    block-sparse kernel.  ``transpose`` marks the (N, K)-stored
    ``lm_head``: its metadata was compiled on the transposed view and
    ``w_kn`` is that view — the kernel reads the stored matrix in place, so
    no (K, N) copy is ever made.

    A quantized plan carries the int8 payload in ``w`` and its float32
    per-output-channel scales in ``qscale``; the payload is stored
    contraction-oriented (the lm_head too), so ``transpose`` is False.  The
    kernel reads ``kn`` (the payload) and scales its accumulator; ``w_kn``
    is the dequantized weight.

    ``gather`` marks a pruned plan tier: its lists leave out live blocks of
    ``w`` on purpose, so on the CPU the dispatch contracts only the listed
    blocks (``ops._gathered_planned_matmul``), from ``wgather`` — the
    listed blocks of each output column packed (..., tn, max_nnz, bk, bn),
    empty slots zero — when it was built.  On the card the block-sparse
    kernel walks the lists and ``wgather`` is never read.

    ``wpad`` is ``kn`` zero-padded to the block multiples (..., tk·bk,
    tn·bn), made once at attach for a weight that is not one (``None``
    otherwise), so the dispatch does not copy the weight every step.  The
    padding blocks are zero and dead.  Expert leaves carry (L, E) in front:
    ``index(l)`` gives the layer's (E, K, N) stack with its lists."""
    w: torch.Tensor          # (..., K, N) weight ((..., N, K) if transpose);
    #                          int8 payload when ``qscale`` is set
    wkidx: torch.Tensor      # (..., tn, max_nnz) int32
    wkcnt: torch.Tensor      # (..., tn) int32
    b_bitmap: torch.Tensor   # (..., tk, tn) bool
    qscale: Optional[torch.Tensor] = None   # (..., N) float32
    site: str = ""
    mode: str = "weight"     # weight | two_sided
    bm: int = 128
    bk: int = 128
    bn: int = 128
    max_nnz: int = 1
    tk: int = 1
    transpose: bool = False
    gather: bool = False
    wgather: Optional[torch.Tensor] = None
    wpad: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.qscale is not None

    @property
    def kn(self) -> torch.Tensor:
        """The stored weight in the (..., K, N) contraction orientation, as
        the kernel reads it (a view for transposed leaves; the int8 payload
        of a quantized plan)."""
        return self.w.transpose(-1, -2) if self.transpose else self.w

    @property
    def kn_padded(self) -> torch.Tensor:
        """``kn`` at the block multiples: ``wpad`` when attach made one,
        else ``kn`` itself, which must then be one (a copy of the weight
        every call is refused)."""
        if self.wpad is not None:
            return self.wpad
        k, n = self.kn.shape[-2:]
        if k % self.bk or n % self.bn:
            raise ValueError(
                f"{self.site}: weight ({k}, {n}) is not a multiple of the "
                f"({self.bk}, {self.bn}) blocks and carries no padded copy; "
                f"attach the plan (or plan_weight) to build it once")
        return self.kn

    @property
    def w_kn(self) -> torch.Tensor:
        """Dense weight in the (..., K, N) contraction orientation
        (dequantized to float32 for quantized plans)."""
        if self.quantized:
            return dequantize_leaf(QuantizedLinear(self.w, self.qscale),
                                   torch.float32)
        return self.kn

    def __rmatmul__(self, other: torch.Tensor) -> torch.Tensor:
        """``other @ self``: the dense product with ``w_kn``, as the
        reference's ``PlannedWeight.__rmatmul__`` — the route of a bare
        product that no ``ops`` site dispatches (the encoder-decoder's
        cross-attention at decode).  The operands meet in their promoted
        dtype, as JAX's ``@`` promotes them: float32 against the
        dequantized weight of an int8 plan."""
        w = self.w_kn
        dt = torch.promote_types(other.dtype, w.dtype)
        return torch.matmul(other.to(dt), w.to(dt))

    def index(self, i: int) -> "PlannedWeight":
        """The slice of a stacked leaf at leading index ``i``."""
        return PlannedWeight(
            w=self.w[i], wkidx=self.wkidx[i], wkcnt=self.wkcnt[i],
            b_bitmap=self.b_bitmap[i],
            qscale=None if self.qscale is None else self.qscale[i],
            site=self.site, mode=self.mode, bm=self.bm, bk=self.bk,
            bn=self.bn, max_nnz=self.max_nnz, tk=self.tk,
            transpose=self.transpose, gather=self.gather,
            wgather=None if self.wgather is None else self.wgather[i],
            wpad=None if self.wpad is None else self.wpad[i])

    @property
    def shape(self):
        return self.w.shape

    @property
    def dtype(self):
        return self.w.dtype


def iter_leaves(tree, path: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """(key path, leaf) for every leaf of a nested-dict params tree."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from iter_leaves(sub, path + (str(key),))
    else:
        yield path, tree


def map_leaves(fn, tree, path: Tuple[str, ...] = ()):
    """Rebuild a nested-dict tree with ``fn(path, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def site_for_path(keys: Tuple[str, ...]) -> Optional[str]:
    if len(keys) == 1:
        return TOP_SITE_KEYS.get(keys[0])
    if len(keys) < 2:
        return None
    return SITE_KEYS.get(keys[-2], {}).get(keys[-1])


def plannable_kn(leaf, site: str) -> Optional[torch.Tensor]:
    """Leaf → (P, K, N) stack (a view) for planning, or None: stacked
    (L, K, N) matmul leaves, 4-D (L, E, K, N) expert leaves (P = L·E), or
    the bare (N, K) lm_head transposed.  A ``QuantizedLinear`` plans on its
    int8 payload, which is already contraction-oriented (the lm_head's
    too)."""
    if isinstance(leaf, QuantizedLinear):
        if site in TRANSPOSED_SITES:
            return leaf.q[None] if leaf.q.dim() == 2 else None
        leaf = leaf.q
    elif not isinstance(leaf, torch.Tensor):
        return None
    elif site in TRANSPOSED_SITES:
        return leaf.t()[None] if leaf.dim() == 2 else None
    if leaf.dim() not in (3, 4):
        return None
    return leaf.reshape(-1, *leaf.shape[-2:])


@dataclass
class SitePlan:
    """Precompiled weight-side metadata for one stacked weight leaf (host
    numpy arrays); ``WeightSparsityPlan.attach`` materialises it as a
    :class:`PlannedWeight` on the leaf's device."""
    path: Tuple[str, ...]
    site: str
    mode: str
    bm: int
    bk: int
    bn: int
    tk: int
    tn: int
    max_nnz: int              # tight: max live K-blocks over slices/columns
    lead: Tuple[int, ...]     # leading stack shape ((L,) or ())
    transpose: bool
    wkidx: np.ndarray         # lead + (tn, max_nnz) int32
    wkcnt: np.ndarray         # lead + (tn,) int32
    b_bitmap: np.ndarray      # lead + (tk, tn) bool
    nnz: int                  # non-zero elements of the stored weight
    size: int                 # elements of the stored weight
    wt_density: float         # element-level non-zero fraction
    block_density: float      # live weight-block fraction
    dense_bytes: int
    zvc_bytes: float
    quantized: bool = False   # compiled from a QuantizedLinear leaf
    int8_zvc_bytes: float = 0.0   # ZVC + int8 storage (modelled for float
    #                               plans, exact for quantized ones)
    prune_ratio: float = 0.0  # tier ratio the lists were compiled at (0 =
    #                           the full plan); the weight is never pruned
    expert_nnz: Optional[np.ndarray] = None   # (E,) non-zeros per expert
    #                                           (expert leaves only)

    def stats(self) -> Dict[str, object]:
        """The plan's economics for this leaf (the reference's
        ``SitePlan.stats``): an expert leaf adds the expert count, each
        expert's element density and each expert's largest live count."""
        saved = max(self.dense_bytes - self.zvc_bytes, 0.0)
        out = {
            "site": self.site, "mode": self.mode, "lead": list(self.lead),
            "layers": int(self.lead[0]) if self.lead else 1,
            "blocks": [self.bm, self.bk, self.bn],
            "max_nnz": self.max_nnz, "tk": self.tk,
            "wt_density": self.wt_density,
            "block_density": self.block_density,
            "dense_bytes": self.dense_bytes, "zvc_bytes": self.zvc_bytes,
            "bytes_saved": saved, "quantized": self.quantized,
            "prune_ratio": self.prune_ratio,
            "int8_zvc_bytes": self.int8_zvc_bytes,
            "bytes_saved_int8": max(self.dense_bytes - self.int8_zvc_bytes,
                                    0.0),
            "int8_vs_sparse_reduction": (
                self.zvc_bytes / self.int8_zvc_bytes
                if self.int8_zvc_bytes else 1.0),
        }
        if len(self.lead) > 1:
            per_expert = self.size / self.lead[1]
            out["experts"] = int(self.lead[1])
            out["expert_wt_density"] = [float(v) / per_expert
                                        for v in self.expert_nnz]
            out["expert_max_nnz"] = [
                int(v) for v in self.wkcnt.max(
                    axis=tuple(i for i in range(self.wkcnt.ndim)
                               if i != 1))]
        return out


@dataclass
class WeightSparsityPlan:
    """Per-site precompiled weight metadata for a whole network: compiled
    once at engine bring-up (``compile_weight_plan``) and attached into the
    params tree (``attach``)."""
    arch: str = ""
    shape: str = ""
    entries: Dict[str, SitePlan] = field(default_factory=dict)
    prune_ratio: float = 0.0   # tier ratio every entry was compiled at

    def attach(self, params, verify: bool = True):
        """Wrap every planned weight leaf of ``params`` as a
        ``PlannedWeight`` (metadata moved to the leaf's device; the weight
        itself is referenced, not copied, so every tier attached to one
        tree shares its weights).

        With ``verify`` each leaf's block bitmap is recomputed and checked
        to be covered by the plan — a plan compiled from different tensors
        of the same shape would otherwise silently skip live MACs.  A
        pruned tier (``prune_ratio > 0``) skips live blocks on purpose, so
        its check is the other way round: every block it lists must be
        live.  ``verify=False`` skips that pass (a read of every planned
        weight), for a plan just compiled from these very params.

        A pruned tier's leaves are marked ``gather``; on the CPU, where
        that dispatch contracts the listed blocks, they also carry the
        packed ``wgather`` payload (about max_nnz/tk of the site's bytes).
        On the card the kernel walks the lists over the shared weight, and
        no payload is built: it would be a second copy of about half the
        weights.
        """
        def wrap(path, leaf):
            key = "/".join(path)
            e = self.entries.get(key)
            if e is None:
                return leaf
            kn = plannable_kn(leaf, e.site)
            if kn is None:
                raise ValueError(
                    f"{key} [{e.site}]: attached leaf (shape "
                    f"{tuple(getattr(leaf, 'shape', ()))}) is not a "
                    f"plannable weight for this site — rebuild with "
                    f"compile_weight_plan on these params")
            dev = kn.device
            planned = torch.as_tensor(e.b_bitmap, device=dev)
            if verify:
                live = stack_block_bitmap(kn, e.bk, e.bn).reshape(
                    planned.shape)
                if e.prune_ratio:
                    bad = planned & ~live
                    why = ("pruned-tier plan lists blocks that are dead in "
                           "the attached weight")
                else:
                    bad = live & ~planned
                    why = ("plan does not cover the attached weight's live "
                           "blocks")
                if bool(bad.any()):
                    raise ValueError(
                        f"{key} [{e.site}]: {why} — it was compiled from "
                        f"different tensors; rebuild with "
                        f"compile_weight_plan on these params")
            quantized = isinstance(leaf, QuantizedLinear)
            gather = bool(e.prune_ratio)
            wkidx = torch.as_tensor(e.wkidx, device=dev)
            wkcnt = torch.as_tensor(e.wkcnt, device=dev)
            stored = leaf.q if quantized else leaf
            kn_full = (stored.transpose(-1, -2) if e.transpose and
                       not quantized else stored)
            padded = pad_to_blocks(kn_full, e.bk, e.bn)
            return PlannedWeight(
                w=leaf.q if quantized else leaf, wkidx=wkidx, wkcnt=wkcnt,
                b_bitmap=planned, qscale=leaf.scale if quantized else None,
                site=e.site, mode=e.mode, bm=e.bm, bk=e.bk, bn=e.bn,
                max_nnz=e.max_nnz, tk=e.tk, transpose=e.transpose,
                gather=gather,
                wgather=(_tier_gather_payload(kn, wkidx, wkcnt, e)
                         if gather and dev.type == "cpu" else None),
                wpad=None if padded is kn_full else padded.contiguous())
        return map_leaves(wrap, params)

    def wt_densities(self) -> Dict[str, float]:
        """Measured per-site element density (size-weighted over entries)."""
        nnz: Dict[str, float] = {}
        size: Dict[str, float] = {}
        for e in self.entries.values():
            nnz[e.site] = nnz.get(e.site, 0.0) + e.nnz
            size[e.site] = size.get(e.site, 0.0) + e.size
        return {s: nnz[s] / size[s] for s in size if size[s]}

    def block_skip_fraction(self) -> float:
        """Fraction of all planned weight blocks that are dead (skipped by
        the kernel whatever the activations)."""
        live = sum(int(e.b_bitmap.sum()) for e in self.entries.values())
        total = sum(e.b_bitmap.size for e in self.entries.values())
        return 1.0 - live / max(total, 1)


def _tier_gather_payload(kn: torch.Tensor, wkidx: torch.Tensor,
                         wkcnt: torch.Tensor, e: SitePlan) -> torch.Tensor:
    """The listed K-blocks of each output column of a pruned tier, packed
    lead + (tn, max_nnz, bk, bn) in the stored weight's dtype (the int8
    payload of a quantized leaf), empty slots zero: what the gathered
    dispatch contracts.  ``kn`` is the (P, K, N) stack."""
    p, k, n = kn.shape
    kp, np_ = e.tk * e.bk, e.tn * e.bn
    idx = wkidx.reshape(p, e.tn, e.max_nnz).long()
    live = (torch.arange(e.max_nnz, device=kn.device)[None, None, :]
            < wkcnt.reshape(p, e.tn)[:, :, None])
    cols = torch.arange(e.tn, device=kn.device)[:, None]
    out = torch.zeros((p, e.tn, e.max_nnz, e.bk, e.bn), dtype=kn.dtype,
                      device=kn.device)
    for s in range(p):
        wb = torch.nn.functional.pad(kn[s], (0, np_ - n, 0, kp - k))
        wb = wb.reshape(e.tk, e.bk, e.tn, e.bn).permute(2, 0, 1, 3)
        out[s] = torch.where(live[s][:, :, None, None], wb[cols, idx[s]],
                             torch.zeros((), dtype=kn.dtype,
                                         device=kn.device))
    return out.reshape(e.lead + (e.tn, e.max_nnz, e.bk, e.bn))


def _planned_leaves(params, schedules):
    """(path, site, descriptor, (P, K, N) stack, lead, stored weight,
    scales) of every leaf a sparse site of ``schedules`` plans; the stored
    weight of a ``QuantizedLinear`` is its int8 payload (zero-preserving,
    so its non-zeros are the float weight's) and its scales come as
    (P, N), else None."""
    for path, leaf in iter_leaves(params):
        site = site_for_path(path)
        if site is None or site not in schedules.sites:
            continue
        d = schedules.sites[site]
        if d.sparsity_mode not in ("weight", "two_sided"):
            continue
        kn = plannable_kn(leaf, site)
        if kn is None:
            continue
        lead = tuple(int(v) for v in leaf.shape[:-2])
        quantized = isinstance(leaf, QuantizedLinear)
        stored = leaf.q if quantized else leaf
        scale = (leaf.scale.reshape(kn.shape[0], -1) if quantized
                 else None)
        yield path, site, d, kn, lead, stored, scale


def _stack_lists(bmaps: np.ndarray, site: str, lead: Tuple[int, ...],
                 cap: Optional[int] = None):
    """(site_nnz, wkidx (P, tn, s), wkcnt (P, tn)) of a (P, tk, tn) bitmap
    stack: the tight site-wide ``max_nnz`` (``cap`` overrides; too small a
    cap raises, naming the slice's coordinates in ``lead``) and each
    slice's ``weight_side_lists``."""
    tn = bmaps.shape[2]
    site_nnz = cap if cap is not None else max(int(bmaps.sum(1).max()), 1)
    wkidx = np.zeros((bmaps.shape[0], tn, site_nnz), np.int32)
    wkcnt = np.zeros((bmaps.shape[0], tn), np.int32)
    for i in range(bmaps.shape[0]):
        label = (f"{site}[{','.join(map(str, np.unravel_index(i, lead)))}]"
                 if lead else site)
        wkidx[i], wkcnt[i] = weight_side_lists(bmaps[i], site_nnz,
                                               site=label)
    return site_nnz, wkidx, wkcnt


def plan_weight(w, *, site: str = "", mode: str = "weight", bm: int = 128,
                bk: int = 128, bn: int = 128, max_nnz: Optional[int] = None,
                transpose: bool = False) -> PlannedWeight:
    """One weight compiled into a :class:`PlannedWeight`: (K, N), a
    batched-expert (E, K, N) or a stacked (L, E, K, N) leaf (``transpose``:
    stored (..., N, K), planned on the transposed view), with one tight
    ``max_nnz`` over every slice unless given.  A ``QuantizedLinear`` is
    planned on its int8 payload and carries its scales (never
    transposed)."""
    quantized = isinstance(w, QuantizedLinear)
    if quantized and transpose:
        raise ValueError("quantized weights are stored contraction-oriented "
                         "— plan them with transpose=False")
    stored = w.q if quantized else w
    kn = stored.transpose(-1, -2) if transpose else stored
    lead = tuple(int(v) for v in kn.shape[:-2])
    flat = kn.reshape(-1, *kn.shape[-2:])
    bmaps = stack_block_bitmap(flat, bk, bn).cpu().numpy()
    tk, tn = bmaps.shape[1:]
    site_nnz, wkidx, wkcnt = _stack_lists(bmaps, site, lead, max_nnz)
    dev = stored.device
    padded = pad_to_blocks(kn, bk, bn)
    return PlannedWeight(
        w=stored,
        wkidx=torch.as_tensor(wkidx.reshape(lead + (tn, site_nnz)),
                              device=dev),
        wkcnt=torch.as_tensor(wkcnt.reshape(lead + (tn,)), device=dev),
        b_bitmap=torch.as_tensor(bmaps.reshape(lead + (tk, tn)), device=dev),
        qscale=w.scale if quantized else None, site=site, mode=mode, bm=bm,
        bk=bk, bn=bn, max_nnz=int(site_nnz), tk=int(tk),
        transpose=transpose,
        wpad=None if padded is kn else padded.contiguous())


def measure_weight_densities(params, schedules) -> Dict[str, float]:
    """Per-site element density of the actual param tensors — the cheap
    first pass of plan bring-up (a non-zero count per planned leaf)."""
    nnz: Dict[str, float] = {}
    size: Dict[str, float] = {}
    for _, site, _, _, _, w, _ in _planned_leaves(params, schedules):
        nnz[site] = nnz.get(site, 0.0) + float(count_nonzero(w))
        size[site] = size.get(site, 0.0) + float(w.numel())
    return {s: nnz[s] / size[s] for s in size if size[s]}


def compile_weight_plan(params, schedules, *,
                        max_nnz: Optional[Dict[str, int]] = None,
                        ref_elem_bytes: Optional[int] = None,
                        prune_ratio: float = 0.0
                        ) -> WeightSparsityPlan:
    """Compile a :class:`WeightSparsityPlan` from the actual param tensors.

    Every plannable leaf of a ``weight``/``two_sided`` site of
    ``schedules`` (a ``core.descriptors.NetworkSchedule``) gets per-slice
    block bitmaps and per-column live-K lists at the site schedule's block
    granularity, with one tight site-wide ``max_nnz``.  ``max_nnz``
    optionally caps a site's bound; a cap below the tightest feasible value
    raises ``ValueError`` naming the site and (slice, column).

    ``QuantizedLinear`` leaves compile on their int8 payload and mark the
    entry ``quantized`` (never transposed).  ``ref_elem_bytes`` is the
    dense-float width the byte economics compare against (default: the
    leaf's own, or 2 — bf16 — for a quantized leaf).

    ``prune_ratio`` compiles a **pruned tier**: each site's lists are those
    of the weight that ``prune_k_blocks`` at ``tier_max_live(tk, ratio)``
    would leave (the weakest K-blocks of each output column dropped, by
    the L2 norm of the dequantized values for an int8 leaf), while the
    weight itself stays as it is, so the tier attaches to the same leaves
    as the full plan.  ``wt_density`` / ``block_density`` are then the
    tier's dispatched densities; the byte economics keep describing the
    stored weight.  At ratio 0 the plan is the default one."""
    if not 0.0 <= prune_ratio < 1.0:
        raise ValueError(f"prune_ratio must be in [0, 1), got {prune_ratio}")
    plan = WeightSparsityPlan(arch=schedules.arch, shape=schedules.shape,
                              prune_ratio=float(prune_ratio))
    for path, site, d, kn, lead, w, scale in _planned_leaves(params,
                                                             schedules):
        _, k, n = kn.shape
        bm = max(min(d.schedule.bm, d.m), 1)
        bk = max(min(d.schedule.bk, k), 1)
        bn = max(min(d.schedule.bn, n), 1)
        bmaps = stack_block_bitmap(kn, bk, bn).cpu().numpy()  # (P, tk, tn)
        tk, tn = bmaps.shape[1:]
        nnz = count_nonzero(w)
        expert_nnz = None
        if len(lead) > 1:             # (L, E, K, N): non-zeros per expert
            expert_nnz = np.array([count_nonzero(w[:, i])
                                   for i in range(lead[1])], np.int64)
        size = int(w.numel())
        dispatched = nnz
        keep = (_prune_stack_blocks(kn, scale, bk, bn, prune_ratio)
                if prune_ratio else None)
        if keep is not None:
            bmaps = bmaps & keep
            dispatched = int((_block_nonzeros(kn, bk, bn) * keep).sum())
        site_nnz, wkidx, wkcnt = _stack_lists(
            bmaps, site, lead, (max_nnz or {}).get(site))
        quantized = w.dtype == torch.int8
        elem_bytes = (ref_elem_bytes if ref_elem_bytes is not None
                      else (2 if quantized else w.element_size()))
        plan.entries["/".join(path)] = SitePlan(
            path=path, site=site, mode=d.sparsity_mode, bm=bm, bk=bk, bn=bn,
            tk=int(tk), tn=int(tn), max_nnz=int(site_nnz), lead=lead,
            transpose=site in TRANSPOSED_SITES and not quantized,
            wkidx=wkidx.reshape(lead + (tn, site_nnz)),
            wkcnt=wkcnt.reshape(lead + (tn,)),
            b_bitmap=bmaps.reshape(lead + (tk, tn)),
            nnz=nnz, size=size, wt_density=dispatched / max(size, 1),
            block_density=float(bmaps.mean()),
            prune_ratio=float(prune_ratio),
            dense_bytes=size * elem_bytes,
            zvc_bytes=zvc_weight_bytes(size, nnz, elem_bytes=elem_bytes),
            quantized=quantized,
            int8_zvc_bytes=zvc_weight_bytes(size, nnz, quantized=True,
                                            n_channels=kn.shape[0] * n),
            expert_nnz=expert_nnz)
    return plan


def compile_plan_tiers(params, schedules, ratios=(0.0, 0.5), *,
                       max_nnz: Optional[Dict[str, int]] = None,
                       ref_elem_bytes: Optional[int] = None) -> list:
    """One :class:`WeightSparsityPlan` per pruning ratio (non-decreasing,
    conventionally from 0.0, the full plan), all over ``schedules`` and so
    at one block granularity: attached to one params tree they share its
    weights.  A higher ratio lists a subset of a lower one's blocks, with a
    ``max_nnz`` no larger."""
    rs = [float(r) for r in ratios]
    if not rs:
        raise ValueError("compile_plan_tiers needs at least one ratio")
    if any(b < a for a, b in zip(rs, rs[1:])):
        raise ValueError(f"tier ratios must be non-decreasing, got {rs}")
    return [compile_weight_plan(params, schedules, max_nnz=max_nnz,
                                ref_elem_bytes=ref_elem_bytes,
                                prune_ratio=r)
            for r in rs]
