"""Plain PyTorch versions of the kernels (the JAX package's
``kernels/ref.py`` oracles).  The wrappers run these for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card."""
from __future__ import annotations

from typing import Optional

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with float32 accumulation (plain version of every
    ``flex_matmul`` stationarity)."""
    return torch.matmul(a.float(), b.float())


def block_sparse_matmul_ref(a: torch.Tensor, b: torch.Tensor, meta,
                            scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain version of the two-sided block-sparse matmul: blocks outside
    the combined bitmap are zeroed (skipped, not approximated), then one
    dense float32 product — equal to the dense product whenever the bitmaps
    come from the data.  ``scale`` (N,) marks an int8 ``b`` payload: the
    product of the masked payload is scaled once per output column."""
    tm, tk = meta.a_bitmap.shape
    tn = meta.b_bitmap.shape[1]
    bm, bk, bn = a.shape[0] // tm, a.shape[1] // tk, b.shape[1] // tn
    a_mask = meta.a_bitmap.repeat_interleave(bm, 0).repeat_interleave(bk, 1)
    b_mask = meta.b_bitmap.repeat_interleave(bk, 0).repeat_interleave(bn, 1)
    a_z = torch.where(a_mask, a, torch.zeros((), dtype=a.dtype,
                                             device=a.device))
    b_z = torch.where(b_mask, b, torch.zeros((), dtype=b.dtype,
                                             device=b.device))
    out = torch.matmul(a_z.float(), b_z.float())
    if scale is not None:
        out = out * scale.float()[None, :]
    return out


def int8_matmul_ref(a: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """The reference's oracle of the int8-weight matmul: dequantize to
    float32, then one float32 product."""
    w = q.float() * scale.float()[None, :]
    return torch.matmul(a.float(), w)


def int8_matmul_plain(a: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain version in the kernel's own order: the unscaled float32
    product of the int8 payload, scaled once per output column.  The
    scales are K-invariant, so this is ``int8_matmul_ref``'s function up to
    float32 rounding."""
    return torch.matmul(a.float(), q.float()) * scale.float()[None, :]


NEG_INF = -1e30


def _attention_mask(sq: int, skv: int, causal: bool, window: int, device,
                    q0: int = 0, k0: int = 0) -> Optional[torch.Tensor]:
    """(sq, skv) bool mask of query rows q0.. against keys k0.., the ends
    of the full sequences aligned (query i sits at position i + skv_full -
    sq_full, folded into ``q0`` by the caller); None when nothing masks."""
    if not (causal or window):
        return None
    qpos = torch.arange(q0, q0 + sq, device=device)[:, None]
    kpos = torch.arange(k0, k0 + skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The reference's dense oracle of the flash-attention kernel: q (BH,
    Sq, hd), k / v (BH, Skv, hd) → (BH, Sq, hd) in v's type.  Scores in
    q's type, softmax in float32 (float64 for float64 inputs), masked
    entries -1e30; the sequence ends are aligned (offset Skv - Sq)."""
    sq, hd = q.shape[1], q.shape[2]
    skv = k.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqh,bkh->bqk", q, k).to(acc) * scale
    mask = _attention_mask(sq, skv, causal, window, q.device, skv - sq)
    if mask is not None:
        s = torch.where(mask[None], s, torch.tensor(NEG_INF, dtype=acc,
                                                    device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", w.to(v.dtype), v)


def _live_q_blocks(nq: int, ki: int, bq: int, bkv: int, offset: int,
                  causal: bool, window: int) -> range:
    """The q blocks for which kv block ``ki`` is live under the Pallas
    kernel's test (causal: k_lo <= q_lo + bq - 1; window: q_lo - (k_lo +
    bkv - 1) < window, with q_lo = qi·bq + offset) — a contiguous range."""
    k_lo = ki * bkv
    live = [qi for qi in range(nq)
            if (not causal or k_lo <= qi * bq + offset + bq - 1)
            and (not window or qi * bq + offset - (k_lo + bkv - 1) < window)]
    return range(live[0], live[-1] + 1) if live else range(0)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          bq: int = 64, bkv: int = 64,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version in the kernel's order: the online softmax over the
    live kv blocks of (bq, bkv), ascending, with the Pallas kernel's
    arithmetic — float32 scores scaled after the dot, p = exp(s - m), alpha
    = exp(m_old - m_new), l = l·alpha + Σp, p rounded to v's type before
    the PV product, acc = acc·alpha + PV, out = acc / max(l, 1e-30) in q's
    type.  Each kv block updates every q block it is live for at once (the
    rows are independent).  Sq and Skv must be multiples of the blocks
    (clamped to the sequence lengths), as the reference's wrapper
    asserts."""
    bh, sq, hd = q.shape
    skv = k.shape[1]
    bq, bkv = min(bq, sq), min(bkv, skv)
    if sq % bq or skv % bkv:
        raise ValueError(f"Sq={sq} / Skv={skv} are not multiples of the "
                         f"blocks ({bq}, {bkv})")
    scale = hd ** -0.5 if scale is None else scale
    offset = skv - sq
    acc_t = torch.promote_types(q.dtype, torch.float32)
    m = torch.full((bh, sq), NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros((bh, sq), dtype=acc_t, device=q.device)
    acc = torch.zeros((bh, sq, hd), dtype=acc_t, device=q.device)
    neg = torch.tensor(NEG_INF, dtype=acc_t, device=q.device)
    for ki in range(skv // bkv):
        rows = _live_q_blocks(sq // bq, ki, bq, bkv, offset, causal, window)
        if not rows:
            continue
        r0, r1 = rows.start * bq, rows.stop * bq
        k_lo = ki * bkv
        kb = k[:, k_lo:k_lo + bkv].to(acc_t)
        vb = v[:, k_lo:k_lo + bkv]
        s = torch.matmul(q[:, r0:r1].to(acc_t), kb.transpose(1, 2)) * scale
        mask = _attention_mask(r1 - r0, bkv, causal, window, q.device,
                               r0 + offset, k_lo)
        if mask is not None:
            s = torch.where(mask[None], s, neg)
        m_old = m[:, r0:r1]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_old - m_new)
        l[:, r0:r1] = l[:, r0:r1] * alpha + p.sum(dim=-1)
        pv = torch.matmul(p.to(v.dtype).to(acc_t), vb.to(acc_t))
        acc[:, r0:r1] = acc[:, r0:r1] * alpha[..., None] + pv
        m[:, r0:r1] = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)
