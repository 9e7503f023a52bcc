"""Plain PyTorch versions of the kernels (the JAX package's
``kernels/ref.py`` oracles).  The wrappers run these for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card."""
from __future__ import annotations

from typing import NamedTuple, Optional

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


def meta_at(meta, e: int):
    """Expert ``e``'s metadata of a batched ``BlockSparseMeta`` (every
    tensor carries a leading expert axis)."""
    return type(meta)(kidx=meta.kidx[e], kcnt=meta.kcnt[e],
                      a_bitmap=meta.a_bitmap[e], b_bitmap=meta.b_bitmap[e],
                      max_nnz=meta.max_nnz)


def expert_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the batched dense expert matmul: (E, M, K) @
    (E, K, N) as ``matmul_ref`` per expert, stacked (float32)."""
    return torch.stack([matmul_ref(a[e], b[e]) for e in range(a.shape[0])])


def block_sparse_expert_matmul_ref(a: torch.Tensor, b: torch.Tensor, meta,
                                   scale: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Plain version of the batched block-sparse expert matmul: (E, M, K)
    @ (E, K, N) under metadata with a leading expert axis (``scale`` (E, N)
    for an int8 payload), ``block_sparse_matmul_ref`` per expert."""
    return torch.stack([
        block_sparse_matmul_ref(a[e], b[e], meta_at(meta, e),
                                None if scale is None else scale[e])
        for e in range(a.shape[0])])


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


def windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       window: int, q_chunk: int = 512) -> torch.Tensor:
    """Causal sliding-window attention with O(S·window) work, the
    reference's plain path: each query chunk attends only to the [pos -
    window, pos] slice of K/V.  q (B,S,KVH,G,hd), k/v (B,S,KVH,hd)."""
    b, sq, kvh, g, hd = q.shape
    q_chunk = min(q_chunk, sq)
    nq = sq // q_chunk
    span = window + q_chunk
    scale = hd ** -0.5
    outs = []
    for qi in range(nq):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        start = max(qi * q_chunk + q_chunk - span, 0)
        n = min(span, sq)
        kc, vc = k[:, start:start + n], v[:, start:start + n]
        qpos = torch.arange(qi * q_chunk, (qi + 1) * q_chunk,
                            device=q.device)[:, None]
        kpos = torch.arange(start, start + n, device=q.device)[None, :]
        mask = (qpos >= kpos) & (qpos - kpos < window)
        s = torch.einsum("bqkgh,bskh->bkgqs", qc, kc).float() * scale
        s = torch.where(mask, s, NEG_INF)
        w = torch.softmax(s, dim=-1).to(qc.dtype)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh", w, vc))
    return torch.cat(outs, dim=1)


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


def _round_to_zero_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` rounded toward zero to float32 (kept in float64)."""
    y = x.float()
    down = torch.nextafter(y, torch.zeros_like(y))
    return torch.where(y.double().abs() > x.abs(), down, y).double()


def tensor_core_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (BH, R, hd) @ kᵀ (BH, C, hd) → float32 (BH, R, C) summed as a
    model of Hopper's tensor cores: each 16-product group (one k16 step)
    exactly, added into the float32 accumulator and truncated toward zero,
    groups in ascending order."""
    bh, r, hd = q.shape
    if hd % 16:
        raise ValueError(f"hd={hd} is not a multiple of the k16 step")
    g = hd // 16
    groups = torch.einsum("brgi,bcgi->brcg",
                          q.double().reshape(bh, r, g, 16),
                          k.double().reshape(bh, k.shape[1], g, 16))
    acc = torch.zeros(groups.shape[:-1], dtype=torch.float64,
                      device=q.device)
    for i in range(g):
        acc = _round_to_zero_f32(acc + groups[..., i])
    return acc.float()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          bq: int = 64, bkv: int = 64,
                          scale: Optional[float] = None,
                          tc_scores: bool = False,
                          truncate_p: bool = False,
                          return_lse: bool = False):
    """Plain version in the kernel's order: the online softmax over the
    live kv blocks of (bq, bkv), ascending, with the Pallas kernel's
    arithmetic — float32 scores scaled after the dot, p = exp(s - m), alpha
    = exp(m_old - m_new), l = l·alpha + Σp, p rounded to v's type before
    the PV product, acc = acc·alpha + PV, out = acc / max(l, 1e-30) in q's
    type.  Each kv block updates every q block it is live for at once (the
    rows are independent).  Sq and Skv must be multiples of the blocks
    (clamped to the sequence lengths), as the reference's wrapper
    asserts.

    Two variants serve the bf16 checks: ``tc_scores`` sums the scores as
    ``tensor_core_scores`` models the tensor cores (bf16 q and k), and
    ``truncate_p`` rounds p toward zero instead of to nearest (a fault the
    checks must reject).  ``return_lse`` also returns each row's
    log-sum-exp m + log(l) (BH, Sq) in the accumulator's type, which the
    backward reads (``flash_attention_backward_plain``)."""
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
        if tc_scores:
            s = tensor_core_scores(q[:, r0:r1], k[:, k_lo:k_lo + bkv])
        else:
            s = torch.matmul(q[:, r0:r1].to(acc_t), kb.transpose(1, 2))
        s = s * scale
        mask = _attention_mask(r1 - r0, bkv, causal, window, q.device,
                               r0 + offset, k_lo)
        if mask is not None:
            s = torch.where(mask[None], s, neg)
        m_old = m[:, r0:r1]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_old - m_new)
        l[:, r0:r1] = l[:, r0:r1] * alpha + p.sum(dim=-1)
        if truncate_p:      # float32 → bf16 by dropping the low 16 bits
            pr = (p.view(torch.int32) & -65536).view(torch.float32)
        else:
            pr = p.to(v.dtype)
        pv = torch.matmul(pr.to(acc_t), vb.to(acc_t))
        acc[:, r0:r1] = acc[:, r0:r1] * alpha[..., None] + pv
        m[:, r0:r1] = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    if return_lse:
        return out.to(q.dtype), m + torch.log(l)
    return out.to(q.dtype)



def _round_toward_zero(x: torch.Tensor, dtype) -> torch.Tensor:
    """float32 ``x`` rounded toward zero to ``dtype`` (bf16: the low 16
    bits dropped), kept in float32 — the faulty rounding the checks must
    reject."""
    if dtype != torch.bfloat16:
        return x
    return (x.view(torch.int32) & -65536).view(torch.float32)


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   lse: torch.Tensor, do: torch.Tensor, *,
                                   causal: bool = True, window: int = 0,
                                   bq: int = 64, bkv: int = 64,
                                   scale: Optional[float] = None,
                                   tc_scores: bool = False,
                                   truncate: bool = False,
                                   magnitudes: bool = False):
    """dQ, dK, dV (float32; float64 for float64 inputs) of the flash
    forward, the plain version of ``fa_backward`` in its block order:
    D = rowsum(dO∘O); for each kv block, ascending, over the q blocks it is
    live for (the forward's skip): P = exp(S·scale − lse) (0 where masked),
    dP = dO·Vᵀ, dS = P∘(dP − D); dV += Pᵀ·dO, dK += dSᵀ·Q, dQ += dS·K, with
    P and dS rounded to q's type before their products (bf16: the kernel's
    tensor-core operands); dK and dQ are scaled once at the end.

    ``tc_scores`` sums S and dP as ``tensor_core_scores`` models the tensor
    cores (bf16), ``truncate`` rounds P and dS toward zero (a fault the
    checks must reject), and ``magnitudes`` returns instead the sums of
    the absolute products, |P̂|ᵀ·|dO|, scale·|dŜ|ᵀ·|Q| and scale·|dŜ|·|K|,
    the scale of each output's rounding (``flash_backward_check``; each
    |dŜ| there carries an allowance for the cancellation in dP − D)."""
    bh, sq, hd = q.shape
    skv = k.shape[1]
    bq, bkv = min(bq, sq), min(bkv, skv)
    if sq % bq or skv % bkv:
        raise ValueError(f"Sq={sq} / Skv={skv} are not multiples of the "
                         f"blocks ({bq}, {bkv})")
    scale = hd ** -0.5 if scale is None else scale
    offset = skv - sq
    acc_t = torch.promote_types(q.dtype, torch.float32)
    dsum = (do.to(acc_t) * o.to(acc_t)).sum(-1)
    dabs = (do.to(acc_t) * o.to(acc_t)).abs().sum(-1)
    dq = torch.zeros((bh, sq, hd), dtype=acc_t, device=q.device)
    dk = torch.zeros((bh, skv, hd), dtype=acc_t, device=q.device)
    dv = torch.zeros((bh, skv, hd), dtype=acc_t, device=q.device)
    lse = lse.to(acc_t)

    def rounded(x):
        if truncate:
            return _round_toward_zero(x, q.dtype)
        return x.to(q.dtype).to(acc_t)

    def mag(x):
        return x.abs() if magnitudes else x

    for ki in range(skv // bkv):
        rows = _live_q_blocks(sq // bq, ki, bq, bkv, offset, causal, window)
        if not rows:
            continue
        r0, r1 = rows.start * bq, rows.stop * bq
        k_lo = ki * bkv
        kb = k[:, k_lo:k_lo + bkv].to(acc_t)
        vb = v[:, k_lo:k_lo + bkv].to(acc_t)
        qb = q[:, r0:r1].to(acc_t)
        dob = do[:, r0:r1].to(acc_t)
        if tc_scores:
            s = tensor_core_scores(q[:, r0:r1], k[:, k_lo:k_lo + bkv])
            dp = tensor_core_scores(do[:, r0:r1], v[:, k_lo:k_lo + bkv])
        else:
            s = torch.matmul(qb, kb.transpose(1, 2))
            dp = torch.matmul(dob, vb.transpose(1, 2))
        p = torch.exp(s * scale - lse[:, r0:r1, None])
        mask = _attention_mask(r1 - r0, bkv, causal, window, q.device,
                               r0 + offset, k_lo)
        if mask is not None:
            p = torch.where(mask[None], p, torch.zeros((), dtype=acc_t,
                                                       device=q.device))
        ds = p * (dp - dsum[:, r0:r1, None])
        pr, dsr = mag(rounded(p)), mag(rounded(ds))
        if magnitudes:
            # dP - D cancels where dS is small: allow each dS the float32
            # rounding of its two hd-term dot products, 2⁻¹⁰·P·(|dO|·|V|ᵀ
            # + Σ|dO∘O|) (≥ hd·2⁻²⁴ of them over 2⁻⁸, with room 2)
            dsr = dsr + 2.0 ** -10 * p * (
                torch.matmul(dob.abs(), vb.abs().transpose(1, 2))
                + dabs[:, r0:r1, None])
        dv[:, k_lo:k_lo + bkv] += torch.matmul(pr.transpose(1, 2), mag(dob))
        dk[:, k_lo:k_lo + bkv] += torch.matmul(dsr.transpose(1, 2), mag(qb))
        dq[:, r0:r1] += torch.matmul(dsr, mag(kb))
    return dq * scale, dk * scale, dv


class BackwardCheck(NamedTuple):
    """How far a bf16 flash backward output is from the plain version, in
    units of its rounding scale 2⁻⁸·W (W: ``magnitudes=True``): the worst
    element, and the root mean square over all elements."""
    worst: float
    rms: float

    def ok(self) -> bool:
        return self.worst <= BWD_WORST and self.rms <= BWD_RMS


# A bf16 backward that rounds P and dS to nearest even as the plain version
# does, but sums S, dP, D and the products in another order, moves an
# output by one bf16 step (2⁻⁸..2⁻⁷ relative) of each P̂ / dŜ that lands
# across a rounding boundary, and by float32 rounding otherwise: at most
# 2⁻⁷·W, 2 in units of 2⁻⁸·W (the worst element is allowed 4); only a small
# share of the P̂ and dŜ lie that close to a boundary, so the root mean
# square stays far below one unit.  P and dS truncated toward zero move
# every term by about half a step, all one way.  On the CPU at BH 2, S 512
# (tests/test_torch_flash_grad.py) the tensor-core model of S and dP
# (``tc_scores``) gives an RMS of at most 0.003 and a worst element of at
# most 0.19, truncation an RMS of at least 0.13: the RMS limit sits 16x
# above the one and 2.6x below the other.
BWD_WORST = 4.0
BWD_RMS = 0.05


def flash_backward_check(out: torch.Tensor, plain: torch.Tensor,
                         weight: torch.Tensor) -> BackwardCheck:
    """``out`` (a bf16 flash backward's float32 dQ, dK or dV) against
    ``plain`` (``flash_attention_backward_plain`` on the same bf16
    operands), scaled by 2⁻⁸·``weight`` (its ``magnitudes=True`` twin)."""
    unit = 2.0 ** -8 * weight.double() + 1e-30
    r = (out.double() - plain.double()) / unit
    return BackwardCheck(r.abs().max().item(), r.pow(2).mean().sqrt().item())


class FlipBounds(NamedTuple):
    """What a bf16 flash kernel whose scores are summed on the tensor cores
    may change against ``flash_attention_plain`` (see
    ``flash_attention_flip_bounds``), per output element (BH, Sq, hd) or
    per row (BH, Sq)."""
    fragile: torch.Tensor   # Σ p·|v| / l over the p that may round apart
    weight: torch.Tensor    # Σ p̂·|v| / l: the softmax-weighted |v|
    score_err: torch.Tensor  # per row: bound on any score's error
    flipped: torch.Tensor   # the plain version, every fragile p̂ flipped
    modelled: torch.Tensor  # the plain version, ``tensor_core_scores``


def flash_attention_flip_bounds(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                window: int = 0, bq: int = 64,
                                bkv: int = 64) -> FlipBounds:
    """Bounds for a bf16 kernel that sums the scores on the tensor cores.

    Such a kernel and ``flash_attention_plain`` (bf16 q, k, v) agree on
    every exact bf16 product but sum them differently.  A score then
    differs by at most ε = 2⁻²⁴·(hd/8 + √hd + 1)·a, a = hd^-0.5·Σ|q||k|:
    the tensor core truncates each 16-product group to within 2⁻²³ of its
    largest term (hd/16 groups), the library's float32 sum errs by ~√hd
    roundings, and the scaling by one.  The row max inherits the error of
    the scores seen so far (``score_err``), so p = exp(s − m) moves
    relatively by δ = ε + that.  Rounding p to bf16 turns δ into a whole
    bf16 step (≤ 2⁻⁷·p) for the p that lie within δ of a rounding
    boundary: the *fragile* ones.  Walks the same live blocks in the same
    order as the plain version; ``modelled`` is the plain version with
    ``tc_scores``."""
    bh, sq, hd = q.shape
    skv = k.shape[1]
    bq, bkv = min(bq, sq), min(bkv, skv)
    scale = hd ** -0.5
    offset = skv - sq
    c = 2.0 ** -24 * (hd / 8 + hd ** 0.5 + 1)
    f32 = torch.float32
    dev = q.device
    m = torch.full((bh, sq), NEG_INF, dtype=f32, device=dev)
    err = torch.zeros((bh, sq), dtype=f32, device=dev)
    l = torch.zeros((bh, sq), dtype=f32, device=dev)
    acc = {n: torch.zeros((bh, sq, hd), dtype=f32, device=dev)
           for n in ("fragile", "weight", "flipped")}
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    for ki in range(skv // bkv):
        rows = _live_q_blocks(sq // bq, ki, bq, bkv, offset, causal, window)
        if not rows:
            continue
        r0, r1 = rows.start * bq, rows.stop * bq
        k_lo = ki * bkv
        qb, kb = q[:, r0:r1].to(f32), k[:, k_lo:k_lo + bkv].to(f32)
        vb = v[:, k_lo:k_lo + bkv].to(f32)
        s = torch.matmul(qb, kb.transpose(1, 2)) * scale
        eps = c * scale * torch.matmul(qb.abs(), kb.abs().transpose(1, 2))
        mask = _attention_mask(r1 - r0, bkv, causal, window, dev,
                               r0 + offset, k_lo)
        if mask is not None:
            s = torch.where(mask[None], s, neg)       # exact on both sides
            eps = torch.where(mask[None], eps, torch.zeros_like(eps))
        m_old = m[:, r0:r1]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        e_new = torch.maximum(err[:, r0:r1], eps.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_old - m_new)
        delta = eps + e_new[..., None]
        pb = p.bfloat16()
        fragile = ((p * (1 + delta)).bfloat16() != pb) \
            | ((p * (1 - delta)).bfloat16() != pb)
        # the other bf16 neighbour of p: one step down from a p̂ above p,
        # one step up from a p̂ below it (p̂ > 0, so the bit pattern steps)
        bits = pb.view(torch.int16)
        step = torch.where(pb.float() > p, -1, 1).to(torch.int16)
        other = torch.where(fragile & (bits > 0), bits + step, bits) \
            .view(torch.bfloat16)
        l[:, r0:r1] = l[:, r0:r1] * alpha + p.sum(dim=-1)
        for name, w, val in (("fragile", p * fragile, vb.abs()),
                             ("weight", pb.to(f32), vb.abs()),
                             ("flipped", other.to(f32), vb)):
            acc[name][:, r0:r1] = acc[name][:, r0:r1] * alpha[..., None] \
                + torch.matmul(w, val)
        m[:, r0:r1] = m_new
        err[:, r0:r1] = e_new
    den = torch.clamp(l, min=1e-30)[..., None]
    return FlipBounds(acc["fragile"] / den, acc["weight"] / den, err,
                      (acc["flipped"] / den).to(q.dtype),
                      flash_attention_plain(q, k, v, causal=causal,
                                            window=window, bq=bq, bkv=bkv,
                                            tc_scores=True))


# how far the share of differing elements may exceed the tensor-core model's
SHARE_ROOM = 2.0


class TcCheck(NamedTuple):
    """``flash_tc_check``'s reading."""
    ratio: float    # worst |out − plain| over its bound
    share: float    # share of elements that differ
    limit: float    # the share allowed

    @property
    def ok(self) -> bool:
        return self.ratio <= 1.0 and self.share <= self.limit


def flash_tc_check(out: torch.Tensor, plain: torch.Tensor, v: torch.Tensor,
                   bounds: FlipBounds) -> TcCheck:
    """The tensor-core tolerance of a bf16 flash kernel's ``out`` against
    ``plain`` = ``flash_attention_plain`` of the same bf16 inputs.  Per
    element the bound is one bf16 ulp of the element (the last
    rounding); 2⁻²⁴·√Skv·max|v| (float32 P·V sums in other orders); the
    score error's continuous effect on the rescales and on l, with e the
    row's score error bound, w the weighted |v| and n the kv blocks,
    (2e + n·2⁻²³)·(w + |o|) + 2e·|o|; and 2⁻⁷ times the weight of the
    fragile p (each may round one bf16 step apart).  The share limit is
    2⁻¹³ (P·V roundings, as for a scalar kernel) plus ``SHARE_ROOM`` times
    the share of elements in which the plain version with the scores
    summed as ``tensor_core_scores`` models them differs: the expected
    number of p that round apart, not the most that could.  The room
    covers a model of a rounding that NVIDIA does not document."""
    d = (out.double() - plain.double()).abs()
    o = plain.double().abs()
    _, e = torch.frexp(o.clamp_min(2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(d), (e - 8).to(torch.int64))
    skv = v.shape[1]
    err = bounds.score_err.double()[..., None]
    gamma = 2 * err + (skv // 64) * 2.0 ** -23
    bound = ulp + 2.0 ** -24 * skv ** 0.5 * v.abs().max().item() \
        + gamma * (bounds.weight.double() + o) + 2 * err * o \
        + 2.0 ** -7 * bounds.fragile.double()
    limit = 2.0 ** -13 + SHARE_ROOM * (bounds.modelled != plain) \
        .double().mean().item()
    return TcCheck((d / bound).max().item(), (d > 0).double().mean().item(),
                   limit)
