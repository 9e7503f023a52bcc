"""Attention: MHA / GQA / MQA projections, masked dense attention, the
full-sequence forward of a prefill (dense up to 2048 tokens, above it the
online softmax, which is the flash-attention kernel under ``use_kernels``;
a sliding window shorter than the sequence takes the windowed branch;
a cross-attention pass takes its keys and values from another sequence),
the per-slot KV cache of decode (full length, or rolling for sliding
windows) and the W-position decode of a speculative verify window.

Under tensor parallelism (a model axis above 1) the full-sequence forward
runs this rank's heads (``_local_heads``): a self-attention's, and a
cross-attention's too — its queries from the decoder stream, its keys and
values from the replicated encoder memory through this rank's ``wkv``
columns, ``wo`` row-parallel with the combine.  Heads that do not split
over the model axis (gemma-2b's 8, Llama-4's 40 or Whisper's 6 over 16)
run whole on every model rank (``_replicated_heads``), as GSPMD keeps
the reference's unsplit head axis.

A decode step under tensor parallelism (``_decode_step_tp``) runs the
same heads.  Its cache holds every kv head (``batch_shardings`` never
splits the cache's head axis), so each rank writes every kv head's new
K / V (its kv heads' gathered over the model axis).  Without SP the cache
holds every row and a rank attends with its heads over it; under SP
(``partition.cache_rows``: the rows cut over ``model``) each rank holds
C / m rows of every kv head: the queries of every head are gathered, each
rank takes its rows' share of the softmax and the shares are merged over
the model axis (``_rows_attention``: the max, the sums of exponentials
and the weighted values, each all-reduced), and this rank's heads go on
to the row-parallel ``wo``; the new K / V is written only by the rank
that holds row ``pos`` (the rolling slot of a windowed cache)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import rope
from repro_torch.models.layers import normal
from repro_torch.sharding import collectives, partition

Params = Dict[str, torch.Tensor]
NEG_INF = -1e30


def init_attention(cfg: ArchConfig, gen: torch.Generator,
                   dtype=torch.bfloat16, lead=(),
                   cross: bool = False) -> Params:
    """``cross`` (a cross-attention block) changes nothing, as in the
    reference: its k / v projection has the same shape."""
    d, hd = cfg.d_model, cfg.head_dim
    s = d ** -0.5
    return {
        "wq": normal(gen, lead + (d, cfg.n_heads * hd), s, dtype),
        "wkv": normal(gen, lead + (d, 2 * cfg.n_kv_heads * hd), s, dtype),
        "wo": normal(gen, lead + (cfg.n_heads * hd, d), s, dtype),
    }


def _project_qkv(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 kv_x: Optional[torch.Tensor] = None):
    """x (B,S,D) -> q (B,S,KVH,G,hd), k/v (B,Skv,KVH,hd); k and v are
    projected from ``kv_x`` (B,Skv,D) when given (cross-attention), else
    from x."""
    b, s, _ = x.shape
    hd, kvh, g = cfg.head_dim, cfg.n_kv_heads, cfg.q_per_kv
    q = ops.flex_matmul(x, p["wq"], site="attn.q").reshape(b, s, kvh, g, hd)
    src = x if kv_x is None else kv_x
    kv = ops.flex_matmul(src, p["wkv"], site="attn.kv")
    kv = kv.reshape(b, src.shape[1], 2, kvh, hd)
    return q, kv[:, :, 0], kv[:, :, 1]


def _local_heads(p: Params, cfg: ArchConfig, tp):
    """(params, config) of this rank's heads: its n_heads / model q heads
    (``wq``'s columns and ``wo``'s rows are split by heads) and the kv
    heads they read.  With kv heads split over the model axis too, its
    ``wkv`` shard already holds the K and V columns of its kv heads;
    otherwise (fewer kv heads than shards: yi-9b or chatglm3-6b at 4)
    the kv projection is gathered and this rank keeps the one kv head
    its q heads share."""
    h, kvh, m = cfg.n_heads, cfg.n_kv_heads, tp.size
    if h % m or (kvh % m and m % kvh):
        raise NotImplementedError(
            f"{cfg.name}: {h} q / {kvh} kv heads over {m} model shards")
    if kvh % m == 0:
        return p, dataclasses.replace(cfg, n_heads=h // m,
                                      n_kv_heads=kvh // m)
    hd = cfg.head_dim
    wkv = partition.model_gather(p["wkv"], tp, halves=True)
    j = tp.index * (h // m) // cfg.q_per_kv
    kv = wkv.unflatten(-1, (2, kvh, hd))[..., j, :].flatten(-2)
    return ({**p, "wkv": kv},
            dataclasses.replace(cfg, n_heads=h // m, n_kv_heads=1))


def heads_split(cfg: ArchConfig, tp) -> bool:
    """Whether the heads split over the model axis (``_local_heads``):
    the q heads divide, and the kv heads divide or each is shared by
    whole ranks."""
    h, kvh, m = cfg.n_heads, cfg.n_kv_heads, tp.size
    return h % m == 0 and (kvh % m == 0 or m % kvh == 0)


def _replicated_heads(p: Params, tp) -> Params:
    """The whole attention weights on every model rank (heads that do not
    split over it): gathered where stored split, each rank's gradient
    block taken back (``partition.model_replicated``)."""
    return {name: partition.model_replicated(p, name, tp)
            for name in ("wq", "wkv", "wo")}


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B,Sq,KVH,G,hd), k/v (B,Skv,KVH,hd), mask broadcastable to
    (B,KVH,G,Sq,Skv) bool.  Masked scores are -1e30 (not -inf); the
    softmax runs in float32 and is cast back to q's dtype.  Operands of
    two dtypes (a bf16 decoder's queries on a float32 encoder memory) meet
    in the promoted one, as ``jnp.einsum``'s do."""
    hd = q.shape[-1]
    scores = torch.einsum("bqkgh,bskh->bkgqs",
                          *ops.common_dtype(q, k)).float() * (hd ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", *ops.common_dtype(w, v))


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0, q_chunk: int = 512,
                        kv_chunk: int = 512) -> torch.Tensor:
    """The flash branch: q (B,S,KVH,G,hd), k/v (B,Skv,KVH,hd) flattened to
    (B·KVH·G, S, hd) in the reference's head order (k/v broadcast over
    G), through ``ops.flash_attention`` — the flash-attention kernel under
    ``use_kernels``, else the online softmax over (q_chunk, kv_chunk)
    blocks, live blocks only — and back.  Both keep the scores in float32
    where the reference's plain twin rounds them to q's type first.  S
    must be a multiple of the blocks, as in the reference.  ``window``
    (0: none) also masks keys ``window`` or more positions back."""
    b, sq, kvh, g, hd = q.shape
    skv = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(b * kvh * g, sq, hd)

    def heads(t):
        return t.permute(0, 2, 1, 3)[:, :, None].expand(
            b, kvh, g, skv, hd).reshape(b * kvh * g, skv, hd)

    o = ops.flash_attention(qf, heads(k), heads(v), causal=causal,
                            window=window, bq=q_chunk, bkv=kv_chunk)
    return o.reshape(b, kvh, g, sq, hd).permute(0, 3, 1, 2, 4)


def attention_forward(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                      positions: torch.Tensor, causal: bool = True,
                      window: int = 0, kv_x: Optional[torch.Tensor] = None,
                      q_chunk: int = 512,
                      mrope_positions: Optional[torch.Tensor] = None,
                      use_flash: Optional[bool] = None,
                      return_kv: bool = False):
    """Full-sequence attention (prefill).  x (B,S,D), ``positions``
    (B,S).  Dense masked attention up to 2048 tokens, above it (or with
    ``use_flash``) the flash branch (``flash_attention_xla``).
    ``return_kv=True`` also returns the (post-RoPE) k and the raw v
    (B,S,KVH,hd), which the cache-filling prefill stores.

    A causal ``window`` shorter than the sequence takes the windowed
    branch (``flash_attention_xla`` with the window): the flash-attention
    kernel under ``use_kernels``, else the reference's
    ``windowed_attention``.

    ``kv_x`` (B,Skv,D) makes it cross-attention: k and v come from
    ``kv_x``, no rotary is applied (as in the reference), and the caller
    passes ``causal=False``, which the dense branch runs unmasked.

    ``mrope_positions`` (3,B,S) are M-RoPE's t/h/w streams (a
    ``rope="mrope"`` config; others ignore them, as the reference does)."""
    tp = partition.tensor_parallel()
    if tp is not None and not heads_split(cfg, tp):
        p, tp = _replicated_heads(p, tp), None    # every head, every rank
    if tp is not None:    # this rank's heads
        p, cfg = _local_heads(p, cfg, tp)
        x = collectives.to_model(x, tp.group)
        if kv_x is not None:
            kv_x = collectives.to_model(kv_x, tp.group)
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, kv_x)
    if kv_x is None:      # self-attention: rotary on q and k
        qf = rope.apply_rope(q.reshape(b, s, cfg.n_heads, cfg.head_dim),
                             positions, kind=cfg.rope, theta=cfg.rope_theta,
                             mrope_positions=mrope_positions)
        q = qf.reshape(q.shape)
        k = rope.apply_rope(k, positions, kind=cfg.rope,
                            theta=cfg.rope_theta,
                            mrope_positions=mrope_positions)

    if use_flash is None:
        use_flash = s > 2048
    if window and causal and s > window:
        o = flash_attention_xla(q, k, v, causal=True, window=window,
                                q_chunk=q_chunk, kv_chunk=max(q_chunk, 512))
    elif use_flash:
        o = flash_attention_xla(q, k, v, causal=causal, q_chunk=q_chunk,
                                kv_chunk=max(q_chunk, 512))
    else:
        mask = None
        if causal:
            qpos, kpos = positions[:, :, None], positions[:, None, :]
            mask = qpos >= kpos
            if window:
                mask &= (qpos - kpos) < window
            mask = mask[:, None, None]
        o = dense_attention(q, k, v, mask)
    o = o.reshape(b, s, cfg.n_heads * cfg.head_dim)
    out = ops.flex_matmul(o, p["wo"], site="attn.out",
                          partial=tp is not None)
    if return_kv:
        return out, (k, v)
    return out


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cpu", lead=()) -> Params:
    """Rolling cache for windowed layers (size=window), else full length."""
    size = min(cfg.window, max_seq) if cfg.window else max_seq
    shape = lead + (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(p: Params, cfg: ArchConfig, x: torch.Tensor, cache: Params,
                pos: torch.Tensor, *, active: Optional[torch.Tensor] = None,
                window: int = 0) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  x (B,1,D); cache k/v (B,C,KVH,hd); ``pos`` (B,)
    per-slot positions.

    The cache is updated **in place**, and committed only at rows where
    ``active`` (B,) is true (None = every row): every row's new K/V is
    written and attended to, as the reference does, and an inactive row's
    slot then gets its old value back.  So every row's output is the
    reference's, the inactive rows' too: a MoE layer routes all rows of
    the batch together, and an idle slot's filler row competes for expert
    capacity with the live ones."""
    tp = partition.tensor_parallel()
    if tp is not None:
        return _decode_step_tp(p, cfg, x, cache, pos, tp, active=active,
                               window=window)
    b = x.shape[0]
    hd = cfg.head_dim
    q, k_new, v_new = _project_qkv(p, cfg, x)
    posb = pos[:, None]
    qf = rope.apply_rope(q.reshape(b, 1, cfg.n_heads, hd), posb,
                         kind=cfg.rope, theta=cfg.rope_theta)
    q = qf.reshape(q.shape)
    k_new = rope.apply_rope(k_new, posb, kind=cfg.rope, theta=cfg.rope_theta)

    size = cache["k"].shape[1]
    slot = (pos % size) if window > 0 else torch.clamp(pos, max=size - 1)
    rows = torch.arange(b, device=x.device)
    kept = {}
    for name, new in (("k", k_new), ("v", v_new)):
        c = cache[name]
        new = new[:, 0].to(c.dtype)
        if active is not None:
            kept[name] = torch.where(active[:, None, None], new,
                                     c[rows, slot])
        c[rows, slot] = new

    idx = torch.arange(size, device=x.device)[None]
    posm = pos[:, None]
    if window > 0:
        age = posm - _slot_position(idx, posm, size)
        valid = (age >= 0) & (age < torch.clamp(posm + 1, max=window))
    else:
        valid = idx <= posm
    o = dense_attention(q, cache["k"], cache["v"],
                        valid[:, None, None, None, :])
    for name, val in kept.items():       # inactive rows keep their slot
        cache[name][rows, slot] = val
    o = o.reshape(b, 1, cfg.n_heads * hd)
    return ops.flex_matmul(o, p["wo"], site="attn.out"), cache


# ---------------------------------------------------------------------------
# Decode under tensor parallelism
# ---------------------------------------------------------------------------

def _rank_heads(cfg: ArchConfig, tp):
    """(first q head, q heads) this rank runs: its block where the heads
    split, else all of them."""
    if heads_split(cfg, tp):
        n = cfg.n_heads // tp.size
        return tp.index * n, n
    return 0, cfg.n_heads


def _rows_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor], group) -> torch.Tensor:
    """``dense_attention`` over keys whose rows are cut over ``group``:
    q (B,Sq,KVH,G,hd) the same on every rank, k / v (B,S/m,KVH,hd) this
    rank's rows, ``mask`` for them.  The max, then the sum of
    exponentials, then the weighted values (in float32) are all-reduced,
    so every rank gets the softmax of the whole row and its output."""
    hd = q.shape[-1]
    scores = torch.einsum("bqkgh,bskh->bkgqs",
                          *ops.common_dtype(q, k)).float() * (hd ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    mx = collectives.all_reduce(scores.amax(-1, keepdim=True), group,
                                torch.distributed.ReduceOp.MAX)
    e = torch.exp(scores - mx)
    total = collectives.all_reduce(e.sum(-1, keepdim=True), group)
    w = (e / total).to(q.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", w.float(), v.float())
    return collectives.all_reduce(o, group).to(
        torch.promote_types(w.dtype, v.dtype))


def rank_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor], cfg: ArchConfig, tp
                   ) -> torch.Tensor:
    """One decode position's attention of this rank's heads under tensor
    parallelism: q (B,1,h_n,hd) the heads ``_rank_heads`` names, k / v
    (B,C',KVH,hd) every kv head of the cache (C' its rows on this rank:
    all of them, or C / m under ``partition.cache_rows``), ``mask``
    broadcastable to (B,KVH,G,1,C') → (B,1,h_n·hd)."""
    b, _, h_n, hd = q.shape
    h0, _ = _rank_heads(cfg, tp)
    g = cfg.q_per_kv
    if partition.cache_rows() is not None:        # SP: every head's q
        if h_n < cfg.n_heads:
            q = collectives.gather_dim(q.contiguous(), tp.group, 2)
        o = _rows_attention(q.reshape(b, 1, cfg.n_kv_heads, g, hd), k, v,
                            mask, tp.group)
        return o.reshape(b, 1, cfg.n_heads, hd)[:, :, h0:h0 + h_n].reshape(
            b, 1, h_n * hd)
    if h_n % g == 0:        # whole kv groups: kv heads h0/g .. (h0+h_n)/g
        kv0, kvn, gq = h0 // g, h_n // g, g
    else:                   # part of one kv head's group
        kv0, kvn, gq = h0 // g, 1, h_n
    o = dense_attention(q.reshape(b, 1, kvn, gq, hd),
                        k[:, :, kv0:kv0 + kvn], v[:, :, kv0:kv0 + kvn], mask)
    return o.reshape(b, 1, h_n * hd)


def _new_kv(p: Params, cfg: ArchConfig, x: torch.Tensor, tp):
    """Every kv head's new k / v (B,1,KVH,hd) on every model rank: this
    rank's kv heads projected and gathered where they split over the
    model axis, else projected from the whole ``wkv``."""
    b = x.shape[0]
    hd, kvh = cfg.head_dim, cfg.n_kv_heads
    split = partition.model_dim(p, "wkv") == p["wkv"].dim() - 1
    if split and kvh % tp.size == 0 and heads_split(cfg, tp):
        kv = ops.flex_matmul(x, p["wkv"], site="attn.kv").reshape(
            b, 1, 2, kvh // tp.size, hd)
        kv = collectives.gather_dim(kv.contiguous(), tp.group, 3)
        return kv[:, :, 0], kv[:, :, 1]
    wkv = partition.model_replicated(p, "wkv", tp)
    kv = ops.flex_matmul(x, wkv, site="attn.kv").reshape(b, 1, 2, kvh, hd)
    return kv[:, :, 0], kv[:, :, 1]


def _decode_step_tp(p: Params, cfg: ArchConfig, x: torch.Tensor,
                    cache: Params, pos: torch.Tensor, tp, *,
                    active: Optional[torch.Tensor], window: int
                    ) -> Tuple[torch.Tensor, Params]:
    """``decode_step`` on this rank's heads and cache shard (module
    docstring); the state stays in its shards."""
    b = x.shape[0]
    hd = cfg.head_dim
    split = heads_split(cfg, tp)
    h0, h_n = _rank_heads(cfg, tp)
    wq = p["wq"] if split else partition.model_replicated(p, "wq", tp)
    wo = p["wo"] if split else partition.model_replicated(p, "wo", tp)
    posb = pos[:, None]
    q = ops.flex_matmul(x, wq, site="attn.q").reshape(b, 1, h_n, hd)
    q = rope.apply_rope(q, posb, kind=cfg.rope, theta=cfg.rope_theta)
    k_new, v_new = _new_kv(p, cfg, x, tp)
    k_new = rope.apply_rope(k_new, posb, kind=cfg.rope, theta=cfg.rope_theta)

    rows_here = cache["k"].shape[1]
    sp = partition.cache_rows() is not None
    size = rows_here * tp.size if sp else rows_here
    lo = tp.index * rows_here if sp else 0
    slot = (pos % size) if window > 0 else torch.clamp(pos, max=size - 1)
    local = slot - lo
    own = (local >= 0) & (local < rows_here)
    local = torch.clamp(local, 0, rows_here - 1)
    rows = torch.arange(b, device=x.device)
    kept = {}
    for name, new in (("k", k_new), ("v", v_new)):
        c = cache[name]
        old = c[rows, local]
        new = torch.where(own[:, None, None], new[:, 0].to(c.dtype), old)
        if active is not None:
            kept[name] = torch.where(active[:, None, None], new, old)
        c[rows, local] = new

    idx = lo + torch.arange(rows_here, device=x.device)[None]
    posm = pos[:, None]
    if window > 0:
        age = posm - _slot_position(idx, posm, size)
        valid = (age >= 0) & (age < torch.clamp(posm + 1, max=window))
    else:
        valid = idx <= posm
    o = rank_attention(q, cache["k"], cache["v"],
                       valid[:, None, None, None, :], cfg, tp)
    for name, val in kept.items():       # inactive rows keep their slot
        cache[name][rows, local] = val
    return ops.flex_matmul(o, wo, site="attn.out", partial=split), cache


def decode_window(p: Params, cfg: ArchConfig, x: torch.Tensor,
                  cache: Params, pos: torch.Tensor, *,
                  active: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Params]:
    """W-position decode, the scorer of a speculative verify window.
    x (B, W, D) holds W consecutive tokens per row and ``pos`` (B,) the
    position of each row's first; full-length caches only.

    All W K/V pairs of the ``active`` rows (every row when None) are
    written in place at positions pos .. pos + W - 1 (clamped to the
    cache), as ``decode_step`` writes one; then window position i attends
    under the mask ``idx <= pos + i``, one position at a time at the
    shapes of a decode step (``q[:, i:i+1]``), so it gets that step's bits:
    the positions above it hold values it masks, as they would at decode.
    The projections run once for the whole window."""
    b, w, _ = x.shape
    hd = cfg.head_dim
    q, k_new, v_new = _project_qkv(p, cfg, x)
    posw = pos[:, None] + torch.arange(w, device=x.device)[None]   # (B, W)
    qf = rope.apply_rope(q.reshape(b, w, cfg.n_heads, hd), posw,
                         kind=cfg.rope, theta=cfg.rope_theta)
    q = qf.reshape(q.shape)
    k_new = rope.apply_rope(k_new, posw, kind=cfg.rope, theta=cfg.rope_theta)

    size = cache["k"].shape[1]
    slots = torch.clamp(posw, max=size - 1)
    rows = torch.arange(b, device=x.device)[:, None]
    for name, new in (("k", k_new), ("v", v_new)):
        c = cache[name]
        new = new.to(c.dtype)
        if active is not None:
            new = torch.where(active[:, None, None, None], new,
                              c[rows, slots])
        c[rows, slots] = new

    idx = torch.arange(size, device=x.device)[None]
    outs = []
    for i in range(w):
        valid = idx <= posw[:, i:i + 1]
        outs.append(dense_attention(q[:, i:i + 1].contiguous(), cache["k"],
                                    cache["v"],
                                    valid[:, None, None, None, :]))
    o = torch.cat(outs, dim=1).reshape(b, w, cfg.n_heads * hd)
    return ops.flex_matmul(o, p["wo"], site="attn.out"), cache


def _slot_position(idx: torch.Tensor, pos: torch.Tensor,
                   size: int) -> torch.Tensor:
    """Original sequence position stored in rolling slot ``idx`` at ``pos``."""
    cur_slot = pos % size
    offset = (idx - cur_slot + size) % size
    return torch.where(offset == 0, pos, pos - size + offset)
