"""Common layers: norms, gated MLPs, embeddings, the logits head and the
chunked cross-entropy of training.

Under tensor parallelism (``sharding.partition.tensor_parallel``: a model
axis above 1) a layer whose weight is split over ``model`` runs on its
shard: the MLP on this rank's d_ff columns (column-parallel in, row-
parallel out, the partial sums combined in ``ops``), the embedding lookup
and the cross-entropy on this rank's vocabulary rows.  At one shard the
arithmetic is the unsharded one."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.flextree import ReduceConfig
from repro_torch.core.stacks import leading_slices
from repro_torch.kernels import ops
from repro_torch.sharding import collectives, partition

Params = Dict[str, torch.Tensor]


# float32 draws of one ``normal`` call above which a stacked leaf is drawn
# in slices of its leading axis of at most as many (2 GiB of float32; a
# full-width expert leaf of DeepSeek-MoE-16B would otherwise take a 20 GB
# float32 temporary).  Smaller leaves are drawn in one call, as before
# there were slices, so their draws stay the same
DRAW_ELEMS = 1 << 29


def normal(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """N(0, scale²) draws on the generator's device, cast to ``dtype`` —
    the reference's ``jax.random.normal(k, shape) * scale`` distribution
    (the draws themselves differ between frameworks); on the meta device
    (``model.param_shapes``) an empty tensor of the shape."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if len(shape) > 2 and math.prod(shape) > DRAW_ELEMS:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        if math.prod(shape[1:]) > DRAW_ELEMS:
            # one leading index is itself too large (a layer of Llama-4's
            # experts, 16 x 5120 x 8192): each is drawn by its own slices
            for i in range(shape[0]):
                out[i] = normal(gen, tuple(shape[1:]), scale, dtype)
            return out
        for s in leading_slices(shape[0], math.prod(shape[1:]), DRAW_ELEMS):
            out[s] = normal(gen, (s.stop - s.start,) + tuple(shape[1:]),
                            scale, dtype)
        return out
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ArchConfig, dim: int, device, lead=()) -> Params:
    p = {"scale": torch.ones(lead + (dim,), dtype=torch.float32,
                             device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (dim,), dtype=torch.float32,
                                device=device)
    return p


def apply_norm(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    return y.to(x.dtype)


def apply_norm_per_position(p: Params, cfg: ArchConfig,
                            x: torch.Tensor) -> torch.Tensor:
    """``apply_norm`` on each position of x (B, W, D) in turn, at the
    (B, 1, D) shape of a decode step: how a row reduction splits its sum
    can depend on the number of rows, and a verify window must give each
    position a decode step's bits."""
    return torch.cat([apply_norm(p, cfg, x[:, i:i + 1].contiguous())
                      for i in range(x.shape[1])], dim=1)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU) and plain MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg: ArchConfig, gen: torch.Generator, d_in: int, d_ff: int,
             dtype=torch.bfloat16, lead=()) -> Params:
    s_in, s_ff = d_in ** -0.5, d_ff ** -0.5
    p = {"w_in": normal(gen, lead + (d_in, d_ff), s_in, dtype)}
    if cfg.act != "gelu_plain":
        p["w_gate"] = normal(gen, lead + (d_in, d_ff), s_in, dtype)
    p["w_out"] = normal(gen, lead + (d_ff, d_in), s_ff, dtype)
    return p


def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act in ("gelu", "gelu_plain"):
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def apply_mlp(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    tp = partition.tensor_parallel()
    split = tp is not None and p["w_in"].shape[-1] * tp.size == cfg.d_ff
    if split:             # this rank's d_ff columns
        x = collectives.to_model(x, tp.group)
    h = ops.flex_matmul(x, p["w_in"], site="mlp.in")
    if "w_gate" in p:
        g = ops.flex_matmul(x, p["w_gate"], site="mlp.gate")
        h = _act(cfg, g) * h
    else:
        h = _act(cfg, h)
    return ops.flex_matmul(h, p["w_out"], site="mlp.out", partial=split)


# ---------------------------------------------------------------------------
# Embedding + logits head
# ---------------------------------------------------------------------------

def init_embedding(cfg: ArchConfig, gen: torch.Generator,
                   dtype=torch.bfloat16) -> torch.Tensor:
    return normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype)


def _vocab_shard(cfg: ArchConfig, table: torch.Tensor):
    """(tensor parallelism, first row) when ``table`` holds this rank's
    rows of the vocabulary, else None."""
    tp = partition.tensor_parallel()
    if tp is None or table.shape[0] * tp.size != cfg.vocab:
        return None
    return tp, tp.index * table.shape[0]


def embed(cfg: ArchConfig, emb: torch.Tensor,
          tokens: torch.Tensor) -> torch.Tensor:
    shard = _vocab_shard(cfg, emb)
    if shard is None:
        x = emb[tokens]
    else:                 # vocab-parallel: rows this rank owns, summed
        tp, lo = shard
        idx = tokens.long() - lo
        own = (idx >= 0) & (idx < emb.shape[0])
        x = emb[torch.where(own, idx, 0)] * own[..., None].to(emb.dtype)
        x = collectives.from_model(x, ReduceConfig("model", tp.size),
                                   tp.group)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def logits_head(cfg: ArchConfig, head, x: torch.Tensor) -> torch.Tensor:
    """Full float32 logits for the decode position(s); the contraction is
    the planned/dispatched ``lm_head`` site.  A ``head`` of this rank's
    vocabulary rows (tensor parallelism) gives this rank's logits, which
    are gathered over the model axis (no gradient)."""
    logits = ops.head_matmul(x, head, site="lm_head").float()
    shard = (_vocab_shard(cfg, head) if isinstance(head, torch.Tensor)
             else None)
    if shard is not None:
        logits = collectives.gather_dim(logits.contiguous(), shard[0].group,
                                        -1)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _xent_chunk(xc: torch.Tensor, head: torch.Tensor,
                lc: torch.Tensor) -> torch.Tensor:
    """Σ (log-sum-exp − label logit) over one (B, C) chunk: the bare
    product x·headᵀ in the operands' promoted dtype, then float32."""
    xc, head = ops.common_dtype(xc, head)
    logits = torch.matmul(xc, head.t()).float()
    lse = torch.logsumexp(logits, dim=-1)
    lab = logits.gather(-1, lc[..., None].long())[..., 0]
    return (lse - lab).sum()


def _xent_chunk_vocab(xc: torch.Tensor, head: torch.Tensor, lc: torch.Tensor,
                      lo: int, tp) -> torch.Tensor:
    """``_xent_chunk`` with ``head`` this rank's vocabulary rows from
    ``lo``: a local max and an all-reduce MAX, a local sum of exponentials
    and an all-reduce SUM, the label logit from the rank that owns it.
    Only (B, C, V / model) logits are live."""
    xc = collectives.to_model(xc, tp.group)
    xc, head = ops.common_dtype(xc, head)
    logits = torch.matmul(xc, head.t()).float()
    red = ReduceConfig("model", tp.size)
    mx = collectives.all_reduce(logits.detach().amax(-1), tp.group,
                                torch.distributed.ReduceOp.MAX)
    se = collectives.from_model(torch.exp(logits - mx[..., None]).sum(-1),
                                red, tp.group)
    idx = lc.long() - lo
    own = (idx >= 0) & (idx < head.shape[0])
    lab = logits.gather(-1, torch.where(own, idx, 0)[..., None])[..., 0]
    lab = collectives.from_model(torch.where(own, lab, 0.0), red, tp.group)
    return (mx + torch.log(se) - lab).sum()


def chunked_softmax_xent(cfg: ArchConfig, head: torch.Tensor,
                         x: torch.Tensor, labels: torch.Tensor,
                         chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy of x (B, S, D) against ``labels`` (B, S) under the
    (V, D) ``head`` without the (B, S, V) logits: ``S // chunk`` chunks
    (the tail that does not divide is dropped, as in the reference), each
    under ``torch.utils.checkpoint`` so that only one chunk's logits are
    ever live, even in the backward; the sum over chunks in float32,
    divided by B·n_chunks·chunk.  The logits are a plain matrix product,
    outside any site (the reference's ``einsum``).  A ``head`` of this
    rank's vocabulary rows (tensor parallelism) takes
    ``_xent_chunk_vocab``."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    n_chunks = max(s // chunk, 1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    grad = torch.is_grad_enabled() and (x.requires_grad
                                        or head.requires_grad)
    fn, extra = _xent_chunk, ()
    shard = _vocab_shard(cfg, head)
    if shard is not None:
        fn, extra = _xent_chunk_vocab, (shard[1], shard[0])
    for c in range(n_chunks):
        xc = x[:, c * chunk:(c + 1) * chunk]
        lc = labels[:, c * chunk:(c + 1) * chunk]
        if grad:
            part = torch.utils.checkpoint.checkpoint(
                fn, xc, head, lc, *extra, use_reentrant=False)
        else:
            part = fn(xc, head, lc, *extra)
        total = total + part
    return total / (b * n_chunks * chunk)
