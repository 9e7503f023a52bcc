"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

Chunked SSD: the sequence is split into chunks; within a chunk a quadratic
(attention-like) form, across chunks a small recurrence that carries the
(B, H, P, N) float32 state from chunk to chunk.  Decode is the selective
state update h ← a·h + dt·B·x, y = C·h.

The in / out projections are plain matmuls (``torch.matmul``): the
reference computes them with a bare ``@`` outside any kernel and its plan
has no ``ssm`` sites, so neither the descriptor table nor a weight plan
reaches them.  Every cast sits where the reference's does (the float32
``dt`` and state, the chunk weights cast to the activation dtype), so a
bf16 model rounds at the same points.

The intra-chunk mask is the reference's as written: it keeps the pairs
i <= j (``causal.at[jj, ii].set(False)`` over the upper triangle's indices),
so with chunks longer than one token a position sees the later positions
of its chunk and the chunked form differs from the recurrence (ROADMAP
queue C).  At chunk 1 only the diagonal is left and the two agree.

Under tensor parallelism (a model axis above 1) the block is channel-
parallel: this rank runs its n_heads / model SSD heads — the z, x and dt
columns of its heads and every B and C column of ``in_proj`` (one group
does not split), its x channels and all B / C channels of the conv —
the gated norm's mean of squares is summed over the model axis before
its rsqrt, and ``out_proj`` is row-parallel, its partial sums combined
by FlexTree's reduction (``_local_params``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.flextree import ReduceConfig
from repro_torch.models.layers import normal
from repro_torch.sharding import collectives, partition

Params = Dict[str, torch.Tensor]


def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def n_ssd_heads(cfg: ArchConfig) -> int:
    return d_inner(cfg) // cfg.ssm.head_dim


def init_ssm(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16,
             lead=()) -> Params:
    """The reference's distributions, drawn leaf by leaf for all ``lead``
    stacked blocks.  ``in_proj`` is the fused [z, x, B, C, dt]
    projection."""
    d, di, h = cfg.d_model, d_inner(cfg), n_ssd_heads(cfg)
    g, n = cfg.ssm.n_groups, cfg.ssm.d_state
    conv_c = di + 2 * g * n
    dev = gen.device

    def vec(values: torch.Tensor) -> torch.Tensor:
        return values.expand(lead + values.shape).contiguous()

    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": normal(gen, lead + (d, 2 * di + 2 * g * n + h), d ** -0.5,
                          dtype),
        "conv_w": normal(gen, lead + (cfg.ssm.d_conv, conv_c), 0.1, dtype),
        "conv_b": torch.zeros(lead + (conv_c,), dtype=dtype, device=dev),
        "A_log": vec(torch.log(torch.linspace(1.0, 16.0, h, **f32))),
        "D": torch.ones(lead + (h,), **f32),
        "dt_bias": vec(torch.log(torch.expm1(torch.full((h,), 0.01,
                                                        **f32)))),
        "norm_scale": torch.ones(lead + (di,), **f32),
        "out_proj": normal(gen, lead + (di, d), di ** -0.5, dtype),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor, di: int = 0):
    di = di or d_inner(cfg)
    gn2 = 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di],
            zxbcdt[..., 2 * di:2 * di + gn2], zxbcdt[..., 2 * di + gn2:])


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d over (B, S, C) with kernel (K, C)."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + s] * w[i]
    return out + b


def _local_params(cfg: ArchConfig, params: Params, tp) -> Params:
    """This rank's share of a block's leaves under tensor parallelism
    (module docstring), as the installed specs store them
    (``partition.model_block`` / ``model_columns`` / ``model_whole``):
    each leaf's gradient summed over ``model`` where ranks share it."""
    di, h = d_inner(cfg), n_ssd_heads(cfg)
    if h % tp.size:
        raise NotImplementedError(f"{cfg.name}: {h} SSD heads over "
                                  f"{tp.size} model shards")
    dl, hl = di // tp.size, h // tp.size
    gn2 = 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    dev = params["in_proj"].device

    def span(lo, n):                  # host indices: the plan needs no data
        return np.arange(lo, lo + n)

    def conv(r):                                            # [x_r | B C]
        return np.concatenate([span(r * dl, dl), span(di, gn2)])

    def proj(r):                                  # [z_r | x_r | B C | dt_r]
        return np.concatenate([span(r * dl, dl), span(di + r * dl, dl),
                               span(2 * di, gn2),
                               span(2 * di + gn2 + r * hl, hl)])
    block = partition.model_block
    out = {
        "in_proj": partition.model_columns(params, "in_proj", tp, proj),
        "conv_w": partition.model_whole(params, "conv_w", tp).index_select(
            -1, torch.as_tensor(conv(tp.index), device=dev)),
        "conv_b": partition.model_columns(params, "conv_b", tp, conv),
        "norm_scale": block(params, "norm_scale", tp, -1),
        "out_proj": block(params, "out_proj", tp, 0),
    }
    for name in ("A_log", "D", "dt_bias"):
        out[name] = block(params, name, tp, -1)
    return out


def ssd_forward(cfg: ArchConfig, params: Params,
                x_in: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD.  x_in (B, S, D) -> (B, S, D).  S must be a
    multiple of min(chunk, S), as the reference's reshapes need.  Under
    tensor parallelism, this rank's heads (module docstring)."""
    tp = partition.tensor_parallel()
    if tp is not None:
        params = _local_params(cfg, params, tp)
        x_in = collectives.to_model(x_in, tp.group)
    return ssd_from_proj(cfg, params, torch.matmul(x_in, params["in_proj"]),
                         tp=tp)


def ssd_from_proj(cfg: ArchConfig, params: Params, zxbcdt: torch.Tensor, *,
                  tp=None) -> torch.Tensor:
    """``ssd_forward`` after its in-projection: the fused [z, x, B, C, dt]
    activations (B, S, 2·d_inner + 2·G·N + H) -> (B, S, D); with ``tp``
    (tensor parallelism) this rank's heads' activations under its
    ``_local_params``."""
    b, s, _ = zxbcdt.shape
    m = 1 if tp is None else tp.size
    di, h = d_inner(cfg) // m, n_ssd_heads(cfg) // m
    g, n, p_hd = cfg.ssm.n_groups, cfg.ssm.d_state, cfg.ssm.head_dim
    chunk = min(cfg.ssm.chunk, s)
    if s % chunk:
        raise ValueError(f"ssd_forward: a sequence of {s} tokens is not a "
                         f"multiple of the SSD chunk {chunk}")
    nc = s // chunk

    z, xc, bc, dt = _split_proj(cfg, zxbcdt, di)
    xbc = torch.cat([xc, bc], dim=-1)
    xbc = F.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"]))
    xc, bc = xbc[..., :di], xbc[..., di:]
    B = bc[..., :g * n].reshape(b, s, g, n)
    C = bc[..., g * n:].reshape(b, s, g, n)

    dt = F.softplus(dt.float() + params["dt_bias"])                 # (B,S,H)
    A = -torch.exp(params["A_log"])                                  # (H,)
    xh = xc.reshape(b, s, h, p_hd)

    # ---- chunked SSD ----
    xch = xh.reshape(b, nc, chunk, h, p_hd)
    Bch = B.reshape(b, nc, chunk, g, n)
    Cch = C.reshape(b, nc, chunk, g, n)
    dtc = dt.reshape(b, nc, chunk, h)
    dA_cum = torch.cumsum(dtc * A, dim=2)                          # (B,nc,c,H)

    # intra-chunk: decay(i, j) = exp(dA_cum[i] - dA_cum[j]) under the
    # reference's mask (module docstring)
    decay = torch.exp(dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :])
    keep = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=zxbcdt.device).triu()
    decay = torch.where(keep[None, None, :, :, None], decay, 0.0)
    hpg = h // g
    scores = torch.einsum("bnigx,bnjgx->bnijg", Cch, Bch)
    scores = torch.repeat_interleave(scores, hpg, dim=-1)            # -> H
    w = scores * decay * dtc[:, :, None, :, :]                     # weight x_j
    del decay, scores
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", w.to(xh.dtype), xch)
    del w

    # inter-chunk recurrence over the (B, H, P, N) state
    Bh = torch.repeat_interleave(Bch, hpg, dim=3)                # (b,nc,c,H,n)
    Ch = torch.repeat_interleave(Cch, hpg, dim=3)
    chunk_decay = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)         # (b,nc,c,H)
    state_in = torch.einsum("bnch,bnchx,bnchp->bnhpx",
                            (chunk_decay * dtc).to(xh.dtype), Bh, xch)
    total_decay = torch.exp(dA_cum[:, :, -1, :])                     # (b,nc,H)
    state_in = state_in.float()
    hstate = torch.zeros((b, h, p_hd, n), dtype=torch.float32,
                         device=zxbcdt.device)
    before = []               # the state each chunk starts from
    for k in range(nc):       # the reference's lax.scan over chunks
        before.append(hstate)
        hstate = hstate * total_decay[:, k, :, None, None] + state_in[:, k]
    states = torch.stack(before, dim=1)                          # (b,nc,H,P,N)
    in_decay = torch.exp(dA_cum)                                   # (b,nc,c,H)
    y_inter = torch.einsum("bnchx,bnhpx,bnch->bnchp", Ch,
                           states.to(xh.dtype), in_decay.to(xh.dtype))

    y = (y_intra + y_inter).reshape(b, s, h, p_hd)
    y = y + params["D"][None, None, :, None].to(y.dtype) * xh
    y = _gated_norm(y.reshape(b, s, di), z, params["norm_scale"], tp)
    out = torch.matmul(y, params["out_proj"])
    if tp is None:
        return out
    return collectives.from_model(out, ReduceConfig("model", tp.size),
                                  tp.group)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                tp=None) -> torch.Tensor:
    """Gated RMSNorm in float32: norm(y · silu(z)) · scale, in y's dtype.
    With ``tp`` the mean of squares is over every rank's channels."""
    yf = y.float() * F.silu(z.float())
    if tp is None:
        var = (yf ** 2).mean(-1, keepdim=True)
    else:
        var = collectives.psum((yf ** 2).sum(-1, keepdim=True),
                               tp.group) / (y.shape[-1] * tp.size)
    return (yf * torch.rsqrt(var + 1e-6) * scale).to(y.dtype)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def conv_channels(cfg: ArchConfig) -> int:
    """The channels of the SSD block's conv: [x | B | C]."""
    return d_inner(cfg) + 2 * cfg.ssm.n_groups * cfg.ssm.d_state


def init_ssm_state(cfg: ArchConfig, batch: int, device="cpu",
                   lead=()) -> Params:
    """{ssm (..., B, H, P, N), conv (..., B, K-1, C)}, both float32 (the
    reference's default, which its stack always takes)."""
    di, h = d_inner(cfg), n_ssd_heads(cfg)
    conv_c = di + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    return {
        "ssm": torch.zeros(lead + (batch, h, cfg.ssm.head_dim,
                                   cfg.ssm.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.ssm.d_conv - 1, conv_c),
                            dtype=torch.float32, device=device),
    }


def ssd_decode_step(cfg: ArchConfig, params: Params, x_in: torch.Tensor,
                    state: Params, *, active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Params]:
    """x_in (B, 1, D); state {ssm (B,H,P,N), conv (B,K-1,C)}, updated **in
    place** at the ``active`` (B,) rows (every row when None); the other
    rows keep their state bit for bit.

    Under tensor parallelism the step runs this rank's SSD heads, as
    ``ssd_forward`` does, on its block of the ``ssm`` state (split by
    head) and of the ``conv`` window (a plain block of its C channels,
    which cuts across [x | B C]): the window is gathered over the model
    axis for the channels this rank convolves ([x_r | B C]), and each rank
    writes its block of the shifted window from the new x columns of
    every rank (gathered) and its own B C."""
    b = x_in.shape[0]
    tp = partition.tensor_parallel()
    m = 1 if tp is None else tp.size
    di, h = d_inner(cfg) // m, n_ssd_heads(cfg) // m
    g, n, p_hd = cfg.ssm.n_groups, cfg.ssm.d_state, cfg.ssm.head_dim
    conv_state = state["conv"]
    # the conv window's channels are whole on each rank where they do not
    # split over the model axis (batch_shardings drops the axis there)
    conv_split = (tp is not None
                  and conv_state.shape[-1] * m == conv_channels(cfg))
    if tp is not None:
        params = _local_params(cfg, params, tp)
        full = (collectives.gather_dim(conv_state.contiguous(), tp.group, -1)
                if conv_split else conv_state)
        cols = torch.cat([torch.arange(tp.index * di, (tp.index + 1) * di),
                          torch.arange(d_inner(cfg), full.shape[-1])]
                         ).to(full.device)
        conv_state = full.index_select(-1, cols)

    zxbcdt = torch.matmul(x_in[:, 0], params["in_proj"])             # (B, ...)
    z, xc, bc, dt = _split_proj(cfg, zxbcdt[:, None, :], di)
    xbc_new = torch.cat([xc, bc], dim=-1)[:, 0]                      # (B, C)
    # float32, as the reference's concatenate with its float32 window gives
    conv_win = torch.cat([conv_state, xbc_new[:, None].float()], dim=1)
    conv_out = (conv_win * params["conv_w"][None]).sum(dim=1) \
        + params["conv_b"]
    xbc = F.silu(conv_out)
    xcv, bcv = xbc[..., :di], xbc[..., di:]
    B = bcv[..., :g * n].reshape(b, g, n)
    C = bcv[..., g * n:].reshape(b, g, n)

    dtv = F.softplus(dt[:, 0].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    da = torch.exp(dtv * A)                                          # (B, H)
    xh = xcv.reshape(b, h, p_hd)
    hpg = h // g
    Bh = torch.repeat_interleave(B, hpg, dim=1)                      # (B,H,N)
    Ch = torch.repeat_interleave(C, hpg, dim=1)

    new_state = state["ssm"] * da[:, :, None, None] \
        + torch.einsum("bh,bhp,bhx->bhpx", dtv, xh.float(), Bh.float())
    y = torch.einsum("bhx,bhpx->bhp", Ch.float(), new_state)
    y = y + params["D"][None, :, None] * xh.float()
    y = y.reshape(b, 1, di).to(x_in.dtype)
    y = _gated_norm(y, z, params["norm_scale"], tp)
    out = torch.matmul(y, params["out_proj"])
    conv = conv_win[:, 1:]
    if tp is not None:
        out = collectives.from_model(out, ReduceConfig("model", tp.size),
                                     tp.group)
        xs = collectives.gather_dim(xc[:, 0].contiguous(), tp.group, -1)
        new = torch.cat([xs, bc[:, 0]], dim=-1).float()      # every channel
        c = state["conv"].shape[-1]
        lo = tp.index * c if conv_split else 0
        conv = torch.cat([state["conv"][:, 1:], new[:, None, lo:lo + c]],
                         dim=1)
    if active is not None:
        new_state = torch.where(active[:, None, None, None], new_state,
                                state["ssm"])
        conv = torch.where(active[:, None, None], conv, state["conv"])
    state["ssm"].copy_(new_state)
    state["conv"].copy_(conv)
    return out, state
