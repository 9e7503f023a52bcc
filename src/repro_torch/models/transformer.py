"""The decoder stack: stacked layer weights (layer axis leading), the
full-sequence forward of a prefill, one-token decode through every layer
and the W-token decode of a speculative verify window.

Five families are ported: the dense decoder (``layers``); the MoE
decoder — ``dense_layers`` (the first ``moe.first_dense_layers`` layers,
dense) then ``layers`` (attention and ``models.moe`` in each); the
Griffin hybrid — ``groups`` of ``rglru.block_pattern`` blocks (two RG-LRU
recurrent layers, then one sliding-window attention layer, keyed
``b{i}_{kind}``) then the ``trailing`` recurrent layers; the Mamba-2 SSM
(``layers`` of one SSD block each, ``models.ssm``); and the Whisper
encoder-decoder — an ``encoder`` stack (bidirectional attention and MLP
over frame embeddings plus sinusoidal positions) and a ``decoder`` stack
(causal self-attention, cross-attention to the encoder's output, MLP).
The decode state is split the same way.  The full-cache prefill and the
verify window take dense stacks only, as the reference's."""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sparsity import PlannedWeight
from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.rope import sinusoidal_positions
from repro_torch.quant.quantize import QuantizedLinear
from repro_torch.core.flextree import ReduceConfig
from repro_torch.sharding import collectives, partition
from repro_torch.models.layers import (apply_mlp, apply_norm,
                                       apply_norm_per_position, init_mlp,
                                       init_norm)

Params = Dict[str, torch.Tensor]


def index_tree(tree, i: int):
    """The layer-``i`` slice of a stacked params tree (views, no copies;
    ``PlannedWeight`` and ``QuantizedLinear`` leaves slice their metadata
    and scales alongside)."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, (PlannedWeight, QuantizedLinear)):
        return tree.index(i)
    return tree[i]


def _check_dense(cfg: ArchConfig) -> None:
    if (cfg.moe.enabled or cfg.rglru.enabled or cfg.ssm.enabled
            or cfg.encoder_decoder):
        raise NotImplementedError(
            f"{cfg.name}: the cache-filling prefill takes dense stacks only")


def init_dense_layer(cfg: ArchConfig, gen: torch.Generator,
                     dtype=torch.bfloat16, lead=()) -> Params:
    return {
        "ln1": init_norm(cfg, cfg.d_model, gen.device, lead),
        "attn": attention.init_attention(cfg, gen, dtype, lead),
        "ln2": init_norm(cfg, cfg.d_model, gen.device, lead),
        "mlp": init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype, lead),
    }


def apply_dense_layer(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                      positions: torch.Tensor, window: int = 0,
                      mrope_positions: Optional[torch.Tensor] = None,
                      q_chunk: int = 512, return_kv: bool = False):
    """One layer over x (B,S,D); ``return_kv=True`` also returns the
    attention's (post-RoPE k, raw v), as ``attention_forward`` does."""
    h = apply_norm(p["ln1"], cfg, x)
    o = attention.attention_forward(
        p["attn"], cfg, h, positions=positions, window=window,
        q_chunk=q_chunk, mrope_positions=mrope_positions,
        return_kv=return_kv)
    if return_kv:
        o, kv = o
    x = x + o
    h = apply_norm(p["ln2"], cfg, x)
    x = x + apply_mlp(p["mlp"], cfg, h)
    return (x, kv) if return_kv else x


def decode_dense_layer(p: Params, cfg: ArchConfig, x, cache, pos, *,
                       active=None, window: int = 0):
    h = apply_norm(p["ln1"], cfg, x)
    o, cache = attention.decode_step(p["attn"], cfg, h, cache, pos,
                                     active=active, window=window)
    x = x + o
    h = apply_norm(p["ln2"], cfg, x)
    return x + apply_mlp(p["mlp"], cfg, h), cache


def init_moe_layer(cfg: ArchConfig, gen: torch.Generator,
                   dtype=torch.bfloat16, lead=()) -> Params:
    return {
        "ln1": init_norm(cfg, cfg.d_model, gen.device, lead),
        "attn": attention.init_attention(cfg, gen, dtype, lead),
        "ln2": init_norm(cfg, cfg.d_model, gen.device, lead),
        "moe": moe_mod.init_moe(cfg, gen, dtype, lead),
    }


def apply_moe_layer(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                    positions: torch.Tensor, q_chunk: int = 512,
                    mrope_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    h = apply_norm(p["ln1"], cfg, x)
    x = x + attention.attention_forward(p["attn"], cfg, h,
                                        positions=positions, q_chunk=q_chunk,
                                        mrope_positions=mrope_positions)
    h = apply_norm(p["ln2"], cfg, x)
    return x + moe_mod.apply_moe(p["moe"], cfg, h)


def decode_moe_layer(p: Params, cfg: ArchConfig, x, cache, pos, *,
                     active=None):
    """One token through a MoE layer; the routing takes the global batch
    (``moe.apply_moe_rows``), as the reference's decode step routes it."""
    h = apply_norm(p["ln1"], cfg, x)
    o, cache = attention.decode_step(p["attn"], cfg, h, cache, pos,
                                     active=active)
    x = x + o
    h = apply_norm(p["ln2"], cfg, x)
    return x + moe_mod.apply_moe_rows(p["moe"], cfg, h), cache


def init_ssm_layer(cfg: ArchConfig, gen: torch.Generator,
                   dtype=torch.bfloat16, lead=()) -> Params:
    return {
        "ln1": init_norm(cfg, cfg.d_model, gen.device, lead),
        "ssm": ssm_mod.init_ssm(cfg, gen, dtype, lead),
    }


def apply_ssm_layer(p: Params, cfg: ArchConfig,
                    x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(p["ln1"], cfg, x)
    return x + ssm_mod.ssd_forward(cfg, p["ssm"], h)


def decode_ssm_layer(p: Params, cfg: ArchConfig, x, state, *, active=None):
    h = apply_norm(p["ln1"], cfg, x)
    o, state = ssm_mod.ssd_decode_step(cfg, p["ssm"], h, state,
                                       active=active)
    return x + o, state


def init_rec_layer(cfg: ArchConfig, gen: torch.Generator,
                   dtype=torch.bfloat16, lead=()) -> Params:
    return {
        "ln1": init_norm(cfg, cfg.d_model, gen.device, lead),
        "rglru": rglru.init_rglru(cfg, gen, dtype, lead),
        "ln2": init_norm(cfg, cfg.d_model, gen.device, lead),
        "mlp": init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype, lead),
    }


def apply_rec_layer(p: Params, cfg: ArchConfig,
                    x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(p["ln1"], cfg, x)
    x = x + rglru.rglru_forward(p["rglru"], cfg, h)
    h = apply_norm(p["ln2"], cfg, x)
    return x + apply_mlp(p["mlp"], cfg, h)


def decode_rec_layer(p: Params, cfg: ArchConfig, x, state, *, active=None):
    h = apply_norm(p["ln1"], cfg, x)
    o, state = rglru.rglru_decode_step(p["rglru"], cfg, h, state,
                                       active=active)
    x = x + o
    h = apply_norm(p["ln2"], cfg, x)
    return x + apply_mlp(p["mlp"], cfg, h), state


def griffin_layout(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_groups, n_trailing_rec) of a Griffin stack."""
    glen = len(cfg.rglru.block_pattern)     # 3 for (rec, rec, attn)
    return cfg.n_layers // glen, cfg.n_layers % glen


def init_griffin_group(cfg: ArchConfig, gen: torch.Generator,
                       dtype=torch.bfloat16, lead=()) -> Params:
    group = {}
    for i, kind in enumerate(cfg.rglru.block_pattern):
        init = init_rec_layer if kind == "rec" else init_dense_layer
        group[f"b{i}_{kind}"] = init(cfg, gen, dtype, lead)
    return group


def apply_griffin_group(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                        positions: torch.Tensor,
                        q_chunk: int = 512) -> torch.Tensor:
    for i, kind in enumerate(cfg.rglru.block_pattern):
        lp = p[f"b{i}_{kind}"]
        if kind == "rec":
            x = apply_rec_layer(lp, cfg, x)
        else:
            x = apply_dense_layer(lp, cfg, x, positions=positions,
                                  window=cfg.window, q_chunk=q_chunk)
    return x


def decode_griffin_group(p: Params, cfg: ArchConfig, x, state, pos, *,
                         active=None):
    """One token through a group; each block's state (views of the
    stacked state) is updated in place at the ``active`` rows."""
    for i, kind in enumerate(cfg.rglru.block_pattern):
        key = f"b{i}_{kind}"
        if kind == "rec":
            x, _ = decode_rec_layer(p[key], cfg, x, state[key],
                                    active=active)
        else:
            x, _ = decode_dense_layer(p[key], cfg, x, state[key], pos,
                                      active=active, window=cfg.window)
    return x, state


def _moe_layout(cfg: ArchConfig) -> Tuple[int, int]:
    """(dense, MoE) layer counts of a MoE stack."""
    n_dense = cfg.moe.first_dense_layers
    return n_dense, cfg.n_layers - n_dense


def init_stack(cfg: ArchConfig, gen: torch.Generator,
               dtype=torch.bfloat16) -> Params:
    """Stacked (L, ...) layer weights, drawn leaf by leaf for all layers;
    a MoE stack holds its MoE layers in ``layers`` and its leading dense
    ones in ``dense_layers``, a Griffin stack its groups in ``groups``
    and its last recurrent layers in ``trailing``, an SSM stack its SSD
    blocks in ``layers``, an encoder-decoder its ``encoder`` and
    ``decoder`` layers."""
    if cfg.encoder_decoder:
        return {"encoder": init_dense_layer(cfg, gen, dtype,
                                            (cfg.n_layers,)),
                "decoder": init_whisper_dec_layer(cfg, gen, dtype,
                                                  (cfg.n_layers,))}
    if cfg.ssm.enabled:
        return {"layers": init_ssm_layer(cfg, gen, dtype, (cfg.n_layers,))}
    if cfg.rglru.enabled:
        n_groups, n_trail = griffin_layout(cfg)
        p = {"groups": init_griffin_group(cfg, gen, dtype, (n_groups,))}
        if n_trail:
            p["trailing"] = init_rec_layer(cfg, gen, dtype, (n_trail,))
        return p
    if cfg.moe.enabled:
        n_dense, n_moe = _moe_layout(cfg)
        p = {"layers": init_moe_layer(cfg, gen, dtype, (n_moe,))}
        if n_dense:
            p["dense_layers"] = init_dense_layer(cfg, gen, dtype, (n_dense,))
        return p
    return {"layers": init_dense_layer(cfg, gen, dtype, (cfg.n_layers,))}


REMAT_POLICIES = ("none", "dots", "full")


@contextlib.contextmanager
def _entered(*managers):
    with contextlib.ExitStack() as stack:
        for cm in managers:
            stack.enter_context(cm)
        yield


def _remat(fn, policy: str):
    """``fn`` (one layer) under the reference's remat ``policy``:
    ``none`` keeps every activation its backward needs; ``full`` saves
    only the layer's inputs and recomputes the rest in the backward
    (``torch.utils.checkpoint``, non-reentrant); ``dots`` also keeps the
    outputs of the layer's matmul and flash calls (``ops.DotsTape``) and
    recomputes only the rest.  The recomputation runs under the ExecConfig
    the forward ran under (PyTorch may run it on another thread), so it
    takes the same routes and gives the same bits: the policies change
    memory, never results.  The sharding rules installed at the forward
    are installed again around the recomputation, so a layer's FSDP
    gathers and tensor-parallel collectives run again there.  Without
    autograd ``fn`` runs as it is."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat {policy!r} not in {REMAT_POLICIES}")
    if policy == "none" or not torch.is_grad_enabled():
        return fn

    def run(*args, **kw):
        ec = ops.current_exec_config()
        state = partition.installed()
        if policy == "full":
            def contexts():
                return contextlib.nullcontext(), _entered(
                    ops.exec_config(ec), partition.use_rules(*state))
        else:
            tape = ops.DotsTape()

            def contexts():
                return (ops.recording(tape),
                        _entered(ops.exec_config(ec), ops.replaying(tape),
                                 partition.use_rules(*state)))
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, context_fn=contexts, **kw)
    return run


def _layer(fn, group: str, remat: str):
    """``fn`` for each layer of the stack's ``group`` under ``remat``;
    on local shards (``sharding.partition.use_rules`` with specs) it first
    gathers the layer's FSDP shards, inside the remat segment, so they are
    freed after the layer and gathered again by its recomputation."""
    return _remat(partition.fsdp_gathered(fn, partition.stack_specs(group)),
                  remat)


def layer_trees(tree, n: int):
    """The n per-layer slices of a stacked params tree, each stacked
    tensor cut with one ``torch.unbind`` (views, as ``index_tree``'s),
    whose backward stacks the layers' gradients in one pass; indexing
    layer by layer would add a zero-filled full-stack gradient per layer.
    ``PlannedWeight`` and ``QuantizedLinear`` leaves slice as in
    ``index_tree``."""
    def cut(t):
        if isinstance(t, dict):
            parts = {k: cut(v) for k, v in t.items()}
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        if isinstance(t, torch.Tensor):
            return list(torch.unbind(t))
        return [index_tree(t, i) for i in range(n)]
    return cut(tree)


def apply_stack(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                positions: torch.Tensor, remat: str = "none",
                q_chunk: int = 512,
                mrope_positions: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the full stack over x (B,S,D); ``frames`` (B, S_f, D) feed the
    encoder of an encoder-decoder, whose decoder then runs over x;
    ``mrope_positions`` (3,B,S) reach every attention layer of a dense or
    MoE stack (only ``rope="mrope"`` reads them).
    ``remat`` (``none`` / ``dots`` / ``full``) wraps each layer as the
    reference's ``_remat`` does (``_remat`` here)."""
    if cfg.encoder_decoder:
        memory = encode(p, cfg, frames, remat=remat, q_chunk=q_chunk)
        layer = _layer(apply_whisper_dec_layer, "decoder", remat)
        for lp in layer_trees(p["decoder"], cfg.n_layers):
            x = layer(lp, cfg, x, memory=memory, positions=positions,
                      q_chunk=q_chunk)
        return x
    if cfg.ssm.enabled:
        layer = _layer(apply_ssm_layer, "layers", remat)
        for lp in layer_trees(p["layers"], cfg.n_layers):
            x = layer(lp, cfg, x)
        return x
    if cfg.rglru.enabled:
        n_groups, n_trail = griffin_layout(cfg)
        group = _layer(apply_griffin_group, "groups", remat)
        for lp in layer_trees(p["groups"], n_groups):
            x = group(lp, cfg, x, positions=positions, q_chunk=q_chunk)
        if n_trail:
            layer = _layer(apply_rec_layer, "trailing", remat)
            for lp in layer_trees(p["trailing"], n_trail):
                x = layer(lp, cfg, x)
        return x
    if cfg.moe.enabled:
        n_dense, n_moe = _moe_layout(cfg)
        if n_dense:
            dense = _layer(apply_dense_layer, "dense_layers", remat)
            for lp in layer_trees(p["dense_layers"], n_dense):
                x = dense(lp, cfg, x, positions=positions, q_chunk=q_chunk,
                          mrope_positions=mrope_positions)
        layer = _layer(apply_moe_layer, "layers", remat)
        for lp in layer_trees(p["layers"], n_moe):
            x = layer(lp, cfg, x, positions=positions, q_chunk=q_chunk,
                      mrope_positions=mrope_positions)
        return x
    # the reference's scan over layers
    dense = _layer(apply_dense_layer, "layers", remat)
    for lp in layer_trees(p["layers"], cfg.n_layers):
        x = dense(lp, cfg, x, positions=positions, window=cfg.window,
                  q_chunk=q_chunk, mrope_positions=mrope_positions)
    return x


# ---------------------------------------------------------------------------
# The Whisper encoder-decoder
# ---------------------------------------------------------------------------

def init_whisper_dec_layer(cfg: ArchConfig, gen: torch.Generator,
                           dtype=torch.bfloat16, lead=()) -> Params:
    return {
        "ln1": init_norm(cfg, cfg.d_model, gen.device, lead),
        "attn": attention.init_attention(cfg, gen, dtype, lead),
        "lnx": init_norm(cfg, cfg.d_model, gen.device, lead),
        "xattn": attention.init_attention(cfg, gen, dtype, lead, cross=True),
        "ln2": init_norm(cfg, cfg.d_model, gen.device, lead),
        "mlp": init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype, lead),
    }


def apply_whisper_dec_layer(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                            memory: torch.Tensor, positions: torch.Tensor,
                            q_chunk: int = 512) -> torch.Tensor:
    """Causal self-attention, cross-attention to ``memory`` (the encoder's
    output, (B, S_f, D)) and the MLP, each behind its norm."""
    h = apply_norm(p["ln1"], cfg, x)
    x = x + attention.attention_forward(p["attn"], cfg, h,
                                        positions=positions, causal=True,
                                        q_chunk=q_chunk)
    h = apply_norm(p["lnx"], cfg, x)
    x = x + attention.attention_forward(p["xattn"], cfg, h,
                                        positions=positions, causal=False,
                                        kv_x=memory, q_chunk=q_chunk)
    h = apply_norm(p["ln2"], cfg, x)
    return x + apply_mlp(p["mlp"], cfg, h)


def encode(p: Params, cfg: ArchConfig, frames: torch.Tensor, *,
           remat: str = "none", q_chunk: int = 512) -> torch.Tensor:
    """The encoder over precomputed frame embeddings (B, S_f, D) (the
    conv front end is a stub, as in the reference) plus sinusoidal
    positions; each layer under ``remat`` as ``apply_stack``'s."""
    b, s, d = frames.shape
    x = frames + sinusoidal_positions(s, d, frames.device).to(
        frames.dtype)[None]
    positions = torch.arange(s, device=frames.device)[None].expand(b, s)
    layer = _layer(_enc_layer, "encoder", remat)
    for lp in layer_trees(p["encoder"], cfg.n_layers):
        x = layer(lp, cfg, x, positions, q_chunk)
    return x


def _enc_layer(lp: Params, cfg: ArchConfig, h: torch.Tensor,
               positions: torch.Tensor, q_chunk: int = 512) -> torch.Tensor:
    """Encoder layer: bidirectional self-attention + MLP."""
    y = apply_norm(lp["ln1"], cfg, h)
    h = h + attention.attention_forward(lp["attn"], cfg, y,
                                        positions=positions, causal=False,
                                        q_chunk=q_chunk)
    y = apply_norm(lp["ln2"], cfg, h)
    return h + apply_mlp(lp["mlp"], cfg, y)


def _cross_decode(p: Params, cfg: ArchConfig, y: torch.Tensor,
                  mem_k: torch.Tensor, mem_v: torch.Tensor) -> torch.Tensor:
    """A decoder layer's cross-attention at one position: the
    reference's bare products on ``xattn``, unmasked over the memory; the
    memory meets q in their promoted dtype.  Under tensor parallelism on
    this rank's heads (``attention.rank_attention``, the memory's rows cut
    over the model axis under SP), ``wo`` row-parallel with the combine;
    heads that do not split run whole on every rank."""
    b = y.shape[0]
    kvh, g, hd = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    tp = partition.tensor_parallel()
    if tp is None:
        q = (y @ p["wq"]).reshape(b, 1, kvh, g, hd)
        dt = torch.promote_types(q.dtype, mem_k.dtype)
        o = attention.dense_attention(q.to(dt), mem_k.to(dt), mem_v.to(dt),
                                      None)
        return o.reshape(b, 1, -1) @ p["wo"]
    split = attention.heads_split(cfg, tp)
    wq, wo = ((p["wq"], p["wo"]) if split else
              (partition.model_replicated(p, "wq", tp),
               partition.model_replicated(p, "wo", tp)))
    q = (y @ wq).reshape(b, 1, -1, hd)
    dt = torch.promote_types(q.dtype, mem_k.dtype)
    o = attention.rank_attention(q.to(dt), mem_k.to(dt), mem_v.to(dt), None,
                                 cfg, tp)
    out = o @ wo
    if not split:
        return out
    return collectives.from_model(out, ReduceConfig("model", tp.size),
                                  tp.group)


def _whisper_dec_step(lp: Params, cfg: ArchConfig, x: torch.Tensor,
                      cache: Params, mem_k: torch.Tensor, mem_v: torch.Tensor,
                      pos: torch.Tensor, active: Optional[torch.Tensor],
                      i: int) -> torch.Tensor:
    """One decoder layer at one position (``_decode_whisper``)."""
    h = x
    y = apply_norm(lp["ln1"], cfg, h)
    o, _ = attention.decode_step(lp["attn"], cfg, y, cache, pos,
                                 active=active)
    h = h + o
    y = apply_norm(lp["lnx"], cfg, h)
    h = h + _cross_decode(lp["xattn"], cfg, y, mem_k, mem_v)
    if h.dtype != x.dtype:
        raise TypeError(
            f"{cfg.name}: decoder layer {i} turns a {x.dtype} residual "
            f"stream into {h.dtype} (cross-attention memory "
            f"{mem_k.dtype}); the reference's scan over the decoder "
            f"layers refuses a carry whose dtype changes")
    y = apply_norm(lp["ln2"], cfg, h)
    return h + apply_mlp(lp["mlp"], cfg, y)


def _decode_whisper(p: Params, cfg: ArchConfig, x: torch.Tensor,
                    state: Params, pos: torch.Tensor,
                    active: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, Params]:
    """One token through the decoder layers: self-attention on the
    ``self`` caches (in place at the ``active`` rows), then
    cross-attention to the ``memory`` k / v of the layer, unmasked, with
    the reference's bare products on ``xattn`` (no ``ops`` site: a
    planned leaf takes its dense route, ``PlannedWeight.__rmatmul__``; a
    ``QuantizedLinear`` raises ``TypeError``, as the reference's does),
    then the MLP.  The memory meets q in their promoted dtype, as JAX's
    einsum promotes them.

    The reference scans the layers with the residual stream as the carry,
    and a scan refuses a carry whose dtype changes (an int8 plan's
    dequantized float32 weight promotes bf16 activations): the same
    raises ``TypeError`` here."""
    caches, mem = state["self"], state["memory"]
    layer = _layer(_whisper_dec_step, "decoder", "none")
    for i in range(cfg.n_layers):
        cache = {"k": caches["k"][i], "v": caches["v"][i]}
        x = layer(index_tree(p["decoder"], i), cfg, x, cache, mem["k"][i],
                  mem["v"][i], pos, active, i)
    return x, state


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device="cpu") -> Params:
    """Stacked per-layer KV caches, (L, B, S, KVH, hd); a MoE stack's are
    split as its weights are (``layers``, ``dense_layers``).  A Griffin
    stack's ``groups`` hold an RG-LRU state ({h, conv}, (G, B, ...)) per
    recurrent block and a rolling cache per attention block, its
    ``trailing`` the recurrent layers' states.  An SSM stack's ``layers``
    hold {ssm (L, B, H, P, N) float32, conv (L, B, K-1, C) float32} (the
    reference gives its SSM state no other dtype); an encoder-decoder's
    ``self`` the decoder's caches and ``memory`` a zero k / v of the
    cross-attention per layer, (L, B, S, KVH, hd), which no decode path
    fills (as in the reference)."""
    if cfg.encoder_decoder:
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return {
            "self": attention.init_cache(cfg, batch, max_seq, dtype, device,
                                         (cfg.n_layers,)),
            "memory": {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)},
        }
    if cfg.ssm.enabled:
        return {"layers": ssm_mod.init_ssm_state(cfg, batch, device=device,
                                                 lead=(cfg.n_layers,))}
    if cfg.rglru.enabled:
        n_groups, n_trail = griffin_layout(cfg)
        group = {}
        for i, kind in enumerate(cfg.rglru.block_pattern):
            group[f"b{i}_{kind}"] = (
                rglru.init_rglru_state(cfg, batch, dtype, device,
                                       (n_groups,))
                if kind == "rec" else
                attention.init_cache(cfg, batch, max_seq, dtype, device,
                                     (n_groups,)))
        st = {"groups": group}
        if n_trail:
            st["trailing"] = rglru.init_rglru_state(cfg, batch, dtype,
                                                    device, (n_trail,))
        return st
    if cfg.moe.enabled:
        n_dense, n_moe = _moe_layout(cfg)
        st = {"layers": attention.init_cache(cfg, batch, max_seq, dtype,
                                             device, (n_moe,))}
        if n_dense:
            st["dense_layers"] = attention.init_cache(
                cfg, batch, max_seq, dtype, device, (n_dense,))
        return st
    return {"layers": attention.init_cache(cfg, batch, max_seq, dtype,
                                           device, (cfg.n_layers,))}


def decode_stack(p: Params, cfg: ArchConfig, x: torch.Tensor, state: Params,
                 pos: torch.Tensor, active: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Params]:
    """One-token step through the stack.  x (B,1,D); ``pos`` (B,).  Each
    layer's cache is a view of the stacked state, updated in place at the
    ``active`` rows.  On local shards (``sharding.partition.use_rules``
    with specs) each layer gathers its FSDP shards first and runs on this
    rank's heads, channels and cache shard (``attention``, ``ssm``,
    ``rglru``, ``moe.apply_moe_rows``).  A MoE stack runs its dense
    layers, then its MoE layers, whose routing takes every row of the
    batch; a Griffin stack its groups, then its trailing recurrent
    layers; an SSM stack its SSD blocks; an encoder-decoder its decoder
    layers (``_decode_whisper``)."""
    if cfg.encoder_decoder:
        return _decode_whisper(p, cfg, x, state, pos, active)
    if cfg.ssm.enabled:
        layer = _layer(decode_ssm_layer, "layers", "none")
        for i in range(cfg.n_layers):
            x, _ = layer(index_tree(p["layers"], i), cfg, x,
                         index_tree(state["layers"], i), active=active)
        return x, state
    if cfg.rglru.enabled:
        n_groups, n_trail = griffin_layout(cfg)
        group = _layer(decode_griffin_group, "groups", "none")
        for i in range(n_groups):
            x, _ = group(index_tree(p["groups"], i), cfg, x,
                         index_tree(state["groups"], i), pos, active=active)
        if n_trail:
            rec = _layer(decode_rec_layer, "trailing", "none")
            for i in range(n_trail):
                x, _ = rec(index_tree(p["trailing"], i), cfg, x,
                           index_tree(state["trailing"], i), active=active)
        return x, state
    if cfg.moe.enabled:
        n_dense, n_moe = _moe_layout(cfg)
        if n_dense:
            caches = state["dense_layers"]
            dense = _layer(decode_dense_layer, "dense_layers", "none")
            for i in range(n_dense):
                cache = {"k": caches["k"][i], "v": caches["v"][i]}
                x, _ = dense(index_tree(p["dense_layers"], i), cfg, x, cache,
                             pos, active=active)
        caches = state["layers"]
        layer = _layer(decode_moe_layer, "layers", "none")
        for i in range(n_moe):
            cache = {"k": caches["k"][i], "v": caches["v"][i]}
            x, _ = layer(index_tree(p["layers"], i), cfg, x, cache, pos,
                         active=active)
        return x, state
    layers, caches = p["layers"], state["layers"]
    dense = _layer(decode_dense_layer, "layers", "none")
    for i in range(cfg.n_layers):
        cache = {"k": caches["k"][i], "v": caches["v"][i]}
        x, _ = dense(index_tree(layers, i), cfg, x, cache, pos,
                     active=active, window=cfg.window)
    return x, state


def decode_stack_window(p: Params, cfg: ArchConfig, x: torch.Tensor,
                        state: Params, pos: torch.Tensor,
                        active: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Params]:
    """W-token decode through a plain dense stack with full-length caches
    (the scorer of ``model.verify_window``).  x (B, W, D); ``pos`` (B,)
    the position of each row's first window token; the caches are written
    in place at the ``active`` rows.  The norms run per position
    (``apply_norm_per_position``) and attention per query
    (``attention.decode_window``), at a decode step's shapes."""
    if (cfg.moe.enabled or cfg.ssm.enabled or cfg.rglru.enabled
            or cfg.encoder_decoder or cfg.window):
        raise ValueError(
            "decode_stack_window: plain dense full-cache stacks only")
    layers, caches = p["layers"], state["layers"]
    for i in range(cfg.n_layers):
        lp = index_tree(layers, i)
        cache = {"k": caches["k"][i], "v": caches["v"][i]}
        h = apply_norm_per_position(lp["ln1"], cfg, x)
        o, _ = attention.decode_window(lp["attn"], cfg, h, cache, pos,
                                       active=active)
        x = x + o
        h = apply_norm_per_position(lp["ln2"], cfg, x)
        x = x + apply_mlp(lp["mlp"], cfg, h)
    return x, state
