"""Top-level model API: init, the training loss (``train_loss``), the
full-sequence prompt pass (``prefill``,
and ``prefill_with_cache``, which also fills the decode state), one decode
step, per-row token sampling (``sample_tokens``), the fused decode block
(``decode_many``), the self-speculative block (``verify_window``,
``verify_block``) and slot prefill (``prefill_into_slot``).

State is a nested dict of stacked caches ((L, B, ...), batch at axis 1),
updated in place; params are nested dicts in the reference's tree layout
(``embed``, ``stack.layers.{ln1,attn,ln2,mlp}``, ``final_norm``,
``lm_head``; a MoE stack has ``stack.layers.{ln1,attn,ln2,moe}`` and
``stack.dense_layers``, and its state the same two groups; a Griffin
stack has ``stack.groups.b{i}_{kind}`` and ``stack.trailing``, and its
state the same; an SSM stack ``stack.layers.{ln1,ssm}``; an
encoder-decoder ``stack.encoder`` and ``stack.decoder``, its state
``self`` and ``memory``).

An encoder-decoder's prompt batch carries ``frames`` (B, S_f, D), the
precomputed frame embeddings its encoder reads (the conv front end is a
stub, as in the reference), beside the decoder's ``tokens``.  A vision
config's (``frontend == "vision"``) may carry ``vis_embeds`` (B, n_vis,
D), precomputed patch embeddings that overwrite the leading positions
(the vision tower is a stub, as in the reference), and
``mrope_positions`` (3, B, S), the t/h/w position streams M-RoPE reads."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sparsity import iter_leaves
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import prng, transformer
from repro_torch.sharding import partition
from repro_torch.models.layers import (apply_norm, apply_norm_per_position,
                                       chunked_softmax_xent, embed,
                                       init_embedding, init_norm, logits_head)

Params = Dict[str, torch.Tensor]

_BIG_BUDGET = (2 ** 31 - 1) // 2

N_VIS_STUB = 1024       # patch-embedding prefix length of a vision config


def n_vis(cfg: ArchConfig, seq_len: int) -> int:
    """The length of the ``vis_embeds`` prefix the data pipeline attaches
    to a vision config's batch of ``seq_len`` tokens (the reference's
    ``n_vis``): ``N_VIS_STUB`` rows, at most a quarter of the sequence;
    0 for any other config."""
    if cfg.frontend != "vision":
        return 0
    return min(N_VIS_STUB, seq_len // 4)


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, dtype=torch.bfloat16, device="cuda") -> Params:
    """Random parameters with the reference's distributions, drawn on
    ``device`` from ``generator`` (default: a new one seeded with 0)."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    elif gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    return _init_tree(cfg, gen, dtype)


def _init_tree(cfg: ArchConfig, gen, dtype) -> Params:
    p: Params = {
        "embed": init_embedding(cfg, gen, dtype),
        "stack": transformer.init_stack(cfg, gen, dtype),
        "final_norm": init_norm(cfg, cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_embedding(cfg, gen, dtype)
    return p


class _MetaDraws:
    """Stands in for a generator: ``layers.normal`` draws nothing on it."""
    device = torch.device("meta")


def param_shapes(cfg: ArchConfig, *, dtype=torch.bfloat16) -> Params:
    """The parameter tree of ``init_params`` as meta tensors: shapes and
    dtypes at any width, no storage (the partition rules resolve on it)."""
    return _init_tree(cfg, _MetaDraws(), dtype)


def head_matrix(p: Params, cfg: ArchConfig):
    """The (V, D) logits matrix — ``embed`` when tied, else ``lm_head``
    (a ``PlannedWeight`` under an attached plan)."""
    return p["embed"] if cfg.tie_embeddings else p["lm_head"]


def _on_params_device(p: Params, t, name: str, ndim: int) -> torch.Tensor:
    dev = p["embed"].device
    if not isinstance(t, torch.Tensor) or t.dim() != ndim:
        raise TypeError(f"batch[{name!r}] must be a {ndim}-D torch tensor")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, params on {dev}")
    return t


def _prompt_tokens(p: Params, cfg: ArchConfig, batch) -> torch.Tensor:
    """The (B, S) token tensor of a prompt batch, on the params' device.
    Vision inputs on a config without the vision frontend raise, as do
    ``frames`` on a config without an encoder (it takes token input
    only)."""
    _refuse_foreign_inputs(cfg, batch)
    return _on_params_device(p, batch["tokens"], "tokens", 2)


def _refuse_foreign_inputs(cfg: ArchConfig, batch) -> None:
    if ((cfg.frontend != "vision"
         and ("vis_embeds" in batch or "mrope_positions" in batch))
            or ("frames" in batch and not cfg.encoder_decoder)):
        raise NotImplementedError(
            f"{cfg.name}: takes token input only (vision inputs need "
            f"frontend='vision', frames an encoder-decoder)")


def _vision_inputs(p: Params, cfg: ArchConfig, batch, x: torch.Tensor):
    """x (B, S, D) with a vision config's ``vis_embeds`` written over its
    leading positions (out of place: autograd sees a concatenation), and
    the batch's ``mrope_positions`` (3, B, S) or None."""
    mrope = batch.get("mrope_positions")
    if mrope is not None:
        mrope = _on_params_device(p, mrope, "mrope_positions", 3)
        if mrope.shape[0] != 3 or mrope.shape[1:] != x.shape[:2]:
            raise ValueError(f"mrope_positions {tuple(mrope.shape)}, want "
                             f"(3, {x.shape[0]}, {x.shape[1]})")
    if "vis_embeds" not in batch:
        return x, mrope
    vis = _on_params_device(p, batch["vis_embeds"], "vis_embeds", 3)
    b, s, d = x.shape
    if vis.shape[0] != b or vis.shape[2] != d or vis.shape[1] > s:
        raise ValueError(f"vis_embeds {tuple(vis.shape)} do not fit a "
                         f"prefix of ({b}, {s}, {d})")
    return torch.cat([vis.to(x.dtype), x[:, vis.shape[1]:]], dim=1), mrope


def _frames(p: Params, cfg: ArchConfig, batch) -> torch.Tensor:
    """An encoder-decoder's (B, S_f, D) frame embeddings, on the params'
    device."""
    if "frames" not in batch:
        raise ValueError(f"{cfg.name}: an encoder-decoder's batch needs "
                         f"'frames' (B, S_f, {cfg.d_model})")
    return _on_params_device(p, batch["frames"], "frames", 3)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None].expand(b, s)


def forward_hidden(p: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                   *, remat: str = "none", q_chunk: int = 512
                   ) -> torch.Tensor:
    """Token inputs (with an encoder-decoder's ``frames``, or a vision
    config's ``vis_embeds`` and ``mrope_positions``) → final-norm hidden
    states (B, S, D).  On local shards (``sharding.partition.use_rules``
    with specs) the embedding's and the final norm's FSDP shards are
    gathered first."""
    return _forward_hidden(partition.gather_top(p), cfg, batch, remat=remat,
                           q_chunk=q_chunk)


def _forward_hidden(p: Params, cfg: ArchConfig, batch, *, remat: str,
                    q_chunk: int) -> torch.Tensor:
    tokens = _prompt_tokens(p, cfg, batch)
    frames = _frames(p, cfg, batch) if cfg.encoder_decoder else None
    x = embed(cfg, p["embed"], tokens)
    x, mrope = _vision_inputs(p, cfg, batch, x)
    x = transformer.apply_stack(p["stack"], cfg, x,
                                positions=_positions(tokens), remat=remat,
                                q_chunk=q_chunk, mrope_positions=mrope,
                                frames=frames)
    return apply_norm(p["final_norm"], cfg, x)


def train_loss(p: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
               *, remat: str = "none", loss_chunk: int = 512,
               q_chunk: int = 512) -> torch.Tensor:
    """The training objective: ``forward_hidden`` then the chunked
    cross-entropy against ``batch["labels"]`` (B, S) under the head
    (``embed`` when tied); a float32 scalar."""
    p = partition.gather_top(p)
    x = _forward_hidden(p, cfg, batch, remat=remat, q_chunk=q_chunk)
    labels = _on_params_device(p, batch["labels"], "labels", 2)
    return chunked_softmax_xent(cfg, head_matrix(p, cfg), x, labels,
                                chunk=loss_chunk)


def prefill(p: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            q_chunk: int = 512) -> torch.Tensor:
    """Prompt pass returning the last position's logits (B, 1, V) float32.
    ``batch["tokens"]`` (B, S) lies on the params' device.

    For an encoder-decoder it is the encoder pass over ``batch["frames"]``
    and returns the encoder's last hidden (B, 1, D), as the reference's
    does (its ``prefill_32k`` cell lowers the encoder)."""
    if cfg.encoder_decoder:
        _refuse_foreign_inputs(cfg, batch)
        mem = transformer.encode(p["stack"], cfg, _frames(p, cfg, batch),
                                 q_chunk=q_chunk)
        return mem[:, -1:, :]
    p = partition.gather_top(p)
    x = _forward_hidden(p, cfg, batch, remat="none", q_chunk=q_chunk)
    return logits_head(cfg, head_matrix(p, cfg), x[:, -1:, :])


def prefill_with_cache(p: Params, cfg: ArchConfig,
                       batch: Dict[str, torch.Tensor], max_seq: int, *,
                       dtype=torch.bfloat16) -> Tuple[torch.Tensor, Params]:
    """Prompt pass that also fills the decode state (dense stacks): returns
    the last position's logits (B, 1, V) and a state in the layout of
    ``init_decode_state(cfg, B, max_seq, dtype)`` holding every layer's
    post-RoPE k and raw v at positions 0..S-1 (zeros after), so
    ``decode_many`` continues from it at position S."""
    transformer._check_dense(cfg)
    tokens = _prompt_tokens(p, cfg, batch)
    b, s = tokens.shape
    state = transformer.init_decode_state(cfg, b, max_seq, dtype,
                                          tokens.device)
    if s > state["layers"]["k"].shape[2]:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of "
                         f"{state['layers']['k'].shape[2]} positions")
    positions = _positions(tokens)
    x = embed(cfg, p["embed"], tokens)
    layers = p["stack"]["layers"]
    for i in range(cfg.n_layers):
        x, (k, v) = transformer.apply_dense_layer(
            transformer.index_tree(layers, i), cfg, x, positions=positions,
            window=cfg.window, return_kv=True)
        state["layers"]["k"][i, :, :s] = k
        state["layers"]["v"][i, :, :s] = v
    x = apply_norm(p["final_norm"], cfg, x)
    return logits_head(cfg, head_matrix(p, cfg), x[:, -1:, :]), state


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device="cuda") -> Params:
    return transformer.init_decode_state(cfg, batch, max_seq, dtype,
                                         resolve_device(device))


def decode_step(p: Params, cfg: ArchConfig, tokens: torch.Tensor,
                state: Params, pos: torch.Tensor,
                active: Optional[torch.Tensor] = None, *,
                with_logits: bool = True
                ) -> Tuple[Optional[torch.Tensor], Params]:
    """One new token per sequence.  tokens (B, 1), ``pos`` (B,) → logits
    (B, 1, V) float32.  The state is updated in place at the ``active``
    rows (all rows when None).  ``with_logits=False`` skips the head (the
    prefill feed discards it).

    On local shards (``sharding.partition.use_rules`` with specs, as
    ``serve.engine.build_serve_step`` installs them) the step runs on this
    rank's batch rows, heads, channels and cache shards; the logits are
    every vocabulary entry's and the state stays in its shards."""
    p = partition.gather_top(p)
    x = embed(cfg, p["embed"], tokens)
    x, state = transformer.decode_stack(p["stack"], cfg, x, state, pos,
                                        active)
    if not with_logits:
        return None, state
    x = apply_norm(p["final_norm"], cfg, x)
    return logits_head(cfg, head_matrix(p, cfg), x), state


def masked_decode_step(p: Params, cfg: ArchConfig, tokens: torch.Tensor,
                       state: Params, pos: torch.Tensor,
                       active: torch.Tensor, *, with_logits: bool = True
                       ) -> Tuple[Optional[torch.Tensor], Params]:
    """``decode_step`` that commits state only for ``active`` (B,) rows.

    The reference selects old-vs-new over the whole state after the step
    (model.py ``masked_decode_step``); here only the active rows are
    written, in place — the committed state is equal.  ``active`` is also
    the popcount row filter (``ops.active_rows``), so runtime activation
    densities count live rows only."""
    with ops.active_rows(active):
        return decode_step(p, cfg, tokens, state, pos, active,
                           with_logits=with_logits)


def sample_tokens(logits: torch.Tensor, temp: torch.Tensor,
                  top_k: torch.Tensor, seeds: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """Per-row temperature / top-k sampling over (B, V) logits → (B,)
    int32.

    ``temp`` (B,) float: 0 is greedy argmax for that row (bit-equal to the
    plain argmax).  ``top_k`` (B,): keep the logits at or above the k-th
    largest (ties at the threshold stay live; 0 or >= V disables).  Row r
    at position p draws Gumbel noise from ``fold_in(PRNGKey(seeds[r]), p)``
    (``models.prng``, JAX's threefry), so a sampled stream is a pure
    function of (seed, position): a T-step block samples what T ``step()``
    calls sample.  ``argmax`` takes the first maximum."""
    v = logits.shape[-1]
    lg = logits.float()
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    k = top_k.to(torch.int64).clamp(1, v)
    top_desc = torch.sort(lg, dim=-1, descending=True).values
    thresh = torch.gather(top_desc, -1, (k - 1)[:, None])
    use_k = (top_k > 0) & (top_k < v)
    masked = torch.where(use_k[:, None] & (lg < thresh), -torch.inf, lg)
    keys = prng.fold_in(prng.PRNGKey(seeds), pos)
    noise = prng.gumbel(keys, v)
    scaled = masked / torch.clamp_min(temp.float(), 1e-6)[:, None]
    sampled = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
    return torch.where(temp > 0, sampled, greedy)


# Row-stop sentinels of a ``decode_many`` token block: -1 is a benign stop
# (EOS hit or budget drained), QUARANTINE_SENTINEL a row whose logits went
# non-finite under ``nan_guard``.  Both sit below every token id.
QUARANTINE_SENTINEL = -2


def decode_many(p: Params, cfg: ArchConfig, tokens: torch.Tensor,
                state: Params, pos: torch.Tensor, live: torch.Tensor,
                n_steps: int, *, rem: Optional[torch.Tensor] = None,
                eos_id: Optional[int] = None,
                temp: Optional[torch.Tensor] = None,
                top_k: Optional[torch.Tensor] = None,
                seeds: Optional[torch.Tensor] = None,
                nan_guard: bool = False):
    """Fused decode: ``n_steps`` decode steps with on-device token
    selection feeding the next token, the stop logic on the device and no
    host sync inside the loop.

    ``tokens`` / ``pos`` (B,) are each row's current input token and
    position, ``live`` (B,) which rows decode, ``rem`` (B,) each row's
    remaining budget (None = unbounded); emitting ``eos_id`` zeroes a
    row's budget.  Inactive rows feed token 0, commit no state, keep their
    carries and emit -1.  ``temp`` / ``top_k`` / ``seeds`` (all (B,), or
    all None for greedy) select per-row sampling (``sample_tokens``, keyed
    by each step's position).

    ``nan_guard`` quarantines a row whose logits go non-finite: at that
    step it emits ``QUARANTINE_SENTINEL``, its budget drops to 0 and its
    token / position carries stay at the last healthy step; every other
    row is unchanged.

    Returns (token block (T, B) int32, state, token carry, position carry,
    budget carry)."""
    live = live.to(torch.bool)
    b = tokens.shape[0]
    dev = tokens.device
    if rem is None:
        rem = torch.full((b,), _BIG_BUDGET, dtype=torch.int32, device=dev)
    tok = tokens.to(torch.int32)
    ps = pos.to(torch.int32)
    rm = rem.to(torch.int32)
    eos = -1 if eos_id is None else int(eos_id)
    emits = []
    for _ in range(n_steps):
        active = live & (rm > 0)
        feed = torch.where(active, tok, 0)[:, None]
        logits, state = masked_decode_step(p, cfg, feed.long(), state,
                                           ps.long(), active)
        lg = logits[:, 0, :]
        if temp is not None:
            nxt = sample_tokens(lg, temp, top_k, seeds, ps)
        else:
            nxt = torch.argmax(lg, dim=-1).to(torch.int32)
        step_rm = torch.where(nxt == eos, 0, rm - 1)
        if nan_guard:
            bad = active & ~torch.isfinite(lg).all(dim=-1)
            good = active & ~bad
            emits.append(torch.where(bad, QUARANTINE_SENTINEL,
                                     torch.where(active, nxt, -1)))
            rm = torch.where(bad, 0, torch.where(active, step_rm, rm))
        else:
            good = active
            emits.append(torch.where(active, nxt, -1))
            rm = torch.where(active, step_rm, rm)
        tok = torch.where(good, nxt, tok)
        ps = torch.where(good, ps + 1, ps)
    toks = torch.stack(emits) if emits else torch.empty(
        (0, b), dtype=torch.int32, device=dev)
    return toks, state, tok, ps, rm


def verify_window(p: Params, cfg: ArchConfig, tokens: torch.Tensor,
                  state: Params, pos: torch.Tensor, active: torch.Tensor
                  ) -> Tuple[torch.Tensor, Params]:
    """Score W consecutive tokens per row in one pass.  tokens (B, W);
    ``pos`` (B,) the position of each row's first; ``active`` (B,) the rows
    whose K/V is written (in place, for all W positions; the other rows
    keep their state).  Returns logits (B, W, V) float32 and the state.

    Window position i gives the logits of a ``masked_decode_step`` at
    pos + i from the state holding the window's first i tokens, bit for
    bit: every matmul site runs its rows in the kernels' decode regime
    (``ops.decode_rows``), norms and attention at a decode step's shapes
    (``transformer.decode_stack_window``).  K/V written past what the
    caller accepts is never read: a query masks every position above its
    own, and the next block writes each position before reading it.
    Plain dense full-cache stacks only."""
    x = embed(cfg, p["embed"], tokens)
    with ops.active_rows(active), ops.decode_rows():
        x, state = transformer.decode_stack_window(p["stack"], cfg, x,
                                                   state, pos, active)
        x = apply_norm_per_position(p["final_norm"], cfg, x)
        return logits_head(cfg, head_matrix(p, cfg), x), state


def verify_block(p_full: Params, p_draft: Params, cfg: ArchConfig,
                 tokens: torch.Tensor, state: Params, pos: torch.Tensor,
                 live: torch.Tensor, k: int, *,
                 rem: Optional[torch.Tensor] = None,
                 eos_id: Optional[int] = None,
                 temp: Optional[torch.Tensor] = None,
                 top_k: Optional[torch.Tensor] = None,
                 seeds: Optional[torch.Tensor] = None,
                 windowed: bool = True, nan_guard: bool = False):
    """Self-speculative block: draft ``k`` tokens with ``p_draft`` (a
    pruned plan tier), score all k + 1 positions with ``p_full`` and keep
    the longest prefix it confirms.  Arguments and return contract are
    ``decode_many``'s with T = k + 1: a (k+1, B) token block with -1 after
    each row's first rejection (the rejected position emits the full
    plan's own token), the state, and the token / position / budget
    carries.

    The emitted stream is the full plan's: position i feeds what the full
    plan's decode would have fed while every earlier draft matched.
    Sampled rows draw position-keyed noise (``sample_tokens``), so a draft
    and the full plan choose by the same rule and acceptance is token
    equality.  ``nan_guard`` acts on the full plan's logits, as in
    ``decode_many``; the draft runs unguarded (its tokens are proposals).

    The draft writes K/V at positions pos .. pos+k-1 of its live rows in
    place; those k positions of every row are saved first and put back
    after it, so the draft leaves no trace.  The full plan then scores
    with ``windowed=True`` one ``verify_window`` over the rows that are
    live with budget left, or with ``windowed=False`` k + 1 masked decode
    steps that commit only rows still matching — the sequential scorer."""
    live = live.to(torch.bool)
    b = tokens.shape[0]
    dev = tokens.device
    if rem is None:
        rem = torch.full((b,), _BIG_BUDGET, dtype=torch.int32, device=dev)
    eos = -1 if eos_id is None else int(eos_id)

    kv = state["layers"]
    rows = torch.arange(b, device=dev)[:, None]
    slots = torch.clamp(pos.long()[:, None]
                        + torch.arange(k, device=dev)[None],
                        max=kv["k"].shape[2] - 1)
    saved = {n: kv[n][:, rows, slots] for n in ("k", "v")}
    d_toks, state, *_ = decode_many(p_draft, cfg, tokens, state, pos, live,
                                    k, temp=temp, top_k=top_k, seeds=seeds)
    for n in ("k", "v"):
        kv[n][:, rows, slots] = saved[n]
    # the feed window: the current token, then the k proposals (dead rows
    # drafted -1 sentinels, which must not reach the embedding)
    tok = tokens.to(torch.int32)
    win = torch.cat([torch.where(live, tok, 0)[:, None],
                     torch.clamp_min(d_toks.t(), 0)], dim=1)
    ps = pos.to(torch.int32)
    rm = rem.to(torch.int32)
    active0 = live & (rm > 0)
    if windowed:
        feed = torch.where(active0[:, None], win, 0)
        logits, state = verify_window(p_full, cfg, feed.long(), state,
                                      ps.long(), active0)

    ok = live                       # prefix still matching
    emits = []
    for i in range(k + 1):
        act = ok & (rm > 0)
        if windowed:
            lg = logits[:, i, :]
        else:
            feed = torch.where(act, win[:, i], 0)[:, None]
            lg_i, state = masked_decode_step(p_full, cfg, feed.long(),
                                             state, ps.long(), act)
            lg = lg_i[:, 0, :]
        if temp is not None:
            nxt = sample_tokens(lg, temp, top_k, seeds, ps)
        else:
            nxt = torch.argmax(lg, dim=-1).to(torch.int32)
        step_rm = torch.where(nxt == eos, 0, rm - 1)
        if nan_guard:
            bad = act & ~torch.isfinite(lg).all(dim=-1)
            good = act & ~bad
            emits.append(torch.where(bad, QUARANTINE_SENTINEL,
                                     torch.where(act, nxt, -1)))
            rm = torch.where(bad, 0, torch.where(act, step_rm, rm))
        else:
            good = act
            emits.append(torch.where(act, nxt, -1))
            rm = torch.where(act, step_rm, rm)
        tok = torch.where(good, nxt, tok)
        ps = torch.where(good, ps + 1, ps)
        if i < k:
            ok = ok & (win[:, i + 1] == nxt)
            if nan_guard:
                ok = ok & ~bad
    return torch.stack(emits), state, tok, ps, rm


def prefill_into_slot(p: Params, cfg: ArchConfig, tokens, valid, slot,
                      state: Params, slot_pos: torch.Tensor, start=0,
                      reset=True) -> Params:
    """Feed one admitted prompt segment into batch row ``slot``.

    ``tokens`` (P,) is the segment, ``valid`` (P,) marks real positions,
    ``slot`` the row, ``start`` the sequence position of the segment's
    first token and ``reset`` whether the row is zero-reset first; each may
    be a host value or a tensor on ``slot_pos``'s device, so a captured
    feed reads them all from its input buffers.  ``slot_pos`` (B,) holds
    every slot's position; the other rows run as masked filler and keep
    their state.  All P positions run, each one masked decode step with the
    head skipped (its logits are discarded): a padding position commits
    nothing, so a segment padded to any length leaves the state as the
    unpadded one does, bit for bit."""
    b = slot_pos.shape[0]
    dev = slot_pos.device
    toks = torch.as_tensor(tokens, device=dev).reshape(-1)
    ok = torch.as_tensor(valid, device=dev).reshape(-1).to(torch.bool)
    onehot = torch.arange(b, device=dev) == torch.as_tensor(slot, device=dev)
    start = torch.as_tensor(start, device=dev).to(torch.int64)
    reset_row = onehot & torch.as_tensor(reset, device=dev).to(torch.bool)
    for _, leaf in iter_leaves(state):   # every leaf, at any depth
        leaf.masked_fill_(reset_row.view((1, b) + (1,) * (leaf.dim() - 2)),
                          0)
    other = slot_pos.to(torch.int64)
    for t in range(toks.shape[0]):
        merge = onehot & ok[t]
        feed = torch.where(merge, toks[t].to(torch.int64), 0)[:, None]
        ps = torch.where(onehot, start + t, other)
        _, state = masked_decode_step(p, cfg, feed, state, ps, merge,
                                      with_logits=False)
    return state


# ---------------------------------------------------------------------------
# Input specs (stand-ins for the dry-run: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape, *, device="meta",
                dtype=torch.bfloat16) -> Dict[str, object]:
    """Every model input of the (arch, shape) cell as empty tensors on
    ``device`` (default ``meta``: no storage), with the reference's shapes
    and dtypes: train {tokens, labels} (B, S) int32 (an encoder-decoder's
    ``frames`` (B, S, D), a vision config's ``vis_embeds`` (B, n_vis, D)
    and ``mrope_positions`` (3, B, S)); prefill {tokens} (an
    encoder-decoder's {frames} only); decode {tokens (B, 1) int32, the
    decode state of ``init_decode_state`` at seq_len positions, pos ()
    int32}."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def empty(*dims, dt=dtype):
        return torch.empty(dims, dtype=dt, device=device)

    if shape.kind == "decode":
        return {"tokens": empty(b, 1, dt=i32),
                "state": transformer.init_decode_state(cfg, b, s, dtype,
                                                       device),
                "pos": empty(dt=i32)}
    if shape.kind == "prefill" and cfg.encoder_decoder:
        return {"frames": empty(b, s, cfg.d_model)}
    specs = {"tokens": empty(b, s, dt=i32)}
    if shape.kind == "train":
        specs["labels"] = empty(b, s, dt=i32)
        if cfg.encoder_decoder:
            specs["frames"] = empty(b, s, cfg.d_model)
    if cfg.frontend == "vision":
        specs["vis_embeds"] = empty(b, n_vis(cfg, s), cfg.d_model)
        specs["mrope_positions"] = empty(3, b, s, dt=i32)
    return specs
