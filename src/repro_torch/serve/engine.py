"""Batched serving engine: slot-based continuous batching over the fused
decode block (the JAX package's ``serve/engine.py`` core).

A fixed decode batch of ``n_slots`` sequences; finished sequences free their
slot and queued requests (FIFO) are prefilled into it whole
(``models.model.prefill_into_slot``).  ``run_until_drained`` drives fused
greedy blocks (``models.model.decode_many``): per block the host does one
dispatch and one token-block sync, and per-row budgets / EOS stop each row
on the device.  ``step()`` is the per-token oracle — the fused block is
computation-identical to T of these steps.

An ``ExecConfig`` (``decode_exec_config``) is installed around every model
call, so every matmul site consults its ``SiteDescriptor``: dense sites run
the schedule-flexible kernels (``use_kernels``) and ``weight`` /
``two_sided`` sites the block-sparse kernel, with the precompiled
``WeightSparsityPlan`` attached into the params at bring-up.

``quantize`` serves int8 weights (``quant.quantize_params``): planned sites
run the scaled block-sparse kernel on the int8 payload, unplanned dense
sites the int8 matmul kernel (``use_kernels``) or, without kernels, the
weight dequantized to the activation dtype.
"""
from __future__ import annotations

import collections
import contextlib
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.scheduler import H100, TPU_V5E
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import model as model_lib
from repro_torch.quant.quantize import quantize_params


def shape_exec_config(cfg: ArchConfig, shape: ShapeConfig, *,
                      use_kernels: bool = False, params=None, hw=None,
                      quantize: bool = False,
                      device="cuda") -> ops.ExecConfig:
    """ExecConfig carrying the descriptor table for ``cfg`` at ``shape``
    (M = global_batch for a decode shape, global_batch · seq_len for a
    prefill or train shape), selected under ``hw`` — ``H100`` on CUDA and
    the reference's ``TPU_V5E`` on the CPU unless given.

    With ``params`` and a sparse config, the weight densities are measured,
    the table re-selected under them, and a ``WeightSparsityPlan`` compiled
    once at the final block granularity.

    ``quantize`` costs the table at int8 weight width and quantizes
    ``params`` before measuring and planning (quantization rounds tiny
    weights to 0, so the plan comes from the quantized tree — the one the
    engine, quantizing the same params deterministically, serves)."""
    from repro_torch.core.descriptors import (compile_network_schedule,
                                              sparsity_mode_for)
    from repro_torch.core.sparsity import (compile_weight_plan,
                                           measure_weight_densities)
    dev = resolve_device(device)
    if hw is None:
        hw = H100 if dev.type == "cuda" else TPU_V5E
    ns = compile_network_schedule(cfg, shape, hw=hw, quantize=quantize)
    if quantize and params is not None:
        params, _ = quantize_params(params,
                                    tie_embeddings=cfg.tie_embeddings)
    plan = None
    if params is not None and sparsity_mode_for(cfg) != "dense":
        measured = measure_weight_densities(params, ns)
        if measured:
            ns = compile_network_schedule(cfg, shape, hw=hw,
                                          wt_densities=measured,
                                          quantize=quantize)
            plan = compile_weight_plan(
                params, ns, ref_elem_bytes=2 if quantize else None)
    return ops.ExecConfig(use_kernels=use_kernels, schedules=ns, plan=plan,
                          quantize=quantize)


def decode_exec_config(cfg: ArchConfig, n_slots: int, **kw) -> ops.ExecConfig:
    """``shape_exec_config`` at the serving decode shape (one new token for
    each of ``n_slots`` slots: M = n_slots); keywords as there."""
    shape = ShapeConfig(name="serve_decode", kind="decode", seq_len=1,
                        global_batch=n_slots)
    return shape_exec_config(cfg, shape, **kw)


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                  # next position to write


class ServeEngine:
    """Continuous-batching engine over the fused decode block.

    ``fused`` selects the block loop in ``run_until_drained`` (False = the
    per-token ``step()`` oracle loop); ``decode_block`` caps the block
    length T.  ``params`` must already live on ``device``.

    ``quantize`` (implied by an exec config built with ``quantize=True``)
    serves the params int8-quantized: ``_serve_params`` holds the quantized
    tree, ``quant_stats`` its byte counts, and the plan attaches onto it.
    ``params`` keeps the original tree."""

    def __init__(self, cfg: ArchConfig, params, *, n_slots: int = 4,
                 max_seq: int = 256, dtype=torch.float32,
                 exec_cfg: Optional[ops.ExecConfig] = None,
                 fused: bool = True,
                 decode_block: int = 16, eos_id: Optional[int] = None,
                 quantize: bool = False, device="cuda"):
        self.device = resolve_device(device)
        leaf = params["embed"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, engine on "
                             f"{self.device}")
        self.cfg, self.params = cfg, params
        self.n_slots, self.max_seq = n_slots, max_seq
        self.exec_cfg = exec_cfg
        self.fused = fused
        self.decode_block = decode_block
        self.eos_id = eos_id
        self.state = model_lib.init_decode_state(cfg, n_slots, max_seq,
                                                 dtype=dtype,
                                                 device=self.device)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: Deque[Request] = collections.deque()
        self._uid = 0
        self._outputs: Dict[int, List[int]] = {}
        self._carry: Optional[tuple] = None
        self.quantize = bool(quantize) or bool(getattr(exec_cfg, "quantize",
                                                       False))
        if self.quantize:
            self._serve_params, self.quant_stats = quantize_params(
                params, tie_embeddings=cfg.tie_embeddings)
        else:
            self._serve_params, self.quant_stats = params, None
        self.plan = getattr(exec_cfg, "plan", None)
        self._exec_params = (self.plan.attach(self._serve_params)
                             if self.plan is not None
                             else self._serve_params)
        self.last_logits: Optional[torch.Tensor] = None

    @contextlib.contextmanager
    def _scope(self):
        if self.exec_cfg is None:
            yield
        else:
            with ops.exec_config(self.exec_cfg):
                yield

    # ---- requests ----
    def submit(self, prompt: np.ndarray, max_new: int = 16) -> int:
        """Queue a request; returns its uid.  Empty or non-1-D prompts and
        prompts needing more than ``max_seq`` positions are refused."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(
                f"prompt must be a non-empty 1-D token array, got shape "
                f"{prompt.shape}")
        if len(prompt) + 1 > self.max_seq:
            raise ValueError(
                f"prompt of {len(prompt)} tokens needs {len(prompt) + 1} "
                f"cache positions (prompt + first generated token) but "
                f"max_seq={self.max_seq}")
        self._uid += 1
        self.queue.append(Request(self._uid, prompt, max_new=max_new))
        return self._uid

    def _finish(self, req: Request) -> None:
        if req.done:
            return
        req.done = True
        self._outputs[req.uid] = req.out

    def results(self) -> Dict[int, List[int]]:
        """Output tokens of every finished request, by uid."""
        return dict(self._outputs)

    # ---- admission ----
    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s.req is None or s.req.done]

    def _slot_positions(self) -> np.ndarray:
        return np.asarray([s.pos for s in self.slots], np.int64)

    def _feed_prefill(self, i: int) -> None:
        """Prefill slot ``i`` with its prompt minus the last token (the
        first decode input), zero-resetting the row first."""
        s = self.slots[i]
        feed = np.asarray(s.req.prompt[:-1], np.int32)
        slot_pos = torch.as_tensor(self._slot_positions(), device=self.device)
        with self._scope(), torch.no_grad():
            model_lib.prefill_into_slot(
                self._exec_params, self.cfg, feed, np.ones(len(feed), bool),
                i, self.state, slot_pos, 0, True)
        s.pos = len(feed)

    def _admit(self) -> None:
        """Move queued requests (FIFO) into free slots, prefilling each
        whole prompt."""
        for i in self._free_slots():
            if not self.queue:
                break
            self.slots[i] = _Slot(req=self.queue.popleft(), pos=0)
            self._feed_prefill(i)

    # ---- decode ----
    def _live(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s.req is not None and not s.req.done]

    def _live_mask(self, live: List[int]) -> torch.Tensor:
        m = np.zeros((self.n_slots,), bool)
        m[list(live)] = True
        return torch.as_tensor(m, device=self.device)

    def _current_tokens(self, live: List[int]) -> np.ndarray:
        toks = np.zeros((self.n_slots,), np.int64)
        for i in live:
            s = self.slots[i]
            hist = list(s.req.prompt) + s.req.out
            toks[i] = hist[s.pos] if s.pos < len(hist) else hist[-1]
        return toks

    def _finish_check(self, s: _Slot) -> None:
        """Done on EOS, on budget exhaustion, or at the ``max_seq - 1``
        sequence wall."""
        r = s.req
        if (self.eos_id is not None and r.out and r.out[-1] == self.eos_id) \
                or len(r.out) >= r.max_new or s.pos >= self.max_seq - 1:
            self._finish(r)

    def _append_block(self, live: List[int], block: np.ndarray,
                      t_block: int) -> Dict[int, List[int]]:
        """Credit a synced (T, n_slots) token block, truncating each column
        at its -1 sentinel."""
        out: Dict[int, List[int]] = {}
        for i in live:
            s = self.slots[i]
            if s.req.done:
                continue
            toks = block[:t_block, i].tolist()
            if -1 in toks:
                toks = toks[:toks.index(-1)]
            s.req.out.extend(toks)
            s.pos += len(toks)
            out[s.req.uid] = toks
            self._finish_check(s)
        return out

    def step(self) -> Dict[int, int]:
        """One decode step for every live slot (the per-token oracle);
        returns {uid: new_token}.  The step's (n_slots, V) float32 logits
        stay in ``last_logits``."""
        self._admit()
        live = self._live()
        if not live:
            return {}
        toks = torch.as_tensor(self._current_tokens(live)[:, None],
                               device=self.device)
        pos = torch.as_tensor(self._slot_positions(), device=self.device)
        with self._scope(), torch.no_grad():
            logits, self.state = model_lib.masked_decode_step(
                self._exec_params, self.cfg, toks, self.state, pos,
                self._live_mask(live))
        self.last_logits = logits[:, 0, :]
        nxt = torch.argmax(self.last_logits, dim=-1).cpu().numpy()
        self._carry = None
        out: Dict[int, int] = {}
        for i in live:
            s = self.slots[i]
            s.req.out.append(int(nxt[i]))
            s.pos += 1
            out[s.req.uid] = int(nxt[i])
            self._finish_check(s)
        return out

    def _block_len(self, live: List[int], budget: int) -> int:
        """Block length: the largest live remaining budget (request budget
        and sequence room), clamped to [1, budget] and rounded down to a
        power of two (the reference's trace-count bound, kept so the two
        engines cut their blocks identically)."""
        rem = max(
            max(min(s.req.max_new - len(s.req.out),
                    (self.max_seq - 1) - s.pos), 1)
            for s in (self.slots[i] for i in live))
        t = max(1, min(rem, budget))
        return 1 << (t.bit_length() - 1)

    def _slot_budgets(self, live: List[int]) -> np.ndarray:
        rem = np.zeros((self.n_slots,), np.int32)
        for i in live:
            s = self.slots[i]
            rem[i] = max(min(s.req.max_new - len(s.req.out),
                             (self.max_seq - 1) - s.pos), 0)
        return rem

    def _live_key(self, live: List[int]) -> tuple:
        return tuple((i, self.slots[i].req.uid) for i in live)

    def _run_block(self, live: List[int], t_block: int) -> None:
        """Dispatch one fused block and credit it.  The next block starts
        from the device (token, pos, budget) carries while the live set is
        unchanged (keyed by (slot, uid)), else from host state."""
        key = self._live_key(live)
        if self._carry is not None and self._carry[0] == key:
            _, toks, pos, rem = self._carry
        else:
            dev = self.device
            toks = torch.as_tensor(self._current_tokens(live), device=dev)
            pos = torch.as_tensor(self._slot_positions(), device=dev)
            rem = torch.as_tensor(self._slot_budgets(live), device=dev)
        with self._scope(), torch.no_grad():
            block, self.state, toks, pos, rem = model_lib.decode_many(
                self._exec_params, self.cfg, toks, self.state, pos,
                self._live_mask(live), t_block, rem=rem, eos_id=self.eos_id)
        self._carry = (key, toks, pos, rem)
        self._append_block(live, block.cpu().numpy(), t_block)

    def _collect(self, results: Dict[int, List[int]]) -> None:
        for s in self.slots:
            if s.req is not None and s.req.done:
                results[s.req.uid] = s.req.out

    def run_until_drained(self, max_steps: int = 1024
                          ) -> Dict[int, List[int]]:
        """Serve until queue and slots drain (or ``max_steps`` decode
        steps); returns {uid: tokens} of the requests finished."""
        if not self.fused:
            return self._run_per_token(max_steps)
        results: Dict[int, List[int]] = {}
        steps = 0
        while True:
            self._collect(results)
            self._admit()
            live = self._live()
            if not live or steps >= max_steps:
                self._collect(results)
                break
            t_block = self._block_len(
                live, min(self.decode_block, max_steps - steps))
            self._run_block(live, t_block)
            steps += t_block
        return results

    def _run_per_token(self, max_steps: int) -> Dict[int, List[int]]:
        results: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            self._collect(results)
            self.step()
            self._collect(results)
            if not self.queue and all(s.req is None or s.req.done
                                      for s in self.slots):
                break
        return results
