"""Deterministic, shardable, resumable token data pipeline — a copy of the
reference's ``data/pipeline.py`` (numpy only), so that the port's batches
equal the reference's bit for bit.

Production framing without external deps:

  * **Deterministic** — batch at step ``t`` is a pure function of
    (seed, t, shard), so a restarted job replays identically and two data
    shards never overlap.
  * **Shardable** — each process materializes only its slice of the global
    batch (``shard``/``n_shards``); the trainer device_puts slices onto the
    local devices of a sharded global array.
  * **Resumable** — state is the step counter alone; the checkpoint stores
    it and restore seeks in O(1).

Sources: ``synthetic`` (seeded Zipf-ish token stream) and ``file`` (memmap
of a flat uint16/uint32 token file — the standard pretraining bin format).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | file
    path: Optional[str] = None         # token file for source="file"
    shard: int = 0
    n_shards: int = 1


@dataclass
class DataState:
    step: int = 0


class TokenPipeline:
    """Yields {"tokens", "labels"} batches of the *local* shard."""

    def __init__(self, cfg: DataConfig, state: Optional[DataState] = None):
        assert cfg.global_batch % cfg.n_shards == 0, (cfg.global_batch,
                                                      cfg.n_shards)
        self.cfg = cfg
        self.state = state or DataState()
        self._mm = None
        if cfg.source == "file":
            assert cfg.path is not None
            self._mm = np.memmap(cfg.path, dtype=np.uint16, mode="r")

    @property
    def local_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_shards

    def _synthetic(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.shard]))
        # Zipf-ish marginal over the vocab (realistic token frequencies)
        u = rng.random((self.local_batch, cfg.seq_len + 1))
        toks = ((cfg.vocab - 1) * u ** 3.0).astype(np.int32)
        return toks

    def _from_file(self, step: int) -> np.ndarray:
        cfg = self.cfg
        n_tok = cfg.seq_len + 1
        per_step = cfg.global_batch * n_tok
        start = (step * per_step + self.cfg.shard * self.local_batch * n_tok)
        start = start % max(len(self._mm) - per_step, 1)
        flat = np.asarray(self._mm[start:start + self.local_batch * n_tok])
        return flat.reshape(self.local_batch, n_tok).astype(np.int32) \
            % self.cfg.vocab

    def next_batch(self) -> Dict[str, np.ndarray]:
        step = self.state.step
        toks = (self._from_file(step) if self._mm is not None
                else self._synthetic(step))
        self.state.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # ---- checkpoint integration ----
    def snapshot(self) -> Dict:
        return {"step": self.state.step}

    def restore(self, snap: Dict) -> None:
        self.state.step = int(snap["step"])


def with_frontend_inputs(batch: Dict[str, np.ndarray], cfg,
                         n_vis: int = 0) -> Dict[str, np.ndarray]:
    """Attach stub frontend tensors ([vlm]/[audio]) to a token batch."""
    b, s = batch["tokens"].shape
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(batch["tokens"][0, 0]), b, s]))
    out = dict(batch)
    if cfg.encoder_decoder:
        out["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32) * 0.02
    if cfg.frontend == "vision" and n_vis:
        out["vis_embeds"] = rng.normal(size=(b, n_vis, cfg.d_model)).astype(
            np.float32) * 0.02
        pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None, None],
                              (3, b, s))
        out["mrope_positions"] = np.ascontiguousarray(pos)
    return out
