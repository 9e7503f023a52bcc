"""Per-(arch × shape) runtime knobs for the production cells, the
reference's ``configs/cells.py``.

The assigned shape set is the same for every LM arch, but the *runtime*
configuration that makes each cell fit device memory differs:
gradient-accumulation depth (``n_micro``), remat policy, chunked-CE
chunk, attention query chunk, and whether the decode KV cache is
sequence-sharded over the "model" axis (SP).  These are the FlexNN
"descriptor" knobs at the framework level; the roofline hillclimb
(``roofline.hillclimb``) overrides them per cell.

The overrides are the reference's, unchanged: they were sized for its
production meshes, (16, 16) and (2, 16, 16) ranks.  The port's dry-run
(``launch.dryrun``) checks each cell's per-rank peak against an
H100's 80 GB; on that budget the residual napkin math is

  residual bytes/rank ≈ (B / n_micro / dp) · S · d_model · 2 per layer
  (remat ``full``), and the per-chunk logits of the chunked
  cross-entropy (B_micro, chunk, V / 16) · 4 bytes,

both far inside 80 GB at the reference's ``n_micro`` and ``loss_chunk``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.configs.base import SHAPES, ShapeConfig


@dataclass(frozen=True)
class CellFlags:
    """Sharding-level flags resolved per cell (see sharding.partition)."""
    seq_shard: bool = False     # shard KV-cache seq dim over "model" (SP)
    fsdp: bool = True           # shard params over the batch axes too


# (arch, shape) -> ShapeConfig field overrides
_SHAPE_OVERRIDES: Dict[Tuple[str, str], Dict] = {
    # ---- train_4k ----
    ("qwen2-vl-72b", "train_4k"):        dict(n_micro=16, loss_chunk=256),
    ("yi-9b", "train_4k"):               dict(n_micro=8),
    ("gemma-2b", "train_4k"):            dict(n_micro=4, loss_chunk=128),
    ("chatglm3-6b", "train_4k"):         dict(n_micro=4),
    ("stablelm-1.6b", "train_4k"):       dict(n_micro=2),
    ("whisper-tiny", "train_4k"):        dict(n_micro=1),
    ("deepseek-moe-16b", "train_4k"):    dict(n_micro=2),
    ("llama4-scout-17b-a16e", "train_4k"): dict(n_micro=4, loss_chunk=256),
    ("recurrentgemma-9b", "train_4k"):   dict(n_micro=8, loss_chunk=128),
    ("mamba2-1.3b", "train_4k"):         dict(n_micro=4),
    # ---- prefill_32k: no grads; chunked attention keeps live set small ----
    ("qwen2-vl-72b", "prefill_32k"):     dict(attn_chunk=512),
    ("gemma-2b", "prefill_32k"):         dict(loss_chunk=128),
}

# (arch, shape) -> CellFlags overrides
_FLAG_OVERRIDES: Dict[Tuple[str, str], CellFlags] = {
    ("qwen2-vl-72b", "prefill_32k"): CellFlags(seq_shard=False, fsdp=True),
    ("llama4-scout-17b-a16e", "prefill_32k"): CellFlags(seq_shard=False,
                                                        fsdp=True),
}

_BIG_DECODE_CACHE = {"qwen2-vl-72b", "yi-9b", "chatglm3-6b", "stablelm-1.6b",
                     "deepseek-moe-16b", "llama4-scout-17b-a16e",
                     "whisper-tiny", "gemma-2b"}


def cell_shape(arch_id: str, shape_name: str) -> ShapeConfig:
    """The ShapeConfig for one cell, with per-cell overrides applied."""
    base = SHAPES[shape_name]
    over = _SHAPE_OVERRIDES.get((arch_id, shape_name))
    return dataclasses.replace(base, **over) if over else base


def cell_flags(arch_id: str, shape_name: str) -> CellFlags:
    if (arch_id, shape_name) in _FLAG_OVERRIDES:
        return _FLAG_OVERRIDES[(arch_id, shape_name)]
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        # big full-length KV caches are sequence-sharded; parameters are
        # tensor-parallel only (serving has no optimizer state), except
        # the two configs whose weights leave no cache headroom at TP 16
        seq_shard = arch_id in _BIG_DECODE_CACHE and shape_name != "long_500k"
        fsdp = arch_id in ("llama4-scout-17b-a16e", "qwen2-vl-72b")
        return CellFlags(seq_shard=seq_shard, fsdp=fsdp)
    if shape.kind == "prefill":
        return CellFlags(seq_shard=False, fsdp=False)
    return CellFlags(seq_shard=False, fsdp=True)


def clamp_micro(shape: ShapeConfig, dp: int) -> ShapeConfig:
    """Keep the microbatch shardable: B/n_micro must divide by dp."""
    n = max(shape.n_micro, 1)
    while n > 1 and (shape.global_batch % n
                     or (shape.global_batch // n) % dp):
        n -= 1
    return dataclasses.replace(shape, n_micro=n)
