"""Shape helpers for stacks of matrices (..., K, N).

``leading_slices`` cuts a pass over a stack into slices of its leading
axis, so that a full-width leaf — a (L, E, K, N) expert leaf of
DeepSeek-MoE-16B is 10 GB in bf16 — gets temporaries of one slice, never
of the whole leaf.  Pruning, bitmaps, counts and quantization are per
(K, N) matrix, so slicing them changes no number.

``pad_to_blocks`` zero-pads the last two dims up to block multiples.
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch
import torch.nn.functional as F

# elements one slice of ``leading_slices`` takes by default: bounds a
# sliced pass's temporaries (float32: 256 MB each)
SLICE_ELEMS = 1 << 26


def leading_slices(p: int, per: int,
                   elems: Optional[int] = None) -> Iterator[slice]:
    """Slices of ``range(p)`` over a stack of ``p`` items of ``per``
    elements each, at most ``elems`` (default ``SLICE_ELEMS``) elements a
    slice and at least one item."""
    step = max(1, (SLICE_ELEMS if elems is None else elems) // max(per, 1))
    for i in range(0, p, step):
        yield slice(i, min(p, i + step))


def pad_to_blocks(x: torch.Tensor, m0: int, m1: int) -> torch.Tensor:
    """Zero-pad the last two dims of ``x`` up to multiples of (m0, m1): ``x``
    itself, no copy, when they already are.  Padding blocks are all-zero,
    so their bitmap bits are dead and the block-sparse path skips them."""
    p0 = (-x.shape[-2]) % m0
    p1 = (-x.shape[-1]) % m1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0))
    return x
