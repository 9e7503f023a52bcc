"""Int8 weight quantization for serving, ported from the JAX package's
``quant/quantize.py``.

Per-output-channel symmetric int8 weights with float32 scales: half the
bf16 weight bytes, which is what a decode step at small batch reads.  The
scales sit on the output channels of the contraction, so they are
K-invariant and a kernel applies them once to its float32 accumulator.
Ordinary (..., K, N) leaves scale along the last axis; the (V, D)
``lm_head`` contracts transposed (x @ headᵀ), so it is quantized on its
(D, V) view and stored that way, contiguous, with per-vocab-row scales.
Under ``tie_embeddings`` the head is the embedding table and stays as it is.

Quantization is zero-preserving: a zero element quantizes to exactly 0, so
block bitmaps — and a weight plan's metadata — survive it.  Scales and
payloads are computed in float32 exactly as the reference does
(``max|w|/127 + 1e-12``, round half to even), so both are bit-equal to it.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.core.stacks import leading_slices


@dataclass
class QuantizedLinear:
    """Per-output-channel symmetric int8 weight (contraction-oriented)."""
    q: torch.Tensor          # (..., K, N) int8
    scale: torch.Tensor      # (..., N) float32

    def index(self, i: int) -> "QuantizedLinear":
        """The slice of a stacked leaf at leading index ``i``."""
        return QuantizedLinear(q=self.q[i], scale=self.scale[i])

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype


def _quantize_matrices(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    wf = w.float()
    scale = wf.abs().amax(dim=-2) / 127.0 + 1e-12
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127)
    return q.to(torch.int8), scale


def quantize_weight(w: torch.Tensor) -> QuantizedLinear:
    """(..., K, N) float → int8 + per-(..., N) scale (symmetric,
    round half to even).  All-zero columns get the epsilon scale and
    quantize to exactly 0.  A stack is quantized a slice of its leading
    axes at a time into the payload (each (K, N) matrix on its own, so the
    slices give the whole leaf's numbers): a full-width expert leaf never
    gets a whole-leaf float32 temporary."""
    if w.dim() < 3:
        q, scale = _quantize_matrices(w)
        return QuantizedLinear(q=q, scale=scale)
    k, n = w.shape[-2:]
    flat = w.reshape(-1, k, n)
    q = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((flat.shape[0], n), dtype=torch.float32,
                        device=w.device)
    for s in leading_slices(flat.shape[0], k * n):
        q[s], scale[s] = _quantize_matrices(flat[s])
    return QuantizedLinear(q=q.reshape(w.shape),
                           scale=scale.reshape(*w.shape[:-2], n))


def dequantize_leaf(qw: QuantizedLinear, dtype=torch.bfloat16
                    ) -> torch.Tensor:
    """q (..., K, N) with scale (..., N) → dense (..., K, N) ``dtype``."""
    return (qw.q.float() * qw.scale[..., None, :]).to(dtype)


def dequantize_weight(qw: QuantizedLinear, dtype=torch.bfloat16
                      ) -> torch.Tensor:
    """A single (K, N) weight back to dense ``dtype``."""
    return dequantize_leaf(qw, dtype)


# weight leaves that hold (in, out) matmul matrices — quantization targets
_MATMUL_LEAF = re.compile(
    r".*(wq|wkv|wo|w_in|w_gate|w_out|w_x|in_proj|out_proj|experts_in|"
    r"experts_gate|experts_out|router|lm_head)$")
# leaves stored (N, K): quantized on the transposed view
_TRANSPOSED_LEAF = re.compile(r".*lm_head$")


def _map_paths(fn, tree, path: str = ""):
    """Rebuild a nested-dict tree with ``fn("a/b/c", leaf)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def quantize_params(params, *, tie_embeddings: bool = False
                    ) -> Tuple[Dict, Dict]:
    """Params tree → (the same tree with ``QuantizedLinear`` at every matmul
    leaf, stats).  Embeddings, norms and vectors keep their dtype; stacked
    (L, K, N) leaves get (L, N) scales and expert (L, E, K, N) leaves
    (L, E, N); the float32 MoE router is quantized like any matmul leaf;
    the ``lm_head`` is quantized on its (D, V) view, or skipped under
    ``tie_embeddings``."""
    stats = {"quantized_bytes": 0, "original_bytes": 0, "n_quantized": 0}

    def qleaf(path, leaf):
        if not (isinstance(leaf, torch.Tensor) and leaf.dim() >= 2
                and _MATMUL_LEAF.match(path)):
            return leaf
        if _TRANSPOSED_LEAF.match(path):
            if tie_embeddings:
                return leaf
            leaf_kn = leaf.transpose(-1, -2)
        else:
            leaf_kn = leaf
        out = quantize_weight(leaf_kn)
        out.q = out.q.contiguous()
        stats["n_quantized"] += 1
        stats["original_bytes"] += leaf.numel() * leaf.element_size()
        stats["quantized_bytes"] += out.q.numel() + out.scale.numel() * 4
        return out

    return _map_paths(qleaf, params), stats


def dequantize_params(qparams, dtype=torch.bfloat16):
    """Inverse of ``quantize_params``: ``QuantizedLinear`` leaves back to
    dense ``dtype``, the ``lm_head`` back in its stored (V, D) orientation,
    so the tree has the shapes of the pre-quantization params."""
    def deq(path, leaf):
        if not isinstance(leaf, QuantizedLinear):
            return leaf
        out = dequantize_leaf(leaf, dtype)
        if _TRANSPOSED_LEAF.match(path):
            out = out.transpose(-1, -2).contiguous()
        return out
    return _map_paths(deq, qparams)
