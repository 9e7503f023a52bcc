"""Compressed gradient collectives — the ZVC idea on the wire, the
reference's ``train/grad_compress.py`` on ``torch.distributed``.

FlexNN keeps tensors zero-value-compressed through every memory level to
cut movement energy (§III-D).  At datacenter scale the expensive "memory
level" is the data-parallel gradient reduction, so the same idea becomes
gradient compression:

  * **EF-int8**: error-feedback int8 quantization.  Each rank quantizes
    (grad + carried error) to int8 with one float32 scale, all-gathers the
    int8 payload (1 B/elem on the wire) and the scales, dequantizes and
    means locally.  The quantization residual is carried to the next step.
  * **ZVC top-k**: keep the top-k fraction by magnitude; error feedback
    carries the dropped mass.  The masked tensor is meaned by
    ``all_reduce`` (the modeled wire cost is ``wire_bytes_per_element``).

``group`` is the process group of the data-parallel axes (None: one rank,
where the collectives are skipped and the arithmetic is the same).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import torch

from repro_torch.sharding import collectives
from repro_torch.train.optimizer import tree_map


@dataclass(frozen=True)
class CompressConfig:
    mode: str = "none"          # none | int8 | zvc_topk
    topk_frac: float = 0.05     # fraction kept in zvc_topk mode
    axis_name: Union[str, Tuple[str, ...]] = "data"


def wire_bytes_per_element(cfg: CompressConfig, dense_bytes: int = 4) -> float:
    """Modeled wire cost (drives the roofline collective term)."""
    if cfg.mode == "int8":
        return 1.0
    if cfg.mode == "zvc_topk":
        return cfg.topk_frac * dense_bytes + 1.0 / 8.0    # values + bitmap
    return float(dense_bytes)


# ---------------------------------------------------------------------------
# EF-int8
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_int8_allreduce(g: torch.Tensor, err: torch.Tensor, group=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of ``g`` across ``group`` with the int8 wire format.
    Returns (mean_grad_f32, new_error)."""
    u = g.to(torch.float32) + err
    q, scale = quantize_int8(u)
    new_err = u - dequantize_int8(q, scale)
    # the int8 payload and the float32 scales gathered; reduced locally
    qs = collectives.gather_dim(q[None], group, 0)          # (G, ...) int8
    ss = collectives.gather_dim(scale.reshape(1), group, 0)  # (G,)
    n = qs.shape[0]
    # Σ_r scale_r · q_r, as the reference's tensordot; one rank's mean is
    # its dequantized payload exactly
    mean = (qs.to(torch.float32)
            * ss.reshape((n,) + (1,) * q.dim())).sum(0) / n
    return mean, new_err


# ---------------------------------------------------------------------------
# ZVC top-k
# ---------------------------------------------------------------------------

def zvc_topk_allreduce(g: torch.Tensor, err: torch.Tensor, group,
                       frac: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-|k| sparsified mean: ``g`` + error masked to its top ``frac``
    fraction by magnitude, meaned over ``group``."""
    u = g.to(torch.float32) + err
    flat = u.reshape(-1)
    k = max(int(flat.shape[0] * frac), 1)
    thr = torch.topk(torch.abs(flat), k).values[-1]
    mask = torch.abs(u) >= thr
    kept = torch.where(mask, u, torch.zeros((), dtype=u.dtype,
                                            device=u.device))
    new_err = u - kept
    mean = collectives.all_reduce(kept, group) / collectives.group_size(group)
    return mean, new_err


def compressed_mean(g: torch.Tensor, err: torch.Tensor, cfg: CompressConfig,
                    group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.mode == "int8":
        return ef_int8_allreduce(g, err, group)
    if cfg.mode == "zvc_topk":
        return zvc_topk_allreduce(g, err, group, cfg.topk_frac)
    n = collectives.group_size(group)
    return collectives.all_reduce(g.to(torch.float32), group) / n, err


def init_error_state(params) -> Dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)

