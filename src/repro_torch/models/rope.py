"""Rotary position embeddings: full, half (ChatGLM 2d), partial
(StableLM, 25% of the head dims) and M-RoPE (Qwen2-VL's multimodal
sections); Whisper's sinusoidal absolute positions."""
from __future__ import annotations

from typing import Optional

import torch

MROPE_SECTIONS = (16, 24, 24)      # t/h/w sections of head_dim/2 (Qwen2-VL)


def _rot_half(x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _freqs(dim_half: int, theta: float, device) -> torch.Tensor:
    # the float32 base is filled on the device: a tensor built on the host
    # and copied there would make every decode step wait for the card
    e = torch.arange(dim_half, dtype=torch.float32, device=device) / dim_half
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), e)


def _cos_sin(positions: torch.Tensor, dim_half: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, dim_half) in float32."""
    ang = positions[..., None].float() * _freqs(dim_half, theta,
                                                positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               kind: str = "full", theta: float = 10_000.0,
               mrope_positions: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  kind: full | half |
    partial25 | mrope | none.  cos/sin are cast to ``x.dtype`` before
    rotating.

    ``mrope_positions`` (3, B, S): the t/h/w position streams of M-RoPE
    (``kind="mrope"`` only); None takes ``positions`` for all three, as a
    decode step does."""
    if kind == "none":
        return x
    hd = x.shape[-1]
    if kind == "mrope":
        if mrope_positions is None:
            mrope_positions = positions.expand(3, *positions.shape)
        cos, sin = _mrope_cos_sin(mrope_positions, hd // 2, theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        return _rot_half(x, cos.to(x.dtype), sin.to(x.dtype))
    rot_dim = {"full": hd, "half": hd // 2, "partial25": hd // 4}.get(kind)
    if rot_dim is None:
        raise ValueError(f"rope kind {kind!r} is not ported")
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    cos, sin = _cos_sin(positions, rot_dim // 2, theta)     # (B, S, rot/2)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]       # (B, S, 1, rot/2)
    xr = _rot_half(xr, cos.to(x.dtype), sin.to(x.dtype))
    return torch.cat([xr, xp], dim=-1) if rot_dim < hd else xr


def mrope_sections(dim_half: int):
    """``MROPE_SECTIONS`` scaled to ``dim_half`` frequency dims, as the
    reference scales them (Python's round, half to even; the last section
    takes the rest): (16, 24, 24) at hd 128, (1, 2, 1) at hd 8."""
    total = sum(MROPE_SECTIONS)
    scaled = [max(int(round(s * dim_half / total)), 1)
              for s in MROPE_SECTIONS]
    scaled[-1] = dim_half - sum(scaled[:-1])
    return scaled


def _mrope_cos_sin(pos3: torch.Tensor, dim_half: int, theta: float):
    """M-RoPE: the frequency dims split into (t, h, w) sections, each
    rotated by its own position stream (arXiv:2409.12191 §2.1).  pos3
    (3, B, S) -> cos/sin (B, S, dim_half) float32."""
    freqs = _freqs(dim_half, theta, pos3.device)
    cos_parts, sin_parts = [], []
    start = 0
    for sec, p in zip(mrope_sections(dim_half), pos3):
        ang = p[..., None].float() * freqs[start:start + sec]   # (B, S, sec)
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        start += sec
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


def sinusoidal_positions(seq: int, dim: int, device="cpu") -> torch.Tensor:
    """Whisper-style sinusoidal absolute embeddings (S, D) float32:
    [sin | cos] of pos / 10000^(2i / D), i < D / 2."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.full((), 10_000.0, dtype=torch.float32,
                                     device=device), 2 * i / dim)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
