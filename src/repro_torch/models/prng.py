"""The port's copy of the part of ``jax.random`` that token sampling uses:
the threefry2x32 hash (20 rounds), ``PRNGKey``, ``fold_in``, 32-bit random
bits in JAX's partitionable layout, ``uniform`` and ``gumbel`` (JAX's
default ``"low"`` mode).

uint32 values are held in int64 tensors masked with ``& 0xFFFFFFFF``, so
every operation is an ordinary elementwise torch op on any device.  Keys
are (..., 2) int64 tensors: a batch of keys hashes in one pass.

Random bits follow JAX's *partitionable* threefry scheme (the
``jax_threefry_partitionable`` flag, on by default since JAX 0.5): the bits
of a shape-(V,) draw hash the counters (hi, lo) = (0, i) of a 64-bit iota
and return ``bits1 ^ bits2``.  Bits and uniforms are bit-exact; the Gumbel
transform's two logs are the platform's ``log``, which may differ from
another library's by an ulp."""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under the key
    (k1, k2), all uint32 values in int64 tensors that broadcast together;
    returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: torch.Tensor) -> torch.Tensor:
    """Keys (..., 2) of uint32 seeds (...,): ``[0, seed]``, as
    ``jax.random.PRNGKey`` gives for a 32-bit seed."""
    seed = seed.to(torch.int64) & MASK
    return torch.stack((torch.zeros_like(seed), seed), dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counters ``[0, data]``
    under ``key`` (..., 2), one uint32 ``data`` (...,) per key."""
    data = data.to(torch.int64) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack((y0, y1), dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random bits (..., n) of each key (..., 2): the partitionable
    layout, ``bits1 ^ bits2`` of the counters (0, i), i < n."""
    iota = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(iota), iota)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform`` float32 (..., n) in [minval, 1): the top 23
    bits as the mantissa of a float in [1, 2), minus 1, scaled to the
    float32 span 1 - minval, shifted and clamped below at ``minval``."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = float(torch.tensor(1.0, dtype=torch.float32) - lo)
    return torch.clamp_min(f * span + float(lo), float(lo))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` in JAX's default ``"low"`` mode: float32
    (..., n) = -log(-log(u)), u uniform in [tiny, 1)."""
    u = uniform(key, n, minval=_TINY)
    return -torch.log(-torch.log(u))
