"""Meshes over ``torch.distributed`` ranks, the reference's
``launch/mesh.py``.

A ``Mesh`` names the axes of a grid of ranks (``axis_names``, ``shape`` as
the dict ``jax`` has) and holds, for every set of its axes whose size is
above 1, the process group of the ranks that share this rank's
coordinates on the other axes.  Ranks are laid out row-major over the
axes, as ``jax.make_mesh`` lays out devices, so a group over a tuple of
axes (``("pod", "data")``) numbers its ranks as the reference's combined
axis index does: ``new_group`` keeps ranks in ascending order.

Without a process group whose world is the mesh's size the mesh is
abstract: shapes only, no groups, no rank of its own (the partition rules
resolve on it, ``shard_leaf`` takes a rank explicitly); an abstract mesh
of one rank is that rank.

  single-pod : (16, 16)    = ("data", "model")
  multi-pod  : (2, 16, 16) = ("pod", "data", "model")
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch.distributed as dist

Axes = Union[None, str, Tuple[str, ...]]


def _axes(ax: Axes) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


class Mesh:
    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} for axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        self.size = math.prod(shape)
        self.rank: Optional[int] = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        if dist.is_initialized() and dist.get_world_size() == self.size:
            self.rank = dist.get_rank()
            self._build_groups()

    @property
    def distributed(self) -> bool:
        return self.rank is not None

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis name -> index of ``rank`` (default: this process's)."""
        rank = self.rank if rank is None else rank
        if rank is None and self.size == 1:
            rank = 0
        if rank is None:
            raise ValueError("an abstract mesh has no rank of its own")
        out = {}
        for name in reversed(self.axis_names):
            out[name] = rank % self.shape[name]
            rank //= self.shape[name]
        return out

    def axis_size(self, ax: Axes) -> int:
        return math.prod(self.shape[a] for a in _axes(ax))

    def axis_index(self, ax: Axes, rank: Optional[int] = None) -> int:
        """The combined, row-major index of ``rank`` over the axes ``ax``."""
        c = self.coords(rank)
        idx = 0
        for a in _axes(ax):
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, ax: Axes):
        """The process group over ``ax`` holding this rank; None where the
        axes have size 1 (no collective is needed)."""
        key = tuple(a for a in self.axis_names if a in _axes(ax))
        if self.axis_size(key) <= 1:
            return None
        if not self.distributed:
            raise ValueError(f"abstract mesh {self.shape}: no group over "
                             f"{key}")
        return self._groups[key]

    def _build_groups(self) -> None:
        """Every rank creates every group, in one order (``new_group`` is
        collective over the world)."""
        names = self.axis_names
        for n in range(1, len(names) + 1):
            for key in itertools.combinations(names, n):
                if self.axis_size(key) <= 1:
                    continue
                if len(key) == len(names):
                    self._groups[key] = dist.group.WORLD
                    continue
                rest = [a for a in names if a not in key]
                mine = None
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    ranks = [r for r in range(self.size)
                             if all(self.coords(r)[a] == i
                                    for a, i in zip(rest, fixed))]
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = g
                self._groups[key] = mine

    def __repr__(self) -> str:
        kind = f"rank {self.rank}" if self.distributed else "abstract"
        return f"Mesh({self.shape}, {kind})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(model: Optional[int] = None) -> Mesh:
    """(world // model, model) over ("data", "model"), the world being the
    initialised process group's (1 without one)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = model or 1
    if n % model:
        raise ValueError(f"{n} ranks do not split into model shards of "
                         f"{model}")
    return Mesh((n // model, model), ("data", "model"))


def mesh_chips(mesh: Mesh) -> int:
    return mesh.size
