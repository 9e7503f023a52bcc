"""The memory of a traced step: every storage that an operator makes is
counted from its creation until it dies (a weak reference to the storage
fires then), so the tracker sees what the step holds at each moment,
autograd's saved tensors and the collectives' buffers included.

``MemoryTracker`` is a ``TorchDispatchMode``: entered inside a
``FakeTensorMode`` it counts the fake storages of a trace, entered
around real tensors it counts theirs.  Storages are counted as the CUDA
caching allocator counts its blocks, in whole ``granule``s (512 bytes);
an operator that writes in place (a cache update, ``copy_``) makes no
storage and adds nothing.

It reports the argument bytes (``add_args``: the storages the step is
handed, counted as live from the start), the peak of the live bytes, and
the output bytes (``outputs``: the storages the step's result holds that
it made).
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

GRANULE = 512            # the CUDA caching allocator's block rounding


class MemoryTracker(TorchDispatchMode):
    def __init__(self, granule: int = GRANULE):
        super().__init__()
        self.granule = granule
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self._sizes: Dict[int, int] = {}     # storage key -> counted bytes
        self._refs: Dict[int, weakref.ref] = {}
        self._args = set()

    def _round(self, n: int) -> int:
        if n == 0:
            return 0
        g = self.granule
        return -(-n // g) * g

    def _key(self, st) -> int:
        return st._cdata

    def _track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage if it is new; its key."""
        st = t.untyped_storage()
        key = self._key(st)
        if key not in self._sizes:
            n = self._round(st.nbytes())
            self._sizes[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            self._refs[key] = weakref.ref(st, self._freer(key))
        return key

    def _freer(self, key: int):
        def free(_):
            n = self._sizes.pop(key, 0)
            self._refs.pop(key, None)
            self.live -= n
        return free

    def add_args(self, *trees) -> int:
        """Count the storages of every tensor in ``trees`` as the step's
        arguments (once each, however many views share one); returns the
        argument bytes, the raw (unrounded) bytes of their storages."""
        seen = set()
        for t in tree_leaves(trees):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = self._key(st)
                if key not in seen:
                    seen.add(key)
                    self.argument_bytes += st.nbytes()
                self._track(t)
                self._args.add(key)
        return self.argument_bytes

    def outputs(self, tree) -> int:
        """The raw bytes of the storages ``tree`` holds that the step made
        (not its arguments')."""
        seen, total = set(), 0
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = self._key(st)
                if key not in seen and key not in self._args:
                    seen.add(key)
                    total += st.nbytes()
        return total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out
