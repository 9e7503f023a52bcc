"""The serving engine's captured entry points: the port's counterpart of the
JAX engine's jitted executables (``jax.jit(..., donate_argnums=...)``).

An ``Executable`` is one entry point at one static shape — the oracle step,
a fused decode block of T steps, a prompt feed of P positions, a verify
block of k drafts.  Everything static (the params of a plan tier, the
exec config and its descriptor table, T, P, k, the EOS id) is closed over;
everything that changes per call (tokens, positions, live mask, budgets,
sampling arrays, the fed slot) is an input tensor.  The decode state is
closed over too and written in place, as a donated argument is.

On CUDA the first call captures the entry point into a
``torch.cuda.CUDAGraph`` over static input buffers:

  1. the input buffers are allocated outside any graph pool;
  2. one warm run with every row dead (``warm``: the same entry point at
     its shortest length, which reaches every kernel, library and popcount
     counter the capture will) runs on the engine's capture stream, so
     nothing is created lazily under capture;
  3. the entry point is captured on that stream into the engine's graph
     pool under the default ``capture_error_mode``, so a synchronizing call
     raises there; ``CaptureError`` names the entry point and its shape.
     There is no eager fallback on the card.

A call copies its inputs into the buffers (a device copy queued on the
stream), replays the graph and returns copies of its outputs: graphs that
share a pool overwrite each other's intermediates, so nothing a caller
keeps (a token block, carries, logits) may stay in the pool.  The kernels'
wrappers count their launches in Python, which a replay does not run:
each replay credits the ``LAUNCHES`` of every kernel module with the counts
its capture recorded (the capture itself launches nothing and credits
nothing), so the counters keep counting real launches.

On the CPU a call runs the entry point eagerly: the plain version."""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import block_sparse, flash_attention, flex_matmul
from repro_torch.kernels import int8_matmul

# the kernel modules whose ``LAUNCHES`` a replay credits
LAUNCH_MODULES = (block_sparse, flex_matmul, int8_matmul, flash_attention)


class CaptureError(RuntimeError):
    """An entry point could not be captured as a CUDA graph."""


def launch_counts() -> Dict[str, Dict[str, int]]:
    """A copy of every kernel module's ``LAUNCHES``."""
    return {m.__name__: dict(m.LAUNCHES) for m in LAUNCH_MODULES}


def _set_launches(counts: Dict[str, Dict[str, int]]) -> None:
    for m in LAUNCH_MODULES:
        m.LAUNCHES.update(counts[m.__name__])


def _credit(delta: Dict[str, Dict[str, int]]) -> None:
    for m in LAUNCH_MODULES:
        for key, n in delta[m.__name__].items():
            m.LAUNCHES[key] += n


def _end_failed_capture(device: torch.device, pool) -> None:
    """Undo what a capture that failed at ``cudaStreamEndCapture`` left in
    the caching allocator: ``capture_end`` raises before it ends routing
    the capture stream's allocations into the graph's pool, and while a
    capture counts as underway the allocator defers frees and
    ``empty_cache`` releases nothing, so the process's free memory would
    stay reserved for good.  End the routing and give the pool back; if
    ``capture_end`` got as far as ending it, there is nothing to undo."""
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    release = getattr(torch._C, "_cuda_releasePool", None)
    if end is None or release is None:
        return
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    try:
        end(index, pool)
    except RuntimeError:            # not routing: capture_end had ended it
        return
    release(index, pool)


def _clone(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.clone()


class Executable:
    """One entry point ``fn`` at one static shape (module docstring).

    ``fn(*inputs)`` returns a tuple of tensors (or None entries); ``warm()``
    runs it once with every row dead.  ``pool`` is the engine's graph pool
    and ``stream`` its capture stream (both unused off CUDA).  ``name`` and
    ``key`` label the entry point in errors and statistics."""

    def __init__(self, name: str, key: tuple, fn: Callable[..., tuple],
                 warm: Callable[[], None], device: torch.device, *,
                 pool=None, stream: Optional[torch.cuda.Stream] = None):
        self.name, self.key, self.fn, self.warm = name, key, fn, warm
        self.device = device
        self.pool, self.stream = pool, stream
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        # the inputs' shapes (None for an absent input), fixed by the
        # first call on every device
        self.shapes: Optional[tuple] = None
        self._inputs: Sequence[Optional[torch.Tensor]] = ()
        self._outputs: Tuple[Optional[torch.Tensor], ...] = ()
        self.launches: Dict[str, Dict[str, int]] = {}
        self.capture_s = 0.0          # warm run + capture + instantiation
        self.pool_bytes = 0           # memory the capture reserved
        self.replays = 0

    def __repr__(self) -> str:
        return f"Executable({self.name}, {self.key})"

    def __call__(self, *args):
        shapes = tuple(None if a is None else tuple(a.shape) for a in args)
        if self.shapes is None:
            self.shapes = shapes
        elif shapes != self.shapes:
            raise ValueError(f"{self!r}: inputs of shapes {shapes}, its "
                             f"static shapes are {self.shapes}")
        if self.device.type != "cuda":
            return self.fn(*args)
        if self.graph is None:
            self._capture(args)
        for buf, arg in zip(self._inputs, args):
            if buf is not None:
                buf.copy_(arg, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        _credit(self.launches)
        return tuple(_clone(o) for o in self._outputs)

    def _capture(self, args) -> None:
        dev = self.device
        t0 = time.perf_counter()
        self._inputs = [None if a is None
                        else torch.empty(a.shape, dtype=a.dtype, device=dev)
                        for a in args]
        current = torch.cuda.current_stream(dev)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.warm()
        reserved = torch.cuda.memory_reserved(dev)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        # the pool's id, known even if the capture fails (``graph.pool()``
        # answers only after a successful one)
        pool = (self.pool if self.pool is not None
                else torch.cuda.graph_pool_handle())
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=pool)
                try:
                    out = self.fn(*self._inputs)
                finally:
                    graph.capture_end()
        except Exception as err:
            _end_failed_capture(dev, pool)
            current.wait_stream(self.stream)
            _set_launches(before)
            raise CaptureError(
                f"{self.name} {self.key}: CUDA graph capture failed "
                f"({type(err).__name__}: {err})") from err
        after = launch_counts()
        _set_launches(before)
        self.launches = {m: {k: after[m][k] - before[m].get(k, 0)
                             for k in after[m]} for m in after}
        current.wait_stream(self.stream)
        self._outputs = tuple(out)
        self.graph = graph
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0
