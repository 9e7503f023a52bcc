"""What the kernel wrappers count for the roofline, and their tracing
route.

Every wrapper of a CUDA kernel adds, where it would launch, the kernel's
FLOPs and the bytes of its operands and output (each read or written
once, as ``PERF.md``'s bounds count them) to ``KERNEL_COST``: a real
launch and a traced one alike, so a step counted under
``FlopCounterMode`` (which cannot see into a ``ctypes`` launch) plus
these counters gives the same FLOPs on the card as in a trace of it.

A traced call is one whose operands are fake tensors
(``torch._subclasses.FakeTensor``, ``launch.step_builders.trace_cell``;
fake CUDA tensors, or fake CPU ones inside ``card_route``):
the wrapper then allocates what the launch would allocate — the output,
the split-K workspace, the aligned copies — and returns it without
building, querying the device or touching ``LAUNCHES``.  A real tensor
always launches.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

# streaming multiprocessors of an H100 SXM: the launch plans of the bf16
# revisit kernels read it, and a traced call has no card to ask
H100_SMS = 132

KERNEL_COST: Dict[str, Dict[str, float]] = {}


_stand_in = [False]


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (a trace, no storage)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


@contextlib.contextmanager
def card_route():
    """Inside, a fake tensor on the CPU takes the card's route in the
    wrappers (``on_card``): a trace for the card made where PyTorch has no
    CUDA, whose autograd cannot hold fake CUDA tensors."""
    prev = _stand_in[0]
    _stand_in[0] = True
    try:
        yield
    finally:
        _stand_in[0] = prev


def on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper takes the card's route for ``t``: a CUDA tensor,
    or a fake one inside ``card_route``."""
    return t.device.type == "cuda" or (_stand_in[0] and is_fake(t))


def count(kernel: str, flops: float, nbytes: float) -> None:
    """Add one call of ``kernel`` doing ``flops`` over ``nbytes``."""
    c = KERNEL_COST.setdefault(kernel, {"calls": 0, "flops": 0.0,
                                        "bytes": 0.0})
    c["calls"] += 1
    c["flops"] += float(flops)
    c["bytes"] += float(nbytes)


def nbytes(*ts) -> int:
    """The bytes of the tensors' elements (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def totals() -> Dict[str, float]:
    """{"flops", "bytes", "calls"} summed over every kernel."""
    out = {"flops": 0.0, "bytes": 0.0, "calls": 0}
    for c in KERNEL_COST.values():
        for k in out:
            out[k] += c[k]
    return out


def reset() -> None:
    KERNEL_COST.clear()


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t``'s first element lies on a 16-byte boundary.  A fake
    tensor has no address: its storage is taken to start on one, as the
    CUDA caching allocator's blocks do."""
    if is_fake(t):
        return (t.storage_offset() * t.element_size()) % 16 == 0
    return t.data_ptr() % 16 == 0
