"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names the
    CPU explicitly.  Asking for CUDA where there is none raises — the port
    never carries on quietly on the CPU — except while a
    ``FakeTensorMode`` is active: a trace (``launch.step_builders``) makes
    fake CUDA tensors, which need no card."""
    dev = torch.device("cuda" if device is None else device)
    if (dev.type == "cuda" and not torch.cuda.is_available()
            and not tracing()):
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def tracing() -> bool:
    """Whether a ``FakeTensorMode`` is active (tensors made now are fake)."""
    from torch._guards import detect_fake_mode
    return detect_fake_mode() is not None
