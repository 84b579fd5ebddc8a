"""Device resolution for the port's entry points.

Every entry point takes `device=`; `None` means the card. There is no
fallback: asking for `cuda` where no card is visible raises, so a run can
never silently measure the CPU in place of the device.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda; raise if a CUDA device is asked for and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    return dev
