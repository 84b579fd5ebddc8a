"""Device resolution for the port's entry points, and host copies.

Every entry point takes `device=`; `None` means the card. There is no
fallback: asking for `cuda` where no card is visible raises, so a run can
never silently measure the CPU in place of the device.
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda; raise if a CUDA device is asked for and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    return dev


def is_dtensor(x) -> bool:
    """Whether `x` is a `torch.distributed.tensor.DTensor` (a sharded
    step's tensor). Imports nothing: with DTensor's module not loaded, no
    DTensor exists."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
