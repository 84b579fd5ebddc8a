"""Slot-dispatch recursion of the finite-capacity replay: each row, in
dispatch order, takes the earliest-idle slot of a pool and holds it.

Replaces the serial `lax.scan` of `repro/cluster/events.py` (`_pool_step`
under `dispatch_scan` and `dispatch_prefix_scan`), which XLA lowered; the
reference has no Pallas kernel for it. Three forms:

* `dispatch_scan_plain`: the recursion step by step, every operation in
  f32 (a loop over numpy f32 scalars);
* `dispatch_scan_cuda`: the hand-written kernel `csrc/dispatch_scan.cu`;
* `dispatch_scan`: the wrapper. CPU tensors take the plain version, CUDA
  tensors the kernel; anything else raises.

Semantics: rows i < count take slot si, the earliest-idle one (the lowest
index among equal minima), start = max(release_i, free[si]) and leave
free[si] = start + hold_i; rows at or past count report their release.
`count` is an int32 tensor, so on the card a pass reads nothing back to
the host. `free` (K,) is the pool's state, read at the start and updated
in place to the state after the last row.

What bounds it on the card: the serial chain, one step per row below
count; see the .cu source for the design.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

#: launches of the CUDA kernel since the count was last set to 0
launches = 0


def dispatch_scan_plain(release: torch.Tensor, hold: torch.Tensor,
                        count: torch.Tensor, free: torch.Tensor
                        ) -> torch.Tensor:
    """(n,) f32 starts; `free` is updated in place."""
    rel = release.detach().cpu().numpy()
    h = hold.detach().cpu().numpy()
    pool = free.detach().cpu().numpy().copy()
    start = rel.copy()
    for i in range(max(0, min(int(count), rel.shape[0]))):
        si = int(np.argmin(pool))      # the first of equal minima
        s = np.maximum(rel[i], pool[si])
        start[i] = s
        pool[si] = s + h[i]            # f32 + f32, rounded to f32
    free.copy_(torch.from_numpy(pool))
    return torch.from_numpy(start).to(release.device)


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("dispatch_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dispatch_scan_launch.argtypes = [i, p, p, p, i, p, i, p, p]
    lib.dispatch_scan_launch.restype = i
    lib.dispatch_scan_pool_shared.argtypes = [i]
    lib.dispatch_scan_pool_shared.restype = i
    return lib


def pool_in_shared_memory(slots: int) -> bool:
    """Does the kernel keep a pool of `slots` slots in shared memory (else
    in device memory)? Builds the kernel if needed."""
    return bool(_library().dispatch_scan_pool_shared(int(slots)))


def _check(name, x, dtype, dev, shape=None):
    if (x.device != dev or x.dtype != dtype or x.dim() != 1
            or not x.is_contiguous()
            or (shape is not None and x.shape[0] != shape)):
        raise ValueError(
            f"dispatch_scan_cuda: {name} must be a contiguous 1-D {dtype} "
            f"tensor on {dev}" + ("" if shape is None else f" of {shape}")
            + f", got {x.dtype} {tuple(x.shape)} on {x.device}")


def dispatch_scan_cuda(release: torch.Tensor, hold: torch.Tensor,
                       count: torch.Tensor, free: torch.Tensor
                       ) -> torch.Tensor:
    """Launch `csrc/dispatch_scan.cu` on the current stream; same outputs
    as `dispatch_scan_plain`."""
    global launches
    dev = release.device
    n = release.shape[0]
    _check("release", release, torch.float32, dev)
    _check("hold", hold, torch.float32, dev, n)
    _check("free", free, torch.float32, dev)
    if count.device != dev or count.dtype != torch.int32 or \
            count.numel() != 1:
        raise ValueError(f"dispatch_scan_cuda: count must be one int32 on "
                         f"{dev}, got {count.dtype} {tuple(count.shape)} on "
                         f"{count.device}")
    K = free.shape[0]
    if K < 1:
        raise ValueError("dispatch_scan_cuda: the pool has no slot")
    start = torch.empty_like(release)
    if n == 0:
        return start
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().dispatch_scan_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        release.data_ptr(), hold.data_ptr(), count.data_ptr(), n,
        free.data_ptr(), K, start.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dispatch_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return start


def dispatch_scan(release: torch.Tensor, hold: torch.Tensor,
                  count: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """The plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    kind = release.device.type
    if kind == "cpu":
        return dispatch_scan_plain(release, hold, count, free)
    if kind == "cuda":
        return dispatch_scan_cuda(release, hold, count, free)
    raise ValueError(f"dispatch_scan: no kernel for device {release.device}")
