"""Slot-dispatch recursion of the finite-capacity replay: each row, in
dispatch order, takes the earliest-idle slot of a pool and holds it.

Replaces the serial `lax.scan` of `repro/cluster/events.py` (`_pool_step`
under `dispatch_scan` and `dispatch_prefix_scan`), which XLA lowered; the
reference has no Pallas kernel for it. Two entry points, each in three
forms:

* `dispatch_scan_batched_plain` / `dispatch_scan_plain`: the recursion
  step by step, every operation in f32 (a loop over numpy f32 scalars);
* `dispatch_scan_batched_cuda` / `dispatch_scan_cuda`: the hand-written
  kernel `csrc/dispatch_scan.cu`, one launch for all segments;
* `dispatch_scan_batched` / `dispatch_scan`: the wrappers. CPU tensors
  take the plain version, CUDA tensors the kernel; anything else raises.

Semantics, per segment p of a batch of P independent passes: rows
i < count[p] take slot si, the earliest-idle one (the lowest index among
equal minima), start = max(release_i, free[si]) and leave
free[si] = start + hold_i; rows at or past count[p] report their release.
Holds are >= 0 (the engine's are by construction; the kernel's sorted
pool relies on it). `count` is an int32 tensor, so on the card a pass
reads nothing back to the host. `free` (P, K) is the pools' state, read
at the start and updated in place to the state after the last row. The
single-pass forms take (n,) rows, one int32 count and a (K,) pool: the
P = 1 case of the same launch.

What bounds it on the card: the serial chain, one step per row below
count; see the .cu source for the two designs, chosen by K (the sorted
pool in registers up to `SORTED_MAX_SLOTS` slots, lane-private groups
above).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

#: launches of the CUDA kernel since the count was last set to 0
launches = 0

#: the largest pool the sorted design serves (4 warps x 32 lanes x 4
#: positions); a fixed cutover of the kernel's C entry, not a parameter
SORTED_MAX_SLOTS = 512
#: the kernel's designs, by the C entry's number
DESIGNS = ("sorted", "groups_shared", "groups_device")


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


def dispatch_scan_batched_plain(release: torch.Tensor, hold: torch.Tensor,
                                count: torch.Tensor, free: torch.Tensor
                                ) -> torch.Tensor:
    """(P, n) f32 starts, one `dispatch_scan_plain` a segment; `free`
    (P, K) is updated in place."""
    return torch.stack([dispatch_scan_plain(release[p], hold[p], count[p],
                                            free[p])
                        for p in range(release.shape[0])])


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("dispatch_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dispatch_scan_launch_as.argtypes = [i, i, p, p, p, i, i, p, i, p, p]
    lib.dispatch_scan_launch_as.restype = i
    lib.dispatch_scan_design.argtypes = [i]
    lib.dispatch_scan_design.restype = i
    return lib


def design_of(slots: int) -> str:
    """The design the kernel uses for a pool of `slots` slots: "sorted"
    (registers), "groups_shared" or "groups_device" (where the pool's keys
    live). Builds the kernel if needed."""
    d = _library().dispatch_scan_design(int(slots))
    if d < 0:
        raise ValueError(f"dispatch_scan: no design serves {slots} slots")
    return DESIGNS[d]


def _check(name, x, dtype, dev, shape):
    if (x.device != dev or x.dtype != dtype or x.dim() != len(shape)
            or not x.is_contiguous()
            or any(want is not None and got != want
                   for got, want in zip(x.shape, shape))):
        dims = ", ".join("*" if d is None else str(d) for d in shape)
        raise ValueError(
            f"dispatch_scan: {name} must be a contiguous ({dims}) {dtype} "
            f"tensor on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def dispatch_scan_batched_cuda(release: torch.Tensor, hold: torch.Tensor,
                               count: torch.Tensor, free: torch.Tensor
                               ) -> torch.Tensor:
    """Launch `csrc/dispatch_scan.cu` once for all P segments on the
    current stream, with the design the C entry chooses by K; same
    outputs as `dispatch_scan_batched_plain`."""
    return _launch(release, hold, count, free, None)


def _launch(release, hold, count, free, design):
    """The launch, with `design` one of `DESIGNS` where it can serve K, or
    None for the C entry's choice; chip_smoke.py forces a design to time
    the cutover."""
    global launches
    dev = release.device
    _check("release", release, torch.float32, dev, (None, None))
    P, n = release.shape
    _check("hold", hold, torch.float32, dev, (P, n))
    _check("count", count, torch.int32, dev, (P,))
    _check("free", free, torch.float32, dev, (P, None))
    K = free.shape[1]
    if P < 1 or K < 1:
        raise ValueError(f"dispatch_scan: no segment or no slot (P={P}, "
                         f"K={K})")
    lib = _library()
    d = (lib.dispatch_scan_design(K) if design is None
         else DESIGNS.index(design))
    start = torch.empty_like(release)
    if n == 0:
        return start
    err = lib.dispatch_scan_launch_as(
        d, dev.index if dev.index is not None else torch.cuda.current_device(),
        release.data_ptr(), hold.data_ptr(), count.data_ptr(), P, n,
        free.data_ptr(), K, start.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dispatch_scan kernel launch failed: CUDA error "
                           f"{err} (design {DESIGNS[d] if d >= 0 else d}, "
                           f"K={K})")
    launches += 1
    return start


def dispatch_scan_cuda(release: torch.Tensor, hold: torch.Tensor,
                       count: torch.Tensor, free: torch.Tensor
                       ) -> torch.Tensor:
    """The P = 1 launch on (n,) rows, one int32 count and a (K,) pool."""
    return _launch(*_one_segment(release, hold, count, free), None)[0]


def _one_segment(release, hold, count, free):
    if release.dim() != 1 or free.dim() != 1 or count.numel() != 1:
        raise ValueError(f"dispatch_scan_cuda: (n,) rows, one count and a "
                         f"(K,) pool, got {tuple(release.shape)}, "
                         f"{tuple(count.shape)}, {tuple(free.shape)}")
    return release[None], hold.reshape(1, -1), count.reshape(1), free[None]


def _route(fns, release: torch.Tensor, *args) -> torch.Tensor:
    kind = release.device.type
    if kind == "cpu":
        return fns[0](release, *args)
    if kind == "cuda":
        return fns[1](release, *args)
    raise ValueError(f"dispatch_scan: no kernel for device {release.device}")


def dispatch_scan(release: torch.Tensor, hold: torch.Tensor,
                  count: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """The plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    return _route((dispatch_scan_plain, dispatch_scan_cuda), release, hold,
                  count, free)


def dispatch_scan_batched(release: torch.Tensor, hold: torch.Tensor,
                          count: torch.Tensor, free: torch.Tensor
                          ) -> torch.Tensor:
    """(P, n) starts of P independent segments: the plain version for CPU
    tensors, one kernel launch for CUDA ones."""
    return _route((dispatch_scan_batched_plain, dispatch_scan_batched_cuda),
                  release, hold, count, free)
