"""Algorithm-1 grid solve: U(r) over r = 0..r_max-1 per job, its first
argmax r*, and PoCD / cost re-evaluated at r*.

Replaces the Pallas TPU kernel `repro/kernels/grid_solve.py`
(`grid_solve_pallas`, body `_kernel` / `_solve_tile`). Three forms:

* `grid_solve_plain`: plain PyTorch built from the spec's closures, the
  same steps as the reference's `_solve_tile` on any device;
* `grid_solve_cuda`: the hand-written kernel `csrc/grid_solve.cu`;
* `grid_solve`: the wrapper. CPU tensors take the plain version, CUDA
  tensors the kernel; anything else raises.

What bounds it on the card: operations. It reads 10 f32 columns and
writes 6 per job, but S-Restart's cost adds a 128-node Gauss-Legendre
quadrature, two powf per node, at every (job, r). The kernel gives each
job one warp: lanes split the quadrature nodes (four per lane, a shuffle
sum) and then the r grid (lane = r), and the first argmax over r is a
shuffle reduction in registers, so the (J, r_max) grid never reaches
device memory. See the .cu source for the tie and NaN rules.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import cost as core_cost
from ..core.utility import JobSpec
from ..strategies.spec import (FORMS, cost_of_spec, get, pocd_of_spec,
                               utility_of)
from . import build

#: launches of the CUDA kernel since the count was last set to 0
launches = 0


def _sub_specs(spec):
    """A composite's component specs in choose-id order, else the spec."""
    if spec.components:
        return tuple(get(n) for n in spec.components)
    return (spec,)


def grid_solve_plain(spec, job: JobSpec, r_max: int):
    """(r_opt i32, choice i32, utility, pocd, cost, sat i32), all (J,)."""
    subs = _sub_specs(spec)
    col = JobSpec(*(x[:, None] for x in job))        # (J, 1) columns
    J = job.t_min.shape[0]
    rs = torch.arange(r_max, dtype=torch.float32,
                      device=job.t_min.device)[None, :]
    u = utility_of(subs[0], rs, col)
    for s in subs[1:]:
        u = torch.maximum(u, utility_of(s, rs, col))  # U(r) = max_s U_s(r)
    i = torch.argmax(u, dim=1)    # first maximum; an all -inf row gives 0
    u_star = torch.gather(u, 1, i[:, None])[:, 0]
    rf = i.to(torch.float32)[:, None]
    # PoCD / cost evaluated at r*, not read back from the grid
    if len(subs) == 1:
        choice = torch.zeros(J, dtype=torch.int32, device=u.device)
        p_star = pocd_of_spec(spec, rf, col)[:, 0]
        c_star = cost_of_spec(spec, rf, col)[:, 0]
    else:
        su = torch.stack([utility_of(s, rf, col)[:, 0] for s in subs])
        choice = torch.argmax(su, dim=0).to(torch.int32)
        p_star = pocd_of_spec(subs[0], rf, col)[:, 0]
        c_star = cost_of_spec(subs[0], rf, col)[:, 0]
        for k, s in enumerate(subs[1:], start=1):
            hit = choice == k
            p_star = torch.where(hit, pocd_of_spec(s, rf, col)[:, 0], p_star)
            c_star = torch.where(hit, cost_of_spec(s, rf, col)[:, 0], c_star)
    sat = (i >= r_max - 1).to(torch.int32)
    return i.to(torch.int32), choice, u_star, p_star, c_star, sat


def forms_mask(spec) -> int:
    """Bit f set for each closed-form family (FORMS id f) the kernel must
    evaluate; a composite's choice id is the rank of its bit, so its
    components must be in increasing family order."""
    ids = [FORMS.index(s.form) for s in _sub_specs(spec)]
    if ids != sorted(set(ids)):
        raise ValueError(f"strategy {spec.name!r}: components must be "
                         f"distinct closed-form families in FORMS order")
    return sum(1 << f for f in ids)


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("grid_solve")
    fn = lib.grid_solve_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i] + [p] * 12 + [i, i, i] + [p] * 6 + [p]
    fn.restype = i
    return fn


@functools.lru_cache(maxsize=None)
def _quadrature_on(device: torch.device):
    return core_cost.GL_U.to(device), core_cost.GL_W.to(device)


def grid_solve_cuda(spec, job: JobSpec, r_max: int):
    """Launch `csrc/grid_solve.cu` on the current stream; same outputs as
    `grid_solve_plain`."""
    global launches
    r_max = int(r_max)
    if r_max < 1:
        raise ValueError(f"r_max must be >= 1, got {r_max}")
    mask = forms_mask(spec)
    dev = job.t_min.device
    J = job.t_min.shape[0]
    for name, x in zip(JobSpec._fields, job):
        if (x.device != dev or x.dtype != torch.float32
                or x.shape != (J,) or not x.is_contiguous()):
            raise ValueError(
                f"grid_solve_cuda: column {name} must be a contiguous f32 "
                f"({J},) tensor on {dev}, got {x.dtype} {tuple(x.shape)} "
                f"on {x.device}")
    gl_u, gl_w = _quadrature_on(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty(J, **i32), torch.empty(J, **i32),
            torch.empty(J, **f32), torch.empty(J, **f32),
            torch.empty(J, **f32), torch.empty(J, **i32))
    if J == 0:
        return outs
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library()(dev.index if dev.index is not None
                     else torch.cuda.current_device(),
                     *(x.data_ptr() for x in job), gl_u.data_ptr(),
                     gl_w.data_ptr(), J, r_max, mask,
                     *(o.data_ptr() for o in outs), stream)
    if err != 0:
        raise RuntimeError(f"grid_solve kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return outs


def grid_solve(spec, job: JobSpec, r_max: int):
    """The plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    kind = job.t_min.device.type
    if kind == "cpu":
        return grid_solve_plain(spec, job, r_max)
    if kind == "cuda":
        return grid_solve_cuda(spec, job, r_max)
    raise ValueError(f"grid_solve: no kernel for device {job.t_min.device}")
