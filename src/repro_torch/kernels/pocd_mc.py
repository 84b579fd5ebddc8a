"""Monte-Carlo PoCD and machine time of the Chronos strategies on
fixed-N job blocks: the paper's evaluation as a map (uniforms -> Pareto
attempt times -> each task's speculative race) and a reduce (a job meets
its deadline iff all N tasks do; its cost is the sum of machine time).

Replaces the two Pallas TPU kernels of `repro/kernels/pocd_mc.py`:
`pocd_mc_pallas` (body `_kernel`, one mode per launch) and
`pocd_mc_all_pallas` (body `_kernel_all`, every mode of `MODES` from one
shared Pareto transform). Three forms of each:

* `pocd_mc_plain` / `pocd_mc_all_plain`: plain PyTorch built from the
  specs' `tile_outcome` bodies, in the Pallas kernel's order of
  operations (att = t_min exp(-log u / beta)), on any device;
* `pocd_mc_cuda` / `pocd_mc_all_cuda`: the hand-written kernel
  `csrc/pocd_mc.cu`;
* `pocd_mc` / `pocd_mc_all`: the wrappers. CPU tensors take the plain
  version, CUDA tensors the kernel; anything else raises.

What bounds it on the card: bytes, the J N R f32 uniforms, beside about
forty instructions for each attempt time (IEEE logf, division, expf).
Every mode reads attempt times only through a minimum over a range of
slots (`slots_read`), and att(u) is non-increasing in u, so the kernel
takes the largest uniform of each range and forms one attempt time per
range, not R per task; `monotone_violations` checks that premise on the
card. One warp per job; a straggler's reactive outcome is formed once 32
are waiting, so a lane's cost sum runs in an order that depends only on
where the stragglers are: the fused launch's row m equals the
single-mode launch of mode m bit for bit. See the .cu source.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..strategies import get, names
from . import build

#: every registered strategy with a tile body is a mode; the fused sweep
#: evaluates them in this order (the reference derives it the same way)
MODES = tuple(n for n in names() if get(n).tile_outcome is not None)

#: the bodies `csrc/pocd_mc.cu` implements, in the order of its mode bits
KERNEL_MODES = ("clone", "srestart", "sresume")

#: launches of the CUDA kernel since the count was last set to 0:
#: `launches` by `pocd_mc`, `launches_all` by `pocd_mc_all`
launches = 0
launches_all = 0


def tile_inputs(u, t_min, beta, D, tau_est_frac, tau_kill_gap_frac):
    """The tile bodies' arguments: attempt times (J, N, R), t_min
    (J, 1, 1), tau_est, tau_kill and D (J, 1)."""
    tm = t_min[:, None, None]
    att = tm * torch.exp(-torch.log(u) / beta[:, None, None])
    tau_est = tau_est_frac * t_min[:, None]
    tau_kill = tau_est + tau_kill_gap_frac * t_min[:, None]
    return att, tm, tau_est, tau_kill, D[:, None]


def _outcome(mode, r, att, tm, tau_est, tau_kill, D, phi):
    completion, machine = get(mode).tile_outcome(att, tm, tau_est, tau_kill,
                                                 D, r[:, None], phi=phi)
    return (torch.all(completion <= D, dim=1).to(torch.float32),
            torch.sum(machine, dim=1))


def pocd_mc_plain(u, t_min, beta, D, r, *, mode="clone", tau_est_frac=0.3,
                  tau_kill_gap_frac=0.5, phi=0.25):
    """u (J, N, R) uniforms; t_min, beta, D (J,) f32; r (J,) i32.
    Returns (met (J,) f32, cost (J,) f32)."""
    _check_mode(mode, MODES)
    _check_slots(u, (mode,))
    pre = tile_inputs(u, t_min, beta, D, tau_est_frac, tau_kill_gap_frac)
    return _outcome(mode, r, *pre, phi)


def pocd_mc_all_plain(u, t_min, beta, D, r_modes, *, tau_est_frac=0.3,
                      tau_kill_gap_frac=0.5, phi=0.25):
    """r_modes (len(MODES), J) i32, one r row per mode in MODES order.
    Returns (met, cost), both (len(MODES), J) f32."""
    _check_slots(u, MODES)
    pre = tile_inputs(u, t_min, beta, D, tau_est_frac, tau_kill_gap_frac)
    out = [_outcome(m, r_modes[i], *pre, phi) for i, m in enumerate(MODES)]
    return (torch.stack([met for met, _ in out]),
            torch.stack([cost for _, cost in out]))


def near_deadline(u, t_min, beta, D, r, *, mode="clone", tau_est_frac=0.3,
                  tau_kill_gap_frac=0.5, phi=0.25, rtol=1e-5):
    """(J,) bool: jobs with a task whose completion lies within `rtol` of
    D. Two correct implementations whose log/exp differ in the last f32
    bit may disagree on met there, and only there."""
    att, tm, tau_est, tau_kill, Dc = tile_inputs(u, t_min, beta, D,
                                                 tau_est_frac,
                                                 tau_kill_gap_frac)
    completion, _ = get(mode).tile_outcome(att, tm, tau_est, tau_kill, Dc,
                                           r[:, None], phi=phi)
    return ((completion - Dc).abs() <= rtol * Dc).any(dim=1)


def slots_read(u, t_min, beta, D, r_rows: dict) -> dict:
    """{mode: (J, N) int64}: how many leading slots of each task `mode`'s
    outcome reads, the ranges `csrc/pocd_mc.cu` takes its maxima over.
    Slot 0 always (it decides whether the task straggles, T1 > D); then
    clone's slots k <= r; for a straggler, srestart's k <= r and
    sresume's k <= r + 1; at most R. A fused launch reads the largest
    count over its modes. No mode's outcome depends on a slot past its
    count."""
    R = u.shape[2]
    # T1 exactly as the plain version forms it
    att, _, _, _, Dc = tile_inputs(u, t_min, beta, D, 0.0, 0.0)
    strag = att[:, :, 0] > Dc
    out = {}
    for m, r in r_rows.items():
        r = r[:, None].to(torch.int64)
        if m == "clone":
            last = r.expand_as(strag)
        else:
            last = torch.where(strag, r if m == "srestart" else r + 1, 0)
        out[m] = 1 + last.clamp(0, R - 1)
    return out


def _check_mode(mode, known):
    if mode not in known:
        raise ValueError(f"pocd_mc: unknown mode {mode!r}; modes: {known}")


def _check_slots(u, modes):
    """S-Restart and S-Resume read slot 0 and at least one more."""
    if u.dim() == 3 and u.shape[2] < (1 if modes == ("clone",) else 2):
        raise ValueError(f"pocd_mc: modes {modes} need more attempt slots "
                         f"than R = {u.shape[2]}")


def _check_inputs(u, cols, r_rows):
    """Shapes, types, device and contiguity the kernel takes; (J, N, R)."""
    if u.dim() != 3:
        raise ValueError(f"pocd_mc: u must be (J, N, R), got "
                         f"{tuple(u.shape)}")
    J, N, R = u.shape
    dev = u.device
    for what, x, dtype in ([("u", u, torch.float32)]
                           + [(n, c, torch.float32) for n, c in cols]
                           + [(n, x, torch.int32) for n, x in r_rows]):
        want = (J, N, R) if what == "u" else (J,)
        if (x.device != dev or x.dtype != dtype or tuple(x.shape) != want
                or not x.is_contiguous()):
            raise ValueError(
                f"pocd_mc: {what} must be a contiguous {dtype} {want} "
                f"tensor on {dev}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    return J, N, R


@functools.lru_cache(maxsize=None)
def _library():
    fn = build.load("pocd_mc").pocd_mc_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [i, i] + [p] * 13 + [i, i, i] + [f, f, f] + [p]
    fn.restype = i
    return fn


def _launch(modes, u, t_min, beta, D, r_rows, tau_est_frac,
            tau_kill_gap_frac, phi):
    """Run the kernel for `modes` (names of KERNEL_MODES) with one (J,) r
    row each; returns (met, cost), both (len(modes), J)."""
    cols = (("t_min", t_min), ("beta", beta), ("D", D))
    J, N, R = _check_inputs(u, cols, list(zip(modes, r_rows)))
    _check_slots(u, modes)
    dev = u.device
    met = torch.empty((len(modes), J), dtype=torch.float32, device=dev)
    cost = torch.empty_like(met)
    if J == 0:
        return met, cost
    r_ptr, met_ptr, cost_ptr = [None] * 3, [None] * 3, [None] * 3
    bits = 0
    for i, mode in enumerate(modes):
        k = KERNEL_MODES.index(mode)
        bits |= 1 << k
        r_ptr[k] = r_rows[i].data_ptr()
        met_ptr[k] = met[i].data_ptr()
        cost_ptr[k] = cost[i].data_ptr()
    err = _library()(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        bits, u.data_ptr(), t_min.data_ptr(), beta.data_ptr(), D.data_ptr(),
        *r_ptr, *met_ptr, *cost_ptr, J, N, R, tau_est_frac,
        tau_kill_gap_frac, 1.0 - phi,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pocd_mc kernel launch failed: CUDA error {err}")
    return met, cost


def pocd_mc_cuda(u, t_min, beta, D, r, *, mode="clone", tau_est_frac=0.3,
                 tau_kill_gap_frac=0.5, phi=0.25):
    """Launch `csrc/pocd_mc.cu` for one mode on the current stream; same
    outputs as `pocd_mc_plain`."""
    global launches
    _check_mode(mode, KERNEL_MODES)
    met, cost = _launch((mode,), u, t_min, beta, D, (r,), tau_est_frac,
                        tau_kill_gap_frac, phi)
    if u.shape[0]:
        launches += 1
    return met[0], cost[0]


def pocd_mc_all_cuda(u, t_min, beta, D, r_modes, *, tau_est_frac=0.3,
                     tau_kill_gap_frac=0.5, phi=0.25):
    """One launch of `csrc/pocd_mc.cu` for every mode of MODES; same
    outputs as `pocd_mc_all_plain`."""
    global launches_all
    if MODES != KERNEL_MODES:
        raise ValueError(f"pocd_mc_all: the kernel evaluates {KERNEL_MODES}"
                         f", the registry's modes are {MODES}")
    if r_modes.dim() != 2 or r_modes.shape[0] != len(MODES):
        raise ValueError(f"pocd_mc_all: r_modes must be ({len(MODES)}, J), "
                         f"got {tuple(r_modes.shape)}")
    out = _launch(MODES, u, t_min, beta, D, tuple(r_modes), tau_est_frac,
                  tau_kill_gap_frac, phi)
    if u.shape[0]:
        launches_all += 1
    return out


@functools.lru_cache(maxsize=None)
def _monotone_library():
    fn = build.load("pocd_mc").pocd_mc_monotone_violations
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def monotone_violations(device="cuda") -> tuple:
    """(logf, expf): how many f32 inputs break the premise of the kernel's
    range minima, with the kernel build's own logf and expf: u in (0, 1]
    where logf of the next float up is smaller, x in [0, 89) where expf
    of the next float up is smaller. Both must be 0 for the kernel to
    equal the plain version bit for bit."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"monotone_violations: needs a CUDA device, got "
                         f"{dev}")
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    err = _monotone_library()(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pocd_mc monotonicity check failed: CUDA error "
                           f"{err}")
    return tuple(int(x) for x in out.cpu())


def _route(u, plain, cuda, what):
    kind = u.device.type
    if kind == "cpu":
        return plain
    if kind == "cuda":
        return cuda
    raise ValueError(f"{what}: no kernel for device {u.device}")


def pocd_mc(u, t_min, beta, D, r, mode="clone", tau_est_frac=0.3,
            tau_kill_gap_frac=0.5, phi=0.25):
    """Monte-Carlo PoCD and cost of one mode for J jobs of N tasks:
    (met (J,), cost (J,)). The plain version for CPU tensors, the CUDA
    kernel for CUDA ones."""
    fn = _route(u, pocd_mc_plain, pocd_mc_cuda, "pocd_mc")
    return fn(u, t_min, beta, D, r, mode=mode, tau_est_frac=tau_est_frac,
              tau_kill_gap_frac=tau_kill_gap_frac, phi=phi)


def pocd_mc_all(u, t_min, beta, D, r_modes, tau_est_frac=0.3,
                tau_kill_gap_frac=0.5, phi=0.25):
    """Every mode of MODES over shared uniforms: r_modes (len(MODES), J)
    i32 -> (met, cost), both (len(MODES), J). The plain version for CPU
    tensors, the CUDA kernel for CUDA ones."""
    fn = _route(u, pocd_mc_all_plain, pocd_mc_all_cuda, "pocd_mc_all")
    return fn(u, t_min, beta, D, r_modes, tau_est_frac=tau_est_frac,
              tau_kill_gap_frac=tau_kill_gap_frac, phi=phi)
