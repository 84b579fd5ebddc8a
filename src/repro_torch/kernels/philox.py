"""Counter-keyed Philox4x32-10 uniforms: row t of the result holds `cols`
f32 uniforms in [1e-7, 1) drawn at (cells[t], rows[t]) under a two-word
key, and depends on nothing else: not on the other rows, their number or
their order.

Replaces the reference's key folding (`jax.random.fold_in(key, rid)`,
`src/repro/serve/scheduler.py:162`; `fold_in(key, block)` in
`src/repro/fleet/runner.py`), which XLA lowered; there is no Pallas
kernel for it. Three forms:

* `philox_rows_plain`: the generator in int64 torch arithmetic, bit-exact
  on the CPU and on the card (each 32 x 32-bit product is formed from
  16-bit halves of one factor, so no int64 product overflows);
* `philox_rows_cuda`: the hand-written kernel `csrc/philox_rows.cu`, one
  launch for every row;
* `philox_rows`: the wrapper. CPU tensors take the plain version, CUDA
  tensors the kernel; anything else raises.

Counter words (cell low 32 bits, cell high 32 bits, row, column // 4);
output word column % 4 becomes (x >> 8) * 2^-24, then
`sim.draws.to_uniform`'s affine map. `philox4x32` is the raw generator,
for the known-answer vectors of Salmon et al. (SC'11).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

#: launches of the CUDA kernel since the count was last set to 0
launches = 0

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
ROUNDS = 10

# the affine map of sim/draws.py:to_uniform, in f32
MINVAL = float(np.float32(1e-7))
SPAN = float(np.float32(1.0) - np.float32(1e-7))
_TWO_POW_MINUS_24 = 2.0 ** -24


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for uint32 values held in int64:
    m times each 16-bit half of x is below 2^48."""
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    t = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (t >> 32), t & _MASK


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = ROUNDS):
    """The four output words of Philox4x32-`rounds` at counter (c0..c3)
    and key (k0, k1): int64 tensors (or ints for the key) holding uint32
    values, broadcast together."""
    for i in range(rounds):
        if i:
            k0 = (k0 + W0) & _MASK
            k1 = (k1 + W1) & _MASK
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_rows_plain(cells: torch.Tensor, rows: torch.Tensor, cols: int,
                      key) -> torch.Tensor:
    """(T, cols) f32 uniforms; cells, rows (T,) int64 on one device."""
    k0, k1 = (int(k) & _MASK for k in key)
    groups = -(-int(cols) // 4)
    g = torch.arange(groups, dtype=torch.int64, device=cells.device)[None]
    c0 = (cells & _MASK)[:, None]
    c1 = ((cells >> 32) & _MASK)[:, None]
    c2 = (rows & _MASK)[:, None]
    words = torch.stack(philox4x32(c0, c1, c2, g, k0, k1), dim=-1)
    x = words.reshape(cells.shape[0], 4 * groups)[:, :cols]
    u = (x >> 8).to(torch.float32).mul_(_TWO_POW_MINUS_24)
    return u.mul_(SPAN).add_(MINVAL).clamp_min_(MINVAL)


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("philox_rows")
    p, i, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_uint)
    lib.philox_rows_launch.argtypes = [i, p, p, ll, i, u, u, ctypes.c_float,
                                       ctypes.c_float, p, p]
    lib.philox_rows_launch.restype = i
    lib.philox_raw_launch.argtypes = [i, p, p, i, p, p]
    lib.philox_raw_launch.restype = i
    return lib


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _check(name, x, dtype, dev, shape):
    if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(
            f"philox_rows: {name} must be a contiguous {shape} {dtype} "
            f"tensor on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def philox_rows_cuda(cells: torch.Tensor, rows: torch.Tensor, cols: int,
                     key) -> torch.Tensor:
    """Launch `csrc/philox_rows.cu` once on the current stream; same
    output as `philox_rows_plain`."""
    global launches
    dev = cells.device
    T = int(cells.shape[0]) if cells.dim() == 1 else -1
    _check("cells", cells, torch.int64, dev, (T,))
    _check("rows", rows, torch.int64, dev, (T,))
    if int(cols) < 1:
        raise ValueError(f"philox_rows: cols must be >= 1, got {cols}")
    out = torch.empty((T, int(cols)), dtype=torch.float32, device=dev)
    if T == 0:
        return out
    k0, k1 = (int(k) & _MASK for k in key)
    err = _library().philox_rows_launch(
        _index(dev), cells.data_ptr(), rows.data_ptr(), T, int(cols), k0, k1,
        SPAN, MINVAL, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"philox_rows kernel launch failed: CUDA error "
                           f"{err} (T={T}, cols={cols})")
    launches += 1
    return out


def philox_raw_cuda(ctr: np.ndarray, key: np.ndarray) -> np.ndarray:
    """The kernel's generator on n (counter, key) pairs, uint32 (n, 4) and
    (n, 2), on the current card; (n, 4) uint32 words on the host. Not
    counted: the known-answer check, not a draw."""
    ctr = np.ascontiguousarray(ctr, np.uint32)
    key = np.ascontiguousarray(key, np.uint32)
    n = ctr.shape[0]
    dev = torch.device("cuda", torch.cuda.current_device())
    on = lambda a: torch.from_numpy(a.view(np.int32)).to(dev)
    c, k = on(ctr), on(key)
    out = torch.empty((n, 4), dtype=torch.int32, device=dev)
    err = _library().philox_raw_launch(
        _index(dev), c.data_ptr(), k.data_ptr(), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"philox_raw kernel launch failed: CUDA error "
                           f"{err}")
    return out.cpu().numpy().view(np.uint32)


def philox_rows(cells: torch.Tensor, rows: torch.Tensor, cols: int,
                key) -> torch.Tensor:
    """(T, cols) uniforms at (cells[t], rows[t]) under `key` (two 32-bit
    words): the plain version for CPU tensors, the kernel for CUDA ones."""
    kind = cells.device.type
    if kind == "cpu":
        return philox_rows_plain(cells, rows, cols, key)
    if kind == "cuda":
        return philox_rows_cuda(cells, rows, cols, key)
    raise ValueError(f"philox_rows: no kernel for device {cells.device}")
