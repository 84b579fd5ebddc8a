"""Flash attention: causal, prefix-LM or bidirectional masks with an
optional sliding window, GQA, tanh logit softcap.

Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py`
(`flash_attention`, body `_kernel`), a forward, and on the backward pass
what XLA differentiates in the reference (its einsum attention, or the
512-key blocks of `_attend_blocked`). Forms:

* `attention_plain`: plain PyTorch, the reference's oracle
  `ref.attention_ref` op for op (f32 scores and softmax), on any device;
* `attention_cuda`: a hand-written kernel, chosen by `_route` from the
  input type. bfloat16 goes to `csrc/flash_attention_sm90.cu`: both
  products on Hopper's tensor cores (`wgmma`, bf16 operands, f32
  accumulators), K/V tiles fed by TMA through a 2-stage mbarrier ring,
  one producer warpgroup and two consumer warpgroups. float32 goes to
  `csrc/flash_attention.cu` (`attention_simt`): f32 products on the SIMT
  units, which hold the f32 tolerance of 2e-5 that bf16 or TF32 products
  would not;
* `attention_forward`: the routed forward. CPU tensors take the plain
  version, CUDA tensors the kernel; anything else raises;
* `attention_backward_plain`: the gradient in plain f32 torch, with a
  few (B, H, Sq, Sk) tensors at once, on any device;
* `attention_backward_cuda`: the gradient as a hand-written kernel, the
  scores recomputed tile by tile, no (Sq, Sk) tensor, no atomics.
  bfloat16 goes to `csrc/flash_attention_bwd_bf16.cu`: every product on
  Hopper's tensor cores (`wgmma`), P and dS as bf16 hi/lo pairs (dS as
  a triple for dq), tiles fed by TMA, producer and consumer warpgroups.
  float32 goes to `csrc/flash_attention_bwd.h` (built as
  `flash_attention_bwd_f32.cu`): f32 products on the SIMT units, P and dS
  in f32, which hold the f32 tolerance;
* `attention_backward`: the routed gradient, one operator as the
  forward is: the plain version for CPU tensors, the kernel for CUDA
  ones;
* `attention`: the wrapper, `attention_forward` under autograd with
  `attention_backward` as its gradient.

q is (B, H, Sq, D), k and v (B, K, Sk, D) with H % K == 0; query head h
reads kv head h // (H // K). The scale is D**-0.5, the softcap
cap * tanh(s / cap) comes after it, and the mask after that: query i may
read key j where, as the reference's `models/attention.py:_mask_bias`
allows it,
  * causal: j <= i, or both i and j below `prefix_len` (the prefix-LM
    mask); not causal: any key (`prefix_len` then changes nothing);
  * and, with a `window`, j > i - window (one-sided, causal or not).
Masked scores are -1e30. The Pallas kernel has the causal mask and no
mask only; the reference computes windows and prefixes with its einsum
`_attend`, the port with these kernels. The softmax is online with f32
running max, sum and accumulator; the output has q's type. The
tensor-core kernel rounds the probabilities p to bf16 before the product
with V (its only numerical change from the plain version; the running sum
adds the unrounded p).

A mask takes Sq == Sk only: positions start at 0 on both sides. For
causal attention the reference disagrees with itself otherwise: its
Pallas kernel aligns the mask top-left (k_pos <= q_pos), its oracle
bottom-right (tril(k=Sk-Sq)). Prefill always has Sq == Sk.

Head dims 64, 80 (hubert-xlarge), 112 (zamba2-7b's shared attention),
128 and 256. At D = 80 and 112 the tensor-core kernel reads D columns
and the TMA unit zero-fills its 128-column shared tiles past them: Q K^T
runs over K = D, and O += P V over N = D.

On DTensors (a sharded train step) the operator has a sharding rule
(`register_dtensor_rule`): on each mesh dim, q, k, v and the output are
all replicated, all sharded on the batch (dim 0), or all sharded on the
heads (dim 1) where the mesh extents divide both H and K, so that each
rank's query heads meet their own kv group. DTensor moves the inputs to
the cheapest of these, and the kernel (or on the CPU the plain version)
runs on each rank's local shard. A sequence-sharded q (the plan's
context-parallel fallback) has no strategy of its own: DTensor gathers
the sequence first. The backward runs `attention_backward` on the same
local shards.

What bounds it on the card: operations (4 B H D for each (query, key)
pair the mask allows: about half of Sq Sk under causal, S W - W^2 / 2
with a window W) against q, k, v and out read or written once; at the
serving shape 68.7 GFLOP, 0.069 ms at the bf16 tensor-core rate. The
gradient's five products take 10 B H D a pair. See the .cu sources for
each design.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..device import is_dtensor
from . import build

#: launches of either CUDA kernel since the count was last set to 0
launches = 0
#: launches of the tensor-core kernel (bfloat16) and of the SIMT kernel
launches_sm90 = 0
launches_simt = 0
#: launches of the backward kernel (one C call: its two kernels)
launches_backward = 0

#: head dims the kernels are instantiated for
KERNEL_HEAD_DIMS = (64, 80, 112, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _tile_dim(D) -> int:
    """The tensor-core kernel's shared tiles: D rounded up to whole
    128-byte rows of 64 bf16 (80 and 112 -> 128)."""
    return -(-D // 64) * 64


#: dynamic shared memory of one tensor-core block by head dim, as
#: `smem_bytes<D>()` in csrc/flash_attention_sm90.cu sizes it: the
#: 128-row Q tile and 2 stages of K and V (128 keys a tile, 64 at D 256),
#: `_tile_dim(D)` bf16 a row, 1024 bytes to align them, 5 mbarriers
SM90_SMEM_BYTES = {D: (128 + 4 * (64 if D == 256 else 128)) * _tile_dim(D)
                   * 2 + 1064 for D in KERNEL_HEAD_DIMS}


def _route(dtype, D) -> str:
    """The kernel that takes a CUDA call: "sm90" (tensor cores) for
    bfloat16, "simt" for float32; raises on any other type or head dim."""
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention: the kernels take head dims "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if dtype == torch.bfloat16:
        return "sm90"
    if dtype == torch.float32:
        return "simt"
    raise ValueError(f"attention: the kernels take float32 or bfloat16, got "
                     f"{dtype}")


def _check(q, k, v, causal, window=None, prefix_len=0):
    """(B, H, K, Sq, Sk, D) of a valid call; raises on anything else."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"attention: q, k, v must be 4-d, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if (tuple(k.shape) != (B, K, Sk, D) or tuple(v.shape) != tuple(k.shape)
            or K == 0 or H % K):
        raise ValueError(f"attention: q (B, H, Sq, D) and k, v (B, K, Sk, "
                         f"D) with H % K == 0, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"attention: window must be at least 1, got "
                         f"{window}")
    if prefix_len < 0:
        raise ValueError(f"attention: prefix_len must be >= 0, got "
                         f"{prefix_len}")
    if (causal or window is not None or prefix_len) and Sq != Sk:
        raise ValueError(
            f"attention: a causal, window or prefix mask needs Sq == Sk, got"
            f" Sq {Sq}, Sk {Sk}; the reference aligns the causal mask "
            f"top-left in its kernel and bottom-right in its oracle, so no "
            f"answer is the reference's")
    return B, H, K, Sq, Sk, D


def allowed_mask(Sq, Sk, causal, window=None, prefix_len=0, device=None):
    """(Sq, Sk) bool: query i may read key j (`_mask_bias`'s rule); None
    where every key is allowed."""
    i = torch.arange(Sq, device=device)[:, None]
    j = torch.arange(Sk, device=device)[None, :]
    allowed = None
    if causal:
        allowed = j <= i
        if prefix_len:
            allowed = allowed | ((i < prefix_len) & (j < prefix_len))
    if window is not None:
        near = j > i - window
        allowed = near if allowed is None else allowed & near
    return allowed


def _masked(s, causal, window, prefix_len):
    """The scores s (..., Sq, Sk) with -1e30 where the mask forbids."""
    allowed = allowed_mask(s.shape[-2], s.shape[-1], causal, window,
                           prefix_len, s.device)
    if allowed is None:
        return s
    return torch.where(allowed, s, torch.tensor(-1e30, device=s.device))


def attention_plain(q, k, v, causal=True, softcap=None, window=None,
                    prefix_len=0):
    """Plain PyTorch attention, as `ref.attention_ref` computes it, with
    the reference model's masks (`_mask_bias`)."""
    B, H, K, Sq, Sk, D = _check(q, k, v, causal, window, prefix_len)
    qg = q.reshape(B, K, H // K, Sq, D).to(torch.float32)
    s = torch.einsum("bkgsd,bktd->bkgst", qg,
                     k.to(torch.float32)) * (D ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = _masked(s, causal, window, prefix_len)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.to(torch.float32))
    return o.reshape(B, H, Sq, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _library(name):
    """The C entry `<name>_launch` of `csrc/<name>.cu`; both sources take
    the same arguments."""
    fn = getattr(build.load(name), f"{name}_launch")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([i, i] + [p] * 4 + [i] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), i, i, i, f, f, p])
    fn.restype = i
    return fn


def _check_cuda(q, k, v, causal, softcap, window=None, prefix_len=0,
                tma=True) -> str:
    """Raise on a call that neither kernel takes; else `_route`'s pick for
    q's type. `tma=False` leaves out the tensor-core kernel's alignment
    rule (the backward kernel reads element by element)."""
    B, H, K, Sq, Sk, D = _check(q, k, v, causal, window, prefix_len)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"attention: the kernel needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention: q, k, v must have one type, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    route = _route(q.dtype, D)
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("attention: the head dim must be contiguous")
    if B * H > 65535 or Sk == 0:
        raise ValueError(f"attention: the kernel takes B * H <= 65535 and "
                         f"Sk > 0, got B * H = {B * H}, Sk = {Sk}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"attention: softcap must be positive, got "
                         f"{softcap}")
    if route == "sm90" and tma:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16 or any(s % 8 for s in _bhs_strides(x)):
                raise ValueError(
                    f"attention: the tensor-core kernel needs {name} 16-byte "
                    f"aligned with (b, h, s) strides that are multiples of "
                    f"8, got strides {tuple(x.stride())}")
    return route


def _bhs_strides(x):
    """x's element strides over (b, h, s); a dim of size 1 is never
    stepped, so it gets the dense stride, which the TMA unit accepts."""
    dense = (x.shape[1] * x.shape[2] * x.shape[3], x.shape[2] * x.shape[3],
             x.shape[3])
    return [x.stride(i) if x.shape[i] > 1 else dense[i] for i in range(3)]


_SOURCE = {"sm90": "flash_attention_sm90", "simt": "flash_attention"}


def kernel_window(Sk, window) -> int:
    """The window as the kernels take it: 0 for none. A window of at
    least Sk allows every key at or after i - Sk + 1 <= 0, so it is none.
    (The kernels' mask and tile ranges ignore a prefix without causal and
    cut one at Sk, so prefix_len goes to them as it is.)"""
    return 0 if window is None or window >= Sk else int(window)


def _launch(route, q, k, v, causal, softcap, window=None, prefix_len=0):
    """Run the route's kernel on the current stream and count the launch;
    returns the output."""
    global launches, launches_sm90, launches_simt
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)  # q's strides when q is dense
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*[
        s for x in (q, k, v, out) for s in _bhs_strides(x)])
    dev = q.device
    name = _SOURCE[route]
    err = _library(name)(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, H, K, Sq, Sk, D, strides, int(bool(causal)),
        kernel_window(Sk, window), int(prefix_len), D ** -0.5, 0.0 if softcap is None else float(softcap),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches += 1
    if route == "sm90":
        launches_sm90 += 1
    else:
        launches_simt += 1
    return out


def attention_simt(q, k, v, causal=True, softcap=None, window=None,
                   prefix_len=0):
    """Launch `csrc/flash_attention.cu` (f32 SIMT products) on float32 or
    bfloat16 inputs. The f32 route; on bfloat16 it is the previous design,
    kept as a baseline and never called from the path."""
    _check_cuda(q, k, v, causal, softcap, window, prefix_len)
    return _launch("simt", q, k, v, causal, softcap, window, prefix_len)


def attention_cuda(q, k, v, causal=True, softcap=None, window=None,
                   prefix_len=0):
    """Launch the kernel `_route` picks for q's type on the current
    stream: bfloat16 on the tensor cores (the TMA unit needs 16-byte
    aligned pointers and (b, h, s) strides that are multiples of 8),
    float32 on the SIMT units. q, k, v may be strided views (the model
    passes (B, S, heads, D) activations seen as (B, heads, S, D)) as long
    as D is contiguous; the output has q's layout. No fallback: a build
    or launch error raises."""
    route = _check_cuda(q, k, v, causal, softcap, window, prefix_len)
    return _launch(route, q, k, v, causal, softcap, window, prefix_len)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, softcap: Optional[float], window: Optional[int],
                prefix_len: int) -> torch.Tensor:
    mask = dict(causal=causal, softcap=softcap, window=window,
                prefix_len=prefix_len)
    kind = q.device.type
    if kind == "cpu":
        return attention_plain(q, k, v, **mask)
    if kind == "cuda":
        return attention_cuda(q, k, v, **mask)
    raise ValueError(f"attention: no kernel for device {q.device}")


@_forward_op.register_fake
def _forward_fake(q, k, v, causal, softcap, window, prefix_len):
    """The output of either route with no work: the kernel's takes q's
    layout (`empty_like`), the plain version's is contiguous."""
    _check(q, k, v, causal, window, prefix_len)
    if q.device.type == "cuda":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return q.new_empty(q.shape)
    raise ValueError(f"attention: no kernel for device {q.device}")


def _shards_divide(shapes, input_specs) -> bool:
    """A strategy of the operator is valid where every sharded dim of q,
    k and v (of `shapes`) divides its mesh extents: a head-sharded q and
    k then give each rank H/n query heads and their K/n kv heads."""
    for shape, spec in zip(shapes, input_specs):
        cuts = [1] * len(shape)
        for mdim, plc in enumerate(spec.placements):
            if plc.is_shard():
                cuts[plc.dim] *= spec.mesh.size(mdim)
        if any(n % c for n, c in zip(shape, cuts)):
            return False
    return True


@functools.lru_cache(maxsize=None)
def register_dtensor_rule() -> None:
    """Register the DTensor sharding rule of `repro_torch::flash_attention`
    (once; `attention_forward` calls it when it is given DTensors). On
    each mesh dim: all replicated, all sharded on the batch, or all
    sharded on the heads; `_shards_divide` drops a combination whose
    shards would be uneven."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops.utils import \
        expand_to_full_mesh_op_strategy

    one_dim = [[Replicate()] * 4, [Shard(0)] * 4, [Shard(1)] * 4]

    def strategy(op_schema):
        args = op_schema.args_schema[:3]
        out = expand_to_full_mesh_op_strategy(args[0].mesh, op_schema,
                                              one_dim, input_index=1)
        shapes = [a.shape for a in args]
        out.strategies = [s for s in out.strategies
                          if _shards_divide(shapes, s.input_specs)]
        return out

    DTensor._op_dispatcher.sharding_propagator.register_op_strategy(
        torch.ops.repro_torch.flash_attention.default, strategy,
        RuntimeSchemaInfo(static_argnum=3))


def attention_forward(q, k, v, causal=True, softcap=None, window=None,
                      prefix_len=0):
    """Flash attention forward with no autograd record: q (B, H, Sq, D),
    k/v (B, K, Sk, D) -> (B, H, Sq, D) in q's type. The plain version for
    CPU tensors, the CUDA kernel for CUDA ones.

    It is one operator, `torch.ops.repro_torch.flash_attention`, so that
    a dispatch mode (`launch/op_analyzer.py`) sees one entry a call on
    either route, fake tensors included, and costs the kernel's own work
    rather than the plain version's (B, H, Sq, Sk) scores. On DTensors it
    runs on each rank's local shards under `register_dtensor_rule`."""
    if is_dtensor(q):
        register_dtensor_rule()
    return _forward_op(q, k, v, bool(causal),
                       None if softcap is None else float(softcap),
                       None if window is None else int(window),
                       int(prefix_len))


def attention_backward_plain(q, k, v, dout, causal=True, softcap=None,
                             window=None, prefix_len=0):
    """(dq, dk, dv) of `attention` given the output's gradient `dout`,
    each in its input's type: the plain version, on any device.

    The Pallas kernel has no backward (the reference differentiates its
    attention through XLA), so this is ordinary torch code in f32: the
    scores are recomputed with the softcap and the mask, then
    P = softmax(s), dP = dO V^T, D = rowsum(P * dP), dS = P * (dP - D),
    times the softcap's derivative 1 - tanh^2(s / cap) of the scaled
    scores; dq = scale dS K, dk = scale dS^T Q and dv = P^T dO, each
    summed over the query heads of a kv group. Memory: a few (B, H, Sq,
    Sk) f32 tensors at once.

    D is rowsum(dO * O) in exact arithmetic. Formed from a bf16 output it
    is not accurate enough where the softmax is peaked and dP - D cancels
    (scores past the softcap): dq then misses the bf16 criterion of a
    mean error within 2^-8 of its mean size against autograd through
    `attention_plain`. From the recomputed f32 P it is what autograd of
    the softmax forms, so no output is saved."""
    B, H, K, Sq, Sk, D = _check(q, k, v, causal, window, prefix_len)
    f32 = torch.float32
    scale = D ** -0.5
    qg = q.reshape(B, K, H // K, Sq, D).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    do = dout.reshape(B, K, H // K, Sq, D).to(f32)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, kf) * scale
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    s = _masked(s, causal, window, prefix_len)
    p = torch.softmax(s, dim=-1)
    del s
    dv = torch.einsum("bkgst,bkgsd->bktd", p, do)
    dp = torch.einsum("bkgsd,bktd->bkgst", do, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    del p, dp
    if softcap is not None:
        ds = ds * (1.0 - t * t)
        del t
    ds = ds * scale
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf).reshape(B, H, Sq, D)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


#: the backward kernel's source of each input type: the tensor-core
#: kernel for bfloat16, `csrc/flash_attention_bwd.h` for float32
_BWD_SOURCE = {torch.float32: "flash_attention_bwd_f32",
               torch.bfloat16: "flash_attention_bwd_bf16"}

#: rows of the tensor-core backward's (B H, Sq) lse and D buffer are
#: padded to this, so each 64-row tile's entries are one aligned copy
BWD_STAT_ROWS = 64

#: dynamic shared memory of the tensor-core backward's two launches by
#: head dim, the larger of `dq_smem_bytes<D>()` (the 64-row Q and dO
#: tiles, 4 stages of K and V, 32 keys a tile at D 256 and 64 below, the
#: rows' statistics of both consumers, 9 mbarriers) and
#: `dkdv_smem_bytes<D>()` (K, V and 2 stages of Q and dO, 64 rows each,
#: 2 x 64 (lse, D) pairs, the 64 x 64 f32 hand-over, 5 mbarriers) in
#: csrc/flash_attention_bwd_bf16.cu, each with 1024 bytes to align
BWD_SM90_SMEM_BYTES = {D: max(
    (128 + 8 * (32 if D == 256 else 64)) * _tile_dim(D) * 2 + 6144 + 1096,
    6 * 64 * _tile_dim(D) * 2 + 2 * 64 * 8 + 64 * 64 * 4 + 1064)
    for D in KERNEL_HEAD_DIMS}


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits_heads(B, H, K, Sk, device) -> bool:
    """Whether the tensor-core backward gives each query head its own
    dk/dv block. One a kv head gives B K Sk/64 blocks, each summing its
    group's heads in order; where that is less than one wave (fewer
    blocks than multiprocessors) and the group has heads to split
    (gemma2-2b's training microbatch: 128 blocks on 132 SMs, the longest
    under causal twice the mean), each head takes a block and a third
    launch sums their (2, H/K, B K, Sk, D) f32 partials, heads in order.
    On an H100 the split took 0.58 of the unsplit time at 128 blocks and
    1.07 and 1.08 of it at 256 and 1024 (`chip_smoke.py` phase 25 (a),
    `bwd_route_times`). The choice depends on the shapes and the card
    alone, so two calls give the same bits."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return H > K and B * K * -(-Sk // 64) < _sm_count(index)


def _tma_ready(x):
    """x if the TMA unit can read it (16-byte aligned, (b, h, s) strides
    multiples of 8 elements), else a dense copy of it in a fresh
    allocation: the same values for the same kernel."""
    if x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in _bhs_strides(x)):
        return x
    return x.clone(memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=None)
def _backward_library(name):
    """The C entry `<name>_launch` of `csrc/<name>.cu`; the bfloat16 one
    takes a pointer more (the per-head partials of `splits_heads`)."""
    fn = getattr(build.load(name), f"{name}_launch")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pointers = 9 if name == _BWD_SOURCE[torch.bfloat16] else 8
    fn.argtypes = ([i] + [p] * pointers + [i] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), i, i, i, f, f, p])
    fn.restype = i
    return fn


def attention_backward_cuda(q, k, v, dout, causal=True, softcap=None,
                            window=None, prefix_len=0):
    """Launch the backward kernel of q's type on the current stream (see
    `_BWD_SOURCE`): (dq, dk, dv) in q's type and its inputs' layouts. q,
    k, v may be the model's strided views (D contiguous); dout is made
    D-contiguous if it is not. Between the kernel's two launches an f32
    buffer holds each row's statistics: for bfloat16 its lse and D, (B H,
    Sq rounded up to BWD_STAT_ROWS) pairs; for float32 its max, sum and D,
    (3, B H Sq). The bfloat16 kernel's tiles come by TMA: an input it
    cannot read that way (`_tma_ready`) is copied first; where its dk/dv
    blocks would be too few, each query head gets its own
    (`splits_heads`). No fallback: a build or launch error raises."""
    global launches_backward
    _check_cuda(q, k, v, causal, softcap, window, prefix_len, tma=False)
    if dout.shape != q.shape or dout.dtype != q.dtype or \
            dout.device != q.device:
        raise ValueError(f"attention backward: dout must be like q "
                         f"{tuple(q.shape)} {q.dtype} on {q.device}, got "
                         f"{tuple(dout.shape)} {dout.dtype} on "
                         f"{dout.device}")
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    pointers = []
    if q.dtype == torch.bfloat16:
        q, k, v, dout = (_tma_ready(x) for x in (q, k, v, dout))
        rows = -(-Sq // BWD_STAT_ROWS) * BWD_STAT_ROWS
        stats = torch.empty((B * H * rows, 2), dtype=torch.float32,
                            device=q.device)
        part = torch.empty((2, H // K, B * K, Sk, D), dtype=torch.float32,
                           device=q.device) \
            if splits_heads(B, H, K, Sk, q.device) else None
        pointers = [None if part is None else part.data_ptr()]
    else:
        stats = torch.empty((3, B * H * Sq), dtype=torch.float32,
                            device=q.device)
    strides = (ctypes.c_longlong * 21)(*[
        s for x in (q, k, v, dout, dq, dk, dv) for s in _bhs_strides(x)])
    dev = q.device
    name = _BWD_SOURCE[q.dtype]
    err = _backward_library(name)(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), *pointers, B, H, K, Sq, Sk, D, strides,
        int(bool(causal)),
        kernel_window(Sk, window), int(prefix_len), D ** -0.5,
        0.0 if softcap is None else float(softcap),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches_backward += 1
    return dq, dk, dv


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=())
def _backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 dout: torch.Tensor, causal: bool, softcap: Optional[float],
                 window: Optional[int], prefix_len: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    mask = dict(causal=causal, softcap=softcap, window=window,
                prefix_len=prefix_len)
    kind = q.device.type
    if kind == "cpu":
        return attention_backward_plain(q, k, v, dout, **mask)
    if kind == "cuda":
        return attention_backward_cuda(q, k, v, dout, **mask)
    raise ValueError(f"attention backward: no kernel for device {q.device}")


@_backward_op.register_fake
def _backward_fake(q, k, v, dout, causal, softcap, window, prefix_len):
    """The gradients of either route with no work: the kernel's take
    their inputs' layouts, the plain version's are contiguous."""
    _check(q, k, v, causal, window, prefix_len)
    if q.device.type == "cuda":
        return tuple(torch.empty_like(x) for x in (q, k, v))
    if q.device.type == "cpu":
        return tuple(x.new_empty(x.shape) for x in (q, k, v))
    raise ValueError(f"attention backward: no kernel for device {q.device}")


def attention_backward(q, k, v, dout, causal=True, softcap=None,
                       window=None, prefix_len=0):
    """(dq, dk, dv) of `attention` given the output's gradient `dout`,
    each in its input's type: `attention_backward_plain` for CPU tensors,
    the kernel (`attention_backward_cuda`) for CUDA ones, anything else
    raises. One operator, `torch.ops.repro_torch.flash_attention_backward`,
    so that a dispatch mode (`launch/op_analyzer.py`) sees one entry a
    call, fake tensors included, and costs the kernel's own work."""
    return _backward_op(q, k, v, dout, bool(causal),
                        None if softcap is None else float(softcap),
                        None if window is None else int(window),
                        int(prefix_len))


def _backward_local(q, k, v, dout, plc, mask):
    """`attention_backward` on DTensors: q, k, v and dout moved to the
    placements `plc` the forward ran under (one of the rule's
    strategies), the gradient of each rank's local shard, and each
    gradient given back in its input's placements."""
    from torch.distributed.tensor import DTensor
    mesh = q.device_mesh
    local = [x.redistribute(mesh, plc).to_local() for x in (q, k, v, dout)]
    grads = attention_backward(*local, **mask)
    return tuple(
        DTensor.from_local(g, mesh, plc, run_check=False).redistribute(
            mesh, x.placements)
        for g, x in zip(grads, (q, k, v)))


class _Attention(torch.autograd.Function):
    """`attention_forward` with `attention_backward` as its gradient;
    saves q, k and v (the backward recomputes the scores)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softcap, window, prefix_len):
        ctx.mask = dict(causal=causal, softcap=softcap, window=window,
                        prefix_len=prefix_len)
        out = attention_forward(q, k, v, **ctx.mask)
        ctx.placements = tuple(out.placements) if is_dtensor(out) else None
        ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        if ctx.placements is not None:
            dq, dk, dv = _backward_local(q, k, v, dout, ctx.placements,
                                         ctx.mask)
        else:
            dq, dk, dv = attention_backward(q, k, v, dout, **ctx.mask)
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, causal=True, softcap=None, window=None, prefix_len=0):
    """Flash attention, differentiable: q (B, H, Sq, D), k/v (B, K, Sk, D)
    -> (B, H, Sq, D) in q's type, under the mask of (causal, window,
    prefix_len). The forward is `attention_forward` (the plain version for
    CPU tensors, the CUDA kernel for CUDA ones), the gradient
    `attention_backward` (routed the same way)."""
    return _Attention.apply(q, k, v, causal, softcap, window, prefix_len)
