"""Op-level cost analysis of a traced step; counterpart of
`repro.launch.hlo_analyzer`.

The reference reads its three roofline inputs from compiled, partitioned
XLA HLO. The port has no compiler between the model and the card: eager
PyTorch runs one aten op at a time. `OpAnalyzer` is a
`TorchDispatchMode` that records every op a step dispatches (on fake
tensors, with nothing allocated, or on the card) and costs each:

  * dot_flops: 2 x |result| x K for every contraction (`mm`, `addmm`,
    `bmm`, `baddbmm`, `mv`, `dot`, `convolution` and its backward);
  * hbm_bytes: the bytes of the operands plus the results of every op
    that is not a view, an allocation or a metadata op (a broadcast
    operand, stride 0, counts the elements it holds). This differs
    from the reference on purpose: in eager PyTorch every such op reads
    its operands from device memory and writes its result there, and
    there is no fusion to take out, so the reference's fused-away lists
    have no counterpart. Writes in place: an op that overwrites its
    destination (`copy_`, `fill_`, `zero_`, an `out=`) does not read it;
    an op that scatters into it (`index_put_`, `index_copy_`,
    `scatter_`, ...) moves its other operands twice (read, then written
    into place), as the reference costs its dynamic-update-slice; any
    other in-place op reads and writes it;
  * wire_bytes: the functional collectives (`_c10d_functional`, and
    DTensor's `_dtensor.shard_dim_alltoall`) with the reference's ring
    factors over a group of n: all-gather
    |result|(n-1)/n, reduce-scatter and all-to-all |operand|(n-1)/n,
    all-reduce 2|operand|(n-1)/n;
  * op counts by name.

The hand-written kernels count as one entry each, on every route:
`kernels/flash_attention.py`'s forward is the operator
`repro_torch.flash_attention`, whose inner ops (the plain version's
(B, H, Sq, Sk) scores on the CPU) this mode never sees. Its cost is the
kernel's: 4 B H D over the (query, key) pairs the mask allows, and the
bytes of q, k, v and the output. Its backward is the operator
`repro_torch.flash_attention_backward`, costed at its kernel's work:
`BWD_PRODUCTS` products of 2 B H D over the allowed pairs, and the bytes
of q, k, v and dO read and dq, dk and dv written.

Trip counts: a train step runs its microbatches in a Python loop;
`repeat(n)` multiplies what runs inside it, so a dry run traces one
microbatch and counts it n times (the reference's loop correction).

Ops are kept as signatures (name, operand and result shapes, the scalar
arguments) with their counts, so `log_of` can store them and
`summary_of` cost them again after a rule changes (`dryrun.reanalyze`).

DTensor programs (a sharded step, `launch/dryrun.py`'s mesh cells):
the mode steps aside for every op on DTensors, so that DTensor runs it
as each rank's local ops and the collectives of its redistributions,
which the mode then records at the local shapes of this rank. DTensor's
bookkeeping is not work and is not recorded: the global-shape ops its
sharding propagation runs on fake tensors to learn an output's shape,
and the index arithmetic that sizes a strided shard (a flatten of two
sharded dims), which runs on real CPU tensors even under
`FakeTensorMode` (it reads no data of the step, and a fake tensor cannot
give its `.tolist()`).

Data-dependent sizes: under fake tensors, indexing by a boolean mask
(moe's kept (token, slot) rows) takes its upper bound, every element
kept; on real tensors the op runs as it is.
"""
from __future__ import annotations

import contextlib
import math
import sys
from collections import Counter

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

FLASH_OP = "repro_torch.flash_attention.default"
FLASH_BWD_OP = "repro_torch.flash_attention_backward.default"
#: the backward kernel's products a (query, key) pair on its bf16 route
#: (`csrc/flash_attention_bwd_bf16.cu`, the training path's): the scores
#: three times and dP three times (two passes over the keys for dq, one
#: over the queries for dk and dv), then dV and dK twice each (P and dS
#: as bf16 hi/lo pairs) and dQ three times (dS as a bf16 triple); the f32
#: route (`csrc/flash_attention_bwd.h`) does those three once each, nine
BWD_PRODUCTS = 13

#: ops that return a view or alias of an operand without a schema
#: annotation, or move no data
_VIEWS = {"aten._unsafe_view.default", "aten.lift_fresh.default",
          "aten.set_.source_Storage_storage_offset", "aten.resize_.default",
          "_c10d_functional.wait_tensor.default",
          "_c10d_functional._wrap_tensor_autograd.default"}
_ALLOCATIONS = ("aten.empty", "aten.new_empty", "aten.empty_like",
                "aten.empty_strided", "aten.new_empty_strided")
#: in-place ops that overwrite their destination without reading it
_OVERWRITE = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_",
              "bernoulli_", "exponential_"}
#: in-place ops that write their other operands into part of the
#: destination
_SCATTER = {"index_put_", "_index_put_impl_", "index_copy_", "scatter_",
            "scatter_add_", "scatter_reduce_", "index_add_", "index_fill_",
            "masked_scatter_", "index_reduce_"}


def _prod(shape) -> int:
    return math.prod(shape)


def _desc(x, written: bool, seen: dict):
    """A JSON-able description of one argument."""
    if isinstance(x, torch.Tensor):
        dup = id(x) in seen
        seen[id(x)] = True
        # elements it holds: a broadcast (stride 0) dim reads one
        held = math.prod(int(n) for n, st in zip(x.shape, x.stride())
                         if st != 0)
        return ("t", tuple(int(d) for d in x.shape), x.element_size(),
                str(x.dtype).replace("torch.", ""), bool(written), dup,
                held)
    if isinstance(x, (list, tuple)):
        if any(isinstance(t, torch.Tensor) for t in x):
            return ("l", tuple(_desc(t, written, seen) if t is not None
                               else ("s", None) for t in x))
        if all(isinstance(t, (int, float, bool)) for t in x):
            return ("s", tuple(x))
    if x is None or isinstance(x, (bool, int, float, str)):
        return ("s", x)
    return ("o", str(x))


def _tensors(descs):
    for d in descs:
        if d[0] == "t":
            yield d
        elif d[0] == "l":
            yield from _tensors(d[1])


def _nbytes(d) -> int:
    return d[6] * d[2]


def _scalar(d):
    return d[1] if d[0] == "s" else None


def allowed_pairs(Sq, Sk, causal, window=None, prefix_len=0) -> int:
    """(query, key) pairs that `kernels/flash_attention.py`'s mask
    allows (`allowed_mask`'s rule), row by row in closed form, with no
    (Sq, Sk) tensor."""
    if not causal and window is None:
        return Sq * Sk
    i = np.arange(Sq)
    if causal:
        P = min(prefix_len, Sq)
        hi = np.minimum(np.where(i < P, np.maximum(i, P - 1), i), Sk - 1)
    else:
        hi = np.full(Sq, Sk - 1)
    lo = 0 if window is None else np.maximum(0, i - window + 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def _contraction_flops(name: str, ins, outs) -> float:
    base = name.split(".")[1]
    ts = list(_tensors(ins))
    if base in ("mm", "bmm"):
        return 2.0 * _prod(outs[0][1]) * ts[0][1][-1]
    if base in ("addmm", "baddbmm"):
        return 2.0 * _prod(outs[0][1]) * ts[1][1][-1]
    if base == "mv":
        return 2.0 * _prod(ts[0][1])
    if base == "dot":
        return 2.0 * ts[0][1][0]
    if base == "convolution":
        x, w = ts[0], ts[1]
        transposed = _scalar(ins[6])
        if transposed:
            return 2.0 * _prod(x[1]) * _prod(w[1][1:])
        return 2.0 * _prod(outs[0][1]) * _prod(w[1][1:])
    if base == "convolution_backward":
        gout, w = ts[0], ts[2]
        mask = _scalar(ins[-1]) or (True, True, True)
        fwd = 2.0 * _prod(gout[1]) * _prod(w[1][1:])
        return fwd * (int(bool(mask[0])) + int(bool(mask[1])))
    return 0.0


_CONTRACTIONS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot",
                 "convolution", "convolution_backward"}
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_to_all_single": "all-to-all",
                # DTensor's Shard(i) -> Shard(j) on one mesh dim (a CUDA
                # mesh; on a CPU mesh DTensor all-gathers and chunks)
                "shard_dim_alltoall": "all-to-all"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional.", "_dtensor.")


def cost(sig) -> dict:
    """{"flops", "bytes", "wire", "collective"} of one op signature
    (name, view, ins, outs, group_size)."""
    name, view, ins, outs, n = sig
    out = {"flops": 0.0, "bytes": 0.0, "wire": 0.0, "collective": None}
    if view or name in _VIEWS or name.startswith(_ALLOCATIONS):
        return out
    operands = [d for d in _tensors(ins) if not d[5]]
    results = list(_tensors(outs))
    base = name.split(".")[1] if "." in name else name
    if name in (FLASH_OP, FLASH_BWD_OP):
        q, k = operands[0][1], operands[1][1]
        B, H, Sq, D = q
        mask = ins[3:7] if name == FLASH_OP else ins[4:8]
        causal, softcap, window, prefix = (_scalar(d) for d in mask)
        pairs = allowed_pairs(Sq, k[2], causal, window, prefix)
        products = 2 if name == FLASH_OP else BWD_PRODUCTS
        out["flops"] = 2.0 * products * B * H * D * pairs
    elif base in _CONTRACTIONS and name.startswith("aten."):
        out["flops"] = _contraction_flops(name, ins, outs)
    written = [d for d in operands if d[4]]
    read = [d for d in operands if not d[4]]
    if base in _SCATTER:
        out["bytes"] = 2.0 * sum(_nbytes(d) for d in read)
    elif written and (base in _OVERWRITE or not base.endswith("_")):
        out["bytes"] = sum(_nbytes(d) for d in read) + \
            sum(_nbytes(d) for d in written)
    else:
        out["bytes"] = sum(_nbytes(d) for d in operands) + \
            sum(_nbytes(d) for d in results)
    if name.startswith(_COLLECTIVE_NAMESPACES) and base in _COLLECTIVES:
        n = max(int(n or 1), 1)
        frac = (n - 1) / n
        ob = sum(_nbytes(d) for d in read)
        rb = sum(_nbytes(d) for d in results)
        kind = _COLLECTIVES[base]
        out["collective"] = kind
        out["wire"] = {"all-gather": rb * frac, "reduce-scatter": ob * frac,
                       "all-reduce": 2 * ob * frac,
                       "all-to-all": ob * frac}[kind]
    return out


def summary_of(records) -> dict:
    """Totals over `(signature, count)` pairs: dot_flops, hbm_bytes,
    wire_bytes, collectives by kind, op counts by name, and the flash
    attention entries (forward and backward)."""
    flops = hbm = wire = 0.0
    colls: dict = {}
    counts: Counter = Counter()
    for sig, count in records:
        c = cost(sig)
        flops += count * c["flops"]
        hbm += count * c["bytes"]
        wire += count * c["wire"]
        counts[sig[0]] += count
        if c["collective"]:
            d = colls.setdefault(c["collective"], {
                "count": 0.0, "result_bytes": 0.0, "wire_bytes": 0.0})
            d["count"] += count
            d["result_bytes"] += count * sum(
                _nbytes(t) for t in _tensors(sig[3]))
            d["wire_bytes"] += count * c["wire"]
    return {"dot_flops": flops, "hbm_bytes": hbm, "wire_bytes": wire,
            "collectives": colls, "op_counts": dict(counts),
            "flash_attention_entries": counts.get(FLASH_OP, 0),
            "flash_attention_backward_entries": counts.get(FLASH_BWD_OP, 0)}


def _group_size(func, args) -> int | None:
    base = func._schema.name.split("::")[-1]
    if not str(func).startswith(_COLLECTIVE_NAMESPACES) or \
            base not in _COLLECTIVES:
        return None
    if base in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _upper_bound_index(func, args, kwargs):
    """`aten.index.Tensor` with boolean masks on fake tensors: the
    result as if every masked element were kept."""
    x, indices = args[0], list(args[1])
    shape, dim, expanded = [], 0, []
    for idx in indices:
        if idx is None:
            shape.append(x.shape[dim])
            dim += 1
        elif idx.dtype in (torch.bool, torch.uint8):
            expanded.append((idx.numel(),))
            dim += idx.dim()
        else:
            expanded.append(tuple(idx.shape))
            dim += 1
    bshape = torch.broadcast_shapes(*expanded) if expanded else ()
    first = next(i for i, t in enumerate(indices) if t is not None)
    shape[first:first] = list(bshape)
    shape += list(x.shape[dim:])
    return x.new_empty(shape)


def _fake(x) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


class OpAnalyzer(TorchDispatchMode):
    """Record and cost every op dispatched while it is active. Enter it
    inside a `FakeTensorMode` to trace with no allocation, or alone on
    real tensors."""

    def __init__(self):
        super().__init__()
        self.mult = 1
        self.records: Counter = Counter()
        self._dtensor = None     # the DTensor type, where it is loaded
        self._shadow = 0         # depth inside DTensor's shape propagation
        self._unpatch = None

    def __enter__(self):
        if "torch.distributed.tensor" in sys.modules:
            self._skip_dtensor_bookkeeping()
        return super().__enter__()

    def __exit__(self, *exc):
        if self._unpatch is not None:
            self._unpatch()
            self._unpatch = None
        return super().__exit__(*exc)

    def _skip_dtensor_bookkeeping(self):
        """While this mode is active, mark the ops of DTensor's shape
        propagation (`_propagate_tensor_meta_non_cached`) and of its
        strided-shard sizing (`_StridedShard.local_shard_size_and_offset`,
        run outside any fake mode), so that they are not recorded."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard
        self._dtensor = DTensor
        mode, saved = self, []
        for owner, name, real in (
                (ShardingPropagator, "_propagate_tensor_meta_non_cached",
                 False),
                (_StridedShard, "local_shard_size_and_offset", True)):
            orig = getattr(owner, name, None)
            if orig is None:
                # left unmarked, its ops would count as the step's work
                raise RuntimeError(
                    f"OpAnalyzer: torch {torch.__version__} has no "
                    f"{owner.__name__}.{name}, whose ops the analyzer must "
                    f"leave out of a DTensor trace")

            def shadow(*args, _orig=orig, _real=real, **kwargs):
                mode._shadow += 1
                try:
                    with (unset_fake_temporarily() if _real
                          else contextlib.nullcontext()):
                        return _orig(*args, **kwargs)
                finally:
                    mode._shadow -= 1

            setattr(owner, name, shadow)
            saved.append((owner, name, orig))

        def unpatch():
            for owner, name, orig in saved:
                setattr(owner, name, orig)
        self._unpatch = unpatch

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs inside n times."""
        prev = self.mult
        self.mult = prev * int(n)
        try:
            yield
        finally:
            self.mult = prev

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._dtensor is not None and any(
                issubclass(t, self._dtensor) for t in types):
            return NotImplemented   # DTensor runs it as local ops
        name = str(func)
        if name.startswith("prim.") or self._shadow:
            return func(*args, **kwargs)
        if name == "aten.index.Tensor" and _fake(args[0]) and any(
                t is not None and t.dtype in (torch.bool, torch.uint8)
                for t in args[1]):
            out = _upper_bound_index(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        self.records[self._signature(func, name, args, kwargs, out)] += \
            self.mult
        return out

    def _signature(self, func, name, args, kwargs, out):
        schema = func._schema
        written = {a.name for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write}
        seen: dict = {}
        ins = []
        for a, x in zip(schema.arguments, args):
            ins.append(_desc(x, a.name in written, seen))
        for k in sorted(kwargs):
            ins.append(_desc(kwargs[k], k in written, seen))
        outs = out if isinstance(out, (list, tuple)) else (out,)
        outs = tuple(_desc(o, False, {}) for o in outs)
        return (name, _is_view(func), tuple(ins), outs,
                _group_size(func, args))

    def summary(self) -> dict:
        return summary_of(self.records.items())


def log_of(records) -> list:
    """`(signature, count)` pairs as JSON-able [signature, count]."""
    return [[list(sig), count] for sig, count in records]


def records_of(log) -> list:
    """`(signature, count)` pairs from a `log_of` read back from JSON
    (lists become tuples again)."""
    def tup(x):
        return tuple(tup(v) for v in x) if isinstance(x, list) else x
    return [(tup(sig), count) for sig, count in log]
