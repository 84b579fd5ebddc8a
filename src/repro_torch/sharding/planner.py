"""Sharding planner: logical-axis rules -> partition specs, per arch x
mesh; counterpart of `repro.sharding.planner`.

The rules are the reference's, copied: the production mesh is (16, 16)
("data", "model") per pod, with a leading "pod" axis multi-pod, and an
architecture that does not divide it falls back deterministically.

Parameters (storage, ZeRO-3 style):
  * logical rules: d_model -> data; ffn, experts, vocab, heads,
    kv_heads, ssm_in, ssm_heads -> model, each only where the dim
    divides the axis;
  * greedy FSDP completion: a tensor of >= 2^16 elements with an unused
    mesh axis gets its largest divisible unsharded dim sharded on it;
  * tensors below 2^16 elements are replicated.
  The reference judges size on its stacked leaf, layers included. The
  port's leaves are one layer each, so size is the leaf's stack depth
  (`models.param.param_axes`) times its elements; its specs are the
  reference's less their leading "layers" entries (always None).

Activations: batch -> ("pod", "data") where divisible; heads, ffn,
experts -> "model" where divisible, else attention falls back to context
parallelism (seq -> "model"). Decode caches: kv_heads -> "model" where
divisible, else the cache's seq takes "model"; batch -> ("pod", "data")
where divisible, else the seq also takes "data".

A spec is a `Spec`: one entry a tensor dim, each a mesh-axis name, a
tuple of names (one tensor dim over several mesh dims, outer first) or
None. A mesh is anything with `axis_names` (or a `DeviceMesh`'s
`mesh_dim_names`) and `shape`: `PlanMesh` plans with no devices, as the
reference's tests plan on `FakeMesh`. `placements(spec, mesh)` turns a
spec into DTensor placements over a `torch.distributed.DeviceMesh`.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Optional

from ..ckpt.checkpoint import tree_map
from ..device import is_dtensor

_SMALL = 1 << 16


class Spec:
    """A partition spec: `Spec("data", None)`, `Spec(("pod", "data"))`;
    `Spec()` replicates. Compares equal to the tuple of its entries. Not
    a tuple, so tree functions keep it whole as a leaf."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Spec(*self.entries[i])
        return self.entries[i]

    def __add__(self, other):
        return Spec(*(self.entries + tuple(other)))

    def __eq__(self, other):
        if isinstance(other, Spec):
            return self.entries == other.entries
        if isinstance(other, tuple):
            return self.entries == other
        return NotImplemented

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"Spec{self.entries!r}"


@dataclass(frozen=True)
class PlanMesh:
    """A mesh to plan on, with no devices: its extents and axis names."""
    shape: tuple
    axis_names: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def mesh_sizes(mesh) -> dict:
    """{axis name: extent} of a `PlanMesh`, a `DeviceMesh` or any mesh
    with names and a shape."""
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def spec_div(spec, mesh) -> int:
    """The number of pieces `spec` cuts a tensor into on `mesh`: the
    product of the extents of the mesh axes it uses."""
    sizes = mesh_sizes(mesh)
    n = 1
    for entry in spec:
        for a in _flat(entry):
            n *= sizes[a]
    return n


def _flat(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def check_spec(spec, shape, mesh):
    """Raise unless `spec` fits `shape` on `mesh`: no mesh axis twice,
    every sharded dim divisible by its mesh extents."""
    sizes = mesh_sizes(mesh)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    used = []
    for dim, entry in zip(shape, spec):
        flat = _flat(entry)
        for a in flat:
            if a in used:
                raise ValueError(f"spec {spec}: mesh axis {a!r} twice")
            used.append(a)
        div = math.prod(sizes[a] for a in flat)
        if dim % div:
            raise ValueError(f"spec {spec}: dim {dim} of shape {shape} does "
                             f"not divide {div}")


def placements(spec, mesh) -> tuple:
    """DTensor placements for `spec` on a `DeviceMesh`: per mesh dim,
    `Shard(d)` where tensor dim d's entry names it, else `Replicate()`.
    A tuple entry shards one dim over several mesh dims in the mesh's
    order, outer first (as DTensor splits them). A mesh dim of extent 1
    holds every dim whole, so it replicates (DTensor will not reshape a
    dim "sharded" over one rank: a microbatch of one row on `card_mesh`)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _flat(entry)]
        if idx != sorted(idx):
            raise ValueError(f"placements: {entry} must list mesh axes "
                             f"outer first, as the mesh {names} orders them")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"placements: mesh axis {names[i]!r} twice "
                                 f"in {spec}")
            out[i] = Shard(d) if sizes[i] > 1 else Replicate()
    return tuple(out)


@dataclass
class Plan:
    mesh: object
    cfg: object
    param_rules: dict
    act_rules: dict
    batch_axes: tuple
    context_parallel_attn: bool
    notes: list = field(default_factory=list)
    fsdp_axes: tuple = ("data", "model")

    # ----- parameters -----
    def spec_for(self, shape, leaf) -> Spec:
        """The spec of one port leaf of `shape` with `leaf`
        (`models.param.LeafAxes`): the reference's rule on the stacked
        leaf, less its "layers" entries."""
        shape = tuple(shape)
        axes = leaf.axes
        assert len(shape) == len(axes), (shape, axes)
        n = leaf.depth * math.prod(shape) if shape else 0
        if n < _SMALL:
            return Spec()
        sizes = mesh_sizes(self.mesh)
        used, spec = set(), []
        for dim, ax in zip(shape, axes):
            mesh_ax = self.param_rules.get(ax)
            if mesh_ax is not None and mesh_ax not in used and \
                    dim % sizes[mesh_ax] == 0:
                spec.append(mesh_ax)
                used.add(mesh_ax)
            else:
                spec.append(None)
        # greedy FSDP completion over unused axes, largest dim first
        for mesh_ax in self.fsdp_axes:
            if mesh_ax in used or mesh_ax not in sizes:
                continue
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for i in order:
                if spec[i] is None and shape[i] % sizes[mesh_ax] == 0 \
                        and shape[i] > 1:
                    spec[i] = mesh_ax
                    used.add(mesh_ax)
                    break
        return Spec(*spec)

    def param_specs(self, params, axes=None):
        """A `Spec` for every leaf of `params` (the init's layout; any
        leaves with a shape, fake tensors too); `axes` defaults to
        `param_axes(cfg, params)`."""
        if axes is None:
            from ..models.param import param_axes
            axes = param_axes(self.cfg, params)
        return tree_map(lambda p, a: self.spec_for(p.shape, a), params, axes)

    def param_shardings(self, params, axes=None):
        """DTensor placements for every leaf on the plan's `DeviceMesh`."""
        return tree_map(lambda p, s: placements(s, self.mesh), params,
                        self.param_specs(params, axes))

    # ----- activations -----
    def act_spec(self, logical: tuple) -> Spec:
        """Resolve logical axes right to left, so that the innermost (TP)
        dimension wins when two map to the same mesh axis."""
        used: set = set()
        resolved = [None] * len(logical)
        for i in range(len(logical) - 1, -1, -1):
            ax = self.act_rules.get(logical[i])
            flat = ax if isinstance(ax, tuple) else (ax,)
            if ax is not None and not (set(flat) & used):
                resolved[i] = ax
                used.update(flat)
        return Spec(*resolved)

    # ----- batches -----
    def batch_spec(self, struct_tree):
        """Shard dim 0 (the global batch) of every leaf over the batch
        axes where it divides them."""
        def spec(x):
            if x.shape and x.shape[0] % self._batch_div() == 0:
                return Spec(self.batch_axes)
            return Spec()
        return tree_map(spec, struct_tree)

    def _batch_div(self):
        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.batch_axes)

    # ----- decode caches -----
    def cache_spec_tree(self, cache_struct, batch_size: int):
        """Specs for a decode cache (`Model.init_cache`'s layout, one
        leaf a layer). kv caches are (batch, seq, kv_heads, head_dim),
        ssm and conv states (batch, *state dims); the batch dim is the
        first equal to `batch_size`, as in the reference, which looks
        past its stacked leaves' leading layer dims."""
        sizes = mesh_sizes(self.mesh)
        batch_ok = batch_size % self._batch_div() == 0
        kv_ok = (self.cfg.n_kv_heads or 0) % sizes["model"] == 0

        def spec(x):
            shape = tuple(x.shape)
            if len(shape) == 1:  # lengths
                return Spec(self.batch_axes if batch_ok else None)
            spec_l = [None] * len(shape)
            try:
                b_i = next(i for i, d in enumerate(shape) if d == batch_size)
            except StopIteration:
                return Spec()
            if batch_ok:
                spec_l[b_i] = self.batch_axes
            is_kv = len(shape) >= b_i + 4 and \
                shape[b_i + 2] == self.cfg.n_kv_heads and \
                shape[b_i + 3] == self.cfg.head_dim
            if is_kv:
                if kv_ok:
                    spec_l[b_i + 2] = "model"
                    if not batch_ok:
                        spec_l[b_i + 1] = "data"
                else:
                    spec_l[b_i + 1] = ("data", "model") if not batch_ok \
                        else "model"
            else:
                # state tensors: shard the largest divisible trailing dim
                for i in range(len(shape) - 1, b_i, -1):
                    if shape[i] % sizes["model"] == 0 and \
                            shape[i] >= sizes["model"]:
                        spec_l[i] = "model"
                        break
            return Spec(*spec_l)

        return tree_map(spec, cache_struct)


def make_plan(cfg, mesh, opts: frozenset = frozenset()) -> Plan:
    sizes = mesh_sizes(mesh)
    model_n = sizes["model"]
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    notes = []

    def div(n, label):
        ok = n > 0 and n % model_n == 0
        if not ok and n > 0:
            notes.append(f"{label}={n} does not divide model axis {model_n}")
        return ok

    heads_ok = div(cfg.n_heads, "q_heads")
    kv_ok = div(cfg.n_kv_heads, "kv_heads")
    cp_attn = not heads_ok and cfg.family != "ssm" and cfg.n_heads > 0
    if cp_attn:
        notes.append("attention falls back to context parallelism "
                     "(seq->model)")

    d_inner = (cfg.ssm.expand * cfg.d_model) if cfg.ssm else 0
    ssm_heads = (d_inner // cfg.ssm.head_dim) if cfg.ssm else 0

    param_rules = {
        "layers": None, "conv": None, "head_dim": None, "patch": None,
        "ssm_bc": None, "ssm_state": None,
        "d_model": "data",
        "ffn": "model",
        "e_ffn": None,               # experts take "model"; d_model "data"
        "heads": "model" if heads_ok else None,
        "kv_heads": "model" if kv_ok else None,
        "vocab": "model",
        "experts": "model",
        "ssm_in": "model" if div(d_inner, "d_inner") else None,
        "ssm_heads": "model" if div(ssm_heads, "ssm_heads") else None,
    }
    ep_data = "ep_data" in opts and cfg.moe is not None
    if ep_data:
        # token-moving expert parallelism: experts on the data axis (an
        # all-to-all routes tokens), the per-expert hidden on model
        param_rules["experts"] = "data"
        param_rules["e_ffn"] = "model"

    act_rules = {
        "batch": batch_axes,
        "seq": "model" if cp_attn else None,
        "heads": "model" if heads_ok else None,
        "kv_heads": "model" if kv_ok else None,
        "ffn": "model",
        "experts": "data" if ep_data else "model",
        "vocab": "model",
        "d_model": None,
        "ssm_heads": "model" if div(ssm_heads, "") else None,
        "ssm_in": "model" if div(d_inner, "") else None,
        None: None,
    }

    fsdp_axes = ("data", "model")
    if "pod_fsdp" in opts and "pod" in sizes:
        # ZeRO-3 across pods too: halves each card's parameter and
        # optimizer state, at the price of gathers across pods
        fsdp_axes = ("pod",) + fsdp_axes
        notes.append("pod_fsdp: parameter storage sharded across pods")
    return Plan(mesh=mesh, cfg=cfg, param_rules=param_rules,
                act_rules=act_rules, batch_axes=batch_axes,
                context_parallel_attn=cp_attn, notes=notes,
                fsdp_axes=fsdp_axes)


# ---------------------------------------------------------------------------
# Activation-constraint context (`constrain` by logical axes)
# ---------------------------------------------------------------------------

#: the plan of the innermost `plan_context`, for the whole process: the
#: autograd engine runs a CUDA backward, and with it a checkpoint's
#: recompute of the forward, on threads of its own
_current: list = [None]


@contextlib.contextmanager
def plan_context(plan: Plan):
    """Make `plan` current (and its `DeviceMesh` the current mesh, where
    it is one)."""
    prev = _current[0]
    _current[0] = plan
    enter = getattr(plan.mesh, "__enter__", None)
    try:
        if enter is None:
            yield plan
        else:
            with plan.mesh:
                yield plan
    finally:
        _current[0] = prev


def current_plan() -> Optional[Plan]:
    return _current[0]


def constrain(x, logical: tuple, dims: Optional[tuple] = None):
    """Redistribute a DTensor to the current plan's spec for its logical
    axes; `x` itself outside a plan or when it is not a DTensor. Axes
    whose dim does not divide the mesh extent are dropped (batch-1
    decode, seq 1).

    `logical` is resolved in its own order (`Plan.act_spec`: the last
    axis wins a mesh axis that two want); `dims` then picks the resolved
    entry of each dim of `x`, for a tensor whose dims are the reference's
    in another order (moe's (E, B*C, D) buffers against the reference's
    (B, E, C, D): `dims=(1, 0, 3)`)."""
    if not is_dtensor(x):
        return x
    want = constraint_placements(x.shape, logical, x.device_mesh, dims)
    if want is None or tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def constraint_placements(shape, logical: tuple, mesh,
                          dims: Optional[tuple] = None):
    """The placements `constrain` gives a tensor of `shape` on `mesh`;
    None outside a plan."""
    plan = current_plan()
    if plan is None:
        return None
    spec = list(plan.act_spec(logical))
    if dims is not None:
        spec = [spec[i] for i in dims]
    sizes = mesh_sizes(plan.mesh)
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        div = math.prod(sizes[a] for a in _flat(ax))
        if shape[i] % div:
            spec[i] = None
    return placements(Spec(*spec), mesh)


# ---------------------------------------------------------------------------
# DTensor programs: plain tensors made inside a step, and placed state
# ---------------------------------------------------------------------------


def replicate_like(x, ref):
    """`x` as a replicated DTensor on `ref`'s mesh where `ref` is a
    DTensor and `x` is not (a position grid, RoPE's frequencies, a mask
    that a step makes inside a DTensor program); `x` itself otherwise.
    Every rank makes the same `x`, so no collective is needed."""
    if not is_dtensor(ref) or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def unshard(x, keep: tuple = ()):
    """A DTensor `x` with every dim but those in `keep` gathered (its
    shards there made replicas: the FSDP all-gather of a weight before
    it is used, where a product reshapes it); `x` itself where nothing
    moves or it is not a DTensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = tuple(p if p.is_shard() and p.dim in keep else
                 p if p.is_replicate() else Replicate()
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def reduce_partial(x):
    """A DTensor `x` with its partial sums reduced (each `Partial`
    placement made a replica: an all-reduce); `x` itself where it has
    none or is not a DTensor. A cast, a norm or any other op that is not
    linear must not meet a partial sum: each rank would round or
    transform its own piece (the vocabulary-sharded embedding's rows are
    one)."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def follow(plc, dims, partial=False) -> tuple:
    """Placements of a tensor whose dims are `dims` of a leading
    DTensor's (None: a dim it has that the leading one lacks), given the
    leading one's placements `plc`: its shards where the tensor has that
    dim, else a replica, or with `partial` a partial sum (a tensor that
    lacks a sharded dim because it was summed over it, or the gradient
    of one broadcast over it)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(Shard(dims.index(p.dim)) if p.is_shard() and p.dim in dims
                 else Partial() if p.is_shard() and partial else Replicate()
                 for p in plc)


def on_shards(fn, operands, out_dims):
    """fn(*tensors) run as plain torch on each rank's shards
    (`local_map`). `operands` = [(tensor, its dims among the first
    one's)]: the first, a DTensor, leads, and every other tensor is cut
    to match its placements (`follow`); each output's placements come
    from its dims in `out_dims` (an output lacking a sharded dim of the
    leader's is a partial sum over it). A gradient of an operand that
    lacks a sharded dim is a partial sum over that dim's mesh dims."""
    from torch.distributed.tensor.experimental import local_map
    lead = tuple(operands[0][0].placements)
    outs = tuple(follow(lead, d, partial=True) for d in out_dims)
    return local_map(
        fn, out_placements=outs if len(outs) > 1 else list(outs[0]),
        in_placements=tuple(follow(lead, d) for _, d in operands),
        in_grad_placements=tuple(follow(lead, d, partial=True)
                                 for _, d in operands),
        device_mesh=operands[0][0].device_mesh,
        redistribute_inputs=True)(*(t for t, _ in operands))


def batch_placements(x) -> tuple:
    """The placements of a DTensor `x` cut down to its batch sharding:
    `Shard(0)` on the mesh dims that shard dim 0, `Replicate()` on the
    others. Work that is independent a batch row (moe's routing and
    dispatch) runs on each rank's rows under these."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if p == Shard(0) else Replicate() for p in x.placements)


def shard_range(n: int, plc: tuple, mesh, dim: int) -> tuple:
    """(start, length) of this rank's piece of a dim of `n` under the
    placements `plc` on `mesh`: each mesh dim that shards `dim`, outer
    first, cuts the piece before it as `torch.chunk` does."""
    coord = mesh.get_coordinate()
    lo = 0
    for mdim, p in enumerate(plc):
        if p.is_shard(dim):
            chunk = -(-n // mesh.size(mdim))
            start = min(coord[mdim] * chunk, n)
            lo, n = lo + start, min(chunk, n - start)
    return lo, n


def place(tree, specs, mesh):
    """Every leaf of `tree` as a DTensor on the `DeviceMesh` `mesh` with
    the placements of its spec in `specs` (a tree of the same layout;
    None leaves stay None). A leaf may be a full tensor, which every rank
    holds alike (a seeded init, a checkpoint: each rank keeps its own
    shard of it, with no collective), or a DTensor of any mesh, which is
    gathered first: every rank of its mesh calls this. A rank outside
    `mesh` keeps an empty shard, as `distribute_tensor` gives it."""
    from torch.distributed.tensor import DTensor
    device = mesh.device_type

    def move(x, spec):
        if x is None:
            return None
        if is_dtensor(x):
            x = x.full_tensor()
        x = x.detach().to(device)
        plc = placements(spec, mesh)
        if mesh.get_coordinate() is None:
            local = x.new_empty(0)
        else:
            local = x
            for d in range(x.dim()):
                lo, n = shard_range(x.shape[d], plc, mesh, d)
                if n != x.shape[d]:
                    local = local.narrow(d, lo, n)
            if local is not x:
                local = local.contiguous()   # the whole tensor can go
        return DTensor.from_local(local, mesh, plc, run_check=False,
                                  shape=x.shape, stride=x.stride())

    return tree_map(move, tree, specs)


def cache_zeros(make, batch_size: int, ref):
    """A decode cache of zeros: `make(device)` (a tree of zero tensors
    on `device`) itself on `ref`'s device, or, where `ref` is a DTensor
    under a plan, DTensors on `ref`'s mesh placed by the plan's
    `cache_spec_tree`, each rank allocating only its own shard (`make`
    gives the shapes and types on the meta device)."""
    plan = current_plan()
    if plan is None or not is_dtensor(ref):
        return make(ref.device)
    from torch.distributed.tensor import zeros
    import torch
    struct = make(torch.device("meta"))
    mesh = ref.device_mesh
    return tree_map(lambda x, spec: zeros(
        tuple(x.shape), dtype=x.dtype, device_mesh=mesh,
        placements=placements(spec, mesh)), struct,
        plan.cache_spec_tree(struct, batch_size))


def cache_placed(cache, batch_size: int, ref):
    """A cache as the reference's jitted prefill and decode give it out
    (`out_shardings`): where `ref` (the step's logits) is a DTensor under
    a plan, every leaf in the placements of the plan's `cache_spec_tree`
    (a DTensor redistributed, a plain tensor, the lengths, placed; a
    no-op for a leaf already there); `cache` itself otherwise."""
    plan = current_plan()
    if plan is None or not is_dtensor(ref):
        return cache
    from torch.distributed.tensor import DTensor
    mesh = ref.device_mesh

    def put(x, spec):
        if not isinstance(x, DTensor):
            return place(x, spec, mesh)
        want = placements(spec, mesh)
        return x if tuple(x.placements) == want else x.redistribute(mesh,
                                                                    want)

    return tree_map(put, cache, plan.cache_spec_tree(cache, batch_size))


def place_serve_state(plan: Plan, params, axes=None, *, batch=None,
                      cache=None, tokens=None):
    """Serving state as DTensors on the plan's `DeviceMesh`, as the
    reference's dry run shards its jitted prefill and decode: the
    parameters by `plan.param_specs`, a prompt batch and decode tokens
    by `plan.batch_spec` (the batch axes only where the batch divides
    them), a cache (`Model.init_cache`'s layout) by
    `plan.cache_spec_tree`. Returns (params, batch, cache, tokens), None
    for each not given."""
    mesh = plan.mesh
    out = [place(params, plan.param_specs(params, axes), mesh)]
    for tree in (batch, tokens):
        out.append(None if tree is None else
                   place(tree, plan.batch_spec(tree), mesh))
    if cache is not None:
        cache = place(cache, plan.cache_spec_tree(
            cache, cache["lengths"].shape[0]), mesh)
    return out[0], out[1], cache, out[2]


def place_train_state(plan: Plan, state, optimizer, batch=None, axes=None):
    """A `TrainState` (and a batch) as DTensors on the plan's
    `DeviceMesh`: the parameters by `plan.param_specs`, the optimizer
    state by its `state_spec_tree`, the step replicated, the batch by
    `plan.batch_spec`. The counterpart of the reference's
    `jax.device_put(params, plan.param_shardings(meta))`. Returns
    (state, batch), batch None when none is given."""
    from ..train.train_step import TrainState
    mesh = plan.mesh
    pspecs = plan.param_specs(state.params, axes)
    ospecs = optimizer.state_spec_tree(pspecs, state.params)
    opt = type(state.opt_state)(*(place(x, spec, mesh) for x, spec in
                                  zip(state.opt_state, ospecs)))
    placed = TrainState(place(state.params, pspecs, mesh), opt,
                        place(state.step, Spec(), mesh))
    if batch is None:
        return placed, None
    return placed, place(batch, plan.batch_spec(batch), mesh)
