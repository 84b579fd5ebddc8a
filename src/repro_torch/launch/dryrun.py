"""Dry run: trace every (arch x shape x mesh) cell's step on fake
tensors; counterpart of `repro.launch.dryrun`.

The reference lowers and compiles each cell on 512 placeholder XLA
devices and reads per-device FLOPs, HBM bytes and collective bytes from
the partitioned HLO. The port builds each cell's model and inputs at
full width under `FakeTensorMode` (shapes and types, nothing allocated)
on the device the caller gives, and traces its step (train, prefill or
decode) under `op_analyzer.OpAnalyzer`. A train step traces one
microbatch's loss and backward, counts it `n_micro` times, and adds one
optimizer update.

Meshes:
  * `h100`: one card. The batch is the shape's global batch, n_micro
    comes from PER_DEVICE_MICRO with a batch divisor of 1; FLOPs and
    bytes are the trace's, collective bytes 0; `memory.argument_bytes`
    counts parameters, optimizer state and batch (or cache) exactly, and
    `fits` says whether they leave room in 80 GiB. `memory.temp_bytes`
    is null: only a run on the card measures it.
  * `16x16` and `2x16x16`: the reference's production meshes, planned
    with `sharding.planner`. `memory.argument_bytes` per device: each
    leaf's bytes over the product of the mesh extents its spec uses
    (parameters, `state_spec_tree`, `batch_spec`, `cache_spec_tree`).
    Every cell is traced sharded, as rank 0 of a fake process group of
    256 or 512 ranks (`fake_rank0`), its DTensors of fake tensors placed
    by the plan, the step run as eager SPMD under `plan_context`: a
    train step (`trace_train_sharded`: state and batch by
    `place_train_state`), a prefill (`trace_prefill_sharded`: parameters
    and prompt by `place_serve_state`, the cache made placed by
    `cache_spec_tree`) or a decode step (`trace_decode_sharded`:
    parameters, tokens and cache by `place_serve_state`), as the
    reference's dry run jits them with these shardings. FLOPs and bytes
    per device are rank 0's local ops, and the collectives of its
    redistributions give the wire bytes (`"per_device": "trace"`). On
    CUDA fake tensors DTensor moves a shard to another dim by an
    all-to-all; on CPU ones (`--device cpu`) it all-gathers and chunks
    instead (gloo has no all-to-all), so such a trace counts those moves
    n times over.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k \\
      --mesh h100 --device cpu
  python -m repro_torch.launch.dryrun --all --mesh all --out artifacts/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import time
import traceback
from pathlib import Path

import torch

from ..ckpt.checkpoint import tree_leaves, tree_leaves_with_paths
from ..configs import ALL_ARCHS, SHAPES, get_config, shape_applicable
from ..device import resolve_device
from ..models import model as model_lib
from ..models.inputs import batch_struct
from ..models.param import param_axes
from ..sharding.planner import (PlanMesh, check_spec, make_plan, place,
                                place_serve_state, place_train_state,
                                plan_context, spec_div)
from ..train.optimizer import make_optimizer
from ..train.train_step import TrainState, make_train_step, micro_rows
from .op_analyzer import OpAnalyzer, log_of, records_of, summary_of

# tokens per device per microbatch for train_4k (bounds activation memory)
PER_DEVICE_MICRO = {
    "deepseek-coder-33b": 1, "arctic-480b": 1,
    "mistral-nemo-12b": 2, "chatglm3-6b": 2, "zamba2-7b": 2,
    "gemma2-2b": 4, "olmoe-1b-7b": 2, "paligemma-3b": 4,
    "mamba2-2.7b": 2, "hubert-xlarge": 4,
}

MESHES = {
    "h100": PlanMesh((1, 1), ("data", "model")),
    "16x16": PlanMesh((16, 16), ("data", "model")),
    "2x16x16": PlanMesh((2, 16, 16), ("pod", "data", "model")),
}
#: one H100 SXM's device memory
HBM_CAPACITY_BYTES = 80 * 2**30


def n_microbatches(arch: str, global_batch: int, batch_div: int) -> int:
    pdm = PER_DEVICE_MICRO.get(arch, 2)
    n = max(global_batch // (pdm * batch_div), 1)
    while global_batch % n or (global_batch // n) % batch_div:
        n -= 1
    return max(n, 1)


def model_flops_analytic(cfg, shape_name: str) -> float:
    """MODEL_FLOPS: 6·N·D train / 2·N·D inference (N = active parameters
    less the embedding table), plus the attention core, causal at S/2."""
    seq, batch, kind = SHAPES[shape_name]
    from ..models.transformer import padded_vocab
    n_eff = cfg.active_param_count() - padded_vocab(cfg) * cfg.d_model
    # attention core flops per token at context S: 4 * H * Dh * S
    if cfg.family == "hybrid":
        n_attn_layers = cfg.n_layers // cfg.hybrid.shared_attn_every
    elif cfg.family == "ssm":
        n_attn_layers = 0
    else:
        n_attn_layers = cfg.n_layers
    attn_per_tok_ctx = 4 * cfg.n_heads * cfg.head_dim * n_attn_layers
    if kind == "train":
        tokens = seq * batch
        return 6.0 * n_eff * tokens + 3.0 * attn_per_tok_ctx * (seq / 2) \
            * tokens
    if kind == "prefill":
        tokens = seq * batch
        return 2.0 * n_eff * tokens + attn_per_tok_ctx * (seq / 2) * tokens
    # decode: one token per sequence against a seq-length cache
    return 2.0 * n_eff * batch + attn_per_tok_ctx * seq * batch


OPTS_HELP = (
    "comma-separated levers: bf16cast (bf16 parameter storage, f32 "
    "masters), bf16grads (bf16 gradient accumulation), blockattn "
    "(attn_impl=\"blocked\": the port's attention is blocked on both "
    "passes whatever attn_impl says, so the records equal the default's), "
    "remat_dots (remat=\"dots\": the transformer blocks keep their weight "
    "products' outputs and recompute the rest), chunk128 / ssd_bf16 (SSD "
    "shaping), micro_half / micro_quarter / micro_double (gradient "
    "accumulation depth), ep_data (experts on the data axis), pod_fsdp "
    "(ZeRO across pods), shardgrads (each microbatch's gradient "
    "reduce-scattered to the parameters' specs; sharded cells only)")

OPTS = {"bf16cast", "bf16grads", "blockattn", "remat_dots", "chunk128",
        "ssd_bf16", "micro_half", "micro_quarter", "micro_double", "ep_data",
        "pod_fsdp", "shardgrads"}


def _apply_cfg_opts(cfg, opts: set):
    """`cfg` with the options that change the config applied, as the
    reference's `_apply_cfg_opts` applies them; raises on an unknown
    option."""
    unknown = sorted(set(opts) - OPTS)
    if unknown:
        raise ValueError(f"dryrun: unknown options {unknown}")
    if "bf16cast" in opts:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if "blockattn" in opts:
        cfg = dataclasses.replace(cfg, attn_impl="blocked")
    if "chunk128" in opts and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=128))
    if "remat_dots" in opts:
        cfg = dataclasses.replace(cfg, remat="dots")
    if "ssd_bf16" in opts and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, intra_dtype="bfloat16"))
    return cfg


def _nbytes(x) -> int:
    return 0 if x is None else x.numel() * x.element_size()


def per_device_bytes(tree, specs, mesh) -> int:
    """Bytes a device holds of `tree` under `specs`: each leaf's bytes
    over the product of the mesh extents its spec uses. Raises on a spec
    that does not fit its leaf (a mesh axis twice, a dim that does not
    divide), as the reference's compile would."""
    spec_of = dict(tree_leaves_with_paths(specs))
    total = 0
    for path, x in tree_leaves_with_paths(tree):
        check_spec(spec_of[path], tuple(x.shape), mesh)
        total += _nbytes(x) // spec_div(spec_of[path], mesh)
    return total


def micro_count(arch, batch, batch_div, opts) -> int:
    n_micro = n_microbatches(arch, batch, batch_div)
    if "micro_half" in opts:
        n_micro = max(n_micro // 2, 1)
    if "micro_quarter" in opts:
        n_micro = max(n_micro // 4, 1)
    if "micro_double" in opts:
        n_micro = min(n_micro * 2, batch // batch_div)
    return n_micro


def step_opts(opts) -> frozenset:
    flags = {"bf16_params": "bf16cast", "bf16_grads": "bf16grads",
             "shard_grads": "shardgrads"}
    return frozenset(o for o, flag in flags.items() if flag in opts)


def trace_train(model, optimizer, state, micro_batch, n_micro: int,
                analyzer: OpAnalyzer, opts=frozenset(), batch=None,
                grad_specs=None, mesh=None):
    """One train step of `n_micro` microbatches as the analyzer counts
    it: `micro_batch`'s loss and backward n_micro times, the gradient
    norm and the update once. Runs on fake or real tensors. A sharded
    step (DTensor state) also gives the global `batch`, which the step
    lays out as microbatches once (`train_step.micro_rows`), and with
    "shardgrads" the gradients' `grad_specs` on `mesh`."""
    step = make_train_step(model, optimizer, 1, opts=step_opts(opts),
                           grad_specs=grad_specs, mesh=mesh,
                           micro_scope=lambda: analyzer.repeat(n_micro))
    with analyzer:
        if batch is not None and n_micro > 1:
            for x in batch.values():
                micro_rows(x, n_micro)
        return step(state, micro_batch, [1.0])


@contextlib.contextmanager
def fake_rank0(mesh, device=None):
    """The `DeviceMesh` of the plan mesh `mesh` as rank 0 of a fake
    process group of `mesh.size` ranks (no communication, nothing
    allocated) on `device`'s type, and the device; the group destroyed
    on exit. None may be started already."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already started; a "
                           "sharded trace starts its own fake one")
    dev = resolve_device(device)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield init_device_mesh(dev.type, tuple(mesh.shape),
                               mesh_dim_names=tuple(mesh.axis_names)), dev
    finally:
        dist.destroy_process_group()


def trace_train_sharded(cfg, mesh, batch: int, seq: int, n_micro: int,
                        opts=frozenset(), device=None):
    """(op records, seconds) of one sharded train step of `cfg` on the
    plan mesh `mesh`, traced as rank 0 of a fake process group
    (`fake_rank0`): the seeded state and a zero `batch` x `seq` batch
    placed by the plan (`place_train_state`) as DTensors of fake
    tensors, the step run under `plan_context` as `trace_train` runs
    it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_rank0(mesh, device) as (dmesh, dev):
        plan = make_plan(cfg, dmesh, opts=frozenset(opts))
        model = model_lib.build(cfg)
        optimizer = make_optimizer(cfg)
        an = OpAnalyzer()
        with FakeTensorMode():
            t0 = time.perf_counter()
            params = model.init(seed=0, device=dev)
            axes = param_axes(cfg, params)
            state = TrainState(params, optimizer.init(params), torch.zeros(
                (), dtype=torch.int32, device=dev))
            gbatch = batch_struct(cfg, batch, seq, "train", dev)
            micro = {k: x[: batch // n_micro] for k, x in gbatch.items()}
            state, gbatch = place_train_state(plan, state, optimizer,
                                              gbatch, axes)
            micro = place(micro, plan.batch_spec(micro), dmesh)
            shard = "shardgrads" in opts
            with plan_context(plan):
                trace_train(model, optimizer, state, micro, n_micro, an,
                            opts, batch=gbatch,
                            grad_specs=plan.param_specs(params, axes)
                            if shard else None,
                            mesh=dmesh if shard else None)
            return list(an.records.items()), time.perf_counter() - t0


def _trace_serve_sharded(cfg, mesh, kind: str, batch: int, seq: int,
                         opts=frozenset(), device=None):
    """(op records, seconds) of one sharded prefill or decode step of
    `cfg` on the plan mesh `mesh`, traced as rank 0 of a fake process
    group (`fake_rank0`): the seeded parameters with a zero prompt of
    `batch` x `seq` (prefill), or with zero tokens of `batch` x 1 and an
    empty cache of `seq` positions (decode), placed by
    `place_serve_state`, the step run under `plan_context`. The prefill
    makes its cache placed by `cache_spec_tree`; the decode writes and
    reads each rank's shard of it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_rank0(mesh, device) as (dmesh, dev):
        plan = make_plan(cfg, dmesh, opts=frozenset(opts))
        model = model_lib.build(cfg)
        an = OpAnalyzer()
        with FakeTensorMode():
            t0 = time.perf_counter()
            params = model.init(seed=0, device=dev)
            axes = param_axes(cfg, params)
            with plan_context(plan):
                if kind == "prefill":
                    params, prompt, _, _ = place_serve_state(
                        plan, params, axes,
                        batch=batch_struct(cfg, batch, seq, "prefill", dev))
                    trace_prefill(model, params, prompt, seq, an)
                else:
                    params, _, cache, tokens = place_serve_state(
                        plan, params, axes,
                        cache=model.init_cache(batch, seq, device=dev),
                        tokens=torch.zeros((batch, 1), dtype=torch.int32,
                                           device=dev))
                    trace_decode(model, params, tokens, cache, an)
            return list(an.records.items()), time.perf_counter() - t0


def trace_prefill_sharded(cfg, mesh, batch: int, seq: int,
                          opts=frozenset(), device=None):
    """`_trace_serve_sharded` of a prefill."""
    return _trace_serve_sharded(cfg, mesh, "prefill", batch, seq, opts,
                                device)


def trace_decode_sharded(cfg, mesh, batch: int, seq: int, opts=frozenset(),
                         device=None):
    """`_trace_serve_sharded` of a decode step."""
    return _trace_serve_sharded(cfg, mesh, "decode", batch, seq, opts,
                                device)


def trace_decode(model, params, tokens, cache, analyzer: OpAnalyzer):
    with analyzer, torch.no_grad():
        return model.decode_step(params, tokens, cache)


def trace_prefill(model, params, batch, seq, analyzer: OpAnalyzer):
    with analyzer, torch.no_grad():
        return model.prefill(params, batch, seq)


def cache_gathers(arch: str, shape_name: str, mesh_kind: str, log,
                  reduced=False) -> list:
    """The collectives of a serving cell's op log (`log_of`) whose result
    holds a decode cache leaf's whole extent on a dim that
    `cache_spec_tree` shards (a gathered cache: a kv cache's sequence or
    kv heads, an ssm state's N), its other dims at the leaf's whole or
    per-device extents; each as {"kind", "count", "result", "leaf"}.
    Empty where every rank reads and writes only its own shards."""
    from .op_analyzer import cost
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    seq, batch, _ = SHAPES[shape_name]
    mesh = MESHES[mesh_kind]
    cache = model_lib.build(cfg).init_cache(batch, seq, device="meta")
    specs = dict(tree_leaves_with_paths(
        make_plan(cfg, mesh).cache_spec_tree(cache, batch)))
    leaves = []
    for path, x in tree_leaves_with_paths(cache):
        spec, full = specs[path], tuple(x.shape)
        local = tuple(-(-n // spec_div(spec[i: i + 1], mesh))
                      if i < len(spec) else n for i, n in enumerate(full))
        cut = [i for i in range(len(full)) if local[i] != full[i]]
        if cut:
            leaves.append((str(path), full, local, cut))
    out = []
    for sig, count in records_of(log):
        kind = cost(sig)["collective"]
        results = [tuple(d[1]) for d in sig[3] if d[0] == "t"] if kind \
            else []
        for shape in results:
            for path, full, local, cut in leaves:
                if len(shape) == len(full) and all(
                        s in (f, n) for s, f, n in zip(shape, full, local)) \
                        and any(shape[i] == full[i] for i in cut):
                    out.append(dict(kind=kind, count=count,
                                    result=list(shape), leaf=path))
    return out


_TRACES: dict = {}


def cell(arch: str, shape_name: str, mesh_kind: str, device=None,
         opts=frozenset(), verbose=True, reduced=False):
    """(record, op log) of one cell, traced on fake tensors at full
    width (or the arch's `reduced()` config) on `device` (None: cuda). A
    trace is kept for the other meshes of the same step (prefill and
    decode trace the global batch on every mesh)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    cfg = _apply_cfg_opts(cfg.reduced() if reduced else cfg, opts)
    seq, batch, kind = SHAPES[shape_name]
    mesh = MESHES[mesh_kind]
    plan = make_plan(cfg, mesh, opts=frozenset(opts))
    n_dev = mesh.size
    dev = resolve_device(device)
    sharded = n_dev > 1
    model = model_lib.build(cfg)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "n_devices": n_dev, "kind": kind, "seq": seq, "batch": batch,
           "device": dev.type, "reduced": bool(reduced)}
    memory = {}
    with FakeTensorMode():
        params = model.init(seed=0, device=dev)
        axes = param_axes(cfg, params)
        pspecs = plan.param_specs(params, axes)
        memory["params"] = per_device_bytes(params, pspecs, mesh)
        rec["n_params"] = sum(p.numel() for p in tree_leaves(params))
        if kind == "train":
            optimizer = make_optimizer(cfg)
            opt_state = optimizer.init(params)
            ospecs = optimizer.state_spec_tree(pspecs, params)
            memory["opt_state"] = per_device_bytes(opt_state, ospecs, mesh)
            n_micro = micro_count(arch, batch, plan._batch_div(), opts)
            gbatch = batch_struct(cfg, batch, seq, "train", dev)
            memory["batch"] = per_device_bytes(
                gbatch, plan.batch_spec(gbatch), mesh)
            rec["n_micro"] = n_micro
            rec["micro_batch"] = batch // n_micro
            key = (arch, reduced, shape_name, tuple(sorted(opts)),
                   batch // n_micro, n_micro, str(dev))
            if sharded:
                key += (mesh_kind,)   # traced below, out of this mode
            elif key not in _TRACES:
                an = OpAnalyzer()
                state = TrainState(params, opt_state, torch.zeros(
                    (), dtype=torch.int32, device=dev))
                t0 = time.perf_counter()
                trace_train(model, optimizer, state, batch_struct(
                    cfg, batch // n_micro, seq, "train", dev), n_micro, an,
                    opts)
                _TRACES[key] = (list(an.records.items()),
                                time.perf_counter() - t0)
        else:
            cache = model.init_cache(batch, seq, device=dev)
            cspecs = plan.cache_spec_tree(cache, batch)
            if kind == "prefill":
                bstruct = batch_struct(cfg, batch, seq, "prefill", dev)
                memory["batch"] = per_device_bytes(
                    bstruct, plan.batch_spec(bstruct), mesh)
                rec["output_cache_bytes"] = per_device_bytes(cache, cspecs,
                                                             mesh)
            else:
                tokens = torch.zeros((batch, 1), dtype=torch.int32,
                                     device=dev)
                memory["cache"] = per_device_bytes(cache, cspecs, mesh)
                memory["tokens"] = per_device_bytes(
                    tokens, plan.batch_spec(tokens), mesh)
            key = (arch, reduced, shape_name, tuple(sorted(opts)), batch, 1,
                   str(dev))
            if sharded:
                key += (mesh_kind,)   # traced below, out of this mode
            elif key not in _TRACES:
                an = OpAnalyzer()
                t0 = time.perf_counter()
                if kind == "prefill":
                    trace_prefill(model, params, bstruct, seq, an)
                else:
                    trace_decode(model, params, tokens, cache, an)
                _TRACES[key] = (list(an.records.items()),
                                time.perf_counter() - t0)
    if key not in _TRACES:
        if kind == "train":
            _TRACES[key] = trace_train_sharded(cfg, mesh, batch, seq,
                                               n_micro, opts, device=dev)
        else:
            trace = trace_prefill_sharded if kind == "prefill" else \
                trace_decode_sharded
            _TRACES[key] = trace(cfg, mesh, batch, seq, opts, device=dev)
    records, trace_s = _TRACES[key]
    arg = sum(memory.values())
    rec["per_device"] = "trace"
    rec.update(_costs(summary_of(records), rec))
    rec.update({
        "memory": {"argument_bytes": arg, "argument_breakdown": memory,
                   "temp_bytes": None},
        "fits": arg <= HBM_CAPACITY_BYTES,
        "hbm_capacity_bytes": HBM_CAPACITY_BYTES,
        "model_flops": model_flops_analytic(cfg, shape_name),
        "trace_s": trace_s,
        "plan_notes": plan.notes,
    })
    if verbose:
        print(f"  {arch} {shape_name} {mesh_kind}: args/dev "
              f"{arg / 2**30:.2f} GiB (fits {rec['fits']}), flops/dev "
              f"{rec['flops_per_device']:.3e}, bytes/dev "
              f"{rec['hbm_bytes_per_device']:.3e}, trace {trace_s:.1f} s")
    return rec, log_of(records)


def _costs(s, rec) -> dict:
    """A record's fields from its trace's `summary_of`: per device, the
    trace's own (one card, or rank 0 of a sharded step); the totals are
    rank 0's times the devices."""
    return {
        "flops_per_device": s["dot_flops"],
        "hbm_bytes_per_device": s["hbm_bytes"],
        "collective_wire_bytes": s["wire_bytes"],
        "collectives": s["collectives"],
        "flops_total": s["dot_flops"] * rec["n_devices"],
        "hbm_bytes_total": s["hbm_bytes"] * rec["n_devices"],
        "flash_attention_entries": s["flash_attention_entries"],
        "flash_attention_backward_entries": s[
            "flash_attention_backward_entries"],
        "n_ops": sum(s["op_counts"].values()),
    }


def _tag(arch, shape_name, mesh_kind, suffix=""):
    return f"{arch}__{shape_name}__{mesh_kind}{suffix}"


def run_cell(arch, shape_name, mesh_kind, out_dir: Path, force=False,
             tag_suffix="", opts=frozenset(), device=None, reduced=False):
    """Write one cell's record (and its op log) under `out_dir`; a
    failure is written as `<tag>.FAILED.json`. Returns (ok, record)."""
    tag = _tag(arch, shape_name, mesh_kind, tag_suffix)
    path = out_dir / f"{tag}.json"
    if path.exists() and not force:
        print(f"[skip-cached] {tag}")
        return True, json.loads(path.read_text())
    ok, reason = shape_applicable(arch, shape_name)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "skipped": True, "reason": reason}
        path.write_text(json.dumps(rec, indent=1))
        print(f"[skip] {tag}: {reason}")
        return True, rec
    print(f"[cell] {tag}")
    try:
        rec, log = cell(arch, shape_name, mesh_kind, device=device,
                        opts=opts, reduced=reduced)
    except Exception as e:
        err = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "error": repr(e), "traceback": traceback.format_exc()}
        (out_dir / f"{tag}.FAILED.json").write_text(json.dumps(err, indent=1))
        print(f"[FAIL] {tag}: {e!r}")
        return False, err
    rec["opts"] = sorted(opts)
    path.write_text(json.dumps(rec, indent=1))
    with gzip.open(out_dir / f"{tag}.ops.json.gz", "wt") as f:
        json.dump(log, f)
    return True, rec


def reanalyze(out_dir: Path):
    """Cost the stored op logs again (no trace) and rewrite the
    analyzer's fields of each record."""
    for lp in sorted(out_dir.glob("*.ops.json.gz")):
        jp = out_dir / (lp.name[: -len(".ops.json.gz")] + ".json")
        if not jp.exists():
            continue
        rec = json.loads(jp.read_text())
        with gzip.open(lp, "rt") as f:
            s = summary_of(records_of(json.load(f)))
        rec.update(_costs(s, rec))
        jp.write_text(json.dumps(rec, indent=1))
        print(f"[reanalyzed] {jp.name}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="h100",
                    choices=list(MESHES) + ["all"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reanalyze", action="store_true",
                    help="cost the stored op logs again")
    ap.add_argument("--opt", default="", help=OPTS_HELP)
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default cuda)")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's reduced() config (a quick check)")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.reanalyze:
        reanalyze(out_dir)
        return 0
    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]
    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    opts = set(o for o in args.opt.split(",") if o)
    _apply_cfg_opts(get_config(archs[0]), opts)   # refuse bad options first
    suffix = ("__opt-" + "-".join(sorted(opts))) if opts else ""
    suffix += "__reduced" if args.reduced else ""
    failures = 0
    t0 = time.perf_counter()
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                ok, _ = run_cell(arch, shape_name, mesh_kind, out_dir,
                                 force=args.force, tag_suffix=suffix,
                                 opts=frozenset(opts), device=args.device,
                                 reduced=args.reduced)
                failures += not ok
    print(f"done in {time.perf_counter() - t0:.1f} s; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
