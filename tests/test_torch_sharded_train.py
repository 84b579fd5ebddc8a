"""The port's sharded train step (DTensor eager SPMD) on the CPU: four
spawned gloo ranks (`FileStore` in tmp_path, no TCP port) on
`make_debug_mesh(2, 2, device="cpu")`.

Reduced olmoe-1b-7b and gemma2-2b, widened (d_model 256, head dim 64,
MLP 512, moe hidden 128, vocabulary 1024) so that the plan shards the
attention, MLP, expert, embedding and head weights (a leaf of fewer than
2^16 elements is replicated), in f32. Weights come from the reference's
`PRNGKey(0)` through `convert.model_params`; the batch is the
reference's `make_batch` (8 x 16). Two steps of `make_train_step` with
`n_micro=2`, AdamW with weight decay, placed by
`place_train_state`, under `plan_context`, with and without
"shard_grads" (`grad_specs` = the parameters' specs). Held:

  * losses and gradient norms against the reference's unsharded jitted
    step on the same batch, within test_torch_train_families.py's 1e-5
    of the largest value (the reference's own sharded test fails under
    jax 0.9, so it is not the yardstick);
  * the first step's gradients, and every parameter and AdamW moment
    after both, against the port's unsharded step, within 1e-5 of each
    leaf's largest value (f32 sums in other orders). AdamW's eps is 1e-3
    here, in both packages: with the default 1e-8 an element whose
    gradient cancels to about eps moves by up to 2 lr on gradient
    rounding alone (test_torch_train_families.py), so no tolerance on
    the parameters would hold anything; with 1e-3 the update is
    smooth in the gradient;
  * every gradient that reaches the optimizer in its parameter's
    placements, with no partial sum;
  * the flash-attention operator's DTensor rule on replicated, batch-
    and head-sharded GQA inputs (K < H), forward and gradient against
    autograd through `attention_plain`, each strategy run on local
    shards;
  * the dry run's fake-process-group trace of the reduced dense step
    (`dryrun.trace_train_sharded`) against the op analyzer on rank 0 of
    the real step: the same collectives by kind and the same wire
    bytes.
"""
import dataclasses
import functools
import json
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.models.inputs import make_batch as ref_make_batch
from repro.models.param import values_of
from repro.train import optimizer as r_opt
from repro.train import train_step as r_ts

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.sharding import PlanMesh, constrain, make_plan, plan_context
from repro_torch.sharding.planner import replicate_like
from repro_torch.models import model as model_lib
from repro_torch.train import AdamW, make_train_step

ARCHS = ("gemma2-2b", "olmoe-1b-7b")
VARIANTS = ("reduce_once", "shard_grads")
BATCH, SEQ, N_MICRO, STEPS = 8, 16, 2, 2
LR, WD, EPS = 3e-3, 0.1, 1e-3
TOL = 1e-5          # against the reference (test_torch_train_families.py)
F32_TOL = 1e-5      # against the port's unsharded step
WIDE = dict(d_model=256, head_dim=64, d_ff=512, vocab_size=1024,
            compute_dtype="float32")


def widened(cfg):
    cfg = dataclasses.replace(cfg, **WIDE)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               d_ff=128))
    return cfg


def configs(name):
    return (widened(ref_get_config(name).reduced()),
            widened(get_config(name).reduced()))


RANKS_SCRIPT = textwrap.dedent("""
    import dataclasses, json, pickle, sys
    import numpy as np
    import torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, store_path, in_path, out_path):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.ckpt.checkpoint import tree_leaves, \\
            tree_leaves_with_paths
        from repro_torch.convert import model_params
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.launch.op_analyzer import OpAnalyzer
        from repro_torch.models import model as model_lib
        from repro_torch.models.param import param_axes
        from repro_torch.sharding import make_plan, plan_context, spec_div
        from repro_torch.sharding.planner import place_train_state
        from repro_torch.train import AdamW, TrainState, make_train_step
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                                rank=rank, world_size=4)
        with open(in_path, "rb") as f:
            inp = pickle.load(f)
        out = {}
        try:
            mesh = make_debug_mesh(2, 2, device="cpu")

            class Recording:
                # the placements of every gradient the optimizer meets,
                # and the first step's gradients, gathered
                def __init__(self, inner):
                    self.inner, self.same, self.partial = inner, True, False
                    self.first = None

                def update(self, grads, state, params, lr_scale=1.0):
                    leaves = tree_leaves(grads)
                    if self.first is None:
                        self.first = [g.full_tensor() if isinstance(
                            g, DTensor) else g.clone() for g in leaves]
                    for g, p in zip(leaves, tree_leaves(params)):
                        if isinstance(g, DTensor):
                            self.same &= tuple(g.placements) == \\
                                tuple(p.placements)
                            self.partial |= any(x.is_partial()
                                                for x in g.placements)
                    return self.inner.update(grads, state, params, lr_scale)

            def rel(a, b):
                a, b = a.detach().double(), b.detach().double()
                return float((a - b).abs().max() /
                             b.abs().max().clamp(min=1e-30))

            for name, d in inp["archs"].items():
                cfg = d["cfg"]
                model = model_lib.build(cfg)
                batch = {k: torch.from_numpy(v) for k, v in
                         d["batch"].items()}
                mask = torch.ones(2)
                opt = AdamW(lr=d["lr"], eps=d["eps"], weight_decay=d["wd"])
                # the port's unsharded step
                params = model_params(d["params"], cfg, device="cpu")
                state = TrainState(params, opt.init(params),
                                   torch.zeros((), dtype=torch.int32))
                plain_rec = Recording(opt)
                step = make_train_step(model, plain_rec, 2)
                plain = {"loss": [], "grad_norm": []}
                for _ in range(d["steps"]):
                    state, m = step(state, batch, mask)
                    plain["loss"].append(float(m["loss"]))
                    plain["grad_norm"].append(float(m["grad_norm"]))
                res = {"plain": plain}
                for variant in ("reduce_once", "shard_grads"):
                    params = model_params(d["params"], cfg, device="cpu")
                    axes = param_axes(cfg, params)
                    plan = make_plan(cfg, mesh)
                    specs = plan.param_specs(params, axes)
                    st = TrainState(params, opt.init(params),
                                    torch.zeros((), dtype=torch.int32))
                    st, pbatch = place_train_state(plan, st, opt, batch, axes)
                    rec = Recording(opt)
                    shard = variant == "shard_grads"
                    sstep = make_train_step(
                        model, rec, 2,
                        opts=frozenset({"shard_grads"} if shard else ()),
                        grad_specs=specs if shard else None,
                        mesh=mesh if shard else None)
                    r = {"loss": [], "grad_norm": [], "metrics_replicated": True}
                    with plan_context(plan):
                        for i in range(d["steps"]):
                            # the second step: the first one's
                            # Recording gathers every gradient
                            an = OpAnalyzer() if (i == 1 and rank == 0) \\
                                else None
                            if an is not None:
                                with an:
                                    st, m = sstep(st, pbatch, mask)
                                s = an.summary()
                                r["collectives"] = {
                                    k: [v["count"], v["wire_bytes"]]
                                    for k, v in s["collectives"].items()}
                                r["wire_bytes"] = s["wire_bytes"]
                            else:
                                st, m = sstep(st, pbatch, mask)
                            for k in ("loss", "grad_norm", "active_shards"):
                                r["metrics_replicated"] &= all(
                                    p == Replicate() for p in m[k].placements)
                            r["loss"].append(float(m["loss"].to_local()))
                            r["grad_norm"].append(
                                float(m["grad_norm"].to_local()))
                    r["grads_same_placements"] = rec.same
                    r["grads_partial"] = rec.partial
                    r["sharded_leaves"] = sum(
                        spec_div(s, mesh) > 1 for s in tree_leaves(specs))
                    r["leaves"] = len(tree_leaves(specs))
                    worst = {"grad": 0.0, "param": 0.0, "m": 0.0, "v": 0.0}
                    for key, got, want in (
                            ("grad", rec.first, plain_rec.first),
                            ("param", st.params, state.params),
                            ("m", st.opt_state.m, state.opt_state.m),
                            ("v", st.opt_state.v, state.opt_state.v)):
                        for (path, g), (_, w) in zip(
                                tree_leaves_with_paths(got),
                                tree_leaves_with_paths(want)):
                            if isinstance(g, DTensor):
                                g = g.full_tensor()
                            e = rel(g, w)
                            if e > worst[key]:
                                worst[key] = e
                                worst[key + "_leaf"] = str(path)
                    r["worst"] = worst
                    res[variant] = r
                out[name] = res

            # the flash-attention operator's rule: q (4, 4, 16, 16), GQA
            # with 2 kv heads, causal, window 8, softcap 20
            g = torch.Generator().manual_seed(0)
            q = torch.randn(4, 4, 16, 16, generator=g)
            k = torch.randn(4, 2, 16, 16, generator=g)
            v = torch.randn(4, 2, 16, 16, generator=g)
            dout = torch.randn(4, 4, 16, 16, generator=g)
            mask_kw = dict(causal=True, softcap=20.0, window=8)
            want = [t.clone().requires_grad_(True) for t in (q, k, v)]
            fa.attention_plain(*want, **mask_kw).backward(dout)
            wout = fa.attention_plain(q, k, v, **mask_kw)
            seen = []
            plain_fn = fa.attention_plain

            def recording_plain(qq, *a, **kw):
                seen.append(list(qq.shape))
                return plain_fn(qq, *a, **kw)

            fa.attention_plain = recording_plain
            R, S0, S1 = Replicate(), Shard(0), Shard(1)
            flash = {}
            for case, plc in (("replicate", [R, R]), ("batch", [S0, R]),
                              ("heads", [R, S1]), ("batch_heads", [S0, S1])):
                seen.clear()
                dq, dk, dv = (DTensor.from_local(
                    t.chunk(2 if plc[0] == S0 else 1, 0)[
                        mesh.get_local_rank(0) if plc[0] == S0 else 0]
                    .chunk(2 if plc[1] == S1 else 1, 1)[
                        mesh.get_local_rank(1) if plc[1] == S1 else 0]
                    .contiguous(), mesh, plc, run_check=False)
                    .requires_grad_(True) for t in (q, k, v))
                o = ops.attention(dq, dk, dv, **mask_kw)
                o.backward(DTensor.from_local(
                    dout, mesh, [R, R], run_check=False).redistribute(
                        mesh, o.placements))
                flash[case] = {
                    "out_placements": [str(p) for p in o.placements],
                    "local_q_shapes": list(seen),
                    "out_err": float((o.full_tensor() - wout).abs().max()),
                    "grad_err": max(float((t.grad.full_tensor() - w.grad)
                                          .abs().max())
                                    for t, w in zip((dq, dk, dv), want)),
                    "scale": float(wout.abs().max()),
                    "grad_scale": max(float(w.grad.abs().max())
                                      for w in want),
                }
            fa.attention_plain = plain_fn
            out["flash"] = flash
            if rank == 0:
                with open(out_path, "w") as f:
                    json.dump(out, f)
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=tuple(sys.argv[1:4]), nprocs=4, join=True)
""")


@functools.lru_cache(maxsize=None)
def setup(name):
    rcfg, tcfg = configs(name)
    rparams = jax.tree.map(np.asarray, values_of(
        ref_model.build(rcfg).init(jax.random.PRNGKey(0))))
    rbatch = ref_make_batch(rcfg, BATCH, SEQ, "train", seed=7)
    return rcfg, tcfg, rparams, {k: np.asarray(v) for k, v in
                                 rbatch.items()}


def reference_metrics(name):
    """Losses and gradient norms of the reference's unsharded jitted
    step, `STEPS` times on the batch."""
    rcfg, _, rparams, rbatch = setup(name)
    opt = r_opt.AdamW(lr=LR, eps=EPS, weight_decay=WD)
    step = jax.jit(r_ts.make_train_step(ref_model.build(rcfg), opt, N_MICRO))
    params = jax.tree.map(jnp.asarray, rparams)
    state = r_ts.TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    out = {"loss": [], "grad_norm": []}
    for _ in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in rbatch.items()},
                        jnp.ones((N_MICRO,), jnp.float32))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results (rank 0's JSON) and the reference's
    metrics, computed while the ranks run."""
    d = tmp_path_factory.mktemp("sharded_train")
    inp = {"archs": {}}
    for name in ARCHS:
        _, tcfg, rparams, rbatch = setup(name)
        inp["archs"][name] = dict(cfg=tcfg, params=rparams, batch=rbatch,
                                  steps=STEPS, lr=LR, wd=WD, eps=EPS)
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    script = d / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    env = {**__import__("os").environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, str(script), str(d / "store"), str(d / "in.pkl"),
         str(d / "out.json")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        ref = {name: reference_metrics(name) for name in ARCHS}
        _, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    out = json.loads((d / "out.json").read_text())
    return out, ref


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", ARCHS)
def test_sharded_step_matches_reference(ranks, name, variant):
    """Both steps' losses and gradient norms, sharded, against the
    reference's unsharded step; and the port's own unsharded step too."""
    out, ref = ranks
    for got in (out[name][variant], out[name]["plain"]):
        for key in ("loss", "grad_norm"):
            want = np.asarray(ref[name][key])
            err = np.abs(np.asarray(got[key]) - want).max()
            assert err <= TOL * np.abs(want).max(), (key, got[key], want)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", ARCHS)
def test_sharded_state_matches_unsharded(ranks, name, variant):
    """The first step's gradients, and every parameter and AdamW moment
    after two sharded steps, against the port's unsharded step
    (gathered, f32, 1e-5 of each leaf's largest value); the plan sharded
    most leaves."""
    r = ranks[0][name][variant]
    for key in ("grad", "param", "m", "v"):
        assert r["worst"][key] <= F32_TOL, \
            (key, r["worst"][key], r["worst"].get(key + "_leaf"))
    assert r["sharded_leaves"] >= 10, r["sharded_leaves"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", ARCHS)
def test_sharded_grads_keep_placements(ranks, name, variant):
    """The optimizer meets every gradient in its parameter's placements
    and never a partial sum; loss, gradient norm and active shards come
    back replicated."""
    r = ranks[0][name][variant]
    assert r["grads_same_placements"] and not r["grads_partial"]
    assert r["metrics_replicated"]


#: the (data, model) placements each input case should run under: the
#: kernel (the plain version on the CPU) on each rank's shard, with no
#: gather of batch or heads
FLASH_CASES = {"replicate": (["R", "R"], [4, 4, 16, 16]),
               "batch": (["S(0)", "R"], [2, 4, 16, 16]),
               "heads": (["R", "S(1)"], [4, 2, 16, 16]),
               "batch_heads": (["S(0)", "S(1)"], [2, 2, 16, 16])}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_dtensor_rule(ranks, case):
    """`repro_torch::flash_attention` on DTensors: the output keeps the
    inputs' strategy, the forward runs on local shards (the head-sharded
    case gives each rank 2 query heads and their 1 kv head), and the
    forward and gradients equal autograd through `attention_plain`
    (f32 2e-5)."""
    f = ranks[0]["flash"][case]
    plc, local = FLASH_CASES[case]
    assert f["out_placements"] == plc
    # the forward once, and its recomputation in no backward (the
    # backward is attention_backward on the same shards)
    assert f["local_q_shapes"] == [local]
    assert f["out_err"] <= 2e-5 * f["scale"]
    assert f["grad_err"] <= 2e-5 * f["grad_scale"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_fake_trace_matches_real_run(ranks, variant):
    """The dry run's trace of the reduced dense step on a (2, 2) fake
    process group (rank 0, fake tensors, the seeded state) counts the
    collectives of rank 0 of the real gloo run: by kind, count and wire
    bytes."""
    real = ranks[0]["gemma2-2b"][variant]
    _, tcfg = configs("gemma2-2b")
    opts = {"shardgrads"} if variant == "shard_grads" else set()
    records, _ = dryrun.trace_train_sharded(
        tcfg, PlanMesh((2, 2), ("data", "model")), BATCH, SEQ, N_MICRO,
        opts, device="cpu")
    assert not dist.is_initialized()
    from repro_torch.launch.op_analyzer import summary_of
    s = summary_of(records)
    fake = {k: [v["count"], v["wire_bytes"]]
            for k, v in s["collectives"].items()}
    assert fake == real["collectives"]
    assert s["wire_bytes"] == real["wire_bytes"] > 0
    assert {"all-gather", "reduce-scatter"} <= set(fake)


def test_shard_grads_needs_a_mesh():
    _, tcfg = configs("gemma2-2b")
    model = model_lib.build(tcfg)
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(model, AdamW(), 2, opts=frozenset({"shard_grads"}),
                        grad_specs={"any": None})
    # "shard_grads" without grad_specs constrains nothing, as in the
    # reference
    make_train_step(model, AdamW(), 2, opts=frozenset({"shard_grads"}))


def test_constrain_and_replicate_like_outside_a_plan():
    """Outside a plan and on plain tensors the models' calls change
    nothing: the same tensor comes back."""
    x = torch.randn(2, 3, 4)
    assert constrain(x, ("batch", "seq", None)) is x
    assert replicate_like(x, torch.zeros(1)) is x
    cfg = get_config("gemma2-2b").reduced()
    with plan_context(make_plan(cfg, PlanMesh((2, 2), ("data", "model")))):
        assert constrain(x, ("batch", "seq", None)) is x


def test_plan_context_is_seen_by_other_threads():
    """The autograd engine runs a CUDA backward (and a checkpoint's
    recompute of the forward, which calls `constrain`) on threads of its
    own: the current plan is the process's, not the entering thread's."""
    import threading
    from repro_torch.sharding import current_plan
    cfg = get_config("gemma2-2b").reduced()
    plan = make_plan(cfg, PlanMesh((2, 2), ("data", "model")))
    seen = []
    with plan_context(plan):
        t = threading.Thread(target=lambda: seen.append(current_plan()))
        t.start()
        t.join()
    assert seen == [plan] and current_plan() is None
