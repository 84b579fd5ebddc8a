"""The port's sharded train step of the vlm, audio, ssm and hybrid
families (DTensor eager SPMD) on the CPU: four spawned gloo ranks
(`FileStore` in tmp_path, no TCP port) on `make_debug_mesh(2, 2,
device="cpu")`.

Reduced paligemma-3b, hubert-xlarge, mamba2-2.7b and zamba2-7b, widened
(d_model 256, head dim 64, MLP 512, vocabulary 1024; the ssm families
d_model 512 and d_state 64, so d_inner 1024, 128 SSD heads and G N 64,
all even, with SSD chunks of 4: the reference's SSD takes exp before it
masks, and at this width a chunk of 8 overflows it to NaN gradients;
paligemma's patch and hubert's frame width 256) so that the
plan shards their attention, MLP, embedding, head, projection and
Mamba2 input and output weights, in f32. The weights are the port's
seeded ones, carried to the reference's layout (the inverse of
`convert.model_params`): the reference's own `PRNGKey(0)` zamba2
weights give NaN gradients there. The batch is `make_batch` (8 x 16,
the reference's arrays). One step of `make_train_step` with
`n_micro=2` and "shard_grads" (`grad_specs` = the parameters' specs),
AdamW with weight decay, placed by `place_train_state`, under
`plan_context`. Held, at test_torch_sharded_train.py's tolerances:

  * the loss and the gradient norm against the reference's unsharded
    jitted step on the same batch and weights (1e-5 of the value);
  * the gradients, and every parameter and AdamW moment after the step,
    against the port's unsharded step, within 1e-5 of each leaf's
    largest value. AdamW's eps is 1e-2 here, in both packages: at the
    step's first update a parameter moves by lr g / (|g| + eps), whose
    slope lr eps / (|g| + eps)^2 turns an f32 difference of the sharded
    gradient's sums into up to (difference) / (4 eps) of lr; at 1e-3
    that is about 4e-5 of the largest update on these Mamba2 biases,
    at 1e-2 a tenth of it;
  * every gradient that reaches the optimizer in its parameter's
    placements, with no partial sum, and most leaves sharded;
  * the losses reduce in the logits' own layout: no collective of the
    step moves a (rows, positions, whole vocabulary) tensor.
"""
import dataclasses
import functools
import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.models import transformer as RT
from repro.models.inputs import make_batch as ref_make_batch
from repro.train import optimizer as r_opt
from repro.train import train_step as r_ts

from repro_torch.configs import get_config
from repro_torch.models import model as model_lib

ARCHS = ("paligemma-3b", "hubert-xlarge", "mamba2-2.7b", "zamba2-7b")
BATCH, SEQ, N_MICRO = 8, 16, 2
LR, WD, EPS = 3e-3, 0.1, 1e-2
TOL = 1e-5          # against the reference (test_torch_sharded_train.py)
F32_TOL = 1e-5      # against the port's unsharded step


def widen(cfg):
    """A reduced config widened so that the plan shards every kind of
    leaf it has, f32 compute."""
    kw = dict(d_model=256, head_dim=64, d_ff=512, vocab_size=1024,
              compute_dtype="float32")
    if cfg.ssm is not None:
        kw.update(d_model=512, ssm=dataclasses.replace(cfg.ssm, d_state=64,
                                                       chunk=4))
    if cfg.hybrid is not None:
        kw["hybrid"] = dataclasses.replace(cfg.hybrid, shared_d_ff=512)
    if cfg.vision is not None:
        kw["vision"] = dataclasses.replace(cfg.vision, embed_dim=256)
    if cfg.audio is not None:
        kw["audio"] = dataclasses.replace(cfg.audio, frame_dim=256)
    return dataclasses.replace(cfg, **kw)


def configs(name):
    return (widen(ref_get_config(name).reduced()),
            widen(get_config(name).reduced()))


def np_leaf(t):
    dt = str(t.dtype).split(".")[-1]
    return t.detach().to(torch.float32).numpy() if dt == "bfloat16" \
        else t.detach().numpy(), getattr(jnp, dt)


def stacked(*ts):
    arrs = [np_leaf(t) for t in ts]
    return jnp.asarray(np.stack([a for a, _ in arrs]), arrs[0][1])


def reference_tree(tparams, rcfg):
    """The port's parameters in the reference's layout (the inverse of
    `model_params`; test_torch_families.py's and test_torch_ssm.py's)."""
    if rcfg.family in ("ssm", "hybrid"):
        out = {k: jnp.asarray(*np_leaf(tparams[k]))
               for k in ("embed", "final_norm", "lm_head")}
        if rcfg.family == "ssm":
            out["blocks"] = jax.tree.map(stacked, *tparams["blocks"])
            return out
        groups = [jax.tree.map(stacked, *g) for g in tparams["groups"]]
        out["groups"] = jax.tree.map(lambda *a: jnp.stack(a), *groups)
        out["shared_attn"] = jax.tree.map(lambda t: jnp.asarray(
            *np_leaf(t)), tparams["shared_attn"])
        out["tail"] = jax.tree.map(stacked, *tparams["tail"]) \
            if tparams["tail"] else None
        return out
    n = len(RT.block_pattern(rcfg).specs)
    out = {k: jnp.asarray(*np_leaf(v)) for k, v in tparams.items()
           if k != "blocks"}
    out["blocks"] = tuple(jax.tree.map(stacked, *tparams["blocks"][i::n])
                          for i in range(n))
    return out


RANKS_SCRIPT = textwrap.dedent("""
    import json, pickle, sys
    import torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, store_path, in_path, out_path):
        from torch.distributed.tensor import DTensor
        from repro_torch.ckpt.checkpoint import tree_leaves, \\
            tree_leaves_with_paths
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.launch.op_analyzer import OpAnalyzer, cost
        from repro_torch.models import model as model_lib
        from repro_torch.models.inputs import make_batch
        from repro_torch.models.param import param_axes
        from repro_torch.models.transformer import padded_vocab
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
                # and the gradients, gathered
                def __init__(self, inner):
                    self.inner, self.same, self.partial = inner, True, False
                    self.grads = None

                def init(self, params):
                    return self.inner.init(params)

                def state_spec_tree(self, *a):
                    return self.inner.state_spec_tree(*a)

                def update(self, grads, state, params, lr_scale=1.0):
                    leaves = tree_leaves(grads)
                    self.grads = [g.full_tensor() if isinstance(
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
                batch = make_batch(cfg, d["batch"], d["seq"], "train",
                                   seed=7, device="cpu")
                mask = torch.ones(2)
                opt = AdamW(lr=d["lr"], eps=d["eps"], weight_decay=d["wd"])
                params = model.init(seed=0, device="cpu")
                state = TrainState(params, opt.init(params),
                                   torch.zeros((), dtype=torch.int32))
                plain_rec = Recording(opt)
                state, m = make_train_step(model, plain_rec, 2)(
                    state, batch, mask)
                res = {"plain": [float(m["loss"]), float(m["grad_norm"])]}
                params = model.init(seed=0, device="cpu")
                axes = param_axes(cfg, params)
                plan = make_plan(cfg, mesh)
                specs = plan.param_specs(params, axes)
                st = TrainState(params, opt.init(params),
                                torch.zeros((), dtype=torch.int32))
                st, pbatch = place_train_state(plan, st, opt, batch, axes)
                rec = Recording(opt)
                step = make_train_step(model, rec, 2,
                                       opts=frozenset({"shard_grads"}),
                                       grad_specs=specs, mesh=mesh)
                an = OpAnalyzer()
                with plan_context(plan), an:
                    st, m = step(st, pbatch, mask)
                res["sharded"] = [float(m["loss"].to_local()),
                                  float(m["grad_norm"].to_local())]
                # every (rows, positions, whole vocabulary) tensor a
                # collective of the step moved: a gathered logits
                Vp = padded_vocab(cfg)
                res["logits_collectives"] = [
                    [sig[0], list(x[1])] for sig, _ in an.records.items()
                    if cost(sig)["collective"] for x in sig[2] + sig[3]
                    if x[0] == "t" and len(x[1]) == 3 and x[1][-1] == Vp]
                res["grads_same_placements"] = rec.same
                res["grads_partial"] = rec.partial
                res["sharded_leaves"] = sum(
                    spec_div(s, mesh) > 1 for s in tree_leaves(specs))
                res["leaves"] = len(tree_leaves(specs))
                worst = {"grad": 0.0, "param": 0.0, "m": 0.0, "v": 0.0}
                for key, got, want in (
                        ("grad", rec.grads, plain_rec.grads),
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
                res["worst"] = worst
                out[name] = res
            if rank == 0:
                with open(out_path, "w") as f:
                    json.dump(out, f)
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=tuple(sys.argv[1:4]), nprocs=4, join=True)
""")


@functools.lru_cache(maxsize=None)
def reference_metrics(name):
    """Loss and gradient norm of the reference's unsharded jitted step on
    the port's seeded weights."""
    rcfg, tcfg = configs(name)
    tparams = model_lib.build(tcfg).init(seed=0, device="cpu")
    params = reference_tree(tparams, rcfg)
    opt = r_opt.AdamW(lr=LR, eps=EPS, weight_decay=WD)
    step = jax.jit(r_ts.make_train_step(ref_model.build(rcfg), opt, N_MICRO))
    state = r_ts.TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    batch = ref_make_batch(rcfg, BATCH, SEQ, "train", seed=7)
    _, m = step(state, batch, jnp.ones((N_MICRO,), jnp.float32))
    return [float(m["loss"]), float(m["grad_norm"])]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results (rank 0's JSON) and the reference's
    metrics, computed while the ranks run."""
    d = tmp_path_factory.mktemp("sharded_families")
    inp = {"archs": {name: dict(cfg=configs(name)[1], batch=BATCH, seq=SEQ,
                                lr=LR, wd=WD, eps=EPS) for name in ARCHS}}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    script = d / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
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
    return json.loads((d / "out.json").read_text()), ref


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_family_step_matches_reference(ranks, name):
    """The sharded step's loss and gradient norm, and the port's
    unsharded step's, against the reference's unsharded step."""
    out, ref = ranks
    want = np.asarray(ref[name])
    for got in (out[name]["sharded"], out[name]["plain"]):
        err = np.abs(np.asarray(got) - want)
        assert (err <= TOL * np.abs(want)).all(), (got, want)


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_family_state_matches_unsharded(ranks, name):
    """The gradients, and every parameter and AdamW moment after the
    sharded step, against the port's unsharded step (gathered, f32,
    1e-5 of each leaf's largest value)."""
    r = ranks[0][name]
    for key in ("grad", "param", "m", "v"):
        assert r["worst"][key] <= F32_TOL, \
            (key, r["worst"][key], r["worst"].get(key + "_leaf"))


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_family_grads_keep_placements(ranks, name):
    """The optimizer meets every gradient in its parameter's placements,
    never a partial sum; the plan sharded most leaves; and no
    collective moved a (rows, positions, whole vocabulary) tensor (the
    losses reduce where the vocabulary-sharded logits lie)."""
    r = ranks[0][name]
    assert r["grads_same_placements"] and not r["grads_partial"]
    assert r["sharded_leaves"] >= 10, (r["sharded_leaves"], r["leaves"])
    assert r["logits_collectives"] == [], r["logits_collectives"]
