"""The port's sharded prefill and decode (`Model.prefill` and
`Model.decode_step` on DTensors placed by `place_serve_state`, under
`plan_context`) on the CPU: four spawned gloo ranks (`FileStore` in
tmp_path, no TCP port) on `make_debug_mesh(2, 2, device="cpu")`.

Configs, widened as test_torch_sharded_families.py widens them (f32
compute, the port's seeded weights, carried to the reference's layout
for the reference):

  * gemma2-2b with 2 kv heads: the cache sharded on its kv heads
    ("model") and its batch ("data");
  * gemma2-2b with 1 kv head: the cache sharded on its sequence
    ("model"), so decode writes on the rank that holds the position and
    combines each rank's partial softmax (`attention._attend_seq_sharded`);
  * the same at batch 1: the sequence over ("data", "model");
  * paligemma-3b (1 kv head, a prefix of patches), mamba2-2.7b and
    zamba2-7b (the ssm and conv states on their largest divisible
    trailing dim, the hybrid's kv on its heads).

A prompt of 16 positions, then 3 greedy decode steps into a cache of 19.
Held:

  * the prefill's logits against the reference's `prefill`, within 1e-5
    of the largest value (f32);
  * each decode step's logits against the reference's `decode_step` on
    the same cache (the sharded run's before the step, gathered, in the
    reference's layout) and token, within 1e-5 of the largest value
    (free-running, the unsharded port's own ssm and hybrid decode logits
    drift up to 1e-3 from the reference's at this width: a bf16 conv
    state rounded one ulp apart feeds the next steps);
  * the greedy tokens: sharded, unsharded and reference alike;
  * the prefill's cache, and each decode step's from the same cache (the
    sharded run's before the step, gathered), against the unsharded
    port's: bf16 kv and conv states within one bf16 ulp (as
    test_torch_ssm.py holds them) past an f32 floor of 1e-5 of the
    leaf's largest value (a near-cancelling sum, summed in another order
    across the ranks, rounds to a bf16 value whose own ulp is far below
    the sum's f32 error), f32 ssm states within 1e-5 of the largest
    value, the lengths equal; every leaf in its `cache_spec_tree`
    placements;
  * where the cache is sharded on its sequence, the first decode step's
    write changes, for each batch row, exactly one rank's shard: the one
    that holds the position.
"""
import dataclasses
import functools
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

from repro_torch.configs import get_config
from repro_torch.models import model as model_lib

from test_torch_sharded_families import reference_tree, stacked, widen

PROMPT, STEPS = 16, 3
PREFILL_TOL = 1e-5
DECODE_TOL = 1e-5
STATE_TOL = 1e-5
#: name -> (arch, kv heads or None, batch, cache sharded on its sequence)
CASES = {
    "kv_heads": ("gemma2-2b", 2, 4, False),
    "sequence": ("gemma2-2b", 1, 4, True),
    "sequence_batch1": ("gemma2-2b", 1, 1, True),
    "vlm": ("paligemma-3b", None, 4, True),
    "ssm": ("mamba2-2.7b", None, 4, False),
    "hybrid": ("zamba2-7b", None, 4, False),
}


def configs(case):
    arch, kv, _, _ = CASES[case]
    kw = {} if kv is None else dict(n_kv_heads=kv)
    return (dataclasses.replace(widen(ref_get_config(arch).reduced()), **kw),
            dataclasses.replace(widen(get_config(arch).reduced()), **kw))


RANKS_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, store_path, in_path, out_path):
        from torch.distributed.tensor import DTensor
        from repro_torch.ckpt.checkpoint import tree_leaves_with_paths, \
            tree_map
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models import model as model_lib
        from repro_torch.models.inputs import make_batch
        from repro_torch.models.param import param_axes
        from repro_torch.sharding import make_plan, placements, plan_context
        from repro_torch.sharding.planner import place_serve_state, \
            shard_range
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                                rank=rank, world_size=4)
        with open(in_path, "rb") as f:
            inp = pickle.load(f)
        out = {}
        try:
            mesh = make_debug_mesh(2, 2, device="cpu")

            def ulps(got, want):
                # |got - want| past the f32 floor (1e-5 of the leaf's
                # largest value) in bf16 ulps of the larger, elementwise
                # max: a sum near cancelling rounds to a bf16 value whose
                # own ulp is far below the sum's error
                got, want = got.float(), want.float()
                mag = torch.maximum(got.abs(), want.abs())
                ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(
                    min=torch.finfo(torch.float32).tiny))) - 7)
                past = (got - want).abs() - d["f32_floor"] * \
                    want.abs().max()
                return float((past.clamp(min=0) / ulp).max())

            def rel(got, want):
                got, want = got.double(), want.double()
                return float((got - want).abs().max() /
                             want.abs().max().clamp(min=1e-30))

            def compare(got, want, specs):
                # a gathered cache against a plain one: bf16 leaves in
                # ulps, f32 leaves relative to their largest value, the
                # lengths equal, every leaf placed by its spec
                worst = {"ulps": 0.0, "state": 0.0, "placed": True,
                         "lengths": True}
                for (path, g), (_, w), (_, spec) in zip(
                        tree_leaves_with_paths(got),
                        tree_leaves_with_paths(want),
                        tree_leaves_with_paths(specs)):
                    worst["placed"] &= isinstance(g, DTensor) and tuple(
                        g.placements) == placements(spec, mesh)
                    g = g.full_tensor()
                    if path[-1] == "lengths":
                        worst["lengths"] &= torch.equal(g, w)
                    elif w.dtype == torch.bfloat16:
                        worst["ulps"] = max(worst["ulps"], ulps(g, w))
                    else:
                        worst["state"] = max(worst["state"], rel(g, w))
                return worst

            def gathered(cache):
                return tree_map(lambda x: x.full_tensor(), cache)

            for case, d in inp["cases"].items():
                cfg, B, S, n = d["cfg"], d["batch"], d["prompt"], d["steps"]
                V = cfg.vocab_size
                model = model_lib.build(cfg)
                batch = make_batch(cfg, B, S, "prefill", seed=3,
                                   device="cpu")
                params = model.init(seed=0, device="cpu")
                with torch.no_grad():
                    logits, cache = model.prefill(params, batch, S + n)
                    prefill_cache = tree_map(torch.clone, cache)
                    plain_tokens = []
                    for _ in range(n):
                        tok = logits[:, -1:, :V].argmax(-1).to(torch.int32)
                        plain_tokens.append(tok[:, 0].tolist())
                        logits, cache = model.decode_step(params, tok, cache)
                plan = make_plan(cfg, mesh)
                specs = plan.cache_spec_tree(cache, B)
                pp, pbatch, _, _ = place_serve_state(
                    plan, params, param_axes(cfg, params), batch=batch)
                res = {"logits": [], "tokens": [], "plain_tokens":
                       plain_tokens, "writes": None, "pre_caches": [],
                       "steps": []}
                with plan_context(plan), torch.no_grad():
                    lg, c = model.prefill(pp, pbatch, S + n)
                    res["logits"].append(lg.full_tensor())
                    res["prefill_cache"] = compare(c, prefill_cache, specs)
                    for i in range(n):
                        tok = lg.full_tensor()[:, -1:, :V].argmax(-1).to(
                            torch.int32)
                        res["tokens"].append(tok[:, 0].tolist())
                        pre = gathered(c)
                        res["pre_caches"].append(pre)
                        kv = c["kv"][0]["k"] if "kv" in c else None
                        before = None if kv is None else \
                            kv.to_local().clone()
                        lg, c = model.decode_step(
                            pp, place_serve_state(plan, {}, tokens=tok)[3], c)
                        res["logits"].append(lg.full_tensor())
                        # the unsharded step from the same cache
                        want_lg, want = model.decode_step(
                            params, tok, tree_map(torch.clone, pre))
                        step = compare(c, want, specs)
                        step["logits"] = rel(lg.full_tensor(), want_lg)
                        res["steps"].append(step)
                        if i == 0 and kv is not None:
                            # the global rows of this rank's shard that
                            # the write changed, and the positions it
                            # holds
                            local = c["kv"][0]["k"].to_local()
                            lo, _ = shard_range(B, kv.placements, mesh, 0)
                            changed = [lo + b for b in range(local.shape[0])
                                       if not torch.equal(local[b],
                                                          before[b])]
                            span = shard_range(kv.shape[1], kv.placements,
                                               mesh, 1)
                            writes = [None] * 4
                            dist.all_gather_object(writes,
                                                   [changed, list(span)])
                            res["writes"] = writes
                res["seq_sharded"] = "kv" in c and any(
                    p.is_shard(1) for p in c["kv"][0]["k"].placements)
                out[case] = res
            if rank == 0:
                torch.save(out, out_path)
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=tuple(sys.argv[1:4]), nprocs=4, join=True)
""")


def reference_cache(cache, rcfg):
    """A port cache (plain tensors, one leaf a layer) in the reference's
    layout: transformer kv stacked by pattern step, one {"k", "v"} a
    spec; ssm states stacked by layer; hybrid groups (n_groups, inner),
    "attn_k"/"attn_v" (n_groups, ...) and the tail (tail, ...)."""
    lengths = jnp.asarray(cache["lengths"].numpy())
    if rcfg.family == "ssm":
        return {"states": jax.tree.map(stacked, *cache["states"]),
                "lengths": lengths}
    if rcfg.family == "hybrid":
        groups = [jax.tree.map(stacked, *g) for g in cache["groups"]]
        return {"groups": jax.tree.map(lambda *a: jnp.stack(a), *groups),
                "attn_k": stacked(*(kv["k"] for kv in cache["kv"])),
                "attn_v": stacked(*(kv["v"] for kv in cache["kv"])),
                "tail": jax.tree.map(stacked, *cache["tail"])
                if cache["tail"] else None, "lengths": lengths}
    n = len(RT.block_pattern(rcfg).specs)
    return {"kv": tuple({k: stacked(*(kv[k] for kv in cache["kv"][i::n]))
                         for k in ("k", "v")} for i in range(n)),
            "lengths": lengths}


@functools.lru_cache(maxsize=None)
def reference_setup(case):
    """(reference config, model, the port's seeded weights in the
    reference's layout, the prompt)."""
    rcfg, tcfg = configs(case)
    params = reference_tree(model_lib.build(tcfg).init(seed=0, device="cpu"),
                            rcfg)
    batch = ref_make_batch(rcfg, CASES[case][2], PROMPT, "prefill", seed=3)
    return rcfg, ref_model.build(rcfg), params, batch


@functools.lru_cache(maxsize=None)
def reference_run(case):
    """The reference's prefill logits and its own greedy tokens."""
    rcfg, rm, params, batch = reference_setup(case)
    logits, cache = jax.jit(rm.prefill, static_argnums=2)(
        params, batch, PROMPT + STEPS)
    first, tokens = np.asarray(logits), []
    decode = jax.jit(rm.decode_step)
    for _ in range(STEPS):
        tok = jnp.argmax(logits[:, -1:, :rcfg.vocab_size], -1).astype(
            jnp.int32)
        tokens.append(np.asarray(tok)[:, 0].tolist())
        logits, cache = decode(params, tok, cache)
    return first, tokens


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_serve")
    inp = {"cases": {case: dict(cfg=configs(case)[1], batch=CASES[case][2],
                                prompt=PROMPT, steps=STEPS,
                                f32_floor=STATE_TOL)
                     for case in CASES}}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    script = d / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, str(script), str(d / "store"), str(d / "in.pkl"),
         str(d / "out.pt")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        ref = {case: reference_run(case) for case in CASES}
        _, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    return torch.load(d / "out.pt"), ref


def held(got, want, tol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), f"{what}: {err:.3g}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_serve_logits_match_reference(ranks, case):
    """The prefill's logits within 1e-5 of the reference's; each decode
    step's within 1e-5 of the reference's `decode_step` from the same
    cache (the sharded run's before the step, gathered, in the
    reference's layout) and token; the greedy tokens of the sharded,
    unsharded and reference runs alike."""
    out, ref = ranks
    got, (want, want_tokens) = out[case], ref[case]
    rcfg, rm, params, _ = reference_setup(case)
    held(got["logits"][0], want, PREFILL_TOL, "prefill logits")
    decode = jax.jit(rm.decode_step)
    for i in range(STEPS):
        tok = jnp.asarray(np.asarray(got["tokens"][i], np.int32)[:, None])
        rlogits, _ = decode(params, tok, reference_cache(
            got["pre_caches"][i], rcfg))
        held(got["logits"][i + 1], rlogits, DECODE_TOL,
             f"decode step {i} logits")
    assert got["tokens"] == got["plain_tokens"] == want_tokens


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_serve_caches_match_unsharded(ranks, case):
    """The prefill's cache, and each decode step's from the same cache,
    gathered, against the unsharded port's: bf16 leaves within one ulp
    and f32 states within 1e-5, the lengths equal, every leaf placed by
    `cache_spec_tree`; each step's logits within 1e-5."""
    got = ranks[0][case]
    for what, c in [("prefill", got["prefill_cache"])] + [
            (f"decode step {i}", c) for i, c in enumerate(got["steps"])]:
        assert c["ulps"] <= 1.0, (what, c)
        assert c["state"] <= STATE_TOL, (what, c)
        assert c["lengths"] and c["placed"], (what, c)
        assert c.get("logits", 0.0) <= DECODE_TOL, (what, c)


@pytest.mark.parametrize("case", sorted(c for c in CASES if CASES[c][3]))
def test_sequence_sharded_write_lands_on_one_rank(ranks, case):
    """On a cache sharded on its sequence, the first decode step changes
    each batch row on exactly one rank's shard, the one whose positions
    hold the prompt's length."""
    got = ranks[0][case]
    assert got["seq_sharded"]
    B = CASES[case][2]
    for b in range(B):
        writers = [span for changed, span in got["writes"] if b in changed]
        assert len(writers) == 1, (b, got["writes"])
        lo, n = writers[0]
        assert lo <= PROMPT < lo + n, (b, writers)
