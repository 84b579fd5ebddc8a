"""Port parity of fault injection, checkpoints and resume
(`repro_torch.chaos`, `repro_torch.ckpt`).

Sizes are the reference tests' (tests/test_chaos.py): 48 jobs in chunks
of 12 (four chunks), 2 replications.

What is held, and how tightly:
* against the JAX package: `FaultPlan` validation, `at`, fingerprints,
  `from_faults` on the registry's dicts and `generate` equal;
  `ElasticGovernor.schedule` and `ChaosContext.bind`'s schedules exactly;
  the audit records of one plan run through both packages' fleets equal;
  `ckpt` directories read across packages with equal arrays; the torn
  write cases of `latest_step`; `StreamCombiner.state_dict` keys and
  arrays; r* under a governed device loss equal on both fleets; the
  capacity fleet under `slot_change` and `chunk_fail` on the reference's
  replayed draws, under the rules of test_torch_fleet.py;
* port-only identities, bit for bit: crash after any chunk and resume,
  every strategy, the capacity fleet's crash with a slot change, retried
  and corrupted chunks, EMPTY_PLAN = chaos off; and the refusals.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as ref_ckpt
from repro.chaos import ChaosContext as RefChaosContext
from repro.chaos import ElasticGovernor as RefElasticGovernor
from repro.chaos import FaultEvent as RefFaultEvent
from repro.chaos import KINDS as REF_KINDS
from repro.chaos import FaultPlan as RefFaultPlan
from repro.chaos import from_faults as ref_from_faults
from repro.chaos import generate as ref_generate_plan
from repro.cluster.engine import QueueMetrics as RefQueueMetrics
from repro.fleet import run_fleet_strategy as ref_run_fleet_strategy
from repro.fleet.cluster import \
    run_cluster_fleet_strategy as ref_run_cluster_fleet
from repro.obs import metrics as ref_obs_metrics
from repro.sim import SimParams as RefSimParams
from repro.sim import generate as ref_generate
from repro.sim.metrics import SimResult as RefSimResult
from repro.sim.metrics import StreamCombiner as RefStreamCombiner
from repro.strategies import index_of as ref_index_of
from repro.workloads import registry as ref_registry

from repro_torch import Philox, SimParams, names, run_all
from repro_torch import ckpt
from repro_torch.chaos import (EMPTY_PLAN, KINDS, ChaosContext,
                               ChaosExhausted, CheckpointConfig,
                               ElasticGovernor, FaultEvent, FaultPlan,
                               SimulatedCrash, from_faults, generate,
                               resume_cluster_fleet, resume_fleet)
from repro_torch.chaos import inject, recovery
from repro_torch.chaos.recovery import (check_fingerprint, pack_state,
                                        run_fingerprint, unpack_state)
from repro_torch.cluster import QueueMetrics
from repro_torch.fleet import fleet_mesh, run_fleet_strategy
from repro_torch.fleet.cluster import run_cluster_fleet_strategy
from repro_torch.fleet.mesh import FleetMesh, shrink_fleet_mesh
from repro_torch.sim.metrics import SimResult, StreamCombiner
from repro_torch.workloads import registry
from test_torch_fleet import (JaxFleetReplay, _capacity_parts, clock_ties,
                              port_jobs, tb_of)
from test_torch_sim import deadline_ties

KEY = jax.random.PRNGKey(0)
P = SimParams()
REF_P = RefSimParams()
N_JOBS, CHUNK, REPS = 48, 12, 2                 # -> 4 chunks


@pytest.fixture(scope="module")
def jobs48():
    ref = ref_generate(N_JOBS, seed=3)
    return ref, port_jobs(ref)


def outputs_equal(a, b) -> bool:
    """Two RunOutput/ClusterOutput payloads bit for bit, queue included."""
    for f in a.result._fields:
        if not torch.equal(getattr(a.result, f), getattr(b.result, f)):
            return False
    for f in ("r_opt", "utility", "theory_pocd", "theory_cost"):
        if not torch.equal(getattr(a, f), getattr(b, f)):
            return False
    qa, qb = getattr(a, "queue", None), getattr(b, "queue", None)
    if (qa is None) != (qb is None):
        return False
    if qa is not None:
        for f in qa._fields:
            x, y = getattr(qa, f), getattr(qb, f)
            same = (x == y) if f == "slots" else torch.equal(x, y)
            if not same:
                return False
    return True


def _flat(jobs, strategy="sresume", source=None, **kw):
    return run_fleet_strategy(source or Philox(0), jobs, strategy, P,
                              chunk_jobs=CHUNK, reps=REPS, device="cpu",
                              **kw)


# ---------------------------------------------------------------------------
# 1. plans, schedules and contexts against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("events,match", [
    ((("meteor", 0),), "unknown fault kind"),
    ((("crash", -1),), "chunk must be >= 0"),
    ((("crash", 2), ("crash", 2)), "duplicate crash"),
    ((("chunk_fail", 0, 0),), "chunk_fail count"),
    ((("device_loss", 1, 0),), "device_loss needs"),
])
def test_plan_validation_matches_reference(events, match):
    with pytest.raises(ValueError, match=match) as got:
        FaultPlan(events=tuple(FaultEvent(*e) for e in events))
    with pytest.raises(ValueError) as want:
        RefFaultPlan(events=tuple(RefFaultEvent(*e) for e in events))
    assert str(got.value) == str(want.value)


def test_plan_at_fingerprint_and_lowering_match_reference():
    ev = (("device_loss", 2, 2), ("chunk_fail", 2, 1), ("crash", 3),
          ("device_loss", 4, 0, (1, 6)), ("slot_change", 1, -10))
    plan = FaultPlan(events=ev, seed=5)
    ref = RefFaultPlan(events=ev, seed=5)
    assert plan.fingerprint() == ref.fingerprint()
    assert plan.kinds() == ref.kinds() and KINDS == REF_KINDS
    for ci in range(6):
        for kind in (None,) + KINDS:
            assert [tuple(e) for e in plan.at(ci, kind)] == \
                [tuple(e) for e in ref.at(ci, kind)]
    assert plan.fingerprint() != FaultPlan(events=ev, seed=6).fingerprint()
    assert EMPTY_PLAN.fingerprint() == "seed=0:"
    n = 0
    for name in registry.list_scenarios():
        faults = registry.get_scenario(name).faults
        assert faults == ref_registry.get_scenario(name).faults
        if faults:
            n += 1
            for seed in (0, 3):
                got, want = from_faults(faults, seed), \
                    ref_from_faults(faults, seed)
                assert [tuple(e) for e in got.events] == \
                    [tuple(e) for e in want.events]
                assert got.fingerprint() == want.fingerprint()
    assert n >= 1


@pytest.mark.parametrize("seed", range(5))
def test_generate_matches_reference(seed):
    kw = dict(n_chunks=40, p_device_loss=0.3, p_chunk_fail=0.3,
              p_corrupt=0.3, max_lost=3)
    got, want = generate(seed, **kw), ref_generate_plan(seed, **kw)
    assert got.n_events == want.n_events > 0
    assert [tuple(e) for e in got.events] == [tuple(e) for e in want.events]
    assert got.fingerprint() == want.fingerprint()
    assert got == generate(seed, **kw)


PLANS = {
    "two-losses": (("device_loss", 1, 2), ("device_loss", 3, 2)),
    "ids": (("device_loss", 0, 0, (3, 6)), ("device_loss", 2, 3),
            ("device_loss", 5, 9)),
    "scenario": (("device_loss", 2, 2), ("chunk_fail", 3, 1),
                 ("device_loss", 5, 2)),
    "slots": (("slot_change", 1, -10), ("slot_change", 3, 25),
              ("slot_change", 4, -500), ("chunk_fail", 2, 1)),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("alpha,base", [(1.0, 8), (0.5, 8), (1.0, 16)])
def test_schedules_match_reference(plan, alpha, base):
    """ElasticGovernor.schedule exactly; ChaosContext.bind's cost scales
    and slot schedule exactly, with and without a governor."""
    ev = PLANS[plan]
    got_plan, ref_plan = FaultPlan(events=ev), RefFaultPlan(events=ev)
    got = ElasticGovernor(alpha=alpha).schedule(got_plan, 7, base)
    want = RefElasticGovernor(alpha=alpha).schedule(ref_plan, 7, base)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for gov, ref_gov in ((None, None),
                         (ElasticGovernor(alpha=alpha, base_devices=base),
                          RefElasticGovernor(alpha=alpha,
                                             base_devices=base))):
        for slots in (None, 40):
            c = ChaosContext(got_plan, governor=gov)
            r = RefChaosContext(ref_plan, governor=ref_gov)
            c.bind(7, None, 2, slots=slots)
            r.bind(7, None, 2, slots=slots)
            assert np.array_equal(c.cost_scales, r.cost_scales)
            assert np.array_equal(c.slots_schedule, r.slots_schedule)
            assert c.base_devices == r.base_devices
            assert [c.slots_at(ci, slots) for ci in range(7)] == \
                [r.slots_at(ci, slots) for ci in range(7)]


def test_audit_records_match_reference(jobs48):
    """One plan (chunk failures, a corruption, a device loss) through
    both packages' flat fleets: the same audit records and the same
    report, and the port's result equals its chaos-free run."""
    ref_jobs, jobs = jobs48
    ev = (("chunk_fail", 1, 2), ("corrupt", 2, 1), ("device_loss", 3, 2),
          ("chunk_fail", 3, 1))
    ref_ctx = RefChaosContext(RefFaultPlan(events=ev, seed=9),
                              backoff_base=0.0)
    ref_run_fleet_strategy(jax.random.fold_in(KEY, ref_index_of("sresume")),
                           ref_jobs, "sresume", REF_P, chunk_jobs=CHUNK,
                           reps=REPS, chaos=ref_ctx)
    ctx = ChaosContext(FaultPlan(events=ev, seed=9), backoff_base=0.0)
    out = _flat(jobs, chaos=ctx)
    assert ctx.records == ref_ctx.records
    assert ctx.report() == ref_ctx.report()
    assert ("device_loss", "ignored: single-device run") in [
        (k, d) for _, k, d in ctx.records]
    assert outputs_equal(out, _flat(jobs))


# ---------------------------------------------------------------------------
# 2. checkpoints against the reference
# ---------------------------------------------------------------------------


LEAVES = [np.arange(4, dtype=np.int32), np.ones((2, 3), np.float64),
          np.array([True, False]), np.float32(2.5) * np.ones(3, np.float32),
          np.frombuffer(b'{"a": 1}', np.uint8)]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ckpt_directories_cross_read(tmp_path, writer):
    """A step written by either package loads through the other's
    load_leaves with equal arrays and dtypes, bfloat16 included."""
    bf = np.array([1.5, -2.25, 3e-3], np.float32)
    if writer == "port":
        ckpt.save(tmp_path, 7, LEAVES + [torch.from_numpy(bf).bfloat16()])
    else:
        ref_ckpt.save(tmp_path, 7, LEAVES + [jnp.asarray(bf, jnp.bfloat16)])
    got = ckpt.load_leaves(tmp_path, 7)
    want = ref_ckpt.load_leaves(tmp_path, 7)
    assert ckpt.latest_step(tmp_path) == ref_ckpt.latest_step(tmp_path) == 7
    for g, w, x in zip(got, want, LEAVES):
        assert g.dtype == w.dtype == x.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, x)
    assert got[-1].dtype == torch.bfloat16 and str(want[-1].dtype) == \
        "bfloat16"
    np.testing.assert_array_equal(got[-1].float().numpy(),
                                  np.asarray(want[-1], np.float32))


def _torn_writes(mod, path):
    mod.save(path, 1, [np.arange(3)])
    mod.save(path, 2, [np.arange(3)])
    (path / "step_00000003.tmp").mkdir()
    (path / "step_junk").mkdir()
    (path / "step_5").mkdir()
    (path / "notes.txt").write_text("x")
    return 2


def _truncated_manifest(mod, path):
    mod.save(path, 1, [np.arange(3)])
    bad = path / "step_00000002"
    bad.mkdir()
    (bad / "manifest.json").write_text('{"n_leaves": 1')
    return 1


def _missing_leaf(mod, path):
    mod.save(path, 1, [np.arange(3)])
    bad = path / "step_00000003"
    bad.mkdir()
    (bad / "manifest.json").write_text(json.dumps(
        {"step": 3, "n_leaves": 2, "leaves": []}))
    np.save(bad / "0.npy", np.arange(2))
    return 1


@pytest.mark.parametrize("case", [_torn_writes, _truncated_manifest,
                                  _missing_leaf])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_latest_step_skips_torn_writes(tmp_path, case, writer):
    """The reference's three hostile-directory cases: both packages pick
    the newest committed step; an empty or missing directory has none."""
    assert ckpt.latest_step(tmp_path / "nope") is None
    assert ckpt.latest_step(tmp_path) is None
    want = case(ckpt if writer == "port" else ref_ckpt, tmp_path)
    assert ckpt.latest_step(tmp_path) == want
    assert ref_ckpt.latest_step(tmp_path) == want


def _chunks(capacity: bool):
    rng = np.random.default_rng(1)
    sizes = (7, 12, 5)
    parts = _capacity_parts(2, len(sizes))
    for n, cap in zip(sizes, parts):
        cols = ((rng.random(n) < 0.6), (rng.random(n) * 100),
                (rng.random(n) * 1e3))
        met, comp, cost = (c.astype(np.float32) if c.dtype != bool else c
                           for c in cols)
        q = [np.float32(x) for x in rng.random(5) * (10, 50, 1, 30, 1)]
        yield n, met, comp, cost, (q if capacity else None), \
            (cap if capacity else None)


@pytest.mark.parametrize("capacity", [False, True],
                         ids=["flat", "capacity"])
def test_state_dict_matches_reference(capacity):
    """StreamCombiner.state_dict: the reference's keys, dtypes and arrays
    for flat chunks and for capacity windows (queue, slots, capacity
    metrics); from_state restores a combiner with the same bits."""
    got, want = StreamCombiner(), RefStreamCombiner()
    for n, met, comp, cost, q, cap in _chunks(capacity):
        got.add(SimResult(np.float32(0), torch.from_numpy(met),
                          torch.from_numpy(comp), torch.from_numpy(cost),
                          np.float32(0)), n_jobs=n,
                queue=None if q is None else QueueMetrics(
                    *(torch.tensor(x) for x in q), slots=9),
                capacity=cap)
        want.add(RefSimResult(jnp.float32(0), met, comp, cost,
                              jnp.float32(0)), n_jobs=n,
                 queue=None if q is None else RefQueueMetrics(
                     *(jnp.float32(x) for x in q), slots=9),
                 capacity=None if cap is None else
                 ref_obs_metrics.CapacityMetrics(*cap))
    g, w = got.state_dict(), want.state_dict()
    assert list(g) == list(w)
    for k in g:
        assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    back = StreamCombiner.from_state(g)
    a, b = back.finalize(device="cpu"), got.finalize(device="cpu")
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    if capacity:
        qa, qb = back.finalize_queue(device="cpu"), \
            got.finalize_queue(device="cpu")
        for f in QueueMetrics._fields:
            x, y = getattr(qa, f), getattr(qb, f)
            assert (x == y) if f == "slots" else torch.equal(x, y), f
        ca, cb = back.finalize_capacity(device="cpu"), \
            got.finalize_capacity(device="cpu")
        for f, x, y in zip(ca._fields, ca, cb):
            assert torch.equal(x, y), f
    with pytest.raises(ValueError, match="empty"):
        StreamCombiner().state_dict()


def test_ckpt_restore_and_async_writer(tmp_path):
    """restore rebuilds lists, tuples, NamedTuples and dicts of tensors in
    their stored dtypes (bfloat16 by its bits); the async writer commits,
    keeps `keep` steps, and refuses a tensor that is not in host memory."""
    tree = {"b": [torch.arange(5), (torch.ones(2, 2).bfloat16(), None)],
            "a": QueueMetrics(*(torch.tensor(float(i)) for i in range(5)),
                              slots=None)}
    ckpt.save(tmp_path, 3, tree)
    back = ckpt.restore(tmp_path, 3, tree, device="cpu")
    assert list(back) == ["a", "b"] and isinstance(back["a"], QueueMetrics)
    assert torch.equal(back["b"][0], tree["b"][0])
    assert back["b"][1][0].dtype == torch.bfloat16
    assert torch.equal(back["b"][1][0], tree["b"][1][0])
    assert back["b"][1][1] is None and back["a"].slots is None
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(tmp_path, 3, [torch.zeros(1)], device="cpu")
    w = ckpt.AsyncCheckpointer(tmp_path / "async", keep=2)
    for step in (1, 2, 3):
        w.save(step, [np.full(3, step)])
    w.wait()
    assert sorted(p.name for p in (tmp_path / "async").iterdir()) == \
        ["step_00000002", "step_00000003"]
    np.testing.assert_array_equal(
        ckpt.load_leaves(tmp_path / "async", 3)[0], np.full(3, 3))
    with pytest.raises(TypeError, match="host"):
        w.save(4, [torch.empty(3, device="meta")])


def test_pack_unpack_state_and_fingerprint():
    arrays = {"a": np.arange(5), "b": np.ones(3, np.float32)}
    fp = run_fingerprint(strategy="sresume", n_jobs=5, key=0, theta=1e-4,
                         slots=None, s=np.int64(3))
    assert fp["s"] == 3 and isinstance(fp["s"], int)
    leaves = pack_state(arrays, next_chunk=3, fingerprint=fp)
    header, back = unpack_state(leaves)
    assert header["next_chunk"] == 3
    check_fingerprint(header["fingerprint"], fp)
    assert all(np.array_equal(arrays[k], back[k]) for k in arrays)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        check_fingerprint(header["fingerprint"], dict(fp, strategy="hedge"))
    with pytest.raises(ValueError, match="carries"):
        unpack_state(leaves[:-1])


# ---------------------------------------------------------------------------
# 3. both fleets under a plan against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["hedge", "sresume", "adaptive"])
def test_governed_r_matches_reference(jobs48, strategy):
    """A device loss of 4 of 8 devices at chunk 2 under the elastic
    governor: the flat and the capacity fleet re-price chunks 2 and 3 at
    scale 2, and r* equals the reference's on both; chunks 0-1 keep the
    unfaulted r*, and the later ones speculate no more than before."""
    ref_jobs, jobs = jobs48
    ev = (("device_loss", 2, 4),)
    key = jax.random.fold_in(KEY, ref_index_of(strategy))

    def both(run_ref, run_port, **kw):
        ref_ctx = RefChaosContext(RefFaultPlan(events=ev),
                                  governor=RefElasticGovernor(base_devices=8))
        ctx = ChaosContext(FaultPlan(events=ev),
                           governor=ElasticGovernor(base_devices=8))
        want = run_ref(key, ref_jobs, strategy, REF_P, chunk_jobs=CHUNK,
                       chaos=ref_ctx, **kw)
        got = run_port(Philox(0), jobs, strategy, P, chunk_jobs=CHUNK,
                       chaos=ctx, device="cpu", **kw)
        assert ctx.cost_scale(1) == 1.0 and ctx.cost_scale(2) == 2.0
        assert ctx.records == ref_ctx.records
        np.testing.assert_array_equal(got.r_opt.numpy(),
                                      np.asarray(want.r_opt))
        np.testing.assert_allclose(got.theory_cost.numpy(),
                                   np.asarray(want.theory_cost), rtol=1e-4)
        base = run_port(Philox(0), jobs, strategy, P, chunk_jobs=CHUNK,
                        device="cpu", **kw)
        r_base = base.r_opt.numpy().reshape(4, -1)
        r_out = got.r_opt.numpy().reshape(4, -1)
        assert np.array_equal(r_base[:2], r_out[:2])
        assert np.all(r_out[2:] <= r_base[2:])

    both(ref_run_fleet_strategy, run_fleet_strategy)
    both(ref_run_cluster_fleet, run_cluster_fleet_strategy, slots=40)


@pytest.fixture(scope="module")
def cluster_faulted(jobs48):
    """sresume's capacity fleet at 40 slots under slot_change -10 at
    window 1, chunk_fail at 2 and a corruption at 3: reference and port
    on the reference's replayed draws."""
    ref_jobs, jobs = jobs48
    ev = (("slot_change", 1, -10), ("chunk_fail", 2, 1), ("corrupt", 3, 1))
    kw = dict(slots=40, reps=REPS, chunk_jobs=CHUNK, collect_metrics=True)
    ref_ctx = RefChaosContext(RefFaultPlan(events=ev), backoff_base=0.0)
    want = ref_run_cluster_fleet(
        jax.random.fold_in(KEY, ref_index_of("sresume")), ref_jobs,
        "sresume", REF_P, chaos=ref_ctx, **kw)
    ctx = ChaosContext(FaultPlan(events=ev), backoff_base=0.0)
    got = run_cluster_fleet_strategy(JaxFleetReplay(KEY), jobs, "sresume",
                                     P, chaos=ctx, device="cpu", **kw)
    return ref_jobs, want, ref_ctx, got, ctx


def test_cluster_fleet_under_slot_change_matches_reference(cluster_faulted):
    """The rules of test_run_cluster_fleet_matches_reference: r* equal,
    job_met equal but deadline ties, mean cost and queue metrics within
    rtol 1e-4, the counters and histograms of the capacity metrics equal;
    the same audit records; the window pools 40, 30, 30, 30."""
    ref_jobs, w, ref_ctx, g, ctx = cluster_faulted
    assert ctx.records == ref_ctx.records
    assert [ctx.slots_at(ci, 40) for ci in range(4)] == [40, 30, 30, 30]
    np.testing.assert_array_equal(g.r_opt.numpy(), np.asarray(w.r_opt))
    flips = g.result.job_met.numpy() != np.asarray(w.result.job_met)
    ties = clock_ties(w.result.job_completion, ref_jobs.D, ref_jobs.arrival)
    assert not (flips & ~ties).any()
    np.testing.assert_allclose(float(g.result.mean_cost),
                               float(w.result.mean_cost), rtol=1e-4)
    for f in ("mean_wait", "max_wait", "utilization", "preempted",
              "admitted_frac"):
        np.testing.assert_allclose(float(getattr(g.queue, f)),
                                   float(getattr(w.queue, f)), rtol=1e-4,
                                   err_msg=f)
    assert g.queue.slots == w.queue.slots == 40
    for f, gm, wm in zip(g.metrics._fields, g.metrics, w.metrics):
        if f in ("occupancy", "wait_total"):
            np.testing.assert_allclose(float(gm), float(wm), rtol=1e-4,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(gm.numpy(), np.asarray(wm),
                                          err_msg=f)


def test_checkpoint_payloads_match_reference(jobs48, tmp_path):
    """The flat fleet checkpointed in both packages on the reference's
    replayed draws: the same header fields and chunk, the same run state
    keys, weights and r*, per-job columns within f32 rtol 1e-5 (met equal
    but deadline ties); the fingerprints differ only in the key."""
    ref_jobs, jobs = jobs48
    ref_run_fleet_strategy(jax.random.fold_in(KEY, ref_index_of("sresume")),
                           ref_jobs, "sresume", REF_P, chunk_jobs=CHUNK,
                           reps=REPS, checkpoint=str(tmp_path / "ref"))
    _flat(jobs, source=JaxFleetReplay(KEY, Tb=tb_of(jobs, CHUNK)),
          checkpoint=str(tmp_path / "port"))
    got = recovery.unpack_state(ckpt.load_leaves(tmp_path / "port", 4))
    want = recovery.unpack_state(ref_ckpt.load_leaves(tmp_path / "ref", 4))
    assert got[0]["fields"] == want[0]["fields"]
    assert got[0]["next_chunk"] == want[0]["next_chunk"] == 4
    gfp, wfp = got[0]["fingerprint"], want[0]["fingerprint"]
    assert sorted(gfp) == sorted(wfp)
    assert {k for k in gfp if gfp[k] != wfp[k]} == {"key"}
    g, w = got[1], want[1]
    for k in ("acc_weights", "r_opt"):
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    flips = g["acc_met"] != w["acc_met"]
    assert not (flips & ~deadline_ties(w["acc_completion"],
                                       ref_jobs.D)).any()
    for k in ("acc_completion", "acc_cost", "th_p", "th_c"):
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# 4. port identities, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def base(jobs48):
    return _flat(jobs48[1])


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_crash_resume_bit_identity_every_chunk(jobs48, base, tmp_path, k):
    """Crash after chunk k's checkpoint commits, resume through a fresh
    checkpointer: the uninterrupted run's bits, at every boundary."""
    jobs = jobs48[1]
    plan = FaultPlan(events=(FaultEvent("crash", k),))
    cfg = CheckpointConfig(directory=tmp_path)
    with pytest.raises(SimulatedCrash) as ei:
        _flat(jobs, chaos=ChaosContext(plan), checkpoint=cfg)
    assert ei.value.chunk == k
    assert ckpt.latest_step(tmp_path) == k + 1
    ctx = ChaosContext(plan)
    out = resume_fleet(Philox(0), jobs, "sresume", P, chunk_jobs=CHUNK,
                       reps=REPS, chaos=ctx, checkpoint=cfg, device="cpu")
    assert outputs_equal(base, out)
    assert ctx.records[0] == (k + 1, "resume", f"resumed at chunk {k + 1}")


@pytest.mark.parametrize("strategy", names())
def test_crash_resume_every_strategy(jobs48, tmp_path, strategy):
    jobs = jobs48[1]
    want = _flat(jobs, strategy)
    plan = FaultPlan(events=(FaultEvent("crash", 1),))
    cfg = CheckpointConfig(directory=tmp_path, use_async=False)
    with pytest.raises(SimulatedCrash):
        _flat(jobs, strategy, chaos=ChaosContext(plan), checkpoint=cfg)
    out = resume_fleet(Philox(0), jobs, strategy, P, chunk_jobs=CHUNK,
                       reps=REPS, chaos=ChaosContext(plan), checkpoint=cfg,
                       device="cpu")
    assert outputs_equal(want, out)


def test_cluster_crash_resume_with_slot_change(jobs48, tmp_path):
    """The capacity fleet: the pool shrinks at window 1, a chunk fails at
    2, the run crashes after window 2; the resume equals the
    uninterrupted faulted run, queue metrics and per-window slots
    included."""
    jobs = jobs48[1]
    kw = dict(slots=40, chunk_jobs=CHUNK, reps=REPS, collect_metrics=True,
              device="cpu")
    events = (FaultEvent("slot_change", 1, -10),
              FaultEvent("chunk_fail", 2, 1))
    want = run_cluster_fleet_strategy(
        Philox(0), jobs, "sresume", P,
        chaos=ChaosContext(FaultPlan(events=events), backoff_base=0.0), **kw)
    plan = FaultPlan(events=events + (FaultEvent("crash", 2),))
    cfg = CheckpointConfig(directory=tmp_path)
    with pytest.raises(SimulatedCrash):
        run_cluster_fleet_strategy(
            Philox(0), jobs, "sresume", P,
            chaos=ChaosContext(plan, backoff_base=0.0), checkpoint=cfg, **kw)
    out = resume_cluster_fleet(Philox(0), jobs, "sresume", P,
                               checkpoint=cfg,
                               chaos=ChaosContext(plan, backoff_base=0.0),
                               **kw)
    assert outputs_equal(want, out)
    for f, a, b in zip(want.metrics._fields, want.metrics, out.metrics):
        assert torch.equal(a, b), f
    state = recovery.unpack_state(ckpt.load_leaves(tmp_path, 4))[1]
    np.testing.assert_array_equal(state["acc_queue_slots"],
                                  [40, 30, 30, 30])


def test_retry_and_corruption_are_invisible_and_deterministic(jobs48, base):
    jobs = jobs48[1]
    plan = FaultPlan(events=(FaultEvent("chunk_fail", 1, 2),
                             FaultEvent("corrupt", 2, 1)), seed=9)
    ctx1 = ChaosContext(plan, backoff_base=0.0)
    ctx2 = ChaosContext(plan, backoff_base=0.0)
    assert outputs_equal(base, _flat(jobs, chaos=ctx1))
    assert outputs_equal(base, _flat(jobs, chaos=ctx2))
    assert ctx1.records == ctx2.records
    kinds = [k for _, k, _ in ctx1.records]
    assert kinds.count("retry") == 3 and kinds.count("corrupt") == 1


def test_integrity_check_and_poison():
    """The poison touches a copy only and NaNs an eighth of every float
    leaf; the check finds NaN in tensors and arrays, not -inf."""
    jc = torch.full((2, 3, 16), -torch.inf)
    jc[:, :, :8] = 1.0
    tree = (jc, torch.zeros(2, 3, 16), torch.arange(4))
    assert not inject._has_nan(tree)
    rng = np.random.Generator(np.random.PCG64((9, 2, 0)))
    poisoned = inject._poison(tree, rng)
    assert not inject._has_nan(tree) and inject._has_nan(poisoned)
    assert int(torch.isnan(poisoned[1]).sum()) == 96 // 8
    assert poisoned[2] is tree[2]
    assert inject._has_nan([None, {"a": np.array([0.0, np.nan])}])


def test_empty_plan_matches_chaos_off(jobs48, base):
    ctx = ChaosContext(EMPTY_PLAN)
    assert outputs_equal(base, _flat(jobs48[1], chaos=ctx))
    assert ctx.records == [] and ctx.report() == "chaos: no events fired"


def test_exhausted_backoff_and_cadence(jobs48, tmp_path):
    """ChaosExhausted past max_attempts; the backoff doubles; every=2
    halves the saves, keep=2 bounds retention, the last chunk always
    checkpoints."""
    jobs = jobs48[1]
    plan = FaultPlan(events=(FaultEvent("chunk_fail", 0, 5),))
    with pytest.raises(ChaosExhausted):
        _flat(jobs, chaos=ChaosContext(plan, max_attempts=3,
                                       backoff_base=0.0))
    sleeps = []
    plan = FaultPlan(events=(FaultEvent("chunk_fail", 0, 3),))
    _flat(jobs, chaos=ChaosContext(plan, max_attempts=5, backoff_base=0.1,
                                   sleep=sleeps.append))
    assert sleeps == pytest.approx([0.1, 0.2, 0.4])
    cfg = CheckpointConfig(directory=tmp_path, every=2, keep=2,
                           use_async=False)
    _flat(jobs, checkpoint=cfg)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000002", "step_00000004"]
    assert ckpt.latest_step(tmp_path) == 4


@pytest.mark.parametrize("what", ["strategy", "seed"])
def test_resume_refuses_fingerprint_mismatch(jobs48, tmp_path, what):
    jobs = jobs48[1]
    cfg = CheckpointConfig(directory=tmp_path)
    plan = FaultPlan(events=(FaultEvent("crash", 1),))
    with pytest.raises(SimulatedCrash):
        _flat(jobs, chaos=ChaosContext(plan), checkpoint=cfg)
    strategy, source = (("hedge", Philox(0)) if what == "strategy"
                        else ("sresume", Philox(1)))
    with pytest.raises(ValueError, match="fingerprint mismatch") as err:
        resume_fleet(source, jobs, strategy, P, chunk_jobs=CHUNK,
                     reps=REPS, chaos=ChaosContext(plan), checkpoint=cfg,
                     device="cpu")
    assert ("key" if what == "seed" else "strategy") in str(err.value)


def test_refusals_and_fresh_resume(jobs48, base, tmp_path):
    """resume without a checkpoint, budget plus chaos, and a chaos= that
    is no plan raise; resume=True over an empty directory starts at
    chunk 0."""
    jobs = jobs48[1]
    with pytest.raises(ValueError, match="requires a checkpoint"):
        _flat(jobs, resume=True)
    with pytest.raises(ValueError, match="requires a checkpoint"):
        run_cluster_fleet_strategy(Philox(0), jobs, "sresume", P, slots=40,
                                   resume=True, device="cpu")
    for run in (_flat, lambda j, **kw: run_cluster_fleet_strategy(
            Philox(0), j, "clone", P, slots=40, device="cpu", **kw)):
        with pytest.raises(ValueError, match="chaos-free"):
            run(jobs, budget=1e5, chaos=EMPTY_PLAN)
    with pytest.raises(TypeError, match="FaultPlan"):
        run_all(Philox(0), jobs, P, chaos=ChaosContext(EMPTY_PLAN),
                device="cpu")
    with pytest.raises(ValueError, match="requires a checkpoint"):
        run_all(Philox(0), jobs, P, resume=True, device="cpu")
    out = _flat(jobs, checkpoint=tmp_path, resume=True)
    assert outputs_equal(base, out)


def test_run_all_picks_up_a_scenarios_plan(monkeypatch):
    """run_all by scenario name: pod-loss-flash-crowd's declared faults
    become every strategy's plan (device losses recorded as ignored on one
    device, the chunk failure retried), and the results equal the
    chaos-free run's."""
    monkeypatch.setitem(registry.SCENARIOS, "pod-loss-mini",
                        registry.get_scenario("pod-loss-flash-crowd")
                        ._replace(name="pod-loss-mini", n_jobs=N_JOBS))
    seen = []

    class Recording(ChaosContext):
        def __init__(self, plan, **kw):
            super().__init__(plan, **kw)
            seen.append(self)

    monkeypatch.setattr(inject, "ChaosContext", Recording)
    strategies = ("hadoop_ns", "sresume")
    outs, r_min = run_all(Philox(0), "pod-loss-mini", P,
                          strategies=strategies, chunk_jobs=CHUNK,
                          block_jobs=CHUNK, device="cpu")
    plan = from_faults(registry.get_scenario("pod-loss-mini").faults)
    assert len(seen) == 2
    for ctx in seen:
        assert ctx.plan == plan
        assert [(c, k) for c, k, _ in ctx.records] == [
            (2, "device_loss"), (3, "retry")]
    want, r_want = run_all(Philox(0), "pod-loss-mini", P,
                           strategies=strategies, chunk_jobs=CHUNK,
                           block_jobs=CHUNK, chaos=EMPTY_PLAN, device="cpu")
    assert r_min == r_want
    for name in strategies:
        assert outputs_equal(outs[name], want[name]), name


def test_shrink_fleet_mesh_on_one_card():
    """No failure returns the mesh (an id outside it is no failure of
    it); losing the one device raises; a (2, 4) mesh laid on one device
    shrinks over its surviving point ids."""
    mesh = fleet_mesh(device="cpu")
    assert shrink_fleet_mesh(mesh, failed=[]) is mesh
    assert shrink_fleet_mesh(mesh, failed=[3], reps=2) is mesh
    with pytest.raises(RuntimeError, match="no devices survive"):
        shrink_fleet_mesh(mesh, failed=[0])
    cpu = torch.device("cpu")
    eight = FleetMesh(2, 4, (cpu,) * 8, tuple(range(8)))
    assert fleet_mesh(devices=8, reps=2, device=["cpu"] * 8) == eight
    six = shrink_fleet_mesh(eight, failed=[2, 5], reps=2)
    assert six == FleetMesh(2, 3, (cpu,) * 6, (0, 1, 3, 4, 6, 7))


def test_governor_resolves_tail_at_new_price():
    from repro_torch.obs.tail import TailGovernor
    tail = TailGovernor(deadline=60.0, n_tasks=200, price=1.0,
                        min_samples=8, device="cpu")
    rng = np.random.default_rng(0)
    for x in 10.0 * rng.pareto(1.5, size=64) + 10.0:
        tail.observe(float(x))
    gov = ElasticGovernor(alpha=1.0, tail=tail)
    gov.on_capacity(2, alive=4, base_devices=8, scale=2.0)
    assert tail.price == pytest.approx(2.0)
    assert gov.decision is not None and gov.decision.r_opt >= 0
    assert gov.history == [(2, 4, 2.0)]
