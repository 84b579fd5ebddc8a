"""The fleet over a mesh of several points (`repro_torch.fleet.mesh`) on
the CPU: eight logical host points (`device=["cpu"] * 8`), the
counterpart of the reference's eight forced XLA host devices.

What is held:
* against the reference, run in a subprocess with
  `--xla_force_host_platform_device_count=8` (as test_torch_elastic.py
  runs it, so the flag cannot leak): `fleet_mesh`'s factorizations and
  errors, `shrink_fleet_mesh`'s id grids, None and raise cases, and for
  a few device-loss plans the chaos audit records, the elastic
  governor's `history`, the mesh after each chunk and `mesh_through`'s
  replay, all equal;
* port-only identities, bit for bit against `mesh=None` (the reference's
  tests/test_fleet.py, test_obs.py and test_chaos.py cases): the flat
  fleet for every strategy on (2, 4) and at reps 3 on (1, 1), (8, 1),
  (1, 8), (4, 2), monolithic and chunked; `run_all(devices=8)` against
  `devices=1`; the capacity fleet with its queue and `collect_metrics`;
  serving on (1, 4), known tail and online; a device-loss shrink 8 -> 6
  -> 4 across a crash and a resume, on both fleets;
* one `cuda` test (two cards or more): every kernel launched on cuda:1
  leaves the caller's current device as it was.

Nothing here imports JAX in this process.
"""
import importlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import Philox, SimParams, generate, names, run_all
from repro_torch.chaos import (ChaosContext, ElasticGovernor, FaultEvent,
                               FaultPlan, SimulatedCrash,
                               resume_cluster_fleet, resume_fleet)
from repro_torch.cluster.engine import run_cluster
from repro_torch.fleet import (FleetMesh, blocks, fleet_mesh, job_split,
                               run_fleet_strategy, shrink_fleet_mesh)
from repro_torch.fleet.cluster import run_cluster_fleet_strategy
from repro_torch.fleet.mesh import mesh_device
from repro_torch.serve import make_requests, run_serve

P = SimParams()
CPU8 = ["cpu"] * 8

# (devices, reps, shape) for fleet_mesh over 8 points
FACTOR = {
    "8r4": (8, 4, None), "8r1": (8, 1, None), "8r8": (8, 8, None),
    "6r4": (6, 4, None), "all_r1": (None, 1, None), "all_r3": (None, 3, None),
    "4r2": (4, 2, None), "shape24": (None, 1, [2, 4]),
    "shape81": (None, 1, [8, 1]), "zero": (0, 1, None),
    "sixteen": (16, 1, None), "shape34": (None, 1, [3, 4]),
    "shape02": (None, 1, [0, 2]),
}
# (reps, failed ids) for shrink_fleet_mesh of fleet_mesh(devices=8, reps)
SHRINK = {
    "r2_2_5": (2, [2, 5]), "r1_0": (1, [0]), "r4_7": (4, [7]),
    "r2_none": (2, []), "r2_unknown": (2, [99]), "r3_1_2": (3, [1, 2]),
    "r2_one_left": (2, [0, 1, 2, 3, 4, 5, 6]),
    "r2_all": (2, list(range(8))),
}
# (reps, chunks, events) run through ChaosContext.begin_chunk on 8 points
CHAOS = {
    "ids_then_count": (2, 4, [["device_loss", 1, 1, [3, 6]],
                              ["device_loss", 2, 2, []]]),
    "down_to_one": (1, 4, [["device_loss", 0, 3, []],
                           ["device_loss", 2, 4, []],
                           ["device_loss", 3, 1, []]]),
    "two_at_once": (4, 3, [["device_loss", 1, 1, [0]],
                           ["device_loss", 1, 1, []]]),
    "lost_twice": (2, 3, [["device_loss", 0, 1, [3]],
                          ["device_loss", 1, 2, [3, 4]]]),
}

REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, "src")
    from repro.chaos import ChaosContext, ElasticGovernor, FaultEvent
    from repro.chaos import FaultPlan
    from repro.fleet.mesh import fleet_mesh, shrink_fleet_mesh
    cases = json.loads(sys.argv[1])

    def grid(m):
        if m is None:
            return None
        return [[int(d.id) for d in row] for row in m.devices]

    def attempt(fn):
        try:
            return {"ok": fn()}
        except Exception as e:
            return {"error": type(e).__name__}

    def plan_of(events):
        return FaultPlan(events=tuple(FaultEvent(k, c, n, tuple(ids))
                                      for k, c, n, ids in events))

    out = {"factor": {}, "shrink": {}, "chaos": {}}
    for name, (devices, reps, shape) in cases["factor"].items():
        out["factor"][name] = attempt(lambda: grid(fleet_mesh(
            devices=devices, reps=reps,
            shape=None if shape is None else tuple(shape))))
    for name, (reps, failed) in cases["shrink"].items():
        mesh = fleet_mesh(devices=8, reps=reps)
        def shrunk():
            m = shrink_fleet_mesh(mesh, failed, reps=reps)
            return "same" if m is mesh else grid(m)
        out["shrink"][name] = attempt(shrunk)
    for name, (reps, n_chunks, events) in cases["chaos"].items():
        plan = plan_of(events)
        mesh = fleet_mesh(devices=8, reps=reps)
        gov = ElasticGovernor()
        ctx = ChaosContext(plan, governor=gov)
        ctx.bind(n_chunks, mesh, reps)
        grids = []
        for ci in range(n_chunks):
            mesh = ctx.begin_chunk(ci, mesh, reps)
            grids.append(grid(mesh))
        through = [grid(ChaosContext(plan).mesh_through(
            k, fleet_mesh(devices=8, reps=reps), reps))
            for k in range(n_chunks + 1)]
        out["chaos"][name] = dict(records=ctx.records, history=gov.history,
                                  grids=grids, through=through)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref():
    cases = dict(factor=FACTOR, shrink=SHRINK, chaos=CHAOS)
    res = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(cases)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def grid(m):
    if m is None:
        return None
    j = m.job_extent
    return [list(m.ids[r * j:(r + 1) * j]) for r in range(m.rep_extent)]


def attempt(fn):
    try:
        return {"ok": fn()}
    except Exception as e:      # the reference's error type, compared
        return {"error": type(e).__name__}


def plan_of(events):
    return FaultPlan(events=tuple(FaultEvent(k, c, n, tuple(ids))
                                  for k, c, n, ids in events))


# ---------------------------------------------------------------------------
# 1. the mesh and chaos against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FACTOR))
def test_fleet_mesh_matches_reference(ref, name):
    devices, reps, shape = FACTOR[name]
    got = attempt(lambda: grid(fleet_mesh(
        devices=devices, reps=reps,
        shape=None if shape is None else tuple(shape), device=CPU8)))
    assert got == ref["factor"][name]


@pytest.mark.parametrize("name", sorted(SHRINK))
def test_shrink_fleet_mesh_matches_reference(ref, name):
    reps, failed = SHRINK[name]
    mesh = fleet_mesh(devices=8, reps=reps, device=CPU8)

    def shrunk():
        m = shrink_fleet_mesh(mesh, failed, reps=reps)
        return "same" if m is mesh else grid(m)
    assert attempt(shrunk) == ref["shrink"][name]


def _begin_chunks(reps, n_chunks, events):
    plan = plan_of(events)
    mesh = fleet_mesh(devices=8, reps=reps, device=CPU8)
    gov = ElasticGovernor()
    ctx = ChaosContext(plan, governor=gov)
    ctx.bind(n_chunks, mesh, reps)
    grids = []
    for ci in range(n_chunks):
        mesh = ctx.begin_chunk(ci, mesh, reps)
        assert mesh is None or mesh.devices == (torch.device("cpu"),) * \
            mesh.size
        grids.append(grid(mesh))
    through = [grid(ChaosContext(plan).mesh_through(
        k, fleet_mesh(devices=8, reps=reps, device=CPU8), reps))
        for k in range(n_chunks + 1)]
    return dict(records=[list(r) for r in ctx.records],
                history=[list(h) for h in gov.history], grids=grids,
                through=through)


@pytest.mark.parametrize("name", sorted(CHAOS))
def test_device_loss_records_match_reference(ref, name):
    """The audit records, the governor's history, the mesh after each
    chunk and the resumed runs' replayed meshes."""
    assert _begin_chunks(*CHAOS[name]) == ref["chaos"][name]


def test_job_split_and_mesh_device():
    mesh = fleet_mesh(shape=(2, 4), device=CPU8)
    assert job_split(mesh, 256) == [(0, 64), (64, 128), (128, 192),
                                    (192, 256)]
    assert job_split(None, 10) == [(0, 10)]
    with pytest.raises(ValueError, match="pad them"):
        job_split(mesh, 254)
    assert mesh_device(mesh, torch.device("cpu")) == torch.device("cpu")
    assert mesh_device(None, torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="asked for"):
        mesh_device(mesh, torch.device("cuda"))
    with pytest.raises(TypeError):
        mesh_device(object(), torch.device("cpu"))


def test_no_quiet_repetition(monkeypatch):
    """On one visible card: more points than cards raise, a card that is
    not there raises, and repeated points come only from a list the
    caller wrote (every point indexed)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    one = fleet_mesh()
    assert one.devices == (torch.device("cuda", 0),)
    for kw in (dict(devices=4), dict(shape=(2, 2))):
        with pytest.raises(ValueError, match="only 1 are visible"):
            fleet_mesh(**kw)
    with pytest.raises(ValueError, match="not visible"):
        fleet_mesh(device=["cuda:0", "cuda:1"])
    four = fleet_mesh(shape=(2, 2), device=["cuda"] * 4)
    assert four == FleetMesh(2, 2, (torch.device("cuda", 0),) * 4,
                             (0, 1, 2, 3))


@pytest.mark.parametrize("blocks_range", [(0, 4), (0, 2), (2, 4), (3, 6),
                                          (4, 6)])
def test_block_view_of_a_point(blocks_range):
    """A point's view of blocks [g0, g1) is the chunk view's rows of those
    blocks, every block starting at a multiple of ALIGN."""
    jobs = generate(30, seed=1, device="cpu")
    layout = blocks.block_layout(jobs, 8, pad_blocks_to=3, min_blocks=6)
    whole = blocks.block_view(jobs, layout, block_offset=5, device="cpu")
    g0, g1 = blocks_range
    part = blocks.block_view(jobs, layout, block_offset=5,
                             blocks=blocks_range, device="cpu")
    Jb = 9
    assert part.block_ids == whole.block_ids[g0:g1]
    assert (part.starts % blocks.ALIGN == 0).all()
    np.testing.assert_array_equal(part.counts, whole.counts[g0:g1])
    assert torch.equal(part.jobs.n_tasks,
                       whole.jobs.n_tasks[g0 * Jb:g1 * Jb])
    lo = int(whole.starts[g0]) if g0 < len(whole.starts) else 0
    T = part.jobs.total_tasks
    for f in ("task_t_min", "task_beta", "task_D"):
        assert torch.equal(getattr(part.jobs, f),
                           getattr(whole.jobs, f)[lo:lo + T])
    assert torch.equal(part.task_valid, whole.task_valid[lo:lo + T])


# ---------------------------------------------------------------------------
# 2. every path on a mesh, bit for bit against no mesh
# ---------------------------------------------------------------------------


def assert_outputs_equal(a, b, what=""):
    for f in a.result._fields:
        x, y = getattr(a.result, f), getattr(b.result, f)
        assert x.dtype == y.dtype and torch.equal(x, y), (what, f)
    for f in ("r_opt", "utility", "theory_pocd", "theory_cost",
              "n_saturated"):
        x, y = getattr(a, f), getattr(b, f)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), (what, f)
    qa, qb = getattr(a, "queue", None), getattr(b, "queue", None)
    assert (qa is None) == (qb is None)
    if qa is not None:
        for f in qa._fields:
            x, y = getattr(qa, f), getattr(qb, f)
            assert (x == y) if f == "slots" else torch.equal(x, y), (what, f)
    ma, mb = getattr(a, "metrics", None), getattr(b, "metrics", None)
    assert (ma is None) == (mb is None)
    if ma is not None:
        for f in ma._fields:
            np.testing.assert_array_equal(np.asarray(getattr(ma, f)),
                                          np.asarray(getattr(mb, f)),
                                          err_msg=f"{what} {f}")


@pytest.fixture(scope="module")
def jobs40():
    return generate(40, seed=0, device="cpu")


@pytest.fixture(scope="module")
def jobs30():
    return generate(30, seed=0, device="cpu")


@pytest.fixture(scope="module")
def no_mesh():
    """Runs without a mesh, each made once: {key: output}."""
    return {}


def _flat(jobs, name, **kw):
    return run_fleet_strategy(Philox(0), jobs, name, P, block_jobs=8,
                              device="cpu", **kw)


@pytest.mark.parametrize("name", names())
def test_flat_every_strategy_on_2x4(jobs40, name):
    want = _flat(jobs40, name, reps=2)
    got = _flat(jobs40, name, reps=2,
                mesh=fleet_mesh(shape=(2, 4), device=CPU8))
    assert_outputs_equal(got, want, name)


@pytest.mark.parametrize("chunk_jobs", [None, 16])
@pytest.mark.parametrize("shape", [(1, 1), (8, 1), (1, 8), (4, 2)])
def test_flat_mesh_shapes_reps3(jobs30, no_mesh, shape, chunk_jobs):
    """reps 3 pads the "rep" axis on (8, 1) and (4, 2); (1, 8) leaves
    points with padding blocks only."""
    key = ("flat", chunk_jobs)
    if key not in no_mesh:
        no_mesh[key] = _flat(jobs30, "sresume", reps=3,
                             chunk_jobs=chunk_jobs)
    got = _flat(jobs30, "sresume", reps=3, chunk_jobs=chunk_jobs,
                mesh=fleet_mesh(shape=shape, device=CPU8))
    assert_outputs_equal(got, no_mesh[key], shape)


def test_run_all_devices_8_equals_1(jobs30):
    outs8, r8 = run_all(Philox(0), jobs30, P, devices=8, reps=2,
                        device="cpu")
    outs1, r1 = run_all(Philox(0), jobs30, P, devices=1, reps=2,
                        device="cpu")
    assert r8 == r1
    assert list(outs8) == list(outs1) == list(names())
    for name in outs8:
        assert_outputs_equal(outs8[name], outs1[name], name)


@pytest.mark.parametrize("shape,chunk_jobs", [((1, 1), None),
                                              ((2, 4), None),
                                              ((8, 1), None),
                                              ((2, 2), 10)])
def test_capacity_mesh_invariance(jobs40, no_mesh, shape, chunk_jobs):
    """Queue and capacity metrics too; reps 3 pads to the mesh's size."""
    kw = dict(slots=200, theta=1e-3, reps=3, collect_metrics=True,
              chunk_jobs=chunk_jobs, device="cpu")
    key = ("capacity", chunk_jobs)
    if key not in no_mesh:
        no_mesh[key] = run_cluster_fleet_strategy(Philox(0), jobs40,
                                                  "sresume", P, **kw)
    got = run_cluster_fleet_strategy(
        Philox(0), jobs40, "sresume", P,
        mesh=fleet_mesh(shape=shape, device=CPU8), **kw)
    assert_outputs_equal(got, no_mesh[key], shape)


def test_run_cluster_devices_8_equals_1(jobs30):
    kw = dict(slots=150, reps=2, strategies=("hadoop_ns", "clone",
                                             "adaptive"),
              collect_metrics=True, device="cpu")
    outs8, r8 = run_cluster(Philox(0), jobs30, P, devices=8, **kw)
    outs1, r1 = run_cluster(Philox(0), jobs30, P, devices=1, **kw)
    assert r8 == r1
    for name in outs8:
        assert_outputs_equal(outs8[name], outs1[name], name)


@pytest.fixture(scope="module")
def reqs600():
    return make_requests("request-storm", 600, device="cpu")


def _serve_equal(a, b):
    for f in a.result._fields:
        assert torch.equal(getattr(a.result, f), getattr(b.result, f)), f
    for f in ("strategy", "utility", "latency", "mean_r", "n_probes",
              "n_refits", "fits", "epoch_strategies"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("online,window", [(False, 256), (True, 256),
                                           (False, 254)])
def test_serving_on_1x4(reqs600, online, window):
    """Every strategy's stream on (1, 4) against no mesh. Window 254 is
    padded to 256 on the mesh, so it is held against window 256 without
    one (on the CPU a 254-lane window puts its last lanes in pow's scalar
    loop, a difference of position, not of the mesh)."""
    kw = dict(device="cpu")
    if online:
        kw.update(refit_every=200, probe_every=8)
    want, r_want = run_serve(Philox(0), reqs600, window=256, **kw)
    got, r_got = run_serve(Philox(0), reqs600, window=window,
                           mesh=fleet_mesh(shape=(1, 4), device=CPU8), **kw)
    assert r_got == r_want
    assert list(got) == list(want)
    for name in want:
        _serve_equal(got[name], want[name])


@pytest.fixture(scope="module")
def jobs48():
    return generate(48, seed=3, device="cpu")


LOSS_PLAN = FaultPlan(events=(
    FaultEvent("device_loss", 1, device_ids=(3, 6)),
    FaultEvent("device_loss", 2, 2),
    FaultEvent("crash", 2),
))


@pytest.mark.parametrize("path", ["flat", "capacity"])
def test_device_loss_shrink_is_bitwise_invisible(ref, tmp_path, jobs48,
                                                 path):
    """8 -> 6 -> 4 points across chunk boundaries (non-contiguous ids),
    a crash after chunk 2 and a resume on the shrunk mesh: the bits of
    the run that never lost a point. The run's device-loss records are
    the reference's for the same plan, and the governor saw both."""
    run, resume = ((run_fleet_strategy, resume_fleet) if path == "flat"
                   else (run_cluster_fleet_strategy, resume_cluster_fleet))
    kw = dict(mesh=fleet_mesh(devices=8, reps=2, device=CPU8),
              chunk_jobs=12, reps=2, device="cpu")
    if path == "capacity":
        kw.update(slots=100, collect_metrics=True)
    base = run(Philox(0), jobs48, "sresume", P, **kw)
    gov = ElasticGovernor(alpha=0.0)     # history only: no re-pricing
    ctx = ChaosContext(LOSS_PLAN, governor=gov)
    with pytest.raises(SimulatedCrash):
        run(Philox(0), jobs48, "sresume", P, chaos=ctx,
            checkpoint=tmp_path, **kw)
    losses = [list(r) for r in ctx.records if r[1] == "device_loss"]
    assert losses == ref["chaos"]["ids_then_count"]["records"]
    assert [d for _, k, d in ctx.records if k == "device_loss"] == [
        "failed=[3, 6] alive=6", "failed=[5, 7] alive=4"]
    assert gov.history == [(1, 6, 1.0), (2, 4, 1.0)]
    out = resume(Philox(0), jobs48, "sresume", P,
                 chaos=ChaosContext(LOSS_PLAN), checkpoint=tmp_path, **kw)
    assert_outputs_equal(out, base, path)


# ---------------------------------------------------------------------------
# 3. on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_launches_on_another_card_keep_the_current_device():
    """Every kernel's C entry sets its tensors' device for the launch and
    gives the caller's back: launches on cuda:1 leave cuda:0 current, and
    a flat fleet over both cards equals the run without a mesh."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from repro_torch.kernels import dispatch_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import philox
    from repro_torch.sim.runner import jobspecs_of
    from repro_torch.strategies import solve_jobs
    # the module: `repro_torch.kernels.pocd_mc` is the function
    pm = importlib.import_module("repro_torch.kernels.pocd_mc")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    g = torch.Generator().manual_seed(0)

    def kept(what):
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0, what

    jobs = generate(64, seed=1, device=dev)
    solve_jobs("sresume", jobspecs_of(jobs, P, 1e-4), 9, device=dev)
    kept("grid_solve")
    cells = torch.arange(256, dtype=torch.int64, device=dev)
    philox.philox_rows(cells, cells.clone(), 4, (1, 2))
    kept("philox_rows")
    with torch.cuda.device(dev):
        philox.philox_raw_cuda(np.zeros((8, 4), np.uint32),
                               np.ones((8, 2), np.uint32))
    kept("philox_raw")
    rel = torch.sort(torch.rand(512, generator=g))[0].to(dev)
    ds.dispatch_scan(rel, torch.rand(512, generator=g).to(dev),
                     torch.tensor([512], dtype=torch.int32, device=dev),
                     torch.zeros(16, device=dev))
    kept("dispatch_scan")
    J, N, R = 64, 16, 5
    u = torch.rand((J, N, R), generator=g).clamp_min(1e-6).to(dev)
    cols = [torch.full((J,), v, device=dev) for v in (10.0, 2.0, 60.0)]
    r = torch.ones(J, dtype=torch.int32, device=dev)
    pm.pocd_mc(u, *cols, r, mode="clone")
    kept("pocd_mc")
    assert pm.monotone_violations(dev) == (0, 0)
    kept("pocd_mc_monotone")
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((1, 2, 128, 64), generator=g).to(dev, dt)
        fa.attention(q, q, q, causal=True)
        kept(f"flash_attention {dt}")
    mesh = fleet_mesh(shape=(1, 2), device=["cuda:0", "cuda:1"])
    jobs = generate(200, seed=2, device="cuda:0")
    want = run_fleet_strategy(Philox(0), jobs, "sresume", P, block_jobs=16,
                              chunk_jobs=64, reps=2, device="cuda:0")
    got = run_fleet_strategy(Philox(0), jobs, "sresume", P, block_jobs=16,
                             chunk_jobs=64, reps=2, mesh=mesh)
    kept("the fleet on two cards")
    assert_outputs_equal(got, want, "two cards")
