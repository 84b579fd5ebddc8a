"""Port parity of the fleet layer (`repro_torch.fleet`).

Draws are the reference's `jax.random` draws replayed into the port: a
fleet cell (strategy, replication, global block) is keyed as the
reference keys it, fold_in(fold_in(fold_in(key, index_of(strategy)),
rep), block) for the flat fleet and without the block for the capacity
fleet (`JaxFleetReplay`).

What is held, and how tightly:
* the block geometry (`block_layout`, `make_blocks`, `gather_index`,
  `pad_count`, `block_task_counts`) field for field;
* `run_all_fleet` and `run_cluster_fleet_strategy` against the
  reference's under the rules of test_torch_sim.py and
  test_torch_cluster.py: r* equal, job_met equal but deadline ties,
  job_cost within f32 rtol 1e-5 (flat), means within rtol 1e-4
  (capacity);
* `StreamCombiner`, `reduce_reps_host` and `combine_windows` against
  the reference's on the same inputs;
* port-only identities, bit for bit: chunked equal to monolithic,
  `fused=` True equal to False, `pad_to` invariance, the windowed batched
  replay equal to window-by-window replays, `run_all(devices=1)` equal to
  `run_all_fleet`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import blocks as ref_blocks
from repro.fleet import mesh as ref_mesh
from repro.fleet import run_all_fleet as ref_run_all_fleet
from repro.fleet import run_cluster_fleet_strategy as ref_run_cluster_fleet
from repro.obs import metrics as ref_obs_metrics
from repro.sim import SimParams as RefSimParams
from repro.sim import generate as ref_generate
from repro.sim.metrics import SimResult as RefSimResult
from repro.sim.metrics import StreamCombiner as RefStreamCombiner
from repro.strategies import index_of as ref_index_of
from repro.cluster.engine import QueueMetrics as RefQueueMetrics

import repro_torch
from repro_torch import Philox, SimParams, convert, generate, run_all
from repro_torch.ckpt import latest_step
from repro_torch.cluster import QueueMetrics, engine, run_cluster
from repro_torch.fleet import blocks, fleet_mesh, pad_count
from repro_torch.fleet import run_all_fleet, run_cluster_fleet_strategy
from repro_torch.fleet import runner as fleet_runner
from repro_torch.obs import metrics as obs_metrics
from repro_torch.sim.draws import DRAW_NAMES, FLEET_TAG, NO_BLOCK
from repro_torch.sim.metrics import SimResult, StreamCombiner, segment_sum
from test_torch_sim import JaxReplay, deadline_ties

KEY = jax.random.PRNGKey(0)
P = SimParams()
REF_P = RefSimParams()
RTOL = 1e-5
CLUSTER_STRATEGIES = ("sresume", "clone", "hadoop_s")


class JaxFleetReplay(JaxReplay):
    """Replays the reference fleet's draws: a cell's key is
    fold_in(fold_in(strategy_key, rep), block) (fleet/runner.py), or
    fold_in(strategy_key, rep) for the capacity fleet (fleet/cluster.py),
    then each sim's own split for "k1"/"k2".

    The reference draws a block's cell at (Tb, ...), and a jax.random
    draw's values depend on its shape, so `uniform_rows` needs the run's
    Tb: it draws each block's (Tb, ...) cell and gathers the asked rows
    from it (rows past Tb are the view's alignment rows, which the runner
    overwrites: they read row Tb - 1). The capacity fleet's cell
    (NO_BLOCK) is drawn at (rows.max() + 1, ...), the window's tasks."""

    def __init__(self, key, reps: int = 1, Tb=None):
        super().__init__(key, reps)
        self.Tb = Tb

    def cell_key(self, strategy, rep, block, name):
        k = jax.random.fold_in(
            jax.random.fold_in(self.key, ref_index_of(strategy)), rep)
        if block is not None:
            k = jax.random.fold_in(k, block)
        if name != "key":
            k = jax.random.split(k)[DRAW_NAMES.index(name) - 1]
        return k

    def uniform_rows(self, strategy, rep, name, cells, rows, rest, device,
                     tag=FLEET_TAG):
        assert tag == FLEET_TAG
        host = lambda x: (x.cpu().numpy() if isinstance(x, torch.Tensor)
                          else np.int64(x))
        cells, rows = np.broadcast_arrays(host(cells), host(rows))
        out = np.empty((cells.shape[0],) + tuple(rest), np.float32)
        for c in np.unique(cells):
            at = cells == c
            if c == NO_BLOCK:
                n = int(rows[at].max()) + 1
                block = None
            else:
                n = self.Tb
                block = int(c)
            u = np.array(jax.random.uniform(
                self.cell_key(strategy, rep, block, name), (n,) + tuple(rest),
                minval=1e-7, maxval=1.0))
            out[at] = u[np.minimum(rows[at], n - 1)]
        return torch.from_numpy(out).to(device)


def tb_of(jobs, block_jobs):
    """The fleet's one block width: the largest block's task count."""
    return int(blocks.block_task_counts(
        fleet_runner.job_columns(jobs).n_tasks, block_jobs).max())


def port_jobs(ref):
    return convert.jobset(ref.n_jobs, {f: np.asarray(getattr(ref, f))
                                       for f in ref._fields[1:]},
                          device="cpu")


def clock_ties(completion, D, arrival, rtol=RTOL):
    """Deadline ties of a replay on the trace's clock: within rtol of D,
    or within two f32 spacings of arrival + D (the replay adds each
    attempt's times to the arrival in f32)."""
    spacing = np.spacing(np.float32(np.asarray(arrival) + np.asarray(D)))
    return deadline_ties(completion, D, rtol) | (
        np.abs(np.asarray(completion) - np.asarray(D)) <= 2 * spacing)


@pytest.fixture(scope="module")
def paper40():
    ref = ref_generate(40, seed=0)
    return ref, port_jobs(ref)


@pytest.fixture(scope="module")
def flat_runs(paper40):
    """One reference run_all_fleet and one port run on its replayed
    draws: reps 2, block_jobs 8 (5 blocks)."""
    ref_jobs, jobs = paper40
    want, ref_r_min = ref_run_all_fleet(KEY, ref_jobs, REF_P, reps=2,
                                        block_jobs=8)
    got, r_min = run_all_fleet(JaxFleetReplay(KEY, Tb=tb_of(jobs, 8)), jobs,
                               P, reps=2, block_jobs=8, device="cpu")
    return want, ref_r_min, got, r_min


@pytest.fixture(scope="module")
def cluster_runs():
    """The capacity fleet on 60 jobs: 200 slots, reps 2, windows of 20
    jobs, queue and capacity metrics; reference and port."""
    ref_jobs = ref_generate(60, seed=1)
    jobs = port_jobs(ref_jobs)
    kw = dict(slots=200, reps=2, chunk_jobs=20, collect_metrics=True)
    out = {}
    for s in CLUSTER_STRATEGIES:
        want = ref_run_cluster_fleet(
            jax.random.fold_in(KEY, ref_index_of(s)), ref_jobs, s, REF_P,
            **kw)
        got = run_cluster_fleet_strategy(JaxFleetReplay(KEY), jobs, s, P,
                                         device="cpu", **kw)
        out[s] = (want, got)
    return ref_jobs, jobs, out


@pytest.fixture(scope="module")
def small_jobs():
    return generate(30, seed=4, device="cpu")


def assert_same_result(a, b, what=""):
    """Two runs' per-job columns and scalars, bit for bit."""
    for f in ("job_met", "job_completion", "job_cost", "pocd", "mean_cost"):
        x, y = getattr(a.result, f), getattr(b.result, f)
        assert x.dtype == y.dtype and torch.equal(x, y), (what, f)
    assert torch.equal(a.r_opt, b.r_opt), what


# ---------------------------------------------------------------------------
# 1. the block geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [7, 8])
@pytest.mark.parametrize("kw", [{}, dict(pad_blocks_to=3, tasks_pad=5000,
                                         block_offset=4, min_blocks=7)])
def test_blocks_equal_reference(B, kw):
    ref = ref_generate(23, seed=3)
    jobs = port_jobs(ref)
    geo = {k: v for k, v in kw.items() if k != "block_offset"}
    want_l = ref_blocks.block_layout(ref, B, **geo)
    got_l = blocks.block_layout(jobs, B, **geo)
    for f in want_l._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got_l, f)),
                                      np.asarray(getattr(want_l, f)),
                                      err_msg=f)
    want = ref_blocks.make_blocks(ref, B, **kw)
    got = blocks.make_blocks(jobs, B, device="cpu", **kw)
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    np.testing.assert_array_equal(blocks.gather_index(23, B),
                                  ref_blocks.gather_index(23, B))
    np.testing.assert_array_equal(
        blocks.block_task_counts(jobs.n_tasks, B),
        ref_blocks.block_task_counts(np.asarray(ref.n_tasks), B))
    col = np.arange(ref.total_tasks) * 3
    np.testing.assert_array_equal(
        blocks.stack_task_column(got_l, col, -1, np.int32,
                                 device="cpu").numpy(),
        np.asarray(ref_blocks.stack_task_column(want_l, col, -1,
                                                np.int32)))


@pytest.mark.parametrize("B", [7, 8])
def test_flat_view_counts_true_tasks(B):
    """The widest block has no padding, yet its dummy row's n_tasks is 1
    (the reference's); the view counts the rows' true tasks (the dummy
    row's: the gap to the next multiple of ALIGN), so the port's
    segment_sum lines up with the segments of every later block, and the
    view's real tasks are the padded blocks' in block order."""
    jobs = generate(23, seed=3, device="cpu")
    layout = blocks.block_layout(jobs, B, pad_blocks_to=2)
    blk = blocks.make_blocks(jobs, B, layout=layout, device="cpu")
    full = blk.task_valid.all(dim=1)
    assert full.any()
    assert (blk.n_tasks[full, B] == 1).all()
    align = blocks.ALIGN
    bv = blocks.block_view(jobs, layout, device="cpu")
    view = bv.jobs
    nt = view.n_tasks.view(blk.n_blocks, B + 1)
    assert (nt[:, B].numpy() == -(-bv.counts // align) * align
            - bv.counts).all()
    assert (nt[:, :B] == blk.n_tasks[:, :B]).all()
    assert int(view.n_tasks.sum()) == view.total_tasks
    assert (bv.starts % align == 0).all()
    assert int(bv.task_valid.sum()) == jobs.total_tasks
    for f in ("job_id", "task_t_min", "task_beta", "task_D"):
        want = getattr(blk, f)[blk.task_valid]
        got = getattr(view, f)[bv.task_valid]
        if f == "job_id":
            got = got % (B + 1)
        assert torch.equal(got.to(want.dtype), want), f
    x = torch.rand(view.total_tasks,
                   generator=torch.Generator().manual_seed(0))
    want = torch.zeros(view.n_jobs, dtype=torch.float64).index_add_(
        0, view.job_id, x.double()).float()
    torch.testing.assert_close(segment_sum(x, view), want, rtol=1e-5,
                               atol=0)
    one = blocks.block_jobset(blocks.FleetBlocks(*(x[0] for x in blk)))
    assert int(one.n_tasks.sum()) == one.total_tasks


def test_pad_count_and_mesh(monkeypatch):
    """pad_count as the reference's; on the CPU a mesh of N points is N
    logical host points, on the card it needs N visible cards."""
    for n, e in ((0, 1), (5, 1), (5, 2), (8, 4), (9, 4)):
        assert pad_count(n, e) == ref_mesh.pad_count(n, e)
    with pytest.raises(ValueError):
        pad_count(3, 0)
    mesh = fleet_mesh(device="cpu")
    assert (mesh.rep_extent, mesh.job_extent) == (1, 1)
    assert fleet_mesh(devices=1, device="cpu") == mesh
    assert fleet_mesh(shape=(1, 1), device="cpu") == mesh
    for kw, ext in ((dict(devices=2), (1, 2)), (dict(shape=(2, 1)), (2, 1)),
                    (dict(shape=(1, 4)), (1, 4))):
        m = fleet_mesh(device="cpu", **kw)
        assert (m.rep_extent, m.job_extent) == ext
        assert m.devices == (torch.device("cpu"),) * m.size
    with pytest.raises(ValueError):
        fleet_mesh(devices=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for kw in (dict(devices=2), dict(shape=(2, 1)), dict(shape=(1, 4))):
        with pytest.raises(ValueError, match="only 1 are visible"):
            fleet_mesh(**kw)


# ---------------------------------------------------------------------------
# 2. against the reference
# ---------------------------------------------------------------------------


def test_run_all_fleet_matches_reference(paper40, flat_runs):
    """All ten strategies at reps 2 on replayed cell draws: r* exact,
    job_met (a frequency) equal but deadline ties, job_cost within f32
    rtol 1e-5."""
    ref_jobs, jobs = paper40
    want, ref_r_min, got, r_min = flat_runs
    assert set(got) == set(want) == set(repro_torch.names())
    D = np.asarray(ref_jobs.D)
    assert abs(r_min - ref_r_min) <= 1.0 / jobs.n_jobs
    for name, w in want.items():
        g = got[name]
        np.testing.assert_array_equal(g.r_opt.numpy(), np.asarray(w.r_opt),
                                      err_msg=name)
        flips = g.result.job_met.numpy() != np.asarray(w.result.job_met)
        assert not (flips & ~deadline_ties(w.result.job_completion,
                                           D)).any(), name
        np.testing.assert_allclose(g.result.job_cost.numpy(),
                                   np.asarray(w.result.job_cost), rtol=RTOL,
                                   err_msg=name)
        np.testing.assert_allclose(g.result.job_completion.numpy(),
                                   np.asarray(w.result.job_completion),
                                   rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(g.theory_pocd.numpy(),
                                   np.asarray(w.theory_pocd), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        assert int(g.n_saturated) == int(w.n_saturated), name


@pytest.mark.parametrize("strategy", CLUSTER_STRATEGIES)
def test_run_cluster_fleet_matches_reference(cluster_runs, strategy):
    """sresume, clone and hadoop_s over three windows of 20 jobs: r*
    equal, job_met equal but deadline ties, PoCD within a tie a flip;
    mean cost and the combined queue metrics within rtol 1e-4; every
    capacity metric: the counters and histograms equal, occupancy and
    total wait within rtol 1e-4."""
    ref_jobs, jobs, out = cluster_runs
    w, g = out[strategy]
    np.testing.assert_array_equal(g.r_opt.numpy(), np.asarray(w.r_opt))
    flips = g.result.job_met.numpy() != np.asarray(w.result.job_met)
    ties = clock_ties(w.result.job_completion, ref_jobs.D, ref_jobs.arrival)
    assert not (flips & ~ties).any()
    assert abs(float(g.result.pocd) - float(w.result.pocd)) <= \
        flips.sum() / jobs.n_jobs + 1e-7
    for f in ("mean_cost",):
        np.testing.assert_allclose(float(getattr(g.result, f)),
                                   float(getattr(w.result, f)), rtol=1e-4)
    for f in ("mean_wait", "max_wait", "utilization", "preempted",
              "admitted_frac"):
        np.testing.assert_allclose(float(getattr(g.queue, f)),
                                   float(getattr(w.queue, f)), rtol=1e-4,
                                   err_msg=f)
    assert g.queue.slots == w.queue.slots == 200
    for f, gm, wm in zip(g.metrics._fields, g.metrics, w.metrics):
        if f in ("occupancy", "wait_total"):
            np.testing.assert_allclose(float(gm), float(wm), rtol=1e-4,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(gm.numpy(), np.asarray(wm),
                                          err_msg=f)


def _capacity_parts(seed, n):
    rng = np.random.default_rng(seed)
    return [obs_metrics.CapacityMetrics(
        depth_hist=rng.integers(0, 50, 16).astype(np.int32),
        depth_max=np.int32(rng.integers(0, 40)),
        occupancy=np.float32(rng.random() * 1e4),
        spec_launched=np.int32(rng.integers(0, 100)),
        spec_killed=np.int32(rng.integers(0, 100)),
        busy_windows=rng.integers(0, 9, 32).astype(np.int32),
        wait_total=np.float32(rng.random() * 1e3),
        n_dispatched=np.int32(rng.integers(0, 1000)),
        reps=np.int32(2)) for _ in range(n)]


def test_host_reductions_match_reference():
    """reduce_reps_host (padded replications dropped) and combine_windows
    on the same inputs, field for field, dtypes included."""
    parts = _capacity_parts(0, 5)
    stacked = obs_metrics.CapacityMetrics(
        *(np.stack([getattr(m, f) for m in parts])
          for f in obs_metrics.CapacityMetrics._fields))
    ref_stacked = ref_obs_metrics.CapacityMetrics(*stacked)
    for reps in (1, 3, 5):
        got = obs_metrics.reduce_reps_host(stacked, reps)
        want = ref_obs_metrics.reduce_reps_host(ref_stacked, reps)
        for f, g, w in zip(got._fields, got, want):
            assert np.asarray(g).dtype == np.asarray(w).dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
    torch_stacked = stacked._replace(
        occupancy=torch.from_numpy(stacked.occupancy))
    np.testing.assert_array_equal(
        obs_metrics.reduce_reps_host(torch_stacked, 3).occupancy,
        ref_obs_metrics.reduce_reps_host(ref_stacked, 3).occupancy)
    got = obs_metrics.combine_windows(parts)
    want = ref_obs_metrics.combine_windows(
        [ref_obs_metrics.CapacityMetrics(*m) for m in parts])
    for f, g, w in zip(got._fields, got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    with pytest.raises(ValueError):
        obs_metrics.combine_windows([])


def test_stream_combiner_matches_reference():
    """Three chunks of per-job columns and queue metrics: the combined
    SimResult and queue within f32 rounding of the reference's reductions
    (the per-job columns equal), the capacity combination equal."""
    rng = np.random.default_rng(1)
    sizes = (7, 12, 5)
    got, want = StreamCombiner(), RefStreamCombiner()
    parts = _capacity_parts(2, len(sizes))
    for n, cap in zip(sizes, parts):
        met = rng.random(n).astype(np.float32)
        comp = (rng.random(n) * 100).astype(np.float32)
        cost = (rng.random(n) * 1e3).astype(np.float32)
        q = [np.float32(x) for x in rng.random(5) * (10, 50, 1, 30, 1)]
        got.add(SimResult(np.float32(0), torch.from_numpy(met),
                          torch.from_numpy(comp), torch.from_numpy(cost),
                          np.float32(0)), n_jobs=n,
                queue=QueueMetrics(*(torch.tensor(x) for x in q), slots=9),
                capacity=cap)
        want.add(RefSimResult(jnp.float32(0), met, comp, cost,
                              jnp.float32(0)), n_jobs=n,
                 queue=RefQueueMetrics(*(jnp.float32(x) for x in q),
                                       slots=9),
                 capacity=ref_obs_metrics.CapacityMetrics(*cap))
    assert got.n_chunks == want.n_chunks == 3
    g, w = got.finalize(device="cpu"), want.finalize()
    for f in ("job_met", "job_completion", "job_cost"):
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(w, f)))
    for f in ("pocd", "mean_cost"):
        np.testing.assert_allclose(float(getattr(g, f)),
                                   float(getattr(w, f)), rtol=1e-6)
    gq, wq = got.finalize_queue(device="cpu"), want.finalize_queue()
    for f in QueueMetrics._fields[:-1]:
        assert float(getattr(gq, f)) == float(getattr(wq, f)), f
    assert gq.slots == wq.slots == 9
    gc, wc = got.finalize_capacity(device="cpu"), want.finalize_capacity()
    for f, a, b in zip(gc._fields, gc, wc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    with pytest.raises(ValueError):
        StreamCombiner().finalize(device="cpu")
    assert StreamCombiner().finalize_queue(device="cpu") is None


# ---------------------------------------------------------------------------
# 3. port-only identities, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mono(small_jobs):
    return run_all_fleet(Philox(0), small_jobs, P, reps=2, block_jobs=4,
                         device="cpu")


@pytest.mark.parametrize("kw", [dict(chunk_jobs=8), dict(chunk_jobs=13),
                                dict(fused=False),
                                dict(chunk_jobs=12, fused=False),
                                dict(pad_to=(3, 2)),
                                dict(chunk_jobs=8, pad_to=(1, 3))],
                         ids=["chunk8", "chunk13", "staged", "chunk-staged",
                              "pad3x2", "chunk-pad1x3"])
def test_fleet_identities(small_jobs, mono, kw):
    """Chunks of 8 and 13 jobs (13 rounds down to 12, a block multiple),
    the staged path, and padded replications and blocks give the
    monolithic run's bits for every strategy."""
    want, r_want = mono
    got, r_got = run_all_fleet(Philox(0), small_jobs, P, reps=2,
                               block_jobs=4, device="cpu", **kw)
    assert r_got == r_want
    for name in want:
        assert_same_result(got[name], want[name], name)


def test_chunked_equals_monolithic_at_a_scenario_scale():
    """300 paper-hadoop jobs (about 300 tasks a job) in blocks of 16 and
    chunks of 64: adaptive's completions are the monolithic run's bits.
    The CPU's elementwise pow rounds the elements past a tensor's last
    multiple of 32 (its scalar loop) otherwise than the rest, so this
    holds only because every block of the view takes a multiple of
    blocks.ALIGN tasks."""
    from repro_torch.workloads.registry import make_trace
    trace = make_trace("paper-hadoop", n_jobs=300, device="cpu")
    kw = dict(r_min=0.09, block_jobs=16, device="cpu")
    want = fleet_runner.run_fleet_strategy(Philox(0), trace, "adaptive", P,
                                           **kw)
    got = fleet_runner.run_fleet_strategy(Philox(0), trace, "adaptive", P,
                                          chunk_jobs=64, **kw)
    assert_same_result(got, want)


def test_run_all_routes_to_the_fleet(small_jobs, mono, tmp_path,
                                     monkeypatch):
    """run_all(devices=1), run_all(devices=2) on two host points and
    run_all(chunk_jobs=) are run_all_fleet; a run without them is the
    flat path; devices=2 with one visible card and a chaos= that is no
    FaultPlan raise; run_cluster(checkpoint=) routes to the windowed
    fleet and equals the plain windowed run."""
    want, r_want = mono
    for kw in (dict(devices=1), dict(devices=2), dict(chunk_jobs=16),
               dict(mesh=fleet_mesh(device="cpu"))):
        got, r_got = run_all(Philox(0), small_jobs, P, reps=2,
                             block_jobs=4, device="cpu", **kw)
        assert r_got == r_want
        for name in want:
            assert_same_result(got[name], want[name], name)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="only 1 are visible"):
            run_all(Philox(0), small_jobs, P, devices=2)
        with pytest.raises(ValueError, match="only 1 are visible"):
            run_cluster(Philox(0), small_jobs, P, slots=50, devices=2)
    with pytest.raises(TypeError):
        run_all(Philox(0), small_jobs, P, chaos=object(), device="cpu")
    kw = dict(slots=50, chunk_jobs=10, strategies=("hadoop_ns", "sresume"),
              device="cpu")
    plain, r_plain = run_cluster(Philox(0), small_jobs, P, **kw)
    saved, r_saved = run_cluster(Philox(0), small_jobs, P,
                                 checkpoint=tmp_path, **kw)
    assert r_saved == r_plain
    for name in plain:
        assert_same_result(saved[name], plain[name], name)
        assert latest_step(tmp_path / name) == 3


def test_flat_fleet_budget_is_one_global_solve(small_jobs):
    """budget= solves once over every job, so chunked equals monolithic
    and r* equals a monolithic run_all_fleet's."""
    # between the least spend with finite U (312,285 at this run's R_min,
    # 0.0657) and the unbudgeted spend (342,922)
    B = 3.25e5
    kw = dict(reps=1, block_jobs=4, strategies=("hadoop_ns", "clone"),
              budget=B, device="cpu")
    a, _ = run_all_fleet(Philox(0), small_jobs, P, **kw)
    b, _ = run_all_fleet(Philox(0), small_jobs, P, chunk_jobs=8, **kw)
    for name in a:
        assert_same_result(a[name], b[name], name)
    assert a["clone"].coupled is not None
    assert float(a["clone"].theory_cost.sum()) <= B


@pytest.fixture(scope="module")
def cluster_small():
    return generate(24, seed=6, mean_tasks=60, device="cpu")


def _cluster(jobs, strategy, **kw):
    kw = dict(dict(slots=40, reps=2, chunk_jobs=7, collect_metrics=True,
                   device="cpu"), **kw)
    return run_cluster_fleet_strategy(Philox(0), jobs, strategy, P, **kw)


def _same_cluster(a, b, what, table_sums_rtol=0.0):
    """Bit-equal runs; with `table_sums_rtol`, the whole-table float sums
    (busy time, total wait: mean_wait, utilization, occupancy,
    wait_total) only within that tolerance, for replays of tables of
    another width, whose extra inactive columns change those sums' order.
    """
    assert_same_result(a, b, what)
    sums = ("mean_wait", "utilization", "occupancy", "wait_total")
    for tree in ("queue", "metrics"):
        x, y = getattr(a, tree), getattr(b, tree)
        for f in x._fields:
            if f == "slots":
                assert x.slots == y.slots
            elif table_sums_rtol and f in sums:
                torch.testing.assert_close(getattr(x, f), getattr(y, f),
                                           rtol=table_sums_rtol, atol=0)
            else:
                assert torch.equal(getattr(x, f), getattr(y, f)), (what, f)


@pytest.mark.parametrize("strategy", ["sresume", "hadoop_s", "adaptive"])
def test_windowed_replay_equals_window_by_window(cluster_small, strategy,
                                                 monkeypatch):
    """Four windows (7, 7, 7, 3 jobs) x 2 replications: one batched launch
    a pass, several launches of at most 4 segments (a window's pair may
    span two), and one window a launch give the same bits; so does
    pad_to=3. fused=False narrows the tables to the largest solved r* + 2
    columns, not max_r + 2: every per-job column is bit-equal, and the
    whole-table sums within f32 rtol 1e-6 (as in the reference, whose
    fused and staged mean_wait differ in the last place)."""
    want = _cluster(cluster_small, strategy)
    for cap in (4, 3, 2):
        monkeypatch.setattr(engine, "MAX_SEGMENTS", cap)
        _same_cluster(_cluster(cluster_small, strategy), want, (cap,))
    monkeypatch.setattr(engine, "MAX_SEGMENTS", 132)
    _same_cluster(_cluster(cluster_small, strategy, pad_to=3), want, "pad")
    _same_cluster(_cluster(cluster_small, strategy, fused=False), want,
                  "staged", table_sums_rtol=1e-6)


def test_windowed_replay_segments_equal_single_window(cluster_small):
    """engine._replay on segments of two windows with different T and
    widths equals each window replayed on its own, bit for bit."""
    spec = repro_torch.get("sresume")
    segs = []
    for lo, hi, width in ((0, 7, 4), (7, 19, 10)):
        jobs = fleet_runner.chunk_jobset(
            fleet_runner.job_columns(cluster_small), lo, hi, device="cpu")
        r = torch.full((jobs.total_tasks,), 2, dtype=torch.int32)
        draw = lambda name, shape, lo=lo: Philox(lo).uniform_cell(
            "sresume", 0, None, name, shape, "cpu")
        table = spec.build_table(draw, jobs, r, torch.zeros_like(r), P,
                                 max_r=8, oracle=True)
        segs.append((engine._narrow_table(table, jobs.total_tasks, width),
                     jobs))
    for discipline in ("fifo", "edf"):
        both = engine._replay(segs, spec.race, 30, discipline, 3)
        for seg, got in zip(segs, both):
            want = engine._replay([seg], spec.race, 30, discipline, 3)[0]
            for a, b in zip(got[0], want[0]):
                assert torch.equal(a, b), discipline
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[2], want[2])


def test_replications_grouped_by_the_segment_cap(cluster_small,
                                                  monkeypatch):
    """run_cluster's replications beyond MAX_SEGMENTS go to further
    launches with the same bits; _replay refuses more segments than the
    cap."""
    kw = dict(slots=40, reps=3, collect_metrics=True, device="cpu")
    want = engine.run_cluster_strategy(Philox(0), cluster_small, "sresume",
                                       P, **kw)
    monkeypatch.setattr(engine, "MAX_SEGMENTS", 2)
    got = engine.run_cluster_strategy(Philox(0), cluster_small, "sresume",
                                      P, **kw)
    _same_cluster(got, want, "grouped")
    with pytest.raises(ValueError, match="MAX_SEGMENTS"):
        engine._replay([None] * 3, False, 40, "fifo", 2)


def test_cluster_fleet_routing_and_budget(cluster_small):
    """run_cluster(chunk_jobs=) routes to the fleet; budget= is one global
    solve (chunked equal to one window); governor and admission run per
    window."""
    from repro_torch.cluster import AdmissionConfig, GovernorConfig
    outs, r_min = run_cluster(Philox(0), cluster_small, P, slots=40,
                              chunk_jobs=7, reps=2,
                              strategies=("hadoop_ns", "sresume"),
                              device="cpu")
    want = _cluster(cluster_small, "sresume", collect_metrics=False,
                    r_min=r_min)
    assert_same_result(outs["sresume"], want, "routed")
    B = 5.2e4   # between the least spend (45,845) and the unbudgeted
    kw = dict(budget=B, collect_metrics=False)
    a = _cluster(cluster_small, "clone", chunk_jobs=None, **kw)
    b = _cluster(cluster_small, "clone", **kw)
    np.testing.assert_array_equal(a.r_opt.numpy(), b.r_opt.numpy())
    assert b.coupled is not None
    assert float(b.theory_cost.sum()) <= B
    g = _cluster(cluster_small, "sresume", slots=10,
                 governor=GovernorConfig(util_threshold=0.1, window=600.0),
                 admission=AdmissionConfig(slack=0.5, window=600.0))
    assert 0.0 < float(g.queue.admitted_frac) <= 1.0
    assert 0.0 <= float(g.queue.utilization) <= 1.0 + 1e-6
    assert int(g.metrics.depth_hist.sum()) == int(g.metrics.n_dispatched)


def test_scenario_name_streams_column_wise():
    """A scenario name goes through make_trace and is chunked by its
    per-job columns."""
    outs, _ = run_all_fleet(Philox(0), "heavy-tail", P, chunk_jobs=256,
                            strategies=("hadoop_ns", "sresume"),
                            device="cpu")
    assert outs["sresume"].result.job_met.shape == (600,)
    for o in outs.values():
        assert 0.0 <= float(o.result.pocd) <= 1.0


def test_fleet_draws_are_keyed_by_cell():
    """Philox cells are pure functions of (seed, strategy, rep, block,
    name), and no fleet stream is a flat one. The batched method draws a
    block's rows as its cell does, whichever rows, and in whatever order
    and company, it is asked for: a chunked run draws every task row
    what the monolithic run draws there."""
    src = Philox(3)
    a = src.uniform_cell("clone", 1, 5, "key", (64, 9), "cpu")
    assert torch.equal(a, Philox(3).uniform_cell("clone", 1, 5, "key",
                                                 (64, 9), "cpu"))
    for other in (("clone", 1, 6), ("clone", 0, 5), ("sresume", 1, 5),
                  ("clone", 1, None)):
        assert not torch.equal(a, src.uniform_cell(*other, "key", (64, 9),
                                                    "cpu"))
    assert not torch.equal(a[:, 0], src.uniform("clone", 1, "key", (64,),
                                                "cpu"))
    assert float(a.min()) >= 1e-7 and float(a.max()) < 1.0
    b = src.uniform_cell("clone", 1, 6, "key", (40, 9), "cpu")
    cells = torch.tensor([6, 5, 5, 6, 5, 6])
    rows = torch.tensor([39, 0, 63, 2, 17, 0])
    mixed = src.uniform_rows("clone", 1, "key", cells, rows, (9,), "cpu")
    want = torch.stack([(a if c == 5 else b)[r] for c, r in
                        zip(cells.tolist(), rows.tolist())])
    assert torch.equal(mixed, want)
    assert torch.equal(a[:, :4], src.uniform_cell("clone", 1, 5, "key",
                                                  (64, 4), "cpu"))

    class Recording:
        """Philox, recording each drawn row by (name, cell, row)."""

        def __init__(self):
            self.rows = {}

        def uniform_rows(self, strategy, rep, name, cells, rows, rest,
                         device, tag=FLEET_TAG):
            u = src.uniform_rows(strategy, rep, name, cells, rows, rest,
                                 device, tag=tag)
            for c, r, x in zip(cells.tolist(), rows.tolist(),
                               u.reshape(len(u), -1)):
                self.rows[(rep, name, c, r)] = x
            return u

    jobs = generate(30, seed=4, device="cpu")
    mono, chunked = Recording(), Recording()
    kw = dict(reps=2, block_jobs=4, device="cpu")
    fleet_runner.run_fleet_strategy(mono, jobs, "sresume", P, **kw)
    fleet_runner.run_fleet_strategy(chunked, jobs, "sresume", P,
                                    chunk_jobs=8, **kw)
    # the real task rows: row < the block's task count (4 jobs a block)
    real = {k for k in mono.rows if k[3] < int(jobs.n_tasks[
        4 * k[2]:4 * k[2] + 4].sum())}
    assert real and real <= set(chunked.rows)
    for k in real:
        assert torch.equal(mono.rows[k], chunked.rows[k]), k


# ---------------------------------------------------------------------------
# 4. on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_chunked_equals_monolithic_on_card():
    """The chunk invariance of the per-job sums on CUDA: chunked runs give
    the monolithic run's bits for every strategy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    jobs = generate(300, seed=2, device="cuda")
    want, _ = run_all_fleet(Philox(0), jobs, P, block_jobs=16)
    for chunk in (48, 112):
        got, _ = run_all_fleet(Philox(0), jobs, P, block_jobs=16,
                               chunk_jobs=chunk)
        for name in want:
            assert_same_result(got[name], want[name], (chunk, name))


@pytest.mark.cuda
def test_cuda_windowed_launch_equals_per_window_on_card(monkeypatch):
    """One dispatch launch over every (window, replication) equals one
    launch a window, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    jobs = generate(120, seed=2, device="cuda")
    kw = dict(slots=300, reps=4, chunk_jobs=30, collect_metrics=True)
    want = run_cluster_fleet_strategy(Philox(0), jobs, "sresume", P, **kw)
    monkeypatch.setattr(engine, "MAX_SEGMENTS", 4)
    got = run_cluster_fleet_strategy(Philox(0), jobs, "sresume", P, **kw)
    _same_cluster(got, want, "per window")
