"""`correct` comes out false when the timed path is broken underneath
the harness, and the control (the reference with float8 products in the
program's place) reads further from the reference than the program.

The CPU tests drive the rest of a run at a tiny size with the chip's
check skipped; the `cuda` test runs the control at a cell's own widths
and sequence on the card (cut to two layers, so that it fits a test
run) and holds it against the cell's limits."""
import pytest
import torch

from bench.calibrate import calibrate
from bench.lib import compare, spec
from bench.lib import weights as W
from bench.lib.cell import FAULTS, run_cell
from bench.lib.model_shape import shape_of
from conftest import tiny, tiny_traffic

CELLS = ["mistral-nemo-12b.train-8k"]
GAPS = ("loss_gap", "grad_gap", "update_gap", "update_diff")


def _run(bench, name, fault):
    cell = spec.workload(bench, name)
    return run_cell(bench, cell, 1234, 0.2, False, device="cpu",
                    cfg=tiny(cell["config"]), traffic=tiny_traffic(name),
                    fault=fault)[0]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_reads_below_every_fault(bench, name):
    """At the tiny size a sound run's readings sit far below each
    fault's (the cell's limits are set at its own size, on the card)."""
    sound = _run(bench, name, None)["checks"]
    assert sound["token_mismatch"]["value"] == 0
    assert sound["window_nonfinite"]["value"] == 0
    for fault in FAULTS:
        bad = _run(bench, name, fault)["checks"]
        assert any(bad[n]["value"] > 10 * sound[n]["value"]
                   for n in GAPS) or \
            bad["token_mismatch"]["value"] > 0, (fault, sound, bad)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(bench, name, fault):
    res = _run(bench, name, fault)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_further_than_the_program(bench, name):
    cell = spec.workload(bench, name)
    res = calibrate(bench, cell, [5, 6], [5, 6], (), device="cpu",
                    cfg=tiny(cell["config"]), traffic=tiny_traffic(name),
                    log=lambda *a: None)
    lower, upper = res["lower"], res["upper"]["control"]
    assert any(upper[n] > lower[n] for n in lower), (lower, upper)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cells_limits_on_the_card(bench, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.workload(bench, name)
    cfg = dict(spec.load_config(bench, cell["config"]), num_hidden_layers=2)
    traffic = spec.load_traffic(name)
    res = calibrate(bench, cell, [21], [21], (), device="cuda", cfg=cfg,
                    traffic=traffic, log=lambda *a: None)
    limits = traffic["limits"]
    ctl = res["control"][21]
    assert any(ctl[n] > limits[n] for n in GAPS), ctl
    snd = res["sound"][21]
    assert all(snd[n] <= limits[n] for n in GAPS), snd


@pytest.mark.parametrize("name", CELLS)
def test_reversed_update_reads_two_in_update_diff(bench, name):
    """Every update reversed at its right size: the norms of the leaves'
    changes cannot see it, their projections can."""
    sound = _run(bench, name, None)["checks"]
    bad = _run(bench, name, "flip")["checks"]
    assert sound["update_diff"]["value"] < 0.5, sound
    assert bad["update_diff"]["value"] > 1.5, bad


def test_change_projections_see_direction():
    """`update_diff`'s projections: the same change reads 0, none reads
    1 and a reversed one 2, where the norms read the same."""
    s = shape_of(tiny("mistral-nemo-12b"))
    init = W.make(s, 3, "cpu")
    step = W.make(s, 4, "cpu")
    moved = {n: init[n] + 1e-3 * step[n] for n in init}
    back = {n: init[n] - 1e-3 * step[n] for n in init}
    n_fwd, p_fwd = W.change_readings(moved, s, 3)
    n_back, p_back = W.change_readings(back, s, 3)
    _, p_none = W.change_readings(init, s, 3)
    keep = {n for n in init if n_fwd[n] > 0}
    assert n_fwd == pytest.approx(n_back)
    same = compare.diff_gaps(p_fwd, p_fwd, keep)
    none = compare.diff_gaps(p_none, p_fwd, keep)
    rev = compare.diff_gaps(p_back, p_fwd, keep)
    assert max(same.values()) == 0
    assert max(none.values()) == pytest.approx(1.0)
    assert max(rev.values()) == pytest.approx(2.0)
