"""Baseline specs: Hadoop-NS, default Hadoop speculation, Mantri; they run
at r = 0 with empirical outcomes only. Counterpart of
`repro.strategies.baselines` (the AttemptTable lowerings come with the
capacity replay)."""
from __future__ import annotations

from ..sim.strategies import sim_hadoop_ns, sim_hadoop_s, sim_mantri
from .spec import StrategySpec, register

HADOOP_NS = register(StrategySpec(
    name="hadoop_ns", kind="baseline", detectable=False,
    draw=lambda draw_u, jobs, r_task, choice_task, p, *, max_r, oracle:
        sim_hadoop_ns(draw_u, jobs, p)))

HADOOP_S = register(StrategySpec(
    name="hadoop_s", kind="baseline", detectable=False,
    draw=lambda draw_u, jobs, r_task, choice_task, p, *, max_r, oracle:
        sim_hadoop_s(draw_u, jobs, p)))

MANTRI = register(StrategySpec(
    name="mantri", kind="baseline", detectable=False,
    draw=lambda draw_u, jobs, r_task, choice_task, p, *, max_r, oracle:
        sim_mantri(draw_u, jobs, p)))
