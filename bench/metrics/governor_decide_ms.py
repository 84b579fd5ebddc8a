"""Median host ms of a warm `StepGovernor.decide` (one that solved: one
grid-solve launch per Chronos strategy) made during the window. Layer:
the Chronos governor."""
import statistics


def read(run):
    ms = run["window"]["decide_ms"]
    return statistics.median(ms) if ms else None
