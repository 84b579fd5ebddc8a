"""Device ms a step of the kernels launched inside the harness's
profiler range around `optimizer.update` (their union, from the
trace). Layer: train step and optimizer."""
from bench.lib.train import OPTIMIZER_RANGE


def read(run):
    tr = run["trace"]
    r = tr and tr["ranges"].get(OPTIMIZER_RANGE)
    if not r or not r["kernels"]:
        return None
    return r["busy_us"] / 1e3 / run["window"]["steps"]
