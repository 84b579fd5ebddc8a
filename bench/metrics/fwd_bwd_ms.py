"""Device-busy ms a step outside the optimizer's range: the model's loss
forward, its recomputation and its backward, and the few kernels of the
governor. Layer: model loss."""
from bench.lib.train import OPTIMIZER_RANGE


def read(run):
    tr = run["trace"]
    if not tr or tr["busy_us"] <= 0:
        return None
    opt = tr["ranges"].get(OPTIMIZER_RANGE, {}).get("busy_us", 0.0)
    return (tr["busy_us"] - opt) / 1e3 / run["window"]["steps"]
