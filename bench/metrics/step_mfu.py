"""% of the card's bf16 peak that the window's model FLOPs
(`counting/model_flops.py`) make over the window's time. Layer: the
whole step."""
from bench.counting import model_flops, peaks


def read(run):
    w = run["window"]
    if not w["steps"] or w["window_s"] <= 0 or run["trace"] is None:
        return None
    tf = run["traffic"]
    flops = w["steps"] * model_flops.step_flops(run["shape"],
                                                tf["global_batch"],
                                                tf["seq_len"])
    return 100.0 * flops / (w["window_s"] * peaks.BF16_FLOPS)
