"""Host ms a window step waits in `next(pipeline)` inside `Trainer.run`
(the harness's `Feed` times each fetch): the mean over the window's
steps. Layer: trainer and input pipeline."""
import statistics


def read(run):
    waits = run["window"]["waits_s"]
    return 1e3 * statistics.fmean(waits) if waits else None
