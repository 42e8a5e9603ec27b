"""``batch_mean``: mean of PlanServe's ``batch_size`` over the window's
completed requests (so a request in a batch of 21 counts 21); None
outside a closed loop."""
import statistics


def read(run):
    stats = run.window.stats
    if not stats:
        return None
    return statistics.fmean(s["batch_size"] for s in stats)
