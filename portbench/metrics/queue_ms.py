"""``queue_ms``: median of PlanServe's ``queue_wait_ms`` (submit to the
start of the request's micro-batch) over the window's completed
requests; None outside a closed loop."""
import statistics


def read(run):
    stats = run.window.stats
    if not stats:
        return None
    return statistics.median(s["queue_wait_ms"] for s in stats)
