"""``p95_ms``: the 95th percentile (nearest rank) of every request's
latency in the window, from the client's submit to its result, on the
harness's clock; failed requests count.  None for a loop without
requests."""
import math


def read(run):
    lat = run.window.latencies_ms
    if not lat:
        return None
    return sorted(lat)[math.ceil(0.95 * len(lat)) - 1]
