"""``k1_local_bytes`` (bytes a thread): the mean local memory (register
spills and stack) a thread of the K1 sources the run loaded takes, from
the port's counters ``k1.local_bytes`` over ``k1.attrs`` (each source
loaded adds its bytes and 1).  None where the port has no such counters
or loaded no K1 source."""


def read(run):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    n = obs.counter("k1.attrs")
    if n <= 0:
        return None
    return obs.counter("k1.local_bytes") / n
