"""``k1_prime_share`` (%): the share of K1's row steps that prime a block
(walked before its first owned row, and recomputed by the block that owns
them), ``100 x (1 - owned / walked)``, from the port's counters
``k1.rows_owned`` and ``k1.rows_walked`` (each launch adds its blocks'
row steps, times the batch of a batched launch).  None where the port has
no such counters or made no K1 launch."""


def read(run):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    walked = obs.counter("k1.rows_walked")
    if walked <= 0:
        return None
    return 100.0 * (1.0 - obs.counter("k1.rows_owned") / walked)
