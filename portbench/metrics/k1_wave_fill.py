"""``k1_wave_fill`` (%): K1's blocks over the blocks its launches' waves
hold (waves x SMs x blocks an SM holds of the built kernel), from the
port's counters ``k1.blocks`` and ``k1.block_slots`` (each launch adds
its own).  None where the port has no such counters or made no K1
launch."""


def read(run):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    slots = obs.counter("k1.block_slots")
    if slots <= 0:
        return None
    return 100.0 * obs.counter("k1.blocks") / slots
