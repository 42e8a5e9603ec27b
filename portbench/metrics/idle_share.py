"""``idle_share`` (%): the share of the traced sub-window in which no
operation ran on the device (one minus the union of device activity
over the sub-window's length on the host's clock)."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100.0
