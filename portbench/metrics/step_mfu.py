"""``step_mfu`` (%): the whole step's share of the card's peak: the least
time the card needs for every example completed in the traced sub-window
(bytes at the HBM rate or operations at the float32 rate, whichever is
longer) over the sub-window's length.  It bounds every kernel's share,
so it still reads once a later change takes K1 off the path."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.examples <= 0 or run.least_s is None:
        return None
    return t.examples * run.least_s / t.window_s * 100.0
