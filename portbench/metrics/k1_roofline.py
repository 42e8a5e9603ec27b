"""``k1_roofline`` (%): the least time the card needs for the examples
completed in the traced sub-window (each input read once, each output
written once at the request's own shape, or its operations at the
float32 rate, whichever is longer), over K1's profiled device time in
it.  None without K1 in the trace or on a card the yardstick does not
know."""


def read(run):
    t = run.trace
    if t is None or t.k1_s <= 0 or t.examples <= 0 or run.least_s is None:
        return None
    return t.examples * run.least_s / t.k1_s * 100.0
