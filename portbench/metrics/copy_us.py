"""``copy_us``: profiled device time outside K1's kernel (fills, copies,
stacks: the host half's re-seat of outputs, PlanServe's pad, stack and
unpad) per example completed in the traced sub-window."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.examples <= 0:
        return None
    return t.other_s / t.examples * 1e6
