"""``points_per_s`` (Gpoints/s): output grid points (each goal's region,
unpadded) of every call or request completed in the window, over the
whole window, the drain to its last result included."""


def read(run):
    w = run.window
    return w.examples * run.points / w.window_s / 1e9
