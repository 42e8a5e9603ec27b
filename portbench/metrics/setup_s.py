"""``setup_s``: from the start of the process to the first timed call:
imports, the CUDA context, the seeded inputs, planning (from the plan
cache after a cell's first run), the kernels' libraries and the
warm-up."""


def read(run):
    return run.setup_s
