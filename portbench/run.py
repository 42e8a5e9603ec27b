"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m portbench.run`` works alike).
The last line of standard output is the result as one JSON object; the
numbers compared with the reference close standard error, each beside
its limit.
"""
import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # the checkout's root (this package) and src/ (the port) first
    if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == \
            _ROOT / "portbench":
        sys.path.pop(0)
    for p in (str(_ROOT / "src"), str(_ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench.harness import main
    sys.exit(main(t_start=T_START))
