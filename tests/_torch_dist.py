"""Run a piece of code on several CPU ranks of one ``gloo`` process
group, each rank its own process (for the port's distributed tests).

The code gets ``RANK`` and ``WORLD_SIZE`` in its environment and starts
the group itself with :data:`INIT`; every process is waited for, and a
rank that fails fails the call."""
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The lines that start the group (prepend to the code a rank runs).
INIT = """
import os
import torch.distributed as dist
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group(
    "gloo", init_method=f"tcp://127.0.0.1:{os.environ['DIST_PORT']}",
    rank=RANK, world_size=WORLD)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(code: str, world: int, timeout: float = 300,
              env: dict | None = None) -> list[str]:
    """Each rank's standard output; raises if any rank fails or the
    group outlives ``timeout`` seconds."""
    port = _free_port()
    procs = []
    for rank in range(world):
        penv = {**os.environ, **(env or {}), "RANK": str(rank),
                "WORLD_SIZE": str(world), "DIST_PORT": str(port),
                "PYTHONPATH": os.path.join(ROOT, "src"),
                "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", INIT + code], env=penv, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} exited {p.returncode}:\n"
                                 f"{out[-2000:]}\n{err[-4000:]}")
    return [out for out, _ in outs]
