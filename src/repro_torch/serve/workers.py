"""Multi-process PlanServe workers sharing one on-disk plan cache.

The port's counterpart of ``repro.serve.workers``.  Each worker is a
spawned child process running its own
:class:`~repro_torch.serve.plans.PlanServe` on the card (its own CUDA
context, its own batcher thread) and answering requests over a pipe.
All workers point at the *same* ``cache_dir``: the first worker to plan
a program persists the :class:`~repro_torch.core.plan.KernelPlan`
through :mod:`repro_torch.core.plancache` (fcntl write locking keeps
concurrent fills/evictions sane), and every later worker — or a later
cold start of the whole pool — compiles warm, skipping the analysis
pipeline.  Each child loads the CUDA kernel from the shared build
directory (``build/repro_torch/``), building it there if no process
has; concurrent builds write under per-process names
(:mod:`repro_torch.kernels.build`).

Programs cross the process boundary *by name* (resolved against
:data:`repro_torch.core.programs.ALL_PROGRAMS` inside the child),
because kernel rule callables are not reliably picklable; requests and
answers cross it as numpy arrays.  The spawn context is used
unconditionally: a forked child cannot use the parent's CUDA context.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pathlib
from typing import Optional


def _ensure_child_pythonpath() -> None:
    """Make sure spawned children can ``import repro_torch``: prepend this
    source tree's root to ``PYTHONPATH`` if it is not already on it
    (spawn re-imports modules from scratch and only inherits the
    environment, not the parent's ``sys.path`` mutations)."""
    src = str(pathlib.Path(__file__).resolve().parents[2])
    parts = os.environ.get("PYTHONPATH", "").split(os.pathsep)
    if src not in parts:
        os.environ["PYTHONPATH"] = os.pathsep.join(
            [src] + [p for p in parts if p])


def _worker_main(conn, program_names, backend, device, cache_dir, quantum,
                 max_batch, max_wait_ms) -> None:
    """Child entry point: build a PlanServe over the named programs and
    answer ``("serve", name, arrays)`` / ``("metrics",)`` / ``("stop",)``
    messages until stopped.  Every reply is a ``(tag, payload)`` pair;
    answers are numpy arrays; request failures reply ``("error",
    message)`` instead of killing the worker."""
    import traceback

    from repro_torch.core.programs import ALL_PROGRAMS
    from repro_torch.serve.plans import PlanServe
    try:
        progs = {n: ALL_PROGRAMS[n]() for n in program_names}
        with PlanServe(progs, backend=backend, device=device,
                       plan_cache_dir=cache_dir, quantum=quantum,
                       max_batch=max_batch,
                       max_wait_ms=max_wait_ms) as srv:
            conn.send(("ready", os.getpid()))
            while True:
                msg = conn.recv()
                if msg[0] == "stop":
                    conn.send(("stopped", srv.metrics.snapshot()))
                    return
                if msg[0] == "metrics":
                    conn.send(("metrics", srv.metrics.snapshot()))
                elif msg[0] == "serve":
                    _, name, arrays = msg
                    try:
                        out = srv.serve(name, arrays, timeout=300)
                        conn.send(("ok", {k: v.cpu().numpy()
                                          for k, v in out.items()}))
                    except Exception as err:
                        conn.send(("error",
                                   f"{type(err).__name__}: {err}"))
                else:
                    conn.send(("error", f"unknown command {msg[0]!r}"))
    except Exception:
        conn.send(("fatal", traceback.format_exc()))


class ServeWorker:
    """One spawned serving process.  ``serve``/``metrics`` are
    synchronous request/reply over the pipe; ``close`` stops the child
    and returns its final metrics snapshot.  ``backend`` and ``device``
    are the child PlanServe's (by default the CUDA kernel on the current
    card; ``device="cpu"`` runs it on the CPU)."""

    def __init__(self, program_names, *, backend: Optional[str] = None,
                 device=None, cache_dir=None, quantum: int = 32,
                 max_batch: int = 16, max_wait_ms: float = 2.0):
        _ensure_child_pythonpath()
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_worker_main,
            args=(child, list(program_names), backend,
                  str(device) if device is not None else None,
                  str(cache_dir) if cache_dir is not None else None,
                  quantum, max_batch, max_wait_ms),
            daemon=True)
        self._proc.start()
        child.close()
        tag, payload = self._conn.recv()
        if tag != "ready":
            raise RuntimeError(f"worker failed to start: {payload}")
        self.pid = payload

    def _rpc(self, *msg):
        self._conn.send(msg)
        tag, payload = self._conn.recv()
        if tag in ("error", "fatal"):
            raise RuntimeError(payload)
        return payload

    def serve(self, name: str, arrays: dict) -> dict:
        """Run one request (numpy arrays) in the worker, returning
        ``{store: numpy array}``."""
        return self._rpc("serve", name, arrays)

    def metrics(self) -> dict:
        """The worker's live :class:`~repro_torch.serve.plans.ServeMetrics`
        snapshot."""
        return self._rpc("metrics")

    def close(self) -> Optional[dict]:
        """Stop the worker (idempotent) and return its final metrics
        snapshot (``None`` if it already died)."""
        if self._proc is None:
            return None
        snap = None
        try:
            snap = self._rpc("stop")
        except (RuntimeError, EOFError, OSError):
            pass
        self._proc.join(timeout=30)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=10)
        self._conn.close()
        self._proc = None
        return snap

    def __enter__(self) -> "ServeWorker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class WorkerPool:
    """``n`` ServeWorkers over one shared cache dir, with round-robin
    request dispatch.  ``close`` returns every worker's final metrics
    snapshot (compile/disk-hit counts per worker)."""

    def __init__(self, n: int, program_names, **kwargs):
        if n < 1:
            raise ValueError(f"need at least one worker, got {n}")
        self.workers = [ServeWorker(program_names, **kwargs)
                        for _ in range(n)]
        self._next = 0

    def serve(self, name: str, arrays: dict) -> dict:
        """Dispatch one request to the next worker (round-robin)."""
        w = self.workers[self._next % len(self.workers)]
        self._next += 1
        return w.serve(name, arrays)

    def metrics(self) -> list:
        """Live metrics snapshots, one per worker."""
        return [w.metrics() for w in self.workers]

    def close(self) -> list:
        """Stop every worker; returns their final metrics snapshots."""
        return [w.close() for w in self.workers]

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
