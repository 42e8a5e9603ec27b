"""PlanServe: batched, shape-bucketed serving of compiled KernelPlans.

The port's counterpart of ``repro.serve.plans``.  The paper's pipeline
decides fusion/vectorization ahead of time, and the
:class:`~repro_torch.core.plan.KernelPlan` IR with the on-disk plan
cache makes the decision a durable, interpreter-agnostic artifact.
This module is the serving half of that story: a long-lived engine that
executes *many* requests against *few* compiled artifacts, on the card
through the CUDA stencil kernel by default.

Three layers:

* **Shape buckets** — request sizes are quantized up to a bucket
  (:func:`quantize`; per-dim quantum, default 32), and only requests of
  one bucket share a micro-batch.  Each program compiles exactly once
  (:func:`repro_torch.core.engine.compile_batched` — the single-example
  executor over a batch: on the card one launch of the CUDA kernel's
  batched source per grid ``CallPlan`` for a whole micro-batch, as the
  reference's ``vmap`` gives ``pallas_call`` a batch grid axis, the
  kernel reading each example's inputs through a table of their
  addresses); its executor fixes one launch shape of the built kernel
  per problem size and keeps it.  A batch whose members share one size
  (an ensemble's members) runs at that size from the members' own
  tensors: nothing is padded, stacked or copied, and each ticket gets
  its row of the launch's stacked output (a view: an answer held keeps
  its whole batch's output allocated) — so a stream of such batches
  fixes one launch shape for each exact size, as ``compile_program``
  fixes one for each size.  A batch of mixed sizes pads each member to
  the bucket (:func:`pad_to_bucket`), hands the padded copies to the
  kernel as they are, and re-seats each result to its request's true
  shape (:func:`unpad_outputs`): one launch shape for each bucket.
  Zero-padding is bit-exact for stencil programs (goal
  stores seat only the valid region ``[lo, n+hi)`` per dim and the
  padded lanes never feed it); it is *not* guaranteed bit-exact for
  reductions (padding changes the reduce-tree shape), so programs with
  a ``reduce`` rule get exact-size buckets (quantum 1) automatically.
  The counters ``serve.gathered`` and ``serve.padded``
  (:mod:`repro_torch.obs`) count the batches of each kind.
* **Request queue + micro-batcher** — :meth:`PlanServe.submit` enqueues
  a request and returns a :class:`ServeTicket`; a background batcher
  thread collects up to ``max_batch`` same-bucket requests or waits at
  most ``max_wait_ms``, executes one batched call on the card over the
  members (or their padded copies) (one kernel launch per grid
  ``CallPlan``,
  from the batcher's thread, on its current stream), waits for the
  device through an event, and scatters
  per-request outputs back through the tickets — so a ticket's latency
  includes the device's time, not just the enqueue.  Nothing is traced,
  so batches are not padded to a family of widths: the batched kernel
  takes any batch width at a launch shape.
* **Warm start** — with a ``plan_cache_dir`` (default: the
  ``REPRO_PLAN_CACHE_DIR`` environment variable, same as
  ``compile_program``), program compilations go through the on-disk plan
  cache: a worker process whose program was already planned — by a
  previous run or by a sibling worker sharing the directory under
  :mod:`repro_torch.core.plancache`'s write locking — skips the
  analysis pipeline entirely.  :mod:`repro_torch.serve.workers` drives
  one :class:`PlanServe` per process on top of this.

A failing batch fails its tickets; nothing retries on another backend.
Per-request metrics (queue wait, batch size, compile-vs-cache-hit,
p50/p99 latency, requests/s) accumulate in :class:`ServeMetrics`.  With
spans on (:mod:`repro_torch.obs`) the caller's ``serve.submit`` and the
batcher's ``serve.wait``, ``serve.collect`` and ``serve.batch`` (with
``serve.pad`` and ``serve.unpad`` of a mixed batch, the plan's run,
``serve.finish`` and ``serve.resolve`` inside) are recorded, joined by
the ``request_id`` and ``batch_id`` in each ticket's ``stats``.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from contextlib import nullcontext as _nullcontext
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..core.engine import (PLAN_CACHE_DIR_ENV, BatchedGenerated,
                           auto_interpreter, compile_batched)
from ..core.interpreters import as_tensor, resolve_device
from ..core.rules import Program

#: Backends PlanServe accepts: those whose batched path is pinned
#: bit-identical to per-example calls (the tests hold batched against
#: unbatched per backend, ``"cuda"``'s batched kernel through its host
#: emulation; ``chip_smoke.py`` holds ``"cuda"`` on the card, one
#: launch per grid ``CallPlan`` a micro-batch).  A newly registered
#: interpreter must be added here once its conformance run passes.
VMAP_SAFE = frozenset({"torch", "cuda", "interp_torch"})

#: Default per-dimension size quantum for shape buckets.
DEFAULT_QUANTUM = 32


def quantize(n: int, quantum: int) -> int:
    """Round ``n`` up to the bucket grid: the smallest positive multiple
    of ``quantum`` that is >= n (so a 1-element dim still gets a
    nonempty bucket)."""
    if n < 1:
        raise ValueError(f"dimension size must be >= 1, got {n}")
    if quantum < 1:
        raise ValueError(f"quantum must be >= 1, got {quantum}")
    return max(quantum, -(-n // quantum) * quantum)


def is_reduction(program: Program) -> bool:
    """Whether any rule of ``program`` is a reduction — the programs
    whose outputs are *not* bit-exact under zero-padding (the pad
    changes the reduce-tree shape), so PlanServe serves them from
    exact-size buckets (quantum 1)."""
    return any(r.kind == "reduce" for r in program.rules)


def _dim(d: str) -> str:
    """Canonical dim name: axiom terms use variable dims (``"j?"``)
    while their extents are keyed by the bare name."""
    return d[:-1] if d.endswith("?") else d


def request_sizes(program: Program, arrays: dict) -> dict:
    """Infer the request's ``{size symbol: int}`` from its input arrays.

    Each axiom's array length along a dim is ``n + hi - lo`` (the
    extent contract, same as the planner's
    :class:`~repro_torch.core.plan.AxiomPlan`); solving for ``n`` per dim and
    cross-checking across axioms yields the concrete loop sizes.
    Raises ``ValueError`` on missing/extra arrays, rank mismatches, or
    inconsistent sizes.  Arrays are tensors or numpy arrays."""
    names = {a.term.ref.name for a in program.axioms}
    got = set(arrays)
    if got != names:
        raise ValueError(
            f"program {program.name!r} expects input arrays {sorted(names)}, "
            f"got {sorted(got)}")
    sizes: dict = {}
    for ax in program.axioms:
        arr = arrays[ax.term.ref.name]
        dims = ax.term.ref.dims
        if len(arr.shape) != len(dims):
            raise ValueError(
                f"axiom {ax.term.ref.name!r} of {program.name!r} is "
                f"{len(dims)}-dimensional, got rank {len(arr.shape)}")
        for axis, d in enumerate(dims):
            e = ax.extents[_dim(d)]
            n = int(arr.shape[axis]) - (e.hi - e.lo)
            if n < 1:
                raise ValueError(
                    f"array {ax.term.ref.name!r} axis {axis} (dim {d!r}) has "
                    f"length {arr.shape[axis]}, too small for extent "
                    f"[{e.lo}, {e.size}{e.hi:+d})")
            if sizes.setdefault(e.size, n) != n:
                raise ValueError(
                    f"inconsistent size for {e.size!r}: {sizes[e.size]} vs "
                    f"{n} (array {ax.term.ref.name!r} axis {axis})")
    return sizes


def bucket_sizes(program: Program, sizes: dict, quantum: int) -> tuple:
    """Quantize request sizes to the bucket grid, as a canonical sorted
    ``((symbol, size), ...)`` tuple (the bucket-table key)."""
    return tuple(sorted((sym, quantize(n, quantum))
                        for sym, n in sizes.items()))


def pad_to_bucket(program: Program, arrays: dict, bucket: tuple, *,
                  dtype=torch.float32, device="cpu") -> dict:
    """Zero-pad every input array (trailing pad per axis) to the shapes
    the bucket implies: length ``B + hi - lo`` per dim, ``B`` the
    bucketed size.  Returns contiguous tensors of ``dtype`` on
    ``device``."""
    bsz = dict(bucket)
    out = {}
    for ax in program.axioms:
        arr = as_tensor(arrays[ax.term.ref.name], dtype, device)
        exts = [ax.extents[_dim(d)] for d in ax.term.ref.dims]
        shape = tuple(bsz[e.size] + e.hi - e.lo for e in exts)
        if tuple(arr.shape) != shape:
            padded = torch.zeros(shape, dtype=dtype, device=device)
            padded[tuple(slice(0, n) for n in arr.shape)] = arr
            arr = padded
        out[ax.term.ref.name] = arr
    return out


def unpad_outputs(program: Program, outputs: dict, sizes: dict) -> dict:
    """Re-seat one example's bucket-shaped outputs to the request's true
    shapes.

    Goal stores are full size-shaped arrays whose valid region is
    ``[lo, n + hi)`` per dim with zero-seated borders (the executors'
    output contract) — so the unpad copies exactly the valid region
    into a zero array of the request's shape, which is bit-identical to
    the unbatched, unpadded run.  Scalar goals (reductions to a single
    value) pass through — reductions always run in exact-size buckets,
    so there is nothing to trim."""
    result = {}
    for g in program.goals:
        arr = outputs[g.store_as]
        dims = g.term.ref.dims
        if not dims:
            result[g.store_as] = arr
            continue
        exts = [g.extents[_dim(d)] for d in dims]
        shape = tuple(sizes[e.size] for e in exts)
        if tuple(arr.shape) == shape:
            result[g.store_as] = arr
            continue
        seat = torch.zeros(shape, dtype=arr.dtype, device=arr.device)
        region = tuple(
            slice(e.lo, sizes[e.size] + e.hi) for e in exts)
        seat[region] = arr[region]
        result[g.store_as] = seat
    return result


class ServeTicket:
    """A pending request: ``result()`` blocks until the batcher has
    executed the request's micro-batch and scattered its outputs back
    (or failed — the execution error re-raises here).  ``stats`` holds
    the per-request metrics row once done."""

    def __init__(self):
        self._event = threading.Event()
        self._outputs: Optional[dict] = None
        self._error: Optional[BaseException] = None
        #: Per-request metrics (filled when done): ``latency_ms``,
        #: ``queue_wait_ms``, ``batch_size``, ``bucket``, and the ids its
        #: spans carry, ``request_id`` and ``batch_id``.
        self.stats: dict = {}

    def done(self) -> bool:
        """Whether the request has finished (successfully or not)."""
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> dict:
        """Block until done and return ``{store_as: tensor}`` (on the
        engine's device, its computation finished) — raising
        the batch's execution error if it failed, or ``TimeoutError``
        after ``timeout`` seconds.  An answer may be a view of its
        micro-batch's one stacked output (always where the members
        share one size), so while it is held the whole batch's output
        stays allocated: ``.clone()`` an answer that is kept long."""
        if not self._event.wait(timeout):
            raise TimeoutError("request still queued/executing")
        if self._error is not None:
            raise self._error
        return self._outputs

    def _resolve(self, outputs: dict) -> None:
        self._outputs = outputs
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()


def _dist(xs: list) -> dict:
    """p50/p99/mean/max summary of a sample list (zeros when empty)."""
    if not xs:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    v = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99)),
            "mean": float(v.mean()), "max": float(v.max())}


#: The most recent requests whose latency and queue wait
#: :class:`ServeMetrics` keeps for its distributions.
SAMPLE_WINDOW = 4096


class ServeMetrics:
    """Thread-safe accumulator for PlanServe's per-request metrics.

    ``snapshot()`` returns request/batch counts, requests/s and batch
    size stats over the engine's lifetime, latency and queue-wait
    distributions (ms) over the most recent :data:`SAMPLE_WINDOW`
    requests, compile accounting (count, disk hits, total ms) and the
    per-bucket hit table.  Its memory stays bounded over the engine's
    lifetime."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.requests = 0
        self.batches = 0
        self.batched_requests = 0
        self.batch_max = 0
        self.latency_ms: deque = deque(maxlen=SAMPLE_WINDOW)
        self.queue_wait_ms: deque = deque(maxlen=SAMPLE_WINDOW)
        self.compiles = 0
        self.compile_disk_hits = 0
        self.compile_ms = 0.0
        self.buckets: dict = {}

    def record_batch(self, bucket_key, n: int) -> None:
        with self._lock:
            self.batches += 1
            self.batched_requests += n
            self.batch_max = max(self.batch_max, n)
            b = self.buckets.setdefault(
                str(bucket_key), {"batches": 0, "requests": 0})
            b["batches"] += 1
            b["requests"] += n

    def record_request(self, latency_ms: float, queue_wait_ms: float) -> None:
        with self._lock:
            self.requests += 1
            self.latency_ms.append(latency_ms)
            self.queue_wait_ms.append(queue_wait_ms)

    def record_compile(self, ms: float, disk_hit: bool) -> None:
        with self._lock:
            self.compiles += 1
            self.compile_ms += ms
            if disk_hit:
                self.compile_disk_hits += 1

    def snapshot(self) -> dict:
        """One immutable metrics view (safe to serialize); the
        percentiles are taken after the lock is let go."""
        with self._lock:
            wall = time.perf_counter() - self._t0
            requests, batches = self.requests, self.batches
            batched, size_max = self.batched_requests, self.batch_max
            latency = list(self.latency_ms)
            queue_wait = list(self.queue_wait_ms)
            compiles = {"count": self.compiles,
                        "disk_hits": self.compile_disk_hits,
                        "total_ms": self.compile_ms}
            buckets = {k: dict(v) for k, v in self.buckets.items()}
        return {
            "requests": requests,
            "batches": batches,
            "wall_s": wall,
            "requests_per_s": requests / wall if wall > 0 else 0.0,
            "latency_ms": _dist(latency),
            "queue_wait_ms": _dist(queue_wait),
            "batch_size": {"mean": batched / batches if batches else 0.0,
                           "max": size_max},
            "compiles": compiles,
            "buckets": buckets,
        }


@dataclass
class _Pending:
    """One queued request as the batcher sees it."""
    ticket: ServeTicket
    arrays: dict
    sizes: dict
    t_submit: float
    request_id: int


class PlanServe:
    """The serving engine: registered programs, a shape-bucketed
    compiled-plan table, and a micro-batching request queue.

    ``programs`` maps serving names to :class:`Program` builders'
    results; every goal must carry an explicit ``store_as`` (outputs
    are keyed by store name — the fallback name is a dataflow-internal
    identifier not derivable here).  ``device`` is where requests run
    (the current CUDA device when omitted; ``device="cpu"`` to run on
    the CPU), and ``backend`` (one of :data:`VMAP_SAFE`) defaults to the
    device's stencil interpreter: the CUDA kernel on the card, its plain
    version only when the caller asked for the CPU.  ``compile_kwargs``
    pass through to :func:`~repro_torch.core.engine.compile_batched`
    (build options, ``check_plans``).  ``quantum`` is the per-dim size
    quantum for
    stencil programs; reduction programs always bucket exactly
    (see :func:`is_reduction`).  ``plan_cache_dir`` (default: the
    ``REPRO_PLAN_CACHE_DIR`` environment variable) warms program
    compilations from the shared on-disk plan cache.

    Use as a context manager, or call :meth:`close` — the batcher
    thread is non-daemonic work and must be joined."""

    def __init__(self, programs: dict, *, backend: Optional[str] = None,
                 device=None, quantum: int = DEFAULT_QUANTUM,
                 max_batch: int = 16, max_wait_ms: float = 2.0,
                 plan_cache_dir=None, compile_kwargs: Optional[dict] = None):
        self.device = resolve_device(device)
        if backend is None:
            backend = auto_interpreter(self.device)
        if backend not in VMAP_SAFE:
            raise ValueError(
                f"backend {backend!r} is not pinned batch-safe; "
                f"expected one of {sorted(VMAP_SAFE)}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.programs: dict = {}
        self._quantum: dict = {}
        for name, prog in programs.items():
            for g in prog.goals:
                if not g.store_as:
                    raise ValueError(
                        f"program {name!r}: goal {g.term} has no store_as — "
                        f"PlanServe keys outputs by store name")
            self.programs[name] = prog
            self._quantum[name] = 1 if is_reduction(prog) else quantum
        self.backend = backend
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        if plan_cache_dir is None:
            plan_cache_dir = os.environ.get(PLAN_CACHE_DIR_ENV) or None
        self.plan_cache_dir = plan_cache_dir
        self.compile_kwargs = dict(compile_kwargs or {})
        #: the element type the programs compile for (their inputs')
        self.dtype = self.compile_kwargs.get("dtype", torch.float32)
        self.metrics = ServeMetrics()
        self._compiled: dict = {}   # name -> BatchedGenerated
        self._request_ids = itertools.count(1)
        self._batch_ids = itertools.count(1)
        self._queues: dict = {}     # (name, bucket) -> deque[_Pending]
        self._cond = threading.Condition()
        self._closed = False
        self._batcher = threading.Thread(
            target=self._batch_loop, name="planserve-batcher", daemon=True)
        self._batcher.start()

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "PlanServe":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the batcher (idempotent).  Queued requests are failed
        with ``RuntimeError`` rather than silently dropped."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._batcher.join()
        for q in self._queues.values():
            while q:
                q.popleft().ticket._fail(
                    RuntimeError("PlanServe closed with requests queued"))

    # -- compilation -------------------------------------------------------

    def _get_compiled(self, name: str) -> BatchedGenerated:
        gen = self._compiled.get(name)
        if gen is not None:
            return gen
        prog = self.programs[name]
        disk_hit = False
        if self.plan_cache_dir is not None and self.backend != "torch":
            from ..core.plancache import PlanCache, program_plan_key
            try:
                disk_hit = PlanCache(self.plan_cache_dir).has(
                    program_plan_key(prog))
            except OSError:
                disk_hit = False
        t0 = time.perf_counter()
        gen = compile_batched(
            prog, self.backend, device=self.device,
            plan_cache_dir=self.plan_cache_dir, **self.compile_kwargs)
        self.metrics.record_compile((time.perf_counter() - t0) * 1e3,
                                    disk_hit)
        self._compiled[name] = gen
        return gen

    def _on_device(self):
        """The context in which this thread launches on the engine's
        card (a no-op on the CPU)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return _nullcontext()

    def _finish(self) -> None:
        """Wait for the device to finish the work this thread enqueued
        (an event on its current stream): the counterpart of the
        reference's ``jax.block_until_ready``."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            ev.synchronize()

    def prefill(self, name: str, sizes: dict, *, batch: int = 1) -> tuple:
        """Warm one size ahead of traffic: compile the program and run a
        zero batch of ``batch`` examples at exactly ``sizes`` through it
        (which builds the kernel and fixes its launch for the batches
        whose members all have that size).  Returns the bucket key
        ``sizes`` quantizes to."""
        prog = self._program(name)
        bucket = bucket_sizes(prog, sizes, self._quantum[name])
        gen = self._get_compiled(name)
        zero = {}
        for ax in prog.axioms:
            exts = [ax.extents[_dim(d)] for d in ax.term.ref.dims]
            shape = tuple(sizes[e.size] + e.hi - e.lo for e in exts)
            zero[ax.term.ref.name] = (torch.zeros(
                shape, dtype=self.dtype, device=self.device),) * batch
        with self._on_device():
            gen.fn(zero)
            self._finish()
        return bucket

    # -- request path ------------------------------------------------------

    def _program(self, name: str) -> Program:
        try:
            return self.programs[name]
        except KeyError:
            raise ValueError(
                f"unknown program {name!r}; registered: "
                f"{sorted(self.programs)}") from None

    def submit(self, name: str, arrays: dict) -> ServeTicket:
        """Enqueue one request (``{axiom array: ndarray}``) and return
        its :class:`ServeTicket` immediately (tensors or numpy arrays;
        they are moved to the engine's device in the batcher).  Size
        inference and
        bucketing happen here (caller thread) so a malformed request
        raises synchronously, not inside the batcher."""
        rid = next(self._request_ids)
        with obs.span("serve.submit", rid):
            prog = self._program(name)
            sizes = request_sizes(prog, arrays)
            bucket = bucket_sizes(prog, sizes, self._quantum[name])
            ticket = ServeTicket()
            pend = _Pending(ticket, arrays, sizes, time.perf_counter(), rid)
            with self._cond:
                if self._closed:
                    raise RuntimeError("PlanServe is closed")
                self._queues.setdefault((name, bucket),
                                        deque()).append(pend)
                self._cond.notify_all()
        return ticket

    def serve(self, name: str, arrays: dict,
              timeout: Optional[float] = None) -> dict:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(name, arrays).result(timeout)

    # -- batcher -----------------------------------------------------------

    def _pick_bucket(self):
        """The non-empty queue whose *oldest* request was submitted
        first (FIFO across buckets — no bucket starves)."""
        best, best_t = None, None
        for key, q in self._queues.items():
            if q and (best_t is None or q[0].t_submit < best_t):
                best, best_t = key, q[0].t_submit
        return best

    def _batch_loop(self) -> None:
        while True:
            with self._cond:
                key = self._pick_bucket()
                if key is None and not self._closed:
                    with obs.span("serve.wait"):
                        while key is None and not self._closed:
                            self._cond.wait()
                            key = self._pick_bucket()
                if key is None and self._closed:
                    return
                bid = next(self._batch_ids)
                q = self._queues[key]
                # collect: up to max_batch requests, or whatever arrived
                # by the oldest request's deadline
                deadline = q[0].t_submit + self.max_wait_s
                with obs.span("serve.collect", bid):
                    while (len(q) < self.max_batch
                           and not self._closed
                           and (left := deadline - time.perf_counter()) > 0):
                        self._cond.wait(timeout=left)
                batch = [q.popleft()
                         for _ in range(min(len(q), self.max_batch))]
            with obs.span("serve.batch", bid):
                self._execute(key, batch, bid)

    def _tensors(self, arrays: dict) -> dict:
        """A request's inputs as contiguous tensors of the engine's
        dtype on its device: each array that is one already as it is."""
        return {k: a if isinstance(a, torch.Tensor) and a.dtype == self.dtype
                and a.device == self.device and a.is_contiguous()
                else as_tensor(a, self.dtype, self.device)
                for k, a in arrays.items()}

    def _execute(self, key, batch, bid: int) -> None:
        name, bucket = key
        prog = self.programs[name]
        t_start = time.perf_counter()
        self.metrics.record_batch(bucket, len(batch))
        # members of one size run at it, from their own tensors; a mixed
        # batch runs at its bucket
        gathered = all(p.sizes == batch[0].sizes for p in batch)
        obs.count("serve.gathered" if gathered else "serve.padded")
        try:
            with self._on_device():
                gen = self._get_compiled(name)
                if gathered:
                    inputs = [self._tensors(p.arrays) for p in batch]
                else:
                    with obs.span("serve.pad", bid):
                        inputs = [pad_to_bucket(prog, p.arrays, bucket,
                                                dtype=self.dtype,
                                                device=self.device)
                                  for p in batch]
                outputs = gen.fn({k: tuple(x[k] for x in inputs)
                                  for k in inputs[0]})
                outs = [{k: v[i] for k, v in outputs.items()}
                        for i in range(len(batch))]
                if not gathered:
                    with obs.span("serve.unpad", bid):
                        outs = [unpad_outputs(prog, out, p.sizes)
                                for out, p in zip(outs, batch)]
                with obs.span("serve.finish", bid):
                    self._finish()
        except Exception as err:
            for p in batch:
                p.ticket._fail(err)
            return
        t_done = time.perf_counter()
        with obs.span("serve.resolve", bid):
            for p, out in zip(batch, outs):
                p.ticket.stats = {
                    "latency_ms": (t_done - p.t_submit) * 1e3,
                    "queue_wait_ms": (t_start - p.t_submit) * 1e3,
                    "batch_size": len(batch),
                    "bucket": bucket,
                    "request_id": p.request_id,
                    "batch_id": bid,
                }
                self.metrics.record_request(p.ticket.stats["latency_ms"],
                                            p.ticket.stats["queue_wait_ms"])
                p.ticket._resolve(out)
