"""Spans and counters inside the port: its one tracing facility.

A **span** names a stretch of host time at a layer boundary of the
stencil path (the compile, a plan's run and its parts, PlanServe's
batcher); a **counter** counts work where it is done (K1's launches, the
kernel libraries built and loaded).  Nothing is written anywhere: a
caller turns spans on with :func:`enable`, takes what was recorded with
:func:`drain`, and pairs it into spans with :func:`pair`.

* **Off** (the default): :func:`span` returns one shared no-op context,
  so a span costs a read of one module flag and allocates nothing.
* **On**: a span's entry and its exit are each written as an event
  (the span's name interned to a small int, the time, the thread,
  ``ident``) into a preallocated, bounded buffer of integer
  columns, under a lock: no Python object is kept per span, so the
  collector's tracked set does not grow.  Events past the buffer's
  capacity are dropped and counted (``Drained.overflow``).  While on,
  every garbage collection is a ``host.gc`` span (its generation in
  ``ident``) on the thread that ran it.

Times are ``time.time_ns()``, the clock ``torch.profiler``'s events
carry, so spans lie on a device trace's timeline; the thread is
``threading.get_ident()`` (``pthread_self()``), by which CUPTI names the
thread of each CUDA runtime call it records (the profiler's events hand
on its low 32 bits as ``device_resource_id()``).
A span's parent is the span open around it on the same thread (its
events nest, so :func:`pair` finds it).  ``ident`` joins spans across
threads: a request's id for a request's spans, a batch's id for a
batch's (``ServeTicket.stats`` holds both).

Counters count whether spans are on or off, for the process's lifetime,
thread-safely; :func:`counter` reads one and :func:`drain` returns them
all.
"""
from __future__ import annotations

import array
import dataclasses
import gc
import threading
import time

import numpy as np

#: Events the buffer holds between two drains (two a span).
CAPACITY = 1 << 20

_on = False
_lock = threading.RLock()
_codes: dict = {}        # span name -> code (1, 2, ...)
_names: list = []        # code - 1 -> span name
_counts: dict = {}
_cols = None             # (code, t_ns, tid, ident) columns, or None
_n = 0
_overflow = 0


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, et, ev, tb):
        return None


_NOOP = _Noop()


def _code(name: str) -> int:
    code = _codes.get(name)
    if code is None:
        with _lock:
            code = _codes.get(name)
            if code is None:
                _names.append(name)
                code = _codes[name] = len(_names)
    return code


def _record(code: int, ident: int) -> None:
    """Write one event: ``+code`` enters a span, ``-code`` leaves it.
    The slot is taken before anything that may allocate, so a collection
    that starts inside this call (and records ``host.gc`` through the
    reentrant lock) takes the next slot."""
    global _n, _overflow
    t = time.time_ns()
    tid = threading.get_ident()
    with _lock:
        cols, i = _cols, _n
        if cols is None:
            return
        if i >= len(cols[0]):
            _overflow += 1
            return
        _n = i + 1
        cols[0][i] = code
        cols[1][i] = t
        cols[2][i] = tid
        cols[3][i] = ident


class _Span:
    __slots__ = ("code", "ident")

    def __init__(self, code: int, ident: int):
        self.code = code
        self.ident = ident

    def __enter__(self):
        _record(self.code, self.ident)

    def __exit__(self, et, ev, tb):
        _record(-self.code, self.ident)


def span(name: str, ident: int = 0):
    """A context manager marking one span named ``name`` on this
    thread, with ``ident`` (a request's or batch's id); a shared no-op
    while spans are off."""
    if not _on:
        return _NOOP
    return _Span(_code(name), ident)


def _on_gc(phase: str, info: dict) -> None:
    code = _code("host.gc")
    _record(code if phase == "start" else -code, info["generation"])


def enable(capacity: int = CAPACITY) -> None:
    """Turn spans on.  The buffer holds ``capacity`` events: a later call
    with the same capacity keeps it and what it holds, one with another
    starts an empty buffer."""
    global _on, _cols, _n, _overflow
    with _lock:
        if _cols is None or len(_cols[0]) != capacity:
            _n = _overflow = 0
            zeros = bytes(8 * capacity)
            _cols = (array.array("q", zeros), array.array("q", zeros),
                     array.array("q", zeros), array.array("q", zeros))
        if _on_gc not in gc.callbacks:
            gc.callbacks.append(_on_gc)
        _on = True


def disable() -> None:
    """Turn spans off (spans open now still record their exit); what the
    buffer holds stays until :func:`drain`."""
    global _on
    with _lock:
        _on = False
        if _on_gc in gc.callbacks:
            gc.callbacks.remove(_on_gc)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always, spans on or off)."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name``'s total over the process's lifetime."""
    return _counts.get(name, 0)


@dataclasses.dataclass
class Drained:
    """What :func:`drain` took: the span events in the order they were
    written (``code`` ``+k`` enters and ``-k`` leaves the span named
    ``names[k - 1]``; ``t_ns``, ``tid``, ``ident`` beside it), the events
    dropped on a full buffer, and every counter's lifetime total."""
    names: list
    code: np.ndarray
    t_ns: np.ndarray
    tid: np.ndarray
    ident: np.ndarray
    overflow: int
    counters: dict


def drain() -> Drained:
    """The events recorded since the last drain (the buffer is emptied)
    and every counter's total (counters are not reset)."""
    global _n, _overflow
    with _lock:
        if _cols is None:
            out = [np.zeros(0, np.int64)] * 4
        else:
            out = [np.frombuffer(c, np.int64, _n).copy() for c in _cols]
        got = Drained(list(_names), *out, _overflow, dict(_counts))
        _n = _overflow = 0
    return got


@dataclasses.dataclass
class Spans:
    """Spans as columns: ``name`` (a name of ``names``), ``start`` and
    ``end`` (``time.time_ns()``; ``end`` is :data:`OPEN` for a span not
    yet closed), ``tid``, ``parent`` (the index of the span open around
    it on its thread, or -1) and ``ident``, in the order they opened."""
    names: list
    name: np.ndarray
    start: np.ndarray
    end: np.ndarray
    tid: np.ndarray
    parent: np.ndarray
    ident: np.ndarray

    def __len__(self) -> int:
        return len(self.name)

    def label(self, i: int) -> str:
        return self.names[self.name[i]]


#: ``Spans.end`` of a span still open.
OPEN = np.iinfo(np.int64).max


def pair(*drains: Drained) -> Spans:
    """Pair the entry and exit events of consecutive drains (the first
    taken after :func:`enable`) into :class:`Spans`.  An exit whose entry
    was dropped on a full buffer is skipped."""
    names = max((d.names for d in drains), key=len, default=[])
    name, start, end, tid, parent, ident = [], [], [], [], [], []
    stacks: dict = {}
    for d in drains:
        for code, t, th, idn in zip(d.code.tolist(), d.t_ns.tolist(),
                                    d.tid.tolist(), d.ident.tolist()):
            stack = stacks.setdefault(th, [])
            if code > 0:
                stack.append(len(name))
                name.append(code - 1)
                start.append(t)
                end.append(OPEN)
                tid.append(th)
                parent.append(stack[-2] if len(stack) > 1 else -1)
                ident.append(idn)
                continue
            k = len(stack) - 1
            while k >= 0 and name[stack[k]] != -code - 1:
                k -= 1
            if k >= 0:
                end[stack[k]] = t
                del stack[k:]
    col = np.asarray
    return Spans(names, col(name, np.int64), col(start, np.int64),
                 col(end, np.int64), col(tid, np.int64),
                 col(parent, np.int64), col(ident, np.int64))
