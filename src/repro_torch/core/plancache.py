"""On-disk AOT plan cache: the durable L2 beneath the engine's
in-memory plan cache.

The port's counterpart of ``repro.core.plancache``.  The paper's
central claim is that fusion + access-pattern analysis can be decided
*ahead of time* and replayed cheaply.  The
:class:`~repro_torch.core.plan.KernelPlan` IR makes the decision
explicit; this module makes it durable: a content-addressed store of serialized plans
(:meth:`KernelPlan.to_dict`, schema
:data:`~repro_torch.core.plan.SCHEMA_VERSION`) keyed by the *program's*
structural identity, so a fresh process compiles a known program
without ever invoking the planner — the analysis pipeline
(inference → dataflow → fusion → storage → plan) is skipped entirely
and the stencil interpreter is built straight from the loaded IR.
Entries are interpreter-agnostic: keys name the *program*, not a
backend, so one warmed plan re-links into whichever registered plan
interpreter (:mod:`repro_torch.core.interpreters`) the loading process asks
for — the engine keys its in-memory executor cache per interpreter on
top of this shared L2.

Design points:

* **Content-addressed** — :func:`program_plan_key` folds the program
  signature (rules, patterns, kernel code objects, axioms/goals, loop
  order) together with the plan schema version, the torch and CUDA
  versions and the port's own ``__version__`` into one SHA-256 digest.
  Any ingredient changing (a kernel body edit, a schema bump, a torch
  upgrade) changes the key, so stale
  entries become unreachable rather than wrong.  Objects without a
  stable byte form (unhashable closures, exotic callables) hash by
  ``repr`` — at worst a per-process address sneaks in and the entry
  simply never hits again (a miss is always safe; a false hit never
  is).
* **Atomic writes** — entries are written to a same-directory temp
  file and :func:`os.replace`\\ d into place, so concurrent writers and
  crashes can never leave a torn entry under the final name.
* **Corruption-tolerant loads** — :meth:`PlanCache.get` treats *any*
  failure (unreadable file, bad JSON, schema mismatch, un-linkable
  function spec, a plan failing
  :meth:`~repro_torch.core.plan.KernelPlan.validate`) as a miss and lets the
  caller re-plan.  Entries condemned by their own bytes are deleted
  best-effort; process-local failures (a step builder not registered
  *here*) keep the file, since other processes may load it fine.  A
  poisoned cache directory degrades to cold compiles, never to a crash
  or a wrong kernel.
* **Bounded with LRU eviction** — at most ``max_entries`` files;
  `get` refreshes an entry's mtime and `put` evicts the
  oldest-touched entries beyond the bound.
* **Cross-process write locking** — ``put`` (the write + the eviction
  sweep) runs under an advisory ``flock`` on a ``.lock`` file in the
  cache directory, so concurrent warmers never interleave an eviction
  scan with another process's fill and over-evict.  On platforms
  without :mod:`fcntl` the lock degrades to a no-op — the atomic
  rename still guarantees entries are never torn, only the LRU bound
  becomes approximate under races.

Wired into :func:`repro_torch.core.engine.compile_program` via
``plan_cache_dir=...``.  Entries always hold the plan before any
LayoutApply transform (the pass re-runs per compilation).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import marshal
import os
import pathlib
import sys
import types
from typing import Optional

import torch

from .plan import SCHEMA_VERSION, KernelPlan

try:
    import fcntl
except ImportError:  # non-POSIX: writes stay atomic, locking no-ops
    fcntl = None

#: Default bound on the number of on-disk entries per cache directory.
DEFAULT_MAX_ENTRIES = 256


def repro_version() -> str:
    """Version stamp of the port, folded into every plan-cache key and
    entry header so a build change invalidates persisted plans."""
    from . import __version__
    return __version__


def _header() -> dict:
    """The version stamps an entry must match to load."""
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "repro_torch": repro_version()}


def _digest_update(h, obj) -> None:
    """Feed one object into a hash with type tags, stably across
    processes: scalars by repr, containers recursively, code objects by
    marshal bytes, callables through fn_key.  Unknown objects fall back
    to repr — unstable reprs (memory addresses) make the key unmatchable,
    which degrades to a cache miss, never a false hit."""
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        h.update(b"s")
        h.update(repr(obj).encode())
    elif isinstance(obj, (tuple, list)):
        h.update(b"t%d" % len(obj))
        for x in obj:
            _digest_update(h, x)
    elif isinstance(obj, dict):
        h.update(b"d%d" % len(obj))
        for k in sorted(obj, key=repr):
            _digest_update(h, k)
            _digest_update(h, obj[k])
    elif isinstance(obj, types.CodeType):
        h.update(b"c")
        h.update(marshal.dumps(obj))
    elif callable(obj):
        from .plan import fn_key
        key = fn_key(obj)
        h.update(b"f")
        if key is obj:  # no stable key: hash by repr (miss-safe)
            h.update(repr(obj).encode())
        else:
            _digest_update(h, key)
    else:
        h.update(b"o")
        h.update(type(obj).__name__.encode())
        h.update(repr(obj).encode())


def program_plan_key(program) -> str:
    """Content digest addressing a program's serialized plan on disk.

    Covers the full structural program signature
    (:func:`repro_torch.core.engine.program_signature` — rule names/patterns/
    kinds/inits, kernel code objects + closures, axioms, goals, loop
    order, aliases) plus the plan schema version, the torch, CUDA and
    port versions, and the Python major.minor (marshal stability)."""
    from .engine import program_signature
    h = hashlib.sha256()
    _digest_update(h, ("repro-torch-kernel-plan", SCHEMA_VERSION,
                       torch.__version__, torch.version.cuda,
                       repro_version(), sys.version_info[:2],
                       program_signature(program)))
    return h.hexdigest()


class PlanCache:
    """A directory of serialized :class:`KernelPlan` entries, one JSON
    file per key, atomic and bounded (see the module docstring)."""

    def __init__(self, root, max_entries: int = DEFAULT_MAX_ENTRIES):
        """Open (creating if needed) the cache directory at ``root``."""
        self.root = pathlib.Path(root)
        self.max_entries = int(max_entries)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> pathlib.Path:
        return self.root / f"{key}.json"

    @contextlib.contextmanager
    def _write_lock(self):
        """Advisory cross-process lock serializing ``put`` (write +
        eviction) against other writers of the same directory.  A
        failure to acquire — missing :mod:`fcntl`, unwritable lock
        file — degrades to unlocked operation: atomic renames keep
        entries untorn; only the eviction bound goes approximate."""
        if fcntl is None:
            yield
            return
        try:
            fd = os.open(self.root / ".lock", os.O_CREAT | os.O_RDWR, 0o644)
        except OSError:
            yield
            return
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)  # closing the fd releases the flock

    def __len__(self) -> int:
        """Number of entries currently on disk."""
        return len(list(self.root.glob("*.json")))

    def has(self, key: str) -> bool:
        """Whether an entry file exists under ``key`` (no load/parse —
        a cheap pre-check for fill-if-missing callers)."""
        return self._path(key).exists()

    def get(self, key: str) -> Optional[KernelPlan]:
        """Load and re-validate the plan stored under ``key``.

        Returns ``None`` on any failure.  Failures that condemn the
        *entry* — torn/corrupt JSON, header mismatch (schema, torch,
        CUDA or port version), a plan failing :meth:`KernelPlan.validate` — delete
        it best-effort so the follow-up re-plan overwrites it.
        Failures that are *process-local*
        (:class:`~repro_torch.core.plan.PlanSerializationError`, e.g. step
        builders not yet registered in this process) keep the file: the
        entry may be perfectly valid for every properly-initialized
        process sharing the directory.  A hit refreshes the entry's
        LRU recency; an entry that vanishes *mid-get* (another
        process's eviction sweep won the race) degrades to a miss, so
        callers never act on a plan the cache no longer holds."""
        from .plan import SCHEMA_VERSION, PlanSerializationError
        path = self._path(key)
        try:
            payload = json.loads(path.read_text())
            if (any(payload[k] != v for k, v in _header().items())
                    or payload["plan"].get("schema") != SCHEMA_VERSION):
                # condemned by its own header: route past the
                # keep-the-entry branch below
                raise ValueError("version header mismatch")
            kplan = KernelPlan.from_dict(payload["plan"]).validate()
        except FileNotFoundError:
            return None
        except PlanSerializationError:
            return None  # process-local re-link failure: keep the entry
        except Exception:
            try:
                path.unlink()
            except OSError:
                pass
            return None
        try:
            os.utime(path)  # LRU recency
        except FileNotFoundError:
            # lost a race with another process's eviction sweep (the
            # refresh runs outside the write lock by design — a read
            # must not serialize against writers): the entry is gone,
            # so a hit here would report a plan the cache no longer
            # holds.  Degrade to a miss: the caller re-plans and
            # re-fills, which is what keeps many serving workers
            # sharing one directory warm.
            return None
        except OSError:
            pass  # utime denied but the entry still exists: still a hit
        return kplan

    def put(self, key: str, kplan: KernelPlan) -> bool:
        """Serialize ``kplan`` under ``key`` (atomic rename), evicting
        the least-recently-touched entries beyond ``max_entries``.

        Returns False — storing nothing — when the plan is not durable
        (a kernel callable without a stable spec,
        :class:`~repro_torch.core.plan.PlanSerializationError`) or the store
        itself fails (``OSError``: full/read-only/racing directory);
        the caller's in-memory compilation is unaffected either way."""
        from .plan import PlanSerializationError
        try:
            payload = json.dumps({**_header(), "plan": kplan.to_dict()},
                                 indent=1, sort_keys=True)
        except PlanSerializationError:
            return False
        path = self._path(key)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        with self._write_lock():
            try:
                tmp.write_text(payload)
                os.replace(tmp, path)
            except OSError:
                try:
                    tmp.unlink()
                except OSError:
                    pass
                return False
            self._evict()
        return True

    def _evict(self) -> None:
        def mtime(p):
            # entries vanish under concurrent writers/evictors: treat a
            # missing file as oldest and let unlink tolerate the race
            try:
                return p.stat().st_mtime
            except OSError:
                return 0.0

        entries = sorted(self.root.glob("*.json"), key=mtime)
        for victim in entries[:max(0, len(entries) - self.max_entries)]:
            try:
                victim.unlink()
            except OSError:
                pass
