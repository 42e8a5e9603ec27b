"""Building the hand-written CUDA kernels: ``nvcc`` into shared libraries
with a plain C interface, loaded with ``ctypes``.

Every kernel of the port is built the same way, at first use, never at
import: one ``nvcc`` per source for ``sm_90a``, all the sources of one
:func:`build` call started together, each library cached by the sha256
of (source, the headers it includes, ``nvcc --version``, the flags) in
``build/repro_torch/`` at the repository root.  A failed build raises
with the compiler's log.  The counters ``kernel.nvcc`` and ``kernel.load``
(:mod:`repro_torch.obs`) count the libraries compiled and loaded.

The same cache holds the host build of a source (:func:`_host_build`, the
tests' emulation): ``g++ -DHFAV_EMULATE``, where
``stencil2d/csrc/emulate.h`` stands in for the card, so a kernel runs on
the CPU, one block after another.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import fcntl
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Callable, Sequence

from .. import obs

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: The host build's flags (a library's add ``-shared -fPIC``).
HOST_FLAGS = ("-x", "c++", "-std=c++20", "-O1", "-pthread", "-DHFAV_EMULATE")
#: The header every host build includes, which enters its cache key.
EMULATE_H = pathlib.Path(__file__).resolve().parent / "stencil2d" / "csrc" \
    / "emulate.h"
#: Host compilers one process runs at once.
HOST_PARALLEL = 4

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_VERSIONS: dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class Job:
    """One library to build: ``source`` (the text of a ``.cu``), the
    ``headers`` it includes (their text enters the cache key), the
    directory to search for them, and ``bind``, which declares the
    library's C functions (``argtypes``/``restype``) once it is loaded."""
    source: str
    headers: tuple[pathlib.Path, ...]
    include: pathlib.Path
    bind: Callable[[ctypes.CDLL], None]


def nvcc_path() -> str:
    """The ``nvcc`` to build with (``$CUDA_HOME/bin/nvcc``, else the
    one on ``PATH``, else ``/usr/local/cuda/bin/nvcc``)."""
    home = os.environ.get("CUDA_HOME")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "nvcc at first use")


def _version(compiler: str) -> str:
    if compiler not in _VERSIONS:
        _VERSIONS[compiler] = subprocess.run(
            [compiler, "--version"], check=True, capture_output=True,
            text=True).stdout
    return _VERSIONS[compiler]


def nvcc_version() -> str:
    return _version(nvcc_path())


def _digest(job: Job, *parts: str) -> str:
    h = hashlib.sha256()
    for part in (job.source, *(p.read_text() for p in job.headers), *parts):
        h.update(part.encode())
        h.update(b"\0")
    return h.hexdigest()[:32]


def digest(job: Job) -> str:
    return _digest(job, nvcc_version(), " ".join(NVCC_FLAGS))


def library_path(job: Job) -> pathlib.Path:
    """Where the library of ``job`` is (or will be) built."""
    return BUILD_DIR / f"{digest(job)}.so"


def sass_count(job: Job, opcode: str) -> int:
    """How many lines of ``cuobjdump -sass`` (from the toolkit of
    :func:`nvcc_path`) on the built library of ``job`` name ``opcode``
    (``grep -c``): ``HMMA`` counts the tensor-core products."""
    cuobjdump = pathlib.Path(nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library_path(job))],
                          check=True, capture_output=True, text=True).stdout
    return sum(opcode in line for line in sass.splitlines())


def resource_usage(job: Job) -> str:
    """Registers, shared memory and spills of each kernel in the built
    library of ``job`` (``cuobjdump -res-usage``), one line each."""
    cuobjdump = pathlib.Path(nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-res-usage",
                          str(library_path(job))], check=True,
                         capture_output=True, text=True).stdout
    return "\n".join(line.strip() for line in out.splitlines()
                     if "REG:" in line or "Function" in line)


def registers(job: Job) -> tuple[int, int]:
    """(registers a thread, bytes of local memory a thread: spills and
    stack) of the first kernel in the built library of ``job``, from
    :func:`resource_usage`."""
    line = next(ln for ln in resource_usage(job).splitlines()
                if "REG:" in ln)
    res = {k: int(v) for k, v in re.findall(r"(\w+):(\d+)", line)}
    return res["REG"], res.get("STACK", 0) + res.get("LOCAL", 0)


def _tmp(key: str, suffix: str) -> pathlib.Path:
    """This process's own name for a file of ``key`` while it builds:
    processes building the same kernel at once (spawned serving workers)
    never write or read each other's files."""
    return BUILD_DIR / f"{key}.{os.getpid()}.tmp{suffix}"


def _start_build(job: Job, key: str, argv=None, suffix: str = ".so"):
    """Start the compiler (``argv``: by default ``nvcc`` and
    :data:`NVCC_FLAGS`) on ``job`` unless its output (``{key}{suffix}``)
    is built already; returns the compiler process, or None."""
    if key in _LIBS or (BUILD_DIR / f"{key}{suffix}").exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _tmp(key, ".cu")
    cu.write_text(job.source)
    return subprocess.Popen(
        [*(argv or (nvcc_path(), *NVCC_FLAGS)), f"-I{job.include}", "-o",
         str(_tmp(key, suffix)), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish_compile(key: str, proc, suffix: str = ".so") -> None:
    """Wait for ``proc`` (if any) and move its source and output to
    their shared names (``{key}.cu``, ``{key}{suffix}``), each by one
    atomic rename; raises with the compiler's log when it failed."""
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{pathlib.Path(proc.args[0]).name} failed "
                           f"building {_tmp(key, '.cu')}:\n{log}")
    os.replace(_tmp(key, ".cu"), BUILD_DIR / f"{key}.cu")
    os.replace(_tmp(key, suffix), BUILD_DIR / f"{key}{suffix}")


def _finish_build(job: Job, key: str, proc) -> ctypes.CDLL:
    """Wait for ``proc`` (if any) and load and bind the library."""
    _finish_compile(key, proc)
    lib = _LIBS.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(BUILD_DIR / f"{key}.so"))
        job.bind(lib)
        _LIBS[key] = lib
        obs.count("kernel.load")
    return lib


def build(jobs: Sequence[Job]) -> tuple[list[ctypes.CDLL], int]:
    """Build (or load from the cache) the library of every job, one
    ``nvcc`` per distinct source, all started together; returns the
    libraries in the order of ``jobs`` and how many were compiled."""
    with _LOCK:
        keys = [digest(j) for j in jobs]
        procs = {}
        for job, key in zip(jobs, keys):
            if key not in procs:
                procs[key] = _start_build(job, key)
        libs = {}
        for job, key in zip(jobs, keys):
            if key not in libs:
                libs[key] = _finish_build(job, key, procs[key])
    compiled = sum(p is not None for p in procs.values())
    obs.count("kernel.nvcc", compiled)
    return [libs[k] for k in keys], compiled


@contextlib.contextmanager
def _held(key: str):
    """An exclusive lock of ``key``'s lock file while the context lasts:
    one process at a time builds a key."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{key}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def _host_build(jobs: Sequence[Job], flags: Sequence[str] = (),
                program: bool = False) -> list:
    """The host build of every job (``g++`` with :data:`HOST_FLAGS` and
    ``flags``): a shared library, loaded and bound, or with ``program``
    an executable, whose path is returned.  Cached as :func:`build`
    caches ``nvcc``'s, the key holding :data:`EMULATE_H` too; each source
    compiles once across processes (a compile holds its key's lock, the
    locks taken in key order), :data:`HOST_PARALLEL` at a time."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host build needs a host C++ "
                           "compiler")
    argv = (gxx, *HOST_FLAGS,
            *(flags if program else ("-shared", "-fPIC", *flags)))
    suffix = ".exe" if program else ".so"
    keys = [_digest(j, EMULATE_H.read_text(), _version(gxx),
                    " ".join(argv[1:])) for j in jobs]
    of = dict(zip(keys, jobs))
    todo = sorted(k for k in of if not (BUILD_DIR / f"{k}{suffix}").exists())
    with _LOCK:
        for i in range(0, len(todo), HOST_PARALLEL):
            with contextlib.ExitStack() as held:
                procs = []
                for key in todo[i:i + HOST_PARALLEL]:
                    held.enter_context(_held(key))
                    procs.append((key, _start_build(of[key], key, argv,
                                                    suffix)))
                for key, proc in procs:
                    _finish_compile(key, proc, suffix)
        if program:
            return [BUILD_DIR / f"{k}{suffix}" for k in keys]
        return [_finish_build(of[k], k, None) for k in keys]
