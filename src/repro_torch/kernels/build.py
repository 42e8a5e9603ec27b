"""Building the hand-written CUDA kernels: ``nvcc`` into shared libraries
with a plain C interface, loaded with ``ctypes``.

Every kernel of the port is built the same way, at first use, never at
import: one ``nvcc`` per source for ``sm_90a``, all the sources of one
:func:`build` call started together, each library cached by the sha256
of (source, the headers it includes, ``nvcc --version``, the flags) in
``build/repro_torch/`` at the repository root.  A failed build raises
with the compiler's log.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Callable, Sequence

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_NVCC_VERSION: list[str] = []


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


def nvcc_version() -> str:
    if not _NVCC_VERSION:
        _NVCC_VERSION.append(subprocess.run(
            [nvcc_path(), "--version"], check=True, capture_output=True,
            text=True).stdout)
    return _NVCC_VERSION[0]


def digest(job: Job) -> str:
    h = hashlib.sha256()
    for part in (job.source, *(p.read_text() for p in job.headers),
                 nvcc_version(), " ".join(NVCC_FLAGS)):
        h.update(part.encode())
        h.update(b"\0")
    return h.hexdigest()[:32]


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


def _start_build(job: Job, key: str):
    """Start ``nvcc`` on ``job`` unless its library is built already;
    returns the compiler process, or None."""
    if key in _LIBS or (BUILD_DIR / f"{key}.so").exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _tmp(key, ".cu")
    cu.write_text(job.source)
    return subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, f"-I{job.include}", "-o",
         str(_tmp(key, ".so")), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish_compile(key: str, proc) -> None:
    """Wait for ``proc`` (if any) and move its source and library to
    their shared names (``{key}.cu``, ``{key}.so``), each by one atomic
    rename; raises with the compiler's log when it failed."""
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {_tmp(key, '.cu')}:\n"
                           f"{log}")
    os.replace(_tmp(key, ".cu"), BUILD_DIR / f"{key}.cu")
    os.replace(_tmp(key, ".so"), BUILD_DIR / f"{key}.so")


def _finish_build(job: Job, key: str, proc) -> ctypes.CDLL:
    """Wait for ``proc`` (if any) and load and bind the library."""
    _finish_compile(key, proc)
    lib = _LIBS.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(BUILD_DIR / f"{key}.so"))
        job.bind(lib)
        _LIBS[key] = lib
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
    return [libs[k] for k in keys], sum(p is not None for p in procs.values())
