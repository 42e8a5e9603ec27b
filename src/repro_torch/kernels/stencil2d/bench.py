"""Timing the stencil kernel on the card.

The helpers time by CUDA events (median over runs after warm-up, the L2
flushed before each run) and count the bytes each call must move: each
input read once, each output written once under the reference contract.
``chip_smoke.py`` uses them for its main-path numbers.
"""
from __future__ import annotations

import math
import statistics
import subprocess

import numpy as np
import torch

from ...cards import HBM_RATE, rate
from . import kernel as k1

#: (program, sizes of its loop dims outermost first): the largest sizes
#: of the repository's normalization and hydro benchmarks, and cosmo at
#: a size past the H100's 50 MB L2.
MAIN_PATH = (("normalization", {"j": 4096, "i": 2048}),
             ("hydro1d", {"j": 2048, "i": 4096}),
             ("cosmo", {"k": 64, "j": 512, "i": 512}))
#: The programs with plane windows, which run in plane chunks times row
#: tiles: heat3d at the size of the repository's lifted benchmark
#: (benchmarks/lifted.py) and at cosmo's, heat3d_stage (a producer plane
#: window) and heat3d_residual_norm (an accumulator over the planes) at
#: cosmo's, and advect4d_halo (no benchmark of its own) at the same 64 MiB
#: of input split over four ``l`` tiles.
PLANE_WINDOW_PATH = (("heat3d", {"k": 6, "j": 32, "i": 256}),
                     ("heat3d", {"k": 64, "j": 512, "i": 512}),
                     ("heat3d_stage", {"k": 64, "j": 512, "i": 512}),
                     ("heat3d_residual_norm", {"k": 64, "j": 512, "i": 512}),
                     ("advect4d_halo", {"l": 4, "k": 16, "j": 512,
                                        "i": 512}))
RUNS = 20


def smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    """The card's device-memory rate (bytes/s)."""
    return rate(HBM_RATE, name)


def make_inputs(name: str, kplan, dims: dict, seed: int, device,
                round_to=None) -> dict:
    """One seeded float32 array per axiom of ``kplan``, shaped by its
    extents at ``dims`` (loop dim -> size); hydro1d's density is kept
    positive as in the repository's hydro benchmark, and hydro2d's
    density and total energy are drawn as the port's benchmark draws
    them (``x * x + 1``, ``x * x + 20``).  ``round_to`` (bf16
    or float16) rounds each value to that type (kept float32, each value
    exact in both, so a float64 run of the same inputs gives the exact
    value)."""
    rng = np.random.default_rng(seed)
    sizes = {sym: dims[d] for d, sym in kplan.dim_sizes}
    out = {}
    for ax in kplan.axioms:
        ext = {d: (sym, lo, hi) for d, sym, lo, hi in ax.extents}
        shape = [sizes[ext[d][0]] + ext[d][2] - ext[d][1] for d in ax.dims]
        a = rng.standard_normal(shape, dtype=np.float32)
        if name == "hydro1d" and ax.array == "rho":
            a = a * a + 1.0
        if name == "hydro2d" and ax.array in ("rho", "E"):
            a = a * a + (1.0 if ax.array == "rho" else 20.0)
        t = torch.from_numpy(a)
        out[ax.array] = (t.to(round_to).float() if round_to
                         else t).to(device)
    return out


def l2_flusher(device):
    """A callable overwriting 128 MiB, past the 50 MB L2."""
    buf = torch.empty(32 * 2**20, dtype=torch.float32, device=device)
    return buf.zero_


#: GPU clock cycles of the spin that :func:`device_ms` puts before its
#: start event (about 1 ms on an H100, far longer than a wrapper takes to
#: launch its kernels).
HIDE_CYCLES = 2_000_000


def _median_ms(fn, flush, runs: int, spin: int) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        flush()
        if spin:
            torch.cuda._sleep(spin)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def event_ms(fn, flush, runs: int = RUNS) -> float:
    """Median time of ``fn`` by CUDA events over ``runs`` runs after
    warm-up, with ``flush`` run before each.  The host's launches are
    inside it: this is the end-to-end time of a call."""
    return _median_ms(fn, flush, runs, 0)


def device_ms(fn, flush, runs: int = RUNS) -> float:
    """As :func:`event_ms`, but the device spins (``torch.cuda._sleep``)
    before the start event while the host enqueues ``fn``, so a call
    shorter than its host-side launch is timed on the device alone.
    Every kernel time (the kernel, its plain version, the library call)
    is taken this way."""
    return _median_ms(fn, flush, runs, HIDE_CYCLES)


def capture(fn):
    """Run ``fn()`` once, recording every kernel launch it makes as
    ``(lib, layout, launch, args)``; returns ``(fn(), records)``."""
    records = []
    real = k1.run_kernel

    def recording(lib, lay, run, args, **kw):
        records.append((lib, lay, run, args))
        return real(lib, lay, run, args, **kw)

    k1.run_kernel = recording
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        k1.run_kernel = real
    return out, records


def call_bytes(lay, run, args) -> int:
    """Bytes one call must move: each input read once (its own element
    size), each output written once in its shape and the call's element
    type (``kernel.output_shapes``: a seated output's goal, else the
    reference contract's -- row outputs ``(*grid, steps_j, Ni)``,
    accumulators ``(*grid[:n_kept], w)``, not the kernel's per-chunk
    partial rows); a batched launch's for each of its examples (whose
    inputs ``args`` holds as sequences of the examples' tensors)."""
    out = sum(math.prod(s) for s in k1.output_shapes(lay, run))
    ins = [t for a in args for t in a] if run.batch else args
    return sum(t.numel() * t.element_size() for t in ins) \
        + lay.itemsize * out * max(run.batch, 1)


def kernel_ms(record, flush) -> float:
    """Device time of one recorded call's kernel alone (the fold of its
    accumulators' partial rows included), relaunched with the same inputs
    at its recorded launch shape (these launches are not counted in
    ``kernel.launches``)."""
    lib, lay, run, args = record
    _, tensors = k1.launch_tensors(lay, run, args)
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    return device_ms(lambda: k1.launch(lib, run, tensors, threads=run.threads,
                                       stream=stream), flush)

