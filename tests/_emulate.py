"""The kernels' host emulation, shared by the port's kernel tests.

The hand-written kernels compile as host C++ (``g++ -DHFAV_EMULATE``,
``repro_torch.kernels.build._host_build``): ``emulate.h`` stands in for
the card, blocks run one after another, a block's threads are host
threads meeting at a barrier, ``cp.async`` lands at the wait that retires
it, and a batched K1 launch runs its blocks in an order that interleaves
the examples (:data:`BLOCK_STRIDE`).  The build caches each source by
content under ``build/repro_torch/``, so a source the suite emulates
compiles once, whichever module or worker asks first.

The emulated K1 is the registered ``"cuda"`` interpreter with only its
driver's device facts swapped (:class:`_Host`): it seats its outputs,
and declares its dtypes, flags and capabilities, because the card's spec
does.  :func:`emulated` registers it with K1's outputs and scratch
starting as NaN, so a step no block writes shows; :func:`emulator` is
the module-scoped fixture of it.

Also here, for the tests that share them: the K1 tests' plans, inputs and
source pins, the hazard analysis of the row step's barriers, the 2-byte
gates' recorded calls, and the K2-K4 emulation's inputs.  This module
imports no JAX: the ``cuda``-marked tests import it on the card's
machine, which has none.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import re
import shutil

import numpy as np
import pytest
import torch

from _goldens import golden_path
from _inputs import hydro2d_state
from repro_torch.core import (ALL_PROGRAMS, clear_compile_cache,
                              compile_program, from_reference_dict)
from repro_torch.core.interpreters import (get_interpreter,
                                           register_interpreter,
                                           registered_interpreters,
                                           unregister_interpreter)
from repro_torch.kernels import build
from repro_torch.kernels.stencil2d import kernel as k1
from repro_torch.kernels.stencil2d.emit import (H100_SMS, CallLayout,
                                                emit_source)

#: The emulated K1 interpreter's name.
NAME = "_emulated_cuda"
#: Host threads an emulated block runs.
THREADS = 3
#: The stride of the emulated batched launch's block order: block b of n
#: runs (b * stride mod n)-th, which interleaves the examples.
BLOCK_STRIDE = 7
#: Concrete sizes of the loop dims: small, distinct, and no multiples of
#: each other.
DIM = {"i": 20, "j": 7, "k": 4, "l": 3}
#: Odd Ni: 2-byte rows start in turn on and between 4-byte words, so the
#: bf16 and float16 ring's 2-byte heads and tails are copied.
ODD_DIM = {"i": 37, "j": 9, "k": 4, "l": 3}
#: (k = 4, l = 3: the plane stencils keep an interior of 2 planes)
LONG_SUMS = {"j": 512, "i": 37, "k": 4, "l": 3}
#: The programs with an accumulator.
ACCUMULATING = ("courant", "energy3d", "heat3d_residual_norm",
                "normalization", "plane_sum", "smooth_norm", "subset_sum")

#: sha256 (first 16 hex digits) of each golden plan's grid-call sources
#: in each dtype, concatenated in call order, as the emitter wrote them
#: before it learned batches (but for the row prime each writes into
#: ``chunk_of``, derived from the plan's reads): the single-call kernels
#: are unchanged.
SOURCES = {
    "float32": {
        "advect4d_halo": "7ce7c25898bc3fae", "cosmo": "6b8c3919fc989f90",
        "energy3d": "4fe5d08bbb96864c", "heat3d": "3e8e29523f5090df",
        "heat3d_residual_norm": "568941a62af936da",
        "heat3d_stage": "157414aaf88c1788", "hydro1d": "cbde5fd94ab9081d",
        "laplace5": "aba0b8d72a16887f", "laplace_pair": "00ee6bc5ac04ec2a",
        "normalization": "cb683d8058d17edc",
        "plane_sum": "4bb673ed3b9a17d0", "pyramid4d": "cc3c970de9888473",
        "row_sum": "f15f127c6de0e72a", "smooth_norm": "09ebe4017c8136af",
        "subset_sum": "64aa52bd10b98786"},
    "bfloat16": {
        "advect4d_halo": "f5a24bd69129e665", "cosmo": "c5bfe858a28ebf1f",
        "energy3d": "4ca7d2b85d41aa5d", "heat3d": "c328b211a5d0e059",
        "heat3d_residual_norm": "cd5ee90b0f95507a",
        "heat3d_stage": "5820e93d5ad0dac2", "hydro1d": "62f7765e1fc99336",
        "laplace5": "0575ca5f04a61e10", "laplace_pair": "3db66cdc01f6d0c6",
        "normalization": "44f1c13ca358d3e3",
        "plane_sum": "df66c2695b543c98", "pyramid4d": "760327eb3d16a679",
        "row_sum": "32da988ec0e7c18f", "smooth_norm": "6d13f409b45efb93",
        "subset_sum": "903058bcf19449ec"},
    "float16": {
        "advect4d_halo": "7288bb43c9c8ef1a", "cosmo": "94a1d6addc51c16f",
        "energy3d": "29fe4d2770460222", "heat3d": "fe0abc3ed9a1b60e",
        "heat3d_residual_norm": "029ac0480abaa086",
        "heat3d_stage": "34f8323e3e671c27", "hydro1d": "b5609f92e064482c",
        "laplace5": "6bb546b24a20e980", "laplace_pair": "11556491bef9908a",
        "normalization": "ebdf5e1820d7935d",
        "plane_sum": "e1df323b450ee052", "pyramid4d": "221fa92b14fe9cee",
        "row_sum": "cc09a04a94540771", "smooth_norm": "93ae2b074ce9bb07",
        "subset_sum": "a82a5b1187f7cddf"},
}


# ---------------------------------------------------------------------------
# K1's plans and inputs
# ---------------------------------------------------------------------------

def _plan(name):
    return compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                           device="cpu").kernel_plan


def _golden(name):
    return from_reference_dict(json.loads(golden_path(name).read_text()))


def grid_calls(name) -> int:
    return sum(c.has_grid for c in _plan(name).calls)


def _dname(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def inputs(name, kplan, rng, dtype=torch.float32, dims=ODD_DIM):
    """One seeded array per axiom of ``kplan`` at ``dims`` (hydro1d's
    density positive, as in the repository's hydro benchmark), rounded
    to ``dtype`` and held as float32 (each value exact in both)."""
    sizes = {sym: dims.get(d, 3) for d, sym in kplan.dim_sizes}
    out = {}
    for ax in kplan.axioms:
        ext = {d: (sym, lo, hi) for d, sym, lo, hi in ax.extents}
        shape = [sizes[ext[d][0]] + ext[d][2] - ext[d][1] for d in ax.dims]
        a = rng.standard_normal(shape).astype(np.float32)
        if name == "hydro1d" and ax.array == "rho":
            a = a * a + 1.0
        a = hydro2d_state(name, ax.array, a)
        out[ax.array] = torch.from_numpy(a).to(dtype).float()
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (a NaN equal to the same NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def _arrays(kplan, rng, dims=DIM):
    """One standard normal float32 array per axiom of ``kplan`` at
    ``dims`` (hydro2d's state physical)."""
    sizes = {sym: dims.get(d, 3) for d, sym in kplan.dim_sizes}
    out = {}
    for ax in kplan.axioms:
        ext = {d: (sym, lo, hi) for d, sym, lo, hi in ax.extents}
        shape = [sizes[ext[d][0]] + ext[d][2] - ext[d][1] for d in ax.dims]
        out[ax.array] = hydro2d_state(
            kplan.program, ax.array,
            rng.standard_normal(shape).astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# The row step's barriers, against a hazard analysis of its own
# ---------------------------------------------------------------------------

def _emitted_phases(src: str) -> tuple[dict, int]:
    """Each step's phase in the emitted row step (a phase ends at each
    ``__syncthreads()`` between the row step's markers), and the
    barriers a row step meets (the one after the ring's wait included)."""
    lines = src.splitlines()
    start = lines.index("    // -- row step --")
    end = lines.index("    // -- end of row step --")
    assert "__syncthreads();" in lines[start - 4]
    phase, barriers, of = 0, 1, {}
    for line in lines[start:end]:
        if line.strip() == "__syncthreads();":
            phase += 1
            barriers += 1
        m = re.search(r"if \(.*\) \{  // step (\d+)$", line)
        if m:
            of[int(m.group(1))] = phase
    return of, barriers


def _shared_touches(step, plane_leads):
    """(reads, writes) of one step in shared memory as (location, row,
    column offset): locals at the writer's column, produced windows at a
    row (a plane window at its plane and row)."""
    reads, writes = [], []
    for rd in step.reads:
        if rd.src.startswith("local:"):
            reads.append((rd.src, None, rd.col0))
        elif rd.src.startswith("b_"):
            reads.append(((rd.src, rd.p_off), rd.j_off, rd.col0))
    if step.acc is None:
        for targets in step.writes:
            for kind, tgt in targets:
                if kind == "local":
                    writes.append((f"local:{tgt}", None, 0))
                elif kind == "buf":
                    writes.append(((str(tgt), plane_leads.get(str(tgt), 0)),
                                   step.lead, step.out_col0))
    return reads, writes


def _same_place(a, b, plane_leads) -> bool:
    """Whether two touches may be the same element of another thread."""
    if a[0] != b[0] or a[2] == b[2]:
        return False
    if a[1] is None:  # a local, at another column
        return True
    if a[0][0] in plane_leads:  # a plane window: rows clamp at the top
        return True if a[1] is None or b[1] is None else \
            min(a[1], b[1]) <= max(a[1], b[1])
    return a[1] == b[1]


def check_barriers(call) -> int:
    """Assert that a barrier separates, inside one row step, every write
    of a shared element and a later read or overwrite of it by another
    thread, and that a register local is read only at its writer's column
    and phase; returns the barriers a row step meets."""
    src = emit_source(call)
    phase, barriers = _emitted_phases(src)
    assert sorted(phase) == list(range(len(call.steps)))
    assert barriers == CallLayout(call).barriers_per_row
    plane_leads = {w.name: w.p_lead for w in call.windows if w.plane}
    touches = [_shared_touches(s, plane_leads) for s in call.steps]
    for w in range(len(call.steps)):
        for r in range(w + 1, len(call.steps)):
            wr_w, rd_w = touches[w][1], touches[w][0]
            rd_r, wr_r = touches[r]
            hazard = any(_same_place(a, b, plane_leads)
                         for a in wr_w for b in rd_r + wr_r) \
                or any(_same_place(a, b, plane_leads)
                       for a in rd_w for b in wr_r)
            if hazard:
                assert phase[w] < phase[r], (
                    f"{call.name}: steps {w} ({call.steps[w].op}) and {r} "
                    f"({call.steps[r].op}) share a shared-memory element "
                    f"across threads with no barrier between them")
    for name in set(re.findall(r"float (L_\w+(?:, L_\w+)*);", src)):
        for reg in name.split(", "):
            local = reg[2:]
            writer = next(i for i, (_, wr) in enumerate(touches)
                          for t in wr if t[0] == f"local:{local}")
            for i, (rd, _) in enumerate(touches):
                for t in rd:
                    if t[0] == f"local:{local}":
                        assert t[2] == 0 and phase[i] == phase[writer], \
                            f"{call.name}: register local {local}"
    return barriers


# ---------------------------------------------------------------------------
# The host build
# ---------------------------------------------------------------------------

def need_gxx() -> None:
    """Skip the test where there is no host C++ compiler."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to emulate the kernels")


def _host_build(jobs, flags=(), program=False) -> list:
    """``build._host_build``, or a skip where there is no ``g++``."""
    need_gxx()
    return build._host_build(jobs, flags, program)


def host_build(source: str, flags=(), bind=None, program=False):
    """The host build of ``source`` (a test's own C++ over ``emulate.h``
    or ``stencil2d.cuh``): a shared library bound by ``bind``, or with
    ``program`` (a source with a ``main``) an executable's path."""
    return _host_build([build.Job(source, (k1.HEADER,), k1.CSRC,
                                  bind or (lambda lib: None))],
                       flags, program)[0]


def kernel_library(mod, flags=()) -> ctypes.CDLL:
    """The host build of the kernel module ``mod``'s ``.cu`` (K2, K3 or
    K4: ``mod.SOURCE``), bound by ``mod._bind``."""
    return _host_build([build.Job(mod.SOURCE.read_text(), (), mod.CSRC,
                                  mod._bind)], flags)[0]


def _k1_job(call, dtype, batched: bool, seated: bool) -> build.Job:
    """K1's build job of ``call``, the batched kernel's blocks set to run
    in the interleaved order once loaded."""
    def bind(lib):
        k1._bind(lib)
        lib.hfav_emulate_block_stride.argtypes = [ctypes.c_longlong]
        lib.hfav_emulate_block_stride(BLOCK_STRIDE if batched else 1)
    return dataclasses.replace(k1.job(call, dtype, batched, seated),
                               bind=bind)


def prebuild(cases) -> None:
    """Compile K1's single and batched sources of every ``(call, dtype,
    seated)`` in ``cases``, several compilers at a time."""
    _host_build([_k1_job(call, dtype, batched, seated)
                 for call, dtype, seated in cases
                 for batched in (False, True)])


# ---------------------------------------------------------------------------
# The emulated K1
# ---------------------------------------------------------------------------

class _Host(k1._Card):
    """The emulation's facts: CPU tensors, K1's host build, the H100's
    SMs, :data:`THREADS` host threads a block, no device context and no
    stream."""

    kind = "cpu"

    def library(self, call, dtype, batched, seated):
        return _host_build([_k1_job(call, dtype, batched, seated)])[0]

    def sms(self, dev) -> int:
        return H100_SMS

    def threads(self, run) -> int:
        return THREADS

    def device(self, dev):
        return contextlib.nullcontext()

    def stream(self, dev):
        return None


HOST = _Host()


def emulated_spec(name: str = NAME, **changes):
    """The ``"cuda"`` interpreter's spec under ``name`` with its driver's
    device facts emulated (and ``changes``, such as ``seats=False``)."""
    return dataclasses.replace(
        get_interpreter("cuda"), name=name,
        build_call=functools.partial(k1._build, card=HOST),
        build_batched=functools.partial(k1._build, batched=True, card=HOST),
        **changes)


@contextlib.contextmanager
def emulated(*specs):
    """``specs`` (by default :func:`emulated_spec`'s) registered, every
    output and scratch K1 allocates starting as NaN, and the compile cache
    cleared, while the context lasts; yields the first spec's name.  A
    name registered before (``"cuda"``) gets its spec back."""
    specs = specs or (emulated_spec(),)
    before = {s.name: get_interpreter(s.name)
              if s.name in registered_interpreters() else None
              for s in specs}
    real = k1.alloc_outputs

    def poisoned(lay, run, device):
        outs, scratch = real(lay, run, device)
        for t in outs + [scratch]:
            t.fill_(float("nan"))
        return outs, scratch

    k1.alloc_outputs = poisoned
    for spec in specs:
        register_interpreter(spec)
    clear_compile_cache()
    try:
        yield specs[0].name
    finally:
        clear_compile_cache()
        for name, spec in before.items():
            if spec is None:
                unregister_interpreter(name)
            else:
                register_interpreter(spec)
        k1.alloc_outputs = real


@pytest.fixture(scope="module")
def emulator():
    """The emulated K1's interpreter name, registered for the module."""
    need_gxx()
    with emulated() as name:
        yield name


# ---------------------------------------------------------------------------
# K1's calls, recorded for the 2-byte gates
# ---------------------------------------------------------------------------

def _numpy(out: dict) -> dict:
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def _listed(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def rel_l2(got, exact) -> float:
    """``|got - exact| / |exact|`` in float64 (the absolute distance
    where ``exact`` is zero)."""
    g = torch.from_numpy(np.array(got, dtype=np.float64))
    e = torch.from_numpy(np.array(exact, dtype=np.float64))
    num = float((g - e).norm())
    den = float(e.norm())
    return num / den if den > 0 else num


def has_accumulator(kplan) -> bool:
    return any(call.accs for call in kplan.calls if call.has_grid)


class recorded_calls:
    """While active, every K1 launch's ``(layout, launch, inputs,
    outputs)``: padded, or at their seat for ``layout.seated_outs``."""

    def __enter__(self):
        self.calls, self.real = [], k1.run_kernel

        def recording(lib, lay, run, args, **kw):
            out = self.real(lib, lay, run, args, **kw)
            self.calls.append((lay, run, args, _listed(out)))
            return out
        k1.run_kernel = recording
        return self.calls

    def __exit__(self, *exc):
        k1.run_kernel = self.real


ISSUE_ROW_CPP = r"""
#include "stencil2d.cuh"
#include <cmath>
#include <cstdio>
#include <cstdlib>
// Copy a row of n bf16 values that starts `off` elements past a 16-byte
// boundary into a window row at the same offset.  The row is its
// tensor's first (nothing before it to borrow) or follows a row of
// off + 8 values; the tensor ends where its allocation ends (ASan sees a
// read past it), and elements before it hold a sentinel that no copy may
// bring into the window.
int main() {
  const unsigned short sentinel = 0x4b00, marker = 0x1234;
  int bad = 0;
  for (int n = 1; n <= 20; ++n)
    for (int off = 0; off < 8; ++off)
      for (int second = 0; second < 2; ++second) {
        const int before = second ? 0 : off;
        const int len = second ? off + 8 + n : n;
        void* raw = nullptr;
        if (posix_memalign(&raw, 16, (before + len) * 2)) return 2;
        __nv_bfloat16* const all = static_cast<__nv_bfloat16*>(raw);
        for (int c = 0; c < before; ++c) all[c].x = sentinel;
        __nv_bfloat16* const t = all + before;
        for (int c = 0; c < len; ++c) t[c] = __float2bfloat16(c + 1.0f);
        const __nv_bfloat16* const src = t + len - n;
        const int sh = hfav::shift8(src);
        if (sh != off) ++bad;
        alignas(16) __nv_bfloat16 win[64];
        for (auto& v : win) v.x = marker;
        blockDim.x = 1;
        threadIdx.x = 0;
        hfav::issue_row(win + sh, src, n, 1, t);
        hfav::commit();
        // before the wait every copied element is undefined (NaN) but
        // the one a plain store moved (the tensor's odd first element)
        for (int c = 0; c < n; ++c) {
          const bool plain = !second && c == 0 && (sh & 1);
          if (!plain && !std::isnan(__bfloat162float(win[sh + c]))) ++bad;
        }
        hfav::wait_ring_n(0);
        for (int c = 0; c < n; ++c)
          if (win[sh + c].x != src[c].x) ++bad;
        for (int c = 0; c < 64; ++c) {
          if (win[c].x == sentinel) ++bad;  // read before the tensor
          // written only in the row and one margin element each side
          if ((c < sh - 1 || c > sh + n) && win[c].x != marker) ++bad;
        }
        std::free(raw);
      }
  std::printf("%d\n", bad);
}
"""


# ---------------------------------------------------------------------------
# K2 and K3's emulation inputs
# ---------------------------------------------------------------------------

def _np(x):
    return x.detach().float().cpu().numpy()


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


def _attn_inputs(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32))


# B, Sq, Skv, H, KVH, D, causal, window, q_offset; each in float32 (the
# scalar kernel) and bf16 (the tensor-core kernel)
EMU_ATTN_CASES = [
    (1, 70, 70, 2, 1, 32, True, None, 0),       # ragged S
    (1, 64, 100, 2, 2, 16, False, None, 36),    # Sq < Skv
    (2, 130, 130, 2, 1, 64, True, 20, 0),       # masked tiles
    (1, 40, 72, 2, 1, 80, True, None, 32),
    (1, 65, 65, 2, 2, 128, False, 30, 0),
    (1, 77, 141, 2, 1, 16, True, None, 64),     # ragged Sq and Skv
    (1, 93, 150, 2, 2, 128, False, None, 57),   # ragged Sq and Skv
    # the moe, encdec and vlm paths' shapes: one query row (decode cross
    # attention) over a ragged Skv, ragged Sq < Skv cross attention at
    # D = 64, GQA group 3 (granite) and group 8 at D = 128 (qwen2-vl)
    (2, 1, 77, 2, 2, 64, False, None, 76),
    (1, 45, 141, 2, 2, 64, False, None, 96),
    (1, 70, 70, 6, 2, 64, True, None, 0),
    (1, 65, 65, 8, 1, 128, True, None, 0),
]

# Two warps, each loading three 16 x 16 bf16 matrices of its own from
# shared memory: A by ldmatrix (A fragments), Bt (B stored n-major, as K
# rows are) by ldmatrix, V (k-major, as V rows are) by ldmatrix.trans;
# then A Bt^T and A V by mma (two n8 tiles each), and a shuffle.
PRIMS_SRC = r"""
#include "emulate.h"
struct Args {
  const unsigned short* m;  // (2 warps, 3 matrices, 16, 16) bf16
  unsigned* raw;            // (2, 32 lanes, 3, 4) ldmatrix registers
  float* d;                 // (2, 2 products, 16, 16)
  float* shfl;              // (2, 32, 5)
};
void prims(const Args p) {
  const unsigned w = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* const sm = reinterpret_cast<unsigned char*>(hfav_smem) +
                            w * 3 * 512;
  if (lane == 0) std::memcpy(sm, p.m + w * 3 * 256, 3 * 512);
  __syncwarp();
  const unsigned r = (lane & 7) + 8 * ((lane >> 3) & 1), h = lane >> 4;
  unsigned regs[3][4];
  hfav_ldmatrix_x4(regs[0], sm + 32 * r + 16 * h, false);
  hfav_ldmatrix_x4(regs[1],
                   sm + 512 + 32 * (8 * h + (lane & 7)) + 16 * ((lane >> 3) & 1),
                   false);
  hfav_ldmatrix_x4(regs[2], sm + 1024 + 32 * r + 16 * h, true);
  for (int m = 0; m < 3; ++m)
    for (int i = 0; i < 4; ++i)
      p.raw[((w * 32 + lane) * 3 + m) * 4 + i] = regs[m][i];
  const unsigned g = lane / 4, t = lane % 4;
  for (int prod = 0; prod < 2; ++prod)
    for (int n = 0; n < 2; ++n) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      hfav_mma_bf16(d, regs[0], regs[1 + prod] + 2 * n, d);
      for (int e = 0; e < 4; ++e)
        p.d[((w * 2 + prod) * 16 + g + 8 * (e / 2)) * 16 + 8 * n + 2 * t +
            e % 2] = d[e];
    }
  const float x = lane * 1.5f + w;
  for (int k = 0; k < 5; ++k)
    p.shfl[(w * 32 + lane) * 5 + k] = __shfl_xor_sync(~0u, x, 1 << k);
}
extern "C" int run_prims(const Args* p) {
  return emulate_launch(prims, *p, 1, 64, 0);
}
"""


def _frag(m8, lane):
    """Register ``lane`` of ldmatrix (not transposed) on the 8 x 8 matrix
    ``m8``: row lane / 4, columns 2 (lane % 4) and 2 (lane % 4) + 1."""
    return m8[lane // 4, 2 * (lane % 4):2 * (lane % 4) + 2]


# ---------------------------------------------------------------------------
# K4's emulation inputs
# ---------------------------------------------------------------------------

def ssd_inputs(B, S, H, P, N, *, seed=0, dt_shift=-1.0, device="cpu",
               dtype=torch.float32):
    """x (in ``dtype``), dt, A, Bm, Cm, D from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    f = np.float32
    arrs = [(rng.standard_normal((B, S, H, P)) * 0.5).astype(f),
            np.log1p(np.exp(rng.standard_normal((B, S, H)) * 0.5
                            + dt_shift)).astype(f),
            (-np.exp(rng.standard_normal(H) * 0.3)).astype(f),
            (rng.standard_normal((B, S, N)) * 0.5).astype(f),
            (rng.standard_normal((B, S, N)) * 0.5).astype(f),
            (rng.standard_normal(H) * 0.2).astype(f)]
    out = [torch.from_numpy(a).to(device) for a in arrs]
    out[0] = out[0].to(dtype)
    return out


def emulate_ssd(lib, args, chunk):
    """One launch of K4's emulated library ``lib`` on ``args`` (y and the
    scratch starting as NaN); returns ``(y, chunk length)``."""
    from repro_torch.kernels.ssd import kernel as k4

    x = args[0]
    L = k4.chunk_len(x.shape[1], chunk)
    y = torch.full_like(x, float("nan"))
    bufs = k4.scratch(x, args[3].shape[-1], L)
    for t in bufs:
        t.fill_(float("nan"))
    blocks = k4.launch(lib, *args, y, *bufs, L=L, stream=None)
    B, S, H, P = x.shape
    nc, n = S // L, -(-L // 64)
    # one block per (b, chunk, pair of 64-row tiles u <= t), per (b, h,
    # chunk), per 256 state entries, and per (b, h, chunk, 64-row tile)
    assert blocks == (B * nc * n * (n + 1) // 2, B * H * nc,
                      -(-B * H * args[3].shape[-1] * P // 256), B * H * nc * n)
    return y, L
