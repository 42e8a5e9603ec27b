"""The Mamba2 SSD chunked scan on Hopper: K4 of the port.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd/kernel.py:ssd_pallas``.
The CUDA C++ source is ``csrc/ssd.cu`` (its header comment gives the
design and what bounds it): the chunk axis is split across blocks in
four launches -- the C_t B_u^T tiles of each (batch, chunk), shared by
the heads; each chunk's own state contribution in parallel; a short
sequential pass over the chunks' states; then each chunk's outputs, one
block per 64-row tile -- and every product runs on the tensor cores
(``mma.sync`` m16n8k8, TF32 operands split in two terms, a float32
accumulator: 3xTF32), so the kernel keeps the float32 function's
accuracy.  What bounds it now is the latency of its tile loads and of
mma.sync fed from shared memory with few warps resident, far above both
the tensor cores' rate and the bytes, scratch included (``PERF.md``).
It is built with ``nvcc`` for ``sm_90a`` at first use
(:mod:`repro_torch.kernels.build`), loaded with ``ctypes`` and launched
on PyTorch's current stream.

:func:`ssd_kernel` launches the kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it runs
:func:`~repro_torch.kernels.ssd.ops.ssd_scan`, the kernel's plain version.
Both take the chunk length as the reference's kernel does
(:func:`chunk_len`), so a sequence that is not a multiple of the chunk
still runs.  :data:`launches` counts its calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import build
from .._grad import refuse_grad
from .ops import ssd_scan

#: Largest head dim and state dim the kernel takes.
MAX_P, MAX_N = 64, 128
#: Rows of one tile of a chunk (t or u).
TILE = 64
#: Shared memory one block may use on the card, in bytes.
MAX_SMEM = 232448
CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "ssd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1,
           torch.float16: 2}

#: Calls of :func:`ssd_kernel` that launched the kernel.
launches = 0
_LIB: list[ctypes.CDLL] = []


def _bind(lib: ctypes.CDLL) -> None:
    lib.ssd_forward.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.ssd_forward.restype = ctypes.c_int
    lib.ssd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_error_string.restype = ctypes.c_char_p


def job() -> build.Job:
    """The build job of the kernel's library."""
    return build.Job(SOURCE.read_text(), (), CSRC, _bind)


def library() -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    if not _LIB:
        _LIB.append(build.build([job()])[0][0])
    return _LIB[0]


def chunk_len(S: int, chunk: int) -> int:
    """The chunk length the reference's kernel takes: ``min(chunk, S)``,
    halved until it divides ``S``."""
    L = min(chunk, S)
    while L > 1 and S % L:
        L //= 2
    return L


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(N: int, P: int, L: int) -> int:
    """Dynamic shared memory of the largest of the kernel's tiled passes
    (as ``ssd.cu`` lays them out: ``state_smem``, ``gram_smem``,
    ``out_smem``)."""
    xst, cst = _pad16(P) + 8, _pad16(N) + 4
    state = 3 * L + 32 + TILE * (_pad16(N) + 8) + TILE * xst
    gram = 2 * TILE * cst
    out = 2 * L + 32 + max(TILE * cst + _pad16(N) * xst,
                           TILE * (TILE + 4) + TILE * xst)
    return 4 * max(state, gram, out)


def _pairs(L: int) -> int:
    """(t tile, u tile <= t tile) pairs of a chunk of ``L`` tokens."""
    n = -(-L // TILE)
    return n * (n + 1) // 2


def _check(x, dt, A, Bm, Cm, D) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, _ = x.shape
    N = Bm.shape[-1] if Bm.ndim == 3 else -1
    want = {"dt": (B, S, H), "A": (H,), "Bm": (B, S, N), "Cm": (B, S, N),
            "D": (H,)}
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("D", D)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]} for x {tuple(x.shape)}")


def launch(lib, x, dt, A, Bm, Cm, D, y, states, decay, gram, *, L: int,
           stream) -> tuple:
    """One launch writing ``y`` on ``stream`` (a ``cudaStream_t`` as an
    int) with chunks of ``L`` tokens; ``A`` and ``D`` float32 and
    contiguous; ``states``, ``decay`` and ``gram`` the float32 scratch
    of :func:`scratch`.  Returns the blocks of its four launches; raises
    when one is refused."""
    B, S, H, P = x.shape
    ints = [_DTYPES[x.dtype], B, S, H, P, Bm.shape[-1], L,
            *x.stride()[:3], *dt.stride(), *y.stride()[:3],
            *Bm.stride()[:2], *Cm.stride()[:2]]
    ptrs = (ctypes.c_void_p * 10)(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                  Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
                                  y.data_ptr(), states.data_ptr(),
                                  decay.data_ptr(), gram.data_ptr())
    blocks = (ctypes.c_longlong * 4)()
    rc = lib.ssd_forward(ptrs, (ctypes.c_longlong * len(ints))(*ints),
                         stream, blocks)
    if rc != 0:
        raise RuntimeError(f"ssd launch failed: "
                           f"{lib.ssd_error_string(rc).decode()} ({rc})")
    return tuple(blocks)


def scratch(x, N: int, L: int):
    """The float32 buffers one launch passes between its passes: the
    chunk states (B, H, S / L, N, P), their decays (B, H, S / L) and the
    Gram tiles C_t B_u^T (B, S / L, pairs, 64, 64)."""
    B, S, H, P = x.shape
    nc = S // L if L else 0
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty((B, H, nc, N, P), **f32),
            torch.empty((B, H, nc), **f32),
            torch.empty((B, nc, _pairs(L) if L else 0, TILE, TILE), **f32))


def prepare(x, dt, A, Bm, Cm, D, *, chunk: int):
    """Check a call on CUDA tensors and allocate its output and scratch.
    Returns ``(y, run)``: ``run()`` launches the kernel once on the
    current stream, writing ``y``, and returns the blocks of its four
    launches.  Raises on anything the kernel does not take.
    :func:`ssd_kernel` launches through it; a timing loop may call
    ``run`` alone."""
    _check(x, dt, A, Bm, Cm, D)
    tensors = (x, dt, A, Bm, Cm, D)
    if not (x.device.type == "cuda"
            and all(t.device == x.device for t in tensors)):
        raise ValueError(f"the ssd kernel takes its tensors on one CUDA "
                         f"device (or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the ssd kernel builds for x in float32, "
                         f"bfloat16 and float16, not {x.dtype}")
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype != torch.float32:
            raise ValueError(f"the ssd kernel takes {name} in float32, not "
                             f"{t.dtype}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N):
        raise ValueError(f"the ssd kernel takes head dims up to {MAX_P} and "
                         f"state dims up to {MAX_N}, not P={P}, N={N}")
    if x.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError("the ssd kernel needs the head dim of x and the "
                         "state dim of Bm and Cm contiguous")
    L = chunk_len(S, chunk) if S else 1
    if smem_bytes(N, P, L) > MAX_SMEM:
        raise ValueError(f"chunks of {L} tokens need "
                         f"{smem_bytes(N, P, L)} bytes of shared memory, "
                         f"more than the {MAX_SMEM} a block may use")
    A = A.to(torch.float32).contiguous()
    D = D.to(torch.float32).contiguous()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    bufs = scratch(x, N, L)
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def run() -> tuple:
        with torch.cuda.device(x.device):
            return launch(lib, x, dt, A, Bm, Cm, D, y, *bufs, L=L,
                          stream=stream)

    return y, run


def ssd_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
               chunk: int = 128) -> torch.Tensor:
    """x (B, S, H, P), dt (B, S, H) post-softplus, A (H,) negative,
    Bm/Cm (B, S, N), D (H,) -> y (B, S, H, P) in x's dtype."""
    global launches
    refuse_grad("the ssd kernel (K4)", x, dt, A, Bm, Cm, D)
    _check(x, dt, A, Bm, Cm, D)
    if all(t.device.type == "cpu" for t in (x, dt, A, Bm, Cm, D)):
        return ssd_scan(x, dt, A, Bm, Cm, D,
                        chunk=chunk_len(x.shape[1], chunk))
    y, run = prepare(x, dt, A, Bm, Cm, D, chunk=chunk)
    run()
    launches += 1
    return y
