"""Split-KV decode attention on Hopper: K3 of the port.

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_decode/kernel.py:flash_decode``.  The CUDA C++
source is ``csrc/flash_decode.cu`` (its header comment gives the design
and what bounds it): a split kernel over (batch, KV head, KV chunk)
blocks and a combine kernel over (batch, head), launched together by
one call.  It is built with ``nvcc`` for ``sm_90a`` at first use
(:mod:`repro_torch.kernels.build`), loaded with ``ctypes`` and launched
on PyTorch's current stream.

:func:`flash_decode` launches the kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it runs
:func:`flash_decode_plain`, the same function as a plain float32 masked
softmax with the kernel's sentinels (``NEG_INF = -1e30``, denominator
clamped at ``1e-30``).  :data:`launches` counts its calls that launched
the kernel pair.

The compute dtype is q's.  When q is bf16 and the caches float32, both
versions round the cached values to bf16 before attending, as the
reference casts the caches to the compute dtype.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import build
from ..flash_attention.kernel import HEAD_DIMS

NEG_INF = -1e30
#: Cache positions one block of the split kernel takes.
CHUNK = 256
#: Most query heads one KV head may serve.
MAX_GROUP = 16
CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_decode.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Calls of :func:`flash_decode` that launched the kernel.
launches = 0
_LIB: list[ctypes.CDLL] = []


def _bind(lib: ctypes.CDLL) -> None:
    lib.fd_decode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_float, ctypes.c_void_p,
                              ctypes.c_void_p]
    lib.fd_decode.restype = ctypes.c_int
    lib.fd_error_string.argtypes = [ctypes.c_int]
    lib.fd_error_string.restype = ctypes.c_char_p


def job() -> build.Job:
    """The build job of the kernel's library."""
    return build.Job(SOURCE.read_text(), (), CSRC, _bind)


def library() -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    if not _LIB:
        _LIB.append(build.build([job()])[0][0])
    return _LIB[0]


def _check(q, k_cache, v_cache, lengths, window) -> None:
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"q (B, H, D) and caches (B, S, KVH, D): got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, H, D = q.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % k_cache.shape[2]:
        raise ValueError(f"{H} query heads do not group over "
                         f"{k_cache.shape[2]} KV heads")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)}, expected ({B},)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if k_cache.dtype != v_cache.dtype:
        raise ValueError(f"cache dtypes differ: {k_cache.dtype}, "
                         f"{v_cache.dtype}")


def flash_decode_plain(q, k_cache, v_cache, lengths, *, window: int | None,
                       scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 scores over the
    cache (rounded to q's dtype first), positions at or past
    ``lengths`` and outside the window masked with the finite sentinel,
    softmax with the clamped denominator, output in q's dtype."""
    B, H, D = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    group = H // KVH
    kf = k_cache.to(q.dtype).float()
    vf = v_cache.to(q.dtype).float()
    qf = q.float().reshape(B, KVH, group, D) * scale
    s = torch.einsum("bhgd,bshd->bhgs", qf, kf)
    kpos = torch.arange(S, device=q.device)[None, :]
    last = (lengths.long() - 1)[:, None]
    mask = kpos <= last
    if window is not None:
        mask &= kpos > last - window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgs,bshd->bhgd", p, vf) / l
    return o.reshape(B, H, D).to(q.dtype)


def n_splits(S: int, chunk: int) -> int:
    return -(-S // chunk)


def launch(lib, q, k_cache, v_cache, lengths, o, part_ml, part_acc, *,
           window: int | None, scale: float, chunk: int,
           stream) -> tuple[int, int]:
    """One launch of the kernel pair writing ``o`` on ``stream`` (a
    ``cudaStream_t`` as an int), ``chunk`` cache positions to a block of
    the split kernel.  Returns the blocks it launched (split kernel,
    combine kernel); raises when refused."""
    B, H, D = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    ints = [_DTYPES[q.dtype], _DTYPES[k_cache.dtype], B, S, H, KVH, D,
            chunk, n_splits(S, chunk), window or 0,
            q.stride(0), q.stride(1), o.stride(0), o.stride(1)]
    for t in (k_cache, v_cache):
        ints += [t.stride(0), t.stride(1), t.stride(2)]
    ptrs = (ctypes.c_void_p * 7)(q.data_ptr(), k_cache.data_ptr(),
                                 v_cache.data_ptr(), lengths.data_ptr(),
                                 o.data_ptr(), part_ml.data_ptr(),
                                 part_acc.data_ptr())
    grids = (ctypes.c_longlong * 2)()
    rc = lib.fd_decode(ptrs, (ctypes.c_longlong * len(ints))(*ints), scale,
                       stream, grids)
    if rc != 0:
        raise RuntimeError(f"flash decode launch failed: "
                           f"{lib.fd_error_string(rc).decode()} ({rc})")
    return grids[0], grids[1]


def buffers(q, S: int, chunk: int = CHUNK):
    """The output and the per-split partials of one call."""
    B, H, D = q.shape
    ns = n_splits(S, chunk)
    return (torch.empty_like(q),
            torch.empty((B, H, ns, 2), dtype=torch.float32, device=q.device),
            torch.empty((B, H, ns, D), dtype=torch.float32, device=q.device))


def prepare(q, k_cache, v_cache, lengths, *, window: int | None,
            scale: float):
    """Check a call on CUDA tensors and allocate its output and partials.
    Returns ``(o, run)``: ``run()`` launches the kernel pair once on the
    current stream, writing ``o``, and returns the blocks it launched, as
    :func:`launch` does.  Raises on anything the kernel does not take.
    :func:`flash_decode` launches through it; a timing loop may call
    ``run`` alone."""
    _check(q, k_cache, v_cache, lengths, window)
    tensors = (q, k_cache, v_cache, lengths)
    if not (q.device.type == "cuda"
            and all(t.device == q.device for t in tensors)):
        raise ValueError(f"flash decode takes its tensors on one CUDA device "
                         f"(or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES:
        raise ValueError(f"flash decode builds for float32 and bfloat16, not "
                         f"{q.dtype} / {k_cache.dtype}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"flash decode builds for head dims {HEAD_DIMS}, "
                         f"not {q.shape[2]}")
    if q.shape[1] // k_cache.shape[2] > MAX_GROUP:
        raise ValueError(f"flash decode serves at most {MAX_GROUP} query "
                         f"heads per KV head")
    if q.stride(2) != 1 or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("flash decode needs the head dim contiguous")
    lengths = lengths.to(torch.int32).contiguous()
    o, part_ml, part_acc = buffers(q, k_cache.shape[1])
    lib = library()
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def run() -> tuple[int, int]:
        with torch.cuda.device(q.device):
            return launch(lib, q, k_cache, v_cache, lengths, o, part_ml,
                          part_acc, window=window, scale=scale, chunk=CHUNK,
                          stream=stream)

    return o, run


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 window: int | None = None,
                 scale: float | None = None) -> torch.Tensor:
    """q (B, H, D) one token per sequence; caches (B, S, KVH, D);
    lengths (B,) valid cache lengths, the new token's included."""
    global launches
    _check(q, k_cache, v_cache, lengths, window)
    scale = scale if scale is not None else q.shape[2] ** -0.5
    if all(t.device.type == "cpu" for t in (q, k_cache, v_cache, lengths)):
        return flash_decode_plain(q, k_cache, v_cache, lengths,
                                  window=window, scale=scale)
    o, run = prepare(q, k_cache, v_cache, lengths, window=window, scale=scale)
    run()
    launches += 1
    return o
