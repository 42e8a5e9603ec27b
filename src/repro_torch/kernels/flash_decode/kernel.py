"""Split-KV decode attention on Hopper: K3 of the port.

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_decode/kernel.py:flash_decode``.  The CUDA C++
source is ``csrc/flash_decode.cu`` (its header comment gives the design
and what bounds it): a split kernel over (batch, KV head, split) blocks,
each taking its share of its sequence's valid cache range, and a combine
kernel over (batch, head), launched together by one call.  The split
count comes from the SM count and ``B * KVH`` alone (:func:`n_splits`),
so a call reads nothing back from the device.  It is built with
``nvcc`` for ``sm_90a`` at first use (:mod:`repro_torch.kernels.build`),
one library for each cache dtype, loaded with ``ctypes`` and launched on
PyTorch's current stream.  The
caches are read 16 bytes at a time: their bases and (batch, seq, head)
strides must be 16-byte aligned, or the wrapper raises.

:func:`flash_decode` launches the kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it runs
:func:`flash_decode_plain`, the same function as a plain float32 masked
softmax with the kernel's sentinels (``NEG_INF = -1e30``, denominator
clamped at ``1e-30``).  :data:`launches` counts its calls that launched
the kernel pair.

The compute dtype is q's.  When q is bf16 or float16 and the caches of
another type, both versions round the cached values to q's dtype before
attending, as the reference casts the caches to the compute dtype (a
bf16 cache under float16 q goes through float16: past 65504 it is Inf,
below 2**-14 a float16 subnormal).
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import NamedTuple

import torch

from .. import build
from .._grad import refuse_grad
from ..flash_attention.kernel import HEAD_DIMS

NEG_INF = -1e30
#: A split block's keys are a multiple of this many cache positions.
PIECE = 64
#: The H100's SM count, the default of :func:`n_splits` off the card.
SMS = 132
#: Most query heads one KV head may serve.
MAX_GROUP = 16
CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_decode.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1,
           torch.float16: 2}

#: Calls of :func:`flash_decode` that launched the kernel.
launches = 0
_LIB: dict[torch.dtype, ctypes.CDLL] = {}
_SMS: dict[int, int] = {}  # SM count by device index


def _bind(lib: ctypes.CDLL) -> None:
    lib.fd_decode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_float, ctypes.c_void_p,
                              ctypes.c_void_p]
    lib.fd_decode.restype = ctypes.c_int
    lib.fd_error_string.argtypes = [ctypes.c_int]
    lib.fd_error_string.restype = ctypes.c_char_p


def job(cache_dtype=torch.bfloat16) -> build.Job:
    """The build job of the kernel's library for caches of
    ``cache_dtype``: one library a cache type (``FD_CACHE``), so the
    three build in parallel."""
    return build.Job(f"#define FD_CACHE {_DTYPES[cache_dtype]}\n"
                     + SOURCE.read_text(), (), CSRC, _bind)


def jobs() -> list[build.Job]:
    """The build jobs of every cache type's library."""
    return [job(dt) for dt in _DTYPES]


def library(cache_dtype=torch.bfloat16) -> ctypes.CDLL:
    """The kernel's library for caches of ``cache_dtype``, built on first
    use."""
    if cache_dtype not in _LIB:
        _LIB[cache_dtype] = build.build([job(cache_dtype)])[0][0]
    return _LIB[cache_dtype]


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


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (read once per device)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def n_splits(B: int, KVH: int, S: int, sms: int = SMS) -> int:
    """Split blocks per (batch, KV head): enough for about two blocks on
    each of ``sms`` SMs, at most one per ``PIECE`` cache positions."""
    return max(1, min(-(-2 * sms // max(B * KVH, 1)), -(-S // PIECE)))


class Launch(NamedTuple):
    """What one launch of the kernel pair did: the split and combine
    blocks it launched, and ``keys``, the (B, KVH, nsplit) int32 tensor
    of the keys each split block held, which the split kernel writes."""
    split_blocks: int
    combine_blocks: int
    keys: torch.Tensor

    @property
    def working(self) -> int:
        """The split blocks that held a key (reads ``keys``: on the card
        this waits for the launch)."""
        return int((self.keys > 0).sum())


def launch(lib, q, k_cache, v_cache, lengths, o, part_ml, part_acc, part_n,
           *, window: int | None, scale: float, stream) -> Launch:
    """One launch of the kernel pair writing ``o`` on ``stream`` (a
    ``cudaStream_t`` as an int), with the split count of the partials
    (:func:`buffers`).  Raises when refused (``ValueError`` for cache
    rows that are not 16-byte aligned, which the library checks)."""
    B, H, D = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    nsplit = part_ml.shape[2]
    ints = [_DTYPES[q.dtype], _DTYPES[k_cache.dtype], B, S, H, KVH, D,
            nsplit, window or 0,
            q.stride(0), q.stride(1), o.stride(0), o.stride(1)]
    for t in (k_cache, v_cache):
        ints += [t.stride(0), t.stride(1), t.stride(2)]
    ptrs = (ctypes.c_void_p * 8)(q.data_ptr(), k_cache.data_ptr(),
                                 v_cache.data_ptr(), lengths.data_ptr(),
                                 o.data_ptr(), part_ml.data_ptr(),
                                 part_acc.data_ptr(), part_n.data_ptr())
    grids = (ctypes.c_longlong * 2)()
    rc = lib.fd_decode(ptrs, (ctypes.c_longlong * len(ints))(*ints), scale,
                       stream, grids)
    if rc == -2:
        raise ValueError(f"flash decode: {lib.fd_error_string(rc).decode()}")
    if rc != 0:
        raise RuntimeError(f"flash decode launch failed: "
                           f"{lib.fd_error_string(rc).decode()} ({rc})")
    return Launch(grids[0], grids[1], part_n)


def buffers(q, KVH: int, nsplit: int):
    """The output, the per-split partials (m, l and acc) and the per-split
    key counts of one call with ``nsplit`` splits."""
    B, H, D = q.shape
    return (torch.empty_like(q),
            torch.empty((B, H, nsplit, 2), dtype=torch.float32,
                        device=q.device),
            torch.empty((B, H, nsplit, D), dtype=torch.float32,
                        device=q.device),
            torch.empty((B, KVH, nsplit), dtype=torch.int32,
                        device=q.device))


def prepare(q, k_cache, v_cache, lengths, *, window: int | None,
            scale: float):
    """Check a call on CUDA tensors and allocate its output and partials.
    Returns ``(o, run)``: ``run()`` launches the kernel pair once on the
    current stream, writing ``o``, and returns its :class:`Launch`.
    Raises on anything the kernel does not take.  :func:`flash_decode`
    launches through it; a timing loop may call ``run`` alone."""
    _check(q, k_cache, v_cache, lengths, window)
    tensors = (q, k_cache, v_cache, lengths)
    if not (q.device.type == "cuda"
            and all(t.device == q.device for t in tensors)):
        raise ValueError(f"flash decode takes its tensors on one CUDA device "
                         f"(or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES:
        raise ValueError(f"flash decode builds for float32, bfloat16 and "
                         f"float16, not {q.dtype} / {k_cache.dtype}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"flash decode builds for head dims {HEAD_DIMS}, "
                         f"not {q.shape[2]}")
    if q.shape[1] // k_cache.shape[2] > MAX_GROUP:
        raise ValueError(f"flash decode serves at most {MAX_GROUP} query "
                         f"heads per KV head")
    if q.stride(2) != 1 or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("flash decode needs the head dim contiguous")
    lengths = lengths.to(torch.int32).contiguous()
    B, S, KVH = k_cache.shape[:3]
    bufs = buffers(q, KVH, n_splits(B, KVH, S, sm_count(q.device)))
    lib = library(k_cache.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def run() -> Launch:
        with torch.cuda.device(q.device):
            return launch(lib, q, k_cache, v_cache, lengths, *bufs,
                          window=window, scale=scale, stream=stream)

    return bufs[0], run


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 window: int | None = None,
                 scale: float | None = None) -> torch.Tensor:
    """q (B, H, D) one token per sequence; caches (B, S, KVH, D);
    lengths (B,) valid cache lengths, the new token's included."""
    global launches
    refuse_grad("flash decode (K3)", q, k_cache, v_cache)
    _check(q, k_cache, v_cache, lengths, window)
    scale = scale if scale is not None else q.shape[2] ** -0.5
    if all(t.device.type == "cpu" for t in (q, k_cache, v_cache, lengths)):
        return flash_decode_plain(q, k_cache, v_cache, lengths,
                                  window=window, scale=scale)
    o, run = prepare(q, k_cache, v_cache, lengths, window=window, scale=scale)
    run()
    launches += 1
    return o
