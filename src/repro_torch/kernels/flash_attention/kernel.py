"""Flash attention forward on Hopper: K2 of the port.

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py:flash_attention_fwd``.
The CUDA C++ source is ``csrc/flash_attention.cu`` (its header comment
gives the design and what bounds it): bf16 and float16 inputs go to a
tensor-core kernel (``mma.sync``, P split in three bf16 or two float16
terms so that P V keeps the float32 function's accuracy), float32 inputs
to a scalar float32 kernel.
It is built with ``nvcc`` for ``sm_90a`` at first use
(:mod:`repro_torch.kernels.build`), loaded with ``ctypes`` and launched
on PyTorch's current stream.  The tensor-core kernel copies rows with
16-byte ``cp.async``: q, k, v and o must have 16-byte aligned bases and
(batch, seq, head) strides, or the wrapper raises.

:func:`flash_attention_fwd` launches the kernel for CUDA tensors and
raises on anything it does not take; for CPU tensors it runs
:func:`flash_attention_plain`, the same function as a plain float32
masked softmax with the kernel's sentinels.  :data:`launches` counts the
kernel launches it made.

Sentinels: masked scores are ``NEG_INF = -1e30``, not ``-inf`` (with
``-inf`` a fully masked tile would give ``exp(-inf - -inf) = NaN``), and
the softmax denominator is clamped at ``1e-30``.  A row with no unmasked
key is the one case where the kernel (which skips fully masked tiles)
and the plain version differ; the model never makes one.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import build
from .._grad import refuse_grad

NEG_INF = -1e30
#: Head dims the kernel is built for.
HEAD_DIMS = (16, 32, 64, 80, 128)
CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1,
           torch.float16: 2}

#: Kernel launches made by :func:`flash_attention_fwd`.
launches = 0
_LIB: list[ctypes.CDLL] = []


def _bind(lib: ctypes.CDLL) -> None:
    lib.fa_forward.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_float, ctypes.c_void_p,
                               ctypes.c_void_p]
    lib.fa_forward.restype = ctypes.c_int
    lib.fa_error_string.argtypes = [ctypes.c_int]
    lib.fa_error_string.restype = ctypes.c_char_p


def job() -> build.Job:
    """The build job of the kernel's library."""
    return build.Job(SOURCE.read_text(), (), CSRC, _bind)


def library() -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    if not _LIB:
        _LIB.append(build.build([job()])[0][0])
    return _LIB[0]


def _check(q, k, v, window) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, Sq, H, D) and k, v (B, Skv, KVH, D): got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"batch or head dim of k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads do not group over "
                         f"{k.shape[2]} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def flash_attention_plain(q, k, v, *, causal: bool, window: int | None,
                          q_offset: int, scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 scores, masked
    with the finite sentinel, softmax with the clamped denominator,
    output in q's dtype."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    group = H // KVH
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1).clamp_min(1e-30)  # (B, H, Sq)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.transpose(1, 2)[..., None]
    return o.to(q.dtype)


def launch(lib, q, k, v, o, *, causal: bool, window: int | None,
           q_offset: int, scale: float, stream) -> int:
    """One launch of the kernel writing ``o`` on ``stream`` (a
    ``cudaStream_t`` as an int).  Returns the blocks it launched; raises
    when refused (``ValueError`` for bf16 or float16 rows that are not
    16-byte aligned, which the library checks)."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    ints = [_DTYPES[q.dtype], B, Sq, Skv, H, KVH, D]
    for t in (q, k, v, o):
        ints += [t.stride(0), t.stride(1), t.stride(2)]
    ints += [int(causal), window or 0, q_offset]
    ptrs = (ctypes.c_void_p * 4)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr())
    grids = (ctypes.c_longlong * 1)()
    rc = lib.fa_forward(ptrs, (ctypes.c_longlong * len(ints))(*ints),
                        scale, stream, grids)
    if rc == -2:
        raise ValueError(f"flash attention: {lib.fa_error_string(rc).decode()}")
    if rc != 0:
        raise RuntimeError(f"flash attention launch failed: "
                           f"{lib.fa_error_string(rc).decode()} ({rc})")
    return grids[0]


def prepare(q, k, v, *, causal: bool, window: int | None, q_offset: int,
            scale: float):
    """Check a call on CUDA tensors and allocate its output.  Returns
    ``(o, run)``: ``run()`` launches the kernel once on the current
    stream, writing ``o``, and returns the blocks it launched.  Raises on
    anything the kernel does not take.  :func:`flash_attention_fwd`
    launches through it; a timing loop may call ``run`` alone."""
    _check(q, k, v, window)
    if not (q.device.type == "cuda" and q.device == k.device == v.device):
        raise ValueError(f"flash attention takes q, k, v on one CUDA device "
                         f"(or all on the CPU), got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention builds for float32, bfloat16 "
                         f"and float16, not {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash attention builds for head dims {HEAD_DIMS}, "
                         f"not {q.shape[3]}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash attention needs the head dim contiguous")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = library()
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def run() -> int:
        with torch.cuda.device(q.device):
            return launch(lib, q, k, v, o, causal=causal, window=window,
                          q_offset=q_offset, scale=scale, stream=stream)

    return o, run


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, window: int | None = None,
                        q_offset: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """GQA attention forward: q (B, Sq, H, D), k and v (B, Skv, KVH, D),
    float32, bf16 or float16; returns (B, Sq, H, D) in q's dtype.
    ``q_offset`` is the position of q[0] on the kv axis (default
    ``Skv - Sq``)."""
    global launches
    refuse_grad("flash attention (K2)", q, k, v)
    _check(q, k, v, window)
    scale = scale if scale is not None else q.shape[3] ** -0.5
    q_off = q_offset if q_offset is not None else k.shape[1] - q.shape[1]
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_off, scale=scale)
    o, run = prepare(q, k, v, causal=causal, window=window, q_offset=q_off,
                     scale=scale)
    run()
    launches += 1
    return o
