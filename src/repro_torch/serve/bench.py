"""Measuring the LM serving path and its kernels on the card.

The work and the bytes each attention or SSD call must do, counted from
its inputs (each input read once, each output written once; for decode
only the valid part of the caches), the card's peak rates by name
(:mod:`repro_torch.cards`), the device's share of a step by
``torch.profiler``, and :func:`checked`, which holds every call of a
kernel wrapper against its plain version while a model runs.  ``chip_smoke.py`` uses them; timing itself uses the
CUDA-event helpers of :mod:`repro_torch.kernels.stencil2d.bench`.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import DeviceType

from ..cards import BF16_PEAK, F32_PEAK, TF32_PEAK, rate


def bf16_peak(name: str) -> float:
    """The card's dense bf16 tensor-core rate."""
    return rate(BF16_PEAK, name)


def f32_peak(name: str) -> float:
    """The card's float32 rate outside the tensor cores."""
    return rate(F32_PEAK, name)


def tf32_peak(name: str) -> float:
    """The card's dense TF32 tensor-core rate."""
    return rate(TF32_PEAK, name)


def attention_pairs(Sq: int, Skv: int, *, causal: bool, window, q_offset: int,
                    device) -> int:
    """Unmasked (query, key) pairs of one head."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return int(mask.sum())


def attention_work(q, k, v, *, causal: bool, window, q_offset: int):
    """(flops, bytes) of one flash attention call: 4 D flops per
    unmasked pair and head (Q K^T and P V), q, k, v read and o
    written once."""
    B, Sq, H, D = q.shape
    pairs = attention_pairs(Sq, k.shape[1], causal=causal, window=window,
                            q_offset=q_offset, device=q.device)
    flops = 4 * D * pairs * B * H
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    return flops, nbytes


def decode_work(q, k_cache, v_cache, lengths, *, window):
    """(flops, bytes) of one flash decode call: the valid cache
    positions of each sequence (its length, less those outside the
    window) read once from K and V, q and lengths read and o written."""
    B, H, D = q.shape
    KVH = k_cache.shape[2]
    valid = lengths.long()
    if window is not None:
        valid = valid.clamp_max(window)
    n = int(valid.sum())
    flops = 4 * D * n * H
    row = KVH * D * k_cache.element_size()
    nbytes = (2 * n * row + 2 * q.numel() * q.element_size()
              + lengths.numel() * lengths.element_size())
    return flops, nbytes


def ssd_work(x, dt, Bm, Cm, D, L: int):
    """(flops, bytes) of one SSD scan with chunks of ``L`` tokens: per
    (batch, head, chunk) the causal half of C B^T and of M x (2 (N + P)
    flops per pair u <= t), and, for every chunk but the first, the
    rolled-in state C S and the state update B^T X (2 N P L flops each;
    the first chunk's state is zero, the last chunk's update is not an
    output).  x, dt, Bm, Cm, A, D read once and y written once."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // L
    pairs = L * (L + 1) // 2
    flops = Bsz * H * (nc * pairs * 2 * (N + P) + (nc - 1) * 4 * N * P * L)
    nbytes = (2 * x.numel() * x.element_size()
              + sum(t.numel() * t.element_size() for t in (dt, Bm, Cm))
              + 2 * D.numel() * 4)
    return flops, nbytes


def ssd_scratch_bytes(x, N: int, L: int) -> int:
    """Bytes of float32 scratch the split kernel moves between its
    passes (not an input or output of the function): each chunk's state
    written by its first pass, read and rewritten by the second, and read
    by the last for every chunk but the first; each 64 x 64 Gram tile
    C_t B_u^T written once and read by every head."""
    Bsz, S, H, P = x.shape
    nc, n = S // L, -(-L // 64)
    gram = Bsz * nc * n * (n + 1) // 2 * 64 * 64
    return 4 * (Bsz * H * N * P * (3 * nc + nc - 1) + gram * (1 + H))


def bound_ms(flops: float, nbytes: float, flop_rate: float,
             byte_rate: float) -> tuple[float, str]:
    """The least time for the work, and which of the two bounds it."""
    t_ops, t_bytes = flops / flop_rate, nbytes / byte_rate
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| in the L2 norm; |got - want| where ``want``
    is zero (an attention over zeroed caches)."""
    diff, norm = (got.float() - want.float()).norm(), want.float().norm()
    return float(diff / norm if norm > 0 else diff)


def device_share(fn, runs: int = 3):
    """Run ``fn`` ``runs`` times under ``torch.profiler`` (after one
    warm-up run); returns (wall ms per run, device kernel ms per run, the
    six kernels with the most device time as (name, ms per run)).  The
    profiler adds host time to every operator, so the device's busy share
    (device ms / wall ms) it gives is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    # the kernels themselves (operator rows repeat their kernels' time)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / runs
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    return wall_ms, dev_ms, [(e.key[:60], e.self_device_time_total / 1e3
                              / runs) for e in top]


def signature(args: tuple, kw: dict) -> tuple:
    """A call's shape: its tensor arguments' shapes and dtypes, and its
    other arguments as they are."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return tuple(a.shape), str(a.dtype)
        return a
    return (tuple(one(a) for a in args),
            tuple(sorted((k, one(v)) for k, v in kw.items())))


@contextlib.contextmanager
def checked(module, name: str, plain, close):
    """While active, every call of ``module.<name>`` (a kernel wrapper)
    is followed by ``plain`` on the same arguments, and ``close(got,
    want)`` -- which raises past its tolerance -- gives the call's
    errors.  Yields a list that receives, per call, ``(errors, args,
    kwargs, sig)``, ``sig`` its :func:`signature`; only the first call
    of each signature keeps its arguments (the others hold ``None``).
    The plain version launches no kernel, so the wrappers' launch counts
    see only the model's own calls."""
    real = getattr(module, name)
    calls: list = []
    seen: set = set()

    def wrapper(*args, **kw):
        got = real(*args, **kw)
        errs = close(got, plain(*args, **kw))
        sig = signature(args, kw)
        first = sig not in seen
        seen.add(sig)
        calls.append((errs, args, kw, sig) if first
                     else (errs, None, None, sig))
        return got

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)
