"""Runtime helpers shared by the port's interpreters and referenced by the
source the fused-source emitter writes.

The port's counterpart of ``repro.core.runtime``.  The emitted code
(:mod:`repro_torch.core.codegen_torch`) works on *rows* — 1-D tensors
over the vectorized (innermost) dimension — streamed through rolling
buffers.  Row positions are Python integers (loop counters of plain
``for`` loops), and the helpers clamp out-of-range starts exactly as
``lax.dynamic_slice`` does, which the emitter exploits to fold the
paper's prologue/epilogue iterations into a steady state predicated by
``if`` statements.  Reads return views; writes go into the buffers in
place, and only when their predicate (a Python bool) holds.
"""
from __future__ import annotations

import torch


def _clip(v: int, hi: int) -> int:
    """``v`` clamped to ``[0, hi]``, as ``lax.dynamic_slice`` clamps a
    start index."""
    return max(0, min(int(v), hi))


def _row(arr, pos, col0: int, width: int):
    idx = tuple(_clip(p, arr.shape[a] - 1) for a, p in enumerate(pos))
    c = _clip(col0, arr.shape[-1] - width)
    return arr[idx + (slice(c, c + width),)]


def _setrow(arr, pos, col0: int, row, valid):
    if valid:
        idx = tuple(_clip(p, arr.shape[a] - 1) for a, p in enumerate(pos))
        c = _clip(col0, arr.shape[-1] - row.shape[0])
        arr[idx + (slice(c, c + row.shape[0]),)] = row
    return arr


def row2(arr, r, col0: int, width: int):
    """Row ``arr[r, col0:col0+width]`` with a clamped start."""
    return _row(arr, (r,), col0, width)


def row3(arr, p, r, col0: int, width: int):
    return _row(arr, (p, r), col0, width)


def row4(arr, q, p, r, col0: int, width: int):
    return _row(arr, (q, p, r), col0, width)


def setrow2(arr, r, col0: int, row, valid):
    """Predicated row write ``arr[r, col0:...] = row`` when ``valid``."""
    return _setrow(arr, (r,), col0, row, valid)


def setrow3(arr, p, r, col0: int, row, valid):
    return _setrow(arr, (p, r), col0, row, valid)


def setrow4(arr, q, p, r, col0: int, row, valid):
    return _setrow(arr, (q, p, r), col0, row, valid)


def brow(buf, stage, col0: int, width: int):
    """A row slice of a rolling buffer at stage ``stage``."""
    return _row(buf, (stage,), col0, width)


def bset(buf, stage, row):
    """Write one row into a rolling-buffer stage (rotation by index
    arithmetic — the analogue of the paper's pointer rotation, Fig.
    9a/9b)."""
    buf[_clip(stage, buf.shape[0] - 1), :row.shape[0]] = row
    return buf


def at(arr, *pos):
    """Element ``arr[pos]`` with every index clamped into range."""
    return arr[tuple(_clip(p, arr.shape[a] - 1) for a, p in enumerate(pos))]


def seat(shape, region, value):
    """A zero tensor of ``shape`` (``value``'s dtype and device) with
    ``value`` written at ``region`` (a tuple of slices)."""
    res = torch.zeros(shape, dtype=value.dtype, device=value.device)
    res[region] = value
    return res


class _Slices:
    """``S[a:b, c:d]`` is the tuple of slices, for :func:`seat`."""

    def __getitem__(self, key):
        return key if isinstance(key, tuple) else (key,)


def lane_reduce(fn, row, ident):
    """Associative lane reduction of a vector partial accumulator
    (the vectorized-reduction epilogue of Section 3.5): log2 halving
    along the leading axis, padding odd halves with the identity.

    ``row`` may carry trailing batch axes (e.g. one partial-accumulator
    row per outer tile, lanes moved to the front): the reduction folds
    axis 0 and returns the remaining shape."""
    n = row.shape[0]
    while n > 1:
        half = (n + 1) // 2
        pad = half * 2 - n
        if pad:
            row = torch.cat([row, torch.full((pad,) + tuple(row.shape[1:]),
                                             ident, dtype=row.dtype,
                                             device=row.device)])
        row = fn(row[:half], row[half:])
        n = half
    return row[0]


NAMESPACE = {
    "torch": torch,
    "_row2": row2,
    "_row3": row3,
    "_row4": row4,
    "_setrow2": setrow2,
    "_setrow3": setrow3,
    "_setrow4": setrow4,
    "_brow": brow,
    "_bset": bset,
    "_at": at,
    "_seat": seat,
    "_S": _Slices(),
    "_lane_reduce": lane_reduce,
}
