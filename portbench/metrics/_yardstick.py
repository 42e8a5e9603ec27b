"""The yardstick: the card's peaks and what one example of a
configuration costs at least.  A frozen copy, kept with the benchmark, so
that a later change to the program cannot move it.

Peaks are NVIDIA's data-sheet rates for each card the cells run on
(dense, no sparsity), keyed on the whole name that
``torch.cuda.get_device_name()`` gives; they assume the card's full power
limit, which the traced runs print beside them (``device.power_limit``).
Another card reads no roofline until its row is added.
"""
from __future__ import annotations

import math

#: card name -> (HBM bytes/s, float32 FLOP/s outside the tensor cores).
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}

ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def peaks(device_name: str):
    """(HBM bytes/s, float32 FLOP/s) of the card, or None if unknown."""
    return PEAKS.get(device_name)


def shape(dims, sizes: dict) -> tuple:
    return tuple(sizes[d] for d in dims)


def points(config: dict, sizes: dict) -> int:
    """Output grid points one example writes: each goal's region,
    unpadded (``[lo, n + hi)`` per dim)."""
    total = 0
    for out in config["outputs"].values():
        total += math.prod(sizes[d] + hi - lo
                           for d, (lo, hi) in out["region"].items())
    return total


def bytes_moved(config: dict, sizes: dict) -> int:
    """Bytes one example must move: each input array read once and each
    output array written once, at its full shape, in the configuration's
    dtype."""
    n = sum(math.prod(shape(a["dims"], sizes))
            for a in config["inputs"].values())
    n += sum(math.prod(shape(o["dims"], sizes))
             for o in config["outputs"].values())
    return n * ITEMSIZE[config["dtype"]]


class Tally:
    """A scalar stand-in that counts each arithmetic operation and
    comparison done on it; a selection (``where``) costs nothing."""

    def __init__(self, box: list):
        self.box = box

    def _op(self, *_):
        self.box[0] += 1
        return Tally(self.box)

    __add__ = __radd__ = __sub__ = __rsub__ = _op
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _op
    __gt__ = __lt__ = __ge__ = __le__ = __neg__ = _op

    def select(self, a, b):
        return Tally(self.box)


def flops_per_point(bodies: dict) -> int:
    """Operations of one evaluation of every kernel body, counted by
    running each body on :class:`Tally` scalars."""
    total = 0
    for fn in bodies.values():
        box = [0]
        nargs = fn.__code__.co_argcount
        fn(*(Tally(box) for _ in range(nargs)))
        total += box[0]
    return total


def least_seconds(config: dict, sizes: dict, flops_point: int,
                  device_name: str):
    """The least time the card needs for one example: the larger of its
    bytes at the HBM rate and its operations at the float32 rate; None on
    a card the table does not know."""
    pk = peaks(device_name)
    if pk is None:
        return None
    hbm, fp32 = pk
    return max(bytes_moved(config, sizes) / hbm,
               flops_point * points(config, sizes) / fp32)
