"""Runtime helpers shared by the host halves of the port's interpreters.

The port's counterpart of ``repro.core.runtime``.  Only
:func:`lane_reduce` lives here so far; the ``NAMESPACE`` the JAX
package's source emitter binds comes with the port of that emitter.
"""
from __future__ import annotations

import torch


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
