"""The Mamba2 SSD chunked scan in plain PyTorch, and the ``ssd`` front
door (the port of ``repro.kernels.ssd.ops``).

The (N, P) state carried from chunk to chunk is a rolling buffer with a
reuse distance of one chunk; within a chunk everything is dense
products, and the prefix sum of dt is the lower-triangular-ones product
the reference uses.  :func:`ssd_scan` is K4's plain version: the
kernel's wrapper runs it for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernel against it.
"""
from __future__ import annotations

import torch


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk: int = 128) -> torch.Tensor:
    """x (B, S, H, P), dt (B, S, H) post-softplus, A (H,) negative,
    Bm/Cm (B, S, N), D (H,) -> y (B, S, H, P) in x's dtype; all
    arithmetic in float32.  ``S`` must be a multiple of
    ``min(chunk, S)``."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    assert S % L == 0, "pad sequence to the chunk size"
    nc = S // L
    xc = x.reshape(Bsz, nc, L, H, P).float()
    dtc = dt.reshape(Bsz, nc, L, H).float()
    bc = Bm.reshape(Bsz, nc, L, N).float()
    cc = Cm.reshape(Bsz, nc, L, N).float()
    A = A.float()
    tril = torch.tril(torch.ones((L, L), dtype=torch.float32,
                                 device=x.device))  # inclusive prefix sum
    mask = (tril > 0)[None, :, :, None]
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xi, dti, bi, ci = xc[:, c], dtc[:, c], bc[:, c], cc[:, c]
        cs = torch.einsum("ts,bsh->bth", tril, dti)  # inclusive cumsum
        din = torch.exp(A[None, None, :] * cs)  # decay from chunk entry to t
        # pairwise decay exp(A (cs_t - cs_tau)) for tau <= t, 0 above the
        # diagonal; masked before the exp, whose argument overflows there
        # (an inf times the zero cotangent of a where after it would make
        # every gradient NaN, as the reference's scan does)
        seg = cs[:, :, None, :] - cs[:, None, :, :]  # (B, L, L, H)
        decay = torch.exp(torch.where(mask, A * seg, -torch.inf))
        # intra-chunk: M[t, tau] = (C_t . B_tau) decay dt_tau
        cb = torch.einsum("btn,bsn->bts", ci, bi)
        M = cb[..., None] * decay * dti[:, None, :, :]
        y = torch.einsum("btsh,bshp->bthp", M, xi)
        # inter-chunk: C_t . (decay to t * S_prev)
        y = y + torch.einsum("btn,bhnp->bthp", ci, state) * din[..., None]
        # state passing: S' = decay_full * S + B^T diag(w) X
        w = torch.exp(A[None, None, :] * (cs[:, -1:, :] - cs)) * dti
        z = torch.einsum("bsn,bsh,bshp->bhnp", bi, w, xi)
        dfull = torch.exp(A[None, :] * cs[:, -1, :])  # (B, H)
        state = dfull[..., None, None] * state + z
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype)


def ssd(x, dt, A, Bm, Cm, D, *, chunk: int = 128,
        impl: str = "chunked") -> torch.Tensor:
    """The SSD scan by ``impl``: ``"reference"`` (the per-token oracle),
    ``"chunked"`` (:func:`ssd_scan`) or ``"pallas"`` (the reference's
    name for its kernel; here the hand-written CUDA kernel K4, whose
    wrapper runs :func:`ssd_scan` on CPU tensors)."""
    if impl == "reference":
        from .ref import naive_ssd
        return naive_ssd(x, dt, A, Bm, Cm, D)
    if impl == "chunked":
        return ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)
    if impl == "pallas":
        from .kernel import ssd_kernel
        return ssd_kernel(x, dt, A, Bm, Cm, D, chunk=chunk)
    raise ValueError(f"unknown ssd impl {impl!r}")
