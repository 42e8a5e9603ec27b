"""Oracle: the naive per-token SSD recurrence (the port of
``repro.kernels.ssd.ref``), in float32.

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * (B_t ⊗ x_t)
    y_t = C_t · S_t + D_h * x_t

Shapes: x (B, S, H, P), dt (B, S, H) [post-softplus], A (H,)
[negative], B/C (B, S, N) [one state group], D (H,).  A Python loop
over the tokens: small sizes only.
"""
from __future__ import annotations

import torch


def naive_ssd(x, dt, A, Bm, Cm, D):
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    A, D = A.float(), D.float()
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].float(), dt[:, t].float()  # (B, H, P), (B, H)
        bt, ct = Bm[:, t].float(), Cm[:, t].float()  # (B, N)
        a = torch.exp(dtt * A[None, :])
        upd = dtt[..., None, None] * bt[:, None, :, None] * xt[:, :, None, :]
        state = a[..., None, None] * state + upd  # (B, H, N, P)
        ys.append(torch.einsum("bn,bhnp->bhp", ct, state)
                  + D[None, :, None] * xt)
    return torch.stack(ys, dim=1).to(x.dtype)
