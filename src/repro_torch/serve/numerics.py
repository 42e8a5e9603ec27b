"""How far two correct float32 paths of the SSM models drift apart, on
the CPU; the numbers behind ``chip_smoke.py``'s SSM tolerances.

Run from the repository root::

    PYTHONPATH=src python -m repro_torch.serve.numerics    # ~1-2 min

It prints three measurements, all in float32 with random weights from
seed 0 at full width:

1. *depth*: mamba2-130m cut to 1, 2, 4, 8, 16 and 24 layers, B=2 and
   31 tokens: the largest relative L2 distance, over the positions,
   between token-by-token decode and the forward pass, and between the
   per-token SSD recurrence (``"reference"``) and the chunked scan
   (``"chunked"``);
2. *spread*: the last-position logits of mamba2-130m (24 layers, 512
   tokens) and zamba2-2.7b (12 layers, 256 tokens) under
   ``"reference"`` against ``"chunked"``, and under chunks of 64
   against 256;
3. *conditioning*: the SSD inputs of mamba2-130m's layers 0, 5 and 17
   at 2048 tokens (B=1), each through ``ssd_scan`` (K4's plain version)
   against the same recurrence in float64: the largest error over the
   output's RMS, the relative L2 error, and the count of elements past
   ``1e-4 + 1e-3 |y|``.
"""
from __future__ import annotations

import torch

from ..configs import ARCHS
from ..kernels.ssd import kernel as k4
from ..kernels.ssd import ssd_scan
from ..models import decode_step, forward, init_caches, init_params
from .bench import rel_l2


def _model(arch: str, layers: int, impl: str = "chunked"):
    cfg = ARCHS[arch].replace(attn_impl=impl, n_layers=layers,
                              dtype="float32")
    gen = torch.Generator().manual_seed(0)
    return cfg, init_params(gen, cfg, device="cpu"), gen


def depth() -> None:
    for layers in (1, 2, 4, 8, 16, 24):
        cfg, p, gen = _model("mamba2-130m", layers)
        tokens = torch.randint(0, cfg.vocab, (2, 31), generator=gen)
        fwd = forward(p, {"tokens": tokens}, cfg)["logits"]
        naive = forward(p, {"tokens": tokens},
                        cfg.replace(attn_impl="reference"))["logits"]
        caches = init_caches(cfg, 2, 64, cache_dtype=torch.float32,
                             device="cpu")
        lengths = torch.zeros((2,), dtype=torch.int32)
        steps = []
        for t in range(tokens.shape[1]):
            lengths = lengths + 1
            steps.append(decode_step(p, tokens[:, t], caches, lengths, cfg))
        dec = torch.stack(steps, dim=1)
        n = tokens.shape[1]
        print(f"depth {layers:2d}: decode vs forward "
              f"{max(rel_l2(dec[:, t], fwd[:, t]) for t in range(n)):.3e}  "
              f"reference vs chunked "
              f"{max(rel_l2(naive[:, t], fwd[:, t]) for t in range(n)):.3e}",
              flush=True)


def spread() -> None:
    for arch, layers, S in (("mamba2-130m", 24, 512),
                            ("zamba2-2.7b", 12, 256)):
        cfg, p, gen = _model(arch, layers)
        batch = {"tokens": torch.randint(0, cfg.vocab, (1, S), generator=gen)}

        def last(c):
            return forward(p, batch, c, last_only=True)["logits"]

        base = last(cfg)
        print(f"spread {arch} {layers} layers S={S}: reference vs chunked "
              f"{rel_l2(last(cfg.replace(attn_impl='reference')), base):.3e}"
              f"  chunk 64 vs 256 "
              f"{rel_l2(last(cfg.replace(ssd_chunk=64)), base):.3e}",
              flush=True)


def _recurrence64(x, dt, A, Bm, Cm, D) -> torch.Tensor:
    """The per-token SSD recurrence in float64."""
    x, dt, A, Bm, Cm, D = (t.double() for t in (x, dt, A, Bm, Cm, D))
    Bsz, S, H, P = x.shape
    state = torch.zeros((Bsz, H, Bm.shape[-1], P), dtype=torch.float64)
    ys = []
    for t in range(S):
        d = dt[:, t]
        state = (torch.exp(d * A)[..., None, None] * state
                 + d[..., None, None] * Bm[:, t][:, None, :, None]
                 * x[:, t][:, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], state)
                  + D[None, :, None] * x[:, t])
    return torch.stack(ys, dim=1)


def conditioning() -> None:
    cfg, p, gen = _model("mamba2-130m", 24, "pallas")
    tokens = torch.randint(0, cfg.vocab, (1, 2048), generator=gen)
    calls = []
    real = k4.ssd_kernel

    def recording(*args, **kw):  # CPU tensors: the plain version runs
        calls.append(args)
        return real(*args, **kw)

    k4.ssd_kernel = recording
    try:
        forward(p, {"tokens": tokens}, cfg, last_only=True)
    finally:
        k4.ssd_kernel = real
    for layer in (0, 5, 17):
        x, dt, A, Bm, Cm, D = calls[layer]
        exact = _recurrence64(x, dt, A, Bm, Cm, D)
        got = ssd_scan(x, dt, A, Bm, Cm, D, chunk=cfg.ssd_chunk).double()
        err = (got - exact).abs()
        rms = float(exact.pow(2).mean().sqrt())
        print(f"conditioning layer {layer:2d}: A min {float(A.min()):.1f}  "
              f"dt max {float(dt.max()):.2f}  RMS(y) {rms:.3f}  "
              f"max|y| {float(exact.abs().max()):.1f}  max err / RMS "
              f"{float(err.max()) / rms:.3e}  rel L2 "
              f"{float(err.norm() / exact.norm()):.3e}  past 1e-4 + "
              f"1e-3|y|: {int((err > 1e-4 + 1e-3 * exact.abs()).sum())} of "
              f"{err.numel()}", flush=True)


def main() -> None:
    depth()
    spread()
    conditioning()


if __name__ == "__main__":
    main()
