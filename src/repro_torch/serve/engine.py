"""Serving steps: prefill (cache build, last-token logits) and decode
(one token per sequence against the cache); the port of
``repro.serve.engine``.

Prefill returns logits for the last position only.  Decode follows
vLLM-style semantics: lengths include the new token, and the KV write
lands at ``lengths - 1`` before attending -- in place, into the caches
the caller passes.

The entry points run on ``device``: the current CUDA device unless the
caller passes ``device="cpu"``; without CUDA and without that argument
they raise.  The parameters must already be on that device.  They run
under ``torch.no_grad()`` (not ``inference_mode``: decode writes the
caller's caches in place), so parameters that require grad, such as a
trainer's masters, serve through the forward-only kernels.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.interpreters import resolve_device
from ..models.lm import decode_step as _decode_step
from ..models.lm import forward, init_caches, require_ported


def _require_on(params: dict, dev: torch.device) -> None:
    have = params["embed"].device
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"the parameters are on {have}, the step runs on "
                         f"{dev}")


def make_prefill_step(cfg: ArchConfig, *, device=None):
    """``prefill_step(params, batch) -> (last-position logits (B, V),
    caches)``: the caches are ``(k, v)`` stacked over the layers (dense,
    vlm, moe) or over the shared block's groups (hybrid), ``((k, v),
    (enc_k, enc_v))`` for encdec (``batch`` then holds ``enc_frames``),
    and ``None`` for the ssm family, as in the reference."""
    require_ported(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        _require_on(params, dev)
        batch = {k: v.to(dev) for k, v in batch.items()}
        out = forward(params, batch, cfg, mode="prefill", last_only=True)
        return out["logits"][:, -1], out["caches"]

    return prefill_step


def make_decode_step(cfg: ArchConfig, *, device=None):
    """``serve_step(params, token, caches, lengths) -> logits (B, V)``;
    writes the new KV entries (and, for the ssm and hybrid families, the
    conv windows and SSM states) into ``caches`` in place; encdec's
    ``cross_k``/``cross_v`` are read, never written."""
    require_ported(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, token, caches, lengths):
        _require_on(params, dev)
        return _decode_step(params, token.to(dev), caches, lengths.to(dev),
                            cfg)

    return serve_step


@torch.no_grad()
def greedy_decode(params: dict, cfg: ArchConfig, prompt, steps: int,
                  max_seq: int, *, cache_dtype: torch.dtype = torch.float32,
                  device=None, on_logits=None) -> torch.Tensor:
    """Sequential greedy decode from ``prompt`` (B, S0): the prompt is fed
    one token at a time through the decode step, then ``steps`` tokens
    are generated; returns them as (B, steps) int32.  ``on_logits``, if
    given, is called with each step's logits (B, V).  As in the
    reference, encdec decodes over zeroed cross-attention caches (no
    encoder run); a caller with encoder K/V drives
    :func:`make_decode_step` over caches it fills."""
    B, S0 = prompt.shape
    if S0 < 1:
        raise ValueError(
            f"greedy_decode needs at least one prompt token per sequence "
            f"(the first generated token is conditioned on the prompt's "
            f"last-position logits), got prompt width {S0}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if S0 + steps - 1 > max_seq:
        raise ValueError(
            f"prompt width {S0} + {steps} decode steps needs sequence "
            f"length {S0 + steps - 1} > max_seq {max_seq}")
    dev = resolve_device(device)
    if steps == 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    prompt = torch.as_tensor(prompt).to(dev)
    caches = init_caches(cfg, B, max_seq, cache_dtype=cache_dtype,
                         device=dev)
    step = make_decode_step(cfg, device=dev)
    lengths = torch.zeros((B,), dtype=torch.int32, device=dev)

    def advance(token):
        nonlocal lengths
        lengths = lengths + 1
        logits = step(params, token, caches, lengths)
        if on_logits is not None:
            on_logits(logits)
        return logits

    for t in range(S0):  # the prompt, one token at a time
        logits = advance(prompt[:, t])
    tok = logits.argmax(-1).to(torch.int32)
    tokens = [tok]
    for _ in range(steps - 1):
        tok = advance(tok).argmax(-1).to(torch.int32)
        tokens.append(tok)
    return torch.stack(tokens, dim=1)
