"""Top-k mixture of experts with per-sequence sort-based dispatch (the
port of ``repro.models.moe``).

Tokens are routed within each sequence: a stable sort of the (token,
slot) pairs by expert, each expert keeping its first ``C`` in token
order (``capacity``); the rest go to one trash slot and contribute
nothing.  The expert products are batched matrix products over
``(B, E, C, d)``.  The auxiliary load-balance loss is Switch
Transformer's.

The router's top k breaks ties by the lower expert index, as
``jax.lax.top_k`` does (a zero router picks experts ``0 .. K-1``).  The
scatter-adds (``.at[].add`` in the reference) are ``index_add_`` over
flattened rows: on the card they are atomics, so a bf16 run is not
bit-repeatable where a token sums its K expert outputs.  (The
deterministic ``index_put_(accumulate=True)`` sorts its indices first:
it took 335 of granite-moe-3b-a800m's 494 ms prefill on an H100.)
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from ..distributed.ctx import local_rows
from .common import dense_init, silu


def moe_init(gen: torch.Generator, cfg: ArchConfig, *, device=None) -> dict:
    m = cfg.moe
    d = cfg.d_model
    E, f = m.n_experts, m.d_ff_expert

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * scale

    return {
        "router": dense_init(gen, d, E, device=device),
        "w_gate": normal(E, d, f, scale=1.0 / math.sqrt(d)),
        "w_up": normal(E, d, f, scale=1.0 / math.sqrt(d)),
        "w_down": normal(E, f, d, scale=1.0 / math.sqrt(f)),
    }


def capacity(seq: int, cfg: ArchConfig) -> int:
    """Slots per expert and sequence: ``ceil(seq K / E x factor)``,
    between 4 and ``seq K``."""
    m = cfg.moe
    c = int(math.ceil(seq * m.top_k / m.n_experts * m.capacity_factor))
    return max(4, min(c, seq * m.top_k))


def route(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """The router: ``(probs (B, S, E), gate_w (B, S, K), gate_i (B, S,
    K))``, float32 probabilities from logits in ``x``'s dtype, the top K
    in descending order with ties to the lower index, their weights
    renormalised."""
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.moe.top_k
    gate_w, gate_i = top[..., :K], idx[..., :K]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, gate_i


def moe_ffn(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, S, d) -> (y (B, S, d), aux float32 scalar).  Routing,
    dispatch and combine work within each sequence, so under a mesh they
    run on each rank's own sequences (``local_rows``: DTensor has no
    sharding rules for their sorts and scatter-adds); the expert
    products between them are DTensor ops laid out by the expert
    weights, so the model axis splits them.  The load-balance loss then
    averages over the whole batch."""
    B, S, _ = x.shape
    E = cfg.moe.n_experts
    h, probs, first, dest, tok, w = local_rows(
        lambda p, x: _dispatch(p, x, cfg), {"router": p["router"]}, x)
    y = _experts(p, h)
    (out,) = local_rows(lambda _, *a: (_combine(*a, S),), {}, y, dest,
                         tok, w)
    # Switch-style load-balance auxiliary loss
    me = probs.mean(dim=(0, 1))
    ce = first.sum(0) / (B * S)
    aux = E * (me * ce).sum()
    return out, aux


def _dispatch(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """``(h (B, E, C, d), probs (B, S, E), first (B, E), dest, tok,
    weight)``: each expert's first ``C`` tokens of each sequence (zeros
    in free slots), the router's probabilities, each sequence's count of
    first choices of each expert (float32), and for each sorted (token,
    slot) pair (B, S K) its slot in ``h``, its source token and its
    combine weight (zero where dropped)."""
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.n_experts, m.top_k
    C = capacity(S, cfg)
    dev = x.device

    probs, gate_w, gate_i = route(p, x, cfg)
    first = torch.zeros((B, E), device=dev).scatter_add_(
        1, gate_i[..., 0], torch.ones((B, S), device=dev))

    # per-sequence sort-based dispatch
    flat_e = gate_i.reshape(B, S * K)  # expert of each (token, slot)
    flat_w = gate_w.reshape(B, S * K)
    sorted_e, order = torch.sort(flat_e, dim=1, stable=True)
    sorted_w = flat_w.gather(1, order)
    tok = order // K  # source token of each sorted slot
    counts = torch.zeros((B, E), dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    offs = counts.cumsum(1) - counts  # exclusive
    pos = torch.arange(S * K, device=dev)[None, :] - offs.gather(1, sorted_e)
    keep = pos < C
    dest = sorted_e * C + pos.clamp(0, C - 1)  # (B, S K) in [0, E C)

    xs = x.gather(1, tok[..., None].expand(B, S * K, d))
    xs = torch.where(keep[..., None], xs, torch.zeros((), dtype=x.dtype,
                                                      device=dev))
    # slots laid out (E, B, C), the expert products' batch order; one
    # trash slot after them all absorbs the dropped tokens
    bidx = torch.arange(B, device=dev)[:, None]
    slot = (sorted_e * B + bidx) * C + pos.clamp(0, C - 1)
    buf = torch.zeros((E * B * C + 1, d), dtype=x.dtype, device=dev)
    buf.index_add_(0, torch.where(keep, slot, E * B * C).reshape(-1),
                   xs.reshape(B * S * K, d))
    h = buf[:E * B * C].view(E, B, C, d).transpose(0, 1)
    return h, probs, first, dest, tok, (sorted_w * keep).to(x.dtype)


def _experts(p: dict, h: torch.Tensor) -> torch.Tensor:
    """The experts' gated FFN over their slots, (B, E, C, d) -> (B, E,
    C, d), computed expert-major: each product is one batched matrix
    product over (E, B C), whose rows merge without a copy (DTensor,
    2.13, fails to copy-merge them from a sharded view)."""
    h = h.transpose(0, 1)
    g = silu(torch.einsum("ebcd,edf->ebcf", h, p["w_gate"].to(h.dtype)))
    u = torch.einsum("ebcd,edf->ebcf", h, p["w_up"].to(h.dtype))
    y = torch.einsum("ebcf,efd->ebcd", g * u, p["w_down"].to(h.dtype))
    return y.transpose(0, 1)


def _combine(y: torch.Tensor, dest: torch.Tensor, tok: torch.Tensor,
             weight: torch.Tensor, S: int) -> torch.Tensor:
    """Each of the ``S`` tokens' weighted sum of its experts' outputs:
    ``y`` (B, E, C, d) read at ``dest`` (B, S K), scaled by ``weight``
    and summed into token ``tok``; (B, S, d)."""
    B, E, C, d = y.shape
    SK = tok.shape[1]
    gathered = y.reshape(B, E * C, d).gather(
        1, dest[..., None].expand(B, SK, d))
    contrib = gathered * weight[..., None]
    out = torch.zeros((B * S, d), dtype=y.dtype, device=y.device)
    bidx = torch.arange(B, device=y.device)[:, None]
    out.index_add_(0, (bidx * S + tok).reshape(-1),
                   contrib.reshape(B * SK, d))
    return out.reshape(B, S, d)
