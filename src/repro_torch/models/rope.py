"""Rotary position embeddings, including Qwen2-VL's multimodal M-RoPE
(the port of ``repro.models.rope``).

M-RoPE splits the (half) head dimension into sections, each rotated by a
different position component (temporal / height / width); pure-text
runs use identical components."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, device=device).float() / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 1e4,
               mrope_sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (3, B, S) for M-RoPE."""
    D = x.shape[-1]
    half = D // 2
    freqs = rope_freqs(D, theta, x.device)  # (half,)
    if mrope_sections is None:
        if positions.ndim == 3:
            positions = positions[0]
        ang = positions[..., None].float() * freqs  # (B, S, half)
    else:
        if positions.ndim != 3 or sum(mrope_sections) != half:
            raise ValueError(
                f"M-RoPE needs (3, B, S) positions and sections summing to "
                f"{half}, got {tuple(positions.shape)} and {mrope_sections}")
        parts = []
        start = 0
        for comp, sec in enumerate(mrope_sections):
            f = freqs[start:start + sec]
            parts.append(positions[comp][..., None].float() * f)
            start += sec
        ang = torch.cat(parts, dim=-1)  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)
