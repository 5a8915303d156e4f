"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE, computed
in f32."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D] rotated by angles [B, S, D/2]."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # [D/2]
    return _rotate(x, positions.float()[..., None] * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: tuple[int, ...],
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: [B, S, H, D]; positions3: [3, B, S] (temporal, height and width ids,
    each equal to the text position for a text token).  The D/2 frequency
    channels are cut into ``sections`` (t, h, w); each section's angles take
    the matching position stream."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # [D/2]
    angles = positions3.float()[..., None] * freqs             # [3, B, S, D/2]
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(angles[i, :, :, start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))
