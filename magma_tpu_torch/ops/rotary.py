"""Rotary position embeddings, GPT-J style (rotate-every-two).

Port of ``magma_tpu/ops/rotary.py``: rotary over the first ``rotary_dim``
dims of each head with the interleaved-pair convention of
mesh-transformer-jax, not NeoX's half rotation.
"""

from __future__ import annotations

import torch


def rotary_sincos(positions: torch.Tensor, rotary_dim: int, base: float = 10000.0):
    """sin/cos tables for integer ``positions`` (...,).  Returns (sin, cos),
    each positions.shape + (rotary_dim // 2,), float32, computed from
    float32 positions exactly as the JAX package does."""
    half = rotary_dim // 2
    freq_exponents = (
        torch.arange(half, dtype=torch.float32, device=positions.device) / float(half)
    )
    inv_freq = 1.0 / (base ** freq_exponents)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.sin(angles), torch.cos(angles)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, rotary_dim: int):
    """Rotate-every-two over the first ``rotary_dim`` dims of x (b, s, h, hd).

    sin/cos: (s, rotary_dim//2) or (b, s, rotary_dim//2).
    out[2i]   = x[2i] * cos_i - x[2i+1] * sin_i
    out[2i+1] = x[2i+1] * cos_i + x[2i] * sin_i
    """
    b, s, h, _ = x.shape
    xr = x[..., :rotary_dim].reshape(b, s, h, rotary_dim // 2, 2)
    x1, x2 = xr[..., 0], xr[..., 1]
    while sin.dim() < 3:
        sin, cos = sin[None], cos[None]
    sin = sin[:, :, None, :].to(x.dtype)
    cos = cos[:, :, None, :].to(x.dtype)
    out_rot = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out_rot.reshape(b, s, h, rotary_dim), x[..., rotary_dim:]], dim=-1)
