"""Sinusoidal embeddings (diffusers ``get_timestep_embedding``), all fp32, as in
sdmatte_tpu/core/embeddings.py."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import tables


def frequencies(half: int, downscale_freq_shift: float, max_period: float) -> np.ndarray:
    """(half,) fp32 exp(-log(max_period) * i / (half - shift))."""
    exponent = -np.float32(math.log(max_period)) * np.arange(half, dtype=np.float32)
    exponent = exponent / np.float32(half - downscale_freq_shift)
    return np.exp(exponent, dtype=np.float32)


def sinusoidal_embedding(t: torch.Tensor, dim: int, *, flip_sin_to_cos: bool = True,
                         downscale_freq_shift: float = 0.0, scale: float = 1.0,
                         max_period: float = 10000.0) -> torch.Tensor:
    """(N,) -> (N, dim)."""
    t = t.float().reshape(-1)
    half = dim // 2
    freqs = tables.on_device(frequencies, t.device, half, float(downscale_freq_shift),
                             float(max_period))
    emb = scale * (t[:, None] * freqs[None, :])
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def point_coords_padding(num_coords: int, total: int = 1680) -> tuple[int, int]:
    """The reference's point-coordinate padding: the smallest length i >= N
    that divides ``total``, and the embedding width ``total // i``.
    Returns (padded_len, embed_channels)."""
    for i in range(num_coords, total + 1):
        if total % i == 0:
            return i, total // i
    raise ValueError(f"no divisor of {total} >= {num_coords}")
