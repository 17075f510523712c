"""Sinusoidal embeddings (diffusers ``get_timestep_embedding``), all fp32, as in
sdmatte_tpu/core/embeddings.py."""

from __future__ import annotations

import math

import numpy as np
import torch


def sinusoidal_embedding(t: torch.Tensor, dim: int, *, flip_sin_to_cos: bool = True,
                         downscale_freq_shift: float = 0.0, scale: float = 1.0,
                         max_period: float = 10000.0) -> torch.Tensor:
    """(N,) -> (N, dim)."""
    t = t.float().reshape(-1)
    half = dim // 2
    exponent = -np.float32(math.log(max_period)) * np.arange(half, dtype=np.float32)
    exponent = exponent / np.float32(half - downscale_freq_shift)
    freqs = torch.from_numpy(np.exp(exponent, dtype=np.float32)).to(t.device)
    emb = scale * (t[:, None] * freqs[None, :])
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
