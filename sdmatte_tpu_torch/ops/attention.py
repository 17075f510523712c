"""Attention front end: one interface for every attention site
(sdmatte_tpu/ops/attention.py).

The bias is a per-key vector (B, Lk) broadcast over queries and heads.  On a
CUDA tensor every site takes a hand kernel (K1 for d <= 128, K2 for d = 512):
the JAX package's ``_FLASH_MIN_SEQ`` threshold is a TPU launch-cost rule, so
the port has none.  On a CPU tensor the plain version runs.
"""

from __future__ import annotations

from .flash_attention import attention_plain, flash_attention


def attention(q, k, v, *, scale: float, bias=None, impl: str = "auto"):
    """q (B,H,Lq,D), k/v (B,H,Lk,D), bias (B,Lk) or None -> (B,H,Lq,D).

    impl: "auto" (the kernel on the card, the plain version on the CPU) or
    "plain" (the plain version everywhere, for checking the kernels)."""
    if impl == "plain":
        return attention_plain(q, k, v, scale=scale, bias=bias)
    if impl != "auto":
        raise ValueError(f"unknown attention impl {impl!r}")
    return flash_attention(q, k, v, scale=scale, bias=bias)
