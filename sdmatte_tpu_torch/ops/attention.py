"""The attention sites' inputs (sdmatte_tpu/ops/attention.py).

Every attention site calls ``ops/flash_attention.flash_attention``, whose
bias is a per-key vector (B, Lk) broadcast over queries and heads, or
decomposed relative-position terms (``RelPos``: ViTMatte's blocks, made by
:func:`relpos_terms`).  On a CUDA tensor every site takes a hand kernel (K1
for d <= 128, K2 for d = 512): the JAX package's ``_FLASH_MIN_SEQ``
threshold is a TPU launch-cost rule, so the port has none.  Where
``ops/dispatch.plain_here`` says so the plain version runs.
"""

from __future__ import annotations

import torch

from .flash_attention import RelPos


def relpos_terms(q, table_h, table_w) -> RelPos:
    """The decomposed relative-position terms of self-attention over a
    (gh, gw) token grid, row-major (MViTv2's, as ViTDet adds them): q
    (B,H,gh*gw,D) unscaled, table_h (gh, gh, D) and table_w (gw, gw, D) the
    tables indexed [query row, key row] and [query column, key column].

    ``rh[q, i] = q . table_h[row(q), i]`` and ``rw[q, j] = q . table_w[col(q),
    j]``: two batched products in q's dtype (bf16 on the card, their own
    values, nothing rounded again), written into rows padded to a multiple of
    8 values, the 16-byte row stride K1's TMA loads need."""
    b, h, n, d = q.shape
    gh, gw = table_h.shape[0], table_w.shape[0]
    grid = q.reshape(b, h, gh, gw, d)
    rh, rw = (torch.empty((b * h, n, -(-k // 8) * 8), dtype=q.dtype, device=q.device)[..., :k]
              for k in (gh, gw))
    rh.view(b, h, gh, gw, gh).copy_(torch.einsum("bhywc,ykc->bhywk", grid, table_h.to(q.dtype)))
    rw.view(b, h, gh, gw, gw).copy_(torch.einsum("bhywc,wkc->bhywk", grid, table_w.to(q.dtype)))
    return RelPos(rh, rw, gw)
