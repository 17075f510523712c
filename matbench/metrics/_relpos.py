"""Operations and bytes of K1's relative-position launches (ViTMatte's
blocks), read by ``k1_attn_relpos_roofline``.  Counted as ``counting.py``
counts the hand kernels: each input byte read once, each output byte
written once, and only the work the kernel does on the tensor cores."""

from __future__ import annotations

# rh's position in K1's launch arguments (sdmatte_tpu_torch/ops/flash_attention.py
# RH_ARG), then rw, kh, kw: appended after the others, before the stream
RH = 17


def relpos_attention_work(b, h, lq, lk, d, kh, kw, elem=2):
    """q (b,h,lq,d), k and v (b,h,lk,d), o like q, in bf16; the two fp32
    terms (b*h, lq, kh) and (b*h, lq, kw), each read once.  The terms'
    two adds a score run on the fp32 pipe and are not counted."""
    flops = 4 * b * h * lq * lk * d
    nbytes = elem * b * h * (2 * lq + 2 * lk) * d + 4 * b * h * lq * (kh + kw)
    return flops, nbytes
