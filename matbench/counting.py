"""Peaks of one H100 and the operations and bytes of the hand kernels' calls.

The arithmetic is a frozen copy of the program's chip check
(``chip_smoke.py``: ``bound`` and the attention and 3x3-conv counts; see
``matbench/README.md`` for the lines and the commit).  Each input byte is
counted read once and each output byte written once.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, flops_rate: float = BF16_FLOPS) -> float:
    """The least time for the work: operations at the peak or bytes at the
    memory's rate, whichever is longer."""
    return max(flops / flops_rate, nbytes / HBM_BYTES_PER_S)


def attention_work(b, h, lq, lk, d, biased, elem=2):
    """q (b,h,lq,d), k and v (b,h,lk,d), o like q; a (b,lk) fp32 bias."""
    flops = 4 * b * h * lq * lk * d
    nbytes = elem * b * h * (2 * lq + 2 * lk) * d + (4 * b * lk if biased else 0)
    return flops, nbytes


def conv3x3_work(b, h, w, cin, cout, gn, res, elem=2):
    """A stride-1 3x3 conv on (b,cin,h,w) -> (b,cout,h,w), with the
    GroupNorm-affine prologue's (b,cin) fp32 pair and a residual read."""
    flops = 2 * b * h * w * cout * 9 * cin
    nbytes = elem * (b * h * w * (cin + cout * (2 if res else 1)) + 9 * cin * cout) \
        + 4 * cout + (8 * b * cin if gn else 0)
    return flops, nbytes
