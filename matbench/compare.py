"""How an answer is judged.

``gap_ratio``: the answer's gap from the fp32 reference, in units of the gap
that the reference itself opens when computed in the configuration's
precision (bf16 products with fp32 accumulation, norms and softmax in fp32:
``torch.autocast``), over every value the call returned (alpha and matted
output)::

    sum |answer - ref_fp32| / sum |ref_bf16 - ref_fp32|

A sound bf16 program reads about 1 on every seed; how far rounding moves
the outputs differs from one set of random weights to the next by about
four times, and the ratio cancels that.  An answer that never came, or came
in the wrong shape, is read as all zeros.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

LIMITS_DIR = Path(__file__).resolve().parent / "limits"


def gap_ratio(got, ref, ref_low) -> float:
    """got, ref, ref_low: (alpha, matted) tensors (got may be None)."""
    gap = scale = 0.0
    for i, (r, low) in enumerate(zip(ref, ref_low)):
        r = r.double()
        g = None if got is None else torch.as_tensor(got[i])
        if g is None or tuple(g.shape) != tuple(r.shape):
            g = torch.zeros_like(r)
        gap += float((g.to(r.device).double() - r).abs().sum())
        scale += float((low.to(r.device).double() - r).abs().sum())
    if scale == 0.0:
        return 0.0 if gap == 0.0 else float("inf")
    return gap / scale


def limits(workload: str) -> dict:
    """{number: limit} of a cell, from ``matbench/limits/<workload>.json``."""
    with open(LIMITS_DIR / f"{workload}.json") as f:
        return {k: float(v["limit"]) for k, v in json.load(f)["numbers"].items()}
