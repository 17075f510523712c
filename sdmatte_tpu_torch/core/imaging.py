"""Image resampling and normalisation (sdmatte_tpu/core/imaging.py).

Separable resampling runs as two small dense matmuls with matrices built once
per (in, out) size pair on the host, in fp32 with the same index and weight
math as torch's antialiased bilinear resize (on NHWC images, as at the
pipeline's public boundary); nearest resize is a gather with torch's
floor(i * in / out) source index (on NCHW model tensors).  Matrices and
indices are kept on the device (core/tables.py), so a resize copies nothing
from the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import tables


@functools.lru_cache(maxsize=None)
def bilinear_aa_matrix(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    """Row-stochastic (out_size, in_size) resampling matrix; with ``antialias``
    and a downscale the triangle filter widens to the scale factor."""
    A = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    if antialias and scale > 1.0:
        support, invscale = scale, 1.0 / scale
    else:
        support, invscale = 1.0, 1.0

    if not antialias and scale > 1.0:
        for i in range(out_size):
            center = scale * (i + 0.5) - 0.5
            x0 = int(np.floor(center))
            frac = center - x0
            A[i, min(max(x0, 0), in_size - 1)] += 1.0 - frac
            A[i, min(max(x0 + 1, 0), in_size - 1)] += frac
        return A.astype(np.float32)

    for i in range(out_size):
        center = scale * (i + 0.5)
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        if xmax <= xmin:
            xmin = min(max(int(center), 0), in_size - 1)
            xmax = xmin + 1
        js = np.arange(xmin, xmax)
        w = np.clip(1.0 - np.abs((js - center + 0.5) * invscale), 0.0, None)
        total = w.sum()
        A[i, xmin:xmax] = np.ones_like(w) / len(w) if total <= 0 else w / total
    return A.astype(np.float32)


@functools.lru_cache(maxsize=None)
def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """torch ``mode='nearest'`` source indices: floor(i * in/out), clamped."""
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int, *,
                    antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) images, fp32 inside, input dtype out."""
    b, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    xf = x.float()
    if h != out_h:
        ah = tables.on_device(bilinear_aa_matrix, x.device, h, out_h, antialias)
        xf = torch.einsum("oh,bhwc->bowc", ah, xf)
    if w != out_w:
        aw = tables.on_device(bilinear_aa_matrix, x.device, w, out_w, antialias)
        xf = torch.einsum("ow,bhwc->bhoc", aw, xf)
    return xf.to(x.dtype)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resize of NCHW model tensors (torch ``F.interpolate`` indices)."""
    h, w = x.shape[2:]
    if (h, w) == (out_h, out_w):
        return x
    ih = tables.on_device(nearest_index, x.device, h, out_h)
    iw = tables.on_device(nearest_index, x.device, w, out_w)
    return x.index_select(2, ih).index_select(3, iw)


def normalize_pm1(x: torch.Tensor) -> torch.Tensor:
    """[0,1] -> [-1,1]."""
    return x * 2.0 - 1.0
