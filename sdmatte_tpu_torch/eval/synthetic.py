"""Synthetic-composite evaluation set with exact ground-truth alphas (the
port's copy of sdmatte_tpu/eval/synthetic.py; numpy and scipy only).

Procedurally generated mattes whose alpha is known exactly: soft disks
(defocus edges), gradient ramps (semi-transparency), hair-like strokes (thin
structures) and a soft-edged blob (generic object), composited over
structured backgrounds.  The parity pack's quality stage scores the port's
pipeline on them.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def _soft_disk(h, w, cy, cx, r, soft):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    return np.clip((r + soft - d) / (2 * soft), 0.0, 1.0)


def _hair_strokes(h, w, n=40, seed=3):
    rng = np.random.default_rng(seed)
    alpha = np.zeros((h, w), np.float64)
    base = _soft_disk(h, w, h * 0.62, w * 0.5, min(h, w) * 0.22, min(h, w) * 0.02)
    alpha = np.maximum(alpha, base)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    for _ in range(n):
        x0 = rng.uniform(0.3, 0.7) * w
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(2, 8)
        width = rng.uniform(0.6, 1.6)
        top = rng.uniform(0.08, 0.3) * h
        curve = x0 + amp * np.sin(yy / 17.0 + phase)
        strand = np.exp(-((xx - curve) ** 2) / (2 * width ** 2))
        strand *= (yy > top) & (yy < h * 0.62)
        alpha = np.maximum(alpha, strand * rng.uniform(0.5, 1.0))
    return np.clip(alpha, 0.0, 1.0)


def _gradient_band(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    core = ((xx > w * 0.25) & (xx < w * 0.75) & (yy > h * 0.2) & (yy < h * 0.8))
    ramp = np.clip((xx - w * 0.25) / (w * 0.5), 0, 1)
    return core * ramp


def _blob(h, w, seed=5):
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), np.float64)
    for _ in range(6):
        m = np.maximum(m, _soft_disk(h, w, rng.uniform(0.3, 0.7) * h,
                                     rng.uniform(0.3, 0.7) * w,
                                     rng.uniform(0.08, 0.2) * min(h, w),
                                     rng.uniform(0.02, 0.08) * min(h, w)))
    return m


def _background(h, w, kind, seed=11):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    if kind == "gradient":
        base = np.stack([xx / w, yy / h, 0.5 * np.ones_like(xx)], -1)
    elif kind == "stripes":
        s = 0.5 + 0.5 * np.sin(xx / 9.0)
        base = np.stack([s, 1 - s, 0.3 + 0.4 * s], -1)
    else:  # noise blobs
        base = ndimage.gaussian_filter(rng.uniform(0, 1, (h, w, 3)),
                                       (9, 9, 0), mode="nearest")
        base = (base - base.min()) / max(float(np.ptp(base)), 1e-6)
    return base


def _foreground(h, w, seed=7):
    rng = np.random.default_rng(seed)
    color = rng.uniform(0.4, 1.0, 3)
    tex = ndimage.gaussian_filter(rng.uniform(0, 1, (h, w, 1)), (5, 5, 0),
                                  mode="nearest")
    return np.clip(color[None, None] * (0.7 + 0.6 * tex), 0, 1)


def trimap_from_alpha(alpha: np.ndarray, band: int = 8) -> np.ndarray:
    """fg=1 / bg=0 / unknown=0.5, with a dilated unknown band around any
    non-binary alpha (mirrors how SegmentAnything-style trimaps feed the
    reference's example workflow)."""
    fg = alpha > 1.0 - 1.0 / 255.0
    bg = alpha < 1.0 / 255.0
    unknown = ~(fg | bg)
    unknown = ndimage.binary_dilation(unknown, iterations=band)
    tri = np.where(unknown, 0.5, np.where(fg, 1.0, 0.0))
    return tri.astype(np.float32)


def make_eval_set(size: int = 256):
    """-> list of dicts {name, image (H,W,3) [0,1], trimap (H,W), alpha_gt}."""
    cases = [
        ("soft_disk", _soft_disk(size, size, size * 0.5, size * 0.5,
                                 size * 0.28, size * 0.06), "gradient"),
        ("hair", _hair_strokes(size, size), "noise"),
        ("gradient_band", _gradient_band(size, size), "stripes"),
        ("blob", _blob(size, size), "noise"),
    ]
    out = []
    for i, (name, alpha, bg_kind) in enumerate(cases):
        fg = _foreground(size, size, seed=7 + i)
        bg = _background(size, size, bg_kind, seed=11 + i)
        img = fg * alpha[..., None] + bg * (1.0 - alpha[..., None])
        out.append({
            "name": name,
            "image": img.astype(np.float32),
            "trimap": trimap_from_alpha(alpha),
            "alpha_gt": alpha.astype(np.float32),
        })
    return out
