"""Matting quality metrics: SAD / MSE / Grad / Conn (the port's copy of
sdmatte_tpu/eval/metrics.py; numpy and scipy only, so the two agree exactly).

The four canonical matting metrics, implemented per the standard evaluation
protocol (Rhemann et al., "A Perceptually Motivated Online Benchmark for
Image Matting", and the DIM/Adobe evaluation code that every matting paper,
SDMatte included, reports against).

Host-side numpy/scipy: metrics run once per image on the CPU; the card owns
the model math, not the scoring.  All functions take float arrays in [0, 1]:
``pred``/``gt`` (H, W) alphas and ``trimap`` (H, W) with unknown == 0.5
(the convention used throughout this repo; 128/255 in 8-bit terms).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

# unknown-region trimap band: values strictly between these are "unknown"
_BG_MAX = 0.15
_FG_MIN = 0.85


def _unknown_mask(trimap: np.ndarray) -> np.ndarray:
    return (trimap > _BG_MAX) & (trimap < _FG_MIN)


def sad(pred, gt, trimap=None) -> float:
    """Sum of absolute differences / 1000 (whole image by convention;
    pass a trimap to restrict to the unknown region)."""
    diff = np.abs(pred.astype(np.float64) - gt.astype(np.float64))
    if trimap is not None:
        diff = diff * _unknown_mask(trimap)
    return float(diff.sum() / 1000.0)


def mse(pred, gt, trimap=None) -> float:
    """Mean squared error over the unknown region (whole image if no trimap)."""
    d2 = (pred.astype(np.float64) - gt.astype(np.float64)) ** 2
    if trimap is None:
        return float(d2.mean())
    m = _unknown_mask(trimap)
    n = max(int(m.sum()), 1)
    return float((d2 * m).sum() / n)


def _gauss_gradient(img: np.ndarray, sigma: float = 1.4):
    """First-order gaussian derivative magnitude (the DIM eval's
    gaussgradient): separable derivative-of-gaussian filtering."""
    gx = ndimage.gaussian_filter(img, sigma, order=(0, 1), mode="nearest")
    gy = ndimage.gaussian_filter(img, sigma, order=(1, 0), mode="nearest")
    return np.sqrt(gx * gx + gy * gy)


def grad_error(pred, gt, trimap=None, sigma: float = 1.4) -> float:
    """Gradient error: sum of squared differences of gaussian gradient
    magnitudes over the unknown region, /1000 (DIM convention)."""
    pg = _gauss_gradient(pred.astype(np.float64), sigma)
    gg = _gauss_gradient(gt.astype(np.float64), sigma)
    err = (pg - gg) ** 2
    if trimap is not None:
        err = err * _unknown_mask(trimap)
    return float(err.sum() / 1000.0)


def conn_error(pred, gt, trimap=None, step: float = 0.1,
               theta: float = 0.15) -> float:
    """Connectivity error (Rhemann et al. / DIM evaluation code):

    For each threshold, find the largest connected component where BOTH
    pred and gt exceed it; each pixel's l value is the highest threshold at
    which it is still connected to that component; the per-pixel penalty
    compares the degrees of connectedness (phi) of pred and gt.  /1000."""
    pred = pred.astype(np.float64)
    gt = gt.astype(np.float64)
    h, w = pred.shape
    thresh_steps = np.arange(0.0, 1.0 + step, step)
    l_map = -np.ones((h, w), np.float64)
    for i in range(1, len(thresh_steps)):
        both = (pred >= thresh_steps[i]) & (gt >= thresh_steps[i])
        labels, n = ndimage.label(both)
        if n > 0:
            sizes = ndimage.sum(both, labels, index=np.arange(1, n + 1))
            omega = labels == (int(np.argmax(sizes)) + 1)
        else:
            omega = np.zeros((h, w), bool)
        flag = (l_map == -1) & (~omega)
        l_map[flag] = thresh_steps[i - 1]
    l_map[l_map == -1] = 1.0

    pred_d = pred - l_map
    gt_d = gt - l_map
    pred_phi = 1.0 - pred_d * (pred_d >= theta)
    gt_phi = 1.0 - gt_d * (gt_d >= theta)
    err = np.abs(pred_phi - gt_phi)
    if trimap is not None:
        err = err * _unknown_mask(trimap)
    return float(err.sum() / 1000.0)


def evaluate(pred, gt, trimap=None) -> dict:
    """All four metrics as a dict (the table row for one image)."""
    return {
        "SAD": sad(pred, gt, trimap),
        "MSE": mse(pred, gt, trimap),
        "Grad": grad_error(pred, gt, trimap),
        "Conn": conn_error(pred, gt, trimap),
    }
