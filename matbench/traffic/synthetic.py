"""Photos with exact alphas, and trimaps from them: a frozen copy, translated
to torch, of ``sdmatte_tpu_torch/eval/synthetic.py`` (the program's own
generator, numpy and scipy on the host; see ``matbench/README.md`` for the
commit).  It runs on the card so that a 2048 px photo takes milliseconds of
set-up, not seconds.  What changed in the translation:

* randomness comes from one ``torch.Generator`` seeded by the run, not from
  fixed numpy seeds per shape;
* ``scipy.ndimage.gaussian_filter(mode="nearest")`` is a separable Gaussian
  (radius 4 sigma) with replicated edges; ``binary_dilation`` with the
  default cross, ``band`` times, is ``band`` steps of a 4-neighbour max;
* the four matte kinds and three backgrounds are those of ``make_eval_set``,
  at any height and width.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

KINDS = ("soft_disk", "hair", "gradient_band", "blob")
BACKGROUNDS = ("gradient", "noise", "stripes", "noise")


def _u(gen, lo, hi, dev):
    return float(torch.rand((), generator=gen, device=dev)) * (hi - lo) + lo


def _grid(h, w, dev):
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, w)
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :].expand(h, w)
    return yy, xx


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """(C, H, W) -> the same, blurred over H and W with replicated edges."""
    r = int(4 * sigma + 0.5)
    t = torch.arange(-r, r + 1, device=x.device, dtype=torch.float32)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = k / k.sum()
    c = x.shape[0]
    y = F.pad(x[None], (r, r, r, r), mode="replicate")
    y = F.conv2d(y, k.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    y = F.conv2d(y, k.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return y[0]


def _soft_disk(h, w, cy, cx, r, soft, dev):
    yy, xx = _grid(h, w, dev)
    d = torch.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    return ((r + soft - d) / (2 * soft)).clamp(0.0, 1.0)


def _hair(h, w, gen, dev, n=40):
    m = min(h, w)
    alpha = _soft_disk(h, w, h * 0.62, w * 0.5, m * 0.22, m * 0.02, dev)
    yy, xx = _grid(h, w, dev)
    for _ in range(n):
        x0 = _u(gen, 0.3, 0.7, dev) * w
        phase = _u(gen, 0.0, 2 * math.pi, dev)
        amp = _u(gen, 2, 8, dev)
        width = _u(gen, 0.6, 1.6, dev)
        top = _u(gen, 0.08, 0.3, dev) * h
        curve = x0 + amp * torch.sin(yy / 17.0 + phase)
        strand = torch.exp(-((xx - curve) ** 2) / (2 * width ** 2))
        strand = strand * ((yy > top) & (yy < h * 0.62))
        alpha = torch.maximum(alpha, strand * _u(gen, 0.5, 1.0, dev))
    return alpha.clamp(0.0, 1.0)


def _gradient_band(h, w, dev):
    yy, xx = _grid(h, w, dev)
    core = (xx > w * 0.25) & (xx < w * 0.75) & (yy > h * 0.2) & (yy < h * 0.8)
    return core * ((xx - w * 0.25) / (w * 0.5)).clamp(0, 1)


def _blob(h, w, gen, dev):
    m = torch.zeros((h, w), device=dev)
    s = min(h, w)
    for _ in range(6):
        m = torch.maximum(m, _soft_disk(h, w, _u(gen, 0.3, 0.7, dev) * h,
                                        _u(gen, 0.3, 0.7, dev) * w,
                                        _u(gen, 0.08, 0.2, dev) * s,
                                        _u(gen, 0.02, 0.08, dev) * s, dev))
    return m


def _background(h, w, kind, gen, dev):
    yy, xx = _grid(h, w, dev)
    if kind == "gradient":
        return torch.stack([xx / w, yy / h, torch.full_like(xx, 0.5)], -1)
    if kind == "stripes":
        s = 0.5 + 0.5 * torch.sin(xx / 9.0)
        return torch.stack([s, 1 - s, 0.3 + 0.4 * s], -1)
    base = gaussian_blur(torch.rand((3, h, w), generator=gen, device=dev), 9.0)
    base = (base - base.min()) / (base.max() - base.min()).clamp_min(1e-6)
    return base.permute(1, 2, 0)


def _foreground(h, w, gen, dev):
    color = torch.rand(3, generator=gen, device=dev) * 0.6 + 0.4
    tex = gaussian_blur(torch.rand((1, h, w), generator=gen, device=dev), 5.0)[0]
    return (color[None, None] * (0.7 + 0.6 * tex[..., None])).clamp(0, 1)


def matte_alpha(kind: str, h: int, w: int, gen, dev) -> torch.Tensor:
    if kind == "soft_disk":
        s = min(h, w)
        return _soft_disk(h, w, h * 0.5, w * 0.5, s * 0.28, s * 0.06, dev)
    if kind == "hair":
        return _hair(h, w, gen, dev)
    if kind == "gradient_band":
        return _gradient_band(h, w, dev)
    return _blob(h, w, gen, dev)


def trimap_from_alpha(alpha: torch.Tensor, band: int) -> torch.Tensor:
    """fg = 1 / bg = 0 / unknown = 0.5, the unknown region (non-binary alpha)
    dilated ``band`` times by the 4-neighbour cross."""
    fg = alpha > 1.0 - 1.0 / 255.0
    bg = alpha < 1.0 / 255.0
    u = (~(fg | bg)).float()[None, None]
    for _ in range(band):
        p = F.pad(u, (1, 1, 1, 1))
        u = torch.maximum(torch.maximum(torch.maximum(p[..., 1:-1, 1:-1], p[..., :-2, 1:-1]),
                                        torch.maximum(p[..., 2:, 1:-1], p[..., 1:-1, :-2])),
                          p[..., 1:-1, 2:])
    unknown = u[0, 0] > 0
    return torch.where(unknown, 0.5, torch.where(fg, 1.0, 0.0)).float()


def photo(kind: str, background: str, h: int, w: int, band: int, gen, dev):
    """-> image (H, W, 3), trimap (H, W), alpha (H, W), fp32 on ``dev``."""
    alpha = matte_alpha(kind, h, w, gen, dev)
    fg = _foreground(h, w, gen, dev)
    bg = _background(h, w, background, gen, dev)
    img = fg * alpha[..., None] + bg * (1.0 - alpha[..., None])
    return img.float(), trimap_from_alpha(alpha, band), alpha.float()
