"""Alpha refinement and compositing (sdmatte_tpu/pipeline/postprocess.py):
foreground boost x1.2, unknown-region kill threshold 0.3, matted_rgb gates
trimap > 0.2 & alpha > 0.1."""

from __future__ import annotations

import torch

OUTPUT_MODES = ("alpha_only", "matted_rgba", "matted_rgb", "alpha_blend")
ALPHA_KILL_THRESHOLD = 0.3
FG_BOOST = 1.2


def mask_refine(alpha: torch.Tensor, trimap: torch.Tensor,
                trimap_constraint: float) -> torch.Tensor:
    """alpha, trimap (B, H, W) in [0, 1] at the original resolution."""
    tc = torch.tensor(trimap_constraint, dtype=torch.float32)
    fg = trimap > tc
    bg = trimap < (1.0 - tc)
    unknown = ~(fg | bg)
    out = torch.where(bg, 0.0, alpha)
    out = torch.where(fg, (out * FG_BOOST).clamp(0.0, 1.0), out)
    return torch.where(unknown & (out < ALPHA_KILL_THRESHOLD), 0.0, out)


def composite(image: torch.Tensor, alpha: torch.Tensor, trimap: torch.Tensor,
              output_mode: str) -> torch.Tensor:
    """image (B, H, W, 3); alpha, trimap (B, H, W) -> (B, H, W, 3), or
    (B, H, W, 4) for matted_rgba."""
    if output_mode not in OUTPUT_MODES:
        raise ValueError(f"unknown output_mode {output_mode!r}; expected one of "
                         f"{OUTPUT_MODES}")
    a = alpha[..., None]
    if output_mode == "alpha_only":
        return torch.zeros_like(image)
    if output_mode == "matted_rgba":
        return torch.cat([image, a], dim=-1)
    if output_mode == "matted_rgb":
        return image * ((trimap[..., None] > 0.2) & (a > 0.1)).to(image.dtype)
    return image * a
