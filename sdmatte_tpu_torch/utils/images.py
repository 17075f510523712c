"""Bit-depth-aware PIL -> unit-float array ingestion (sdmatte_tpu/utils/images.py).

Shared by the CLI and the HTTP server so every entry surface normalizes
pixels identically.  PIL's ``convert("L"/"RGB")`` clips >8-bit samples at
255, so a 16-bit trimap's 0.5-gray unknown band (32768/65535) would become
foreground; high-depth modes are normalized numerically instead.  Pillow is
imported where an image is opened, so the package imports without it.
"""

from __future__ import annotations

import numpy as np

# single-channel numeric PIL modes whose samples exceed 8 bits
_HIGH_DEPTH_MODES = ("I", "I;16", "I;16B", "I;16L", "I;16N", "F")


def pil_to_unit_array(img, channels: int) -> np.ndarray:
    """PIL image (any mode) -> (H, W, ``channels``) float32 in [0, 1].

    ``channels`` must be 3 (RGB) or 1 (mask/trimap).  8-bit images go
    through PIL ``convert`` (resolving palette/CMYK/LA/RGBA modes);
    high-bit-depth modes are normalized numerically by their actual sample
    range because ``convert`` would clip them.
    """
    if img.mode == "P":
        # palette images decode to raw palette INDICES; resolve to colors
        img = img.convert("RGBA" if "transparency" in img.info else "RGB")
    if img.mode in _HIGH_DEPTH_MODES:
        arr = np.asarray(img).astype(np.float32)
        if img.mode != "F":                # float modes are already [0, 1]
            arr /= 65535.0                 # I / I;16 PNG data is 16-bit
        arr = np.clip(arr, 0.0, 1.0)
    else:
        img = img.convert("RGB" if channels == 3 else "L")
        arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    if channels == 3 and arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    elif channels == 1 and arr.shape[-1] > 1:
        arr = arr[..., :1]
    return arr


def load_unit_image(path: str, channels: int) -> np.ndarray:
    """File-path convenience wrapper around :func:`pil_to_unit_array`."""
    from PIL import Image
    with Image.open(path) as img:
        return pil_to_unit_array(img, channels)


def to_uint8(arr) -> np.ndarray:
    """[0, 1] floats -> uint8 by clip, *255 and round half up, the rounding
    the CLI's and the server's PNGs use."""
    a = np.clip(np.asarray(arr, np.float32), 0.0, 1.0)
    return (a * 255.0 + 0.5).astype(np.uint8)


def save_png(path_or_file, arr) -> None:
    """Write a [0, 1] array of shape (H, W), (H, W, 1), (H, W, 3) or (H, W, 4)
    as an 8-bit PNG."""
    from PIL import Image
    Image.fromarray(to_uint8(arr).squeeze()).save(path_or_file, format="PNG")
