"""Training data: composite matting batches, made on the host and prefetched
(sdmatte_tpu/parallel/data.py).

  * composition on the host in numpy (the port's eval/synthetic.py mattes,
    whose alphas are exact, or caller-supplied (fg, alpha) pairs); from the
    same seed :class:`CompositeSampler` draws the JAX sampler's batches bit
    for bit, NHWC numpy as there
  * augmentation: random crop and scale, horizontal flip, background
    shuffle, foreground colour jitter, a random trimap band width
  * :func:`prefetch_batches`: a worker thread composites the next batch into
    pinned host tensors (NCHW, the port's layout) while the current step
    runs; the consumer copies them to the device without blocking
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..eval import synthetic


class CompositeSampler:
    """Yields (image, trimap, alpha_gt) training triples by compositing
    foreground/alpha pairs over backgrounds with augmentation."""

    def __init__(self, size: int = 64, *, seed: int = 0,
                 sources: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
                 trimap_band: Tuple[int, int] = (2, 12)):
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.trimap_band = trimap_band
        if sources is None:
            s = max(size, 64)
            alphas = [
                synthetic._soft_disk(s, s, s * 0.5, s * 0.5, s * 0.28, s * 0.06),
                synthetic._hair_strokes(s, s),
                synthetic._gradient_band(s, s),
                synthetic._blob(s, s),
            ]
            sources = [(synthetic._foreground(s, s, seed=7 + i), a)
                       for i, a in enumerate(alphas)]
        self.sources = [(np.asarray(fg, np.float32), np.asarray(a, np.float32))
                        for fg, a in sources]

    # -- augmentation ------------------------------------------------------

    def _crop_resize(self, fg, alpha):
        h, w = alpha.shape
        s = self.size
        scale = self.rng.uniform(0.6, 1.0)
        ch, cw = max(int(h * scale), 8), max(int(w * scale), 8)
        y0 = self.rng.integers(0, h - ch + 1)
        x0 = self.rng.integers(0, w - cw + 1)
        fg_c = fg[y0:y0 + ch, x0:x0 + cw]
        a_c = alpha[y0:y0 + ch, x0:x0 + cw]
        # nearest resize to the target size (exactness does not matter for
        # augmentation)
        yi = np.clip((np.arange(s) + 0.5) * ch / s, 0, ch - 1).astype(np.int64)
        xi = np.clip((np.arange(s) + 0.5) * cw / s, 0, cw - 1).astype(np.int64)
        return fg_c[yi][:, xi], a_c[yi][:, xi]

    def sample(self) -> dict:
        idx = self.rng.integers(0, len(self.sources))
        fg, alpha = self.sources[idx]
        fg, alpha = self._crop_resize(fg, alpha)
        if self.rng.uniform() < 0.5:
            fg, alpha = fg[:, ::-1], alpha[:, ::-1]
        jitter = self.rng.uniform(0.7, 1.3, (1, 1, 3)).astype(np.float32)
        fg = np.clip(fg * jitter, 0, 1)
        bg = synthetic._background(
            self.size, self.size,
            ("gradient", "stripes", "noise")[int(self.rng.integers(0, 3))],
            seed=int(self.rng.integers(0, 1 << 31)))
        img = fg * alpha[..., None] + bg * (1 - alpha[..., None])
        band = int(self.rng.integers(*self.trimap_band))
        tri = synthetic.trimap_from_alpha(alpha, band=band)
        return {"image": img.astype(np.float32), "trimap": tri,
                "alpha_gt": alpha.astype(np.float32)}

    def batch(self, batch_size: int) -> dict:
        """A batch dict in the JAX package's layout: NHWC numpy, image and
        trimap in [-1, 1], alpha_gt in [0, 1] (see :func:`to_tensors`)."""
        items = [self.sample() for _ in range(batch_size)]
        img = np.stack([it["image"] for it in items])
        tri = np.stack([it["trimap"] for it in items])
        alpha = np.stack([it["alpha_gt"] for it in items])
        return {
            "image": (img * 2.0 - 1.0).astype(np.float32),
            "trimap": (tri * 2.0 - 1.0).astype(np.float32)[..., None],
            "trimap_coords": np.tile(
                np.asarray([[0.0, 0.0, 1.0, 1.0]], np.float32),
                (batch_size, 1)),
            "is_trans": np.zeros((batch_size,), np.float32),
            "alpha_gt": alpha[..., None],
        }


def to_tensors(batch: dict, *, pin: bool = False) -> dict:
    """A numpy batch -> CPU tensors in the model's layout: every 4-D array
    NHWC -> NCHW (contiguous), the rest as they are; ``pin`` puts them in
    page-locked memory, from which a copy to the card need not block."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.ndim == 4:
            t = t.permute(0, 3, 1, 2).contiguous()
        out[k] = t.pin_memory() if pin else t
    return out


def prefetch_batches(sampler: CompositeSampler, batch_size: int, *, steps: int,
                     mesh=None, device=None, depth: int = 2) -> Iterator[dict]:
    """Batches on ``device`` (the CPU when None), composited one step ahead
    on a worker thread; an exception in the worker is raised here.

    ``batch_size`` is the global batch.  With a mesh of more than one
    process each process composites only its own ``batch_size // world``
    samples, and processes are expected to draw different data
    (train_loop seeds the default sampler with the rank)."""
    device = torch.device("cpu" if device is None else device)
    world = mesh.size() if mesh is not None else 1
    local_bs = batch_size
    if world > 1:
        if batch_size % world:
            raise ValueError(f"global batch_size {batch_size} must divide evenly over "
                             f"{world} processes")
        local_bs = batch_size // world
    pin = device.type == "cuda"

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        for _ in range(steps):
            if stop.is_set():
                return
            try:
                item = to_tensors(sampler.batch(local_bs), pin=pin)
            except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
                q.put(e)
                return
            q.put(item)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        for _ in range(steps):
            item = q.get()
            if isinstance(item, Exception):
                raise item
            yield {k: v.to(device, non_blocking=True) for k, v in item.items()}
    finally:
        stop.set()
        # drain, so that a worker blocked in put() sees the stop
        while not q.empty():
            q.get_nowait()
