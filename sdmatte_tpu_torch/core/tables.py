"""Small constant tables kept on the device: resampling matrices, gather
indices, frequencies.

A table is built on the host (by a numpy function) once per (function,
device, sizes) and copied to the device once, so that a call that uses it
makes no host-to-device copy: such a copy waits on the host, and it cannot
be captured in a CUDA graph (pipeline/graphs.py).  The cache is bounded, the
least recently used table going first; a graph reads a table by its address,
so a capture collects every table it reads (:func:`holding`) and keeps them
for as long as its graphs live.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Callable, Iterator, List

import numpy as np
import torch

CAPACITY = 64

_lock = threading.Lock()
_cache: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_local = threading.local()


def on_device(build: Callable[..., np.ndarray], device: torch.device, *sizes) -> torch.Tensor:
    """``build(*sizes)`` as a tensor on ``device``, made once and then
    handed out as the same tensor (read it, never write it)."""
    key = (build, device, sizes)
    with _lock:
        t = _cache.get(key)
        if t is not None:
            _cache.move_to_end(key)
    if t is None:
        t = torch.from_numpy(build(*sizes)).to(device)
        with _lock:
            t = _cache.setdefault(key, t)
            while len(_cache) > CAPACITY:
                _cache.popitem(last=False)
    held = getattr(_local, "held", None)
    if held is not None:
        held.append(t)
    return t


@contextlib.contextmanager
def holding() -> Iterator[List[torch.Tensor]]:
    """Collects every table handed out on this thread inside the block."""
    outer = getattr(_local, "held", None)
    _local.held = held = []
    try:
        yield held
    finally:
        _local.held = outer
