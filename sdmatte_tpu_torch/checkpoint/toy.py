"""Checkpoint writer: an ``SDMatte`` module -> torch-layout safetensors
(sdmatte_tpu/checkpoint/toy.py), written by the port's own writer.

For checkpoints made at run time (tests, the card's smoke run) and for
saving weights in the format the reference ecosystem reads."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from . import safetensors_io


def save_checkpoint(model: nn.Module, path: str, *, dtype: Optional[torch.dtype] = None,
                    rename: Optional[Callable[[str], str]] = None) -> int:
    """Write ``model``'s state dict to ``path`` (in ``dtype`` where given,
    else each tensor's own), each key passed through ``rename`` where given.
    Returns the file's size in bytes."""
    sd = {}
    for k, v in model.state_dict().items():
        v = v if dtype is None or not v.is_floating_point() else v.to(dtype)
        sd[rename(k) if rename else k] = v
    return safetensors_io.write(sd, path)
