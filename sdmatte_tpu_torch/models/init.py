"""Seeded random weights, made on a given device.

For runs at full width without a checkpoint (the card's smoke run).  The
scales give O(1) activations everywhere, as the JAX package's parity tests
do with their inflated init: conv and linear weights N(0, 1/fan_in), biases
N(0, 0.05), norm scales U(0.7, 1.3) and norm biases N(0, 0.05).
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def init_random_(model: nn.Module, *, seed: int = 0, device=None) -> nn.Module:
    """Fill every parameter of ``model`` from one ``torch.Generator`` seeded
    with ``seed``, in ``named_parameters`` order; a model on the meta device
    is first materialised on ``device``."""
    if device is not None:
        model.to_empty(device=device)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            norm = isinstance(mod, (nn.GroupNorm, nn.LayerNorm))
            if name == "weight" and norm:
                v = torch.rand(p.shape, generator=gen, device=dev) * 0.6 + 0.7
            elif name == "weight":
                fan_in = p[0].numel()
                v = torch.randn(p.shape, generator=gen, device=dev) / fan_in ** 0.5
            else:
                v = torch.randn(p.shape, generator=gen, device=dev) * 0.05
            p.copy_(v)
    return model
