"""Seeded weights, made on the device in a few large calls.

The rows come from the parameter table of the configuration's reference
(``reference/<architecture>_ref.py``; SDMatte's VAE and U-Net) and, for the
parameters the program declares that the table lacks (SDMatte's CLIP text
tower, resident but never run under the default gating), from the names
and shapes of the program's model.  Values: conv and linear weights
N(0, 1/fan_in), biases and norm shifts N(0, 0.05^2), norm scales U(0.7, 1.3)
(O(1) activations throughout); drawn in fp32 from one generator, then cast
to the serving dtype.
"""

from __future__ import annotations

import math

import torch

from . import architecture
from .traffic.generate import derive_seed


def extra_rows(shapes: dict) -> list[tuple[str, tuple, str]]:
    """Rows for the program's own parameters from {name: shape}."""
    rows = []
    for name, shape in shapes.items():
        kind = "b" if name.endswith(".bias") else ("nw" if len(shape) == 1 else "w")
        rows.append((name, tuple(shape), kind))
    return rows


def make_params(conf: dict, seed: int, device, dtype=torch.bfloat16,
                extra_shapes=None) -> dict:
    """{name: tensor} for the reference's table (and the program's own
    parameters, where their {name: shape} is given), each its own tensor in
    ``dtype``.  The two groups are drawn from generators of their own, so
    the reference, which asks for the first alone, gets the same values.
    The second's seed is labelled "text-weights" for every architecture, so
    that SDMatte's text tower keeps its values."""
    table = architecture.reference_of(conf).param_table(conf)
    out = _draw(table, derive_seed(seed, "weights"), device, dtype)
    if extra_shapes:
        out.update(_draw(extra_rows(extra_shapes), derive_seed(seed, "text-weights"),
                         device, dtype))
    return out


@torch.no_grad()
def _draw(rows, seed, device, dtype) -> dict:
    n_normal = sum(math.prod(s) for _, s, k in rows if k != "nw")
    n_uniform = sum(math.prod(s) for _, s, k in rows if k == "nw")
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, i_n, i_u = {}, 0, 0
    for name, shape, kind in rows:
        n = math.prod(shape)
        if kind == "nw":
            v = uniform[i_u:i_u + n] * 0.6 + 0.7
            i_u += n
        else:
            scale = 1.0 / math.sqrt(math.prod(shape[1:])) if kind == "w" else 0.05
            v = normal[i_n:i_n + n] * scale
            i_n += n
        out[name] = v.view(shape).to(dtype, copy=True)
    del normal, uniform
    return out
