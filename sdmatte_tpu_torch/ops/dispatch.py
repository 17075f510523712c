"""Which implementation runs, and which 3x3 stride-1 convs take the conv
kernel (sdmatte_tpu/ops/dispatch.py).

Every hand-kernel entry point asks :func:`plain_here` before it launches: a
CPU tensor takes the plain version, and so does any tensor inside
``implementation("plain")``, the one switch that forces the plain versions
on the card (to check the kernels, and to train: no kernel has a backward).

The conv table is, for now, the JAX package's as its TPU pipeline runs it
(inside ``model_jit``): ``PALLAS_CONV_WINS`` with the ``PALLAS_CONV_WINS_SVMEM``
overlay applied, keeping each entry's gn / residual fusion flags.  Every one
is a VAE-encoder shape at concat batch 2, and only under the bf16 policy.
Every other conv is ``torch.nn.functional.conv2d``.  The table was measured
against XLA on a TPU; retuning it against cuDNN on the H100 is later work.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import NamedTuple, Optional

import torch

IMPLEMENTATIONS = ("auto", "plain")
_implementation: ContextVar[str] = ContextVar("implementation", default="auto")


@contextlib.contextmanager
def implementation(name: str):
    """Inside: "plain" runs the plain versions on any device, "auto" the
    kernels on the card.  Scopes nest and restore the outer setting on any
    exit; a thread starts at "auto" whatever another thread has set."""
    if name not in IMPLEMENTATIONS:
        raise ValueError(f"implementation must be 'auto' or 'plain', got {name!r}")
    token = _implementation.set(name)
    try:
        yield
    finally:
        _implementation.reset(token)


def plain_here(t: torch.Tensor) -> bool:
    """Whether an entry point takes the plain version for this tensor."""
    return t.device.type == "cpu" or _implementation.get() == "plain"


def checkpoint_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the recompute runs under
    the implementation of the forward it repeats, since a backward on the
    card may run it on an autograd thread of its own."""
    return contextlib.nullcontext(), implementation(_implementation.get())


class Route(NamedTuple):
    fuse_gn: bool
    fuse_residual: bool


# (batch, spatial, cin, cout) -> fusions
CONV3X3_TABLE: dict[tuple[int, int, int, int], Route] = {
    (2, 1024, 128, 128): Route(True, False),
    (2, 512, 256, 256): Route(True, True),
    (2, 256, 512, 512): Route(True, True),
    (2, 512, 128, 256): Route(False, False),
    (2, 512, 256, 128): Route(False, False),
    (2, 512, 128, 128): Route(True, True),
    (2, 256, 256, 256): Route(False, False),
    (2, 640, 128, 128): Route(True, True),
    (2, 320, 256, 256): Route(False, False),
    (2, 768, 128, 128): Route(True, True),
    (2, 384, 256, 256): Route(False, False),
    (2, 896, 128, 128): Route(True, False),
    (2, 448, 256, 256): Route(False, False),
}


def conv3x3_route(b: int, h: int, w: int, cin: int, cout: int, *,
                  compute_dtype: torch.dtype) -> Optional[Route]:
    """The fusions to use when the conv kernel takes this 3x3 stride-1
    shape, else None."""
    if compute_dtype != torch.bfloat16 or h != w:
        return None
    return CONV3X3_TABLE.get((b, h, cin, cout))
