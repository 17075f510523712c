"""Which 3x3 stride-1 convs take the conv kernel (sdmatte_tpu/ops/dispatch.py).

For now the table is the JAX package's as its TPU pipeline runs it (inside
``model_jit``): ``PALLAS_CONV_WINS`` with the ``PALLAS_CONV_WINS_SVMEM``
overlay applied, keeping each entry's gn / residual fusion flags.  Every one
is a VAE-encoder shape at concat batch 2, and only under the bf16 policy.
Every other conv is ``torch.nn.functional.conv2d``.  The table was measured
against XLA on a TPU; retuning it against cuDNN on the H100 is later work.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


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
