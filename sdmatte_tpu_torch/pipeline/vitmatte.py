"""The matting pipeline of ViTMatte (models/vitmatte.py), with
``MattingPipeline``'s contract and steps.

``_pre`` normalises the photo to [-1, 1], appends the trimap as a fourth
channel and zero-pads at the bottom and right to a multiple of 32 (the
image processor of ``hustvl/vitmatte-base-composition-1k``): ViTMatte runs
at the photo's own resolution, so there is no inference size.  ``_heavy``
is the model, replayed on the card from the CUDA graphs of its key (the
input's shape and dtype and the pipeline's settings; pipeline/graphs.py).
``_post`` crops the padding off, clamps, and applies the shared trimap
refinement and composite (pipeline/postprocess.py).
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as tF

from ..core.dtypes import FP32, Policy
from ..models.vitmatte import ViTMatte
from ..ops import quant
from ..ops.dispatch import IMPLEMENTATIONS, implementation
from ..utils import observability
from . import postprocess
from .graphs import HeavyGraphs
from .matting import resolve_device


@dataclasses.dataclass(frozen=True)
class ViTMatteOptions:
    """Per-call knobs.  ``is_transparent`` is accepted and ignored: it is
    there so that the options of an SDMatte call (a benchmark mix's, the
    CLI's ``--transparent``) build these too; ViTMatte has no opacity input."""
    output_mode: str = "alpha_only"
    mask_refine: bool = True
    trimap_constraint: float = 0.8
    is_transparent: bool = False


class ViTMattePipeline:
    """``model`` is a :class:`ViTMatte` with its weights; the pipeline moves
    it to ``device`` in the policy's parameter dtype, in
    ``torch.channels_last``.  ``weight_storage="int8"`` keeps every conv and
    linear weight of at least 65,536 elements as int8 plus an fp32 scale,
    dequantized at its use (on a copy: the caller's model keeps its
    weights).  ``impl``: "auto" runs the hand kernels on the card (the plain
    versions on the CPU); "plain" runs the plain versions on the card too
    (the step inside ``implementation(impl)``, as ``MattingPipeline``'s)."""

    def __init__(self, model: ViTMatte, *, policy: Policy = FP32, device=None,
                 impl: str = "auto", weight_storage: str = "fp"):
        if weight_storage not in ("fp", "int8"):
            raise ValueError(f"weight_storage must be 'fp' or 'int8', got {weight_storage!r}")
        if impl not in IMPLEMENTATIONS:
            raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
        self.device = resolve_device(device)
        self.cfg = model.cfg
        self.policy = policy
        self.impl = impl
        if weight_storage == "int8":
            model = quant.compress_tree_int8_(copy.deepcopy(model))
        self.model = quant.stage_(model, device=self.device, dtype=policy.param_dtype).eval()
        self._graphs = HeavyGraphs(self.device)

    def _pre(self, image, trimap):
        """image (B,H,W,3), trimap (B,H,W) in [0,1] -> (B, 4, Hp, Wp) in the
        compute dtype, channels_last."""
        x = torch.cat([image * 2.0 - 1.0, trimap[..., None]], dim=-1).permute(0, 3, 1, 2)
        d = self.cfg.size_divisor
        h, w = x.shape[2:]
        x = tF.pad(x, (0, (-w) % d, 0, (-h) % d))
        return x.to(self.policy.compute_dtype).contiguous(memory_format=torch.channels_last)

    def _heavy(self, x):
        """The model's alpha (B, Hp, Wp) fp32: on the card by the graphs of
        the step's key, else eagerly."""
        key = (self.policy, self.impl, tuple(x.shape), x.dtype)
        return self._graphs(key, self._model_alpha, (x,))

    def _model_alpha(self, x):
        with implementation(self.impl):
            return self.model(x, policy=self.policy)[:, 0]

    def _post(self, alpha_p, image, trimap, *, output_mode: str, refine: bool,
              trimap_constraint: float):
        h, w = image.shape[1:3]
        alpha = alpha_p[:, :h, :w].clamp(0.0, 1.0)
        if refine:
            alpha = postprocess.mask_refine(alpha, trimap, trimap_constraint)
        return alpha, postprocess.composite(image, alpha, trimap, output_mode)

    @torch.no_grad()
    def __call__(self, image, trimap, *, options: ViTMatteOptions = ViTMatteOptions()):
        """image (B,H,W,3) or (H,W,3) in [0,1]; trimap (B,H,W) or (H,W).

        Returns (alpha (B,H,W), matted (B,H,W,3|4)) as fp32 tensors on the
        pipeline's device."""
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        if image.ndim == 3:
            image = image[None]
        trimap = torch.as_tensor(trimap, dtype=torch.float32, device=self.device)
        if trimap.ndim == 2:
            trimap = trimap[None]
        x = self._pre(image, trimap)
        with observability.span("pipeline.heavy"):
            alpha_p = self._heavy(x)
        return self._post(alpha_p, image, trimap, output_mode=options.output_mode,
                          refine=options.mask_refine,
                          trimap_constraint=options.trimap_constraint)
