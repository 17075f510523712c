"""ViTMatte in the port: ``ViTMatte`` declared from the configuration's
transformers-style groups (``backbone_config`` and the decoder's keys),
served by the port's ``ViTMattePipeline``.  The port is imported here, when
the module is first asked for, so that ``declare`` imports nothing on the
meta device.

The control is the reference computed one precision below the
configuration's bf16, put in the program's place: the port has no path in
a lower precision whose gap separates from bf16's by a wide margin (its
int8 weight storage reads 2.4 times the program's worst over three seeds,
PERF.md), so ``CONTROL``'s keyword makes :func:`pipeline` serve
``reference/vitmatte_ref.py`` under bf16 autocast with every product's
operands first rounded to float8 e4m3 (:class:`Float8Products`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from sdmatte_tpu_torch.configs import ViTMatteConfig
from sdmatte_tpu_torch.core.dtypes import BF16, FP32
from sdmatte_tpu_torch.models.vitmatte import ViTMatte
from sdmatte_tpu_torch.pipeline.vitmatte import ViTMatteOptions, ViTMattePipeline

from ..reference import vitmatte_ref

CONTROL = {"reference_in": "float8_e4m3fn"}
E4M3_MAX = 448.0


def policy_of(conf: dict):
    return {"bfloat16": BF16, "float32": FP32}[conf["precision"]["compute"]]


def declare(conf: dict):
    return ViTMatte(ViTMatteConfig.from_dict(conf))


def program_only_shapes(model) -> dict:
    """None: the reference's table holds every parameter and statistic."""
    return {}


def param_dtype(conf: dict):
    return policy_of(conf).param_dtype


def pipeline(model, conf: dict, device, *, reference_in: str | None = None, **keywords):
    if reference_in is not None:
        return Float8Reference(model, conf, device, reference_in)
    return ViTMattePipeline(model, policy=policy_of(conf), device=device, **keywords)


def options(mix: dict):
    return ViTMatteOptions(**mix["options"])


# ------------------------------------------------------------ the control ---

def e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one power-of-two scale for the
    whole tensor (its largest magnitude maps to at most 448), returned in
    ``t``'s dtype: the scale is exact, so the values are e4m3 values times a
    power of two, which bf16 holds exactly."""
    if not t.is_floating_point():
        return t
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, torch.exp2(torch.ceil(torch.log2(amax / E4M3_MAX))),
                        torch.ones_like(amax))
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


class Float8Products(TorchFunctionMode):
    """Autocast in float8 e4m3, as ``torch.autocast`` is in bf16: inside it,
    the operands of every linear, conv, matmul and einsum, and its output,
    are rounded by :func:`e4m3`, and the product accumulates in fp32 (under
    bf16 autocast, which holds e4m3 values exactly).  Norms, softmax and the
    rest run as bf16 autocast runs them."""

    PAIRS = (F.linear, F.conv2d, torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PAIRS:
            args = (e4m3(args[0]), e4m3(args[1]), *args[2:])
        elif func is torch.einsum:
            args = (args[0], *(e4m3(t) for t in args[1:]))
        else:
            return func(*args, **(kwargs or {}))
        return e4m3(func(*args, **(kwargs or {})))


class Float8Reference:
    """The plain reference on the model's weights, computed with float8 e4m3
    products (:class:`Float8Products` under bf16 autocast), with the
    pipeline's ``__call__`` and steps."""

    def __init__(self, model, conf: dict, device, fmt: str):
        if fmt != "float8_e4m3fn":
            raise ValueError(f"reference_in: only float8_e4m3fn, not {fmt!r}")
        self.device = torch.device(device)
        self.conf = conf
        self.params = vitmatte_ref.stored(
            {k: v.to(self.device, torch.float32) for k, v in model.state_dict().items()}, conf)

    def _pre(self, image, trimap):
        return vitmatte_ref.inputs(image, trimap)

    def _heavy(self, x):
        with torch.autocast(self.device.type, dtype=torch.bfloat16), Float8Products():
            return vitmatte_ref.model_alpha(self.params, self.conf, x).float()

    def _post(self, alpha_p, image, trimap, options: ViTMatteOptions):
        return vitmatte_ref.finish(alpha_p, image, trimap,
                                   trimap_constraint=options.trimap_constraint,
                                   refine=options.mask_refine, output_mode=options.output_mode)

    @torch.no_grad()
    def __call__(self, image, trimap, *, options: ViTMatteOptions = ViTMatteOptions()):
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        trimap = torch.as_tensor(trimap, dtype=torch.float32, device=self.device)
        if image.ndim == 3:
            image, trimap = image[None], trimap[None]
        return self._post(self._heavy(self._pre(image, trimap)), image, trimap, options)
