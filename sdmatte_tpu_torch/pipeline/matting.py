"""End-to-end matting pipeline of the port (sdmatte_tpu/pipeline/matting.py).

The flow keeps the JAX package's three steps: ``_pre`` (antialiased resize
to the inference size and normalisation to [-1, 1]), ``_heavy`` (the model:
VAE encode, U-Net, decode) and ``_post`` (resize back, clamp, trimap
refinement, composite).  PyTorch runs eagerly, so there is no per-shape
compile cache; ``warmup`` builds the hand kernels and runs each size once.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import AUX_INPUT_COORDS
from ..core import imaging
from ..core.dtypes import FP32, Policy
from ..models.sdmatte import SDMatte
from ..ops import quant
from . import postprocess

SPEED_MODES = ("off", "aux_half", "rgb_half", "decode_half", "fast", "fastest")


@dataclasses.dataclass(frozen=True)
class PipelineOptions:
    """User-facing knobs (the reference node's INPUT_TYPES)."""
    inference_size: int = 1024
    is_transparent: bool = False
    output_mode: str = "alpha_only"
    mask_refine: bool = True
    trimap_constraint: float = 0.8
    aux_input: str = "trimap"


def resolve_device(device) -> torch.device:
    """``None`` means the card; asking for the card without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("MattingPipeline runs on the CUDA card by default, "
                           "and CUDA is not available; pass device='cpu' to "
                           "run the plain versions on the CPU")
    return dev


class MattingPipeline:
    """``model`` is an :class:`SDMatte` with its weights (see
    checkpoint/convert.load_params and models/init.init_random_); the
    pipeline moves it to ``device`` in the policy's parameter dtype, in
    ``torch.channels_last``.

    ``vae_int8`` gives every 3x3 VAE conv int8 compute fields (the int8
    conv, K4 on the card); ``weight_storage="int8"`` keeps every large conv
    and linear weight as int8 plus an fp32 scale, dequantized at its use.
    Both quantize the weights as the model holds them, before the cast to
    the parameter dtype, compute first so that the two compose (the JAX
    pipeline's order); they work on a copy, so the caller's model keeps its
    fp weights.

    ``impl``: "auto" runs the hand kernels on the card (the plain versions
    on the CPU); "plain" runs the plain versions on the card too, for
    checking the kernels end to end.  Nothing chooses "plain" by itself.

    ``tokenizer`` (models/tokenizer.CLIPTokenizer) turns captions into the
    text tower's ids; a model whose gating sends a stage to the text tokens
    needs one at call time.

    ``vae_chunk`` runs the VAE over the batch in chunks of at most that many
    images (peak memory for large batches); ``vae_encode_split`` forces
    (True) or forbids (False) the two-pass encode, which None takes when the
    concat batch would exceed 16.  ``speed_mode`` (out of parity, never the
    default): "aux_half" and "rgb_half" encode that input at half size,
    "decode_half" decodes the alpha latent at half size, "fast" is aux_half
    + decode_half and "fastest" all three."""

    def __init__(self, model: SDMatte, *, policy: Policy = FP32, device=None,
                 impl: str = "auto", tokenizer=None, vae_chunk: Optional[int] = None,
                 vae_int8: bool = False, weight_storage: str = "fp",
                 vae_encode_split: Optional[bool] = None,
                 speed_mode: str = "off"):
        if speed_mode not in SPEED_MODES:
            raise ValueError(f"unknown speed_mode {speed_mode!r}")
        if weight_storage not in ("fp", "int8"):
            raise ValueError(f"weight_storage must be 'fp' or 'int8', got "
                             f"{weight_storage!r}")
        if impl not in ("auto", "plain"):
            raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
        self.device = resolve_device(device)
        self.cfg = model.cfg
        self.policy = policy
        self.impl = impl
        self.tokenizer = tokenizer
        self.vae_chunk = vae_chunk
        self.vae_encode_split = vae_encode_split
        self.speed_mode = speed_mode
        if vae_int8 or weight_storage == "int8":
            model = copy.deepcopy(model)
            if vae_int8:
                quant.quantize_vae_tree_(model.vae)
            if weight_storage == "int8":
                quant.compress_tree_int8_(model)
        self.model = quant.stage_(model, device=self.device,
                                  dtype=policy.param_dtype).eval()

    def _pre(self, image, prompt_mask, *, size: int):
        """image (B,H,W,3), prompt_mask (B,H,W) in [0,1] -> NCHW (S,S) pair."""
        cd = self.policy.compute_dtype
        img = imaging.normalize_pm1(imaging.resize_bilinear(image, size, size)).to(cd)
        pm = imaging.resize_bilinear(prompt_mask[..., None], size, size)
        pm = imaging.normalize_pm1(pm).to(cd)
        return img.permute(0, 3, 1, 2), pm.permute(0, 3, 1, 2)

    def _heavy(self, img, pm, coords, is_trans, *, aux_type: str, text_ids=None):
        """Preprocessed inputs -> model alpha (B,S,S) fp32 in [0,1]."""
        data = {"image": img, aux_type: pm, AUX_INPUT_COORDS[aux_type]: coords,
                "is_trans": is_trans}
        if text_ids is not None:
            data["text_ids"] = text_ids
        mode = self.speed_mode
        alpha = self.model(data, aux_input_type=aux_type, policy=self.policy,
                           impl=self.impl, vae_chunk=self.vae_chunk,
                           vae_encode_split=self.vae_encode_split,
                           speed_aux_half=mode in ("aux_half", "fast", "fastest"),
                           speed_rgb_half=mode in ("rgb_half", "fastest"),
                           speed_decode_half=mode in ("decode_half", "fast", "fastest"))
        if isinstance(alpha, tuple):
            # cfg.use_dis_loss makes the model return (alpha, feature_maps),
            # a training hook; inference keeps the alpha
            alpha = alpha[0]
        return alpha.float()[:, 0]

    def _post(self, alpha_s, image, prompt_mask, *, output_mode: str,
              refine: bool, trimap_constraint: float):
        """Model alpha + ORIGINAL-resolution image and mask -> (alpha, matted)."""
        oh, ow = image.shape[1:3]
        alpha = imaging.resize_bilinear(alpha_s[..., None], oh, ow)[..., 0].clamp(0.0, 1.0)
        if refine:
            alpha = postprocess.mask_refine(alpha, prompt_mask, trimap_constraint)
        return alpha, postprocess.composite(image, alpha, prompt_mask, output_mode)

    def warmup(self, *, sizes: Sequence[int] = (1024,),
               batch_sizes: Sequence[int] = (1,),
               options: Optional[PipelineOptions] = None) -> dict:
        """Run zero-filled inputs through each (size, batch) once, so the
        first user request does not pay the kernels' build and the
        allocator's growth.  Returns {(size, batch): seconds}."""
        base = options or PipelineOptions()
        timings = {}
        for size in sizes:
            opts = dataclasses.replace(base, inference_size=size)
            for b in batch_sizes:
                t0 = time.perf_counter()
                img = torch.zeros((b, size, size, 3), device=self.device)
                pm = torch.zeros((b, size, size), device=self.device)
                self(img, pm, options=opts)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                timings[(size, b)] = round(time.perf_counter() - t0, 3)
        return timings

    @torch.no_grad()
    def __call__(self, image, prompt_mask, *, options: PipelineOptions,
                 coords=None, caption: Optional[Sequence[str]] = None):
        """image (B,H,W,3) or (H,W,3) in [0,1]; prompt_mask (B,H,W) or (H,W);
        ``caption``: one string per image for the text tower (empty strings
        by default), read only under text gating.

        Returns (alpha (B,H,W), matted (B,H,W,3|4)) as fp32 tensors on the
        pipeline's device."""
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        if image.ndim == 3:
            image = image[None]
        prompt_mask = torch.as_tensor(prompt_mask, dtype=torch.float32, device=self.device)
        if prompt_mask.ndim == 2:
            prompt_mask = prompt_mask[None]
        b = image.shape[0]
        if coords is None:
            coords = np.tile(np.asarray([[0.0, 0.0, 1.0, 1.0]], np.float32), (b, 1))
        coords = torch.as_tensor(coords, dtype=torch.float32).to(self.device)
        is_trans = torch.full((b,), 1.0 if options.is_transparent else 0.0,
                              device=self.device)
        text_ids = None
        if not all(self.cfg.unet.use_encoder_hidden_states_list):
            if self.tokenizer is None:
                raise ValueError("text-conditioned gating requires a tokenizer")
            prompts = list(caption) if caption else [""] * b
            text_ids = torch.as_tensor(self.tokenizer(prompts), dtype=torch.int64,
                                       device=self.device)
        img_s, pm_s = self._pre(image, prompt_mask, size=options.inference_size)
        alpha_s = self._heavy(img_s, pm_s, coords, is_trans, aux_type=options.aux_input,
                              text_ids=text_ids)
        return self._post(alpha_s, image, prompt_mask,
                          output_mode=options.output_mode,
                          refine=options.mask_refine,
                          trimap_constraint=options.trimap_constraint)
