"""ComfyUI node adapter: the ``Apply SDMatte`` node on the port
(sdmatte_tpu/api/node.py).

The public surface is the reference node's: input names, types, defaults and
ranges, return types and names, function name and category, so existing
workflows run unchanged.  The model and its weights are cached across calls,
one model at a time.  The node runs bf16 on the CUDA card; ``force_cpu``
(or a host whose device manager says CPU) runs fp32 on the CPU, and without
CUDA and without that request it raises.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from . import comfy_shim
from ..assets import manager as assets
from ..configs import SDMatteConfig
from ..core.dtypes import BF16, FP32
from ..pipeline import MattingPipeline, PipelineOptions
from ..pipeline.matting import resolve_device

_PIPELINE_CACHE: dict = {}

# Register the SDMatte model dir with the host path system at import time,
# as the reference plugin's module import does (the registry only; no file
# is touched).
try:
    comfy_shim.register_default_dirs()
except Exception:
    pass


def _resolve_config_dir() -> Optional[str]:
    """A local SD2.1 config dir in the registered diffusers paths; else the
    non-fatal config bootstrap; else None (the built-in SDMatteConfig is the
    SD2.1-base architecture)."""
    for path in comfy_shim.get_folder_paths("diffusers"):
        cand = os.path.join(path, "stable-diffusion-2-1-base")
        if os.path.isdir(cand):
            return cand
    default = os.path.join(comfy_shim.models_dir(), "diffusers",
                           "stable-diffusion-2-1-base")
    if os.path.isdir(os.path.join(default, "unet")):
        return default
    try:
        return assets.ensure_sd21_configs(default)
    except Exception as e:
        print(f"[sdmatte_tpu_torch] config bootstrap unavailable ({e}); "
              f"using built-in SD2.1 config")
        return None


def pipeline_cache_key(ckpt_path: str, *, force_cpu: bool = False,
                       policy_name: str = "bf16", speed_mode: str = "off",
                       weight_storage: str = "fp") -> tuple:
    """The cache key of a pipeline: the file, its mtime and the options."""
    return (ckpt_path, os.path.getmtime(ckpt_path), force_cpu, policy_name,
            speed_mode, weight_storage)


def get_pipeline(ckpt_name: str, *, force_cpu: bool = False,
                 policy_name: str = "bf16", speed_mode: str = "off",
                 weight_storage: str = "fp") -> MattingPipeline:
    """Build-or-fetch the cached pipeline for a checkpoint.  The pipeline's
    ``load_report`` is the checkpoint's :class:`LoadReport`."""
    from ..checkpoint import load_sdmatte_checkpoint
    from ..models.init import init_random_
    from ..models.sdmatte import SDMatte
    from ..models.tokenizer import CLIPTokenizer

    device = resolve_device("cpu" if force_cpu else None)
    models_dir = comfy_shim.register_default_dirs()
    ckpt_path = assets.download_model(
        ckpt_name, models_dir,
        search_paths=comfy_shim.get_folder_paths("SDMatte"))
    key = pipeline_cache_key(ckpt_path, force_cpu=force_cpu, policy_name=policy_name,
                             speed_mode=speed_mode, weight_storage=weight_storage)
    if key in _PIPELINE_CACHE:
        return _PIPELINE_CACHE[key]
    _PIPELINE_CACHE.clear()   # hold one model at a time

    cfg_dir = _resolve_config_dir()
    cfg = (SDMatteConfig.from_pretrained_dir(cfg_dir)
           if cfg_dir and os.path.isdir(os.path.join(cfg_dir, "unet"))
           else SDMatteConfig())
    tokenizer = None
    if cfg_dir:
        tok_dir = os.path.join(cfg_dir, "tokenizer")
        if os.path.isfile(os.path.join(tok_dir, "vocab.json")):
            tokenizer = CLIPTokenizer.from_pretrained_dir(tok_dir)

    policy = FP32 if force_cpu else {"bf16": BF16, "fp32": FP32}[policy_name]
    # strict=False: what the checkpoint lacks keeps a seeded init value
    with torch.device("meta"):
        model = SDMatte(cfg)
    init_random_(model, seed=0, device=device)
    model.to(dtype=policy.param_dtype)
    report = load_sdmatte_checkpoint(model, ckpt_path)
    print(f"[sdmatte_tpu_torch] checkpoint {os.path.basename(ckpt_path)}: "
          f"{report.summary()}")
    pipe = MattingPipeline(model, policy=policy, device=device, tokenizer=tokenizer,
                           speed_mode=speed_mode, weight_storage=weight_storage)
    pipe.load_report = report
    _PIPELINE_CACHE[key] = pipe
    return pipe


def _as_host_float(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


class SDMatteApply:
    """Drop-in 'Apply SDMatte' node on the CUDA card."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "ckpt_name": (list(assets.MODEL_URLS.keys()),),
                "image": ("IMAGE", {"tooltip": "Input image to matte"}),
                "trimap": ("MASK", {"tooltip": "Trimap mask: white=fg, "
                                               "black=bg, gray=unknown"}),
                "inference_size": ([512, 640, 768, 896, 1024], {
                    "default": 1024,
                    "tooltip": "Inference resolution; higher = better quality,"
                               " slower"}),
                "is_transparent": ("BOOLEAN", {
                    "default": False,
                    "tooltip": "Enable if the input image has an alpha/"
                               "transparent background"}),
                "output_mode": (["alpha_only", "matted_rgba", "matted_rgb"], {
                    "default": "alpha_only",
                    "tooltip": "alpha_only = mask only; matted_rgba = cutout "
                               "with transparency; matted_rgb = cutout on "
                               "black"}),
                "mask_refine": ("BOOLEAN", {
                    "default": True,
                    "tooltip": "Trimap-constrained alpha refinement"}),
                "trimap_constraint": ("FLOAT", {
                    "default": 0.8, "min": 0.1, "max": 1.0, "step": 0.1,
                    "tooltip": "Constraint strength: higher = stricter "
                               "filtering by the trimap"}),
            },
            "optional": {
                "force_cpu": ("BOOLEAN", {"default": False}),
            },
        }

    RETURN_TYPES = ("MASK", "IMAGE")
    RETURN_NAMES = ("alpha_mask", "matted_image")
    FUNCTION = "apply_matte"
    CATEGORY = "Matting/SDMatte"

    def apply_matte(self, ckpt_name, image, trimap, inference_size,
                    is_transparent, output_mode, mask_refine,
                    trimap_constraint, force_cpu=False) -> Tuple:
        """ComfyUI's image (B,H,W,C) and trimap (B,H,W) in [0, 1] -> (alpha
        (B,H,W), matted (B,H,W,3|4)) as CPU fp32 contiguous tensors of their
        own (writable, sharing no memory with the pipeline)."""
        img = _as_host_float(image)
        tri = _as_host_float(trimap)
        if tri.ndim == 2:
            tri = tri[None]
        # a CPU-only host makes force_cpu implicit, as in the reference
        force_cpu = bool(force_cpu) or comfy_shim.host_prefers_cpu()
        pipe = get_pipeline(ckpt_name, force_cpu=force_cpu)
        opts = PipelineOptions(
            inference_size=int(inference_size),
            is_transparent=bool(is_transparent),
            output_mode=str(output_mode),
            mask_refine=bool(mask_refine),
            trimap_constraint=float(trimap_constraint),
        )
        alpha, matted = pipe(img, tri, options=opts)
        out = tuple(t.to("cpu", torch.float32).contiguous().clone() for t in (alpha, matted))
        comfy_shim.soft_empty_cache()
        return out


NODE_CLASS_MAPPINGS = {"SDMatteApply": SDMatteApply}
NODE_DISPLAY_NAME_MAPPINGS = {"SDMatteApply": "Apply SDMatte"}
