"""SDMatte meta-architecture of the port: one deterministic U-Net pass from
image + prompt to alpha (sdmatte_tpu/models/sdmatte.py), trimap/bbox branch.

  * one VAE encode of rgb || trimap as a batch of 2B (deterministic mean)
  * the bbox coordinate embedding (trimap prompts take the bbox branch)
  * attention mask = nearest 1/8 of (aux + 1) / 2, flattened HW-major
  * opacity trans = 1 - is_trans drives the time embedding
  * alpha = clip(channel mean of the decoded image), remapped to [0, 1]

Inputs are NCHW tensors.  The text tower is not ported: it never runs under
the default [T, T, T] gating, and a config that needs it raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs import AUX_INPUT_COORDS, SDMatteConfig
from ..core.dtypes import FP32, Policy
from ..core.embeddings import sinusoidal_embedding
from ..core.imaging import resize_nearest
from .unet import MatteUNet
from .vae import AutoencoderKL


# ROADMAP entries are named by their titles
_META_PATHS = 'ROADMAP Queue 1: "Remaining meta-arch paths"'
_TEXT_TOWER = 'ROADMAP Queue 1: "Text tower"'


def _todo(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet ({item})")


class SDMatte(nn.Module):
    def __init__(self, cfg: SDMatteConfig):
        super().__init__()
        self.cfg = cfg
        self.vae = AutoencoderKL(cfg.vae)
        self.unet = MatteUNet(cfg.unet)

    def forward(self, data: dict, *, aux_input_type: Optional[str] = None,
                policy: Policy = FP32, impl: str = "auto",
                vae_chunk: Optional[int] = None,
                vae_encode_split: Optional[bool] = None,
                speed_aux_half: bool = False, speed_rgb_half: bool = False,
                speed_decode_half: bool = False,
                return_intermediates: bool = False):
        """data (NCHW tensors): image (B, 3, S, S) in [-1, 1]; <aux_type>
        (B, 1, S, S) in [-1, 1]; <aux>_coords (B, 4); is_trans (B,).
        Returns alpha (B, 1, S, S) fp32 in [0, 1]."""
        cfg = self.cfg
        aux_type = aux_input_type or cfg.aux_input
        rgb = data["image"]
        b, s = rgb.shape[0], rgb.shape[2]

        if not cfg.use_aux_input:
            raise NotImplementedError(
                "use_aux_input=False has no working forward path (the "
                "reference crashes identically); SDMatte checkpoints require "
                "the aux latent")
        if AUX_INPUT_COORDS[aux_type] == "point_coords":
            raise _todo("the point-prompt branch", _META_PATHS)
        if speed_aux_half or speed_rgb_half or speed_decode_half:
            raise _todo("the speed modes", _META_PATHS)
        if vae_chunk:
            raise _todo("vae_chunk", _META_PATHS)
        if vae_encode_split or (vae_encode_split is None and 2 * b > 16):
            raise _todo("the split VAE encode", _META_PATHS)
        if return_intermediates or cfg.use_dis_loss:
            raise _todo("return_intermediates and the distillation features",
                        f'{_META_PATHS} and "Training, video, multi-device"')
        if not all(cfg.unet.use_encoder_hidden_states_list):
            raise _todo("text-conditioned gating (the CLIP text tower)",
                        _TEXT_TOWER)

        # -- latents: one concat-batch encode of rgb || aux ---------------
        aux = data[aux_type]
        aux3 = aux.expand(b, 3, s, s).to(rgb.dtype)
        # the encoder runs in channels_last (NHWC memory, what K3 reads)
        pair = torch.cat([rgb, aux3], dim=0).contiguous(memory_format=torch.channels_last)
        lat = self.vae.encode(pair, policy=policy, impl=impl)
        rgb_latent, aux_latent = lat[:b], lat[b:]

        # -- coordinate conditioning (bbox branch) -----------------------
        coords = data[AUX_INPUT_COORDS[aux_type]].float()
        if not cfg.use_coor_input:
            coords = torch.tensor([[0.0, 0.0, 1.0, 1.0]], device=coords.device).expand(b, 4)
        coords_embed = {"bbox_mask_coords":
                        sinusoidal_embedding(coords.reshape(-1), 320).reshape(b, -1)}

        # -- latent-resolution prompt mask --------------------------------
        latent_mask = None
        if aux_type in cfg.attn_mask_aux_input and (
                cfg.use_attention_mask or cfg.use_encoder_attention_mask):
            m = resize_nearest((aux + 1.0) * 0.5, s // 8, s // 8)
            latent_mask = m.reshape(b, -1)
        attention_mask = latent_mask if cfg.use_attention_mask else None

        aux_tokens = None
        if cfg.use_encoder_hidden_states:
            aux_tokens = self.unet.aux_tokens(aux_latent, policy=policy, impl=impl)
        trans = 1.0 - data["is_trans"].float().reshape(-1)
        enc_mask = latent_mask if (cfg.use_encoder_attention_mask and latent_mask is not None
                                   and aux_tokens is not None) else None

        cd = policy.compute_dtype
        sample = torch.cat([rgb_latent, aux_latent], dim=1).to(cd)
        label_latent = self.unet(sample=sample, trans=trans,
                                 encoder_hidden_states=aux_tokens,
                                 coords_embed=coords_embed,
                                 attention_mask=attention_mask,
                                 encoder_attention_mask=enc_mask,
                                 policy=policy, impl=impl)

        # -- decode + alpha head ------------------------------------------
        z = label_latent.to(cd) / torch.tensor(cfg.vae.scaling_factor, dtype=cd)
        decoded = self.vae.decode(z, policy=policy, impl=impl)
        alpha = decoded.float().mean(dim=1, keepdim=True).clamp(-1.0, 1.0)
        return (alpha + 1.0) * 0.5
