"""SDMatte meta-architecture of the port: one deterministic U-Net pass from
image + prompt to alpha (sdmatte_tpu/models/sdmatte.py).

  * one VAE encode of rgb || aux as a batch of 2B (deterministic mean), or
    two passes, rgb then aux, when 2B > 16 or when asked (the split encode)
  * the coordinate embedding: trimap, mask and bbox prompts take the bbox
    branch, point prompts the point branch
  * attention mask = nearest 1/8 of (aux + 1) / 2, flattened HW-major
  * opacity trans = 1 - is_trans drives the time embedding
  * alpha = clip(channel mean of the decoded image), remapped to [0, 1]

Opt-in, out of parity, never the default: ``vae_chunk`` runs the VAE's
encode and decode over the batch in chunks, which caps peak memory for
large batches; the speed modes encode an input at S/2 (then upsample its
latent back to S/8) or decode the alpha latent at half resolution.

Inputs are NCHW tensors.  The CLIP text tower runs only when a stage's
``use_encoder_hidden_states_list`` entry is False: that stage's
cross-attention then reads the 77 text tokens of ``data["text_ids"]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as tF
from torch import nn

from ..configs import AUX_INPUT_COORDS, SDMatteConfig
from ..core.dtypes import FP32, Policy
from ..core.embeddings import point_coords_padding, sinusoidal_embedding
from ..core.imaging import resize_bilinear, resize_nearest
from .clip import CLIPTextModel
from .unet import MatteUNet
from .vae import AutoencoderKL


def _coords_embed(cfg: SDMatteConfig, aux_type: str, coords: torch.Tensor) -> dict:
    """Coordinate conditioning: (B, 1680) point or (B, 1280) bbox embedding."""
    b = coords.shape[0]
    coords = coords.float()
    if AUX_INPUT_COORDS[aux_type] == "point_coords":
        n = coords.shape[1]
        padded, channels = point_coords_padding(n, cfg.unet.point_embeddings_input_dim)
        coor = tF.pad(coords, (0, padded - n))
        if not cfg.use_coor_input:
            coor = torch.zeros_like(coor)
        emb = sinusoidal_embedding(coor.reshape(-1), channels)
        return {"point_coords": emb.reshape(b, -1)}
    # bbox / mask / trimap / auto all take the bbox branch
    if not cfg.use_coor_input:
        # the full-frame box [0, 0, 1, 1], made on the device (no host copy)
        coords = torch.zeros((b, 4), device=coords.device)
        coords[:, 2:] = 1.0
    emb = sinusoidal_embedding(coords.reshape(-1), 320)
    return {"bbox_mask_coords": emb.reshape(b, -1)}


def _chunked(fn, x: torch.Tensor, chunk: Optional[int]) -> torch.Tensor:
    """``fn`` over the batch in ``chunk``-sized groups, one after another,
    which caps the peak memory of the pixel-space VAE stages.  When the
    batch does not divide ``chunk``, the largest divisor below it is used:
    running unchunked would defeat the only purpose of the knob."""
    b = x.shape[0]
    if not chunk or b <= chunk:
        return fn(x)
    if b % chunk:
        chunk = max(c for c in range(1, chunk + 1) if b % c == 0)
    return torch.cat([fn(part) for part in torch.split(x, chunk)], dim=0)


def _resize(x: torch.Tensor, h: int, w: int, *, antialias: bool) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor through the NHWC resampler, in the
    input's dtype."""
    return resize_bilinear(x.permute(0, 2, 3, 1), h, w,
                           antialias=antialias).permute(0, 3, 1, 2)


class SDMatte(nn.Module):
    def __init__(self, cfg: SDMatteConfig):
        super().__init__()
        self.cfg = cfg
        self.vae = AutoencoderKL(cfg.vae)
        self.unet = MatteUNet(cfg.unet)
        # after vae and unet: init_random_ fills parameters in this order
        self.text_encoder = CLIPTextModel(cfg.clip)

    def forward(self, data: dict, *, aux_input_type: Optional[str] = None,
                policy: Policy = FP32, vae_chunk: Optional[int] = None,
                vae_encode_split: Optional[bool] = None,
                speed_aux_half: bool = False, speed_rgb_half: bool = False,
                speed_decode_half: bool = False,
                return_intermediates: bool = False, remat: bool = False):
        """data (NCHW tensors): image (B, 3, S, S) in [-1, 1]; <aux_type>
        (B, 1, S, S) in [-1, 1]; <aux>_coords (B, 4), or (B, N) for points;
        is_trans (B,); text_ids (B, 77) token ids, needed only under text
        gating.

        Returns alpha (B, 1, S, S) fp32 in [0, 1]; with
        ``return_intermediates`` (alpha, dict of rgb_latent, aux_latent,
        aux_tokens, unet_out, decoded and feature_maps), else under
        ``cfg.use_dis_loss`` (alpha, feature_maps).  ``remat``
        rematerialises the U-Net's blocks on the backward pass (training)."""
        cfg = self.cfg
        aux_type = aux_input_type or cfg.aux_input
        rgb = data["image"]
        b, s = rgb.shape[0], rgb.shape[2]

        if not cfg.use_aux_input:
            raise NotImplementedError(
                "use_aux_input=False has no working forward path (the "
                "reference crashes identically); SDMatte checkpoints require "
                "the aux latent")

        # -- latents ------------------------------------------------------
        aux = data[aux_type]
        aux3 = aux.expand(b, 3, s, s).to(rgb.dtype)

        def half(x):
            return _resize(x, x.shape[2] // 2, x.shape[3] // 2, antialias=True)

        def to_latent_grid(lat):
            hl, wl = rgb.shape[2] // 8, rgb.shape[3] // 8
            if lat.shape[2:] == (hl, wl):
                return lat
            return _resize(lat, hl, wl, antialias=False)

        def enc(x):
            # the encoder runs in channels_last (NHWC memory, what K3 reads)
            x = x.contiguous(memory_format=torch.channels_last)
            return self.vae.encode(x, policy=policy)

        split = vae_encode_split
        if split is None:
            # one concat pass doubles the encoder's peak activations; two
            # passes of the same math keep batches above 8 in memory
            split = 2 * b > 16
        rgb_src = half(rgb) if speed_rgb_half else rgb
        aux_src = half(aux3) if speed_aux_half else aux3
        if rgb_src.shape[2] == aux_src.shape[2] and not split:
            lat = _chunked(enc, torch.cat([rgb_src, aux_src], dim=0), vae_chunk)
            rgb_latent, aux_latent = lat[:b], lat[b:]
        else:
            rgb_latent = _chunked(enc, rgb_src, vae_chunk)
            aux_latent = _chunked(enc, aux_src, vae_chunk)
        rgb_latent = to_latent_grid(rgb_latent)
        aux_latent = to_latent_grid(aux_latent)

        coords_embed = _coords_embed(cfg, aux_type, data[AUX_INPUT_COORDS[aux_type]])

        # -- latent-resolution prompt mask --------------------------------
        latent_mask = None
        if aux_type in cfg.attn_mask_aux_input and (
                cfg.use_attention_mask or cfg.use_encoder_attention_mask):
            m = resize_nearest((aux + 1.0) * 0.5, s // 8, s // 8)
            latent_mask = m.reshape(b, -1)
        attention_mask = latent_mask if cfg.use_attention_mask else None

        aux_tokens = None
        if cfg.use_encoder_hidden_states:
            aux_tokens = self.unet.aux_tokens(aux_latent, policy=policy)
        text_tokens = None
        if not all(cfg.unet.use_encoder_hidden_states_list):
            text_tokens = self.text_encoder(data["text_ids"], policy=policy)
        trans = 1.0 - data["is_trans"].float().reshape(-1)
        enc_mask = latent_mask if (cfg.use_encoder_attention_mask and latent_mask is not None
                                   and aux_tokens is not None) else None

        cd = policy.compute_dtype
        want_features = cfg.use_dis_loss or return_intermediates
        sample = torch.cat([rgb_latent, aux_latent], dim=1).to(cd)
        out = self.unet(sample=sample, trans=trans,
                        encoder_hidden_states=aux_tokens,
                        encoder_hidden_states_2=text_tokens,
                        coords_embed=coords_embed,
                        attention_mask=attention_mask,
                        encoder_attention_mask=enc_mask,
                        policy=policy, return_features=want_features,
                        remat=remat)
        label_latent, feature_maps = out if want_features else (out, None)

        # -- decode + alpha head ------------------------------------------
        z = label_latent.to(cd) / torch.tensor(cfg.vae.scaling_factor, dtype=cd)
        if speed_decode_half:
            z = _resize(z, z.shape[2] // 2, z.shape[3] // 2, antialias=False)
        decoded = _chunked(lambda zz: self.vae.decode(zz, policy=policy), z, vae_chunk)
        alpha = decoded.float().mean(dim=1, keepdim=True).clamp(-1.0, 1.0)
        alpha = (alpha + 1.0) * 0.5
        if return_intermediates:
            return alpha, {"rgb_latent": rgb_latent, "aux_latent": aux_latent,
                           "aux_tokens": aux_tokens, "unet_out": label_latent,
                           "decoded": decoded, "feature_maps": feature_maps}
        if cfg.use_dis_loss:
            return alpha, feature_maps
        return alpha
