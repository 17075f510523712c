"""SD2.1 VAE (AutoencoderKL) of the port (sdmatte_tpu/models/vae.py).

Parameter names are the checkpoint's under ``vae.``.  Encode is
deterministic (the moments' mean times ``scaling_factor``).  The encoder's
3x3 convs at the dispatch table's shapes run the conv kernel K3 with the
GroupNorm+SiLU prologue and residual epilogue; the mid-block's single-head
attention (scale 1/sqrt(c)) runs K2 on the card.  Under ``vae_int8``
(ops/quant.quantize_vae_tree) every 3x3 conv here, the stride-2
downsamplers and the upsamplers' convs included, runs the int8 conv K4
instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..configs import VAEConfig
from ..core import nn as F
from ..core.dtypes import FP32, Policy
from ..ops.flash_attention import flash_attention


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: VAEConfig):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.norm1 = nn.GroupNorm(g, cin, eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(g, cout, eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, policy: Policy):
        h = F.gn_silu_conv2d(self.norm1, self.conv1, x, policy=policy)
        res = x
        if self.conv_shortcut is not None:
            res = F.conv2d(self.conv_shortcut, x, padding=0, policy=policy)
        return F.gn_silu_conv2d(self.norm2, self.conv2, h, policy=policy, residual=res)


class AttentionBlock(nn.Module):
    """Single-head spatial self-attention (diffusers VAE mid-block)."""

    def __init__(self, c: int, cfg: VAEConfig):
        super().__init__()
        self.group_norm = nn.GroupNorm(cfg.norm_num_groups, c, cfg.norm_eps)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x, policy: Policy):
        b, c, h, w = x.shape
        cd = policy.compute_dtype
        y = F.group_norm(self.group_norm, x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q = F.linear(self.to_q, y, policy).to(cd)
        k = F.linear(self.to_k, y, policy).to(cd)
        v = F.linear(self.to_v, y, policy).to(cd)
        o = flash_attention(q[:, None], k[:, None], v[:, None], scale=1.0 / math.sqrt(c))[:, 0]
        o = F.linear(self.to_out[0], o.reshape(b, h * w, c), policy).to(x.dtype)
        return x + o.reshape(b, h, w, c).permute(0, 3, 1, 2)


class MidBlock(nn.Module):
    def __init__(self, c: int, cfg: VAEConfig):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(c, c, cfg), ResnetBlock(c, c, cfg)])
        self.attentions = nn.ModuleList([AttentionBlock(c, cfg)])

    def forward(self, x, policy: Policy):
        x = self.resnets[0](x, policy)
        x = self.attentions[0](x, policy)
        return self.resnets[1](x, policy)


class _Sampler(nn.Module):
    """Holds ``conv`` so its key reads ``downsamplers.0.conv`` / ``upsamplers.0.conv``."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)


class _Stage(nn.Module):
    def __init__(self, resnets, sampler_name=None, c=0):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler_name:
            setattr(self, sampler_name, nn.ModuleList([_Sampler(c)]))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = list(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        blocks, cin = [], ch[0]
        for i, cout in enumerate(ch):
            res = [ResnetBlock(cin if j == 0 else cout, cout, cfg)
                   for j in range(cfg.layers_per_block)]
            blocks.append(_Stage(res, "downsamplers" if i < len(ch) - 1 else None, cout))
            cin = cout
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(ch[-1], cfg)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, ch[-1], cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0], cfg)
        blocks, cin = [], rev[0]
        for i, cout in enumerate(rev):
            res = [ResnetBlock(cin if j == 0 else cout, cout, cfg)
                   for j in range(cfg.layers_per_block + 1)]
            blocks.append(_Stage(res, "upsamplers" if i < len(rev) - 1 else None, cout))
            cin = cout
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, rev[-1], cfg.norm_eps)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        lat = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode_moments(self, x, *, policy: Policy = FP32):
        """(B, 3, S, S) image in [-1, 1] -> (mean, logvar), latent_channels each."""
        e = self.encoder
        h = F.conv2d(e.conv_in, x, policy=policy)
        n = len(e.down_blocks)
        for i, blk in enumerate(e.down_blocks):
            for res in blk.resnets:
                h = res(h, policy)
            if i < n - 1:
                # stride-2 conv with (0, 1), (0, 1) padding (diffusers Downsample2D)
                h = F.conv2d(blk.downsamplers[0].conv, h, stride=2,
                             padding=((0, 1), (0, 1)), policy=policy)
        h = e.mid_block(h, policy)
        h = F.gn_silu(e.conv_norm_out, h)
        h = F.conv2d(e.conv_out, h, policy=policy)
        moments = F.conv2d(self.quant_conv, h, padding=0, policy=policy)
        return moments.chunk(2, dim=1)

    def encode(self, x, *, policy: Policy = FP32):
        """Deterministic latent: mean * scaling_factor."""
        mean, _ = self.encode_moments(x, policy=policy)
        return mean * torch.tensor(self.cfg.scaling_factor, dtype=mean.dtype)

    def decode(self, z, *, policy: Policy = FP32):
        """Latent (already divided by scaling_factor) -> image in [-1, 1]."""
        d = self.decoder
        h = F.conv2d(self.post_quant_conv, z, padding=0, policy=policy)
        h = F.conv2d(d.conv_in, h, policy=policy)
        h = d.mid_block(h, policy)
        n = len(d.up_blocks)
        for i, blk in enumerate(d.up_blocks):
            for res in blk.resnets:
                h = res(h, policy)
            if i < n - 1:
                h = F.upsample2x_conv(blk.upsamplers[0].conv, h, policy=policy)
        h = F.gn_silu(d.conv_norm_out, h)
        return F.conv2d(d.conv_out, h, policy=policy)
