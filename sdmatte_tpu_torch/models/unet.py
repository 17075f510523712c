"""MatteUNet of the port: the SD2.1 U-Net with SDMatte's conditioning built in
(sdmatte_tpu/models/unet.py).

Parameter names are the checkpoint's under ``unet.``.  Opacity drives the
time embedding (``timestep`` is None on the matting path), the bbox or the
point head adds the prompt's coordinate embedding, and the latent-resolution
prompt mask biases SELF-attention only, as (1 - m) * -10000 nearest-resized
to each resolution.  Every attention site runs the hand kernel K1 on the card; the
convs are ``torch.nn.functional.conv2d``, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..configs import UNetConfig
from ..core import nn as F
from ..core.dtypes import FP32, Policy
from ..core.embeddings import sinusoidal_embedding
from ..core.imaging import resize_nearest
from ..ops.attention import attention

NEG_BIAS = -10000.0


class TimestepEmbedding(nn.Module):
    """diffusers TimestepEmbedding: linear -> silu -> linear."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, cout)
        self.linear_2 = nn.Linear(cout, cout)

    def forward(self, x, policy: Policy):
        return F.linear(self.linear_2, F.silu(F.linear(self.linear_1, x, policy)), policy)


class Attention(nn.Module):
    def __init__(self, c: int, ctx_dim: int):
        super().__init__()
        self.to_q = nn.Linear(c, c, bias=False)
        self.to_k = nn.Linear(ctx_dim, c, bias=False)
        self.to_v = nn.Linear(ctx_dim, c, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x, ctx, *, heads: int, bias, policy: Policy, impl: str,
                residual: bool = False):
        """q from x, k/v from ctx, per-key bias (B, Lk); ``residual`` is
        diffusers' ``Attention.residual_connection``."""
        b, lq, c = x.shape
        lk, d = ctx.shape[1], c // heads
        cd = policy.compute_dtype
        q = F.linear(self.to_q, x, policy).view(b, lq, heads, d).transpose(1, 2)
        k = F.linear(self.to_k, ctx, policy).view(b, lk, heads, d).transpose(1, 2)
        v = F.linear(self.to_v, ctx, policy).view(b, lk, heads, d).transpose(1, 2)
        o = attention(q.to(cd), k.to(cd), v.to(cd), scale=1.0 / math.sqrt(d),
                      bias=bias, impl=impl)
        out = F.linear(self.to_out[0], o.transpose(1, 2).reshape(b, lq, c), policy)
        return out + x.to(out.dtype) if residual else out


class _GEGLU(nn.Module):
    def __init__(self, c: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(c, 2 * inner)


class FeedForward(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.net = nn.ModuleList([_GEGLU(c, 4 * c), nn.Identity(), nn.Linear(4 * c, c)])

    def forward(self, x, policy: Policy):
        return F.linear(self.net[2], F.geglu(self.net[0].proj, x, policy), policy)


class BasicTransformerBlock(nn.Module):
    def __init__(self, c: int, cfg: UNetConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(c)
        self.attn1 = Attention(c, c)
        self.norm2 = nn.LayerNorm(c)
        self.attn2 = Attention(c, cfg.cross_attention_dim)
        self.norm3 = nn.LayerNorm(c)
        self.ff = FeedForward(c)


class Transformer2D(nn.Module):
    """Transformer2DModel with use_linear_projection=True (SD2.1)."""

    def __init__(self, c: int, cfg: UNetConfig):
        super().__init__()
        self.norm = nn.GroupNorm(cfg.norm_num_groups, c, cfg.transformer_norm_eps)
        self.proj_in = nn.Linear(c, c)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(c, cfg)])
        self.proj_out = nn.Linear(c, c)
        self.residual_attn1 = cfg.residual_connection and c == 320

    def forward(self, x, ctx, *, heads: int, bias_self, bias_cross,
                policy: Policy, impl: str):
        b, c, h, w = x.shape
        y = F.group_norm(self.norm, x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = F.linear(self.proj_in, y, policy).to(x.dtype)
        tb = self.transformer_blocks[0]
        n1 = F.layer_norm(tb.norm1, y)
        y = y + tb.attn1(n1, n1, heads=heads, bias=bias_self, policy=policy,
                         impl=impl, residual=self.residual_attn1).to(y.dtype)
        y = y + tb.attn2(F.layer_norm(tb.norm2, y), ctx, heads=heads,
                         bias=bias_cross, policy=policy, impl=impl).to(y.dtype)
        y = y + tb.ff(F.layer_norm(tb.norm3, y), policy).to(y.dtype)
        y = F.linear(self.proj_out, y, policy).to(x.dtype)
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, cfg: UNetConfig):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.norm1 = nn.GroupNorm(g, cin, eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = nn.GroupNorm(g, cout, eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb, policy: Policy, impl: str):
        h = F.conv2d(self.conv1, F.gn_silu(self.norm1, x), policy=policy, impl=impl)
        t = F.linear(self.time_emb_proj, F.silu(emb), policy).to(h.dtype)
        h = h + t[:, :, None, None]
        h = F.conv2d(self.conv2, F.gn_silu(self.norm2, h), policy=policy, impl=impl)
        if self.conv_shortcut is not None:
            x = F.conv2d(self.conv_shortcut, x, padding=0, policy=policy, impl=impl)
        return x + h


class _Sampler(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)


class _Stage(nn.Module):
    def __init__(self, resnets, attentions, sampler_name, c):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        if sampler_name:
            setattr(self, sampler_name, nn.ModuleList([_Sampler(c)]))


class _MidBlock(nn.Module):
    def __init__(self, c: int, temb: int, cfg: UNetConfig):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(c, c, temb, cfg),
                                      ResnetBlock(c, c, temb, cfg)])
        self.attentions = nn.ModuleList([Transformer2D(c, cfg)])


class _BiasPyramid:
    """The latent-resolution mask nearest-resized to each attention
    resolution as an additive per-key bias (1 - m) * -10000, built once per
    resolution per forward."""

    def __init__(self, mask, h0: int, w0: int):
        self._grid = None if mask is None else mask.reshape(mask.shape[0], 1, h0, w0)
        self._cache = {}

    def at(self, h: int, w: int):
        if self._grid is None:
            return None
        if (h, w) not in self._cache:
            m = resize_nearest(self._grid, h, w).reshape(self._grid.shape[0], h * w)
            self._cache[(h, w)] = (1.0 - m.float()) * NEG_BIAS
        return self._cache[(h, w)]


class MatteUNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        ch = list(cfg.block_out_channels)
        ted = cfg.time_embed_dim
        n = len(ch)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.aux_conv_in = nn.Conv2d(cfg.aux_in_channels, cfg.aux_token_dim, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], ted)
        self.point_embedding = TimestepEmbedding(cfg.point_embeddings_input_dim, ted)
        self.bbox_embedding = TimestepEmbedding(cfg.bbox_embeddings_input_dim, ted)

        skip_ch = [ch[0]]
        down, cin = [], ch[0]
        for i, cout in enumerate(ch):
            res, att = [], []
            for j in range(cfg.layers_per_block):
                res.append(ResnetBlock(cin if j == 0 else cout, cout, ted, cfg))
                if cfg.down_has_attn[i]:
                    att.append(Transformer2D(cout, cfg))
                skip_ch.append(cout)
            if i < n - 1:
                skip_ch.append(cout)
            down.append(_Stage(res, att, "downsamplers" if i < n - 1 else None, cout))
            cin = cout
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _MidBlock(ch[-1], ted, cfg)

        up, prev = [], ch[-1]
        for i, cout in enumerate(reversed(ch)):
            res, att = [], []
            for j in range(cfg.layers_per_block + 1):
                rin = (prev if j == 0 else cout) + skip_ch.pop()
                res.append(ResnetBlock(rin, cout, ted, cfg))
                if cfg.up_has_attn[i]:
                    att.append(Transformer2D(cout, cfg))
            up.append(_Stage(res, att, "upsamplers" if i < n - 1 else None, cout))
            prev = cout
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, ch[0], cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def aux_tokens(self, aux_latent, *, policy: Policy = FP32, impl: str = "auto"):
        """aux latent (B, 4, h, w) -> cross-attention context (B, h*w, C),
        tokens in HW-major order."""
        t = F.conv2d(self.aux_conv_in, aux_latent, policy=policy, impl=impl)
        b, c, h, w = t.shape
        return t.permute(0, 2, 3, 1).reshape(b, h * w, c)

    def forward(self, *, sample, trans, encoder_hidden_states,
                encoder_hidden_states_2=None,
                coords_embed: Optional[dict] = None, attention_mask=None,
                encoder_attention_mask=None, policy: Policy = FP32,
                impl: str = "auto", return_features: bool = False):
        """One U-Net pass with ``timestep`` None (the matting path).

        sample (B, 8, h, w) rgb||aux latents; trans (B,) opacity label;
        encoder_hidden_states (B, L0, C) aux tokens; encoder_hidden_states_2
        (B, 77, C) text tokens, the context of each stage whose
        ``use_encoder_hidden_states_list`` entry is False; coords_embed
        {"bbox_mask_coords": (B, 1280)} or {"point_coords": (B, 1680)};
        attention_mask (B, h*w) in [0, 1].

        With ``return_features`` (the reference's distillation hooks)
        returns ``(out, [after down, after mid, after up])``, NCHW."""
        cfg = self.cfg
        b, _, h0, w0 = sample.shape
        ch = list(cfg.block_out_channels)
        cd = policy.compute_dtype

        tr = trans.float().reshape(-1).expand(b)
        op = sinusoidal_embedding(tr, ch[0], flip_sin_to_cos=cfg.flip_sin_to_cos,
                                  downscale_freq_shift=cfg.freq_shift)
        emb = self.time_embedding(op.to(cd), policy)
        if coords_embed:
            if "point_coords" in coords_embed:
                ce, head = coords_embed["point_coords"], self.point_embedding
            elif "bbox_mask_coords" in coords_embed:
                ce, head = coords_embed["bbox_mask_coords"], self.bbox_embedding
            else:
                raise ValueError("coords_embed must contain point_coords or "
                                 "bbox_mask_coords")
            emb = emb + head(ce.reshape(b, -1).to(cd), policy)
        emb = emb.to(cd)

        biases = _BiasPyramid(attention_mask, h0, w0)
        mask_on = tuple(cfg.use_attention_mask_list)
        # per-stage [down, mid, up] context: aux tokens, or text tokens
        ctxs = tuple(encoder_hidden_states if u else encoder_hidden_states_2
                     for u in cfg.use_encoder_hidden_states_list)
        enc_bias = None
        if encoder_attention_mask is not None:
            enc_bias = (1.0 - encoder_attention_mask.float()) * NEG_BIAS

        def stage_bias(stage, hh, ww):
            bias_self = biases.at(hh, ww) if mask_on[stage] else None
            bias_cross = None
            ctx = ctxs[stage]
            if enc_bias is not None and ctx is not None and enc_bias.shape[1] == ctx.shape[1]:
                bias_cross = enc_bias
            return bias_self, bias_cross

        heads = list(cfg.attention_head_dim)

        def transformer(t, x, stage, heads_i):
            bs, bc = stage_bias(stage, x.shape[2], x.shape[3])
            return t(x, ctxs[stage], heads=heads_i, bias_self=bs, bias_cross=bc,
                     policy=policy, impl=impl)

        x = F.conv2d(self.conv_in, sample, policy=policy, impl=impl)
        skips = [x]
        n = len(ch)
        for i, blk in enumerate(self.down_blocks):
            for j, res in enumerate(blk.resnets):
                x = res(x, emb, policy, impl)
                if blk.attentions is not None:
                    x = transformer(blk.attentions[j], x, 0, heads[i])
                skips.append(x)
            if i < n - 1:
                x = F.conv2d(blk.downsamplers[0].conv, x, stride=2, policy=policy, impl=impl)
                skips.append(x)

        features = [x]
        mid = self.mid_block
        x = mid.resnets[0](x, emb, policy, impl)
        x = transformer(mid.attentions[0], x, 1, heads[-1])
        x = mid.resnets[1](x, emb, policy, impl)
        features.append(x)

        for i, blk in enumerate(self.up_blocks):
            for j, res in enumerate(blk.resnets):
                x = torch.cat([x, skips.pop()], dim=1)
                x = res(x, emb, policy, impl)
                if blk.attentions is not None:
                    x = transformer(blk.attentions[j], x, 2, heads[n - 1 - i])
            if i < n - 1:
                # nearest 2x to the next skip's size; odd sizes resize + conv
                th, tw = skips[-1].shape[2:] if skips else (2 * x.shape[2], 2 * x.shape[3])
                up = blk.upsamplers[0].conv
                if (th, tw) == (2 * x.shape[2], 2 * x.shape[3]):
                    x = F.upsample2x_conv(up, x, policy=policy, impl=impl)
                else:
                    x = F.conv2d(up, resize_nearest(x, th, tw), policy=policy, impl=impl)

        features.append(x)
        x = F.gn_silu(self.conv_norm_out, x)
        out = F.conv2d(self.conv_out, x, policy=policy, impl=impl)
        return (out, features) if return_features else out
