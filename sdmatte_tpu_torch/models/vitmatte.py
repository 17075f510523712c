"""ViTMatte of the port (hustvl/ViTMatte, arXiv:2305.15272): a ViTDet
backbone over photo || trimap at the photo's own resolution, and a conv
detail decoder.  Parameter names are transformers'
``VitMatteForImageMatting`` names, so its ``model.safetensors`` loads with no
key mapping (``checkpoint/loader.load_vitmatte_checkpoint``).

  embed    a 16 x 16, stride-16 conv from 4 channels, plus the absolute
           position table (14 x 14 and a cls row, which is dropped)
           resized bicubically to the token grid
  blocks   pre-norm: x + attn(LN(x)), then x + MLP(LN(x)) (exact GELU); a
           windowed block attends in window x window windows of the grid,
           zero-padded after its first norm (the padded tokens are keys
           with no mask); a global block attends over the whole grid and is
           followed by a residual bottleneck (1x1, 3x3, 1x1 convs, each with
           a LayerNorm over channels, GELU after the first two)
  rel-pos  every score adds Rh[q, row(k)] + Rw[q, col(k)] from the unscaled
           q and the block's tables, resized linearly to 2 * side - 1 rows
           (ops/attention.relpos_terms; K1's relative-position mode)
  decoder  ConvStream (3x3 stride-2 conv, BatchNorm, ReLU: 4 -> 48 -> 96 ->
           192), four fusion blocks (bilinear x2 of the features, the detail
           map of that scale in front, 3x3 conv, BatchNorm, ReLU) and the
           head (3x3 conv, BatchNorm, ReLU, 1x1 conv, sigmoid)

Tokens are kept NHWC, which is the ``channels_last`` memory of the convs'
NCHW.  The residual stream between blocks stays fp32 under the bf16
policy, as autocast keeps it: every norm, linear and conv reads it cast to
the compute dtype, and each block's output is added to it in fp32.  The
position tables depend only on the weights and the grid, so
each grid size's tables are made once (``vitmatte.tables_built`` counts
them) and kept until the weights are loaded or moved again.  BatchNorm runs
with its running statistics, folded into its conv.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as tF
from torch import nn

from ..configs import ViTMatteConfig
from ..core import nn as F
from ..core import tables
from ..core.dtypes import FP32, Policy
from ..ops.attention import attention, relpos_terms
from ..utils import observability


class BatchNorm(nn.Module):
    """Inference BatchNorm: ``weight``, ``bias``, ``running_mean`` and
    ``running_var`` (torch's names, without its ``num_batches_tracked``)."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def affine(self):
        """(scale, shift) fp32 with BatchNorm(x) = x * scale + shift."""
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        return scale, self.bias.float() - self.running_mean.float() * scale


class ConvBN(nn.Module):
    """transformers' ``VitMatteBasicConv3x3``: conv (no bias), BatchNorm, ReLU."""

    def __init__(self, cin: int, cout: int, eps: float):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, bias=False)
        self.batch_norm = BatchNorm(cout, eps)

    def forward(self, x, *, stride: int, policy: Policy):
        y = F.conv2d_affine(self.conv, x, *self.batch_norm.affine(), stride=stride,
                            policy=policy)
        return tF.relu(y, inplace=True)


class Attention(nn.Module):
    def __init__(self, cfg: ViTMatteConfig, table_rows: int):
        super().__init__()
        c, d = cfg.hidden_size, cfg.head_dim
        self.heads = cfg.num_attention_heads
        self.qkv = nn.Linear(c, 3 * c, bias=cfg.qkv_bias)
        self.proj = nn.Linear(c, c)
        self.rel_pos_h = nn.Parameter(torch.zeros(table_rows, d))
        self.rel_pos_w = nn.Parameter(torch.zeros(table_rows, d))

    def forward(self, x, tab_h, tab_w, *, policy: Policy, impl: str):
        """x (B, gh, gw, C) -> (B, gh, gw, C); tab_h (gh, gh, d), tab_w (gw, gw, d)."""
        b, gh, gw, c = x.shape
        n, d = gh * gw, c // self.heads
        qkv = F.linear(self.qkv, x, policy).view(b, n, 3, self.heads, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        rel = relpos_terms(q, tab_h, tab_w)
        o = attention(q, k, v, scale=d ** -0.5, rel=rel, impl=impl)
        return F.linear(self.proj, o.transpose(1, 2).reshape(b, gh, gw, c), policy)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTMatteConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.hidden_size * cfg.mlp_ratio)
        self.fc2 = nn.Linear(cfg.hidden_size * cfg.mlp_ratio, cfg.hidden_size)

    def forward(self, x, policy: Policy):
        return F.linear(self.fc2, F.gelu(F.linear(self.fc1, x, policy)), policy)


def _channel_norm(p: nn.LayerNorm, y):
    """ViTDet's LayerNorm over the channels of an NCHW tensor."""
    return F.layer_norm(p, y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """The residual block after a global block (transformers'
    ``VitDetResBottleneckBlock``), without a last activation."""

    def __init__(self, cfg: ViTMatteConfig):
        super().__init__()
        c, m, eps = cfg.hidden_size, cfg.hidden_size // 2, cfg.layer_norm_eps
        self.conv1 = nn.Conv2d(c, m, 1, bias=False)
        self.norm1 = nn.LayerNorm(m, eps=eps)
        self.conv2 = nn.Conv2d(m, m, 3, padding=1, bias=False)
        self.norm2 = nn.LayerNorm(m, eps=eps)
        self.conv3 = nn.Conv2d(m, c, 1, bias=False)
        self.norm3 = nn.LayerNorm(c, eps=eps)

    def forward(self, x, *, policy: Policy, impl: str):
        """x (B, gh, gw, C) NHWC -> the same."""
        y = F.conv2d(self.conv1, x.permute(0, 3, 1, 2), padding=0, policy=policy, impl=impl)
        y = F.gelu(_channel_norm(self.norm1, y))
        y = F.conv2d(self.conv2, y, padding=1, policy=policy, impl=impl)
        y = F.gelu(_channel_norm(self.norm2, y))
        y = F.conv2d(self.conv3, y, padding=0, policy=policy, impl=impl)
        return x + _channel_norm(self.norm3, y).permute(0, 2, 3, 1)


def window_partition(x, ws: int):
    """(B, h, w, C) -> (B * windows, ws, ws, C), the grid zero-padded at its
    bottom and right to whole windows; returns the padded (h, w) too."""
    b, h, w, c = x.shape
    hp, wp = h + (-h) % ws, w + (-w) % ws
    x = tF.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(win, ws: int, padded, hw):
    hp, wp = padded
    h, w = hw
    b = win.shape[0] // ((hp // ws) * (wp // ws))
    x = win.view(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


class Layer(nn.Module):
    def __init__(self, cfg: ViTMatteConfig, index: int):
        super().__init__()
        self.window = cfg.window_size if index in cfg.window_block_indices else 0
        side = self.window or cfg.image_size // cfg.patch_size
        self.norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attention = Attention(cfg, 2 * side - 1)
        self.norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = Mlp(cfg)
        if index in cfg.residual_block_indices:
            self.residual = Bottleneck(cfg)

    def forward(self, x, tab_h, tab_w, *, policy: Policy, impl: str):
        """x (B, gh, gw, C) fp32, the residual stream -> the same."""
        h = policy.cast_compute(F.layer_norm(self.norm1, x))
        if self.window:
            win, padded = window_partition(h, self.window)
            a = self.attention(win, tab_h, tab_w, policy=policy, impl=impl)
            a = window_unpartition(a, self.window, padded, x.shape[1:3])
        else:
            a = self.attention(h, tab_h, tab_w, policy=policy, impl=impl)
        x = x + a
        x = x + self.mlp(policy.cast_compute(F.layer_norm(self.norm2, x)), policy)
        if hasattr(self, "residual"):
            x = self.residual(x, policy=policy, impl=impl)
        return x


class Embeddings(nn.Module):
    def __init__(self, cfg: ViTMatteConfig):
        super().__init__()
        side = cfg.pretrain_image_size // cfg.patch_size
        self.position_embeddings = nn.Parameter(torch.zeros(1, side * side + 1, cfg.hidden_size))
        self.projection = nn.Conv2d(cfg.num_channels, cfg.hidden_size, cfg.patch_size,
                                    stride=cfg.patch_size)


class Encoder(nn.Module):
    def __init__(self, cfg: ViTMatteConfig):
        super().__init__()
        self.layer = nn.ModuleList(Layer(cfg, i) for i in range(cfg.num_hidden_layers))


class Backbone(nn.Module):
    def __init__(self, cfg: ViTMatteConfig):
        super().__init__()
        self.embeddings = Embeddings(cfg)
        self.encoder = Encoder(cfg)


class ConvStream(nn.Module):
    def __init__(self, cfg: ViTMatteConfig):
        super().__init__()
        chans = [cfg.num_channels, *cfg.convstream_hidden_sizes]
        self.convs = nn.ModuleList(ConvBN(a, b, cfg.batch_norm_eps)
                                   for a, b in zip(chans, chans[1:]))


class FusionBlock(nn.Module):
    def __init__(self, cin: int, cout: int, eps: float):
        super().__init__()
        self.conv = ConvBN(cin, cout, eps)


class Head(nn.Module):
    def __init__(self, cfg: ViTMatteConfig, mid: int = 16):
        super().__init__()
        self.matting_convs = nn.Sequential(
            nn.Conv2d(cfg.fusion_hidden_sizes[-1], mid, 3, padding=1),
            BatchNorm(mid, cfg.batch_norm_eps), nn.ReLU(), nn.Conv2d(mid, 1, 1))


class Decoder(nn.Module):
    def __init__(self, cfg: ViTMatteConfig):
        super().__init__()
        self.convstream = ConvStream(cfg)
        detail = [cfg.num_channels, *cfg.convstream_hidden_sizes][::-1]
        chans = [cfg.hidden_size, *cfg.fusion_hidden_sizes]
        self.fusion_blocks = nn.ModuleList(
            FusionBlock(chans[i] + detail[i], chans[i + 1], cfg.batch_norm_eps)
            for i in range(len(cfg.fusion_hidden_sizes)))
        self.matting_head = Head(cfg)


class PositionTables(NamedTuple):
    """One grid size's tables: the absolute positions (1, gh, gw, C) fp32,
    and each block's (table_h, table_w) in the compute dtype."""
    absolute: torch.Tensor
    relative: list


def _rel_index(n: int) -> np.ndarray:
    """[query, key] -> row of a relative-position table of 2n - 1 rows."""
    i = np.arange(n)
    return (i[:, None] - i[None, :] + (n - 1)).astype(np.int64)


def _rel_table(rel_pos: torch.Tensor, n: int) -> torch.Tensor:
    """transformers' ``get_rel_pos`` for n queries over n keys: the table
    resized linearly to 2n - 1 rows, then indexed [query, key] -> (n, n, d)."""
    t = rel_pos.float()
    if t.shape[0] != 2 * n - 1:
        t = tF.interpolate(t.t()[None], size=2 * n - 1, mode="linear")[0].t()
    return t[tables.on_device(_rel_index, t.device, n)]


class ViTMatte(nn.Module):
    """``forward(x)``: x (B, 4, H, W), H and W multiples of the patch (the
    pipeline pads to 32), normalised rgb || trimap -> alpha (B, 1, H, W)
    fp32 in [0, 1]."""

    def __init__(self, cfg: ViTMatteConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.decoder = Decoder(cfg)
        self._tables: dict = {}
        self.register_load_state_dict_post_hook(lambda module, keys: module._tables.clear())

    def _apply(self, fn, *args, **kwargs):
        self._tables.clear()
        return super()._apply(fn, *args, **kwargs)

    def position_tables(self, gh: int, gw: int, dtype: torch.dtype) -> PositionTables:
        """The tables of a (gh, gw) token grid, made at its first use."""
        pos = self.backbone.embeddings.position_embeddings
        key = (gh, gw, dtype, pos.device)
        got = self._tables.get(key)
        if got is not None:
            return got
        with torch.no_grad():
            side = math.isqrt(pos.shape[1] - 1)
            a = pos[:, 1:].float().reshape(1, side, side, -1)
            if (side, side) != (gh, gw):
                a = tF.interpolate(a.permute(0, 3, 1, 2), size=(gh, gw), mode="bicubic",
                                   align_corners=False).permute(0, 2, 3, 1)
            rel = []
            for layer in self.backbone.encoder.layer:
                att = layer.attention
                n_h, n_w = (layer.window, layer.window) if layer.window else (gh, gw)
                rel.append((_rel_table(att.rel_pos_h, n_h).to(dtype),
                            _rel_table(att.rel_pos_w, n_w).to(dtype)))
            got = PositionTables(a.contiguous(), rel)
        self._tables[key] = got
        observability.METRICS.count("vitmatte.tables_built")
        return got

    def backbone_forward(self, x, *, policy: Policy = FP32, impl: str = "auto"):
        """x (B, 4, H, W) -> features (B, H/16, W/16, C) NHWC, fp32."""
        p = self.cfg.patch_size
        gh, gw = x.shape[2] // p, x.shape[3] // p
        tabs = self.position_tables(gh, gw, policy.compute_dtype)
        t = F.conv2d(self.backbone.embeddings.projection, x, stride=p, padding=0,
                     policy=policy, impl=impl)
        t = t.permute(0, 2, 3, 1) + tabs.absolute
        for layer, (tab_h, tab_w) in zip(self.backbone.encoder.layer, tabs.relative):
            t = layer(t, tab_h, tab_w, policy=policy, impl=impl)
        return t

    def decoder_forward(self, features, x, *, policy: Policy = FP32):
        """features (B, h, w, C) NHWC at 1/16, x the model's input -> alpha
        (B, 1, H, W) fp32."""
        dec = self.decoder
        details = [policy.cast_compute(x)]
        for conv in dec.convstream.convs:
            details.append(conv(details[-1], stride=2, policy=policy))
        f = policy.cast_compute(features).permute(0, 3, 1, 2)
        for i, block in enumerate(dec.fusion_blocks):
            up = tF.interpolate(f, scale_factor=2.0, mode="bilinear", align_corners=False)
            f = block.conv(torch.cat([details[-(i + 1)], up], dim=1), stride=1, policy=policy)
        head = dec.matting_head.matting_convs
        f = tF.relu(F.conv2d_affine(head[0], f, *head[1].affine(), policy=policy), inplace=True)
        f = F.conv2d(head[3], f, padding=0, policy=policy)
        return torch.sigmoid(f.float())

    def forward(self, x, *, policy: Policy = FP32, impl: str = "auto"):
        with observability.span("model.vit"):
            features = self.backbone_forward(x, policy=policy, impl=impl)
        with observability.span("model.vitmatte_decoder"):
            return self.decoder_forward(features, x, policy=policy)
