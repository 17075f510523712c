"""CLIP text encoder of the port (SD2.1's OpenCLIP-H text tower), as an
``nn.Module`` (sdmatte_tpu/models/clip.py).

It rebuilds transformers' ``CLIPTextModel``: the output is the final
layer-normed ``last_hidden_state``, (B, 77, hidden), what
``text_encoder(input_ids)[0]`` returns.  Parameter names are the
checkpoint's under ``text_encoder.text_model.``.

The attention here is ``torch.matmul`` and softmax with the causal bias, as
the JAX package leaves it to XLA einsums (77 tokens: no kernel site).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..configs import CLIPTextConfig
from ..core import nn as F
from ..core.dtypes import FP32, Policy

# the causal mask's additive bias (fp32), as the JAX package writes it
CAUSAL_NEG = -3.4e38


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_heads
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.q_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x, causal_bias, policy: Policy):
        """fp32 scores, softmax and PV accumulation; P in V's dtype."""
        b, lq, c = x.shape
        h = self.heads
        d = c // h

        def split(t):
            return t.view(b, lq, h, d).transpose(1, 2)

        q = split(F.linear(self.q_proj, x, policy))
        k = split(F.linear(self.k_proj, x, policy))
        v = split(F.linear(self.v_proj, x, policy))
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
        w = torch.softmax(s + causal_bias, dim=-1).to(v.dtype)
        o = torch.matmul(w.float(), v.float()).to(x.dtype)
        o = o.transpose(1, 2).reshape(b, lq, c)
        return F.linear(self.out_proj, o, policy).to(x.dtype)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        if cfg.hidden_act not in ("gelu", "quick_gelu"):
            raise ValueError(f"unknown CLIP hidden_act {cfg.hidden_act!r}")
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x, policy: Policy):
        y = F.linear(self.fc1, x, policy)
        y = F.gelu(y) if self.act == "gelu" else y * torch.sigmoid(1.702 * y)
        return F.linear(self.fc2, y, policy)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, causal_bias, policy: Policy):
        x = x + self.self_attn(F.layer_norm(self.layer_norm1, x), causal_bias, policy)
        return x + self.mlp(F.layer_norm(self.layer_norm2, x), policy).to(x.dtype)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor, *, policy: Policy = FP32) -> torch.Tensor:
        """input_ids (B, L) integers -> last_hidden_state (B, L, hidden) in
        the policy's compute dtype."""
        tm = self.text_model
        ids = input_ids.long()
        l = ids.shape[1]
        x = tm.embeddings.token_embedding.weight[ids]
        x = x + tm.embeddings.position_embedding.weight[:l][None]
        x = x.to(policy.compute_dtype)
        causal = torch.full((l, l), CAUSAL_NEG, dtype=torch.float32,
                            device=x.device).triu(1)
        for layer in tm.encoder.layers:
            x = layer(x, causal, policy)
        return F.layer_norm(tm.final_layer_norm, x)
