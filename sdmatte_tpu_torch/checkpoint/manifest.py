"""Expected checkpoint-key manifest for ``SDMatte.safetensors``: the port's
copy of sdmatte_tpu/checkpoint/manifest.py.

The exact torch-convention key set (name -> shape) is derived by hand from
the reference topology: ``unet.*`` (SD2.1 ``UNet2DConditionModel`` with
``use_linear_projection=True`` plus SDMatte's ``aux_conv_in``, widened
``conv_in`` and ``point_embedding`` / ``bbox_embedding`` heads), ``vae.*``
(diffusers ``AutoencoderKL``) and ``text_encoder.*`` (transformers
``CLIPTextModel``).  The JAX module can also derive the CLIP keys from
``transformers``; the port enumerates them by hand only, so it needs no
``transformers`` (tests hold the two against each other).

Key names follow torch ``state_dict`` semantics: Linear/Conv ``weight`` /
``bias`` in torch layouts (Linear (out, in); Conv OIHW).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..configs import CLIPTextConfig, SDMatteConfig, UNetConfig, VAEConfig

Shape = Tuple[int, ...]


def _lin(out: Dict[str, Shape], name: str, cin: int, cout: int, bias=True):
    out[f"{name}.weight"] = (cout, cin)            # torch Linear: (out, in)
    if bias:
        out[f"{name}.bias"] = (cout,)


def _conv(out: Dict[str, Shape], name: str, cin: int, cout: int, k=3):
    out[f"{name}.weight"] = (cout, cin, k, k)      # torch Conv2d: OIHW
    out[f"{name}.bias"] = (cout,)


def _norm(out: Dict[str, Shape], name: str, c: int):
    out[f"{name}.weight"] = (c,)
    out[f"{name}.bias"] = (c,)


# ---------------------------------------------------------------------- VAE --

def _vae_resnet(out, name, cin, cout):
    """diffusers ResnetBlock2D (no time embedding in the VAE)."""
    _norm(out, f"{name}.norm1", cin)
    _conv(out, f"{name}.conv1", cin, cout)
    _norm(out, f"{name}.norm2", cout)
    _conv(out, f"{name}.conv2", cout, cout)
    if cin != cout:
        _conv(out, f"{name}.conv_shortcut", cin, cout, k=1)


def _vae_attn(out, name, c):
    """diffusers Attention in the VAE mid-block (modern to_q/to_k/to_v/to_out
    names; the legacy query/key/value/proj_attn aliases are a load-time
    rename, see loader._VAE_ATTN_ALIASES)."""
    _norm(out, f"{name}.group_norm", c)
    _lin(out, f"{name}.to_q", c, c)
    _lin(out, f"{name}.to_k", c, c)
    _lin(out, f"{name}.to_v", c, c)
    _lin(out, f"{name}.to_out.0", c, c)


def _vae_mid(out, name, c):
    _vae_resnet(out, f"{name}.resnets.0", c, c)
    _vae_attn(out, f"{name}.attentions.0", c)
    _vae_resnet(out, f"{name}.resnets.1", c, c)


def vae_keys(cfg: VAEConfig, prefix: str = "vae.") -> Dict[str, Shape]:
    out: Dict[str, Shape] = {}
    ch = list(cfg.block_out_channels)
    lat = cfg.latent_channels

    # encoder
    _conv(out, f"{prefix}encoder.conv_in", cfg.in_channels, ch[0])
    cin = ch[0]
    for i, cout in enumerate(ch):
        for j in range(cfg.layers_per_block):
            _vae_resnet(out, f"{prefix}encoder.down_blocks.{i}.resnets.{j}",
                        cin if j == 0 else cout, cout)
        if i < len(ch) - 1:
            _conv(out, f"{prefix}encoder.down_blocks.{i}.downsamplers.0.conv",
                  cout, cout)
        cin = cout
    _vae_mid(out, f"{prefix}encoder.mid_block", ch[-1])
    _norm(out, f"{prefix}encoder.conv_norm_out", ch[-1])
    _conv(out, f"{prefix}encoder.conv_out", ch[-1], 2 * lat)

    # decoder
    rev = list(reversed(ch))
    _conv(out, f"{prefix}decoder.conv_in", lat, rev[0])
    _vae_mid(out, f"{prefix}decoder.mid_block", rev[0])
    cin = rev[0]
    for i, cout in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            _vae_resnet(out, f"{prefix}decoder.up_blocks.{i}.resnets.{j}",
                        cin if j == 0 else cout, cout)
        if i < len(rev) - 1:
            _conv(out, f"{prefix}decoder.up_blocks.{i}.upsamplers.0.conv",
                  cout, cout)
        cin = cout
    _norm(out, f"{prefix}decoder.conv_norm_out", rev[-1])
    _conv(out, f"{prefix}decoder.conv_out", rev[-1], cfg.out_channels)

    _conv(out, f"{prefix}quant_conv", 2 * lat, 2 * lat, k=1)
    _conv(out, f"{prefix}post_quant_conv", lat, lat, k=1)
    return out


# --------------------------------------------------------------------- UNet --

def _unet_resnet(out, name, cin, cout, temb):
    """diffusers ResnetBlock2D with time_emb_proj (replace.py block factories)."""
    _norm(out, f"{name}.norm1", cin)
    _conv(out, f"{name}.conv1", cin, cout)
    _lin(out, f"{name}.time_emb_proj", temb, cout)
    _norm(out, f"{name}.norm2", cout)
    _conv(out, f"{name}.conv2", cout, cout)
    if cin != cout:
        _conv(out, f"{name}.conv_shortcut", cin, cout, k=1)


def _unet_attn(out, name, c, ctx):
    """diffusers Attention: to_q/k/v bias-less, to_out.0 with bias."""
    _lin(out, f"{name}.to_q", c, c, bias=False)
    _lin(out, f"{name}.to_k", ctx, c, bias=False)
    _lin(out, f"{name}.to_v", ctx, c, bias=False)
    _lin(out, f"{name}.to_out.0", c, c)


def _unet_transformer(out, name, c, cfg: UNetConfig):
    """Transformer2DModel, use_linear_projection=True (SD2.1 —
    replace.py:152 config; proj_in/proj_out are Linear, not 1x1 conv)."""
    _norm(out, f"{name}.norm", c)
    _lin(out, f"{name}.proj_in", c, c)
    tb = f"{name}.transformer_blocks.0"
    _norm(out, f"{tb}.norm1", c)
    _unet_attn(out, f"{tb}.attn1", c, c)
    _norm(out, f"{tb}.norm2", c)
    _unet_attn(out, f"{tb}.attn2", c, cfg.cross_attention_dim)
    _norm(out, f"{tb}.norm3", c)
    _lin(out, f"{tb}.ff.net.0.proj", c, 8 * c)     # GEGLU: 2 * (4c)
    _lin(out, f"{tb}.ff.net.2", 4 * c, c)
    _lin(out, f"{name}.proj_out", c, c)


def unet_keys(cfg: UNetConfig, prefix: str = "unet.") -> Dict[str, Shape]:
    out: Dict[str, Shape] = {}
    ch = list(cfg.block_out_channels)
    ted = cfg.time_embed_dim
    n = len(ch)

    # stem + conditioning heads (replace.py:184-200; utils.py:13-41)
    _conv(out, f"{prefix}conv_in", cfg.in_channels, ch[0])
    _conv(out, f"{prefix}aux_conv_in", cfg.aux_in_channels, cfg.aux_token_dim)
    _lin(out, f"{prefix}time_embedding.linear_1", ch[0], ted)
    _lin(out, f"{prefix}time_embedding.linear_2", ted, ted)
    _lin(out, f"{prefix}point_embedding.linear_1",
         cfg.point_embeddings_input_dim, ted)
    _lin(out, f"{prefix}point_embedding.linear_2", ted, ted)
    _lin(out, f"{prefix}bbox_embedding.linear_1",
         cfg.bbox_embeddings_input_dim, ted)
    _lin(out, f"{prefix}bbox_embedding.linear_2", ted, ted)

    # down path (replace.py:232-265); track skip channels for the up path
    skip_ch: List[int] = [ch[0]]
    cin = ch[0]
    for i, cout in enumerate(ch):
        for j in range(cfg.layers_per_block):
            _unet_resnet(out, f"{prefix}down_blocks.{i}.resnets.{j}",
                         cin if j == 0 else cout, cout, ted)
            if cfg.down_has_attn[i]:
                _unet_transformer(
                    out, f"{prefix}down_blocks.{i}.attentions.{j}", cout, cfg)
            skip_ch.append(cout)
        if i < n - 1:
            _conv(out, f"{prefix}down_blocks.{i}.downsamplers.0.conv",
                  cout, cout)
            skip_ch.append(cout)
        cin = cout

    # mid (replace.py:268-289)
    _unet_resnet(out, f"{prefix}mid_block.resnets.0", ch[-1], ch[-1], ted)
    _unet_transformer(out, f"{prefix}mid_block.attentions.0", ch[-1], cfg)
    _unet_resnet(out, f"{prefix}mid_block.resnets.1", ch[-1], ch[-1], ted)

    # up path (replace.py:292-348): every resnet takes concat(h, skip)
    rev = list(reversed(ch))
    prev = rev[0]
    for i, cout in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            rin = (prev if j == 0 else cout) + skip_ch.pop()
            _unet_resnet(out, f"{prefix}up_blocks.{i}.resnets.{j}",
                         rin, cout, ted)
            if cfg.up_has_attn[i]:
                _unet_transformer(
                    out, f"{prefix}up_blocks.{i}.attentions.{j}", cout, cfg)
        if i < n - 1:
            _conv(out, f"{prefix}up_blocks.{i}.upsamplers.0.conv", cout, cout)
        prev = cout

    # head (replace.py:353-362)
    _norm(out, f"{prefix}conv_norm_out", ch[0])
    _conv(out, f"{prefix}conv_out", ch[0], cfg.out_channels)
    return out


# --------------------------------------------------------------------- CLIP --

def clip_keys_manual(cfg: CLIPTextConfig,
                     prefix: str = "text_encoder.") -> Dict[str, Shape]:
    """Hand enumeration of transformers CLIPTextModel keys."""
    out: Dict[str, Shape] = {}
    d, ff = cfg.hidden_size, cfg.intermediate_size
    tm = f"{prefix}text_model"
    out[f"{tm}.embeddings.token_embedding.weight"] = (cfg.vocab_size, d)
    out[f"{tm}.embeddings.position_embedding.weight"] = (
        cfg.max_position_embeddings, d)
    for i in range(cfg.num_layers):
        lyr = f"{tm}.encoder.layers.{i}"
        for pn in ("k_proj", "v_proj", "q_proj", "out_proj"):
            _lin(out, f"{lyr}.self_attn.{pn}", d, d)
        _norm(out, f"{lyr}.layer_norm1", d)
        _lin(out, f"{lyr}.mlp.fc1", d, ff)
        _lin(out, f"{lyr}.mlp.fc2", ff, d)
        _norm(out, f"{lyr}.layer_norm2", d)
    _norm(out, f"{tm}.final_layer_norm", d)
    return out


def clip_keys(cfg: CLIPTextConfig, prefix: str = "text_encoder.") -> Dict[str, Shape]:
    return clip_keys_manual(cfg, prefix)


# ---------------------------------------------------------------- top level --

def expected_keys(cfg: SDMatteConfig) -> Dict[str, Shape]:
    """Full expected key set of SDMatte.safetensors (name -> torch shape).

    Top-level prefixes follow the reference ``SDMatte`` module attributes
    (meta_arch.py:87-124: self.text_encoder / self.vae / self.unet;
    noise_scheduler and tokenizer hold no parameters)."""
    out: Dict[str, Shape] = {}
    out.update(vae_keys(cfg.vae))
    out.update(unet_keys(cfg.unet))
    out.update(clip_keys(cfg.clip))
    return out


def legacy_vae_attn_variant(keys: Dict[str, Shape]) -> Dict[str, Shape]:
    """The same key set with the VAE mid-block attention expressed in legacy
    diffusers names (query/key/value/proj_attn, weights (C,C,1,1)-shaped in
    very old exports are NOT modeled — SDMatte's era uses 2-D Linear)."""
    ren = {".attentions.0.to_q.": ".attentions.0.query.",
           ".attentions.0.to_k.": ".attentions.0.key.",
           ".attentions.0.to_v.": ".attentions.0.value.",
           ".attentions.0.to_out.0.": ".attentions.0.proj_attn."}
    out = {}
    for k, v in keys.items():
        if k.startswith("vae."):
            for old, new in ren.items():
                if old in k:
                    k = k.replace(old, new)
                    break
        out[k] = v
    return out
