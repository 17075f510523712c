"""Plain fp32 reference of SDMatte's matting call, written for the benchmark.

It imports torch alone: nothing of the program under test, of its plain
kernel versions or of its tests.  Parameters are a flat dict keyed by the
checkpoint's names (``vae.encoder.conv_in.weight``, ``unet.down_blocks.0...``),
the diffusers layout that ``SDMatte.safetensors`` uses; the sizes come from
the configuration file under ``matbench/configs/`` (SD2.1-base's published
``unet``, ``vae`` and ``text_encoder`` configs with SDMatte's surgery).

The call, as the reference ComfyUI node runs it:

  pre    antialiased bilinear resize of photo and trimap to S x S, [0,1] ->
         [-1,1]
  model  VAE encode of rgb || trimap (trimap copied to 3 channels) as one
         batch, deterministic mean * scaling_factor; the bbox branch's
         sinusoidal embedding of the coords; the latent prompt mask (nearest
         1/8 of (trimap + 1) / 2) as an additive (1 - m) * -10000 bias on every
         self-attention; the aux latent through ``aux_conv_in`` as the
         cross-attention context; opacity 1 - is_trans as the time step; the
         SD2.1 U-Net (linear projections, GEGLU); VAE decode of
         out / scaling_factor; alpha = (clip(channel mean, -1, 1) + 1) / 2
  post   bilinear resize back to the photo's size, clamp to [0, 1], trimap
         refinement (fg x1.2, bg 0, unknown below 0.3 -> 0), composite

Run it in fp32 with TF32 off (``reference.exact_fp32``); the benchmark also
runs it under ``torch.autocast`` in bf16, the configuration's precision,
whose gap from fp32 is the unit its comparison counts in.  Attention is computed in
query blocks so that the scores of one block stay near 1 GiB.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_BIAS = -10000.0
FG_BOOST = 1.2
KILL_BELOW = 0.3
INT8_MIN_ELEMS = 1 << 16
PIPELINE_KEYS = frozenset({"weight_storage"})


# ------------------------------------------------------------ parameters ---

class _Table:
    def __init__(self):
        self.rows: list[tuple[str, tuple, str]] = []

    def add(self, name, shape, kind):
        self.rows.append((name, tuple(shape), kind))

    def conv(self, name, cin, cout, k=3):
        self.add(f"{name}.weight", (cout, cin, k, k), "w")
        self.add(f"{name}.bias", (cout,), "b")

    def linear(self, name, cin, cout, bias=True):
        self.add(f"{name}.weight", (cout, cin), "w")
        if bias:
            self.add(f"{name}.bias", (cout,), "b")

    def norm(self, name, c):
        self.add(f"{name}.weight", (c,), "nw")
        self.add(f"{name}.bias", (c,), "nb")


def _vae_resnet(t, name, cin, cout):
    t.norm(f"{name}.norm1", cin)
    t.conv(f"{name}.conv1", cin, cout)
    t.norm(f"{name}.norm2", cout)
    t.conv(f"{name}.conv2", cout, cout)
    if cin != cout:
        t.conv(f"{name}.conv_shortcut", cin, cout, 1)


def _vae_mid(t, name, c):
    _vae_resnet(t, f"{name}.resnets.0", c, c)
    _vae_resnet(t, f"{name}.resnets.1", c, c)
    a = f"{name}.attentions.0"
    t.norm(f"{a}.group_norm", c)
    for p in ("to_q", "to_k", "to_v", "to_out.0"):
        t.linear(f"{a}.{p}", c, c)


def _unet_resnet(t, name, cin, cout, temb):
    t.norm(f"{name}.norm1", cin)
    t.conv(f"{name}.conv1", cin, cout)
    t.linear(f"{name}.time_emb_proj", temb, cout)
    t.norm(f"{name}.norm2", cout)
    t.conv(f"{name}.conv2", cout, cout)
    if cin != cout:
        t.conv(f"{name}.conv_shortcut", cin, cout, 1)


def _transformer(t, name, c, ctx_dim):
    t.norm(f"{name}.norm", c)
    t.linear(f"{name}.proj_in", c, c)
    b = f"{name}.transformer_blocks.0"
    for i, kv in ((1, c), (2, ctx_dim)):
        t.norm(f"{b}.norm{i}", c)
        t.linear(f"{b}.attn{i}.to_q", c, c, bias=False)
        t.linear(f"{b}.attn{i}.to_k", kv, c, bias=False)
        t.linear(f"{b}.attn{i}.to_v", kv, c, bias=False)
        t.linear(f"{b}.attn{i}.to_out.0", c, c)
    t.norm(f"{b}.norm3", c)
    t.linear(f"{b}.ff.net.0.proj", c, 8 * c)
    t.linear(f"{b}.ff.net.2", 4 * c, c)
    t.linear(f"{name}.proj_out", c, c)


def param_table(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every VAE and U-Net parameter, in a fixed
    order; kind is "w" (conv or linear weight), "b" (its bias), "nw" / "nb"
    (a norm's scale / shift).  ``cfg`` is a configuration file's dict."""
    t = _Table()
    v = cfg["vae"]
    ch = list(v["block_out_channels"])
    lpb = v["layers_per_block"]
    t.conv("vae.encoder.conv_in", v["in_channels"], ch[0])
    cin = ch[0]
    for i, cout in enumerate(ch):
        for j in range(lpb):
            _vae_resnet(t, f"vae.encoder.down_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout)
        if i < len(ch) - 1:
            t.conv(f"vae.encoder.down_blocks.{i}.downsamplers.0.conv", cout, cout)
        cin = cout
    _vae_mid(t, "vae.encoder.mid_block", ch[-1])
    t.norm("vae.encoder.conv_norm_out", ch[-1])
    t.conv("vae.encoder.conv_out", ch[-1], 2 * v["latent_channels"])
    rev = ch[::-1]
    t.conv("vae.decoder.conv_in", v["latent_channels"], rev[0])
    _vae_mid(t, "vae.decoder.mid_block", rev[0])
    cin = rev[0]
    for i, cout in enumerate(rev):
        for j in range(lpb + 1):
            _vae_resnet(t, f"vae.decoder.up_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout)
        if i < len(rev) - 1:
            t.conv(f"vae.decoder.up_blocks.{i}.upsamplers.0.conv", cout, cout)
        cin = cout
    t.norm("vae.decoder.conv_norm_out", rev[-1])
    t.conv("vae.decoder.conv_out", rev[-1], v["out_channels"])
    lat = v["latent_channels"]
    t.conv("vae.quant_conv", 2 * lat, 2 * lat, 1)
    t.conv("vae.post_quant_conv", lat, lat, 1)

    u = cfg["unet"]
    ch = list(u["block_out_channels"])
    n = len(ch)
    temb = 4 * ch[0]
    ctx = u["cross_attention_dim"]
    down_attn = [ty.startswith("CrossAttn") for ty in u["down_block_types"]]
    up_attn = [ty.startswith("CrossAttn") for ty in u["up_block_types"]]
    t.conv("unet.conv_in", u["in_channels"], ch[0])
    t.conv("unet.aux_conv_in", u["aux_in_channels"], u["aux_token_dim"])
    t.linear("unet.time_embedding.linear_1", ch[0], temb)
    t.linear("unet.time_embedding.linear_2", temb, temb)
    t.linear("unet.point_embedding.linear_1", u["point_embeddings_input_dim"], temb)
    t.linear("unet.point_embedding.linear_2", temb, temb)
    t.linear("unet.bbox_embedding.linear_1", u["bbox_embeddings_input_dim"], temb)
    t.linear("unet.bbox_embedding.linear_2", temb, temb)
    skips = [ch[0]]
    cin = ch[0]
    for i, cout in enumerate(ch):
        for j in range(u["layers_per_block"]):
            _unet_resnet(t, f"unet.down_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout, temb)
            if down_attn[i]:
                _transformer(t, f"unet.down_blocks.{i}.attentions.{j}", cout, ctx)
            skips.append(cout)
        if i < n - 1:
            t.conv(f"unet.down_blocks.{i}.downsamplers.0.conv", cout, cout)
            skips.append(cout)
        cin = cout
    _unet_resnet(t, "unet.mid_block.resnets.0", ch[-1], ch[-1], temb)
    _unet_resnet(t, "unet.mid_block.resnets.1", ch[-1], ch[-1], temb)
    _transformer(t, "unet.mid_block.attentions.0", ch[-1], ctx)
    prev = ch[-1]
    for i, cout in enumerate(ch[::-1]):
        for j in range(u["layers_per_block"] + 1):
            rin = (prev if j == 0 else cout) + skips.pop()
            _unet_resnet(t, f"unet.up_blocks.{i}.resnets.{j}", rin, cout, temb)
            if up_attn[i]:
                _transformer(t, f"unet.up_blocks.{i}.attentions.{j}", cout, ctx)
        if i < n - 1:
            t.conv(f"unet.up_blocks.{i}.upsamplers.0.conv", cout, cout)
        prev = cout
    t.norm("unet.conv_norm_out", ch[0])
    t.conv("unet.conv_out", ch[0], u["out_channels"])
    return t.rows


def stored(params: dict, conf: dict) -> dict:
    """The weights as the deployment holds them: ``weight_storage`` "int8"
    (:func:`int8_storage`) or "fp" (as they are)."""
    return int8_storage(params) if conf["pipeline"]["weight_storage"] == "int8" else params


def int8_storage(params: dict) -> dict:
    """The int8-storage deployment's weights, worked out again from the fp
    ones: every conv or linear weight of at least 65,536 elements becomes
    round_half_even(w / s) clipped to +-127, times s, with s = amax / 127 per
    output channel (1 where amax is 0), all in fp32."""
    out = {}
    for name, w in params.items():
        if name.endswith(".weight") and w.ndim in (2, 4) and w.numel() >= INT8_MIN_ELEMS:
            wf = w.float()
            amax = wf.abs().amax(dim=tuple(range(1, wf.ndim)))
            s = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
            s = s.reshape(-1, *([1] * (wf.ndim - 1)))
            w = torch.clamp(torch.round(wf / s), -127, 127) * s
        out[name] = w
    return out


# --------------------------------------------------------------- layers ---

def _conv(P, name, x, stride=1, padding=1):
    return F.conv2d(x, P[f"{name}.weight"], P[f"{name}.bias"], stride=stride, padding=padding)


def _linear(P, name, x):
    return F.linear(x, P[f"{name}.weight"], P.get(f"{name}.bias"))


def _gn(P, name, x, groups, eps):
    return F.group_norm(x, groups, P[f"{name}.weight"], P[f"{name}.bias"], eps)


def _ln(P, name, x):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], 1e-5)


def attention(q, k, v, scale, bias=None, block_elems=1 << 28):
    """q (B,H,Lq,D), k/v (B,H,Lk,D), bias (B,Lk) or None: softmax(q k^T *
    scale + bias) v, in query blocks."""
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    rows = max(1, min(lq, block_elems // max(1, b * h * lk)))
    out = []
    for s in range(0, lq, rows):
        sc = torch.matmul(q[:, :, s:s + rows], k.transpose(-1, -2)) * scale
        if bias is not None:
            sc = sc + bias[:, None, None, :]
        out.append(torch.matmul(torch.softmax(sc, dim=-1), v))
    return torch.cat(out, dim=2)


def timestep_embedding(t, dim, flip_sin_to_cos=True, shift=0.0, max_period=10000.0):
    """diffusers ``get_timestep_embedding``: (N,) -> (N, dim)."""
    half = dim // 2
    expo = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(expo / (half - shift))
    e = t.float()[:, None] * freqs[None]
    e = torch.cat([torch.sin(e), torch.cos(e)], dim=-1)
    if flip_sin_to_cos:
        e = torch.cat([e[:, half:], e[:, :half]], dim=-1)
    return e


# ------------------------------------------------------------------ VAE ---

def _vae_resnet_fwd(P, name, x, g, eps):
    h = _conv(P, f"{name}.conv1", F.silu(_gn(P, f"{name}.norm1", x, g, eps)))
    h = _conv(P, f"{name}.conv2", F.silu(_gn(P, f"{name}.norm2", h, g, eps)))
    if f"{name}.conv_shortcut.weight" in P:
        x = _conv(P, f"{name}.conv_shortcut", x, padding=0)
    return x + h


def _vae_mid_fwd(P, name, x, g, eps):
    x = _vae_resnet_fwd(P, f"{name}.resnets.0", x, g, eps)
    a = f"{name}.attentions.0"
    b, c, h, w = x.shape
    y = _gn(P, f"{a}.group_norm", x, g, eps).flatten(2).transpose(1, 2)
    q, k, v = (_linear(P, f"{a}.{p}", y)[:, None] for p in ("to_q", "to_k", "to_v"))
    o = attention(q, k, v, 1.0 / math.sqrt(c))[:, 0]
    o = _linear(P, f"{a}.to_out.0", o)
    x = x + o.transpose(1, 2).reshape(b, c, h, w)
    return _vae_resnet_fwd(P, f"{name}.resnets.1", x, g, eps)


def vae_encode(P, cfg, x):
    """(B, 3, S, S) in [-1, 1] -> latent mean * scaling_factor."""
    v = cfg["vae"]
    g, eps, n = v["norm_num_groups"], v["norm_eps"], len(v["block_out_channels"])
    h = _conv(P, "vae.encoder.conv_in", x)
    for i in range(n):
        for j in range(v["layers_per_block"]):
            h = _vae_resnet_fwd(P, f"vae.encoder.down_blocks.{i}.resnets.{j}", h, g, eps)
        if i < n - 1:
            h = _conv(P, f"vae.encoder.down_blocks.{i}.downsamplers.0.conv",
                      F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
    h = _vae_mid_fwd(P, "vae.encoder.mid_block", h, g, eps)
    h = _conv(P, "vae.encoder.conv_out", F.silu(_gn(P, "vae.encoder.conv_norm_out", h, g, eps)))
    moments = _conv(P, "vae.quant_conv", h, padding=0)
    return moments[:, :v["latent_channels"]] * v["scaling_factor"]


def vae_decode(P, cfg, z):
    """Latent already divided by scaling_factor -> image in [-1, 1]."""
    v = cfg["vae"]
    g, eps, n = v["norm_num_groups"], v["norm_eps"], len(v["block_out_channels"])
    h = _conv(P, "vae.post_quant_conv", z, padding=0)
    h = _conv(P, "vae.decoder.conv_in", h)
    h = _vae_mid_fwd(P, "vae.decoder.mid_block", h, g, eps)
    for i in range(n):
        for j in range(v["layers_per_block"] + 1):
            h = _vae_resnet_fwd(P, f"vae.decoder.up_blocks.{i}.resnets.{j}", h, g, eps)
        if i < n - 1:
            h = _conv(P, f"vae.decoder.up_blocks.{i}.upsamplers.0.conv",
                      F.interpolate(h, scale_factor=2.0, mode="nearest"))
    h = F.silu(_gn(P, "vae.decoder.conv_norm_out", h, g, eps))
    return _conv(P, "vae.decoder.conv_out", h)


# ---------------------------------------------------------------- U-Net ---

def _unet_resnet_fwd(P, name, x, emb, g, eps):
    h = _conv(P, f"{name}.conv1", F.silu(_gn(P, f"{name}.norm1", x, g, eps)))
    h = h + _linear(P, f"{name}.time_emb_proj", F.silu(emb))[:, :, None, None]
    h = _conv(P, f"{name}.conv2", F.silu(_gn(P, f"{name}.norm2", h, g, eps)))
    if f"{name}.conv_shortcut.weight" in P:
        x = _conv(P, f"{name}.conv_shortcut", x, padding=0)
    return x + h


def _mha(P, name, x, ctx, heads, bias):
    b, lq, c = x.shape
    d = c // heads
    q = _linear(P, f"{name}.to_q", x).reshape(b, lq, heads, d).transpose(1, 2)
    k = _linear(P, f"{name}.to_k", ctx).reshape(b, -1, heads, d).transpose(1, 2)
    v = _linear(P, f"{name}.to_v", ctx).reshape(b, -1, heads, d).transpose(1, 2)
    o = attention(q, k, v, 1.0 / math.sqrt(d), bias)
    return _linear(P, f"{name}.to_out.0", o.transpose(1, 2).reshape(b, lq, c))


def _transformer_fwd(P, name, x, ctx, heads, bias, g, eps, residual_attn1):
    b, c, h, w = x.shape
    y = _gn(P, f"{name}.norm", x, g, eps).flatten(2).transpose(1, 2)
    y = _linear(P, f"{name}.proj_in", y)
    blk = f"{name}.transformer_blocks.0"
    n1 = _ln(P, f"{blk}.norm1", y)
    a1 = _mha(P, f"{blk}.attn1", n1, n1, heads, bias)
    y = y + (a1 + n1 if residual_attn1 else a1)
    y = y + _mha(P, f"{blk}.attn2", _ln(P, f"{blk}.norm2", y), ctx, heads, None)
    hid, gate = _linear(P, f"{blk}.ff.net.0.proj", _ln(P, f"{blk}.norm3", y)).chunk(2, dim=-1)
    y = y + _linear(P, f"{blk}.ff.net.2", hid * F.gelu(gate))
    y = _linear(P, f"{name}.proj_out", y)
    return x + y.transpose(1, 2).reshape(b, c, h, w)


def unet(P, cfg, sample, trans, ctx, coords_emb, latent_mask):
    """sample (B, 8, h, w); trans (B,); ctx (B, L, C) aux tokens; coords_emb
    (B, 1280) bbox embedding; latent_mask (B, 1, h, w) in [0, 1] or None."""
    u = cfg["unet"]
    ch = list(u["block_out_channels"])
    n = len(ch)
    g, eps, teps = u["norm_num_groups"], u["norm_eps"], u["transformer_norm_eps"]
    heads = list(u["attention_head_dim"])
    down_attn = [ty.startswith("CrossAttn") for ty in u["down_block_types"]]
    up_attn = [ty.startswith("CrossAttn") for ty in u["up_block_types"]]
    mask_on = list(u["use_attention_mask_list"])
    resid1 = u["residual_connection"]

    op = timestep_embedding(trans, ch[0], u["flip_sin_to_cos"], u["freq_shift"])
    emb = _linear(P, "unet.time_embedding.linear_2",
                  F.silu(_linear(P, "unet.time_embedding.linear_1", op)))
    emb = emb + _linear(P, "unet.bbox_embedding.linear_2",
                        F.silu(_linear(P, "unet.bbox_embedding.linear_1", coords_emb)))

    def bias(stage, x):
        if latent_mask is None or not mask_on[stage]:
            return None
        m = F.interpolate(latent_mask, size=x.shape[2:], mode="nearest")
        return (1.0 - m.flatten(1)) * NEG_BIAS

    def tf(name, x, stage, nh, c):
        return _transformer_fwd(P, name, x, ctx, nh, bias(stage, x), g, teps,
                                resid1 and c == 320)

    x = _conv(P, "unet.conv_in", sample)
    skips = [x]
    for i in range(n):
        for j in range(u["layers_per_block"]):
            x = _unet_resnet_fwd(P, f"unet.down_blocks.{i}.resnets.{j}", x, emb, g, eps)
            if down_attn[i]:
                x = tf(f"unet.down_blocks.{i}.attentions.{j}", x, 0, heads[i], ch[i])
            skips.append(x)
        if i < n - 1:
            x = _conv(P, f"unet.down_blocks.{i}.downsamplers.0.conv", x, stride=2)
            skips.append(x)
    x = _unet_resnet_fwd(P, "unet.mid_block.resnets.0", x, emb, g, eps)
    x = tf("unet.mid_block.attentions.0", x, 1, heads[-1], ch[-1])
    x = _unet_resnet_fwd(P, "unet.mid_block.resnets.1", x, emb, g, eps)
    for i in range(n):
        c = ch[n - 1 - i]
        for j in range(u["layers_per_block"] + 1):
            x = torch.cat([x, skips.pop()], dim=1)
            x = _unet_resnet_fwd(P, f"unet.up_blocks.{i}.resnets.{j}", x, emb, g, eps)
            if up_attn[i]:
                x = tf(f"unet.up_blocks.{i}.attentions.{j}", x, 2, heads[n - 1 - i], c)
        if i < n - 1:
            x = _conv(P, f"unet.up_blocks.{i}.upsamplers.0.conv",
                      F.interpolate(x, size=skips[-1].shape[2:], mode="nearest"))
    x = F.silu(_gn(P, "unet.conv_norm_out", x, g, eps))
    return _conv(P, "unet.conv_out", x)


# ------------------------------------------------------------- the call ---

def model_alpha(P, cfg, img, aux, coords, is_trans):
    """img, aux NCHW (B,3,S,S), (B,1,S,S) in [-1, 1]; coords (B, 4); is_trans
    (B,) -> alpha (B, S, S) in [0, 1]."""
    b, _, s, _ = img.shape
    lat = vae_encode(P, cfg, torch.cat([img, aux.expand(b, 3, s, s)], dim=0))
    rgb_lat, aux_lat = lat[:b], lat[b:]
    coords_emb = timestep_embedding(coords.reshape(-1), 320).reshape(b, -1)
    latent_mask = F.interpolate((aux + 1.0) * 0.5, size=(s // 8, s // 8), mode="nearest")
    tok = _conv(P, "unet.aux_conv_in", aux_lat)
    ctx = tok.flatten(2).transpose(1, 2)
    out = unet(P, cfg, torch.cat([rgb_lat, aux_lat], dim=1), 1.0 - is_trans.float(),
               ctx, coords_emb, latent_mask)
    dec = vae_decode(P, cfg, out / cfg["vae"]["scaling_factor"])
    return (dec.mean(dim=1).clamp(-1.0, 1.0) + 1.0) * 0.5


def _resize(x, h, w):
    """Antialiased bilinear resize of NCHW fp32 (torch's own resampler)."""
    if tuple(x.shape[2:]) == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)


def matte(P, cfg, image, trimap, *, size, trimap_constraint=0.8, refine=True,
          is_transparent=False, output_mode="alpha_only"):
    """image (B,H,W,3), trimap (B,H,W) in [0,1] fp32 on P's device ->
    (alpha (B,H,W), matted (B,H,W,3|4)), the reference node's outputs."""
    b, h, w, _ = image.shape
    img = _resize(image.permute(0, 3, 1, 2), size, size) * 2.0 - 1.0
    aux = _resize(trimap[:, None], size, size) * 2.0 - 1.0
    coords = torch.tensor([[0.0, 0.0, 1.0, 1.0]], device=image.device).expand(b, 4)
    is_trans = torch.full((b,), 1.0 if is_transparent else 0.0, device=image.device)
    a = model_alpha(P, cfg, img, aux, coords, is_trans).float()
    alpha = _resize(a[:, None], h, w)[:, 0].clamp(0.0, 1.0)
    if refine:
        fg = trimap > trimap_constraint
        bg = trimap < 1.0 - trimap_constraint
        alpha = torch.where(bg, 0.0, alpha)
        alpha = torch.where(fg, (alpha * FG_BOOST).clamp(0.0, 1.0), alpha)
        alpha = torch.where(~(fg | bg) & (alpha < KILL_BELOW), 0.0, alpha)
    if output_mode == "alpha_only":
        matted = torch.zeros_like(image)
    elif output_mode == "matted_rgba":
        matted = torch.cat([image, alpha[..., None]], dim=-1)
    elif output_mode == "matted_rgb":
        matted = image * ((trimap[..., None] > 0.2) & (alpha[..., None] > 0.1)).float()
    else:
        matted = image * alpha[..., None]
    return alpha, matted


def answer(P, cfg, image, trimap, options: dict):
    """The whole call on one photo, image (H,W,3) and trimap (H,W), with the
    mix's options (the node's inputs) -> (alpha (H,W), matted (H,W,C)) fp32."""
    a, m = matte(P, cfg, image[None], trimap[None], size=options["inference_size"],
                 trimap_constraint=options["trimap_constraint"],
                 refine=options["mask_refine"], is_transparent=options["is_transparent"],
                 output_mode=options["output_mode"])
    return a[0].float(), m[0].float()


def meta_forward(cfg, options: dict, height: int, width: int):
    """The model's forward (VAE encode, U-Net, decode) for one photo, on the
    meta device: at the inference size, whatever the photo's."""
    meta = torch.device("meta")
    params = {n: torch.empty(s, device=meta) for n, s, _ in param_table(cfg)}
    size = options["inference_size"]
    img = torch.empty((1, 3, size, size), device=meta)
    aux = torch.empty((1, 1, size, size), device=meta)
    coords = torch.empty((1, 4), device=meta)
    is_trans = torch.empty((1,), device=meta)
    return model_alpha(params, cfg, img, aux, coords, is_trans)
