"""Plain fp32 reference of ViTMatte's matting call, written for the benchmark.

It imports torch alone: nothing of the program under test, of its plain
kernel versions or of its tests.  Parameters are a flat dict keyed by
transformers' ``VitMatteForImageMatting`` names (``backbone.encoder.layer.0
.attention.rel_pos_h``, ``decoder.fusion_blocks.0.conv.conv.weight``, ...);
the sizes come from the configuration file under ``matbench/configs/``
(``hustvl/vitmatte-base-composition-1k``'s config: a ``backbone_config``
group and the decoder's keys).  Written from transformers'
``modeling_vitdet.py``, ``modeling_vitmatte.py`` and
``image_processing_vitmatte.py``:

  pre    rgb in [0, 1] -> [-1, 1] (mean 0.5, std 0.5), the trimap in [0, 1]
         appended as a fourth channel, zero-padded at the bottom and right to
         a multiple of 32; no resize
  model  ViTDet: patch embedding (16 x 16 conv), the absolute table
         resized bicubically to the grid, pre-norm blocks whose attention
         adds the decomposed relative positions (``get_rel_pos``: the table
         resized linearly to 2 * side - 1 rows, indexed by q - k; einsum of
         the unscaled q), windowed blocks on the grid zero-padded to whole
         windows, a residual bottleneck after each global block; the detail
         decoder (ConvStream, fusion blocks, head, sigmoid)
  post   crop to the photo, clamp to [0, 1], trimap refinement (fg x1.2,
         bg 0, unknown below 0.3 -> 0), composite

Run it in fp32 with TF32 off (``reference.exact_fp32``); the benchmark also
runs it under ``torch.autocast`` in bf16, the configuration's precision,
whose gap from fp32 is the unit its comparison counts in.  Attention is
computed in blocks of query rows, all heads at once, so that a block's
scores are at most 2^28 fp32 values (1 GiB): 467 rows a block at a 12 MP
photo's 47,880 tokens and 12 heads.  The whole score matrix, 110 GB a
global block there, is never held.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FG_BOOST = 1.2
KILL_BELOW = 0.3
INT8_MIN_ELEMS = 1 << 16
BLOCK_ELEMS = 1 << 28
PIPELINE_KEYS = frozenset({"weight_storage"})


# ------------------------------------------------------------ parameters ---

def _sizes(cfg: dict) -> dict:
    b = cfg["backbone_config"]
    c = b["hidden_size"]
    return {"c": c, "heads": b["num_attention_heads"], "layers": b["num_hidden_layers"],
            "mlp": int(c * b["mlp_ratio"]), "patch": b["patch_size"], "cin": b["num_channels"],
            "grid": b["image_size"] // b["patch_size"],
            "pre": b["pretrain_image_size"] // b["patch_size"],
            "ws": b["window_size"], "windows": set(b["window_block_indices"]),
            "residual": set(b["residual_block_indices"]), "eps": b["layer_norm_eps"],
            "stream": list(cfg["convstream_hidden_sizes"]),
            "fusion": list(cfg["fusion_hidden_sizes"]), "bn_eps": cfg["batch_norm_eps"],
            "dec_c": cfg["hidden_size"]}


def param_table(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and BatchNorm statistic, in a
    fixed order; kind is "w" (conv or linear weight), "b" (its bias), "nw" /
    "nb" (a norm's scale / shift).  The relative-position tables are drawn
    as "w" (N(0, 1/d): the terms they add then weigh about as much as the
    scaled q.k, so the mechanism moves the answer), the absolute table as
    "b" (N(0, 0.05^2), a small shift of O(1) tokens), a BatchNorm's running
    variance as "nw" (positive) and its running mean as "nb"."""
    s = _sizes(cfg)
    c, d = s["c"], s["c"] // s["heads"]
    rows = []

    def add(name, shape, kind):
        rows.append((name, tuple(shape), kind))

    def norm(name, n):
        add(f"{name}.weight", (n,), "nw")
        add(f"{name}.bias", (n,), "nb")

    def bn(name, n):
        norm(name, n)
        add(f"{name}.running_mean", (n,), "nb")
        add(f"{name}.running_var", (n,), "nw")

    e = "backbone.embeddings"
    add(f"{e}.position_embeddings", (1, s["pre"] ** 2 + 1, c), "b")
    add(f"{e}.projection.weight", (c, s["cin"], s["patch"], s["patch"]), "w")
    add(f"{e}.projection.bias", (c,), "b")
    for i in range(s["layers"]):
        p = f"backbone.encoder.layer.{i}"
        side = s["ws"] if i in s["windows"] else s["grid"]
        norm(f"{p}.norm1", c)
        add(f"{p}.attention.rel_pos_h", (2 * side - 1, d), "w")
        add(f"{p}.attention.rel_pos_w", (2 * side - 1, d), "w")
        add(f"{p}.attention.qkv.weight", (3 * c, c), "w")
        add(f"{p}.attention.qkv.bias", (3 * c,), "b")
        add(f"{p}.attention.proj.weight", (c, c), "w")
        add(f"{p}.attention.proj.bias", (c,), "b")
        norm(f"{p}.norm2", c)
        add(f"{p}.mlp.fc1.weight", (s["mlp"], c), "w")
        add(f"{p}.mlp.fc1.bias", (s["mlp"],), "b")
        add(f"{p}.mlp.fc2.weight", (c, s["mlp"]), "w")
        add(f"{p}.mlp.fc2.bias", (c,), "b")
        if i in s["residual"]:
            r, m = f"{p}.residual", c // 2
            add(f"{r}.conv1.weight", (m, c, 1, 1), "w")
            norm(f"{r}.norm1", m)
            add(f"{r}.conv2.weight", (m, m, 3, 3), "w")
            norm(f"{r}.norm2", m)
            add(f"{r}.conv3.weight", (c, m, 1, 1), "w")
            norm(f"{r}.norm3", c)
    chans = [s["cin"], *s["stream"]]
    for i in range(len(s["stream"])):
        add(f"decoder.convstream.convs.{i}.conv.weight", (chans[i + 1], chans[i], 3, 3), "w")
        bn(f"decoder.convstream.convs.{i}.batch_norm", chans[i + 1])
    fus = [s["dec_c"], *s["fusion"]]
    for i in range(len(s["fusion"])):
        cin = fus[i] + chans[-(i + 1)]
        add(f"decoder.fusion_blocks.{i}.conv.conv.weight", (fus[i + 1], cin, 3, 3), "w")
        bn(f"decoder.fusion_blocks.{i}.conv.batch_norm", fus[i + 1])
    h = "decoder.matting_head.matting_convs"
    add(f"{h}.0.weight", (16, fus[-1], 3, 3), "w")
    add(f"{h}.0.bias", (16,), "b")
    bn(f"{h}.1", 16)
    add(f"{h}.3.weight", (1, 16, 1, 1), "w")
    add(f"{h}.3.bias", (1,), "b")
    return rows


def stored(params: dict, conf: dict) -> dict:
    """The weights as the deployment holds them: ``weight_storage`` "int8"
    (every conv or linear weight of at least 65,536 elements as
    round_half_even(w / s) clipped to +-127, times s, s = amax / 127 per
    output channel, 1 where amax is 0) or "fp" (as they are)."""
    if conf["pipeline"]["weight_storage"] != "int8":
        return params
    out = {}
    for name, w in params.items():
        if name.endswith(".weight") and w.ndim in (2, 4) and w.numel() >= INT8_MIN_ELEMS:
            wf = w.float()
            amax = wf.abs().amax(dim=tuple(range(1, wf.ndim)))
            sc = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
            sc = sc.reshape(-1, *([1] * (wf.ndim - 1)))
            w = torch.clamp(torch.round(wf / sc), -127, 127) * sc
        out[name] = w
    return out


# --------------------------------------------------------------- layers ---

def _ln(P, name, x, eps):
    """LayerNorm over the last dim."""
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], eps)


def _bn(P, name, x, eps):
    return F.batch_norm(x, P[f"{name}.running_mean"], P[f"{name}.running_var"],
                        P[f"{name}.weight"], P[f"{name}.bias"], False, 0.0, eps)


def get_rel_pos(q_size: int, k_size: int, rel_pos):
    """transformers' ``get_rel_pos``: (q_size, k_size, d)."""
    m = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != m:
        rel_pos = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
                                size=m, mode="linear").reshape(-1, m).permute(1, 0)
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def attention(P, name, x, heads, block_elems=BLOCK_ELEMS):
    """ViTDet's attention over (B, h, w, C) tokens, with the decomposed
    relative positions, in blocks of query rows."""
    b, h, w, c = x.shape
    n, d = h * w, c // heads
    qkv = F.linear(x, P[f"{name}.qkv.weight"], P[f"{name}.qkv.bias"])
    qkv = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).reshape(3, b * heads, n, d)
    q, k, v = qkv.unbind(0)
    rel_h = get_rel_pos(h, h, P[f"{name}.rel_pos_h"])
    rel_w = get_rel_pos(w, w, P[f"{name}.rel_pos_w"])
    r_q = q.reshape(b * heads, h, w, d)
    rh = torch.einsum("bhwc,hkc->bhwk", r_q, rel_h).reshape(b * heads, n, h)
    rw = torch.einsum("bhwc,wkc->bhwk", r_q, rel_w).reshape(b * heads, n, w)
    rows = max(1, min(n, block_elems // (b * heads * n)))
    out = []
    for s in range(0, n, rows):
        e = min(n, s + rows)
        sc = (q[:, s:e] * d ** -0.5) @ k.transpose(-2, -1)
        sc = (sc.view(b * heads, e - s, h, w) + rh[:, s:e, :, None]
              + rw[:, s:e, None, :]).view(b * heads, e - s, n)
        out.append(sc.softmax(dim=-1) @ v)
    o = torch.cat(out, dim=1).view(b, heads, h, w, d).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
    return F.linear(o, P[f"{name}.proj.weight"], P[f"{name}.proj.bias"])


def window_partition(x, ws):
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.contiguous().view(-1, ws, ws, c), (hp, wp)


def window_unpartition(win, ws, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = win.shape[0] // (hp * wp // ws // ws)
    x = win.view(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.contiguous().view(b, hp, wp, -1)[:, :h, :w].contiguous()


def _residual(P, name, x, eps):
    """The bottleneck on (B, h, w, C) tokens: its convs on NCHW, its
    LayerNorms over the channels."""
    def cn(y, norm):
        return _ln(P, f"{name}.{norm}", y.permute(0, 2, 3, 1), eps).permute(0, 3, 1, 2)

    y = x.permute(0, 3, 1, 2)
    y = F.gelu(cn(F.conv2d(y, P[f"{name}.conv1.weight"]), "norm1"))
    y = F.gelu(cn(F.conv2d(y, P[f"{name}.conv2.weight"], padding=1), "norm2"))
    y = cn(F.conv2d(y, P[f"{name}.conv3.weight"]), "norm3")
    return x + y.permute(0, 2, 3, 1)


def backbone(P, cfg, x):
    """x (B, 4, H, W) -> features (B, H/16, W/16, C)."""
    s = _sizes(cfg)
    e = "backbone.embeddings"
    t = F.conv2d(x, P[f"{e}.projection.weight"], P[f"{e}.projection.bias"],
                 stride=s["patch"]).permute(0, 2, 3, 1)
    gh, gw = t.shape[1:3]
    pos = P[f"{e}.position_embeddings"][:, 1:]
    side = math.isqrt(pos.shape[1])
    pos = pos.reshape(1, side, side, -1)
    if (side, side) != (gh, gw):
        pos = F.interpolate(pos.permute(0, 3, 1, 2), size=(gh, gw), mode="bicubic",
                            align_corners=False).permute(0, 2, 3, 1)
    t = t + pos
    for i in range(s["layers"]):
        t = block(P, cfg, i, t, s)
    return t


def block(P, cfg, i, t, s=None):
    """Block ``i`` on (B, h, w, C) tokens."""
    s = s or _sizes(cfg)
    p = f"backbone.encoder.layer.{i}"
    h = _ln(P, f"{p}.norm1", t, s["eps"])
    if i in s["windows"]:
        win, pad_hw = window_partition(h, s["ws"])
        a = window_unpartition(attention(P, f"{p}.attention", win, s["heads"]), s["ws"],
                               pad_hw, t.shape[1:3])
    else:
        a = attention(P, f"{p}.attention", h, s["heads"])
    t = t + a
    m = _ln(P, f"{p}.norm2", t, s["eps"])
    m = F.linear(F.gelu(F.linear(m, P[f"{p}.mlp.fc1.weight"], P[f"{p}.mlp.fc1.bias"])),
                 P[f"{p}.mlp.fc2.weight"], P[f"{p}.mlp.fc2.bias"])
    t = t + m
    if i in s["residual"]:
        t = _residual(P, f"{p}.residual", t, s["eps"])
    return t


def decoder(P, cfg, features, x):
    """features (B, h, w, C) at 1/16, x (B, 4, H, W) -> alpha (B, 1, H, W)."""
    s = _sizes(cfg)
    eps = s["bn_eps"]
    details = [x]
    for i in range(len(s["stream"])):
        c = f"decoder.convstream.convs.{i}"
        y = F.conv2d(details[-1], P[f"{c}.conv.weight"], stride=2, padding=1)
        details.append(F.relu(_bn(P, f"{c}.batch_norm", y, eps)))
    f = features.permute(0, 3, 1, 2)
    n = len(s["fusion"])
    for i in range(n):
        c = f"decoder.fusion_blocks.{i}.conv"
        up = F.interpolate(f, scale_factor=2, mode="bilinear", align_corners=False)
        y = F.conv2d(torch.cat([details[n - i - 1], up], dim=1), P[f"{c}.conv.weight"],
                     padding=1)
        f = F.relu(_bn(P, f"{c}.batch_norm", y, eps))
    h = "decoder.matting_head.matting_convs"
    f = F.relu(_bn(P, f"{h}.1", F.conv2d(f, P[f"{h}.0.weight"], P[f"{h}.0.bias"], padding=1),
                   eps))
    return torch.sigmoid(F.conv2d(f, P[f"{h}.3.weight"], P[f"{h}.3.bias"]))


# ------------------------------------------------------------- the call ---

def inputs(image, trimap, divisor=32):
    """image (B,H,W,3), trimap (B,H,W) in [0,1] -> (B, 4, Hp, Wp), zero-padded."""
    x = torch.cat([image * 2.0 - 1.0, trimap[..., None]], dim=-1).permute(0, 3, 1, 2)
    h, w = x.shape[2:]
    return F.pad(x, (0, (-w) % divisor, 0, (-h) % divisor))


def model_alpha(P, cfg, x):
    return decoder(P, cfg, backbone(P, cfg, x), x)


def matte(P, cfg, image, trimap, *, trimap_constraint=0.8, refine=True,
          output_mode="alpha_only"):
    """image (B,H,W,3), trimap (B,H,W) in [0,1] fp32 on P's device ->
    (alpha (B,H,W), matted (B,H,W,3|4))."""
    return finish(model_alpha(P, cfg, inputs(image, trimap)), image, trimap,
                  trimap_constraint=trimap_constraint, refine=refine, output_mode=output_mode)


def finish(alpha_p, image, trimap, *, trimap_constraint=0.8, refine=True,
           output_mode="alpha_only"):
    """The model's padded alpha (B,1,Hp,Wp) -> (alpha (B,H,W), matted
    (B,H,W,3|4)): cropped to the photo, clamped, refined and composited."""
    h, w = image.shape[1:3]
    alpha = alpha_p.float()[:, 0, :h, :w].clamp(0.0, 1.0)
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
    mix's options -> (alpha (H,W), matted (H,W,C)) fp32."""
    a, m = matte(P, cfg, image[None], trimap[None],
                 trimap_constraint=options["trimap_constraint"],
                 refine=options["mask_refine"], output_mode=options["output_mode"])
    return a[0].float(), m[0].float()


def meta_forward(cfg, options: dict, height: int, width: int):
    """The model's forward (ViTDet backbone, detail decoder) for one photo
    of that size, padded to 32, on the meta device."""
    meta = torch.device("meta")
    params = {n: torch.empty(s, device=meta) for n, s, _ in param_table(cfg)}
    x = torch.empty((1, 4, height + (-height) % 32, width + (-width) % 32), device=meta)
    return model_alpha(params, cfg, x)
