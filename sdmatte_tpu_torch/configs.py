"""Model configs of the PyTorch port: the port's own copy of the JAX package's
dataclasses (sdmatte_tpu/configs.py), with the same fields, defaults and
``tiny()`` sizes, so one config value means the same model in both packages.

Each parses the diffusers/transformers JSON config set of SD2.1-base with the
JAX package's keys and defaults (``from_json``;
``SDMatteConfig.from_pretrained_dir`` for the whole directory).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    scaling_factor: float = 0.18215

    @classmethod
    def from_json(cls, path: str) -> "VAEConfig":
        d = _read_json(path)
        return cls(
            in_channels=d.get("in_channels", 3),
            out_channels=d.get("out_channels", 3),
            latent_channels=d.get("latent_channels", 4),
            block_out_channels=tuple(d.get("block_out_channels", (128, 256, 512, 512))),
            layers_per_block=d.get("layers_per_block", 2),
            norm_num_groups=d.get("norm_num_groups", 32),
            scaling_factor=d.get("scaling_factor", 0.18215),
        )

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
                   layers_per_block=1)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8                # rgb latent + aux latent
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    # HEADS per stage (SD2.1 naming): 320/5 = 640/10 = 1280/20 = d 64
    attention_head_dim: Sequence[int] = (5, 10, 20, 20)
    use_linear_projection: bool = True
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    transformer_norm_eps: float = 1e-6
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    down_has_attn: Sequence[bool] = (True, True, True, False)
    up_has_attn: Sequence[bool] = (False, True, True, True)
    aux_in_channels: int = 4
    aux_token_dim: int = 1024
    point_embeddings_input_dim: int = 1680
    bbox_embeddings_input_dim: int = 1280
    bbox_time_embed_dim: int = 1280
    # per-stage gating [down, mid, up]
    use_attention_mask_list: Sequence[bool] = (True, True, True)
    use_encoder_hidden_states_list: Sequence[bool] = (True, True, True)
    # attn1's own residual add at the 320-channel stages
    residual_connection: bool = False

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def from_json(cls, path: str, **overrides) -> "UNetConfig":
        """diffusers' ``attention_head_dim`` may be one int for every stage."""
        d = _read_json(path)
        head_dim = d.get("attention_head_dim", (5, 10, 20, 20))
        if isinstance(head_dim, int):
            head_dim = (head_dim,) * 4
        kw = dict(
            out_channels=d.get("out_channels", 4),
            block_out_channels=tuple(d.get("block_out_channels", (320, 640, 1280, 1280))),
            layers_per_block=d.get("layers_per_block", 2),
            cross_attention_dim=d.get("cross_attention_dim", 1024),
            attention_head_dim=tuple(head_dim),
            use_linear_projection=d.get("use_linear_projection", True),
            norm_num_groups=d.get("norm_num_groups", 32),
            point_embeddings_input_dim=d.get("point_embeddings_input_dim", 1680),
            bbox_embeddings_input_dim=d.get("bbox_embeddings_input_dim", 1280),
            bbox_time_embed_dim=d.get("bbox_time_embed_dim", 1280),
        )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def tiny(cls) -> "UNetConfig":
        return cls(
            block_out_channels=(16, 24, 32, 32),
            layers_per_block=1,
            cross_attention_dim=32,
            attention_head_dim=(2, 2, 4, 4),
            norm_num_groups=8,
            aux_token_dim=32,
            point_embeddings_input_dim=1680,
            bbox_embeddings_input_dim=1280,
        )


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"
    eos_token_id: int = 49407

    @classmethod
    def from_json(cls, path: str) -> "CLIPTextConfig":
        d = _read_json(path)
        return cls(
            vocab_size=d.get("vocab_size", 49408),
            hidden_size=d.get("hidden_size", 1024),
            num_layers=d.get("num_hidden_layers", 23),
            num_heads=d.get("num_attention_heads", 16),
            intermediate_size=d.get("intermediate_size", 4096),
            max_position_embeddings=d.get("max_position_embeddings", 77),
            hidden_act=d.get("hidden_act", "gelu"),
            eos_token_id=d.get("eos_token_id", 49407),
        )

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
                   intermediate_size=64)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """DDIM scheduler config, parsed for config-set compatibility only: the
    model is one deterministic pass with add_noise=False, so nothing runs
    the scheduler."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    steps_offset: int = 1
    clip_sample: bool = False

    @classmethod
    def from_json(cls, path: str) -> "SchedulerConfig":
        d = _read_json(path)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class SDMatteConfig:
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    clip: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    aux_input: str = "trimap"
    use_aux_input: bool = True
    use_coor_input: bool = True
    use_attention_mask: bool = True
    attn_mask_aux_input: Sequence[str] = ("point_mask", "bbox_mask", "mask", "trimap")
    aux_input_list: Sequence[str] = ("point_mask", "bbox_mask", "mask", "trimap")
    use_encoder_hidden_states: bool = True
    add_noise: bool = False
    use_encoder_attention_mask: bool = False
    use_dis_loss: bool = False

    @classmethod
    def from_pretrained_dir(cls, base_dir: str, **overrides) -> "SDMatteConfig":
        """Build from a diffusers-layout config directory (the SD2.1 config
        set), also in the nested ``dir/dir`` layout."""
        def resolve(sub, fname):
            direct = os.path.join(base_dir, sub, fname)
            nested = os.path.join(base_dir, sub, sub, fname)
            return direct if os.path.exists(direct) else nested
        sched_path = resolve("scheduler", "scheduler_config.json")
        sched = (SchedulerConfig.from_json(sched_path)
                 if os.path.exists(sched_path) else SchedulerConfig())
        return cls(
            vae=VAEConfig.from_json(resolve("vae", "config.json")),
            unet=UNetConfig.from_json(resolve("unet", "config.json")),
            clip=CLIPTextConfig.from_json(resolve("text_encoder", "config.json")),
            scheduler=sched,
            **overrides,
        )

    @classmethod
    def tiny(cls) -> "SDMatteConfig":
        return cls(vae=VAEConfig.tiny(), unet=UNetConfig.tiny(),
                   clip=CLIPTextConfig.tiny())


def save_pretrained_dir(cfg: SDMatteConfig, base_dir: str) -> str:
    """Write ``cfg`` as a diffusers-layout config directory
    (``{vae,unet,text_encoder}/config.json`` and
    ``scheduler/scheduler_config.json``) under the published SD2.1-base key
    names, which :meth:`SDMatteConfig.from_pretrained_dir` reads back as
    ``cfg`` (its fields that have no published key keep their defaults)."""
    v, u, c = cfg.vae, cfg.unet, cfg.clip
    n_up = len(u.block_out_channels)
    files = {
        "vae/config.json": {
            "_class_name": "AutoencoderKL", "act_fn": "silu",
            "in_channels": v.in_channels, "out_channels": v.out_channels,
            "latent_channels": v.latent_channels,
            "block_out_channels": list(v.block_out_channels),
            "down_block_types": ["DownEncoderBlock2D"] * len(v.block_out_channels),
            "up_block_types": ["UpDecoderBlock2D"] * len(v.block_out_channels),
            "layers_per_block": v.layers_per_block,
            "norm_num_groups": v.norm_num_groups,
            "scaling_factor": v.scaling_factor,
        },
        "unet/config.json": {
            "_class_name": "UNet2DConditionModel", "act_fn": "silu",
            "in_channels": u.in_channels, "out_channels": u.out_channels,
            "block_out_channels": list(u.block_out_channels),
            "down_block_types": ["CrossAttnDownBlock2D" if a else "DownBlock2D"
                                 for a in u.down_has_attn],
            "up_block_types": ["CrossAttnUpBlock2D" if a else "UpBlock2D"
                               for a in u.up_has_attn][:n_up],
            "layers_per_block": u.layers_per_block,
            "cross_attention_dim": u.cross_attention_dim,
            "attention_head_dim": list(u.attention_head_dim),
            "use_linear_projection": u.use_linear_projection,
            "norm_num_groups": u.norm_num_groups, "norm_eps": u.norm_eps,
            "flip_sin_to_cos": u.flip_sin_to_cos, "freq_shift": u.freq_shift,
            "point_embeddings_input_dim": u.point_embeddings_input_dim,
            "bbox_embeddings_input_dim": u.bbox_embeddings_input_dim,
            "bbox_time_embed_dim": u.bbox_time_embed_dim,
        },
        "text_encoder/config.json": {
            "architectures": ["CLIPTextModel"], "model_type": "clip_text_model",
            "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
            "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads,
            "intermediate_size": c.intermediate_size,
            "max_position_embeddings": c.max_position_embeddings,
            "layer_norm_eps": c.layer_norm_eps, "hidden_act": c.hidden_act,
            "eos_token_id": c.eos_token_id,
        },
        "scheduler/scheduler_config.json": {
            "_class_name": "DDIMScheduler", **dataclasses.asdict(cfg.scheduler)},
    }
    for rel, d in files.items():
        path = os.path.join(base_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(d, f, indent=2)
    return base_dir


@dataclasses.dataclass(frozen=True)
class ViTMatteConfig:
    """ViTMatte (hustvl/ViTMatte, arXiv:2305.15272): a ViTDet backbone over
    photo || trimap and a conv detail decoder.  The defaults are
    ``hustvl/vitmatte-base-composition-1k``'s published config (transformers'
    ``VitMatteConfig`` around its ``VitDetConfig``): 768 wide, 12 heads, 12
    blocks, blocks 0, 1, 3, 4, 6, 7, 9 and 10 in 14 x 14 windows, blocks 2, 5,
    8 and 11 global with a residual bottleneck after them."""
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: int = 4
    patch_size: int = 16
    num_channels: int = 4
    image_size: int = 512               # the global blocks' rel-pos tables: 2 * 512/16 - 1 rows
    pretrain_image_size: int = 224      # the absolute table: (224/16)^2 + 1 (cls) rows
    window_size: int = 14
    window_block_indices: Sequence[int] = (0, 1, 3, 4, 6, 7, 9, 10)
    residual_block_indices: Sequence[int] = (2, 5, 8, 11)
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    convstream_hidden_sizes: Sequence[int] = (48, 96, 192)
    fusion_hidden_sizes: Sequence[int] = (256, 128, 64, 32)
    batch_norm_eps: float = 1e-5
    size_divisor: int = 32              # the image processor's padding

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_dict(cls, d: dict) -> "ViTMatteConfig":
        """A transformers ``config.json`` of ``VitMatteForImageMatting`` (its
        ``backbone_config`` group), transformers' defaults for absent keys."""
        b = d.get("backbone_config", {})
        f = cls()
        return cls(
            hidden_size=b.get("hidden_size", f.hidden_size),
            num_hidden_layers=b.get("num_hidden_layers", f.num_hidden_layers),
            num_attention_heads=b.get("num_attention_heads", f.num_attention_heads),
            mlp_ratio=b.get("mlp_ratio", f.mlp_ratio),
            patch_size=b.get("patch_size", f.patch_size),
            num_channels=b.get("num_channels", f.num_channels),
            image_size=b.get("image_size", f.image_size),
            pretrain_image_size=b.get("pretrain_image_size", f.pretrain_image_size),
            window_size=b.get("window_size", f.window_size),
            window_block_indices=tuple(b.get("window_block_indices", f.window_block_indices)),
            residual_block_indices=tuple(b.get("residual_block_indices",
                                               f.residual_block_indices)),
            layer_norm_eps=b.get("layer_norm_eps", f.layer_norm_eps),
            qkv_bias=b.get("qkv_bias", f.qkv_bias),
            convstream_hidden_sizes=tuple(d.get("convstream_hidden_sizes",
                                                f.convstream_hidden_sizes)),
            fusion_hidden_sizes=tuple(d.get("fusion_hidden_sizes", f.fusion_hidden_sizes)),
            batch_norm_eps=d.get("batch_norm_eps", f.batch_norm_eps),
        )

    def to_dict(self) -> dict:
        """The transformers ``config.json`` form that :meth:`from_dict` reads."""
        return {
            "backbone_config": {
                "model_type": "vitdet", "hidden_size": self.hidden_size,
                "num_hidden_layers": self.num_hidden_layers,
                "num_attention_heads": self.num_attention_heads, "mlp_ratio": self.mlp_ratio,
                "patch_size": self.patch_size, "num_channels": self.num_channels,
                "image_size": self.image_size, "pretrain_image_size": self.pretrain_image_size,
                "window_size": self.window_size,
                "window_block_indices": list(self.window_block_indices),
                "residual_block_indices": list(self.residual_block_indices),
                "layer_norm_eps": self.layer_norm_eps, "qkv_bias": self.qkv_bias,
                "use_absolute_position_embeddings": True,
                "use_relative_position_embeddings": True,
                "out_features": [f"stage{self.num_hidden_layers}"]},
            "model_type": "vitmatte", "hidden_size": self.hidden_size,
            "convstream_hidden_sizes": list(self.convstream_hidden_sizes),
            "fusion_hidden_sizes": list(self.fusion_hidden_sizes),
            "batch_norm_eps": self.batch_norm_eps,
        }

    @classmethod
    def tiny(cls) -> "ViTMatteConfig":
        """Every kind of block at test size: block 0 in 4 x 4 windows, block 1
        global with the residual bottleneck; rel-pos tables in both."""
        return cls(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                   image_size=64, pretrain_image_size=64, window_size=4,
                   window_block_indices=(0,), residual_block_indices=(1,),
                   convstream_hidden_sizes=(8, 12, 16), fusion_hidden_sizes=(16, 12, 8, 8))


# aux-input type -> coordinate key
AUX_INPUT_COORDS = {
    "auto_mask": "auto_coords",
    "point_mask": "point_coords",
    "bbox_mask": "bbox_coords",
    "mask": "mask_coords",
    "trimap": "trimap_coords",
}
