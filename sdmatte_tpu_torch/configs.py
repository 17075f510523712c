"""Model configs of the PyTorch port: the port's own copy of the JAX package's
dataclasses (sdmatte_tpu/configs.py), with the same fields, defaults and
``tiny()`` sizes, so one config value means the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


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
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
                   intermediate_size=64)


@dataclasses.dataclass(frozen=True)
class SDMatteConfig:
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    clip: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
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
    def tiny(cls) -> "SDMatteConfig":
        return cls(vae=VAEConfig.tiny(), unet=UNetConfig.tiny(),
                   clip=CLIPTextConfig.tiny())


# aux-input type -> coordinate key
AUX_INPUT_COORDS = {
    "auto_mask": "auto_coords",
    "point_mask": "point_coords",
    "bbox_mask": "bbox_coords",
    "mask": "mask_coords",
    "trimap": "trimap_coords",
}
