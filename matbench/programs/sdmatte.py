"""SDMatte in the port: ``SDMatte`` declared from the configuration's
``vae``, ``unet``, ``text_encoder`` and ``sdmatte`` groups, served by the
port's ``MattingPipeline``.  The port is imported here, when the module is
first asked for, so that ``declare`` imports nothing on the meta device."""

from __future__ import annotations

from sdmatte_tpu_torch.configs import CLIPTextConfig, SDMatteConfig, UNetConfig, VAEConfig
from sdmatte_tpu_torch.core.dtypes import BF16, FP32
from sdmatte_tpu_torch.models.sdmatte import SDMatte
from sdmatte_tpu_torch.pipeline import MattingPipeline, PipelineOptions

# the program's own lower-precision path: the VAE's 3x3 convs in int8 (K4)
CONTROL = {"vae_int8": True}


def port_config(conf: dict):
    """The port's ``SDMatteConfig`` for a configuration file."""
    v, u, t, s = conf["vae"], conf["unet"], conf["text_encoder"], conf["sdmatte"]
    vae = VAEConfig(in_channels=v["in_channels"], out_channels=v["out_channels"],
                    latent_channels=v["latent_channels"],
                    block_out_channels=tuple(v["block_out_channels"]),
                    layers_per_block=v["layers_per_block"], norm_num_groups=v["norm_num_groups"],
                    norm_eps=v["norm_eps"], scaling_factor=v["scaling_factor"])
    unet = UNetConfig(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]),
        layers_per_block=u["layers_per_block"], cross_attention_dim=u["cross_attention_dim"],
        attention_head_dim=tuple(u["attention_head_dim"]),
        use_linear_projection=u["use_linear_projection"], norm_num_groups=u["norm_num_groups"],
        norm_eps=u["norm_eps"], transformer_norm_eps=u["transformer_norm_eps"],
        flip_sin_to_cos=u["flip_sin_to_cos"], freq_shift=float(u["freq_shift"]),
        down_has_attn=tuple(x.startswith("CrossAttn") for x in u["down_block_types"]),
        up_has_attn=tuple(x.startswith("CrossAttn") for x in u["up_block_types"]),
        aux_in_channels=u["aux_in_channels"], aux_token_dim=u["aux_token_dim"],
        point_embeddings_input_dim=u["point_embeddings_input_dim"],
        bbox_embeddings_input_dim=u["bbox_embeddings_input_dim"],
        bbox_time_embed_dim=u["bbox_time_embed_dim"],
        use_attention_mask_list=tuple(u["use_attention_mask_list"]),
        use_encoder_hidden_states_list=tuple(u["use_encoder_hidden_states_list"]),
        residual_connection=u["residual_connection"])
    clip = CLIPTextConfig(vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                          num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
                          intermediate_size=t["intermediate_size"],
                          max_position_embeddings=t["max_position_embeddings"],
                          layer_norm_eps=t["layer_norm_eps"], hidden_act=t["hidden_act"],
                          eos_token_id=t["eos_token_id"])
    return SDMatteConfig(vae=vae, unet=unet, clip=clip, aux_input=s["aux_input"],
                         use_coor_input=s["use_coor_input"],
                         use_attention_mask=s["use_attention_mask"],
                         use_encoder_attention_mask=s["use_encoder_attention_mask"],
                         add_noise=s["add_noise"])


def policy_of(conf: dict):
    return {"bfloat16": BF16, "float32": FP32}[conf["precision"]["compute"]]


def declare(conf: dict):
    return SDMatte(port_config(conf))


def program_only_shapes(model) -> dict:
    """The CLIP text tower, which the program keeps resident but the
    default gating never runs, and so the reference does not model."""
    return {n: tuple(p.shape) for n, p in model.named_parameters()
            if n.startswith("text_encoder.")}


def param_dtype(conf: dict):
    return policy_of(conf).param_dtype


def pipeline(model, conf: dict, device, **keywords):
    return MattingPipeline(model, policy=policy_of(conf), device=device, **keywords)


def options(mix: dict):
    return PipelineOptions(**mix["options"])
