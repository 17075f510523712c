"""The system under test, built from a configuration file: the port's
``MattingPipeline`` (and, for the server's cells, its ``MattingService``)
holding the benchmark's seeded weights.  This is the one module of the
benchmark that imports the program."""

from __future__ import annotations

import contextlib

import torch

from . import weights


def port_config(conf: dict):
    """The port's ``SDMatteConfig`` for a configuration file."""
    from sdmatte_tpu_torch.configs import CLIPTextConfig, SDMatteConfig, UNetConfig, VAEConfig
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
    from sdmatte_tpu_torch.core.dtypes import BF16, FP32
    return {"bfloat16": BF16, "float32": FP32}[conf["precision"]["compute"]]


@contextlib.contextmanager
def _skeleton():
    """Modules declared on the meta device without running their
    initialisers: the seeded weights replace every value, and on the meta
    device ``normal_`` goes through ``torch._refs``, whose first use imports
    ``torch._dynamo`` (seconds of set-up for nothing)."""
    names = ("normal_", "uniform_", "kaiming_uniform_", "ones_", "zeros_")
    saved = {n: getattr(torch.nn.init, n) for n in names}
    try:
        for n in names:
            setattr(torch.nn.init, n, lambda tensor, *a, **k: tensor)
        with torch.device("meta"):
            yield
    finally:
        for n, f in saved.items():
            setattr(torch.nn.init, n, f)


def build_pipeline(conf: dict, seed: int, device, *, control: bool = False, policy=None,
                   mark=lambda name: None):
    """The deployment's pipeline on ``device`` with the seed's weights.
    ``control`` switches on the program's own lower-precision path (the
    VAE's 3x3 convs in int8, ``vae_int8``) in the configuration's place;
    ``mark(name)`` is called as each step of the build ends."""
    from sdmatte_tpu_torch.models.sdmatte import SDMatte
    from sdmatte_tpu_torch.pipeline import MattingPipeline
    policy = policy or policy_of(conf)
    with _skeleton():
        model = SDMatte(port_config(conf))
    mark("model declared")
    text = {n: tuple(p.shape) for n, p in model.named_parameters()
            if n.startswith("text_encoder.")}
    params = weights.make_params(conf, seed, device, policy.param_dtype, text_shapes=text)
    mark("weights made")
    model.load_state_dict(params, strict=True, assign=True)
    del params
    keywords = dict(conf["pipeline"])     # every key reaches the pipeline: an unknown one raises
    if control:
        keywords["vae_int8"] = True
    pipe = MattingPipeline(model, policy=policy, device=device, **keywords)
    del model
    return pipe


def options(mix: dict):
    from sdmatte_tpu_torch.pipeline import PipelineOptions
    return PipelineOptions(**mix["options"])


def service(pipe, mix: dict, warmup):
    """The HTTP server's service object, its batcher warmed by ``warmup`` on
    its own worker thread."""
    from sdmatte_tpu_torch.api.serve import MattingService
    return MattingService(pipe, warmup=warmup, **mix["server"])


def overload_errors():
    from sdmatte_tpu_torch.api.serve import RequestTimeout, ServiceOverloaded
    return (ServiceOverloaded, RequestTimeout)


def hand_kernels() -> dict:
    """{name: Kernel} of the program's hand kernels (``ops/_build.Kernel``)."""
    from sdmatte_tpu_torch.ops import conv3x3, flash_attention  # noqa: F401  (registers them)
    from sdmatte_tpu_torch.ops._build import Kernel
    return {k.name: k for k in Kernel.registry}


def build_kernels() -> None:
    """Compile every stale hand-kernel library at once (nvcc in parallel);
    an up-to-date build directory loads as it is."""
    from sdmatte_tpu_torch.ops._build import build
    build()
