"""The port's remaining inference paths of the meta-architecture against the
JAX package on the tiny config: the point prompt, the split encode,
``vae_chunk``, the speed modes, ``return_intermediates`` and the
distillation features.

Both packages get the same weights (``sdmatte.init`` inflated to O(1)
activations, carried across by checkpoint/convert.py) and the same numpy
inputs, fp32, 64 px; the JAX side runs ``attn_impl="xla"`` and the port the
plain versions on the CPU.  Bars (the JAX package's fp32 bars):
  * 1e-5 max abs for an identity of the port with itself (split against
    concat, chunked against unchunked): the same math in another order
  * 5e-5 max abs against the JAX package (tests/test_block_parity.py's
    block bar), for every output and intermediate
The ``cuda`` cases hold the same paths on the card, kernels against plain
versions, at the bf16 bar (alpha MAE <= 1e-2).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sdmatte_tpu.configs import SDMatteConfig as JaxSDMatteConfig
from sdmatte_tpu.models import sdmatte as jax_sdmatte
from sdmatte_tpu.models import unet as jax_unet
from sdmatte_tpu.pipeline import MattingPipeline as JaxPipeline
from sdmatte_tpu.pipeline import PipelineOptions as JaxOptions
from test_torch_models import _nchw, _nhwc, _randomized_params

from sdmatte_tpu_torch.checkpoint.convert import load_params
from sdmatte_tpu_torch.configs import SDMatteConfig
from sdmatte_tpu_torch.core.embeddings import point_coords_padding
from sdmatte_tpu_torch.models import sdmatte
from sdmatte_tpu_torch.models.sdmatte import SDMatte
from sdmatte_tpu_torch.pipeline import MattingPipeline, PipelineOptions
from sdmatte_tpu_torch.pipeline.matting import SPEED_MODES

IDENTITY = 1e-5    # the port against itself, same math in another order
PARITY = 5e-5      # the port against the JAX package


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxSDMatteConfig.tiny()
    params = _randomized_params(jcfg, seed=1)
    model = load_params(SDMatte(SDMatteConfig.tiny()), params).eval()
    return jcfg, params, model


def _data(b, s=64, aux="trimap", n_points=4, seed=0):
    """NHWC numpy inputs of one forward: image, prompt, coords, is_trans."""
    rng = np.random.default_rng(seed)
    coords_key = "point_coords" if aux == "point_mask" else f"{aux}_coords"
    n = n_points if aux == "point_mask" else 4
    return {
        "image": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        aux: rng.choice([-1.0, 0.0, 1.0], (b, s, s, 1)).astype(np.float32),
        coords_key: rng.uniform(0, 1, (b, n)).astype(np.float32),
        "is_trans": (np.arange(b) % 2).astype(np.float32),
    }


def _jax(params, cfg, data, aux="trimap", **kw):
    return jax.jit(lambda p, d: jax_sdmatte.forward(
        p, cfg, d, aux_input_type=aux, attn_impl="xla", **kw))(params, data)


def _port(model, data, aux="trimap", **kw):
    tdata = {k: (_nchw(v) if v.ndim == 4 else torch.from_numpy(v)) for k, v in data.items()}
    with torch.no_grad():
        return model(tdata, aux_input_type=aux, **kw)


def _max_err(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max())


def test_point_coords_padding_matches_jax():
    from sdmatte_tpu.core.embeddings import point_coords_padding as jax_padding
    for n in (1, 2, 4, 9, 11, 100, 841, 1680):
        assert point_coords_padding(n) == jax_padding(n)
    assert point_coords_padding(4) == (4, 420)
    with pytest.raises(ValueError):
        point_coords_padding(1681)


def test_unet_point_branch_matches_jax(tiny, rng):
    """The point head alone (tests/test_models.py::test_unet_point_branch's
    inputs): (B, 1680) point embedding through unet.point_embedding."""
    jcfg, params, model = tiny
    b, h, w = 2, 8, 8
    sample = rng.standard_normal((b, h, w, 8)).astype(np.float32)
    ctx = rng.standard_normal((b, h * w, jcfg.unet.aux_token_dim)).astype(np.float32)
    pe = rng.standard_normal((b, jcfg.unet.point_embeddings_input_dim)).astype(np.float32)
    trans = np.array([1.0, 0.0], np.float32)
    ref = jax.jit(lambda p, s, t, c, ce: jax_unet.apply(
        p, jcfg.unet, sample=s, trans=t, encoder_hidden_states=c,
        coords_embed={"point_coords": ce}, attn_impl="xla"))(
        params["unet"], sample, trans, ctx, pe)
    with torch.no_grad():
        got = model.unet(sample=_nchw(sample), trans=torch.from_numpy(trans),
                         encoder_hidden_states=torch.from_numpy(ctx),
                         coords_embed={"point_coords": torch.from_numpy(pe)})
    assert _max_err(_nhwc(got), ref) <= PARITY
    with pytest.raises(ValueError, match="point_coords or bbox_mask_coords"):
        model.unet(sample=_nchw(sample), trans=torch.from_numpy(trans),
                   encoder_hidden_states=torch.from_numpy(ctx),
                   coords_embed={"other": torch.from_numpy(pe)})


@pytest.mark.parametrize("n_points,use_coor", [(4, True), (9, True), (4, False)])
def test_point_prompt_forward_matches_jax(tiny, n_points, use_coor):
    """N = 4 pads to 4 (420 channels), N = 9 to 10 (168); without
    use_coor_input the padded coords are zeros."""
    jcfg, params, model = tiny
    jcfg = dataclasses.replace(jcfg, use_coor_input=use_coor)
    model.cfg = dataclasses.replace(model.cfg, use_coor_input=use_coor)
    try:
        data = _data(2, aux="point_mask", n_points=n_points)
        ref = _jax(params, jcfg, data, aux="point_mask")
        got = _port(model, data, aux="point_mask")
    finally:
        model.cfg = SDMatteConfig.tiny()
    assert got.shape == (2, 1, 64, 64)
    assert _max_err(_nhwc(got), ref) <= PARITY


@pytest.mark.parametrize("b,split", [(2, True), (9, None)])
def test_split_encode(tiny, b, split):
    """Forced at B = 2; automatic at B = 9 (concat batch 18 > 16).  The split
    equals the concat pass (vae_encode_split=False) and the JAX split."""
    jcfg, params, model = tiny
    data = _data(b, seed=b)
    got = _port(model, data, vae_encode_split=split)
    concat = _port(model, data, vae_encode_split=False)
    assert got.shape == (b, 1, 64, 64)
    assert _max_err(got, concat) <= IDENTITY
    ref = _jax(params, jcfg, data, vae_encode_split=split)
    assert _max_err(_nhwc(got), ref) <= PARITY


@pytest.mark.parametrize("chunk", [2, 3])
def test_vae_chunk(tiny, chunk):
    """B = 4 in chunks of 2, and of 3, which falls back to 2 (the largest
    divisor of 4 below 3), against the unchunked call and the JAX chunking."""
    jcfg, params, model = tiny
    data = _data(4, seed=4)
    got = _port(model, data, vae_chunk=chunk)
    assert _max_err(got, _port(model, data)) <= IDENTITY
    ref = _jax(params, jcfg, data, vae_chunk=chunk)
    assert _max_err(_nhwc(got), ref) <= PARITY


def test_chunked_falls_back_to_a_divisor():
    """tests/test_review_fixes.py's case: b = 6 in chunks of 4 runs as two
    chunks of 3, not unchunked."""
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        return x * 2.0

    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    torch.testing.assert_close(sdmatte._chunked(fn, x, 4), x * 2.0)
    assert calls == [3, 3]
    calls.clear()
    sdmatte._chunked(fn, x, 8)
    assert calls == [6]


@pytest.mark.parametrize("mode", [m for m in SPEED_MODES if m != "off"])
def test_speed_mode_matches_jax(tiny, mode):
    """Each speed mode through both pipelines at 64 px (the port maps the
    mode onto the model's three flags as the JAX pipeline does)."""
    jcfg, params, model = tiny
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    tri = rng.choice([0.0, 0.5, 1.0], (2, 64, 64)).astype(np.float32)
    kw = dict(inference_size=64, mask_refine=False)
    ref, _ = JaxPipeline(params, jcfg, attn_impl="xla", speed_mode=mode)(
        img, tri, options=JaxOptions(**kw))
    pipe = MattingPipeline(model, device="cpu", speed_mode=mode)
    got, _ = pipe(img, tri, options=PipelineOptions(**kw))
    off, _ = MattingPipeline(model, device="cpu")(img, tri, options=PipelineOptions(**kw))
    assert _max_err(got.numpy(), ref) <= PARITY
    assert _max_err(got.numpy(), off.numpy()) > 1e-3   # the mode changed the matte


def test_return_intermediates_match_jax(tiny):
    """Every intermediate, key by key, in the JAX package's NHWC layout."""
    jcfg, params, model = tiny
    data = _data(2, seed=5)
    ref_alpha, ref = _jax(params, jcfg, data, return_intermediates=True)
    alpha, inter = _port(model, data, return_intermediates=True)
    assert inter.keys() == ref.keys() == {"rgb_latent", "aux_latent", "aux_tokens",
                                          "unet_out", "decoded", "feature_maps"}
    assert _max_err(_nhwc(alpha), ref_alpha) <= PARITY
    for key in ("rgb_latent", "aux_latent", "unet_out", "decoded"):
        assert _nhwc(inter[key]).shape == ref[key].shape, key
        assert _max_err(_nhwc(inter[key]), ref[key]) <= PARITY, key
    assert _max_err(inter["aux_tokens"].numpy(), ref["aux_tokens"]) <= PARITY
    assert len(inter["feature_maps"]) == len(ref["feature_maps"]) == 3
    for got, want in zip(inter["feature_maps"], ref["feature_maps"]):
        assert _max_err(_nhwc(got), want) <= PARITY


def test_dis_loss_features_match_jax(tiny):
    """use_dis_loss: (alpha, [after down, after mid, after up]) with the JAX
    package's channel counts; the pipeline keeps the alpha."""
    jcfg, params, model = tiny
    jcfg = dataclasses.replace(jcfg, use_dis_loss=True)
    model.cfg = dataclasses.replace(model.cfg, use_dis_loss=True)
    try:
        data = _data(1, seed=6)
        ref_alpha, ref = _jax(params, jcfg, data)
        alpha, feats = _port(model, data)
        pipe_alpha, _ = MattingPipeline(model, device="cpu")(
            np.full((64, 64, 3), 0.5, np.float32), np.full((64, 64), 0.5, np.float32),
            options=PipelineOptions(inference_size=64))
    finally:
        model.cfg = SDMatteConfig.tiny()
    ch = jcfg.unet.block_out_channels
    assert [f.shape[1] for f in feats] == [r.shape[-1] for r in ref] == [ch[-1], ch[-1], ch[0]]
    assert _max_err(_nhwc(alpha), ref_alpha) <= PARITY
    for got, want in zip(feats, ref):
        assert _max_err(_nhwc(got), want) <= PARITY
    assert pipe_alpha.shape == (1, 64, 64)


# -- on the card: the kernels' path against the plain versions ----------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the hand kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sdmatte_tpu_torch.core.dtypes import BF16
    from sdmatte_tpu_torch.models.init import init_random_
    dev = torch.device("cuda")
    with torch.device("meta"):
        model = SDMatte(SDMatteConfig())
    init_random_(model, seed=0, device=dev)

    def pipe(**kw):
        return MattingPipeline(model, policy=BF16, device=dev, **kw)

    return pipe


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["point", "split_b9", "chunk2_b4", "fastest"])
def test_meta_paths_on_card_match_plain(card, path):
    """Full width, bf16, 256 px: each path with the hand kernels against the
    same call on the plain versions, alpha before mask_refine MAE <= 1e-2."""
    rng = np.random.default_rng(0)
    b = {"split_b9": 9, "chunk2_b4": 4}.get(path, 1)
    img = rng.uniform(0, 1, (b, 256, 256, 3)).astype(np.float32)
    tri = rng.choice([0.0, 0.5, 1.0], (b, 256, 256)).astype(np.float32)
    aux = "point_mask" if path == "point" else "trimap"
    coords = rng.uniform(0, 1, (b, 4)).astype(np.float32)
    kw = {"chunk2_b4": {"vae_chunk": 2}, "fastest": {"speed_mode": "fastest"}}.get(path, {})
    opts = PipelineOptions(inference_size=256, mask_refine=False, aux_input=aux)
    got, _ = card(**kw)(img, tri, options=opts, coords=coords)
    if path == "split_b9":
        # the plain path's (B, H, 1024, 1024) scores are small at 256 px
        ref, _ = card(impl="plain", vae_encode_split=True, **kw)(img, tri, options=opts,
                                                                 coords=coords)
    else:
        ref, _ = card(impl="plain", **kw)(img, tri, options=opts, coords=coords)
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().mean()) <= 1e-2
