"""The PyTorch port's models against the JAX package on the tiny config.

Both packages get the same weights (the JAX package's ``sdmatte.init``,
inflated to O(1) activations and carried across by the port's
checkpoint/convert.py) and the same numpy inputs; the port runs on the CPU,
where every kernel site takes its plain version.  Bars are the JAX
package's own: 5e-5 for blocks (tests/test_block_parity.py), MAE <= 1e-4 for
the whole forward (tests/test_assembled_parity.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdmatte_tpu.checkpoint import manifest
from sdmatte_tpu.checkpoint.toy import tree_to_torch_state_dict
from sdmatte_tpu.configs import SDMatteConfig as JaxSDMatteConfig
from sdmatte_tpu.models import sdmatte as jax_sdmatte
from sdmatte_tpu.models import unet as jax_unet
from sdmatte_tpu.models import vae as jax_vae

from sdmatte_tpu_torch.checkpoint.convert import load_params, params_to_state_dict
from sdmatte_tpu_torch.configs import SDMatteConfig
from sdmatte_tpu_torch.models.sdmatte import SDMatte


def _randomized_params(cfg, seed=0):
    """sdmatte.init weights inflated to O(1) activations, as
    tests/test_assembled_parity.py::_randomized_params does."""
    params = jax_sdmatte.init(cfg, seed=seed)
    rng = np.random.default_rng(seed + 100)

    def bump(x):
        x = np.asarray(x)
        if x.ndim == 1 and np.all(x == 1.0):
            return rng.uniform(0.7, 1.3, x.shape).astype(np.float32)
        if x.ndim == 1:
            return rng.normal(0, 0.05, x.shape).astype(np.float32)
        fan_in = int(np.prod(x.shape[:-1]))
        return rng.normal(0, 1.0 / np.sqrt(fan_in), x.shape).astype(np.float32)

    return jax.tree_util.tree_map(bump, params)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxSDMatteConfig.tiny()
    params = _randomized_params(jcfg)
    model = load_params(SDMatte(SDMatteConfig.tiny()), params).eval()
    return jcfg, params, model


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("part", ["encode", "decode"])
def test_vae_matches_jax(tiny, rng, part):
    jcfg, params, model = tiny
    if part == "encode":
        x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
        ref = jax.jit(lambda p, x: jax_vae.encode(p, x, jcfg.vae, attn_impl="xla"))(
            params["vae"], x)
        with torch.no_grad():
            got = model.vae.encode(_nchw(x))
    else:
        z = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
        ref = jax.jit(lambda p, z: jax_vae.decode(p, z, jcfg.vae, attn_impl="xla"))(
            params["vae"], z)
        with torch.no_grad():
            got = model.vae.decode(_nchw(z))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("mask_on", [True, False])
def test_unet_matches_jax(tiny, rng, mask_on):
    jcfg, params, model = tiny
    b, h, w = 2, 8, 8
    sample = rng.standard_normal((b, h, w, 8)).astype(np.float32)
    ctx = rng.standard_normal((b, h * w, jcfg.unet.aux_token_dim)).astype(np.float32)
    coords = rng.standard_normal((b, 1280)).astype(np.float32)
    trans = np.array([1.0, 0.0], np.float32)
    mask = (rng.uniform(0, 1, (b, h * w)) < 0.5).astype(np.float32) if mask_on else None
    ref = jax.jit(lambda p, s, t, c, ce, m: jax_unet.apply(
        p, jcfg.unet, sample=s, trans=t, encoder_hidden_states=c,
        coords_embed={"bbox_mask_coords": ce}, attention_mask=m,
        attn_impl="xla"))(params["unet"], sample, trans, ctx, coords, mask)
    with torch.no_grad():
        got = model.unet(sample=_nchw(sample), trans=torch.from_numpy(trans),
                         encoder_hidden_states=torch.from_numpy(ctx),
                         coords_embed={"bbox_mask_coords": torch.from_numpy(coords)},
                         attention_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("case", ["default", "odd_s80", "mask_off"])
def test_forward_matches_jax(tiny, rng, case):
    jcfg, params, model = tiny
    b, s = (1, 80) if case == "odd_s80" else (2, 64)
    if case == "mask_off":
        jcfg = dataclasses.replace(jcfg, use_attention_mask=False)
        model.cfg = dataclasses.replace(model.cfg, use_attention_mask=False)
    data = {
        "image": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        "trimap": rng.choice([-1.0, 0.0, 1.0], (b, s, s, 1)).astype(np.float32),
        "trimap_coords": rng.uniform(0, 1, (b, 4)).astype(np.float32),
        "is_trans": np.array([0.0, 1.0], np.float32)[:b],
    }
    try:
        ref = np.asarray(jax.jit(lambda p, d: jax_sdmatte.forward(
            p, jcfg, d, attn_impl="xla"))(params, {k: jnp.asarray(v) for k, v in data.items()}))
        tdata = {k: (_nchw(v) if v.ndim == 4 else torch.from_numpy(v)) for k, v in data.items()}
        with torch.no_grad():
            got = _nhwc(model(tdata))
    finally:
        model.cfg = SDMatteConfig.tiny()
    assert got.shape == ref.shape
    mae = float(np.abs(got - ref).mean())
    assert mae <= 1e-4, mae


def test_params_to_state_dict_matches_jax_exporter(tiny):
    _, params, _ = tiny
    ours = params_to_state_dict(params)
    ref = tree_to_torch_state_dict(params)
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)


def test_full_width_module_has_the_checkpoint_keys():
    with torch.device("meta"):
        model = SDMatte(SDMatteConfig())
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    # manifest.expected_keys: vae.*, unet.* and text_encoder.*
    ref = {k: tuple(v) for k, v in manifest.expected_keys(JaxSDMatteConfig()).items()}
    assert ours == ref


def test_use_aux_input_false_raises(tiny):
    """The one forward that raises: without the aux latent there is no
    working path (the reference crashes identically); every other branch of
    the meta-architecture runs (tests/test_torch_meta_paths.py)."""
    _, _, model = tiny
    data = {"image": torch.zeros(1, 3, 16, 16), "trimap": torch.zeros(1, 1, 16, 16),
            "trimap_coords": torch.zeros(1, 4), "is_trans": torch.zeros(1)}
    model.cfg = dataclasses.replace(model.cfg, use_aux_input=False)
    try:
        with pytest.raises(NotImplementedError, match="use_aux_input"):
            model(data)
    finally:
        model.cfg = SDMatteConfig.tiny()
