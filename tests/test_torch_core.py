"""The port's core ops against the JAX package's, in fp32 at 2e-5.

Layers take the port's ``nn.Module``s and the JAX package's param dicts,
both filled from the same numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from sdmatte_tpu.core import embeddings as jax_emb
from sdmatte_tpu.core import imaging as jax_img
from sdmatte_tpu.core import nn as jax_nn

from sdmatte_tpu_torch.core import embeddings, imaging
from sdmatte_tpu_torch.core import nn as F

TOL = dict(atol=2e-5, rtol=2e-5)
SIZES = (512, 640, 768, 896, 1024)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


# ------------------------------------------------------------------ resize ---

@pytest.mark.parametrize("size", SIZES)
def test_resize_matrices_of_the_inference_sizes(size):
    """The pipeline's pairs at each inference size: an odd photo (1000 x 750)
    down to S and the model's S back up to it, and the mask's S -> S/8."""
    for n_in, n_out in ((1000, size), (750, size), (size, 1000), (size, 750)):
        np.testing.assert_allclose(imaging.bilinear_aa_matrix(n_in, n_out, True),
                                   jax_img._bilinear_aa_matrix(n_in, n_out, True), **TOL)
    np.testing.assert_array_equal(imaging.nearest_index(size, size // 8),
                                  jax_img._nearest_index(size, size // 8))


@pytest.mark.parametrize("hw_in,hw_out", [((97, 80), (64, 64)), ((64, 64), (97, 80)),
                                          ((75, 61), (40, 40))])
def test_resize_bilinear_image(rng, hw_in, hw_out):
    x = rng.uniform(0, 1, (2, *hw_in, 3)).astype(np.float32)
    ref = jax_img.resize_bilinear(jnp.asarray(x), *hw_out, antialias=True)
    got = imaging.resize_bilinear(_t(x), *hw_out, antialias=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------- sinusoid ---

@pytest.mark.parametrize("dim,flip,shift", [(320, True, 0.0), (16, False, 1.0), (7, True, 0.0)])
def test_sinusoidal_embedding(rng, dim, flip, shift):
    t = rng.uniform(0, 1, (8,)).astype(np.float32)
    ref = jax_emb.sinusoidal_embedding(jnp.asarray(t), dim, flip_sin_to_cos=flip,
                                       downscale_freq_shift=shift)
    got = embeddings.sinusoidal_embedding(_t(t), dim, flip_sin_to_cos=flip,
                                          downscale_freq_shift=shift)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ------------------------------------------------------------------ layers ---

def _norm(rng, cls, c, **kw):
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.5, c).astype(np.float32)
    mod = cls(**kw)
    mod.weight.copy_(_t(scale))
    mod.bias.copy_(_t(bias))
    return mod, {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}


def _conv(rng, cin, cout, k=3):
    w = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32)
    mod = nn.Conv2d(cin, cout, k)
    mod.weight.copy_(_t(w).permute(3, 2, 0, 1))
    mod.bias.copy_(_t(b))
    return mod, {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}


def _linear(rng, cin, cout):
    w = (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32)
    mod = nn.Linear(cin, cout)
    mod.weight.copy_(_t(w).T)
    mod.bias.copy_(_t(b))
    return mod, {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("hw_in,hw_out", [((64, 64), (8, 8)), ((80, 80), (10, 10)),
                                          ((10, 10), (5, 5)), ((5, 5), (3, 3))])
def test_resize_nearest(rng, hw_in, hw_out):
    x = rng.uniform(0, 1, (1, *hw_in, 1)).astype(np.float32)
    ref = jax_img.resize_nearest(jnp.asarray(x), *hw_out)
    got = imaging.resize_nearest(_nchw(x), *hw_out)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))


def test_group_norm_stats(rng):
    x = rng.normal(0.3, 2.0, (2, 6, 5, 16)).astype(np.float32)
    mod, p = _norm(rng, nn.GroupNorm, 16, num_groups=4, num_channels=16, eps=1e-6)
    ra, rd = jax_nn.group_norm_stats(p, jnp.asarray(x), groups=4, eps=1e-6)
    a, d = F.group_norm_stats(mod, _nchw(x))
    np.testing.assert_allclose(a.numpy(), np.asarray(ra), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), **TOL)


# (NHWC shape, groups, eps): 8 channels a group; C = 320 at 32 groups (10 a
# group, as the U-Net's first level has); a batch of 3 at 6 a group
GN_CASES = [((2, 6, 5, 64), 8, 1e-6), ((1, 4, 3, 320), 32, 1e-5), ((3, 2, 7, 24), 4, 1e-6)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape,groups,eps", GN_CASES, ids=str)
def test_plain_group_norm_versions_against_jax(rng, shape, groups, eps, dtype):
    """ops/group_norm.py's plain versions, which the CPU and the "plain" scope
    run, against the JAX package's group_norm_stats and group_norm (then
    silu), and core/nn's entry points equal to them bit for bit on the CPU.
    In bf16 the statistics are fp32 on both sides; the outputs are one bf16
    rounding of nearly the same fp32 value, so within one bf16 ulp."""
    from sdmatte_tpu_torch.ops import group_norm as gn
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = rng.normal(0.3, 2.0, shape).astype(np.float32)
    x = np.array(jnp.asarray(x, jdt).astype(jnp.float32))       # representable in dtype
    c = shape[-1]
    mod, p = _norm(rng, nn.GroupNorm, c, num_groups=groups, num_channels=c, eps=eps)
    xt = _nchw(x).to(dtype)
    ra, rd = jax_nn.group_norm_stats(p, jnp.asarray(x, jdt), groups=groups, eps=eps)
    a, d = gn.group_norm_stats_plain(mod, xt)
    assert a.dtype == d.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), np.asarray(ra), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), **TOL)
    ref = jax_nn.group_norm(p, jnp.asarray(x, jdt), groups=groups, eps=eps)
    tol = TOL if dtype == torch.float32 else dict(atol=1e-6, rtol=2.0 ** -7)
    for silu, want in ((False, ref), (True, jax.nn.silu(ref.astype(jnp.float32)).astype(jdt))):
        y = gn.group_norm_apply_plain(xt, a, d, silu)
        assert y.dtype == dtype
        np.testing.assert_allclose(_nhwc(y.float()), np.asarray(want, np.float32), **tol)
        entry = F.gn_silu(mod, xt) if silu else F.group_norm(mod, xt)
        assert torch.equal(entry, y)
    ea, ed = F.group_norm_stats(mod, xt)
    assert torch.equal(ea, a) and torch.equal(ed, d)


@pytest.mark.parametrize("residual", [False, True])
def test_gn_silu_conv2d(rng, residual):
    x = rng.normal(0, 1, (2, 9, 7, 8)).astype(np.float32)
    norm, pn = _norm(rng, nn.GroupNorm, 8, num_groups=4, num_channels=8, eps=1e-5)
    conv, pc = _conv(rng, 8, 16)
    res = rng.normal(0, 1, (2, 9, 7, 16)).astype(np.float32) if residual else None
    ref = jax_nn.gn_silu_conv2d(pn, pc, jnp.asarray(x), groups=4, eps=1e-5,
                                residual=None if res is None else jnp.asarray(res))
    got = F.gn_silu_conv2d(norm, conv, _nchw(x), residual=None if res is None else _nchw(res))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (2, ((0, 1), (0, 1))), (1, 0)])
def test_conv2d(rng, stride, padding):
    x = rng.normal(0, 1, (1, 11, 10, 6)).astype(np.float32)
    conv, pc = _conv(rng, 6, 8, k=1 if padding == 0 else 3)
    ref = jax_nn.conv2d(pc, jnp.asarray(x), stride=stride, padding=padding)
    got = F.conv2d(conv, _nchw(x), stride=stride, padding=padding)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


def test_layer_norm(rng):
    x = rng.normal(0.5, 3.0, (2, 10, 24)).astype(np.float32)
    mod, p = _norm(rng, nn.LayerNorm, 24, normalized_shape=24)
    np.testing.assert_allclose(F.layer_norm(mod, _t(x)).numpy(),
                               np.asarray(jax_nn.layer_norm(p, jnp.asarray(x))), **TOL)


def test_geglu(rng):
    x = rng.normal(0, 1, (2, 10, 24)).astype(np.float32)
    mod, p = _linear(rng, 24, 64)
    np.testing.assert_allclose(F.geglu(mod, _t(x)).numpy(),
                               np.asarray(jax_nn.geglu(p, jnp.asarray(x))), **TOL)


def test_upsample2x_conv(rng):
    x = rng.normal(0, 1, (1, 5, 6, 4)).astype(np.float32)
    conv, pc = _conv(rng, 4, 4)
    ref = jax_nn.upsample2x_conv(pc, jnp.asarray(x), mode="base")
    np.testing.assert_allclose(_nhwc(F.upsample2x_conv(conv, _nchw(x))), np.asarray(ref), **TOL)
