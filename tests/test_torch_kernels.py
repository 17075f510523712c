"""The port's kernel sites: their plain versions against the JAX package's
Pallas kernels (run in interpret mode on the CPU, as tests/test_flash_attention.py
and tests/test_conv3x3.py run them), and the CUDA kernels against the plain
versions on the card.

The CUDA cases carry the ``cuda`` marker and skip without a card; on the card
run ``python -m pytest tests/test_torch_kernels.py -m cuda``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdmatte_tpu.ops.conv3x3 import conv3x3_same, conv3x3_same_csplit, conv3x3_same_int8
from sdmatte_tpu.ops.flash_attention import flash_attention as jax_flash_attention

from sdmatte_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_csplit, conv3x3_int8,
                                           conv3x3_int8_plain, conv3x3_plain)
from sdmatte_tpu_torch.ops.dispatch import implementation, plain_here
from sdmatte_tpu_torch.ops.flash_attention import attention_plain, flash_attention


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# -------------------------------------------------------------- attention ---

ATTN_CASES = {
    # (b, h, lq, lk, d), biased, bf16, (atol, rtol) of tests/test_flash_attention.py
    "multiblock_bias_d64": ((1, 2, 256, 256, 64), True, False, (2e-5, 2e-5)),
    "ragged_100x200": ((1, 1, 100, 200, 64), True, False, (2e-5, 2e-5)),
    "wide_head_d512": ((1, 1, 128, 128, 512), False, False, (2e-5, 2e-5)),
    "bf16_bias": ((1, 2, 128, 256, 64), True, True, (2e-2, 2e-2)),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_plain_attention_matches_pallas_kernel(rng, case):
    (b, h, lq, lk, d), biased, bf16, (atol, rtol) = ATTN_CASES[case]
    q, k, v = (rng.standard_normal((b, h, n, d), dtype=np.float32) for n in (lq, lk, lk))
    bias = (rng.uniform(0, 1, (b, lk)) < 0.5).astype(np.float32) * -10000.0 if biased else None
    scale = 1.0 / np.sqrt(d)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), scale=scale,
                                  bias=None if bias is None else jnp.asarray(bias),
                                  block_q=128, block_k=128)
    tdt = torch.bfloat16 if bf16 else torch.float32
    got = attention_plain(*(_t(x).to(tdt) for x in (q, k, v)), scale=scale,
                          bias=None if bias is None else _t(bias))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


def test_wrapper_takes_the_plain_version_on_the_cpu(rng):
    q, k, v = (_t(rng.standard_normal((1, 2, 40, 64))) for _ in range(3))
    bias = _t((rng.uniform(0, 1, (1, 40)) < 0.5) * -10000.0)
    torch.testing.assert_close(flash_attention(q, k, v, scale=0.125, bias=bias),
                               attention_plain(q, k, v, scale=0.125, bias=bias),
                               rtol=0, atol=0)


# ------------------------------------------------------------------- conv ---

CONV_CASES = ["bare", "ragged_rows_bias", "gn_prologue_border", "residual"]


@pytest.mark.parametrize("case", CONV_CASES)
def test_plain_conv_matches_pallas_kernel(rng, case):
    """conv3x3_plain (NCHW, OIHW) against conv3x3_same (NHWC, HWIO) in
    interpret mode, at tests/test_conv3x3.py's shapes and 3e-5."""
    shape = {"bare": (1, 16, 24, 8), "ragged_rows_bias": (2, 13, 24, 8),
             "gn_prologue_border": (2, 16, 24, 8), "residual": (1, 16, 16, 8)}[case]
    b, h, w, c = shape
    cout = 16 if case == "bare" else 8
    x = rng.standard_normal(shape).astype(np.float32)
    wk = (rng.standard_normal((3, 3, c, cout)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32) if case != "bare" else None
    affine = res = None
    if case == "gn_prologue_border":
        # d != 0: the zero border must stay zero through silu(x * a + d)
        affine = (rng.uniform(0.5, 2.0, (b, c)).astype(np.float32),
                  rng.uniform(0.5, 1.5, (b, c)).astype(np.float32))
    if case == "residual":
        res = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = conv3x3_same(jnp.asarray(x), jnp.asarray(wk),
                           None if bias is None else jnp.asarray(bias),
                           affine=None if affine is None else tuple(map(jnp.asarray, affine)),
                           residual=None if res is None else jnp.asarray(res), block_rows=8)
    got = conv3x3_plain(_t(x).permute(0, 3, 1, 2), _t(wk).permute(3, 2, 0, 1),
                        None if bias is None else _t(bias),
                        affine=None if affine is None else tuple(map(_t, affine)),
                        residual=None if res is None else _t(res).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("fuse_sum", [True, False])
def test_csplit_matches_pallas_wrapper(rng, fuse_sum):
    """conv3x3_csplit against conv3x3_same_csplit in interpret mode, with the
    GroupNorm affine and the residual in play, at tests/test_conv3x3.py's
    csplit bar."""
    x = rng.standard_normal((1, 16, 16, 16)).astype(np.float32)
    wk = (rng.standard_normal((3, 3, 16, 8)) * 0.1).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    a = rng.uniform(0.5, 2.0, (1, 16)).astype(np.float32)
    d = rng.uniform(-0.5, 0.5, (1, 16)).astype(np.float32)
    res = rng.standard_normal((1, 16, 16, 8)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = conv3x3_same_csplit(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b),
                                  affine=(jnp.asarray(a), jnp.asarray(d)),
                                  residual=jnp.asarray(res), block_rows=8, fuse_sum=fuse_sum)
    got = conv3x3_csplit(_t(x).permute(0, 3, 1, 2), _t(wk).permute(3, 2, 0, 1), _t(b),
                         affine=(_t(a), _t(d)), residual=_t(res).permute(0, 3, 1, 2),
                         fuse_sum=fuse_sum)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("shape,bias", [((1, 16, 24, 8, 16), True), ((2, 13, 24, 8, 8), False)])
def test_int8_plain_conv_matches_pallas_kernel(rng, shape, bias):
    """conv3x3_int8_plain against conv3x3_same_int8 (the TPU int8 kernel) in
    interpret mode, at tests/test_conv3x3.py's int8 bar."""
    b, h, w, cin, cout = shape
    xq = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    scale = rng.uniform(0.5, 2.0, (cout,)).astype(np.float32)
    bv = rng.standard_normal(cout).astype(np.float32) if bias else None
    with pltpu.force_tpu_interpret_mode():
        ref = conv3x3_same_int8(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                                None if bv is None else jnp.asarray(bv), block_rows=8,
                                out_dtype=jnp.float32)
    got = conv3x3_int8_plain(torch.from_numpy(xq).permute(0, 3, 1, 2),
                             torch.from_numpy(wq).permute(3, 2, 0, 1), _t(scale),
                             None if bv is None else _t(bv), out_dtype=torch.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=1e-3, rtol=1e-6)


def test_int8_wrapper_takes_the_plain_version_on_the_cpu(rng):
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 3, 9, 11)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (5, 3, 3, 3)).astype(np.int8))
    scale = _t(rng.uniform(0.5, 2.0, 5))
    kw = dict(stride=2, padding=((0, 1), (0, 1)), out_dtype=torch.float32)
    got = conv3x3_int8(xq, wq, scale, **kw)
    assert got.shape == (2, 5, 4, 5)
    torch.testing.assert_close(got, conv3x3_int8_plain(xq, wq, scale, **kw), rtol=0, atol=0)


# ------------------------------------------- the implementation scope ---
# ops/dispatch.implementation: the one switch between a kernel and its plain
# version, per thread, "auto" by default; every entry point asks plain_here.

def _setting():
    """The calling thread's implementation, as an entry point sees it for a
    tensor on a device with no kernel (meta)."""
    return "plain" if plain_here(torch.empty(0, device="meta")) else "auto"


def test_the_default_is_auto_and_plain_is_the_cpu_alone():
    assert _setting() == "auto"
    assert plain_here(torch.empty(1)) and not plain_here(torch.empty(1, device="meta"))
    with implementation("plain"):
        assert plain_here(torch.empty(1, device="meta"))
    with pytest.raises(ValueError, match="'auto' or 'plain'"):
        with implementation("xla"):
            pass


@pytest.mark.parametrize("leave", ["on_exit", "on_an_exception"])
def test_scopes_nest_and_restore_the_outer_setting(leave):
    class Leave(Exception):
        pass

    with implementation("plain"):
        try:
            with implementation("auto"):
                assert _setting() == "auto"
                with implementation("plain"):
                    assert _setting() == "plain"
                assert _setting() == "auto"
                if leave == "on_an_exception":
                    raise Leave
        except Leave:
            pass
        assert _setting() == "plain"
    assert _setting() == "auto"


def test_the_setting_is_per_thread():
    import threading
    inside, seen = threading.Event(), []

    def other():
        inside.wait(30)
        seen.append(_setting())
        with implementation("plain"):
            seen.append(_setting())
    t = threading.Thread(target=other)
    t.start()
    with implementation("plain"):
        inside.set()
        t.join(30)
        assert _setting() == "plain"
    assert seen == ["auto", "plain"] and _setting() == "auto"


def _meta_site(name):
    """A call of one entry point on the meta device, where only a plain
    version can run (no kernel takes a meta tensor)."""
    meta = torch.device("meta")
    if name == "flash_attention":
        q = torch.empty(1, 2, 16, 64, device=meta)
        return lambda: flash_attention(q, q, q, scale=0.125)
    if name == "conv3x3":
        x = torch.empty(1, 16, 8, 8, device=meta).contiguous(memory_format=torch.channels_last)
        return lambda: conv3x3(x, torch.empty(16, 16, 3, 3, device=meta))
    xq = torch.empty(1, 16, 8, 8, device=meta, dtype=torch.int8)
    wq = torch.empty(8, 16, 3, 3, device=meta, dtype=torch.int8)
    return lambda: conv3x3_int8(xq, wq, torch.empty(8, device=meta), out_dtype=torch.float32)


@pytest.mark.parametrize("name", ["flash_attention", "conv3x3", "conv3x3_int8"])
def test_every_entry_point_takes_the_plain_version_inside_plain(name):
    call = _meta_site(name)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        call()
    with implementation("plain"):
        assert call().device.type == "meta"


def _tiny_model():
    from sdmatte_tpu_torch.configs import SDMatteConfig
    from sdmatte_tpu_torch.models.init import init_random_
    from sdmatte_tpu_torch.models.sdmatte import SDMatte
    return init_random_(SDMatte(SDMatteConfig.tiny()), seed=0)


def test_a_training_step_runs_under_plain(monkeypatch):
    """The step's forward sees "plain" inside an outer "auto", and a
    rematerialised block's recompute sees it too when the backward runs on
    another thread, as the autograd engine runs a card's backward."""
    import threading
    from sdmatte_tpu_torch.models import unet
    from sdmatte_tpu_torch.parallel import train
    from sdmatte_tpu_torch.parallel.data import CompositeSampler, to_tensors
    seen = {"forward": set(), "recompute": set()}
    phase = ["forward"]
    forward = unet.ResnetBlock.forward

    def spy(self, *a):
        seen[phase[0]].add(_setting())
        return forward(self, *a)
    monkeypatch.setattr(unet.ResnetBlock, "forward", spy)
    model = _tiny_model()
    batch = to_tensors(CompositeSampler(size=32).batch(1))
    with implementation("auto"):
        train.train_step(train.init_train_state(model, 1e-3), batch)
        loss = train.matting_loss(model, batch, remat=True)
    phase[0] = "recompute"
    t = threading.Thread(target=loss.backward)
    t.start()
    t.join(120)
    assert seen == {"forward": {"plain"}, "recompute": {"plain"}}


# ------------------------------------------------------------- on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the hand kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, atol, rtol):
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


def _close_attn(got, ref):
    """fp32: the JAX package's 2e-5 bar.  bf16: its 2e-2 bar relative to the
    output's scale, max|got - ref| <= 2e-2 * max|ref|, since at long Lk the
    outputs are smaller than a fixed atol of 2e-2."""
    if ref.dtype == torch.float32:
        return _close(got, ref, 2e-5, 2e-5)
    err = float((got.float() - ref.float()).abs().max())
    bar = 2e-2 * float(ref.float().abs().max())
    assert err <= bar, f"max |got - ref| {err} > {bar} (2e-2 * max|ref|)"


@pytest.mark.parametrize("lk,d,biased", [(16384, 64, True), (16384, 512, False)])
def test_bf16_attention_bar_rejects_a_dropped_kv_tile(lk, d, biased):
    """At the main path's Lk = 16384 the bf16 bar must reject the output of a
    kernel that skips one 64-key tile, which a fixed atol of 2e-2 would not."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 1, n, d, generator=g).bfloat16() for n in (128, lk, lk))
    bias = (torch.rand(1, lk, generator=g) < 0.5).float() * -10000.0 if biased else None
    ref = attention_plain(q, k, v, scale=d ** -0.5, bias=bias)
    keep = torch.ones(lk, dtype=torch.bool)
    keep[4096:4160] = False
    dropped = attention_plain(q, k[:, :, keep], v[:, :, keep], scale=d ** -0.5,
                              bias=None if bias is None else bias[:, keep])
    assert float((dropped.float() - ref.float()).abs().max()) < 2e-2
    _close_attn(ref, ref)
    with pytest.raises(AssertionError):
        _close_attn(dropped, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2, 256, 256, 64), (1, 5, 1000, 777, 64),
                                   (2, 3, 130, 4096, 128)])
def test_k1_matches_plain(cuda, dtype, shape):
    b, h, lq, lk, d = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, h, n, d, generator=g, device=cuda).to(dtype) for n in (lq, lk, lk))
    bias = (torch.rand(b, lk, generator=g, device=cuda) < 0.5).float() * -10000.0
    _close_attn(flash_attention(q, k, v, scale=d ** -0.5, bias=bias),
                attention_plain(q, k, v, scale=d ** -0.5, bias=bias))


@pytest.mark.cuda
@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("shape", [(1, 5, 1000, 777, 64), (2, 3, 130, 4096, 128),
                                   (2, 2, 300, 257, 64)])
def test_k1_tile_edges_on_transposed_views(cuda, shape, biased):
    """bf16 K1 at its 128-row and 128-key tiles' ragged edges (a last key
    tile of one key at Lk = 257), with q, k and v as the U-Net passes them:
    (B, L, H, D) memory viewed as (B, H, L, D).  With a bias, the last batch's
    keys all carry -10000."""
    b, h, lq, lk, d = shape
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(b, n, h, d, generator=g, device=cuda).bfloat16().transpose(1, 2)
               for n in (lq, lk, lk))
    bias = None
    if biased:
        bias = (torch.rand(b, lk, generator=g, device=cuda) < 0.5).float() * -10000.0
        bias[-1] = -10000.0
    _close_attn(flash_attention(q, k, v, scale=d ** -0.5, bias=bias),
                attention_plain(q, k, v, scale=d ** -0.5, bias=bias))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 20, 256, 77, 64), (1, 5, 16384, 77, 64),
                                   (2, 20, 256, 77, 64)])
def test_k1_text_cross_attention(cuda, dtype, shape):
    """K1 at the U-Net's cross-attention onto the 77 text tokens (text
    gating): Lk = 77 is less than one 128-key tile, unbiased, with q, k and
    v as the U-Net passes them ((B, L, H, D) memory viewed as (B, H, L, D))."""
    b, h, lq, lk, d = shape
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(b, n, h, d, generator=g, device=cuda).to(dtype).transpose(1, 2)
               for n in (lq, lk, lk))
    _close_attn(flash_attention(q, k, v, scale=d ** -0.5),
                attention_plain(q, k, v, scale=d ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1, 1024, 1024, 512), (1, 1, 300, 170, 512)])
def test_k2_matches_plain(cuda, dtype, shape):
    b, h, lq, lk, d = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(b, h, n, d, generator=g, device=cuda).to(dtype) for n in (lq, lk, lk))
    _close_attn(flash_attention(q, k, v, scale=d ** -0.5), attention_plain(q, k, v, scale=d ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("shape", [(1, 1, 130, 170, 512), (2, 1, 64, 65, 512),
                                   (2, 2, 200, 1000, 512), (1, 1, 1, 31, 512)])
def test_k2_tile_edges_on_transposed_views(cuda, shape, biased):
    """bf16 K2 at its 64-row and 64-key tiles' ragged edges and at the 32-key
    halves its two warpgroups score: Lk = 170 leaves the second half of the
    last tile 10 keys, Lk = 65 one key in the first half and none in the
    second, Lk = 31 less than one half; q, k and v as (B, L, H, D) memory
    viewed as (B, H, L, D).  With a bias, the last batch's keys all carry
    -10000."""
    b, h, lq, lk, d = shape
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(b, n, h, d, generator=g, device=cuda).bfloat16().transpose(1, 2)
               for n in (lq, lk, lk))
    bias = None
    if biased:
        bias = (torch.rand(b, lk, generator=g, device=cuda) < 0.5).float() * -10000.0
        bias[-1] = -10000.0
    _close_attn(flash_attention(q, k, v, scale=d ** -0.5, bias=bias),
                attention_plain(q, k, v, scale=d ** -0.5, bias=bias))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,gn,res", [((2, 64, 64, 128, 128), True, False),
                                          ((1, 50, 37, 128, 320), True, True),
                                          ((2, 32, 32, 256, 256), False, True)])
def test_k3_matches_plain(cuda, dtype, shape, gn, res):
    b, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    cl = torch.channels_last
    x = torch.randn(b, cin, h, w, generator=g, device=cuda).to(dtype).contiguous(memory_format=cl)
    wt = (torch.randn(cout, cin, 3, 3, generator=g, device=cuda) / (9 * cin) ** 0.5).to(dtype)
    bias = torch.randn(cout, generator=g, device=cuda) * 0.1
    affine = (torch.rand(b, cin, generator=g, device=cuda) + 0.5,
              torch.rand(b, cin, generator=g, device=cuda) + 0.5) if gn else None
    r = torch.randn(b, cout, h, w, generator=g, device=cuda).to(dtype).contiguous(
        memory_format=cl) if res else None
    tol = (3e-5, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    _close(conv3x3(x, wt, bias, affine=affine, residual=r),
           conv3x3_plain(x, wt, bias, affine=affine, residual=r), *tol)


@pytest.mark.cuda
@pytest.mark.parametrize("gn,res", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("shape", [(1, 100, 75, 128, 128), (1, 50, 37, 64, 320),
                                   (2, 9, 130, 128, 100)])
def test_k3_bf16_tile_edges(cuda, shape, gn, res):
    """bf16 K3 at its 4 x 64-pixel, 128-channel tile's edges: W not a
    multiple of 64, Cout not a multiple of 128 (and 100, not of 8), Cin at
    the 64-channel chunk, every fusion."""
    b, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(6)
    cl = torch.channels_last
    x = torch.randn(b, cin, h, w, generator=g, device=cuda).bfloat16().contiguous(memory_format=cl)
    wt = (torch.randn(cout, cin, 3, 3, generator=g, device=cuda) / (9 * cin) ** 0.5).bfloat16()
    bias = torch.randn(cout, generator=g, device=cuda) * 0.1
    affine = (torch.rand(b, cin, generator=g, device=cuda) + 0.5,
              torch.rand(b, cin, generator=g, device=cuda) - 0.5) if gn else None
    r = torch.randn(b, cout, h, w, generator=g, device=cuda).bfloat16().contiguous(
        memory_format=cl) if res else None
    _close(conv3x3(x, wt, bias, affine=affine, residual=r),
           conv3x3_plain(x, wt, bias, affine=affine, residual=r), 2e-2, 2e-2)


# K4: every int8 conv class of the vae_int8 path, at small spatial sizes
K4_CASES = {
    # (b, h, w, cin, cout), stride, padding
    "s1_128": ((2, 32, 48, 128, 128), 1, 1),
    "s1_ragged_256_to_320": ((1, 50, 37, 256, 320), 1, 1),
    "s2_downsampler": ((2, 64, 64, 128, 128), 2, ((0, 1), (0, 1))),
    "s2_ragged": ((1, 33, 27, 256, 256), 2, ((0, 1), (0, 1))),
    "cin3_conv_in": ((2, 40, 40, 3, 128), 1, 1),
    "cin4_conv_in": ((1, 24, 24, 4, 512), 1, 1),
    "cout3_conv_out": ((1, 40, 40, 128, 3), 1, 1),
    "cout8_conv_out": ((2, 16, 16, 512, 8), 1, 1),
    # the wgmma kernels' tile edges: W and H off the 4 x 64-pixel tile, Cout
    # off the 128-channel tile and off 8, Cin off the 128-channel chunk
    "s1_ragged_w130_cout100": ((2, 9, 130, 128, 100), 1, 1),
    "s1_cin64": ((1, 20, 70, 64, 128), 1, 1),
    "s1_cin320_three_chunks": ((1, 13, 66, 320, 136), 1, 1),
    "s1_many_tiles_two_cout_tiles": ((2, 96, 200, 128, 256), 1, 1),
    "s1_uneven_padding": ((1, 21, 67, 128, 64), 1, ((0, 2), (2, 0))),
    "cout8_ragged_w": ((1, 5, 200, 128, 8), 1, 1),
    "cout3_cin256": ((1, 10, 65, 256, 3), 1, 1),
    # taps folded into K: Cin 3 and 4 (one and two k32 steps)
    "cin3_ragged_cout130": ((1, 37, 70, 3, 130), 1, 1),
    "cin4_ragged": ((2, 7, 129, 4, 24), 1, 1),
    "cin3_uneven_padding": ((1, 9, 66, 3, 8), 1, ((2, 0), (0, 2))),
    # what stays on the first design
    "cin7_first_design": ((1, 10, 10, 7, 16), 1, 1),
    "cin20_first_design": ((1, 12, 12, 20, 24), 1, 1),
    "s2_cin3_first_design": ((1, 16, 18, 3, 16), 2, ((0, 1), (0, 1))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_matches_plain(cuda, case, out_dtype):
    (b, h, w, cin, cout), stride, padding = K4_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(3)
    cl = torch.channels_last
    xq = torch.randint(-127, 128, (b, cin, h, w), generator=g, device=cuda,
                       dtype=torch.int8).contiguous(memory_format=cl)
    wq = torch.randint(-127, 128, (cout, cin, 3, 3), generator=g, device=cuda,
                       dtype=torch.int8).contiguous(memory_format=cl)
    scale = torch.rand(cout, generator=g, device=cuda) * 1e-4 + 1e-5
    bias = torch.randn(cout, generator=g, device=cuda) * 0.1
    kw = dict(stride=stride, padding=padding, out_dtype=out_dtype)
    # the int32 sums and the epilogue are exact: fp32 equals the plain
    # version bit for bit, bf16 is its one rounding
    got = conv3x3_int8(xq, wq, scale, bias, **kw)
    ref = conv3x3_int8_plain(xq, wq, scale, bias, **kw)
    assert got.shape == ref.shape
    _close(got, ref, 0.0, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_sum", [True, False])
def test_csplit_on_the_card_matches_direct(cuda, fuse_sum):
    g = torch.Generator(device=cuda).manual_seed(4)
    cl = torch.channels_last
    x = torch.randn(2, 256, 48, 40, generator=g, device=cuda).contiguous(memory_format=cl)
    wt = torch.randn(128, 256, 3, 3, generator=g, device=cuda) / 48.0
    bias = torch.randn(128, generator=g, device=cuda) * 0.1
    affine = (torch.rand(2, 256, generator=g, device=cuda) + 0.5,
              torch.rand(2, 256, generator=g, device=cuda) - 0.5)
    r = torch.randn(2, 128, 48, 40, generator=g, device=cuda).contiguous(memory_format=cl)
    _close(conv3x3_csplit(x, wt, bias, affine=affine, residual=r, fuse_sum=fuse_sum),
           conv3x3_plain(x, wt, bias, affine=affine, residual=r), 5e-5, 1e-4)


# ------------------------------------------ no gradient through a kernel ---
#
# A launch writes a fresh tensor, so each one runs inside
# ops/_build.forward_only, whose backward raises: no kernel has a backward
# (in the JAX package neither), and training runs the plain versions.

def _kernel_calls(device, dtype, launch):
    """name -> (fn, tensors) for K1, K2, K3, K4 and the channel-split
    wrapper, every floating input requiring grad; ``launch`` decides what
    computes: the public wrappers, or the plain versions standing in for
    the launches on the CPU."""
    g = torch.Generator(device=device).manual_seed(6)
    cl = torch.channels_last

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=device) * scale).to(dtype)

    def attn(d):
        q, k, v = (rnd(1, 2 if d == 64 else 1, 128, d) for _ in range(3))
        bias = (torch.rand(1, 128, generator=g, device=device) < 0.5).float() * -10000.0
        return (lambda q, k, v: launch("attention", q, k, v, d ** -0.5, bias)), (q, k, v)

    x = rnd(1, 64, 12, 10).contiguous(memory_format=cl)
    w = rnd(64, 64, 3, 3, scale=1 / 24.0)
    b = torch.randn(64, generator=g, device=device) * 0.1
    xq = torch.randint(-127, 128, (1, 16, 12, 10), generator=g, device=device,
                       dtype=torch.int8).contiguous(memory_format=cl)
    wq = torch.randint(-127, 128, (8, 16, 3, 3), generator=g, device=device,
                       dtype=torch.int8).contiguous(memory_format=cl)
    scale = torch.rand(8, generator=g, device=device) * 1e-3 + 1e-4
    # the split halves Cin: 64 per half, the bf16 kernel's channel chunk
    x2 = rnd(1, 128, 12, 10).contiguous(memory_format=cl)
    w2 = rnd(64, 128, 3, 3, scale=1 / 34.0)
    calls = {
        "flash_attention_k1": attn(64),
        "flash_attention_k2": attn(512),
        "conv3x3": ((lambda x, w, b: launch("conv3x3", x, w, b)), (x, w, b)),
        "conv3x3_int8": ((lambda s: launch("conv3x3_int8", xq, wq, s)), (scale,)),
        "conv3x3 (channel split)": ((lambda x, w, b: launch("csplit", x, w, b)), (x2, w2, b)),
    }
    for _, tensors in calls.values():
        for t in tensors:
            t.requires_grad_()
    return calls


def _wrappers(op, *args):
    if op == "attention":
        q, k, v, scale, bias = args
        return flash_attention(q, k, v, scale=scale, bias=bias)
    if op == "conv3x3":
        return conv3x3(*args)
    if op == "csplit":
        return conv3x3_csplit(*args)
    xq, wq, s = args
    return conv3x3_int8(xq, wq, s, out_dtype=torch.float32)


def _plain(op, *args):
    if op == "attention":
        q, k, v, scale, bias = args
        return attention_plain(q, k, v, scale=scale, bias=bias)
    if op in ("conv3x3", "csplit"):
        return conv3x3_plain(*args)
    xq, wq, s = args
    return conv3x3_int8_plain(xq, wq, s, out_dtype=torch.float32)


KERNEL_CALLS = ["flash_attention_k1", "flash_attention_k2", "conv3x3", "conv3x3_int8",
                "conv3x3 (channel split)"]


@pytest.mark.parametrize("name", KERNEL_CALLS)
def test_forward_only_is_the_launch_and_refuses_a_backward(name):
    """The autograd node each launch runs in, driven on the CPU with the
    plain version standing in for the launch: the forward is the launch's
    result, and a backward through it raises and names the kernel."""
    from sdmatte_tpu_torch.ops._build import forward_only
    fn, tensors = _kernel_calls("cpu", torch.float32, _plain)[name]
    kernel = name.split(" ")[0]
    got = forward_only(kernel, fn, *tensors)
    torch.testing.assert_close(got, fn(*tensors), rtol=0, atol=0)
    assert got.requires_grad
    with pytest.raises(RuntimeError,
                       match=rf"{kernel} has no backward kernel.*implementation\(\"plain\"\)"):
        got.float().square().sum().backward()
    with torch.no_grad():
        assert forward_only(kernel, fn, *tensors).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNEL_CALLS)
def test_backward_through_a_kernel_raises_on_the_card(cuda, name):
    fn, tensors = _kernel_calls(cuda, torch.bfloat16, _wrappers)[name]
    out = fn(*tensors)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match=f"{name.split(' ')[0]} has no backward kernel"):
        out.float().sum().backward()


@pytest.mark.cuda
def test_data_parallel_and_video_at_world_size_1_on_nccl(cuda, tmp_path):
    """In-process NCCL at world size 1: the data-parallel step equals the
    plain step, and matte_video through a mesh of 1 equals the call without
    one (the tiny config runs the plain versions: its heads are 8 wide)."""
    import copy
    import socket
    import torch.distributed as dist
    from sdmatte_tpu_torch.configs import SDMatteConfig
    from sdmatte_tpu_torch.models.init import init_random_
    from sdmatte_tpu_torch.models.sdmatte import SDMatte
    from sdmatte_tpu_torch.parallel import mesh, train
    from sdmatte_tpu_torch.parallel.data import CompositeSampler, to_tensors
    from sdmatte_tpu_torch.parallel.video import matte_video
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert mesh.distributed_init(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        m = mesh.make_mesh()
        model = init_random_(SDMatte(SDMatteConfig.tiny()), seed=0).to(cuda)
        twin = copy.deepcopy(model)
        batch = {k: v.to(cuda) for k, v in to_tensors(CompositeSampler(size=64).batch(2)).items()}
        states = [train.init_train_state(x, 1e-3) for x in (model, twin)]
        loss_dp = train.make_sharded_train_step(m)(states[0], batch)
        loss = train.train_step(states[1], batch)
        torch.testing.assert_close(loss_dp, loss, rtol=1e-6, atol=0)
        for (n, a), b in zip(model.named_parameters(), twin.parameters()):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=n)
        frames = batch["image"]
        with implementation("plain"):
            got = matte_video(model, frames, batch["trimap"], mesh=m)
            ref = matte_video(model, frames, batch["trimap"])
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    finally:
        dist.destroy_process_group()
