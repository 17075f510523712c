"""The port's int8 weights and int8 VAE convs (sdmatte_tpu_torch/ops/quant.py)
against the JAX package's (sdmatte_tpu/ops/quant.py), on the CPU.

The same numpy inputs go to both.  The quantizers are held bit-exact; the int8
conv at tests/test_conv3x3.py's int8 bar (atol 1e-3, rtol 1e-6); the layers
with int8 storage at 1e-5 in fp32; the whole tiny model at alpha MAE <= 1e-4
(tests/test_assembled_parity.py's bar) with the same layers quantized on both
sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from sdmatte_tpu.configs import SDMatteConfig as JaxSDMatteConfig
from sdmatte_tpu.core import nn as JF
from sdmatte_tpu.core.dtypes import FP32 as JFP32
from sdmatte_tpu.ops import quant as jq
from sdmatte_tpu.pipeline import MattingPipeline as JaxPipeline
from sdmatte_tpu.pipeline import PipelineOptions as JaxOptions

from sdmatte_tpu_torch.checkpoint.convert import load_params
from sdmatte_tpu_torch.configs import SDMatteConfig
from sdmatte_tpu_torch.core import nn as F
from sdmatte_tpu_torch.core.dtypes import BF16, FP32
from sdmatte_tpu_torch.models.sdmatte import SDMatte
from sdmatte_tpu_torch.ops import quant
from sdmatte_tpu_torch.pipeline import MattingPipeline, PipelineOptions

from test_torch_pipeline import _randomized_params

TINY_MIN_ELEMS = 1024   # lowered on both sides, so the tiny model compresses


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _weight_with_edges(rng, shape_out_last):
    """Random fp32 weight (output channels last) with one all-zero output
    channel and one channel of exact .5 ties: its amax is 127, so its scale
    is 1.0 and w / scale lands on k + 0.5."""
    w = (rng.standard_normal(shape_out_last) * 0.2).astype(np.float32)
    w[..., 0] = 0.0
    ties = rng.integers(-60, 60, w[..., 1].shape) + 0.5
    ties.flat[0] = 127.0
    w[..., 1] = ties.astype(np.float32)
    return w


# --------------------------------------------------------------- quantizers ---

@pytest.mark.parametrize("fn,layout", [("quantize_weights_int8", "conv"),
                                       ("compress_kernel_int8", "conv"),
                                       ("compress_kernel_int8", "linear")])
def test_weight_quantizers_bit_exact(rng, fn, layout):
    w = _weight_with_edges(rng, (3, 3, 16, 8) if layout == "conv" else (48, 8))
    ref_q, ref_s = (np.asarray(a) for a in getattr(jq, fn)(w))
    wt = _t(w).permute(3, 2, 0, 1) if layout == "conv" else _t(w).t()
    got_q, got_s = getattr(quant, fn)(wt.contiguous())
    got_q = got_q.permute(2, 3, 1, 0) if layout == "conv" else got_q.t()
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert np.array_equal(got_q.numpy(), ref_q.astype(np.int8))
    assert np.array_equal(got_s.numpy(), ref_s.astype(np.float32))
    assert got_s[0] == 1.0 and (got_q[..., 0] == 0).all()   # the zero channel


@pytest.mark.parametrize("case", ["random", "ties", "zeros"])
def test_quantize_act_int8_bit_exact(rng, case):
    x = rng.standard_normal((2, 8, 6, 5)).astype(np.float32) * 3.0
    if case == "ties":    # amax 127 -> scale 1.0, every value a .5 tie
        x = (rng.integers(-100, 100, x.shape) + 0.5).astype(np.float32)
        x.flat[0] = 127.0
    if case == "zeros":
        x[:] = 0.0
    ref_q, ref_s = jq.quantize_act_int8(jnp.asarray(x.transpose(0, 2, 3, 1)))
    got_q, got_s = quant.quantize_act_int8(_t(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32 and got_s.ndim == 0
    assert np.array_equal(got_q.permute(0, 2, 3, 1).numpy(), np.asarray(ref_q))
    assert np.array_equal(got_s.numpy(), np.asarray(ref_s, np.float32))


CONV_INT8_CASES = {
    # (b, h, w, cin, cout), stride, padding
    "stride1": ((2, 13, 11, 8, 16), 1, 1),
    "stride2_downsampler": ((2, 14, 12, 8, 8), 2, ((0, 1), (0, 1))),
    "cin3_conv_in": ((2, 12, 10, 3, 8), 1, 1),
    "cout3_conv_out": ((1, 12, 10, 8, 3), 1, 1),
}


@pytest.mark.parametrize("case", list(CONV_INT8_CASES))
def test_conv2d_int8_matches_jax(rng, case):
    (b, h, w, cin, cout), stride, padding = CONV_INT8_CASES[case]
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wk = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    jwq, jws = jq.quantize_weights_int8(jnp.asarray(wk))
    ref = jq.conv2d_int8(jnp.asarray(x), jwq, jws, jnp.asarray(bias), stride=stride,
                         padding=padding, out_dtype=jnp.float32)
    wq, ws = quant.quantize_weights_int8(_t(wk).permute(3, 2, 0, 1))
    got = quant.conv2d_int8(_t(x).permute(0, 3, 1, 2), wq, ws, _t(bias), stride=stride,
                            padding=padding, out_dtype=torch.float32)
    assert got.shape == (b, cout) + tuple(np.asarray(ref).shape[1:3])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=1e-3, rtol=1e-6)


# ------------------------------------------------------------ int8 storage ---

def _conv(rng, cin, cout):
    m = nn.Conv2d(cin, cout, 3, padding=1)
    wk = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    with torch.no_grad():
        m.weight.copy_(_t(wk).permute(3, 2, 0, 1))
        m.bias.copy_(_t(b))
    return m, {"kernel": wk, "bias": b}


@pytest.mark.parametrize("layer", ["kernel_of", "linear", "conv2d", "gn_silu_conv2d"])
@torch.no_grad()
def test_storage_layers_match_jax(rng, layer):
    min_elems = 64
    if layer in ("kernel_of", "linear"):
        wk = (rng.standard_normal((70, 24)) * 0.05).astype(np.float32)
        b = (rng.standard_normal(24) * 0.1).astype(np.float32)
        m = nn.Linear(70, 24)
        with torch.no_grad():
            m.weight.copy_(_t(wk).t())
            m.bias.copy_(_t(b))
        jp = jq.compress_tree_int8({"kernel": wk, "bias": b}, min_elems=min_elems)
        mq = quant.compress_tree_int8(m, min_elems=min_elems)
        assert "weight" not in mq._parameters and mq.weight_i8.dtype == torch.int8
        if layer == "kernel_of":
            ref = np.asarray(JF.kernel_of(jp, jnp.float32)).T
            got = F.kernel_of(mq, torch.float32).numpy()
        else:
            x = rng.standard_normal((3, 70)).astype(np.float32)
            ref = np.asarray(JF.linear(jp, jnp.asarray(x), JFP32))
            got = F.linear(mq, _t(x), FP32).detach().numpy()
    else:
        m, jp = _conv(rng, 16, 16)
        jp = jq.compress_tree_int8(jp, min_elems=min_elems)
        mq = quant.compress_tree_int8(m, min_elems=min_elems)
        x = rng.standard_normal((1, 9, 11, 16)).astype(np.float32)
        if layer == "conv2d":
            ref = np.asarray(JF.conv2d(jp, jnp.asarray(x), policy=JFP32))
            got = F.conv2d(mq, _t(x).permute(0, 3, 1, 2), policy=FP32)
        else:
            scale = rng.uniform(0.5, 2.0, 16).astype(np.float32)
            shift = rng.standard_normal(16).astype(np.float32)
            norm = nn.GroupNorm(4, 16)
            with torch.no_grad():
                norm.weight.copy_(_t(scale))
                norm.bias.copy_(_t(shift))
            res = rng.standard_normal((1, 9, 11, 16)).astype(np.float32)
            ref = np.asarray(JF.gn_silu_conv2d({"scale": scale, "bias": shift}, jp,
                                               jnp.asarray(x), groups=4, policy=JFP32,
                                               residual=jnp.asarray(res)))
            got = F.gn_silu_conv2d(norm, mq, _t(x).permute(0, 3, 1, 2), policy=FP32,
                                   residual=_t(res).permute(0, 3, 1, 2))
        got = got.detach().permute(0, 2, 3, 1).numpy()
    assert "weight" in m._parameters   # the source layer keeps its fp weight
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_compress_tree_int8_scope():
    """Big weights compress; small ones, norms and layers with the int8
    compute fields stay as they are; the source is not changed."""
    model = nn.ModuleDict({
        "big": nn.Linear(512, 256), "small": nn.Conv2d(4, 8, 3),
        "norm": nn.GroupNorm(2, 8), "qcompute": nn.Conv2d(128, 256, 3),
    })
    quant.quantize_conv_params_(model["qcompute"])
    out = quant.compress_tree_int8(model)
    assert "weight" not in out["big"]._parameters
    assert out["big"].weight_i8.shape == (256, 512) and out["big"].weight_s.shape == (256,)
    assert out["big"].bias is not None
    assert "weight_i8" not in out["small"]._buffers and "weight" in out["small"]._parameters
    assert "weight_i8" not in out["norm"]._buffers
    assert "weight" in out["qcompute"]._parameters and "weight_i8" not in out["qcompute"]._buffers
    assert "weight" in model["big"]._parameters and not list(model["big"].buffers())


def test_quantize_vae_tree_scope():
    """Only 3x3 convs gain int8 fields, in channels_last; 1x1 convs and norms
    stay fp; the source VAE is not changed."""
    vae = SDMatte(SDMatteConfig.tiny()).vae
    q = quant.quantize_vae_tree(vae)
    assert q.encoder.conv_in.weight_q.is_contiguous(memory_format=torch.channels_last)
    assert q.encoder.conv_in.weight_scale.dtype == torch.float32
    assert "weight_q" not in q.quant_conv._buffers and "weight_q" not in q.post_quant_conv._buffers
    n3 = sum(isinstance(m, nn.Conv2d) and m.kernel_size == (3, 3) for m in vae.modules())
    assert sum(quant.is_int8_conv(m) for m in q.modules()) == n3 > 0
    assert not list(vae.buffers())


# ------------------------------------------------------------- whole model ---

MODES = {"vae_int8": dict(vae_int8=True),
         "storage": dict(weight_storage="int8"),
         "both": dict(vae_int8=True, weight_storage="int8")}


@pytest.fixture(scope="module")
def tiny_setup():
    params = _randomized_params(JaxSDMatteConfig.tiny())
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (1, 75, 61, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:75, 0:61]
    r = np.hypot(yy - 37, xx - 30)
    tri = np.where(r < 15, 1.0, np.where(r < 25, 0.5, 0.0)).astype(np.float32)
    return params, img, tri


def _lower_min_elems(monkeypatch):
    import functools
    monkeypatch.setattr(jq, "compress_tree_int8",
                        functools.partial(jq.compress_tree_int8, min_elems=TINY_MIN_ELEMS))
    monkeypatch.setattr(quant, "STORAGE_MIN_ELEMS", TINY_MIN_ELEMS)


def _alpha_with_shared_activations(monkeypatch, jax_pipe, pipe, img, tri):
    """Both pipelines' alpha before mask_refine, with the port's int8 convs
    fed the JAX package's quantized activations and scales, in call order.

    Dynamic per-tensor requantization before each int8 conv turns an fp32
    rounding difference upstream into a flip of one quantization step in a
    few elements, which the next convs spread: after a few convs the two
    packages differ by about the int8 noise itself (alpha MAE ~1e-2 on this
    model, though every int8 conv is exact on equal inputs).  So the int8
    decisions are shared, and the port is held segment by segment: each
    int8 conv's fp32 input to the JAX package's at the fp32 block bar
    (tests/test_block_parity.py, 5e-5), and its own quantizer's decisions
    to the shared ones (at most 0.1% of elements one step apart, scales to
    1e-5).  With every activation shared the alpha follows from the last
    conv's.  Returns (jax alpha, port alpha, number of activations shared)."""
    import jax
    shared, seen = [], []
    jax_own, own = jq.quantize_act_int8, quant.quantize_act_int8

    def keep(x, q, s):
        shared.append((np.asarray(x), np.asarray(q), np.asarray(s)))

    def record(x):
        q, s = jax_own(x)
        jax.debug.callback(keep, x, q, s, ordered=True)
        return q, s

    def replay(x):
        q, s = own(x)
        ref_x, ref_q, ref_s = shared.pop(0)
        np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(), ref_x, atol=5e-5, rtol=5e-5)
        ref_q = torch.from_numpy(ref_q.copy()).permute(0, 3, 1, 2)
        ref_s = torch.tensor(ref_s, dtype=torch.float32)
        d = (q.int() - ref_q.int()).abs()
        seen.append((int((d != 0).sum()), d.numel(), int(d.max())))
        assert float((s - ref_s).abs() / ref_s) <= 1e-5
        return ref_q, ref_s

    monkeypatch.setattr(jq, "quantize_act_int8", record)
    monkeypatch.setattr(quant, "quantize_act_int8", replay)
    opts = dict(inference_size=64, mask_refine=False)
    ref, _ = jax_pipe(img, tri, options=JaxOptions(**opts))
    n = len(shared)
    alpha, _ = pipe(img, tri, options=PipelineOptions(**opts))
    assert not shared and len(seen) == n
    if n:
        assert max(f[2] for f in seen) <= 1
        assert sum(f[0] for f in seen) <= 1e-3 * sum(f[1] for f in seen)
    return np.asarray(ref), alpha.numpy(), n


@pytest.mark.parametrize("mode", list(MODES))
def test_int8_modes_match_jax(tiny_setup, monkeypatch, mode):
    params, img, tri = tiny_setup
    _lower_min_elems(monkeypatch)
    kw = MODES[mode]
    jax_pipe = JaxPipeline(params, JaxSDMatteConfig.tiny(), attn_impl="xla", **kw)
    pipe = MattingPipeline(load_params(SDMatte(SDMatteConfig.tiny()), params), device="cpu", **kw)
    counts = {k: sum(k in m._buffers for m in pipe.model.modules())
              for k in ("weight_q", "weight_i8")}
    assert (counts["weight_q"] > 0) == ("vae_int8" in kw)
    assert (counts["weight_i8"] > 0) == ("weight_storage" in kw)
    ref, alpha, n = _alpha_with_shared_activations(monkeypatch, jax_pipe, pipe, img, tri)
    assert n == (counts["weight_q"] if "vae_int8" in kw else 0)
    assert float(np.abs(alpha - ref).mean()) <= 1e-4


def test_vae_int8_composes_with_int8_storage(tiny_setup):
    """The port's twin of tests/test_review_fixes.py: compute quantization
    runs first, so every eligible conv keeps its int8 compute fields under
    int8 storage, and the combined pipeline still mattes."""
    params, img, tri = tiny_setup
    model = load_params(SDMatte(SDMatteConfig.tiny()), params)
    both = MattingPipeline(model, device="cpu", weight_storage="int8", vae_int8=True)
    alone = MattingPipeline(model, device="cpu", vae_int8=True)

    def count(pipe):
        return sum(quant.is_int8_conv(m) for m in pipe.model.vae.modules())

    assert count(both) == count(alone) > 0
    alpha, _ = both(img, tri, options=PipelineOptions(inference_size=64))
    assert alpha.shape == (1, 75, 61)


def test_pipeline_quantizes_a_copy_and_keeps_fp32_scales(tiny_setup):
    """The caller's model keeps its fp weights; under the bf16 policy the
    parameters are bf16, the int8 fields int8 and the scales fp32."""
    params, img, tri = tiny_setup
    model = load_params(SDMatte(SDMatteConfig.tiny()), params)
    pipe = MattingPipeline(model, device="cpu", policy=BF16, vae_int8=True,
                           weight_storage="int8")
    assert not list(model.buffers()) and next(model.parameters()).dtype == torch.float32
    conv = pipe.model.vae.encoder.conv_in
    assert conv.weight.dtype == torch.bfloat16 and conv.weight_q.dtype == torch.int8
    assert conv.weight_scale.dtype == torch.float32
    stored = [m for m in pipe.model.modules() if "weight_i8" in m._buffers]
    assert stored and all(m.weight_s.dtype == torch.float32 for m in stored)
    alpha, _ = pipe(img, tri, options=PipelineOptions(inference_size=64))
    assert bool(torch.isfinite(alpha).all())


def test_quantized_jax_tree_carries_across(tiny_setup, monkeypatch):
    """A tree the JAX package has quantized (compute and storage) loads into
    the port with the same int8 values and fp32 scales, is not quantized
    again, and mattes as the JAX pipeline does on it."""
    params, img, tri = tiny_setup
    qparams = dict(params)
    qparams["vae"] = jq.quantize_vae_tree(params["vae"])
    qparams = {k: jq.compress_tree_int8(v, min_elems=TINY_MIN_ELEMS) if k in ("unet", "vae")
               else v for k, v in qparams.items()}
    model = load_params(SDMatte(SDMatteConfig.tiny()), qparams)
    conv = model.vae.encoder.conv_in
    src = qparams["vae"]["encoder"]["conv_in"]
    assert np.array_equal(conv.weight_q.permute(2, 3, 1, 0).numpy(), np.asarray(src["kernel_q"]))
    assert np.array_equal(conv.weight_scale.numpy(), np.asarray(src["kernel_scale"]))
    stored = [(n, m) for n, m in model.named_modules() if "weight_i8" in m._buffers]
    assert stored
    name, m = stored[0]
    node = qparams
    for part in name.split("."):
        node = node[part]
    w = np.asarray(node["kernel_i8"])
    w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
    assert m.weight_i8.dtype == torch.int8 and np.array_equal(m.weight_i8.numpy(), w)
    assert "weight" not in m._parameters

    pipe = MattingPipeline(model, device="cpu", vae_int8=True)
    assert torch.equal(pipe.model.vae.encoder.conv_in.weight_q, conv.weight_q)
    jax_pipe = JaxPipeline(qparams, JaxSDMatteConfig.tiny(), attn_impl="xla")
    ref, alpha, n = _alpha_with_shared_activations(monkeypatch, jax_pipe, pipe, img, tri)
    assert n > 0 and float(np.abs(alpha - ref).mean()) <= 1e-4
