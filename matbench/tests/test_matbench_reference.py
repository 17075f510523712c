"""The frozen reference against the program's plain path at the tiny
configuration (fp32 on the CPU), its parameter table against the program's
model at full width, and its int8 storage against the program's."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT, small_mix, tiny_conf
from matbench import architecture, harness, program, weights
from matbench.reference import sdmatte_ref as ref

DEV = torch.device("cpu")


def _inputs(seed, b=1, h=72, w=100):
    g = torch.Generator().manual_seed(seed)
    img = torch.rand(b, h, w, 3, generator=g)
    tri = (torch.rand(b, h, w, generator=g) * 2).round() / 2
    return img, tri


@pytest.mark.parametrize("name", ["sdmatte-bf16", "sdmatte-bf16-w8"])
def test_param_table_is_the_programs_at_full_width(name):
    conf = json.load(open(ROOT / "matbench" / "configs" / f"{name}.json"))
    arch = architecture.program_of(conf)
    with torch.device("meta"):
        model = arch.declare(conf)
    extra = arch.program_only_shapes(model)
    assert extra and all(n.startswith("text_encoder.") for n in extra)
    port = {n: tuple(p.shape) for n, p in model.named_parameters() if n not in extra}
    mine = {n: s for n, s, _ in ref.param_table(conf)}
    assert port == mine
    assert sum(torch.Size(s).numel() for s in mine.values()) == 956_684_715


@pytest.mark.parametrize("output_mode", ["alpha_only", "matted_rgba", "matted_rgb",
                                         "alpha_blend"])
def test_reference_matches_the_plain_path(output_mode):
    from sdmatte_tpu_torch.pipeline import PipelineOptions
    conf = tiny_conf()
    pipe = program.build_pipeline(conf, 5, DEV)
    img, tri = _inputs(1, b=2)
    a, m = pipe(img, tri, options=PipelineOptions(inference_size=64, output_mode=output_mode))
    params = weights.make_params(conf, 5, DEV, torch.float32)
    ra, rm = ref.matte(params, conf, img, tri, size=64, output_mode=output_mode)
    assert ((a > 0) & (a < 1)).float().mean() > 0.2      # not saturated
    assert (a - ra).abs().max() < 1e-4
    assert (m - rm).abs().max() < 1e-4


def test_reference_matches_without_refinement_and_transparent():
    from sdmatte_tpu_torch.pipeline import PipelineOptions
    conf = tiny_conf()
    pipe = program.build_pipeline(conf, 6, DEV)
    img, tri = _inputs(2, h=130, w=40)
    opts = PipelineOptions(inference_size=128, mask_refine=False, is_transparent=True)
    a, _ = pipe(img, tri, options=opts)
    params = weights.make_params(conf, 6, DEV, torch.float32)
    ra, _ = ref.matte(params, conf, img, tri, size=128, refine=False, is_transparent=True)
    assert (a - ra).abs().max() < 1e-4


def test_int8_storage_matches_the_programs():
    from sdmatte_tpu_torch.pipeline import PipelineOptions
    conf = tiny_conf("sdmatte-bf16-w8")
    # at the tiny widths no weight reaches 65,536 elements: lower the rule's
    # size for both sides to exercise the quantization
    import sdmatte_tpu_torch.ops.quant as quant
    old_port, old_ref = quant.STORAGE_MIN_ELEMS, ref.INT8_MIN_ELEMS
    quant.STORAGE_MIN_ELEMS = ref.INT8_MIN_ELEMS = 1024
    try:
        pipe = program.build_pipeline(conf, 7, DEV)
        assert any("weight_i8" in mod._buffers for mod in pipe.model.modules())
        img, tri = _inputs(3)
        a, _ = pipe(img, tri, options=PipelineOptions(inference_size=64))
        params = ref.int8_storage(weights.make_params(conf, 7, DEV, torch.float32))
        ra, _ = ref.matte(params, conf, img, tri, size=64)
        fp, _ = ref.matte(weights.make_params(conf, 7, DEV, torch.float32), conf, img, tri,
                          size=64)
    finally:
        quant.STORAGE_MIN_ELEMS, ref.INT8_MIN_ELEMS = old_port, old_ref
    assert (a - ra).abs().max() < 1e-4
    assert (a - fp).abs().max() > 1e-3           # the quantization is seen


def test_weights_are_the_seeds_and_served_in_bf16():
    conf = tiny_conf()
    a = weights.make_params(conf, 9, DEV)
    b = weights.make_params(conf, 9, DEV)
    c = weights.make_params(conf, 10, DEV)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert {v.dtype for v in a.values()} == {torch.bfloat16}
    norm = [k for k, _, kind in ref.param_table(conf) if kind == "nw"]
    assert all(0.69 <= float(a[k].min()) and float(a[k].max()) <= 1.31 for k in norm)
    # the reference's group comes out the same with or without the text tower
    text = {"text_encoder.x.weight": (4, 8), "text_encoder.x.bias": (4,)}
    d = weights.make_params(conf, 9, DEV, extra_shapes=text)
    assert all(torch.equal(a[k], d[k]) for k in a) and set(d) - set(a) == set(text)


def test_model_flops_are_counted_from_shapes():
    conf = tiny_conf()
    mix = small_mix()
    f64 = harness.model_flops(conf, mix)
    mix["options"] = dict(mix["options"], inference_size=128)
    f128 = harness.model_flops(conf, mix)
    assert f64 > 0 and 4.0 < f128 / f64 < 16.0
