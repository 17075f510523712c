"""ViTMatte as the benchmark's second architecture, at the tests' tiny size:
its cell runs through ``harness.run`` to a correct line, traced and not; its
control (the reference with float8 e4m3 products in the program's place)
reads far above the bf16 program; its reference imports ``torch`` alone and
names the program's parameters; its two readers read nothing from empty
readings and the right share from made-up ones."""

from __future__ import annotations

import copy
import importlib
import json
from pathlib import Path

import pytest
import torch

from matbench import architecture, calibrate, compare, harness, program, trace
from test_matbench_imports import top_level_imports
from matbench.traffic import generate

ROOT = Path(__file__).resolve().parents[2]
CELL = "vitmatte-b-bf16.camera-12mp"
DEV = torch.device("cpu")


def tiny_conf(compute="float32") -> dict:
    """The cell's configuration at ``ViTMatteConfig.tiny()``'s sizes, in
    ``compute`` (fp32 by default)."""
    from sdmatte_tpu_torch.configs import ViTMatteConfig
    conf = json.load(open(ROOT / "matbench" / "configs" / "vitmatte-b-bf16.json"))
    conf = copy.deepcopy(conf)
    tiny = ViTMatteConfig.tiny().to_dict()
    conf["backbone_config"].update(tiny["backbone_config"])
    for key in ("hidden_size", "convstream_hidden_sizes", "fusion_hidden_sizes"):
        conf[key] = tiny[key]
    conf["precision"] = {"params": compute, "compute": compute, "accumulate": "float32"}
    return conf


def small_mix() -> dict:
    mix = copy.deepcopy(generate.load_mix("camera-12mp"))
    mix.update(pool=4, sizes=[[75, 100], [100, 75]])
    return mix


def test_the_cell_names_the_vitmatte_modules():
    conf, mix = harness.cell_files(CELL)
    assert conf["architecture"] == "vitmatte" and conf["reduced"] == []
    assert architecture.program_of(conf).__name__ == "matbench.programs.vitmatte"
    assert architecture.reference_of(conf).__name__ == "matbench.reference.vitmatte_ref"
    assert mix["entry"] == "pipeline" and mix["sizes"] == [[3024, 4032], [4032, 3024]]


@pytest.mark.parametrize("trace_on", [0, 1])
def test_vitmatte_runs_to_a_correct_line(trace_on):
    res = harness.run(CELL, 2 ** 31 + 17, 1.0, bool(trace_on), device=DEV, t0=0.0,
                      conf=tiny_conf(), mix=small_mix())
    line = json.loads(harness.result_line(res))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 4
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    if not trace_on:
        assert set(line["metrics"]) == {"mattes_per_s", "setup_s"}
    else:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["checks"]) == 4


def test_control_reads_far_above_the_bf16_program_at_tiny_size():
    """``calibrate.readings`` on the cell at the tiny size in bf16: on every
    seed the program stays under the cell's limit and the control reads over
    three times the program's worst.  oneDNN is turned off: its bf16 kernel
    for the 16 x 16, stride-16 patch conv is off by about the values' own
    size on x86 CPUs with torch 2.13 (the bf16 unit then reads as large as
    the control), which cuDNN on the card is not."""
    limit = compare.limits(CELL)["gap_ratio"]
    with torch.backends.mkldnn.flags(enabled=False):
        rows = list(calibrate.readings(CELL, [1, 2], {1, 2}, 1.0, device=DEV,
                                       conf=tiny_conf("bfloat16"), mix=small_mix()))
    for r in rows:
        assert max(r["program"].values()) <= limit, r
        assert max(r["control"].values()) > 3.0 * max(r["program"].values()), r
    s = calibrate.summary(rows)
    assert s["control_seeds"] == 2 and s["upper"] > 3.0 * s["lower"]


def test_the_control_is_the_reference_in_float8():
    conf, _ = harness.cell_files(CELL)
    arch = architecture.program_of(conf)
    assert arch.CONTROL == {"reference_in": "float8_e4m3fn"}
    with program._skeleton():
        model = arch.declare(tiny_conf())
    assert isinstance(arch.pipeline(model.to_empty(device=DEV), tiny_conf(), DEV, **arch.CONTROL),
                      arch.Float8Reference)


def test_e4m3_rounds_to_float8_under_a_power_of_two_scale():
    e4m3 = architecture.program_of(harness.cell_files(CELL)[0]).e4m3
    t = torch.tensor([1.0, 1.1, 1.3, 300.0, -0.001, 0.0])
    # amax 300 -> scale 1: e4m3's 3 mantissa bits, 2^-9 its smallest step
    assert e4m3(t).tolist() == [1.0, 1.125, 1.25, 288.0, -0.001953125, 0.0]
    assert torch.equal(e4m3(t * 2.0 ** 20), e4m3(t) * 2.0 ** 20)
    assert torch.equal(e4m3(torch.zeros(3)), torch.zeros(3))
    assert e4m3(t.bfloat16()).dtype == torch.bfloat16


def test_float8_products_round_each_product_and_nothing_else():
    arch = architecture.program_of(harness.cell_files(CELL)[0])
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(5, 8, generator=g), torch.randn(3, 8, generator=g)
    with arch.Float8Products():
        lin = torch.nn.functional.linear(x, w)
        mm = x @ w.T
        ein = torch.einsum("ij,kj->ik", x, w)
        soft = x.softmax(-1)
    want = arch.e4m3(arch.e4m3(x) @ arch.e4m3(w).T)
    for got in (lin, mm, ein):
        torch.testing.assert_close(got, want, atol=0, rtol=1e-6)
    assert torch.equal(soft, x.softmax(-1))
    assert float((lin - x @ w.T).abs().max()) > 1e-2


def test_the_program_holds_the_references_parameters_at_the_published_config():
    """The seeded weights load strictly: the reference's table is the
    program's state dict, names and shapes, at ViTMatte-B's sizes."""
    conf, _ = harness.cell_files(CELL)
    ref = architecture.reference_of(conf)
    with program._skeleton():
        model = architecture.program_of(conf).declare(conf)
    table = {n: s for n, s, _ in ref.param_table(conf)}
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == table
    assert architecture.program_of(conf).program_only_shapes(model) == {}


def test_operations_of_a_12mp_matte():
    """The reference's forward on the meta device at the mix's two sizes:
    about 40 TFLOP, 70% of it the attention of the four global blocks."""
    conf, mix = harness.cell_files(CELL)
    flops = harness.model_flops(conf, mix)
    assert 38e12 < flops < 42e12
    tokens = (3040 // 16) * (4032 // 16)
    global_attn = 4 * 4 * 12 * tokens ** 2 * 64
    assert 0.65 < global_attn / flops < 0.75


def test_reference_imports_torch_alone():
    path = ROOT / "matbench" / "reference" / "vitmatte_ref.py"
    assert top_level_imports(path) <= {"__future__", "math", "torch"}
    assert "from ." not in path.read_text()


def _reader(name):
    return harness.load_reader(name)


@pytest.mark.parametrize("name", ["step_mfu.vitmatte", "k1_attn_relpos_roofline"])
def test_readers_find_nothing_in_empty_readings(name):
    assert _reader(name).read(trace.Readings()) is None


def test_relpos_roofline_reads_its_launches_alone():
    """Two rel-pos launches (a global grid and a windowed block) and a per-key
    launch beside them, against made-up device times."""
    counting = importlib.import_module("matbench.counting")
    work = importlib.import_module("matbench.metrics._relpos")

    def launch(b, h, lq, lk, kh=None, kw=None):
        rel = (None, None, 0, 0) if kh is None else (7, 8, kh, kw)
        return (1, 64, 1, 2, 3, None, 4, None, None, None, None, 0, b, h, lq, lk, 0.125) + rel

    calls = [launch(1, 12, 47880, 47880, 190, 252), launch(252, 12, 196, 196, 14, 14),
             launch(1, 5, 4096, 4096)]
    t = trace.Readings(launches={"flash_attention_k1": calls},
                       kernels=[("flash_fwd_relpos_sm90<64, 2>", 0.010),
                                ("flash_fwd_relpos_sm90<64, 2>", 0.0005),
                                ("flash_fwd_sm90<64, 3, false>", 0.002)])
    least = (counting.bound_s(*work.relpos_attention_work(1, 12, 47880, 47880, 64, 190, 252))
             + counting.bound_s(*work.relpos_attention_work(252, 12, 196, 196, 64, 14, 14)))
    got = _reader("k1_attn_relpos_roofline").read(t)
    assert got == pytest.approx(100 * least / 0.0105)
    assert 0 < got < 100
    flops, nbytes = work.relpos_attention_work(1, 12, 47880, 47880, 64, 190, 252)
    assert flops == 4 * 12 * 47880 ** 2 * 64
    assert nbytes == 2 * 12 * 4 * 47880 * 64 + 4 * 12 * 47880 * 442


def test_step_mfu_vitmatte_reads_the_share_of_the_peak():
    t = trace.Readings(flops_per_matte=40e12, s_per_matte=0.2)
    got = _reader("step_mfu.vitmatte").read(t)
    assert got == pytest.approx(100 * 40e12 / 989e12 / 0.2)
