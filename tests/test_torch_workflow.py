"""The port's headless workflow runner (sdmatte_tpu_torch/workflow.py)
against the JAX package's (examples/run_workflow.py).

The bundled example workflow, shrunk to inference size 64 as
tests/test_workflow_runner.py shrinks it, runs through both runners: the
JAX node on the JAX package's tiny fp32 pipeline (``sdmatte.init(tiny,
seed=0)``), the port's node on the port's tiny fp32 pipeline with the same
weights carried across by ``checkpoint/convert.load_params``, on the CPU.
The nodes' outputs agree at MAE <= 1e-4 (tests/test_assembled_parity.py's
whole-model fp32 bar) and every PNG the sinks write within one 8-bit step.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from sdmatte_tpu.api import node as jax_node
from sdmatte_tpu.configs import SDMatteConfig as JaxSDMatteConfig
from sdmatte_tpu.core.dtypes import FP32 as JAX_FP32
from sdmatte_tpu.models import sdmatte as jax_sdmatte
from sdmatte_tpu.pipeline import MattingPipeline as JaxPipeline

from sdmatte_tpu_torch import workflow
from sdmatte_tpu_torch.api import node
from sdmatte_tpu_torch.checkpoint.convert import load_params
from sdmatte_tpu_torch.configs import SDMatteConfig
from sdmatte_tpu_torch.models.sdmatte import SDMatte
from sdmatte_tpu_torch.pipeline import MattingPipeline

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
sys.path.insert(0, EXAMPLES)

import run_workflow  # noqa: E402
from test_reference_workflow import REF_DIR, _reference_workflow  # noqa: E402

WORKFLOW = os.path.join(EXAMPLES, "workflow_sdmatte_tpu.json")
WIDGETS = ["ckpt_name", "inference_size", "is_transparent", "output_mode",
           "mask_refine", "trimap_constraint", "force_cpu"]


@pytest.fixture(scope="module")
def tiny_pipes():
    cfg = JaxSDMatteConfig.tiny()
    params = jax_sdmatte.init(cfg, seed=0)
    jax_pipe = JaxPipeline(params, cfg, policy=JAX_FP32, attn_impl="xla")
    model = load_params(SDMatte(SDMatteConfig.tiny()), params)
    return jax_pipe, MattingPipeline(model, device="cpu")


def _graph(size=64):
    with open(WORKFLOW) as f:
        g = json.load(f)
    for n in g["nodes"]:
        if n["type"] == "SDMatteApply":
            n["widgets_values"][1] = size
    return g


def _pngs(d):
    return {f: np.asarray(Image.open(os.path.join(d, f))).astype(np.int16)
            for f in sorted(os.listdir(d)) if f.endswith(".png")}


def test_bundled_workflow_matches_jax_runner(tiny_pipes, tmp_path, monkeypatch):
    jax_pipe, pipe = tiny_pipes
    monkeypatch.setattr(jax_node, "get_pipeline", lambda *a, **k: jax_pipe)
    monkeypatch.setattr(node, "get_pipeline", lambda *a, **k: pipe)
    asset_dir = os.path.dirname(os.path.abspath(WORKFLOW))
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_registry = {
        "LoadImage": run_workflow.LoadImage(asset_dir),
        "LoadImageMask": run_workflow.LoadImageMask(asset_dir),
        "MaskToImage": run_workflow.MaskToImage(),
        "PreviewImage": run_workflow.PreviewImage(jax_out),
        "SaveImage": run_workflow.SaveImage(jax_out),
        "SDMatteApply": jax_node.SDMatteApply(),
    }
    registry = dict(workflow.builtin_nodes(asset_dir, out),
                    SDMatteApply=node.SDMatteApply())
    ref = run_workflow.execute_workflow(_graph(), jax_registry, verbose=False)
    timings = {}
    got = workflow.execute_workflow(_graph(), registry, verbose=False, timings=timings)

    assert set(got) == set(ref) == set(timings)
    alpha, matted = got[3]
    assert alpha.ndim == 3 and matted.shape[-1] == 4     # matted_rgba per the graph
    for g, r in zip(got[3], ref[3]):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        assert g.shape == r.shape
        assert float((g - r).abs().mean()) <= 1e-4
    ours, theirs = _pngs(out), _pngs(jax_out)
    assert list(ours) == list(theirs) == ["preview_01_000.png", "sdmatte_matted_01_000.png"]
    for name, a in ours.items():
        assert a.shape == theirs[name].shape
        assert np.abs(a - theirs[name]).max() <= 1, name
    # the SaveImage PNG is the matted tensor in 8 bits
    saved = ours["sdmatte_matted_01_000.png"] / 255.0
    assert np.abs(saved - matted[0].numpy()).max() <= 1 / 255


def test_widget_mapping_matches_input_types():
    names = workflow._widget_names(node.SDMatteApply)
    assert names == WIDGETS == run_workflow._widget_names(jax_node.SDMatteApply)
    with open(WORKFLOW) as f:
        g = json.load(f)
    apply = next(n for n in g["nodes"] if n["type"] == "SDMatteApply")
    assert len(apply["widgets_values"]) == len(names)


@pytest.mark.parametrize("image", ["example_photo", "uniform"])
def test_segment_anything_standin_matches_jax(image):
    if image == "example_photo":
        asset_dir = os.path.dirname(os.path.abspath(WORKFLOW))
        img, _ = workflow.LoadImage(asset_dir).run(["example_input.png"], [])
        jax_img, _ = run_workflow.LoadImage(asset_dir).run(["example_input.png"], [])
        assert torch.equal(img, jax_img)
    else:
        img = torch.full((1, 40, 56, 3), 0.37)
        lum = np.full((40, 56), 0.37, np.float32)
        assert workflow.SegmentAnythingStandin._otsu(lum) == 0.5
        assert run_workflow.SegmentAnythingStandin._otsu(lum) == 0.5
    out_img, mask = workflow.SegmentAnythingStandin().run([], [img])
    _, ref = run_workflow.SegmentAnythingStandin().run([], [img.clone()])
    assert out_img is img
    assert mask.dtype == ref.dtype == torch.float32 and torch.equal(mask, ref)


@pytest.mark.skipif(_reference_workflow() is None,
                    reason="reference example_workflow not present on this host")
def test_reference_workflow_runs_through_port(tiny_pipes, tmp_path, monkeypatch):
    """The reference plugin's production workflow (as
    tests/test_reference_workflow.py runs it through the JAX runner)."""
    _, pipe = tiny_pipes
    monkeypatch.setattr(node, "get_pipeline", lambda *a, **k: pipe)
    with open(_reference_workflow()) as f:
        graph = json.load(f)
    apply_ids = [n["id"] for n in graph["nodes"] if n["type"] == "SDMatteApply"]
    assert len(apply_ids) == 4
    for n in graph["nodes"]:
        if n["type"] == "SDMatteApply":
            assert n["widgets_values"][1] == 1024
            n["widgets_values"][1] = 64
    out_dir = str(tmp_path / "out")
    registry = dict(workflow.builtin_nodes(REF_DIR, out_dir), SDMatteApply=node.SDMatteApply())
    results = workflow.execute_workflow(graph, registry, verbose=False)
    for nid in apply_ids:
        a = results[nid][0].numpy()
        assert a.ndim == 3 and np.isfinite(a).all() and 0.0 <= a.min() and a.max() <= 1.0
    assert len([f for f in os.listdir(out_dir) if f.endswith(".png")]) >= 9


def _small_workflow(tmp_path):
    """The bundled workflow at inference size 64, beside copies of its images."""
    d = tmp_path / "wf"
    d.mkdir()
    for f in ("example_input.png", "example_trimap.png"):
        shutil.copy(os.path.join(EXAMPLES, f), d / f)
    (d / "workflow.json").write_text(json.dumps(_graph()))
    return str(d / "workflow.json")


def test_main_tiny_cpu_writes_pngs(tmp_path):
    out = tmp_path / "out"
    get_pipeline = node.get_pipeline
    rc = workflow.main([_small_workflow(tmp_path), "--out-dir", str(out), "--tiny", "--cpu",
                        "--random-weights"])
    assert rc == 0
    assert sorted(os.listdir(out)) == ["preview_01_000.png", "sdmatte_matted_01_000.png"]
    assert np.asarray(Image.open(out / "sdmatte_matted_01_000.png")).shape == (768, 1024, 4)
    assert node.get_pipeline is get_pipeline     # the node's loader is restored


def test_main_cpu_asks_the_node_for_the_cpu(tiny_pipes, tmp_path, monkeypatch):
    """Without --random-weights, --cpu reaches the node's own loader as
    force_cpu=True."""
    _, pipe = tiny_pipes
    calls = []

    def get_pipeline(name, **kw):
        calls.append((name, kw))
        return pipe

    monkeypatch.setattr(node, "get_pipeline", get_pipeline)
    rc = workflow.main([_small_workflow(tmp_path), "--out-dir", str(tmp_path / "out"), "--cpu"])
    assert rc == 0
    assert calls == [("SDMatte_plus.safetensors", {"force_cpu": True})]


@pytest.mark.parametrize("flags", [[], ["--random-weights"]])
def test_main_without_cuda_exits_2(tmp_path, monkeypatch, capsys, flags):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    rc = workflow.main([_small_workflow(tmp_path), "--out-dir", str(out), *flags])
    assert rc == 2
    assert "(or pass --cpu)" in capsys.readouterr().err
    assert not out.exists()
