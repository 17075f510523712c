"""The PyTorch port's pipeline against the JAX pipeline, and the port's
isolation from JAX.

The port runs on the CPU (``device="cpu"``), where every kernel site takes
its plain version; both pipelines get the same weights and the same numpy
inputs at an odd size, and agree at MAE <= 1e-4
(tests/test_assembled_parity.py's bar) in every output mode.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sdmatte_tpu.configs import SDMatteConfig as JaxSDMatteConfig
from sdmatte_tpu.models import sdmatte as jax_sdmatte
from sdmatte_tpu.pipeline import MattingPipeline as JaxPipeline
from sdmatte_tpu.pipeline import PipelineOptions as JaxOptions

from sdmatte_tpu_torch.checkpoint.convert import load_params
from sdmatte_tpu_torch.configs import SDMatteConfig
from sdmatte_tpu_torch.models.sdmatte import SDMatte
from sdmatte_tpu_torch.pipeline import MattingPipeline, PipelineOptions

PACKAGE = pathlib.Path(__file__).resolve().parent.parent / "sdmatte_tpu_torch"


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
def pipes():
    params = _randomized_params(JaxSDMatteConfig.tiny())
    jax_pipe = JaxPipeline(params, JaxSDMatteConfig.tiny(), attn_impl="xla")
    model = load_params(SDMatte(SDMatteConfig.tiny()), params)
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (1, 75, 61, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:75, 0:61]
    r = np.hypot(yy - 37, xx - 30)
    tri = np.where(r < 15, 1.0, np.where(r < 25, 0.5, 0.0)).astype(np.float32)
    return jax_pipe, MattingPipeline(model, device="cpu"), img, tri


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("mode", ["alpha_only", "matted_rgba", "matted_rgb", "alpha_blend"])
def test_pipeline_matches_jax(pipes, mode, refine):
    jax_pipe, pipe, img, tri = pipes
    kw = dict(inference_size=64, output_mode=mode, mask_refine=refine)
    ref_alpha, ref_matted = (np.asarray(a) for a in jax_pipe(img, tri, options=JaxOptions(**kw)))
    alpha, matted = pipe(img, tri, options=PipelineOptions(**kw))
    assert alpha.shape == ref_alpha.shape == (1, 75, 61)
    assert matted.shape == ref_matted.shape
    assert float(np.abs(alpha.numpy() - ref_alpha).mean()) <= 1e-4
    assert float(np.abs(matted.numpy() - ref_matted).mean()) <= 1e-4


def test_pipeline_rejects_unknown_options(pipes):
    _, pipe, img, tri = pipes
    with pytest.raises(ValueError, match="output_mode"):
        pipe(img, tri, options=PipelineOptions(inference_size=64, output_mode="blend"))
    model = pipe.model
    with pytest.raises(ValueError):
        MattingPipeline(model, device="cpu", speed_mode="turbo")
    with pytest.raises(ValueError, match="weight_storage"):
        MattingPipeline(model, device="cpu", weight_storage="int4")
    # text gating needs a tokenizer to turn captions into ids
    text_gated = dataclasses.replace(model.cfg, unet=dataclasses.replace(
        model.cfg.unet, use_encoder_hidden_states_list=(True, False, True)))
    gated = MattingPipeline(SDMatte(text_gated), device="cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        gated(img, tri, options=PipelineOptions(inference_size=64))


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with torch.device("meta"):
        model = SDMatte(SDMatteConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        MattingPipeline(model)


def _modules():
    """Every module of the port, by dotted name."""
    names = []
    for path in sorted(PACKAGE.rglob("*.py")):
        parts = path.relative_to(PACKAGE.parent).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


def test_import_pulls_in_no_jax():
    """Importing the port and every module of it loads neither jax nor the
    JAX package, and builds no kernel."""
    code = ("import sys, importlib\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'sdmatte_tpu' or m.startswith('sdmatte_tpu.'))\n"
            "print(len(bad), bad[:5])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PACKAGE.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout


# modules of the user entry points, the loader and the parity pack, which
# the checks above must reach
ENTRY_MODULES = {"sdmatte_tpu_torch.cli", "sdmatte_tpu_torch.api.node",
                 "sdmatte_tpu_torch.parity_pack", "sdmatte_tpu_torch.eval",
                 "sdmatte_tpu_torch.eval.metrics", "sdmatte_tpu_torch.eval.synthetic",
                 "sdmatte_tpu_torch.api.serve", "sdmatte_tpu_torch.api.comfy_shim",
                 "sdmatte_tpu_torch.assets.manager", "sdmatte_tpu_torch.checkpoint.loader",
                 "sdmatte_tpu_torch.checkpoint.safetensors_io",
                 "sdmatte_tpu_torch.checkpoint.manifest", "sdmatte_tpu_torch.checkpoint.toy",
                 "sdmatte_tpu_torch.models.clip", "sdmatte_tpu_torch.models.tokenizer",
                 "sdmatte_tpu_torch.utils.images", "sdmatte_tpu_torch.utils.observability",
                 "sdmatte_tpu_torch.utils.env"}


def test_isolation_checks_see_the_entry_points():
    assert ENTRY_MODULES <= set(_modules())


def test_import_pulls_in_no_optional_package():
    """Importing every module loads neither ``safetensors`` nor
    ``transformers`` (the card's machine is not promised to have them) nor
    Pillow (imported where an image is read or written)."""
    code = ("import sys, importlib\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('safetensors', 'transformers', 'PIL'))\n"
            "print(len(bad), bad[:5])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PACKAGE.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout


def test_no_file_imports_jax():
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "sdmatte_tpu", "safetensors",
                                   "transformers"), (path, name)
