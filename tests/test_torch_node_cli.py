"""The port's ComfyUI node and CLI against the JAX package's.

Both packages read one tiny checkpoint, written by the port's writer from
the JAX package's weights, and one config directory written by the port's
``configs.save_pretrained_dir`` (the tiny config with 1024-wide aux tokens:
``aux_token_dim`` has no published config key, so both parsers give it the
default 1024).  Each package's model registry points at them, so nothing is
downloaded.  The node runs fp32 on the CPU (``force_cpu``) and meets the JAX
node at MAE <= 1e-4 (tests/test_assembled_parity.py's bar); the CLIs' 8-bit
PNGs differ by at most one step, 0.05 steps on average.
"""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from sdmatte_tpu import cli as jax_cli
from sdmatte_tpu.api import comfy_shim as jax_shim
from sdmatte_tpu.api import node as jax_node
from sdmatte_tpu.configs import SDMatteConfig as JaxSDMatteConfig
from test_torch_models import _randomized_params

from sdmatte_tpu_torch import cli, configs
from sdmatte_tpu_torch.api import comfy_shim, node
from sdmatte_tpu_torch.assets import manager
from sdmatte_tpu_torch.checkpoint.convert import load_params
from sdmatte_tpu_torch.checkpoint.toy import save_checkpoint
from sdmatte_tpu_torch.models.sdmatte import SDMatte


def _cfg(base):
    return dataclasses.replace(base, unet=dataclasses.replace(
        base.unet, cross_attention_dim=1024, aux_token_dim=1024))


def _no_network(url, dst, progress=True):
    raise AssertionError(f"a test tried to download {url}")


def _no_native_reader(path):
    raise OSError("the native reader is not used here")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A models directory with SDMatte/SDMatte.safetensors and the config
    directory, registered with both packages' shims (fresh registries,
    restored afterwards).

    The JAX package reads the checkpoint through the ``safetensors``
    package: its native reader (sdmatte_tpu/runtime/fast_safetensors.py)
    hands out views that outlive their mapping once the dict that owns it
    is dropped, and the JAX pipeline's staging then read freed pages and
    crashed the test process now and then (a segfault in
    ``MattingPipeline.__init__``'s ``tree_map_with_path``, under
    ``-n 6 --dist loadfile``)."""
    from sdmatte_tpu.runtime import fast_safetensors
    root = tmp_path_factory.mktemp("models")
    (root / "SDMatte").mkdir()
    cfg = _cfg(configs.SDMatteConfig.tiny())
    model = load_params(SDMatte(cfg), _randomized_params(_cfg(JaxSDMatteConfig.tiny()), seed=4))
    save_checkpoint(model, str(root / "SDMatte" / "SDMatte.safetensors"))
    cfg_dir = root / "diffusers" / "stable-diffusion-2-1-base"
    configs.save_pretrained_dir(cfg, str(cfg_dir))
    assert configs.SDMatteConfig.from_pretrained_dir(str(cfg_dir)) == cfg
    with pytest.MonkeyPatch.context() as mp:
        for shim in (comfy_shim, jax_shim):
            registry = shim._StandaloneRegistry()
            registry.models_dir = str(root)
            mp.setattr(shim, "_registry", registry)
        mp.setattr(manager, "_default_fetch", _no_network)
        mp.setattr(fast_safetensors, "read", _no_native_reader)
        yield root, model
    node._PIPELINE_CACHE.clear()
    jax_node._PIPELINE_CACHE.clear()


def test_input_types_match_jax():
    assert node.SDMatteApply.INPUT_TYPES() == jax_node.SDMatteApply.INPUT_TYPES()
    for attr in ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY"):
        assert getattr(node.SDMatteApply, attr) == getattr(jax_node.SDMatteApply, attr)
    assert node.NODE_CLASS_MAPPINGS == {"SDMatteApply": node.SDMatteApply}
    assert node.NODE_DISPLAY_NAME_MAPPINGS == jax_node.NODE_DISPLAY_NAME_MAPPINGS


@pytest.mark.parametrize("mode", ["alpha_only", "matted_rgba", "matted_rgb"])
def test_apply_matte_matches_jax_node(models, mode):
    rng = np.random.default_rng(11)
    img = torch.from_numpy(rng.uniform(0, 1, (1, 70, 90, 3)).astype(np.float32))
    tri = torch.from_numpy(rng.choice([0.0, 0.5, 1.0], (1, 70, 90)).astype(np.float32))
    args = ("SDMatte.safetensors", img, tri, 64, False, mode, True, 0.8)
    ref_alpha, ref_matted = jax_node.SDMatteApply().apply_matte(*args, force_cpu=True)
    alpha, matted = node.SDMatteApply().apply_matte(*args, force_cpu=True)
    for got, ref in ((alpha, ref_alpha), (matted, ref_matted)):
        assert got.device.type == "cpu" and got.dtype == torch.float32
        assert got.is_contiguous() and got.shape == ref.shape
        assert float((got - ref).abs().mean()) <= 1e-4
    pipe = node.get_pipeline("SDMatte.safetensors", force_cpu=True)
    rep = pipe.load_report
    assert (rep.missing, rep.unexpected, rep.mismatched) == ([], [], [])
    # the returned tensors are the caller's own: writing them is safe
    alpha.fill_(0.5)
    again, _ = node.SDMatteApply().apply_matte(*args, force_cpu=True)
    assert float((again - ref_alpha).abs().mean()) <= 1e-4


def test_loaded_weights_are_the_checkpoint(models):
    _, model = models
    pipe = node.get_pipeline("SDMatte.safetensors", force_cpu=True)
    assert pipe.device.type == "cpu" and pipe.policy.param_dtype == torch.float32
    ours = pipe.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(ours[k], v), k


def test_pipeline_cache_key(models):
    root, _ = models
    path = str(root / "SDMatte" / "SDMatte.safetensors")
    first = node.get_pipeline("SDMatte.safetensors", force_cpu=True)
    assert node.get_pipeline("SDMatte.safetensors", force_cpu=True) is first
    key = node.pipeline_cache_key(path, force_cpu=True)
    assert key == (path, os.path.getmtime(path), True, "bf16", "off", "fp")
    assert list(node._PIPELINE_CACHE) == [key]
    # another option is another pipeline, and the cache holds one model
    other = node.get_pipeline("SDMatte.safetensors", force_cpu=True, weight_storage="int8")
    assert other is not first and len(node._PIPELINE_CACHE) == 1
    # a rewritten file (new mtime) is reloaded
    st = os.stat(path)
    os.utime(path, (st.st_atime, st.st_mtime + 10))
    again = node.get_pipeline("SDMatte.safetensors", force_cpu=True, weight_storage="int8")
    assert again is not other


def test_unknown_checkpoint_name_is_refused(models):
    with pytest.raises(manager.AssetError, match="unknown model name"):
        node.get_pipeline("NoSuch.safetensors", force_cpu=True)


def _fake_comfy(monkeypatch, device_type):
    mm = types.ModuleType("comfy.model_management")
    mm.get_torch_device = lambda: torch.device(device_type)
    mm.flushed = []
    mm.soft_empty_cache = lambda: mm.flushed.append(1)
    pkg = types.ModuleType("comfy")
    pkg.model_management = mm
    monkeypatch.setitem(sys.modules, "comfy", pkg)
    monkeypatch.setitem(sys.modules, "comfy.model_management", mm)
    return mm


@pytest.mark.parametrize("device_type,expect", [("cpu", True), ("cuda", False), (None, False)])
def test_host_prefers_cpu_reads_the_host_device(monkeypatch, device_type, expect):
    """The host's torch device is the signal itself (no JAX backend check)."""
    if device_type is not None:
        mm = _fake_comfy(monkeypatch, device_type)
        comfy_shim.soft_empty_cache()
        assert mm.flushed == [1]
    assert comfy_shim.host_prefers_cpu() is expect


def test_host_cpu_makes_force_cpu_implicit(models, monkeypatch):
    _fake_comfy(monkeypatch, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img, tri = torch.rand(1, 40, 40, 3), torch.rand(1, 40, 40)
    alpha, _ = node.SDMatteApply().apply_matte("SDMatte.safetensors", img, tri, 64,
                                               False, "alpha_only", True, 0.8)
    assert alpha.shape == (1, 40, 40)


def test_entry_points_raise_without_cuda(models, monkeypatch, tmp_path):
    """The card unless the caller asks for the CPU; never a quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        node.get_pipeline("SDMatte.safetensors")
    with pytest.raises(RuntimeError, match="CUDA"):
        node.SDMatteApply().apply_matte("SDMatte.safetensors", torch.rand(1, 8, 8, 3),
                                        torch.rand(1, 8, 8), 512, False, "alpha_only",
                                        True, 0.8)
    img, tri = _write_pair(tmp_path, "x")
    assert cli.main(["--image", img, "--trimap", tri, "--out", str(tmp_path / "a.png"),
                     "--tiny"]) == 2
    assert not (tmp_path / "a.png").exists()
    from sdmatte_tpu_torch.api import serve
    assert serve.main(["--random-weights", "--port", "0"]) == 2


# ------------------------------------------------------------------- CLI ---

def _write_pair(d, stem, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    img, tri = str(d / f"{stem}_img.png"), str(d / f"{stem}_tri.png")
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(img)
    t = np.zeros((h, w), np.uint8)
    t[h // 4: h // 2, w // 4: w // 2] = 128
    t[h // 2:, w // 2:] = 255
    Image.fromarray(t).save(tri)
    return img, tri


def _assert_pngs_match(got_path, ref_path):
    got = np.asarray(Image.open(got_path)).astype(np.int16)
    ref = np.asarray(Image.open(ref_path)).astype(np.int16)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    # fp32 differences of ~1e-5 flip the 8-bit rounding of a few pixels
    assert diff.max() <= 1 and diff.mean() <= 0.05, (diff.max(), diff.mean())


@pytest.mark.parametrize("mode", ["alpha_only", "matted_rgba"])
def test_cli_file_mode_matches_jax_cli(models, tmp_path, mode):
    root, _ = models
    ckpt = str(root / "SDMatte" / "SDMatte.safetensors")
    img, tri = _write_pair(tmp_path, "cat", h=50, w=70)
    outs = {}
    for name, main in (("ours", cli.main), ("jax", jax_cli.main)):
        outs[name] = (str(tmp_path / f"{name}_alpha.png"), str(tmp_path / f"{name}_matted.png"))
        rc = main(["--image", img, "--trimap", tri, "--out", outs[name][0],
                   "--matted-out", outs[name][1], "--mode", mode, "--size", "512",
                   "--ckpt", ckpt, "--cpu"])
        assert rc == 0
    assert np.asarray(Image.open(outs["ours"][0])).shape == (50, 70)
    for got, ref in zip(outs["ours"], outs["jax"]):
        _assert_pngs_match(got, ref)


@pytest.mark.parametrize("extra", [
    ["--prompt-type", "point_mask", "--coords", "0.3,0.4,0.6,0.5"],
    ["--speed-mode", "fast"],
], ids=["point_mask", "speed_fast"])
def test_cli_options_match_jax_cli(models, tmp_path, extra):
    """A point prompt (two points, the trimap file as its mask) and a speed
    mode reach the pipeline as in the JAX CLI: the same alpha PNG."""
    root, _ = models
    ckpt = str(root / "SDMatte" / "SDMatte.safetensors")
    img, tri = _write_pair(tmp_path, "cat", h=40, w=56, seed=3)
    for name, main in (("ours", cli.main), ("jax", jax_cli.main)):
        rc = main(["--image", img, "--trimap", tri, "--out", str(tmp_path / f"{name}.png"),
                   "--size", "512", "--ckpt", ckpt, "--cpu"] + extra)
        assert rc == 0
    _assert_pngs_match(tmp_path / "ours.png", tmp_path / "jax.png")


def test_cli_batch_9_matches_jax_cli(models, tmp_path, monkeypatch):
    """Nine same-shape pairs at --batch 9 run as one pipeline call of batch
    9, whose encode is split (concat batch 18 > 16), as in the JAX CLI."""
    from sdmatte_tpu_torch.pipeline import MattingPipeline
    root, _ = models
    ckpt = str(root / "SDMatte" / "SDMatte.safetensors")
    imgs, tris = tmp_path / "imgs", tmp_path / "tris"
    imgs.mkdir(), tris.mkdir()
    for i in range(9):
        img, tri = _write_pair(tmp_path, f"p{i}", h=24, w=32, seed=20 + i)
        os.replace(img, imgs / f"p{i}.png"), os.replace(tri, tris / f"p{i}.png")
    batches = []
    heavy = MattingPipeline._heavy

    def spy(self, img, *a, **k):
        batches.append(img.shape[0])
        return heavy(self, img, *a, **k)

    monkeypatch.setattr(MattingPipeline, "_heavy", spy)
    for name, main in (("ours", cli.main), ("jax", jax_cli.main)):
        rc = main(["--image", str(imgs), "--trimap", str(tris), "--out", str(tmp_path / name),
                   "--size", "512", "--batch", "9", "--ckpt", ckpt, "--cpu"])
        assert rc == 0
    assert batches == [9]
    for i in range(9):
        _assert_pngs_match(tmp_path / "ours" / f"p{i}.png", tmp_path / "jax" / f"p{i}.png")


def test_cli_directory_mode_matches_jax_cli(models, tmp_path):
    root, _ = models
    ckpt = str(root / "SDMatte" / "SDMatte.safetensors")
    imgs, tris = tmp_path / "imgs", tmp_path / "tris"
    imgs.mkdir(), tris.mkdir()
    for i in range(3):                       # one shape group: chunks of 2 and 1
        img, tri = _write_pair(tmp_path, f"a{i}", seed=i)
        os.replace(img, imgs / f"a{i}.png"), os.replace(tri, tris / f"a{i}.png")
    img, tri = _write_pair(tmp_path, "wide", h=32, w=80, seed=9)
    os.replace(img, imgs / "wide.png"), os.replace(tri, tris / "wide.png")
    (imgs / "orphan.png").write_bytes((imgs / "wide.png").read_bytes())
    for name, main in (("ours", cli.main), ("jax", jax_cli.main)):
        rc = main(["--image", str(imgs), "--trimap", str(tris),
                   "--out", str(tmp_path / name), "--matted-out", str(tmp_path / f"{name}_m"),
                   "--size", "512", "--batch", "2", "--ckpt", ckpt, "--cpu"])
        assert rc == 0
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == ["a0.png", "a1.png", "a2.png", "wide.png"]   # orphan skipped
    assert sorted(p.name for p in (tmp_path / "jax").iterdir()) == names
    for n in names:
        _assert_pngs_match(tmp_path / "ours" / n, tmp_path / "jax" / n)
        _assert_pngs_match(tmp_path / "ours_m" / n, tmp_path / "jax_m" / n)


def test_cli_tiny_random_weights(tmp_path):
    img, tri = _write_pair(tmp_path, "x", h=48, w=64)
    out, matted = str(tmp_path / "alpha.png"), str(tmp_path / "matted.png")
    rc = cli.main(["--image", img, "--trimap", tri, "--out", out, "--matted-out", matted,
                   "--mode", "matted_rgba", "--size", "512", "--tiny", "--cpu"])
    assert rc == 0
    assert np.asarray(Image.open(out)).shape == (48, 64)
    assert np.asarray(Image.open(matted)).shape == (48, 64, 4)


def test_cli_argument_errors(tmp_path):
    img, tri = _write_pair(tmp_path, "x")
    base = ["--image", img, "--trimap", tri, "--out", str(tmp_path / "o.png"), "--tiny", "--cpu"]
    for extra in (["--prompt-type", "point_mask"], ["--batch", "0"], ["--coords", "a,b"]):
        with pytest.raises(SystemExit):
            cli.main(base + extra)
    with pytest.raises(SystemExit):
        cli.main(["--image", str(tmp_path), "--trimap", tri, "--out", "o", "--tiny", "--cpu"])
