"""The port's parity pack (python -m sdmatte_tpu_torch.parity_pack) on a tiny
checkpoint the port writes: the four cases of tests/test_parity_pack.py (a
clean pass, a loader layout bug, flipped conv taps, the frozen-stats round
trip), stage 1 on a wrapper prefix, and the port's golden dump against the
JAX pack's on the same file: every shared key within MAE 5e-5 and the alpha
within MAE 1e-4 (the whole-model bar of tests/test_assembled_parity.py);
the encoder's outputs (the latents and aux tokens) also within 5e-5 max abs,
the fp32 block bar of tests/test_block_parity.py."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from sdmatte_tpu import parity_pack as jax_pack
from sdmatte_tpu.checkpoint.loader import read_safetensors as jax_read_safetensors

from sdmatte_tpu_torch import parity_pack
from sdmatte_tpu_torch.checkpoint import loader, safetensors_io
from sdmatte_tpu_torch.checkpoint.toy import save_checkpoint
from sdmatte_tpu_torch.configs import SDMatteConfig
from sdmatte_tpu_torch.models.init import init_random_
from sdmatte_tpu_torch.models.sdmatte import SDMatte

GOLDEN_KEYS = {"alpha", "rgb_latent", "aux_latent", "aux_tokens", "unet_out", "decoded"}


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    model = SDMatte(SDMatteConfig.tiny())
    init_random_(model, seed=3, device="cpu")
    path = tmp_path_factory.mktemp("pp") / "tiny.safetensors"
    save_checkpoint(model, str(path))
    return str(path)


def _loaded(path):
    model = SDMatte(SDMatteConfig.tiny())
    init_random_(model, seed=0, device="cpu")
    return model, loader.load_sdmatte_checkpoint(model, path)


def test_parity_pack_passes_on_clean_checkpoint(tiny_ckpt, tmp_path):
    """The module as a user runs it, in a process of its own."""
    out, golden = tmp_path / "report.json", tmp_path / "golden.npz"
    r = subprocess.run([sys.executable, "-m", "sdmatte_tpu_torch.parity_pack",
                        "--ckpt", tiny_ckpt, "--tiny", "--cpu", "--size", "64",
                        "--golden-out", str(golden), "--out", str(out)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads(out.read_text())
    assert rep["ok"] and rep["device"] == "cpu"
    for name in ("header_vs_manifest", "load_report", "layout_signatures", "golden",
                 "quality"):
        assert rep["stages"][name]["ok"], name
        assert rep["stages"][name]["seconds"] >= 0
    assert set(np.load(golden).files) == GOLDEN_KEYS
    assert {"SAD", "MSE", "Grad", "Conn"} <= rep["stages"]["quality"].keys()


def test_parity_pack_catches_loader_layout_bug(tiny_ckpt, monkeypatch):
    """The file is ground truth; the risk is the loader.  Simulate linear
    weights reaching the module transposed: square linears load shape-clean,
    and only the signatures catch them."""
    real = loader.read_checkpoint

    def transposed(path):
        return {k: (v.t() if v.ndim == 2 and v.shape[0] == v.shape[1] else v)
                for k, v in real(path).items()}

    monkeypatch.setattr(loader, "read_checkpoint", transposed)
    model, rep = _loaded(tiny_ckpt)
    monkeypatch.undo()
    assert (rep.missing, rep.unexpected, rep.mismatched) == ([], [], [])
    failures = parity_pack.check_loaded_stats(model, safetensors_io.read(tiny_ckpt))
    assert failures
    assert any("to_q" in f or "to_k" in f or "proj" in f for f in failures)
    clean, _ = _loaded(tiny_ckpt)
    assert parity_pack.check_loaded_stats(clean, safetensors_io.read(tiny_ckpt)) == []


def test_parity_pack_catches_flipped_conv_taps(tiny_ckpt):
    """Spatially flipped taps keep every shape and channel statistic; the
    tap-grid signature catches them."""
    model, _ = _loaded(tiny_ckpt)
    with torch.no_grad():
        w = model.vae.encoder.conv_in.weight
        w.copy_(w.flip(2, 3))
    failures = parity_pack.check_loaded_stats(model, safetensors_io.read(tiny_ckpt))
    assert failures and all("conv_in" in f and "tap_grid" in f for f in failures)


def test_parity_pack_frozen_stats_roundtrip(tiny_ckpt, tmp_path):
    stats = tmp_path / "stats.json"
    base = ["--ckpt", tiny_ckpt, "--tiny", "--cpu", "--size", "64",
            "--skip-golden", "--skip-quality"]
    assert parity_pack.run(base + ["--emit-stats", str(stats)]) == 0 and stats.exists()
    assert parity_pack.run(base + ["--check-stats", str(stats)]) == 0
    # the frozen signatures are the JAX pack's: its check accepts them
    assert jax_pack.check_frozen_stats(jax_read_safetensors(tiny_ckpt),
                                       json.loads(stats.read_text())) == []
    # a perturbed tensor drifts them
    bad = dict(safetensors_io.read(tiny_ckpt))
    key = next(k for k, v in bad.items() if v.ndim == 4)
    bad[key] = bad[key] + 0.25
    bad_path = str(tmp_path / "drift.safetensors")
    safetensors_io.write(bad, bad_path)
    bad_base = ["--ckpt", bad_path] + base[2:]
    assert parity_pack.run(bad_base + ["--check-stats", str(stats)]) == 1


def test_wrapper_prefix_fails_stage_1_only(tiny_ckpt, tmp_path):
    """A "module."-prefixed file loads cleanly (the loader strips the
    prefix) but is not the manifest's key set, as in the JAX pack."""
    tensors = safetensors_io.read(tiny_ckpt)
    path = str(tmp_path / "wrapped.safetensors")
    safetensors_io.write({"module." + k: v for k, v in tensors.items()}, path)
    out = tmp_path / "r.json"
    assert parity_pack.run(["--ckpt", path, "--tiny", "--cpu", "--skip-golden",
                            "--skip-quality", "--out", str(out)]) == 1
    stages = json.loads(out.read_text())["stages"]
    assert not stages["header_vs_manifest"]["ok"]
    assert stages["load_report"]["ok"] and stages["layout_signatures"]["ok"]


def test_parity_pack_needs_the_card_unless_cpu(tiny_ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert parity_pack.run(["--ckpt", tiny_ckpt, "--tiny", "--skip-golden",
                            "--skip-quality"]) == 2


def test_golden_matches_the_jax_pack(tiny_ckpt, tmp_path, monkeypatch):
    """Both packs' stage 4 on the same file: the same keys, NHWC.

    The JAX pack reads through the ``safetensors`` package here: its native
    reader's zero-copy views outlive the mapping once the dict that owns it
    is dropped (sdmatte_tpu/runtime/fast_safetensors.py), which the JAX
    loader's unconverted tensors do, and stage 3 then reads freed pages."""
    from sdmatte_tpu.runtime import fast_safetensors

    def unavailable(path):
        raise OSError("the native reader is not used here")

    monkeypatch.setattr(fast_safetensors, "read", unavailable)
    ours, theirs = tmp_path / "ours.npz", tmp_path / "jax.npz"
    base = ["--ckpt", tiny_ckpt, "--tiny", "--size", "64", "--skip-quality"]
    assert parity_pack.run(base + ["--cpu", "--golden-out", str(ours)]) == 0
    assert jax_pack.run(base + ["--golden-out", str(theirs)]) == 0
    got, ref = np.load(ours), np.load(theirs)
    assert set(got.files) == set(ref.files) == GOLDEN_KEYS
    for key in GOLDEN_KEYS:
        assert got[key].shape == ref[key].shape, key
        diff = np.abs(got[key] - ref[key])
        assert diff.mean() <= (1e-4 if key == "alpha" else 5e-5), (key, diff.mean())
        if key in ("rgb_latent", "aux_latent", "aux_tokens"):
            assert diff.max() <= 5e-5, (key, diff.max())


def test_golden_inputs_from_files_match_the_jax_pack(tmp_path):
    """--image/--trimap: the files resized to --size as the JAX pack does
    (antialiased bilinear on the 8-bit values)."""
    import jax.numpy as jnp
    from PIL import Image
    from sdmatte_tpu.core import imaging as jax_imaging
    from sdmatte_tpu.utils.images import load_unit_image
    rng = np.random.default_rng(5)
    img, tri = tmp_path / "img.png", tmp_path / "tri.png"
    Image.fromarray(rng.integers(0, 255, (70, 90, 3), dtype=np.uint8)).save(img)
    Image.fromarray(rng.choice([0, 128, 255], (70, 90)).astype(np.uint8)).save(tri)
    got_img, got_tri = parity_pack.golden_inputs(64, str(img), str(tri))
    ref_img = jax_imaging.resize_bilinear(jnp.asarray(load_unit_image(str(img), 3))[None],
                                          64, 64, antialias=True)
    ref_tri = jax_imaging.resize_bilinear(
        jnp.asarray(load_unit_image(str(tri), 1)[..., 0])[None, ..., None], 64, 64,
        antialias=True)
    assert got_img.shape == (1, 64, 64, 3) and got_tri.shape == (1, 64, 64, 1)
    np.testing.assert_allclose(got_img, np.asarray(ref_img), atol=1e-6)
    np.testing.assert_allclose(got_tri, np.asarray(ref_tri), atol=1e-6)
