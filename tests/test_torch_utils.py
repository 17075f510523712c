"""The port's copies of the JAX package's jax-free helpers (utils/env.py,
utils/images.py, utils/observability.py, assets/manager.py), held against
the JAX package's own modules on the same inputs."""

import os

import numpy as np
import pytest
from PIL import Image

from sdmatte_tpu.utils import images as jax_images
from sdmatte_tpu.utils import observability as jax_obs
from sdmatte_tpu.utils.env import env_flag as jax_env_flag
from sdmatte_tpu_torch.assets import manager
from sdmatte_tpu_torch.utils import images, observability
from sdmatte_tpu_torch.utils.env import env_flag


@pytest.mark.parametrize("val", ["1", "true", "TRUE", "yes", "on", " 1 ", "0", "false",
                                 "False", "no", "off", "", "maybe", None])
@pytest.mark.parametrize("default", [False, True])
def test_env_flag_matches_jax(monkeypatch, val, default):
    if val is None:
        monkeypatch.delenv("SDMATTE_TEST_FLAG", raising=False)
    else:
        monkeypatch.setenv("SDMATTE_TEST_FLAG", val)
    assert env_flag("SDMATTE_TEST_FLAG", default) is jax_env_flag("SDMATTE_TEST_FLAG", default)


def _image(mode: str) -> Image.Image:
    rng = np.random.default_rng(3)
    if mode in ("I;16", "I"):
        return Image.fromarray(rng.integers(0, 65536, (9, 7), dtype=np.uint16)).convert(mode)
    if mode == "F":
        return Image.fromarray(rng.random((9, 7), dtype=np.float32), mode="F")
    rgba = Image.fromarray(rng.integers(0, 256, (9, 7, 4), dtype=np.uint8), mode="RGBA")
    if mode == "P+transparency":
        img = rgba.convert("RGB").convert("P")
        img.info["transparency"] = 0
        return img
    return rgba.convert(mode)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA", "P", "P+transparency", "CMYK",
                                  "1", "I;16", "I", "F"])
@pytest.mark.parametrize("channels", [1, 3])
def test_pil_to_unit_array_matches_jax(mode, channels):
    got = images.pil_to_unit_array(_image(mode), channels)
    ref = jax_images.pil_to_unit_array(_image(mode), channels)
    assert got.dtype == np.float32 and got.shape == (9, 7, channels)
    np.testing.assert_array_equal(got, ref)


def test_png_round_trip_is_8_bit(tmp_path):
    a = np.random.default_rng(0).random((5, 6, 3)).astype(np.float32)
    path = str(tmp_path / "a.png")
    images.save_png(path, a)
    back = images.load_unit_image(path, 3)
    np.testing.assert_array_equal(back * 255.0, images.to_uint8(a).astype(np.float32))


def test_metrics_summary_matches_jax():
    ours, ref = observability.Metrics(), jax_obs.Metrics()
    rng = np.random.default_rng(1)
    for m in (ours, ref):
        m.count("requests")
        m.count("requests", 2.0)
    for v in rng.random(observability._SERIES_CAP + 100):
        for m in (ours, ref):
            m.observe("queue_depth", float(v))
            m.observe_ms("lat", float(v) * 100)
    assert ours.summary() == ref.summary()
    assert len(ours.values["queue_depth"]) == observability._SERIES_CAP
    assert ours.summary()["values"]["queue_depth"]["n"] == observability._SERIES_CAP + 100


def test_timed_observes_into_its_metrics():
    m = observability.Metrics()
    with observability.timed("step", m):
        pass
    assert m.totals["step"] == 1 and m.timings_ms["step"][0] >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch
    with observability.trace(str(tmp_path)):
        torch.ones(4).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0


@pytest.fixture
def local_store(tmp_path):
    src = tmp_path / "store"
    src.mkdir()
    (src / "SDMatte.safetensors").write_bytes(b"FAKEWEIGHTS")
    for rel in manager.SD21_CONFIG_MANIFEST:
        p = src / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("{}")
    return str(src)


def _no_fetch(url, dst):
    raise AssertionError("should not fetch")


def test_download_model_local_fetch_then_found(local_store, tmp_path):
    urls = {"SDMatte.safetensors": "https://x/resolve/main/SDMatte.safetensors"}
    dst = str(tmp_path / "models")
    p = manager.download_model("SDMatte.safetensors", dst, model_urls=urls,
                               fetch=manager.local_copy_fetch(local_store))
    assert open(p, "rb").read() == b"FAKEWEIGHTS"
    assert manager.download_model("SDMatte.safetensors", dst, model_urls=urls,
                                  fetch=_no_fetch) == p


def test_download_search_paths_come_first(local_store, tmp_path):
    p = manager.download_model("SDMatte.safetensors", str(tmp_path / "unused"),
                               search_paths=[local_store], fetch=_no_fetch)
    assert p == os.path.join(local_store, "SDMatte.safetensors")


def test_failed_download_leaves_nothing(tmp_path):
    def bad_fetch(url, dst):
        with open(dst, "wb") as f:
            f.write(b"partial")
        raise IOError("network died")
    urls = {"SDMatte.safetensors": "https://x/SDMatte.safetensors"}
    with pytest.raises(IOError):
        manager.download_model("SDMatte.safetensors", str(tmp_path), model_urls=urls,
                               fetch=bad_fetch)
    assert os.listdir(tmp_path) == []


def test_concurrent_winner_kept(tmp_path):
    target = tmp_path / "SDMatte.safetensors"

    def racing_fetch(url, dst):
        with open(dst, "wb") as f:
            f.write(b"mine")
        target.write_bytes(b"winner")

    urls = {"SDMatte.safetensors": "https://x/SDMatte.safetensors"}
    p = manager.download_model("SDMatte.safetensors", str(tmp_path), model_urls=urls,
                               fetch=racing_fetch)
    assert open(p, "rb").read() == b"winner"
    assert not os.path.exists(str(target) + ".tmp")


def test_sd21_configs_partial_failure_is_not_fatal(local_store, tmp_path):
    copy = manager.local_copy_fetch(local_store)

    def flaky(url, dst):
        if "unet" in url:
            raise IOError("404")
        copy(url, dst)

    out = manager.ensure_sd21_configs(str(tmp_path / "sd21"), fetch=flaky)
    for rel in manager.SD21_CONFIG_MANIFEST:
        assert os.path.isfile(os.path.join(out, rel)) == ("unet" not in rel)
    with pytest.raises(IOError):
        manager.ensure_sd21_configs(str(tmp_path / "strict"), fetch=flaky, strict=True)
