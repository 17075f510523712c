"""The port's checkpoint loader, safetensors reader/writer, manifest and
config parsing against the JAX package.

A checkpoint the JAX package writes (checkpoint/toy.save_toy_checkpoint)
loads into the port's tiny model with nothing missing, unexpected or
mismatched, with the weights the JAX loader reads from the same file, and
the loaded model meets the JAX forward on those weights at MAE <= 1e-4
(tests/test_assembled_parity.py's bar), fp32 on the CPU.  (The JAX writer
hands ``safetensors.numpy.save_file`` transposed views, which safetensors
0.8 stores in memory order, so the file's conv and linear weights are not
the tree's; both loaders read the same bytes.)  The reader and
writer are held to the ``safetensors`` package byte for byte, for every
dtype (the port itself never imports that package).
"""

import dataclasses
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import load_file as st_load
from safetensors.torch import save_file as st_save

from sdmatte_tpu import configs as jax_configs
from sdmatte_tpu.checkpoint import manifest as jax_manifest
from sdmatte_tpu.checkpoint.loader import load_sdmatte_checkpoint as jax_load
from sdmatte_tpu.checkpoint.toy import save_toy_checkpoint, tree_to_torch_state_dict
from sdmatte_tpu.models import sdmatte as jax_sdmatte
from test_torch_models import _nchw, _nhwc, _randomized_params

from sdmatte_tpu_torch import configs
from sdmatte_tpu_torch.checkpoint import loader, manifest, safetensors_io
from sdmatte_tpu_torch.checkpoint.toy import save_checkpoint
from sdmatte_tpu_torch.models.sdmatte import SDMatte

FROZEN_MANIFEST = (pathlib.Path(__file__).resolve().parent.parent / "sdmatte_tpu"
                   / "checkpoint" / "sdmatte_expected_keys.json")


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A checkpoint written by the JAX package from inflated init weights."""
    jcfg = jax_configs.SDMatteConfig.tiny()
    params = _randomized_params(jcfg, seed=1)
    path = str(tmp_path_factory.mktemp("ckpt") / "SDMatte.safetensors")
    save_toy_checkpoint(params, path)
    return jcfg, params, path


def _tiny_model():
    return SDMatte(configs.SDMatteConfig.tiny()).eval()


def test_jax_checkpoint_loads_and_matches_jax_forward(jax_ckpt, rng):
    jcfg, _, path = jax_ckpt
    params, jax_report = jax_load(jax_sdmatte.init(jcfg, seed=7), path)
    assert not (jax_report.missing or jax_report.unexpected or jax_report.mismatched)
    model = _tiny_model()
    report = loader.load_sdmatte_checkpoint(model, path)
    assert (report.missing, report.unexpected, report.mismatched) == ([], [], [])
    assert report.loaded == len(model.state_dict())
    _assert_loaded_all(model, {k: torch.from_numpy(np.array(v, order="C"))
                               for k, v in tree_to_torch_state_dict(params).items()})
    b, s = 2, 64
    data = {
        "image": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        "trimap": rng.choice([-1.0, 0.0, 1.0], (b, s, s, 1)).astype(np.float32),
        "trimap_coords": rng.uniform(0, 1, (b, 4)).astype(np.float32),
        "is_trans": np.array([0.0, 1.0], np.float32),
    }
    ref = np.asarray(jax.jit(lambda p, d: jax_sdmatte.forward(p, jcfg, d, attn_impl="xla"))(
        params, {k: jnp.asarray(v) for k, v in data.items()}))
    tdata = {k: (_nchw(v) if v.ndim == 4 else torch.from_numpy(v)) for k, v in data.items()}
    with torch.no_grad():
        got = _nhwc(model(tdata))
    assert float(np.abs(got - ref).mean()) <= 1e-4


def _sd(jax_ckpt):
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in tree_to_torch_state_dict(jax_ckpt[1]).items()}


def _assert_loaded_all(model, sd):
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


@pytest.mark.parametrize("prefix", loader.CANDIDATE_PREFIXES)
def test_wrapper_prefix_is_stripped(jax_ckpt, prefix):
    sd = _sd(jax_ckpt)
    model = _tiny_model()
    report = loader.load_into_module(model, {prefix + k: v for k, v in sd.items()})
    assert (report.missing, report.unexpected, report.mismatched) == ([], [], [])
    _assert_loaded_all(model, sd)


def test_prefix_shared_by_some_keys_only_is_kept(jax_ckpt):
    sd = _sd(jax_ckpt)
    keys = list(sd)
    wrapped = {("module." + k if i else k): sd[k] for i, k in enumerate(keys)}
    report = loader.load_into_module(_tiny_model(), wrapped)
    assert len(report.unexpected) == len(keys) - 1
    assert report.missing and report.loaded == 1


def test_legacy_vae_attention_names_load(jax_ckpt, tmp_path):
    sd = _sd(jax_ckpt)
    legacy = jax_manifest.legacy_vae_attn_variant({k: tuple(v.shape) for k, v in sd.items()})
    renamed = dict(zip(legacy, sd.values()))
    assert any(".attentions.0.query." in k for k in renamed)
    path = str(tmp_path / "legacy.safetensors")
    st_save(renamed, path)
    model = _tiny_model()
    report = loader.load_sdmatte_checkpoint(model, path)
    assert (report.missing, report.unexpected, report.mismatched) == ([], [], [])
    _assert_loaded_all(model, sd)


def test_ignored_buffers_are_not_unexpected(jax_ckpt):
    sd = _sd(jax_ckpt)
    sd["text_encoder.text_model.embeddings.position_ids"] = torch.arange(77)[None]
    sd["vae.encoder.norm.num_batches_tracked"] = torch.tensor(3)
    report = loader.load_into_module(_tiny_model(), sd)
    assert sorted(report.ignored) == ["text_encoder.text_model.embeddings.position_ids",
                                      "vae.encoder.norm.num_batches_tracked"]
    assert (report.missing, report.unexpected, report.mismatched) == ([], [], [])


def test_mismatched_shape_is_reported_not_loaded(jax_ckpt):
    sd = _sd(jax_ckpt)
    key = "unet.conv_in.weight"
    sd[key] = torch.ones(16, 4, 3, 3)
    sd["unet.no_such_layer.weight"] = torch.ones(3)
    del sd["vae.quant_conv.bias"]
    model = _tiny_model()
    before = model.state_dict()[key].clone()
    report = loader.load_into_module(model, sd)
    assert report.mismatched == [(key, (16, 8, 3, 3), (16, 4, 3, 3))]
    assert report.unexpected == ["unet.no_such_layer.weight"]
    # as in the JAX loader, a leaf that did not load is also missing
    assert sorted(report.missing) == [key, "vae.quant_conv.bias"]
    torch.testing.assert_close(model.state_dict()[key], before, rtol=0, atol=0)
    assert "mismatched=1" in report.summary()


@pytest.mark.parametrize("wrap_key", loader._PTH_KEYS + (None,))
def test_pth_is_unwrapped(jax_ckpt, tmp_path, wrap_key):
    sd = _sd(jax_ckpt)
    obj = sd if wrap_key is None else {wrap_key: sd, "epoch": 3}
    path = str(tmp_path / "SDMatte.pth")
    torch.save(obj, path)
    model = _tiny_model()
    report = loader.load_sdmatte_checkpoint(model, path)
    assert (report.missing, report.unexpected, report.mismatched) == ([], [], [])
    _assert_loaded_all(model, sd)


def test_load_casts_into_the_parameter_dtype(jax_ckpt):
    sd = _sd(jax_ckpt)
    model = _tiny_model().to(torch.bfloat16)
    report = loader.load_into_module(model, sd)
    assert not report.missing
    for k, v in model.state_dict().items():
        assert v.dtype == torch.bfloat16
        torch.testing.assert_close(v, sd[k].to(torch.bfloat16), rtol=0, atol=0)


DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int8,
          torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool,
          torch.float8_e4m3fn, torch.float8_e5m2]


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in (("a.weight", (3, 5, 2)), ("b", (7,)), ("scalar", ()), ("empty", (0, 4))):
        x = torch.randn(shape, generator=g) * 50
        out[name] = x > 0 if dtype == torch.bool else x.to(dtype)
    return out


def _bytes(t):
    return t.reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_writer_is_read_by_safetensors(tmp_path, dtype):
    t = _tensors(dtype)
    path = str(tmp_path / "ours.safetensors")
    size = safetensors_io.write(t, path)
    assert size == os.path.getsize(path)
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
    back = st_load(path)
    assert back.keys() == t.keys()
    for k in t:
        assert back[k].dtype == dtype and back[k].shape == t[k].shape
        assert torch.equal(_bytes(back[k]), _bytes(t[k]))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_reader_reads_safetensors(tmp_path, dtype):
    t = _tensors(dtype, seed=1)
    path = str(tmp_path / "theirs.safetensors")
    st_save(t, path, metadata={"format": "pt"})
    ours = safetensors_io.read(path)
    assert list(ours) == list(st_load(path))
    for k in t:
        assert ours[k].dtype == dtype and ours[k].shape == t[k].shape
        assert torch.equal(_bytes(ours[k]), _bytes(t[k]))


def test_reader_views_are_writable_and_private(tmp_path):
    path = str(tmp_path / "x.safetensors")
    safetensors_io.write({"w": torch.arange(6, dtype=torch.float32)}, path)
    first = safetensors_io.read(path)["w"]
    first.add_(1)                      # copy-on-write: the file is untouched
    assert torch.equal(safetensors_io.read(path)["w"], torch.arange(6, dtype=torch.float32))


def test_reader_rejects_a_bad_file(tmp_path):
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(b"\x05\x00")
    with pytest.raises(safetensors_io.SafetensorsError):
        safetensors_io.read(str(bad))
    hdr = json.dumps({"w": {"dtype": "F32", "shape": [4], "data_offsets": [0, 8]}}).encode()
    bad.write_bytes(len(hdr).to_bytes(8, "little") + hdr + b"\x00" * 8)
    with pytest.raises(safetensors_io.SafetensorsError, match="offsets"):
        safetensors_io.read(str(bad))


def test_save_checkpoint_round_trip(tmp_path):
    torch.manual_seed(0)
    model = _tiny_model()
    path = str(tmp_path / "SDMatte.safetensors")
    save_checkpoint(model, path, dtype=torch.bfloat16,
                    rename=lambda k: "module." + k.replace(".attentions.0.to_q.", ".attentions.0.query."))
    back = _tiny_model().to(torch.bfloat16)
    report = loader.load_sdmatte_checkpoint(back, path)
    assert (report.missing, report.unexpected, report.mismatched) == ([], [], [])
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v.to(torch.bfloat16)), k


@pytest.mark.parametrize("cfg_name", ["default", "tiny"])
def test_manifest_matches_jax(cfg_name):
    tiny = cfg_name == "tiny"
    jcfg = jax_configs.SDMatteConfig.tiny() if tiny else jax_configs.SDMatteConfig()
    cfg = configs.SDMatteConfig.tiny() if tiny else configs.SDMatteConfig()
    ours = manifest.expected_keys(cfg)
    assert ours == jax_manifest.expected_keys(jcfg)
    assert manifest.legacy_vae_attn_variant(ours) == jax_manifest.legacy_vae_attn_variant(ours)
    assert manifest.clip_keys(cfg.clip) == jax_manifest.clip_keys_manual(jcfg.clip)


def test_manifest_matches_the_frozen_file_and_the_module():
    frozen = {k: tuple(v) for k, v in json.loads(FROZEN_MANIFEST.read_text()).items()}
    ours = manifest.expected_keys(configs.SDMatteConfig())
    assert ours == frozen
    with torch.device("meta"):
        model = SDMatte(configs.SDMatteConfig())
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == ours
    assert list(model.state_dict())[:2] == ["vae.encoder.conv_in.weight",
                                            "vae.encoder.conv_in.bias"]
    assert list(model.state_dict())[-1].startswith("text_encoder.")


def _write_config_dir(base, nested=False, head_dim=(5, 10, 20, 20)):
    def put(sub, name, d):
        p = base / sub / sub if nested else base / sub
        p.mkdir(parents=True, exist_ok=True)
        (p / name).write_text(json.dumps(d))
    put("vae", "config.json", {"block_out_channels": [64, 128], "layers_per_block": 1,
                               "norm_num_groups": 16, "scaling_factor": 0.2})
    put("unet", "config.json", {"block_out_channels": [32, 64, 64, 64],
                                "attention_head_dim": head_dim, "cross_attention_dim": 64,
                                "in_channels": 4, "norm_num_groups": 8})
    put("text_encoder", "config.json", {"hidden_size": 64, "num_hidden_layers": 3,
                                        "num_attention_heads": 2, "intermediate_size": 128,
                                        "vocab_size": 500, "hidden_act": "quick_gelu"})
    put("scheduler", "scheduler_config.json", {"num_train_timesteps": 500,
                                               "beta_schedule": "linear", "unknown": 1})


@pytest.mark.parametrize("layout", ["direct", "nested", "int_head_dim", "no_scheduler"])
def test_config_dir_parses_as_jax(tmp_path, layout):
    _write_config_dir(tmp_path, nested=layout == "nested",
                      head_dim=8 if layout == "int_head_dim" else (5, 10, 20, 20))
    if layout == "no_scheduler":
        (tmp_path / "scheduler" / "scheduler_config.json").unlink()
    ours = configs.SDMatteConfig.from_pretrained_dir(str(tmp_path))
    ref = jax_configs.SDMatteConfig.from_pretrained_dir(str(tmp_path))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    if layout == "int_head_dim":
        assert ours.unet.attention_head_dim == (8, 8, 8, 8)


def test_saved_config_dir_round_trips(tmp_path):
    cfg = configs.SDMatteConfig()
    configs.save_pretrained_dir(cfg, str(tmp_path))
    assert configs.SDMatteConfig.from_pretrained_dir(str(tmp_path)) == cfg
    assert jax_configs.SDMatteConfig.from_pretrained_dir(str(tmp_path)) == jax_configs.SDMatteConfig()
    unet = json.loads((tmp_path / "unet" / "config.json").read_text())
    assert unet["_class_name"] == "UNet2DConditionModel"
    assert unet["attention_head_dim"] == [5, 10, 20, 20]
