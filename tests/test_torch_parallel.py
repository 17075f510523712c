"""The port's checkpoints, video path, meshes and fine-tune entry point
(sdmatte_tpu_torch/parallel/{checkpointing,video,mesh}.py, finetune.py)
against the JAX package's on the tiny config, fp32, on the CPU.

  * a train-state checkpoint round-trips bit for bit
  * the fine-tune's export loads through the port's loader with nothing
    missing or unexpected, and the JAX package's loader reads it into the
    same parameters
  * matte_video meets the JAX package's at MAE <= 1e-4
    (tests/test_assembled_parity.py's whole-model bar)
  * over two gloo processes (torch.multiprocessing), video equals the
    one-process call and the mesh helpers split, gather and broadcast as
    the JAX package's shardings do
"""

import os
import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sdmatte_tpu.checkpoint import loader as jax_loader
from sdmatte_tpu.configs import SDMatteConfig as JaxSDMatteConfig
from sdmatte_tpu.models import sdmatte as jax_sdmatte
from sdmatte_tpu.parallel.video import matte_video as jax_matte_video
from test_torch_models import _randomized_params

from sdmatte_tpu_torch import finetune
from sdmatte_tpu_torch.checkpoint import load_sdmatte_checkpoint
from sdmatte_tpu_torch.checkpoint.convert import load_params, params_to_state_dict
from sdmatte_tpu_torch.configs import SDMatteConfig
from sdmatte_tpu_torch.models.sdmatte import SDMatte
from sdmatte_tpu_torch.parallel import checkpointing, mesh, train
from sdmatte_tpu_torch.parallel.data import CompositeSampler
from sdmatte_tpu_torch.parallel.video import matte_video


@pytest.fixture(scope="module")
def tiny():
    params = jax.tree_util.tree_map(np.asarray, _randomized_params(JaxSDMatteConfig.tiny(), seed=6))
    return params, load_params(SDMatte(SDMatteConfig.tiny()), params).eval()


def _clip(t=4, s=64, seed=0):
    """A synthetic clip, NHWC numpy in [-1, 1]: a soft disk moving across a
    gradient, and its trimaps."""
    yy, xx = np.mgrid[0:s, 0:s] / s
    frames, tris = [], []
    for i in range(t):
        r = np.hypot(yy - 0.5, xx - 0.3 - 0.1 * i)
        a = np.clip((0.25 - r) / 0.05 + 0.5, 0, 1)
        img = np.stack([a * 0.8 + (1 - a) * yy, a * 0.3 + (1 - a) * xx, 0.5 + 0 * a], -1)
        frames.append(img * 2 - 1)
        tris.append(np.where(a >= 1, 1.0, np.where(a <= 0, -1.0, 0.0))[..., None])
    rng = np.random.default_rng(seed)
    frames = np.asarray(frames) + rng.normal(0, 0.02, np.shape(frames))
    return frames.astype(np.float32), np.asarray(tris, np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# ------------------------------------------------------------ checkpoints ---

def test_train_state_round_trip_is_bit_identical(tiny, tmp_path):
    params, _ = tiny
    model = load_params(SDMatte(SDMatteConfig.tiny()), params)
    state = train.init_train_state(model, 1e-3)
    train.train_step(state, _batch(2))       # the optimizer holds moments now
    ema = load_params(SDMatte(SDMatteConfig.tiny()), params)
    d = str(tmp_path / "ckpts")
    checkpointing.save_train_state(d, 3, state, ema=ema)
    path = checkpointing.save_train_state(d, 7, state, ema=ema)
    assert os.path.basename(path) == "step_00000007"
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000007"]   # no temporaries
    assert checkpointing.latest_step(d) == 7
    step, sd, opt_sd, ema_sd = checkpointing.restore_train_state(d, with_ema=True)
    assert step == 7
    for k, v in model.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    for k, v in ema.state_dict().items():
        torch.testing.assert_close(ema_sd[k], v, rtol=0, atol=0)
    ref = state.optimizer.state_dict()
    assert opt_sd["param_groups"] == ref["param_groups"]
    assert opt_sd["state"].keys() == ref["state"].keys() and len(ref["state"]) > 0
    for i, s in ref["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(opt_sd["state"][i][k], v, rtol=0, atol=0)
    # the restored state resumes into a fresh model and optimizer
    fresh = SDMatte(SDMatteConfig.tiny())
    fresh.load_state_dict(sd)
    resumed = train.init_train_state(fresh, 1e-3)
    resumed.optimizer.load_state_dict(opt_sd)
    assert checkpointing.restore_train_state(d, step=3)[0] == 3
    assert len(checkpointing.restore_train_state(d)) == 3


def test_latest_step_without_checkpoints(tmp_path):
    assert checkpointing.latest_step(str(tmp_path / "none")) is None
    (tmp_path / ".step_00000009.123.tmp").write_bytes(b"")
    assert checkpointing.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        checkpointing.restore_train_state(str(tmp_path))


def _batch(b, size=64, seed=1):
    from sdmatte_tpu_torch.parallel.data import to_tensors
    return to_tensors(CompositeSampler(size=size, seed=seed).batch(b))


def test_finetune_writes_what_both_loaders_read(tmp_path, monkeypatch):
    """``python -m sdmatte_tpu_torch.finetune --tiny --cpu --steps 4
    --ema-decay 0.9``: checkpoints at steps 2 and 4 and an export of the EMA
    weights, which the port's loader and the JAX package's read into the
    same parameters (the JAX side through the ``safetensors`` package: the
    native reader's views outlive their mapping)."""
    from sdmatte_tpu.runtime import fast_safetensors

    def unavailable(path):
        raise OSError("the native reader is not used here")

    monkeypatch.setattr(fast_safetensors, "read", unavailable)
    out = tmp_path / "ft"
    assert finetune.main(["--tiny", "--cpu", "--steps", "4", "--ema-decay", "0.9",
                          "--out", str(out)]) == 0
    assert checkpointing.latest_step(str(out / "ckpts")) == 4
    assert sorted(os.listdir(out / "ckpts")) == ["step_00000002", "step_00000004"]
    export = str(out / "finetuned.safetensors")
    _, _, _, ema_sd = checkpointing.restore_train_state(str(out / "ckpts"), with_ema=True)

    ours = SDMatte(SDMatteConfig.tiny())
    report = load_sdmatte_checkpoint(ours, export)
    assert report.missing == [] and report.unexpected == [] and report.mismatched == []
    for k, v in ours.state_dict().items():
        torch.testing.assert_close(v, ema_sd[k], rtol=0, atol=0)

    theirs, jreport = jax_loader.load_sdmatte_checkpoint(
        jax_sdmatte.init(JaxSDMatteConfig.tiny(), seed=11), export)
    assert jreport.missing == [] and jreport.unexpected == []
    jax_sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, theirs))
    assert jax_sd.keys() == ema_sd.keys()
    for k, v in jax_sd.items():
        torch.testing.assert_close(v, ema_sd[k], rtol=0, atol=0)


def test_finetune_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert finetune.main(["--tiny", "--steps", "1", "--out", str(tmp_path)]) == 2
    assert not (tmp_path / "ckpts").exists()


# ------------------------------------------------------------------ video ---

def test_matte_video_matches_jax(tiny):
    params, model = tiny
    frames, tris = _clip(t=4)
    ref = np.asarray(jax_matte_video(params, JaxSDMatteConfig.tiny(), frames, tris,
                                     attn_impl="xla"))
    got = matte_video(model, _nchw(frames), _nchw(tris))
    assert got.shape == (4, 1, 64, 64) and got.dtype == torch.float32
    mae = float(np.abs(got.permute(0, 2, 3, 1).numpy() - ref).mean())
    assert mae <= 1e-4, mae


# ------------------------------------------------------------------ mesh ---

def test_distributed_init_is_a_noop_without_the_environment(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
                 "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert mesh.distributed_init() is False
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="distributed_init"):
        mesh.make_mesh()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_worker(rank, world, port, inputs, out_dir):
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank))
    assert mesh.distributed_init(backend="gloo")
    try:
        blob = torch.load(inputs, weights_only=False)
        m = mesh.make_mesh()
        model = SDMatte(SDMatteConfig.tiny())
        model.load_state_dict(blob["state"])
        alpha = matte_video(model, blob["frames"], blob["trimaps"], mesh=m)
        x = torch.arange(12.0).reshape(6, 2)
        sharded = mesh.shard_batch({"x": x, "l": [x + 1]}, m)
        # rank 1 starts from other weights; replicate makes them rank 0's
        other = SDMatte(SDMatteConfig.tiny())
        if rank == 1:
            with torch.no_grad():
                for p in other.parameters():
                    p.add_(1.0)
        mesh.replicate(other, m)
        hybrid = mesh.make_hybrid_mesh(n_hosts=2, devices_per_host=1)
        try:
            mesh.make_hybrid_mesh(n_hosts=2, devices_per_host=2)
            uneven = None
        except ValueError as e:
            uneven = str(e)
        torch.save({"alpha": alpha, "x": sharded["x"], "l": sharded["l"][0],
                    "axes": mesh.data_axes(m), "hybrid_axes": mesh.data_axes(hybrid),
                    "hybrid_index": mesh.data_index(hybrid), "uneven": uneven,
                    "replicated": other.state_dict()},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world2(tiny, tmp_path_factory):
    _, model = tiny
    frames, tris = _clip(t=4, seed=1)
    d = tmp_path_factory.mktemp("mesh")
    inputs = str(d / "inputs.pt")
    torch.save({"state": model.state_dict(), "frames": _nchw(frames), "trimaps": _nchw(tris)},
               inputs)
    torch.multiprocessing.spawn(_mesh_worker, args=(2, _free_port(), inputs, str(d)),
                                nprocs=2, join=True)
    out = [torch.load(str(d / f"rank{r}.pt"), weights_only=False) for r in range(2)]
    return out, matte_video(model, _nchw(frames), _nchw(tris))


def test_video_over_two_processes_matches_one(world2):
    """Each process mattes its two frames; the gathered alphas, in frame
    order, are the one-process call's, to 1e-5 (the same math at batch 2
    and batch 4, tests/test_torch_meta_paths.py's identity bar)."""
    out, single = world2
    for r in out:
        torch.testing.assert_close(r["alpha"], single, atol=1e-5, rtol=0)


def test_mesh_helpers_over_two_processes(world2):
    out, _ = world2
    x = torch.arange(12.0).reshape(6, 2)
    for rank, r in enumerate(out):
        torch.testing.assert_close(r["x"], x[3 * rank:3 * rank + 3], rtol=0, atol=0)
        torch.testing.assert_close(r["l"], x[3 * rank:3 * rank + 3] + 1, rtol=0, atol=0)
        assert r["axes"] == ("data",) and r["hybrid_axes"] == ("dcn", "data")
        assert r["hybrid_index"] == rank
        assert "cover every process exactly" in r["uneven"]
    for k, v in out[0]["replicated"].items():
        torch.testing.assert_close(out[1]["replicated"][k], v, rtol=0, atol=0)
