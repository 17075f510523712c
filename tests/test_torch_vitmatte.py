"""ViTMatte in the port (models/vitmatte.py, pipeline/vitmatte.py) and K1's
relative-position mode, held to the benchmark's plain reference
(matbench/reference/vitmatte_ref.py, the one copy) and to transformers'
``VitMatteForImageMatting``.

On the CPU the port runs its plain path in fp32 at ``ViTMatteConfig.tiny()``,
which keeps every kind of block (block 0 in 4 x 4 windows, block 1 global
with the residual bottleneck, rel-pos tables in both), on a 75 x 100 photo:
padded to 96 x 128, a 6 x 8 token grid (kh != kw), windows ragged (6 -> 8),
the global tables resized (7 -> 11 and 15 rows).  Bars: 5e-5 a block and
MAE <= 1e-4 for the whole call.  The ``cuda`` cases run K1's mode at the
main path's shapes and skip without a card; on the card run
``python -m pytest tests/test_torch_vitmatte.py -m cuda``.
"""

from __future__ import annotations

import dataclasses
import importlib
import os

import pytest
import torch

from matbench import weights
from matbench.reference import vitmatte_ref as ref
from sdmatte_tpu_torch.configs import ViTMatteConfig
from sdmatte_tpu_torch.core.dtypes import BF16, FP32
from sdmatte_tpu_torch.models.vitmatte import ViTMatte
from sdmatte_tpu_torch.ops.flash_attention import (PLAIN_BLOCK_ELEMS, RelPos, attention_plain,
                                                   flash_attention, relpos_fits)
from sdmatte_tpu_torch.pipeline.vitmatte import ViTMatteOptions, ViTMattePipeline
from sdmatte_tpu_torch.utils.observability import METRICS

attention_mod = importlib.import_module("sdmatte_tpu_torch.ops.attention")
CPU = torch.device("cpu")
OPTIONS = {"output_mode": "alpha_only", "mask_refine": True, "trimap_constraint": 0.8,
           "is_transparent": False}


def conf_of(cfg: ViTMatteConfig) -> dict:
    """A benchmark configuration's form of ``cfg``."""
    return dict(cfg.to_dict(), name="vitmatte-test", architecture="vitmatte",
                pipeline={"weight_storage": "fp"})


def seeded(cfg: ViTMatteConfig, seed: int = 7, device=CPU):
    """The benchmark's seeded weights of ``cfg`` (fp32) and a model holding them."""
    conf = conf_of(cfg)
    params = weights.make_params(conf, seed, device, torch.float32)
    model = ViTMatte(cfg)
    model.load_state_dict(params, strict=True)
    return conf, params, model


def photo(h=75, w=100, seed=1):
    g = torch.Generator().manual_seed(seed)
    img = torch.rand(h, w, 3, generator=g)
    tri = torch.randint(0, 3, (h, w), generator=g).float() / 2
    return img, tri


# ----------------------------------------------------- against the reference ---

def test_blocks_match_the_reference():
    """Patch embedding, each block and the decoder, each from the same input."""
    cfg = ViTMatteConfig.tiny()
    conf, params, model = seeded(cfg)
    img, tri = photo()
    x = ref.inputs(img[None], tri[None])
    assert tuple(x.shape) == (1, 4, 96, 128)
    with torch.no_grad():
        tabs = model.position_tables(6, 8, torch.float32)
        t = torch.nn.functional.conv2d(x, params["backbone.embeddings.projection.weight"],
                                       params["backbone.embeddings.projection.bias"],
                                       stride=16).permute(0, 2, 3, 1)
        s = ref._sizes(conf)
        for i, layer in enumerate(model.backbone.encoder.layer):
            got = layer(t, *tabs.relative[i], policy=FP32, impl="auto")
            want = ref.block(params, conf, i, t, s)
            torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-5)
            t = want
        feats = ref.backbone(params, conf, x)
        torch.testing.assert_close(model.backbone_forward(x), feats, atol=5e-5, rtol=5e-5)
        torch.testing.assert_close(model.decoder_forward(feats, x),
                                   ref.decoder(params, conf, feats, x), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("output_mode", ["alpha_only", "matted_rgba"])
def test_whole_call_matches_the_reference(output_mode):
    cfg = ViTMatteConfig.tiny()
    conf, params, model = seeded(cfg)
    pipe = ViTMattePipeline(model, device="cpu")
    img, tri = photo()
    alpha, matted = pipe(img, tri, options=ViTMatteOptions(output_mode=output_mode))
    ra, rm = ref.answer(params, conf, img, tri, dict(OPTIONS, output_mode=output_mode))
    assert alpha.shape == (1, 75, 100) and matted.shape[:3] == (1, 75, 100)
    assert float((alpha[0] - ra).abs().mean()) <= 1e-4
    assert float((matted[0] - rm).abs().mean()) <= 1e-4
    assert 0.05 < float(ra.mean()) < 0.95       # the refinement left something to compare


def test_tables_are_made_once_per_grid():
    cfg = ViTMatteConfig.tiny()
    _, _, model = seeded(cfg)
    pipe = ViTMattePipeline(model, device="cpu")
    img, tri = photo()
    before = METRICS.counters.get("vitmatte.tables_built", 0)
    for _ in range(2):
        pipe(img, tri)
    pipe(img.transpose(0, 1), tri.t())           # the other orientation: one more grid
    assert METRICS.counters.get("vitmatte.tables_built", 0) - before == 2
    pipe.model.load_state_dict(pipe.model.state_dict())
    pipe(img, tri)
    assert METRICS.counters.get("vitmatte.tables_built", 0) - before == 3


def test_int8_storage_is_the_references_stored_weights():
    """The control's path: weight_storage="int8" against the reference on
    ``stored`` weights (the same quantization, worked out again)."""
    cfg = dataclasses.replace(ViTMatteConfig.tiny(), hidden_size=128)   # fc1, fc2, the patch embedding
    conf, params, model = seeded(cfg)
    conf["pipeline"] = {"weight_storage": "int8"}
    pipe = ViTMattePipeline(model, device="cpu", weight_storage="int8")
    img, tri = photo()
    alpha, _ = pipe(img, tri)
    ra, _ = ref.answer(ref.stored(params, conf), conf, img, tri, OPTIONS)
    assert float((alpha[0] - ra).abs().mean()) <= 1e-4
    big = {n for n, w in params.items() if n.endswith(".weight") and w.numel() >= 1 << 16}
    assert {n for n, _ in pipe.model.named_buffers() if n.endswith("weight_i8")} == \
        {n.replace(".weight", ".weight_i8") for n in big} and len(big) == 5


def test_reference_matches_transformers():
    """The reference against transformers' ``VitMatteForImageMatting`` on the
    same seeded weights (the installed transformers, built from its config
    classes: nothing is downloaded)."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    cfg = ViTMatteConfig.tiny()
    conf, params, _ = seeded(cfg)
    d = cfg.to_dict()
    bb = transformers.VitDetConfig(**{k: v for k, v in d["backbone_config"].items()
                                      if k != "model_type"})
    tcfg = transformers.VitMatteConfig(backbone_config=bb, hidden_size=d["hidden_size"],
                                       convstream_hidden_sizes=d["convstream_hidden_sizes"],
                                       fusion_hidden_sizes=d["fusion_hidden_sizes"],
                                       batch_norm_eps=d["batch_norm_eps"])
    model = transformers.VitMatteForImageMatting(tcfg).eval()
    missing, unexpected = model.load_state_dict(params, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    img, tri = photo()
    x = ref.inputs(img[None], tri[None])
    with torch.no_grad():
        want = model(pixel_values=x).alphas
    torch.testing.assert_close(ref.model_alpha(params, conf, x), want, atol=2e-6, rtol=1e-5)


def test_state_dict_is_transformers_at_the_published_config():
    """Names and shapes at ``hustvl/vitmatte-base-composition-1k``'s config
    equal transformers' (both on the meta device), but for the BatchNorm
    counters the port drops; 96.7 M values, as the reference's table."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    cfg = ViTMatteConfig()
    d = cfg.to_dict()
    bb = transformers.VitDetConfig(**{k: v for k, v in d["backbone_config"].items()
                                      if k != "model_type"})
    with torch.device("meta"):
        theirs = transformers.VitMatteForImageMatting(
            transformers.VitMatteConfig(backbone_config=bb, hidden_size=768)).state_dict()
        ours = ViTMatte(cfg).state_dict()
    theirs = {k: tuple(v.shape) for k, v in theirs.items()
              if not k.endswith("num_batches_tracked")}
    assert {k: tuple(v.shape) for k, v in ours.items()} == theirs
    assert {n: s for n, s, _ in ref.param_table(conf_of(cfg))} == theirs
    total = sum(v.numel() for v in ours.values())
    assert len(ours) == 250 and 96.6e6 < total < 96.8e6


def test_checkpoint_names_load_with_no_mapping(tmp_path):
    from sdmatte_tpu_torch.checkpoint import load_vitmatte_checkpoint, safetensors_io
    cfg = ViTMatteConfig.tiny()
    _, params, _ = seeded(cfg)
    file = tmp_path / "model.safetensors"
    counters = {k.replace("running_var", "num_batches_tracked"): torch.tensor(3)
                for k in params if k.endswith("running_var")}
    safetensors_io.write({**params, **counters}, str(file))
    model = ViTMatte(cfg)
    report = load_vitmatte_checkpoint(model, str(file))
    assert report.loaded == len(params) and not report.missing and not report.unexpected
    assert sorted(report.ignored) == sorted(counters)
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k]), k


# ----------------------------------------------------- K1's relative mode ---

def materialised(q, k, v, scale, rel):
    """Scores with the whole (Lq, Lk) bias formed from the terms by index."""
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    key = torch.arange(lk)
    rh = rel.rh.view(b, h, lq, -1)[..., key // rel.kw]
    rw = rel.rw.view(b, h, lq, -1)[..., key % rel.kw]
    s = q.float() @ k.float().transpose(-1, -2) * scale + rh + rw
    return (torch.softmax(s, -1) @ v.float()).to(v.dtype)


@pytest.mark.parametrize("block", [PLAIN_BLOCK_ELEMS, 1000])
@pytest.mark.parametrize("grid", [(6, 8), (5, 3)])
def test_relpos_plain_matches_a_materialised_bias(monkeypatch, block, grid):
    import sdmatte_tpu_torch.ops.flash_attention as fa
    monkeypatch.setattr(fa, "PLAIN_BLOCK_ELEMS", block)
    g = torch.Generator().manual_seed(4)
    b, h, d = 2, 3, 16
    n = grid[0] * grid[1]
    q, k, v = (torch.randn(b, h, n, d, generator=g) for _ in range(3))
    th, tw = torch.randn(grid[0], grid[0], d, generator=g), torch.randn(grid[1], grid[1], d,
                                                                         generator=g)
    rel = attention_mod.relpos_terms(q, th, tw)
    assert rel.rh.shape == (b * h, n, grid[0]) and rel.rw.shape == (b * h, n, grid[1])
    qg = q.view(b, h, grid[0], grid[1], d)
    row, col = torch.arange(n) // grid[1], torch.arange(n) % grid[1]
    torch.testing.assert_close(rel.rh.view(b, h, n, -1),
                               torch.einsum("bhnc,nkc->bhnk", q, th[row]), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rel.rw.view(b, h, n, -1),
                               torch.einsum("bhnc,nkc->bhnk", q, tw[col]), atol=1e-5, rtol=1e-5)
    assert qg.shape[2:4] == grid
    got = attention_plain(q, k, v, scale=d ** -0.5, rel=rel)
    torch.testing.assert_close(got, materialised(q, k, v, d ** -0.5, rel), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(flash_attention(q, k, v, scale=d ** -0.5, rel=rel), got)


@pytest.mark.parametrize("grid", [(6, 8), (15, 20), (10, 420), (4, 4)])
def test_relpos_key_order_does_not_change_the_attention(grid):
    """The wrapper's column-major form of a grid K1 does not take row-major
    (K and V in column order, the terms swapped, kw the grid's height)
    computes the same attention."""
    b, h, d = 1, 2, 16
    kh, kw = grid
    n = kh * kw
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(b, h, n, d, generator=g) for _ in range(3))
    rel = RelPos(torch.randn(b * h, n, kh, generator=g), torch.randn(b * h, n, kw, generator=g),
                 kw)
    kc, vc = (t.reshape(b, h, kh, kw, d).transpose(2, 3).reshape(b, h, n, d) for t in (k, v))
    torch.testing.assert_close(attention_plain(q, kc, vc, scale=d ** -0.5,
                                               rel=RelPos(rel.rw, rel.rh, kh)),
                               attention_plain(q, k, v, scale=d ** -0.5, rel=rel),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,fits", [(14, True), (190, True), (252, True), (392, True),
                                     (394, False), (420, False), (6, False), (15, False)])
def test_relpos_key_grids_the_kernel_takes(cuda, kw, fits):
    """kw even and >= 8, Rw within shared memory (csrc rel_fits, which the
    built library answers): a 12 MP photo's grids (190, 252) and the 14 x 14
    windows go row-major."""
    assert relpos_fits(kw) is fits


@pytest.mark.parametrize("kw", [8, 14, 20, 190, 252])
def test_relpos_tile_walk(kw):
    """The kernel's walk over a tile's keys (csrc fa3_softmax_rel): one
    division at the tile's start, then 8 keys on per step with at most one
    row end, lands on each key's (row - tile's first row, column), and the
    rows stay within the staged ring (127 / kw + 2)."""
    nr = 127 // kw + 2
    for k0 in range(0, 4 * 128 * kw, 128):
        for tig in range(4):
            key = k0 + 2 * tig
            r, c = key // kw, key % kw
            r -= k0 // kw
            for jj in range(16):
                if jj:
                    c += 8
                    if c >= kw:
                        c, r = c - kw, r + 1
                key = k0 + 8 * jj + 2 * tig
                assert (r, c) == (key // kw - k0 // kw, key % kw)
                assert r < nr and c + 1 < kw        # the pair shares its row


@pytest.mark.parametrize("kw", [8, 14, 190, 252, 392])
def test_relpos_rw_staging_walk(kw):
    """The consumers' walk over their warpgroup's 64 Rw rows (csrc fa3_fwd,
    mode 2): thread tw takes pairs tw, tw + 128, ... in batches, stepping
    (row, column) by (128 // kw2, 128 % kw2) with at most one carry, and
    lands on each pair's divmod; every pair is taken once."""
    kw2, batch = kw // 2, 8
    n, di, dc = 64 * kw2, 128 // kw2, 128 % kw2
    seen = []
    for tw in range(128):
        i0, c0 = divmod(tw, kw2)
        for e0 in range(tw, n, 128 * batch):
            i, c2 = i0, c0
            for t in range(batch):
                if e0 + 128 * t < n:
                    assert (i, c2) == divmod(e0 + 128 * t, kw2)
                    seen.append(e0 + 128 * t)
                i, c2 = i + di, c2 + dc
                if c2 >= kw2:
                    i, c2 = i + 1, c2 - kw2
            i0, c0 = i, c2
    assert sorted(seen) == list(range(n))


def test_launches_a_matte_at_the_published_config(monkeypatch):
    """On the meta device: 12 K1 launches (four global over the grid, eight
    over all of a block's windows at once), at a 12 MP photo's shapes."""
    calls = []

    def count(q, k, v, *, scale, bias=None, rel=None):
        calls.append((tuple(q.shape), rel.rh.shape[-1], rel.kw))
        return torch.empty_like(q)

    import sdmatte_tpu_torch.models.vitmatte as vm
    monkeypatch.setattr(attention_mod, "flash_attention", count)
    with torch.device("meta"):
        model = ViTMatte(ViTMatteConfig())
    x = torch.empty((1, 4, 3040, 4032), device="meta", dtype=torch.bfloat16)
    model.forward(x, policy=BF16)
    assert vm.attention is attention_mod.attention
    glob = [(1, 12, 47880, 64), 190, 252]
    win = [(252, 12, 196, 64), 14, 14]
    assert [list(c) for c in calls] == [win, win, glob] * 4


# ------------------------------------------------------------- on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the hand kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bar(got, want):
    """K1's bf16 bar of tests/test_torch_kernels.py: max|got - want| <= 2e-2
    * max|want|."""
    err = float((got.float() - want.float()).abs().max())
    bar = 2e-2 * float(want.float().abs().max())
    assert err <= bar, f"max |got - want| {err} > {bar} (2e-2 * max|want|)"
    return err, bar


@pytest.mark.cuda
@pytest.mark.parametrize("bh,grid", [((1, 12), (190, 252)), ((1, 12), (252, 190)),
                                     ((252, 12), (14, 14)), ((2, 3), (15, 20)),
                                     ((1, 2), (10, 420))])
def test_k1_relpos_matches_plain(cuda, bh, grid):
    """The main path's shapes (a 12 MP photo's global grid both ways, a
    windowed block's 252 windows) and two ragged ones (a grid wider than
    Rw's room goes column-major), on q, k, v sliced from one qkv tensor as
    the model's are."""
    b, h = bh
    n, d = grid[0] * grid[1], 64
    g = torch.Generator(device=cuda).manual_seed(11)
    qkv = torch.randn(b, n, 3, h, d, generator=g, device=cuda).bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    rel = RelPos(torch.randn(b * h, n, grid[0], generator=g, device=cuda),
                 torch.randn(b * h, n, grid[1], generator=g, device=cuda), grid[1])
    before = METRICS.counters.get("attention.relpos_launches", 0)
    got = flash_attention(q, k, v, scale=d ** -0.5, rel=rel)
    torch.cuda.synchronize()
    assert METRICS.counters.get("attention.relpos_launches", 0) == before + 1
    err, bar = _bar(got, attention_plain(q, k, v, scale=d ** -0.5, rel=rel))
    print(f"relpos {b}x{h} grid {grid}: max err {err:.3e}, bar {bar:.3e}")


@pytest.mark.cuda
def test_pipeline_on_the_card_matches_its_plain_path(cuda):
    """A small ViTMatte with d = 64 heads, bf16, through the graphs and K1
    against the same pipeline on the plain versions; replays equal the
    eager first call."""
    from sdmatte_tpu_torch.configs import ViTMatteConfig as C
    cfg = C(hidden_size=128, num_hidden_layers=3, num_attention_heads=2, image_size=128,
            window_block_indices=(0,), residual_block_indices=(1, 2),
            convstream_hidden_sizes=(8, 12, 16), fusion_hidden_sizes=(16, 12, 8, 8))
    _, _, model = seeded(cfg, device=CPU)
    img, tri = photo(300, 460)
    fast = ViTMattePipeline(model, policy=BF16, device=cuda)
    plain = ViTMattePipeline(model, policy=BF16, device=cuda, impl="plain")
    first = fast(img, tri)[0]
    again = fast(img, tri)[0]
    want = plain(img, tri)[0]
    assert torch.equal(first, again)
    assert float((first - want).abs().mean()) < 2e-3


def test_cli_runs_vitmatte_at_the_photos_size(tmp_path, capsys):
    """``--model vitmatte --tiny --cpu``: a 75 x 100 photo in, a 75 x 100 alpha
    PNG out; SDMatte's prompt options are refused."""
    import numpy as np
    from PIL import Image
    from sdmatte_tpu_torch import cli
    img, tri = photo()
    Image.fromarray((img.numpy() * 255).astype(np.uint8)).save(tmp_path / "in.png")
    Image.fromarray((tri.numpy() * 255).astype(np.uint8)).save(tmp_path / "tri.png")
    base = ["--model", "vitmatte", "--image", str(tmp_path / "in.png"),
            "--trimap", str(tmp_path / "tri.png"), "--out", str(tmp_path / "alpha.png"),
            "--cpu", "--tiny"]
    assert cli.main(base + ["--matted-out", str(tmp_path / "m.png"), "--mode", "matted_rgba"]) == 0
    assert Image.open(tmp_path / "alpha.png").size == (100, 75)
    assert Image.open(tmp_path / "m.png").size == (100, 75)
    with pytest.raises(SystemExit):
        cli.main(base + ["--coords", "0,0,1,1"])
    with pytest.raises(SystemExit):
        cli.main(base[:-1] + ["--ckpt", str(tmp_path / "none.safetensors")])
