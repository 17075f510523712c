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
                                                   flash_attention, tma_rows)
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
    """The grid transposed (K and V in column order, the terms swapped, kw
    the grid's height) gives the same attention: the plain version reads
    each term at its key's own row and column."""
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


# K1's relative-position mode, replayed on the CPU: 2-D key tiles of the grid,
# the terms folded into the QK product (csrc flash_fwd_relpos_sm90).  A key
# tile is REL_TILE grid rows x grid columns (csrc rel::kRows, rel::kCols), and
# a term lane past the grid carries REL_MASK (csrc rel::kMaskBf16, -2^100,
# finite in bf16); the cuda cases below hold the kernel itself to the plain
# version.
REL_TILE = (8, 16)
REL_MASK = -2.0 ** 100
GRIDS = [(190, 252), (252, 190), (14, 14), (15, 20), (17, 30), (6, 6)]


def grid_tiles(kh, kw):
    """K1's key tiles over a kh x kw grid in its order (row blocks outside):
    (tiles, 128) keys, slot t = 16 r + c holding grid row r0 + r, column
    c0 + c, and -1 where that lies past the grid (TMA zero-fills K and V)."""
    rows, cols = REL_TILE
    t = torch.arange(rows * cols)
    out = []
    for r0 in range(0, kh, rows):
        for c0 in range(0, kw, cols):
            gr, gc = r0 + t // cols, c0 + t % cols
            out.append(torch.where((gr < kh) & (gc < kw), gr * kw + gc, -1))
    return torch.stack(out)


def one_hot(scale):
    """The kernel's B (128 keys x 32 lanes): key t = 16 r + c holds 1 / scale
    at lanes c and 16 + r."""
    rows, cols = REL_TILE
    t = torch.arange(rows * cols)
    b = torch.zeros(rows * cols, 32)
    b[t, t % cols] = 1 / scale
    b[t, 16 + t // cols] = 1 / scale
    return b


def folded_scores(q, k, rh, rw, kh, kw, scale):
    """Each tile's scores as K1 forms them, [q | A] [k_tile | B]^T * scale,
    A = [Rw of the tile's 16 columns | Rh of its 8 rows | 0 x 8] with REL_MASK
    in the lanes past the grid: (queries, tiles * 128) in the tiles' order."""
    rows, cols = REL_TILE
    b = one_hot(scale)
    keys = grid_tiles(kh, kw)
    out = []
    for i, (r0, c0) in enumerate((r0, c0) for r0 in range(0, kh, rows)
                                 for c0 in range(0, kw, cols)):
        c, r = c0 + torch.arange(cols), r0 + torch.arange(rows)
        a = torch.cat([torch.where(c < kw, rw[:, c.clamp(max=kw - 1)], REL_MASK),
                       torch.where(r < kh, rh[:, r.clamp(max=kh - 1)], REL_MASK),
                       torch.zeros(len(q), 8)], 1)
        kt = torch.where(keys[i, :, None] >= 0, k[keys[i].clamp(min=0)], 0.0)
        out.append(torch.cat([q, a], 1) @ torch.cat([kt, b], 1).T * scale)
    return torch.cat(out, 1)


@pytest.mark.parametrize("grid", GRIDS)
def test_relpos_grid_tiles_cover_every_key_once(grid):
    """8 x 16 tiles cover each key of the grid once, pad a 12 MP photo's grid
    (47,880 keys) to 49,152 either way round and a 14 x 14 window to 256, and
    every tile's first slot is a key of the grid (a row's running max is
    finite from the first tile on)."""
    kh, kw = grid
    keys = grid_tiles(kh, kw)
    assert torch.equal(keys[keys >= 0].sort().values, torch.arange(kh * kw))
    assert keys.numel() == 128 * -(-kh // 8) * -(-kw // 16)
    assert keys.numel() == {(190, 252): 49152, (252, 190): 49152, (14, 14): 256}.get(
        grid, keys.numel())
    assert bool((keys[:, 0] >= 0).all())


@pytest.mark.parametrize("size", [1.0, 30.0])
@pytest.mark.parametrize("grid", GRIDS)
def test_relpos_folded_product_is_the_biased_score(grid, size):
    """Per tile, [q | A] [k | B]^T * scale equals scale * q.k + Rh + Rw in
    fp32 at every key of the grid, and the mask leaves padded slots softmax
    weight 0 (terms of magnitude ~30 included), so the softmax over the
    tiles is the softmax over the grid."""
    kh, kw = grid
    d, scale, nq = 64, 64 ** -0.5, 5
    g = torch.Generator().manual_seed(kh * kw)
    q, k = torch.randn(nq, d, generator=g), torch.randn(kh * kw, d, generator=g)
    rh, rw = ((size * torch.randn(nq, n, generator=g)).bfloat16().float() for n in (kh, kw))
    got = folded_scores(q, k, rh, rw, kh, kw, scale)
    keys = grid_tiles(kh, kw).flatten()
    real = keys >= 0
    key = torch.arange(kh * kw)
    want = scale * q @ k.T + rh[:, key // kw] + rw[:, key % kw]
    torch.testing.assert_close(got[:, real], want[:, keys[real]], rtol=1e-5, atol=1e-4)
    assert float(got[:, ~real].max()) <= REL_MASK
    p = torch.softmax(got, -1)
    assert float(p[:, ~real].abs().max()) == 0.0
    torch.testing.assert_close(p[:, real], torch.softmax(want, -1)[:, keys[real]],
                               rtol=1e-5, atol=1e-7)


def test_relpos_one_hot_words_cover_the_tile():
    """The kernel's loop over B's 4096 words (csrc flash_fwd_relpos_sm90):
    word w is row w // 32 and physical 16-byte chunk (w // 4) % 8 of the
    128-byte-swizzled tile, logical chunk ((w // 4) % 8) ^ (row % 8); each
    (row, lane) is written once and the tile reads back as the one-hot."""
    inv = 8.0
    tile = torch.full((128, 64), float("nan"))
    for w in range(128 * 128 // 4):
        t = w >> 5
        j = ((((w >> 2) & 7) ^ (t & 7)) << 3) + (w & 3) * 2
        c, r = t % 16, 16 + t // 16
        for lane in (j, j + 1):
            assert tile[t, lane].isnan()
            tile[t, lane] = inv if lane in (c, r) else 0.0
    assert torch.equal(tile[:, :32], one_hot(1 / inv))
    assert torch.equal(tile[:, 32:], torch.zeros(128, 32))


def test_relpos_terms_come_in_tma_rows():
    """relpos_terms writes rows padded to 8 values, which K1's TMA loads take
    as they are; terms with another row stride are copied into such rows."""
    q = torch.randn(1, 2, 14 * 15, 16)
    rel = attention_mod.relpos_terms(q, torch.randn(14, 14, 16), torch.randn(15, 15, 16))
    for t, n in ((rel.rh, 14), (rel.rw, 15)):
        assert t.stride() == (14 * 15 * 16, 16, 1) and t.shape[-1] == n
        assert tma_rows(t) is t
    plain = torch.randn(2, 210, 15)
    got = tma_rows(plain)
    assert got.stride() == (210 * 16, 16, 1) and torch.equal(got, plain)


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


def relpos_case(cuda, b, h, grid, size=1.0, seed=11):
    """q, k, v sliced from one (B, L, 3, H, 64) bf16 tensor as the model's
    are, and bf16 terms as relpos_terms makes them, from tables scaled so
    that the terms' magnitude is about ``size`` times q's."""
    kh, kw = grid
    n, d = kh * kw, 64
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=g, device=cuda).bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    th, tw = (size / 8 * torch.randn(m, m, d, generator=g, device=cuda) for m in (kh, kw))
    return q, k, v, attention_mod.relpos_terms(q, th, tw)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,grid,size", [((1, 12), (190, 252), 1.0), ((1, 12), (252, 190), 1.0),
                                          ((252, 12), (14, 14), 1.0), ((2, 3), (15, 20), 1.0),
                                          ((1, 2), (10, 420), 1.0), ((2, 3), (17, 30), 1.0),
                                          ((1, 12), (190, 252), 30.0), ((2, 3), (40, 6), 1.0),
                                          ((4, 3), (6, 6), 1.0)])
def test_k1_relpos_matches_plain(cuda, bh, grid, size):
    """The main path's shapes (a 12 MP photo's global grid both ways, a
    windowed block's 252 windows), ragged grids (17 x 30 at both edges of
    the 8 x 16 tiles), terms of magnitude ~30 against the mask's headroom,
    and grids narrower and shorter than one tile (40 x 6, 6 x 6: a term box
    past the grid whole); on bf16 terms as relpos_terms makes them."""
    b, h = bh
    q, k, v, rel = relpos_case(cuda, b, h, grid, size)
    assert rel.rh.dtype == torch.bfloat16
    before = METRICS.counters.get("attention.relpos_launches", 0)
    got = flash_attention(q, k, v, scale=64 ** -0.5, rel=rel)
    torch.cuda.synchronize()
    assert METRICS.counters.get("attention.relpos_launches", 0) == before + 1
    err, bar = _bar(got, attention_plain(q, k, v, scale=64 ** -0.5, rel=rel))
    print(f"relpos {b}x{h} grid {grid} terms ~{size}: max err {err:.3e}, bar {bar:.3e}")


@pytest.mark.cuda
def test_k1_relpos_refuses_fp32_terms(cuda):
    """fp32 terms raise on the card rather than being rounded to bf16."""
    q, k, v, rel = relpos_case(cuda, 1, 2, (15, 20))
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q, k, v, scale=64 ** -0.5, rel=RelPos(rel.rh.float(), rel.rw.float(), 20))


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
