"""GroupNorm's hand kernels (ops/group_norm.py, csrc/group_norm.cu) and the
capture mode they run in (``Kernel(cuts=False)``, ops/_build.py).

On the CPU: a full-width 1024 px forward on the meta device meets the sites
of ``SHAPES_1024`` (113, 10 of them applied by K3's prologue); the plain
statistics count one ``norm.plain_sites`` a GroupNorm call; a kernel built
with ``cuts=False`` runs inside a capture instead of being handed to the
segmenter, and a plan counts it (and ``_build.tally``'s counters) at each
replay; the slab counts put several blocks on each SM at the large shapes.

On the card (``cuda``): the kernels against their plain versions at every
GroupNorm shape of a 1024 px matte, at the server's batches 2-8 of the U-Net
and decoder shapes, and in fp32; two launches equal bit for bit; a backward
through either entry point raises; a step captured with the kernels inside
its graph replays its eager call bit for bit; every site of a 1024 px matte
arrives in channels_last.

This file imports no JAX, so that its ``cuda`` cases run on the card alone:
``python -m pytest tests/test_torch_group_norm.py -m cuda --noconftest``.
"""

import collections
import ctypes
import math

import pytest
import torch
from torch import nn

from sdmatte_tpu_torch.configs import SDMatteConfig
from sdmatte_tpu_torch.core import nn as F
from sdmatte_tpu_torch.core.dtypes import BF16
from sdmatte_tpu_torch.models.sdmatte import SDMatte
from sdmatte_tpu_torch.ops import _build
from sdmatte_tpu_torch.ops import group_norm as gn
from sdmatte_tpu_torch.ops.dispatch import implementation
from sdmatte_tpu_torch.pipeline import graphs
from sdmatte_tpu_torch.utils.observability import METRICS

# (B, C, H, W) of each GroupNorm site of a 1024 px matte (32 groups), the sites
# at that shape, and how many of them K3's prologue applies (no apply kernel):
# the VAE encoder at concat batch 2, the U-Net and the decoder at batch 1
SHAPES_1024 = [
    ((2, 128, 1024, 1024), 4, 4), ((1, 256, 1024, 1024), 1, 0), ((2, 256, 512, 512), 3, 3),
    ((1, 512, 512, 512), 1, 0), ((1, 128, 1024, 1024), 6, 0), ((2, 128, 512, 512), 1, 0),
    ((2, 512, 256, 256), 3, 3), ((1, 256, 512, 512), 5, 0), ((2, 256, 256, 256), 1, 0),
    ((1, 512, 256, 256), 6, 0), ((2, 512, 128, 128), 10, 0), ((1, 960, 128, 128), 1, 0),
    ((1, 640, 128, 128), 2, 0), ((1, 512, 128, 128), 11, 0), ((1, 1920, 64, 64), 1, 0),
    ((1, 320, 128, 128), 13, 0), ((1, 1280, 64, 64), 1, 0), ((1, 960, 64, 64), 1, 0),
    ((1, 640, 64, 64), 11, 0), ((1, 2560, 32, 32), 2, 0), ((1, 1920, 32, 32), 1, 0),
    ((1, 320, 64, 64), 1, 0), ((1, 1280, 32, 32), 11, 0), ((1, 640, 32, 32), 1, 0),
    ((1, 2560, 16, 16), 3, 0), ((1, 1280, 16, 16), 12, 0),
]
# the U-Net's and the decoder's shapes, which the server runs at batches 2-8
SERVE_SHAPES = [s for s, _, _ in SHAPES_1024 if s[0] == 1]


def _counter(name):
    return METRICS.counters.get(name, 0.0)


# ------------------------------------------------------------ on the CPU ---

def test_a_1024_matte_meets_the_sites_of_the_table(monkeypatch):
    """Full width on the meta device under "plain" (where the entry points
    take the plain versions): 113 statistics sites at the table's shapes,
    103 applies, one ``norm.plain_sites`` each, one a GroupNorm module."""
    stats, applies = collections.Counter(), collections.Counter()
    plain_stats, plain_apply = gn.group_norm_stats, gn.group_norm_apply

    def stats_spy(p, x):
        stats[tuple(x.shape)] += 1
        return plain_stats(p, x)

    def apply_spy(x, a, d, *, silu):
        applies[tuple(x.shape)] += 1
        return plain_apply(x, a, d, silu=silu)
    monkeypatch.setattr(gn, "group_norm_stats", stats_spy)
    monkeypatch.setattr(gn, "group_norm_apply", apply_spy)
    with torch.device("meta"):
        model = SDMatte(SDMatteConfig()).to(torch.bfloat16)
    b, s = 1, 1024
    data = {"image": torch.empty(b, 3, s, s, device="meta", dtype=torch.bfloat16),
            "trimap": torch.empty(b, 1, s, s, device="meta", dtype=torch.bfloat16),
            "trimap_coords": torch.empty(b, 4, device="meta"),
            "is_trans": torch.empty(b, device="meta")}
    before = _counter(gn.PLAIN_SITES)
    with implementation("plain"), torch.no_grad():
        model(data, aux_input_type="trimap", policy=BF16)
    assert _counter(gn.PLAIN_SITES) - before == 113
    assert stats == {shape: n for shape, n, _ in SHAPES_1024}
    assert applies == {shape: n - fused for shape, n, fused in SHAPES_1024 if n > fused}
    n_modules = sum(isinstance(m, nn.GroupNorm) for m in model.modules())
    assert sum(stats.values()) == n_modules == 113


def test_plain_sites_count_one_per_groupnorm_call(monkeypatch):
    """A tiny SDMatte forward on the CPU: each GroupNorm module of the VAE and
    the U-Net runs once, and each run counts one plain site."""
    from sdmatte_tpu_torch.models.init import init_random_
    model = init_random_(SDMatte(SDMatteConfig.tiny()), seed=0).eval()
    calls = []
    forward = gn.group_norm_stats_plain

    def spy(p, x):
        calls.append(p)
        return forward(p, x)
    monkeypatch.setattr(gn, "group_norm_stats_plain", spy)
    s = 32
    data = {"image": torch.rand(1, 3, s, s) * 2 - 1, "trimap": torch.rand(1, 1, s, s) * 2 - 1,
            "trimap_coords": torch.tensor([[0.0, 0.0, 1.0, 1.0]]), "is_trans": torch.zeros(1)}
    before = _counter(gn.PLAIN_SITES)
    with torch.no_grad():
        model(data, aux_input_type="trimap")
    norms = [m for m in model.modules() if isinstance(m, nn.GroupNorm)]
    assert _counter(gn.PLAIN_SITES) - before == len(calls) == len(norms) > 0
    assert sorted(map(id, calls)) == sorted(map(id, norms))


@pytest.fixture
def stub_kernel():
    """A kernel that does not cut, whose native function is a recorder (out of
    the registry), counting ``test.stub_launches``."""
    k = _build.Kernel("stub", "stub", "stub", [], replaces="nothing", cuts=False,
                      counter="test.stub_launches")
    _build.Kernel.registry.remove(k)
    k.calls = []
    k._fn = lambda *args: k.calls.append(args) or 0
    k._lib = None
    return k


class StubGraph:
    def __init__(self, log):
        self.log = log
        log.append("begin")

    def capture_end(self):
        self.log.append("end")

    def replay(self):
        self.log.append("replay")


def test_a_kernel_built_with_cuts_false_is_not_handed_to_the_segmenter(stub_kernel):
    """Inside a capture it runs (on the capturing stream: the open graph
    records it) and is not counted; the segmenter holds it, with the
    counters ``tally`` met, and each replay of the plan counts them."""
    log = []
    seg = graphs.Segmenter(lambda: StubGraph(log))
    cut = []
    seg.cut = lambda kernel, args: cut.append(kernel)
    before = (_counter("test.stub_launches"), _counter("test.stub_sites"))
    _build.CAPTURE.segmenter = seg
    try:
        stub_kernel.launch(1, ctypes.c_void_p(2))
        stub_kernel.launch(3, ctypes.c_void_p(4))
        _build.tally("test.stub_sites")
    finally:
        _build.CAPTURE.segmenter = None
    steps = seg.finish()
    assert cut == [] and len(stub_kernel.calls) == 2 and stub_kernel.launches == 0
    assert log == ["begin", "end"] and len(steps) == 1
    assert seg.held == {stub_kernel: 2, "test.stub_sites": 1}
    assert (_counter("test.stub_launches"), _counter("test.stub_sites")) == before
    plan = graphs.Plan((None,), steps, torch.ones(1), [], seg.held)
    for _ in range(3):
        plan((None,), ctypes.c_void_p(9))
    assert log.count("replay") == 3 and len(stub_kernel.calls) == 2
    assert stub_kernel.launches == 6
    assert _counter("test.stub_launches") - before[0] == 6
    assert _counter("test.stub_sites") - before[1] == 3
    stub_kernel.launch(5, ctypes.c_void_p(6))         # outside a capture: runs and counts
    assert stub_kernel.launches == 7 and len(stub_kernel.calls) == 3
    _build.tally("test.stub_sites")
    assert _counter("test.stub_sites") - before[1] == 4


@pytest.mark.parametrize("shape", [s for s, _, _ in SHAPES_1024], ids=str)
def test_slabs_fill_the_card_at_the_large_shapes(shape):
    b, c, h, w = shape
    s = gn.slabs(b, h * w, c)
    tpr = c // gn.VEC
    rows_a_step = 1 if tpr >= gn.ROW_THREADS else gn.ROW_THREADS // tpr
    per = math.ceil(h * w / s)
    assert 1 <= s and (s - 1) * per < h * w           # no slab is empty
    assert b * s <= gn.BLOCKS + b
    assert per >= gn.THREAD_ROWS * rows_a_step or s == 1
    if b * h * w * c * 2 >= 64 << 20:                 # 64 MB and more: two blocks an SM or more
        assert b * s >= 2 * 132
    if h * w <= 16 * 16:                              # the 16^2 sites stay a few blocks
        assert b * s <= 32


# ------------------------------------------------------------- on the card ---

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the hand kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _site(shape, dtype, dev, seed):
    """An activation of ``shape`` in channels_last (mean 0.5, std 1.5, with a
    per-channel offset) and a GroupNorm of 32 groups with weights in
    ``dtype``, as the bf16 policy stages them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, c, h, w = shape
    x = torch.randn(shape, generator=g, device=dev) * 1.5 + 0.5
    x = x + torch.randn((1, c, 1, 1), generator=g, device=dev)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    p = nn.GroupNorm(32, c, eps=1e-6 if c % 3 else 1e-5).to(dev)
    with torch.no_grad():
        p.weight.copy_(torch.rand(c, generator=g, device=dev) + 0.5)
        p.bias.copy_(torch.randn(c, generator=g, device=dev) * 0.2)
    return x, p.to(dtype).requires_grad_(False)


def _hold_stats(got, ref):
    """(a, d) against the plain version's: fp32 sums taken in two orders over
    up to 2^23 values, so within 1e-4 relative (E[x^2] - E[x]^2 loses a
    little to cancellation) and 2e-5 absolute for d near 0."""
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, r, rtol=1e-4, atol=2e-5)


def _hold_apply(y, x, a, d, silu):
    """The kernel's output against x * a + d (then SiLU) in fp32, with the
    same (a, d): a bf16 output within one bf16 ulp of the fp32 value; an fp32
    output within 4 fp32 ulp (x * a + d rounded once or twice, and the two
    sides' expf, each within 2 ulp)."""
    ref = torch.addcmul(d[:, :, None, None], x.float(), a[:, :, None, None])
    if silu:
        ref = torch.nn.functional.silu(ref)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert y.is_contiguous(memory_format=torch.channels_last)
    mant, ulps = (7, 1) if x.dtype == torch.bfloat16 else (23, 4)
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - mant)
    err = (y.float() - ref).abs()
    assert bool((err <= ulps * ulp).all()), f"max error {float((err / ulp).max())} ulp"


def _check_shape(shape, dtype, dev, seed):
    x, p = _site(shape, dtype, dev, seed)
    with torch.no_grad():
        got = gn.group_norm_stats(p, x)
        with implementation("plain"):
            ref = gn.group_norm_stats(p, x)
        _hold_stats(got, ref)
        for silu in (True, False):
            y = gn.group_norm_apply(x, *got, silu=silu)
            _hold_apply(y, x, *got, silu)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype", [(s, torch.bfloat16) for s, _, _ in SHAPES_1024]
                         + [((2, 320, 50, 37), torch.float32), ((1, 960, 24, 24), torch.bfloat16)],
                         ids=str)
def test_kernels_match_plain_at_a_1024_matte_shapes(cuda, shape, dtype):
    _check_shape(shape, dtype, cuda, seed=sum(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SERVE_SHAPES, ids=str)
def test_kernels_match_plain_at_serve_batches(cuda, shape):
    for b in range(2, 9):
        _check_shape((b, *shape[1:]), torch.bfloat16, cuda, seed=b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 128, 1024, 1024), (1, 320, 128, 128),
                                   (1, 1280, 16, 16), (2, 320, 50, 37)], ids=str)
def test_two_launches_are_equal_bit_for_bit(cuda, shape):
    x, p = _site(shape, torch.bfloat16, cuda, seed=7)
    with torch.no_grad():
        a1, d1 = gn.group_norm_stats(p, x)
        a2, d2 = gn.group_norm_stats(p, x)
        y1 = gn.group_norm_apply(x, a1, d1, silu=True)
        y2 = gn.group_norm_apply(x, a1, d1, silu=True)
    assert torch.equal(a1, a2) and torch.equal(d1, d2) and torch.equal(y1, y2)


@pytest.mark.cuda
def test_a_backward_through_either_kernel_raises(cuda):
    x, p = _site((1, 320, 16, 16), torch.float32, cuda, seed=3)
    p.requires_grad_(True)
    x = x.detach().requires_grad_(True)
    with pytest.raises(RuntimeError, match="group_norm_stats has no backward"):
        sum(t.sum() for t in gn.group_norm_stats(p, x)).backward()
    a, d = (t.detach() for t in gn.group_norm_stats(p, x))
    with pytest.raises(RuntimeError, match="group_norm_apply has no backward"):
        gn.group_norm_apply(x, a, d, silu=True).sum().backward()


@pytest.mark.cuda
def test_a_captured_step_holds_the_kernels_and_replays_its_eager_call_bit_for_bit(cuda):
    """The kernels run inside one graph (no cut); a replay equals the eager
    call of the same input bit for bit and counts the launches it holds."""
    x, p1 = _site((1, 640, 64, 64), torch.bfloat16, cuda, seed=11)
    _, p2 = _site((1, 640, 64, 64), torch.bfloat16, cuda, seed=12)

    def step(x):
        return F.group_norm(p2, F.gn_silu(p1, x))
    runner = graphs.HeavyGraphs(cuda)
    kernels = (gn.GN_STATS, gn.GN_FINISH, gn.GN_APPLY)
    launches = [k.launches for k in kernels]
    x2, _ = _site((1, 640, 64, 64), torch.bfloat16, cuda, seed=13)
    with torch.no_grad():
        first = runner("key", step, (x,))                 # eager, then captured
        assert [k.launches - n for k, n in zip(kernels, launches)] == [2, 2, 2]
        eager_first = step(x)
        before = _counter(gn.LAUNCHES)
        replayed = runner("key", step, (x2,))
        assert _counter(gn.LAUNCHES) - before == 6
        eager = step(x2)
    plan = runner.plans["key"]
    assert [type(s).__name__ for s in plan.steps] == ["CUDAGraph"]
    assert torch.equal(first, eager_first) and torch.equal(replayed, eager)


@pytest.fixture(scope="module")
def card_model(cuda):
    from sdmatte_tpu_torch.models.init import init_random_
    with torch.device("meta"):
        model = SDMatte(SDMatteConfig())
    return init_random_(model, seed=0, device=cuda)


@pytest.mark.cuda
def test_every_site_of_a_1024_matte_arrives_channels_last(card_model, monkeypatch):
    from sdmatte_tpu_torch.pipeline import MattingPipeline, PipelineOptions
    seen = []
    stats = gn.group_norm_stats

    def spy(p, x):
        seen.append((tuple(x.shape), x.is_contiguous(memory_format=torch.channels_last)))
        return stats(p, x)
    monkeypatch.setattr(gn, "group_norm_stats", spy)
    pipe = MattingPipeline(card_model, policy=BF16, device=torch.device("cuda"))
    pipe._graphs.engaged = lambda: False
    img = torch.rand(1024, 1024, 3, device="cuda")
    tri = (torch.rand(1024, 1024, device="cuda") > 0.5).float() * 0.5
    pipe(img, tri, options=PipelineOptions(inference_size=1024))
    assert len(seen) == 113
    assert [s for s in seen if not s[1]] == []
