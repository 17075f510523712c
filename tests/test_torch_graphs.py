"""The heavy step's piecewise CUDA-graph replay (pipeline/graphs.py) and the
constant tables kept on the device (core/tables.py).

On the CPU: the tables equal the numpy-built ones and come back as the same
tensor; a CPU pipeline runs its heavy step eagerly and counts it; the step's
key separates what the step's shapes and branches depend on; the segmenter
cuts a capture at each hand-kernel launch, and a plan replays graphs and
launches in order on the caller's stream; the runner's flow (first call
eager, then capture; replay by copy-in and clone; a failed capture falls
back), with stub graphs in place of the card's; a pipeline's step runs under
its own implementation (ops/dispatch.implementation) whatever the caller's.

On the card (``cuda``): at full width a replayed step equals the eager one,
also after calls alternate between keys on one pipeline's pool; a replayed
1024 px call counts the hand kernels' launches and a wrapper on
``Kernel.launch`` sees them; a capture that raises leaves its key eager.

This file imports no JAX, so that its ``cuda`` cases run on the card alone:
``python -m pytest tests/test_torch_graphs.py -m cuda --noconftest``.
"""

import collections
import contextlib
import ctypes
import functools

import numpy as np
import pytest
import torch

from sdmatte_tpu_torch.configs import SDMatteConfig
from sdmatte_tpu_torch.core import embeddings, imaging, tables
from sdmatte_tpu_torch.core.dtypes import BF16
from sdmatte_tpu_torch.models.sdmatte import SDMatte
from sdmatte_tpu_torch.ops import _build
from sdmatte_tpu_torch.ops.dispatch import implementation, plain_here
from sdmatte_tpu_torch.pipeline import MattingPipeline, PipelineOptions
from sdmatte_tpu_torch.pipeline import graphs
from sdmatte_tpu_torch.utils.observability import METRICS

COUNTERS = ("heavy.graph_captures", "heavy.graph_replays", "heavy.graph_fallbacks",
            "heavy.eager")


def _counts():
    return {k: METRICS.counters.get(k, 0.0) for k in COUNTERS}


def _delta(before):
    now = _counts()
    return {k: now[k] - before[k] for k in COUNTERS}


# ------------------------------------------------------------------ tables ---

@pytest.mark.parametrize("build, sizes", [
    (imaging.bilinear_aa_matrix, (75, 32, True)),
    (imaging.bilinear_aa_matrix, (16, 40, False)),
    (imaging.nearest_index, (128, 16)),
    (embeddings.frequencies, (160, 1.0, 10000.0)),
])
def test_table_equals_the_numpy_one_and_comes_back_as_the_same_tensor(build, sizes):
    cpu = torch.device("cpu")
    t = tables.on_device(build, cpu, *sizes)
    assert torch.equal(t, torch.from_numpy(build(*sizes)))
    assert tables.on_device(build, cpu, *sizes) is t


def test_resizes_and_embedding_read_the_tables_unchanged():
    x = torch.rand(2, 40, 30, 3)
    ah = torch.from_numpy(imaging.bilinear_aa_matrix(40, 17, True))
    aw = torch.from_numpy(imaging.bilinear_aa_matrix(30, 23, True))
    want = torch.einsum("ow,bhwc->bhoc", aw, torch.einsum("oh,bhwc->bowc", ah, x))
    assert torch.equal(imaging.resize_bilinear(x, 17, 23), want)
    y = torch.rand(2, 3, 32, 24)
    ih = torch.from_numpy(imaging.nearest_index(32, 8))
    iw = torch.from_numpy(imaging.nearest_index(24, 6))
    assert torch.equal(imaging.resize_nearest(y, 8, 6), y.index_select(2, ih).index_select(3, iw))
    t = torch.tensor([0.0, 0.25, 1.0])
    exponent = -np.float32(np.log(10000.0)) * np.arange(4, dtype=np.float32) / np.float32(4)
    arg = t[:, None] * torch.from_numpy(np.exp(exponent, dtype=np.float32))[None]
    want = torch.cat([torch.cos(arg), torch.sin(arg)], -1)
    assert torch.equal(embeddings.sinusoidal_embedding(t, 8), want)


def test_tables_are_bounded_and_a_capture_holds_what_it_read(monkeypatch):
    monkeypatch.setattr(tables, "CAPACITY", 3)
    cpu = torch.device("cpu")
    with tables.holding() as held:
        first = tables.on_device(imaging.nearest_index, cpu, 1000, 7)
        again = tables.on_device(imaging.nearest_index, cpu, 1000, 7)
    assert held == [first, again] and held[0] is held[1]
    for n in range(8, 12):
        tables.on_device(imaging.nearest_index, cpu, 1000, n)
    assert tables.on_device(imaging.nearest_index, cpu, 1000, 7) is not first
    assert len(tables._cache) <= 3


# ----------------------------------------------------------- the pipeline ---

@pytest.fixture(scope="module")
def tiny_pipe():
    torch.manual_seed(0)
    return MattingPipeline(SDMatte(SDMatteConfig.tiny()).eval(), device="cpu")


def _photo(size=48, b=1, seed=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    r = np.hypot(yy - size / 2, xx - size / 2)
    tri = np.where(r < size / 5, 1.0, np.where(r < size / 3, 0.5, 0.0)).astype(np.float32)
    return img, np.broadcast_to(tri, (b, size, size)).copy()


def test_cpu_pipeline_runs_its_heavy_step_eagerly_and_counts_it(tiny_pipe):
    img, tri = _photo()
    opts = PipelineOptions(inference_size=32)
    before = _counts()
    alpha, _ = tiny_pipe(img, tri, options=opts)
    alpha2, _ = tiny_pipe(img, tri, options=opts)
    assert _delta(before) == {"heavy.graph_captures": 0, "heavy.graph_replays": 0,
                              "heavy.graph_fallbacks": 0, "heavy.eager": 2}
    assert tiny_pipe._graphs.plans == {}
    with torch.no_grad():
        x = torch.from_numpy(img)
        m = torch.from_numpy(tri)
        img_s, pm_s = tiny_pipe._pre(x, m, size=32)
        coords = torch.tensor([[0.0, 0.0, 1.0, 1.0]])
        alpha_s = tiny_pipe._model_alpha(img_s, pm_s, coords, torch.zeros(1), None,
                                         aux_type="trimap")
        want, _ = tiny_pipe._post(alpha_s, x, m, output_mode="alpha_only", refine=True,
                                  trimap_constraint=0.8)
    assert torch.equal(alpha, want) and torch.equal(alpha2, want)


def test_warmup_runs_the_largest_step_first(tiny_pipe, monkeypatch):
    seen = []
    heavy = tiny_pipe._heavy

    def spy(img, *a, **kw):
        seen.append(tuple(img.shape))
        return heavy(img, *a, **kw)
    monkeypatch.setattr(tiny_pipe, "_heavy", spy)
    timings = tiny_pipe.warmup(sizes=(16, 32), batch_sizes=(1, 2))
    assert seen == [(2, 3, 32, 32), (1, 3, 32, 32), (2, 3, 16, 16), (1, 3, 16, 16)]
    assert sorted(timings) == [(16, 1), (16, 2), (32, 1), (32, 2)]


def test_heavy_key_separates_batch_size_speed_mode_and_text_ids(tiny_pipe):
    def args(b=1, s=64, text=False):
        return (torch.zeros(b, 3, s, s), torch.zeros(b, 1, s, s), torch.zeros(b, 4),
                torch.zeros(b), torch.zeros(b, 77, dtype=torch.int64) if text else None)

    base = tiny_pipe._heavy_key(args(), "trimap")
    assert tiny_pipe._heavy_key(args(), "trimap") == base
    others = [tiny_pipe._heavy_key(args(b=2), "trimap"),
              tiny_pipe._heavy_key(args(s=32), "trimap"),
              tiny_pipe._heavy_key(args(text=True), "trimap"),
              tiny_pipe._heavy_key(args(), "mask")]
    tiny_pipe.speed_mode = "fast"
    try:
        others.append(tiny_pipe._heavy_key(args(), "trimap"))
    finally:
        tiny_pipe.speed_mode = "off"
    assert len({base, *others}) == 1 + len(others)


# ------------------------------------------------- segmenter, plan, runner ---

class StubGraph:
    """A CUDA graph's capture and replay, written into a shared log."""

    def __init__(self, log):
        self.log, self.id = log, sum(e[0] == "begin" for e in log)
        log.append(("begin", self.id))

    def capture_end(self):
        self.log.append(("end", self.id))

    def replay(self):
        self.log.append(("replay", self.id))


@pytest.fixture
def stub_kernel():
    """A hand kernel whose native function is a recorder (out of the registry)."""
    k = _build.Kernel("stub", "stub", "stub", [], replaces="nothing")
    _build.Kernel.registry.remove(k)
    k.calls = []
    k._fn = lambda *args: k.calls.append(args) or 0
    k._lib = None
    return k


def test_segmenter_alternates_graphs_and_launches_and_a_plan_replays_them(stub_kernel):
    log = []
    seg = graphs.Segmenter(lambda: StubGraph(log))
    strides = (ctypes.c_longlong * 3)(1, 2, 3)
    a1 = (7, strides, ctypes.c_void_p(11))
    a2 = (8, ctypes.c_void_p(12))
    seg.cut(stub_kernel, a1)
    seg.cut(stub_kernel, a2)
    steps = seg.finish()
    assert [type(s).__name__ for s in steps] == ["StubGraph", "tuple", "StubGraph", "tuple",
                                                 "StubGraph"]
    assert steps[1] == (stub_kernel, a1) and steps[1][1][1] is strides
    assert log == [("begin", 0), ("end", 0), ("begin", 1), ("end", 1), ("begin", 2),
                   ("end", 2)]
    log.clear()
    stream = ctypes.c_void_p(99)
    out = torch.ones(2)
    plan = graphs.Plan((None,), steps, out, [])
    got = plan((None,), stream)
    assert log == [("replay", 0), ("replay", 1), ("replay", 2)]
    assert stub_kernel.calls == [(7, strides, stream), (8, stream)]
    assert stub_kernel.launches == 2
    assert torch.equal(got, out) and got.data_ptr() != out.data_ptr()


def test_a_launch_inside_a_capture_is_cut_not_run(stub_kernel):
    cuts = []

    class Recorder:
        def cut(self, kernel, args):
            cuts.append((kernel, args))

    _build.CAPTURE.segmenter = Recorder()
    try:
        stub_kernel.launch(1, 2, ctypes.c_void_p(3))
    finally:
        _build.CAPTURE.segmenter = None
    assert len(cuts) == 1 and cuts[0][0] is stub_kernel and cuts[0][1][:2] == (1, 2)
    assert stub_kernel.calls == [] and stub_kernel.launches == 0
    stub_kernel.launch(1, 2, ctypes.c_void_p(3))
    assert len(stub_kernel.calls) == 1 and stub_kernel.launches == 1


class StubRunner(graphs.HeavyGraphs):
    """The runner with stub graphs and no streams: its flow on the CPU."""

    def __init__(self):
        super().__init__(torch.device("cpu"))
        self.log = []

    def engaged(self):
        return True

    @contextlib.contextmanager
    def _on_side_stream(self):
        yield

    def _open_graph(self):
        return StubGraph(self.log)

    def _stream(self):
        return "the caller's stream"


def _setting():
    """The calling thread's implementation, as an entry point sees it for a
    tensor on a device with no kernel (meta)."""
    return "plain" if plain_here(torch.empty(0, device="meta")) else "auto"


def _stub_pipeline(kind, impl):
    """A tiny pipeline of ``kind`` on the stub runner, whose model records
    the implementation it runs under and answers zeros."""
    from sdmatte_tpu_torch.configs import ViTMatteConfig
    from sdmatte_tpu_torch.models.vitmatte import ViTMatte
    from sdmatte_tpu_torch.pipeline.vitmatte import ViTMattePipeline
    if kind == "sdmatte":
        pipe = MattingPipeline(SDMatte(SDMatteConfig.tiny()), device="cpu", impl=impl)
    else:
        pipe = ViTMattePipeline(ViTMatte(ViTMatteConfig.tiny()), device="cpu", impl=impl)
    pipe._graphs, pipe.seen = StubRunner(), []

    def model(x, **kw):
        pipe.seen.append(_setting())
        x = x["image"] if isinstance(x, dict) else x
        return torch.zeros((x.shape[0], 1, *x.shape[2:]))
    pipe.model = model
    return pipe


@pytest.mark.parametrize("kind", ["sdmatte", "vitmatte"])
@pytest.mark.parametrize("impl, outer", [("plain", "auto"), ("auto", "plain")])
def test_the_step_runs_under_its_pipelines_implementation(kind, impl, outer):
    """Inside a caller's scope of the other value, the eager first call and
    the capture both run under the pipeline's own; a replay runs no model."""
    pipe = _stub_pipeline(kind, impl)
    img, tri = _photo(size=32)
    call = (functools.partial(pipe, options=PipelineOptions(inference_size=32))
            if kind == "sdmatte" else pipe)
    with implementation(outer):
        first, _ = call(img, tri)
        again, _ = call(img, tri)
        assert _setting() == outer
    assert pipe.seen == [impl, impl] and len(pipe._graphs.plans) == 1
    assert torch.equal(first, again)


def test_runner_captures_at_the_first_call_and_replays_by_copy_in_and_clone(stub_kernel):
    runner = StubRunner()

    def step(x, y, none):
        assert none is None
        z = x * 2.0
        stub_kernel.launch(z.shape[0], "capture stream")
        return z + imaging.resize_nearest(y, 2, 2).flatten()[:1]

    x0, y0 = torch.tensor([1.0, 2.0]), torch.ones(1, 1, 4, 4)
    before = _counts()
    out = runner("k", step, (x0, y0, None))
    assert torch.equal(out, torch.tensor([3.0, 5.0]))
    assert _delta(before)["heavy.graph_captures"] == 1
    plan = runner.plans["k"]
    assert [type(s).__name__ for s in plan.steps] == ["StubGraph", "tuple", "StubGraph"]
    assert plan.inputs[2] is None and plan.inputs[0] is not x0
    assert len(plan.tables) == 2            # the two index tables the step read
    assert stub_kernel.calls == [(2, "capture stream")]   # the eager run's launch only

    x1 = torch.tensor([5.0, 6.0])
    got = runner("k", step, (x1, y0, None))
    assert torch.equal(plan.inputs[0], x1)
    assert stub_kernel.calls[-1] == (2, "the caller's stream")
    assert got.data_ptr() != plan.output.data_ptr() and torch.equal(got, plan.output)
    assert _delta(before) == {"heavy.graph_captures": 1, "heavy.graph_replays": 1,
                              "heavy.graph_fallbacks": 0, "heavy.eager": 0}
    runner("k2", step, (torch.ones(1), y0, None))     # a smaller key joins the pool
    assert set(runner.plans) == {"k", "k2"}


@pytest.mark.parametrize("first, later", [("inference", "no_grad"), ("no_grad", "inference")])
def test_a_plan_captured_in_one_grad_mode_replays_in_the_other(stub_kernel, first, later):
    """ComfyUI runs nodes under inference mode, the server under no_grad: a
    plan's static inputs take copies in either."""
    modes = {"inference": torch.inference_mode, "no_grad": torch.no_grad}
    runner = StubRunner()

    def step(x):
        stub_kernel.launch("capture stream")
        return x + 1.0

    with modes[first]():
        runner("k", step, (torch.zeros(2),))
    with modes[later]():
        got = runner("k", step, (torch.ones(2),))
    assert torch.equal(runner.plans["k"].inputs[0], torch.ones(2))
    assert torch.equal(got, torch.ones(2))          # the stub graphs keep the captured output


def test_a_larger_key_starts_a_fresh_pool_and_smaller_keys_join_it(stub_kernel):
    runner = StubRunner()

    def step(x):
        stub_kernel.launch("capture stream")
        return x + 1.0

    before = _counts()
    for n in (2, 3):                    # rising sizes: each drops the pool's plans
        runner(n, step, (torch.zeros(n),))
    assert set(runner.plans) == {3}
    for n in (2, 1, 3, 2):              # smaller keys join the larger key's pool
        runner(n, step, (torch.zeros(n),))
    assert set(runner.plans) == {1, 2, 3}
    d = _delta(before)
    assert (d["heavy.graph_captures"], d["heavy.graph_replays"]) == (4, 2)


def test_a_capture_that_raises_leaves_the_key_eager(stub_kernel):
    runner = StubRunner()

    def step(x):
        y = x + 1.0
        stub_kernel.launch("capture stream")
        if _build.CAPTURE.segmenter is not None:
            raise RuntimeError("operation not permitted when stream is capturing")
        return y

    before = _counts()
    assert torch.equal(runner("k", step, (torch.zeros(2),)), torch.ones(2))
    assert runner.plans == {"k": None} and _build.CAPTURE.segmenter is None
    assert runner.log[-1] == ("end", 1)     # the open capture was ended
    assert torch.equal(runner("k", step, (torch.ones(2),)), torch.full((2,), 2.0))
    assert _delta(before) == {"heavy.graph_captures": 0, "heavy.graph_replays": 0,
                              "heavy.graph_fallbacks": 1, "heavy.eager": 1}


# ------------------------------------------------------------- on the card ---

@pytest.fixture(scope="module")
def card_pipe():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs and the hand kernels have no CPU mode)")
    from sdmatte_tpu_torch.models.init import init_random_
    cuda = torch.device("cuda")
    with torch.device("meta"):
        model = SDMatte(SDMatteConfig())
    init_random_(model, seed=0, device=cuda)
    return MattingPipeline(model, policy=BF16, device=cuda)


def _card_inputs(pipe, b, size, seed):
    """A photo batch through ``_pre``: the heavy step's arguments."""
    g = torch.Generator(device=pipe.device).manual_seed(seed)
    img = torch.rand(b, size, size, 3, generator=g, device=pipe.device)
    yy, xx = torch.meshgrid(torch.arange(size, device=pipe.device),
                            torch.arange(size, device=pipe.device), indexing="ij")
    r = torch.hypot(yy - size / 2, xx - size / 2)
    tri = torch.where(r < size / 5, 1.0, torch.where(r < size / 3, 0.5, 0.0))
    tri = tri.expand(b, size, size).contiguous()
    img_s, pm_s = pipe._pre(img, tri, size=size)
    coords = torch.tensor([[0.0, 0.0, 1.0, 1.0]] * b, device=pipe.device)
    return img_s, pm_s, coords, torch.zeros(b, device=pipe.device)


def _eager_and_graphed(pipe, b, size, seed):
    args = _card_inputs(pipe, b, size, seed)
    with torch.no_grad():
        eager = pipe._model_alpha(*args, None, aux_type="trimap")
        got = pipe._heavy(*args, aux_type="trimap")
    return (eager - got).abs().max().item()


@pytest.mark.cuda
def test_replayed_step_equals_the_eager_one_at_1024(card_pipe):
    pipe = MattingPipeline(card_pipe.model, policy=BF16, device=card_pipe.device)
    before = _counts()
    first = _eager_and_graphed(pipe, 1, 1024, seed=1)     # eager, then capture
    diffs = [_eager_and_graphed(pipe, 1, 1024, seed=s) for s in (2, 3)]
    print(f"max |eager - replayed| at 1024 px, batch 1: {diffs} (first call {first})")
    assert first == 0.0 and max(diffs) <= 1e-3
    d = _delta(before)
    assert (d["heavy.graph_captures"], d["heavy.graph_replays"], d["heavy.graph_fallbacks"]) \
        == (1, 2, 0)


@pytest.mark.cuda
def test_replays_stay_right_when_keys_alternate_on_one_pool(card_pipe):
    shapes = [(1, 1024), (2, 1024), (1, 512)]
    before = _counts()
    diffs = {}
    for turn in range(2):
        for b, s in shapes:
            diffs[(turn, b, s)] = _eager_and_graphed(card_pipe, b, s, seed=10 * turn + b + s)
    print(f"max |eager - graphed| by (turn, batch, size): {diffs}")
    assert max(diffs.values()) <= 1e-3
    assert _delta(before)["heavy.graph_fallbacks"] == 0


@pytest.mark.cuda
def test_a_replayed_call_launches_and_shows_every_hand_kernel(card_pipe):
    from sdmatte_tpu_torch.ops.conv3x3 import K3
    from sdmatte_tpu_torch.ops.flash_attention import K1, K2
    img = torch.rand(1024, 1024, 3, device=card_pipe.device)
    tri = (torch.rand(1024, 1024, device=card_pipe.device) > 0.5).float() * 0.5
    opts = PipelineOptions(inference_size=1024)
    card_pipe(img, tri, options=opts)                   # captured already, or now
    seen = {k.name: 0 for k in (K1, K2, K3)}

    def wrap(k):
        original = k.launch

        def launch(*args):
            seen[k.name] += 1
            return original(*args)
        k.launch = launch

    for k in (K1, K2, K3):
        k.launches = 0
        wrap(k)
    before = _counts()
    try:
        card_pipe(img, tri, options=opts)
    finally:
        for k in (K1, K2, K3):
            del k.launch
    assert _delta(before)["heavy.graph_replays"] == 1
    assert (K1.launches, K2.launches, K3.launches) == (32, 2, 11)
    assert seen == {K1.name: 32, K2.name: 2, K3.name: 11}


@pytest.mark.cuda
def test_a_replayed_matte_holds_the_norm_kernels_inside_46_graphs(card_pipe):
    """A 1024 px matte's plan: 46 graphs and 45 cut launches (K1 32, K2 2, K3
    11), the GroupNorm kernels inside the graphs: at a replay 113 statistics
    and 113 finishes, 103 applies (10 sites are K3's prologue), no plain
    site; the replay equals the eager call of the same input bit for bit."""
    from sdmatte_tpu_torch.ops import group_norm as gn
    pipe = MattingPipeline(card_pipe.model, policy=BF16, device=card_pipe.device)
    args = _card_inputs(pipe, 1, 1024, seed=21)
    with torch.no_grad():
        pipe._heavy(*args, aux_type="trimap")               # eager, then captured
        (plan,) = pipe._graphs.plans.values()
        cuts = collections.Counter(s[0].name for s in plan.steps if type(s) is tuple)
        n_graphs = sum(type(s) is not tuple for s in plan.steps)
        kernels = (gn.GN_STATS, gn.GN_FINISH, gn.GN_APPLY)
        for k in kernels:
            k.launches = 0
        counts = {n: METRICS.counters.get(n, 0.0) for n in (gn.LAUNCHES, gn.PLAIN_SITES)}
        args = _card_inputs(pipe, 1, 1024, seed=22)
        got = pipe._heavy(*args, aux_type="trimap")
        launches = [k.launches for k in kernels]
        delta = {n: METRICS.counters.get(n, 0.0) - v for n, v in counts.items()}
        eager = pipe._model_alpha(*args, None, aux_type="trimap")
    print(f"plan: {n_graphs} graphs, cuts {dict(cuts)}; norm launches {launches}, {delta}; "
          f"max |eager - replayed| {(eager - got).abs().max().item()}")
    assert n_graphs == 46 and cuts == {"flash_attention_k1": 32, "flash_attention_k2": 2,
                                       "conv3x3": 11}
    assert launches == [113, 113, 103]
    assert delta == {gn.LAUNCHES: 329, gn.PLAIN_SITES: 0}
    assert torch.equal(got, eager)


@pytest.mark.cuda
def test_a_capture_that_raises_on_the_card_leaves_the_key_eager(card_pipe):
    pipe = MattingPipeline(card_pipe.model, policy=BF16, device=card_pipe.device)
    step = pipe._model_alpha

    def syncing(*args, **kw):
        out = step(*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            out.sum().item()        # a host sync: not allowed in a capture
        return out
    pipe._model_alpha = syncing
    args = _card_inputs(pipe, 1, 512, seed=5)
    before = _counts()
    with torch.no_grad():
        first = pipe._heavy(*args, aux_type="trimap")
        again = pipe._heavy(*args, aux_type="trimap")
        eager = step(*args, None, aux_type="trimap")
    assert list(pipe._graphs.plans.values()) == [None]
    assert _delta(before) == {"heavy.graph_captures": 0, "heavy.graph_replays": 0,
                              "heavy.graph_fallbacks": 1, "heavy.eager": 1}
    assert torch.equal(first, eager) and torch.equal(again, eager)


PATHS = {                   # pipeline options, batch, size, aux type
    "point": ({}, 1, 512, "point_mask"),
    "batch9-split": ({}, 9, 512, "trimap"),
    "vae_chunk": ({"vae_chunk": 2}, 4, 512, "trimap"),
    "fastest": ({"speed_mode": "fastest"}, 1, 1024, "trimap"),
    "vae_int8": ({"vae_int8": True}, 1, 512, "trimap"),
    "int8-storage": ({"weight_storage": "int8"}, 1, 512, "trimap"),
    "plain": ({"impl": "plain"}, 1, 512, "trimap"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_every_path_is_captured_and_replays_like_its_eager_run(card_pipe, path):
    kw, b, size, aux = PATHS[path]
    pipe = MattingPipeline(card_pipe.model, policy=BF16, device=card_pipe.device, **kw)
    before = _counts()
    diffs = []
    for seed in (1, 2, 3):
        img_s, pm_s, coords, is_trans = _card_inputs(pipe, b, size, seed)
        if aux == "point_mask":
            coords = torch.tensor([[0.4, 0.5, 0.6, 0.45]] * b, device=pipe.device)
        with torch.no_grad():
            eager = pipe._model_alpha(img_s, pm_s, coords, is_trans, None, aux_type=aux)
            got = pipe._heavy(img_s, pm_s, coords, is_trans, aux_type=aux)
        diffs.append((eager - got).abs().max().item())
    print(f"{path}: max |eager - graphed| by call {diffs}")
    assert max(diffs) <= 1e-3
    d = _delta(before)
    assert (d["heavy.graph_captures"], d["heavy.graph_replays"], d["heavy.graph_fallbacks"]) \
        == (1, 2, 0)
