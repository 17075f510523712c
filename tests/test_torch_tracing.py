"""The span recorder of ``utils/observability.py`` and the program's three
span sites: off by default and then recording nothing, nesting and threads,
the bounded buffer, one ``pipeline.heavy`` a pipeline call and no span
inside it, the MicroBatcher's ``serve.queued`` and ``serve.batch`` tied by
request id, and the clock: a span around a torch op contains the op's
profiler event, and no span reaches the profiler's event stream.

This file imports no JAX, so that its ``cuda`` case runs on the card alone:
``python -m pytest tests/test_torch_tracing.py -m cuda --noconftest``.
"""

import collections
import importlib.util
import pathlib
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sdmatte_tpu_torch.api.serve import MicroBatcher
from sdmatte_tpu_torch.configs import SDMatteConfig
from sdmatte_tpu_torch.models.sdmatte import SDMatte
from sdmatte_tpu_torch.ops import quant
from sdmatte_tpu_torch.pipeline import MattingPipeline, PipelineOptions
from sdmatte_tpu_torch.utils import observability as obs

WAIT_S = 30
OPTS = PipelineOptions(inference_size=64)


@pytest.fixture(autouse=True)
def _recorder_off():
    obs.drain()
    yield
    obs.drain()


def _by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


def _inputs():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:64, 0:64]
    r = np.hypot(yy - 32, xx - 32)
    tri = np.where(r < 12, 1.0, np.where(r < 22, 0.5, 0.0)).astype(np.float32)
    return img, tri


@pytest.fixture(scope="module")
def tiny_model():
    torch.manual_seed(0)
    return SDMatte(SDMatteConfig.tiny()).eval()


@pytest.fixture
def int8_pipe(tiny_model, monkeypatch):
    monkeypatch.setattr(quant, "STORAGE_MIN_ELEMS", 1024)
    pipe = MattingPipeline(tiny_model, device="cpu", weight_storage="int8")
    assert any("weight_i8" in m._buffers for m in pipe.model.modules())
    return pipe


# ------------------------------------------------------------ the recorder ---

def test_off_by_default_and_records_nothing():
    assert obs.ON is False
    with obs.span("pipeline.heavy", images=1) as s:
        assert s is obs._OFF
    obs.record("serve.queued", 1, 2, request=0)
    assert len(obs._buffer) == 0
    assert obs.drain() == obs.Drained([], 0)


def test_nesting_parents_and_threads():
    obs.start()
    with obs.span("outer", k=1) as outer:
        assert outer.start_ns is not None
        with obs.span("inner"):
            pass
        with obs.span("second"):
            with obs.span("deep"):
                pass

    def other():
        with obs.span("elsewhere"):
            pass
    t = threading.Thread(target=other)
    t.start()
    t.join(WAIT_S)
    spans, dropped = obs.drain()
    assert dropped == 0
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["inner", "deep", "second", "outer", "elsewhere"]
    assert by["outer"].parent is None and by["outer"].attrs == {"k": 1}
    assert by["inner"].parent == by["second"].parent == by["outer"].id
    assert by["deep"].parent == by["second"].id
    assert by["elsewhere"].parent is None
    me = threading.get_ident()
    assert {by[n].thread for n in ("outer", "inner", "second", "deep")} == {me}
    assert by["elsewhere"].thread not in (me, None)
    o = by["outer"]
    for n in ("inner", "second", "deep"):
        assert o.start_ns <= by[n].start_ns <= by[n].end_ns <= o.end_ns
    assert by["inner"].end_ns <= by["second"].start_ns
    assert len({s.id for s in spans}) == len(spans)
    assert obs._stack() == []


def test_record_keeps_the_given_stamps_and_has_no_parent():
    obs.start()
    with obs.span("outer"):
        obs.record("serve.queued", 100, 250, request=7)
    spans, _ = obs.drain()
    q = next(s for s in spans if s.name == "serve.queued")
    assert (q.start_ns, q.end_ns, q.parent, q.attrs) == (100, 250, None, {"request": 7})
    assert q.thread == threading.get_ident()


def test_buffer_is_bounded_and_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(obs, "_buffer", deque(maxlen=4))
    obs.start()
    for i in range(10):
        with obs.span(f"s{i}"):
            pass
    spans, dropped = obs.drain()
    assert [s.name for s in spans] == ["s6", "s7", "s8", "s9"] and dropped == 6
    obs.start()
    with obs.span("fresh"):
        pass
    spans, dropped = obs.drain()
    assert [s.name for s in spans] == ["fresh"] and dropped == 0


def test_a_span_open_at_drain_is_not_kept_and_the_stack_unwinds():
    obs.start()
    with obs.span("open"):
        spans, _ = obs.drain()
        assert spans == []
    assert obs._stack() == [] and len(obs._buffer) == 0
    with obs.span("after"):
        pass
    assert len(obs._buffer) == 0


# --------------------------------------------------------- the span sites ---

def test_pipeline_call_records_heavy_and_unet_once(tiny_model):
    pipe = MattingPipeline(tiny_model, device="cpu")
    img, tri = _inputs()
    off, _ = pipe(img, tri, options=OPTS)
    obs.start()
    on, _ = pipe(img, tri, options=OPTS)
    spans, dropped = obs.drain()
    by = _by_name(spans)
    assert dropped == 0 and sorted(by) == ["pipeline.heavy"]
    (heavy,) = by["pipeline.heavy"]
    assert heavy.attrs == {} and heavy.parent is None and heavy.start_ns <= heavy.end_ns
    torch.testing.assert_close(on, off, rtol=0, atol=0)


class _Stub:
    def __init__(self, per_call_s=0.05):
        self.per_call_s = per_call_s

    def __call__(self, imgs, tris, *, options):
        time.sleep(self.per_call_s)
        b, h, w = imgs.shape[:3]
        return torch.zeros((b, h, w)), torch.zeros((b, h, w, 3))


def test_microbatcher_spans_tie_each_request_to_its_batch():
    mb = MicroBatcher(_Stub(), window_ms=30.0, max_batch=4)
    img, tri = np.zeros((16, 16, 3), np.float32), np.zeros((16, 16), np.float32)
    try:
        mb.submit(img, tri, OPTS)            # before recording: not in the spans
        calls0 = mb.batch_calls
        obs.start()
        threads = [threading.Thread(target=mb.submit, args=(img, tri, OPTS))
                   for _ in range(10)]
        for t in threads:
            t.start()
            time.sleep(0.005)
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        mb.shutdown()          # the worker leaves its last serve.batch span first
    spans, dropped = obs.drain()
    calls = mb.batch_calls - calls0
    by = _by_name(spans)
    queued, batches = by["serve.queued"], by["serve.batch"]
    assert dropped == 0 and sorted(by) == ["serve.batch", "serve.queued"]
    assert len(queued) == 10 and len(batches) == calls >= 3
    rids = [q.attrs["request"] for q in queued]
    assert sorted(rids) == list(range(1, 11))
    assert sorted(r for b in batches for r in b.attrs["requests"]) == sorted(rids)
    worker = {b.thread for b in batches}
    assert len(worker) == 1
    for b in batches:
        ending = sorted(q.attrs["request"] for q in queued if q.end_ns == b.start_ns)
        assert ending == sorted(b.attrs["requests"])
        assert b.start_ns <= b.end_ns and b.parent is None
    for q in queued:
        assert q.start_ns <= q.end_ns and q.thread in worker


# -------------------------------------------------------------- the clock ---

def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return list(prof.profiler.kineto_results.events())


def test_a_span_contains_the_profiler_event_of_the_op_inside_it():
    a = torch.randn(128, 128)
    a @ a
    obs.start()

    def work():
        with obs.span("pipeline.heavy"):
            torch.mm(a, a)
    events = _profiled(work)
    spans, _ = obs.drain()
    (s,) = spans
    (mm,) = [e for e in events if e.name() == "aten::mm"]
    assert s.start_ns <= mm.start_ns() <= mm.start_ns() + mm.duration_ns() <= s.end_ns


def test_the_profiler_gains_no_event_from_the_spans(int8_pipe):
    img, tri = _inputs()
    int8_pipe(img, tri, options=OPTS)

    def call():
        int8_pipe(img, tri, options=OPTS)
    off = collections.Counter(e.name() for e in _profiled(call))
    obs.start()
    on = collections.Counter(e.name() for e in _profiled(call))
    spans, _ = obs.drain()
    names = {s.name for s in spans}
    assert names == {"pipeline.heavy"}
    assert on == off
    assert not names & set(on)


# ---------------------------------------------- the readings of the spans ---

def _tool():
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "span_readings.py"
    spec = importlib.util.spec_from_file_location("span_readings", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_union_overlap_and_nearest_rank():
    t = _tool()
    assert t.union([(5, 10), (1, 3), (2, 4), (10, 12)]) == [[1, 4], [5, 12]]
    assert t.overlap([[1, 4], [5, 12]], [[0, 2], [3, 6], [11, 20]]) == 1 + 1 + 1 + 1
    assert t.overlap([], [[0, 1]]) == 0
    assert t.nearest_rank(list(range(1, 21)), 0.95) == 19 and t.nearest_rank([], 0.5) is None


def test_span_readings_on_synthetic_spans():
    """Hand-computed: the stretch 100-150 ms holds busy 110-120 and 130-140,
    so idle 100-110, 120-130, 140-150 (30 ms) over 2 mattes."""
    ms, t = 1_000_000, _tool()
    ids = iter(range(1000))

    def sp(name, a, b, **attrs):
        return obs.Span(next(ids), name, int(a * ms), int(b * ms), 1, None, attrs)
    spans = [sp("pipeline.heavy", 10, 60), sp("pipeline.heavy", 60, 90),       # before
             sp("pipeline.heavy", 105, 135), sp("pipeline.heavy", 145, 148)]   # in the stretch
    spans += [sp("serve.queued", 10 * i, 11 * i, request=i) for i in range(1, 21)]
    spans += [sp("serve.queued", 250, 260, request=21),                        # after the window
              sp("serve.batch", 55, 56, requests=[5]),                         # ids match
              sp("serve.batch", 125, 142, requests=[7])]                       # request 7 ends at 77
    busy = [[110 * ms, 120 * ms], [130 * ms, 140 * ms]]
    got = t.readings(spans, busy, (100 * ms, 150 * ms), 2, (0, 200 * ms))
    assert got["idle_ms_per_matte"] == 15.0
    assert got["pipeline.heavy_idle_ms"] == (5 + 10 + 3) / 2
    assert not {"model.unet_idle_ms", "quant.dequant_ms", "dequant_spans_per_matte"} & set(got)
    assert (got["serve.queue_wait_ms"], got["queue_wait_p50_ms"]) == (19.0, 10.0)
    assert got["queue_wait_samples"] == 20
    assert got["serve_batches"] == 2 and got["serve_batches_whose_ids_mismatch"] == 1
    assert got["serve.host_idle_ms"] == (5 + 2) / 2
    assert got["serve.waiting_idle_ms"] == 15.0 - 3.5


# ------------------------------------------------------------- on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the hand kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_span_contains_the_k1_launch_on_the_card(cuda):
    """A span around one K1 launch holds the launch's runtime call, and
    starts no later than the kernel starts on the card: spans and the
    profiler's host and device events share one clock."""
    from sdmatte_tpu_torch.ops.flash_attention import flash_attention
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(1, 5, 4096, 64, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    flash_attention(q, k, v, scale=0.125)
    torch.cuda.synchronize(cuda)
    obs.start()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with obs.span("pipeline.heavy"):
            flash_attention(q, k, v, scale=0.125)
        torch.cuda.synchronize(cuda)
    (s,), _ = obs.drain()
    events = list(prof.profiler.kineto_results.events())
    kernels = [e for e in events if str(e.device_type()).endswith("CUDA")
               and "flash_fwd_sm90" in e.name()]
    assert len(kernels) == 1, [e.name() for e in events if str(e.device_type()).endswith("CUDA")]
    kern = kernels[0]
    launches = [e for e in events if not str(e.device_type()).endswith("CUDA")
                and e.name().startswith("cu") and e.correlation_id() == kern.correlation_id()]
    assert len(launches) == 1, sorted({e.name() for e in events})
    rt = launches[0]
    assert s.start_ns <= rt.start_ns() <= rt.start_ns() + rt.duration_ns() <= s.end_ns
    assert s.start_ns <= kern.start_ns()
