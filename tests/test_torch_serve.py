"""The port's HTTP server: the micro-batcher with a stub pipeline (the cases
of tests/test_serve.py, with "stacks exactly n" in place of the JAX
server's power-of-two buckets), real round trips through a socket on a
tiny fp32 CPU pipeline, held against direct pipeline calls on the same
decoded inputs, and the same payloads sent to the JAX package's server on
the same weights: alphas within one 8-bit step, the same status codes and
error messages.  Every wait is bounded (30 s at most); servers bind port 0
and shut down in ``finally``.
"""

import base64
import io
import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import _randomized_params
from sdmatte_tpu.api import serve as jax_serve
from sdmatte_tpu.configs import SDMatteConfig as JaxSDMatteConfig
from sdmatte_tpu.pipeline import MattingPipeline as JaxPipeline

from sdmatte_tpu_torch.api import serve as serve_mod
from sdmatte_tpu_torch.api.serve import (MicroBatcher, RequestTimeout,
                                         ServiceOverloaded)
from sdmatte_tpu_torch.checkpoint.convert import load_params
from sdmatte_tpu_torch.configs import SDMatteConfig
from sdmatte_tpu_torch.models.sdmatte import SDMatte
from sdmatte_tpu_torch.pipeline import MattingPipeline, PipelineOptions
from sdmatte_tpu_torch.utils.images import pil_to_unit_array, to_uint8

WAIT_S = 30


def _png_b64(arr):
    buf = io.BytesIO()
    Image.fromarray(to_uint8(arr).squeeze()).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _decode(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


class _Server:
    def __init__(self, pipe, module=serve_mod, **kw):
        if module is serve_mod:
            self.httpd = serve_mod.serve(pipe, port=0, **kw)
            self.batcher = self.httpd.service.batcher
        else:   # the JAX server keeps its service inside its handler class
            service = module.MattingService(pipe, **kw)
            self.httpd = module.ThreadingHTTPServer(("127.0.0.1", 0),
                                                    module.make_handler(service))
            self.batcher = service.batcher
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.shutdown()
        self.thread.join(timeout=WAIT_S)
        assert not self.thread.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT_S) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def params():
    return _randomized_params(JaxSDMatteConfig.tiny(), seed=6)


@pytest.fixture(scope="module")
def pipe(params):
    return MattingPipeline(load_params(SDMatte(SDMatteConfig.tiny()), params), device="cpu")


@pytest.fixture(scope="module")
def server(pipe):
    srv = _Server(pipe, window_ms=300.0)
    try:
        yield srv
    finally:
        srv.close()


def test_healthz_and_metrics(server):
    code, body = _get(server.url + "/healthz")
    assert code == 200 and body == {"status": "ok", "backend": "cpu", "device": "cpu"}
    code, body = _get(server.url + "/metrics")
    assert code == 200 and "counters" in body


def _request(rng, h, w, **kw):
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    tri = rng.choice([0.0, 0.5, 1.0], (h, w)).astype(np.float32)
    return {"image": _png_b64(img), "trimap": _png_b64(tri), "inference_size": 64, **kw}


def _direct(pipe, payload, mode="alpha_only"):
    """The direct call on the decoded inputs, quantized as the server does."""
    img = pil_to_unit_array(Image.open(io.BytesIO(base64.b64decode(payload["image"]))), 3)
    tri = pil_to_unit_array(Image.open(io.BytesIO(base64.b64decode(payload["trimap"]))), 1)[..., 0]
    alpha, matted = pipe(img, tri, options=PipelineOptions(inference_size=64, output_mode=mode))
    return to_uint8(alpha[0].numpy()), to_uint8(matted[0].numpy())


def test_round_trip_matches_the_direct_call(server, pipe):
    payload = _request(np.random.default_rng(1), 70, 50, output_mode="matted_rgba")
    code, body = _post(server.url + "/v1/matte", payload)
    assert code == 200, body
    alpha, matted = _decode(body["alpha"]), _decode(body["matted"])
    ref_alpha, ref_matted = _direct(pipe, payload, "matted_rgba")
    assert alpha.shape == (70, 50) and matted.shape == (70, 50, 4)
    assert np.array_equal(alpha, ref_alpha) and np.array_equal(matted, ref_matted)
    assert body["ms"] > 0
    _, metrics = _get(server.url + "/metrics")
    assert metrics["counters"]["requests"] >= 1


def test_concurrent_requests_coalesce_into_one_call(server, pipe):
    """Four same-shape requests inside the window run as ONE pipeline call of
    batch 4; a request of another size takes a call of its own; each alpha
    meets its direct batch-1 call."""
    rng = np.random.default_rng(2)
    payloads = [_request(rng, 40, 60) for _ in range(4)]
    batcher = server.batcher
    calls0 = batcher.batch_calls
    results = [None] * 4
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, _post(server.url + "/v1/matte", payloads[i]))) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert batcher.batch_calls == calls0 + 1
    for (code, body), payload in zip(results, payloads):
        assert code == 200, body
        diff = np.abs(_decode(body["alpha"]).astype(int) - _direct(pipe, payload)[0].astype(int))
        assert diff.max() <= 1 and diff.mean() <= 0.05
    code, body = _post(server.url + "/v1/matte", _request(rng, 33, 47))
    assert code == 200 and _decode(body["alpha"]).shape == (33, 47)
    assert batcher.batch_calls == calls0 + 2


# refused payloads: (fields over a valid request, a word of the 400 message)
_BAD = (({"inference_size": 123}, "inference_size"),
        ({"inference_size": "big"}, "inference_size"),
        ({"output_mode": "nope"}, "output_mode"),
        ({"trimap_constraint": 7.0}, "trimap_constraint"),
        ({"trimap_constraint": [0.5]}, "trimap_constraint"),
        ({"image": "bm90YXBuZw=="}, "undecodable"),
        ({"prompt_type": "telepathy"}, "prompt_type"),
        ({"prompt_type": "point_mask"}, "requires coords"),
        ({"prompt_type": "point_mask", "coords": [0.5]}, "point coords"),
        ({"prompt_type": "bbox_mask", "coords": [0, 0, 1]}, "coords"),
        ({"coords": ["a", "b", "c", "d"]}, "coords"))


def test_server_matches_the_jax_server(server, params, monkeypatch):
    """The same payloads through both packages' servers on the same weights:
    decoded alphas and matted images within one 8-bit step, and the same
    status code and error message for every refused request."""
    jax_pipe = JaxPipeline(params, JaxSDMatteConfig.tiny(), attn_impl="xla")
    ref = _Server(jax_pipe, module=jax_serve, window_ms=1.0)
    try:
        rng = np.random.default_rng(8)
        for payload in (_request(rng, 70, 50, output_mode="matted_rgba"),
                        _request(rng, 32, 32, prompt_type="bbox_mask",
                                 coords=[0.1, 0.1, 0.9, 0.8])):
            (code, body), (ref_code, ref_body) = (_post(s.url + "/v1/matte", payload)
                                                  for s in (server, ref))
            assert code == ref_code == 200, (body, ref_body)
            for key in ("alpha", "matted"):
                got, want = _decode(body[key]), _decode(ref_body[key])
                assert got.shape == want.shape
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, key
        ok = _request(rng, 16, 16)
        for payload in [dict(ok, **bad) for bad, _ in _BAD] + [{"image": ok["image"]}, {}]:
            # a decoder's message may name an object's address
            got, want = ((code, re.sub(r"0x[0-9a-f]+", "0x", body["error"]))
                         for code, body in (_post(s.url + "/v1/matte", payload)
                                            for s in (server, ref)))
            assert got == want and got[0] == 400, (payload.keys(), got, want)
        assert _post(server.url + "/v1/nope", {}) == _post(ref.url + "/v1/nope", {})
        for mod in (serve_mod, jax_serve):
            monkeypatch.setattr(mod, "MAX_BODY_BYTES", 64)
        big = _request(rng, 16, 16)
        got, want = (_post(s.url + "/v1/matte", big) for s in (server, ref))
        assert got == want and got[0] == 413
    finally:
        ref.close()


def test_validation_is_400(server):
    ok = _request(np.random.default_rng(3), 16, 16)
    for bad, field in _BAD:
        code, body = _post(server.url + "/v1/matte", dict(ok, **bad))
        assert code == 400 and field in body["error"], (bad, code, body)
    code, body = _post(server.url + "/v1/matte", {"image": ok["image"]})
    assert code == 400 and "trimap" in body["error"]


def test_unknown_route_is_404_and_large_body_413(server, monkeypatch):
    assert _post(server.url + "/v1/nope", {})[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server.url + "/nope", timeout=WAIT_S)
    assert e.value.code == 404
    monkeypatch.setattr(serve_mod, "MAX_BODY_BYTES", 64)
    code, body = _post(server.url + "/v1/matte", _request(np.random.default_rng(4), 16, 16))
    assert code == 413 and "exceeds" in body["error"]


def test_exotic_png_modes_canonicalized(server):
    def b64(im):
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()
    code, body = _post(server.url + "/v1/matte", {
        "image": b64(Image.new("LA", (24, 16), (128, 200))),
        "trimap": b64(Image.new("P", (24, 16), 3)), "inference_size": 64})
    assert code == 200, body
    assert _decode(body["alpha"]).shape == (16, 24)


def test_bbox_prompt_over_http(server):
    code, body = _post(server.url + "/v1/matte", _request(
        np.random.default_rng(5), 32, 32, prompt_type="bbox_mask", coords=[0.1, 0.1, 0.9, 0.8]))
    assert code == 200 and "alpha" in body


def test_point_prompt_over_http_matches_jax_server(server, params):
    """A point_mask request with two points: 200 from both packages'
    servers on the same weights, alphas within one 8-bit step."""
    jax_pipe = JaxPipeline(params, JaxSDMatteConfig.tiny(), attn_impl="xla")
    ref = _Server(jax_pipe, module=jax_serve, window_ms=1.0)
    try:
        payload = _request(np.random.default_rng(9), 40, 36, prompt_type="point_mask",
                           coords=[0.3, 0.4, 0.6, 0.5])
        (code, body), (ref_code, ref_body) = (_post(s.url + "/v1/matte", payload)
                                              for s in (server, ref))
        assert code == ref_code == 200, (body, ref_body)
        got, want = _decode(body["alpha"]), _decode(ref_body["alpha"])
        assert got.shape == want.shape == (40, 36)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    finally:
        ref.close()


def test_warmup_runs_batches_above_8(monkeypatch):
    """--max-batch 9 --warmup: the real warmup runs batches 1..9 (9 is a
    split encode) on the worker before the server serves (stopped here as
    soon as the warmup ends)."""
    seen = {}
    warmed = threading.Event()
    real_warmup = MattingPipeline.warmup

    def warmup(self, **kw):
        try:
            seen["timings"] = real_warmup(self, **kw)
        finally:
            warmed.set()
        return seen["timings"]

    def fake_serve_forever(self, *a, **k):
        assert warmed.wait(timeout=120)

    monkeypatch.setattr(MattingPipeline, "warmup", warmup)
    monkeypatch.setattr(serve_mod.ThreadingHTTPServer, "serve_forever", fake_serve_forever)
    import sdmatte_tpu_torch.configs as cfgs
    monkeypatch.setattr(cfgs, "SDMatteConfig", SDMatteConfig.tiny)   # a tiny model
    assert serve_mod.main(["--random-weights", "--cpu", "--warmup", "64",
                           "--max-batch", "9", "--port", "0"]) == 0
    assert sorted(seen["timings"]) == [(64, b) for b in range(1, 10)]


def test_overload_and_timeout_over_http():
    """429 when the queue is full, 504 past the deadline."""
    stub = _StubPipeline(per_call_s=1.0)
    srv = _Server(stub, window_ms=1.0, max_batch=1, max_queue=1, request_timeout_s=0.3)
    try:
        payload = _request(np.random.default_rng(6), 16, 16)
        codes = []
        threads = [threading.Thread(target=lambda: codes.append(
            _post(srv.url + "/v1/matte", payload)[0])) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert 504 in codes and 429 in codes, codes
    finally:
        srv.close()


# ---------------------------------------------------------------- batching --

class _StubPipeline:
    """Counts calls; sleeps a fixed 'device time' per CALL (not per image)."""

    def __init__(self, per_call_s=0.05):
        self.calls = 0
        self.batch_sizes = []
        self.per_call_s = per_call_s

    def __call__(self, imgs, tris, *, options):
        self.calls += 1
        b = imgs.shape[0]
        self.batch_sizes.append(b)
        time.sleep(self.per_call_s)
        h, w = imgs.shape[1], imgs.shape[2]
        return torch.zeros((b, h, w)), torch.zeros((b, h, w, 3))


def _run_threads(fn, args_list):
    threads = [threading.Thread(target=fn, args=a) for a in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)


def _zeros(h=16, w=16):
    return np.zeros((h, w, 3), np.float32), np.zeros((h, w), np.float32)


def test_microbatch_coalesces_concurrent_requests():
    stub = _StubPipeline(per_call_s=0.08)
    mb = MicroBatcher(stub, window_ms=30.0, max_batch=8)
    opts = PipelineOptions(inference_size=64)
    img, tri = _zeros(32, 48)
    try:
        t0 = time.perf_counter()
        mb.submit(img, tri, opts)
        t_single = time.perf_counter() - t0
        results = [None] * 4
        t0 = time.perf_counter()
        _run_threads(lambda i: results.__setitem__(i, mb.submit(img, tri, opts)),
                     [(i,) for i in range(4)])
        t_four = time.perf_counter() - t0
    finally:
        mb.shutdown()
    assert all(r is not None and r[0].shape == (32, 48) for r in results)
    assert isinstance(results[0][0], np.ndarray)
    assert stub.calls <= 3 and max(stub.batch_sizes) >= 2
    assert t_four < 2 * t_single + 0.2


def test_microbatch_mixed_keys_fifo():
    stub = _StubPipeline(per_call_s=0.005)
    mb = MicroBatcher(stub, window_ms=5.0, max_batch=8)
    o1 = PipelineOptions(inference_size=64)
    o2 = PipelineOptions(inference_size=64, output_mode="matted_rgba")
    outs = []
    try:
        _run_threads(lambda h, o: outs.append(mb.submit(*_zeros(h, 40), o)),
                     [(32, o1), (48, o1), (32, o2), (32, o1)])
    finally:
        mb.shutdown()
    assert len(outs) == 4
    assert 3 <= stub.calls <= 4


def test_microbatch_stacks_exactly_n():
    """A 3-request burst runs as ONE call of batch 3 (no padding rows), and
    each caller gets its own row."""
    class _Marking(_StubPipeline):
        def __call__(self, imgs, tris, *, options):
            alpha, matted = super().__call__(imgs, tris, options=options)
            return alpha + torch.from_numpy(imgs[:, :1, :1, 0]), matted

    stub = _Marking(per_call_s=0.01)
    mb = MicroBatcher(stub, window_ms=300.0, max_batch=8)
    opts = PipelineOptions(inference_size=64)
    results = [None] * 3

    def worker(i):
        img, tri = _zeros()
        img[0, 0, 0] = i + 1
        results[i] = mb.submit(img, tri, opts)

    try:
        _run_threads(worker, [(i,) for i in range(3)])
    finally:
        mb.shutdown()
    assert stub.batch_sizes == [3]
    assert [float(r[0][0, 0]) for r in results] == [1.0, 2.0, 3.0]


def test_batch_key_includes_trimap_shape():
    stub = _StubPipeline(per_call_s=0.01)
    mb = MicroBatcher(stub, window_ms=40.0, max_batch=8)
    opts = PipelineOptions(inference_size=64)
    img = np.zeros((32, 48, 3), np.float32)
    outs = []
    try:
        _run_threads(lambda th, tw: outs.append(mb.submit(img, np.zeros((th, tw), np.float32),
                                                          opts)),
                     [(32, 48), (16, 24), (32, 48)])
    finally:
        mb.shutdown()
    assert len(outs) == 3 and all(o[0].shape == (32, 48) for o in outs)
    assert stub.calls >= 2


def test_queue_overflow_raises_overloaded():
    stub = _StubPipeline(per_call_s=0.3)
    mb = MicroBatcher(stub, window_ms=1.0, max_batch=1, max_queue=2)
    opts = PipelineOptions(inference_size=64)
    errs = []

    def worker():
        try:
            mb.submit(*_zeros(), opts)
        except ServiceOverloaded as e:
            errs.append(e)

    try:
        _run_threads(worker, [() for _ in range(8)])
    finally:
        mb.shutdown()
    assert errs


def test_request_timeout():
    stub = _StubPipeline(per_call_s=2.0)
    mb = MicroBatcher(stub, window_ms=1.0, max_batch=1, request_timeout_s=0.3)
    try:
        with pytest.raises(RequestTimeout):
            mb.submit(*_zeros(), PipelineOptions(inference_size=64))
    finally:
        mb.shutdown()


def test_poisoned_request_does_not_wedge_batcher():
    class _Poisonable(_StubPipeline):
        def __call__(self, imgs, tris, *, options):
            if float(imgs.max()) > 0.5:
                raise ValueError("poisoned input")
            return super().__call__(imgs, tris, options=options)

    mb = MicroBatcher(_Poisonable(per_call_s=0.01), window_ms=1.0, max_batch=8,
                      request_timeout_s=5.0)
    opts = PipelineOptions(inference_size=64)
    tri = np.zeros((16, 16), np.float32)
    try:
        with pytest.raises(ValueError, match="poisoned"):
            mb.submit(np.ones((16, 16, 3), np.float32), tri, opts)
        alpha, _ = mb.submit(np.zeros((16, 16, 3), np.float32), tri, opts)
    finally:
        mb.shutdown()
    assert alpha.shape == (16, 16)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_death_fails_fast_not_forever():
    class _Lethal(_StubPipeline):
        def __call__(self, imgs, tris, *, options):
            raise SystemExit("simulated interpreter teardown")

    mb = MicroBatcher(_Lethal(), window_ms=1.0, max_batch=1, request_timeout_s=WAIT_S)
    opts = PipelineOptions(inference_size=64)
    with pytest.raises(RuntimeError, match="worker terminated"):
        mb.submit(*_zeros(), opts)
    mb._worker.join(timeout=5)
    assert not mb._worker.is_alive()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="worker died"):
        mb.submit(*_zeros(), opts)
    assert time.perf_counter() - t0 < 10


def test_microbatch_coords_batch_as_data():
    class _CoordStub(_StubPipeline):
        def __init__(self):
            super().__init__(per_call_s=0.02)
            self.coords_seen = []

        def __call__(self, imgs, tris, *, options, coords=None):
            self.coords_seen.append(None if coords is None else np.asarray(coords))
            return super().__call__(imgs, tris, options=options)

    stub = _CoordStub()
    mb = MicroBatcher(stub, window_ms=60.0, max_batch=8)
    opts = PipelineOptions(inference_size=64, aux_input="bbox_mask")
    c1 = np.asarray([0.0, 0.0, 1.0, 1.0], np.float32)
    c2 = np.asarray([0.2, 0.2, 0.8, 0.8], np.float32)
    results = [None] * 3
    try:
        _run_threads(lambda i, c: results.__setitem__(i, mb.submit(*_zeros(32, 32), opts,
                                                                   coords=c)),
                     [(0, c1), (1, c2), (2, None)])
    finally:
        mb.shutdown()
    assert all(r is not None for r in results)
    assert stub.calls == 2
    with_c = [c for c in stub.coords_seen if c is not None]
    assert len(with_c) == 1 and with_c[0].shape == (2, 4)
    assert {tuple(r) for r in with_c[0]} == {tuple(c1), tuple(c2)}


def test_warmup_flag_warms_each_batch_size(monkeypatch):
    """--warmup runs every batch size 1..--max-batch once per size, on the
    CPU with --cpu, on the micro-batcher's worker thread (torch's library
    handles are per thread); the server then serves (stopped here at once)."""
    seen = {}
    warmed = threading.Event()

    def fake_warmup(self, *, sizes, batch_sizes, options=None):
        seen.update(sizes=sizes, batches=list(batch_sizes), thread=threading.current_thread())
        warmed.set()
        return {}

    def fake_serve_forever(self, *a, **k):
        assert warmed.wait(timeout=WAIT_S)
        seen["worker"] = self.service.batcher._worker

    monkeypatch.setattr(MattingPipeline, "warmup", fake_warmup)
    monkeypatch.setattr(serve_mod.ThreadingHTTPServer, "serve_forever", fake_serve_forever)
    import sdmatte_tpu_torch.configs as cfgs
    monkeypatch.setattr(cfgs, "SDMatteConfig", SDMatteConfig.tiny)   # a tiny model
    assert serve_mod.main(["--random-weights", "--cpu", "--warmup", "64,128",
                           "--max-batch", "3", "--port", "0"]) == 0
    assert seen["sizes"] == (64, 128) and seen["batches"] == [1, 2, 3]
    assert seen["thread"] is seen["worker"]
