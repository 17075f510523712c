"""HTTP matting service of the port (sdmatte_tpu/api/serve.py).

One process owns the card; concurrent requests coalesce into batched
pipeline calls.

Endpoints:
  GET  /healthz            -> {"status": "ok", "backend": "cuda"|"cpu", "device": ...}
  GET  /metrics            -> utils.observability metrics summary (JSON)
  POST /v1/matte           -> JSON request:
        {"image": <base64 PNG>, "trimap": <base64 PNG>,
         "inference_size": 1024, "output_mode": "alpha_only",
         "mask_refine": true, "trimap_constraint": 0.8,
         "is_transparent": false,
         "prompt_type": "trimap",       # |mask|bbox_mask|point_mask|auto_mask
         "coords": [0, 0, 1, 1]}        # optional; REQUIRED for point_mask
                                        # (x1,y1,x2,y2,... normalized)
      response: {"alpha": <base64 PNG>, "matted": <base64 PNG>, "ms": float}

A micro-batching queue coalesces concurrent requests that share a batchable
key (input size + options) into ONE pipeline call; a lone request still
dispatches after at most ``window_ms`` of coalescing delay.  The batch is
exactly the requests that coalesced: PyTorch runs eagerly and compiles
nothing per batch size, so the JAX server's padding to power-of-two batch
buckets (which bounds XLA recompiles) has no use here.

Run: python -m sdmatte_tpu_torch.api.serve --ckpt SDMatte.safetensors --port 8700
     (--random-weights for a weight-less smoke deployment, --cpu for fp32
     on the CPU; without --cpu and without CUDA it exits with an error)
"""

from __future__ import annotations

import argparse
import base64
import io
import itertools
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

from ..configs import AUX_INPUT_COORDS
from ..pipeline import MattingPipeline, PipelineOptions
from ..pipeline.postprocess import OUTPUT_MODES as VALID_MODES
from ..utils.observability import METRICS, get_logger, record

_log = get_logger("sdmatte_tpu_torch.serve")

MAX_IMAGE_SIDE = 8192          # reject absurd decode bombs up front
MAX_BODY_BYTES = 128 << 20     # bound request reads (128 MB of JSON+base64)


def _png_to_array(b64: str, channels: int) -> np.ndarray:
    from PIL import Image
    from ..utils.images import pil_to_unit_array
    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    # Canonicalize so EVERY input mode (LA, P, CMYK, 16-bit, ...) lands at
    # exactly (H, W, 3) or (H, W, 1): the micro-batch key has no channel
    # component, so a surprise channel count would fail np.stack for the
    # whole coalesced batch, not just this request.
    return pil_to_unit_array(img, channels)


def _array_to_png_b64(arr: np.ndarray) -> str:
    from ..utils.images import save_png
    buf = io.BytesIO()
    save_png(buf, arr)
    return base64.b64encode(buf.getvalue()).decode()


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ServiceOverloaded(RuntimeError):
    """Queue is full — the caller should back off (HTTP 429)."""


class RequestTimeout(RuntimeError):
    """The request did not complete within the deadline (HTTP 504)."""


class _Pending:
    """One queued request: inputs + a completion event the worker signals;
    ``rid`` and ``queued_ns`` (when it joined the queue) tie its
    ``serve.queued`` span to its batch's ``serve.batch`` span."""

    __slots__ = ("img", "tri", "key", "opts", "coords", "done", "alpha",
                 "matted", "err", "rid", "queued_ns")

    def __init__(self, img, tri, key, opts, coords=None):
        self.img, self.tri, self.key, self.opts = img, tri, key, opts
        self.coords = coords
        self.done = threading.Event()
        self.alpha = self.matted = self.err = None
        self.rid = self.queued_ns = None


class MicroBatcher:
    """Coalesces concurrent requests into batched pipeline calls.

    A single worker thread owns the device.  Arriving requests append to a
    queue; the worker takes the oldest request, waits up to ``window_ms`` for
    more requests with the SAME batch key — (img H, img W, trimap shape,
    coords shape, PipelineOptions), the stacking precondition — stacks
    exactly those requests, runs ONE pipeline call, and distributes the
    per-image results.  Non-matching requests stay queued for the next
    cycle, so mixed traffic degrades to FIFO, never starves.

    Backpressure: the queue is bounded (``max_queue``; overflow raises
    ServiceOverloaded -> 429) and every request carries a deadline
    (``request_timeout_s`` -> 504).

    While the span recorder (utils/observability) is on, each request's
    wait in the queue is a ``serve.queued`` span and each batch's work on
    the worker (stacking, the pipeline call, the copies to the host, the
    hand-out) a ``serve.batch`` span; both carry the request ids that
    ``submit`` assigns.

    ``warmup``, where given, runs on the worker thread before its first
    batch: torch makes its cuBLAS and cuDNN handles per thread, so a warmup
    on another thread leaves the worker's first matte slower on the card
    (chip_smoke.py phase 6 (c) times it).
    """

    def __init__(self, pipeline, *, window_ms: float = 10.0,
                 max_batch: int = 8, max_queue: int = 64,
                 request_timeout_s: float = 600.0,
                 warmup: Optional[Callable[[], object]] = None):
        self.pipeline = pipeline
        self._warmup = warmup
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.request_timeout_s = request_timeout_s
        self._queue: list[_Pending] = []
        self._cv = threading.Condition()
        self._stop = False
        self.batch_calls = 0          # observability: pipeline invocations
        self._rids = itertools.count()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, img: np.ndarray, tri: np.ndarray,
               opts: PipelineOptions, coords: Optional[np.ndarray] = None):
        """Blocking: returns (alpha, matted) numpy arrays for ONE image.

        Raises ServiceOverloaded when the queue is at capacity and
        RequestTimeout if the item is not completed within
        ``request_timeout_s``.  The batch key includes the TRIMAP shape (the
        pipeline resizes image and trimap independently) and the coords
        shape (coords values batch as data)."""
        item = _Pending(img, tri,
                        (img.shape[0], img.shape[1], tri.shape,
                         None if coords is None else coords.shape, opts),
                        opts, coords)
        with self._cv:
            if len(self._queue) >= self.max_queue:
                METRICS.count("rejected_overload")
                raise ServiceOverloaded(
                    f"queue full ({self.max_queue} pending)")
            item.rid = next(self._rids)
            item.queued_ns = time.time_ns()
            self._queue.append(item)
            METRICS.observe("queue_depth", float(len(self._queue)))
            self._cv.notify()
        deadline = time.monotonic() + self.request_timeout_s
        # wait in slices so a dead worker thread is noticed promptly even
        # with a generous request deadline
        while not item.done.wait(timeout=min(
                1.0, max(0.0, deadline - time.monotonic()))):
            if not self._worker.is_alive():
                with self._cv:      # drop the item if still queued
                    if item in self._queue:
                        self._queue.remove(item)
                raise RuntimeError("micro-batcher worker died")
            if time.monotonic() >= deadline:
                with self._cv:
                    if item in self._queue:
                        self._queue.remove(item)
                METRICS.count("request_timeouts")
                raise RequestTimeout(
                    f"request not completed in {self.request_timeout_s:.0f}s")
        if item.err is not None:
            raise item.err
        return item.alpha, item.matted

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._worker.join(timeout=5)

    # -- worker ----------------------------------------------------------

    def _take_batch(self) -> list[_Pending]:
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait()
            if self._stop and not self._queue:
                return []
            head = self._queue[0]
            deadline = time.monotonic() + self.window_s
            while (len([x for x in self._queue if x.key == head.key])
                   < self.max_batch and not self._stop):
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(timeout=left)
            batch = []
            rest = []
            for x in self._queue:
                if x.key == head.key and len(batch) < self.max_batch:
                    batch.append(x)
                else:
                    rest.append(x)
            self._queue[:] = rest
            return batch

    def _run(self):
        if self._warmup is not None:
            self._warmup()
        while True:
            batch = self._take_batch()
            if not batch:
                if self._stop:
                    return
                continue
            taken_ns = time.time_ns()
            for x in batch:
                record("serve.queued", x.queued_ns, taken_ns, request=x.rid)
            try:
                imgs = np.stack([x.img for x in batch])
                tris = np.stack([x.tri for x in batch])
                # coords batch as data (the key guarantees one length);
                # absent everywhere -> the coords-free call
                if any(x.coords is not None for x in batch):
                    alpha, matted = self.pipeline(
                        imgs, tris, options=batch[0].opts,
                        coords=np.stack([x.coords for x in batch]))
                else:
                    alpha, matted = self.pipeline(imgs, tris, options=batch[0].opts)
                alpha, matted = _host(alpha), _host(matted)
                self.batch_calls += 1
                METRICS.count("batches")
                METRICS.observe("batch_size", float(len(batch)))
                for i, x in enumerate(batch):
                    x.alpha, x.matted = alpha[i], matted[i]
                    x.done.set()
            except Exception as e:
                # a poisoned request fails ITS batch only; the worker lives
                for x in batch:
                    x.err = e
                    x.done.set()
            except BaseException as e:  # pragma: no cover - defensive
                # KeyboardInterrupt/SystemExit escaping the pipeline: fail
                # the in-flight batch so no caller hangs, then re-raise
                # (submit()'s liveness check surfaces the dead worker to
                # everything still queued)
                for x in batch:
                    x.err = RuntimeError(f"worker terminated: {e!r}")
                    x.done.set()
                raise
            record("serve.batch", taken_ns, time.time_ns(), requests=[x.rid for x in batch])


class BadRequest(ValueError):
    """Client-side input error (HTTP 400)."""


class MattingService:
    """Owns the pipeline; requests coalesce through the micro-batcher."""

    def __init__(self, pipeline: MattingPipeline, *, window_ms: float = 10.0,
                 max_batch: int = 8, max_queue: int = 64,
                 request_timeout_s: float = 600.0,
                 warmup: Optional[Callable[[], object]] = None):
        self.pipeline = pipeline
        self.batcher = MicroBatcher(pipeline, window_ms=window_ms,
                                    max_batch=max_batch, max_queue=max_queue,
                                    request_timeout_s=request_timeout_s,
                                    warmup=warmup)

    def health(self) -> dict:
        dev = torch.device(getattr(self.pipeline, "device", "cpu"))
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        return {"status": "ok", "backend": dev.type, "device": name}

    def matte(self, req: dict) -> dict:
        for field in ("image", "trimap"):
            if field not in req:
                raise KeyError(field)
        try:
            img = _png_to_array(req["image"], 3)
            tri = _png_to_array(req["trimap"], 1)[..., 0]
        except Exception as e:
            raise BadRequest(f"undecodable image/trimap payload: {e}") from e
        for name, arr in (("image", img), ("trimap", tri)):
            if max(arr.shape[:2]) > MAX_IMAGE_SIDE or min(arr.shape[:2]) < 1:
                raise BadRequest(
                    f"{name} dimensions {arr.shape[:2]} outside "
                    f"[1, {MAX_IMAGE_SIDE}]")
        try:
            size = int(req.get("inference_size", 1024))
        except (TypeError, ValueError):
            raise BadRequest(
                f"inference_size {req.get('inference_size')!r} is not an "
                f"integer") from None
        # the latent stack downsamples 8x in the VAE and 8x across U-Net
        # stages: sizes must be multiples of 64
        if size % 64 != 0 or not 64 <= size <= 2048:
            raise BadRequest(
                f"inference_size {size} must be a multiple of 64 in "
                f"[64, 2048]")
        mode = str(req.get("output_mode", "alpha_only"))
        if mode not in VALID_MODES:
            raise BadRequest(f"output_mode {mode!r} not in {VALID_MODES}")
        prompt_type = str(req.get("prompt_type", "trimap"))
        if prompt_type not in AUX_INPUT_COORDS:
            raise BadRequest(f"prompt_type {prompt_type!r} not in "
                             f"{sorted(AUX_INPUT_COORDS)}")
        is_point = AUX_INPUT_COORDS[prompt_type] == "point_coords"
        coords = req.get("coords")
        if coords is not None:
            try:
                coords = np.asarray([float(v) for v in coords], np.float32)
            except (TypeError, ValueError):
                raise BadRequest(
                    "coords must be a flat list of numbers") from None
            if is_point:
                if coords.size == 0 or coords.size % 2 or coords.size > 1680:
                    raise BadRequest(
                        f"point coords need a non-empty even-length list "
                        f"(x1,y1,x2,y2,... <= 1680 values), got "
                        f"{coords.size}")
            elif coords.size != 4:
                raise BadRequest(
                    f"{prompt_type} coords must be [x0, y0, x1, y1], got "
                    f"{coords.size} values")
        elif is_point:
            raise BadRequest(f"prompt_type {prompt_type!r} requires coords")
        try:
            tc = float(req.get("trimap_constraint", 0.8))
        except (TypeError, ValueError):
            raise BadRequest(
                f"trimap_constraint {req.get('trimap_constraint')!r} is not "
                f"a number") from None
        if not 0.0 <= tc <= 1.0:
            raise BadRequest(f"trimap_constraint {tc} outside [0, 1]")
        opts = PipelineOptions(
            inference_size=size,
            is_transparent=bool(req.get("is_transparent", False)),
            output_mode=mode,
            mask_refine=bool(req.get("mask_refine", True)),
            trimap_constraint=tc,
            aux_input=prompt_type,
        )
        t0 = time.perf_counter()
        alpha_np, matted_np = self.batcher.submit(img, tri, opts,
                                                  coords=coords)
        ms = (time.perf_counter() - t0) * 1e3
        METRICS.count("requests")
        METRICS.observe_ms("matte_e2e", ms)
        return {"alpha": _array_to_png_b64(alpha_np),
                "matted": _array_to_png_b64(matted_np),
                "ms": round(ms, 1)}


def make_handler(service: MattingService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, service.health())
            elif self.path == "/metrics":
                self._send(200, METRICS.summary())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/matte":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY_BYTES:
                    self._send(413, {"error": f"body {n} bytes exceeds "
                                              f"{MAX_BODY_BYTES}"})
                    return
                req = json.loads(self.rfile.read(n))
                self._send(200, service.matte(req))
            except KeyError as e:
                self._send(400, {"error": f"missing field {e}"})
            except (BadRequest, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
            except ServiceOverloaded as e:
                self._send(429, {"error": str(e)})
            except RequestTimeout as e:
                self._send(504, {"error": str(e)})
            except Exception as e:  # pragma: no cover - defensive
                _log.exception("request failed")
                self._send(500, {"error": str(e)})

        def log_message(self, fmt, *args):
            _log.info("%s %s", self.address_string(), fmt % args)

    return Handler


def serve(pipeline: MattingPipeline, port: int = 8700, host: str = "127.0.0.1",
          **service_kwargs) -> ThreadingHTTPServer:
    """The HTTP server (not yet serving: call ``serve_forever``).  Its
    ``service`` attribute is the :class:`MattingService`; to stop, call
    ``shutdown()`` and ``server_close()`` on the server and
    ``service.batcher.shutdown()``."""
    service = MattingService(pipeline, **service_kwargs)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    httpd.service = service
    _log.info("serving on http://%s:%d", host, httpd.server_address[1])
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="SDMatte.safetensors")
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--random-weights", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="fp32 on the CPU (the default is bf16 on the CUDA card)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="requests coalesced into one pipeline call at most")
    ap.add_argument("--warmup", default=None, metavar="SIZES",
                    help="comma-separated inference sizes to run once per batch "
                         "size 1..--max-batch on the serving thread before its "
                         "first request, e.g. '512,1024', so first requests skip "
                         "the kernels' build, the thread's library handles and "
                         "the allocator's growth")
    ap.add_argument("--speed-mode", default="off",
                    choices=["off", "aux_half", "rgb_half", "decode_half",
                             "fast", "fastest"],
                    help="out-of-parity speed modes: encode the trimap "
                         "(aux_half) or photo (rgb_half) at half size, decode "
                         "at half size (decode_half); fast = aux_half + "
                         "decode_half, fastest = all three; never the default")
    ap.add_argument("--weight-storage", default="fp",
                    choices=["fp", "int8"],
                    help="int8 weight residency (bf16 compute)")
    args = ap.parse_args(argv)

    from ..pipeline.matting import resolve_device
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"[serve] {e} (or pass --cpu)", file=sys.stderr)
        return 2
    if args.random_weights:
        from ..configs import SDMatteConfig
        from ..core.dtypes import BF16, FP32
        from ..models.init import init_random_
        from ..models.sdmatte import SDMatte
        with torch.device("meta"):
            model = SDMatte(SDMatteConfig())
        init_random_(model, seed=0, device=device)
        pipe = MattingPipeline(model, policy=FP32 if args.cpu else BF16,
                               device=device, speed_mode=args.speed_mode,
                               weight_storage=args.weight_storage)
    else:
        from .node import get_pipeline
        pipe = get_pipeline(args.ckpt, force_cpu=args.cpu,
                            speed_mode=args.speed_mode,
                            weight_storage=args.weight_storage)
    warmup = None
    if args.warmup:
        sizes = tuple(int(s) for s in args.warmup.split(","))
        batches = list(range(1, args.max_batch + 1))

        def warmup():
            _log.info("warming %s x batches %s ...", sizes, batches)
            for cfg_key, secs in pipe.warmup(sizes=sizes, batch_sizes=batches).items():
                _log.info("warmup %s: %.1fs", cfg_key, secs)
    httpd = serve(pipe, args.port, args.host, max_batch=args.max_batch, warmup=warmup)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        httpd.service.batcher.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
