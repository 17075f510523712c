"""Tracing, profiling and structured logging (sdmatte_tpu/utils/observability.py).

Structured logging, ``torch.profiler`` trace capture for device timelines,
a lightweight metrics registry the server reports into, and a span recorder
(``span``, ``record``, ``start``, ``drain``) that stamps named stretches of
host time on the clock of ``torch.profiler``'s events, so that an operator
can lay them over a device trace: which step the card idles in, how long a
request waits in the server's queue.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
from collections import defaultdict, deque
from itertools import count
from typing import Deque, Dict, Iterator, List, NamedTuple, Optional

_LOGGERS: Dict[str, logging.Logger] = {}


def get_logger(name: str = "sdmatte_tpu_torch") -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("SDMATTE_TPU_LOG_LEVEL", "INFO"))
        logger.propagate = False
    _LOGGERS[name] = logger
    return logger


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the host and, where there is a
    card, of the device, written as a Chrome trace (Perfetto,
    chrome://tracing) to ``log_dir/trace.json``.

    Usage: ``with observability.trace("traces"): pipe(img, tri, ...)``
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or os.environ.get("SDMATTE_TPU_TRACE_DIR", "sdmatte_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    get_logger().info("profiler trace written to %s", path)


# Per-series window: percentiles are computed over the most recent
# _SERIES_CAP observations so a long-lived serving process holds bounded
# memory.  Totals keep the true observation count.
_SERIES_CAP = 4096


@dataclasses.dataclass
class Metrics:
    """Process-local metric registry: counters and timing histograms."""

    counters: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    timings_ms: Dict[str, Deque[float]] = dataclasses.field(
        default_factory=lambda: defaultdict(
            lambda: deque(maxlen=_SERIES_CAP)))
    values: Dict[str, Deque[float]] = dataclasses.field(
        default_factory=lambda: defaultdict(
            lambda: deque(maxlen=_SERIES_CAP)))
    totals: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))

    def count(self, name: str, value: float = 1.0):
        self.counters[name] += value

    def observe_ms(self, name: str, ms: float):
        self.timings_ms[name].append(ms)
        self.totals[name] += 1

    def observe(self, name: str, value: float):
        """Unitless distribution (e.g. batch sizes, queue depths)."""
        self.values[name].append(value)
        self.totals[name] += 1

    def summary(self) -> dict:
        import numpy as np
        out: dict = {"counters": dict(self.counters)}
        out["timings"] = {
            k: {"n": self.totals[k],
                "p50_ms": float(np.percentile(v, 50)),
                "p99_ms": float(np.percentile(v, 99)) if len(v) > 1 else float(v[0])}
            for k, v in ((k, list(v)) for k, v in self.timings_ms.items()) if v
        }
        out["values"] = {
            k: {"n": self.totals[k], "p50": float(np.percentile(v, 50)),
                "max": float(max(v))}
            for k, v in ((k, list(v)) for k, v in self.values.items()) if v
        }
        return out

    def dump(self) -> str:
        return json.dumps(self.summary())


METRICS = Metrics()



# -- spans -------------------------------------------------------------------
#
# The program's span sites, each for one reading:
#   pipeline.heavy  the model call of MattingPipeline.__call__: the card's idle
#                   time inside it, per matte
#   serve.queued    a request in MicroBatcher's queue, submit to its batch
#   serve.batch     the batcher's worker from a batch's selection to its last
#                   answer handed out (stacking, the call, the copies back)
# (pipeline.heavy also wraps ViTMattePipeline's model call.)  No span sits
# inside the heavy step: a replayed step runs none of the model's Python.
#
# Counters in METRICS beside them: heavy.* (pipeline/graphs.py);
# vitmatte.tables_built, the position tables ViTMatte makes, one set a token
# grid (0 in a window that meets no new photo size); attention.relpos_launches,
# K1's launches in its relative-position mode, replays included;
# norm.kernel_launches, the GroupNorm kernels' launches, replays included (a
# plan adds those its graphs hold), and norm.plain_sites, the GroupNorm sites
# whose plain statistics ran (ops/group_norm.py).
# Stamps are time.time_ns(), the clock torch.profiler's events carry, so a
# span can be intersected with a trace's device intervals.  No span enters
# torch.profiler's own event stream (record_function): a trace with the
# recorder on holds the same events as one with it off.

SPAN_CAP = 1 << 18     # spans kept


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int                 # threading.get_ident() of the thread that recorded it
    parent: Optional[int]       # the id of the span open around it on its thread
    attrs: dict


class Drained(NamedTuple):
    spans: List[Span]           # oldest first
    dropped: int                # the oldest spans the bounded buffer let go


ON = False                      # read by the span sites before any other work
_buffer: Deque[tuple] = deque(maxlen=SPAN_CAP)
_dropped = 0
_lock = threading.Lock()
_ids = count(1)
_local = threading.local()


def _put(s: tuple) -> None:
    """Keep one span's fields; they become a ``Span`` when drained."""
    global _dropped
    with _lock:
        if not ON:
            return
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
        _buffer.append(s)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Open:
    """A span being recorded on this thread."""

    __slots__ = ("name", "attrs", "id", "parent", "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else None
        self.id = next(_ids)
        st.append(self.id)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        _put((self.id, self.name, self.start_ns, end, threading.get_ident(),
              self.parent, self.attrs))
        return False


class _Off:
    """What ``span`` returns while recording is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """``with span("pipeline.heavy"):`` records the stretch of host time inside
    it while recording is on; ``attrs`` are kept with it."""
    if not ON:
        return _OFF
    return _Open(name, attrs)


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """A span its caller stamped (``time.time_ns()``): one that starts on
    one thread and ends on another, or one on a hot path, where ``span``'s
    bookkeeping would cost more than the work it times; it has no parent."""
    if ON:
        _put((next(_ids), name, start_ns, end_ns, threading.get_ident(), None, attrs))


def start() -> None:
    """Turn recording on, with an empty buffer."""
    global ON, _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0
        ON = True


def drain() -> Drained:
    """Turn recording off and hand over what it recorded."""
    global ON, _dropped
    with _lock:
        ON = False
        out = Drained([Span._make(s) for s in _buffer], _dropped)
        _buffer.clear()
        _dropped = 0
    return out
