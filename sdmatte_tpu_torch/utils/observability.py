"""Tracing, profiling and structured logging (sdmatte_tpu/utils/observability.py).

Structured logging, ``torch.profiler`` trace capture for device timelines,
and a lightweight metrics registry the server reports into.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Iterator, Optional

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


@contextlib.contextmanager
def timed(name: str, metrics: Metrics = METRICS) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        metrics.observe_ms(name, (time.perf_counter() - t0) * 1e3)
