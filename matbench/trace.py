"""The traced stretch of a ``--trace 1`` run and its reduction to numbers.

A ``torch.profiler`` session (host and device activity, kept in memory,
nothing written to disk) covers the last stretch of the window; the
benchmark's own spans (``matbench.pre``, ``matbench.heavy``,
``matbench.post`` around the pipeline's three steps) label the host's time.
The hand kernels' launches are recorded at the kernel boundary
(``Kernel.launch`` of the program's ``ops/_build.py``) with their sizes, so
that a kernel's roofline counts the work its calls needed.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
from dataclasses import dataclass, field

SPAN_PREFIX = "matbench."
COPY_PREFIXES = ("Memcpy", "Memset")


@dataclass
class Readings:
    """What the per-layer readers read.  Times in seconds."""
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: list = field(default_factory=list)        # (name, seconds)
    device_ops: list = field(default_factory=list)     # (name, seconds) top 10
    idle_gaps: list = field(default_factory=list)      # (label, seconds) top 10
    mattes: int = 0                                    # completed in the stretch
    launches: dict = field(default_factory=dict)       # kernel name -> [args]
    flops_per_matte: float | None = None
    s_per_matte: float | None = None                   # outside the stretch
    images_per_call: float | None = None


class LaunchLog:
    """Wraps each hand kernel's ``launch`` to keep its integer arguments and
    whether its optional pointers were given, while ``on``."""

    def __init__(self, kernels: dict):
        self.kernels = kernels
        self.on = False
        self.calls: dict[str, list] = {name: [] for name in kernels}
        self._saved = {}
        self._lock = threading.Lock()

    def _arg(self, a):
        v = getattr(a, "value", a)
        return v if isinstance(v, (int, float)) or v is None else None

    def install(self):
        for name, k in self.kernels.items():
            original = k.launch

            def launch(*args, _name=name, _original=original):
                if self.on:
                    with self._lock:
                        self.calls[_name].append(tuple(self._arg(a) for a in args))
                return _original(*args)
            self._saved[name] = original
            k.launch = launch

    def uninstall(self):
        for name, k in self.kernels.items():
            if name in self._saved:
                del k.launch   # the instance attribute; the class method shows again
        self._saved.clear()


@contextlib.contextmanager
def span(name: str):
    from torch.profiler import record_function
    with record_function(SPAN_PREFIX + name):
        yield


def instrument(pipe):
    """Spans around the pipeline's pre, heavy and post steps, set on the
    instance (the program is not changed)."""
    for step in ("_pre", "_heavy", "_post"):
        inner = getattr(pipe, step)

        def wrapped(*a, _inner=inner, _name=step.strip("_"), **kw):
            with span(_name):
                return _inner(*a, **kw)
        setattr(pipe, step, wrapped)


def prepare():
    """What starting a profiler session imports (``prepare_trace`` touches
    ``torch._inductor``, which imports ``torch._dynamo``: seconds on a fresh
    process), done during set-up so that the stretch starts on time."""
    import torch._inductor.config  # noqa: F401


def start():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _kind(e) -> str | None:
    """"kernel", "copy" (a copy or set on the card), "host" (an op or a
    span on the host), or None (the device's copies of the spans)."""
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith(SPAN_PREFIX):
            return None
        return "copy" if name.startswith(COPY_PREFIXES) else "kernel"
    return "host"


def reduce(prof, top: int = 10) -> Readings:
    """Device busy time (the union of kernel, copy and set intervals), the
    window (first to last event), kernel times by name, and the idle gaps
    summed by what the host was doing when each began."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind is None:
            continue
        start = e.start_ns()
        item = (start, start + e.duration_ns(), e.name())
        if kind == "host":
            host.append(item)
        else:
            dev.append(item + (kind,))
    r = Readings()
    if not dev:
        return r
    all_start = min([d[0] for d in dev] + [h[0] for h in host])
    all_end = max([d[1] for d in dev] + [h[1] for h in host])
    r.window_s = (all_end - all_start) / 1e9
    dev.sort()
    merged = []
    for s, e, _, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    r.busy_s = sum(e - s for s, e in merged) / 1e9
    by_name: dict[str, float] = {}
    for s, e, name, act in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        if act == "kernel":
            r.kernels.append((name, (e - s) / 1e9))
    r.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    host.sort()
    spans = [h for h in host if h[2].startswith(SPAN_PREFIX)]
    span_starts = [h[0] for h in spans]
    ops = [h for h in host if not h[2].startswith(SPAN_PREFIX)]
    op_starts = [h[0] for h in ops]

    def label(t):
        i = bisect.bisect_right(span_starts, t) - 1
        inside = i >= 0 and spans[i][1] > t
        where = spans[i][2][len(SPAN_PREFIX):] if inside else "outside"
        i = bisect.bisect_right(op_starts, t) - 1
        # the op that began last before the gap, still running or just done
        what = ops[i][2] if i >= 0 else "none"
        return f"{where}:{what}"

    gaps: dict[str, float] = {}
    edges = [(all_start, all_start)] + [tuple(m) for m in merged] + [(all_end, all_end)]
    for (_, e0), (s1, _) in zip(edges, edges[1:]):
        if s1 > e0:
            key = label(e0)
            gaps[key] = gaps.get(key, 0.0) + (s1 - e0) / 1e9
    r.idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return r
