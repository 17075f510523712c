"""Piecewise CUDA-graph replay of the pipeline's heavy step.

At 1024 px the heavy step (VAE encode, U-Net, decode) is some 3,300 launches
a matte, most of them small torch ops; handed out one by one by the host,
they leave the card waiting on the host for almost half of the step.  From
CUDA graphs they cost the host one call per graph.

K1-K4 stay outside the graphs.  While a step is captured, each of their
``Kernel.launch`` calls cuts the capture (ops/_build.CAPTURE): the graph so far
ends, the kernel and its arguments join the plan, and the next graph begins
in the same memory pool on the same stream.  The plan is [graph, (kernel,
args), graph, ..., graph], and a replay runs it in order: each kernel goes
through ``kernel.launch`` (looked up at the call, so a wrapper installed on
the kernel sees the launch and ``Kernel.launches`` counts it) with the
current stream in place of the capture's.  The GroupNorm kernels
(``cuts=False``) run inside the graphs; the segmenter counts what the capture
met of them (and of ``_build.tally``'s counters), and a replay adds those
counts.

A step's key holds everything its shapes and branches depend on.  The first
call of a key runs eagerly on a side stream, which is also the warm-up a
capture needs (library handles, workspaces, kernel builds), returns that
answer, and then captures the key's plan.

The plans share one memory pool, in which a capture reuses the blocks that
earlier captures freed.  A freed block serves a smaller tensor but never a
larger one (blocks of separate allocations do not merge), so keys captured
in rising sizes (batches 1, 2, ..., 8 in a server's warm-up) would each
add their whole working set to the pool.  So a key larger than every key of
the pool (its first argument, the image batch, has more elements) starts a
fresh pool: the old pool's plans are dropped, and each is captured again at
its next call, into the larger key's free blocks.  The pool holds about the
largest key's working set.  A later call copies its inputs
into the plan's static buffers, replays the plan on the current stream and
returns a clone of the static output, so that no caller holds memory the
next replay overwrites.  A key whose capture raises stays eager for the life
of the runner.  The runner engages on a CUDA device with autograd off; there
and elsewhere a call that does not replay runs the step eagerly.

The graphs read every tensor where the capture found it: the static buffers,
the device tables the capture read (core/tables.py, which the plan keeps),
and the model's weights (changed in place they are read anew; replaced by
other tensors they are not).

Counters (utils/observability.METRICS): ``heavy.graph_captures``,
``heavy.graph_replays``, ``heavy.graph_fallbacks`` (a capture that raised)
and ``heavy.eager`` (a call on the CPU, under autograd, or of a key that fell
back).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Hashable, Optional

import torch

from ..core import tables
from ..ops._build import CAPTURE, stream_handle
from ..utils import observability


class Segmenter:
    """Builds a plan while a capture runs.  ``open_graph()`` returns a graph
    whose capture has begun; the segmenter ends it at each hand-kernel launch
    (:meth:`cut`) and at :meth:`finish`, and opens the next."""

    def __init__(self, open_graph: Callable):
        self._open_graph = open_graph
        self.steps: list = []
        self.held: dict = {}        # kernel or counter name -> times the graphs hold it
        self._graph = open_graph()

    def cut(self, kernel, args: tuple) -> None:
        self._close()
        self.steps.append((kernel, args))
        self._graph = self._open_graph()

    def hold(self, what) -> None:
        """A kernel launched inside the open graph, or a counter name, which
        each replay of the plan counts once more."""
        self.held[what] = self.held.get(what, 0) + 1

    def finish(self) -> list:
        self._close()
        return self.steps

    def abort(self) -> None:
        """End the open capture of a step that raised."""
        graph, self._graph = self._graph, None
        if graph is not None:
            with contextlib.suppress(RuntimeError):   # the failure invalidated it
                graph.capture_end()

    def _close(self) -> None:
        graph, self._graph = self._graph, None
        graph.capture_end()
        self.steps.append(graph)


class Plan:
    """A key's captured step: the static inputs, the steps, the static
    output, the device tables the graphs read, and what the graphs hold that
    each replay counts (``Segmenter.held``)."""

    __slots__ = ("inputs", "steps", "output", "tables", "counts")

    def __init__(self, inputs: tuple, steps: list, output: torch.Tensor, held: list,
                 counts: Optional[dict] = None):
        self.inputs, self.steps, self.output, self.tables = inputs, steps, output, held
        self.counts = list((counts or {}).items())

    def __call__(self, args: tuple, stream) -> torch.Tensor:
        """Copy ``args`` in, run the steps in order, each kernel on
        ``stream`` (a launch's last argument is its stream), and return a
        clone of the output."""
        for static, a in zip(self.inputs, args):
            if static is not None:
                static.copy_(a)
        for step in self.steps:
            if type(step) is tuple:
                kernel, kargs = step
                kernel.launch(*kargs[:-1], stream)
            else:
                step.replay()
        for what, n in self.counts:
            if isinstance(what, str):
                observability.METRICS.count(what, n)
            else:
                what.count(n)
        return self.output.clone()


class HeavyGraphs:
    """The heavy step's graphs of one pipeline: its plans by key, the memory
    pool they share, one side stream for first calls and captures, and the
    lock that keeps two threads from interleaving on the pool."""

    def __init__(self, device: torch.device):
        self.device = device
        self.plans: dict = {}           # key -> Plan, or None: eager for good
        self._lock = threading.Lock()
        self._pool = None
        self._pool_elems = 0            # the largest first argument captured in the pool
        self._side = None

    def engaged(self) -> bool:
        return self.device.type == "cuda" and not torch.is_grad_enabled()

    def __call__(self, key: Hashable, step: Callable, args: tuple):
        """``step(*args)`` (tensors, None allowed) through the plan of ``key``."""
        metrics = observability.METRICS
        if not self.engaged():
            metrics.count("heavy.eager")
            return step(*args)
        with self._lock:
            if key not in self.plans:
                return self._first(key, step, args)
            plan = self.plans[key]
            if plan is None:
                metrics.count("heavy.eager")
                return step(*args)
            metrics.count("heavy.graph_replays")
            return plan(args, self._stream())

    def _first(self, key, step, args):
        elems = args[0].numel()
        if elems > self._pool_elems:    # a larger step than any of the pool's: a fresh pool
            self.plans = {k: p for k, p in self.plans.items() if p is None}
            self._pool, self._pool_elems = None, 0
        with torch.inference_mode(False):   # normal tensors: replays write them in any mode
            statics = tuple(None if a is None else a.clone(memory_format=torch.preserve_format)
                            for a in args)
        with self._on_side_stream():
            out = step(*args)
            plan = self.plans[key] = self._capture(step, statics)
        if plan is not None:
            self._pool_elems = max(self._pool_elems, elems)
        return out

    def _capture(self, step, statics) -> Optional[Plan]:
        seg = None
        try:
            with tables.holding() as held:
                seg = Segmenter(self._open_graph)
                CAPTURE.segmenter = seg
                try:
                    output = step(*statics)
                finally:
                    CAPTURE.segmenter = None
                steps = seg.finish()
        except Exception:       # the step stays eager; the call has its answer
            if seg is not None:
                seg.abort()
            observability.METRICS.count("heavy.graph_fallbacks")
            observability.get_logger().warning(
                "the heavy step's graph capture failed; this key runs eagerly", exc_info=True)
            return None
        observability.METRICS.count("heavy.graph_captures")
        return Plan(statics, steps, output, held, seg.held)

    # -- the card's side (the CPU tests put stubs in their place) -------------

    @contextlib.contextmanager
    def _on_side_stream(self):
        """Work on the side stream; then the blocks the first call cached for
        that stream, which no replay uses, go back to the card."""
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(cur)
        try:
            with torch.cuda.stream(self._side):
                yield
        finally:
            cur.wait_stream(self._side)
            torch.cuda.empty_cache()

    def _open_graph(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
        return graph

    def _stream(self):
        return stream_handle(self.device)
