"""One run of one cell: build the deployment, warm it, drive the cell's
traffic for the window, judge every answer of the window against the
reference, and reduce everything to the cell's metrics.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file, the two modules of the configuration's
architecture (``architecture.py``), its mix under ``matbench/traffic/``,
its limits under ``matbench/limits/`` and each per-layer metric's reader
under ``matbench/metrics/``.  Adding a cell, or an architecture, adds files
and entries; no code here changes.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import queue
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import architecture, compare, program, reference
from . import trace as tracing
from .traffic import generate

ROOT = Path(__file__).resolve().parent.parent
METRICS_DIR = Path(__file__).resolve().parent / "metrics"
FORBIDDEN = ("jax", "jaxlib", "flax", "sdmatte_tpu")
STRETCH_S = 5.0          # the profiled stretch at the end of a traced window
LATE_WAIT_S = 60.0       # how long past the close the run waits for answers
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda"}


def use_checkout_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's nvcc builds already live in ``sdmatte_tpu_torch/_build/``)."""
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / ".matbench_cache" / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names among ``modules`` (by default ``sys.modules``) that
    are JAX or the JAX package, compared whole: ``sdmatte_tpu_torch`` is not
    ``sdmatte_tpu``, nor ``jaxtyping`` ``jax``."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, workload: str):
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return wl, cfg


def cell_files(workload: str, conf=None, mix=None):
    """The cell's configuration and mix, unless given; a configuration
    whose architecture has no modules is refused here."""
    wl, cfg = find_cell(load_benchmark(), workload)
    if conf is None:
        with open(ROOT / cfg["file"]) as f:
            conf = json.load(f)
    architecture.name_of(conf)
    return conf, mix or generate.load_mix(wl["traffic"])


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"matbench_metric_{name}",
                                                  METRICS_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, kind: str) -> list[dict]:
    """The entries of ``end_to_end`` or ``per_layer`` that this cell reports."""
    out = []
    e2e = {m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])}
    for m in bench[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def nearest_rank(values, q: float) -> float:
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def card_note() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not available"
    return out


@dataclass
class Drive:
    """What one program run produced."""
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    completed: int = 0
    latencies_s: list = field(default_factory=list)
    peak_bytes: int = 0
    kept: dict = field(default_factory=dict)          # request id -> (alpha, matted)
    photo_of: dict = field(default_factory=dict)      # request id -> pool index
    inputs: dict = field(default_factory=dict)        # pool index -> (image, trimap)
    readings: tracing.Readings | None = None
    notes: list = field(default_factory=list)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def drive(workload: str, seed: int, seconds: float, trace: bool, *, device,
          t0: float, conf: dict | None = None, mix: dict | None = None,
          control: bool = False, rate: float | None = None,
          clock=time.perf_counter) -> Drive:
    """Build, warm, and drive one cell's traffic for ``seconds``; ``conf``
    and ``mix`` replace the cell's files (the CPU tests' tiny sizes)."""
    conf, mix = cell_files(workload, conf, mix)
    marks = []

    def mark(name):                       # the set-up's steps, for the run's notes
        _sync(device)
        marks.append((name, clock() - t0))

    mark("start")
    if device.type == "cuda":
        program.build_kernels()
        mark("kernels built")
    pipe = program.build_pipeline(conf, seed, device, control=control, mark=mark)
    mark("pipeline built")
    pool = generate.make_pool(mix, seed, device)
    mark("photos made")
    opts = program.options(conf, mix)
    log = None
    if trace:
        tracing.prepare()
        tracing.instrument(pipe)
        log = tracing.LaunchLog(program.hand_kernels())
        log.install()
    try:
        d = driver_of(mix)(pipe, pool, mix, opts, seed, seconds, trace, log, device, t0,
                           clock, rate)
    finally:
        if log is not None:
            log.uninstall()
    d.notes.insert(0, "set-up s: " + ", ".join(f"{name} {t:.3f}" for name, t in marks)
                   + f", warmed {d.setup_s:.3f}")
    if d.readings is not None:
        d.readings.launches = log.calls
    d.inputs = dict(enumerate(pool))
    del pipe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return d


def _closed(pipe, pool, mix, opts, seed, seconds, trace, log, device, t0, clock,
            rate=None) -> Drive:
    """One client calling ``MattingPipeline.__call__`` back to back."""
    d = Drive()

    def call(k):
        alpha, matted = pipe(pool[k][0], pool[k][1], options=opts)
        return alpha.cpu(), matted.cpu()

    for k in range(len(pool)):          # every size the window will see, on this thread
        call(k)
    _sync(device)
    _reset_peak(device)
    d.setup_s = clock() - t0
    order = generate.closed_order(mix, seed, int(seconds * 200) + len(pool))
    prof, stretch_t0, stretch_n, before_n = None, None, 0, 0
    captures0 = program.graph_captures()
    w0 = clock()
    close = w0 + seconds
    records = []
    for k in order:
        ts = clock()
        if ts >= close:
            break
        if trace and prof is None and ts >= close - min(STRETCH_S, seconds / 4):
            before_n, stretch_t0 = len(records), ts
            prof = tracing.start()
            log.on = True
        try:
            out, ok = call(k), True
        except Exception as e:  # a failed call counts as failed, the loop goes on
            out, ok = None, False
            d.notes.append(f"request {len(records)} failed: {e!r}")
        te = clock()
        d.photo_of[len(records)] = k
        if ok:
            d.kept[len(records)] = (out[0][0], out[1][0])
        records.append((ts, te, ok))
        if prof is not None:
            stretch_n += ok
    d.peak_bytes = _peak(device)
    d.notes.append(f"graph captures in window {program.graph_captures() - captures0}")
    if prof is not None:
        _sync(device)
        log.on = False
        prof.stop()
        d.readings = tracing.reduce(prof)
        d.readings.mattes = stretch_n
        done_before = sum(ok for _, _, ok in records[:before_n])
        if done_before:
            d.readings.s_per_matte = (stretch_t0 - w0) / done_before
    d.window_s = seconds
    d.attempted = len(records)
    d.failed = sum(not ok for _, _, ok in records)
    d.completed = sum(ok and te <= close for _, te, ok in records)
    d.latencies_s = [te - ts if ok else math.inf for ts, te, ok in records]
    return d


def _open(pipe, pool, mix, opts, seed, seconds, trace, log, device, t0, clock,
          rate=None) -> Drive:
    """Requests into the server's ``MicroBatcher.submit`` on the mix's
    schedule, each from a client thread of its own, timed from when it was
    due."""
    d = Drive()
    images = [(img.numpy(), tri.numpy()) for img, tri in pool]
    max_batch = int(mix["server"]["max_batch"])

    def warm():                          # on the batcher's worker thread
        for b in range(max_batch, 0, -1):   # largest first: the smaller graphs fit its pool
            ks = [i % len(images) for i in range(b)]
            alpha, matted = pipe(np.stack([images[k][0] for k in ks]),
                                 np.stack([images[k][1] for k in ks]), options=opts)
            alpha.cpu(), matted.cpu()

    svc = program.service(pipe, mix, warm)
    overload = program.overload_errors()
    schedule = generate.open_schedule(mix, seed, seconds, rate)
    d.photo_of = {rid: k for rid, (_, k) in enumerate(schedule)}
    results = {}                          # id -> (start, end, ok)
    lock = threading.Lock()
    work: queue.Queue = queue.Queue()

    def client():
        while True:
            item = work.get()
            if item is None:
                return
            rid, k = item
            ts = clock()
            try:
                alpha, matted = svc.batcher.submit(images[k][0], images[k][1], opts)
                ok = True
            except overload as e:
                ok, alpha, note = False, None, f"request {rid} refused: {e!r}"
            except Exception as e:  # counted as failed; the client goes on
                ok, alpha, note = False, None, f"request {rid} failed: {e!r}"
            te = clock()
            with lock:
                if not ok:
                    d.notes.append(note)
                results[rid] = (ts, te, ok)
                if ok:
                    d.kept[rid] = (torch.from_numpy(alpha), torch.from_numpy(matted))

    n_clients = int(mix["server"]["max_queue"]) + 2 * max_batch
    clients = [threading.Thread(target=client, daemon=True) for _ in range(n_clients)]
    for c in clients:
        c.start()
    try:
        svc.batcher.submit(images[0][0], images[0][1], opts)    # waits for the warm-up
        _sync(device)
        _reset_peak(device)
        d.setup_s = clock() - t0
        stretch = min(STRETCH_S, seconds / 4) if trace else 0.0
        prof, stretch_t0 = None, None
        calls0, captures0 = svc.batcher.batch_calls, program.graph_captures()
        w0 = clock()
        close = w0 + seconds
        due_at = []
        for rid, (due, k) in enumerate(schedule):
            wait = w0 + due - clock()
            if trace and prof is None and w0 + due >= close - stretch:
                stretch_t0 = clock()
                prof = tracing.start()
                log.on = True
            if wait > 0:
                time.sleep(wait)
            due_at.append(clock() - (w0 + due))
            work.put((rid, k))
        left = close - clock()
        if left > 0:
            time.sleep(left)
        calls_in_window = svc.batcher.batch_calls - calls0
        captures_in_window = program.graph_captures() - captures0
        stretch_t1 = clock()
        if prof is not None:
            log.on = False
            prof.stop()
        deadline = close + LATE_WAIT_S
        while len(results) < len(schedule) and clock() < deadline:
            time.sleep(0.05)
        d.peak_bytes = _peak(device)
    finally:
        for _ in clients:
            work.put(None)
        for c in clients:
            c.join(timeout=LATE_WAIT_S)
        svc.batcher.shutdown()
    lat, done_in_window, done_in_stretch = [], 0, 0
    for rid, (due, k) in enumerate(schedule):
        if rid not in results or not results[rid][2]:
            lat.append(math.inf)
            continue
        te = results[rid][1]
        lat.append(te - (w0 + due))
        done_in_window += te <= close
        if stretch_t0 is not None and stretch_t0 <= te <= stretch_t1:
            done_in_stretch += 1
    d.window_s = seconds
    d.attempted = len(schedule)
    d.failed = sum(x == math.inf for x in lat)
    d.completed = done_in_window
    d.latencies_s = lat
    d.notes.append(f"generator lateness ms: median {1e3 * float(np.median(due_at)):.3f}, "
                   f"max {1e3 * max(due_at):.3f}")
    d.notes.append(f"pipeline calls in window {calls_in_window}, "
                   f"graph captures in window {captures_in_window}")
    if prof is not None:
        d.readings = tracing.reduce(prof)
        d.readings.mattes = done_in_stretch
    if d.readings is not None and calls_in_window:
        d.readings.images_per_call = done_in_window / calls_in_window
    del svc
    return d


DRIVERS = {"pipeline": _closed, "microbatcher": _open}


def driver_of(mix: dict):
    """The driver of the mix's ``entry``; any other entry is refused."""
    entry = mix.get("entry")
    if entry not in DRIVERS:
        raise SystemExit(f"matbench: no driver for entry {entry!r}; known: "
                         f"{', '.join(sorted(DRIVERS))}")
    return DRIVERS[entry]


@torch.no_grad()
def reference_answers(conf: dict, seed: int, device, inputs: dict, mix: dict) -> dict:
    """{photo: ((alpha, matted) in fp32, (alpha, matted) in bf16)} of the
    configuration's reference for each photo of the pool, on weights made
    again from the seed: fp32 with TF32 off, and under bf16 autocast (the
    configuration's precision), whose gap from fp32 is the unit of
    ``compare.gap_ratio``."""
    from . import weights
    ref = architecture.reference_of(conf)
    unknown = set(conf["pipeline"]) - ref.PIPELINE_KEYS
    if unknown:
        raise SystemExit(f"matbench: the reference does not model the pipeline keys "
                         f"{sorted(unknown)}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    reference.exact_fp32()
    try:
        params = weights.make_params(conf, seed, device, dtype=torch.bfloat16)
        params = ref.stored({k: v.float() for k, v in params.items()}, conf)

        def call(img, tri):
            return ref.answer(params, conf, img.to(device), tri.to(device), mix["options"])

        out = {}
        for i, (img, tri) in inputs.items():
            exact = call(img, tri)
            with torch.autocast(device.type, dtype=torch.bfloat16):
                low = call(img, tri)
            out[i] = (exact, low)
        del params
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return out


def judge(d: Drive, refs: dict) -> dict:
    """{photo: the largest gap_ratio of its answers}, over every request of
    the window; a request that was never answered reads as all zeros."""
    worst = {}
    for rid, k in sorted(d.photo_of.items()):
        worst[k] = max(worst.get(k, 0.0), compare.gap_ratio(d.kept.get(rid), *refs[k]))
    return worst


def model_flops(conf: dict, mix: dict) -> float:
    """Operations of one matte's model forward, counted from the shapes of
    the reference's forward on the meta device at the mix's options and
    averaged over the photos of its pool (each is sent equally often)."""
    from torch.utils.flop_counter import FlopCounterMode
    ref = architecture.reference_of(conf)
    sizes = [(e.h, e.w) for e in generate.pool_layout(mix)]
    total = 0.0
    for h, w in sorted(set(sizes)):
        counter = FlopCounterMode(display=False)
        with counter:
            ref.meta_forward(conf, mix["options"], h, w)
        total += sizes.count((h, w)) * float(counter.get_total_flops())
    return total / len(sizes)


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    breakdown: dict | None
    checks: dict
    notes: list


def run(workload: str, seed: int, seconds: float, trace: bool, *, device, t0: float,
        conf: dict | None = None, mix: dict | None = None,
        clock=time.perf_counter) -> Result:
    """A whole run of the cell, reduced to the result line's fields."""
    bench = load_benchmark()
    conf, mix = cell_files(workload, conf, mix)
    d = drive(workload, seed, seconds, trace, device=device, t0=t0, conf=conf, mix=mix,
              clock=clock)
    refs = reference_answers(conf, seed, device, d.inputs, mix)
    ratios = judge(d, refs)
    limit = compare.limits(workload)["gap_ratio"]
    checks = {f"gap_ratio.photo{k}": {"value": v, "limit": limit} for k, v in ratios.items()}
    correct = bool(ratios) and all(v <= limit for v in ratios.values())
    lat_ms = [1e3 * x for x in d.latencies_s]
    values = {"mattes_per_s": d.completed / d.window_s,
              "latency_p50_ms": nearest_rank(lat_ms, 0.50),
              "latency_p95_ms": nearest_rank(lat_ms, 0.95),
              "peak_mem_gib": d.peak_bytes / 2 ** 30,
              "setup_s": d.setup_s}
    notes = list(d.notes) + [f"latency samples {len(lat_ms)} (attempted {d.attempted}, "
                             f"failed {d.failed}, completed in window {d.completed}); "
                             f"answers judged {len(d.photo_of)}, worst per photo below"]
    metrics, breakdown = {}, None
    if not trace:
        for m in cell_metrics(bench, workload, "end_to_end"):
            v = values[m["name"].split(".")[0]]     # "latency_p95_ms.serve" reads latency_p95_ms
            metrics[m["name"]] = {"value": v if math.isfinite(v) else None, "unit": m["unit"]}
    else:
        r = d.readings or tracing.Readings()
        if r.s_per_matte:
            r.flops_per_matte = model_flops(conf, mix)
        for m in cell_metrics(bench, workload, "per_layer"):
            v = load_reader(m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": [[n, s] for n, s in r.device_ops],
                     "idle_gaps": [[n, s] for n, s in r.idle_gaps]}
        notes.append(f"traced stretch {r.window_s:.6f} s, device busy {r.busy_s:.6f} s, "
                     f"{len(r.kernels)} kernels, {r.mattes} mattes")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": d.peak_bytes}
    if trace:
        r = d.readings or tracing.Readings()
        dev["busy_s"], dev["window_s"] = r.busy_s, r.window_s
    return Result(correct, d.attempted, d.failed, metrics, dev, breakdown, checks, notes)


def result_line(res: Result) -> str:
    line = {"correct": res.correct, "attempted": res.attempted, "failed": res.failed,
            "metrics": res.metrics, "device": res.device}
    if res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["checks"] = res.checks
    return json.dumps(line)
