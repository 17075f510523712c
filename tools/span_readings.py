"""One traced matbench run with the program's span recorder on (or off), and
the three readings of its spans, until matbench reads them itself:

- pipeline.heavy_idle_ms, serve.host_idle_ms: the card's idle time in the
  profiled stretch (no kernel, copy or set running: the merge that
  device.idle_pct uses) inside the union of the span's intervals, per matte
  completed in the stretch;
- serve.queue_wait_ms: the 95th percentile (nearest rank) of serve.queued
  over the requests that joined the queue in the window; and the check
  that every serve.batch holds exactly the ids of the serve.queued spans
  that end at its start.

Beside them: the heavy step's graph counters over the run (captures,
replays, fallbacks, eager calls) and replays over heavy calls, which is 1
less the first call of each key where the graphs engage; ViTMatte's
counters over the run and inside the window (``vitmatte.tables_built``,
position tables made, which reads 0 in the window;
``attention.relpos_launches``, K1's launches in its relative-position
mode); the GroupNorm counters over the run and inside the window
(``norm.kernel_launches``, the statistics, finish and apply kernels'
launches, replays included; ``norm.plain_sites``, the sites whose plain
statistics ran, which reads 0 on the card); and the card's memory at the
stretch's close, while the pipeline lives: allocated, reserved, and the part
of reserved that graph pools hold.

    python3 tools/span_readings.py --workload <cell> --seed <n> [--seconds 40] [--recorder 0|1]
    python3 tools/span_readings.py --workload <cell> --seed <n> --seconds 8 --rehearse   # CPU, tiny

The harness runs as ``python3 -m matbench.run --trace 1`` runs it, with two
of its functions wrapped: ``_reset_peak`` (the window opens after warm-up:
stamp it and start the recorder) and ``trace.reduce`` (keep the profiler's
device intervals and the stretch's bounds, drain the recorder).  Prints the
harness's result line, then one line ``RIG {...}``.  The recorder off gives
the same traced run as ``matbench.run --trace 1``, for its cost.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def union(intervals) -> list:
    """Sorted disjoint [start, end] intervals covering the given ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def nearest_rank(values, q: float):
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)] if v else None


def readings(spans, busy, bounds, mattes: int, window_ns) -> dict:
    """The three readings from the drained spans, the card's merged busy
    intervals and the stretch's (first, last) event in ns, the mattes
    completed in the stretch, and the window's (open, close) in ns."""
    t0, t1 = bounds
    idle, last = [], t0
    for s, e in busy:
        if s > last:
            idle.append([last, s])
        last = max(last, e)
    if t1 > last:
        idle.append([last, t1])
    by: dict = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    out = {"spans": {k: len(v) for k, v in by.items()},
           "idle_ms_per_matte": overlap(idle, [[t0, t1]]) / 1e6 / mattes if mattes else None}
    for metric, name in (("pipeline.heavy_idle_ms", "pipeline.heavy"),
                         ("serve.host_idle_ms", "serve.batch")):
        iv = union([(s.start_ns, s.end_ns) for s in by.get(name, [])])
        out[metric] = overlap(iv, idle) / 1e6 / mattes if mattes and iv else None
    queued = by.get("serve.queued", [])
    if queued:
        w0, close = window_ns
        waits = [(s.end_ns - s.start_ns) / 1e6 for s in queued if w0 <= s.start_ns <= close]
        out["serve.queue_wait_ms"] = nearest_rank(waits, 0.95)
        out["queue_wait_p50_ms"] = nearest_rank(waits, 0.50)
        out["queue_wait_samples"] = len(waits)
        ending: dict = {}
        for s in queued:
            ending.setdefault(s.end_ns, set()).add(s.attrs["request"])
        batches = by.get("serve.batch", [])
        out["serve_batches"] = len(batches)
        out["serve_batches_whose_ids_mismatch"] = sum(
            set(b.attrs["requests"]) != ending.get(b.start_ns, set()) for b in batches)
        if out["serve.host_idle_ms"] is not None and out["idle_ms_per_matte"] is not None:
            out["serve.waiting_idle_ms"] = out["idle_ms_per_matte"] - out["serve.host_idle_ms"]
    return out


HEAVY_COUNTERS = ("heavy.graph_captures", "heavy.graph_replays", "heavy.graph_fallbacks",
                  "heavy.eager")
VITMATTE_COUNTERS = ("vitmatte.tables_built", "attention.relpos_launches")
NORM_COUNTERS = ("norm.kernel_launches", "norm.plain_sites")


def heavy_graphs(counters) -> dict:
    """The heavy step's graph counters and replays over heavy calls."""
    out = {k: counters.get(k, 0.0) for k in HEAVY_COUNTERS}
    calls = sum(out.values())
    out["heavy.graph_replay_share"] = out["heavy.graph_replays"] / calls if calls else None
    return out


def in_window(names, counters, at_open) -> dict:
    """Counters over the run and inside the window (from its open to the
    run's end)."""
    out = {}
    for k in names:
        out[k] = counters.get(k, 0.0)
        out[k + ".in_window"] = counters.get(k, 0.0) - at_open.get(k, 0.0)
    return out


def memory(device) -> dict:
    """The card's allocated and reserved bytes, and the reserved bytes of
    graph pools (segments outside the default pool), in GiB."""
    import torch
    if device.type != "cuda":
        return {}
    pools = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))
    return {"allocated_gib": torch.cuda.memory_allocated(device) / 2**30,
            "reserved_gib": torch.cuda.memory_reserved(device) / 2**30,
            "graph_pool_gib": pools / 2**30}


def main():
    import argparse
    sys.path.insert(0, str(ROOT))
    from matbench import run as mrun          # stamps the process start first
    ap = argparse.ArgumentParser(prog="python3 tools/span_readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU, its convs and matmuls standing for device work")
    a = ap.parse_args()

    from matbench import harness
    from matbench import trace as tracing
    harness.use_checkout_caches()
    import torch
    from sdmatte_tpu_torch.utils import observability as obs

    got = {}
    vit = a.workload.startswith("vitmatte")
    reset = harness._reset_peak

    def reset_peak(device):
        reset(device)
        got["w0_ns"] = time.time_ns()
        got["counters_at_open"] = dict(obs.METRICS.counters)
        if a.recorder:
            obs.start()
    harness._reset_peak = reset_peak

    reduce = tracing.reduce

    def reduce_keeping(prof, top=10):
        dev, every = [], []
        for e in prof.profiler.kineto_results.events():
            kind = tracing._kind(e)
            if kind is None:
                continue
            iv = (e.start_ns(), e.start_ns() + e.duration_ns())
            every.append(iv)
            if kind != "host":
                dev.append(iv)
        got["drained"] = obs.drain() if a.recorder else obs.Drained([], 0)
        got["memory"] = memory(device)
        if dev:
            got["bounds"] = (min(s for s, _ in every), max(e for _, e in every))
            got["busy"] = union(dev)
        got["r"] = reduce(prof, top)
        return got["r"]
    tracing.reduce = reduce_keeping

    kw = {}
    if a.rehearse:
        sys.path.insert(0, str(ROOT / "matbench" / "tests"))
        import conftest as tiny
        _, cfg = harness.find_cell(harness.load_benchmark(), a.workload)
        if cfg["name"].startswith("vitmatte"):
            import test_matbench_vitmatte as tiny_vit
            kw = dict(conf=tiny_vit.tiny_conf(), mix=tiny_vit.small_mix())
        else:
            kw = dict(conf=tiny.tiny_conf(cfg["name"]),
                      mix=tiny.small_mix("open" if "serve" in a.workload else "closed"))
        if "w8" in a.workload:
            from sdmatte_tpu_torch.ops import quant
            quant.STORAGE_MIN_ELEMS = 1024
        device = torch.device("cpu")
        kind = tracing._kind

        def cpu_kind(e):
            k = kind(e)
            return "kernel" if k == "host" and e.name() in (
                "aten::mm", "aten::addmm", "aten::convolution") else k
        tracing._kind = cpu_kind
    else:
        device = torch.device("cuda", 0)
    print(f"card: {harness.card_note()}", file=sys.stderr)
    res = harness.run(a.workload, a.seed, a.seconds, True, device=device, t0=mrun.T0, **kw)
    for note in res.notes:
        print(note, file=sys.stderr)
    print(harness.result_line(res), flush=True)

    r = got["r"]
    out = {"workload": a.workload, "seed": a.seed, "recorder": a.recorder,
           "s_per_matte": r.s_per_matte, "mattes_in_stretch": r.mattes,
           "launches_per_matte": len(r.kernels) / r.mattes if r.mattes else None,
           "idle_pct": 100 * (1 - r.busy_s / r.window_s) if r.window_s else None,
           "correct": res.correct, **heavy_graphs(obs.METRICS.counters),
           **in_window(NORM_COUNTERS, obs.METRICS.counters, got.get("counters_at_open", {})),
           **got.get("memory", {})}
    spans, out["dropped"] = got["drained"]
    if vit:
        out.update(in_window(VITMATTE_COUNTERS, obs.METRICS.counters,
                             got.get("counters_at_open", {})))
    if a.recorder:
        window = (got["w0_ns"], got["w0_ns"] + int(a.seconds * 1e9))
        out.update(readings(spans, got.get("busy", []), got.get("bounds", (math.inf, math.inf)),
                            r.mattes, window))
    print("RIG " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
