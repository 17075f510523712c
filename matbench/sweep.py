"""Offered-rate sweep of an open-loop cell, to find once the highest rate the
system sustains; the cell's mix then fixes a rate below it.  Not part of a
benchmark run.

    python3 -m matbench.sweep --workload <open-loop cell> --seed <n> \\
        --seconds 40 --rates 4,4.5,5,5.5,6,6.5,7

Every rate is driven with the mix's own arrivals (its ``plan_seed``), for
the same window.  One line per rate: the offered and completed rates, p50
and p95, the requests still unanswered when the window closed, and whether
the rate is sustained by one rule: no request failed, and no more than one
full batch (the server's ``max_batch``) was left unanswered at the close.
A rate above what the system keeps up with leaves a backlog that grows all
through the window.  The last line names the knee: the highest rate that is
sustained, with every lower rate sustained too.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m matbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    if not torch.cuda.is_available():
        print("matbench.sweep: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    conf, mix = harness.cell_files(args.workload)
    max_batch = int(mix["server"]["max_batch"])
    knee, broken = None, False
    for rate in sorted(float(r) for r in args.rates.split(",")):
        t0 = time.perf_counter()
        d = harness.drive(args.workload, args.seed, args.seconds, False, device=device,
                          t0=t0, conf=conf, mix=mix, rate=rate)
        backlog = d.attempted - d.completed
        sustained = d.failed == 0 and backlog <= max_batch
        if sustained and not broken:
            knee = rate
        broken = broken or not sustained
        ms = [1e3 * x for x in d.latencies_s]
        print(json.dumps({"rate": rate, "completed_per_s": d.completed / d.window_s,
                          "attempted": d.attempted, "failed": d.failed,
                          "unanswered_at_close": backlog, "sustained": sustained,
                          "p50_ms": harness.nearest_rank(ms, 0.5),
                          "p95_ms": harness.nearest_rank(ms, 0.95),
                          "peak_gib": d.peak_bytes / 2 ** 30,
                          "notes": d.notes[-2:]}), flush=True)
    print(json.dumps({"knee_mattes_per_s": knee, "seconds": args.seconds,
                      "rule": f"no failure, at most {max_batch} unanswered at the close"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
