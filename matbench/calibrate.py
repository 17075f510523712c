"""The readings a cell's limit is set from, and its control.

    python3 -m matbench.calibrate --workload <cell> --seeds a,b,... \\
        --control-seeds a,b,c --seconds 8

For each seed: the program drives the cell's traffic for ``--seconds`` (the
timed path and its sizes, a shorter window), and every answer is judged
against the reference (``compare.gap_ratio``), the worst kept for each photo
of the pool; for a control seed, the control
then takes the program's place on the same traffic and is judged against
the same reference answers.  The control is the program's own
lower-precision path, the pipeline keywords ``CONTROL`` of the
configuration's architecture module (``programs/<architecture>.py``): for
SDMatte the VAE's 3x3 convs in int8 (``vae_int8``), one step below the
configuration's bf16.

One JSON line per seed, then a summary: the lower reading (the largest the
program gave), the upper reading (the smallest of the control's per-run
worst), and their ratio.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness


def readings(workload: str, seeds, control_seeds, seconds: float, *, device,
             conf=None, mix=None):
    """One row per seed: the program's readings and, on a control seed,
    the control's, each {photo: the largest gap_ratio of its answers}."""
    conf, mix = harness.cell_files(workload, conf, mix)
    for seed in seeds:
        t0 = time.perf_counter()
        d = harness.drive(workload, seed, seconds, False, device=device, t0=t0,
                          conf=conf, mix=mix)
        refs = harness.reference_answers(conf, seed, device, d.inputs, mix)
        row = {"seed": seed, "program": harness.judge(d, refs),
               "completed": d.completed, "attempted": d.attempted}
        if seed in control_seeds:
            dc = harness.drive(workload, seed, seconds, False, device=device,
                               t0=time.perf_counter(), conf=conf, mix=mix, control=True)
            row["control"] = harness.judge(dc, refs)
        yield row


def summary(rows) -> dict:
    lower = max(max(r["program"].values()) for r in rows)
    ctrl = [max(r["control"].values()) for r in rows if "control" in r]
    upper = min(ctrl) if ctrl else None
    return {"lower": lower, "upper": upper,
            "ratio": (upper / lower) if upper and lower else None,
            "seeds": len(rows), "control_seeds": len(ctrl)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m matbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    if not torch.cuda.is_available():
        print("matbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for row in readings(args.workload, seeds, control, args.seconds,
                        device=torch.device("cuda", 0)):
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
