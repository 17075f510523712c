"""The benchmark's command: one run of one cell on the card this process
runs on.

    python3 -m matbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

It prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number with
its limit (also the last lines of standard error).  Without a CUDA card, or
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded once the window has closed, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import time


def _process_start() -> float:
    """``time.perf_counter()`` at this process's start (Linux ``/proc``), so
    that set-up counts the interpreter and every import too."""
    now = time.perf_counter()
    try:
        import os
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m matbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import harness
    harness.use_checkout_caches()
    import torch
    bench = harness.load_benchmark()
    wl, _ = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"matbench: the cell needs {wl['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"card: {harness.card_note()}", file=sys.stderr)
    res = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      device=device, t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"matbench: loaded in this process: {', '.join(bad)}; no result",
              file=sys.stderr)
        return 2
    for note in res.notes:
        print(note, file=sys.stderr)
    for name, c in res.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
