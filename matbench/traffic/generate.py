"""The one traffic generator: reads a mix file ``matbench/traffic/<mix>.json``
and turns it, with the run's seed, into a pool of photos and a request plan.

Every seed gets the same set of sizes and arrivals; the seed changes their
order and the photos' content, so two seeds do the same work.

Mix keys:

* ``entry``: where the requests go in, and so how they are driven:
  "pipeline" (``MattingPipeline.__call__``, one client in a closed loop: the
  next call when the last returned) or "microbatcher" (the server's
  ``MicroBatcher.submit``, an open loop: requests on a schedule, whatever
  the system does).  ``harness.DRIVERS`` maps each entry to its driver and
  refuses any other.
* ``pool``: how many distinct photos; requests cycle through them.
* ``sizes``: [[H, W], ...] cycled over the pool.
* ``band_frac`` [lo, hi]: the trimap's unknown band in iterations, as a share
  of the long side, at the pool's quantiles.
* ``options``: the pipeline's per-call options (the node's inputs).
* "microbatcher": ``server`` (the service's keywords), ``rate_mattes_per_s``
  (Poisson arrivals of one request each: the exponential law's gaps at
  their quantiles), ``plan_seed``, where given, fixes the order of the gaps
  for every run (the seed still draws which photo each request sends), so
  that runs differ by the system's timing alone.

Every answer due in the window is judged, against the reference's answer
for its photo: the reference runs once per photo of the pool.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import synthetic

TRAFFIC_DIR = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    with open(TRAFFIC_DIR / f"{name}.json") as f:
        return json.load(f)


def derive_seed(seed: int, salt: str) -> int:
    """A 63-bit seed for one purpose (weights, photos, plan) of a run seed."""
    salt_int = int.from_bytes(salt.encode(), "little")
    return int(np.random.SeedSequence([int(seed), salt_int]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


@dataclass(frozen=True)
class PoolEntry:
    h: int
    w: int
    band: int
    kind: str
    background: str


def pool_layout(mix: dict) -> list[PoolEntry]:
    """The pool's sizes, bands and kinds: a function of the mix alone."""
    k = int(mix["pool"])
    q = [(i + 0.5) / k for i in range(k)]
    sizes = [tuple(mix["sizes"][i % len(mix["sizes"])]) for i in range(k)]
    blo, bhi = mix.get("band_frac", [0.01, 0.03])
    out = []
    for i, (h, w) in enumerate(sizes):
        frac = blo + (bhi - blo) * q[(5 * i) % k]
        out.append(PoolEntry(h, w, max(1, int(round(frac * max(h, w)))),
                             synthetic.KINDS[i % len(synthetic.KINDS)],
                             synthetic.BACKGROUNDS[(i // len(synthetic.KINDS)) % len(synthetic.BACKGROUNDS)]))
    return out


def make_pool(mix: dict, seed: int, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(image (H,W,3), trimap (H,W)) fp32 host tensors, made on ``device``
    from the seed and copied to the host once."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "photos"))
    pool = []
    for e in pool_layout(mix):
        img, tri, _ = synthetic.photo(e.kind, e.background, e.h, e.w, e.band, gen, device)
        pool.append((img.cpu(), tri.cpu()))
    return pool


def closed_order(mix: dict, seed: int, n: int) -> list[int]:
    """Pool indices of the first ``n`` calls: each run of ``pool`` calls is a
    fresh permutation of the whole pool."""
    rng = np.random.default_rng(derive_seed(seed, "plan"))
    k = int(mix["pool"])
    out = []
    while len(out) < n:
        out.extend(int(i) for i in rng.permutation(k))
    return out[:n]


def open_schedule(mix: dict, seed: int, seconds: float, rate: float | None = None):
    """[(due seconds from the window's start, pool index)] for a window of
    ``seconds``: Poisson arrivals of one request each at
    ``rate_mattes_per_s`` (the gaps are the exponential law's quantiles,
    shuffled, scaled to fill the window), the first at 0."""
    rate = float(rate if rate is not None else mix["rate_mattes_per_s"])
    n = max(1, int(round(seconds * rate)))
    rng = np.random.default_rng(derive_seed(mix.get("plan_seed", seed), "plan"))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps = gaps / gaps.sum() * seconds
    gaps = gaps[rng.permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return [(float(t), k) for t, k in zip(due, closed_order(mix, seed, n))]
