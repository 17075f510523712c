"""The traffic generator: deterministic from the seed, true to its mix's
parameters, and the same work for every seed."""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import pytest
import torch

from matbench.traffic import generate, synthetic

SEEDS = (0, 7, 2 ** 31 + 12345, 2 ** 33 + 5)


def test_node_mix_pool_layout_matches_its_parameters():
    mix = generate.load_mix("node-1024")
    layout = generate.pool_layout(mix)
    assert len(layout) == mix["pool"] == 8
    assert {(e.h, e.w) for e in layout} == {tuple(s) for s in mix["sizes"]}
    for e in layout:
        frac = e.band / max(e.h, e.w)
        assert mix["band_frac"][0] - 1e-3 <= frac <= mix["band_frac"][1] + 1e-3
    assert Counter(e.kind for e in layout) == Counter({k: 2 for k in synthetic.KINDS})


def test_closed_order_each_cycle_is_the_whole_pool():
    mix = generate.load_mix("node-1024")
    k = mix["pool"]
    for seed in SEEDS:
        order = generate.closed_order(mix, seed, 4 * k)
        assert order == generate.closed_order(mix, seed, 4 * k)
        for c in range(4):
            assert sorted(order[k * c:k * (c + 1)]) == list(range(k))
    assert generate.closed_order(mix, 1, 32) != generate.closed_order(mix, 2, 32)


def test_open_schedule_same_work_for_every_seed():
    mix = generate.load_mix("serve-poisson-1024")
    free = {k: v for k, v in mix.items() if k != "plan_seed"}
    seconds = 40.0
    for m in (mix, free):
        counts = set()
        for seed in SEEDS:
            sched = generate.open_schedule(m, seed, seconds)
            assert sched == generate.open_schedule(m, seed, seconds)
            due = [t for t, _ in sched]
            assert due == sorted(due) and due[0] == 0.0 and due[-1] < seconds
            assert len(set(due)) == len(due)          # one request per arrival
            counts.add(len(sched))
        assert counts == {round(seconds * m["rate_mattes_per_s"])}
    # the mix's plan seed fixes the arrivals; the run's seed, the photos
    a, b = generate.open_schedule(mix, 1, seconds), generate.open_schedule(mix, 2, seconds)
    assert [t for t, _ in a] == [t for t, _ in b] and a != b
    a, b = generate.open_schedule(free, 1, seconds), generate.open_schedule(free, 2, seconds)
    assert [t for t, _ in a] != [t for t, _ in b]


def test_gaps_are_exponential_quantiles():
    mix = dict(generate.load_mix("serve-poisson-1024"), rate_mattes_per_s=4.5)
    sched = generate.open_schedule(mix, 3, 400.0)
    gaps = np.diff([t for t, _ in sched])
    mean = 400.0 / len(sched)
    assert gaps.mean() == pytest.approx(mean, rel=0.05)
    assert np.median(gaps) == pytest.approx(mean * math.log(2), rel=0.1)


def test_pool_is_deterministic_from_the_seed():
    mix = {"pool": 3, "sizes": [[40, 56], [56, 40]], "band_frac": [0.05, 0.1]}
    a = generate.make_pool(mix, 11, torch.device("cpu"))
    b = generate.make_pool(mix, 11, torch.device("cpu"))
    c = generate.make_pool(mix, 12, torch.device("cpu"))
    for (ia, ta), (ib, tb) in zip(a, b):
        assert torch.equal(ia, ib) and torch.equal(ta, tb)
    assert not all(torch.equal(x[0], y[0]) for x, y in zip(a, c))
    for img, tri in a:
        assert img.dtype == torch.float32 and 0 <= img.min() and img.max() <= 1
        assert set(torch.unique(tri).tolist()) <= {0.0, 0.5, 1.0}


def test_trimap_matches_the_programs_generator():
    """The copy's dilation against scipy's, which the program's eval set uses."""
    ndimage = pytest.importorskip("scipy.ndimage")
    g = torch.Generator().manual_seed(0)
    for kind in synthetic.KINDS:
        alpha = synthetic.matte_alpha(kind, 60, 80, g, torch.device("cpu"))
        for band in (1, 3, 7):
            a = alpha.numpy().astype(np.float64)
            fg = a > 1.0 - 1.0 / 255.0
            bg = a < 1.0 / 255.0
            unknown = ndimage.binary_dilation(~(fg | bg), iterations=band)
            want = np.where(unknown, 0.5, np.where(fg, 1.0, 0.0))
            got = synthetic.trimap_from_alpha(alpha, band).numpy()
            assert np.array_equal(got, want), (kind, band)


def test_mixes_name_a_known_entry():
    from matbench import harness
    for name in ("node-1024", "serve-poisson-1024"):
        assert harness.driver_of(generate.load_mix(name)) in harness.DRIVERS.values()
    with pytest.raises(SystemExit, match="no driver for entry"):
        harness.driver_of({"entry": "workflow"})
