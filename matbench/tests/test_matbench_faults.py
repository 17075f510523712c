"""A run with the timed path broken underneath must come out not correct:
the look for a card is skipped (CPU, tiny configuration), the rest of the
run is the benchmark's own, with every answer of the window judged.  Faults
a cell can have: an answer altered where it is produced (every cell; once,
in a single call, too), and, where calls are batched, half of the batch left
out with the mean of the rest answered in its place."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import small_mix, tiny_conf
from matbench import harness, program

DEV = torch.device("cpu")


class Broken:
    """The pipeline with one fault planted at its output."""

    def __init__(self, pipe, fault):
        self._pipe, self._fault, self._calls = pipe, fault, 0

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def __call__(self, image, prompt_mask, **kw):
        if self._fault == "half_batch" and len(image) > 1:
            keep = (len(image) + 1) // 2
            alpha, matted = self._pipe(image[:keep], prompt_mask[:keep], **kw)
            fill = alpha.mean(dim=0, keepdim=True).expand(len(image) - keep, *alpha.shape[1:])
            return torch.cat([alpha, fill]), torch.cat(
                [matted, matted.mean(dim=0, keepdim=True).expand(
                    len(image) - keep, *matted.shape[1:])])
        alpha, matted = self._pipe(image, prompt_mask, **kw)
        self._calls += 1
        # "once": the third call after the closed loop's warm-up of its pool of 4
        if self._fault == "altered" or (self._fault == "once" and self._calls == 7):
            alpha = alpha * 0.5
        return alpha, matted


def _plant(monkeypatch, fault):
    real = program.build_pipeline
    monkeypatch.setattr(program, "build_pipeline",
                        lambda *a, **k: Broken(real(*a, **k), fault))


@pytest.mark.parametrize("workload", ["sdmatte-bf16.node-1024", "sdmatte-bf16-w8.single-1024",
                                      "sdmatte-bf16.serve-poisson-1024"])
def test_sound_run_is_correct(workload):
    mix = small_mix("open" if "serve" in workload else "closed")
    res = harness.run(workload, 21, 1.5, False, device=DEV, t0=0.0,
                      conf=tiny_conf(workload.split(".")[0]), mix=mix)
    assert res.correct


@pytest.mark.parametrize("workload,fault", [
    ("sdmatte-bf16.node-1024", "altered"),
    ("sdmatte-bf16.node-1024", "once"),
    ("sdmatte-bf16-w8.single-1024", "altered"),
    ("sdmatte-bf16.serve-poisson-1024", "altered"),
    ("sdmatte-bf16.serve-poisson-1024", "half_batch"),
])
def test_planted_fault_is_not_correct(monkeypatch, workload, fault):
    _plant(monkeypatch, fault)
    mix = small_mix("open" if "serve" in workload else "closed")
    if fault == "half_batch":
        # arrivals faster than the tiny model on the CPU serves them one by
        # one, so that requests queue and calls hold two or more
        mix["rate_mattes_per_s"] = 40.0
    res = harness.run(workload, 21, 1.5, False, device=DEV, t0=0.0,
                      conf=tiny_conf(workload.split(".")[0]), mix=mix)
    if fault == "half_batch":
        calls = int(next(n for n in res.notes if n.startswith("pipeline calls"))
                    .rsplit(" ", 1)[1])
        assert calls < res.attempted          # some call was a batch of 2+
    assert not res.correct
    worst = max(c["value"] for c in res.checks.values())
    assert worst > max(c["limit"] for c in res.checks.values())


def test_pipeline_keys_reach_the_program_and_the_reference():
    """A configuration's pipeline keys all go to ``MattingPipeline`` (an
    unknown one raises there), and the reference refuses one it does not
    model rather than judge another path against the default one."""
    mix = small_mix()
    conf = tiny_conf()
    conf["pipeline"] = {"weight_storage": "fp", "no_such_keyword": 1}
    with pytest.raises(TypeError, match="no_such_keyword"):
        harness.run("sdmatte-bf16.node-1024", 3, 0.5, False, device=DEV, t0=0.0,
                    conf=conf, mix=mix)
    conf["pipeline"] = {"weight_storage": "fp", "speed_mode": "fastest"}
    with pytest.raises(SystemExit, match="speed_mode"):
        harness.run("sdmatte-bf16.node-1024", 3, 0.5, False, device=DEV, t0=0.0,
                    conf=conf, mix=mix)


def test_gap_ratio_by_hand():
    from matbench import compare
    ref = (torch.full((4, 4), 0.5), torch.zeros(4, 4, 3))
    low = (torch.full((4, 4), 0.51), torch.zeros(4, 4, 3))       # scale 16 * 0.01
    assert compare.gap_ratio(ref, ref, low) == 0.0
    got = (torch.full((4, 4), 0.52), torch.zeros(4, 4, 3))
    assert compare.gap_ratio(got, ref, low) == pytest.approx(2.0)
    # an answer that never came, or in the wrong shape, reads as zeros
    assert compare.gap_ratio(None, ref, low) == pytest.approx(50.0)
    wrong = (np.zeros((4, 5)), np.zeros((4, 5, 3)))
    assert compare.gap_ratio(wrong, ref, low) == pytest.approx(50.0)
    assert compare.gap_ratio(got, ref, ref) == float("inf")
