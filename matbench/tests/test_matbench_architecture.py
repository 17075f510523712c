"""The architecture is a property of the configuration file.

A second architecture comes as new files alone: ``toy_arch/`` holds a toy's
configuration, its ``programs/`` module, its ``_ref.py`` and its cell's
limits, and ``entries.json`` the entries its change would add to
``BENCHMARK.json``.  The fixture puts them where the benchmark looks (the
two packages' paths, the benchmark it reads, the limits' directory) without
touching a file of the benchmark, and the toy runs through ``harness.run``
on the CPU.  A configuration without the key, or naming an architecture
that has no modules, is refused with the known names."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

from conftest import small_mix, tiny_conf
from matbench import architecture, calibrate, compare, harness, programs, reference, weights

DEV = torch.device("cpu")
TOY = Path(__file__).resolve().parent / "toy_arch"


@pytest.fixture
def toy(monkeypatch):
    """The toy architecture's cell name, with its files in place."""
    monkeypatch.setattr(programs, "__path__", [*programs.__path__, str(TOY / "programs")])
    monkeypatch.setattr(reference, "__path__", [*reference.__path__, str(TOY / "reference")])
    entries = json.loads((TOY / "entries.json").read_text())
    bench = harness.load_benchmark()
    bench["configs"] += entries["configs"]
    bench["workloads"] += entries["workloads"]
    monkeypatch.setattr(harness, "load_benchmark", lambda: copy.deepcopy(bench))
    monkeypatch.setattr(compare, "LIMITS_DIR", TOY / "limits")
    try:
        yield entries["workloads"][0]["name"]
    finally:
        for name in ("matbench.programs.toy", "matbench.reference.toy_ref"):
            sys.modules.pop(name, None)


def test_known_architectures():
    assert architecture.known() == ["sdmatte"]


def test_toy_is_known_from_its_files(toy):
    assert architecture.known() == ["sdmatte", "toy"]
    conf, _ = harness.cell_files(toy)
    assert architecture.program_of(conf).__name__ == "matbench.programs.toy"
    assert architecture.reference_of(conf).__name__ == "matbench.reference.toy_ref"


@pytest.mark.parametrize("trace", [0, 1])
def test_toy_architecture_runs_to_a_correct_line(toy, trace):
    res = harness.run(toy, 2 ** 31 + 5, 1.0, bool(trace), device=DEV, t0=0.0,
                      mix=small_mix())
    line = json.loads(harness.result_line(res))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 4
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    if not trace:
        assert set(line["metrics"]) == {"mattes_per_s", "setup_s"}
    else:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["checks"]) == small_mix()["pool"]


def test_toy_model_flops_come_from_its_reference(toy):
    """The toy runs at each photo's own size: its count is the mean over the
    pool's photos, each sent equally often."""
    conf, _ = harness.cell_files(toy)
    mix = small_mix()
    pixels = sum(h * w for h, w in mix["sizes"]) / len(mix["sizes"])
    per_pixel = 2 * 9 * (4 * conf["width"] + conf["width"] * 1)   # two per multiply-add
    assert harness.model_flops(conf, mix) == per_pixel * pixels


def test_planted_fault_in_the_toy_program_is_not_correct(toy, monkeypatch):
    conf, _ = harness.cell_files(toy)
    net = architecture.program_of(conf).Net
    forward = net.forward
    monkeypatch.setattr(net, "forward", lambda self, x: forward(self, x) * 0.5)
    res = harness.run(toy, 2 ** 31 + 5, 1.0, False, device=DEV, t0=0.0, mix=small_mix())
    assert not res.correct
    assert max(c["value"] for c in res.checks.values()) > compare.limits(toy)["gap_ratio"]


def test_toy_control_fails_its_limit(toy):
    limit = compare.limits(toy)["gap_ratio"]
    for r in calibrate.readings(toy, [11, 12], {11, 12}, 0.5, device=DEV, mix=small_mix()):
        assert max(r["program"].values()) <= limit < max(r["control"].values()), r


@pytest.mark.parametrize("arch", [None, "vitmatte"])
def test_configuration_without_a_known_architecture_is_refused(arch):
    conf = tiny_conf()
    if arch is None:
        del conf["architecture"]
    else:
        conf["architecture"] = arch
    with pytest.raises(SystemExit, match="known: sdmatte$") as e:
        harness.run("sdmatte-bf16.node-1024", 3, 0.5, False, device=DEV, t0=0.0,
                    conf=conf, mix=small_mix())
    assert ("names no architecture" if arch is None else repr(arch)) in str(e.value)
    with pytest.raises(SystemExit, match="known: sdmatte$"):
        weights.make_params(conf, 3, DEV)
