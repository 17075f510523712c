"""The result line: its keys, their order and types, at the tiny
configuration on the CPU with a clock that ticks by a fixed step; and the
command's refusal to run without a card."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import small_mix, tiny_conf
from matbench import harness, run

DEV = torch.device("cpu")
BENCH = harness.load_benchmark()


class TickClock:
    """Advances by ``step`` seconds at every reading."""

    def __init__(self, step=0.05):
        self.t, self.step = 1000.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _units(kind):
    return {m["name"]: m["unit"] for m in BENCH[kind]}


@pytest.mark.parametrize("workload,trace", [("sdmatte-bf16.node-1024", 0),
                                            ("sdmatte-bf16-w8.single-1024", 1)])
def test_result_line_shape(workload, trace):
    clock = TickClock()
    res = harness.run(workload, 2 ** 31 + 99, 1.0, bool(trace), device=DEV, t0=clock.t,
                      conf=tiny_conf(workload.split(".")[0]), mix=small_mix(), clock=clock)
    line = json.loads(harness.result_line(res))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    # two readings a call at 0.05 s a reading: 0.1 s per call, ten calls in 1 s
    assert line["attempted"] == 10
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    kind = "per_layer" if trace else "end_to_end"
    units = _units(kind)
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in
                                        harness.cell_metrics(BENCH, workload, "end_to_end")}
        assert line["metrics"]["latency_p50_ms"]["value"] == pytest.approx(50.0)
        assert line["metrics"]["mattes_per_s"]["value"] == pytest.approx(10.0)
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_open_loop_line_counts_every_request():
    mix = small_mix("open")
    res = harness.run("sdmatte-bf16.serve-poisson-1024", 17, 2.0, True, device=DEV,
                      t0=0.0, conf=tiny_conf(), mix=mix)
    line = json.loads(harness.result_line(res))
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == pytest.approx(2.0 * mix["rate_mattes_per_s"], abs=3)
    assert "serve.images_per_call" in line["metrics"]
    plain = harness.run("sdmatte-bf16.serve-poisson-1024", 17, 1.0, False, device=DEV,
                        t0=0.0, conf=tiny_conf(), mix=mix)
    assert set(plain.metrics) == {"mattes_per_s", "latency_p95_ms.serve", "setup_s"}
    assert line["metrics"]["serve.images_per_call"]["value"] >= 1.0


def test_cells_report_what_benchmark_json_says():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, w["name"], "end_to_end")}
        assert {"setup_s", "mattes_per_s"} <= e2e
        per = harness.cell_metrics(BENCH, w["name"], "per_layer")
        assert per and all(m["moves"] in e2e for m in per)
        for m in per:
            reader = harness.load_reader(m["name"])
            assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"],
                                                                 m["moves"])


def test_command_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "sdmatte-bf16.node-1024", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
