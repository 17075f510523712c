"""The control: the program's own lower-precision path, the architecture
module's ``CONTROL`` keywords (for SDMatte the VAE's 3x3 convs in int8,
``vae_int8``), in the program's place must come out not correct.

On the CPU at the tiny configuration it reads above the bf16 program on
every seed; on the card (``-m cuda``) it is run at each cell's own size on
three seeds and must fail the cell's limit on each:

    python3 -m pytest matbench/tests/test_matbench_control.py -m cuda
"""

from __future__ import annotations

import pytest
import torch

from conftest import small_mix, tiny_conf
from matbench import architecture, calibrate, compare, harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_above_the_program_at_tiny_size(workload):
    loop = "open" if "serve" in workload else "closed"
    rows = list(calibrate.readings(workload, [1, 2], {1, 2}, 1.5, device=torch.device("cpu"),
                                   conf=tiny_conf(workload.split(".")[0], compute="bfloat16"),
                                   mix=small_mix(loop)))
    for r in rows:
        assert max(r["control"].values()) > 2.0 * max(r["program"].values()), r
    s = calibrate.summary(rows)
    assert s["lower"] > 0 and s["upper"] > s["lower"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_the_architectures_lower_precision_path(workload):
    """Both configurations are SDMatte's, whose control is ``vae_int8``."""
    conf, _ = harness.cell_files(workload)
    assert architecture.name_of(conf) == "sdmatte"
    assert architecture.program_of(conf).CONTROL == {"vae_int8": True}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    harness.use_checkout_caches()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit_at_the_cells_size(card, workload):
    seeds = [4_000_000_001, 4_000_000_002, 4_000_000_003]
    limit = compare.limits(workload)["gap_ratio"]
    for r in calibrate.readings(workload, seeds, set(seeds), 8.0, device=card):
        assert max(r["program"].values()) <= limit, r
        assert max(r["control"].values()) > limit, r
