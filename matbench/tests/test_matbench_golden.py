"""SDMatte's numbers do not move when the architecture-specific code moves:
the seeded weights (same tensors, same order, same derived seeds), the
reference's answers and the operation count that ``step_mfu`` divides by
are held to values recorded before the architecture modules existed
(``golden_sdmatte.json``, whose ``about`` says how)."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest
import torch

from conftest import ROOT, small_mix, tiny_conf
from matbench import architecture, harness, program, weights
from matbench.reference import sdmatte_ref
from matbench.traffic import generate

DEV = torch.device("cpu")
GOLDEN = json.loads((Path(__file__).resolve().parent / "golden_sdmatte.json").read_text())
NAMES = ["sdmatte-bf16", "sdmatte-bf16-w8"]


def digest(t: torch.Tensor, n: int) -> str:
    t = t.detach().contiguous().cpu()
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()[:n]


def photo():
    g = torch.Generator().manual_seed(GOLDEN["seed"] % 2 ** 31)
    return (torch.rand(40, 52, 3, generator=g),
            (torch.rand(40, 52, generator=g) * 2).round() / 2)


@pytest.mark.parametrize("name", NAMES)
def test_seeded_weights_are_the_golden_ones(name):
    conf = tiny_conf(name)
    arch = architecture.program_of(conf)
    with program._skeleton():
        model = arch.declare(conf)
    params = weights.make_params(conf, GOLDEN["seed"], DEV,
                                 extra_shapes=arch.program_only_shapes(model))
    assert [[k, digest(v, 12)] for k, v in params.items()] == \
        [list(kv) for kv in GOLDEN["weights"].items()]


@pytest.mark.parametrize("name", NAMES)
def test_reference_answers_are_the_golden_ones(name, monkeypatch):
    monkeypatch.setattr(sdmatte_ref, "INT8_MIN_ELEMS", 1024)
    refs = harness.reference_answers(tiny_conf(name), GOLDEN["seed"], DEV, {0: photo()},
                                     small_mix())
    (alpha, matted), (alpha_bf16, matted_bf16) = refs[0]
    got = {"alpha": digest(alpha, 16), "matted": digest(matted, 16),
           "alpha_bf16": digest(alpha_bf16, 16), "matted_bf16": digest(matted_bf16, 16),
           "alpha_sum": float(alpha.double().sum())}
    assert got == GOLDEN["reference"][name]


def test_model_flops_at_1024_are_the_golden_count():
    conf = json.loads((ROOT / "matbench" / "configs" / "sdmatte-bf16.json").read_text())
    mix = generate.load_mix("node-1024")
    assert harness.model_flops(conf, mix) == GOLDEN["model_flops_1024"] == 28_752_180_281_344
