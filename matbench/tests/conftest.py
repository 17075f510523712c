"""Shared pieces of the benchmark's CPU tests: a tiny configuration (the
port's ``SDMatteConfig.tiny()`` sizes in a configuration file's form) and a
small mix of each loop."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def tiny_conf(name="sdmatte-bf16", compute="float32") -> dict:
    conf = json.load(open(ROOT / "matbench" / "configs" / f"{name}.json"))
    conf = copy.deepcopy(conf)
    conf["vae"].update(block_out_channels=[8, 16, 16, 16], norm_num_groups=4,
                       layers_per_block=1)
    conf["unet"].update(block_out_channels=[16, 24, 32, 32], layers_per_block=1,
                        cross_attention_dim=32, attention_head_dim=[2, 2, 4, 4],
                        norm_num_groups=8, aux_token_dim=32)
    conf["text_encoder"].update(vocab_size=1000, hidden_size=32, num_hidden_layers=2,
                                num_attention_heads=4, intermediate_size=64)
    conf["precision"] = {"params": compute, "compute": compute, "accumulate": "float32"}
    return conf


def small_mix(loop="closed") -> dict:
    """A closed loop into the pipeline, or an open one into the MicroBatcher."""
    mix = {"entry": "pipeline" if loop == "closed" else "microbatcher", "pool": 4,
           "band_frac": [0.01, 0.03],
           "options": {"inference_size": 64, "output_mode": "alpha_only", "mask_refine": True,
                       "trimap_constraint": 0.8, "is_transparent": False,
                       "aux_input": "trimap"}}
    if loop == "closed":
        mix.update(sizes=[[48, 64], [96, 72], [64, 64], [54, 96]])
    else:
        mix.update(sizes=[[64, 64]], rate_mattes_per_s=8.0,
                   server={"window_ms": 10.0, "max_batch": 4, "max_queue": 64})
    return mix


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
