"""K1 (flash_fwd_sm90, the U-Net's d = 64 attention) against its roofline."""

import importlib

LAYER = "ops/flash_attention.py (K1, K2)"
UNIT = "%"
MOVES = "mattes_per_s"


def read(t):
    return importlib.import_module("matbench.metrics._roofline").attention(
        t, "flash_attention_k1", "flash_fwd_sm90")
