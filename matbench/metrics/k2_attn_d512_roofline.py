"""K2 (flash_fwd_d512_sm90, the VAE mid-block's single d = 512 head) against
its roofline."""

import importlib

LAYER = "ops/flash_attention.py (K1, K2)"
UNIT = "%"
MOVES = "mattes_per_s"


def read(t):
    return importlib.import_module("matbench.metrics._roofline").attention(
        t, "flash_attention_k2", "flash_fwd_d512_sm90")
