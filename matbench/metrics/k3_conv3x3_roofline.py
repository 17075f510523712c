"""K3 (conv3x3_sm90, the dispatch table's VAE-encoder convs) against its
roofline; its calls are the table's routes, so a retuned table changes the
count with them."""

import importlib

LAYER = "ops/conv3x3.py (K3, K4)"
UNIT = "%"
MOVES = "mattes_per_s"


def read(t):
    return importlib.import_module("matbench.metrics._roofline").conv3x3(
        t, "conv3x3", "conv3x3_sm90")
