"""The whole matte's share of the card's bf16 peak: the least time of the
model's operations (counted from shapes on the frozen reference's forward,
at 989 TFLOP/s) over the measured time per matte (the traced run's window
outside its profiled stretch).  It reads the same work whatever implements
it, so it still bounds a gain after a kernel leaves the path."""

import importlib

LAYER = "models/sdmatte.py (VAE encode, U-Net, decode)"
UNIT = "%"
MOVES = "mattes_per_s"


def read(t):
    counting = importlib.import_module("matbench.counting")
    if not t.flops_per_matte or not t.s_per_matte:
        return None
    return 100.0 * (t.flops_per_matte / counting.BF16_FLOPS) / t.s_per_matte
