"""K1's relative-position mode (flash_fwd_relpos_sm90: ViTMatte's global
blocks over the token grid, its windowed blocks over all windows at once)
against its roofline: the least time of the launches in that mode that the
launch log saw (sizes read at ``Kernel.launch``; operations and bytes in
``_relpos.py``) over the device time of the kernels of that name."""

import importlib

LAYER = "ops/flash_attention.py (K1, K2)"
UNIT = "%"
MOVES = "mattes_per_s"


def read(t):
    c = importlib.import_module("matbench.counting")
    w = importlib.import_module("matbench.metrics._relpos")
    calls = [a for a in t.launches.get("flash_attention_k1", [])
             if len(a) > w.RH + 3 and a[0] == 1 and a[w.RH] is not None]
    dev = sum(s for name, s in t.kernels if "flash_fwd_relpos_sm90" in name)
    if not calls or dev <= 0:
        return None
    least = 0.0
    for a in calls:
        d, b, h, lq, lk = a[1], a[12], a[13], a[14], a[15]
        kh, kw = a[w.RH + 2], a[w.RH + 3]
        least += c.bound_s(*w.relpos_attention_work(b, h, lq, lk, d, kh, kw))
    return 100.0 * least / dev
