"""Shared arithmetic of the hand kernels' roofline readers: the least time
of the calls a kernel served in the traced stretch (sizes read at its
launch) over the device time of the kernels with its name."""

import importlib


def attention(t, kernel, device_name):
    c = importlib.import_module("matbench.counting")
    calls = [a for a in t.launches.get(kernel, []) if a[0] == 1]   # bf16
    dev = sum(s for name, s in t.kernels if device_name in name)
    if not calls or dev <= 0:
        return None
    least = 0.0
    for a in calls:
        d, b, h, lq, lk = a[1], a[12], a[13], a[14], a[15]
        least += c.bound_s(*c.attention_work(b, h, lq, lk, d, a[5] is not None))
    return 100.0 * least / dev


def conv3x3(t, kernel, device_name):
    c = importlib.import_module("matbench.counting")
    calls = [a for a in t.launches.get(kernel, []) if a[0] == 1]   # bf16
    dev = sum(s for name, s in t.kernels if device_name in name)
    if not calls or dev <= 0:
        return None
    least = 0.0
    for a in calls:
        b, h, w, cin, cout = a[8:13]
        least += c.bound_s(*c.conv3x3_work(b, h, w, cin, cout, a[4] is not None,
                                           a[6] is not None))
    return 100.0 * least / dev
