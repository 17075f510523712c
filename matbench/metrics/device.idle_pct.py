"""Share of the traced stretch in which no kernel, copy or set ran on the
card (torch.profiler's device timeline): the host holding the card back."""

LAYER = "the device (the host's launch path)"
UNIT = "%"
MOVES = "mattes_per_s"


def read(t):
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
