"""Kernels in the traced stretch over the mattes completed in it: the work
the host's launch path does per matte."""

LAYER = "the device (the host's launch path)"
UNIT = "launches"
MOVES = "mattes_per_s"


def read(t):
    if not t.kernels or t.mattes <= 0:
        return None
    return len(t.kernels) / t.mattes
