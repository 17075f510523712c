"""Requests completed in the window over the pipeline calls the
MicroBatcher made in it (the change in its ``batch_calls``)."""

LAYER = "api/serve.py (MattingService, MicroBatcher)"
UNIT = "images"
MOVES = "latency_p95_ms.serve"


def read(t):
    return t.images_per_call
