"""The system under test, built from a configuration file: the program's
pipeline (and, for the server's cells, the port's ``MattingService``)
holding the benchmark's seeded weights.  This module and
``matbench/programs/*.py`` are the benchmark's only modules that import the
program.

What every architecture shares is here: declaring the model without its
initialisers, drawing and loading the weights, the server, the hand
kernels and their build.  What belongs to one architecture is in
``matbench/programs/<architecture>.py``, named by the configuration's
``architecture`` key (``architecture.py``), which exposes:

* ``declare(conf)``: the model, declared under :func:`_skeleton` (on the
  meta device, initialisers skipped); its parameters are the reference's
  ``param_table`` rows and those of ``program_only_shapes``;
* ``program_only_shapes(model)``: {name: shape} of the parameters that the
  reference's table lacks (SDMatte: the text tower), drawn from a generator
  of their own;
* ``param_dtype(conf)``: the dtype the weights are served in;
* ``CONTROL``: the pipeline keywords that switch on the program's own
  lower-precision path, the control of ``calibrate.py``;
* ``pipeline(model, conf, device, **keywords)``: the pipeline on the loaded
  model, ``keywords`` being the configuration's ``pipeline`` group (every
  key reaches it: an unknown one raises).  It keeps
  ``__call__(image, trimap, options=)``, image (H,W,3) or (B,H,W,3) and
  trimap (H,W) or (B,H,W) in [0, 1], host tensors or arrays, returning
  (alpha (B,H,W), matted (B,H,W,C)), and does its work in the steps
  ``_pre``, ``_heavy`` and ``_post``, each called through the instance, so
  that ``trace.instrument`` can wrap them;
* ``options(mix)``: the per-call options object made from the mix's
  ``options``.
"""

from __future__ import annotations

import contextlib

import torch

from . import architecture, weights


@contextlib.contextmanager
def _skeleton():
    """Modules declared on the meta device without running their
    initialisers (every in-place one of ``torch.nn.init``): the seeded
    weights replace every value, and on the meta device ``normal_`` goes
    through ``torch._refs``, whose first use imports ``torch._dynamo``
    (seconds of set-up for nothing)."""
    names = [n for n in vars(torch.nn.init) if n.endswith("_") and not n.startswith("_")]
    saved = {n: getattr(torch.nn.init, n) for n in names}
    try:
        for n in names:
            setattr(torch.nn.init, n, lambda tensor, *a, **k: tensor)
        with torch.device("meta"):
            yield
    finally:
        for n, f in saved.items():
            setattr(torch.nn.init, n, f)


def build_pipeline(conf: dict, seed: int, device, *, control: bool = False,
                   mark=lambda name: None):
    """The deployment's pipeline on ``device`` with the seed's weights.
    ``control`` switches on the program's own lower-precision path (the
    architecture's ``CONTROL`` keywords) in the configuration's place;
    ``mark(name)`` is called as each step of the build ends."""
    arch = architecture.program_of(conf)
    with _skeleton():
        model = arch.declare(conf)
    mark("model declared")
    params = weights.make_params(conf, seed, device, arch.param_dtype(conf),
                                 extra_shapes=arch.program_only_shapes(model))
    mark("weights made")
    model.load_state_dict(params, strict=True, assign=True)
    del params
    keywords = dict(conf["pipeline"])
    if control:
        keywords.update(arch.CONTROL)
    pipe = arch.pipeline(model, conf, device, **keywords)
    del model
    return pipe


def options(conf: dict, mix: dict):
    """The per-call options of the mix, as the configuration's architecture
    takes them."""
    return architecture.program_of(conf).options(mix)


def service(pipe, mix: dict, warmup):
    """The HTTP server's service object, its batcher warmed by ``warmup`` on
    its own worker thread."""
    from sdmatte_tpu_torch.api.serve import MattingService
    return MattingService(pipe, warmup=warmup, **mix["server"])


def overload_errors():
    from sdmatte_tpu_torch.api.serve import RequestTimeout, ServiceOverloaded
    return (ServiceOverloaded, RequestTimeout)


def graph_captures() -> int:
    """The heavy step's CUDA-graph captures so far in this process (the
    program's counter): a capture inside the window is set-up left undone."""
    from sdmatte_tpu_torch.utils.observability import METRICS
    return int(METRICS.counters.get("heavy.graph_captures", 0))


def hand_kernels() -> dict:
    """{name: Kernel} of the program's hand kernels (``ops/_build.Kernel``)."""
    from sdmatte_tpu_torch.ops import conv3x3, flash_attention  # noqa: F401  (registers them)
    from sdmatte_tpu_torch.ops._build import Kernel
    return {k.name: k for k in Kernel.registry}


def build_kernels() -> None:
    """Compile every stale hand-kernel library at once (nvcc in parallel);
    an up-to-date build directory loads as it is."""
    from sdmatte_tpu_torch.ops._build import build
    build()
