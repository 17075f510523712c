"""Builds the hand kernels in ``csrc/`` at first use and binds them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` beside the package, where
the hash covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is.  Nothing is built when the package is
imported: a :class:`Kernel` compiles its library on its first launch, and
:func:`build` compiles every stale library at once, one ``nvcc`` process per
source, all started together.

Every launch runs inside :func:`forward_only`: no kernel here has a
backward, and a launch writes a fresh tensor, so without that node a
gradient through a kernel would be dropped without a word.

While a thread captures a CUDA graph of the pipeline's heavy step
(pipeline/graphs.py), :data:`CAPTURE` holds that capture's segmenter, and a
launch on that thread cuts the capture there instead of running: the kernel
runs between two graphs at each replay, through :meth:`Kernel.launch`.  A
kernel built with ``cuts=False`` runs on the capturing stream instead, so the
open graph records it, and the segmenter keeps its count for the plan, which
adds it at each replay (:func:`tally` does the same for a counter).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

import torch

from ..utils import observability

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("flash_attention", "conv3x3", "conv3x3_i8", "group_norm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the hand kernels are compiled with the "
                       "CUDA toolkit's nvcc (put it on PATH or set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = SOURCES) -> dict[str, dict]:
    """Compile every stale library in ``names`` in parallel.

    Returns {name: {"seconds": wall time or 0.0 if up to date, "log": nvcc's
    output}}; raises with the compiler's output if any source fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    report = {name: {"seconds": 0.0, "log": ""} for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if stale."""
    with _LOCK:
        if name not in _LIBS:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.sdm_error_string.argtypes = [ctypes.c_int]
            lib.sdm_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


class _Capture(threading.local):
    """Per thread: the segmenter of the graph capture running on it, else None."""
    segmenter = None


CAPTURE = _Capture()


def tally(name: str) -> None:
    """Count ``name`` in ``observability.METRICS`` once: now, or inside a
    graph capture on this thread at each replay of its plan (a replay runs
    no Python)."""
    seg = CAPTURE.segmenter
    if seg is None:
        observability.METRICS.count(name)
    else:
        seg.hold(name)


class Kernel:
    """One hand kernel: where it lives, what it replaces, and its launch count.

    ``launches`` is a plain integer that :meth:`count` raises by one per
    successful launch and nothing else touches, so a caller can zero it,
    drive a code path, and read how often the path reached the kernel; a
    kernel with a ``counter`` also counts it in ``observability.METRICS``.
    ``cuts`` says what a graph capture does with a launch (:meth:`launch`).
    Every kernel joins ``Kernel.registry`` when its module is imported."""

    registry: list["Kernel"] = []

    def __init__(self, name: str, library: str, symbol: str, argtypes: list,
                 replaces: str, *, cuts: bool = True, counter: str | None = None):
        self.name = name
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.cuts = cuts
        self.counter = counter
        self.source = f"sdmatte_tpu_torch/csrc/{library}.cu"
        self.launches = 0
        self._fn = None
        Kernel.registry.append(self)

    def launch(self, *args) -> None:
        """Run the kernel on the stream of the last argument.  Inside a graph
        capture on this thread a kernel that cuts is handed to the capture's
        plan instead (neither run nor counted until the plan replays it);
        one built with ``cuts=False`` runs on the capturing stream, where the
        open graph records it, and is counted at each replay of the plan.
        Its library is loaded at its first launch, which for a captured
        step is the key's eager first call."""
        seg = CAPTURE.segmenter
        if seg is not None and self.cuts:
            seg.cut(self, args)
            return
        if self._fn is None:
            lib = load(self.library)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        err = self._fn(*args)
        if err != 0:
            msg = self._lib.sdm_error_string(err).decode()
            raise RuntimeError(f"{self.name}: launch failed with CUDA error "
                               f"{err} ({msg})")
        if seg is None:
            self.count(1)
        else:
            seg.hold(self)

    def count(self, n: int) -> None:
        self.launches += n
        if self.counter is not None:
            observability.METRICS.count(self.counter, n)


class _ForwardOnly(torch.autograd.Function):
    """A launch as an autograd node whose backward raises."""

    @staticmethod
    def forward(ctx, name, launch, *tensors):
        ctx.name = name
        return launch(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            f"{ctx.name} has no backward kernel: the port, like the JAX package, "
            f"differentiates only the plain versions, so training runs inside "
            f"ops.dispatch.implementation(\"plain\")")


def forward_only(name: str, launch: Callable, *tensors):
    """``launch(*tensors)`` (None allowed among them), recorded so that a
    backward through its output raises a RuntimeError naming kernel ``name``."""
    return _ForwardOnly.apply(name, launch, *tensors)


def stream_handle(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's data pointer, or NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())
