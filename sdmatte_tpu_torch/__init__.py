"""sdmatte_tpu_torch: the PyTorch/CUDA port of sdmatte_tpu for the NVIDIA H100.

Module names follow the JAX package (``sdmatte_tpu``), which stays the
reference; the port imports nothing from it.  The TPU's Pallas kernels are
hand-written CUDA C++ for Hopper under ``csrc/``, compiled by ``nvcc`` at
their first launch (``ops/_build.py``); importing the package builds nothing.
Entry points run on the card unless the caller asks for the CPU, where each
kernel site runs its plain PyTorch version.

The package directory is also a ComfyUI custom node: put it (or a link to
it) into ``custom_nodes/`` and the host's loader, which imports it under a
name of its own choosing and reads ``NODE_CLASS_MAPPINGS``, registers the
port's ``SDMatteApply``.  Every import inside the package is relative, so
any module name works.
"""

__version__ = "0.1.0"

_NODE_NAMES = ("NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS")


def __getattr__(name):
    """The node mappings, imported from ``api.node`` on first access, so that
    importing the package alone still loads no model code (PEP 562)."""
    if name in _NODE_NAMES:
        from .api import node
        return getattr(node, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
