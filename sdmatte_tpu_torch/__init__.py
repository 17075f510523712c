"""sdmatte_tpu_torch: the PyTorch/CUDA port of sdmatte_tpu for the NVIDIA H100.

Module names follow the JAX package (``sdmatte_tpu``), which stays the
reference; the port imports nothing from it.  The TPU's Pallas kernels are
hand-written CUDA C++ for Hopper under ``csrc/``, compiled by ``nvcc`` at
their first launch (``ops/_build.py``); importing the package builds nothing.
Entry points run on the card unless the caller asks for the CPU, where each
kernel site runs its plain PyTorch version.
"""

__version__ = "0.1.0"
