"""The benchmark of the PyTorch and CUDA port (``sdmatte_tpu_torch``): see
``matbench/README.md``."""
