"""Mixed-precision policy, as in the JAX package (sdmatte_tpu/core/dtypes.py).

BF16 stores parameters and feeds matmuls and convs in bf16; the products
accumulate in fp32 (cuBLAS, cuDNN and the hand kernels all accumulate bf16
products in fp32), and normalisation statistics and softmax run in fp32.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x if x.dtype == self.compute_dtype else x.to(self.compute_dtype)


FP32 = Policy(torch.float32, torch.float32, torch.float32)
BF16 = Policy(torch.bfloat16, torch.bfloat16, torch.float32)

