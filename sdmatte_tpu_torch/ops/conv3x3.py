"""3x3 stride-1 conv with an optional GroupNorm-affine + SiLU prologue and an
optional residual epilogue: the hand kernel and its plain version.

  K3  csrc/conv3x3.cu, an implicit-GEMM conv on NHWC memory; replaces
      sdmatte_tpu/ops/conv3x3.py::_kernel_v5 and covers ::_kernel (the
      padded-halo variant), since it masks its own ragged edges.

It is bound by operations on the H100; the source note says what the design
does about it.  :func:`conv3x3` takes the plain version for a CPU tensor and
launches the kernel for a CUDA tensor, or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as tF

from ._build import Kernel, ptr, stream_handle

K3 = Kernel("conv3x3", "conv3x3", "sdm_conv3x3",
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [ctypes.c_void_p],
            replaces="sdmatte_tpu/ops/conv3x3.py:56 (_kernel_v5), "
                     ":182 (_kernel)")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# input channels per chunk of the kernel (ConvShape<T>::BKC in the source;
# Cin must be a multiple of it)
CIN_MULTIPLE = {torch.float32: 16, torch.bfloat16: 32}


def conv3x3_plain(x, w, b=None, *, affine=None, residual=None):
    """The plain version: silu(x * a + d) in fp32, cast to x's dtype, then the
    conv in fp32 with the bias and residual added in fp32 and one rounding to
    x's dtype at the end (the kernel's arithmetic, unfused).

    x (B,Cin,H,W), w (Cout,Cin,3,3), b (Cout,) or None, affine ((B,Cin),
    (B,Cin)) fp32 or None, residual (B,Cout,H,W) or None."""
    if affine is not None:
        a, d = affine
        x = tF.silu(x.float() * a[:, :, None, None] + d[:, :, None, None]).to(x.dtype)
    y = tF.conv2d(x.float(), w.float(), None if b is None else b.float(), padding=1)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def conv3x3(x, w, b=None, *, affine=None, residual=None):
    """Same contract as :func:`conv3x3_plain`.  On the card x and residual
    must be in ``torch.channels_last`` (NHWC memory) and the output is too;
    the weight is read as (Cout, 3, 3, Cin), which is free for a
    channels_last weight and one small copy otherwise."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, affine=affine, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"conv3x3: no kernel for x {x.dtype}, w {w.dtype}")
    bsz, cin, h, wd = x.shape
    cout = w.shape[0]
    if w.shape != (cout, cin, 3, 3) or w.device != x.device:
        raise ValueError(f"conv3x3: weight {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if cin % CIN_MULTIPLE[x.dtype]:
        raise ValueError(f"conv3x3: Cin={cin} must be a multiple of "
                         f"{CIN_MULTIPLE[x.dtype]} for {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv3x3: x must be channels_last")
    if residual is not None and (
            residual.shape != (bsz, cout, h, wd) or residual.dtype != x.dtype
            or not residual.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("conv3x3: residual must match the output's shape, "
                         "dtype and channels_last layout")
    a = d = None
    if affine is not None:
        a, d = affine
        for t in (a, d):
            if t.shape != (bsz, cin) or t.dtype != torch.float32 \
                    or not t.is_contiguous() or t.device != x.device:
                raise ValueError("conv3x3: affine must be two contiguous "
                                 "(B, Cin) fp32 tensors")
    w_nhwc = w.permute(0, 2, 3, 1).contiguous()
    bias = None if b is None else b.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty((bsz, cout, h, wd), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    K3.launch(_DTYPES[x.dtype], ptr(x), ptr(w_nhwc), ptr(bias), ptr(a), ptr(d),
              ptr(residual), ptr(y), bsz, h, wd, cin, cout,
              stream_handle(x.device))
    return y
