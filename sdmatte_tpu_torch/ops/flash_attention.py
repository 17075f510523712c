"""Flash attention with an additive per-key bias: the hand kernels and their
plain version.

  K1  csrc/flash_attention.cu, d <= 128 (the U-Net's d=64 self- and
      cross-attention); replaces sdmatte_tpu/ops/flash_attention.py
      ::_kernel_fused_l and ::_kernel_d64_v2.
  K2  d = 512 (the VAE mid-block's single head); replaces ::_kernel.  In
      bf16 a wgmma/TMA kernel of its own (d split over two warpgroups), in
      fp32 the first design's template.

Both are bound by operations on the H100; the source note says what the
design does about it.  :func:`flash_attention` takes the plain version for a
CPU tensor and launches a kernel for a CUDA tensor, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, forward_only, ptr, stream_handle

_ARGS = [ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_void_p]

K1 = Kernel("flash_attention_k1", "flash_attention", "sdm_flash_attention_k1",
            _ARGS, replaces="sdmatte_tpu/ops/flash_attention.py:78 "
                            "(_kernel_fused_l), :119 (_kernel_d64_v2)")
K2 = Kernel("flash_attention_k2", "flash_attention", "sdm_flash_attention_k2",
            _ARGS, replaces="sdmatte_tpu/ops/flash_attention.py:41 (_kernel)")

K1_HEAD_DIMS = (64, 128)
K2_HEAD_DIMS = (512,)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q, k, v, *, scale: float, bias=None):
    """The plain version (sdmatte_tpu/ops/attention.py::attention_xla): fp32
    scores and softmax, P cast to V's dtype before the PV product, which
    accumulates in fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(v.dtype)


def _check(name, t, dtype, device):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"flash_attention: {name} is {t.dtype} on {t.device}, "
                         f"expected {dtype} on {device}")
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} needs a contiguous last dim")
    step = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % step for s in t.stride()[:-1]):
        raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned")


def flash_attention(q, k, v, *, scale: float, bias=None):
    """q (B,H,Lq,D), k and v (B,H,Lk,D), bias (B,Lk) fp32 or None ->
    (B,H,Lq,D) in q's dtype.

    Any (batch, head, row) strides are taken as they are; the output of a
    kernel is a (B,H,Lq,D) view of a (B,Lq,H,D) tensor, so the caller's
    merge of the heads is free."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale, bias=bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != (b, h, lk, d):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: no kernel for {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, q.device)
    if bias is not None:
        if bias.shape != (b, lk) or bias.dtype != torch.float32 \
                or bias.device != q.device or bias.stride(1) != 1:
            raise ValueError("flash_attention: bias must be a (B, Lk) fp32 "
                             "tensor with a contiguous last dim on q's device")
    if d in K1_HEAD_DIMS:
        kernel = K1
    elif d in K2_HEAD_DIMS:
        kernel = K2
    else:
        raise ValueError(f"flash_attention: no kernel for head dim {d}")
    return forward_only(kernel.name, lambda q, k, v, bias: _launch(kernel, q, k, v, bias, scale),
                        q, k, v, bias)


def _launch(kernel, q, k, v, bias, scale):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)

    def strides(t):
        return (ctypes.c_longlong * 3)(*t.stride()[:3])

    kernel.launch(_DTYPES[q.dtype], d, ptr(q), ptr(k), ptr(v), ptr(bias),
                  ptr(out), strides(q), strides(k), strides(v), strides(out),
                  0 if bias is None else bias.stride(0), b, h, lq, lk,
                  float(scale), stream_handle(q.device))
    return out
