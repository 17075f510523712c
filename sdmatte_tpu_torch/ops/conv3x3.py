"""3x3 convs: the hand kernels and their plain versions.

  K3  csrc/conv3x3.cu, an implicit-GEMM bf16/fp32 conv (stride 1) on NHWC
      memory with an optional GroupNorm-affine + SiLU prologue and residual
      epilogue; replaces sdmatte_tpu/ops/conv3x3.py::_kernel_v5 and covers
      ::_kernel (the padded-halo variant), since it masks its own ragged
      edges.  :func:`conv3x3_csplit` is the channel-split wrapper over it.
  K4  csrc/conv3x3_i8.cu, the int8 x int8 -> int32 conv with the fp32
      dequantizing epilogue; replaces ::_kernel_i8 and also takes the
      stride-2 and ragged-channel int8 convs of the int8 VAE.  Stride 1 runs
      on wgmma (s8) fed by TMA, with the nine taps folded into K for Cin 3 and 4;
      stride 2 and other channel counts stay on the first design
      (:func:`int8_route` says which kernel takes a conv).

Both are bound by operations on the H100; the source notes say what the
designs do about it.  :func:`conv3x3` and :func:`conv3x3_int8` take the plain
version where ``ops/dispatch.plain_here`` says so and launch the kernel for a
CUDA tensor, or raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as tF

from ._build import Kernel, forward_only, ptr, stream_handle
from .dispatch import plain_here

K3 = Kernel("conv3x3", "conv3x3", "sdm_conv3x3",
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [ctypes.c_void_p],
            replaces="sdmatte_tpu/ops/conv3x3.py:56 (_kernel_v5), "
                     ":182 (_kernel)")

K4 = Kernel("conv3x3_int8", "conv3x3_i8", "sdm_conv3x3_i8",
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
            + [ctypes.c_void_p],
            replaces="sdmatte_tpu/ops/conv3x3.py:336 (_kernel_i8)")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K4's kernels, by the code sdm_conv3x3_i8_route returns
INT8_ROUTES = ("conv3x3_i8_kernel (first design)", "conv3x3_i8_sm90<128>",
               "conv3x3_i8_sm90<8>", "conv3x3_i8_fold")
# input channels per chunk of the kernel (h90::BKC for bf16 and
# ConvShape<float>::BKC for fp32 in the source; Cin must be a multiple of it)
CIN_MULTIPLE = {torch.float32: 16, torch.bfloat16: 64}


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


def _aligned16(t):
    """t, or a copy of it in the same memory format when its data does not
    start on a 16-byte boundary (a view at an odd offset)."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.preserve_format)


def conv3x3(x, w, b=None, *, affine=None, residual=None):
    """Same contract as :func:`conv3x3_plain`.  On the card x and residual
    must be in ``torch.channels_last`` (NHWC memory) and the output is too;
    the weight is read as (Cout, 3, 3, Cin), which is free for a
    channels_last weight and one small copy otherwise."""
    if plain_here(x):
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
    return forward_only(K3.name, _launch_k3, x, w, b, a, d, residual)


def _launch_k3(x, w, b, a, d, residual):
    bsz, cin, h, wd = x.shape
    cout = w.shape[0]
    w_nhwc = w.permute(0, 2, 3, 1).contiguous()
    bias = None if b is None else b.to(device=x.device, dtype=torch.float32).contiguous()
    # the bf16 kernel reads x and w by TMA and bias and residual in 16-byte
    # vectors, all from their base addresses
    x, bias, residual = (_aligned16(t) for t in (x, bias, residual))
    y = torch.empty((bsz, cout, h, wd), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    K3.launch(_DTYPES[x.dtype], ptr(x), ptr(w_nhwc), ptr(bias), ptr(a), ptr(d),
              ptr(residual), ptr(y), bsz, h, wd, cin, cout,
              stream_handle(x.device))
    return y


def conv3x3_csplit(x, w, b=None, *, affine=None, residual=None,
                   fuse_sum: bool = False):
    """:func:`conv3x3` as two half-input-channel passes summed
    (sdmatte_tpu/ops/conv3x3.py::conv3x3_same_csplit): conv(x, w) =
    conv(x_lo, w_lo) + conv(x_hi, w_hi), each half applying its slice of
    the GroupNorm affine.  ``fuse_sum`` rides the cross-pass add and the
    residual on the second pass's residual epilogue; otherwise the adds run
    outside.  No dispatch entry takes it, as in the JAX package."""
    cl = torch.channels_last
    ch = x.shape[1] // 2
    x_lo = x[:, :ch].contiguous(memory_format=cl)
    x_hi = x[:, ch:].contiguous(memory_format=cl)
    w_lo, w_hi = w[:, :ch], w[:, ch:]
    a_lo = a_hi = None
    if affine is not None:
        a, d = affine
        a_lo = (a[:, :ch].contiguous(), d[:, :ch].contiguous())
        a_hi = (a[:, ch:].contiguous(), d[:, ch:].contiguous())
    if fuse_sum:
        half1 = conv3x3(x_lo, w_lo, None, affine=a_lo, residual=residual)
        return conv3x3(x_hi, w_hi, b, affine=a_hi, residual=half1)
    half1 = conv3x3(x_lo, w_lo, None, affine=a_lo)
    half2 = conv3x3(x_hi, w_hi, b, affine=a_hi)
    out = half1 + half2
    return out if residual is None else out + residual.to(out.dtype)


# ------------------------------------------------------------------ int8 ---

def pads_of(padding):
    """An int or ((top, bottom), (left, right)) -> the explicit pair."""
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return (tuple(padding[0]), tuple(padding[1]))


def _out_size(n: int, lo: int, hi: int, stride: int) -> int:
    return (n + lo + hi - 3) // stride + 1


def conv3x3_int8_plain(xq, wq, scale_vec, b=None, *, stride: int = 1, padding=1,
                       out_dtype=torch.bfloat16):
    """The plain version: the integer conv computed exactly, then
    ``float(acc) * scale_vec (+ b)`` in fp32 and one rounding to out_dtype.

    xq (B,Cin,H,W) int8, wq (Cout,Cin,3,3) int8, scale_vec (Cout,) fp32 =
    s_x * w_scale, b (Cout,) or None.  The nine taps are fp64 matrix
    products over shifted views: every partial sum is an integer below 2^53,
    so they are exact in any order, and the fp64 -> fp32 conversion rounds
    as JAX's int32 -> fp32 does."""
    (pt, pb), (pl, pr) = pads_of(padding)
    bsz, _, h, w = xq.shape
    ho, wo = _out_size(h, pt, pb, stride), _out_size(w, pl, pr, stride)
    xp = tF.pad(xq.permute(0, 2, 3, 1).double(), (0, 0, pl, pr, pt, pb))
    w64 = wq.double()
    acc = None
    for dy in range(3):
        for dx in range(3):
            xs = xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                    dx:dx + stride * (wo - 1) + 1:stride]
            t = xs @ w64[:, :, dy, dx].t()
            acc = t if acc is None else acc.add_(t)
    y = acc.float() * scale_vec.float()
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype).permute(0, 3, 1, 2)


def int8_route(cin: int, cout: int, stride: int) -> str:
    """The kernel of csrc/conv3x3_i8.cu that :func:`conv3x3_int8` reaches on
    the card for a conv of these sizes (asked of the built library)."""
    from ._build import load
    fn = load(K4.library).sdm_conv3x3_i8_route
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return INT8_ROUTES[fn(cin, cout, stride)]


def conv3x3_int8(xq, wq, scale_vec, b=None, *, stride: int = 1, padding=1,
                 out_dtype=torch.bfloat16):
    """Same contract as :func:`conv3x3_int8_plain` (that of
    sdmatte_tpu/ops/conv3x3.py::conv3x3_same_int8, widened to stride 2 and
    any padding of 0-2 a side).  On the card xq must be in
    ``torch.channels_last`` and the output is too; the weight is read as
    (Cout, 3, 3, Cin), which is free for a channels_last weight."""
    if plain_here(xq):
        return conv3x3_int8_plain(xq, wq, scale_vec, b, stride=stride,
                                  padding=padding, out_dtype=out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"conv3x3_int8: no kernel for device {xq.device}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or out_dtype not in _DTYPES:
        raise ValueError(f"conv3x3_int8: no kernel for x {xq.dtype}, w {wq.dtype} "
                         f"-> {out_dtype}")
    bsz, cin, h, w = xq.shape
    cout = wq.shape[0]
    if wq.shape != (cout, cin, 3, 3) or wq.device != xq.device:
        raise ValueError(f"conv3x3_int8: weight {tuple(wq.shape)} does not fit x "
                         f"{tuple(xq.shape)}")
    if scale_vec.shape != (cout,) or scale_vec.dtype != torch.float32 \
            or not scale_vec.is_contiguous() or scale_vec.device != xq.device:
        raise ValueError("conv3x3_int8: scale_vec must be a contiguous (Cout,) "
                         "fp32 tensor on x's device")
    (pt, pb), (pl, pr) = pads_of(padding)
    if stride not in (1, 2) or not all(0 <= q <= 2 for q in (pt, pb, pl, pr)):
        raise ValueError(f"conv3x3_int8: no kernel for stride {stride}, "
                         f"padding {padding}")
    if not xq.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv3x3_int8: x must be channels_last")
    return forward_only(K4.name, lambda xq, wq, scale_vec, b: _launch_k4(
        xq, wq, scale_vec, b, stride, (pt, pb, pl, pr), out_dtype), xq, wq, scale_vec, b)


def _launch_k4(xq, wq, scale_vec, b, stride, pads, out_dtype):
    pt, pb, pl, pr = pads
    bsz, cin, h, w = xq.shape
    cout = wq.shape[0]
    ho, wo = _out_size(h, pt, pb, stride), _out_size(w, pl, pr, stride)
    # the wgmma kernels read x and w by TMA from 16-byte aligned bases
    xq, w_nhwc = _aligned16(xq), _aligned16(wq.permute(0, 2, 3, 1).contiguous())
    bias = None if b is None else b.to(device=xq.device, dtype=torch.float32).contiguous()
    y = torch.empty((bsz, cout, ho, wo), dtype=out_dtype, device=xq.device,
                    memory_format=torch.channels_last)
    K4.launch(_DTYPES[out_dtype], ptr(xq), ptr(w_nhwc), ptr(scale_vec), ptr(bias),
              ptr(y), bsz, h, w, cin, cout, ho, wo, stride, pt, pl,
              stream_handle(xq.device))
    return y
