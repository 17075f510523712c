"""Layer functions of the port (sdmatte_tpu/core/nn.py).

Each function takes the layer's ``nn.Module`` (whose parameters carry the
checkpoint's names and torch layouts: OIHW convs, (out, in) linears) the way
the JAX functions take a param dict, and a ``Policy``.  Activations are
NCHW tensors; on the card the model keeps them in ``torch.channels_last``,
which is the NHWC memory order the 3x3 conv kernel reads.

The hand-kernel sites call the kernels' entry points, which choose between
a kernel and its plain version themselves (``ops/dispatch.plain_here``).

Weights are read through :func:`kernel_of`, which dequantizes int8 storage
(``weight_i8`` + ``weight_s``, ops/quant.compress_tree_int8) at its use; a
conv with int8 compute fields (``weight_q``, ops/quant.quantize_vae_tree)
takes the int8 conv before the dispatch table is consulted.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tF
from torch import nn

from .dtypes import FP32, Policy


def _bias(p: nn.Module, dtype: torch.dtype):
    return None if p.bias is None else p.bias.to(dtype)


def kernel_of(p: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """The layer's weight in ``dtype``; int8 storage is dequantized here, as
    ``w_i8.float() * w_s`` in fp32 per output channel, so the fp form is a
    temporary of this use while the resident copy stays int8."""
    if "weight_i8" in p._buffers:
        w = p.weight_i8
        return (w.float() * p.weight_s.reshape(-1, *([1] * (w.ndim - 1)))).to(dtype)
    return p.weight.to(dtype)


def weight_shape(p: nn.Module) -> torch.Size:
    """The weight's shape, read from the int8 storage where it replaced it."""
    return p.weight_i8.shape if "weight_i8" in p._buffers else p.weight.shape


def linear(p: nn.Linear, x: torch.Tensor, policy: Policy = FP32) -> torch.Tensor:
    cd = policy.compute_dtype
    return tF.linear(policy.cast_compute(x), kernel_of(p, cd), _bias(p, cd))


def conv2d(p: nn.Conv2d, x: torch.Tensor, *, stride: int = 1, padding=1,
           policy: Policy = FP32) -> torch.Tensor:
    """3x3/1x1 conv.  ``padding`` is an int or ((top, bottom), (left, right));
    the VAE encoder's downsample pads (0, 1), (0, 1).  A conv with int8
    compute fields takes the int8 conv (ops/quant.conv2d_int8, K4 on the
    card); the 3x3 stride-1 shapes of the dispatch table (ops/dispatch.py)
    take the 3x3 conv kernel; every other conv is
    ``torch.nn.functional.conv2d``."""
    cd = policy.compute_dtype
    if "weight_q" in p._buffers:
        from ..ops.quant import conv2d_int8
        return conv2d_int8(x, p.weight_q, p.weight_scale, p.bias, stride=stride,
                           padding=padding, out_dtype=cd)
    from ..ops.conv3x3 import pads_of
    shape = weight_shape(p)
    pad = pads_of(padding)
    if shape[2:] == (3, 3) and stride == 1 and pad == ((1, 1), (1, 1)):
        from ..ops.dispatch import conv3x3_route
        b, _, h, wd = x.shape
        if conv3x3_route(b, h, wd, shape[1], shape[0], compute_dtype=cd):
            return _conv3x3(p, x, policy=policy)
    x = policy.cast_compute(x)
    w = kernel_of(p, cd)
    if pad[0][0] == pad[0][1] and pad[1][0] == pad[1][1]:
        return tF.conv2d(x, w, _bias(p, cd), stride=stride,
                         padding=(pad[0][0], pad[1][0]))
    x = tF.pad(x, (pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
    return tF.conv2d(x, w, _bias(p, cd), stride=stride)


def conv2d_affine(p: nn.Conv2d, x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                  stride: int = 1, padding: int = 1, policy: Policy = FP32) -> torch.Tensor:
    """conv(x) * scale + shift per output channel (an inference BatchNorm
    after the conv), folded into the conv's weight and bias in fp32 before
    their cast to the compute dtype: one conv and no pass over its output."""
    cd = policy.compute_dtype
    w = kernel_of(p, torch.float32) * scale.reshape(-1, 1, 1, 1)
    b = shift if p.bias is None else shift + p.bias.float() * scale
    return tF.conv2d(policy.cast_compute(x), w.to(cd), b.to(cd), stride=stride, padding=padding)


def _conv3x3(p: nn.Conv2d, x, *, policy: Policy, affine=None, residual=None):
    from ..ops.conv3x3 import conv3x3
    cd = policy.compute_dtype
    res = None if residual is None else policy.cast_compute(residual)
    return conv3x3(policy.cast_compute(x), kernel_of(p, cd), p.bias, affine=affine, residual=res)


def upsample2x_conv(p: nn.Conv2d, x: torch.Tensor, *, policy: Policy = FP32) -> torch.Tensor:
    """diffusers ``Upsample2D``: nearest x2, then the 3x3 conv (the JAX
    package's default ``base`` form)."""
    u = tF.interpolate(x, scale_factor=2.0, mode="nearest")
    return conv2d(p, u, policy=policy)


def group_norm_stats(p: nn.GroupNorm, x: torch.Tensor):
    """Per-(batch, channel) fp32 (a, d) with GroupNorm(x) = x * a + d, the
    pair the 3x3 conv kernel's prologue takes (ops/group_norm.py: a hand
    kernel on the card, fp32 E[x^2] - E[x]^2 statistics as the JAX
    package's)."""
    from ..ops.group_norm import group_norm_stats as stats
    return stats(p, x)


def group_norm(p: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm with fp32 statistics and an fp32 apply, written in the
    input's dtype by one pass."""
    from ..ops.group_norm import group_norm_apply
    a, d = group_norm_stats(p, x)
    return group_norm_apply(x, a, d, silu=False)


def gn_silu(p: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """silu(GroupNorm(x)): on the card the SiLU rides the apply's one pass."""
    from ..ops.group_norm import group_norm_apply
    a, d = group_norm_stats(p, x)
    return group_norm_apply(x, a, d, silu=True)


def gn_silu_conv2d(p_norm: nn.GroupNorm, p_conv: nn.Conv2d, x: torch.Tensor, *,
                   policy: Policy = FP32, residual=None) -> torch.Tensor:
    """conv(silu(GroupNorm(x))) [+ residual], the resnet pattern.  Where the
    dispatch table says so, the norm's apply pass and the SiLU ride the 3x3
    conv kernel's prologue and the residual its epilogue; elsewhere the
    unfused composition runs (the same math); so does a conv with int8
    compute fields, whose conv2d takes the int8 conv."""
    shape = weight_shape(p_conv)
    if shape[2:] == (3, 3) and "weight_q" not in p_conv._buffers:
        from ..ops.dispatch import conv3x3_route
        b, _, h, wd = x.shape
        route = conv3x3_route(b, h, wd, shape[1], shape[0],
                              compute_dtype=policy.compute_dtype)
        if route is not None and route.fuse_gn:
            affine = group_norm_stats(p_norm, x)
            res = residual if route.fuse_residual else None
            y = _conv3x3(p_conv, x, policy=policy, affine=affine, residual=res)
            if residual is not None and res is None:
                y = y + residual.to(y.dtype)
            return y
    y = conv2d(p_conv, gn_silu(p_norm, x), policy=policy)
    return y if residual is None else y + residual.to(y.dtype)


def layer_norm(p: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with fp32 statistics; output in the input's dtype."""
    y = tF.layer_norm(x.float(), p.normalized_shape, p.weight.float(),
                      p.bias.float(), p.eps)
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return tF.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return tF.gelu(x)   # exact (erf)


def geglu(p: nn.Linear, x: torch.Tensor, policy: Policy = FP32) -> torch.Tensor:
    """diffusers GEGLU: one projection to 2*d_ff, the second half gates."""
    a, g = linear(p, x, policy).chunk(2, dim=-1)
    return a * gelu(g)
