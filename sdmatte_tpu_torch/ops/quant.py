"""Int8 weights and the int8 VAE convs (sdmatte_tpu/ops/quant.py).

Two modes, as in the JAX package, both symmetric and zero-point-free:

* **int8 compute** (``vae_int8``): :func:`quantize_vae_tree` gives every 3x3
  conv of the VAE an int8 copy of its weight (``weight_q``, OIHW int8 in
  ``channels_last``) and a per-output-channel fp32 scale (``weight_scale``)
  beside the fp ``weight``; :func:`conv2d_int8` quantizes the activation per
  tensor on the device and runs the int8 conv (K4 on the card), dequantizing
  by ``s_x * w_scale`` in fp32.  1x1 convs and norms stay fp.
* **int8 storage** (``weight_storage="int8"``): :func:`compress_tree_int8`
  replaces every conv or linear weight of at least ``STORAGE_MIN_ELEMS``
  elements by ``weight_i8`` (int8) and ``weight_s`` (fp32 per output
  channel); ``core/nn.kernel_of`` dequantizes it at its use, so the products
  stay in the policy's dtype.  Layers that carry the compute fields are left
  alone, so compute quantization runs first and the two compose.

Weight scales are amax/127 per output channel (1.0 where amax is 0); values
are divided by the scale, rounded half to even and clipped to +-127.  Both
mutating forms (``*_``) and the JAX package's non-mutating forms are here;
the latter deep-copy, so the source model is never changed.  Scales stay
fp32 under any policy: :data:`SCALE_NAMES` lists the buffers that
``pipeline/matting`` keeps out of the parameter cast.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from .conv3x3 import conv3x3_int8

STORAGE_MIN_ELEMS = 1 << 16
SCALE_NAMES = ("weight_scale", "weight_s")


def _channel_scale(wf: torch.Tensor) -> torch.Tensor:
    """fp32 weight with output channels first -> (Cout,) amax/127 scales."""
    amax = wf.abs().amax(dim=tuple(range(1, wf.ndim)))
    return torch.where(amax == 0, torch.ones_like(amax), amax / torch.full_like(amax, 127.0))


def _quantize(wf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    s = scale.reshape(-1, *([1] * (wf.ndim - 1)))
    return torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)


def compress_kernel_int8(w: torch.Tensor):
    """A conv (OIHW) or linear (out, in) weight -> (int8 weight, fp32
    per-output-channel scale)."""
    wf = w.detach().float()
    scale = _channel_scale(wf)
    return _quantize(wf, scale), scale


def quantize_weights_int8(w: torch.Tensor):
    """An OIHW conv weight -> (int8 weight, fp32 per-output-channel scale);
    the same scheme as :func:`compress_kernel_int8`."""
    return compress_kernel_int8(w)


def quantize_act_int8(x: torch.Tensor):
    """Dynamic per-tensor quantization -> (int8 x in x's layout, fp32 scale
    as a 0-dim tensor on x's device).  Nothing is read back to the host; the
    division is a true one in fp32 (the scale as a 1-element tensor
    promotes a bf16 x to fp32 without a copy; a host scalar divisor would
    become a multiply by its reciprocal in PyTorch's CUDA kernels).  The
    JAX package's clip to +-127 is left out because it cannot act: |x| <=
    amax, so |x| / fl(amax / 127) <= 127 * (1 + 2^-23) rounds to at most
    127."""
    amax = torch.linalg.vector_norm(x, float("inf"), dtype=torch.float32)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / torch.full_like(amax, 127.0))
    q = torch.div(x, scale.reshape(1)).round_()
    return q.to(torch.int8), scale


def conv2d_int8(x, wq, w_scale, bias=None, *, stride: int = 1, padding=1,
                out_dtype=torch.bfloat16):
    """Dynamic activation quantization -> int8 3x3 conv -> fp32 dequant by
    ``s_x * w_scale`` (+ bias), written as out_dtype."""
    xq, s_x = quantize_act_int8(x)
    scale_vec = s_x * w_scale.float()
    xq = xq.contiguous(memory_format=torch.channels_last)
    return conv3x3_int8(xq, wq, scale_vec, bias, stride=stride, padding=padding,
                        out_dtype=out_dtype)


def _set_buffer(m: nn.Module, name: str, t: torch.Tensor) -> None:
    if t.ndim == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    m.register_buffer(name, t)


def quantize_conv_params_(m: nn.Conv2d) -> nn.Conv2d:
    """Give one conv its int8 compute fields, beside its fp weight."""
    wq, scale = quantize_weights_int8(m.weight)
    _set_buffer(m, "weight_q", wq)
    _set_buffer(m, "weight_scale", scale)
    return m


def is_int8_conv(m: nn.Module) -> bool:
    return "weight_q" in m._buffers


def quantize_vae_tree_(vae: nn.Module) -> nn.Module:
    """Give every 3x3 conv under ``vae`` int8 compute fields, in place.
    Convs that already carry them (a quantized tree carried across) keep
    theirs."""
    for m in vae.modules():
        if isinstance(m, nn.Conv2d) and tuple(m.kernel_size) == (3, 3) \
                and not is_int8_conv(m):
            quantize_conv_params_(m)
    return vae


def quantize_vae_tree(vae: nn.Module) -> nn.Module:
    """:func:`quantize_vae_tree_` on a copy; ``vae`` is left as it is."""
    return quantize_vae_tree_(copy.deepcopy(vae))


def compress_tree_int8_(model: nn.Module, *, min_elems: int | None = None) -> nn.Module:
    """Replace every conv or linear weight of at least ``min_elems``
    (default :data:`STORAGE_MIN_ELEMS`) elements by int8 storage, in place.
    Layers with int8 compute fields, or already compressed, are skipped."""
    min_elems = STORAGE_MIN_ELEMS if min_elems is None else min_elems
    for m in model.modules():
        if not isinstance(m, (nn.Conv2d, nn.Linear)) or is_int8_conv(m) \
                or "weight" not in m._parameters:
            continue
        if m.weight.numel() < min_elems:
            continue
        wq, scale = compress_kernel_int8(m.weight)
        del m.weight
        _set_buffer(m, "weight_i8", wq)
        _set_buffer(m, "weight_s", scale)
    return model


def compress_tree_int8(model: nn.Module, *, min_elems: int | None = None) -> nn.Module:
    """:func:`compress_tree_int8_` on a copy; ``model`` is left as it is."""
    return compress_tree_int8_(copy.deepcopy(model), min_elems=min_elems)


def stage_(model: nn.Module, *, device, dtype: torch.dtype) -> nn.Module:
    """``model.to(device, dtype, channels_last)`` in place, with the int8
    scales (:data:`SCALE_NAMES`) kept in fp32: a scale in bf16 would add a
    second rounding on top of the int8 one (sdmatte_tpu/pipeline/matting.py
    ``_stage``).  int8 buffers keep their dtype under ``Module.to``."""
    scales = [(m, n, b) for m in model.modules()
              for n, b in m.named_buffers(recurse=False) if n in SCALE_NAMES]
    model.to(device=device, dtype=dtype, memory_format=torch.channels_last)
    for m, n, b in scales:
        m.register_buffer(n, b.to(device=device, dtype=torch.float32))
    return model
