"""Flash attention with an additive per-key bias, or with decomposed
relative-position terms: the hand kernels and their plain version.

  K1  csrc/flash_attention.cu, d <= 128 (the U-Net's d=64 self- and
      cross-attention); replaces sdmatte_tpu/ops/flash_attention.py
      ::_kernel_fused_l and ::_kernel_d64_v2.  Its relative-position mode
      (``rel``, bf16 at d = 64: ViTMatte's blocks) replaces no TPU kernel:
      the JAX package has no such model, and at a 12 MP photo the bias it
      adds per (query, key) would take 110 GB a block if it were formed.
  K2  d = 512 (the VAE mid-block's single head); replaces ::_kernel.  In
      bf16 a wgmma/TMA kernel of its own (d split over two warpgroups), in
      fp32 the first design's template.

Both are bound by operations on the H100; the source note says what the
design does about it.  :func:`flash_attention`, every attention site's entry
point, takes the plain version where ``ops/dispatch.plain_here`` says so and
launches a kernel for a CUDA tensor, or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils import observability
from ._build import CAPTURE, Kernel, forward_only, ptr, stream_handle
from .dispatch import plain_here

_ARGS = [ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
# K1's relative-position arguments (rh, rw, kh, kw, then the terms' row
# strides), appended after its others and before the stream, which stays last
# (pipeline/graphs.py): the benchmark's readers take the others, and rh, rw,
# kh, kw, by position
_REL_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int]
RH_ARG = len(_ARGS) - 1          # the position of rh in a K1 launch


class _K1(Kernel):
    """K1, which also counts its relative-position launches
    (``attention.relpos_launches``), replays of a captured step included."""

    def launch(self, *args) -> None:
        super().launch(*args)
        if CAPTURE.segmenter is None and args[RH_ARG].value is not None:
            observability.METRICS.count("attention.relpos_launches")


K1 = _K1("flash_attention_k1", "flash_attention", "sdm_flash_attention_k1",
         _ARGS[:-1] + _REL_ARGS + _ARGS[-1:],
         replaces="sdmatte_tpu/ops/flash_attention.py:78 "
                  "(_kernel_fused_l), :119 (_kernel_d64_v2)")
K2 = Kernel("flash_attention_k2", "flash_attention", "sdm_flash_attention_k2",
            _ARGS, replaces="sdmatte_tpu/ops/flash_attention.py:41 (_kernel)")

K1_HEAD_DIMS = (64, 128)
K2_HEAD_DIMS = (512,)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the plain version's score block: at most this many fp32 scores at once
PLAIN_BLOCK_ELEMS = 1 << 28


class RelPos(NamedTuple):
    """Decomposed relative-position terms over a key grid of ``kw`` columns
    (keys row-major): ``rh`` (B*H, Lq, kh) and ``rw`` (B*H, Lq, kw), in q's
    dtype, with a contiguous last dim (rows may be padded, as
    ``ops/attention.relpos_terms`` pads them for K1's TMA loads); key k adds
    ``rh[q, k // kw] + rw[q, k % kw]`` to q's score."""
    rh: torch.Tensor
    rw: torch.Tensor
    kw: int


def attention_plain(q, k, v, *, scale: float, bias=None, rel: RelPos | None = None):
    """The plain version (sdmatte_tpu/ops/attention.py::attention_xla): fp32
    scores and softmax, P cast to V's dtype before the PV product, which
    accumulates in fp32.  With ``rel`` the scores of at most
    :data:`PLAIN_BLOCK_ELEMS` are held at once (blocks of query rows)."""
    if rel is not None:
        return _relpos_plain(q, k, v, scale, rel)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(v.dtype)


def _relpos_plain(q, k, v, scale, rel):
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    kw = rel.kw
    kh = lk // kw
    rh = rel.rh.view(b, h, lq, kh)
    rw = rel.rw.view(b, h, lq, kw)
    kt = k.float().transpose(-1, -2)
    vf = v.float()
    rows = max(1, min(lq, PLAIN_BLOCK_ELEMS // (b * h * lk)))
    out = []
    for r0 in range(0, lq, rows):
        r1 = min(lq, r0 + rows)
        s = torch.matmul(q[:, :, r0:r1].float(), kt) * scale
        s = s.view(b, h, r1 - r0, kh, kw) + rh[:, :, r0:r1, :, None] + rw[:, :, r0:r1, None, :]
        p = torch.softmax(s.view(b, h, r1 - r0, lk), dim=-1)
        out.append(torch.matmul(p.to(v.dtype).float(), vf))
    return torch.cat(out, dim=2).to(v.dtype)


def _check(name, t, dtype, device):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"flash_attention: {name} is {t.dtype} on {t.device}, "
                         f"expected {dtype} on {device}")
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} needs a contiguous last dim")
    step = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % step for s in t.stride()[:-1]):
        raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned")


def flash_attention(q, k, v, *, scale: float, bias=None, rel: RelPos | None = None):
    """q (B,H,Lq,D), k and v (B,H,Lk,D), bias (B,Lk) fp32 or None, rel the
    relative-position terms or None -> (B,H,Lq,D) in q's dtype.

    Any (batch, head, row) strides are taken as they are; the output of a
    kernel is a (B,H,Lq,D) view of a (B,Lq,H,D) tensor, so the caller's
    merge of the heads is free."""
    if plain_here(q):
        return attention_plain(q, k, v, scale=scale, bias=bias, rel=rel)
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
    if rel is not None:
        return _relpos(q, k, v, scale, bias, rel)
    if d in K1_HEAD_DIMS:
        kernel = K1
    elif d in K2_HEAD_DIMS:
        kernel = K2
    else:
        raise ValueError(f"flash_attention: no kernel for head dim {d}")
    return forward_only(kernel.name, lambda q, k, v, bias: _launch(kernel, q, k, v, bias, scale),
                        q, k, v, bias)


@functools.cache
def _exact_in_bf16(x: float) -> bool:
    return torch.tensor(x).bfloat16().item() == x


def tma_rows(t):
    """Terms (B*H, Lq, n) as K1's TMA loads read them: a contiguous last dim,
    a row stride of a multiple of 8 values (16 bytes), rows packed, a 16-byte
    aligned start.  ``t`` itself where it is so (``relpos_terms`` writes them
    so), else a copy with rows padded to a multiple of 8."""
    bh, lq, n = t.shape
    ld = t.stride(1)
    if t.stride(2) == 1 and ld >= n and ld % 8 == 0 and t.stride(0) == lq * ld \
            and t.data_ptr() % 16 == 0:
        return t
    out = torch.empty((bh, lq, -(-n // 8) * 8), dtype=t.dtype, device=t.device)[..., :n]
    return out.copy_(t)


def _relpos(q, k, v, scale, bias, rel):
    """K1's relative-position mode, on any key grid: its 8 x 16 key tiles
    mask what lies past the grid's edge (csrc flash_fwd_relpos_sm90)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if bias is not None:
        raise ValueError("flash_attention: a per-key bias and relative-position terms "
                         "are not taken together")
    if q.dtype != torch.bfloat16 or d != 64:
        raise ValueError(f"flash_attention: the relative-position mode runs bf16 at "
                         f"d = 64, not {q.dtype} at d = {d}")
    if not (scale > 0 and _exact_in_bf16(1.0 / scale)):
        raise ValueError(f"flash_attention: the relative-position mode needs 1 / scale "
                         f"exact in bf16 (its one-hot carries it), not scale {scale}")
    kw = rel.kw
    kh = lk // kw
    if kh * kw != lk:
        raise ValueError(f"flash_attention: {lk} keys are no grid of {kw} columns")
    for name, t, n in (("rh", rel.rh, kh), ("rw", rel.rw, kw)):
        if t.shape != (b * h, lq, n) or t.dtype != torch.bfloat16 \
                or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be a ({b * h}, {lq}, {n}) bf16 "
                             f"tensor with a contiguous last dim on q's device, not "
                             f"{tuple(t.shape)} {t.dtype}: K1 takes the terms as "
                             f"relpos_terms makes them and rounds none")
    return forward_only(K1.name, lambda q, k, v, rh, rw: _launch(K1, q, k, v, None, scale,
                                                                 RelPos(rh, rw, kw)),
                        q, k, v, tma_rows(rel.rh), tma_rows(rel.rw))


def _launch(kernel, q, k, v, bias, scale, rel=None):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)

    def strides(t):
        return (ctypes.c_longlong * 3)(*t.stride()[:3])

    args = [_DTYPES[q.dtype], d, ptr(q), ptr(k), ptr(v), ptr(bias),
            ptr(out), strides(q), strides(k), strides(v), strides(out),
            0 if bias is None else bias.stride(0), b, h, lq, lk, float(scale)]
    if kernel is K1:
        args += ([ptr(None), ptr(None), 0, 0, 0, 0] if rel is None else
                 [ptr(rel.rh), ptr(rel.rw), rel.rh.shape[-1], rel.kw,
                  rel.rh.stride(1), rel.rw.stride(1)])
    kernel.launch(*args, stream_handle(q.device))
    return out
