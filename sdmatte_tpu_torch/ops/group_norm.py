"""GroupNorm's statistics and its apply: the hand kernels and their plain versions.

  csrc/group_norm.cu, for every GroupNorm site of SDMatte (113 a 1024 px
  matte): ``gn_stats_sm90`` (per-channel sums of x and x^2 over slabs of
  rows, one read of the input) and ``gn_finish`` (the group statistics and
  the per-channel (a, d)) for :func:`group_norm_stats`; ``gn_apply_sm90``
  (x * a + d, then SiLU when asked, one read and one write) for
  :func:`group_norm_apply`.  They replace no TPU kernel: the JAX package
  leaves GroupNorm to XLA (sdmatte_tpu/core/nn.py:190, :214).

The kernels are bound by bytes on the H100; the source note says what the
designs do about it.  They do not cut the heavy step's CUDA graphs
(``cuts=False``, ops/_build.py): each runs inside the graph being captured,
and the plan counts it at each replay.  Both entry points take the plain
version where ``ops/dispatch.plain_here`` says so and launch the kernels for
a CUDA tensor, or raise.

Counters (utils/observability.METRICS): ``norm.kernel_launches``, the three
kernels' launches, replays included; ``norm.plain_sites``, the GroupNorm
sites whose plain statistics ran, one a site.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as tF
from torch import nn

from ._build import Kernel, forward_only, ptr, stream_handle, tally
from .conv3x3 import _aligned16
from .dispatch import plain_here

LAUNCHES = "norm.kernel_launches"
PLAIN_SITES = "norm.plain_sites"
_REPLACES = "no TPU kernel: XLA's fusion of sdmatte_tpu/core/nn.py:190 (group_norm_stats)"

GN_STATS = Kernel("group_norm_stats", "group_norm", "sdm_gn_stats",
                  [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
                  + [ctypes.c_void_p],
                  replaces=_REPLACES, cuts=False, counter=LAUNCHES)
GN_FINISH = Kernel("group_norm_finish", "group_norm", "sdm_gn_finish",
                   [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
                   replaces=_REPLACES, cuts=False, counter=LAUNCHES)
GN_APPLY = Kernel("group_norm_apply", "group_norm", "sdm_gn_apply",
                  [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p],
                  replaces="no TPU kernel: XLA's fusion of sdmatte_tpu/core/nn.py:214 "
                           "(group_norm) and the SiLU after it",
                  cuts=False, counter=LAUNCHES)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VEC = 8                 # channels a thread owns (kVec in the source)
ROW_THREADS = 256       # a block's threads, as near as whole rows allow (kRowThreads)
MAX_THREADS = 512       # C / VEC at most (kMaxThreads)
BLOCKS = 8 * 132        # blocks a pass aims at: eight on each of the H100's 132 SMs
THREAD_ROWS = 8         # rows a thread walks at least


def slabs(b: int, hw: int, c: int) -> int:
    """The blocks each pass cuts a batch's ``hw`` rows into: about ``BLOCKS``
    in all, each thread walking at least ``THREAD_ROWS`` rows (a block reads
    ``rows_a_step`` whole rows at a time)."""
    tpr = c // VEC
    rows_a_step = 1 if tpr >= ROW_THREADS else ROW_THREADS // tpr
    per = max(THREAD_ROWS * rows_a_step, math.ceil(hw / math.ceil(BLOCKS / b)))
    return math.ceil(hw / per)


# ------------------------------------------------------------ plain versions ---

def group_norm_stats_plain(p: nn.GroupNorm, x: torch.Tensor):
    """Per-(batch, channel) fp32 (a, d) with GroupNorm(x) = x * a + d.

    The per-channel sums of x and x^2 accumulate in fp32 inside the
    reductions (on the card a bf16 input is read once per sum, with no fp32
    copy and no squared tensor); the group statistics follow the JAX
    package's E[x^2] - E[x]^2."""
    b, c, h, w = x.shape
    groups, cg = p.num_groups, c // p.num_groups
    n = float(h * w * cg)
    s1 = x.sum(dim=(2, 3), dtype=torch.float32)
    s2 = torch.linalg.vector_norm(x, 2, dim=(2, 3), dtype=torch.float32).square()
    gm = s1.reshape(b, groups, cg).sum(-1) / n
    g2 = s2.reshape(b, groups, cg).sum(-1) / n
    inv = torch.rsqrt(g2 - gm.square() + p.eps)
    inv_c = inv.repeat_interleave(cg, dim=-1)
    mean_c = gm.repeat_interleave(cg, dim=-1)
    a = inv_c * p.weight.float()[None]
    d = p.bias.float()[None] - mean_c * a
    return a, d


def group_norm_apply_plain(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                           silu: bool) -> torch.Tensor:
    """x * a + d in fp32, written in x's dtype by one pass (a differentiable
    pass in the promoted dtype, then cast, when autograd records: an ``out=``
    op has no gradient); then SiLU, in place unless autograd records it."""
    if torch.is_grad_enabled() and (x.requires_grad or a.requires_grad):
        y = torch.addcmul(d[:, :, None, None], x, a[:, :, None, None]).to(x.dtype)
    else:
        y = torch.addcmul(d[:, :, None, None], x, a[:, :, None, None],
                          out=torch.empty_like(x))
    return tF.silu(y, inplace=not y.requires_grad) if silu else y


# ------------------------------------------------------------- entry points ---

def _check_x(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise ValueError(f"{name}: no kernel for x {x.dtype} of {x.dim()} dims")
    c = x.shape[1]
    if c % VEC or c // VEC > MAX_THREADS:
        raise ValueError(f"{name}: C={c} must be a multiple of {VEC} and at most "
                         f"{VEC * MAX_THREADS}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: x must be channels_last")


def group_norm_stats(p: nn.GroupNorm, x: torch.Tensor):
    """Same contract as :func:`group_norm_stats_plain`: (a, d), each (B, C)
    fp32, the pair the 3x3 conv kernel's prologue takes.  On the card x must
    be in ``torch.channels_last`` (NHWC memory), bf16 or fp32, with C a
    multiple of 8; the weight and bias are read in their own dtype."""
    if plain_here(x):
        tally(PLAIN_SITES)
        return group_norm_stats_plain(p, x)
    _check_x(x, "group_norm_stats")
    c = x.shape[1]
    w, bias = p.weight, p.bias
    if c % p.num_groups or w is None or bias is None:
        raise ValueError(f"group_norm_stats: no kernel for {p}")
    for t in (w, bias):
        if t.shape != (c,) or t.dtype not in _DTYPES or t.dtype != w.dtype \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError("group_norm_stats: weight and bias must be contiguous (C,) "
                             "tensors of one float dtype on x's device")
    return forward_only(GN_STATS.name, lambda x, w, bias: _launch_stats(
        x, w, bias, p.num_groups, p.eps), x, w, bias)


def _launch_stats(x, w, bias, groups, eps):
    b, c, h, wd = x.shape
    s = slabs(b, h * wd, c)
    x = _aligned16(x)
    part = torch.empty((b, s, c, 2), dtype=torch.float32, device=x.device)
    a = torch.empty((b, c), dtype=torch.float32, device=x.device)
    d = torch.empty_like(a)
    stream = stream_handle(x.device)
    GN_STATS.launch(_DTYPES[x.dtype], ptr(x), ptr(part), b, h * wd, c, s, stream)
    GN_FINISH.launch(ptr(part), ptr(w), ptr(bias), _DTYPES[w.dtype], ptr(a), ptr(d),
                     b, c, groups, s, float(h * wd * (c // groups)), float(eps), stream)
    return a, d


def group_norm_apply(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor, *,
                     silu: bool) -> torch.Tensor:
    """Same contract as :func:`group_norm_apply_plain`, a fresh output in
    x's dtype and memory format.  On the card x as for
    :func:`group_norm_stats`, a and d contiguous (B, C) fp32; the SiLU is
    applied to the fp32 value before the one rounding."""
    if plain_here(x):
        return group_norm_apply_plain(x, a, d, silu)
    _check_x(x, "group_norm_apply")
    for t in (a, d):
        if t.shape != x.shape[:2] or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError("group_norm_apply: a and d must be two contiguous (B, C) "
                             "fp32 tensors on x's device")
    return forward_only(GN_APPLY.name, lambda x, a, d: _launch_apply(x, a, d, silu), x, a, d)


def _launch_apply(x, a, d, silu):
    b, c, h, wd = x.shape
    x = _aligned16(x)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    GN_APPLY.launch(_DTYPES[x.dtype], ptr(x), ptr(a), ptr(d), ptr(y), b, h * wd, c,
                    slabs(b, h * wd, c), int(silu), stream_handle(x.device))
    return y
