"""Smoke run of the PyTorch port (sdmatte_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout; one CUDA card
    python3 chip_smoke.py --profile  # also: device time by kernel for one matte

Phases, in order; any failure exits non-zero before the result lines:
  1. the card's name and power limit, torch and CUDA versions; TF32 off
  2. build the hand kernels from csrc/ (one nvcc per source, in parallel);
     per source the registers, spills and wgmma serialization warnings, and
     per kernel function the HGMMA / IGMMA (wgmma on bf16 / int8) and
     UTMALDG (TMA load) counts of its SASS.  Every main-path instantiation
     of K1-K4 must have its wgmma and TMA instructions and no spill, or the
     run fails before its result lines
  3. hold each kernel against its plain version at every main-path shape
     class, at shapes ragged for its tiles, and in fp32; the channel-split
     conv wrapper against the direct conv; for each int8 conv the kernel of
     csrc/conv3x3_i8.cu it is routed to is printed
  4. time each kernel, its plain version and the one PyTorch call that
     computes the same function (a yardstick the port never calls), beside
     the least time the card could take (bytes at 3.35 TB/s, or operations
     at 989 TFLOP/s bf16 or 1,979 TOP/s int8, whichever is larger); for K1
     also the exp2 (MUFU) bound
  5. three mattes end to end at full width (SDMatteConfig(): U-Net
     320/640/1280/1280, VAE 128/256/512/512) with seeded random weights,
     bf16, 1024 px: the default, vae_int8=True (every 3x3 VAE conv on the
     int8 kernel K4) and weight_storage="int8".  Each path is built from the
     fp32 weights; for each, launch counts against the counts the code
     predicts, warm time per matte, peak memory, and the model's alpha
     (before mask_refine) against the same call on the plain versions (MAE
     <= 1e-2); on the vae_int8 path the plain versions run on the kernels'
     path's int8 activations and each int8 conv's input is held to the
     kernels' path's (relative MAE <= 2e-2)
With --profile, one more warm matte of the default and vae_int8 paths runs
under torch.profiler and the device time per kernel name, the device's busy
share and the top kernels are printed.  The last two lines are the
per-kernel JSON record and the device record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12           # dense bf16 tensor cores
INT8_OPS = 1979e12            # dense int8 tensor cores
# exp2 on the SFU (MUFU): 16 per clock per SM, 132 SMs, at the 1.83 GHz that
# the bf16 peak implies (989e12 / (132 SMs x 4096 flop per clock)); one per
# attention score.  Printed beside K1's bound, not part of it.
MUFU_EX2_PER_S = 16 * 132 * 1.83e9

# Main-path launches per 1024 px matte, read from the code:
#   K1: 16 U-Net transformers (down 2+2+2, mid 1, up 3+3+3), one biased
#       self-attention and one cross-attention onto the 16,384 aux tokens each
#   K2: the VAE mid-block attention, encoder (batch 2) and decoder (batch 1)
#   K3: the encoder's dispatch-table convs at concat batch 2: 1024^2 128->128
#       x4 (gn), 512^2 128->256 x1 (bare), 512^2 256->256 x3 (gn, residual on
#       the two conv2s), 256^2 512->512 x3 (gn, residual on the two conv2s)
ATTN_SHAPES = {   # kernel -> [(label, (B, H, Lq, Lk, D), biased, launches)]
    "flash_attention_k1": [
        ("self 128^2", (1, 5, 16384, 16384, 64), True, 5),
        ("self 64^2", (1, 10, 4096, 4096, 64), True, 5),
        ("self 32^2", (1, 20, 1024, 1024, 64), True, 5),
        ("self 16^2", (1, 20, 256, 256, 64), True, 1),
        ("cross 128^2", (1, 5, 16384, 16384, 64), False, 5),
        ("cross 64^2", (1, 10, 4096, 16384, 64), False, 5),
        ("cross 32^2", (1, 20, 1024, 16384, 64), False, 5),
        ("cross 16^2", (1, 20, 256, 16384, 64), False, 1),
    ],
    "flash_attention_k2": [
        ("vae encoder mid", (2, 1, 16384, 16384, 512), False, 1),
        ("vae decoder mid", (1, 1, 16384, 16384, 512), False, 1),
    ],
}
CONV_SHAPES = [   # (label, (B, H, W, Cin, Cout), gn, residual, launches)
    ("1024^2 128->128 gn", (2, 1024, 1024, 128, 128), True, False, 4),
    ("512^2 128->256", (2, 512, 512, 128, 256), False, False, 1),
    ("512^2 256->256 gn", (2, 512, 512, 256, 256), True, False, 1),
    ("512^2 256->256 gn+res", (2, 512, 512, 256, 256), True, True, 2),
    ("256^2 512->512 gn", (2, 256, 256, 512, 512), True, False, 1),
    ("256^2 512->512 gn+res", (2, 256, 256, 512, 512), True, True, 2),
]
# K4 under vae_int8: every 3x3 conv of the VAE, read from models/vae.py.
#   encoder at concat batch 2: conv_in; 2 resnets x 2 convs per stage; a
#     stride-2 downsampler after each of the first three stages; the
#     mid-block's 2 resnets; conv_out (25)
#   decoder at batch 1: conv_in; the mid-block's 2 resnets; 3 resnets x 2
#     convs per stage; an upsampler conv (nearest x2, then the conv) after
#     each of the first three stages; conv_out (33)
INT8_SHAPES = [   # (label, (B, H, W, Cin, Cout), stride, launches)
    ("enc conv_in", (2, 1024, 1024, 3, 128), 1, 1),
    ("enc 1024^2 128->128", (2, 1024, 1024, 128, 128), 1, 4),
    ("enc down 1024^2 128", (2, 1024, 1024, 128, 128), 2, 1),
    ("enc 512^2 128->256", (2, 512, 512, 128, 256), 1, 1),
    ("enc 512^2 256->256", (2, 512, 512, 256, 256), 1, 3),
    ("enc down 512^2 256", (2, 512, 512, 256, 256), 2, 1),
    ("enc 256^2 256->512", (2, 256, 256, 256, 512), 1, 1),
    ("enc 256^2 512->512", (2, 256, 256, 512, 512), 1, 3),
    ("enc down 256^2 512", (2, 256, 256, 512, 512), 2, 1),
    ("enc 128^2 512->512", (2, 128, 128, 512, 512), 1, 8),
    ("enc conv_out", (2, 128, 128, 512, 8), 1, 1),
    ("dec conv_in", (1, 128, 128, 4, 512), 1, 1),
    ("dec 128^2 512->512", (1, 128, 128, 512, 512), 1, 10),
    ("dec 256^2 512->512", (1, 256, 256, 512, 512), 1, 7),
    ("dec 512^2 512->512", (1, 512, 512, 512, 512), 1, 1),
    ("dec 512^2 512->256", (1, 512, 512, 512, 256), 1, 1),
    ("dec 512^2 256->256", (1, 512, 512, 256, 256), 1, 5),
    ("dec 1024^2 256->256", (1, 1024, 1024, 256, 256), 1, 1),
    ("dec 1024^2 256->128", (1, 1024, 1024, 256, 128), 1, 1),
    ("dec 1024^2 128->128", (1, 1024, 1024, 128, 128), 1, 5),
    ("dec conv_out", (1, 1024, 1024, 128, 3), 1, 1),
]
DOWN_PAD = ((0, 1), (0, 1))   # diffusers Downsample2D's padding at stride 2
# tolerances: the JAX package's own bars (tests/test_flash_attention.py:43,97,
# tests/test_conv3x3.py:64,117,135), as allclose(atol, rtol), except bf16
# attention.
# The JAX file set its bf16 bar, allclose(2e-2, 2e-2), at Lk=256, where the
# outputs reach ~0.6; at Lk=16384 they have std ~0.013, below its atol, and a
# kernel that dropped a KV tile would pass.  bf16 attention is therefore held
# to the bar's 2e-2 relative to the output's scale:
# max|got - ref| <= 2e-2 * max|ref|.  The bf16 conv outputs are O(1), where
# the JAX bar means what it says.
TOL = {"attn_bf16": 2e-2, "attn_fp32": (2e-5, 2e-5),
       "conv_bf16": (2e-2, 2e-2), "conv_fp32": (3e-5, 1e-4),
       "csplit_fp32": (5e-5, 1e-4),
       # K4: the int32 sums and the fp32 epilogue are exact and a bf16 output
       # is the same one rounding, so the kernel equals its plain version
       "int8_exact": (0.0, 0.0)}


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "USETMAXREG")
# kernel function (a substring of its mangled name) -> what its SASS must hold;
# none of them may spill.  These are the main paths' instantiations: K1, K2
# (bf16 d = 512), K3, and K4 at stride 1 (Cin a multiple of 16; and Cin 3 and
# 4 with the taps folded into K, which gathers its rows without TMA).
SASS_REQUIRED = {
    "flash_attention": {"flash_fwd_sm90": ("HGMMA", "UTMALDG"),
                        "flash_fwd_d512_sm90": ("HGMMA", "UTMALDG")},
    "conv3x3": {"conv3x3_sm90": ("HGMMA", "UTMALDG")},
    "conv3x3_i8": {"conv3x3_i8_sm90": ("IGMMA", "UTMALDG"),
                   "conv3x3_i8_fold": ("IGMMA",)},
}


def sass_counts(lib) -> dict:
    """Per kernel function of a built library, the wgmma (HGMMA on bf16,
    IGMMA on int8), TMA load (UTMALDG) and USETMAXREG instructions in its
    SASS (cuobjdump, beside nvcc): {mangled name: {op: count}}."""
    from sdmatte_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        counts[name.strip()] = {op: body.count(op) for op in SASS_OPS}
    return counts


def short_name(mangled: str) -> str:
    """A kernel's name and template arguments out of its mangled name, as
    nvcc writes it for a function in an anonymous namespace:
    ..._cu_<8 hex digits><length><name>I<arguments>EEv<parameters>."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if not m:
        return mangled[:60]
    return mangled[m.end():].split("Ev")[0][:60]


def median_ms(torch, fn, reps=5, warm=2):
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops, nbytes, flops_rate=BF16_FLOPS):
    t_ops, t_bytes = flops / flops_rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def allclose_err(torch, got, ref, tol):
    """(max |got - ref|, passed) for |got - ref| <= atol + rtol * |ref|, or,
    where tol is a number, for max |got - ref| <= tol * max |ref|."""
    diff = (got.float() - ref.float()).abs()
    if isinstance(tol, float):
        return float(diff.max()), bool(diff.max() <= tol * ref.float().abs().max())
    atol, rtol = tol
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return float(diff.max()), ok


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device=self.dev).manual_seed(0)
        self.err = {}      # kernel -> max abs err over its checks
        self.profile_on = False

    def randn(self, *shape, dtype=None, scale=1.0):
        t = self.torch.randn(*shape, generator=self.gen, device=self.dev) * scale
        return t if dtype is None else t.to(dtype)

    def rand(self, *shape, lo=0.0, hi=1.0):
        return self.torch.rand(*shape, generator=self.gen, device=self.dev) * (hi - lo) + lo

    def check(self, name, label, got, ref, tol_key):
        tol = TOL[tol_key]
        err, ok = allclose_err(self.torch, got, ref, tol)
        self.err[name] = max(self.err.get(name, 0.0), err)
        bar = (f"max err <= {tol:g} * max|ref|" if isinstance(tol, float)
               else f"allclose atol {tol[0]:g} rtol {tol[1]:g}")
        log(f"  check {name:20s} {label:34s} max_abs_err {err:.3e} "
            f"(max|ref| {float(ref.float().abs().max()):.3g}; {bar}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label}: kernel disagrees with its plain version")

    # -- attention -------------------------------------------------------
    def attn_inputs(self, shape, biased, dtype):
        b, h, lq, lk, d = shape
        q, k, v = (self.randn(b, h, n, d, dtype=dtype) for n in (lq, lk, lk))
        bias = None
        if biased:
            bias = (self.rand(b, lk) < 0.5).float() * -10000.0
        return q, k, v, bias, d ** -0.5

    def check_attention(self):
        from sdmatte_tpu_torch.ops.flash_attention import attention_plain, flash_attention
        torch = self.torch
        cases = [(name, label, shape, biased, torch.bfloat16, "attn_bf16")
                 for name, rows in ATTN_SHAPES.items()
                 for label, shape, biased, _ in rows]
        cases += [
            ("flash_attention_k1", "ragged 80^2 (640 px)", (1, 5, 6400, 6400, 64), True,
             torch.bfloat16, "attn_bf16"),
            # 75^2 = 5625 = 43 x 128 + 121: ragged for the 128-row and
            # 128-key tiles (6400 is not)
            ("flash_attention_k1", "ragged 75^2 (600 px)", (1, 5, 5625, 5625, 64), True,
             torch.bfloat16, "attn_bf16"),
            ("flash_attention_k1", "ragged cross 75^2 x 5000", (1, 5, 5625, 5000, 64), False,
             torch.bfloat16, "attn_bf16"),
            ("flash_attention_k1", "fp32 self 32^2", (1, 20, 1024, 1024, 64), True,
             torch.float32, "attn_fp32"),
            ("flash_attention_k1", "fp32 ragged 100x200", (1, 2, 100, 200, 64), True,
             torch.float32, "attn_fp32"),
            ("flash_attention_k2", "ragged 80^2 (640 px)", (2, 1, 6400, 6400, 512), False,
             torch.bfloat16, "attn_bf16"),
            # ragged for K2's 64-row and 64-key tiles and for the 32-key
            # halves its two warpgroups score: Lk = 170 leaves the last
            # tile's second half 10 keys, Lk = 65 one key in the first half
            ("flash_attention_k2", "ragged 130x170", (1, 1, 130, 170, 512), False,
             torch.bfloat16, "attn_bf16"),
            ("flash_attention_k2", "ragged 200x1000 biased", (2, 1, 200, 1000, 512), True,
             torch.bfloat16, "attn_bf16"),
            ("flash_attention_k2", "ragged 64x65 biased", (2, 1, 64, 65, 512), True,
             torch.bfloat16, "attn_bf16"),
            ("flash_attention_k2", "fp32 1024 tokens", (2, 1, 1024, 1024, 512), False,
             torch.float32, "attn_fp32"),
            ("flash_attention_k2", "fp32 ragged 300x170 biased", (1, 1, 300, 170, 512), True,
             torch.float32, "attn_fp32"),
        ]
        for name, label, shape, biased, dtype, tol in cases:
            q, k, v, bias, scale = self.attn_inputs(shape, biased, dtype)
            got = flash_attention(q, k, v, scale=scale, bias=bias)
            torch.cuda.synchronize()
            ref = attention_plain(q, k, v, scale=scale, bias=bias)
            self.check(name, f"{label} {tuple(shape)}", got, ref, tol)
            del q, k, v, got, ref
        # K2 on q, k and v as (B, L, H, D) memory viewed as (B, H, L, D)
        q, k, v = (self.randn(2, n, 2, 512, dtype=torch.bfloat16).transpose(1, 2)
                   for n in (1000, 777, 777))
        bias = (self.rand(2, 777) < 0.5).float() * -10000.0
        got = flash_attention(q, k, v, scale=512 ** -0.5, bias=bias)
        torch.cuda.synchronize()
        self.check("flash_attention_k2", "transposed view 1000x777 biased (2, 2, 1000, 777, 512)",
                   got, attention_plain(q, k, v, scale=512 ** -0.5, bias=bias), "attn_bf16")

    # -- conv ------------------------------------------------------------
    def conv_inputs(self, shape, gn, res, dtype):
        torch = self.torch
        b, h, w, cin, cout = shape
        cl = torch.channels_last
        x = self.randn(b, cin, h, w, dtype=dtype).contiguous(memory_format=cl)
        wt = self.randn(cout, cin, 3, 3, dtype=dtype, scale=(9 * cin) ** -0.5)
        bias = self.randn(cout, scale=0.1)
        affine = (self.rand(b, cin, lo=0.5, hi=1.5), self.rand(b, cin, lo=0.5, hi=1.5)) if gn else None
        r = self.randn(b, cout, h, w, dtype=dtype).contiguous(memory_format=cl) if res else None
        return x, wt, bias, affine, r

    def check_conv(self):
        from sdmatte_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
        torch = self.torch
        cases = [(label, shape, gn, res, torch.bfloat16, "conv_bf16")
                 for label, shape, gn, res, _ in CONV_SHAPES]
        cases += [
            ("ragged 100x75 gn+res", (1, 100, 75, 128, 128), True, True, torch.bfloat16, "conv_bf16"),
            ("ragged 50x37 64->320 gn+res", (1, 50, 37, 64, 320), True, True, torch.bfloat16,
             "conv_bf16"),
            ("fp32 ragged 100x75 gn+res", (1, 100, 75, 128, 128), True, True,
             torch.float32, "conv_fp32"),
            ("fp32 128^2 256->256 gn", (2, 128, 128, 256, 256), True, False,
             torch.float32, "conv_fp32"),
        ]
        for label, shape, gn, res, dtype, tol in cases:
            x, wt, bias, affine, r = self.conv_inputs(shape, gn, res, dtype)
            got = conv3x3(x, wt, bias, affine=affine, residual=r)
            torch.cuda.synchronize()
            ref = conv3x3_plain(x, wt, bias, affine=affine, residual=r)
            self.check("conv3x3", f"{label} {tuple(shape)}", got, ref, tol)
            del x, got, ref

    def check_csplit(self):
        """The channel-split wrapper (two half-Cin K3 passes summed) against
        the direct plain conv, in both fuse_sum modes, GN affine and
        residual on."""
        from sdmatte_tpu_torch.ops.conv3x3 import conv3x3_csplit, conv3x3_plain
        torch = self.torch
        cases = [("csplit 512^2 256->256 gn+res", (2, 512, 512, 256, 256), torch.bfloat16,
                  "conv_bf16"),
                 ("fp32 csplit ragged 100x75 256->128 gn+res", (1, 100, 75, 256, 128),
                  torch.float32, "csplit_fp32")]
        for label, shape, dtype, tol in cases:
            x, wt, bias, affine, r = self.conv_inputs(shape, True, True, dtype)
            ref = conv3x3_plain(x, wt, bias, affine=affine, residual=r)
            for fuse_sum in (True, False):
                got = conv3x3_csplit(x, wt, bias, affine=affine, residual=r, fuse_sum=fuse_sum)
                torch.cuda.synchronize()
                self.check("conv3x3", f"{label} fuse_sum={fuse_sum} {tuple(shape)}", got,
                           ref, tol)
            del x, got, ref

    # -- int8 conv ---------------------------------------------------------
    def int8_inputs(self, shape, stride):
        torch = self.torch
        b, h, w, cin, cout = shape
        cl = torch.channels_last
        xq = torch.randint(-127, 128, (b, cin, h, w), generator=self.gen, device=self.dev,
                           dtype=torch.int8).contiguous(memory_format=cl)
        wq = torch.randint(-127, 128, (cout, cin, 3, 3), generator=self.gen, device=self.dev,
                           dtype=torch.int8).contiguous(memory_format=cl)
        # s_x * w_scale of O(1) activations and weights of std (9 Cin)^-0.5
        scale = self.rand(cout, lo=0.5, hi=1.5) / (127.0 * 127.0 * (9 * cin) ** 0.5)
        bias = self.randn(cout, scale=0.1)
        return xq, wq, scale, bias, dict(stride=stride, padding=1 if stride == 1 else DOWN_PAD)

    def check_int8_conv(self):
        from sdmatte_tpu_torch.ops.conv3x3 import (conv3x3_int8, conv3x3_int8_plain,
                                                   int8_route)
        torch = self.torch
        cases = [(label, shape, stride, torch.bfloat16, "int8_exact")
                 for label, shape, stride, _ in INT8_SHAPES]
        # every kernel of csrc/conv3x3_i8.cu at shapes ragged for its tiles
        # (4 x 64 pixels, 128 or 8 output channels, 128-channel chunks)
        cases += [
            ("ragged 100x75 128->128", (1, 100, 75, 128, 128), 1, torch.bfloat16, "int8_exact"),
            ("fp32 ragged 100x75 128->128", (1, 100, 75, 128, 128), 1, torch.float32,
             "int8_exact"),
            ("fp32 ragged 9x130 128->100", (2, 9, 130, 128, 100), 1, torch.float32, "int8_exact"),
            ("ragged 9x130 128->100", (2, 9, 130, 128, 100), 1, torch.bfloat16, "int8_exact"),
            ("fp32 Cin 64 20x70", (1, 20, 70, 64, 128), 1, torch.float32, "int8_exact"),
            ("fp32 Cin 320 13x66 ->136", (1, 13, 66, 320, 136), 1, torch.float32, "int8_exact"),
            ("fp32 ragged down 100x75 256", (1, 100, 75, 256, 256), 2, torch.float32,
             "int8_exact"),
            ("ragged down 33x27 128", (1, 33, 27, 128, 128), 2, torch.bfloat16, "int8_exact"),
            ("fp32 conv_in 256^2 3->128", (2, 256, 256, 3, 128), 1, torch.float32, "int8_exact"),
            ("fp32 conv_in 37x70 4->130", (1, 37, 70, 4, 130), 1, torch.float32, "int8_exact"),
            ("fp32 conv_out 256^2 128->3", (1, 256, 256, 128, 3), 1, torch.float32,
             "int8_exact"),
            ("fp32 conv_out 5x200 512->8", (1, 5, 200, 512, 8), 1, torch.float32, "int8_exact"),
            ("fp32 Cin 20 (first design)", (1, 12, 12, 20, 24), 1, torch.float32, "int8_exact"),
        ]
        routes = {}
        for label, shape, stride, dtype, tol in cases:
            xq, wq, scale, bias, kw = self.int8_inputs(shape, stride)
            got = conv3x3_int8(xq, wq, scale, bias, out_dtype=dtype, **kw)
            torch.cuda.synchronize()
            ref = conv3x3_int8_plain(xq, wq, scale, bias, out_dtype=dtype, **kw)
            route = int8_route(shape[3], shape[4], stride)
            routes.setdefault(route, []).append(label)
            self.check("conv3x3_int8", f"{label} s{stride} {tuple(shape)} [{route}]", got, ref,
                       tol)
            del xq, got, ref
        for route, labels in routes.items():
            log(f"  K4 route {route}: {len(labels)} checks ({', '.join(labels)})")

    # -- timing ----------------------------------------------------------
    def time_kernels(self):
        import torch.nn.functional as tF
        from sdmatte_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
        from sdmatte_tpu_torch.ops.flash_attention import attention_plain, flash_attention
        torch = self.torch
        rows = []
        for name, shapes in ATTN_SHAPES.items():
            for label, shape, biased, launches in shapes:
                b, h, lq, lk, d = shape
                q, k, v, bias, scale = self.attn_inputs(shape, biased, torch.bfloat16)
                mask = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)
                t = {
                    "ms": median_ms(torch, lambda: flash_attention(q, k, v, scale=scale, bias=bias)),
                    "plain_ms": median_ms(torch, lambda: attention_plain(q, k, v, scale=scale, bias=bias),
                                          reps=3, warm=1),
                    "library_ms": median_ms(torch, lambda: tF.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, scale=scale)),
                }
                flops = 4 * b * h * lq * lk * d
                nbytes = 2 * b * h * (2 * lq + 2 * lk) * d + (4 * b * lk if biased else 0)
                t["flops"], t["bytes"] = flops, nbytes
                t["bound_ms"], t["bound_by"] = bound(flops, nbytes)
                t["mufu_ms"] = b * h * lq * lk / MUFU_EX2_PER_S * 1e3
                rows.append((name, label, shape, launches, t))
                del q, k, v
        for label, shape, gn, res, launches in CONV_SHAPES:
            b, h, w, cin, cout = shape
            x, wt, bias, affine, r = self.conv_inputs(shape, gn, res, torch.bfloat16)
            xa = x
            if affine is not None:
                a, d = affine
                xa = tF.silu(x.float() * a[:, :, None, None] + d[:, :, None, None]).to(
                    x.dtype).contiguous(memory_format=torch.channels_last)
            wcl = wt.contiguous(memory_format=torch.channels_last)
            bb = bias.to(torch.bfloat16)
            t = {
                "ms": median_ms(torch, lambda: conv3x3(x, wt, bias, affine=affine, residual=r)),
                "plain_ms": median_ms(torch, lambda: conv3x3_plain(x, wt, bias, affine=affine, residual=r),
                                      reps=3, warm=1),
                # cuDNN's bf16 conv on the already-activated input: the conv
                # part of the function (prologue and residual not included)
                "library_ms": median_ms(torch, lambda: tF.conv2d(xa, wcl, bb, padding=1)),
            }
            flops = 2 * b * h * w * cout * 9 * cin
            nbytes = 2 * (b * h * w * (cin + cout * (2 if res else 1)) + 9 * cin * cout) \
                + 4 * cout + (8 * b * cin if gn else 0)
            t["flops"], t["bytes"] = flops, nbytes
            t["bound_ms"], t["bound_by"] = bound(flops, nbytes)
            rows.append(("conv3x3", label, shape, launches, t))
            del x, xa, r
        rows += self.time_int8_conv()
        for name, label, shape, launches, t in rows:
            extra = "".join(f"  {key} {t[key]:.4f}" for key in ("mufu_ms", "cudnn_bf16_ms")
                            if key in t) + (f"  [{t['route']}]" if "route" in t else "")
            log(f"  time {name:20s} {label:24s} {str(shape):32s} x{launches}  "
                f"kernel_ms {t['ms']:.4f}  plain_ms {t['plain_ms']:.4f}  "
                f"library_ms {t['library_ms']:.4f}  bound_ms {t['bound_ms']:.4f} "
                f"({t['bound_by']}){extra}")
        return rows

    def time_int8_conv(self):
        """K4 per vae_int8 shape.  The yardstick is torch._int_mm on the
        im2col matrix of the same conv (the int8 GEMM only, K and N padded
        to its multiple of 8); cuDNN's bf16 conv of the same shape is
        printed beside it."""
        import torch.nn.functional as tF
        from sdmatte_tpu_torch.ops.conv3x3 import (conv3x3_int8, conv3x3_int8_plain,
                                                   int8_route)
        torch = self.torch
        rows = []
        for label, shape, stride, launches in INT8_SHAPES:
            b, h, w, cin, cout = shape
            xq, wq, scale, bias, kw = self.int8_inputs(shape, stride)
            (pt, pb), (pl, pr) = ((1, 1), (1, 1)) if stride == 1 else DOWN_PAD
            ho, wo = (h + pt + pb - 3) // stride + 1, (w + pl + pr - 3) // stride + 1
            t = {
                "ms": median_ms(torch, lambda: conv3x3_int8(xq, wq, scale, bias, **kw)),
                "plain_ms": median_ms(torch, lambda: conv3x3_int8_plain(xq, wq, scale, bias, **kw),
                                      reps=3, warm=1),
            }
            xp = tF.pad(xq.permute(0, 2, 3, 1), (0, 0, pl, pr, pt, pb))
            cols = torch.stack([xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                                   dx:dx + stride * (wo - 1) + 1:stride]
                                for dy in range(3) for dx in range(3)], dim=3)
            k, kp, np_ = 9 * cin, -(-9 * cin // 8) * 8, -(-cout // 8) * 8
            a = tF.pad(cols.reshape(b * ho * wo, k), (0, kp - k))
            del cols, xp
            wmat = tF.pad(wq.permute(0, 2, 3, 1).reshape(cout, k), (0, kp - k, 0, np_ - cout)).t()
            t["library_ms"] = median_ms(torch, lambda: torch._int_mm(a, wmat))
            del a
            xb = tF.pad(torch.randn(b, cin, h, w, generator=self.gen, device=self.dev,
                                    dtype=torch.bfloat16), (pl, pr, pt, pb))
            xb = xb.contiguous(memory_format=torch.channels_last)
            wb = (wq.float() / 127.0).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            t["cudnn_bf16_ms"] = median_ms(torch, lambda: tF.conv2d(xb, wb, stride=stride))
            del xb
            flops = 2 * b * ho * wo * cout * 9 * cin
            nbytes = b * h * w * cin + 9 * cin * cout + 2 * b * ho * wo * cout + 8 * cout
            t["flops"], t["bytes"] = flops, nbytes
            t["bound_ms"], t["bound_by"] = bound(flops, nbytes, INT8_OPS)
            t["route"] = int8_route(cin, cout, stride)
            rows.append(("conv3x3_int8", label, shape + (stride,), launches, t))
            del xq
        return rows

    # -- end to end --------------------------------------------------------
    def inputs(self):
        """A synthetic 1024x1024 photo and trimap, made from a seed, and the
        default call's options (1024 px, alpha_only, refine, 0.8)."""
        import numpy as np
        from sdmatte_tpu_torch.pipeline import PipelineOptions
        rng = np.random.default_rng(0)
        yy, xx = np.mgrid[0:1024, 0:1024] / 1024.0
        r = np.sqrt((yy - 0.5) ** 2 + (xx - 0.45) ** 2)
        img = np.stack([0.2 + 0.6 * (r < 0.3), 0.3 + 0.4 * yy, 0.5 + 0.3 * xx], -1)
        img = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)
        tri = np.where(r < 0.25, 1.0, np.where(r < 0.35, 0.5, 0.0)).astype(np.float32)
        return img, tri, PipelineOptions()

    def pipeline(self, **kw):
        """A bf16 pipeline on a model with the seeded fp32 weights, made anew,
        so that no path sees another's cast or quantized weights."""
        torch = self.torch
        from sdmatte_tpu_torch.configs import SDMatteConfig
        from sdmatte_tpu_torch.core.dtypes import BF16
        from sdmatte_tpu_torch.models.init import init_random_
        from sdmatte_tpu_torch.models.sdmatte import SDMatte
        from sdmatte_tpu_torch.pipeline import MattingPipeline
        with torch.device("meta"):
            model = SDMatte(SDMatteConfig())
        init_random_(model, seed=0, device=self.dev)
        n = sum(p.numel() for p in model.parameters())
        return MattingPipeline(model, policy=BF16, device=self.dev, **kw), n

    def matte(self, label, predicted, **kw):
        """One path end to end: launches of one matte against ``predicted``,
        the warm median of 3, peak memory, and the alpha before mask_refine
        against the same path on the plain versions.  Returns (launches,
        median s, peak GiB, alpha before mask_refine)."""
        torch = self.torch
        from sdmatte_tpu_torch.ops._build import Kernel
        img, tri, opts = self.inputs()
        t0 = time.perf_counter()
        pipe, n_params = self.pipeline(**kw)
        torch.cuda.synchronize()
        log(f"  [{label}] model: {n_params / 1e6:.1f} M params, seeded random weights, "
            f"bf16, {kw or 'default options'}, ready in {time.perf_counter() - t0:.1f} s")

        pipe(img, tri, options=opts)          # warm: allocator, cuDNN plans
        torch.cuda.synchronize()
        kernels = Kernel.registry
        for k in kernels:
            k.launches = 0
        times = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        alpha, matted = pipe(img, tri, options=opts)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = {k.name: k.launches for k in kernels}
        log(f"  [{label}] launches per matte: {launches}  predicted: {predicted}")
        if launches != predicted:
            raise AssertionError(f"{label}: the launch counts differ from the prediction")
        for _ in range(2):
            t0 = time.perf_counter()
            pipe(img, tri, options=opts)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        a = alpha.float()
        log(f"  [{label}] alpha {tuple(a.shape)} range [{a.min().item():.4f}, "
            f"{a.max().item():.4f}] finite {bool(torch.isfinite(a).all())}  "
            f"mean {a.mean().item():.4f}")
        if a.shape != (1, 1024, 1024) or not bool(torch.isfinite(a).all()) \
                or a.min() < 0 or a.max() > 1:
            raise AssertionError(f"{label}: alpha is not a finite (1, 1024, 1024) map in [0, 1]")
        median = statistics.median(times)
        log(f"  [{label}] warm seconds per matte (host clock, synchronized): "
            f"{[round(t, 4) for t in times]}  median {median:.4f}  peak memory {peak:.2f} GiB")
        if self.profile_on:
            self.profile(pipe, (img, tri, opts))

        # The bar holds the model's alpha before mask_refine: refine forces the
        # trimap's background (62% of these pixels) to 0 on both paths, which
        # would dilute the MAE over the pixels the model decides.
        raw_opts = dataclasses.replace(opts, mask_refine=False)
        shared, n_shared = [], 0
        with self.int8_activations(shared, replay=False):  # records only on the int8 path
            alpha_raw, _ = pipe(img, tri, options=raw_opts)
        del pipe
        plain, _ = self.pipeline(impl="plain", **kw)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        alpha_plain, _ = plain(img, tri, options=opts)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        alpha_plain_raw, _ = plain(img, tri, options=raw_opts)
        mae_free = float((alpha_raw.float() - alpha_plain_raw.float()).abs().mean())
        if shared:
            # Each int8 conv requantizes its input per tensor, so a bf16
            # rounding difference upstream flips single int8 steps, which the
            # next convs spread until the two paths differ by about the int8
            # noise itself: the free-running MAE is printed, not held.  The
            # bar holds the path segment by segment instead: the plain path
            # runs on the kernels' path's int8 activations, and each int8
            # conv's input on it is held to the kernels' path's input at the
            # kernel checks' bf16 bar relative to scale (mean |diff| / mean
            # |input| <= 2e-2).  Segments differ only where K1 or K2 run (the
            # U-Net before the decoder's conv_in is the deepest).  With every
            # activation shared, the alpha follows from the last conv's.
            n_shared = len(shared)
            with self.int8_activations(shared, replay=True) as per_conv:
                alpha_plain_raw, _ = plain(img, tri, options=raw_opts)
            if shared or len(per_conv) != n_shared:
                raise AssertionError(f"{label}: the plain path ran another number of int8 "
                                     f"convs than the kernels' path ({len(per_conv)} vs "
                                     f"{n_shared})")
            worst = max(range(n_shared), key=lambda i: per_conv[i][0])
            n_flip, n_el = sum(c[1] for c in per_conv), sum(c[2] for c in per_conv)
            log(f"  [{label}] {n_shared} int8 conv inputs held against the kernels' path's "
                f"with its int8 activations shared: relative MAE per conv "
                f"{[float(f'{c[0]:.2e}') for c in per_conv]}, largest {per_conv[worst][0]:.3e} "
                f"(conv {worst}; bar 2e-2); the plain quantizer departs from the shared "
                f"activations in {n_flip} of {n_el} elements ({100 * n_flip / n_el:.4f}%, at "
                f"most {max(c[3] for c in per_conv)} steps), scales by at most "
                f"{max(c[4] for c in per_conv):.2e}; free-running alpha MAE {mae_free:.3e} "
                f"(printed only)")
            if not per_conv[worst][0] <= 2e-2:
                raise AssertionError(f"{label}: int8 conv {worst}'s input differs from the "
                                     f"kernels' path by {per_conv[worst][0]} > 2e-2 (relative)")
        del plain
        if any(k.launches for k in kernels):
            raise AssertionError(f"{label}: the plain run launched a hand kernel")
        mae_raw = float((alpha_raw.float() - alpha_plain_raw.float()).abs().mean())
        mae = float((alpha.float() - alpha_plain.float()).abs().mean())
        log(f"  [{label}] plain versions end to end: {t_plain:.4f} s (first call); alpha "
            f"MAE vs kernels before mask_refine {mae_raw:.3e} (bar 1e-2"
            f"{'; int8 activations shared' if n_shared else ''}), after it {mae:.3e}"
            f"{' (free-running)' if n_shared else ''}")
        if not mae_raw <= 1e-2:
            raise AssertionError(f"{label}: alpha MAE {mae_raw} between kernels and plain "
                                 f"versions (before mask_refine) > 1e-2")
        torch.cuda.empty_cache()
        return launches, median, peak, alpha_raw

    @contextlib.contextmanager
    def int8_activations(self, shared, *, replay):
        """Record each int8 conv's input and quantized activation on a path
        into ``shared``, or (``replay``) hand the recorded activations out
        again in call order, yielding per conv: mean |input - recorded
        input| / mean |recorded input|, elements where the path's own
        quantizer differs, elements, largest difference in steps, and the
        relative scale difference."""
        from sdmatte_tpu_torch.ops import quant
        torch = self.torch
        own, stats = quant.quantize_act_int8, []

        def record(x):
            q, s = own(x)
            shared.append((x, q, s))
            return q, s

        def replay_fn(x):
            q, s = own(x)
            ref_x, ref_q, ref_s = shared.pop(0)
            rel = float((x.float() - ref_x.float()).abs().mean() / ref_x.float().abs().mean())
            d = (q.to(torch.int16) - ref_q.to(torch.int16)).abs()
            stats.append((rel, int((d != 0).sum()), d.numel(), int(d.max()),
                          float((s - ref_s).abs() / ref_s)))
            return ref_q, ref_s

        quant.quantize_act_int8 = replay_fn if replay else record
        try:
            yield stats
        finally:
            quant.quantize_act_int8 = own

    def profile(self, pipe, inputs):
        """Device time of one warm matte by kernel (torch.profiler)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        img, tri, opts = inputs
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe(img, tri, options=opts)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted(((ev.self_device_time_total / 1e3, ev.count, ev.key)
                       for ev in prof.key_averages()
                       if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                      reverse=True)
        busy = sum(r[0] for r in rows)
        groups = {}
        for ms, n, key in rows:
            k = key.lower()
            group = ("hand kernels" if "flash_fwd" in k or "conv3x3_sm90" in k
                     or "conv3x3_f32" in k or "conv3x3_i8" in k
                     else "cuDNN conv" if "fprop" in k or "conv" in k
                     else "GEMM" if "gemm" in k or "cutlass" in k
                     else "reductions" if "reduce" in k
                     else "copies and casts" if "copy" in k or "memcpy" in k
                     else "other elementwise and misc")
            g = groups.setdefault(group, [0.0, 0])
            g[0] += ms
            g[1] += n
        log(f"  profiled matte: wall {wall_ms:.2f} ms (profiler on), device busy "
            f"{busy:.2f} ms, idle share {100 * (1 - busy / wall_ms):.1f}%")
        for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            log(f"    {group:28s} {ms:9.3f} ms  {n:5d} launches")
        for ms, n, key in rows[:25]:
            log(f"    {ms:9.3f} ms  x{n:<5d} {key[:110]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on the card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "sdmatte_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repo (sdmatte_tpu_torch/ "
              "is missing beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    t_start = time.perf_counter()

    log("== 1. device")
    smi = nvidia_smi()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for cuDNN convs and cuBLAS matmuls: fp32 references run in full fp32")

    log("== 2. build")
    from sdmatte_tpu_torch.ops import _build
    from sdmatte_tpu_torch.ops.conv3x3 import K3, K4
    from sdmatte_tpu_torch.ops.flash_attention import K1, K2
    t0 = time.perf_counter()
    report = _build.build()
    log(f"  built in {time.perf_counter() - t0:.1f} s: "
        f"{ {k: round(v['seconds'], 1) for k, v in report.items()} }")
    build_faults = []
    for name, r in report.items():
        lines = r["log"].splitlines()
        spills, func = {}, ""
        for ln in lines:
            if "Function properties for" in ln:
                func = ln.split("Function properties for")[1].strip()
            elif "spill" in ln and " 0 bytes spill" not in ln:
                spills[func] = ln.strip()
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines if "Used " in ln]
        serial = [ln for ln in lines if "wgmma.mma_async instructions are serialized" in ln]
        log(f"  {name}: registers per instantiation {regs}; spilling functions {len(spills)}; "
            f"wgmma serialization warnings {len(serial)}")
        for func, ln in spills.items():
            log(f"    spill in {short_name(func)}: {ln[:200]}")
        for ln in serial:
            log(f"    {ln.strip()[:240]}")
        sass = sass_counts(_build.library_path(name))
        for func, ops in sass.items():
            log(f"    SASS {short_name(func):44s} "
                + "  ".join(f"{op} {n}" for op, n in ops.items()))
        for key, needed in SASS_REQUIRED[name].items():
            mine = {f: ops for f, ops in sass.items() if key in f}
            if not mine:
                build_faults.append(f"{name}: no kernel function named {key}")
            for func, ops in mine.items():
                missing = [op for op in needed if not ops[op]]
                if missing or func in spills:
                    build_faults.append(
                        f"{short_name(func)}: " + (f"no {'/'.join(missing)} in its SASS" if missing
                                                   else "spills"))
        if serial:
            build_faults.append(f"{name}: ptxas serializes wgmma instructions")
    for fault in build_faults:
        log(f"  BUILD FAULT {fault}")

    smoke = Smoke(torch)
    smoke.profile_on = "--profile" in sys.argv[1:]
    log("== 3. kernels against their plain versions")
    smoke.check_attention()
    smoke.check_conv()
    smoke.check_csplit()
    smoke.check_int8_conv()

    log("== 4. timing (CUDA events, warm, median)")
    rows = smoke.time_kernels()

    log("== 5. end to end: full width, bf16, 1024 px (with --profile, a profile of one "
        "more warm matte follows the default and vae_int8 paths' timings)")
    n_int8 = sum(n for *_, n in INT8_SHAPES)
    paths = {
        "default": ({K1.name: 32, K2.name: 2, K3.name: 11, K4.name: 0}, {}),
        "vae_int8": ({K1.name: 32, K2.name: 2, K3.name: 0, K4.name: n_int8},
                     {"vae_int8": True}),
        "int8 storage": ({K1.name: 32, K2.name: 2, K3.name: 11, K4.name: 0},
                         {"weight_storage": "int8"}),
    }
    results = {}
    for label, (predicted, kw) in paths.items():
        smoke.profile_on = "--profile" in sys.argv[1:] and label != "int8 storage"
        results[label] = smoke.matte(label, predicted, **kw)
    base = results["default"]
    for label, (_, median, peak, alpha_raw) in results.items():
        mae = float((alpha_raw.float() - base[3].float()).abs().mean())
        log(f"  {label:14s} warm median {median:.4f} s (default {base[1]:.4f} s), peak "
            f"{peak:.2f} GiB (default {base[2]:.2f} GiB); alpha MAE vs the default bf16 "
            f"matte before mask_refine {mae:.3e} (printed only: random weights)")

    record = []
    for kern, path, rate in ((K1, "default", BF16_FLOPS), (K2, "default", BF16_FLOPS),
                             (K3, "default", BF16_FLOPS), (K4, "vae_int8", INT8_OPS)):
        mine = [(n, t) for name, _, _, n, t in rows if name == kern.name]
        per_matte = {key: sum(n * t[key] for n, t in mine)
                     for key in ("ms", "plain_ms", "library_ms", "flops", "bytes")}
        bound_ms, bound_by = bound(per_matte["flops"], per_matte["bytes"], rate)
        record.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": results[path][0][kern.name],
            "max_abs_err": smoke.err[kern.name],
            "ms": per_matte["ms"], "plain_ms": per_matte["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": per_matte["library_ms"],
        })
    k1 = [(n, t) for name, _, _, n, t in rows if name == K1.name]
    log(f"  per matte: K1 MUFU bound (1 exp2 per score at 16/clk/SM) "
        f"{sum(n * t['mufu_ms'] for n, t in k1):.4f} ms beside its tensor bound "
        f"{sum(n * t['flops'] for n, t in k1) / BF16_FLOPS * 1e3:.4f} ms")
    log(f"(times in the kernels record are per matte: each shape's median times its "
        f"launches on its path, the default matte's for K1-K3 and the vae_int8 "
        f"matte's for K4; total run {time.perf_counter() - t_start:.1f} s)")
    if build_faults:
        raise AssertionError("; ".join(build_faults))
    print(smi, flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
