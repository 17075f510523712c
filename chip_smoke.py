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
     csrc/conv3x3_i8.cu it is routed to is printed; K1's relative-position
     mode at a 12 MP ViTMatte-B matte's shapes (RELPOS_SHAPES)
  4. time each kernel, its plain version and the one PyTorch call that
     computes the same function (a yardstick the port never calls), beside
     the least time the card could take (bytes at 3.35 TB/s, or operations
     at 989 TFLOP/s bf16 or 1,979 TOP/s int8, whichever is larger); for K1
     also the exp2 (MUFU) bound.  K1's relative-position mode beside SDPA
     with the bias formed in bf16 where it fits (the windows; at the global
     shapes it would take 110 GB)
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
  6. the entry points at full width (SDMatteConfig(), depth not cut, bf16,
     1024 px), each step raising on failure: (a) the seeded model written by
     the port's safetensors writer as bf16 under the legacy VAE attention
     names and a "module." prefix, beside an SD2.1-base config directory;
     (b) the ComfyUI node loading it (nothing missing, unexpected or
     mismatched; every weight bit-equal to the written model's) and matting
     the photo and trimap read back from 8-bit PNGs, against a direct
     pipeline call; (c) the HTTP server with its worker thread warmed as
     ``--warmup`` does (a worker that was not is timed first), four
     concurrent requests served as one batch-4 pipeline call and one of
     another size as its own, each alpha PNG against its direct call; (d) the CLI in a subprocess on the
     checkpoint, against (b)'s alpha; (e) the [T, F, T] text gating (the mid
     stage's cross-attention onto 77 text tokens, K1 at Lk = 77) with a
     synthetic tokenizer, against its plain versions.  Launch counts are
     asserted on every step
  7. the other paths of the meta-architecture at full width (bf16, 1024 px,
     one pipeline on the seeded weights and variants of it on the same
     model), each step asserting its launch counts and printing its warm
     time and peak memory: K1, K2 and K3 at the shapes these paths add
     (batch 9, 64^2 latents, the 512 px encoder); (a) a point prompt (two
     clicks, N = 4) against the plain versions; (b) nine images through the
     node at batch 9 (the split encode), each against the plain versions run
     alone with vae_encode_split=True, and a point_mask request over HTTP
     against (a); (c) vae_chunk=2 at batch 4 against the unchunked call;
     (d) speed_mode "fastest" against its plain versions, beside the
     default; (e) the parity pack on a 2.59 GB bf16 checkpoint under plain
     key names at --size 512 (every stage OK), then its stage-4 fp32 forward
     on the plain versions (alpha MAE <= 1e-4).  Alphas are held before
     mask_refine at MAE <= 1e-2
  8. training, video and the process group at full width (seeded random
     weights): (a) the fine-tune at the JAX example's full-size line
     (parallel/train.train_loop: 512 px, batch 4, remat, EMA 0.999, FP32,
     VAE and text towers frozen, 4 steps), every loss finite, the frozen
     towers bit-identical, the U-Net changed, no optimizer state for frozen
     parameters, no hand kernel launched; median step time and peak memory;
     (b) remat on and off at batch 1: the same loss (rtol 1e-6) and
     gradients (atol 1e-5, rtol 1e-4); (c) one step of the tiny config on
     the card against the CPU; (d) a backward through K1, K2, K3, K4 and the
     channel-split wrapper raises; (e) an 8-frame 1024 px bf16 clip through
     matte_video (K1 32, K2 2, K3 0; alone, K3 11), each frame against the
     frame matted alone and against the plain versions (MAE <= 1e-2); (f)
     NCCL at world size 1 in this process: the data-parallel step equals the
     plain step and matte_video through a mesh of 1 the call without one
  9. (run after phase 7, while its work directory exists) the ComfyUI host
     path at full width (SDMatteConfig(), bf16) on phase 6's checkpoint,
     under the bundled workflow's checkpoint name: (a) in a subprocess, the
     package loaded as ComfyUI loads a custom node (its __init__.py under a
     foreign module name, stub folder_paths and comfy.model_management on
     the card): the registered class must be the port's SDMatteApply, no
     module of jax or sdmatte_tpu loaded, and the bundled workflow (1024 px,
     matted_rgba, mask_refine) runs through workflow.execute_workflow on it;
     (b) the bundled workflow in this process on a warmed worker thread
     under inference mode, as ComfyUI's prompt worker runs nodes: K1 32, K2
     2, K3 11; the node's alpha against a direct pipeline call (MAE <=
     1e-2), the SaveImage PNG against the matted tensor (within 1/255), the
     alpha PNG against (a)'s; (c) a graph shaped like the reference's
     production workflow (LoadImage, the SegmentAnything stand-in, four
     SDMatteApply nodes at 1024 px matted_rgba and matted_rgb, 768 and 512
     px alpha_only, eight MaskPreview+, one SaveImage): one pipeline in the
     node cache throughout, one checkpoint load in (b) and (c), each node's
     launches, each alpha against its direct call (MAE <= 1e-2), warm s per
     graph and its peak beside one matte's; (d) python -m
     sdmatte_tpu_torch.workflow --random-weights in a subprocess: exit 0,
     the PNGs, K1 32, K2 2, K3 11, the alpha against (b)'s (the seeded
     weights are the checkpoint's), its wall beside a bare process
 10. (run after phase 9, before phase 8) ViTMatte-B (ViTMatteConfig(), 12
     blocks, nothing cut) on a 4032 x 3024 photo through ViTMattePipeline
     and its CUDA graphs: 12 K1 launches a matte, all in the
     relative-position mode, counted from zero after the warm call; warm
     time, peak memory, the card's reserved memory before and after, and
     the alpha before mask_refine against the plain versions (MAE <= 1e-2)
Phases 3-7, 9 and 10 run under torch.inference_mode(); phase 8 trains, so it does not.
After phase 7, K1 and SDPA at the text path's shapes by device time
(torch.profiler), where an event pair would time the host's work.
With --profile, one more warm matte of each phase-5 path runs under
torch.profiler and the device time per kernel name, the device's busy
share and the top kernels are printed.  The last two lines are the
per-kernel JSON record and the device record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
# K1 on the text path: the U-Net cross-attention onto the 77 text tokens,
# unbiased.  Under the [T, F, T] gating of phase 6 (e) it is the mid stage (16^2
# latent tokens, 1280 channels, 20 heads): one launch per matte.  A gating
# with a False down stage would run the 128^2 stage's (5 heads) instead.
TEXT_ATTN_SHAPES = [   # (label, (B, H, Lq, Lk, D), biased, launches on (e))
    ("text cross 16^2 x 77", (1, 20, 256, 77, 64), False, 1),
    ("text cross 128^2 x 77", (1, 5, 16384, 77, 64), False, 0),
]
# K1's relative-position mode on a 12 MP ViTMatte-B matte (ViTMatteConfig(),
# 4032 x 3024 padded to 4032 x 3040: a 190 x 252 token grid, 252 x 190 for the
# portrait photo): the four global blocks over the whole grid, the eight
# windowed blocks each over all 252 of its 14 x 14 windows at once (190 -> 196
# padded), read from models/vitmatte.py
RELPOS_SHAPES = [   # (label, (B, H, kh, kw), launches on a landscape matte)
    ("global 190x252", (1, 12, 190, 252), 4),
    ("global 252x190", (1, 12, 252, 190), 0),   # the portrait photo's
    ("windows 14x14", (252, 12, 14, 14), 8),
]
VITMATTE_HW = (3024, 4032)
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
# none of them may spill.  These are the main paths' instantiations: K1 (and
# its relative-position mode, ViTMatte's), K2 (bf16 d = 512), K3, and K4 at
# stride 1 (Cin a multiple of 16; and Cin 3 and 4 with the taps folded into
# K, which gathers its rows without TMA).
SASS_REQUIRED = {
    "flash_attention": {"flash_fwd_sm90": ("HGMMA", "UTMALDG"),
                        "flash_fwd_relpos_sm90": ("HGMMA", "UTMALDG"),
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


def device_ms(torch, fn, reps=10):
    """Device time per call: the CUDA kernel time that torch.profiler records
    for ``reps`` calls, over ``reps``.  Unlike an event pair around one call,
    it leaves out the host's work for the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e3 / reps


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

    def relpos_inputs(self, shape):
        """q, k, v sliced from one (B, L, 3, H, 64) bf16 tensor, as ViTMatte's
        are, and bf16 terms Rh, Rw as ops/attention.relpos_terms makes them,
        from tables scaled to give terms of the scores' own scale."""
        from sdmatte_tpu_torch.ops.attention import relpos_terms
        b, h, kh, kw = shape
        n, d = kh * kw, 64
        qkv = self.randn(b, n, 3, h, d, dtype=self.torch.bfloat16)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        rel = relpos_terms(q, self.randn(kh, kh, d) / 8, self.randn(kw, kw, d) / 8)
        return q, k, v, rel, d ** -0.5

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
            *[("flash_attention_k1", f"{prec}{label}", shape, biased, dtype, tol)
              for label, shape, biased, _ in TEXT_ATTN_SHAPES
              for prec, dtype, tol in (("", torch.bfloat16, "attn_bf16"),
                                       ("fp32 ", torch.float32, "attn_fp32"))],
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
        for label, shape, _ in RELPOS_SHAPES:
            q, k, v, rel, scale = self.relpos_inputs(shape)
            got = flash_attention(q, k, v, scale=scale, rel=rel)
            torch.cuda.synchronize()
            ref = attention_plain(q, k, v, scale=scale, rel=rel)
            self.check("flash_attention_k1 relpos", f"{label} {tuple(shape)}", got, ref,
                       "attn_bf16")
            del q, k, v, rel, got, ref
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

        def time_attention(shape, biased):
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
            return t

        for name, shapes in ATTN_SHAPES.items():
            for label, shape, biased, launches in shapes:
                rows.append((name, label, shape, launches, time_attention(shape, biased)))
        # the text path's shapes, printed beside the others; the kernels record
        # holds the default matte's launches, which do not include them
        text_rows = [("flash_attention_k1", label, shape, launches, time_attention(shape, biased))
                     for label, shape, biased, launches in TEXT_ATTN_SHAPES]
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
        self.relpos_rows = [("flash_attention_k1 relpos", label, shape, launches,
                             self.time_relpos(shape)) for label, shape, launches in RELPOS_SHAPES]
        for name, label, shape, launches, t in rows + text_rows:
            extra = "".join(f"  {key} {t[key]:.4f}" for key in ("mufu_ms", "cudnn_bf16_ms")
                            if key in t) + (f"  [{t['route']}]" if "route" in t else "")
            log(f"  time {name:20s} {label:24s} {str(shape):32s} x{launches}  "
                f"kernel_ms {t['ms']:.4f}  plain_ms {t['plain_ms']:.4f}  "
                f"library_ms {t['library_ms']:.4f}  bound_ms {t['bound_ms']:.4f} "
                f"({t['bound_by']}){extra}")
        for name, label, shape, launches, t in self.relpos_rows:
            library = ("null (" + t["library_note"] + ")" if t["library_ms"] is None
                       else f"{t['library_ms']:.4f}")
            log(f"  time {name:26s} {label:16s} {str(shape):20s} x{launches}  "
                f"kernel_ms {t['ms']:.4f}  plain_ms {t['plain_ms']:.4f}  library_ms {library}  "
                f"bound_ms {t['bound_ms']:.4f} ({t['bound_by']})  mufu_ms {t['mufu_ms']:.4f}")
        return rows

    def time_relpos(self, shape):
        """K1's relative-position mode at one shape.  Its operations are the
        QK and PV products; its bytes q, k, v, o and the two terms in bf16,
        each read once.  The yardstick is SDPA with the bias formed whole in
        bf16 ((B, H, Lq, Lk)), where it fits on the card."""
        import torch.nn.functional as tF
        from sdmatte_tpu_torch.ops.flash_attention import attention_plain, flash_attention
        torch = self.torch
        b, h, kh, kw = shape
        n, d = kh * kw, 64
        q, k, v, rel, scale = self.relpos_inputs(shape)
        t = {"ms": median_ms(torch, lambda: flash_attention(q, k, v, scale=scale, rel=rel)),
             "plain_ms": median_ms(torch, lambda: attention_plain(q, k, v, scale=scale, rel=rel),
                                   reps=1, warm=1)}
        bias_bytes = 2 * b * h * n * n
        if bias_bytes <= 8 << 30:
            key = torch.arange(n, device=self.dev)
            bias = (rel.rh.view(b, h, n, kh)[..., key // kw]
                    + rel.rw.view(b, h, n, kw)[..., key % kw]).to(torch.bfloat16)
            t["library_ms"] = median_ms(torch, lambda: tF.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=scale))
            del bias
        else:
            t["library_ms"] = None
            t["library_note"] = (f"SDPA's bias alone would take {bias_bytes / 1e9:.0f} GB "
                                 f"in bf16")
        flops = 4 * b * h * n * n * d
        nbytes = 2 * b * h * 4 * n * d + 2 * b * h * n * (kh + kw)
        t["flops"], t["bytes"] = flops, nbytes
        t["bound_ms"], t["bound_by"] = bound(flops, nbytes)
        t["mufu_ms"] = b * h * n * n / MUFU_EX2_PER_S * 1e3
        del q, k, v, rel
        torch.cuda.empty_cache()
        return t

    def text_device_times(self):
        """K1 and SDPA at the text path's shapes by device time: at these
        sizes an event pair around one call mostly times the host's work for
        it.  Run after the timed mattes, so that no profiler session precedes
        them in this process."""
        import torch.nn.functional as tF
        from sdmatte_tpu_torch.ops.flash_attention import flash_attention
        torch = self.torch
        for label, shape, _, _ in TEXT_ATTN_SHAPES:
            q, k, v, _, scale = self.attn_inputs(shape, False, torch.bfloat16)
            kernel = device_ms(torch, lambda: flash_attention(q, k, v, scale=scale))
            library = device_ms(torch, lambda: tF.scaled_dot_product_attention(q, k, v,
                                                                               scale=scale))
            log(f"  device time flash_attention_k1 {label:24s} {str(shape):28s} kernel_ms "
                f"{kernel:.4f}  library_ms {library:.4f} (torch.profiler, mean of 10 calls)")

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
        n = (sum(p.numel() for p in model.parameters()),
             sum(p.numel() for p in model.text_encoder.parameters()))
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
        log(f"  [{label}] model: {n_params[0] / 1e6:.1f} M params ("
            f"{(n_params[0] - n_params[1]) / 1e6:.1f} M without the text tower, which this "
            f"path does not run), seeded random weights, "
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
        # the int8 activations are recorded and handed back by the model's own
        # Python, which a replayed heavy-step graph does not run: these calls,
        # and the plain pipeline's, run eagerly
        pipe._graphs.engaged = lambda: False
        with self.int8_activations(shared, replay=False):  # records only on the int8 path
            alpha_raw, _ = pipe(img, tri, options=raw_opts)
        del pipe
        plain, _ = self.pipeline(impl="plain", **kw)
        plain._graphs.engaged = lambda: False
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

    def vitmatte_pipeline(self, **kw):
        """ViTMatte-B (ViTMatteConfig(): 12 blocks of 768, nothing cut) on
        seeded weights in a bf16 ViTMattePipeline, made anew."""
        torch = self.torch
        from sdmatte_tpu_torch.configs import ViTMatteConfig
        from sdmatte_tpu_torch.core.dtypes import BF16
        from sdmatte_tpu_torch.models.init import init_random_
        from sdmatte_tpu_torch.models.vitmatte import ViTMatte
        from sdmatte_tpu_torch.pipeline.vitmatte import ViTMattePipeline
        with torch.device("meta"):
            model = ViTMatte(ViTMatteConfig())
        init_random_(model, seed=0, device=self.dev)
        n = sum(p.numel() for p in model.parameters())
        return ViTMattePipeline(model, policy=BF16, device=self.dev, **kw), n

    def vitmatte_matte(self):
        """A 12 MP photo (4032 x 3024) through ViTMatte-B end to end: K1's
        launches of one matte, counted from zero after the warm call, must be
        12, all in the relative-position mode; warm time, peak memory, and
        the alpha before mask_refine against the same call on the plain
        versions (MAE <= 1e-2).  Returns (launches, median s, peak GiB)."""
        import numpy as np
        torch = self.torch
        from sdmatte_tpu_torch.ops._build import Kernel
        from sdmatte_tpu_torch.ops.flash_attention import K1
        from sdmatte_tpu_torch.pipeline.vitmatte import ViTMatteOptions
        from sdmatte_tpu_torch.utils.observability import METRICS
        label = "vitmatte 12 MP"
        h, w = VITMATTE_HW
        rng = np.random.default_rng(1)
        yy, xx = np.mgrid[0:h, 0:w]
        r = np.sqrt(((yy - 0.5 * h) / h) ** 2 + ((xx - 0.45 * w) / w) ** 2)
        img = np.stack([0.2 + 0.6 * (r < 0.3), 0.3 + 0.4 * yy / h, 0.5 + 0.3 * xx / w], -1)
        img = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)
        tri = np.where(r < 0.25, 1.0, np.where(r < 0.35, 0.5, 0.0)).astype(np.float32)
        opts = ViTMatteOptions()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved() / 2 ** 30
        t0 = time.perf_counter()
        pipe, n_params = self.vitmatte_pipeline()
        torch.cuda.synchronize()
        log(f"  [{label}] model: {n_params / 1e6:.1f} M params, seeded random weights, bf16, "
            f"photo {w} x {h}, ready in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        pipe(img, tri, options=opts)          # warm: the graphs' capture
        torch.cuda.synchronize()
        log(f"  [{label}] first call (eager, then captured) {time.perf_counter() - t0:.2f} s")
        for k in Kernel.registry:
            k.launches = 0
        relpos0 = METRICS.counters.get("attention.relpos_launches", 0)
        predicted = {k.name: (12 if k is K1 else 0) for k in Kernel.registry}
        torch.cuda.reset_peak_memory_stats()
        times = []
        t0 = time.perf_counter()
        alpha, _ = pipe(img, tri, options=opts)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = {k.name: k.launches for k in Kernel.registry}
        relpos = METRICS.counters.get("attention.relpos_launches", 0) - relpos0
        log(f"  [{label}] launches per matte: {launches} (relative-position mode {relpos})  "
            f"predicted: {predicted} (all 12 K1 in that mode)")
        if launches != predicted or relpos != 12:
            raise AssertionError(f"{label}: the launch counts differ from the prediction")
        for _ in range(2):
            t0 = time.perf_counter()
            pipe(img, tri, options=opts)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        reserved = torch.cuda.memory_reserved() / 2 ** 30
        a = alpha.float()
        if a.shape != (1, h, w) or not bool(torch.isfinite(a).all()) or a.min() < 0 \
                or a.max() > 1:
            raise AssertionError(f"{label}: alpha is not a finite (1, {h}, {w}) map in [0, 1]")
        median = statistics.median(times)
        log(f"  [{label}] warm seconds per matte (host clock, synchronized): "
            f"{[round(t, 4) for t in times]}  median {median:.4f}  peak allocated {peak:.2f} GiB "
            f"(outside the graphs' pool), reserved {reserved:.2f} GiB (the pool included)")
        raw_opts = dataclasses.replace(opts, mask_refine=False)
        alpha_raw, _ = pipe(img, tri, options=raw_opts)
        del pipe
        plain, _ = self.vitmatte_pipeline(impl="plain")
        plain._graphs.engaged = lambda: False
        for k in Kernel.registry:
            k.launches = 0
        t0 = time.perf_counter()
        alpha_plain_raw, _ = plain(img, tri, options=raw_opts)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        del plain
        if any(k.launches for k in Kernel.registry):
            raise AssertionError(f"{label}: the plain run launched a hand kernel")
        mae = float((alpha_raw.float() - alpha_plain_raw.float()).abs().mean())
        log(f"  [{label}] plain versions end to end: {t_plain:.4f} s (eager); alpha MAE vs "
            f"kernels before mask_refine {mae:.3e} (bar 1e-2)")
        if not mae <= 1e-2:
            raise AssertionError(f"{label}: alpha MAE {mae} between kernels and plain versions "
                                 f"(before mask_refine) > 1e-2")
        torch.cuda.empty_cache()
        log(f"  [{label}] reserved {reserved0:.2f} GiB before the pipelines, "
            f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB after them")
        return launches, median, peak

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


def legacy_name(key: str) -> str:
    """``module.`` + the key, with the VAE mid-block attention under its legacy
    diffusers names (query/key/value/proj_attn), as old exports wrote them."""
    if key.startswith("vae."):
        for new, old in ((".attentions.0.to_q.", ".attentions.0.query."),
                         (".attentions.0.to_k.", ".attentions.0.key."),
                         (".attentions.0.to_v.", ".attentions.0.value."),
                         (".attentions.0.to_out.0.", ".attentions.0.proj_attn.")):
            key = key.replace(new, old)
    return "module." + key


def write_tokenizer(d: str, caption: str) -> str:
    """A synthetic CLIP vocab and merges (no tokenizer file is in the repo):
    every byte-level character alone and word-final, the merges that spell
    the caption's words, and the special tokens at their SD2.1 ids."""
    from sdmatte_tpu_torch.models.tokenizer import _bytes_to_unicode
    os.makedirs(d, exist_ok=True)
    vocab = {}
    for ch in _bytes_to_unicode().values():
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    merges = ["#version: 0.2"]
    for w in caption.lower().split():
        for i in range(1, len(w)):
            pair = (w[:i], w[i] + ("</w>" if i == len(w) - 1 else ""))
            vocab.setdefault(pair[0] + pair[1], len(vocab))
            if " ".join(pair) not in merges:
                merges.append(" ".join(pair))
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 49406, 49407
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("\n".join(merges) + "\n")
    return d


class EntryPoints:
    """Phase 6: the node, the server and the CLI on a checkpoint written at
    full width, and the text path.  Each step raises on failure."""

    CAPTION = "a photo of a cat"

    def __init__(self, smoke, workdir: str, root: str):
        from sdmatte_tpu_torch.ops._build import Kernel
        self.smoke, self.torch, self.dev = smoke, smoke.torch, smoke.dev
        self.dir, self.root = workdir, root
        self.kernels = Kernel.registry
        self.ckpt = os.path.join(workdir, "SDMatte", "SDMatte.safetensors")
        self.cfg_dir = os.path.join(workdir, "diffusers", "stable-diffusion-2-1-base")
        self.numbers = {}

    def zero_counts(self):
        for k in self.kernels:
            k.launches = 0

    def expect(self, label, predicted, got=None):
        got = got if got is not None else {k.name: k.launches for k in self.kernels}
        log(f"  [{label}] launches: {got}  predicted: {predicted}")
        if got != predicted:
            raise AssertionError(f"{label}: the launch counts differ from the prediction")

    def step(self, name, fn):
        t0 = time.perf_counter()
        fn()
        self.torch.cuda.synchronize()
        log(f"  step {name}: {time.perf_counter() - t0:.1f} s")

    # -- (a) -------------------------------------------------------------
    def checkpoint(self):
        torch = self.torch
        from sdmatte_tpu_torch.checkpoint import load_sdmatte_checkpoint, save_checkpoint
        from sdmatte_tpu_torch.configs import SDMatteConfig, save_pretrained_dir
        from sdmatte_tpu_torch.models.init import init_random_
        from sdmatte_tpu_torch.models.sdmatte import SDMatte
        with torch.device("meta"):
            model = SDMatte(SDMatteConfig())
        init_random_(model, seed=0, device=self.dev)
        model.to(torch.bfloat16)
        n = sum(p.numel() for p in model.parameters())
        n_text = sum(p.numel() for p in model.text_encoder.parameters())
        os.makedirs(os.path.dirname(self.ckpt))
        t0 = time.perf_counter()
        size = save_checkpoint(model, self.ckpt, dtype=torch.bfloat16, rename=legacy_name)
        t_write = time.perf_counter() - t0
        save_pretrained_dir(SDMatteConfig(), self.cfg_dir)
        log(f"  (a) model {n / 1e6:.1f} M params ({n_text / 1e6:.1f} M in the text tower, "
            f"{(n - n_text) / 1e6:.1f} M without it); checkpoint written as bf16 under "
            f"'module.' and the legacy VAE attention names: {size / 1e9:.3f} GB in "
            f"{t_write:.2f} s ({size / 1e9 / t_write:.2f} GB/s, card to file)")
        # the loader alone, into a bf16 model on the card
        with torch.device("meta"):
            fresh = SDMatte(SDMatteConfig()).to(torch.bfloat16)
        fresh.to_empty(device=self.dev)
        t0 = time.perf_counter()
        report = load_sdmatte_checkpoint(fresh, self.ckpt)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        log(f"  (a) loader: {report.summary()} ignored={len(report.ignored)} in {t_load:.2f} s "
            f"({size / 1e9 / t_load:.2f} GB/s, file in the page cache to the card)")
        if report.missing or report.unexpected or report.mismatched:
            raise AssertionError(f"(a) the loader's report is not clean: {report.summary()}")
        written = model.state_dict()
        bad = [k for k, v in fresh.state_dict().items() if not torch.equal(v, written[k])]
        if bad:
            raise AssertionError(f"(a) {len(bad)} loaded tensors differ from the written ones, "
                                 f"first {bad[0]}")
        self.numbers.update(write_s=t_write, load_s=t_load, gb=size / 1e9)
        self.model = model

    # -- (b) -------------------------------------------------------------
    def node(self):
        torch = self.torch
        from sdmatte_tpu_torch.api import comfy_shim
        from sdmatte_tpu_torch.api import node as node_mod
        from sdmatte_tpu_torch.assets import manager
        from sdmatte_tpu_torch.core.dtypes import BF16
        from sdmatte_tpu_torch.pipeline import MattingPipeline
        from sdmatte_tpu_torch.utils.images import load_unit_image, save_png

        def refuse(url, dst, progress=True):
            raise AssertionError(f"(b) tried to download {url}")

        manager._default_fetch = refuse
        comfy_shim.add_model_folder_path("SDMatte", os.path.dirname(self.ckpt))
        comfy_shim.add_model_folder_path("diffusers", os.path.dirname(self.cfg_dir))
        t0 = time.perf_counter()
        pipe = node_mod.get_pipeline("SDMatte.safetensors")
        torch.cuda.synchronize()
        t_ready = time.perf_counter() - t0
        rep = pipe.load_report
        log(f"  (b) node model ready in {t_ready:.2f} s: {rep.summary()} "
            f"ignored={len(rep.ignored)}")
        if rep.missing or rep.unexpected or rep.mismatched:
            raise AssertionError(f"(b) the node's load report is not clean: {rep.summary()}")
        if pipe.cfg != self.model.cfg:
            raise AssertionError("(b) the node's config, read from the config directory, is "
                                 "not the written model's")
        ours = pipe.model.state_dict()
        written = self.model.state_dict()
        bad = [k for k, v in written.items() if not torch.equal(ours[k], v)]
        if bad or len(ours) != len(written):
            raise AssertionError(f"(b) {len(bad)} of the node's weights differ from the "
                                 f"written model's")
        log(f"  (b) all {len(written)} tensors of the node's model equal the written model's "
            f"bit for bit")

        img, tri, self.opts = self.smoke.inputs()
        self.photo = os.path.join(self.dir, "photo.png")
        self.trimap = os.path.join(self.dir, "trimap.png")
        save_png(self.photo, img)
        save_png(self.trimap, tri)
        self.img = load_unit_image(self.photo, 3)
        self.tri = load_unit_image(self.trimap, 1)[..., 0]
        args = ("SDMatte.safetensors", torch.from_numpy(self.img)[None],
                torch.from_numpy(self.tri)[None], self.opts.inference_size, False,
                "alpha_only", True, 0.8)
        apply = node_mod.SDMatteApply().apply_matte
        self.zero_counts()
        t0 = time.perf_counter()
        alpha, matted = apply(*args)
        t_first = time.perf_counter() - t0
        self.expect("(b) node", self.predicted(k3=11))
        t0 = time.perf_counter()
        apply(*args)
        t_warm = time.perf_counter() - t0
        if not (alpha.device.type == "cpu" and alpha.dtype == torch.float32
                and alpha.is_contiguous() and tuple(alpha.shape) == (1,) + self.tri.shape
                and matted.device.type == "cpu"):
            raise AssertionError(f"(b) the node returned {alpha.dtype} {tuple(alpha.shape)} on "
                                 f"{alpha.device}")
        alpha.mul_(1.0)                      # the caller may write it
        self.direct = MattingPipeline(self.model, policy=BF16, device=self.dev)
        ref, _ = self.direct(self.img, self.tri, options=self.opts)
        diff = (alpha - ref.cpu()).abs()
        log(f"  (b) node apply_matte: first call {t_first:.4f} s, warm {t_warm:.4f} s; alpha "
            f"{tuple(alpha.shape)} fp32 on the CPU; against a direct MattingPipeline call on "
            f"the written weights: MAE {float(diff.mean()):.3e}, max {float(diff.max()):.3e} "
            f"(bar MAE 1e-2)")
        if not float(diff.mean()) <= 1e-2:
            raise AssertionError("(b) the node's alpha differs from the direct call")
        self.numbers.update(ready_s=t_ready, node_first_s=t_first, node_warm_s=t_warm)
        self.node_alpha = alpha
        self.pipe = pipe

    def predicted(self, *, k1=32, k2=2, k3=0, k4=0):
        from sdmatte_tpu_torch.ops.conv3x3 import K3, K4
        from sdmatte_tpu_torch.ops.flash_attention import K1, K2
        return {K1.name: k1, K2.name: k2, K3.name: k3, K4.name: k4}

    # -- (c) -------------------------------------------------------------
    def server(self):
        import base64
        import io
        import threading
        import urllib.request
        import numpy as np
        from sdmatte_tpu_torch.api import serve as serve_mod
        from sdmatte_tpu_torch.utils.images import to_uint8
        from sdmatte_tpu_torch.utils.observability import METRICS
        torch = self.torch
        opts = self.opts

        def png_b64(a):
            from sdmatte_tpu_torch.utils.images import save_png
            buf = io.BytesIO()
            save_png(buf, a)
            return base64.b64encode(buf.getvalue()).decode()

        def post(url, payload):
            req = urllib.request.Request(url + "/v1/matte", data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read())

        def check(label, body, img, tri):
            from PIL import Image
            got = np.asarray(Image.open(io.BytesIO(base64.b64decode(body["alpha"]))))
            ref, _ = self.direct(img, tri, options=opts)
            d = np.abs(got.astype(np.int16) - to_uint8(ref[0].cpu().numpy()).astype(np.int16))
            log(f"  (c) {label}: alpha {got.shape}, against its direct call (8-bit): MAE "
                f"{d.mean() / 255:.3e}, max {d.max()} steps (bar MAE 1e-2); server ms "
                f"{body['ms']}")
            if got.shape != tri.shape or not d.mean() / 255 <= 1e-2:
                raise AssertionError(f"(c) {label}: the served alpha differs from the direct call")

        # four different photos of one shape, the 8-bit PNG values as they are
        inputs = [(np.roll(self.img, 97 * i, axis=1), np.roll(self.tri, 97 * i, axis=1))
                  for i in range(4)]
        payloads = [{"image": png_b64(a), "trimap": png_b64(t),
                     "inference_size": opts.inference_size} for a, t in inputs]
        # a worker thread's first mattes when nothing warmed that thread
        cold = serve_mod.MicroBatcher(self.pipe, window_ms=0.0)
        try:
            t_cold = []
            for _ in range(2):
                t0 = time.perf_counter()
                cold.submit(self.img, self.tri, opts)
                t_cold.append(time.perf_counter() - t0)
        finally:
            cold.shutdown()
        log(f"  (c) a micro-batcher whose worker thread was not warmed: first matte "
            f"{t_cold[0]:.4f} s, second {t_cold[1]:.4f} s")
        # the server as `serve.main --warmup 1024 --max-batch 4` starts it: the
        # worker warms batch sizes 1 and 4 (the allocator's growth included)
        warmed = threading.Event()

        def warmup():
            self.pipe.warmup(sizes=(opts.inference_size,), batch_sizes=(1, 4))
            warmed.set()

        httpd = serve_mod.serve(self.pipe, port=0, host="127.0.0.1", window_ms=300.0,
                                warmup=warmup)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        batcher = httpd.service.batcher
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
            with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
                json.loads(r.read())
            log(f"  (c) GET /healthz {health}; GET /metrics ok")
            if health != {"status": "ok", "backend": "cuda",
                          "device": torch.cuda.get_device_name(0)}:
                raise AssertionError(f"(c) /healthz says {health}")
            if not warmed.wait(timeout=300):
                raise AssertionError("(c) the worker's warmup did not end")
            # two lone requests, timed without the coalescing window
            window, batcher.window_s = batcher.window_s, 0.0
            t_lone = []
            for i in range(2):
                t0 = time.perf_counter()
                body = post(url, payloads[0])
                t_lone.append(time.perf_counter() - t0)
                check(f"lone request {i + 1} (batch 1, no coalescing window, "
                      f"{t_lone[-1]:.4f} s)", body, *inputs[0])
            t_one = t_lone[-1]
            batcher.window_s = window
            results = [None] * 4

            def worker(i):
                results[i] = post(url, payloads[i])

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
            calls = batcher.batch_calls
            self.zero_counts()
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            t_four = time.perf_counter() - t0
            if any(r is None for r in results):
                raise AssertionError("(c) a request of the four did not complete")
            self.expect("(c) four requests", self.predicted(k3=0))
            sizes = list(METRICS.values["batch_size"])[-2:]
            log(f"  (c) four concurrent requests: {batcher.batch_calls - calls} pipeline "
                f"call(s), batch sizes of the last two calls {sizes}; {t_four:.4f} s for the "
                f"four, {t_four / 4:.4f} s per image (one request alone: {t_one:.4f} s)")
            if batcher.batch_calls - calls != 1 or sizes[-1] != 4.0:
                raise AssertionError("(c) the four requests were not served as one batch-4 call")
            for i, body in enumerate(results):
                check(f"request {i} of the four", body, *inputs[i])
            rows = 3 * self.tri.shape[0] // 4
            img, tri = self.img[:rows], self.tri[:rows]
            t0 = time.perf_counter()
            body = post(url, {"image": png_b64(img), "trimap": png_b64(tri),
                              "inference_size": opts.inference_size})
            t_other = time.perf_counter() - t0
            if batcher.batch_calls - calls != 2:
                raise AssertionError("(c) the request of another size did not take its own call")
            check(f"a {rows}x{tri.shape[1]} request in its own call ({t_other:.4f} s)", body,
                  img, tri)
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.shutdown()
            thread.join(timeout=30)
        self.numbers.update(cold_thread_first_s=t_cold[0], cold_thread_second_s=t_cold[1],
                            served_first_s=t_lone[0], served_one_s=t_one,
                            served_four_s=t_four)

    # -- (d) -------------------------------------------------------------
    def cli(self):
        import numpy as np
        from sdmatte_tpu_torch.utils.images import load_unit_image, to_uint8
        out = os.path.join(self.dir, "cli_alpha.png")
        env = dict(os.environ, SDMATTE_TPU_MODELS_DIR=self.dir)
        cmd = [sys.executable, "-m", "sdmatte_tpu_torch.cli", "--ckpt", self.ckpt,
               "--image", self.photo, "--trimap", self.trimap, "--out", out,
               "--size", str(self.opts.inference_size)]
        # what any process that touches the card pays: start, imports, the
        # CUDA context, exit
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import torch, sdmatte_tpu_torch.cli; "
                        "torch.zeros(1, device='cuda'); torch.cuda.synchronize()"],
                       cwd=self.root, env=env, check=True, timeout=300)
        bare = time.perf_counter() - t0
        log(f"  (d) a bare process (imports, CUDA context, exit): {bare:.2f} s")
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=self.root, env=env, capture_output=True, text=True,
                           timeout=600)
        wall = time.perf_counter() - t0
        lines = [ln for ln in r.stderr.splitlines() if ln.startswith(("[cli]", "[sdmatte"))]
        for ln in lines:
            log(f"  (d) {ln}")
        if r.returncode != 0:
            log(r.stderr[-4000:])
            raise AssertionError(f"(d) the CLI exited {r.returncode}")
        counts = [ln.split("hand-kernel launches: ", 1)[1] for ln in lines
                  if "hand-kernel launches" in ln]
        self.expect("(d) CLI process", self.predicted(k3=11), json.loads(counts[-1]))
        got = to_uint8(load_unit_image(out, 1)[..., 0]).astype(np.int16)
        ref = to_uint8(self.node_alpha[0].numpy()).astype(np.int16)
        mae = float(np.abs(got - ref).mean()) / 255
        log(f"  (d) python -m sdmatte_tpu_torch.cli: exit 0 in {wall:.2f} s (wall, process "
            f"start to exit); alpha PNG {got.shape} against (b)'s alpha: MAE {mae:.3e} "
            f"(bar 1/255 = {1 / 255:.3e})")
        if got.shape != self.tri.shape or not mae <= 1 / 255:
            raise AssertionError("(d) the CLI's alpha differs from the node's")
        self.numbers.update(cli_s=wall, bare_process_s=bare)

    # -- (e) -------------------------------------------------------------
    def text_path(self):
        torch = self.torch
        from sdmatte_tpu_torch.configs import SDMatteConfig
        from sdmatte_tpu_torch.core.dtypes import BF16
        from sdmatte_tpu_torch.models.init import init_random_
        from sdmatte_tpu_torch.models.sdmatte import SDMatte
        from sdmatte_tpu_torch.models.tokenizer import CLIPTokenizer
        from sdmatte_tpu_torch.pipeline import MattingPipeline
        tok = CLIPTokenizer.from_pretrained_dir(
            write_tokenizer(os.path.join(self.dir, "tokenizer"), self.CAPTION))
        ids = tok([self.CAPTION])[0]
        base = SDMatteConfig()
        cfg = dataclasses.replace(base, unet=dataclasses.replace(
            base.unet, use_encoder_hidden_states_list=(True, False, True),
            use_attention_mask_list=(True, False, True)))
        opts = dataclasses.replace(self.opts, mask_refine=False)

        def build(**kw):
            with torch.device("meta"):
                model = SDMatte(cfg)
            init_random_(model, seed=0, device=self.dev)
            return MattingPipeline(model, policy=BF16, device=self.dev, tokenizer=tok, **kw)

        pipe = build()
        self.zero_counts()
        alpha, _ = pipe(self.img, self.tri, options=opts, caption=[self.CAPTION])
        torch.cuda.synchronize()
        self.expect("(e) text gating [T, F, T]", self.predicted(k3=11))
        t0 = time.perf_counter()
        pipe(self.img, self.tri, options=opts, caption=[self.CAPTION])
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        del pipe
        plain = build(impl="plain")
        self.zero_counts()
        ref, _ = plain(self.img, self.tri, options=opts, caption=[self.CAPTION])
        torch.cuda.synchronize()
        if any(k.launches for k in self.kernels):
            raise AssertionError("(e) the plain run launched a hand kernel")
        del plain
        mae = float((alpha.float() - ref.float()).abs().mean())
        log(f"  (e) caption {self.CAPTION!r} -> {sum(i != tok.pad_token_id for i in ids)} "
            f"ids before padding; warm matte {t_warm:.4f} s; alpha before mask_refine against "
            f"the plain versions: MAE {mae:.3e} (bar 1e-2)")
        if not (torch.isfinite(alpha).all() and mae <= 1e-2):
            raise AssertionError(f"(e) the text path's alpha MAE {mae} > 1e-2")
        self.numbers.update(text_warm_s=t_warm)

    def run(self):
        self.step("(a) checkpoint", self.checkpoint)
        self.step("(b) node", self.node)
        self.step("(c) server", self.server)
        self.step("(d) CLI", self.cli)
        del self.pipe, self.direct, self.model
        from sdmatte_tpu_torch.api import node as node_mod
        node_mod._PIPELINE_CACHE.clear()
        self.torch.cuda.empty_cache()
        self.step("(e) text path", self.text_path)
        log(f"  phase 6 numbers: { {k: round(v, 4) for k, v in self.numbers.items()} }")


def point_mask(h: int, w: int, points, radius: float) -> "np.ndarray":
    """A point prompt's mask: a disk of ``radius`` px around each (x, y)
    click, the coords normalized to [0, 1]."""
    import numpy as np
    yy, xx = np.mgrid[0:h, 0:w]
    m = np.zeros((h, w), np.float32)
    for x, y in zip(points[0::2], points[1::2]):
        m[np.hypot(yy - y * h, xx - x * w) < radius] = 1.0
    return m


class MetaPaths(EntryPoints):
    """Phase 7: the paths of the meta-architecture that phases 5 and 6 do
    not run, at full width, bf16, 1024 px, on one pipeline with the seeded
    weights (and variants of it on the same model): a point prompt, batch 9
    (the split encode) through the node and a point request over HTTP,
    vae_chunk=2 at batch 4, the fastest speed mode, and the parity pack on a
    full-width checkpoint.  Every step asserts its launch counts and prints
    its warm time and peak memory; the kernels' alphas are held against the
    plain versions' (before mask_refine, MAE <= 1e-2)."""

    # two clicks (x1, y1, x2, y2, normalized): N = 4 coords, padded to 4,
    # 420 channels each (core/embeddings.point_coords_padding)
    POINTS = (0.45, 0.5, 0.55, 0.35)
    # The click disks' radius at 1024 px.  The mask biases self-attention at
    # 128^2 down to 16^2 (the nearest-resized mask); at radius 64 each click
    # keeps keys at every stage.  At radius 24 the 16^2 stage keeps one key,
    # so every query there reads that one key's value, and the random-weight
    # model amplifies bf16 rounding: the plain versions' own bf16 alpha lies
    # 1.48e-2 from fp32 (PERF.md), above the bf16 bar for any bf16
    # implementation.  That case is held in fp32 at the whole-model bar.
    POINT_RADIUS, SINGLE_KEY_RADIUS = 64, 24
    # (kernel, (B, H, Lq, Lk, D), biased, plain version per batch element)
    ATTN_SHAPES = [("flash_attention_k1", (9, 5, 16384, 16384, 64), True, True),
                   ("flash_attention_k2", (9, 1, 16384, 16384, 512), False, True),
                   ("flash_attention_k2", (2, 1, 4096, 4096, 512), False, False),
                   ("flash_attention_k2", (1, 1, 4096, 4096, 512), False, False)]
    # (label, (B, H, W, Cin, Cout), gn, residual)
    CONV_SHAPES = [("512 px enc 512^2 128->128 gn+res", (2, 512, 512, 128, 128), True, True),
                   ("512 px enc 256^2 256->256", (2, 256, 256, 256, 256), False, False)]

    def __init__(self, smoke, workdir: str, root: str):
        super().__init__(smoke, workdir, root)
        import numpy as np
        from sdmatte_tpu_torch.utils.images import to_uint8
        img, tri, opts = smoke.inputs()
        # the 8-bit values, so that a PNG round trip (the server) is exact
        self.img = to_uint8(img).astype(np.float32) / 255.0
        self.tri = to_uint8(tri).astype(np.float32) / 255.0
        self.pm = point_mask(*tri.shape, self.POINTS, self.POINT_RADIUS)
        self.raw = dataclasses.replace(opts, mask_refine=False)
        self.results = {}

    def variant(self, **kw):
        """A pipeline on the shared model (staged already: no copy)."""
        from sdmatte_tpu_torch.core.dtypes import BF16
        from sdmatte_tpu_torch.pipeline import MattingPipeline
        return MattingPipeline(self.pipe.model, policy=BF16, device=self.dev, **kw)

    def timed(self, label, predicted, fn, reps=3):
        """fn() once with the counts at 0 (asserted), then ``reps`` warm
        calls: (first result, median s, peak GiB).  The first call is warm
        too: every path here runs once before it is timed."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        out = fn()
        torch.cuda.synchronize()
        self.expect(label, predicted)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        median = statistics.median(times)
        log(f"  [{label}] warm s {[round(t, 4) for t in times]} median {median:.4f}, peak "
            f"memory {peak:.2f} GiB")
        self.results[label] = (median, peak)
        return out, median, peak

    def plain_alpha(self, fn):
        """fn() on the plain versions; no hand kernel may launch."""
        self.zero_counts()
        out = fn()
        self.torch.cuda.synchronize()
        if any(k.launches for k in self.kernels):
            raise AssertionError("a plain run launched a hand kernel")
        return out

    def hold(self, label, got, ref, bar=1e-2):
        mae = float((got.float() - ref.float()).abs().mean())
        log(f"  [{label}] alpha before mask_refine against the plain versions: MAE "
            f"{mae:.3e} (bar {bar:g})")
        if not mae <= bar:
            raise AssertionError(f"{label}: alpha MAE {mae} against the plain versions > {bar}")
        return mae

    # -- kernels -----------------------------------------------------------
    def new_shapes(self):
        """Each kernel at the shapes this phase gives it that phase 3 does not
        hold: K1 and K2 at batch 9 (the plain version per batch element, at
        the first and the last), K2 at the half-size encode and decode (64^2
        latents), K3 at the 512 px encoder's table shapes."""
        torch = self.torch
        from sdmatte_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
        from sdmatte_tpu_torch.ops.flash_attention import attention_plain, flash_attention
        smoke = self.smoke
        for name, shape, biased, per_item in self.ATTN_SHAPES:
            q, k, v, bias, scale = smoke.attn_inputs(shape, biased, torch.bfloat16)
            got = flash_attention(q, k, v, scale=scale, bias=bias)
            torch.cuda.synchronize()
            items = (0, shape[0] - 1) if per_item else (slice(None),)
            for i in items:
                sl = slice(i, i + 1) if per_item else i
                ref = attention_plain(q[sl], k[sl], v[sl], scale=scale,
                                      bias=None if bias is None else bias[sl])
                smoke.check(name, f"{shape} {'item ' + str(i) if per_item else ''}", got[sl],
                            ref, "attn_bf16")
                del ref
            del q, k, v, got
        for label, shape, gn, res in self.CONV_SHAPES:
            x, wt, b, affine, r = smoke.conv_inputs(shape, gn, res, torch.bfloat16)
            got = conv3x3(x, wt, b, affine=affine, residual=r)
            torch.cuda.synchronize()
            smoke.check("conv3x3", f"{label} {shape}", got,
                        conv3x3_plain(x, wt, b, affine=affine, residual=r), "conv_bf16")
            del x, got
        torch.cuda.empty_cache()

    # -- (a) -------------------------------------------------------------
    def point(self):
        import numpy as np
        from sdmatte_tpu_torch.core.embeddings import point_coords_padding
        opts = dataclasses.replace(self.raw, aux_input="point_mask")
        coords = np.asarray([self.POINTS], np.float32)
        padded, ch = point_coords_padding(coords.shape[1])
        log(f"  (a) point prompt: {coords.shape[1]} coords, padded to {padded}, {ch} channels "
            f"each; a {int(self.pm.sum())}-pixel point mask")
        alpha, _, _ = self.timed("(a) point prompt", self.predicted(k3=11), lambda: self.pipe(
            self.img, self.pm, options=opts, coords=coords)[0])
        plain = self.variant(impl="plain")
        ref = self.plain_alpha(lambda: plain(self.img, self.pm, options=opts, coords=coords)[0])
        self.hold("(a) point prompt", alpha, ref)
        base = self.pipe(self.img, self.tri, options=self.raw)[0]
        log(f"  (a) alpha mean {float(alpha.mean()):.4f}; MAE against the trimap matte "
            f"{float((alpha - base).abs().mean()):.3e} (printed only: random weights)")
        self.point_alpha = alpha
        self.point_fp32(opts, coords, plain)

    def point_fp32(self, opts, coords, plain):
        """Both radii in fp32, kernels against the plain versions at the
        whole-model bar (MAE <= 1e-4, tests/test_assembled_parity.py); the
        bf16 alphas of both paths are printed against fp32's."""
        torch = self.torch
        from sdmatte_tpu_torch.configs import SDMatteConfig
        from sdmatte_tpu_torch.core.dtypes import FP32
        from sdmatte_tpu_torch.models.init import init_random_
        from sdmatte_tpu_torch.models.sdmatte import SDMatte
        from sdmatte_tpu_torch.pipeline import MattingPipeline
        with torch.device("meta"):
            model = SDMatte(SDMatteConfig())
        init_random_(model, seed=0, device=self.dev)
        f32 = MattingPipeline(model, policy=FP32, device=self.dev)
        f32_plain = MattingPipeline(model, policy=FP32, device=self.dev, impl="plain")
        for radius in (self.POINT_RADIUS, self.SINGLE_KEY_RADIUS):
            pm = point_mask(*self.tri.shape, self.POINTS, radius)
            self.zero_counts()
            got = f32(self.img, pm, options=opts, coords=coords)[0]
            torch.cuda.synchronize()
            self.expect(f"(a) fp32, radius {radius}", self.predicted())
            ref = self.plain_alpha(lambda: f32_plain(self.img, pm, options=opts, coords=coords)[0])
            mae = float((got - ref).abs().mean())
            k = self.pipe(self.img, pm, options=opts, coords=coords)[0]
            p = plain(self.img, pm, options=opts, coords=coords)[0]
            log(f"  (a) radius {radius}, fp32: kernels against the plain versions MAE "
                f"{mae:.3e} (bar 1e-4); bf16 (printed only): kernels against plain "
                f"{float((k - p).abs().mean()):.3e}, kernels against fp32 "
                f"{float((k - ref).abs().mean()):.3e}, plain against fp32 "
                f"{float((p - ref).abs().mean()):.3e}")
            if not mae <= 1e-4:
                raise AssertionError(f"(a) fp32 point prompt at radius {radius}: MAE {mae} "
                                     f"between kernels and plain versions > 1e-4")
        del f32, f32_plain, model
        torch.cuda.empty_cache()

    # -- (b) -------------------------------------------------------------
    def batch9(self):
        import numpy as np
        torch = self.torch
        from sdmatte_tpu_torch.api import node as node_mod
        imgs = np.stack([np.roll(self.img, 97 * i, axis=1) for i in range(9)])
        tris = np.stack([np.roll(self.tri, 97 * i, axis=1) for i in range(9)])
        apply = node_mod.SDMatteApply().apply_matte
        args = ("SDMatte.safetensors", torch.from_numpy(imgs), torch.from_numpy(tris),
                self.raw.inference_size, False, "alpha_only", False, 0.8)
        t0 = time.perf_counter()
        node_mod.get_pipeline("SDMatte.safetensors")
        torch.cuda.synchronize()
        log(f"  (b) node model ready in {time.perf_counter() - t0:.2f} s (phase 6's checkpoint)")
        alpha, median, _ = self.timed("(b) node batch 9 (split encode)",
                                      self.predicted(k2=3), lambda: apply(*args)[0], reps=2)
        log(f"  (b) {median / 9:.4f} s per image at batch 9")
        if tuple(alpha.shape) != (9,) + self.tri.shape or not bool(torch.isfinite(alpha).all()):
            raise AssertionError(f"(b) the node returned {tuple(alpha.shape)}")
        # the plain path holds each image alone with the same split encode
        # (its (B, H, 16384, 16384) fp32 scores would need ~48 GiB at batch 9)
        plain = self.variant(impl="plain", vae_encode_split=True)
        maes = []
        for i in range(9):
            ref = self.plain_alpha(lambda: plain(imgs[i], tris[i], options=self.raw)[0])
            maes.append(float((alpha[i] - ref[0].cpu()).abs().mean()))
        log(f"  (b) each image against the plain versions alone (vae_encode_split=True): MAE "
            f"{[float(f'{m:.3e}') for m in maes]} (bar 1e-2)")
        if not max(maes) <= 1e-2:
            raise AssertionError(f"(b) a batch-9 alpha differs from its plain version by MAE "
                                 f"{max(maes)} > 1e-2")
        del plain
        node_mod._PIPELINE_CACHE.clear()
        torch.cuda.empty_cache()
        self.served_point()

    def served_point(self):
        import base64
        import io
        import threading
        import urllib.request
        import numpy as np
        from PIL import Image
        from sdmatte_tpu_torch.api import serve as serve_mod
        from sdmatte_tpu_torch.utils.images import save_png, to_uint8

        def png_b64(a):
            buf = io.BytesIO()
            save_png(buf, a)
            return base64.b64encode(buf.getvalue()).decode()

        payload = {"image": png_b64(self.img), "trimap": png_b64(self.pm),
                   "prompt_type": "point_mask", "coords": list(self.POINTS),
                   "mask_refine": False, "inference_size": self.raw.inference_size}
        httpd = serve_mod.serve(self.pipe, port=0, host="127.0.0.1", window_ms=0.0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/matte"
        try:
            self.zero_counts()
            t0 = time.perf_counter()
            req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                status, body = r.status, json.loads(r.read())
            t_req = time.perf_counter() - t0
            self.expect("(b) served point_mask request", self.predicted(k3=11))
        finally:
            httpd.shutdown()
            httpd.server_close()
            httpd.service.batcher.shutdown()
            thread.join(timeout=30)
        got = np.asarray(Image.open(io.BytesIO(base64.b64decode(body["alpha"]))))
        want = to_uint8(self.point_alpha[0].cpu().numpy())
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        log(f"  (b) POST point_mask with {len(self.POINTS)} coords: HTTP {status} in "
            f"{t_req:.4f} s (a worker thread not warmed; server ms {body['ms']}); alpha "
            f"{got.shape} against (a)'s (8-bit): MAE {d.mean() / 255:.3e}, max {d.max()} steps "
            f"(bar MAE 1e-2)")
        if status != 200 or got.shape != self.pm.shape or not d.mean() / 255 <= 1e-2:
            raise AssertionError("(b) the served point_mask alpha differs from (a)'s")

    # -- (c) -------------------------------------------------------------
    def chunk(self):
        import numpy as np
        imgs = np.stack([np.roll(self.img, 131 * i, axis=0) for i in range(4)])
        tris = np.stack([np.roll(self.tri, 131 * i, axis=0) for i in range(4)])
        # encoder: concat batch 8 in four chunks of 2, each the 11 K3 convs of
        # the table; decoder: two chunks of 2, each 17 table convs at batch 2
        # (1024^2 128->128 x5, 512^2 256->256 x5, 256^2 512->512 x6 and the
        # upsampler conv into 256^2); K2 once per chunk (4 + 2)
        chunked = self.variant(vae_chunk=2)
        a_c, t_c, p_c = self.timed("(c) vae_chunk=2, batch 4", self.predicted(k2=6, k3=78),
                                   lambda: chunked(imgs, tris, options=self.raw)[0], reps=2)
        a_u, t_u, p_u = self.timed("(c) unchunked, batch 4", self.predicted(),
                                   lambda: self.pipe(imgs, tris, options=self.raw)[0], reps=2)
        mae = float((a_c - a_u).abs().mean())
        log(f"  (c) chunked against unchunked: MAE {mae:.3e} (bar 1e-2); {t_c:.4f} s against "
            f"{t_u:.4f} s per batch, peak {p_c:.2f} against {p_u:.2f} GiB")
        if not mae <= 1e-2:
            raise AssertionError(f"(c) vae_chunk=2 differs from the unchunked call by {mae}")
        plain = self.variant(impl="plain", vae_chunk=2)
        ref = self.plain_alpha(lambda: plain(imgs[:1], tris[:1], options=self.raw)[0])
        self.hold("(c) vae_chunk=2, image 0 of 4", a_c[:1], ref)

    # -- (d) -------------------------------------------------------------
    def fastest(self):
        # aux and rgb both at 512 px (one concat pass of batch 2: the 7 table
        # convs of a 512 px encode), the alpha latent decoded at 64^2
        fast = self.variant(speed_mode="fastest")
        a_f, t_f, p_f = self.timed("(d) speed_mode fastest", self.predicted(k3=7),
                                   lambda: fast(self.img, self.tri, options=self.raw)[0])
        a_d, t_d, p_d = self.timed("(d) default", self.predicted(k3=11),
                                   lambda: self.pipe(self.img, self.tri, options=self.raw)[0])
        plain = self.variant(impl="plain", speed_mode="fastest")
        self.hold("(d) speed_mode fastest", a_f,
                  self.plain_alpha(lambda: plain(self.img, self.tri, options=self.raw)[0]))
        log(f"  (d) fastest against the default matte: alpha MAE "
            f"{float((a_f - a_d).abs().mean()):.3e} (printed only: random weights); "
            f"{t_f:.4f} s against {t_d:.4f} s, peak {p_f:.2f} against {p_d:.2f} GiB")

    # -- (e) -------------------------------------------------------------
    def parity(self):
        import numpy as np
        torch = self.torch
        from sdmatte_tpu_torch import parity_pack
        from sdmatte_tpu_torch.checkpoint import load_sdmatte_checkpoint, save_checkpoint
        from sdmatte_tpu_torch.configs import SDMatteConfig
        from sdmatte_tpu_torch.models.init import init_random_
        from sdmatte_tpu_torch.models.sdmatte import SDMatte
        path = os.path.join(self.dir, "SDMatte_plain_names.safetensors")
        t0 = time.perf_counter()
        size = save_checkpoint(self.pipe.model, path, dtype=torch.bfloat16)
        log(f"  (e) checkpoint under plain key names: {size / 1e9:.3f} GB in "
            f"{time.perf_counter() - t0:.2f} s")
        del self.pipe
        torch.cuda.empty_cache()
        golden = os.path.join(self.dir, "golden.npz")
        report = os.path.join(self.dir, "parity_report.json")
        self.zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = parity_pack.run(["--ckpt", path, "--size", "512", "--golden-out", golden,
                              "--out", report])
        t_pack = time.perf_counter() - t0
        # fp32: K3's table is bf16 only; stage 4 is one 512 px forward, stage 5
        # two 256 px mattes
        self.expect("(e) parity pack, fp32", self.predicted(k1=96, k2=6))
        with open(report) as f:
            stages = json.load(f)["stages"]
        secs = {k: round(v["seconds"], 2) for k, v in stages.items() if isinstance(v, dict)}
        log(f"  (e) parity_pack.run at --size 512: exit {rc} in {t_pack:.2f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; seconds per stage {secs}; "
            f"quality {({k: round(v, 4) for k, v in stages['quality'].items() if k in ('SAD', 'MSE', 'Grad', 'Conn')})}")
        bad = [k for k, v in stages.items() if isinstance(v, dict) and not v["ok"]]
        if rc != 0 or bad:
            raise AssertionError(f"(e) the parity pack failed: exit {rc}, stages {bad}")
        # stage 4's forward again on the plain versions
        with torch.device("meta"):
            model = SDMatte(SDMatteConfig())
        init_random_(model, seed=0, device=self.dev)
        load_sdmatte_checkpoint(model, path)
        model.eval()
        img, tri = parity_pack.golden_inputs(512)
        ref = self.plain_alpha(lambda: parity_pack.golden_dump(model, img, tri, impl="plain"))
        got = np.load(golden)
        rel = {k: float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max()) for k in ref}
        mae = float(np.abs(got["alpha"] - ref["alpha"]).mean())
        log(f"  (e) stage 4 on the kernels against the plain versions, fp32, TF32 off: alpha "
            f"MAE {mae:.3e} (bar 1e-4); max |diff| / max |ref| per key "
            f"{ {k: float(f'{v:.3e}') for k, v in rel.items()} }")
        if not mae <= 1e-4:
            raise AssertionError(f"(e) the golden alpha on the kernels differs from the plain "
                                 f"versions' by MAE {mae} > 1e-4")

    def run(self):
        torch = self.torch
        t0 = time.perf_counter()
        self.pipe, _ = self.smoke.pipeline()
        torch.cuda.synchronize()
        log(f"  the shared bf16 pipeline (seeded weights) ready in "
            f"{time.perf_counter() - t0:.1f} s")
        self.step("kernels at this phase's new shapes", self.new_shapes)
        self.step("(a) point prompt", self.point)
        self.step("(b) batch 9 and a served point request", self.batch9)
        self.step("(c) vae_chunk", self.chunk)
        self.step("(d) speed mode", self.fastest)
        self.step("(e) parity pack", self.parity)
        log(f"  phase 7 (median s, peak GiB): "
            f"{ {k: (round(t, 4), round(p, 2)) for k, (t, p) in self.results.items()} }")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Training(EntryPoints):
    """Phase 8: training, video and the process group at full width
    (SDMatteConfig(), seeded random weights).  Training runs the plain
    versions (no hand kernel has a backward), FP32, with TF32 off as set in
    phase 1; the video runs the kernels in bf16.  Each step raises on
    failure."""

    FT_SIZE, FT_BATCH, FT_STEPS, FT_EMA = 512, 4, 4, 0.999
    VIDEO_SIZE, VIDEO_T = 1024, 8
    BACKEND = "nccl"

    def __init__(self, smoke, workdir: str, root: str, smi: str):
        super().__init__(smoke, workdir, root)
        self.smi = smi

    def model(self, cfg=None, seed=0):
        from sdmatte_tpu_torch.configs import SDMatteConfig
        from sdmatte_tpu_torch.models.init import init_random_
        from sdmatte_tpu_torch.models.sdmatte import SDMatte
        with self.torch.device("meta"):
            model = SDMatte(cfg or SDMatteConfig())
        return init_random_(model, seed=seed, device=self.dev)

    def loss_cfg(self):
        from sdmatte_tpu_torch.parallel import train
        # the fine-tune's terms (sdmatte_tpu_torch/finetune.py)
        return train.LossConfig(l1=1.0, unknown_l1=1.0, grad_l1=0.5)

    def batch(self, b, size, seed=0):
        from sdmatte_tpu_torch.parallel.data import CompositeSampler, to_tensors
        return {k: v.to(self.dev) for k, v in
                to_tensors(CompositeSampler(size=size, seed=seed).batch(b)).items()}

    # -- (a) -------------------------------------------------------------
    def finetune(self):
        torch = self.torch
        from sdmatte_tpu_torch.parallel import train
        from sdmatte_tpu_torch.parallel.data import CompositeSampler
        model = self.model()
        frozen = {n: p.detach().cpu().clone() for n, p in model.named_parameters()
                  if n.split(".")[0] in train.FROZEN_TOWERS}
        unet0 = {n: p.detach().cpu().clone() for n, p in model.unet.named_parameters()}
        real, times, seen = train.train_step, [], {}

        def timed_step(state, batch, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = real(state, batch, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            seen["state"] = state
            return loss

        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        train.train_step = timed_step
        t0 = time.perf_counter()
        try:
            model, losses, ema = train.train_loop(
                model, steps=self.FT_STEPS, batch_size=self.FT_BATCH,
                sampler=CompositeSampler(size=self.FT_SIZE, seed=0),
                learning_rate=train.make_lr_schedule(1e-4, warmup_steps=2,
                                                     total_steps=self.FT_STEPS),
                loss_cfg=self.loss_cfg(), remat=True, ema_decay=self.FT_EMA, log_every=1)
        finally:
            train.train_step = real
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        self.expect("(a) fine-tune (plain versions)", self.predicted(k1=0, k2=0))
        state = seen["state"]
        bad_frozen = [n for n, p in model.named_parameters()
                      if n in frozen and not torch.equal(p.detach().cpu(), frozen[n])]
        changed = sum(not torch.equal(p.detach().cpu(), unet0[n])
                      for n, p in model.unet.named_parameters())
        ema_frozen = [n for n, p in ema.named_parameters()
                      if n in frozen and not torch.equal(p.detach().cpu(), frozen[n])]
        frozen_ids = {id(p) for n, p in model.named_parameters() if n in frozen}
        with_state = sum(id(p) in frozen_ids for p in state.optimizer.state)
        n_unet = len(unet0)
        median = statistics.median(times)
        log(f"  (a) full width, FP32 (TF32 off), {self.FT_SIZE} px, batch {self.FT_BATCH}, remat, EMA "
            f"{self.FT_EMA}, VAE and text towers frozen: losses {[round(x, 5) for x in losses]}; "
            f"seconds per step {[round(t, 3) for t in times]} median {median:.3f} "
            f"({self.FT_BATCH / median:.2f} images/s); loop {wall:.1f} s; peak memory "
            f"{peak:.2f} GiB; {changed} of {n_unet} U-Net tensors changed, frozen towers "
            f"changed {len(bad_frozen)}, optimizer state for {len(state.optimizer.state)} "
            f"tensors ({with_state} of them frozen); {self.smi}")
        if not all(math.isfinite(x) for x in losses) or len(losses) != self.FT_STEPS:
            raise AssertionError(f"(a) losses {losses}")
        if bad_frozen or with_state or changed == 0:
            raise AssertionError(f"(a) frozen tensors changed {bad_frozen[:3]}, frozen tensors "
                                 f"with optimizer state {with_state}, U-Net tensors changed "
                                 f"{changed}")
        self.numbers.update(ft_step_s=median, ft_peak_gib=peak, ft_ema_frozen_drift=len(ema_frozen))
        del model, ema, state, seen, frozen, unet0
        torch.cuda.empty_cache()

    # -- (b) -------------------------------------------------------------
    def remat(self):
        torch = self.torch
        from sdmatte_tpu_torch.parallel import train
        model = self.model()
        batch = self.batch(1, self.FT_SIZE, seed=1)
        out, peaks = [], []
        for remat in (False, True):
            model.zero_grad(set_to_none=True)
            torch.cuda.reset_peak_memory_stats()
            loss = train.matting_loss(model, batch, loss_cfg=self.loss_cfg(), remat=remat)
            loss.backward()
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            out.append((loss.item(), {n: p.grad for n, p in model.named_parameters()
                                      if p.grad is not None}))
            for p in model.parameters():
                p.grad = None
        (l0, g0), (l1, g1) = out
        worst = max((float(((g1[n] - g0[n]).abs() / (1e-5 + 1e-4 * g0[n].abs())).max()), n)
                    for n in g0)
        log(f"  (b) full width, batch 1, {self.FT_SIZE} px, FP32: loss without remat {l0:.7f}, with "
            f"{l1:.7f}; {len(g0)} gradient tensors, largest |diff| / (1e-5 + 1e-4 |ref|) "
            f"{worst[0]:.3e} ({worst[1]}); peak {peaks[0]:.2f} GiB without remat, "
            f"{peaks[1]:.2f} GiB with")
        if g0.keys() != g1.keys() or not abs(l1 - l0) <= 1e-6 * abs(l0) or not worst[0] <= 1.0:
            raise AssertionError("(b) remat changed the loss or the gradients")
        self.numbers.update(remat_peak_gib=peaks[1], no_remat_peak_gib=peaks[0])
        del model, out, g0, g1
        torch.cuda.empty_cache()

    # -- (c) -------------------------------------------------------------
    def card_vs_cpu(self):
        torch = self.torch
        from sdmatte_tpu_torch.configs import SDMatteConfig
        from sdmatte_tpu_torch.models.init import init_random_
        from sdmatte_tpu_torch.models.sdmatte import SDMatte
        from sdmatte_tpu_torch.parallel import train
        cpu = init_random_(SDMatte(SDMatteConfig.tiny()), seed=0)
        card = SDMatte(SDMatteConfig.tiny()).to(self.dev)
        card.load_state_dict(cpu.state_dict())
        batch = self.batch(2, 64, seed=2)
        res = []
        for model, dev in ((cpu, "cpu"), (card, self.dev)):
            state = train.init_train_state(model, 1e-3)
            b = {k: v.to(dev) for k, v in batch.items()}
            loss = train.loss_and_grads(state, b, loss_cfg=self.loss_cfg())
            res.append((float(loss), {n: p.grad.detach().cpu().double()
                                      for n, p in model.named_parameters() if p.grad is not None}))
        (l_cpu, g_cpu), (l_card, g_card) = res
        rel = {n: float((g_card[n] - g).norm() / (g.norm() + 1e-30)) for n, g in g_cpu.items()}
        elementwise = sum(bool(((g_card[n] - g).abs() > 1e-5 + 1e-4 * g.abs()).any())
                          for n, g in g_cpu.items())
        worst = max(rel.items(), key=lambda kv: kv[1])
        bad = [n for n, g in g_cpu.items()
               if float((g_card[n] - g).norm()) > 1e-3 * float(g.norm()) + 1e-5 * g.numel() ** 0.5]
        log(f"  (c) tiny config, one step, card against CPU: loss {l_card:.7f} vs {l_cpu:.7f} "
            f"(rtol 1e-5); {len(g_cpu)} gradient tensors, largest ||diff|| / ||cpu|| "
            f"{worst[1]:.3e} ({worst[0]}); leaves outside the elementwise atol 1e-5 / rtol "
            f"1e-4 (printed only) {elementwise}")
        if g_cpu.keys() != g_card.keys() or not abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu) or bad:
            raise AssertionError(f"(c) the card's step differs from the CPU's: {bad[:3]}")

    # -- (d) -------------------------------------------------------------
    def no_backward(self):
        torch = self.torch
        from sdmatte_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_csplit, conv3x3_int8
        from sdmatte_tpu_torch.ops.flash_attention import flash_attention
        smoke = self.smoke
        cases = []
        for shape in ((1, 5, 4096, 4096, 64), (1, 1, 4096, 4096, 512)):
            q, k, v, bias, scale = smoke.attn_inputs(shape, shape[-1] == 64, torch.bfloat16)
            cases.append((f"K{1 if shape[-1] == 64 else 2} {shape}",
                          lambda q, k, v, bias=bias, scale=scale: flash_attention(
                              q, k, v, scale=scale, bias=bias), (q, k, v)))
        x, wt, b, affine, r = smoke.conv_inputs((2, 256, 256, 128, 128), True, True, torch.bfloat16)
        cases.append(("K3 (2, 256, 256, 128, 128) gn+res",
                      lambda x, wt, affine=affine, r=r, b=b: conv3x3(x, wt, b, affine=affine,
                                                                    residual=r), (x, wt)))
        cases.append(("K3 via the channel split",
                      lambda x, wt, affine=affine, r=r, b=b: conv3x3_csplit(
                          x, wt, b, affine=affine, residual=r), (x, wt)))
        xq, wq, scale_vec, bias, _ = smoke.int8_inputs((2, 256, 256, 128, 128), 1)
        cases.append(("K4 (2, 256, 256, 128, 128)",
                      lambda s, xq=xq, wq=wq, bias=bias: conv3x3_int8(xq, wq, s, bias),
                      (scale_vec,)))
        for label, fn, tensors in cases:
            leaves = [t.detach().clone().requires_grad_() for t in tensors]
            self.zero_counts()
            out = fn(*leaves)
            torch.cuda.synchronize()
            launched = [k.name for k in self.kernels if k.launches]
            try:
                out.float().sum().backward()
            except RuntimeError as e:
                msg = str(e).splitlines()[0]
                log(f"  (d) {label}: launched {launched}; backward raises: {msg[:150]}")
                if "has no backward kernel" not in msg:
                    raise
            else:
                raise AssertionError(f"(d) a backward through {label} did not raise")
            if len(launched) != 1:
                raise AssertionError(f"(d) {label} launched {launched}")
            del out, leaves
        torch.cuda.empty_cache()

    # -- (e) -------------------------------------------------------------
    def clip(self):
        """A T-frame clip, NCHW in [-1, 1]: a soft disk moving across a
        background of gradients and noise, and its trimaps."""
        import numpy as np
        s, t = self.VIDEO_SIZE, self.VIDEO_T
        rng = np.random.default_rng(0)
        yy, xx = np.mgrid[0:s, 0:s] / s
        bg = np.stack([0.3 + 0.4 * yy, 0.5 + 0.3 * xx, 0.4 + 0.2 * yy * xx], 0)
        frames, tris = [], []
        for i in range(t):
            r = np.hypot(yy - 0.5, xx - 0.25 - 0.5 * i / max(t - 1, 1))
            a = np.clip((0.2 - r) / 0.04 + 0.5, 0, 1)
            fg = np.stack([0.9 + 0 * a, 0.3 + 0.2 * yy, 0.2 + 0 * a], 0)
            img = a * fg + (1 - a) * bg + rng.normal(0, 0.03, bg.shape)
            frames.append(np.clip(img, 0, 1) * 2 - 1)
            tris.append(np.where(a >= 0.99, 1.0, np.where(a <= 0.01, -1.0, 0.0))[None])
        torch = self.torch
        return (torch.tensor(np.asarray(frames), dtype=torch.float32),
                torch.tensor(np.asarray(tris), dtype=torch.float32))

    def video(self):
        torch = self.torch
        from sdmatte_tpu_torch.core.dtypes import BF16
        from sdmatte_tpu_torch.ops import quant
        from sdmatte_tpu_torch.parallel.video import matte_video
        model = quant.stage_(self.model(), device=self.dev, dtype=torch.bfloat16).eval()
        frames, tris = self.clip()
        t = frames.shape[0]
        matte_video(model, frames, tris, policy=BF16)          # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        t0 = time.perf_counter()
        alpha = matte_video(model, frames, tris, policy=BF16)
        torch.cuda.synchronize()
        t_clip = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        self.expect(f"(e) video, T = {t}", self.predicted(k1=32, k2=2, k3=0))
        if tuple(alpha.shape) != (t, 1, self.VIDEO_SIZE, self.VIDEO_SIZE) \
                or not bool(torch.isfinite(alpha).all()):
            raise AssertionError(f"(e) the clip's alpha is {tuple(alpha.shape)}")
        alone, plain, t_alone = [], [], []
        for i in range(t):
            self.zero_counts()
            t0 = time.perf_counter()
            a = matte_video(model, frames[i:i + 1], tris[i:i + 1], policy=BF16)
            torch.cuda.synchronize()
            t_alone.append(time.perf_counter() - t0)
            self.expect(f"(e) frame {i} alone, T = 1", self.predicted(k1=32, k2=2, k3=11))
            alone.append(float((alpha[i] - a[0]).abs().mean()))
            self.zero_counts()
            p = matte_video(model, frames[i:i + 1], tris[i:i + 1], policy=BF16, impl="plain")
            torch.cuda.synchronize()
            if any(k.launches for k in self.kernels):
                raise AssertionError("(e) the plain run launched a hand kernel")
            plain.append(float((alpha[i] - p[0]).abs().mean()))
        log(f"  (e) video, {t} frames at {self.VIDEO_SIZE} px, bf16: {t_clip:.4f} s per clip, "
            f"{t_clip / t:.4f} s per frame (one frame alone: median "
            f"{statistics.median(t_alone):.4f} s), peak memory {peak:.2f} GiB; per frame, "
            f"alpha MAE against the frame matted alone {[float(f'{m:.2e}') for m in alone]}, "
            f"against the plain versions {[float(f'{m:.2e}') for m in plain]} (bar 1e-2); "
            f"{self.smi}")
        if not max(alone + plain) <= 1e-2:
            raise AssertionError(f"(e) a frame's alpha differs by MAE {max(alone + plain)} > 1e-2")
        self.numbers.update(video_s_per_frame=t_clip / t, video_peak_gib=peak)
        self.video_model = model

    # -- (f) -------------------------------------------------------------
    def process_group(self):
        import copy
        torch = self.torch
        import torch.distributed as dist
        from sdmatte_tpu_torch.configs import SDMatteConfig
        from sdmatte_tpu_torch.core.dtypes import BF16
        from sdmatte_tpu_torch.parallel import mesh, train
        from sdmatte_tpu_torch.parallel.video import matte_video
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                          WORLD_SIZE="1", RANK="0")
        if not mesh.distributed_init(backend=self.BACKEND):
            raise AssertionError("(f) distributed_init did not start the process group")
        try:
            m = mesh.make_mesh()
            model = self.model(SDMatteConfig.tiny())
            twin = copy.deepcopy(model)
            batch = self.batch(2, 64, seed=2)
            states = [train.init_train_state(x, 1e-3) for x in (model, twin)]
            loss_dp = float(train.make_sharded_train_step(m, loss_cfg=self.loss_cfg())(
                states[0], batch))
            loss = float(train.train_step(states[1], batch, loss_cfg=self.loss_cfg()))
            diff = max(float((a - b).abs().max()) for a, b in zip(
                model.state_dict().values(), twin.state_dict().values()))
            frames, tris = self.clip()
            self.zero_counts()
            got = matte_video(self.video_model, frames[:2], tris[:2], mesh=m, policy=BF16)
            ref = matte_video(self.video_model, frames[:2], tris[:2], policy=BF16)
            torch.cuda.synchronize()
            vdiff = float((got - ref).abs().max())
            log(f"  (f) {dist.get_backend()} at world size {dist.get_world_size()} "
                f"({mesh.data_axes(m)} mesh): the data-parallel step's loss {loss_dp:.7f} "
                f"against the plain step's {loss:.7f}, parameters max |diff| {diff:.3e}; "
                f"matte_video of 2 frames through the mesh against without it: max |diff| "
                f"{vdiff:.3e}")
            # the same math twice, with cuDNN's deterministic algorithms
            if not (abs(loss_dp - loss) <= 1e-6 * abs(loss) and diff <= 1e-6
                    and vdiff <= 1e-2):
                raise AssertionError("(f) the process group changed a result")
        finally:
            dist.destroy_process_group()
        del self.video_model
        torch.cuda.empty_cache()

    def run(self):
        torch = self.torch
        self.step("(a) fine-tune", self.finetune)
        # cuDNN's deterministic algorithms, so that two evaluations of the
        # same math are bitwise equal (remat recomputes, (f) runs twice)
        torch.backends.cudnn.deterministic = True
        self.step("(b) remat", self.remat)
        self.step("(c) the card against the CPU", self.card_vs_cpu)
        self.step("(d) no backward through a kernel", self.no_backward)
        self.step("(e) video", self.video)
        self.step("(f) process group", self.process_group)
        log(f"  phase 8 numbers: { {k: round(v, 4) for k, v in self.numbers.items()} } "
            f"({self.smi})")


# The ComfyUI loader of phase 9 (a), run in its own process: the package's
# __init__.py under a module name of the host's choosing, entered in
# sys.modules before it runs (ComfyUI's nodes.load_custom_node), with stub
# host modules: folder_paths on the models directory, comfy.model_management
# whose device is the card and whose soft_empty_cache does what ComfyUI's
# does on an NVIDIA card (the node calls it after each matte, as the
# reference node empties the cache).  The host makes its CUDA context at
# start-up, before it loads custom nodes.  Then the bundled workflow through
# the port's runner under the same name: once cold, twice warm, and twice
# warm with the host's cache emptying turned off.  Prints one JSON line.
COMFY_LOAD = r'''
import importlib, importlib.util, inspect, json, os, sys, time, types
import torch
root, models, out_dir, device = sys.argv[1:5]
name = "comfyui_sdmatte_port"

fp = types.ModuleType("folder_paths")
fp.models_dir = models
fp.folder_names_and_paths = {"diffusers": [os.path.join(models, "diffusers")]}
def add_model_folder_path(kind, path, is_default=False):
    paths = fp.folder_names_and_paths.setdefault(kind, [])
    if path not in paths:
        paths.append(path)
fp.add_model_folder_path = add_model_folder_path
fp.get_folder_paths = lambda kind: list(fp.folder_names_and_paths.get(kind, []))
comfy = types.ModuleType("comfy")
mm = types.ModuleType("comfy.model_management")
mm.get_torch_device = lambda: torch.device(device)
def soft_empty_cache(force=False):
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        torch.cuda.ipc_collect()
mm.soft_empty_cache = soft_empty_cache
comfy.model_management = mm
sys.modules.update({"folder_paths": fp, "comfy": comfy, "comfy.model_management": mm})
t0 = time.perf_counter()
torch.zeros(1, device=device)
t_ctx = time.perf_counter() - t0

t0 = time.perf_counter()
spec = importlib.util.spec_from_file_location(
    name, os.path.join(root, "sdmatte_tpu_torch", "__init__.py"))
module = importlib.util.module_from_spec(spec)
sys.modules[name] = module
spec.loader.exec_module(module)
cls = getattr(module, "NODE_CLASS_MAPPINGS")["SDMatteApply"]
t_load = time.perf_counter() - t0

def refuse(url, dst, progress=True):
    raise AssertionError(f"tried to download {url}")

importlib.import_module(name + ".assets.manager")._default_fetch = refuse
build = importlib.import_module(name + ".ops._build")
wf = importlib.import_module(name + ".workflow")
node = sys.modules[name + ".api.node"]
get_pipeline, t_pipeline = node.get_pipeline, []
def timed_get_pipeline(*a, **k):
    t0 = time.perf_counter()
    pipe = get_pipeline(*a, **k)
    t_pipeline.append(time.perf_counter() - t0)
    return pipe
node.get_pipeline = timed_get_pipeline
with open(os.path.join(root, "examples", "workflow_sdmatte_tpu.json")) as f:
    graph = json.load(f)

def run(out):
    registry = dict(wf.builtin_nodes(os.path.join(root, "examples"), out),
                    SDMatteApply=cls())
    timings = {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        wf.execute_workflow(graph, registry, verbose=False, timings=timings)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0, timings[3]

first, first_node = run(os.path.join(out_dir, "first"))
for k in build.Kernel.registry:
    k.launches = 0
warm, warm_node = run(os.path.join(out_dir, "warm"))
launches = {k.name: k.launches for k in build.Kernel.registry}
warm2, warm2_node = run(os.path.join(out_dir, "warm2"))
mm.soft_empty_cache = lambda force=False: None
kept = [run(os.path.join(out_dir, f"kept{i}")) for i in range(2)]
(pipe,) = node._PIPELINE_CACHE.values()
rep = pipe.load_report
print(json.dumps({
    "class_file": inspect.getfile(cls), "class_module": cls.__module__,
    "is_port_node": cls is node.SDMatteApply,
    "foreign": sorted(m for m in sys.modules if m.split(".")[0] in
                      ("jax", "sdmatte_tpu", "sdmatte_tpu_torch", "run_workflow", "examples")),
    "build_dir": str(build.BUILD_DIR),
    "libraries": sorted(str(build.library_path(n)) for n in build._LIBS),
    "sdmatte_folder": fp.get_folder_paths("SDMatte"),
    "report": [len(rep.missing), len(rep.unexpected), len(rep.mismatched)],
    "device": str(pipe.device), "dtype": str(pipe.policy.param_dtype),
    "context_s": t_ctx, "import_s": t_load, "pipeline_s": t_pipeline[0],
    "first_s": first, "first_node_s": first_node,
    "warm_s": [warm, warm2], "warm_node_s": [warm_node, warm2_node],
    "kept_s": [t for t, _ in kept], "kept_node_s": [n for _, n in kept],
    "launches": launches,
    "pngs": sorted(os.listdir(os.path.join(out_dir, "warm")))}))
'''


class HostPath(EntryPoints):
    """Phase 9: the ComfyUI host path at full width (SDMatteConfig(), bf16),
    on phase 6's checkpoint under the bundled workflow's checkpoint name:
    (a) the package loaded as ComfyUI loads a custom node, in a subprocess,
    running the bundled workflow; (b) the bundled workflow on a warmed worker
    thread; (c) a graph shaped like the reference's production workflow;
    (d) ``python -m sdmatte_tpu_torch.workflow --random-weights`` in a
    subprocess.  Each step asserts its launch counts and raises on failure."""

    CKPT_NAME = "SDMatte_plus.safetensors"    # the bundled workflow's ckpt_name
    # (inference_size, output_mode, K3 launches) per node of (c); K1 32 and K2
    # 2 at every size.  Counted on the meta device: the 1024 px encoder takes
    # 11 convs of the dispatch table, the 768 and 512 px encoders 7 each
    PRODUCTION = [(1024, "matted_rgba", 11), (1024, "matted_rgb", 11),
                  (768, "alpha_only", 7), (512, "alpha_only", 7)]
    # the card; the CPU only when this phase is tried out without one
    DEVICE, WORKFLOW_FLAGS = "cuda", ()

    def __init__(self, smoke, workdir: str, root: str, bare_s: float):
        super().__init__(smoke, workdir, root)
        self.bare_s = bare_s
        self.examples = os.path.join(root, "examples")
        self.workflow = os.path.join(self.examples, "workflow_sdmatte_tpu.json")
        self.out = os.path.join(workdir, "workflow_out")
        # ComfyUI's SDMatte folder holds phase 6's file under the workflow's name
        os.symlink(self.ckpt, os.path.join(os.path.dirname(self.ckpt), self.CKPT_NAME))

    def on_worker(self, fn):
        """fn() on the worker thread under inference mode, synchronized."""
        def call():
            with self.torch.inference_mode():
                out = fn()
                self.torch.cuda.synchronize()
                return out
        return self.worker.submit(call).result()

    def run_graph(self, graph, node, out):
        """(outputs, total s, each node's own s) of one graph on the worker,
        with fresh builtin nodes writing into ``out`` (their "wrote" lines
        are dropped)."""
        import io
        from sdmatte_tpu_torch import workflow
        registry = dict(workflow.builtin_nodes(self.examples, out), SDMatteApply=node)
        timings = {}

        def go():
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                res = workflow.execute_workflow(graph, registry, verbose=False,
                                                timings=timings)
            self.torch.cuda.synchronize()
            return res, time.perf_counter() - t0
        res, total = self.on_worker(go)
        return res, total, timings

    @staticmethod
    def options(widgets):
        """The pipeline options a node's widgets ask for."""
        from sdmatte_tpu_torch.pipeline import PipelineOptions
        _, size, transparent, mode, refine, tc = widgets[:6]
        return PipelineOptions(inference_size=size, is_transparent=transparent,
                               output_mode=mode, mask_refine=refine, trimap_constraint=tc)

    @staticmethod
    def png(path):
        import numpy as np
        from PIL import Image
        return np.asarray(Image.open(path)).astype(np.int16)

    # -- (a) -------------------------------------------------------------
    def comfy_load(self):
        script = os.path.join(self.dir, "comfy_load.py")
        with open(script, "w") as f:
            f.write(COMFY_LOAD)
        out = os.path.join(self.dir, "comfy_out")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, script, self.root, self.dir, out, self.DEVICE],
                           cwd=self.dir, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            log(r.stdout[-2000:] + r.stderr[-4000:])
            raise AssertionError(f"(a) the ComfyUI-style load exited {r.returncode}")
        got = json.loads(r.stdout.strip().splitlines()[-1])
        node_file = os.path.join(self.root, "sdmatte_tpu_torch", "api", "node.py")
        build_dir = os.path.join(self.root, "sdmatte_tpu_torch", "_build")
        log(f"  (a) loaded as {got['class_module']!r} from {got['class_file']}; modules of "
            f"jax, sdmatte_tpu or the package's own name: {got['foreign']}; kernels from "
            f"{got['build_dir']} ({len(got['libraries'])} libraries); the node's model "
            f"folder {got['sdmatte_folder']}; load report missing/unexpected/mismatched "
            f"{got['report']}, {got['device']} {got['dtype']}")
        if not (got["is_port_node"] and os.path.samefile(got["class_file"], node_file)
                and got["class_module"] == "comfyui_sdmatte_port.api.node"):
            raise AssertionError("(a) the registered class is not the port's SDMatteApply")
        if got["foreign"]:
            raise AssertionError(f"(a) the load imported {got['foreign']}")
        if not (os.path.samefile(got["build_dir"], build_dir) and got["libraries"]
                and all(os.path.dirname(p) == got["build_dir"] for p in got["libraries"])):
            raise AssertionError("(a) the kernels were not loaded from the package's _build/")
        if got["report"] != [0, 0, 0]:
            raise AssertionError(f"(a) the node's load report is not clean: {got['report']}")
        self.expect("(a) bundled workflow under the foreign name", self.predicted(k3=11),
                    got["launches"])
        r4 = lambda ts: [round(t, 4) for t in ts]   # noqa: E731
        log(f"  (a) subprocess wall {wall:.2f} s (bare process {self.bare_s:.2f} s): the "
            f"host's CUDA context {got['context_s']:.2f} s; package import "
            f"{got['import_s']:.2f} s; first workflow {got['first_s']:.2f} s (node "
            f"{got['first_node_s']:.2f} s, of which the node's pipeline (seeded init, "
            f"checkpoint load) {got['pipeline_s']:.2f} s); warm, the host emptying the CUDA "
            f"cache after each matte: {r4(got['warm_s'])} s (node {r4(got['warm_node_s'])} s); "
            f"warm, the cache kept: {r4(got['kept_s'])} s (node {r4(got['kept_node_s'])} s); "
            f"PNGs {got['pngs']}")
        if got["pngs"] != ["preview_01_000.png", "sdmatte_matted_01_000.png"]:
            raise AssertionError(f"(a) the workflow wrote {got['pngs']}")
        self.comfy_out = os.path.join(out, "warm")
        self.numbers.update(comfy_wall_s=wall, comfy_first_s=got["first_s"],
                            comfy_warm_s=statistics.median(got["warm_s"]),
                            comfy_kept_s=statistics.median(got["kept_s"]))

    # -- (b) -------------------------------------------------------------
    def bundled(self):
        import numpy as np
        torch = self.torch
        from sdmatte_tpu_torch.api import NODE_CLASS_MAPPINGS
        from sdmatte_tpu_torch.api import node as node_mod
        with open(self.workflow) as f:
            graph = json.load(f)
        node = NODE_CLASS_MAPPINGS["SDMatteApply"]()
        out = os.path.join(self.out, "bundled")
        # the worker's first workflow loads the checkpoint through the node
        _, first, _ = self.run_graph(graph, node, os.path.join(self.out, "bundled_first"))
        (self.pipe,) = node_mod._PIPELINE_CACHE.values()
        self.zero_counts()
        res, _, _ = self.run_graph(graph, node, out)
        self.expect("(b) bundled workflow", self.predicted(k3=11))
        times, node_s, own_s, by_type = [], [], [], {}
        types = {n["id"]: n["type"] for n in graph["nodes"]}
        for i in range(3):
            _, total, timings = self.run_graph(graph, node, os.path.join(self.out, f"bundled_{i}"))
            times.append(total)
            node_s.append(timings[3])
            own_s.append(total - sum(timings.values()))
            for nid, t in timings.items():
                by_type.setdefault(types[nid], []).append(t)
        alpha, matted = res[3]
        img, tri = res[1][0], res[2][0]
        opts = self.options(graph["nodes"][2]["widgets_values"])
        direct = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            t0 = time.perf_counter()
            ref = self.on_worker(lambda: self.pipe(img, tri, options=opts))
            direct.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        mae = float((alpha - ref[0].cpu()).abs().mean())
        saved = self.png(os.path.join(out, "sdmatte_matted_01_000.png")) / 255.0
        png_err = float(np.abs(saved - matted[0].numpy()).max())
        comfy = self.png(os.path.join(self.comfy_out, "preview_01_000.png"))
        ours = self.png(os.path.join(out, "preview_01_000.png"))
        comfy_mae = float(np.abs(comfy - ours).mean()) / 255
        med, med_direct = statistics.median(times), statistics.median(direct)
        log(f"  (b) first workflow on the worker {first:.2f} s (the checkpoint load included); "
            f"warm s {[round(t, 4) for t in times]} median {med:.4f}, of which the node "
            f"{statistics.median(node_s):.4f} s and the runner itself "
            f"{statistics.median(own_s) * 1e3:.3f} ms; the direct pipeline call on the same "
            f"thread {[round(t, 4) for t in direct]} median {med_direct:.4f} s, peak "
            f"{peak:.2f} GiB")
        log(f"  (b) median s per node: "
            f"{ {k: round(statistics.median(v), 4) for k, v in by_type.items()} }")
        log(f"  (b) node alpha {tuple(alpha.shape)} against the direct call: MAE {mae:.3e} (bar "
            f"1e-2); the SaveImage PNG against the matted tensor: max {png_err:.3e} (bar 1/255 "
            f"= {1 / 255:.3e}); the alpha preview PNG against (a)'s: MAE {comfy_mae:.3e}, max "
            f"{int(np.abs(comfy - ours).max())} steps (bar MAE 1/255)")
        if not (mae <= 1e-2 and png_err <= 1 / 255 and comfy_mae <= 1 / 255):
            raise AssertionError("(b) the bundled workflow's outputs differ")
        self.preview = ours
        self.numbers.update(workflow_s=med, workflow_node_s=statistics.median(node_s),
                            runner_ms=statistics.median(own_s) * 1e3, direct_s=med_direct,
                            one_matte_gib=peak)

    # -- (c) -------------------------------------------------------------
    def production_graph(self):
        """LoadImage -> the SegmentAnything stand-in (the trimap) -> four
        SDMatteApply nodes on one checkpoint; each node's alpha beside the
        trimap it was given in eight MaskPreview+ nodes, as the reference's
        previews pair them; the first node's cutout into one SaveImage; a
        Bookmark."""
        nodes, links = [], []

        def add(type_, inputs=(), widgets=()):
            nid = len(nodes) + 1
            ins = []
            for name, (src, slot) in inputs:
                links.append([len(links) + 1, src, slot, nid, len(ins), ""])
                ins.append({"name": name, "link": len(links)})
            nodes.append({"id": nid, "type": type_, "inputs": ins,
                          "widgets_values": list(widgets)})
            return nid

        photo = add("LoadImage", widgets=("example_input.png", "image"))
        sam = add("LayerMask: SegmentAnythingUltra V2", [("image", (photo, 0))])
        applies = [add("SDMatteApply", [("image", (photo, 0)), ("trimap", (sam, 1))],
                       (self.CKPT_NAME, size, False, mode, True, 0.8, False))
                   for size, mode, _ in self.PRODUCTION]
        for a in applies:
            add("MaskPreview+", [("mask", (a, 0))])
            add("MaskPreview+", [("mask", (sam, 1))])
        add("SaveImage", [("images", (applies[0], 1))], ("sdmatte_production",))
        add("Bookmark (rgthree)")
        return {"nodes": nodes, "links": links}, photo, sam, applies

    def production(self):
        import numpy as np
        torch = self.torch
        from sdmatte_tpu_torch.api import node as node_mod
        from sdmatte_tpu_torch.ops._build import Kernel
        graph, photo, sam, applies = self.production_graph()
        calls = []
        smoke = self

        class CountedApply(node_mod.SDMatteApply):
            """The port's node, recording each call's launches and the cache."""

            def apply_matte(self, **kw):
                smoke.zero_counts()
                out = super().apply_matte(**kw)
                torch.cuda.synchronize()
                calls.append(({k.name: k.launches for k in Kernel.registry},
                              list(node_mod._PIPELINE_CACHE.values())))
                return out

        node, out = CountedApply(), os.path.join(self.out, "production")
        self.run_graph(graph, node, out + "_first")      # warms 768 and 512 px
        calls.clear()
        res, _, _ = self.run_graph(graph, node, out)
        for (size, mode, k3), (got, cache) in zip(self.PRODUCTION, calls):
            self.expect(f"(c) node {size} px {mode}", self.predicted(k3=k3), got)
            if len(cache) != 1 or cache[0] is not self.pipe:
                raise AssertionError(f"(c) the node cache held {len(cache)} pipelines, not (b)'s")
        total = {k: sum(c[0][k] for c in calls) for k in calls[0][0]}
        log(f"  (c) per graph: launches {total}; checkpoint loads in (b) and (c): "
            f"{len(self.loads)}; pipelines in the node cache after each node: "
            f"{[len(c[1]) for c in calls]}")
        if len(calls) != 4 or len(self.loads) != 1:
            raise AssertionError(f"(c) {len(calls)} node calls, {len(self.loads)} checkpoint loads")
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        if len(pngs) != 9:
            raise AssertionError(f"(c) the graph wrote {len(pngs)} PNGs, not 8 previews and a save")
        torch.cuda.reset_peak_memory_stats()
        times, by_type = [], {}
        for i in range(2):
            _, t, timings = self.run_graph(graph, node, f"{out}_{i}")
            times.append(t)
            sums = {}
            for n in graph["nodes"]:
                sums[n["type"]] = sums.get(n["type"], 0.0) + timings[n["id"]]
            for k, v in sums.items():
                by_type.setdefault(k, []).append(v)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        img, tri = res[photo][0], res[sam][1]
        maes = []
        for nid in applies:
            opts = self.options(graph["nodes"][nid - 1]["widgets_values"])
            ref = self.on_worker(lambda: self.pipe(img, tri, options=opts))
            maes.append(float((res[nid][0] - ref[0].cpu()).abs().mean()))
        same = float((res[applies[0]][0] - res[applies[1]][0]).abs().max())
        log(f"  (c) each node's alpha against its direct call: MAE "
            f"{[float(f'{m:.3e}') for m in maes]} (bar 1e-2); the two 1024 px nodes' alphas "
            f"differ by max {same:.3e}; trimap from the stand-in: "
            f"{float((tri == 1).float().mean()):.3f} fg, {float((tri == 0).float().mean()):.3f} "
            f"bg; {len(pngs)} PNGs")
        log(f"  (c) warm s per graph {[round(t, 4) for t in times]} median "
            f"{statistics.median(times):.4f} (the bundled workflow {self.numbers['workflow_s']:.4f} "
            f"s); peak {peak:.2f} GiB against one 1024 px matte's "
            f"{self.numbers['one_matte_gib']:.2f} GiB; median s per graph by node type "
            f"{ {k: round(statistics.median(v), 4) for k, v in by_type.items()} }")
        if not max(maes) <= 1e-2:
            raise AssertionError(f"(c) a node's alpha differs from its direct call by {max(maes)}")
        self.numbers.update(graph_s=statistics.median(times), graph_gib=peak)

    # -- (d) -------------------------------------------------------------
    def entry_point(self):
        import numpy as np
        out = os.path.join(self.out, "entry_point")
        cmd = [sys.executable, "-m", "sdmatte_tpu_torch.workflow", self.workflow,
               "--random-weights", "--out-dir", out, *self.WORKFLOW_FLAGS]
        env = dict(os.environ, SDMATTE_TPU_MODELS_DIR=self.dir)
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=self.root, env=env, capture_output=True, text=True,
                           timeout=600)
        wall = time.perf_counter() - t0
        lines = [ln for ln in r.stderr.splitlines() if ln.startswith("[workflow]")]
        for ln in lines + [ln for ln in r.stdout.splitlines() if ln.startswith("[workflow]")]:
            log(f"  (d) {ln}")
        if r.returncode != 0:
            log(r.stdout[-2000:] + r.stderr[-4000:])
            raise AssertionError(f"(d) python -m sdmatte_tpu_torch.workflow exited {r.returncode}")
        counts = [ln.split("hand-kernel launches: ", 1)[1] for ln in lines
                  if "hand-kernel launches" in ln]
        self.expect("(d) workflow process", self.predicted(k3=11), json.loads(counts[-1]))
        pngs = sorted(os.listdir(out))
        if pngs != ["preview_01_000.png", "sdmatte_matted_01_000.png"]:
            raise AssertionError(f"(d) the workflow wrote {pngs}")
        # the seeded weights are phase 6's checkpoint's: the same alpha as (b)
        got = self.png(os.path.join(out, "preview_01_000.png"))
        mae = float(np.abs(got - self.preview).mean()) / 255
        log(f"  (d) exit 0 in {wall:.2f} s (wall, process start to exit; a bare process "
            f"{self.bare_s:.2f} s, phase 6 (d)); PNGs {pngs}; the alpha preview against (b)'s: "
            f"MAE {mae:.3e}, max {int(np.abs(got - self.preview).max())} steps (bar MAE 1/255)")
        if not mae <= 1 / 255:
            raise AssertionError("(d) the entry point's alpha differs from the node's")
        self.numbers.update(workflow_process_s=wall)

    def run(self):
        from concurrent.futures import ThreadPoolExecutor
        from sdmatte_tpu_torch import checkpoint
        from sdmatte_tpu_torch.api import comfy_shim
        from sdmatte_tpu_torch.api import node as node_mod
        comfy_shim.add_model_folder_path("SDMatte", os.path.dirname(self.ckpt))
        comfy_shim.add_model_folder_path("diffusers", os.path.dirname(self.cfg_dir))
        node_mod._PIPELINE_CACHE.clear()
        self.loads = []
        load = checkpoint.load_sdmatte_checkpoint

        def counted_load(model, path, **kw):
            self.loads.append(path)
            return load(model, path, **kw)

        checkpoint.load_sdmatte_checkpoint = counted_load
        try:
            self.step("(a) ComfyUI-style load in a subprocess", self.comfy_load)
            with ThreadPoolExecutor(max_workers=1) as self.worker:
                self.step("(b) bundled workflow", self.bundled)
                self.step("(c) production-shaped graph", self.production)
        finally:
            checkpoint.load_sdmatte_checkpoint = load
        node_mod._PIPELINE_CACHE.clear()
        del self.pipe
        self.torch.cuda.empty_cache()
        self.step("(d) python -m sdmatte_tpu_torch.workflow", self.entry_point)
        log(f"  phase 9 numbers: { {k: round(v, 4) for k, v in self.numbers.items()} }")


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
    # Phases 3-7, 9 and 10 infer only: inference mode keeps every tensor they make out
    # of autograd (the pipeline and the parity pack run under no_grad anyway)
    with torch.inference_mode():
        log("== 3. kernels against their plain versions")
        smoke.check_attention()
        smoke.check_conv()
        smoke.check_csplit()
        smoke.check_int8_conv()

        log("== 4. timing (CUDA events, warm, median)")
        rows = smoke.time_kernels()

        log("== 5. end to end: full width, bf16, 1024 px (with --profile, a profile of one "
            "more warm matte follows each path's timings)")
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
            results[label] = smoke.matte(label, predicted, **kw)
        base = results["default"]
        for label, (_, median, peak, alpha_raw) in results.items():
            mae = float((alpha_raw.float() - base[3].float()).abs().mean())
            log(f"  {label:14s} warm median {median:.4f} s (default {base[1]:.4f} s), peak "
                f"{peak:.2f} GiB (default {base[2]:.2f} GiB); alpha MAE vs the default bf16 "
                f"matte before mask_refine {mae:.3e} (printed only: random weights)")

        log("== 6. entry points at full width: checkpoint, node, server, CLI, text path")
        import shutil
        import tempfile
        workdir = tempfile.mkdtemp(prefix="sdmatte_smoke_")
        try:
            entry = EntryPoints(smoke, workdir, root)
            entry.run()
            log("== 7. the other meta-architecture paths at full width: point prompt, batch 9, "
                "vae_chunk, speed mode, parity pack")
            MetaPaths(smoke, workdir, root).run()
            log("== 9. the ComfyUI host path at full width: the package loaded as a custom "
                "node, the bundled workflow, a production-shaped graph, the runner's entry point")
            HostPath(smoke, workdir, root, entry.numbers["bare_process_s"]).run()
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        smoke.text_device_times()
        log("== 10. ViTMatte-B end to end at 12 MP (4032 x 3024), bf16, through its graphs")
        vit = smoke.vitmatte_matte()

    log("== 8. training, video and the process group at full width: fine-tune, remat, the "
        "card against the CPU, no backward through a kernel, video, NCCL at world size 1")
    Training(smoke, workdir, root, smi).run()

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
    mine = [(n, t) for *_, n, t in smoke.relpos_rows]
    per_matte = {key: sum(n * t[key] for n, t in mine)
                 for key in ("ms", "plain_ms", "flops", "bytes")}
    windows = [(n, t) for n, t in mine if t["library_ms"] is not None]
    bound_ms, bound_by = bound(per_matte["flops"], per_matte["bytes"])
    record.append({
        "name": K1.name, "mode": "relpos", "path": "vitmatte 12 MP (4032 x 3024)",
        "route": "cuda", "source": K1.source, "replaces": None,
        "launches": vit[0][K1.name], "max_abs_err": smoke.err["flash_attention_k1 relpos"],
        "ms": per_matte["ms"], "plain_ms": per_matte["plain_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library_note": "SDPA with the bias formed: the 8 windowed launches "
                        f"{sum(n * t['library_ms'] for n, t in windows):.4f} ms (kernel "
                        f"{sum(n * t['ms'] for n, t in windows):.4f} ms); at the 4 global "
                        f"launches the bias would take 110 GB",
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
