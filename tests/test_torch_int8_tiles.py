"""K4's tile and window indexing, replayed in numpy and held to the references.

csrc/conv3x3_i8.cu has three kernels, and no CUDA compiler runs here, so this
file replays what each does with its indices, step by step on int8 inputs
made from a seed:

  conv3x3_i8_sm90   4 x 64-pixel tiles, 128-channel chunks; per chunk one
                    (4+2) x 66 halo window whose pixels are 128-byte rows in
                    the 128-byte swizzle, zero outside the image and past
                    Cin; a tap's shift moves the A tile's start by whole
                    pixel rows of that window; weight tiles of 128 or 8
                    output channels per (chunk, tap), zero past Cout
  conv3x3_i8_fold   Cin 3 and 4: the nine taps folded into K, k = tap * Cin
                    + c, one or two 32-byte steps of a swizzled 128-byte row
  conv3x3_i8_kernel the first design, where stride 2 stays: 8 x 16-pixel
                    tiles, 64-channel chunks, a window of (8-1)*S+3 rows in
                    which output pixel (ty, tx) at tap (dy, dx) reads pixel
                    (ty*S+dy, tx*S+dx)

Each replay ends in the kernels' exact epilogue, float32(acc) * scale +
bias, and must equal conv3x3_int8_plain bit for bit; at stride 1 and padding
1 it is also held to the JAX package's Pallas kernel (conv3x3_same_int8, in
interpret mode, as tests/test_torch_kernels.py runs it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdmatte_tpu.ops.conv3x3 import conv3x3_same_int8

from sdmatte_tpu_torch.ops.conv3x3 import conv3x3_int8_plain, pads_of


def _out_size(n, lo, hi, stride):
    return (n + lo + hi - 3) // stride + 1


def _epilogue(acc, scale, bias):
    """(B, Ho, Wo, Cout) int sums -> fp32, as the kernels' epilogue rounds."""
    y = acc.astype(np.int32).astype(np.float32) * scale.astype(np.float32)
    return y if bias is None else y + bias.astype(np.float32)


def swizzle128(addr):
    """The 128-byte swizzle as the hardware applies it to a shared-memory
    byte address: address bits 4-6 (the 16-byte chunk of a 128-byte row) are
    XORed with bits 7-9 (the row within its group of eight)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _store_rows(rows):
    """An (n, 128) byte matrix, written as TMA writes it: row r's 16-byte
    chunk c at chunk c ^ (r & 7).  Returns the flat buffer."""
    n = rows.shape[0]
    buf = np.zeros(n * 128, rows.dtype)
    addr = np.arange(n * 128)
    buf[swizzle128(addr)] = rows.reshape(-1)
    return buf


def _read_tile(buf, first_row, nrows, kbytes=128):
    """The (nrows, kbytes) K-major operand a descriptor starting at row
    ``first_row`` reads: logical byte (i, k) from the swizzled address of
    (first_row + i) * 128 + k.  Any row may start a tile."""
    addr = (first_row + np.arange(nrows))[:, None] * 128 + np.arange(kbytes)[None, :]
    return buf[swizzle128(addr)]


def sm90_replay(x, w, scale, bias, padding, bn):
    """conv3x3_i8_sm90 at stride 1: x (B, H, W, Cin) int8 with Cin % 16 == 0,
    w (Cout, 3, 3, Cin) int8, bn output channels per tile (128 or 8)."""
    TH, TW, BKC = 4, 64, 128
    wcols = TW + 2
    (pt, pb), (pl, pr) = pads_of(padding)
    b_, h, wd, cin = x.shape
    cout = w.shape[0]
    ho, wo = _out_size(h, pt, pb, 1), _out_size(wd, pl, pr, 1)
    nchunks = -(-cin // BKC)
    acc = np.zeros((b_, ho, wo, cout), np.int64)
    for b in range(b_):
        for y0 in range(0, ho, TH):
            for x0 in range(0, wo, TW):
                for co0 in range(0, cout, bn):
                    tile = np.zeros((TH, TW, bn), np.int64)
                    for c in range(nchunks):
                        # one TMA copy: (TH + 2) x 66 pixels x 128 channels
                        # from (y0 - pad_top, x0 - pad_left), zeros outside
                        win = np.zeros((TH + 2, wcols, BKC), np.int8)
                        for r in range(TH + 2):
                            for q in range(wcols):
                                iy, ix = y0 - pt + r, x0 - pl + q
                                if 0 <= iy < h and 0 <= ix < wd:
                                    nc = min(BKC, cin - c * BKC)
                                    win[r, q, :nc] = x[b, iy, ix, c * BKC:c * BKC + nc]
                        wbuf = _store_rows(win.reshape(-1, BKC))
                        for tap in range(9):
                            dy, dx = tap // 3, tap % 3
                            # the (chunk, tap) weight tile: bn rows of 128 bytes
                            wt = np.zeros((bn, BKC), np.int8)
                            nco = max(0, min(bn, cout - co0))
                            nc = min(BKC, cin - c * BKC)
                            wt[:nco, :nc] = w[co0:co0 + nco, dy, dx, c * BKC:c * BKC + nc]
                            bt = _read_tile(_store_rows(wt), 0, bn).astype(np.int64)
                            for ty in range(TH):   # warpgroup ty // 2, m64 tile ty % 2
                                pix0 = (ty + dy) * wcols + dx
                                a = _read_tile(wbuf, pix0, TW).astype(np.int64)
                                tile[ty] += a @ bt.T
                    ys, xs, cs = min(TH, ho - y0), min(TW, wo - x0), min(bn, cout - co0)
                    acc[b, y0:y0 + ys, x0:x0 + xs, co0:co0 + cs] = tile[:ys, :xs, :cs]
    return _epilogue(acc, scale, bias)


def fold_replay(x, w, scale, bias, padding):
    """conv3x3_i8_fold: Cin 3 or 4, the nine taps folded into K."""
    TH, TW, BN = 4, 64, 128
    (pt, pb), (pl, pr) = pads_of(padding)
    b_, h, wd, cin = x.shape
    cout = w.shape[0]
    k_all = 9 * cin
    ksteps = -(-k_all // 32)
    assert ksteps <= 2
    ho, wo = _out_size(h, pt, pb, 1), _out_size(wd, pl, pr, 1)
    acc = np.zeros((b_, ho, wo, cout), np.int64)
    for b in range(b_):
        for y0 in range(0, ho, TH):
            for x0 in range(0, wo, TW):
                # thread t gathers the im2col row of pixel (t // 64, t % 64)
                rows = np.zeros((TH * TW, 128), np.int8)
                for t in range(TH * TW):
                    oy, ox = y0 + t // TW, x0 + t % TW
                    for tap in range(9):
                        iy, ix = oy - pt + tap // 3, ox - pl + tap % 3
                        if 0 <= iy < h and 0 <= ix < wd:
                            rows[t, tap * cin:(tap + 1) * cin] = x[b, iy, ix]
                abuf = _store_rows(rows)
                for co0 in range(0, cout, BN):
                    wt = np.zeros((BN, 128), np.int8)
                    nco = min(BN, cout - co0)
                    wt[:nco, :k_all] = w[co0:co0 + nco].reshape(nco, k_all)
                    bt = _read_tile(_store_rows(wt), 0, BN, ksteps * 32).astype(np.int64)
                    for ty in range(TH):
                        a = _read_tile(abuf, ty * TW, TW, ksteps * 32).astype(np.int64)
                        ys, xs = ho - y0, min(TW, wo - x0)
                        if ty < ys:
                            acc[b, y0 + ty, x0:x0 + xs, co0:co0 + nco] = (a @ bt.T)[:xs, :nco]
    return _epilogue(acc, scale, bias)


def first_design_replay(x, w, scale, bias, stride, padding):
    """conv3x3_i8_kernel: 8 x 16-pixel tiles, 64-channel chunks, any stride."""
    TH, TW, BKC = 8, 16, 64
    s = stride
    (pt, pb), (pl, pr) = pads_of(padding)
    b_, h, wd, cin = x.shape
    cout = w.shape[0]
    ho, wo = _out_size(h, pt, pb, s), _out_size(wd, pl, pr, s)
    wh, ww = (TH - 1) * s + 3, (TW - 1) * s + 3
    acc = np.zeros((b_, ho, wo, cout), np.int64)
    w64 = w.astype(np.int64)
    for b in range(b_):
        for oy0 in range(0, ho, TH):
            for ox0 in range(0, wo, TW):
                iy0, ix0 = oy0 * s - pt, ox0 * s - pl
                tile = np.zeros((TH, TW, cout), np.int64)
                for c0 in range(0, cin, BKC):
                    nc = min(BKC, cin - c0)
                    win = np.zeros((wh * ww, BKC), np.int64)
                    for pix in range(wh * ww):
                        y, xx = iy0 + pix // ww, ix0 + pix % ww
                        if 0 <= y < h and 0 <= xx < wd:
                            win[pix, :nc] = x[b, y, xx, c0:c0 + nc]
                    for tap in range(9):
                        dy, dx = tap // 3, tap % 3
                        for ty in range(TH):
                            pix = (ty * s + dy) * ww + np.arange(TW) * s + dx
                            tile[ty] += win[pix, :nc] @ w64[:, dy, dx, c0:c0 + nc].T
                ys, xs = min(TH, ho - oy0), min(TW, wo - ox0)
                acc[b, oy0:oy0 + ys, ox0:ox0 + xs] = tile[:ys, :xs]
    return _epilogue(acc, scale, bias)


def route(cin, cout, stride):
    """csrc/conv3x3_i8.cu::route_of for 16-byte aligned tensors."""
    if stride != 1:
        return "first"
    if cin % 16 == 0:
        return "sm90_n8" if cout <= 8 else "sm90_n128"
    return "fold" if cin in (3, 4) else "first"


DOWN = ((0, 1), (0, 1))
# (b, h, w, cin, cout), stride, padding, bias
CASES = {
    # conv3x3_i8_sm90: W and H off the 4 x 64 tile, Cin off the 128-channel
    # chunk (a second, ragged chunk), Cout off the 128- and 8-channel tiles
    "sm90_ragged_w70_two_chunks": ((1, 6, 70, 144, 24), 1, 1, True),
    "sm90_cin16_cout130": ((2, 5, 9, 16, 130), 1, 1, False),
    "sm90_uneven_padding": ((1, 7, 66, 32, 16), 1, ((0, 2), (2, 0)), True),
    "sm90_narrow_cout3": ((1, 5, 67, 32, 3), 1, 1, True),
    "sm90_narrow_cout8": ((2, 9, 8, 144, 8), 1, 1, False),
    # conv3x3_i8_fold: 27 values in one k32 step, 36 in two
    "fold_cin3": ((2, 6, 67, 3, 20), 1, 1, True),
    "fold_cin4_cout130": ((1, 9, 10, 4, 130), 1, 1, True),
    "fold_cin3_uneven_padding": ((1, 5, 66, 3, 8), 1, ((2, 0), (0, 2)), False),
    # the first design: stride 2 with the downsampler's padding, other Cin
    "first_stride2_down": ((2, 18, 21, 16, 24), 2, DOWN, True),
    "first_stride2_ragged_cin80": ((1, 33, 27, 80, 8), 2, DOWN, False),
    "first_stride2_cin3": ((1, 16, 19, 3, 16), 2, DOWN, True),
    "first_cin20": ((1, 12, 18, 20, 24), 1, 1, True),
}


def _inputs(case, seed=5):
    (b, h, w, cin, cout), stride, padding, biased = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (cout, 3, 3, cin)).astype(np.int8)
    scale = rng.uniform(0.5, 2.0, (cout,)).astype(np.float32) / np.float32(127.0 * 127.0)
    bias = rng.standard_normal(cout).astype(np.float32) if biased else None
    return x, wq, scale, bias, stride, padding


def _replay(case):
    x, wq, scale, bias, stride, padding = _inputs(case)
    kind = route(x.shape[3], wq.shape[0], stride)
    if kind == "sm90_n128":
        return sm90_replay(x, wq, scale, bias, padding, 128)
    if kind == "sm90_n8":
        return sm90_replay(x, wq, scale, bias, padding, 8)
    if kind == "fold":
        return fold_replay(x, wq, scale, bias, padding)
    return first_design_replay(x, wq, scale, bias, stride, padding)


@pytest.mark.parametrize("case", list(CASES))
def test_k4_replay_equals_plain_bit_for_bit(case):
    x, wq, scale, bias, stride, padding = _inputs(case)
    assert case.startswith(route(x.shape[3], wq.shape[0], stride).split("_")[0])
    got = _replay(case)
    ref = conv3x3_int8_plain(torch.from_numpy(x).permute(0, 3, 1, 2),
                             torch.from_numpy(wq).permute(0, 3, 1, 2),
                             torch.from_numpy(scale),
                             None if bias is None else torch.from_numpy(bias),
                             stride=stride, padding=padding, out_dtype=torch.float32)
    ref = ref.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert np.abs(got.astype(np.float64) - ref.astype(np.float64)).max() == 0.0


@pytest.mark.parametrize("case", [c for c, v in CASES.items() if v[1] == 1 and v[2] == 1])
def test_k4_replay_matches_pallas_kernel(case):
    """Stride 1, padding 1: against sdmatte_tpu/ops/conv3x3.py::_kernel_i8 in
    interpret mode, at tests/test_conv3x3.py's int8 bar."""
    x, wq, scale, bias, _, _ = _inputs(case)
    with pltpu.force_tpu_interpret_mode():
        ref = conv3x3_same_int8(jnp.asarray(x), jnp.asarray(wq.transpose(1, 2, 3, 0)),
                                jnp.asarray(scale),
                                None if bias is None else jnp.asarray(bias),
                                block_rows=8, out_dtype=jnp.float32)
    np.testing.assert_allclose(_replay(case), np.asarray(ref), atol=1e-3, rtol=1e-6)


def test_a_tap_shift_is_a_row_shift_of_the_swizzled_window():
    """Any row of a swizzled window may start an operand tile: reading 64
    rows from row r0 gives rows r0..r0+63 of what was written, for every
    r0 a tap can ask for (the swizzle follows the address bits)."""
    rng = np.random.default_rng(0)
    rows = rng.integers(-127, 128, (6 * 66, 128)).astype(np.int8)
    buf = _store_rows(rows)
    for dy in range(3):
        for dx in range(3):
            for ty in range(4):
                r0 = (ty + dy) * 66 + dx
                np.testing.assert_array_equal(_read_tile(buf, r0, 64), rows[r0:r0 + 64])
    # and a k32 step is a 32-byte column slice of the same rows
    np.testing.assert_array_equal(_read_tile(buf, 67, 64)[:, 32:64], rows[67:131, 32:64])
