"""The copied operation and byte counts, on hand-worked shapes, and the
roofline readers on a made-up trace."""

from __future__ import annotations

import math

import pytest

from matbench import counting, harness
from matbench.trace import Readings


def test_attention_work_by_hand():
    # U-Net 320-channel self-attention: 5 heads of 64, 128^2 tokens, biased
    f, b = counting.attention_work(1, 5, 16384, 16384, 64, True)
    assert f == 4 * 5 * 16384 * 16384 * 64 == 343_597_383_680
    assert b == 2 * 5 * (2 * 16384 + 2 * 16384) * 64 + 4 * 16384 == 42_008_576
    t = counting.bound_s(f, b)
    assert t == pytest.approx(f / 989e12)          # bound by operations


def test_conv3x3_work_by_hand():
    f, b = counting.conv3x3_work(2, 1024, 1024, 128, 128, True, False)
    assert f == 2 * 2 * 1024 * 1024 * 128 * 9 * 128
    assert b == 2 * (2 * 1024 * 1024 * (128 + 128) + 9 * 128 * 128) + 4 * 128 + 8 * 2 * 128
    f2, b2 = counting.conv3x3_work(2, 512, 512, 256, 256, True, True)
    assert b2 == 2 * (2 * 512 * 512 * (256 + 2 * 256) + 9 * 256 * 256) + 4 * 256 + 8 * 2 * 256
    # a memory-bound case takes the bytes
    f3, b3 = counting.conv3x3_work(1, 8, 8, 64, 64, False, False)
    assert counting.bound_s(f3, b3) == pytest.approx(b3 / counting.HBM_BYTES_PER_S)


def _k1_args(b, h, lq, lk, d, biased, dtype=1):
    args = [None] * 18
    args[0], args[1] = dtype, d
    args[5] = 12345 if biased else None
    args[12:16] = [b, h, lq, lk]
    return tuple(args)


def _k3_args(b, h, w, cin, cout, gn, res):
    args = [None] * 14
    args[0] = 1
    args[4] = 1 if gn else None
    args[6] = 1 if res else None
    args[8:13] = [b, h, w, cin, cout]
    return tuple(args)


def test_roofline_readers_count_bf16_launches_against_named_kernels():
    r = Readings(kernels=[("void flash_fwd_sm90<64, 3, true>(Fa3Params)", 0.004),
                          ("void flash_fwd_d512_sm90<false>(Fa3Params)", 0.002),
                          ("conv3x3_sm90(Conv90Params)", 0.003),
                          ("elementwise_kernel", 1.0)],
                 launches={"flash_attention_k1": [_k1_args(1, 5, 16384, 16384, 64, True),
                                                  _k1_args(1, 5, 64, 64, 64, False, dtype=0)],
                           "flash_attention_k2": [_k1_args(2, 1, 16384, 16384, 512, False)],
                           "conv3x3": [_k3_args(2, 1024, 1024, 128, 128, True, False)]})
    k1 = harness.load_reader("k1_attn_d64_roofline").read(r)
    least = counting.bound_s(*counting.attention_work(1, 5, 16384, 16384, 64, True))
    assert k1 == pytest.approx(100 * least / 0.004)
    k2 = harness.load_reader("k2_attn_d512_roofline").read(r)
    least2 = counting.bound_s(*counting.attention_work(2, 1, 16384, 16384, 512, False))
    assert k2 == pytest.approx(100 * least2 / 0.002)
    k3 = harness.load_reader("k3_conv3x3_roofline").read(r)
    least3 = counting.bound_s(*counting.conv3x3_work(2, 1024, 1024, 128, 128, True, False))
    assert k3 == pytest.approx(100 * least3 / 0.003)


def test_readers_return_nothing_when_there_is_nothing_to_read():
    empty = Readings()
    for name in ("k1_attn_d64_roofline", "k2_attn_d512_roofline", "k3_conv3x3_roofline",
                 "device.idle_pct", "device.launches_per_matte", "step_mfu",
                 "serve.images_per_call"):
        assert harness.load_reader(name).read(empty) is None, name


def test_device_readers():
    r = Readings(window_s=2.0, busy_s=1.5, kernels=[("k", 0.1)] * 30, mattes=10,
                 flops_per_matte=28.75e12, s_per_matte=0.15)
    assert harness.load_reader("device.idle_pct").read(r) == pytest.approx(25.0)
    assert harness.load_reader("device.launches_per_matte").read(r) == pytest.approx(3.0)
    mfu = harness.load_reader("step_mfu").read(r)
    assert mfu == pytest.approx(100 * 28.75e12 / 989e12 / 0.15)
    assert math.isfinite(mfu)
