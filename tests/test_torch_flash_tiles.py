"""K1's and K2's tile arithmetic, emulated on the CPU and held to the references.

The bf16 K1 kernel (csrc/flash_attention.cu, flash_fwd_sm90) reformulates
the softmax for the H100: 128-key tiles, scores in the log2 domain with
scale*log2(e) and bias*log2(e) folded into one FFMA, exp2, fp32 running max
and sum, P rounded to bf16 before the PV product.  Keys past Lk carry
MASK_VALUE as their staged bias, unscaled in the log2 domain, against a K row
of zeros; without a bias the max is taken on the raw scores and the last
tile's keys past Lk are set to -inf.  No CUDA compiler runs here, so this
file replays that arithmetic step by step in fp32 and holds it to
attention_plain and to the JAX Pallas kernel (in interpret mode, as
tests/test_torch_kernels.py runs it), at the kernel checks' bars.

The bf16 K2 kernel (flash_fwd_d512_sm90, d = 512) splits a tile of 64 keys
over two warpgroups: each scores 32 keys over all of d, the two row maxima
are exchanged, P is rounded to bf16 once into a tile both read, and each
accumulates its 256 columns of O (rescaled only where a row's maximum
moved); the row sums stay per warpgroup until the end.  ``k2_tiles`` replays
that split the same way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdmatte_tpu.ops.flash_attention import flash_attention as jax_flash_attention

from sdmatte_tpu_torch.ops.flash_attention import attention_plain

MASK_VALUE = np.float32(-0.7 * np.finfo(np.float32).max)
LOG2E = np.float32(1.4426950408889634)
BK = 128


def k1_tiles(q, k, v, scale, bias, p_bf16=False, trace=None):
    """The kernel's arithmetic on (B, H, L, D) fp32 tensors.  ``trace``, a
    list, receives each tile's running max and sum."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    log2e = torch.tensor(float(LOG2E))
    sl2 = torch.tensor(scale, dtype=torch.float32) * log2e
    m = torch.full((b, h, lq, 1), -torch.inf)
    l = torch.zeros((b, h, lq, 1))
    o = torch.zeros((b, h, lq, d))
    for j in range(-(-lk // BK)):
        n = min(BK, lk - j * BK)
        kt = torch.zeros((b, h, BK, d))  # TMA zero-fills rows past Lk
        vt = torch.zeros((b, h, BK, d))
        kt[:, :, :n] = k[:, :, j * BK:j * BK + n]
        vt[:, :, :n] = v[:, :, j * BK:j * BK + n]
        s = q @ kt.transpose(-1, -2)
        if bias is not None:
            staged = torch.full((b, BK), float(MASK_VALUE))
            staged[:, :n] = bias[:, j * BK:j * BK + n] * log2e
            t = torch.addcmul(staged[:, None, None, :], s, sl2)  # s * c + bias*log2(e)
            m_new = torch.maximum(m, t.amax(-1, keepdim=True))
            p = torch.exp2(t - m_new)
        else:
            s[..., n:] = -torch.inf
            m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
            p = torch.exp2(torch.addcmul(-m_new, s, sl2))  # s * c - m
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        if trace is not None:
            trace.append((m.clone(), l.clone()))
        pv = p.to(torch.bfloat16).float() if p_bf16 else p
        o = o * alpha + pv @ vt
    return o / torch.where(l == 0, torch.ones_like(l), l)


# (b, h, lq, lk, d), biased: Lk 300 leaves a ragged 44-key last tile, Lk 257
# a last tile of one key; with a bias, the last batch's keys all carry -10000
CASES = {
    "ragged_300_biased": ((2, 2, 96, 300, 64), True),
    "one_key_last_tile_biased": ((2, 2, 64, 257, 64), True),
    "ragged_300_unbiased": ((1, 2, 96, 300, 64), False),
    "one_key_last_tile_unbiased": ((1, 2, 64, 257, 64), False),
}


def _inputs(case, seed=7):
    (b, h, lq, lk, d), biased = CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (lq, lk, lk))
    bias = None
    if biased:
        bias = (rng.uniform(0, 1, (b, lk)) < 0.5).astype(np.float32) * -10000.0
        bias[-1] = -10000.0
    return q, k, v, bias, d ** -0.5


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _exact(q, k, v, scale, bias):
    """float64 softmax attention."""
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    if bias is not None:
        s = s + bias[:, None, None, :].astype(np.float64)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v.astype(np.float64))


def _held(got, ref, bias, exact):
    """fp32 P: 2e-5 (the JAX package's fp32 bar) on every batch with an
    unbiased key.  A batch whose keys all carry -10000 scores s - 10000,
    where fp32 keeps 2^-10 (about 5e-4 relative on each P for the
    references as for the kernel): there the emulation is held to the exact
    float64 result no worse than the reference is."""
    full = np.ones(got.shape[0], bool) if bias is None else (bias > -10000.0).any(-1)
    np.testing.assert_allclose(got[full], ref[full], atol=2e-5, rtol=2e-5)
    for i in np.flatnonzero(~full):
        own = np.abs(got[i] - exact[i]).max()
        assert own <= max(np.abs(ref[i] - exact[i]).max(), 2e-5), (own, i)


@pytest.mark.parametrize("case", list(CASES))
def test_k1_tiles_fp32_match_plain(case):
    q, k, v, bias, scale = _inputs(case)
    got = k1_tiles(_t(q), _t(k), _t(v), scale, _t(bias)).numpy()
    ref = attention_plain(_t(q), _t(k), _t(v), scale=scale, bias=_t(bias)).numpy()
    _held(got, ref, bias, _exact(q, k, v, scale, bias))


@pytest.mark.parametrize("case", list(CASES))
def test_k1_tiles_fp32_match_pallas_kernel(case):
    q, k, v, bias, scale = _inputs(case)
    got = k1_tiles(_t(q), _t(k), _t(v), scale, _t(bias)).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), scale=scale,
                                  bias=None if bias is None else jnp.asarray(bias),
                                  block_q=128, block_k=128)
    _held(got, np.asarray(ref, np.float32), bias, _exact(q, k, v, scale, bias))


@pytest.mark.parametrize("case", list(CASES))
def test_k1_tiles_bf16_p_within_the_bf16_bar(case):
    """P rounded to bf16 before PV, on bf16 inputs: the kernel checks' bf16
    bar, max |got - ref| <= 2e-2 * max |ref|, against attention_plain."""
    q, k, v, bias, scale = _inputs(case)
    qb, kb, vb = (_t(x).bfloat16() for x in (q, k, v))
    got = k1_tiles(qb.float(), kb.float(), vb.float(), scale, _t(bias), p_bf16=True)
    ref = attention_plain(qb, kb, vb, scale=scale, bias=_t(bias)).float()
    err = float((got.bfloat16().float() - ref).abs().max())
    assert err <= 2e-2 * float(ref.abs().max()), err


@pytest.mark.parametrize("case", list(CASES))
def test_k1_tiles_keep_the_running_max_and_sum_finite(case):
    """No -inf or NaN reaches the running max or sum after any tile, the
    ragged and single-key last tiles and the all -10000 batch included, and
    MASK_VALUE never leaves the log2 domain scaled (it would overflow)."""
    q, k, v, bias, scale = _inputs(case)
    trace = []
    out = k1_tiles(_t(q), _t(k), _t(v), scale, _t(bias), trace=trace)
    assert len(trace) == -(-k.shape[2] // BK)
    for m, l in trace:
        assert torch.isfinite(m).all() and torch.isfinite(l).all() and (l > 0).all()
    assert torch.isfinite(out).all()
    with np.errstate(over="ignore"):  # why the mask is staged unscaled
        assert np.isinf(MASK_VALUE * LOG2E)


# ------------------------------------------------------------------- K2 ---

K2_BK, K2_HALF, K2_D = 64, 32, 512


def k2_tiles(q, k, v, scale, bias, p_bf16=False, trace=None):
    """K2's arithmetic on (B, H, L, 512) fp32 tensors: key halves, exchanged
    max, P rounded to bf16 once, d halves, keys past Lk."""
    b, h, lq, d = q.shape
    assert d == K2_D
    lk = k.shape[2]
    log2e = torch.tensor(float(LOG2E))
    sl2 = torch.tensor(scale, dtype=torch.float32) * log2e
    m = torch.full((b, h, lq, 1), -torch.inf)
    l_half = [torch.zeros((b, h, lq, 1)) for _ in range(2)]   # one partial sum per warpgroup
    o_half = [torch.zeros((b, h, lq, d // 2)) for _ in range(2)]
    for j in range(-(-lk // K2_BK)):
        n = max(0, min(K2_BK, lk - j * K2_BK))
        kt = torch.zeros((b, h, K2_BK, d))  # TMA zero-fills rows past Lk
        vt = torch.zeros((b, h, K2_BK, d))
        kt[:, :, :n] = k[:, :, j * K2_BK:j * K2_BK + n]
        vt[:, :, :n] = v[:, :, j * K2_BK:j * K2_BK + n]
        t_half, mx_half = [], []
        for w in range(2):                      # each warpgroup's 32 keys, over all of d
            lo = w * K2_HALF
            s = q @ kt[:, :, lo:lo + K2_HALF].transpose(-1, -2)
            valid = n - lo                      # this half's keys inside Lk
            if bias is not None:
                staged = torch.full((b, K2_HALF), float(MASK_VALUE))
                if valid > 0:
                    nv = min(valid, K2_HALF)
                    staged[:, :nv] = bias[:, j * K2_BK + lo:j * K2_BK + lo + nv] * log2e
                s = torch.addcmul(staged[:, None, None, :], s, sl2)
            elif valid < K2_HALF:
                s[..., max(valid, 0):] = -torch.inf
            t_half.append(s)
            mx_half.append(s.amax(-1, keepdim=True))
        mx = torch.maximum(mx_half[0], mx_half[1])      # exchanged through shared memory
        if bias is None:
            mx = mx * sl2                               # the maxima were of raw scores
        m_new = torch.maximum(m, mx)
        alpha = torch.exp2(m - m_new)
        p_tile = []
        for w in range(2):
            if bias is not None:
                p = torch.exp2(t_half[w] - m_new)
            else:
                p = torch.exp2(torch.addcmul(-m_new, t_half[w], sl2))
            l_half[w] = l_half[w] * alpha + p.sum(-1, keepdim=True)
            p_tile.append(p.to(torch.bfloat16).float() if p_bf16 else p)
        p_all = torch.cat(p_tile, -1)                   # the one P tile both warpgroups read
        m = m_new
        if trace is not None:
            trace.append((m.clone(), (l_half[0] + l_half[1]).clone()))
        for w in range(2):                              # each warpgroup's 256 columns of O
            moved = alpha != 1
            o_half[w] = torch.where(moved, o_half[w] * alpha, o_half[w])
            o_half[w] = o_half[w] + p_all @ vt[..., w * 256:(w + 1) * 256]
    l = l_half[0] + l_half[1]
    return torch.cat(o_half, -1) / torch.where(l == 0, torch.ones_like(l), l)


# (b, h, lq, lk), biased.  Lk 170: the last tile's second half holds 10 keys;
# Lk 97: one key; Lk 80: none (a half of -inf or MASK_VALUE only), and the
# first half 16; with a bias, the last batch's keys all carry -10000
K2_CASES = {
    "ragged_130x170_unbiased": ((1, 1, 130, 170), False),
    "ragged_130x170_biased": ((2, 1, 130, 170), True),
    "one_key_second_half_unbiased": ((1, 1, 70, 97), False),
    "empty_second_half_biased": ((2, 1, 64, 80), True),
    "empty_second_half_unbiased": ((1, 2, 33, 80), False),
}


def _k2_inputs(case, seed=11):
    (b, h, lq, lk), biased = K2_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, K2_D)).astype(np.float32) for n in (lq, lk, lk))
    bias = None
    if biased:
        bias = (rng.uniform(0, 1, (b, lk)) < 0.5).astype(np.float32) * -10000.0
        bias[-1] = -10000.0
    return q, k, v, bias, K2_D ** -0.5


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_tiles_fp32_match_plain(case):
    q, k, v, bias, scale = _k2_inputs(case)
    got = k2_tiles(_t(q), _t(k), _t(v), scale, _t(bias)).numpy()
    ref = attention_plain(_t(q), _t(k), _t(v), scale=scale, bias=_t(bias)).numpy()
    _held(got, ref, bias, _exact(q, k, v, scale, bias))


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_tiles_fp32_match_pallas_kernel(case):
    """Against sdmatte_tpu/ops/flash_attention.py::_kernel (d = 512) in
    interpret mode."""
    q, k, v, bias, scale = _k2_inputs(case)
    got = k2_tiles(_t(q), _t(k), _t(v), scale, _t(bias)).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), scale=scale,
                                  bias=None if bias is None else jnp.asarray(bias),
                                  block_q=128, block_k=128)
    _held(got, np.asarray(ref, np.float32), bias, _exact(q, k, v, scale, bias))


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_tiles_bf16_p_within_the_bf16_bar(case):
    q, k, v, bias, scale = _k2_inputs(case)
    qb, kb, vb = (_t(x).bfloat16() for x in (q, k, v))
    got = k2_tiles(qb.float(), kb.float(), vb.float(), scale, _t(bias), p_bf16=True)
    ref = attention_plain(qb, kb, vb, scale=scale, bias=_t(bias)).float()
    err = float((got.bfloat16().float() - ref).abs().max())
    assert err <= 2e-2 * float(ref.abs().max()), err


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_tiles_keep_the_running_max_and_sum_finite(case):
    """A half tile wholly past Lk (all -inf, or all MASK_VALUE) takes the
    other half's maximum: no -inf or NaN reaches the running max or sum."""
    q, k, v, bias, scale = _k2_inputs(case)
    trace = []
    out = k2_tiles(_t(q), _t(k), _t(v), scale, _t(bias), trace=trace)
    assert len(trace) == -(-k.shape[2] // K2_BK)
    for m, l in trace:
        assert torch.isfinite(m).all() and torch.isfinite(l).all() and (l > 0).all()
    assert torch.isfinite(out).all()
