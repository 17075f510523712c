"""The port's copy of eval/ (SAD / MSE / Grad / Conn and the synthetic
composite set) against the JAX package's: both are numpy and scipy, so the
values must be equal exactly, not within a tolerance."""

import numpy as np
import pytest

from sdmatte_tpu.eval import metrics as jax_metrics
from sdmatte_tpu.eval import synthetic as jax_synthetic

from sdmatte_tpu_torch import eval as port_eval
from sdmatte_tpu_torch.eval import metrics, synthetic


@pytest.mark.parametrize("size", [48, 64])
def test_synthetic_set_equals_jax(size):
    ours, ref = synthetic.make_eval_set(size), jax_synthetic.make_eval_set(size)
    assert [c["name"] for c in ours] == [c["name"] for c in ref]
    for a, b in zip(ours, ref):
        for key in ("image", "trimap", "alpha_gt"):
            assert a[key].dtype == b[key].dtype == np.float32
            np.testing.assert_array_equal(a[key], b[key])


def test_trimap_from_alpha_equals_jax(rng):
    alpha = np.clip(rng.normal(0.5, 0.4, (40, 52)), 0, 1).astype(np.float32)
    for band in (1, 4, 8):
        np.testing.assert_array_equal(synthetic.trimap_from_alpha(alpha, band),
                                      jax_synthetic.trimap_from_alpha(alpha, band))


@pytest.mark.parametrize("with_trimap", [True, False])
def test_metrics_equal_jax(rng, with_trimap):
    case = synthetic.make_eval_set(64)[1]
    pred = np.clip(case["alpha_gt"] + rng.normal(0, 0.1, case["alpha_gt"].shape), 0, 1)
    pred[::7, ::5] = 1.0 - pred[::7, ::5]     # speckle for Conn
    tri = case["trimap"] if with_trimap else None
    ours = metrics.evaluate(pred, case["alpha_gt"], trimap=tri)
    assert ours == jax_metrics.evaluate(pred, case["alpha_gt"], trimap=tri)
    assert set(ours) == {"SAD", "MSE", "Grad", "Conn"} and ours["SAD"] > 0
    for name in ("sad", "mse", "grad_error", "conn_error"):
        assert getattr(port_eval, name)(pred, case["alpha_gt"], tri) == \
            getattr(jax_metrics, name)(pred, case["alpha_gt"], tri)


def test_metrics_zero_on_identical():
    case = synthetic.make_eval_set(48)[0]
    row = metrics.evaluate(case["alpha_gt"], case["alpha_gt"], trimap=case["trimap"])
    assert row == {"SAD": 0.0, "MSE": 0.0, "Grad": 0.0, "Conn": 0.0}
