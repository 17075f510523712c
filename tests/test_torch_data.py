"""The port's training data (sdmatte_tpu_torch/parallel/data.py) against the
JAX package's (sdmatte_tpu/parallel/data.py): the composite sampler draws
the same batches bit for bit from the same seed, and the prefetcher hands
them over in the port's NCHW layout, raises a worker's exception in the
consumer and splits the global batch over the processes of a mesh."""

import types

import numpy as np
import pytest
import torch

from sdmatte_tpu.parallel.data import CompositeSampler as JaxSampler

from sdmatte_tpu_torch.parallel.data import CompositeSampler, prefetch_batches, to_tensors

KEYS = ("image", "trimap", "trimap_coords", "is_trans", "alpha_gt")


@pytest.mark.parametrize("size,seed,batch", [(64, 0, 4), (96, 3, 2), (32, 11, 3)])
def test_sampler_matches_jax_bit_for_bit(size, seed, batch):
    ours, ref = CompositeSampler(size=size, seed=seed), JaxSampler(size=size, seed=seed)
    for _ in range(3):
        got, want = ours.batch(batch), ref.batch(batch)
        assert set(got) == set(want) == set(KEYS)
        for k in KEYS:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["image"].shape == (batch, size, size, 3)


def test_sampler_with_sources_matches_jax():
    rng = np.random.default_rng(0)
    sources = [(rng.uniform(0, 1, (50, 70, 3)), rng.uniform(0, 1, (50, 70))) for _ in range(2)]
    got = CompositeSampler(size=32, seed=5, sources=sources).batch(3)
    want = JaxSampler(size=32, seed=5, sources=sources).batch(3)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_to_tensors_is_the_port_layout():
    b = CompositeSampler(size=32, seed=1).batch(2)
    t = to_tensors(b)
    assert t["image"].shape == (2, 3, 32, 32) and t["image"].is_contiguous()
    assert t["trimap"].shape == t["alpha_gt"].shape == (2, 1, 32, 32)
    assert t["trimap_coords"].shape == (2, 4) and t["is_trans"].shape == (2,)
    np.testing.assert_array_equal(t["image"].permute(0, 2, 3, 1).numpy(), b["image"])
    np.testing.assert_array_equal(t["alpha_gt"][:, 0].numpy(), b["alpha_gt"][..., 0])


def test_prefetch_yields_the_sampler_batches_in_order():
    got = list(prefetch_batches(CompositeSampler(size=32, seed=2), 2, steps=3))
    ref = CompositeSampler(size=32, seed=2)
    assert len(got) == 3
    for b in got:
        want = to_tensors(ref.batch(2))
        for k in KEYS:
            assert b[k].device.type == "cpu"
            torch.testing.assert_close(b[k], want[k], rtol=0, atol=0)


class _Failing(CompositeSampler):
    def batch(self, batch_size):
        if getattr(self, "calls", 0) == 1:
            raise RuntimeError("composite failed")
        self.calls = getattr(self, "calls", 0) + 1
        return super().batch(batch_size)


def test_prefetch_raises_a_worker_exception_in_the_consumer():
    it = prefetch_batches(_Failing(size=32, seed=0), 2, steps=3)
    assert next(it)["image"].shape == (2, 3, 32, 32)
    with pytest.raises(RuntimeError, match="composite failed"):
        next(it)


def _mesh_of(world):
    """Stands in for a DeviceMesh of ``world`` processes (prefetch_batches
    reads only its size)."""
    return types.SimpleNamespace(size=lambda: world)


def test_prefetch_splits_the_global_batch_over_a_mesh():
    got = next(prefetch_batches(CompositeSampler(size=32, seed=0), 8, steps=1,
                                mesh=_mesh_of(4)))
    assert got["image"].shape == (2, 3, 32, 32)


def test_prefetch_raises_on_an_uneven_split():
    with pytest.raises(ValueError, match="divide evenly over 2 processes"):
        next(prefetch_batches(CompositeSampler(size=32, seed=0), 3, steps=1,
                              mesh=_mesh_of(2)))
