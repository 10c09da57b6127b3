"""PyTorch port: the calibration pick `top_k_outliers_from_scales` orders
tied scales as mixq_tpu/ops/quant.py does. jax.lax.top_k keeps the lower
index first among equal values; the port's pick must give the same indices
in the same order (and so the same set), since calibration scales are f32
maxima of bf16 activations and ties near the cut are the normal case."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.ops import quant as JQ
from mixq_tpu_torch.ops import quant as TQ


def tied_scales(seed, K, levels):
    """Integer-valued f32 scales in [0, levels): many ties at every value."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, levels, K).astype(np.float32)


def assert_same_pick(s, n, budget):
    K = s.shape[0]
    j = JQ.top_k_outliers_from_scales(jnp.asarray(s), n, K, budget)
    p = TQ.top_k_outliers_from_scales(torch.from_numpy(s.copy()), n, K,
                                      budget)
    np.testing.assert_array_equal(np.asarray(j.ind), p.ind.numpy())
    assert set(np.asarray(j.ind)[:n].tolist()) == set(p.ind[:n].tolist())
    np.testing.assert_array_equal(np.asarray(j.mask), p.mask.numpy())
    np.testing.assert_array_equal(np.asarray(j.k_mask), p.k_mask.numpy())
    assert int(j.count) == int(p.count) == n


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("K,n,levels", [(4096, 128, 20), (4096, 128, 4),
                                        (64, 16, 3)])
def test_tied_scales_pick_as_jax(seed, K, n, levels):
    assert_same_pick(tied_scales(seed, K, levels), n, n)


def test_all_equal_takes_the_lowest_indices():
    s = np.full(256, 3.0, np.float32)
    assert_same_pick(s, 16, 32)
    p = TQ.top_k_outliers_from_scales(torch.from_numpy(s), 16, 256, 32)
    assert p.ind[:16].tolist() == list(range(16))


def test_top_indices_helper_is_a_stable_descending_pick():
    s = torch.tensor([1.0, 5.0, 5.0, -float("inf"), 2.0, 5.0, 2.0])
    assert TQ.top_indices(s, 5).tolist() == [1, 2, 5, 4, 6]
