"""Port parity: unique_with_counts gives the JAX package's outputs bit for
bit (order decides placement), with duplicates, invalid masks and negative
high words."""
import numpy as np
import pytest
import torch

from tfplus_tpu.kv import unique as ju
from tfplus_tpu_torch.kv import unique as tu


def _case(seed, n, pool, invalid_frac):
    rng = np.random.RandomState(seed)
    universe = rng.randint(-2**31, 2**31, size=(pool, 2)).astype(np.int32)
    universe[: pool // 3, 1] = rng.randint(-4, 0, pool // 3)  # negative hi
    universe[0] = (-1, -1)                                      # EMPTY as a key
    keys = universe[rng.randint(0, pool, n)]
    valid = rng.rand(n) >= invalid_frac
    return keys, valid


@pytest.mark.parametrize("seed,n,pool,invalid_frac", [
    (0, 256, 40, 0.0), (1, 256, 40, 0.3), (2, 1000, 900, 0.1),
    (3, 64, 3, 0.5), (4, 128, 128, 0.0), (5, 50, 10, 1.0)])
def test_unique_with_counts(seed, n, pool, invalid_frac):
    keys, valid = _case(seed, n, pool, invalid_frac)
    j = ju.unique_with_counts(keys, valid)
    t = tu.unique_with_counts(torch.from_numpy(keys), torch.from_numpy(valid))
    for name in ("unique_keys", "inverse", "counts", "num_unique"):
        jv, tv = np.asarray(getattr(j, name)), getattr(t, name)
        assert tv.dtype == torch.int32, name
        np.testing.assert_array_equal(jv, tv.numpy(), name)


def test_unique_without_mask():
    keys, _ = _case(7, 300, 50, 0.0)
    j = ju.unique_with_counts(keys)
    t = tu.unique_with_counts(torch.from_numpy(keys))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
