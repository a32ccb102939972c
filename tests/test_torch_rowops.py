"""Port parity: the row ops' plain PyTorch versions (what a CPU tensor runs)
against the JAX package's Pallas kernels in interpret mode — bit-exact, as
these are copies and single adds."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfplus_tpu.ops import rowops as jr
from tfplus_tpu_torch.ops import rowops as tr

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _vals(rng, shape, dt):
    x = rng.randn(*shape).astype(np.float32)
    return jnp.asarray(x, DTYPES[dt][0]), torch.from_numpy(x).to(DTYPES[dt][1])


def _as_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("width", [1, 3, 5, 16, 48])
def test_gather_rows(dt, width):
    rng = np.random.RandomState(width)
    c, n = 37, 64
    jv, tv = _vals(rng, (c, width), dt)
    idx = rng.randint(-3, c, n).astype(np.int32)      # negatives + duplicates
    idx[:2] = [c - 1, 0]
    want = jr._gather_pallas(jv, jnp.asarray(idx), interpret=True)
    got = tr.gather_rows(tv, torch.from_numpy(idx))
    np.testing.assert_array_equal(np.asarray(want, np.float32), _as_np(got))
    np.testing.assert_array_equal(np.asarray(jr.gather_rows(jv, jnp.asarray(idx)),
                                             np.float32), _as_np(got))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("width", [1, 3, 5, 16, 48])
@pytest.mark.parametrize("add", [False, True])
def test_scatter_rows(dt, width, add):
    rng = np.random.RandomState(width + add)
    c, n = 41, 24
    jv, tv = _vals(rng, (c, width), dt)
    jrow, trow = _vals(rng, (n, width), dt)
    idx = rng.permutation(c - 1)[:n].astype(np.int32)  # unique, < c - 1
    idx[:3] = [-1, -5, c - 1]
    want = jr._scatter_pallas(jv, jnp.asarray(idx), jrow, add=add,
                              interpret=True)
    got = tr.scatter_rows(tv, torch.from_numpy(idx), trow, add=add)
    assert got is tv                                  # in place
    np.testing.assert_array_equal(np.asarray(want, np.float32), _as_np(got))


def test_scatter_drops_out_of_range():
    tv = torch.zeros(8, 4)
    rows = torch.ones(3, 4)
    tr.scatter_rows(tv, torch.tensor([-1, 8, 3], dtype=torch.int32), rows)
    assert tv.sum() == 4 and (tv[3] == 1).all()
    got = tr.gather_rows(torch.arange(8.0)[:, None].repeat(1, 4),
                         torch.tensor([-7, 8, 100, 2], dtype=torch.int32))
    np.testing.assert_array_equal(got[:, 0].numpy(), [0, 7, 7, 2])


def test_wrappers_reject_what_the_kernel_does_not_take():
    v = torch.zeros(8, 4)
    with pytest.raises(TypeError):
        tr.gather_rows(v, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError):
        tr.gather_rows(v.double(), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        tr.scatter_rows(v, torch.zeros(3, dtype=torch.int32),
                        torch.zeros(3, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tr.scatter_rows(v, torch.zeros(3, dtype=torch.int32), torch.zeros(3, 5))
    assert tr.gather_rows.launches == 0 and tr.scatter_rows.launches == 0
