"""Port parity for the monotone compactor: every case of test_compactor.py
goes through the port's ``compact`` (on the CPU, its plain version) and the
JAX package's Pallas ``compact`` in interpret mode, bit for bit: the live
rows ``packed[:n]``, the live rows' ``new_loc``, and 0 as the dead rows'
``new_loc`` (the kernel's contract). The port's ``compact_reference`` equals
the JAX oracle in full (dead rows' ``new_loc`` is their prefix count there).
Row copies are exact, so every comparison is bit for bit."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tfplus_tpu.ops import compactor as jc
from tfplus_tpu_torch.ops import compactor as tc


def _clustered(m):
    live = np.zeros(m, bool)
    live[:64] = True          # solid live run
    live[200:208] = True      # tiny island
    live[320:512] = True      # tail run (whole blocks dead between)
    return live


def _pattern(pattern, m):
    return np.array((pattern * 4)[:m], bool)


CASES = {
    # (M, W, R, live mask maker, out_rows, dtype)
    "frac0": (512, 128, 32, lambda r, m: r.rand(m) < 0.0, None, "f32"),
    "frac0.3": (512, 128, 32, lambda r, m: r.rand(m) < 0.3, None, "f32"),
    "frac2/3": (512, 128, 32, lambda r, m: r.rand(m) < 2 / 3, None, "f32"),
    "frac0.97": (512, 128, 32, lambda r, m: r.rand(m) < 0.97, None, "f32"),
    "frac1": (512, 128, 32, lambda r, m: r.rand(m) < 1.0, None, "f32"),
    "clustered": (512, 128, 32, lambda r, m: _clustered(m), None, "f32"),
    "single_live": (64, 128, 16, lambda r, m: _pattern([1] * 16, m), None,
                    "f32"),
    "single_dead": (64, 128, 16, lambda r, m: _pattern([0] * 16, m), None,
                    "f32"),
    "single_crossing": (64, 128, 16, lambda r, m: _pattern([1, 0] * 8, m),
                        None, "f32"),
    "out_rows_gt_m": (256, 256, 32, lambda r, m: r.rand(m) < 0.5, 320,
                      "f32"),
    "bf16": (256, 128, 32, lambda r, m: r.rand(m) < 0.6, None, "bf16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_matches_jax(case):
    m, w, r, make_live, out_rows, dt = CASES[case]
    rng = np.random.RandomState(1 if case.startswith("frac") else 3)
    arena = rng.randn(m, w).astype(np.float32)
    live = make_live(rng, m)
    if dt == "bf16":
        arena = arena.astype(ml_dtypes.bfloat16)
        t_arena = torch.from_numpy(arena.view(np.uint16).copy()).view(
            torch.bfloat16)
    else:
        t_arena = torch.from_numpy(arena)
    t_live = torch.from_numpy(live)
    n = int(live.sum())

    jp, jl = jc.compact(jnp.asarray(arena), jnp.asarray(live), block_rows=r,
                        out_rows=out_rows, interpret=True)
    tp, tl = tc.compact(t_arena, t_live, block_rows=r, out_rows=out_rows)
    assert tp.dtype == torch.float32 and tl.dtype == torch.int32
    assert tuple(tp.shape) == tuple(jp.shape) and tuple(tl.shape) == (m,)
    np.testing.assert_array_equal(tp[:n].numpy(), np.asarray(jp)[:n])
    np.testing.assert_array_equal(tp[:n].numpy(),
                                  arena[live].astype(np.float32))
    np.testing.assert_array_equal(tl.numpy()[live], np.asarray(jl)[live])
    assert (tl.numpy()[~live] == 0).all()
    np.testing.assert_array_equal(np.asarray(jl)[~live], 0)

    jrp, jrl = jc.compact_reference(jnp.asarray(arena), jnp.asarray(live),
                                    out_rows)
    trp, trl = tc.compact_reference(t_arena, t_live, out_rows)
    np.testing.assert_array_equal(trp.float().numpy(),
                                  np.asarray(jrp).astype(np.float32))
    np.testing.assert_array_equal(trl.numpy(), np.asarray(jrl))
    assert tc.compact.launches == 0              # the CPU runs no kernel


def test_compact_raises_as_jax_does():
    arena = torch.zeros(96, 128)
    live = torch.ones(96, dtype=torch.bool)
    for kw, arr in (({"block_rows": 64}, arena),          # M % R
                    ({"block_rows": 32}, torch.zeros(96, 100)),  # W % 128
                    ({"block_rows": 32, "out_rows": 100}, arena)):
        with pytest.raises(ValueError):
            tc.compact(arr, live[:arr.shape[0]], **kw)
        with pytest.raises(ValueError):
            jc.compact(jnp.asarray(arr.numpy()),
                       jnp.asarray(live[:arr.shape[0]].numpy()),
                       interpret=True, **kw)
    with pytest.raises(TypeError):
        tc.compact(arena.double(), live, block_rows=32)
    with pytest.raises(TypeError):
        tc.compact(arena, live.int(), block_rows=32)
