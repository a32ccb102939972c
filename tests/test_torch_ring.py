"""Port parity for ring and context-parallel attention
(``parallel/ring_attention.py``) over 4 CPU ranks against the JAX package on
4 of the conftest's fake devices (the launcher of test_torch_parallel.py).

Each rank holds its sequence shard of the same q, k, v (made from a seed
with numpy). Cases, each against JAX's same function under ``shard_map``:
the plain ring, causal and not, its dropout (the same global masks for the
same seed) and its gradients; ``ring_flash_attention`` causal and not, and
with dropout (the per-block seeds), forward and gradients, the JAX side in
interpret mode. The non-causal f32 blocks here take the single-pass route
(``flash_fwd_single`` and ``flash_bwd_single``'s plain versions on the
CPU) with the global l and m; the causal ones the tiled route.
``context_parallel_attention``, causal and with dropout. Outputs and
gradients within 1e-5 (f32)."""
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import join, launch, rank_main

NDEV = 4
B, H, S, D = 2, 2, NDEV * 32, 16
TOL = dict(atol=1e-5, rtol=1e-5)
SEED, P_DROP = 42, 0.3
# (name, fn, causal, p_dropout, with gradients)
CASES = (("ring", "ring_attention", False, 0.0, False),
         ("ring_causal", "ring_attention", True, 0.0, True),
         ("ring_dropout", "ring_attention", True, P_DROP, False),
         ("flash", "ring_flash_attention", False, 0.0, True),
         ("flash_causal", "ring_flash_attention", True, 0.0, True),
         ("flash_dropout", "ring_flash_attention", False, P_DROP, True))


def qkv(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, S, D).astype(np.float32) for _ in range(3)]


def _shard(x, rank):
    n = S // NDEV
    return x[:, :, rank * n:(rank + 1) * n]


def port_ring(rank, world, d, out):
    from tfplus_tpu_torch.parallel import ring_attention as ra
    for k, (name, fn, causal, p, grads) in enumerate(CASES):
        q, kk, v = (torch.from_numpy(np.ascontiguousarray(_shard(x, rank)))
                    .requires_grad_(grads) for x in qkv(k))
        o = getattr(ra, fn)(q, kk, v, causal=causal, p_dropout=p,
                            dropout_seed=SEED)
        out[name] = o.detach().numpy()
        if grads:
            torch.sum(o * o).backward()
            for t, g in zip("qkv", (q, kk, v)):
                out[f"{name}.d{t}"] = g.grad.numpy()
    for causal, p in ((True, 0.0), (False, 0.25)):
        q, kk, v = qkv(7)
        o = ra.context_parallel_attention(
            torch.from_numpy(q), torch.from_numpy(_shard(kk, rank).copy()),
            torch.from_numpy(_shard(v, rank).copy()), causal=causal,
            p_dropout=p, dropout_seed=9)
        out[f"cp{int(causal)}"] = o.numpy()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring")
    handle = launch(Path(__file__), NDEV, d)
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from tfplus_tpu import parallel as par
    from tfplus_tpu.parallel import ring_attention as ra
    mesh = par.make_mesh(NDEV, axis_name="sp")
    seq = P(None, None, "sp", None)
    specs = dict(mesh=mesh, in_specs=(seq,) * 3, out_specs=seq,
                 check_vma=False)
    jres = {}
    for k, (name, fn, causal, p, grads) in enumerate(CASES):
        kw = dict(axis_name="sp", causal=causal, p_dropout=p,
                  dropout_seed=SEED)
        if fn == "ring_flash_attention":
            kw.update(block_q=32, block_k=32, interpret=True)
        body = shard_map(functools.partial(getattr(ra, fn), **kw), **specs)
        args = [jnp.asarray(x) for x in qkv(k)]
        jres[name] = np.asarray(jax.jit(body)(*args))
        if grads:
            g = jax.jit(jax.grad(lambda q, k, v: jnp.sum(body(q, k, v) ** 2),
                                 argnums=(0, 1, 2)))(*args)
            for t, x in zip("qkv", g):
                jres[f"{name}.d{t}"] = np.asarray(x)
    for causal, p in ((True, 0.0), (False, 0.25)):
        body = shard_map(functools.partial(
            ra.context_parallel_attention, axis_name="sp", causal=causal,
            p_dropout=p, dropout_seed=9), mesh=mesh,
            in_specs=(P(), seq, seq), out_specs=P(), check_vma=False)
        jres[f"cp{int(causal)}"] = np.asarray(jax.jit(body)(
            *[jnp.asarray(x) for x in qkv(7)]))
    return join(handle), jres


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=2)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ring_matches_jax(run, case):
    ranks, jres = run
    name, fn, causal, p, grads = case
    np.testing.assert_allclose(_cat(ranks, name), jres[name], **TOL)
    if grads:
        for t in "qkv":
            np.testing.assert_allclose(_cat(ranks, f"{name}.d{t}"),
                                       jres[f"{name}.d{t}"], err_msg=t,
                                       **TOL)


def test_ring_dropout_drops_what_the_single_rank_reference_drops(run):
    """The plain ring's masks are global: against the port's own
    single-rank reference on the whole sequence, same seed."""
    ranks, _ = run
    from tfplus_tpu_torch.ops import flash_attention as fa
    q, k, v = (torch.from_numpy(x) for x in qkv(2))
    ref = fa.reference_attention(q, k, v, causal=True, p_dropout=P_DROP,
                                 dropout_seed=SEED)
    np.testing.assert_allclose(_cat(ranks, "ring_dropout"), ref.numpy(),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_context_parallel_matches_jax(run, causal):
    ranks, jres = run
    key = f"cp{int(causal)}"
    for r in ranks:
        np.testing.assert_allclose(r[key], jres[key], **TOL)


if __name__ == "__main__":
    rank_main([port_ring])
