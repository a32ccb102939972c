"""Port parity for the distributed tier (``tfplus_tpu_torch/parallel``) over
4 CPU ranks, against the JAX package on 4 of the conftest's fake devices.

The port's side runs in ONE launch per file: 4 processes (this file run as
a script, importing no JAX) join a ``gloo`` group through a ``FileStore``
under the test's tmp dir (so xdist workers never share a port), with a
60 s collective timeout and a 120 s limit on the whole launch, so that a
hung collective fails the test instead of eating the suite's time. Each
rank starts from JAX's shard (``convert.sharded_from_numpy``), runs every
scenario and writes its results; the tests compare rank i with JAX's
``local_shard(t, i)``. Integers (headers, slots, counts, the exchange's
unique and inverse arrays, ``route_stats``, capacities) match bit for bit;
losses within 1e-5 and table state within 2e-5 / 1e-4 (the sums on the
owner and the optimizers round alike only to that); served f32 and int8
rows bit for bit.

Scenarios: lookup and apply over 3 steps (GroupAdam, deferred meta) with
the exchange state, then an eval lookup that inserts nothing and the
sparse lookup; growth past the wall between steps; route-overflow recovery;
the bfloat16 exchange; the sharded host tier; ``save_multihost``
checkpoints restored in the other package both ways; sharded serving (f32
and int8) with a delta refresh.
"""
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
NDEV = 4
DIM = 8
BL = 32                                  # ids per rank and step
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(atol=2e-5, rtol=1e-4)
LAUNCH_TIMEOUT = 120                     # seconds for a whole launch
COLLECTIVE_TIMEOUT = 60                  # seconds for one collective
FIELDS = ("header", "payload", "init_pool", "deleted_keys", "deleted_count",
          "deleted_overflow", "deleted_seen_train", "deleted_seen_pred")


# ---------------------------------------------------------------------------
# the launcher (test_torch_sharded2d.py and test_torch_ring.py use it too)
# ---------------------------------------------------------------------------

def launch(script, world: int, workdir: Path, timeout=LAUNCH_TIMEOUT):
    """Start ``script`` as ``world`` gloo ranks on the CPU; returns a
    handle for :func:`join`. The ranks run while the caller works."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    logs = [workdir / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "wb") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(script), "--rank", str(r), "--world",
                 str(world), "--dir", str(workdir)],
                env=env, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT))
    return procs, logs, workdir, time.monotonic() + timeout, timeout


def join(handle):
    """Each rank's results (the dict its :func:`rank_main` saved). Fails
    the test with the ranks' logs when one exits non-zero or the launch
    passes its time limit; every process is stopped before returning."""
    procs, logs, workdir, deadline, timeout = handle
    world = len(procs)
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        text = "\n".join(f"--- rank {r} (rc {procs[r].returncode}):\n"
                         + logs[r].read_text(errors="replace")[-4000:]
                         for r in bad)
        pytest.fail(f"ranks {bad} failed or passed the {timeout} s limit:\n"
                    f"{text}")
    out = []
    for r in range(world):
        with np.load(workdir / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def rank_main(scenarios):
    """One rank's process: join the gloo group, run each ``scenario(rank,
    world, workdir, out)`` in order and save ``out``'s numpy arrays."""
    import argparse
    from datetime import timedelta
    import torch.distributed as dist
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--dir")
    a = ap.parse_args()
    torch.set_num_threads(1)
    workdir = Path(a.dir)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(workdir / "store"), a.world),
        rank=a.rank, world_size=a.world,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT))
    out = {}
    try:
        for fn in scenarios:
            fn(a.rank, a.world, workdir, out)
    finally:
        dist.destroy_process_group()
    np.savez(workdir / f"rank{a.rank}.npz",
             **{k: np.asarray(v) for k, v in out.items()})
    mods = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "tfplus_tpu"))
    assert not mods, f"a rank imported {mods}"


def save_jax_table(workdir: Path, name: str, stacked) -> None:
    """A JAX stacked table's arrays and config, for :func:`load_shard`."""
    np.savez(workdir / f"{name}.npz",
             **{f: np.asarray(getattr(stacked, f)) for f in FIELDS})
    c = stacked.config
    (workdir / f"{name}.json").write_text(json.dumps(dict(
        dim=c.dim, enter_threshold=c.enter_threshold,
        max_probes=c.max_probes, value_dtype=np.dtype(c.value_dtype).name,
        name=c.name, slot_layout=[list(x) for x in c.slot_layout],
        support_prediction_delta=c.support_prediction_delta)))


def load_shard(workdir: Path, name: str, *index):
    """The port's shard ``index`` (rank, or (r, c)) of a table that
    :func:`save_jax_table` wrote, on the CPU."""
    from tfplus_tpu_torch import convert
    cfg = json.loads((workdir / f"{name}.json").read_text())
    cfg["slot_layout"] = tuple(tuple(x) for x in cfg["slot_layout"])
    config = convert.config_from_numpy(types.SimpleNamespace(**cfg))
    with np.load(workdir / f"{name}.npz") as z:
        arrays = {k: z[k] for k in z.files}
    if len(index) == 1:
        return convert.sharded_from_numpy(arrays, config, index[0], "cpu")
    return convert.sharded_2d_from_numpy(arrays, config, *index, "cpu")


def put_table(out: dict, prefix: str, t) -> None:
    out[prefix + ".header"] = t.header.numpy().copy()
    out[prefix + ".payload"] = t.payload.float().numpy().copy()


def same_shard(port: dict, prefix: str, jtable, what=""):
    """Port rank's saved table against a JAX shard: header bit for bit,
    payload within the state tolerance."""
    np.testing.assert_array_equal(port[prefix + ".header"],
                                  np.asarray(jtable.header), f"{what} header")
    np.testing.assert_allclose(port[prefix + ".payload"],
                               np.asarray(jtable.payload, np.float32),
                               err_msg=f"{what} payload", **STATE_TOL)


# ---------------------------------------------------------------------------
# inputs, the same on both sides
# ---------------------------------------------------------------------------

def train_batches(seed=0, steps=3, hi=2000):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, hi, NDEV * BL).astype(np.int32),
             rng.randn(NDEV * BL).astype(np.float32)) for _ in range(steps)]


def fresh_batches(steps=3, per_rank=48):
    """Mostly fresh ids every step: the tables pass the 64-row wall."""
    out = []
    for s in range(steps):
        base = 1000 * (s + 1)
        ids = np.arange(base, base + NDEV * per_rank, dtype=np.int32)
        ids[:8] = np.arange(8)                    # a few revisits
        out.append((ids, np.full(NDEV * per_rank, 0.5, np.float32)))
    return out


def hot_ids():
    """Every id owned by shard 0 and 16 unique ids per rank: a 4-deep
    bucket overflows."""
    return np.concatenate([(np.arange(1, 17, dtype=np.int64) + d * 100)
                           * NDEV for d in range(NDEV)]).astype(np.int32)


def eval_ids():
    rng = np.random.RandomState(9)
    return rng.randint(0, 4000, NDEV * BL).astype(np.int32)


def sparse_inputs():
    rng = np.random.RandomState(11)
    ids = rng.randint(0, 2000, NDEV * BL).astype(np.int32)
    seg = np.sort(rng.randint(0, 8, NDEV * BL)).astype(np.int32)
    return ids, seg


def hybrid_batches():
    """Three batches of BL ids per shard, fresh but for 4 ids per shard of
    batch 1 in batch 3. Batch k's rows carry day k, so by batch 3 every
    row of batch 1 is in the tier (the coldest go first): each shard
    promotes 4 rows, spills 8, then 32 and 32, the same counts on every
    shard and in both packages."""
    rng = np.random.RandomState(0)
    out = []
    for k in range(3):
        j = np.arange(BL, dtype=np.int64) + 1000 * (k + 1)
        if k == 2:
            j[:4] = np.arange(4) + 1000
        ids = (j[:, None] * NDEV + np.arange(NDEV)).reshape(-1)
        out.append(rng.permutation(ids))
    return out


HYB_BUDGET = 24


def serve_ids():
    rng = np.random.RandomState(5)
    return rng.randint(0, 3000, NDEV * BL).astype(np.int32)


# ---------------------------------------------------------------------------
# the port's side (runs in each rank)
# ---------------------------------------------------------------------------

def _mine(x, rank):
    return x[rank * (len(x) // NDEV):(rank + 1) * (len(x) // NDEV)]


def _port_steps(par, opt, t, batches, rank, lr, out=None, tag=None,
                grow=False, exchange_dtype=None):
    """Lookup, squared-error loss on the rows' sums, apply; optionally a
    growth sweep before each step."""
    for s, (ids, y) in enumerate(batches, start=1):
        if grow:
            tabs, grew = par.grow_sharded_if_needed(
                {"t": t}, incoming_per_shard=2 * BL)
            t = tabs["t"]
            out[f"{tag}.cap{s}"] = np.int64(t.capacity)
        rows, state, t = par.sharded_lookup(
            t, torch.from_numpy(_mine(ids, rank)), defer_meta=True,
            exchange_dtype=exchange_dtype)
        r = rows.clone().requires_grad_(True)
        loss = torch.sum((r.sum(1) - torch.from_numpy(_mine(y, rank))) ** 2)
        loss.backward()
        t = par.sharded_apply_grads(opt, t, state, r.grad, lr=lr, step=s,
                                    exchange_dtype=exchange_dtype)
        if tag is not None:
            out[f"{tag}.loss{s}"] = loss.detach().numpy()
            out[f"{tag}.rows{s}"] = rows.float().numpy()
            if s == 1:
                for f in ("src_inverse", "src_counts", "dest", "own_inverse",
                          "own_slot", "own_counts"):
                    out[f"{tag}.{f}"] = getattr(state, f).numpy()
    return t


def port_train(rank, world, d, out):
    from tfplus_tpu_torch import parallel as par, train as ttrain
    opt = ttrain.GroupAdamOptimizer()
    t = load_shard(d, "train", rank)
    t = _port_steps(par, opt, t, train_batches(), rank, 0.05, out, "train")
    put_table(out, "train", t)
    # eval: reads, inserts nothing
    size = int(t.header.numel())
    rows, state, t = par.sharded_lookup(
        t, torch.from_numpy(_mine(eval_ids(), rank)), train=False)
    out["eval.rows"] = rows.numpy()
    out["eval.own_slot"] = state.own_slot.numpy()
    assert int(t.header.numel()) == size
    put_table(out, "eval", t)
    ids, seg = sparse_inputs()
    comb, _, _ = par.sharded_embedding_lookup_sparse(
        t, torch.from_numpy(_mine(ids, rank)),
        torch.from_numpy(_mine(seg, rank) % 4), 4, train=False,
        combiner="mean")
    out["sparse.rows"] = comb.numpy()
    # a full multihost checkpoint for the JAX side to restore
    from tfplus_tpu_torch.checkpoint import saver
    saver.save_multihost(str(d / "port_ckpt"), {"emb": t},
                         process_id=rank, num_processes=world)


def port_growth(rank, world, d, out):
    from tfplus_tpu_torch import parallel as par, train as ttrain
    opt = ttrain.AdagradOptimizer()
    t = load_shard(d, "grow", rank)
    t = _port_steps(par, opt, t, fresh_batches(), rank, 0.1, out, "grow",
                    grow=True)
    put_table(out, "grow", t)
    out["grow.sizes"] = np.asarray(par.shard_sizes(t))


def port_route(rank, world, d, out):
    from tfplus_tpu_torch import parallel as par, train as ttrain
    from tfplus_tpu_torch.kv import hashing, table as kvt
    opt = ttrain.AdagradOptimizer()
    t = load_shard(d, "route", rank)
    ids = torch.from_numpy(_mine(hot_ids(), rank))
    valid = torch.ones(ids.shape, dtype=torch.bool)
    needed = None
    for k, cap in enumerate((4, None)):
        rows, state, t = par.sharded_lookup(
            t, ids, valid=valid, defer_meta=True,
            bucket_capacity=cap or needed)
        t = par.sharded_apply_grads(opt, t, state, rows * 0.1, lr=0.05,
                                    step=1)
        stats = par.route_stats(state)
        for key, v in stats.items():
            out[f"route{k}.{key}"] = np.int64(v)
        valid = par.dropped_positions(state)
        out[f"route{k}.dropped"] = valid.numpy()
        needed = stats["needed_bucket_capacity"]
    put_table(out, "route", t)
    mine = hot_ids()[hot_ids() % NDEV == rank]
    out["route.counts"] = kvt.get_count(
        t, hashing.encode_ids_raw(torch.from_numpy(mine), "cpu")).numpy()


def port_bf16(rank, world, d, out):
    from tfplus_tpu_torch import parallel as par, train as ttrain
    opt = ttrain.AdagradOptimizer()
    t = load_shard(d, "bf16", rank)
    t = _port_steps(par, opt, t, train_batches(3, steps=2), rank, 0.05, out,
                    "bf16", exchange_dtype=torch.bfloat16)
    put_table(out, "bf16", t)


def port_hybrid(rank, world, d, out):
    from tfplus_tpu_torch import parallel as par, train as ttrain
    opt = ttrain.AdagradOptimizer()
    hyb = par.ShardedHybridTable(load_shard(d, "hybrid", rank),
                                 max_live_per_shard=HYB_BUDGET)
    spilled = 0
    for s, b in enumerate(hybrid_batches(), start=1):
        out[f"hybrid.promoted{s}"] = np.int64(hyb.prefetch(b))
        ids = _mine(b, rank).astype(np.int32)
        rows, state, hyb.table = par.sharded_lookup(
            hyb.table, torch.from_numpy(ids), defer_meta=True, day=s)
        r = rows.clone().requires_grad_(True)
        y = torch.from_numpy((ids % 5).astype(np.float32))
        torch.mean((r.sum(-1) - y) ** 2).backward()
        hyb.table = par.sharded_apply_grads(opt, hyb.table, state, r.grad,
                                            lr=0.05, step=s)
        spilled += hyb.maybe_spill()
        st = hyb.stats()
        out[f"hybrid.dev{s}"] = np.int64(st["device_rows_per_shard"][0])
        out[f"hybrid.tier{s}"] = np.int64(st["tier_rows_per_shard"][0])
    out["hybrid.spilled"] = np.int64(spilled)
    put_table(out, "hybrid", hyb.table)
    keys, payload, meta = hyb.tier.live_rows()
    order = np.argsort(keys)
    out["hybrid.tier_keys"] = keys[order]
    out["hybrid.tier_payload"] = payload[order]
    out["hybrid.tier_meta"] = meta[order]


def port_serving(rank, world, d, out):
    from tfplus_tpu_torch import parallel as par
    srv = d / "export"
    ids = torch.from_numpy(_mine(serve_ids(), rank))
    for quantize in (False, True):
        tag = "int8" if quantize else "f32"
        tables, _ = par.serving.load_for_serving_sharded(
            str(srv), quantize=quantize, device="cpu")
        look = par.serving.make_serving_lookup(tables["emb"])
        out[f"serve.{tag}"] = look(ids).numpy()
        out[f"serve.{tag}.cap"] = np.int64(tables["emb"].capacity)
        tables = par.serving.refresh_sharded_from_delta(
            tables, str(d / "delta"), quantize=quantize)
        out[f"serve.{tag}.refreshed"] = par.serving.make_serving_lookup(
            tables["emb"])(ids).numpy()
        rows, ovf, needed = par.serving.sharded_serving_lookup(
            tables["emb"], ids, bucket_capacity=2)
        out[f"serve.{tag}.ovf"] = np.int64(bool(ovf))
        out[f"serve.{tag}.needed"] = np.int64(int(needed))


PORT_SCENARIOS = (port_train, port_growth, port_route, port_bf16,
                  port_hybrid, port_serving)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_env():
    import functools
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from tfplus_tpu import parallel as jpar, train as jtrain
    return types.SimpleNamespace(functools=functools, jax=jax, jnp=jnp,
                                 shard_map=shard_map, P=P, par=jpar,
                                 train=jtrain,
                                 mesh=jpar.make_mesh(NDEV))


def _jax_table(J, opt, cap, seed):
    t = J.par.create_sharded(DIM, cap, NDEV, seed=seed)
    t = J.par.init_optimizer_sharded(opt, t)
    return J.jax.device_put(t, J.par.table_sharding(J.mesh))


def _jax_step(J, opt, lr, tspec, exchange_dtype=None):
    P = J.P

    @J.functools.partial(
        J.shard_map, mesh=J.mesh, in_specs=(tspec, P("mp"), P("mp"), P()),
        out_specs=(tspec, P("mp"), P("mp"), P("mp"), P("mp"), P("mp"),
                   P("mp"), P("mp"), P("mp"), P("mp")), check_vma=False)
    def step(t, ids, y, s):
        rows, st, t = J.par.sharded_lookup(t, ids, defer_meta=True,
                                           exchange_dtype=exchange_dtype)

        def loss_fn(r):
            return J.jnp.sum((r.sum(1) - y) ** 2)

        val, g = J.jax.value_and_grad(loss_fn)(rows)
        t = J.par.sharded_apply_grads(opt, t, st, g, lr=lr, step=s,
                                      exchange_dtype=exchange_dtype)
        return (t, val[None], rows, st.src_inverse, st.src_counts, st.dest,
                st.own_inverse, st.own_slot, st.own_counts,
                st.table_overflow[None])

    return J.jax.jit(step)


def _jax_steps(J, opt, t, batches, lr, grow=False, exchange_dtype=None):
    tspec = J.jax.tree_util.tree_map(lambda _: J.P("mp"), t)
    step = _jax_step(J, opt, lr, tspec, exchange_dtype)
    hist = []
    for s, (ids, y) in enumerate(batches, start=1):
        cap = None
        if grow:
            tabs, _ = J.par.grow_sharded_if_needed(
                {"t": t}, incoming_per_shard=2 * BL,
                sharding=J.par.table_sharding(J.mesh))
            t = tabs["t"]
            cap = t.header.shape[-2] * 16
            tspec = J.jax.tree_util.tree_map(lambda _: J.P("mp"), t)
            step = _jax_step(J, opt, lr, tspec, exchange_dtype)
        t, loss, rows, *st = step(t, J.jnp.asarray(ids), J.jnp.asarray(y),
                                  J.jnp.int32(s))
        hist.append(dict(loss=np.asarray(loss), rows=np.asarray(rows),
                         cap=cap, state=[np.asarray(x) for x in st]))
    return t, hist


STATE_FIELDS = ("src_inverse", "src_counts", "dest", "own_inverse",
                "own_slot", "own_counts")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's starting tables and checkpoint out, the 4 ranks run, JAX's
    side of every scenario computed; returns (ranks, jax results)."""
    d = tmp_path_factory.mktemp("parallel")
    J = _jax_env()
    from tfplus_tpu.checkpoint import saver as jsaver
    from tfplus_tpu import serving as jserving, kv as jkv
    jres = {}
    gadam, adagrad = J.train.GroupAdamOptimizer(), J.train.AdagradOptimizer()
    start = {"train": _jax_table(J, gadam, 256, 4),
             "grow": _jax_table(J, adagrad, 64, 2),
             "route": _jax_table(J, adagrad, 512, 3),
             "bf16": _jax_table(J, adagrad, 256, 3),
             "hybrid": _jax_table(J, adagrad, 128, 5)}
    for name, t in start.items():
        save_jax_table(d, name, t)
    # a JAX multihost checkpoint (one bundle per process) for the ranks
    shards = [J.par.local_shard(start["train"], i) for i in range(NDEV)]
    for p in range(NDEV):
        jsaver.save_multihost(str(d / "jax_ckpt"), {"emb": [shards[p]]},
                              process_id=p, num_processes=NDEV)
    # a serving export of one table, and a trainer's 4-shard delta that
    # rewrites every row (250 keys a shard)
    rng = np.random.RandomState(0)
    keys = np.arange(1000, dtype=np.int64) * 3
    single = jkv.insert(jkv.create(DIM, 4096, seed=3),
                        jkv.encode_ids_np_to_device(keys),
                        J.jnp.asarray(rng.randn(1000, DIM).astype(np.float32)))
    md = jserving.RankingMetadata()
    md.add_embedding_column(column_name="emb", var_name="emb",
                            embedding_dim=DIM)
    jserving.export_for_serving(str(d / "export"), {"emb": single}, md)
    sharded = []
    for i in range(NDEV):
        mine = keys[keys % NDEV == i]
        sharded.append(jkv.insert(
            jkv.create(DIM, 1024, seed=3), jkv.encode_ids_np_to_device(mine),
            J.jnp.asarray(rng.randn(len(mine), DIM).astype(np.float32))))
    jsaver.save(str(d / "delta"), {"emb": sharded}, delta=True)

    handle = launch(Path(__file__), NDEV, d)

    # JAX's side of each scenario
    t, jres["train"] = _jax_steps(J, gadam, start["train"], train_batches(),
                                  0.05)
    jres["train_table"] = t
    tspec = J.jax.tree_util.tree_map(lambda _: J.P("mp"), t)

    @J.functools.partial(J.shard_map, mesh=J.mesh,
                         in_specs=(tspec, J.P("mp")),
                         out_specs=(J.P("mp"), J.P("mp"), tspec),
                         check_vma=False)
    def evaluate(t, ids):
        rows, st, t = J.par.sharded_lookup(t, ids, train=False)
        return rows, st.own_slot, t

    jres["eval"] = J.jax.jit(evaluate)(t, J.jnp.asarray(eval_ids()))
    ids, seg = sparse_inputs()

    @J.functools.partial(J.shard_map, mesh=J.mesh,
                         in_specs=(tspec, J.P("mp"), J.P("mp")),
                         out_specs=J.P("mp"), check_vma=False)
    def sparse(t, ids, seg):
        out, _, _ = J.par.sharded_embedding_lookup_sparse(
            t, ids, seg % 4, 4, train=False, combiner="mean")
        return out

    jres["sparse"] = np.asarray(J.jax.jit(sparse)(
        t, J.jnp.asarray(ids), J.jnp.asarray(seg)))
    t, jres["grow"] = _jax_steps(J, adagrad, start["grow"], fresh_batches(),
                                 0.1, grow=True)
    jres["grow_table"] = t
    jres["grow_sizes"] = J.par.shard_sizes(t)

    t, jres["bf16"] = _jax_steps(J, adagrad, start["bf16"],
                                 train_batches(3, steps=2), 0.05,
                                 exchange_dtype=J.jnp.bfloat16)
    jres["bf16_table"] = t
    jres["route"] = _jax_route(J, adagrad, start["route"])
    jres["hybrid"] = _jax_hybrid(J, adagrad, start["hybrid"])
    jres["serve"] = _jax_serving(J, d)
    ranks = join(handle)
    # both checkpoints restored by both packages into 4 fresh templates
    from tfplus_tpu_torch.checkpoint import saver as tsaver
    from tfplus_tpu_torch.kv import table as tkvt
    for ck in ("jax_ckpt", "port_ckpt"):
        jres[ck] = (
            jsaver.restore_multihost(str(d / ck), {"emb": [
                jkv.create(DIM, 256) for _ in range(NDEV)]})[0]["emb"],
            tsaver.restore_multihost(str(d / ck), {"emb": [
                tkvt.create(DIM, 256, device="cpu")
                for _ in range(NDEV)]})[0]["emb"])

    return ranks, jres


def _jax_route(J, opt, t):
    from tfplus_tpu import kv as jkv
    rspec = J.jax.tree_util.tree_map(lambda _: J.P("mp"), t)
    P = J.P

    def build(cap):
        @J.functools.partial(J.shard_map, mesh=J.mesh,
                             in_specs=(rspec, P("mp"), P("mp")),
                             out_specs=(rspec, P("mp"), P("mp"), P(), P()),
                             check_vma=False)
        def rstep(tab, ids, valid):
            rows, st, tab = J.par.sharded_lookup(
                tab, ids, valid=valid, defer_meta=True, bucket_capacity=cap)
            tab = J.par.sharded_apply_grads(opt, tab, st, rows * 0.1,
                                            lr=0.05, step=1)
            return (tab, J.par.dropped_positions(st),
                    st.route_overflow[None].astype(J.jnp.int32),
                    st.route_dropped, st.needed_bucket_capacity)
        return J.jax.jit(rstep)

    ids = J.jnp.asarray(hot_ids())
    valid = J.jnp.ones((len(hot_ids()),), bool)
    steps, needed = [], 4
    for cap in (4, None):
        t, dropped, ovf, rd, nd = build(cap or needed)(t, ids, valid)
        steps.append(dict(dropped=np.asarray(dropped), ovf=np.asarray(ovf),
                          route_dropped=int(rd), needed=int(nd)))
        valid = dropped
        needed = int(nd)
    host = J.jax.device_get(t)
    counts = []
    for i in range(NDEV):
        mine = hot_ids()[hot_ids() % NDEV == i].astype(np.int64)
        counts.append(np.asarray(jkv.get_count(
            J.par.local_shard(host, i), jkv.encode_ids_np_to_device(mine))))
    return dict(steps=steps, table=t, counts=counts)


def _jax_hybrid(J, opt, t):
    hyb = J.par.ShardedHybridTable(t, J.mesh, max_live_per_shard=HYB_BUDGET)
    tspec = J.jax.tree_util.tree_map(lambda _: J.P("mp"), hyb.table)
    P = J.P

    @J.functools.partial(J.shard_map, mesh=J.mesh,
                         in_specs=(tspec, P("mp"), P("mp"), P()),
                         out_specs=tspec, check_vma=False)
    def step(tab, ids, y, s):
        rows, st, tab = J.par.sharded_lookup(tab, ids, defer_meta=True,
                                             day=s)
        _, g = J.jax.value_and_grad(
            lambda r: J.jnp.mean((r.sum(-1) - y) ** 2))(rows)
        return J.par.sharded_apply_grads(opt, tab, st, g, lr=0.05, step=s)

    jstep = J.jax.jit(step)
    stats, promoted, spilled = [], [], 0
    for s, b in enumerate(hybrid_batches(), start=1):
        promoted.append(hyb.prefetch(b))
        hyb.table = jstep(hyb.table, J.jnp.asarray(b.astype(np.int32)),
                          J.jnp.asarray((b % 5).astype(np.float32)),
                          J.jnp.int32(s))
        spilled += hyb.maybe_spill()
        stats.append(hyb.stats())
    tiers = []
    for i in range(NDEV):
        keys, payload, meta = hyb.tiers[i].live_rows()
        order = np.argsort(keys)
        tiers.append((keys[order], payload[order], meta[order]))
    return dict(stats=stats, promoted=promoted, spilled=spilled,
                table=J.jax.device_get(hyb.table), tiers=tiers)


def _jax_serving(J, d):
    from tfplus_tpu.parallel import serving as jsrv
    out = {}
    for quantize in (False, True):
        tag = "int8" if quantize else "f32"
        tables, _ = jsrv.load_for_serving_sharded(str(d / "export"), J.mesh,
                                                  quantize=quantize)
        look = jsrv.make_serving_lookup(tables["emb"], J.mesh)
        out[tag] = np.asarray(look(J.jnp.asarray(serve_ids())))
        out[tag + ".cap"] = tables["emb"].header.shape[-2] * 16
        tables = jsrv.refresh_sharded_from_delta(tables, str(d / "delta"),
                                                 J.mesh, quantize=quantize)
        out[tag + ".refreshed"] = np.asarray(jsrv.make_serving_lookup(
            tables["emb"], J.mesh)(J.jnp.asarray(serve_ids())))
    return out


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks])


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_lookup_and_apply_match_jax(run):
    ranks, jres = run
    host = jres["train_table"]
    for s, h in enumerate(jres["train"], start=1):
        np.testing.assert_allclose(
            np.stack([r[f"train.loss{s}"] for r in ranks]), h["loss"],
            err_msg=f"loss {s}", **LOSS_TOL)
        np.testing.assert_allclose(_cat(ranks, f"train.rows{s}"), h["rows"],
                                   err_msg=f"rows {s}", **STATE_TOL)
    for f, j in zip(STATE_FIELDS, jres["train"][0]["state"]):
        np.testing.assert_array_equal(_cat(ranks, f"train.{f}"), j, f)
    import jax
    host = jax.device_get(host)
    for i, r in enumerate(ranks):
        same_shard(r, "train", jax.tree_util.tree_map(lambda x: x[i], host),
                   f"rank {i}")


def test_eval_lookup_inserts_nothing_and_sparse_lookup(run):
    ranks, jres = run
    rows, own_slot, t = jres["eval"]
    np.testing.assert_allclose(_cat(ranks, "eval.rows"), np.asarray(rows),
                               **STATE_TOL)
    np.testing.assert_array_equal(_cat(ranks, "eval.own_slot"),
                                  np.asarray(own_slot))
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["eval.header"], r["train.header"])
        np.testing.assert_array_equal(r["eval.header"],
                                      np.asarray(t.header)[i])
    np.testing.assert_allclose(_cat(ranks, "sparse.rows"), jres["sparse"],
                               **STATE_TOL)


def test_growth_past_the_wall_matches_jax(run):
    ranks, jres = run
    import jax
    for s, h in enumerate(jres["grow"], start=1):
        assert {int(r[f"grow.cap{s}"]) for r in ranks} == {h["cap"]}, s
        np.testing.assert_allclose(
            np.stack([r[f"grow.loss{s}"] for r in ranks]), h["loss"],
            **LOSS_TOL)
    assert jres["grow"][-1]["cap"] > 64
    host = jax.device_get(jres["grow_table"])
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["grow.sizes"], jres["grow_sizes"])
        same_shard(r, "grow", jax.tree_util.tree_map(lambda x: x[i], host),
                   f"rank {i}")


def test_route_overflow_recovery_matches_jax(run):
    ranks, jres = run
    import jax
    j = jres["route"]
    for k, js in enumerate(j["steps"]):
        for r in ranks:
            assert int(r[f"route{k}.route_dropped"]) == js["route_dropped"]
            assert int(r[f"route{k}.needed_bucket_capacity"]) == js["needed"]
        np.testing.assert_array_equal(
            np.stack([r[f"route{k}.route_overflow"] for r in ranks]),
            js["ovf"])
        np.testing.assert_array_equal(_cat(ranks, f"route{k}.dropped"),
                                      js["dropped"])
    assert j["steps"][0]["route_dropped"] > 0
    assert j["steps"][1]["route_dropped"] == 0
    host = jax.device_get(j["table"])
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["route.counts"], j["counts"][i])
        assert (r["route.counts"] == 1).all() or r["route.counts"].size == 0
        same_shard(r, "route", jax.tree_util.tree_map(lambda x: x[i], host),
                   f"rank {i}")


def test_bf16_exchange_matches_jax(run):
    ranks, jres = run
    import jax
    for s, h in enumerate(jres["bf16"], start=1):
        np.testing.assert_allclose(_cat(ranks, f"bf16.rows{s}"), h["rows"],
                                   **STATE_TOL)
    host = jax.device_get(jres["bf16_table"])
    for i, r in enumerate(ranks):
        same_shard(r, "bf16", jax.tree_util.tree_map(lambda x: x[i], host),
                   f"rank {i}")


def test_sharded_host_tier_matches_jax(run):
    ranks, jres = run
    j = jres["hybrid"]
    assert sum(int(r["hybrid.spilled"]) for r in ranks) == j["spilled"] > 0
    for s, st in enumerate(j["stats"], start=1):
        assert [int(r[f"hybrid.dev{s}"]) for r in ranks] == \
            st["device_rows_per_shard"], s
        assert [int(r[f"hybrid.tier{s}"]) for r in ranks] == \
            st["tier_rows_per_shard"], s
        assert max(st["device_rows_per_shard"]) <= HYB_BUDGET
    assert sum(j["promoted"]) == 4 * NDEV
    assert [sum(int(r[f"hybrid.promoted{s}"]) for r in ranks)
            for s in (1, 2, 3)] == j["promoted"]
    import jax
    for i, r in enumerate(ranks):
        same_shard(r, "hybrid",
                   jax.tree_util.tree_map(lambda x: x[i], j["table"]),
                   f"rank {i}")
        keys, payload, meta = j["tiers"][i]
        np.testing.assert_array_equal(r["hybrid.tier_keys"], keys)
        np.testing.assert_array_equal(r["hybrid.tier_meta"], meta)
        np.testing.assert_allclose(r["hybrid.tier_payload"], payload,
                                   **STATE_TOL)


@pytest.mark.parametrize("ckpt", ["jax_ckpt", "port_ckpt"])
def test_multihost_checkpoints_cross_packages(run, ckpt):
    """JAX's per-process bundles (one per fake process) and the ranks'
    ``save_multihost`` bundles, each restored by both packages: every
    shard bit for bit, and the ranks' trained rows per key."""
    ranks, jres = run
    jtabs, ttabs = jres[ckpt]
    for i in range(NDEV):
        np.testing.assert_array_equal(ttabs[i].header.numpy(),
                                      np.asarray(jtabs[i].header))
        np.testing.assert_array_equal(ttabs[i].payload.numpy(),
                                      np.asarray(jtabs[i].payload))
    if ckpt == "port_ckpt":
        from tfplus_tpu_torch.kv import table as tkvt
        for i, r in enumerate(ranks):
            t = ttabs[i]
            keys = t.header.view(-1, 4, 16)
            live = ~(((keys[:, 0] == -1) | (keys[:, 0] == -2))
                     & (keys[:, 1] == -1)).reshape(-1)
            q = torch.stack([keys[:, 0].reshape(-1), keys[:, 1].reshape(-1)],
                            -1)[live]
            hdr = torch.from_numpy(r["train.header"])
            trained = tkvt.KvTable(
                header=hdr, payload=torch.from_numpy(r["train.payload"]),
                init_pool=t.init_pool, config=t.config,
                **tkvt._empty_deletion_log("cpu"))
            got = tkvt.find(trained, q)
            assert bool(got.found.all())
            np.testing.assert_array_equal(
                trained.payload[got.slot.long()].numpy(),
                t.payload[tkvt.find(t, q).slot.long()].numpy())


def test_sharded_serving_matches_jax(run):
    ranks, jres = run
    j = jres["serve"]
    for tag in ("f32", "int8"):
        np.testing.assert_array_equal(_cat(ranks, f"serve.{tag}"), j[tag])
        np.testing.assert_array_equal(_cat(ranks, f"serve.{tag}.refreshed"),
                                      j[tag + ".refreshed"])
        assert {int(r[f"serve.{tag}.cap"]) for r in ranks} == \
            {j[tag + ".cap"]}
        # a 2-deep bucket overflows on every rank, with one needed size
        assert {int(r[f"serve.{tag}.ovf"]) for r in ranks} == {1}
        assert len({int(r[f"serve.{tag}.needed"]) for r in ranks}) == 1
    assert not np.array_equal(j["f32"], j["f32.refreshed"])


if __name__ == "__main__":
    rank_main(PORT_SCENARIOS)
