"""Sharded DLRM training, one process per rank: the port's twin of
examples/train_dlrm_sharded.py, the flagship distributed configuration
("DLRM-style multi-table row-sharded training with all-to-all exchange").

Every table is row-sharded over the ranks (``key % world``) and the batch
is data-parallel over the same ranks: per step, each rank dedups its ids,
all-to-alls them to the owner shards, owners do the fused
lookup-or-insert, rows ride the mirrored all-to-all back, and gradients
take the reverse path into the fused sparse-optimizer update. Finishes
with a sharded checkpoint save + elastic N→2N restore.

Usage: torchrun --nproc-per-node=N -m \
           tfplus_tpu_torch.examples.train_dlrm_sharded [--cpu] [--batches 60]

Each rank joins through ``env://`` (as torchrun sets it): gloo on the CPU
with ``--cpu``, else NCCL on ``cuda:<LOCAL_RANK>``. Started without
torchrun it runs as a world of one rank. Every rank draws the same global
batch from the seed and trains on its slice; rank 0 prints.
"""
import argparse
import os
import shutil
import tempfile
import time
import zlib


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8,
                    help="the most ranks to train on; the world is "
                         "the number of processes torchrun starts")
    ap.add_argument("--cols", type=int, default=1,
                    help="column shards per table (2D sparse parallelism; "
                         "world/cols row shards x cols col shards)")
    ap.add_argument("--batches", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--tables", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=1 << 13,
                    help="initial per-shard capacity; tables GROW online "
                         "when the load factor or an overflow flag trips")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.002)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--bucket-capacity", type=int, default=None,
                    help="per-destination exchange-bucket capacity (unique "
                         "ids per source->owner pair); default 2x balanced "
                         "load. Set low (e.g. 8) to demo the automatic "
                         "route-overflow recovery: the step surfaces the "
                         "needed capacity and retries exactly the dropped "
                         "ids — nothing is lost")
    ap.add_argument("--bf16-exchange", action="store_true",
                    help="halve the all_to_all wire bytes (lossy; "
                         "table state stays f32)")
    return ap.parse_args(argv)


def join(args):
    """Join the ranks' process group (env:// under torchrun, else a world
    of one on a free localhost port). Returns ``(device, joined)``."""
    import socket
    import torch
    import torch.distributed as dist
    from ..parallel import mesh as pmesh
    from ..utils import device as _dev
    backend = "gloo" if args.cpu else "nccl"
    if dist.is_initialized():
        joined = False
    elif "WORLD_SIZE" in os.environ:
        pmesh.initialize_multihost(backend=backend)
        joined = True
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        pmesh.initialize_multihost(f"tcp://localhost:{port}", world_size=1,
                                   rank=0, backend=backend)
        joined = True
    dev = (torch.device("cpu") if args.cpu
           else _dev.resolve(pmesh.default_device()))
    return dev, joined


def table_seed(name):
    """A per-table init seed that every rank computes alike (Python's
    ``hash`` of a str is salted per process)."""
    return zlib.crc32(name.encode()) % 1000


def say(*a, **kw):
    import torch.distributed as dist
    if dist.get_rank() == 0:
        print(*a, **kw)


def main(argv=None):
    args = parse_args(argv)
    import torch.distributed as dist
    dev, joined = join(args)
    try:
        n_dev = dist.get_world_size()
        if n_dev > args.devices:
            raise ValueError(f"{n_dev} ranks but --devices {args.devices}")
        bs = args.batch_size - args.batch_size % n_dev
        if args.cols > 1:
            return main_2d(args, n_dev, bs, dev)
        return main_1d(args, n_dev, bs, dev)
    finally:
        if joined:
            dist.destroy_process_group()


def batch_slice(np, b, lo, hi, tables):
    """This rank's slice ``[lo, hi)`` of a global batch."""
    return ({f"T{c}": np.ascontiguousarray(b["categorical"][lo:hi, c])
             for c in range(tables)},
            b["numeric"][lo:hi], b["label"][lo:hi])


def main_1d(args, n_dev, bs, dev):
    import numpy as np
    import torch
    import torch.distributed as dist
    from .. import checkpoint as ckpt, kv, parallel as par, train as tft
    from ..data import synthetic
    from ..models import DLRM

    rank = dist.get_rank()
    bl = bs // n_dev
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(f"mesh: {n_dev} x {kind}, batch {bs}")

    model = DLRM(num_tables=args.tables, embedding_dim=args.dim,
                 num_numeric=13, bottom_hidden=(64, args.dim),
                 top_hidden=(64, 32), capacity=args.capacity)
    opt = tft.GroupAdamOptimizer(learning_rate=args.lr)
    dense = model.init_dense(torch.Generator().manual_seed(0), "cpu").to(dev)
    tx = torch.optim.Adam(dense.parameters(), lr=args.lr)
    xdtype = torch.bfloat16 if args.bf16_exchange else None

    tables = {}
    for name in sorted(model.table_specs):
        t = par.create_sharded(args.dim, model.table_specs[name]["capacity"],
                               device=dev, seed=table_seed(name))
        tables[name] = par.init_optimizer_sharded(opt, t)

    def step(ids, valids, feats, labels, s, bucket_cap, update_dense=True):
        """One step closed over the exchange-bucket capacity.
        ``update_dense=False`` is the route-overflow RETRY: the same
        forward, the dense tower frozen, only the (masked) sparse grads
        apply, so each dropped id contributes exactly once."""
        rows, states = {}, {}
        for name in sorted(tables):
            r, st, tables[name] = par.sharded_lookup(
                tables[name], ids[name], valid=valids.get(name),
                defer_meta=True, bucket_capacity=bucket_cap,
                exchange_dtype=xdtype)
            rows[name], states[name] = r.requires_grad_(), st
        preds = model.apply(dense, rows, feats)
        loss = model.loss(preds, labels)
        params = list(dense.parameters())
        names = sorted(rows)
        grads = torch.autograd.grad(loss, params + [rows[n] for n in names],
                                    allow_unused=True)
        if update_dense:
            for p, g in zip(params, grads):
                g = torch.zeros_like(p) if g is None else g.contiguous()
                dist.all_reduce(g)
                p.grad = g / n_dev
            tx.step()
        ovf = torch.zeros((), dtype=torch.bool, device=dev)
        route_ovf = torch.zeros((), dtype=torch.bool, device=dev)
        needed = 0
        dropped = {}
        with torch.no_grad():
            for n, g in zip(names, grads[len(params):]):
                st = states[n]
                tables[n] = par.sharded_apply_grads(
                    opt, tables[n], st, g, lr=args.lr, step=s,
                    exchange_dtype=xdtype)
                # grow only on TABLE overflow; bucket-routing overflow
                # needs a bigger bucket_capacity, which growing can't fix
                ovf = ovf | st.table_overflow
                route_ovf = route_ovf | st.route_overflow
                needed = max(needed, int(st.needed_bucket_capacity))
                dropped[n] = par.dropped_positions(st)
        loss = par.mesh.all_reduce(loss.detach(), "sum") / n_dev
        return loss, ovf, par.mesh.any_true(route_ovf), needed, dropped

    bucket_cap = args.bucket_capacity
    gen = synthetic.dlrm_batches(bs, args.batches, num_tables=args.tables,
                                 vocab=30_000, seed=7)
    t0, seen, window, losses, rates = time.time(), 0, [], [], []
    total_route_dropped = 0
    for i, b in enumerate(gen):
        ids, feats, labels = batch_slice(np, b, rank * bl, (rank + 1) * bl,
                                         args.tables)
        feats = torch.as_tensor(feats, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        s = torch.tensor(i + 1, dtype=torch.int32, device=dev)
        loss, ovf, route_ovf, needed, dropped = step(
            ids, {}, feats, labels, s, bucket_cap)
        if route_ovf:
            # route-overflow RECOVERY (never drop an id): raise the bucket
            # capacity to the surfaced requirement and re-run exactly the
            # dropped positions, dense tower frozen
            bucket_cap = needed
            local = {n: int(m.sum()) for n, m in dropped.items()}
            n_drop = {n: par.mesh.host_sum(c, device=dev)
                      for n, c in local.items()}
            n_drop = {n: c for n, c in n_drop.items() if c}
            say(f"batch {i+1:4d} exchange-bucket overflow: dropped "
                f"{n_drop} position(s); raising bucket_capacity to "
                f"{bucket_cap} and retrying the dropped ids", flush=True)
            total_route_dropped += sum(n_drop.values())
            _, ovf2, r2, _, _ = step(ids, dropped, feats, labels, s,
                                     bucket_cap, update_dense=False)
            if r2:
                raise RuntimeError("retry overflowed at the surfaced "
                                   "capacity")
            ovf = ovf | ovf2
        window.append(float(loss))
        seen += bs
        # online growth: an overflow flag means some id failed placement
        # THIS step — grow now and the next lookup inserts it; the
        # periodic load-factor sweep grows ahead of the wall.
        if par.mesh.any_true(ovf) or (i + 1) % 20 == 0:
            tables, grew = par.grow_sharded_if_needed(
                tables, incoming_per_shard=bl, overflow=ovf)
            if grew:
                caps = {n: t.capacity for n, t in tables.items()}
                say(f"batch {i+1:4d} grew tables to per-shard capacity "
                    f"{max(caps.values())}", flush=True)
        if (i + 1) % 10 == 0:
            dt = time.time() - t0
            losses.append(float(np.mean(window)))
            rates.append(seen / dt)
            say(f"batch {i+1:4d} loss {losses[-1]:.5f} "
                f"({seen/dt:.0f} examples/s)", flush=True)
            window = []

    sizes = {name: sum(par.shard_sizes(t)) for name, t in tables.items()}
    say("rows per table:", sizes)
    say(f"route-overflow recoveries: {total_route_dropped} dropped "
        f"position(s) retried, final bucket_capacity "
        f"{bucket_cap if bucket_cap else 'default (2x balanced)'}")

    # sharded checkpoint → elastic restore into 2x the shards
    d = [tempfile.mkdtemp(prefix="dlrm_sharded_") if rank == 0 else None]
    dist.broadcast_object_list(d)
    d = d[0]
    try:
        prefix = os.path.join(d, "ckpt-final")
        ckpt.save_multihost(prefix, tables, dense, process_id=rank,
                            num_processes=n_dev)
        dist.barrier()
        tmpl = {name: [opt.init(kv.create(args.dim, args.capacity, seed=0,
                                          device=dev))
                       for _ in range(2 * n_dev)]
                for name in tables}
        restored, _ = ckpt.restore_multihost(prefix, tmpl)
        got = {name: sum(int(kv.size(s)) for s in shards)
               for name, shards in restored.items()}
        if got != sizes:
            raise AssertionError(f"restored rows {got} != trained {sizes}")
        say(f"elastic restore {n_dev} -> {2*n_dev} shards: row counts match")
        dist.barrier()
    finally:
        if rank == 0:
            shutil.rmtree(d, ignore_errors=True)
    return {"losses": losses, "rows_per_table": sizes,
            "route_dropped": total_route_dropped,
            "examples_per_s": rates[-1] if rates else 0.0}


def main_2d(args, n_dev, bs, dev):
    """2D sparse parallelism: tables sharded rows x cols. Per-rank row
    exchange volume drops by the col count — the layout for very wide
    embeddings or many ranks."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from .. import parallel as par, train as tft
    from ..data import synthetic
    from ..models import DLRM
    from ..parallel import sharded2d as s2

    C = args.cols
    R = n_dev // C
    if R * C != n_dev or args.dim % C:
        raise ValueError(f"--cols {C} must divide the world {n_dev} and "
                         f"--dim {args.dim}")
    mesh = s2.make_mesh_2d(R, C, device_type=dev.type)
    rank = dist.get_rank()
    bl = bs // n_dev
    say(f"2D mesh: {R} row x {C} col shards, batch {bs}")

    model = DLRM(num_tables=args.tables, embedding_dim=args.dim,
                 num_numeric=13, bottom_hidden=(64, args.dim),
                 top_hidden=(64, 32), capacity=1 << 13)
    opt = s2.for_col_axis(tft.GroupAdamOptimizer(learning_rate=args.lr),
                          mesh)
    dense = model.init_dense(torch.Generator().manual_seed(0), "cpu").to(dev)
    tx = torch.optim.Adam(dense.parameters(), lr=args.lr)

    tables = {}
    for name in sorted(model.table_specs):
        t = s2.create_sharded_2d(args.dim, args.capacity, mesh, device=dev,
                                 seed=table_seed(name))
        tables[name] = s2.init_optimizer_sharded_2d(opt, t)

    def step(ids, feats, labels, s):
        rows, states = {}, {}
        for name in sorted(tables):
            r, st, tables[name] = s2.sharded_lookup_2d(
                tables[name], ids[name], mesh=mesh, defer_meta=True)
            rows[name], states[name] = r.requires_grad_(), st
        loss = model.loss(model.apply(dense, rows, feats), labels)
        params = list(dense.parameters())
        names = sorted(rows)
        grads = torch.autograd.grad(loss, params + [rows[n] for n in names],
                                    allow_unused=True)
        for p, g in zip(params, grads):
            g = torch.zeros_like(p) if g is None else g.contiguous()
            dist.all_reduce(g)
            p.grad = g / n_dev
        tx.step()
        ovf = torch.zeros((), dtype=torch.bool, device=dev)
        with torch.no_grad():
            for n, g in zip(names, grads[len(params):]):
                tables[n] = s2.sharded_apply_grads_2d(
                    opt, tables[n], states[n], g, mesh=mesh, lr=args.lr,
                    step=s)
                ovf = ovf | states[n].table_overflow
        return par.mesh.all_reduce(loss.detach(), "sum") / n_dev, ovf

    gen = synthetic.dlrm_batches(bs, args.batches, num_tables=args.tables,
                                 vocab=30_000, seed=7)
    t0, seen, window, losses, rates = time.time(), 0, [], [], []
    for i, b in enumerate(gen):
        ids, feats, labels = batch_slice(np, b, rank * bl, (rank + 1) * bl,
                                         args.tables)
        loss, ovf = step(ids, torch.as_tensor(feats, device=dev),
                         torch.as_tensor(labels, device=dev),
                         torch.tensor(i + 1, dtype=torch.int32, device=dev))
        window.append(float(loss))
        seen += bs
        # online growth, 2D analogue of the row-sharded loop above
        if par.mesh.any_true(ovf) or (i + 1) % 20 == 0:
            tables, grew = s2.grow_sharded_2d_if_needed(
                tables, mesh, incoming_per_shard=bs // R, overflow=ovf)
            if grew:
                caps = {n: t.capacity for n, t in tables.items()}
                say(f"batch {i+1:4d} grew tables to per-row-shard capacity "
                    f"{max(caps.values())}", flush=True)
        if (i + 1) % 10 == 0:
            dt = time.time() - t0
            losses.append(float(np.mean(window)))
            rates.append(seen / dt)
            say(f"batch {i+1:4d} loss {losses[-1]:.5f} "
                f"({seen/dt:.0f} examples/s)", flush=True)
            window = []
    grid = {name: s2.shard_sizes_2d(t, mesh) for name, t in tables.items()}
    sizes = {name: sum(row[0] for row in g) for name, g in grid.items()}
    say("rows per table:", sizes)
    return {"losses": losses, "rows_per_table": sizes,
            "examples_per_s": rates[-1] if rates else 0.0}


if __name__ == "__main__":
    main()
