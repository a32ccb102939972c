"""Train DCN on Criteo(-like) data: the port's twin of examples/train_dcn.py,
mirroring the reference benchmark (example/dcn/train.py): 26 KV-embedded
categorical + 13 numeric features, deep tower + cross net, sigmoid CE;
reports accuracy + AUC like example/dcn/README.md:54-84.

Uses the real Criteo-Kaggle TSV when present (CRITEO_PATH env or
--data), else a planted-logistic criteo-like stream.

Usage: python -m tfplus_tpu_torch.examples.train_dcn --optimizer group_adam
"""
import argparse
import functools
import time

from ._common import OPTIMIZERS, auc_accuracy, sparse_optimizer


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--optimizer", default="adam", choices=OPTIMIZERS)
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--train-batches", type=int, default=200)
    ap.add_argument("--eval-batches", type=int, default=20)
    ap.add_argument("--data", default=None)
    ap.add_argument("--cache-dir", default=None,
                    help="pre-tokenized binary cache dir (built on first "
                         "use from --data): parse+hash once, then epochs "
                         "stream memmapped slices ~10x faster than live "
                         "TSV parsing")
    ap.add_argument("--steps-per-loop", type=int, default=1,
                    help=">1 runs K train steps per call "
                         "(make_train_step_scan + packed one-buffer feed: "
                         "one host-to-device copy per K steps)")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def criteo_streams(args):
    """``(train_iter, eval_iter)``: the binary cache, the TSV through the
    native loader, or the planted stream, as the flags and data say."""
    from ..data import criteo, synthetic
    path = criteo.available(args.data)
    if path and getattr(args, "cache_dir", None):
        print("using binary cache:", args.cache_dir, "(source:", path + ")")
        cache = criteo.BinaryCriteoCache(
            criteo.build_binary_cache(path, args.cache_dir))
        return (cache.batches(args.batch_size, args.train_batches,
                              loop=True),
                cache.batches(args.batch_size, args.eval_batches))
    if path:
        print("using real criteo data:", path)
        # threads>1 → native multithreaded prefetching loader (io/native.py)
        return (criteo.batches(path, args.batch_size, args.train_batches,
                               threads=8),
                criteo.batches(path, args.batch_size, args.eval_batches))
    print("criteo TSV not found — using planted criteo-like stream")
    gen = synthetic.CriteoLike(seed=0)
    return (gen.batches(args.batch_size, args.train_batches),
            gen.batches(args.batch_size, args.eval_batches))


def to_batch(b):
    """A Criteo batch in the step's format (ids raw int64 per column)."""
    return {"ids": {f"C{i+1}": b["categorical"][:, i] for i in range(26)},
            "features": b["numeric"], "labels": b["label"]}


def evaluate(estep, state, eval_iter):
    """Eval pass: ``(accuracy, AUC)`` over the eval batches."""
    labels, scores = [], []
    for b in eval_iter:
        _, _, preds = estep(state, to_batch(b))
        labels.append(b["label"])
        scores.append(preds.float().cpu().numpy())
    return auc_accuracy(labels, scores)


def host_batch(np, b):
    """A Criteo batch with its ids encoded on the host as int32 pairs
    ``[N, 2]`` (4-byte leaves, as the packed feed takes them)."""
    u = b["categorical"].astype(np.uint64)
    ids = np.stack(
        [(u & np.uint64(0xFFFFFFFF)).astype(np.uint32).astype(np.int32),
         (u >> np.uint64(32)).astype(np.uint32).astype(np.int32)],
        axis=-1)                                           # [N, 26, 2]
    return {"ids": {f"C{i+1}": np.ascontiguousarray(ids[:, i])
                    for i in range(26)},
            "features": np.ascontiguousarray(b["numeric"]),
            "labels": np.ascontiguousarray(b["label"])}


def stack_batches(np, chunk):
    """K host batches → one tree whose leaves have a leading [K] axis."""
    first = chunk[0]
    if isinstance(first, dict):
        return {k: stack_batches(np, [c[k] for c in chunk]) for k in first}
    return np.stack(chunk)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch
    from .. import kv
    from ..models import DCN, init_state, make_train_step

    dev = "cpu" if args.cpu else "cuda"
    model = DCN(capacity=1 << 16)
    opt = sparse_optimizer(args.optimizer, args.lr)
    tx = functools.partial(torch.optim.Adam, lr=args.lr)
    state = init_state(model, opt, tx, seed=0, device=dev)
    step = make_train_step(model, opt, sparse_lr=args.lr)
    estep = make_train_step(model, opt, sparse_lr=args.lr, train=False)
    train_iter, eval_iter = criteo_streams(args)

    t0 = time.time()
    seen = 0
    losses = []
    if args.steps_per_loop > 1:
        from ..data import make_packed_feed
        from ..models import make_train_step_scan
        K = args.steps_per_loop
        scan_step = make_train_step_scan(model, opt, sparse_lr=args.lr)
        pack = unpack = None
        chunk = []
        i = 0
        for b in train_iter:
            chunk.append(host_batch(np, b))
            if len(chunk) < K:
                continue
            stacked = stack_batches(np, chunk)
            if pack is None:
                pack, unpack = make_packed_feed(stacked, device=dev)
            # one upload for K steps; unpack cuts views on the device
            flat = pack(stacked).to(dev, non_blocking=True)
            state, step_losses = scan_step(state, unpack(flat))
            chunk = []
            seen += args.batch_size * K
            i += K
            losses.append(float(step_losses[-1]))
            print(f"step {i} loss {losses[-1]:.5f} "
                  f"({seen/(time.time()-t0):.0f} ex/s)", flush=True)
    else:
        for i, b in enumerate(train_iter):
            state, loss, _ = step(state, to_batch(b))
            seen += args.batch_size
            if i % 20 == 0:
                losses.append(float(loss))
                print(f"step {i} loss {losses[-1]:.5f} "
                      f"({seen/(time.time()-t0):.0f} ex/s)", flush=True)
    examples_per_s = seen / (time.time() - t0)

    acc, auc = evaluate(estep, state, eval_iter)
    print(f"eval accuracy: {acc:.5f} AUC: {auc:.5f}")
    total_rows = sum(int(kv.size(t)) for t in state.tables.values())
    print(f"total embedding rows: {total_rows}")
    return {"losses": losses, "accuracy": acc, "auc": auc,
            "total_rows": total_rows, "examples_per_s": examples_per_s}


if __name__ == "__main__":
    main()
