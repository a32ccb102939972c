"""Train NCF on MovieLens-shaped data: the port's twin of
examples/train_ncf.py, mirroring the reference demo
(example/NCFModel/train.py): user+movie KV embeddings -> MLP -> MSE,
20 epochs, loss must decrease.

Usage: python -m tfplus_tpu_torch.examples.train_ncf [--epochs 20] [--cpu]
"""
import argparse
import functools
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--examples", type=int, default=100_000)
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from .. import checkpoint as ckpt, kv, train as tft
    from ..data import movielens
    from ..models import NCF, init_state, make_train_step

    dev = "cpu" if args.cpu else "cuda"
    # real ml-100k u.data when on disk (MOVIELENS_PATH), else synthetic
    data = movielens.load_or_synthetic(args.examples, seed=2021)
    args.examples = min(args.examples, len(data["rating"]))
    model = NCF()
    opt = tft.AdamOptimizer(learning_rate=args.lr)
    tx = functools.partial(torch.optim.Adam, lr=args.lr)
    state = init_state(model, opt, tx, seed=2021, device=dev)
    step = make_train_step(model, opt, sparse_lr=args.lr)

    bs = args.batch_size
    n = args.examples - args.examples % bs
    losses, rates = [], []
    for epoch in range(args.epochs):
        t0 = time.time()
        total = 0.0
        nb = 0
        for i in range(0, n, bs):
            batch = {
                "ids": {"user": data["user_id"][i:i+bs].astype(np.int64),
                        "movie": data["movie_id"][i:i+bs].astype(np.int64)},
                "labels": data["rating"][i:i+bs],
            }
            state, loss, _ = step(state, batch)
            total += float(loss)
            nb += 1
        dt = time.time() - t0
        losses.append(total / nb)
        rates.append(n / dt)
        print(f"epoch: {epoch} loss: {total/nb:.5f} "
              f"({n/dt:.0f} examples/s)", flush=True)

    user_rows = int(kv.size(state.tables["user"]))
    movie_rows = int(kv.size(state.tables["movie"]))
    print("user rows:", user_rows, "movie rows:", movie_rows)
    if args.ckpt_dir:
        mgr = ckpt.CheckpointManager(args.ckpt_dir)
        mgr.save(state.tables, state.dense, step=int(state.step))
        print("checkpoint saved to", args.ckpt_dir)
    return {"losses": losses, "user_rows": user_rows,
            "movie_rows": movie_rows,
            "examples_per_s": float(np.mean(rates)) if rates else 0.0}


if __name__ == "__main__":
    main()
