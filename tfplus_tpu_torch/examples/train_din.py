"""Train DIN or BST on planted behavior-sequence data: the port's twin of
examples/train_din.py.

DIN (arXiv:1706.06978) attends the candidate over the click history with a
learned activation unit; BST (arXiv:1905.06874) runs transformer blocks
over [history..., candidate] through the flash-attention layer (the
single-pass Hopper kernels at these shapes). Framework pieces on display:
one shared item KV table fed by TWO id streams (candidate + flattened
history, deduped into a single probe/gather/apply pass) and
variable-length sequences via padding masks.

Usage: python -m tfplus_tpu_torch.examples.train_din --cpu
       python -m tfplus_tpu_torch.examples.train_din --model bst --cpu
       python -m tfplus_tpu_torch.examples.train_din --optimizer group_adam
"""
import argparse
import functools
import time

from ._common import OPTIMIZERS, auc_accuracy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="din", choices=["din", "bst"])
    ap.add_argument("--optimizer", default="adam", choices=OPTIMIZERS)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--train-batches", type=int, default=600)
    ap.add_argument("--eval-batches", type=int, default=10)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from .. import train as tft
    from ..data import synthetic
    from ..kv import table as kvt
    from ..models import BST, DIN, init_state, make_train_step

    dev = "cpu" if args.cpu else "cuda"
    opts = {
        "adam": tft.AdamOptimizer,
        "adagrad": tft.AdagradOptimizer,
        "group_adam": lambda: tft.GroupAdamOptimizer(
            l1_regularization_strength=1e-5,
            l21_regularization_strength=1e-5),
        "sparse_group_ftrl": tft.SparseGroupFtrlOptimizer,
    }
    gen = synthetic.BehaviorSequence(n_items=5000, n_clusters=25,
                                     seq_len=args.seq_len, seed=0)
    if args.model == "bst":
        model = BST(embedding_dim=32, seq_len=args.seq_len, num_numeric=4,
                    num_heads=2, head_dim=32, num_blocks=2,
                    capacity=1 << 14)
    else:
        model = DIN(embedding_dim=32, seq_len=args.seq_len, num_numeric=4,
                    capacity=1 << 14)
    opt = opts[args.optimizer]()
    tx = functools.partial(torch.optim.Adam, lr=args.lr)
    state = init_state(model, opt, tx, seed=0, device=dev)
    step = make_train_step(model, opt, sparse_lr=args.lr)

    def to_batch(b):
        return {
            "ids": {"item": model.pack_item_ids(b["cand"], b["seq"]),
                    "user": b["user"].astype(np.int64)},
            "features": {"numeric": b["numeric"], "mask": b["mask"]},
            "labels": b["label"],
        }

    t0, seen, losses = time.time(), 0, []
    for i, b in enumerate(gen.batches(args.batch_size, args.train_batches)):
        state, loss, _ = step(state, to_batch(b))
        seen += args.batch_size
        if (i + 1) % 50 == 0:
            losses.append(float(loss))
            rate = seen / max(time.time() - t0, 1e-9)
            print(f"step {i+1} loss {losses[-1]:.5f} ({rate:,.0f} ex/s)")
    examples_per_s = seen / max(time.time() - t0, 1e-9)

    estep = make_train_step(model, opt, sparse_lr=args.lr, train=False)
    labels, scores = [], []
    for b in gen.batches(args.batch_size, args.eval_batches):
        _, _, preds = estep(state, to_batch(b))
        labels.append(b["label"])
        scores.append(preds.float().cpu().numpy())
    _, auc = auc_accuracy(labels, scores)
    print(f"eval AUC: {auc:.5f}")
    item_rows = kvt.stats(state.tables["item"])["size"]
    user_rows = kvt.stats(state.tables["user"])["size"]
    print(f"item rows: {item_rows} user rows: {user_rows}")
    return {"losses": losses, "auc": auc, "item_rows": int(item_rows),
            "user_rows": int(user_rows), "examples_per_s": examples_per_s}


if __name__ == "__main__":
    main()
