"""Train DeepFM or Wide&Deep on Criteo(-like) data: the port's twin of
examples/train_deepfm.py.

The reference ships NCF and DCN examples; production TFPlus users run the
wider CTR zoo on the same KvVariable stack. This example exercises the two
remaining common families — DeepFM's FM interaction term and Wide&Deep's
dim-1 linear tables (tiny-dim KV tables sharing id streams with their
embedding tables via ``id_alias``).

Usage: python -m tfplus_tpu_torch.examples.train_deepfm --model deepfm --cpu
       python -m tfplus_tpu_torch.examples.train_deepfm --model widedeep \
           --optimizer group_adam
"""
import argparse
import functools
import time

from ._common import OPTIMIZERS, sparse_optimizer
from .train_dcn import criteo_streams, evaluate, to_batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="deepfm",
                    choices=["deepfm", "widedeep"])
    ap.add_argument("--optimizer", default="adam", choices=OPTIMIZERS)
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--train-batches", type=int, default=100)
    ap.add_argument("--eval-batches", type=int, default=20)
    ap.add_argument("--data", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from .. import kv
    from ..models import DeepFM, WideDeep, init_state, make_train_step

    dev = "cpu" if args.cpu else "cuda"
    cls = DeepFM if args.model == "deepfm" else WideDeep
    model = cls(capacity=1 << 16)
    opt = sparse_optimizer(args.optimizer, args.lr)
    tx = functools.partial(torch.optim.Adam, lr=args.lr)
    state = init_state(model, opt, tx, seed=0, device=dev)
    step = make_train_step(model, opt, sparse_lr=args.lr)
    estep = make_train_step(model, opt, sparse_lr=args.lr, train=False)
    train_iter, eval_iter = criteo_streams(args)

    t0 = time.time()
    seen = 0
    losses = []
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
