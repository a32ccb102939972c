#!/usr/bin/env python3
"""Replay the host-DRAM tier's stream of ``chip_smoke.py`` phase 22 on a
card and on the CPU side by side, and report the ids each step's lookup
could not place.

    python3 scripts/hybrid_overflow_probe.py [--rows 1048576] [--steps 40]

Run from the repository root on a machine with a CUDA card. Both sides run
the phase's protocol (prefetch, lookup, Adam on ``rows * 0.1``, the next
batch's asynchronous prefetch, spill to the 2^19-row budget) on a dim-128
table of ``--rows`` rows. A step whose lookup left ids unplaced prints the
count, the table's rows and, for the first five such ids, the free lanes
of both candidate buckets; after every step the two sides' headers are
compared (payloads may differ in the last bit: the card rounds Adam's
arithmetic otherwise). Placement is a pure function of the keys, so the
sides must agree on every unplaced id.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tfplus_tpu_torch import kv, train  # noqa: E402
from tfplus_tpu_torch.kv import hashing, storage  # noqa: E402

SEED = 0
BUDGET = 1 << 19


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    opt = train.AdamOptimizer()
    rng = np.random.RandomState(SEED + 110)         # phase 22's stream
    perm = rng.permutation(1 << 22).astype(np.int64)
    stream = [np.unique(perm[(rng.zipf(1.05, 1 << 15) - 1) % (1 << 22)])
              for _ in range(64)]
    hts = {d: storage.HybridTable(opt.init(kv.create(
        128, args.rows, seed=SEED + 111, device=d)), max_live=BUDGET)
        for d in ("cuda", "cpu")}
    for s, ids in enumerate(stream[:args.steps], start=1):
        for d, ht in hts.items():
            ht.prefetch(ids)
            q = kv.encode_ids(ids, device=d)
            res = kv.lookup_or_insert(ht.table, q, day=1)
            bad = int((res.slot < 0).sum())
            if bad:
                print(f"step {s} {d}: {bad} of {len(ids)} ids not placed, "
                      f"{int(kv.size(ht.table))} rows held", flush=True)
                miss = (res.slot < 0).nonzero()[:5, 0]
                b1, b2 = hashing.bucket_choices(q[miss], ht.table.capacity)
                for i in range(len(miss)):
                    free = []
                    for b in (int(b1[i]), int(b2[i])):
                        row = ht.table.header[b].cpu().numpy()
                        free.append(int((((row[:16] == -1) | (row[:16] == -2))
                                         & (row[16:32] == -1)).sum()))
                    print(f"  id {int(ids[int(miss[i])])}: free lanes in its "
                          f"buckets {free}", flush=True)
            opt.apply(ht.table, res.slot, res.rows * 0.1, lr=0.01, step=s)
            ht.prefetch_async(stream[s])
            ht.apply_prefetch()
            ht.maybe_spill()
        same = torch.equal(hts["cuda"].table.header.cpu(),
                           hts["cpu"].table.header)
        print(f"step {s}: headers equal {same}", flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
