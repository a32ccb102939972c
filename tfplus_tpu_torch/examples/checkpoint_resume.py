"""Checkpoint / resume / elastic-repartition demo: the port's twin of
examples/checkpoint_resume.py.

Exercises the full persistence story end-to-end, mirroring the reference's
workflow: train sharded tables → full checkpoint → cheap delta checkpoints
→ crash → restore (full + delta replay) with a DIFFERENT shard count
(elastic repartition), then keep training.

Usage: python -m tfplus_tpu_torch.examples.checkpoint_resume [--cpu]
"""
import argparse
import os
import shutil
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from .. import checkpoint as ckpt, kv, train as tft

    dev = "cpu" if args.cpu else "cuda"
    rng = np.random.RandomState(0)
    opt = tft.GroupAdamOptimizer(learning_rate=0.05)

    def train_steps(shards, start_step, n_steps, ids_stream):
        num_shards = len(shards)
        for s in range(start_step, start_step + n_steps):
            ids = next(ids_stream)
            assign = ids % num_shards
            for i in range(num_shards):
                # lookup_or_insert requires DEDUPLICATED keys
                sel = np.unique(ids[assign == i])
                res = kv.lookup_or_insert(
                    shards[i], kv.encode_ids_np_to_device(sel, device=dev))
                g = res.rows * 0.1 + 0.01
                shards[i] = opt.apply(res.table, res.slot, g, lr=0.05,
                                      step=s, payload_rows=res.payload_rows,
                                      meta_rows=res.meta_rows)
        return shards

    def id_stream():
        while True:
            yield rng.randint(0, 5000, 256)

    stream = id_stream()
    workdir = tempfile.mkdtemp(prefix="tfplus_ckpt_demo_")
    try:
        mgr = ckpt.CheckpointManager(os.path.join(workdir, "ckpts"))

        # --- phase 1: train on 4 shards, checkpoint full + deltas ----------
        shards = [opt.init(kv.create(16, 1 << 12, seed=i,
                                     name=f"emb/part_{i}", device=dev))
                  for i in range(4)]
        shards = train_steps(shards, 1, 20, stream)
        shards = mgr.save({"emb": shards}, step=20, full=True)["emb"]
        shards = train_steps(shards, 21, 5, stream)
        shards = mgr.save({"emb": shards}, step=25, full=False)["emb"]
        shards = train_steps(shards, 26, 5, stream)
        mgr.save({"emb": shards}, step=30, full=False)            # delta
        total_before = sum(int(kv.size(s)) for s in shards)
        print(f"[train] 4 shards, 30 steps, {total_before} rows; "
              f"full@20 + deltas@25,@30 saved")

        # sample ground truth to verify after restore
        sample_ids = rng.randint(0, 5000, 64).astype(np.int64)

        def lookup_all(shards, ids64):
            ns = len(shards)
            out = torch.zeros((len(ids64), 16))
            assign = ids64 % ns
            for i in range(ns):
                sel = assign == i
                if sel.sum():
                    q = kv.encode_ids_np_to_device(ids64[sel], device=dev)
                    out[torch.from_numpy(sel)] = kv.lookup_or_zeros(
                        shards[i], q).cpu()
            return out

        want = lookup_all(shards, sample_ids)

        # --- phase 2: "crash"; restore into SIX shards (elastic) -----------
        mgr2 = ckpt.CheckpointManager(os.path.join(workdir, "ckpts"))
        templates = [opt.init(kv.create(16, 1 << 12, seed=99 + i,
                                        name=f"emb/part_{i}", device=dev))
                     for i in range(6)]
        restored, _, step = mgr2.restore({"emb": templates})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    new_shards = restored["emb"]
    got = lookup_all(new_shards, sample_ids)
    if not torch.equal(got, want):
        raise AssertionError("restored rows differ from the trained ones")
    print(f"[restore] resumed at step {step} into 6 shards — "
          f"64-id sample matches bit-for-bit after 4→6 repartition")

    # --- phase 3: keep training on the new topology ------------------------
    new_shards = train_steps(new_shards, step + 1, 5, stream)
    total_after = sum(int(kv.size(s)) for s in new_shards)
    print(f"[resume] trained 5 more steps on 6 shards; rows {total_after}")
    print("OK")
    return {"step": int(step), "rows_before": total_before,
            "rows_after": total_after}


if __name__ == "__main__":
    main()
