"""End-to-end TFPlus migration demo: the port's twin of
examples/migrate_from_tfplus.py.

1. Fabricates a TFPlus-format checkpoint (a TensorFlow TensorBundle with the
   reference tensor contract), standing in for a production checkpoint: the
   original's names, shapes and seed, written by the port's own bundle
   writer (the bytes ``SaveV2`` writes).
2. Imports it into KvTables (elastic: 2 checkpoint shards into 3 tables).
3. Resumes training with GroupAdam.
4. Exports BACK to TFPlus format so an existing TF-based ranking service
   keeps working, and to the native streaming bundle.

No TensorFlow is needed, on the CPU or on the card.

Usage: python -m tfplus_tpu_torch.examples.migrate_from_tfplus [--cpu]
"""
import argparse
import os
import shutil
import tempfile


def fabricate_reference_checkpoint(prefix: str):
    """What a production TFPlus job would have left on disk."""
    import numpy as np
    from ..checkpoint import tf_bundle
    rng = np.random.RandomState(0)
    names, tensors = [], []

    def add(n, t):
        names.append(n)
        tensors.append(t)

    # 2-shard user table (name/part_i layout), uint16 freqs, one blacklist
    for part in range(2):
        ids = np.arange(part, 2000, 2, dtype=np.int64)
        add(f"user_emb/part_{part}-keys", ids)
        add(f"user_emb/part_{part}-values",
            rng.randn(len(ids), 16).astype(np.float32))
        add(f"user_emb/part_{part}-init_table",
            rng.randn(100, 16).astype(np.float32))
        add(f"user_emb/part_{part}-blacklist",
            ids[:3] if part == 0 else np.zeros((0,), np.int64))
        add(f"user_emb/part_{part}-freq_keys", ids)
        add(f"user_emb/part_{part}-freq_values",
            rng.randint(1, 900, len(ids)).astype(np.uint16))
    add("dnn/hidden0/kernel", rng.randn(16, 8).astype(np.float32))
    tf_bundle.write_bundle(prefix, names, tensors)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from .. import checkpoint as ckpt, kv, train as tft
    from ..checkpoint import tf_bundle, tf_export, tf_import

    dev = "cpu" if args.cpu else "cuda"
    work = tempfile.mkdtemp(prefix="tfplus_migrate_demo_")
    try:
        ref_ckpt = os.path.join(work, "tfplus.ckpt-100")
        fabricate_reference_checkpoint(ref_ckpt)
        print(f"[1] fabricated reference checkpoint at {ref_ckpt}")

        infos = tf_import.list_kv_variables(ref_ckpt)
        shards_of = {k: v["num_shards"] for k, v in infos.items()}
        rows_of = {k: v["rows"] for k, v in infos.items()}
        print(f"[2] discovered: {shards_of} rows={rows_of}")

        # elastic import: 2 checkpoint shards -> 3 tables
        shards = tf_import.import_kv_variable(ref_ckpt, "user_emb",
                                              num_shards=3, capacity=2048,
                                              device=dev)
        w0 = tf_import.read_dense(ref_ckpt, "dnn/hidden0/kernel")
        total = sum(int(kv.size(s)) for s in shards)
        print(f"[3] imported into 3 shards, {total} rows; dense {w0.shape}")

        # resume training with GroupAdam
        opt = tft.GroupAdamOptimizer(learning_rate=0.01)
        shards = [opt.init(s) for s in shards]
        rng = np.random.RandomState(1)
        for step in range(1, 4):
            for i, t in enumerate(shards):
                ids = np.arange(i, 400, 3, dtype=np.int64) * 3 + i
                ids = ids[ids % 3 == i][:64]       # this shard's
                if not len(ids):
                    continue
                q = kv.encode_ids_np_to_device(ids, device=dev)
                res = kv.lookup_or_insert(t, q)
                g = torch.from_numpy(
                    rng.randn(len(ids), 16).astype(np.float32)).to(dev) * 0.01
                shards[i] = opt.apply(res.table, res.slot, g, lr=0.01,
                                      step=step)
        print("[4] resumed 3 training steps with GroupAdam")

        # native streaming checkpoint for this framework...
        native_prefix = os.path.join(work, "native-ckpt")
        shards = ckpt.save(native_prefix, {"user_emb": shards})["user_emb"]
        # ...and a TFPlus-format export for the existing serving stack
        back = os.path.join(work, "back-to-tfplus.ckpt-101")
        tf_export.export_checkpoint(back, {"user_emb": shards},
                                    dense={"dnn/hidden0/kernel": w0})
        names = sorted(tf_bundle.TFBundleReader(back)
                       .get_variable_to_shape_map())
        print(f"[5] exported native bundle + TFPlus bundle "
              f"({len(names)} tensors, e.g. {names[:3]})")
        print("migration round-trip OK")
        return {"discovered_shards": shards_of, "discovered_rows": rows_of,
                "imported_rows": total, "rows_per_shard": [
                    int(kv.size(s)) for s in shards],
                "dense_shape": list(w0.shape), "exported_tensors": names}
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
