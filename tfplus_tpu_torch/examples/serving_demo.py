"""Serving demo: the port's twin of examples/serving_demo.py. Train
briefly, export for serving, load the export in a "server" with no
training code or templates, and answer embedding queries over HTTP — the
reference's ranking-service flow (ranking_utils metadata + prediction-mode
checkpoint) as a runnable end-to-end story.

Usage: python -m tfplus_tpu_torch.examples.serving_demo [--cpu] [--port 8571]
       (runs a self-test against its own server, then exits; pass --serve to
        stay up)
"""
import argparse
import json
import tempfile
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def train_and_export(directory, device):
    """Train a user and an item table for three steps and export them."""
    import numpy as np
    from .. import kv, serving, train

    opt = train.AdamOptimizer(learning_rate=0.01)
    tables, md = {}, serving.RankingMetadata()
    rng = np.random.RandomState(0)
    for name, vocab in (("user_emb", 500), ("item_emb", 2000)):
        # hash() of a str is salted per process: the init seed (and so the
        # tables) agree within one run only, as in the JAX example
        t = opt.init(kv.create(16, 4096, seed=hash(name) % 97,
                               device=device))
        for step in range(1, 4):
            ids = kv.encode_ids_np_to_device(
                rng.randint(0, vocab, 512).astype(np.int64), device=device)
            u = kv.unique_with_counts(ids)
            res = kv.lookup_or_insert(t, u.unique_keys, counts=u.counts)
            g = res.rows * 0.1 + 0.01
            t = opt.apply(res.table, res.slot, g, lr=0.01, step=step,
                          payload_rows=res.payload_rows,
                          meta_rows=res.meta_rows)
        tables[name] = t
        md.add_embedding_column(column_name=name.split("_")[0],
                                var_name=name, embedding_dim=16)
    serving.export_for_serving(directory, tables, md)
    return tables


class EmbeddingServer:
    """Loads an export directory; serves /signature and /embed lookups."""

    def __init__(self, directory, quantize=False, sharded=False,
                 device="cuda"):
        import numpy as np
        from .. import kv, serving
        self.kv, self.np = kv, np
        self.quantize = quantize
        self.sharded = sharded
        self.device = device
        if sharded:
            # sharded serving: one table shard per rank, queries answered
            # with the trainer's all-to-all exchange (f32 or int8). This
            # process serves HTTP, so its group is a world of one rank.
            from ..parallel import serving as psrv
            self.tables, self.metadata = psrv.load_for_serving_sharded(
                directory, quantize=quantize, device=device)
            self.lookups = {var: psrv.make_serving_lookup(t)
                            for var, t in self.tables.items()}
        else:
            self.tables, self.metadata = serving.load_for_serving(
                directory, quantize=quantize, device=device)
        self.by_column = {c["column_name"]: c
                          for c in self.metadata._columns}

    def embed(self, column, ids):
        kv, np = self.kv, self.np
        ids64 = np.asarray(ids, np.int64)
        col = self.by_column[column]
        var = col["embedding_var_keys"][0][:-len("-keys")].split("/part_")[0]
        if self.sharded:
            q = kv.encode_ids_np_to_device(ids64, device=self.device)
            return self.lookups[var](q).cpu().numpy()
        t = self.tables[var]
        if self.quantize:
            # int8 tables: 4x less memory, lookups dequantize on the fly;
            # shard lists route by key % N like the f32 path
            from ..kv import quant
            if isinstance(t, list):
                out = np.zeros((len(ids64), t[0].dim), np.float32)
                for s_i, shard in enumerate(t):
                    sel = (ids64.astype(np.uint64)
                           % np.uint64(len(t))) == s_i
                    if sel.any():
                        q = kv.encode_ids_np_to_device(ids64[sel],
                                                       device=self.device)
                        out[sel] = quant.lookup_or_zeros(shard, q).cpu(
                            ).numpy()
                return out
            q = kv.encode_ids_np_to_device(ids64, device=self.device)
            return quant.lookup_or_zeros(t, q).cpu().numpy()
        # partitioned_lookup handles single tables AND shard lists (key % N
        # routing, the reference's PartitionedVariable read path)
        from .. import embedding as emb
        rows, _ = emb.partitioned_lookup(t, ids64, train=False)
        return rows.cpu().numpy()


def make_handler(server):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            from urllib.parse import parse_qs, urlparse
            u = urlparse(self.path)
            if u.path == "/signature":
                return self._json(server.metadata.generate_signature())
            if u.path == "/embed":
                qs = parse_qs(u.query)
                col = qs.get("column", [""])[0]
                ids = [int(x) for x in qs.get("ids", [""])[0].split(",") if x]
                if col not in server.by_column:
                    return self._json({"error": f"unknown column {col}"}, 404)
                rows = server.embed(col, ids)
                return self._json({"column": col, "ids": ids,
                                   "embeddings": rows.tolist()})
            return self._json({"error": "use /signature or /embed"}, 404)
    return Handler


def join_world_of_one(device):
    """A process group of this process alone (gloo on the CPU, NCCL on a
    card) on a free localhost port, unless one is up already."""
    import socket
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise ValueError("serving_demo --sharded serves from one "
                             "process; start it without torchrun")
        return False
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    if device != "cpu":
        import torch
        torch.cuda.set_device(0)
    dist.init_process_group("gloo" if device == "cpu" else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--port", type=int, default=8571)
    ap.add_argument("--serve", action="store_true",
                    help="stay up instead of running the self-test")
    ap.add_argument("--quantize", action="store_true",
                    help="serve int8 row-quantized tables (4x less memory)")
    ap.add_argument("--sharded", action="store_true",
                    help="serve from sharded tables (one shard per rank, "
                         "all-to-all exchange; composes with --quantize), "
                         "here in a process group of one rank")
    args = ap.parse_args(argv)
    import numpy as np
    from .. import kv
    from ..utils import device as _dev

    device = str(_dev.resolve("cpu" if args.cpu else "cuda"))
    joined = join_world_of_one(device) if args.sharded else False
    try:
        with tempfile.TemporaryDirectory() as d:
            print("training + exporting ...")
            ref_tables = train_and_export(d, device)
            print("loading export in server (no templates) ...")
            server = EmbeddingServer(d, quantize=args.quantize,
                                     sharded=args.sharded, device=device)
        httpd = ThreadingHTTPServer(("127.0.0.1", args.port),
                                    make_handler(server))
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            base = f"http://127.0.0.1:{args.port}"
            sig = json.loads(urllib.request.urlopen(
                base + "/signature").read())
            print("signature:", sig)
            resp = json.loads(urllib.request.urlopen(
                base + "/embed?column=user&ids=1,2,3,999999").read())
            got = np.asarray(resp["embeddings"], np.float32)
            want = kv.lookup_or_zeros(
                ref_tables["user_emb"], kv.encode_ids_np_to_device(
                    np.array([1, 2, 3, 999999], np.int64),
                    device=device)).cpu().numpy()
            tol = ((np.abs(want).max() / 120.0 + 1e-6) if args.quantize
                   else 1e-6)
            if not np.allclose(got, want, atol=float(tol)):
                raise AssertionError("served rows != trained rows")
            if np.abs(got[-1]).sum() != 0.0:
                raise AssertionError("unknown id must read zeros")
            print("self-test OK: served rows match training, unknown id -> "
                  "zeros")
            if args.serve:
                print(f"serving on {base} (ctrl-c to stop)")
                t.join()
        finally:
            httpd.shutdown()
            httpd.server_close()
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()
    return {"signature": sig, "max_abs_err": float(np.abs(got - want).max()),
            "tolerance": float(tol)}


if __name__ == "__main__":
    main()
