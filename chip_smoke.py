#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (tfplus_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py                  # build, check and measure
    python3 chip_smoke.py --profile DIR    # also writes torch.profiler tables
                                           # of both serving paths to DIR

Run from the repository root on a machine with one CUDA card and nvcc. It
imports neither JAX nor the JAX package. Phases, each of which raises on a
failed check:

1. The card's name and power limit; the CUDA kernels are built from
   ``tfplus_tpu_torch/ops/csrc`` and the build time printed.
2. Kernels: every row kernel is held bit-exact against its plain PyTorch
   version at the shapes the serving paths give it (f32 and bf16, widths
   64/128/384; 32,768 indices with negative, duplicated and edge values;
   the DCN's 2,048-row gathers and 2^19-row fill scatters) and timed beside
   it and beside one PyTorch call that computes the same function.
3. Embedding serving (the bench's serving-leg shape): a 1M-row dim-128
   table filled by ``lookup_or_insert`` of 32,768 ids, then repeated
   ``lookup_or_zeros`` of those ids and their reversal.
4. DCN serving at the reference width: 26 tables of 1M rows, each filled
   with 2^19 keys through ``insert``, then batch-2048 requests through
   ``make_train_step(train=False)``, checked against a host-side map of what
   was inserted and a float64 numpy forward pass of the dense towers (the
   deep tower's logit on its own too, with a TF32 control it must reject).

Each serving path runs with the kernels' launch counts set to 0 just before
it and read just after it. The line before the last is the
``{"kernels": [...]}`` JSON; the last line is ``{"ok": true, "device":
{...}}``. Without a card, or without the port beside it, the script exits
non-zero and prints no result.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
C_ROWS = 1 << 20                 # rows per table, as in the bench's legs
N_IDS = 1 << 15                  # ids per serving-leg call
FILL = 1 << 19                   # resident keys per DCN table
BATCH = 2048
REQUESTS = 20
SEED = 0
L2_FLUSH_BYTES = 256 << 20       # > the H100's 50 MB L2
SLEEP_CYCLES = 2_000_000         # ~1 ms: the host enqueues while the card waits
F32_RTOL = 1e-5                  # DCN against float64: f32, other sum order


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=25):
    """Median device time of one ``fn()`` call, from a cold L2. Each call is
    bracketed by CUDA events behind a short device-side sleep, so the host's
    launch overhead is hidden unless ``fn`` synchronises itself (the plain
    scatter's boolean indexing does, and its time includes that)."""
    fn()
    torch.cuda.synchronize()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEV)
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_case(torch, rowops, dtype, width, n, gen):
    """Hold both kernels (scatter: set and add) against their plain versions
    at one shape, and time kernel, plain version and the one-call library
    yardstick. Bounds count each index read once, each distinct source row
    read once and each output row written once."""
    values = torch.randn(C_ROWS, width, device=DEV, generator=gen).to(dtype)
    esz = values.element_size()
    # gather: duplicates, negatives, the last row and beyond it
    gidx = torch.randint(0, C_ROWS, (n,), device=DEV, generator=gen,
                         dtype=torch.int32)
    gidx[:64] = -torch.arange(1, 65, device=DEV, dtype=torch.int32)
    gidx[64:96] = C_ROWS - 1
    gidx[96:128] = gidx[128:160]
    gidx[160] = C_ROWS + 7
    # scatter: unique indices with negatives, the last row and beyond it
    sidx = torch.randperm(C_ROWS - 1, device=DEV, generator=gen)[:n].to(
        torch.int32)
    sidx[:64] = -torch.arange(1, 65, device=DEV, dtype=torch.int32)
    sidx[64] = C_ROWS - 1
    sidx[65] = C_ROWS + 3
    rows = torch.randn(n, width, device=DEV, generator=gen).to(dtype)

    out = {}
    got = rowops.gather_rows(values, gidx)
    want = rowops.gather_rows_plain(values, gidx)
    check(torch.equal(got, want), f"gather_rows {dtype} W={width} differs")
    out["gather_err"] = (got.float() - want.float()).abs().max().item()
    for add in (False, True):
        v1, v2 = values.clone(), values.clone()
        rowops.scatter_rows(v1, sidx, rows, add=add)
        rowops.scatter_rows_plain(v2, sidx, rows, add=add)
        check(torch.equal(v1, v2),
              f"scatter_rows(add={add}) {dtype} W={width} differs")
        out[f"scatter_{'add' if add else 'set'}_err"] = \
            (v1.float() - v2.float()).abs().max().item()
        del v1, v2
    torch.cuda.synchronize()

    row_bytes = width * esz
    clamped = gidx.long().clamp(0, C_ROWS - 1)
    keep = (sidx >= 0) & (sidx < C_ROWS)
    kept_idx, kept_rows = sidx[keep].long(), rows[keep]
    n_kept = int(keep.sum())
    n_rows_read = int(torch.unique(clamped).numel())
    out["gather_ms"] = time_ms(torch, lambda: rowops.gather_rows(values, gidx))
    out["gather_plain_ms"] = time_ms(
        torch, lambda: rowops.gather_rows_plain(values, gidx))
    out["gather_library_ms"] = time_ms(
        torch, lambda: torch.index_select(values, 0,
                                          gidx.clamp(0, C_ROWS - 1)))
    out["gather_bound_ms"] = bound_ms(n * 4 + n_rows_read * row_bytes
                                      + n * row_bytes)
    target = values.clone()
    out["scatter_ms"] = time_ms(
        torch, lambda: rowops.scatter_rows(target, sidx, rows))
    out["scatter_plain_ms"] = time_ms(
        torch, lambda: rowops.scatter_rows_plain(target, sidx, rows))
    out["scatter_library_ms"] = time_ms(
        torch, lambda: target.index_copy_(0, kept_idx, kept_rows))
    out["scatter_bound_ms"] = bound_ms(n * 4 + 2 * n_kept * row_bytes)
    out["scatter_add_ms"] = time_ms(
        torch, lambda: rowops.scatter_rows(target, sidx, rows, add=True))
    out["scatter_add_plain_ms"] = time_ms(
        torch, lambda: rowops.scatter_rows_plain(target, sidx, rows, add=True))
    out["scatter_add_library_ms"] = time_ms(
        torch, lambda: target.index_add_(0, kept_idx, kept_rows))
    out["scatter_add_bound_ms"] = bound_ms(n * 4 + 3 * n_kept * row_bytes)
    del values, target
    torch.cuda.empty_cache()
    return out


def kernel_phase(torch, rowops):
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    shapes = [(dtype, width, N_IDS)
              for dtype in (torch.float32, torch.bfloat16)
              for width in (64, 128, 384)]
    # the DCN request's gathers and the DCN fill's scatters
    shapes += [(torch.float32, width, n)
               for n in (BATCH, FILL) for width in (64, 128)]
    cases = {}
    for dtype, width, n in shapes:
        name = f"{str(dtype).split('.')[-1]}_w{width}_n{n}"
        cases[name] = c = kernel_case(torch, rowops, dtype, width, n, gen)
        print("kernel case", name, json.dumps(c), flush=True)
    return cases


def reset_launches(rowops):
    rowops.gather_rows.launches = rowops.scatter_rows.launches = 0


def read_launches(rowops):
    return {"gather_rows": rowops.gather_rows.launches,
            "scatter_rows": rowops.scatter_rows.launches}


def embedding_serving_phase(torch, np, kv, hashing, rowops, profile_dir):
    """The bench's serving-leg shape: dim 128, 1M rows, 32k ids."""
    rng = np.random.RandomState(SEED)
    ids = rng.permutation(np.unique(rng.randint(0, 1 << 40, N_IDS + 4096,
                                                dtype=np.int64)))[:N_IDS]
    reps = 20
    reset_launches(rowops)
    t = kv.create(128, C_ROWS, max_probes=16, seed=SEED, device=DEV)
    q = kv.encode_ids(ids, device=DEV)
    res = kv.lookup_or_insert(t, q)
    t = res.table
    kv.lookup_or_zeros(t, q)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qf = q.flip(0)
    for _ in range(reps):
        a = kv.lookup_or_zeros(t, q)
        b = kv.lookup_or_zeros(t, qf)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(rowops)

    check(not bool(res.overflow), "serving leg: lookup_or_insert overflowed")
    check(int(kv.size(t)) == N_IDS, "serving leg: wrong table size")
    r1, r2 = hashing.init_row_indices(q, t.init_pool.shape[0])
    expect = (t.init_pool[r1] + t.init_pool[r2]) * 0.5
    check(torch.equal(res.rows, expect), "serving leg: inserted rows differ")
    check(torch.equal(a, expect) and torch.equal(b, expect.flip(0)),
          "serving leg: lookup_or_zeros rows differ from the inserted rows")
    unknown = kv.lookup_or_zeros(t, kv.encode_ids(ids + (1 << 41),
                                                  device=DEV))
    check(bool((unknown == 0).all()), "serving leg: unknown ids not zero")
    check(launches["gather_rows"] > 0 and launches["scatter_rows"] > 0,
          f"serving leg did not launch both kernels: {launches}")
    rate = 2 * reps * N_IDS / dt
    print(f"embedding serving: {rate:.1f} ids/s (lookup_or_zeros of "
          f"{N_IDS} ids, dim 128, {C_ROWS} rows, {2 * reps} calls in "
          f"{dt:.6f} s); launches {json.dumps(launches)}", flush=True)
    if profile_dir:
        profile_calls(torch, "embedding",
                      [lambda: kv.lookup_or_zeros(t, q)] * 5,
                      dt / (2 * reps), profile_dir)
    del t, res
    torch.cuda.empty_cache()
    return launches, rate


def dcn_reference(np, dense, embs, features, labels):
    """Float64 numpy forward of the DCN's dense towers: the logits, the deep
    tower's logit alone and the loss."""
    p = {k: v.detach().double().cpu().numpy()
         for k, v in dense.state_dict().items()}
    x0 = np.concatenate([embs[f"C{i + 1}"] for i in range(len(embs))]
                        + [features], axis=1).astype(np.float64)
    h = x0
    for i in range(len(dense.dnn)):
        h = np.maximum(h @ p[f"dnn.{i}.w"] + p[f"dnn.{i}.b"], 0.0)
    deep = h @ p["dnn_logits.w"] + p["dnn_logits.b"]
    x = x0
    for i in range(len(dense.cross)):
        x = x0 * (x @ p[f"cross.{i}.w"])[:, None] + p[f"cross.{i}.b"] + x
    logit = (deep + x @ p["cross_logits.w"] + p["cross_logits.b"])[:, 0]
    loss = np.mean(np.maximum(logit, 0) - logit * labels
                   + np.log1p(np.exp(-np.abs(logit))))
    return logit, deep[:, 0], loss


def err_ratio(np, got, ref, rtol=F32_RTOL):
    """Largest ``|got - ref| / (atol + rtol·|ref|)`` over the elements, with
    ``atol = rtol·rms(ref)`` so that sums which cancel to near zero are held
    to the batch's scale; a ratio above 1 fails."""
    got = got.double().cpu().numpy().reshape(ref.shape)
    atol = rtol * float(np.sqrt(np.mean(ref * ref)))
    return float(np.max(np.abs(got - ref) / (atol + rtol * np.abs(ref))))


def deep_logit(step, state, batch):
    """One request through the serving step; returns the deep tower's logit
    as the step computed it (a forward hook on ``dnn_logits``)."""
    seen = []
    hook = state.dense.dnn_logits.register_forward_hook(
        lambda mod, args, out: seen.append(out.detach().clone()))
    try:
        step(state, batch)
    finally:
        hook.remove()
    return seen[0][:, 0]


def dcn_serving_phase(torch, np, kv, embedding, models, rowops, profile_dir):
    """Reference-width DCN: fill 26 tables, then serve batch-2048 requests."""
    model = models.DCN(capacity=C_ROWS)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    rng = np.random.RandomState(SEED + 1)
    tables_keys = {
        f"C{i + 1}": rng.permutation(np.unique(rng.randint(
            0, 1 << 40, FILL + FILL // 8, dtype=np.int64)))[:FILL]
        for i in range(len(model.embedding_dims))}

    reset_launches(rowops)
    t0 = time.perf_counter()
    state = models.init_state(model, seed=SEED, device=DEV)
    rows_in = {}
    for name in sorted(state.tables):
        t = state.tables[name]
        rows_in[name] = torch.randn(FILL, t.dim, device=DEV, generator=gen)
        kv.insert(t, kv.encode_ids(tables_keys[name], device=DEV),
                  rows_in[name], day=1)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    fill_launches = read_launches(rowops)

    # a user-facing insert may drop keys whose two buckets are full: serve
    # only what was placed (a handful of keys per table at this load)
    resident = {}
    for name, keys in tables_keys.items():
        found = kv.find(state.tables[name],
                        kv.encode_ids(keys, device=DEV)).found.cpu().numpy()
        check(found.mean() > 0.999, f"DCN fill: {name} placed too few rows")
        resident[name] = np.nonzero(found)[0]       # rows of rows_in[name]
    batches = []
    for _ in range(REQUESTS + 1):
        ids = {}
        for name, keys in tables_keys.items():
            col = keys[rng.choice(resident[name], BATCH)]
            unknown = rng.rand(BATCH) < 0.05
            col[unknown] = rng.randint(1 << 41, 1 << 42, int(unknown.sum()),
                                       dtype=np.int64)
            ids[name] = col
        batches.append({"ids": ids,
                        "features": rng.randn(BATCH, 13).astype(np.float32),
                        "labels": rng.randint(0, 2, BATCH).astype(np.float32)})
    step = models.make_train_step(model, train=False)
    step(state, batches[0])                                   # warm-up
    torch.cuda.synchronize()
    gather1 = rowops.gather_rows.launches
    outs = []
    t0 = time.perf_counter()
    for b in batches[1:]:
        outs.append(step(state, b)[1:])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(rowops)
    per_request = (launches["gather_rows"] - gather1) / REQUESTS

    payload_gb = sum(t.payload.numel() * t.payload.element_size()
                     for t in state.tables.values()) / 1e9
    print(f"DCN fill: {len(state.tables)} tables x {C_ROWS} rows "
          f"({payload_gb:.3f} GB payload), {FILL} keys each, in "
          f"{fill_s:.3f} s; launches {json.dumps(fill_launches)}", flush=True)
    check(launches["gather_rows"] > 0 and launches["scatter_rows"] > 0,
          f"DCN path did not launch both kernels: {launches}")
    for loss, preds in outs:
        check(preds.shape == (BATCH,) and bool(torch.isfinite(preds).all())
              and bool(torch.isfinite(loss)), "DCN: non-finite output")

    # the first timed request against a host-side map of what was inserted
    b = batches[1]
    embs = {}
    for name, keys in tables_keys.items():
        order = resident[name][np.argsort(keys[resident[name]])]
        ids = b["ids"][name]
        pos = np.minimum(np.searchsorted(keys[order], ids),
                         order.shape[0] - 1)
        hit = keys[order[pos]] == ids
        ref = rows_in[name][torch.from_numpy(order[pos]).to(DEV)]
        ref = torch.where(torch.from_numpy(hit).to(DEV)[:, None], ref,
                          torch.zeros_like(ref))
        look, _ = embedding.lookup_unique(state.tables[name], ids,
                                          train=False)
        check(torch.equal(embedding.gather(look), ref),
              f"DCN: {name} looked-up rows differ from the inserted rows")
        embs[name] = ref.cpu().numpy()
    ref_logits, ref_deep, ref_loss = dcn_reference(
        np, state.dense, embs, b["features"], b["labels"])
    loss, preds = outs[0]
    # The logits' scale comes from the cross net's elementwise sums; the deep
    # tower's matmuls are held on their own, once as served (TF32 off) and
    # once with TF32 on as a control that the check must catch.
    preds_ratio = err_ratio(np, preds, ref_logits)
    loss_err = abs(float(loss) - float(ref_loss))
    deep_ratio = err_ratio(np, deep_logit(step, state, b), ref_deep)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_ratio = err_ratio(np, deep_logit(step, state, b), ref_deep)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    precision = {"rtol": F32_RTOL, "preds_err_ratio": preds_ratio,
                 "deep_logit_err_ratio": deep_ratio,
                 "deep_logit_err_ratio_tf32_control": tf32_ratio,
                 "loss_abs_err": loss_err, "loss": float(ref_loss),
                 "max_abs_logit": float(np.abs(ref_logits).max()),
                 "rms_deep_logit": float(np.sqrt(np.mean(ref_deep ** 2)))}
    print("DCN precision against a float64 reference:",
          json.dumps(precision), flush=True)
    check(preds_ratio <= 1 and deep_ratio <= 1
          and loss_err <= F32_RTOL * max(1.0, abs(float(ref_loss))),
          f"DCN: preds/loss differ from the float64 reference: {precision}")
    check(tf32_ratio > 1, "DCN: the precision check does not see TF32 in "
          f"the deep tower: {precision}")
    rate = REQUESTS * BATCH / dt
    print(f"DCN serving: {rate:.1f} examples/s ({REQUESTS} requests of "
          f"batch {BATCH} in {dt:.6f} s, {per_request:.1f} gathers per "
          f"request); launches {json.dumps(launches)}", flush=True)
    if profile_dir:
        profile_calls(torch, "dcn", [lambda b=b: step(state, b)
                                     for b in batches[1:4]],
                      dt / REQUESTS, profile_dir)
    return launches, rate, per_request


def profile_calls(torch, name, calls, call_s, out_dir):
    """torch.profiler over a few calls of one path: device kernel time and
    kernel launches per call, and the device's busy share of an unprofiled
    call that took ``call_s``; the table of ops and kernels goes to
    ``out_dir/<name>_profile.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / len(calls)
    launches = sum(e.count for e in kernels) / len(calls)
    path = os.path.join(out_dir, f"{name}_profile.txt")
    with open(path, "w") as f:
        f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
    print(f"{name} profile: {dev_ms:.4f} ms of device kernels and "
          f"{launches:.1f} kernel launches per call; device busy "
          f"{dev_ms / (call_s * 1e3):.4f} of an unprofiled call "
          f"({call_s * 1e3:.4f} ms); table in {path}", flush=True)


def kernel_entry(name, src, replaces, launches, errs, case, key):
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs),
            "ms": case[f"{key}_ms"], "plain_ms": case[f"{key}_plain_ms"],
            "bound_ms": case[f"{key}_bound_ms"], "bound_by": "bytes",
            "library_ms": case[f"{key}_library_ms"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler table of DCN requests here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA "
              "card", file=sys.stderr)
        return 1
    try:
        import numpy as np
        from tfplus_tpu_torch import embedding, kv, models
        from tfplus_tpu_torch.kv import hashing
        from tfplus_tpu_torch.ops import _build, rowops
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1
    smi = smi_line()
    print(smi, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.3f} s",
          flush=True)

    cases = kernel_phase(torch, rowops)
    emb_launches, emb_rate = embedding_serving_phase(
        torch, np, kv, hashing, rowops, args.profile)
    dcn_launches, dcn_rate, per_request = dcn_serving_phase(
        torch, np, kv, embedding, models, rowops, args.profile)

    errs = {k: [c[f"{k}_err"] for c in cases.values()]
            for k in ("gather", "scatter_set", "scatter_add")}
    check(max(max(v) for v in errs.values()) == 0.0,
          "a kernel differs from its plain version")
    src = "tfplus_tpu_torch/ops/csrc/rowops.cu"
    main_case = cases[f"float32_w128_n{N_IDS}"]     # the serving-leg shape
    kernels = [
        kernel_entry("gather_rows", src, "tfplus_tpu/ops/rowops.py:76",
                     emb_launches["gather_rows"] + dcn_launches["gather_rows"],
                     errs["gather"], main_case, "gather"),
        kernel_entry("scatter_rows", src, "tfplus_tpu/ops/rowops.py:122",
                     emb_launches["scatter_rows"]
                     + dcn_launches["scatter_rows"],
                     errs["scatter_set"] + errs["scatter_add"], main_case,
                     "scatter"),
    ]
    print(json.dumps({"serving": {
        "embedding_ids_per_s": emb_rate, "embedding_launches": emb_launches,
        "dcn_examples_per_s": dcn_rate, "dcn_launches": dcn_launches,
        "dcn_gathers_per_request": per_request}}))
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
