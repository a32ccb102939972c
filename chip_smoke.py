#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (tfplus_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py                  # build, check and measure
    python3 chip_smoke.py --profile DIR    # also writes torch.profiler tables
                                           # of the serving and training
                                           # paths to DIR

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
5. Attention kernels: each flash-forward kernel is held against its plain
   PyTorch version and timed beside it, beside the least time the card could
   take and beside ``scaled_dot_product_attention`` (timed only; the port
   never calls it): the bench's causal bf16 B4 H8 S2048 D128 and the same
   non-causal with segments from lengths (tiled kernel); BST's f32 heads,
   B2048 H8 S128 D8 with BST's request mask, without and with dropout
   (single-pass kernel); dropout 0.2 at S1000, causal and not, f32 and bf16;
   ``flash_attention_with_lse``'s residuals and its -inf on padding rows.
6. Flash entry points: ``flash_attention(causal=True)`` and
   ``flash_attention_with_lse`` at the bench's shape.
7. BST and DIN serving at published widths: an item table of 2^23 rows
   filled with 2^22 keys and a user table of 2^22 rows filled with 2^21,
   dim 64, then batch-2048 requests (histories of 1-20 items, 2 % of users
   with none, 5 % unknown ids) through ``make_train_step(train=False)``, BST
   first and then DIN on the same tables, checked against the host-side map
   of what was inserted and a float64 numpy forward pass (BST with a TF32
   control it must reject).
8. Attention-backward kernels: ``flash_bwd_dkv`` and ``flash_bwd_dq`` held
   against their plain versions and against float64 autograd through
   ``reference_attention``, rerun bit for bit, and timed beside the plain
   versions, the least time the card could take and the backward alone of
   ``scaled_dot_product_attention`` (timed only): the bench's causal bf16
   B4 H8 S2048 D128; BST's f32 heads with BST's request mask; dropout 0.2
   at S1000 D64, causal and not, f32 and bf16; non-causal bf16 S2048 D128
   with segments from lengths in 512-2048.
9. ``flash_attention(causal=True)`` forward and backward x10 at the bench's
   shape, in TFLOP/s counted as the JAX bench's ``grad=True`` leg.
10. Training checks at the reference DCN's and BST's widths with tables of
   2^14 rows: three steps from one state on the card and on the CPU (headers
   and slots bit for bit, the rest within the stated tolerances), two runs
   from cloned states bit for bit on the card, and a loss that falls over
   ten steps on one batch.
11. DCN training at the reference width: 26 tables of 2^20 rows with
   GroupAdam's slot columns (payload 4·D), each filled with 2^19 keys, then
   batch-2048 steps with 5 % unseen ids (GroupAdam 1e-3, dense Adam 1e-3).
12. BST training at published widths: the item and user tables of phase 7
   with Adam's slot columns (payload 3·D), batch-2048 steps (Adam 0.01,
   dense Adam 0.01); every step launches the single-pass forward and both
   backward kernels.
13. Compactor: ``ops.compact`` (an entry point no engine path calls) at its
   study shape, M = 1,572,864 x W = 256 f32, 2/3 live, R = 128, held bit
   for bit against its plain version and timed beside it, its byte bound
   and ``arena[live]``; then live shares 0-1, clustered dead runs, a single
   block, ``out_rows > M`` and a bf16 arena, each also rerun bit for bit.
14. Growth, checkpoint and resume at the reference DCN's width: every table
   starts at 2^14 rows, 12 steps of 2,048 fresh ids per table with
   ``grow_if_needed`` before each (every table doubles twice), a full
   checkpoint at step 6 and deltas at 9 and 12 (``CheckpointManager``, dense
   tower included), a restore into fresh 2^14-row templates by a second
   manager, every table compared with the live one per key and the dense
   tower bit for bit, and one more step from both states with equal losses.
15. Repartition: examples/checkpoint_resume.py's configuration (4 shards of
   dim 16, 30 steps, full + 2 deltas) restored into 6 shards, a 64-id sample
   bit for bit, then 5 more steps.
16. One growth at reference size: a dim-128 GroupAdam table of 2^20 rows with
   2^19 keys grown to 2^21, then compacted after a third of its keys are
   deleted, each timed against its byte bound and checked row for row.

Each path (the serving and training paths, the flash entry points, the
compactor entry point and the growth, checkpoint and repartition paths) runs
with the kernels' launch counts set to 0 just before it and read just after
it. Each phase frees its tables before the next and prints the peak device
memory it reached. The line before the last is the ``{"kernels": [...]}``
JSON, after the ``{"serving": ...}``, ``{"training": ...}`` and
``{"growth": ...}`` lines; the last line is ``{"ok": true, "device":
{...}}``. Without a card, or without the port beside it, the script exits
non-zero and prints no result.
"""
import argparse
import copy
import dataclasses
import functools
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
PEAK_FLOPS = {"bfloat16": 989e12,  # H100 SXM dense bf16 tensor cores
              "float32": 67e12}    # f32 on the CUDA cores (no TF32)
# Flash kernels against their plain versions. f32: another summation order
# only, so 1e-5 (a flipped dropout bit moves an output by p·v/(1 - 0.2),
# about 1e-3 at S = 1000, a hundred times the limit). bf16: the same f32
# arithmetic, then the output rounds to 8 significant bits, so one bf16 ulp
# (2^-7 relative) may differ: rtol 2^-6, atol 1e-5 for outputs near zero.
ATTN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2.0 ** -6)}
SEQ_REQUESTS = 10
# Backward kernels against their plain versions, (atol, rtol): f32 differs
# in summation order only, and one flipped dropout bit moves a gradient by
# about p·do/(1 - 0.2), some 1e-3 at S = 1000, a hundred times the limit;
# bf16 rounds p_d and ds to 8 bits before their products on both sides, and
# an intermediate that rounds the other way moves a gradient by a bf16 ulp
# of one term, the output rounds to bf16 too: 1e-2. Against float64
# autograd through reference_attention, |err| <= tol · max|grad|: 1e-5 for
# f32 (summation order over at most 2048 terms) and 2e-2 for bf16 (inputs
# exact in f64; p_d, ds, the output and di's o round to bf16).
BWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
BWD_F64_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TRAIN_STEPS = 10                 # timed training steps, after 2 warm-up
CHECK_ROWS = 1 << 14             # table rows of the training checks
CHECK_BATCH = 256                # batch of the card-against-CPU check
CHECK_STEPS = 3                  # steps of the card-against-CPU and rerun checks
# Card against CPU. Losses within 1e-5 (f32, other summation order). Step
# 1's dense gradients within 1e-5 of each tensor's largest gradient (f32
# sums over the batch in another order). After three steps, payloads, slot
# columns and dense parameters within atol 2e-5, rtol 1e-4 (the port's CPU
# parity limits) for all but 1e-3 of the elements, and every element within
# one learning rate per step: each Adam-type step moves an element by
# lr·m̂/(√v̂ + ε), and where a gradient lies within rounding of zero,
# m̂/(√v̂ + ε) turns the rounding of the two devices' sums into different
# steps of up to about lr (BST's dense tower after its step-2 loss spike
# showed 2.2e-4 of its elements so, the largest 0.5·lr off, on an H100).
TRAIN_TOL = {"loss": 1e-5, "grad": 1e-5, "atol": 2e-5, "rtol": 1e-4,
             "share": 1e-3}
HIST = 20                        # BST paper's history length (Table 2)
ITEM_ROWS, ITEM_FILL = 1 << 23, 1 << 22
USER_ROWS, USER_FILL = 1 << 22, 1 << 21
# BST per arXiv:1905.06874 §4 (Table 2): embedding 64 (top of its 4-64
# range), 8 heads, head dim 8 (= d/h), 1 transformer block, MLP 1024-512-256,
# history 20. Assumed (the paper gives none): ffn_hidden 256 (4·d, the
# Transformer's convention) and num_numeric 4 (the repo's default).
BST_CONFIG = dict(embedding_dim=64, seq_len=HIST, num_numeric=4, num_heads=8,
                  head_dim=8, num_blocks=1, ffn_hidden=256,
                  dnn_hidden=(1024, 512, 256), capacity=ITEM_ROWS)
# DIN at the same width; dnn_hidden from the DIN paper's MLP
# (arXiv:1706.06978 §6.3, 200-80); att_hidden at the repo's default (64, 32),
# assumed.
DIN_CONFIG = dict(embedding_dim=64, seq_len=HIST, num_numeric=4,
                  att_hidden=(64, 32), dnn_hidden=(200, 80),
                  capacity=ITEM_ROWS)
# the compactor's study shape (scripts/prof_compactor.py): 1.5M rows x 256
# f32 lanes, 2/3 live, 128-row blocks
COMPACT_M, COMPACT_W, COMPACT_R = 1_572_864, 256, 128
# growth, checkpoint and resume: tables start at 2^14 rows (a cut), 12 steps
# of 2,048 fresh ids per table, a full save at step 6 and deltas at 9 and 12
GROW_START_ROWS = 1 << 14
GROW_STEPS = 12
GROW_SAVES = (6, 9, 12)


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


def _wrappers():
    from tfplus_tpu_torch.ops import compactor, rowops
    from tfplus_tpu_torch.ops import flash_attention as fa
    return {"gather_rows": rowops.gather_rows,
            "scatter_rows": rowops.scatter_rows,
            "flash_fwd": fa.flash_fwd, "flash_fwd_single": fa.flash_fwd_single,
            "flash_bwd_dkv": fa.flash_bwd_dkv,
            "flash_bwd_dq": fa.flash_bwd_dq, "compact": compactor.compact}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _wrappers().items()}


def embedding_serving_phase(torch, np, kv, hashing, rowops, profile_dir):
    """The bench's serving-leg shape: dim 128, 1M rows, 32k ids."""
    rng = np.random.RandomState(SEED)
    ids = rng.permutation(np.unique(rng.randint(0, 1 << 40, N_IDS + 4096,
                                                dtype=np.int64)))[:N_IDS]
    reps = 20
    reset_launches()
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
    launches = read_launches()

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
    return logit, deep[:, 0], sigmoid_ce_mean(np, logit, labels)


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

    reset_launches()
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
    fill_launches = read_launches()

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
    launches = read_launches()
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
        ref = host_rows(torch, np, keys, order, rows_in[name], ids)
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


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------

def _dtype_name(dtype):
    return str(dtype).split(".")[-1]


def attention_bound(fa, q, k, qs, ks, causal, residuals):
    """Least time of one forward on these inputs, ``(ms, bound_by, flops)``:
    the larger of the operations that the valid (row, key) pairs need (4·D
    each: qkᵀ and pv) over the peak rate of q's type, and the bytes that
    this input needs over the HBM rate: q rows that hit a key and k, v rows
    that some row hits, each read once; out (and l, m) written once; the
    segment ids read once."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    esz = q.element_size()
    mask = fa._attention_mask(sq, skv, qs, ks, causal, q.device).expand(
        b, sq, skv)
    flops = 4 * d * h * int(mask.sum())
    nbytes = ((int(mask.any(-1).sum()) + 2 * int(mask.any(-2).sum()))
              * h * d * esz + b * h * sq * d * esz)
    if qs is not None:
        nbytes += 4 * (qs.numel() + ks.numel())
    if residuals:
        nbytes += 2 * 4 * b * h * sq
    t_bytes = bound_ms(nbytes)
    t_ops = flops / PEAK_FLOPS[_dtype_name(q.dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), flops


def sdpa_call(torch, fa, q, k, v, qs, ks, causal, sm_scale):
    """One ``scaled_dot_product_attention`` call on the same inputs (timed
    as a yardstick only; the port never calls it). The boolean mask is built
    outside the timed call."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if qs is None:
        return lambda: sdpa(q, k, v, is_causal=causal, scale=sm_scale)
    mask = fa._attention_mask(q.shape[2], k.shape[2], qs, ks, causal,
                              q.device)[:, None]
    return lambda: sdpa(q, k, v, attn_mask=mask, scale=sm_scale)


def bst_token_mask(np, rng, batch):
    """BST's request mask: histories of 1-20 items, 2 % of users with none."""
    lengths = rng.randint(1, HIST + 1, batch)
    lengths[rng.rand(batch) < 0.02] = 0
    return (np.arange(HIST)[None, :] < lengths[:, None]).astype(np.float32)


def attention_case(torch, np, fa, name, gen, b, h, s, d, dtype, causal,
                   seg=None, p_dropout=0.0):
    """Hold the routed kernel against its plain version (out, l, m), check
    ``flash_attention_with_lse`` (same out, lse = m + log l, -inf on rows
    that hit no key), and time kernel, plain version and SDPA."""
    q, k, v = (torch.randn(b, h, s, d, device=DEV, generator=gen).to(dtype)
               for _ in range(3))
    qs = ks = seg
    single = not causal and fa.single_fits(s, d, dtype)
    kernel, plain = ((fa.flash_fwd_single, fa.fwd_single_plain) if single
                     else (fa.flash_fwd, fa.fwd_tiled_plain))
    kw = dict(sm_scale=1.0 / float(np.sqrt(d)), p_dropout=p_dropout)
    if not single:
        kw["causal"] = causal
    got = kernel(q, k, v, qs, ks, SEED, **kw)
    want = plain(q, k, v, qs, ks, SEED, **kw)
    out, lse = fa.flash_attention_with_lse(
        q, k, v, causal=causal, q_segment_ids=qs, kv_segment_ids=ks,
        p_dropout=p_dropout, dropout_seed=SEED)
    torch.cuda.synchronize()
    dname = _dtype_name(dtype)
    ratios = []
    for g, w, (atol, rtol) in zip(got, want, [ATTN_TOL[dname]]
                                  + [ATTN_TOL["float32"]] * 2):
        g, w = g.float(), w.float()
        ratios.append(float(((g - w).abs() / (atol + rtol * w.abs())).max()))
    err = float((got[0].float() - want[0].float()).abs().max())
    hit = want[1] > 0
    want_lse = torch.where(hit, want[2] + torch.log(torch.where(
        hit, want[1], 1.0)), -float("inf"))
    lse_ok = (torch.equal(torch.isneginf(lse), ~hit)
              and float((lse[hit] - want_lse[hit]).abs().max())
              <= 1e-5 * (1.0 + float(want_lse[hit].abs().max())))
    if seg is not None:         # padding rows hit nothing
        lse_ok = lse_ok and bool(torch.isneginf(
            lse.transpose(0, 1)[:, seg < 0]).all())
    c = {"kernel": kernel.__name__, "dtype": dname, "shape": [b, h, s, d],
         "causal": causal, "segments": seg is not None,
         "p_dropout": p_dropout, "max_abs_err": err,
         "err_ratio_out_l_m": ratios, "lse_ok": lse_ok,
         "entry_point_equals_kernel": torch.equal(out, got[0])}
    check(max(ratios) <= 1 and lse_ok and c["entry_point_equals_kernel"],
          f"attention case {name}: kernel differs from its plain version: "
          f"{json.dumps(c)}")
    c["ms"] = time_ms(torch, lambda: kernel(q, k, v, qs, ks, SEED,
                                            save_residuals=False, **kw))
    c["plain_ms"] = time_ms(torch, lambda: plain(q, k, v, qs, ks, SEED,
                                                 **kw))
    c["library_ms"] = None if p_dropout else time_ms(
        torch, sdpa_call(torch, fa, q, k, v, qs, ks, causal, kw["sm_scale"]))
    c["bound_ms"], c["bound_by"], flops = attention_bound(
        fa, q, k, qs, ks, causal, residuals=False)
    c["tflops"] = flops / c["ms"] / 1e9
    return c, (q, k, v, got[0])


def attention_phase(torch, np, fa):
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    rng = np.random.RandomState(SEED + 2)
    bench_seg = fa.make_segment_ids_from_lengths(
        torch.from_numpy(rng.randint(512, 2049, 4)).to(DEV), 2048)
    tok = np.concatenate([bst_token_mask(np, rng, BATCH),
                          np.ones((BATCH, 1), np.float32)], axis=1)
    bst_seg = torch.from_numpy(np.pad(np.where(tok > 0, 0, -1), (
        (0, 0), (0, 128 - tok.shape[1])), constant_values=-1)).to(
            device=DEV, dtype=torch.int32)
    bf16, f32 = torch.bfloat16, torch.float32
    specs = [
        ("bench_causal_bf16", 4, 8, 2048, 128, bf16, True, None, 0.0),
        ("bench_segments_bf16", 4, 8, 2048, 128, bf16, False, bench_seg, 0.0),
        ("bst_f32", BATCH, 8, 128, 8, f32, False, bst_seg, 0.0),
        ("bst_dropout_f32", BATCH, 8, 128, 8, f32, False, bst_seg, 0.2),
    ] + [(f"s1000_dropout_{'causal' if c else 'full'}_{_dtype_name(t)}",
          2, 8, 1000, 64, t, c, None, 0.2)
         for c in (True, False) for t in (f32, bf16)]
    cases, bench = {}, None
    for name, *spec in specs:
        cases[name], tensors = attention_case(torch, np, fa, name, gen, *spec)
        if name == "bench_causal_bf16":
            bench = tensors
        print("attention case", name, json.dumps(cases[name]), flush=True)
    check(cases["bench_causal_bf16"]["kernel"] == "flash_fwd"
          and cases["bench_segments_bf16"]["kernel"] == "flash_fwd"
          and cases["bst_f32"]["kernel"] == "flash_fwd_single",
          "attention cases did not take the expected routes")
    torch.cuda.empty_cache()
    return cases, bench


def flash_path_phase(torch, fa, bench, reps=10):
    """The public entry points at the bench's shape (causal bf16 B4 H8
    S2048 D128): ``flash_attention`` and ``flash_attention_with_lse``."""
    q, k, v, kernel_out = bench
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fa.flash_attention(q, k, v, causal=True)
    out2, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    check(launches["flash_fwd"] == reps + 1
          and launches["flash_fwd_single"] == 0,
          f"flash entry points did not launch the tiled kernel: {launches}")
    check(torch.equal(out, kernel_out) and torch.equal(out2, kernel_out)
          and bool(torch.isfinite(lse).all()),
          "flash entry points differ from the checked kernel output")
    _, _, flops = attention_bound(fa, q, k, None, None, True, False)
    print(f"flash entry points: {(reps + 1) * flops / dt / 1e12:.4f} "
          f"TFLOP/s ({reps} flash_attention + 1 flash_attention_with_lse, "
          f"causal bf16 B4 H8 S2048 D128, in {dt:.6f} s); launches "
          f"{json.dumps(launches)}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# BST and DIN serving
# ---------------------------------------------------------------------------

def host_rows(torch, np, keys, order, rows_in, ids):
    """Rows a lookup of ``ids`` must return: the inserted row of a resident
    key (``order`` sorts the resident rows of ``rows_in`` by key), zeros for
    any other id."""
    ids = np.asarray(ids)
    pos = np.minimum(np.searchsorted(keys[order], ids), order.shape[0] - 1)
    hit = keys[order[pos]] == ids
    ref = rows_in[torch.from_numpy(order[pos]).to(DEV)]
    return torch.where(torch.from_numpy(hit).to(DEV)[:, None], ref,
                       torch.zeros_like(ref))


def sigmoid_ce_mean(np, logit, labels):
    return np.mean(np.maximum(logit, 0) - logit * labels
                   + np.log1p(np.exp(-np.abs(logit))))


def _ref_dense(p, x, name, relu=False):
    y = x @ p[f"{name}.w"] + p[f"{name}.b"]
    return (y > 0) * y if relu else y


def bst_reference(np, model, p, e_item, e_user, feats):
    """Float64 numpy forward of BST over the unpadded tokens."""
    mask = feats["mask"]
    b, hist = mask.shape
    d, heads, dh = model.embedding_dim, model.num_heads, model.head_dim
    x = np.concatenate([e_item[b:].reshape(b, hist, d), e_item[:b, None]],
                       axis=1) + p["pos"][None, :hist + 1]
    tok = np.concatenate([mask, np.ones((b, 1))], axis=1) > 0
    valid = tok[:, None, :, None] & tok[:, None, None, :]

    def ln(x, pre):
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        return (x - mu) / np.sqrt(var + 1e-6) * p[f"{pre}.g"] + p[f"{pre}.b"]

    for i in range(model.num_blocks):
        pre = f"blocks.{i}"
        q, k, v = (t.reshape(b, hist + 1, heads, dh).transpose(0, 2, 1, 3)
                   for t in np.split(_ref_dense(p, ln(x, f"{pre}.ln1"),
                                                f"{pre}.qkv"), 3, axis=-1))
        s = np.where(valid, q @ k.transpose(0, 1, 3, 2) / np.sqrt(dh),
                     -1e300)
        w = np.exp(s - s.max(-1, keepdims=True)) * valid
        w = w / np.maximum(w.sum(-1, keepdims=True), 1e-300)
        att = (w @ v).transpose(0, 2, 1, 3).reshape(b, hist + 1, heads * dh)
        x = x + _ref_dense(p, att, f"{pre}.proj")
        y = _ref_dense(p, ln(x, f"{pre}.ln2"), f"{pre}.ffn1", relu=True)
        x = x + _ref_dense(p, y, f"{pre}.ffn2")
    w = tok[..., None]
    pooled = (x * w).sum(1) / np.maximum(w.sum(1), 1.0)
    h = np.concatenate([e_user, pooled, x[:, hist], feats["numeric"]], -1)
    for i in range(len(model.dnn_hidden)):
        h = _ref_dense(p, h, f"dnn.{i}", relu=True)
    return _ref_dense(p, h, "dnn_logits")[:, 0]


def din_reference(np, model, p, e_item, e_user, feats):
    """Float64 numpy forward of DIN."""
    mask = feats["mask"]
    b, hist = mask.shape
    cand = e_item[:b]
    seq = e_item[b:].reshape(b, hist, model.embedding_dim)
    cexp = np.broadcast_to(cand[:, None], seq.shape)
    h = np.concatenate([seq, cexp, seq * cexp, seq - cexp], -1)
    for i in range(len(model.att_hidden)):
        h = _ref_dense(p, h, f"att.{i}", relu=True)
    scores = np.where(mask > 0, _ref_dense(p, h, "att_out")[..., 0], -1e9)
    w = np.exp(scores - scores.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True) * (mask.sum(-1, keepdims=True) > 0)
    interest = np.einsum("bl,bld->bd", w, seq)
    h = np.concatenate([e_user, cand, interest, interest * cand,
                        feats["numeric"]], -1)
    for i in range(len(model.dnn_hidden)):
        h = _ref_dense(p, h, f"dnn.{i}", relu=True)
    return _ref_dense(p, h, "dnn_logits")[:, 0]


def sequence_batch(np, models, rng, keys, resident, batch=BATCH):
    """One request: candidates and histories of resident items with 5 %
    unknown ids, pad id 0 (never inserted) behind each history, users with
    5 % unknown."""
    mask = bst_token_mask(np, rng, batch)
    item = keys["item"][rng.choice(resident["item"], (batch, HIST + 1))]
    unknown = rng.rand(batch, HIST + 1) < 0.05
    item[unknown] = rng.randint(1 << 41, 1 << 42, int(unknown.sum()),
                                dtype=np.int64)
    seq = np.where(mask > 0, item[:, 1:], 0)
    user = keys["user"][rng.choice(resident["user"], batch)]
    unknown = rng.rand(batch) < 0.05
    user[unknown] = rng.randint(1 << 41, 1 << 42, int(unknown.sum()),
                                dtype=np.int64)
    return {"ids": {"item": models.DIN.pack_item_ids(item[:, 0], seq),
                    "user": user},
            "features": {"numeric": rng.randn(batch, 4).astype(np.float32),
                         "mask": mask},
            "labels": rng.randint(0, 2, batch).astype(np.float32)}


def serve_sequence_model(torch, np, name, model, step, state, batches,
                         ref_fn, embs, profile_dir, tf32_control):
    """Time the requests with the launch counts reset just before, then
    check the first timed request against the float64 reference."""
    reset_launches()
    step(state, batches[0])                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [step(state, b)[1:] for b in batches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    for loss, preds in outs:
        check(preds.shape == (BATCH,) and bool(torch.isfinite(preds).all())
              and bool(torch.isfinite(loss)), f"{name}: non-finite output")
    b = batches[1]
    p = {k: v.detach().double().cpu().numpy()
         for k, v in state.dense.state_dict().items()}
    feats = {k: v.astype(np.float64) for k, v in b["features"].items()}
    ref = ref_fn(np, model, p, embs["item"], embs["user"], feats)
    ref_loss = sigmoid_ce_mean(np, ref, b["labels"])
    loss, preds = outs[0]
    precision = {"rtol": F32_RTOL, "preds_err_ratio": err_ratio(np, preds,
                                                                ref),
                 "loss_abs_err": abs(float(loss) - float(ref_loss)),
                 "loss": float(ref_loss),
                 "max_abs_logit": float(np.abs(ref).max()),
                 "rms_logit": float(np.sqrt(np.mean(ref ** 2)))}
    if tf32_control:
        # every dense layer of the step in TF32: the check must catch it
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            precision["preds_err_ratio_tf32_control"] = err_ratio(
                np, step(state, b)[2], ref)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{name} precision against a float64 reference:",
          json.dumps(precision), flush=True)
    check(precision["preds_err_ratio"] <= 1 and precision["loss_abs_err"]
          <= F32_RTOL * max(1.0, abs(float(ref_loss))),
          f"{name}: preds/loss differ from the float64 reference: "
          f"{precision}")
    if tf32_control:
        check(precision["preds_err_ratio_tf32_control"] > 1,
              f"{name}: the precision check does not see TF32: {precision}")
    n = len(batches)            # the warm-up request counts too
    per_request = {k: v / n for k, v in launches.items()}
    rate = (n - 1) * BATCH / dt
    print(f"{name} serving: {rate:.1f} examples/s ({n - 1} requests of "
          f"batch {BATCH} in {dt:.6f} s); kernel launches per request "
          f"{json.dumps(per_request)}", flush=True)
    if profile_dir:
        profile_calls(torch, name.lower(), [lambda b=b: step(state, b)
                                            for b in batches[1:4]],
                      dt / (n - 1), profile_dir)
    return launches, rate, per_request, precision


def sequence_serving_phase(torch, np, kv, embedding, models, profile_dir):
    """BST, then DIN on the same item and user tables, at published
    widths."""
    bst = models.BST(**BST_CONFIG)
    bst.table_specs["user"]["capacity"] = USER_ROWS
    din = models.DIN(**DIN_CONFIG)
    fills = {"item": ITEM_FILL, "user": USER_FILL}
    rng = np.random.RandomState(SEED + 3)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    keys = {name: rng.permutation(np.unique(rng.randint(
        1, 1 << 40, n + n // 8, dtype=np.int64)))[:n]
        for name, n in fills.items()}

    reset_launches()
    t0 = time.perf_counter()
    state = models.init_state(bst, seed=SEED, device=DEV)
    rows_in = {}
    for name in sorted(state.tables):
        t = state.tables[name]
        rows_in[name] = torch.randn(fills[name], t.dim, device=DEV,
                                    generator=gen)
        kv.insert(t, kv.encode_ids(keys[name], device=DEV), rows_in[name],
                  day=1)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    fill_launches = read_launches()
    check(fill_launches["scatter_rows"] > 0,
          f"BST/DIN fill did not launch the scatter kernel: {fill_launches}")
    resident, order = {}, {}
    for name, k in keys.items():
        found = kv.find(state.tables[name],
                        kv.encode_ids(k, device=DEV)).found.cpu().numpy()
        check(found.mean() > 0.999, f"BST/DIN fill: {name} placed too few")
        resident[name] = np.nonzero(found)[0]
        order[name] = resident[name][np.argsort(k[resident[name]])]
    payload_gb = sum(t.payload.numel() * t.payload.element_size()
                     + t.header.numel() * t.header.element_size()
                     for t in state.tables.values()) / 1e9
    print(f"BST/DIN fill: item {state.tables['item'].capacity} rows with "
          f"{ITEM_FILL} keys, user {state.tables['user'].capacity} rows with "
          f"{USER_FILL} keys, dim 64 ({payload_gb:.3f} GB of payload and "
          f"header), in {fill_s:.3f} s; launches "
          f"{json.dumps(fill_launches)}", flush=True)
    batches = [sequence_batch(np, models, rng, keys, resident)
               for _ in range(SEQ_REQUESTS + 1)]

    # the first timed request's rows against the host-side map
    b = batches[1]
    embs = {}
    for name in ("item", "user"):
        want = host_rows(torch, np, keys[name], order[name], rows_in[name],
                         b["ids"][name])
        look, _ = embedding.lookup_unique(state.tables[name], b["ids"][name],
                                          train=False)
        check(torch.equal(embedding.gather(look), want),
              f"BST/DIN: {name} looked-up rows differ from the inserted rows")
        embs[name] = want.double().cpu().numpy()

    out = {"fill_launches": fill_launches, "fill_s": fill_s}
    bst_step = models.make_train_step(bst, train=False)
    out["BST"] = serve_sequence_model(torch, np, "BST", bst, bst_step, state,
                                      batches, bst_reference, embs,
                                      profile_dir, tf32_control=True)
    launches = out["BST"][0]
    check(launches["flash_fwd_single"] >= len(batches)
          and launches["flash_fwd"] == 0 and launches["gather_rows"] > 0,
          f"BST path: expected flash_fwd_single on every request, no "
          f"flash_fwd, and row gathers: {launches}")
    din_state = models.TrainState(
        tables=state.tables, opt_state=None, step=state.step,
        dense=din.init_dense(torch.Generator().manual_seed(SEED), DEV))
    din_step = models.make_train_step(din, train=False)
    out["DIN"] = serve_sequence_model(torch, np, "DIN", din, din_step,
                                      din_state, batches, din_reference,
                                      embs, profile_dir, tf32_control=False)
    launches = out["DIN"][0]
    check(launches["gather_rows"] > 0 and launches["flash_fwd"] == 0
          and launches["flash_fwd_single"] == 0,
          f"DIN path: expected row gathers and no attention: {launches}")
    del state, din_state, rows_in
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# attention backward
# ---------------------------------------------------------------------------

def backward_bound(fa, q, k, qs, ks, causal, kernel):
    """Least time of one backward kernel on these inputs, ``(ms, bound_by,
    flops)``: the larger of its operations on the valid (row, key) pairs
    (2·D per product: four for dkv, three for dq) over the peak rate of q's
    type, and the bytes it must move over the HBM rate: q and do rows that
    hit a key, k and v rows that some row hits, and l, m, di of the hit
    rows, each read once; its outputs (dk and dv, or dq) written once; the
    segment ids read once."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    esz = q.element_size()
    mask = fa._attention_mask(sq, skv, qs, ks, causal, q.device).expand(
        b, sq, skv)
    flops = (8 if kernel == "dkv" else 6) * d * h * int(mask.sum())
    rows, keys = int(mask.any(-1).sum()), int(mask.any(-2).sum())
    nbytes = 2 * (rows + keys) * h * d * esz + 3 * 4 * rows * h
    nbytes += (2 * b * h * skv if kernel == "dkv" else b * h * sq) * d * esz
    if qs is not None:
        nbytes += 4 * (qs.numel() + ks.numel())
    t_bytes = bound_ms(nbytes)
    t_ops = flops / PEAK_FLOPS[_dtype_name(q.dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), flops


def sdpa_backward_call(torch, fa, q, k, v, qs, ks, causal, sm_scale, do):
    """The backward alone of one ``scaled_dot_product_attention`` call on the
    same inputs: the forward runs once here, untimed (a yardstick only; the
    port never calls it)."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = sdpa_call(torch, fa, *leaves, qs, ks, causal, sm_scale)()
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def backward_case(torch, np, fa, name, gen, q, k, v, causal, seg=None,
                  p_dropout=0.0):
    """Hold both backward kernels against their plain versions on the card
    and against float64 autograd through ``reference_attention``, rerun them
    bit for bit, and time kernel, plain version, bound and SDPA's
    backward."""
    b, h, s, d = q.shape
    dtype = q.dtype
    dname = _dtype_name(dtype)
    do = torch.randn(q.shape, device=DEV, generator=gen).to(dtype)
    qs = ks = seg
    sm = 1.0 / float(np.sqrt(d))
    out, l, m = fa._fwd_dispatch(q, k, v, qs, ks, SEED, causal, sm,
                                 p_dropout, save_residuals=True)
    di = fa._delta(do, out)
    args = (q, k, v, qs, ks, SEED, do, l, m, di)
    kw = dict(causal=causal, sm_scale=sm, p_dropout=p_dropout)
    dk, dv = fa.flash_bwd_dkv(*args, **kw)
    dq = fa.flash_bwd_dq(*args, **kw)
    want_dk, want_dv = fa.bwd_dkv_plain(*args, **kw)
    want_dq = fa.bwd_dq_plain(*args, **kw)
    again = fa.flash_bwd_dkv(*args, **kw) + (fa.flash_bwd_dq(*args, **kw),)
    torch.cuda.synchronize()
    atol, rtol = BWD_TOL[dname]

    def vs_plain(got, want):
        g, w = got.float(), want.float()
        return (float(((g - w).abs() / (atol + rtol * w.abs())).max()),
                float((g - w).abs().max()))

    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    ref = fa.reference_attention(*leaves, causal=causal, sm_scale=sm,
                                 q_segment_ids=qs, kv_segment_ids=ks,
                                 p_dropout=p_dropout, dropout_seed=SEED)
    f64 = torch.autograd.grad(ref, leaves, do.double())
    del ref, leaves
    f64_ratio = [float((g.double() - w).abs().max())
                 / max(float(w.abs().max()), 1e-30) / BWD_F64_TOL[dname]
                 for g, w in zip((dq, dk, dv), f64)]
    del f64
    c = {"dtype": dname, "shape": [b, h, s, d], "causal": causal,
         "segments": seg is not None, "p_dropout": p_dropout,
         "rerun_bit_identical": all(torch.equal(x, y) for x, y in
                                    zip(again, (dk, dv, dq))),
         "f64_err_ratio_dq_dk_dv": f64_ratio}
    for kernel, got, want in (("flash_bwd_dkv", (dk, dv), (want_dk, want_dv)),
                              ("flash_bwd_dq", (dq,), (want_dq,))):
        errs = [vs_plain(g, w) for g, w in zip(got, want)]
        c[kernel] = {"err_ratio": max(e[0] for e in errs),
                     "max_abs_err": max(e[1] for e in errs)}
    check(c["flash_bwd_dkv"]["err_ratio"] <= 1
          and c["flash_bwd_dq"]["err_ratio"] <= 1 and max(f64_ratio) <= 1
          and c["rerun_bit_identical"],
          f"backward case {name}: kernels differ: {json.dumps(c)}")
    del again, want_dk, want_dv, want_dq
    for kernel, fn, plain in (
            ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.bwd_dkv_plain),
            ("flash_bwd_dq", fa.flash_bwd_dq, fa.bwd_dq_plain)):
        e = c[kernel]
        e["ms"] = time_ms(torch, lambda fn=fn: fn(*args, **kw))
        e["plain_ms"] = time_ms(torch, lambda plain=plain: plain(*args, **kw),
                                reps=5)
        e["bound_ms"], e["bound_by"], flops = backward_bound(
            fa, q, k, qs, ks, causal, kernel.split("_")[-1])
        e["tflops"] = flops / e["ms"] / 1e9
    c["library_ms"] = None if p_dropout else time_ms(
        torch, sdpa_backward_call(torch, fa, q, k, v, qs, ks, causal, sm, do))
    torch.cuda.empty_cache()
    return c, (do, dq, dk, dv)


def attention_backward_phase(torch, np, fa, bench):
    """Four backward cases: (a) the bench shape, on the forward phase's
    inputs, whose gradients the entry-point phase reproduces; (b) BST's
    heads; (c) dropout at S1000; (d) segments from lengths."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    rng = np.random.RandomState(SEED + 4)
    bf16, f32 = torch.bfloat16, torch.float32

    def rand(b, h, s, d, dtype):
        return [torch.randn(b, h, s, d, device=DEV, generator=gen).to(dtype)
                for _ in range(3)]

    tok = np.concatenate([bst_token_mask(np, rng, BATCH),
                          np.ones((BATCH, 1), np.float32)], axis=1)
    bst_seg = torch.from_numpy(np.pad(np.where(tok > 0, 0, -1), (
        (0, 0), (0, 128 - tok.shape[1])), constant_values=-1)).to(
            device=DEV, dtype=torch.int32)
    bench_seg = fa.make_segment_ids_from_lengths(
        torch.from_numpy(rng.randint(512, 2049, 4)).to(DEV), 2048)
    specs = [("a_bench_causal_bf16", lambda: bench[:3], True, None, 0.0),
             ("b_bst_f32", lambda: rand(BATCH, 8, 128, 8, f32), False,
              bst_seg, 0.0)]
    specs += [(f"c_s1000_dropout_{'causal' if c else 'full'}_"
               f"{_dtype_name(t)}", lambda t=t: rand(2, 8, 1000, 64, t), c,
               None, 0.2) for c in (True, False) for t in (f32, bf16)]
    specs += [("d_segments_bf16", lambda: rand(4, 8, 2048, 128, bf16), False,
               bench_seg, 0.0)]
    cases, bench_grads = {}, None
    for name, make, causal, seg, p in specs:
        q, k, v = make()
        cases[name], grads = backward_case(torch, np, fa, name, gen, q, k, v,
                                           causal, seg, p)
        if name == "a_bench_causal_bf16":
            bench_grads = grads
        del q, k, v, grads
        print("backward case", name, json.dumps(cases[name]), flush=True)
    torch.cuda.empty_cache()
    return cases, bench_grads


def flash_grad_path_phase(torch, fa, bench, bench_grads, reps=10):
    """``flash_attention(causal=True)`` forward and backward at the bench's
    shape, reported as the JAX bench's ``grad=True`` leg counts it (3.5 ×
    the forward's operations, ``bench.py:116``)."""
    do, dq, dk, dv = bench_grads
    leaves = [t.detach().clone().requires_grad_() for t in bench[:3]]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fa.flash_attention(*leaves, causal=True)
        grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    check(launches["flash_fwd"] == reps and launches["flash_bwd_dkv"] == reps
          and launches["flash_bwd_dq"] == reps,
          f"flash gradients did not launch the kernels: {launches}")
    check(all(torch.equal(g, w) for g, w in zip(grads, (dq, dk, dv))),
          "flash_attention's gradients differ from the checked kernels'")
    _, _, flops = attention_bound(fa, *leaves[:2], None, None, True, False)
    tflops = reps * 3.5 * flops / dt / 1e12
    print(f"flash gradients: {tflops:.4f} TFLOP/s (flash_attention forward "
          f"+ backward x{reps}, causal bf16 B4 H8 S2048 D128, in {dt:.6f} s); "
          f"launches {json.dumps(launches)}", flush=True)
    return launches, tflops


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

_START = time.perf_counter()


def peak_memory(torch, name):
    """Print the phase's peak device memory and the script's run time so
    far, free the phase's caches and reset the peak."""
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"{name}: peak device memory {peak:.3f} GiB; "
          f"{time.perf_counter() - _START:.1f} s since the start", flush=True)
    return peak


def dcn_batch(np, rng, keys, resident, batch, unseen=0.05):
    ids = {}
    for name, k in keys.items():
        col = k[rng.choice(resident[name], batch)]
        unknown = rng.rand(batch) < unseen
        col[unknown] = rng.randint(1 << 41, 1 << 42, int(unknown.sum()),
                                   dtype=np.int64)
        ids[name] = col
    return {"ids": ids, "features": rng.randn(batch, 13).astype(np.float32),
            "labels": rng.randint(0, 2, batch).astype(np.float32)}


def fill_tables(torch, np, kv, state, keys, gen):
    """Insert ``keys[name]`` with random rows; returns the indices of the
    keys each table placed."""
    for name in sorted(state.tables):
        t = state.tables[name]
        kv.insert(t, kv.encode_ids(keys[name], device=DEV),
                  torch.randn(keys[name].shape[0], t.dim, device=DEV,
                              generator=gen), day=1)
    resident = {}
    for name, k in keys.items():
        found = kv.find(state.tables[name],
                        kv.encode_ids(k, device=DEV)).found.cpu().numpy()
        check(found.mean() > 0.999, f"fill: {name} placed too few rows")
        resident[name] = np.nonzero(found)[0]
    return resident


def train_path(torch, name, step, state, batches, per_step, profile_dir):
    """Two warm-up steps, then the timed ones; the launch counts are reset
    by the caller before the tables were filled."""
    for b in batches[:2]:
        state, loss, _ = step(state, b)
    torch.cuda.synchronize()
    before = read_launches()
    t0 = time.perf_counter()
    losses = []
    for b in batches[2:]:
        state, loss, preds = step(state, b)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = read_launches()
    n = len(batches) - 2
    check(all(bool(torch.isfinite(x)) for x in losses)
          and bool(torch.isfinite(preds).all()), f"{name}: non-finite loss")
    steps = {k: (after[k] - before[k]) / n for k in after}
    for k in per_step:
        check(steps[k] == per_step[k],
              f"{name}: expected {per_step[k]} {k} per step: {steps}")
    check(steps["gather_rows"] > 0 and steps["scatter_rows"] > 0,
          f"{name}: the row kernels were not launched: {steps}")
    rate = n * BATCH / dt
    print(f"{name} training: {rate:.1f} examples/s ({n} steps of batch "
          f"{BATCH} in {dt:.6f} s, loss {float(losses[0]):.6f} -> "
          f"{float(losses[-1]):.6f}); kernel launches per step "
          f"{json.dumps(steps)}", flush=True)
    if profile_dir:
        profile_calls(torch, f"{name.lower()}_train",
                      [lambda b=b: step(state, b) for b in batches[2:5]],
                      dt / n, profile_dir)
    return state, after, rate, steps


def dcn_training_phase(torch, np, kv, models, train, profile_dir):
    """Reference-width DCN: GroupAdam 1e-3 and dense Adam 1e-3 (the JAX
    bench's DCN leg), 26 tables of 2^20 rows with 2^19 keys each."""
    model = models.DCN(capacity=C_ROWS)
    opt = train.GroupAdamOptimizer()
    rng = np.random.RandomState(SEED + 5)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    keys = {f"C{i + 1}": rng.permutation(np.unique(rng.randint(
        0, 1 << 40, FILL + FILL // 8, dtype=np.int64)))[:FILL]
        for i in range(len(model.embedding_dims))}
    reset_launches()
    t0 = time.perf_counter()
    state = models.init_state(model, opt,
                              functools.partial(torch.optim.Adam, lr=1e-3),
                              seed=SEED, device=DEV)
    resident = fill_tables(torch, np, kv, state, keys, gen)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    payload_gib = sum(t.payload.numel() * t.payload.element_size()
                      for t in state.tables.values()) / 2 ** 30
    print(f"DCN training fill: 26 tables x {C_ROWS} rows x 4·D "
          f"({payload_gib:.3f} GiB payload), {FILL} keys each, in "
          f"{fill_s:.3f} s", flush=True)
    batches = [dcn_batch(np, rng, keys, resident, BATCH)
               for _ in range(TRAIN_STEPS + 2)]
    step = models.make_train_step(model, opt, sparse_lr=1e-3)
    state, launches, rate, per_step = train_path(
        torch, "DCN", step, state, batches, {"flash_fwd": 0}, profile_dir)
    del state
    return launches, rate, per_step, peak_memory(torch, "DCN training")


def bst_training_phase(torch, np, kv, models, train, profile_dir):
    """BST at published widths: Adam 0.01 and dense Adam 0.01 (the paper's
    Table 2 learning rate), the item and user tables of the serving phase
    with Adam's slots."""
    model = models.BST(**BST_CONFIG)
    model.table_specs["user"]["capacity"] = USER_ROWS
    opt = train.AdamOptimizer()
    fills = {"item": ITEM_FILL, "user": USER_FILL}
    rng = np.random.RandomState(SEED + 6)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    keys = {name: rng.permutation(np.unique(rng.randint(
        1, 1 << 40, n + n // 8, dtype=np.int64)))[:n]
        for name, n in fills.items()}
    reset_launches()
    state = models.init_state(model, opt,
                              functools.partial(torch.optim.Adam, lr=0.01),
                              seed=SEED, device=DEV)
    resident = fill_tables(torch, np, kv, state, keys, gen)
    batches = [sequence_batch(np, models, rng, keys, resident)
               for _ in range(TRAIN_STEPS + 2)]
    step = models.make_train_step(model, opt, sparse_lr=0.01)
    blocks = model.num_blocks
    state, launches, rate, per_step = train_path(
        torch, "BST", step, state, batches,
        {"flash_fwd_single": blocks, "flash_bwd_dkv": blocks,
         "flash_bwd_dq": blocks, "flash_fwd": 0}, profile_dir)
    del state
    return launches, rate, per_step, peak_memory(torch, "BST training")


def copy_state(torch, convert, models, state, device, dense_tx):
    """A copy of ``state`` on ``device`` with a fresh dense optimizer."""
    tables = {n: dataclasses.replace(t, **{
        f: getattr(t, f).to(device, copy=True) for f in convert.TABLE_FIELDS})
        for n, t in state.tables.items()}
    dense = copy.deepcopy(state.dense).to(device)
    return models.TrainState(tables=tables, dense=dense,
                             opt_state=dense_tx(dense.parameters()),
                             step=state.step.to(device, copy=True))


def check_setup(np, models, train, name, seed):
    """Model, sparse optimizer, dense factory, sparse lr and a batch maker
    for the training checks: the reference widths with every table cut to
    2^14 rows, ids drawn from a few thousand per table (duplicates within
    and across steps; every table starts empty, so step 1 inserts; BST's
    batches add 5 % unknown ids, as its requests do)."""
    rng = np.random.RandomState(seed)
    if name == "DCN":
        model = models.DCN(capacity=CHECK_ROWS)
        universe = {n: rng.randint(0, 1 << 40, 4000, dtype=np.int64)
                    for n in model.table_specs}

        def batch(b):
            return dcn_batch(np, rng, universe,
                             {n: np.arange(4000) for n in universe}, b,
                             unseen=0.0)
        return model, train.GroupAdamOptimizer(), 1e-3, 1e-3, batch
    model = models.BST(**dict(BST_CONFIG, capacity=CHECK_ROWS))
    universe = {"item": rng.randint(1, 1 << 40, 4000, dtype=np.int64),
                "user": rng.randint(1, 1 << 40, 3000, dtype=np.int64)}

    def batch(b):
        return sequence_batch(np, models, rng, universe,
                              {n: np.arange(len(u))
                               for n, u in universe.items()}, b)
    return model, train.AdamOptimizer(), 0.01, 0.01, batch


def run_steps(models, model, opt, lr, state, batches):
    """Train on ``batches``: ``(state, losses, the dense gradients of the
    first step)``."""
    step = models.make_train_step(model, opt, sparse_lr=lr)
    losses, first = [], None
    for b in batches:
        state, loss, _ = step(state, b)
        losses.append(float(loss))
        if first is None:
            first = [p.grad.detach().cpu().clone()
                     for p in state.dense.parameters()]
    return state, losses, first


def state_arrays(torch, state):
    return ({n: (t.header.cpu(), t.payload.cpu())
             for n, t in state.tables.items()},
            {k: v.detach().cpu() for k, v in state.dense.state_dict().items()})


def training_checks_phase(torch, np, kv, models, train, convert):
    """(1) card against CPU, (2) determinism, (3) the loss falls; each at the
    reference widths with tables of 2^14 rows."""
    out = {}
    for i, name in enumerate(("DCN", "BST")):
        model, opt, lr, dense_lr, batch = check_setup(np, models, train, name,
                                                      SEED + 10 + i)
        tx = functools.partial(torch.optim.Adam, lr=dense_lr)
        init = models.init_state(model, opt, tx, seed=SEED + 10 + i,
                                 device="cpu")
        # (1) batch-256 steps on the CPU and on the card
        batches = [batch(CHECK_BATCH) for _ in range(CHECK_STEPS)]
        states, losses, grads = {}, {}, {}
        for dev in ("cpu", DEV):
            states[dev], losses[dev], grads[dev] = run_steps(
                models, model, opt, lr,
                copy_state(torch, convert, models, init, dev, tx), batches)
        (tc, pc), (tg, pg) = (state_arrays(torch, states[d])
                              for d in ("cpu", DEV))
        slots_equal = all(
            torch.equal(kv.find(states["cpu"].tables[n], kv.encode_ids(
                np.concatenate([b["ids"][n] for b in batches]),
                device="cpu")).slot,
                kv.find(states[DEV].tables[n], kv.encode_ids(
                    np.concatenate([b["ids"][n] for b in batches]),
                    device=DEV)).slot.cpu())
            for n in tc)
        atol, rtol = TRAIN_TOL["atol"], TRAIN_TOL["rtol"]

        def diff(got, want, step_lr):
            """Share of elements past the tight limit, and the largest
            difference in learning rates."""
            over = total = 0
            worst = 0.0
            for g, w in zip(got, want):
                g, w = g.double(), w.double()
                d = (g - w).abs()
                over += int((d > atol + rtol * w.abs()).sum())
                total += w.numel()
                worst = max(worst, float(d.max()) / step_lr)
            return {"share_past_tight": over / total, "elements": total,
                    "max_abs_err_in_lr": worst}

        c = {"headers_bit_identical": all(torch.equal(tc[n][0], tg[n][0])
                                          for n in tc),
             "slots_bit_identical": slots_equal,
             "loss_cpu": losses["cpu"], "loss_card": losses[DEV],
             "loss_max_abs_err": max(abs(a - b) for a, b in
                                     zip(losses["cpu"], losses[DEV])),
             # step 1's dense gradients, each tensor against its own scale
             "grad_err_ratio": max(
                 float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                 for g, w in zip(grads[DEV], grads["cpu"]))
             / TRAIN_TOL["grad"],
             # the rows the steps placed (equal headers: equal rows)
             "payload": diff(*([t[n][1][kv.occupied_mask(
                 states["cpu"].tables[n])] for n in tc] for t in (tg, tc)),
                 lr),
             "dense": diff([pg[k] for k in pc], [pc[k] for k in pc],
                           dense_lr)}
        del states, tc, pc, tg, pg
        # (2) two runs of batch-2048 steps on the card from clones of one
        # state
        batches = [batch(BATCH) for _ in range(CHECK_STEPS)]
        runs = [state_arrays(torch, run_steps(
            models, model, opt, lr,
            copy_state(torch, convert, models, init, DEV, tx), batches)[0])
            for _ in range(2)]
        c["rerun_bit_identical"] = (
            all(torch.equal(x, y) for n in runs[0][0]
                for x, y in zip(runs[0][0][n], runs[1][0][n]))
            and all(torch.equal(runs[0][1][k], runs[1][1][k])
                    for k in runs[0][1]))
        del runs
        # (3) ten steps on one batch-2048 batch
        _, falling, _ = run_steps(models, model, opt, lr,
                               copy_state(torch, convert, models, init, DEV,
                                          tx), [batches[0]] * 10)
        c["loss_on_one_batch"] = [falling[0], falling[-1]]
        print(f"{name} training checks:", json.dumps(c), flush=True)
        check(c["headers_bit_identical"] and c["slots_bit_identical"]
              and c["loss_max_abs_err"] <= TRAIN_TOL["loss"] * max(
                  1.0, max(abs(x) for x in losses["cpu"]))
              and c["grad_err_ratio"] <= 1
              and all(c[k]["share_past_tight"] <= TRAIN_TOL["share"]
                      and c[k]["max_abs_err_in_lr"] <= CHECK_STEPS
                      for k in ("payload", "dense")),
              f"{name}: training on the card differs from the CPU: {c}")
        check(c["rerun_bit_identical"],
              f"{name}: two runs of the same steps differ on the card")
        check(falling[-1] < falling[0],
              f"{name}: ten steps on one batch did not lower the loss")
        out[name] = c
    peak_memory(torch, "training checks")
    return out


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


# ---------------------------------------------------------------------------
# compactor, growth, checkpoints and resume
# ---------------------------------------------------------------------------

def compactor_case(torch, compactor, name, gen, m, w, r, live, dtype,
                   out_rows=None, arena=None):
    """Hold the compactor kernel bit for bit against its plain version on
    one arena, and a rerun against the first run. Returns the case's
    record and the arena."""
    if arena is None:
        arena = torch.randn(m, w, device=DEV, generator=gen).to(dtype)
    got = compactor.compact(arena, live, block_rows=r, out_rows=out_rows)
    again = compactor.compact(arena, live, block_rows=r, out_rows=out_rows)
    want = compactor.compact_plain(arena, live, out_rows=out_rows)
    n = min(int(live.sum()), out_rows or m)
    check(torch.equal(got[0][:n], want[0][:n])
          and torch.equal(got[1], want[1]),
          f"compact {name} differs from its plain version")
    check(torch.equal(got[0][:n], again[0][:n])
          and torch.equal(got[1], again[1]),
          f"compact {name}: a rerun differs")
    err = (got[0][:n] - want[0][:n]).abs().max().item() if n else 0.0
    return {"m": m, "w": w, "block_rows": r, "live": n,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err}


def compactor_phase(torch, ops, compactor):
    """The compactor's own entry point (no engine path calls it) at the
    study shape of ``scripts/prof_compactor.py`` (M = 1,572,864 rows x
    W = 256 f32, 2/3 live, R = 128), then the cases of
    ``tests/test_compactor.py`` at the card's scale: live shares 0, 0.3,
    2/3, 0.97 and 1, clustered dead runs with whole empty blocks, a single
    block, ``out_rows > M`` and a bf16 arena. The bound counts the live rows
    read and written once, the mask read and ``new_loc`` written."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 20)
    m, w, r = COMPACT_M, COMPACT_W, COMPACT_R
    arena = torch.randn(m, w, device=DEV, generator=gen)
    live = torch.rand(m, device=DEV, generator=gen) < 2 / 3
    torch.cuda.synchronize()
    reset_launches()
    ops.compact(arena, live, block_rows=r)          # the path: one call
    torch.cuda.synchronize()
    launches = read_launches()
    cases = {"study": compactor_case(torch, compactor, "study", gen, m, w, r,
                                     live, torch.float32, arena=arena)}
    n = cases["study"]["live"]
    timing = {
        "ms": time_ms(torch, lambda: compactor.compact(arena, live,
                                                       block_rows=r)),
        "plain_ms": time_ms(torch, lambda: compactor.compact_plain(arena,
                                                                   live)),
        "library_ms": time_ms(torch, lambda: arena[live]),
        "bound_ms": bound_ms(2 * n * w * 4 + m + m * 4)}
    del arena, live
    torch.cuda.empty_cache()
    sm, sw = 1 << 18, 256
    for frac in (0.0, 0.3, 2 / 3, 0.97, 1.0):
        live = torch.rand(sm, device=DEV, generator=gen) < frac
        cases[f"live_{frac:.3f}"] = compactor_case(
            torch, compactor, f"live {frac:.3f}", gen, sm, sw, 128, live,
            torch.float32)
    live = torch.zeros(sm, dtype=torch.bool, device=DEV)
    live[:64 * 128] = True                          # solid live run
    live[200 * 128:200 * 128 + 8] = True            # a tiny island
    live[300 * 128:] = True                         # tail run
    cases["clustered"] = compactor_case(torch, compactor, "clustered", gen,
                                        sm, sw, 128, live, torch.float32)
    live = torch.rand(128, device=DEV, generator=gen) < 0.5
    cases["single_block"] = compactor_case(torch, compactor, "single block",
                                           gen, 128, sw, 128, live,
                                           torch.float32)
    live = torch.rand(1 << 16, device=DEV, generator=gen) < 0.5
    cases["out_rows_gt_m"] = compactor_case(
        torch, compactor, "out_rows > M", gen, 1 << 16, sw, 128, live,
        torch.float32, out_rows=(1 << 16) + 4096)
    live = torch.rand(sm, device=DEV, generator=gen) < 0.6
    cases["bf16"] = compactor_case(torch, compactor, "bf16", gen, sm, sw,
                                   128, live, torch.bfloat16)
    print(f"compactor: study shape M={m} W={w} R={r}, {n} live rows: "
          f"{json.dumps(timing)}; cases {json.dumps(cases)}; launches "
          f"{json.dumps(launches)}", flush=True)
    check(launches["compact"] == 1, f"compact entry point: {launches}")
    return launches, cases, timing, peak_memory(torch, "compactor")


def payload_bytes(tbundle, prefix):
    """Bytes of the values and slot columns in one bundle."""
    index = tbundle.BundleReader(prefix)._index
    return sum(e.get("nbytes", 0) for k, e in index.items()
               if k.endswith("-values") or "-slot-" in k)


def table_by_key(np, kv, rowops, t, day):
    """A table's rows by key: sorted keys, the full payload rows (values and
    slot columns), the reference meta words and the blacklist."""
    ex = kv.export_arrays(t, as_of_unix_day=day)
    order = np.argsort(ex["keys"])
    keys = ex["keys"][order]
    fr = kv.find(t, kv.encode_ids(keys, device=DEV))
    check(bool(fr.found.all()), "table_by_key: an exported key not found")
    return (keys, rowops.gather_rows(t.payload, fr.slot),
            ex["meta"][order], np.sort(ex["blacklist"]))


def fresh_batch(np, rng, model, batch):
    """A batch of fresh ids (drawn from 2^40) for every table."""
    return {"ids": {n: rng.randint(1, 1 << 40, batch, dtype=np.int64)
                    for n in model.table_specs},
            "features": rng.randn(batch, 13).astype(np.float32),
            "labels": rng.randint(0, 2, batch).astype(np.float32)}


def growth_checkpoint_phase(torch, np, kv, models, train, checkpoint,
                            tbundle, rowops, profile_dir):
    """The port's twin of examples/checkpoint_resume.py on the reference
    DCN: every table starts at 2^14 rows (a cut; the training phase's are
    2^20) and each step brings 2,048 fresh ids per table, so
    ``grow_if_needed`` doubles every table twice within 12 steps; a full
    checkpoint at step 6 and deltas at 9 and 12 through
    ``CheckpointManager`` with the dense tower; a second manager restores
    into fresh 2^14-row templates (which must grow); every table equals the
    live one per key, bit for bit, and the dense tower too; one more step
    from each state on one batch gives the same loss."""
    import tempfile
    model = models.DCN(capacity=GROW_START_ROWS)
    opt = train.GroupAdamOptimizer()
    tx = functools.partial(torch.optim.Adam, lr=1e-3)
    rng = np.random.RandomState(SEED + 30)
    batches = [fresh_batch(np, rng, model, BATCH)
               for _ in range(GROW_STEPS + 1)]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = {"grows": 0, "saves": {}}
    try:
        state = models.init_state(model, opt, tx, seed=SEED, device=DEV)
        step = models.make_train_step(model, opt, sparse_lr=1e-3)
        mgr = checkpoint.CheckpointManager(os.path.join(workdir, "ckpts"))
        torch.cuda.synchronize()
        reset_launches()
        train_s, save_bytes = 0.0, 0
        for i in range(1, GROW_STEPS + 1):
            t0 = time.perf_counter()
            caps = {n: t.capacity for n, t in state.tables.items()}
            state = models.grow_if_needed(state, BATCH)
            out["grows"] += sum(state.tables[n].capacity != c
                                for n, c in caps.items())
            state, loss, _ = step(state, batches[i - 1])
            torch.cuda.synchronize()
            train_s += time.perf_counter() - t0
            if i in GROW_SAVES:
                full = i == GROW_SAVES[0]
                t0 = time.perf_counter()
                tables = mgr.save(state.tables, state.dense, step=i,
                                  full=full)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                state = state._replace(tables=tables)
                kind = "full" if full else "delta"
                nbytes = payload_bytes(tbundle, os.path.join(
                    workdir, "ckpts", f"ckpt-{kind}-{i}"))
                save_bytes += nbytes
                out["saves"][f"{kind}@{i}"] = {
                    "s": dt, "payload_bytes": nbytes,
                    "gb_per_s": nbytes / dt / 1e9}
        caps = {n: t.capacity for n, t in state.tables.items()}
        # "crash": a second manager restores into fresh 2^14-row templates
        dense = model.init_dense(torch.Generator().manual_seed(SEED + 31),
                                 DEV)
        templates = model.init_tables(opt, seed=SEED + 32, device=DEV)
        t0 = time.perf_counter()
        restored, dense, at = checkpoint.CheckpointManager(
            os.path.join(workdir, "ckpts")).restore(templates, dense)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    out.update({
        "examples_per_s": GROW_STEPS * BATCH / train_s, "train_s": train_s,
        "restore_s": restore_s, "restore_gb_per_s": save_bytes / restore_s / 1e9,
        "capacity_min": min(caps.values()), "capacity_max": max(caps.values()),
        "restored_capacity_min": min(t.capacity for t in restored.values())})
    check(at == GROW_STEPS, f"restored step {at}")
    check(all(c >= GROW_START_ROWS * 4 for c in caps.values()),
          f"every table should have doubled at least twice: {caps}")
    check(all(t.capacity > GROW_START_ROWS for t in restored.values()),
          "the restore did not grow its templates")
    day = 20000
    for n in sorted(state.tables):
        a = table_by_key(np, kv, rowops, state.tables[n], day)
        b = table_by_key(np, kv, rowops, restored[n], day)
        check(np.array_equal(a[0], b[0]) and torch.equal(a[1], b[1])
              and np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3]),
              f"restored table {n} differs from the live one")
    live_dense = state.dense.state_dict()
    check(all(torch.equal(v, live_dense[k])
              for k, v in dense.state_dict().items()),
          "restored dense tower differs")
    # one more step from both states on one batch: the loss comes before
    # any update, so the two must be equal
    resumed = models.TrainState(tables=restored, dense=dense,
                                opt_state=tx(dense.parameters()),
                                step=state.step.clone())
    reset_launches()
    state, loss_live, _ = step(models.grow_if_needed(state, BATCH),
                               batches[-1])
    resumed, loss_resumed, _ = step(models.grow_if_needed(resumed, BATCH),
                                    batches[-1])
    torch.cuda.synchronize()
    more = read_launches()
    launches = {k: launches[k] + more[k] for k in launches}
    out["loss_live"], out["loss_resumed"] = float(loss_live), float(
        loss_resumed)
    check(torch.equal(loss_live, loss_resumed),
          f"resumed loss {out['loss_resumed']} != live {out['loss_live']}")
    check(launches["gather_rows"] > 0 and launches["scatter_rows"] > 0,
          f"growth path: the row kernels were not launched: {launches}")
    out["launches"] = launches
    print(f"growth/checkpoint/resume: {json.dumps(out)}", flush=True)
    if profile_dir:
        profile_calls(torch, "dcn_growth_train",
                      [lambda b=b: step(state, b) for b in batches[:3]],
                      train_s / GROW_STEPS, profile_dir)
    del state, resumed, restored, templates
    out["peak_gib"] = peak_memory(torch, "growth/checkpoint/resume")
    return launches, out


def repartition_phase(torch, np, kv, train, checkpoint):
    """examples/checkpoint_resume.py's own configuration on the card: 4
    shards of dim 16 at 2^12 rows, GroupAdam lr 0.05, 30 steps of 256 ids
    drawn from 5,000, a full checkpoint at 20 and deltas at 25 and 30,
    restored into 6 shards (a 64-id sample must match bit for bit), then 5
    more steps."""
    import shutil
    import tempfile
    rng = np.random.RandomState(0)
    opt = train.GroupAdamOptimizer(learning_rate=0.05)

    def train_steps(shards, start, n_steps):
        ns = len(shards)
        for s in range(start, start + n_steps):
            ids = rng.randint(0, 5000, 256)
            for i in range(ns):
                sel = np.unique(ids[ids % ns == i])
                res = kv.lookup_or_insert(shards[i],
                                          kv.encode_ids(sel, device=DEV))
                shards[i] = opt.apply(res.table, res.slot,
                                      res.rows * 0.1 + 0.01, lr=0.05, step=s,
                                      payload_rows=res.payload_rows,
                                      meta_rows=res.meta_rows)
        return shards

    def lookup_all(shards, ids):
        out = torch.zeros(len(ids), 16)
        for i in range(len(shards)):
            sel = ids % len(shards) == i
            if sel.any():
                out[torch.from_numpy(sel)] = kv.lookup_or_zeros(
                    shards[i], kv.encode_ids(ids[sel], device=DEV)).cpu()
        return out

    workdir = tempfile.mkdtemp(prefix="chip_smoke_repart_")
    try:
        reset_launches()
        mgr = checkpoint.CheckpointManager(os.path.join(workdir, "ckpts"))
        shards = [opt.init(kv.create(16, 1 << 12, seed=i,
                                     name=f"emb/part_{i}", device=DEV))
                  for i in range(4)]
        shards = train_steps(shards, 1, 20)
        shards = mgr.save({"emb": shards}, step=20, full=True)["emb"]
        shards = train_steps(shards, 21, 5)
        shards = mgr.save({"emb": shards}, step=25, full=False)["emb"]
        shards = train_steps(shards, 26, 5)
        mgr.save({"emb": shards}, step=30, full=False)
        sample = rng.randint(0, 5000, 64).astype(np.int64)
        templates = [opt.init(kv.create(16, 1 << 12, seed=99 + i,
                                        name=f"emb/part_{i}", device=DEV))
                     for i in range(6)]
        restored, _, at = checkpoint.CheckpointManager(
            os.path.join(workdir, "ckpts")).restore({"emb": templates})
        launches = read_launches()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    want = lookup_all(shards, sample)
    new = restored["emb"]
    got = lookup_all(new, sample)
    rows = sum(int(kv.size(s)) for s in shards)
    check(at == 30 and torch.equal(got, want),
          "4 -> 6 repartition: the 64-id sample differs")
    check(sum(int(kv.size(s)) for s in new) == rows,
          "4 -> 6 repartition lost rows")
    reset_launches()
    new = train_steps(new, at + 1, 5)
    torch.cuda.synchronize()
    more = read_launches()
    launches = {k: launches[k] + more[k] for k in launches}
    after = sum(int(kv.size(s)) for s in new)
    check(after >= rows and all(bool(torch.isfinite(s.payload).all())
                                for s in new),
          "training on 6 shards after the restore failed")
    out = {"rows_before": rows, "rows_after_5_steps": after,
           "launches": launches}
    print(f"repartition 4 -> 6: {json.dumps(out)}", flush=True)
    return launches, out


def reference_growth_phase(torch, np, kv, train, packing, rowops):
    """One dim-128 GroupAdam table (payload 4·128 f32) at 2^20 rows holding
    2^19 keys, with random values, slot columns and meta words written by
    ``insert_raw``: ``grow`` to 2^21, then ``compact`` after deleting a
    third of the keys. Each is timed once and checked to keep every row
    (size, and each key's full payload row and meta word). Bound: the live
    rows read and written once, the new table's other rows zeroed, the old
    header read and the new one written (16 B per slot), over 3.35 TB/s."""
    opt = train.GroupAdamOptimizer()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 40)
    rng = np.random.RandomState(SEED + 40)
    keys = rng.permutation(np.unique(rng.randint(
        0, 1 << 40, FILL + FILL // 8, dtype=np.int64)))[:FILL]
    t = opt.init(kv.create(128, C_ROWS, seed=SEED, device=DEV))
    w = t.payload.shape[1]
    q = kv.encode_ids(keys, device=DEV)
    meta = packing.pack(torch.randint(1, 1000, (FILL,), device=DEV,
                                      generator=gen), 7)
    kv.insert_raw(t, q, torch.randn(FILL, w, device=DEV, generator=gen),
                  meta)
    n0 = int(kv.size(t))
    check(n0 > 0.999 * FILL, "reference growth: the fill placed too few")

    def rows_of(table, qq):
        fr = kv.find(table, qq)
        check(bool(fr.found.all()), "a key was lost")
        return (rowops.gather_rows(table.payload, fr.slot),
                table.meta[fr.slot.long()])

    placed = kv.find(t, q).found
    qk = q[placed]
    want = rows_of(t, qk)
    row_bytes = w * 4

    def bound(n, c_old, c_new):
        return bound_ms(2 * n * row_bytes + (c_new - n) * row_bytes
                        + 16 * (c_old + c_new))

    out = {"rows": n0, "row_bytes": row_bytes}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    g = kv.grow(t, 2 * C_ROWS)
    torch.cuda.synchronize()
    out["grow_ms"] = (time.perf_counter() - t0) * 1e3
    out["grow_launches"] = read_launches()
    out["grow_bound_ms"] = bound(n0, C_ROWS, 2 * C_ROWS)
    del t
    got = rows_of(g, qk)
    check(g.capacity == 2 * C_ROWS and int(kv.size(g)) == n0
          and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "grow to 2^21 lost or changed a row")
    gone = qk[:n0 // 3]
    kv.delete(g, gone)
    keep = qk[n0 // 3:]
    want = (want[0][n0 // 3:], want[1][n0 // 3:])
    n1 = int(kv.size(g))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    c = kv.compact(g)
    torch.cuda.synchronize()
    out["compact_ms"] = (time.perf_counter() - t0) * 1e3
    out["compact_launches"] = read_launches()
    out["compact_bound_ms"] = bound(n1, 2 * C_ROWS, 2 * C_ROWS)
    got = rows_of(c, keep)
    check(c.capacity == 2 * C_ROWS and int(kv.size(c)) == n1 == n0 - n0 // 3
          and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
          and not bool(kv.hashing.is_tombstone(c.keys).any()),
          "compact lost or changed a row")
    out["compact_rows"] = n1
    print(f"reference-size growth: {json.dumps(out)}", flush=True)
    launches = {k: out["grow_launches"][k] + out["compact_launches"][k]
                for k in out["grow_launches"]}
    check(launches["scatter_rows"] >= 2,
          f"grow/compact did not move rows through the kernel: {launches}")
    del g, c, got, want
    out["peak_gib"] = peak_memory(torch, "reference-size growth")
    return launches, out


def kernel_entry(name, src, replaces, launches, errs, case, key):
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs),
            "ms": case[f"{key}_ms"], "plain_ms": case[f"{key}_plain_ms"],
            "bound_ms": case[f"{key}_bound_ms"], "bound_by": "bytes",
            "library_ms": case[f"{key}_library_ms"]}


def attention_entry(name, replaces, launches, cases, main_case):
    c = cases[main_case]
    return {"name": name, "route": "cuda",
            "source": "tfplus_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in cases.values()
                               if x["kernel"] == name),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]}


def backward_entry(name, replaces, launches, cases, main_case):
    c = cases[main_case][name]
    return {"name": name, "route": "cuda",
            "source": "tfplus_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(x[name]["max_abs_err"] for x in cases.values()),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": cases[main_case]["library_ms"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="write torch.profiler tables of the serving and "
                    "training paths here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA "
              "card", file=sys.stderr)
        return 1
    try:
        import numpy as np
        from tfplus_tpu_torch import (checkpoint, convert, embedding, kv,
                                      models, ops, train)
        from tfplus_tpu_torch.checkpoint import bundle as tbundle
        from tfplus_tpu_torch.kv import hashing
        from tfplus_tpu_torch.ops import _build, compactor, rowops
        from tfplus_tpu_torch.ops import flash_attention as fa
        from tfplus_tpu_torch.utils import packing
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
    attn_cases, bench = attention_phase(torch, np, fa)
    bwd_cases, bench_grads = attention_backward_phase(torch, np, fa, bench)
    peak_memory(torch, "attention kernels")
    emb_launches, emb_rate = embedding_serving_phase(
        torch, np, kv, hashing, rowops, args.profile)
    peak_memory(torch, "embedding serving")
    dcn_launches, dcn_rate, per_request = dcn_serving_phase(
        torch, np, kv, embedding, models, rowops, args.profile)
    peak_memory(torch, "DCN serving")
    flash_launches = flash_path_phase(torch, fa, bench)
    grad_launches, grad_tflops = flash_grad_path_phase(torch, fa, bench,
                                                       bench_grads)
    del bench, bench_grads
    peak_memory(torch, "flash entry points")
    seq = sequence_serving_phase(torch, np, kv, embedding, models,
                                 args.profile)
    peak_memory(torch, "BST/DIN serving")
    checks = training_checks_phase(torch, np, kv, models, train, convert)
    dcn_train = dcn_training_phase(torch, np, kv, models, train, args.profile)
    bst_train = bst_training_phase(torch, np, kv, models, train, args.profile)
    comp_launches, comp_cases, comp_time, comp_peak = compactor_phase(
        torch, ops, compactor)
    grow_launches, grow = growth_checkpoint_phase(
        torch, np, kv, models, train, checkpoint, tbundle, rowops,
        args.profile)
    rep_launches, rep = repartition_phase(torch, np, kv, train, checkpoint)
    ref_launches, ref = reference_growth_phase(torch, np, kv, train, packing,
                                               rowops)

    errs = {k: [c[f"{k}_err"] for c in cases.values()]
            for k in ("gather", "scatter_set", "scatter_add")}
    check(max(max(v) for v in errs.values()) == 0.0,
          "a kernel differs from its plain version")
    paths = [emb_launches, dcn_launches, flash_launches,
             seq["fill_launches"], seq["BST"][0], seq["DIN"][0],
             grad_launches, dcn_train[0], bst_train[0], comp_launches,
             grow_launches, rep_launches, ref_launches]
    launches = {k: sum(p[k] for p in paths) for k in paths[0]}
    src = "tfplus_tpu_torch/ops/csrc/rowops.cu"
    main_case = cases[f"float32_w128_n{N_IDS}"]     # the serving-leg shape
    kernels = [
        kernel_entry("gather_rows", src, "tfplus_tpu/ops/rowops.py:76",
                     launches["gather_rows"], errs["gather"], main_case,
                     "gather"),
        kernel_entry("scatter_rows", src, "tfplus_tpu/ops/rowops.py:122",
                     launches["scatter_rows"],
                     errs["scatter_set"] + errs["scatter_add"], main_case,
                     "scatter"),
        attention_entry("flash_fwd", "tfplus_tpu/ops/flash_attention.py:328",
                        launches["flash_fwd"], attn_cases,
                        "bench_causal_bf16"),
        attention_entry("flash_fwd_single",
                        "tfplus_tpu/ops/flash_attention.py:267",
                        launches["flash_fwd_single"], attn_cases, "bst_f32"),
        backward_entry("flash_bwd_dkv",
                       "tfplus_tpu/ops/flash_attention.py:589",
                       launches["flash_bwd_dkv"], bwd_cases,
                       "a_bench_causal_bf16"),
        backward_entry("flash_bwd_dq",
                       "tfplus_tpu/ops/flash_attention.py:636",
                       launches["flash_bwd_dq"], bwd_cases,
                       "a_bench_causal_bf16"),
        {"name": "compact", "route": "cuda",
         "source": "tfplus_tpu_torch/ops/csrc/compactor.cu",
         "replaces": "tfplus_tpu/ops/compactor.py:141",
         "launches": launches["compact"],
         "max_abs_err": max(c["max_abs_err"] for c in comp_cases.values()),
         "ms": comp_time["ms"], "plain_ms": comp_time["plain_ms"],
         "bound_ms": comp_time["bound_ms"], "bound_by": "bytes",
         "library_ms": comp_time["library_ms"]},
    ]
    check(all(e["launches"] > 0 for e in kernels),
          f"a kernel was not launched on its path: {kernels}")
    print(json.dumps({"serving": {
        "embedding_ids_per_s": emb_rate, "embedding_launches": emb_launches,
        "dcn_examples_per_s": dcn_rate, "dcn_launches": dcn_launches,
        "dcn_gathers_per_request": per_request,
        "flash_entry_point_launches": flash_launches,
        "bst_examples_per_s": seq["BST"][1],
        "bst_launches_per_request": seq["BST"][2],
        "din_examples_per_s": seq["DIN"][1],
        "din_launches_per_request": seq["DIN"][2]}}))
    print(json.dumps({"training": {
        "flash_grad_tflops": grad_tflops,
        "flash_grad_launches": grad_launches,
        "dcn_examples_per_s": dcn_train[1],
        "dcn_launches_per_step": dcn_train[2],
        "dcn_peak_gib": dcn_train[3],
        "bst_examples_per_s": bst_train[1],
        "bst_launches_per_step": bst_train[2],
        "bst_peak_gib": bst_train[3],
        "checks": checks}}))
    print(json.dumps({"growth": {
        "compactor": dict(comp_time, peak_gib=comp_peak),
        "growth_checkpoint_resume": grow, "repartition_4_to_6": rep,
        "reference_size_growth": ref}}))
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
