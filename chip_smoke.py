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
   ``tfplus_tpu_torch/ops/csrc`` and the build time printed, with ptxas's
   registers, shared memory and spills of the tensor-core flash kernels and
   the single-pass forward and backward.
2. Kernels: every row kernel is held bit-exact against its plain PyTorch
   version at the shapes the serving paths give it (f32 and bf16, widths
   64/128/384, and f32 widths 1 and 3, the 4- and 12-byte rows of DeepFM's
   and Wide&Deep's linear tables; 32,768 indices with negative, duplicated
   and edge values; the DCN's 2,048-row gathers and 2^19-row fill
   scatters) and at the payload widths the training paths give it at
   2,048 rows (f32 widths 3, 16, 48, 96, 192, 256 and 512: dim-1, DLRM's
   and NCF's tables with Adam's slots, BST's 3·64 and DCN's GroupAdam
   4·D), rerun bit for bit, and timed beside it, beside the earlier kernels on
   the same inputs (``earlier_ms``, ``csrc/rowops_earlier.cu``) and beside
   one PyTorch call that computes the same function; each case prints the
   launch plan (``rowops.plan``) that gather, set and add took.
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
   non-causal with segments from lengths (tiled kernel, tensor-core route);
   BST's f32 heads, B2048 H8 S128 D8 with BST's request mask, without and
   with dropout (single-pass kernel); dropout 0.2 at S1000 D64, causal and
   not, f32 (CUDA-core route) and bf16 (tensor-core route); then the
   single-pass kernel off BST: f32 B16 H8 D32 at Sq 1000 against Skv 128
   with q and kv segments that differ, bf16 B64 H8 S200 D16 with two
   segments, and without segments bf16 B64 H8 S192 D64 and S64 D128 (which
   the dispatch sends to the tensor cores; forced here and timed beside
   them); ``flash_attention_with_lse``'s residuals and its -inf on padding
   rows. Each case records the route it took; at the bench shape the
   CUDA-core kernel is also timed on the same bf16 inputs, and on the
   single-pass cases the earlier single-pass kernel of flash_fwd.cu, as the
   earlier routes; the single-pass kernel is also rerun bit for bit.
6. Flash entry points: ``flash_attention(causal=True)`` and
   ``flash_attention_with_lse`` at the bench's shape, every forward launch
   on the tensor-core route.
7. BST and DIN serving at published widths: an item table of 2^23 rows
   filled with 2^22 keys and a user table of 2^22 rows filled with 2^21,
   dim 64, then batch-2048 requests (histories of 1-20 items, 2 % of users
   with none, 5 % unknown ids) through ``make_train_step(train=False)``, BST
   first and then DIN on the same tables, checked against the host-side map
   of what was inserted and a float64 numpy forward pass (BST with a TF32
   control it must reject).
8. Attention-backward kernels, through ``_bwd_dispatch`` as
   ``flash_attention``'s backward calls them: ``flash_bwd_single`` (not
   causal, the KV fits one block, a dtype and D on the CUDA cores) or
   ``flash_bwd_dkv`` and ``flash_bwd_dq``, held against the plain dk/dv and
   dq versions and against float64 autograd through
   ``reference_attention``, rerun bit for bit, and timed beside the plain
   versions, the least time the card could take and the backward alone of
   ``scaled_dot_product_attention`` (timed only): the bench's causal bf16
   B4 H8 S2048 D128; BST's f32 heads with BST's request mask, without and
   with dropout 0.2 (single-pass); dropout 0.2 at S1000 D64, causal and
   not, f32 and bf16; non-causal bf16 S2048 D128 with segments from
   lengths in 512-2048; bf16 D16 S200 with two segments and padding, and
   f32 D32 at Sq 1000 against Skv 128 with q and kv segments that differ
   (single-pass). dk/dv and dq take the tensor-core route on the bf16 D128
   cases and the CUDA-core one on the f32 ones; at the bench shape the
   CUDA-core dk/dv and dq kernels are also timed on the same inputs, and on
   the single-pass cases too (the earlier route). Then head dims the
   kernels take only padded (12, 60) or in 128-column chunks (136, 256):
   B1 H2 S200, causal with segments and non-causal, f32 and bf16, each
   forward (the route ``flash_attention`` takes) and the backward that
   ``_bwd_dispatch`` takes (single-pass at D 12 non-causal) held against
   the plain versions at the caller's D, with the routes recorded.
9. ``flash_attention(causal=True)`` forward and backward x10 at the bench's
   shape, in TFLOP/s counted as the JAX bench's ``grad=True`` leg, every
   forward, dk/dv and dq launch on the tensor-core route.
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
   dense Adam 0.01); every step launches the single-pass forward and the
   single-pass backward, and neither dk/dv nor dq.
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
17. The serving API on DLRM at its Criteo Kaggle widths
   (facebookresearch/dlrm ``bench/dlrm_s_criteo_kaggle.sh``: 26 tables of
   dim 16, bottom MLP 13-512-256-64-16, top 512-256-1; cut to 2^20 rows
   per table holding 2^18 keys): batch-2048 requests (5 % unknown ids)
   against a float64 forward; ``export_for_serving``; ``load_for_serving``
   with no templates (predictions bit for bit) and as int8 tables (lookups
   bit for bit against the CPU on the same int8 table, within max|row|/254
   of the f32 rows); three Adam steps of the live tables and a delta save;
   ``refresh_from_delta`` of both (f32 rows per key bit for bit with the
   trainer's and no slot columns; int8 within the bound). Seconds and
   GB/s of export, loads and refresh, and peak memory.
18. The int8 lookup at the bench's serving-leg shape (a 2^20-row dim-128
   table filled with 32,768 ids): ``quantize_table`` bit for bit against
   the CPU, ``quant.lookup_or_zeros`` of the ids and their reversal in
   ids/s beside ``kv.lookup_or_zeros``, in turns. Then on that table each
   of the 7 ``scatter`` ops over 32,768 ids half present, ``get_count``,
   ``get_timestamp`` and a TTL eviction of a known share, against the same
   calls on a CPU copy bit for bit; and ``safe_embedding_lookup_sparse``
   over 2,048 rows of 1-20 ids (each combiner, weighted and not, negative
   and unknown ids, a default id), rerun bit for bit and within 1e-6 of
   the CPU's scale.
19. DeepFM and Wide&Deep (26 fields of dim 16 and 26 dim-1 tables, DNN
   256-128) and NCF (dim 32, 256-64), the examples' widths, on 2^14-row
   tables: three Adam steps on the card against the CPU as in phase 10,
   then batch-2048 serving against a float64 forward.

Each path (the serving and training paths, the flash entry points, the
compactor entry point, the growth, checkpoint and repartition paths, and
the serving-API, int8, table-op and CTR-model paths) runs
with the kernels' launch counts set to 0 just before it and read just after
it. Each phase frees its tables before the next and prints the peak device
memory it reached. The line before the last is the ``{"kernels": [...]}``
JSON, after the ``{"serving": ...}``, ``{"training": ...}``,
``{"growth": ...}`` and ``{"serving_api": ...}`` lines; the last line is ``{"ok": true, "device":
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
# That bf16 limit holds where the kernel's f32 sums are the plain version's
# bit for bit (the CUDA-core kernels sum q·k by FMA in the same order as the
# f32 matmul). The tensor cores sum in another order, so s differs in its
# last bits and a p within that of a bf16 rounding tie may round the other
# way, moving an output by one bf16 ulp of p·|v|/l: on the tensor-core route
# the output's limit adds, per element, that move for every p of the plain
# version within TIE_ULPS of a tie (tie_allowance); l and m keep the f32
# limits, and the strict ratio is reported beside.
TIE_ULPS = 128                   # of the 2^16 f32 ulps between bf16 values
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


# facebookresearch/dlrm bench/dlrm_s_criteo_kaggle.sh: sparse feature size
# 16, bottom MLP 13-512-256-64-16, top MLP 512-256-1 over 26 tables; cut to
# 2^20 rows per table holding 2^18 keys (Kaggle's largest vocabularies reach
# ~10M)
DLRM_CONFIG = dict(num_tables=26, embedding_dim=16, num_numeric=13,
                   bottom_hidden=(512, 256, 64, 16), top_hidden=(512, 256))
DLRM_ROWS, DLRM_FILL = 1 << 20, 1 << 18
CTR_ROWS = 1 << 14               # DeepFM, Wide&Deep and NCF tables
# the int8 bound max|row|/254 holds in exact arithmetic; the float32
# division by the scale, the product by it and the f32 rebuild before a
# refresh each round by half an ulp of values up to max|row|: 2^-12 of the
# bound covers them with room to spare
QUANT_SLACK = 2.0 ** -12


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
    return time_turns(torch, {"fn": fn}, reps)["fn"]


def time_turns(torch, fns, reps=25):
    """As ``time_ms`` for each of ``fns`` ({key: fn}), the functions taking
    turns within every repetition, each repetition starting one function
    further on, so that neither a drift of the card's clocks nor a place in
    the order favours any: {key: median ms}."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEV)
    events = {key: [] for key in fns}
    keys = list(fns)
    for rep in range(reps):
        for key in keys[rep % len(keys):] + keys[:rep % len(keys)]:
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[key]()
            b.record()
            events[key].append((a, b))
    torch.cuda.synchronize()
    return {key: statistics.median(a.elapsed_time(b) for a, b in ev)
            for key, ev in events.items()}


def bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_case(torch, rowops, dtype, width, n, gen):
    """Hold both kernels (scatter: set and add) against their plain versions
    at one shape and rerun them bit for bit; time kernel, the earlier kernel on
    the same inputs, plain version and the one-call library yardstick, and
    record the launch plan each took. Bounds count each index read once,
    each distinct source row read once and each output row written once."""
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

    row_bytes = width * esz
    out = {"plan": {
        kind: rowops.plan(row_bytes, n, align=rowops._align(values, rows),
                          dtype=dtype, kind=kind)
        for kind in ("gather", "set", "add")}}
    got = rowops.gather_rows(values, gidx)
    want = rowops.gather_rows_plain(values, gidx)
    check(torch.equal(got, want), f"gather_rows {dtype} W={width} differs")
    out["gather_err"] = (got.float() - want.float()).abs().max().item()
    rerun = [torch.equal(rowops.gather_rows(values, gidx), got)]
    for add in (False, True):
        v1, v2 = values.clone(), values.clone()
        rowops.scatter_rows(v1, sidx, rows, add=add)
        rowops.scatter_rows_plain(v2, sidx, rows, add=add)
        check(torch.equal(v1, v2),
              f"scatter_rows(add={add}) {dtype} W={width} differs")
        out[f"scatter_{'add' if add else 'set'}_err"] = \
            (v1.float() - v2.float()).abs().max().item()
        v2.copy_(values)
        rerun.append(torch.equal(rowops.scatter_rows(v2, sidx, rows,
                                                     add=add), v1))
        del v1, v2
    torch.cuda.synchronize()
    out["rerun_bit_identical"] = all(rerun)
    check(out["rerun_bit_identical"],
          f"row kernels {dtype} W={width} n={n}: a rerun differs {rerun}")

    clamped = gidx.long().clamp(0, C_ROWS - 1)
    keep = (sidx >= 0) & (sidx < C_ROWS)
    kept_idx, kept_rows = sidx[keep].long(), rows[keep]
    n_kept = int(keep.sum())
    n_rows_read = int(torch.unique(clamped).numel())
    # the kernel, the earlier kernel and the library call take turns
    times = time_turns(torch, {
        "gather": lambda: rowops.gather_rows(values, gidx),
        "gather_earlier": lambda: rowops._gather_rows_earlier(values, gidx),
        "gather_library": lambda: torch.index_select(
            values, 0, gidx.clamp(0, C_ROWS - 1))})
    out["gather_plain_ms"] = time_ms(
        torch, lambda: rowops.gather_rows_plain(values, gidx))
    out["gather_bound_ms"] = bound_ms(n * 4 + n_rows_read * row_bytes
                                      + n * row_bytes)
    target = values.clone()
    times.update(time_turns(torch, {
        "scatter": lambda: rowops.scatter_rows(target, sidx, rows),
        "scatter_earlier": lambda: rowops._scatter_rows_earlier(
            target, sidx, rows),
        "scatter_library": lambda: target.index_copy_(0, kept_idx,
                                                      kept_rows)}))
    out["scatter_plain_ms"] = time_ms(
        torch, lambda: rowops.scatter_rows_plain(target, sidx, rows))
    out["scatter_bound_ms"] = bound_ms(n * 4 + 2 * n_kept * row_bytes)
    times.update(time_turns(torch, {
        "scatter_add": lambda: rowops.scatter_rows(target, sidx, rows,
                                                   add=True),
        "scatter_add_earlier": lambda: rowops._scatter_rows_earlier(
            target, sidx, rows, add=True),
        "scatter_add_library": lambda: target.index_add_(0, kept_idx,
                                                         kept_rows)}))
    out["scatter_add_plain_ms"] = time_ms(
        torch, lambda: rowops.scatter_rows_plain(target, sidx, rows, add=True))
    out["scatter_add_bound_ms"] = bound_ms(n * 4 + 3 * n_kept * row_bytes)
    out.update({f"{key}_ms": ms for key, ms in times.items()})
    del values, target
    torch.cuda.empty_cache()
    return out


# the payload widths the training paths scatter and gather at 2,048 rows:
# DeepFM/W&D dim 1 + Adam (3), DLRM serving (16), DLRM/DeepFM dim 16 + Adam
# (48), NCF dim 32 + Adam (96), BST dim 64 + Adam (192), DCN GroupAdam 4·D
# (256, 512)
TRAIN_WIDTHS = (3, 16, 48, 96, 192, 256, 512)


def kernel_phase(torch, rowops):
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    shapes = [(dtype, width, N_IDS)
              for dtype in (torch.float32, torch.bfloat16)
              for width in (64, 128, 384)]
    # the dim-1 and dim-3 tables' 4- and 12-byte rows (DeepFM's and
    # Wide&Deep's linear weights)
    shapes += [(torch.float32, width, N_IDS) for width in (1, 3)]
    # the DCN request's gathers and the DCN fill's scatters
    shapes += [(torch.float32, width, n)
               for n in (BATCH, FILL) for width in (64, 128)]
    shapes += [(torch.float32, width, BATCH) for width in TRAIN_WIDTHS]
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
            "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_single": fa.flash_bwd_single,
            "compact": compactor.compact}


ROUTED = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")  # two routes each
ROUTES = ("tc", "cuda_core")


def reset_launches():
    for name, fn in _wrappers().items():
        fn.launches = 0
        if name in ROUTED:
            fn.tc_launches = fn.cuda_core_launches = 0


def read_launches():
    """Launches per wrapper, and per route (``flash_fwd.tc``, ...) for the
    wrappers that have two."""
    out = {}
    for name, fn in _wrappers().items():
        out[name] = fn.launches
        if name in ROUTED:
            for route in ROUTES:
                out[f"{name}.{route}"] = getattr(fn, f"{route}_launches")
    return out


def route_of(fn, call):
    """Run ``call`` and return the route ``fn`` (a routed wrapper) took."""
    before = [getattr(fn, f"{r}_launches") for r in ROUTES]
    out = call()
    taken = [r for r, b in zip(ROUTES, before)
             if getattr(fn, f"{r}_launches") > b]
    check(len(taken) == 1, f"{fn.__name__}: expected one routed launch")
    return taken[0], out


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


def tie_allowance(torch, fa, q, k, v, qs, ks, seed, causal, sm_scale,
                  p_dropout, single=False):
    """How far p's rounding ties may move each output, ``[B, H, Sq, D]``:
    the plain version's online softmax (``fwd_tiled_plain``) over the same
    64-key tiles (or, ``single``, ``fwd_single_plain``'s one pass over all
    keys), where each dropped, scaled p within ``TIE_ULPS`` f32 ulps of a
    bf16 tie may round one bf16 ulp either way, times |v|, rescaled and
    divided by l as the output is."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    step = skv if single else fa.BLOCK_K
    m = torch.full((b, h, sq, 1), -3.4028234663852886e38, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    allow = torch.zeros((b, h, sq, d), device=q.device)
    for c0 in range(0, skv, step):
        if causal and c0 > sq - 1:
            break
        c1 = min(c0 + step, skv)
        s = fa._scores(q, k[:, :, c0:c1], qs,
                       None if ks is None else ks[:, c0:c1], sm_scale, causal,
                       col0=c0)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        bits = fa._apply_dropout(p, seed, p_dropout, c0).view(torch.int32)
        tie = ((bits & 0xFFFF) - 0x8000).abs() < TIE_ULPS
        ulp = (bits & 0x7F800000).view(torch.float32) * 2.0 ** -7
        allow = allow * alpha + torch.matmul(torch.where(tie, ulp, 0.0),
                                             v[:, :, c0:c1].float().abs())
        m = m_next
    return allow / torch.where(l == 0.0, 1.0, l)


def bst_token_mask(np, rng, batch):
    """BST's request mask: histories of 1-20 items, 2 % of users with none."""
    lengths = rng.randint(1, HIST + 1, batch)
    lengths[rng.rand(batch) < 0.02] = 0
    return (np.arange(HIST)[None, :] < lengths[:, None]).astype(np.float32)


def takes_single(fa, skv, d, dtype, causal):
    """The dispatch's rule (``_fwd_dispatch``, ``_bwd_dispatch``), as the
    checks expect it: the single-pass kernels where not causal, the KV fits
    one block and the CUDA cores serve the dtype and D."""
    return (not causal and fa.single_fits(skv, d, dtype)
            and fa.flash_route(dtype, d) == "cuda_core")


def attention_case(torch, np, fa, name, gen, b, h, s, d, dtype, causal,
                   seg=None, p_dropout=0.0, single=None):
    """Hold the kernel against its plain version (out, l, m), check
    ``flash_attention_with_lse`` (the routed kernel's out, lse = m + log l,
    -inf on rows that hit no key), and time kernel, plain version and SDPA.
    ``s`` is S or ``(Sq, Skv)``; ``seg`` one id array for q and kv or a
    ``(q_seg, kv_seg)`` pair. The kernel is the one the dispatch takes,
    or with ``single`` the single-pass kernel, which is also rerun bit for
    bit and timed beside the earlier single-pass kernel of flash_fwd.cu on
    the same inputs (``earlier_ms``) and, for bf16 at D 64/128, beside the
    tiled kernel's tensor-core route (``tc_ms``)."""
    sq, skv = s if isinstance(s, tuple) else (s, s)
    qs, ks = seg if isinstance(seg, tuple) else (seg, seg)
    q = torch.randn(b, h, sq, d, device=DEV, generator=gen).to(dtype)
    k, v = (torch.randn(b, h, skv, d, device=DEV, generator=gen).to(dtype)
            for _ in range(2))
    routed_single = takes_single(fa, skv, d, dtype, causal)
    single = routed_single if single is None else single
    kernel, plain = ((fa.flash_fwd_single, fa.fwd_single_plain) if single
                     else (fa.flash_fwd, fa.fwd_tiled_plain))
    kw = dict(sm_scale=1.0 / float(np.sqrt(d)), p_dropout=p_dropout)
    tiled_kw = dict(kw, causal=causal)
    route = None
    if single:
        got = kernel(q, k, v, qs, ks, SEED, **kw)
    else:
        kw = tiled_kw
        route, got = route_of(kernel, lambda: kernel(q, k, v, qs, ks, SEED,
                                                     **kw))
        check(route == fa.flash_route(dtype, d),
              f"attention case {name} took the {route} route")
    want = plain(q, k, v, qs, ks, SEED, **kw)
    out, lse = fa.flash_attention_with_lse(
        q, k, v, causal=causal, q_segment_ids=qs, kv_segment_ids=ks,
        p_dropout=p_dropout, dropout_seed=SEED)
    # what the entry point routes to, where that is not this case's kernel
    entry_got, entry_want = got, want
    if single != routed_single:
        entry_got = fa.flash_fwd(q, k, v, qs, ks, SEED, **tiled_kw)
        entry_want = fa.fwd_tiled_plain(q, k, v, qs, ks, SEED, **tiled_kw)
    torch.cuda.synchronize()
    dname = _dtype_name(dtype)
    ratios = []
    for g, w, (atol, rtol) in zip(got, want, [ATTN_TOL[dname]]
                                  + [ATTN_TOL["float32"]] * 2):
        g, w = g.float(), w.float()
        ratios.append(float(((g - w).abs() / (atol + rtol * w.abs())).max()))
    strict_out = ratios[0]
    if route == "tc":
        atol, rtol = ATTN_TOL[dname]
        allow = tie_allowance(torch, fa, q, k, v, qs, ks, SEED, causal,
                              kw["sm_scale"], p_dropout)
        g, w = got[0].float(), want[0].float()
        ratios[0] = float(((g - w).abs()
                           / (atol + rtol * w.abs() + allow)).max())
        del allow, g, w
    err = float((got[0].float() - want[0].float()).abs().max())
    hit = entry_want[1] > 0
    want_lse = torch.where(hit, entry_want[2] + torch.log(torch.where(
        hit, entry_want[1], 1.0)), -float("inf"))
    lse_ok = (torch.equal(torch.isneginf(lse), ~hit)
              and float((lse[hit] - want_lse[hit]).abs().max())
              <= 1e-5 * (1.0 + float(want_lse[hit].abs().max())))
    if qs is not None:          # padding rows hit nothing
        lse_ok = lse_ok and bool(torch.isneginf(
            lse.transpose(0, 1)[:, qs < 0]).all())
    c = {"kernel": kernel.__name__, "route": route, "dtype": dname,
         "shape": [b, h, sq, d], "skv": skv, "causal": causal,
         "segments": seg is not None, "p_dropout": p_dropout,
         "max_abs_err": err, "err_ratio_out_l_m": ratios,
         "strict_out_ratio": strict_out, "lse_ok": lse_ok,
         "entry_point_equals_kernel": torch.equal(out, entry_got[0])}
    if single:
        c["block_rows_heads"] = list(fa.single_fwd_config(b, h, sq))
        c["rerun_bit_identical"] = all(
            all(torch.equal(x, y) for x, y in zip(
                kernel(q, k, v, qs, ks, SEED, **kw), got)) for _ in range(2))
    check(max(ratios) <= 1 and lse_ok and c["entry_point_equals_kernel"]
          and c.get("rerun_bit_identical", True),
          f"attention case {name}: kernel differs from its plain version: "
          f"{json.dumps(c)}")
    del entry_got, entry_want
    c["ms"] = time_ms(torch, lambda: kernel(q, k, v, qs, ks, SEED,
                                            save_residuals=False, **kw))
    if route == "tc" and name.startswith("bench"):
        # the CUDA-core kernel on the same bf16 inputs: the earlier route
        c["cuda_core_ms"] = time_ms(torch, lambda: fa._launch(
            fa._flash_lib(), "tfp_flash_fwd", q, k, v, qs, ks, SEED,
            kw["sm_scale"], p_dropout, False, mid=(int(causal),)))
    if single:
        # the earlier single-pass kernel on the same inputs
        c["earlier_ms"] = time_ms(torch, lambda: fa._launch(
            fa._flash_lib(), "tfp_flash_fwd_single", q, k, v, qs, ks, SEED,
            kw["sm_scale"], p_dropout, False))
        if fa.flash_route(dtype, d) == "tc":
            c["tc_ms"] = time_ms(torch, lambda: fa.flash_fwd(
                q, k, v, qs, ks, SEED, save_residuals=False, **tiled_kw))
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
    # the single-pass kernel off BST: few long problems (q and kv segments
    # that differ, a q segment that meets no key), two segments at bf16 D16,
    # and no segments at the largest Skv of bf16 D64 and at bf16 D128 (where
    # the dispatch takes the tensor cores; forced here, timed beside them)
    specs += [
        ("single_long_rows_f32", 16, 8, (1000, 128), 32, f32, False,
         cross_segments(torch, np, fa, rng, 16), 0.0),
        ("single_bf16_d16", 64, 8, 200, 16, bf16, False,
         short_segments(torch, np, rng, 64, 200), 0.0),
        ("single_nosegments_bf16_d64", 64, 8, 192, 64, bf16, False, None,
         0.0, True),
        ("single_nosegments_bf16_d128", 64, 8, 64, 128, bf16, False, None,
         0.0, True)]
    cases, bench = {}, None
    for name, *spec in specs:
        cases[name], tensors = attention_case(torch, np, fa, name, gen, *spec)
        if name == "bench_causal_bf16":
            bench = tensors
        print("attention case", name, json.dumps(cases[name]), flush=True)
    check(cases["bench_causal_bf16"]["kernel"] == "flash_fwd"
          and cases["bench_segments_bf16"]["kernel"] == "flash_fwd"
          and all(c["kernel"] == "flash_fwd_single" for n, c in cases.items()
                  if n.startswith(("bst", "single"))),
          "attention cases did not take the expected routes")
    check(all(c["route"] == ("tc" if c["dtype"] == "bfloat16" else
                             "cuda_core")
              for c in cases.values() if c["kernel"] == "flash_fwd"),
          "tiled attention cases: bf16 D64/D128 must take the tensor-core "
          "route and f32 the CUDA-core one")
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
          and launches["flash_fwd.tc"] == reps + 1
          and launches["flash_fwd_single"] == 0,
          f"flash entry points did not launch the tensor-core tiled kernel: "
          f"{launches}")
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
    (2·D per product: four for dkv, three for dq, five for the single-pass
    kernel) over the peak rate of q's type, and the bytes it must move over
    the HBM rate: q and do rows that hit a key, k and v rows that some row
    hits, and l, m, di of the hit rows, each read once; its outputs (dk and
    dv, dq, or all three) written once; the segment ids read once."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    esz = q.element_size()
    mask = fa._attention_mask(sq, skv, qs, ks, causal, q.device).expand(
        b, sq, skv)
    flops = {"dkv": 8, "dq": 6, "single": 10}[kernel] * d * h * int(
        mask.sum())
    rows, keys = int(mask.any(-1).sum()), int(mask.any(-2).sum())
    nbytes = 2 * (rows + keys) * h * d * esz + 3 * 4 * rows * h
    nbytes += {"dkv": 2 * skv, "dq": sq, "single": sq + 2 * skv}[kernel] \
        * b * h * d * esz
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


def backward_route(fa, call):
    """Run ``call`` (a ``_bwd_dispatch``) and return the route it took with
    its ``(dq, dk, dv)``: ``"single"`` (one ``flash_bwd_single`` launch) or
    the one route, ``"tc"`` or ``"cuda_core"``, of one ``flash_bwd_dkv``
    and one ``flash_bwd_dq`` launch."""
    pair = (fa.flash_bwd_dkv, fa.flash_bwd_dq)

    def counts():
        return ([fa.flash_bwd_single.launches]
                + [getattr(f, f"{r}_launches") for f in pair for r in ROUTES])

    before = counts()
    out = call()
    delta = [a - b for a, b in zip(counts(), before)]
    if delta == [1, 0, 0, 0, 0]:
        return "single", out
    taken = [r for i, r in enumerate(ROUTES) if delta[1 + i] == 1
             and delta[1 + len(ROUTES) + i] == 1]
    check(delta[0] == 0 and sum(delta) == 2 and len(taken) == 1,
          f"backward: expected one single-pass launch or one dk/dv and one "
          f"dq launch on one route, got {delta}")
    return taken[0], out


def expected_bwd_route(fa, q, k, causal):
    """``_bwd_dispatch``'s rule, as the checks expect it."""
    d = q.shape[3]
    if takes_single(fa, k.shape[2], d, q.dtype, causal):
        return "single"
    return fa.flash_route(q.dtype, d)


def backward_case(torch, np, fa, name, gen, q, k, v, causal, seg=None,
                  p_dropout=0.0):
    """Hold the backward kernels that ``_bwd_dispatch`` takes (the
    single-pass kernel, or dk/dv and dq) against their plain versions on the
    card and against float64 autograd through ``reference_attention``, rerun
    them bit for bit, and time kernel, plain version, bound and SDPA's
    backward; on the single-pass route also the CUDA-core dk/dv and dq
    kernels on the same inputs (the earlier route). ``seg`` is one id array
    for q and kv, or a ``(q_seg, kv_seg)`` pair."""
    b, h, s, d = q.shape
    dtype = q.dtype
    dname = _dtype_name(dtype)
    do = torch.randn(q.shape, device=DEV, generator=gen).to(dtype)
    qs, ks = seg if isinstance(seg, tuple) else (seg, seg)
    sm = 1.0 / float(np.sqrt(d))
    out, l, m = fa._fwd_dispatch(q, k, v, qs, ks, SEED, causal, sm,
                                 p_dropout, save_residuals=True)
    di = fa._delta(do, out)
    args = (q, k, v, qs, ks, SEED, do, l, m, di)
    kw = dict(causal=causal, sm_scale=sm, p_dropout=p_dropout)
    route, (dq, dk, dv) = backward_route(
        fa, lambda: fa._bwd_dispatch(*args, **kw))
    check(route == expected_bwd_route(fa, q, k, causal),
          f"backward case {name}: took the {route} route")
    want_dk, want_dv = fa.bwd_dkv_plain(*args, **kw)
    want_dq = fa.bwd_dq_plain(*args, **kw)
    again = fa._bwd_dispatch(*args, **kw)
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
    c = {"dtype": dname, "shape": [b, h, s, d], "skv": k.shape[2],
         "causal": causal, "route": route, "segments": seg is not None,
         "p_dropout": p_dropout,
         "rerun_bit_identical": all(torch.equal(x, y) for x, y in
                                    zip(again, (dq, dk, dv))),
         "f64_err_ratio_dq_dk_dv": f64_ratio}
    parts = ((("flash_bwd_single", (dq, dk, dv), (want_dq, want_dk, want_dv)),)
             if route == "single" else
             (("flash_bwd_dkv", (dk, dv), (want_dk, want_dv)),
              ("flash_bwd_dq", (dq,), (want_dq,))))
    for kernel, got, want in parts:
        errs = [vs_plain(g, w) for g, w in zip(got, want)]
        c[kernel] = {"err_ratio": max(e[0] for e in errs),
                     "max_abs_err": max(e[1] for e in errs)}
    check(all(c[p[0]]["err_ratio"] <= 1 for p in parts)
          and max(f64_ratio) <= 1 and c["rerun_bit_identical"],
          f"backward case {name}: kernels differ: {json.dumps(c)}")
    del again, want_dk, want_dv, want_dq

    def both_plain():
        return (fa.bwd_dkv_plain(*args, **kw), fa.bwd_dq_plain(*args, **kw))

    single_kw = dict(sm_scale=sm, p_dropout=p_dropout)
    timed = ((("flash_bwd_single",
               lambda: fa.flash_bwd_single(*args, **single_kw), both_plain),)
             if route == "single" else
             (("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(*args, **kw),
               lambda: fa.bwd_dkv_plain(*args, **kw)),
              ("flash_bwd_dq", lambda: fa.flash_bwd_dq(*args, **kw),
               lambda: fa.bwd_dq_plain(*args, **kw))))
    for kernel, fn, plain in timed:
        e = c[kernel]
        e["ms"] = time_ms(torch, fn)
        e["plain_ms"] = time_ms(torch, plain, reps=5)
        e["bound_ms"], e["bound_by"], flops = backward_bound(
            fa, q, k, qs, ks, causal, kernel.split("_")[-1])
        e["tflops"] = flops / e["ms"] / 1e9

    # the CUDA-core kernels on the same inputs: the earlier route
    def cuda_core(fn_name, outs):
        return lambda: fa._launch_bwd(fa._flash_bwd_lib(), fn_name,
                                      [torch.empty_like(t) for t in outs],
                                      *args, **kw)
    if route == "tc" and "bench" in name:
        c["flash_bwd_dkv"]["cuda_core_ms"] = time_ms(
            torch, cuda_core("tfp_flash_bwd_dkv", (k, v)), reps=5)
        c["flash_bwd_dq"]["cuda_core_ms"] = time_ms(
            torch, cuda_core("tfp_flash_bwd_dq", (q,)), reps=5)
    if route == "single":
        e = c["flash_bwd_single"]
        e["cuda_core_dkv_ms"] = time_ms(
            torch, cuda_core("tfp_flash_bwd_dkv", (k, v)))
        e["cuda_core_dq_ms"] = time_ms(
            torch, cuda_core("tfp_flash_bwd_dq", (q,)))
    c["library_ms"] = None if p_dropout else time_ms(
        torch, sdpa_backward_call(torch, fa, q, k, v, qs, ks, causal, sm, do))
    torch.cuda.empty_cache()
    return c, (do, dq, dk, dv)


def cross_segments(torch, np, fa, rng, b):
    """q and kv ids of B rows at Sq 1000 against Skv 128: kv ids from
    lengths in 1-128; q ids 0 up to a length in 1-1000, then a run of 50
    rows of segment 1, which meets no key (l = 0), then padding."""
    kv = fa.make_segment_ids_from_lengths(
        torch.from_numpy(rng.randint(1, 129, b)).to(DEV), 128)
    q = np.full((b, 1000), -1, np.int32)
    for i, n in enumerate(rng.randint(1, 1001, b)):
        q[i, :n] = 0
        q[i, n:n + 50] = 1
    return torch.from_numpy(q).to(DEV), kv


def short_segments(torch, np, rng, b, s):
    """Two segments and a padded tail per batch row, the last row all
    padding."""
    seg = np.full((b, s), -1, np.int32)
    for i in range(b - 1):
        cut, end = sorted(rng.randint(1, s + 1, 2))
        seg[i, :cut], seg[i, cut:end] = 0, 1
    return torch.from_numpy(seg).to(DEV)


def attention_backward_phase(torch, np, fa, bench):
    """The backward cases: (a) the bench shape, on the forward phase's
    inputs, whose gradients the entry-point phase reproduces; (b) BST's
    heads, without and with dropout (the single-pass backward); (c) dropout
    at S1000; (d) segments from lengths; (e) bf16 D16 S200 with segments and
    (f) f32 D32 at Sq 1000 against Skv 128, with q and kv segments that
    differ (both on the single-pass backward)."""
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
              bst_seg, 0.0),
             ("b_bst_dropout_f32", lambda: rand(BATCH, 8, 128, 8, f32), False,
              bst_seg, 0.2)]
    specs += [(f"c_s1000_dropout_{'causal' if c else 'full'}_"
               f"{_dtype_name(t)}", lambda t=t: rand(2, 8, 1000, 64, t), c,
               None, 0.2) for c in (True, False) for t in (f32, bf16)]
    specs += [("d_segments_bf16", lambda: rand(4, 8, 2048, 128, bf16), False,
               bench_seg, 0.0)]
    # (f): q and kv ids that differ, a q segment that meets no key
    cross_b = 16
    cross_seg = cross_segments(torch, np, fa, rng, cross_b)

    def cross():
        q = torch.randn(cross_b, 8, 1000, 32, device=DEV, generator=gen)
        return [q] + rand(cross_b, 8, 128, 32, f32)[:2]

    specs += [("e_short_segments_bf16_d16", lambda: rand(64, 8, 200, 16, bf16),
               False, short_segments(torch, np, rng, 64, 200), 0.0),
              ("f_sq1000_skv128_f32_d32", cross, False, cross_seg, 0.0)]
    cases, bench_grads = {}, None
    for name, make, causal, seg, p in specs:
        q, k, v = make()
        cases[name], grads = backward_case(torch, np, fa, name, gen, q, k, v,
                                           causal, seg, p)
        if name == "a_bench_causal_bf16":
            bench_grads = grads
        del q, k, v, grads
        print("backward case", name, json.dumps(cases[name]), flush=True)
    check(all(c["route"] == "single" for n, c in cases.items()
              if n[0] in "bef")
          and all(c["route"] != "single" for n, c in cases.items()
                  if n[0] in "acd"),
          "backward cases did not take the expected routes")
    torch.cuda.empty_cache()
    return cases, bench_grads


HEAD_DIMS = (12, 60, 136, 256)   # padded to 16 and 64; 128-column chunks


def head_dim_case(torch, np, fa, gen, d, dtype, causal, seg):
    """B1 H2 S200 at head dim ``d``: the forward ``flash_attention`` takes
    (``_fwd_dispatch``'s rule) and the backward (``_bwd_dispatch``'s rule:
    the single-pass kernel at D 12 non-causal, else dk/dv and dq), each held
    against its plain versions at the caller's D. The forward's output within
    ``ATTN_TOL`` and, for bf16, the tie allowance (the kernel, at the
    padded D or chunk by chunk, may sum q·k in another order than the plain
    version's matmul at the caller's D; the strict ratio is kept beside),
    l and m within the f32 limit, the gradients within ``BWD_TOL``."""
    b, h, s = 1, 2, 200
    q, k, v, do = (torch.randn(b, h, s, d, device=DEV, generator=gen)
                   .to(dtype) for _ in range(4))
    dname = _dtype_name(dtype)
    kw = dict(sm_scale=1.0 / float(np.sqrt(d)), p_dropout=0.1)
    single = takes_single(fa, s, d, dtype, causal)
    if single:
        fwd_route = None
        got = fa.flash_fwd_single(q, k, v, seg, seg, SEED, **kw)
        want = fa.fwd_single_plain(q, k, v, seg, seg, SEED, **kw)
    else:
        fwd_route, got = route_of(fa.flash_fwd, lambda: fa.flash_fwd(
            q, k, v, seg, seg, SEED, causal=causal, **kw))
        want = fa.fwd_tiled_plain(q, k, v, seg, seg, SEED, causal=causal,
                                  **kw)
    entry = fa.flash_attention(q, k, v, causal=causal, q_segment_ids=seg,
                               kv_segment_ids=seg, p_dropout=0.1,
                               dropout_seed=SEED)
    kw["causal"] = causal
    args = (q, k, v, seg, seg, SEED, do, got[1], got[2],
            fa._delta(do, got[0]))
    bwd_route, (dq, dk, dv) = backward_route(
        fa, lambda: fa._bwd_dispatch(*args, **kw))
    want_dk, want_dv = fa.bwd_dkv_plain(*args, **kw)
    want_dq = fa.bwd_dq_plain(*args, **kw)
    torch.cuda.synchronize()

    def ratio(g, w, atol, rtol, allow=0.0):
        g, w = g.float(), w.float()
        return float(((g - w).abs() / (atol + rtol * w.abs() + allow)).max())

    atol, rtol = ATTN_TOL[dname]
    strict = ratio(got[0], want[0], atol, rtol)
    out_ratio = strict
    if dtype == torch.bfloat16:
        out_ratio = ratio(got[0], want[0], atol, rtol, tie_allowance(
            torch, fa, q, k, v, seg, seg, SEED, causal, kw["sm_scale"], 0.1,
            single=single))
    route = fa.flash_route(dtype, d)
    c = {"shape": [b, h, s, d], "padded_d": fa.padded_head_dim(d),
         "dtype": dname, "causal": causal, "segments": seg is not None,
         "forward": "flash_fwd_single" if single else "flash_fwd",
         "fwd_route": fwd_route, "bwd_route": bwd_route,
         "err_ratio_out_l_m": [out_ratio] + [
             ratio(g, w, *ATTN_TOL["float32"])
             for g, w in zip(got[1:], want[1:])],
         "strict_out_ratio": strict,
         "err_ratio_dq_dk_dv": [ratio(g, w, *BWD_TOL[dname]) for g, w in
                                zip((dq, dk, dv), (want_dq, want_dk,
                                                   want_dv))],
         "max_abs_err": max(float((g.float() - w.float()).abs().max())
                            for g, w in zip((got[0], dq, dk, dv),
                                            (want[0], want_dq, want_dk,
                                             want_dv))),
         "shapes_ok": got[0].shape == dq.shape == q.shape
         and dk.shape == dv.shape == k.shape,
         "entry_point_equals_kernel": torch.equal(entry, got[0])}
    check(bwd_route == expected_bwd_route(fa, q, k, causal)
          and fwd_route in (None, route)
          and max(c["err_ratio_out_l_m"] + c["err_ratio_dq_dk_dv"]) <= 1
          and c["shapes_ok"] and c["entry_point_equals_kernel"],
          f"head-dim case D{d}: kernels differ from their plain versions or "
          f"took another route: {json.dumps(c)}")
    return c


def head_dim_phase(torch, np, fa):
    """Head dims the kernels take only zero-padded (12, 60) or in
    128-column chunks (136, 256), f32 and bf16, causal with two segments and
    a padded tail, and non-causal without segments."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    seg = torch.tensor([[0] * 90 + [1] * 80 + [-1] * 30], dtype=torch.int32,
                       device=DEV)
    cases = {}
    for d in HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                name = (f"d{d}_{'causal_segments' if causal else 'full'}_"
                        f"{_dtype_name(dtype)}")
                cases[name] = head_dim_case(torch, np, fa, gen, d, dtype,
                                            causal, seg if causal else None)
                print("head-dim case", name, json.dumps(cases[name]),
                      flush=True)
    torch.cuda.empty_cache()


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
          and launches["flash_bwd_dq"] == reps
          and launches["flash_fwd.tc"] == reps
          and launches["flash_bwd_dkv.tc"] == reps
          and launches["flash_bwd_dq.tc"] == reps,
          f"flash gradients did not launch the tensor-core kernels: "
          f"{launches}")
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
        {"flash_fwd_single": blocks, "flash_bwd_single": blocks,
         "flash_bwd_dkv": 0, "flash_bwd_dq": 0, "flash_fwd": 0}, profile_dir)
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


def card_against_cpu(torch, np, kv, models, convert, model, opt, lr,
                     dense_lr, init, tx, batches):
    """``batches`` of training steps from ``init`` (a CPU state) on the CPU
    and on the card: headers and the batches' slots bit for bit, losses and
    step 1's dense gradients within ``TRAIN_TOL``, the placed rows and the
    dense parameters within its tight limits on all but a share of
    elements and within a step's learning rate per step everywhere. Returns
    the comparison and raises if it fails."""
    states, losses, grads = {}, {}, {}
    for dev in ("cpu", DEV):
        states[dev], losses[dev], grads[dev] = run_steps(
            models, model, opt, lr,
            copy_state(torch, convert, models, init, dev, tx), batches)
    (tc, pc), (tg, pg) = (state_arrays(torch, states[d])
                          for d in ("cpu", DEV))
    alias = getattr(model, "id_alias", {})

    def slots(dev, n):
        ids = np.concatenate([b["ids"][alias.get(n, n)] for b in batches])
        return kv.find(states[dev].tables[n],
                       kv.encode_ids(ids, device=dev)).slot.cpu()

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
         "slots_bit_identical": all(torch.equal(slots("cpu", n),
                                                slots(DEV, n)) for n in tc),
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
         "dense": diff([pg[k] for k in pc], [pc[k] for k in pc], dense_lr)}
    check(c["headers_bit_identical"] and c["slots_bit_identical"]
          and c["loss_max_abs_err"] <= TRAIN_TOL["loss"] * max(
              1.0, max(abs(x) for x in losses["cpu"]))
          and c["grad_err_ratio"] <= 1
          and all(c[k]["share_past_tight"] <= TRAIN_TOL["share"]
                  and c[k]["max_abs_err_in_lr"] <= len(batches)
                  for k in ("payload", "dense")),
          f"{type(model).__name__}: training on the card differs from the "
          f"CPU: {c}")
    return c


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
        c = card_against_cpu(
            torch, np, kv, models, convert, model, opt, lr, dense_lr, init,
            tx, [batch(CHECK_BATCH) for _ in range(CHECK_STEPS)])
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
        check(c["rerun_bit_identical"],
              f"{name}: two runs of the same steps differ on the card")
        check(falling[-1] < falling[0],
              f"{name}: ten steps on one batch did not lower the loss")
        out[name] = c
    peak_memory(torch, "training checks")
    return out


def profile_calls(torch, name, calls, call_s, out_dir):
    """torch.profiler over a few calls of one path: device kernel time and
    kernel launches per call, the row kernels' share of them beside what
    the row wrappers counted in the same calls, and the device's busy share
    of an unprofiled call that took ``call_s``; the table of ops and kernels
    goes to ``out_dir/<name>_profile.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    before = read_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    after = read_launches()
    counted = sum(after[k] - before[k]
                  for k in ("gather_rows", "scatter_rows")) / len(calls)
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / len(calls)
    launches = sum(e.count for e in kernels) / len(calls)
    rows = [e for e in kernels if "rows_kernel" in e.key]
    rows_ms = sum(e.self_device_time_total for e in rows) / 1e3 / len(calls)
    rows_launches = sum(e.count for e in rows) / len(calls)
    path = os.path.join(out_dir, f"{name}_profile.txt")
    with open(path, "w") as f:
        f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
    print(f"{name} profile: {dev_ms:.4f} ms of device kernels and "
          f"{launches:.1f} kernel launches per call; device busy "
          f"{dev_ms / (call_s * 1e3):.4f} of an unprofiled call "
          f"({call_s * 1e3:.4f} ms); row kernels {rows_ms:.4f} ms in "
          f"{rows_launches:.1f} launches (the row wrappers counted "
          f"{counted:.1f}); table in {path}", flush=True)


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


def payload_bytes(tbundle, prefix, slots=True):
    """Bytes of the values (and, with ``slots``, the slot columns) in one
    bundle."""
    index = tbundle.BundleReader(prefix)._index
    return sum(e.get("nbytes", 0) for k, e in index.items()
               if k.endswith("-values") or (slots and "-slot-" in k))


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


# ---------------------------------------------------------------------------
# the serving API: export, int8 tables, delta refresh, table ops, sparse
# lookups, and the DLRM, DeepFM, Wide&Deep and NCF models
# ---------------------------------------------------------------------------

def dlrm_reference(np, model, dense, embs, features, labels):
    """Float64 numpy forward of DLRM's towers and interaction: the logits
    and the loss."""
    p = {k: v.detach().double().cpu().numpy()
         for k, v in dense.state_dict().items()}

    def mlp(name, x, n, final_relu):
        for i in range(n):
            x = _ref_dense(p, x, f"{name}.{i}", relu=i + 1 < n or final_relu)
        return x

    x_num = mlp("bottom", features.astype(np.float64),
                len(model.bottom_hidden), True)
    t = np.stack([x_num] + [embs[f"T{i}"] for i in range(model.num_tables)],
                 axis=1)
    z = np.einsum("bfd,bgd->bfg", t, t)
    iu, ju = np.triu_indices(t.shape[1], 1)
    logit = mlp("top", np.concatenate([x_num, z[:, iu, ju]], axis=1),
                len(model.top_hidden) + 1, False)[:, 0]
    return logit, sigmoid_ce_mean(np, logit, labels)


def quant_bound(torch, rows):
    """The int8 error bound per row, ``max|row| / 254``, with ``QUANT_SLACK``
    of it for the float32 roundings of the division and the products."""
    return rows.abs().amax(dim=1, keepdim=True) / 254.0 * (1 + QUANT_SLACK)


def per_key(np, kv, t):
    """A table's keys (sorted, encoded on the card) and their embedding
    columns: ``(keys, rows)``."""
    ex = kv.export_arrays(t)
    order = np.argsort(ex["keys"])
    return (kv.encode_ids(ex["keys"][order], device=DEV),
            ex["values"][order])


def dlrm_serving_api_phase(torch, np, kv, quant, models, train, serving,
                           checkpoint, tbundle):
    """DLRM at the Criteo Kaggle widths of facebookresearch/dlrm
    (bench/dlrm_s_criteo_kaggle.sh): 26 tables of dim 16 cut to 2^20 rows
    holding 2^18 keys each (random rows and weights from the seed), bottom
    MLP 13-512-256-64-16, top 512-256-1 over the 16 + 351 pairwise dots.
    Serve batch-2048 requests (5 % unknown ids) against a float64 forward;
    export for serving; load with no templates (the served predictions
    bit for bit) and as int8 tables (lookups bit for bit against the CPU
    on the same int8 table, within max|row|/254 of the f32 rows); three
    Adam steps of the live tables (slots appear) and a delta save; refresh
    both loaded dicts (f32: the trainer's rows per key bit for bit and no
    slot columns; int8: within the bound)."""
    import shutil
    import tempfile
    model = models.DLRM(**DLRM_CONFIG, capacity=DLRM_ROWS)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 50)
    rng = np.random.RandomState(SEED + 50)
    keys = {n: rng.permutation(np.unique(rng.randint(
        0, 1 << 40, DLRM_FILL + DLRM_FILL // 8, dtype=np.int64)))[:DLRM_FILL]
        for n in model.table_specs}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    out = {}
    try:
        reset_launches()
        t0 = time.perf_counter()
        state = models.init_state(model, seed=SEED, device=DEV)
        rows_in = {}
        for name in sorted(state.tables):
            rows_in[name] = torch.randn(DLRM_FILL, 16, device=DEV,
                                        generator=gen)
            kv.insert(state.tables[name],
                      kv.encode_ids(keys[name], device=DEV), rows_in[name],
                      day=1)
        torch.cuda.synchronize()
        out["fill_s"] = time.perf_counter() - t0
        resident, order = {}, {}
        for name, k in keys.items():
            found = kv.find(state.tables[name],
                            kv.encode_ids(k, device=DEV)).found.cpu().numpy()
            check(found.mean() > 0.999, f"DLRM fill: {name} placed too few")
            resident[name] = np.nonzero(found)[0]
            order[name] = resident[name][np.argsort(k[resident[name]])]
        batches = [dcn_batch(np, rng, keys, resident, BATCH)
                   for _ in range(REQUESTS + 1)]
        step = models.make_train_step(model, train=False)
        step(state, batches[0])                               # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [step(state, b)[1:] for b in batches[1:]]
        torch.cuda.synchronize()
        out["examples_per_s"] = REQUESTS * BATCH / (time.perf_counter() - t0)
        for loss, preds in outs:
            check(preds.shape == (BATCH,) and bool(torch.isfinite(preds).all())
                  and bool(torch.isfinite(loss)), "DLRM: non-finite output")
        b = batches[1]
        embs = {}
        for name in keys:
            embs[name] = host_rows(torch, np, keys[name], order[name],
                                   rows_in[name], b["ids"][name]
                                   ).double().cpu().numpy()
        ref_logits, ref_loss = dlrm_reference(np, model, state.dense, embs,
                                              b["features"], b["labels"])
        loss, preds = outs[0]
        out["preds_err_ratio"] = err_ratio(np, preds, ref_logits)
        out["loss_abs_err"] = abs(float(loss) - float(ref_loss))
        check(out["preds_err_ratio"] <= 1 and out["loss_abs_err"]
              <= F32_RTOL * max(1.0, abs(float(ref_loss))),
              f"DLRM: preds/loss differ from the float64 reference: {out}")

        # export, then the template-free loads
        md = serving.RankingMetadata()
        for name in sorted(keys):
            md.add_embedding_column(column_name=name, var_name=name,
                                    embedding_dim=16)
        export_dir = os.path.join(workdir, "export")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefix = serving.export_for_serving(export_dir, state.tables, md)
        out["export_s"] = time.perf_counter() - t0
        nbytes = payload_bytes(tbundle, prefix)
        out["export_payload_bytes"] = nbytes
        out["export_gb_per_s"] = nbytes / out["export_s"] / 1e9
        t0 = time.perf_counter()
        loaded, _ = serving.load_for_serving(export_dir, device=DEV)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["load_gb_per_s"] = nbytes / out["load_s"] / 1e9
        t0 = time.perf_counter()
        loaded_q, _ = serving.load_for_serving(export_dir, quantize=True,
                                               device=DEV)
        torch.cuda.synchronize()
        out["load_int8_s"] = time.perf_counter() - t0
        out["load_int8_gb_per_s"] = nbytes / out["load_int8_s"] / 1e9
        served = state._replace(tables=loaded)
        check(all(torch.equal(step(served, bb)[2], p)
                  for bb, (_, p) in zip(batches[1:4], outs[:3])),
              "DLRM: predictions from the loaded tables differ from the "
              "live tables'")
        worst = 0.0
        for name, qt in loaded_q.items():
            q = kv.encode_ids(b["ids"][name], device=DEV)
            got = quant.lookup_or_zeros(qt, q)
            on_cpu = quant.QuantKvTable(header=qt.header.cpu(),
                                        payload=qt.payload.cpu(),
                                        config=qt.config)
            check(torch.equal(got.cpu(), quant.lookup_or_zeros(on_cpu,
                                                               q.cpu())),
                f"DLRM: {name}'s int8 lookup differs from the CPU's")
            full = kv.lookup_or_zeros(state.tables[name], q)
            err = (got - full).abs()
            check(bool((err <= quant_bound(torch, full)).all()),
                  f"DLRM: {name}'s int8 rows past max|row|/254")
            worst = max(worst, float((err / quant_bound(torch, full)
                                      .clamp(min=1e-30)).max()))
        out["int8_err_over_bound"] = worst
        out["f32_payload_gib"] = sum(
            t.payload.numel() * 4 for t in loaded.values()) / 2 ** 30
        out["int8_payload_gib"] = sum(
            t.payload.numel() for t in loaded_q.values()) / 2 ** 30

        # the trainer: a baseline, three Adam steps, a delta save
        opt = train.AdamOptimizer()
        tables = {}
        for name, t in state.tables.items():
            kv.clear_deltalist(t, "train")
            tables[name] = opt.init(t)
        state = models.TrainState(
            tables=tables, dense=state.dense, step=state.step,
            opt_state=torch.optim.Adam(state.dense.parameters(), lr=0.01))
        del tables, rows_in
        tstep = models.make_train_step(model, opt, sparse_lr=0.01)
        for bb in [dcn_batch(np, rng, keys, resident, BATCH)
                   for _ in range(3)]:
            state, loss, _ = tstep(state, bb)
        check(bool(torch.isfinite(loss)), "DLRM training: non-finite loss")
        delta = os.path.join(workdir, "delta-1")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(delta, state.tables, delta=True)
        out["delta_save_s"] = time.perf_counter() - t0
        # a refresh reads the delta's values, not its slot columns
        dbytes = payload_bytes(tbundle, delta, slots=False)
        out["delta_values_bytes"] = dbytes
        t0 = time.perf_counter()
        loaded = serving.refresh_from_delta(loaded, delta)
        torch.cuda.synchronize()
        out["refresh_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded_q = serving.refresh_from_delta(loaded_q, delta, quantize=True)
        torch.cuda.synchronize()
        out["refresh_int8_s"] = time.perf_counter() - t0
        out["refresh_gb_per_s"] = dbytes / out["refresh_s"] / 1e9
        out["launches"] = read_launches()
        for name, t in state.tables.items():
            k, want = per_key(np, kv, t)
            want = torch.from_numpy(want).to(DEV)
            ft = loaded[name]
            fr = kv.find(ft, k)
            check(bool(fr.found.all()) and int(kv.size(ft)) == k.shape[0]
                  and ft.payload.shape[1] == 16 and not ft.config.slot_layout,
                  f"DLRM refresh: {name} has other keys or slot columns")
            check(torch.equal(ft.payload[fr.slot.long()], want),
                  f"DLRM refresh: {name}'s f32 rows differ from the "
                  "trainer's")
            got = quant.lookup_or_zeros(loaded_q[name], k)
            check(bool(((got - want).abs() <= quant_bound(torch, want))
                       .all()),
                  f"DLRM refresh: {name}'s int8 rows past max|row|/254")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    check(out["launches"]["gather_rows"] > 0
          and out["launches"]["scatter_rows"] > 0,
          f"DLRM serving API path: the row kernels were not launched: "
          f"{out['launches']}")
    del state, loaded, loaded_q
    out["peak_gib"] = peak_memory(torch, "DLRM serving API")
    print(f"DLRM serving API: {json.dumps(out)}", flush=True)
    return out["launches"], out


def int8_lookup_and_table_ops_phase(torch, np, kv, quant, embedding,
                                    convert):
    """(b) The JAX bench's serving-leg shape: a 2^20-row dim-128 table
    filled with 32,768 ids; ``quant.lookup_or_zeros`` of the ids and their
    reversal in ids/s beside ``kv.lookup_or_zeros`` on the same table, in
    turns (f32, int8, int8, f32). (c) On that table, each of the 7 scatter
    ops over 32,768 ids of which half are present, ``get_count``,
    ``get_timestamp`` and a TTL eviction of the filled rows no op touched,
    each against the same calls on a CPU copy bit for bit; then
    ``safe_embedding_lookup_sparse`` over a batch of 2,048 rows of 1-20 ids
    (5 % unknown, 5 % negative, weights with some <= 0, a default id), each
    combiner weighted and not: reruns on the card bit for bit, within 1e-6
    of the CPU's scale."""
    rng = np.random.RandomState(SEED + 60)
    ids = rng.permutation(np.unique(rng.randint(0, 1 << 40, N_IDS + 4096,
                                                dtype=np.int64)))[:N_IDS]
    reps = 20
    out = {}
    reset_launches()
    t = kv.create(128, C_ROWS, max_probes=16, seed=SEED, device=DEV)
    q = kv.encode_ids(ids, device=DEV)
    qf = q.flip(0)
    check(not bool(kv.lookup_or_insert(t, q, day=100).overflow),
          "int8 leg: the fill overflowed")
    cpu = dataclasses.replace(t, **{f: getattr(t, f).to("cpu", copy=True)
                                    for f in convert.TABLE_FIELDS})
    qt = quant.quantize_table(t)
    qt_cpu = quant.quantize_table(cpu)
    check(torch.equal(qt.header.cpu(), qt_cpu.header)
          and torch.equal(qt.payload.cpu(), qt_cpu.payload),
          "int8 leg: quantize_table on the card differs from the CPU's")
    calls = {"f32": lambda x: kv.lookup_or_zeros(t, x),
             "int8": lambda x: quant.lookup_or_zeros(qt, x)}
    rates = {"f32": [], "int8": []}
    for leg in ("f32", "int8", "int8", "f32"):
        fn = calls[leg]
        fn(q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(q)
            fn(qf)
        torch.cuda.synchronize()
        rates[leg].append(2 * reps * N_IDS / (time.perf_counter() - t0))
    out["int8_leg_launches"] = read_launches()
    out["ids_per_s"] = rates
    full = kv.lookup_or_zeros(t, q)
    got = quant.lookup_or_zeros(qt, q)
    check(torch.equal(got.cpu(), quant.lookup_or_zeros(qt_cpu, q.cpu())),
          "int8 leg: the card's int8 lookup differs from the CPU's")
    check(bool(((got - full).abs() <= quant_bound(torch, full)).all()),
          "int8 leg: int8 rows past max|row|/254")
    out["int8_payload_bytes"] = qt.payload.numel()
    out["f32_payload_bytes"] = t.payload.numel() * 4
    out["card"] = smi_line()
    del qt, qt_cpu
    print(f"int8 lookup leg: {json.dumps(out)}", flush=True)

    # (c) the table ops, on the card and on the CPU copy
    gen = torch.Generator().manual_seed(SEED + 61)
    present = ids[:N_IDS // 2]
    reset_launches()
    ops_ms = {}
    for k, op in enumerate(("update", "add", "sub", "mul", "div", "min",
                            "max")):
        # fresh ids for every op: disjoint ranges
        new = rng.randint(1 << (41 + k), 1 << (42 + k), N_IDS // 2,
                          dtype=np.int64)
        qq = np.concatenate([present, new])
        upd = torch.randn(N_IDS, 128, generator=gen)
        qd, ud = kv.encode_ids(qq, device=DEV), upd.to(DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv.scatter(t, qd, ud, op, day=110)
        torch.cuda.synchronize()
        ops_ms[op] = (time.perf_counter() - t0) * 1e3
        kv.scatter(cpu, kv.encode_ids(qq, device="cpu"), upd, op, day=110)
    qall = kv.encode_ids(np.concatenate([ids, new]), device=DEV)
    counts = kv.get_count(t, qall)
    days = kv.get_timestamp(t, qall)
    check(torch.equal(counts.cpu(), kv.get_count(cpu, qall.cpu()))
          and torch.equal(days.cpu(), kv.get_timestamp(cpu, qall.cpu())),
          "table ops: get_count/get_timestamp differ from the CPU's")
    # the present half: the fill and 7 ops; the rest of the fill; the last
    # op's new ids
    want_counts = np.concatenate([np.full(N_IDS // 2, 8), np.ones(N_IDS)])
    want_days = np.concatenate([np.full(N_IDS // 2, 110),
                                np.full(N_IDS // 2, 100),
                                np.full(N_IDS // 2, 110)])
    check(np.array_equal(counts.cpu().numpy(), want_counts)
          and np.array_equal(days.cpu().numpy(), want_days),
          "table ops: unexpected counts or days")
    size_before = int(kv.size(t))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, evicted = kv.delete_with_timestamp(t, 5, 110)
    torch.cuda.synchronize()
    ops_ms["delete_with_timestamp"] = (time.perf_counter() - t0) * 1e3
    _, evicted_cpu = kv.delete_with_timestamp(cpu, 5, 110)
    check(int(evicted.sum()) == N_IDS // 2
          and int(kv.size(t)) == size_before - N_IDS // 2,
          "table ops: the eviction missed its share")
    check(all(torch.equal(getattr(t, f).cpu(), getattr(cpu, f))
              for f in convert.TABLE_FIELDS) and torch.equal(evicted.cpu(),
                                                     evicted_cpu),
          "table ops: the card's table differs from the CPU's")
    out_ops = {"ms": ops_ms, "rows": size_before,
               "evicted": int(evicted.sum()),
               "evicted_share": int(evicted.sum()) / size_before}

    # the sparse lookups over the table's live keys
    live = np.concatenate([present, new])
    lengths = rng.randint(1, 21, BATCH)
    n = int(lengths.sum())
    sq = live[rng.randint(0, live.shape[0], n)]
    unknown = rng.rand(n) < 0.05
    sq[unknown] = rng.randint(1 << 50, 1 << 51, int(unknown.sum()))
    neg = rng.rand(n) < 0.05
    sq[neg] = -sq[neg]
    seg = np.repeat(np.arange(BATCH), lengths).astype(np.int32)
    w = (rng.rand(n) - 0.05).astype(np.float32)
    sparse = {}
    for combiner in ("sum", "mean", "sqrtn"):
        for weighted in (False, True):

            def run(dev, table):
                wt = torch.from_numpy(w).to(dev) if weighted else None
                return embedding.safe_embedding_lookup_sparse(
                    table, sq, seg, BATCH, weights=wt, combiner=combiner,
                    train=False, default_id=int(present[0]))[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = run(DEV, t)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            b = run(DEV, t)
            c = run("cpu", cpu)
            scale = float(c.abs().max())
            err = float((a.cpu() - c).abs().max())
            name = f"{combiner}{'_weighted' if weighted else ''}"
            sparse[name] = {"ms": ms, "max_abs_err": err, "scale": scale}
            check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                  f"sparse lookup {name}: a rerun on the card differs")
            check(np.allclose(a.cpu().numpy(), c.numpy(), rtol=1e-6,
                              atol=1e-6 * scale),
                  f"sparse lookup {name}: card and CPU differ: {err}")
    out_ops["sparse_lookups"] = {"entries": n, "rows": BATCH, **sparse}
    out_ops["launches"] = read_launches()
    check(out_ops["launches"]["gather_rows"] > 0
          and out_ops["launches"]["scatter_rows"] > 0,
          f"table ops: the row kernels were not launched: {out_ops}")
    print(f"table ops and sparse lookups: {json.dumps(out_ops)}", flush=True)
    del t, cpu
    out["table_ops"] = out_ops
    out["peak_gib"] = peak_memory(torch, "int8 leg, table ops, sparse")
    return out["int8_leg_launches"], out_ops["launches"], out


def ctr_reference(np, model, name, dense, embs, features):
    """Float64 numpy forward of DeepFM, Wide&Deep or NCF."""
    p = {k: v.detach().double().cpu().numpy()
         for k, v in dense.state_dict().items()}

    def mlp(pre, x, n, final_relu):
        for i in range(n):
            x = _ref_dense(p, x, f"{pre}{i}", relu=i + 1 < n or final_relu)
        return x

    if name == "NCF":
        x = np.concatenate([embs["user"], embs["movie"]], axis=1)
        return mlp("", x, len(model.hidden) + 1, False)[:, 0]
    f = model.num_fields
    v = np.stack([embs[f"C{i + 1}"] for i in range(f)], axis=1)
    linear = sum(embs[f"C{i + 1}_w"][:, 0] for i in range(f))
    h = mlp("dnn.", np.concatenate([v.reshape(v.shape[0], -1), features], 1),
            len(model.dnn_hidden), True)
    deep = _ref_dense(p, h, "dnn_logits")[:, 0]
    if name == "DeepFM":
        s = v.sum(1)
        fm = 0.5 * (s * s - (v * v).sum(1)).sum(-1)
        return fm + linear + deep + p["bias"][0]
    return linear + _ref_dense(p, features, "wide_numeric")[:, 0] + deep


def ctr_models_phase(torch, np, kv, embedding, models, train, convert):
    """DeepFM and Wide&Deep (26 fields of dim 16 and 26 dim-1 tables, DNN
    256-128; examples/train_deepfm.py) and NCF (dim 32, 256-64;
    examples/train_ncf.py), tables of 2^14 rows, Adam 1e-3 sparse and dense
    (the examples' defaults): three steps on the card against the CPU as in
    the training checks, then batch-2048 serving against a float64
    forward."""
    out, launches = {}, None
    for i, name in enumerate(("DeepFM", "WideDeep", "NCF")):
        model = getattr(models, name)(capacity=CTR_ROWS)
        alias = getattr(model, "id_alias", {})
        streams = sorted({alias.get(n, n) for n in model.table_specs})
        rng = np.random.RandomState(SEED + 70 + i)
        universe = {s: rng.randint(1, 1 << 40, 4000, dtype=np.int64)
                    for s in streams}

        def batch(b):
            ids = {s: u[rng.randint(0, 4000, b)] for s, u in universe.items()}
            bt = {"ids": ids, "labels": (rng.randint(1, 6, b) if name == "NCF"
                                         else rng.randint(0, 2, b)
                                         ).astype(np.float32)}
            if name != "NCF":     # ratings 1-5 for NCF's squared error
                bt["features"] = rng.randn(b, 13).astype(np.float32)
            return bt
        opt = train.AdamOptimizer()
        tx = functools.partial(torch.optim.Adam, lr=1e-3)
        init = models.init_state(model, opt, tx, seed=SEED + 70 + i,
                                 device="cpu")
        reset_launches()
        c = card_against_cpu(torch, np, kv, models, convert, model, opt,
                             1e-3, 1e-3, init, tx,
                             [batch(CHECK_BATCH) for _ in range(CHECK_STEPS)])
        state = copy_state(torch, convert, models, init, DEV, tx)
        state, _, _ = run_steps(models, model, opt, 1e-3, state,
                                [batch(BATCH) for _ in range(CHECK_STEPS)])
        b = batch(BATCH)
        for s in streams:
            unknown = rng.rand(BATCH) < 0.05
            b["ids"][s][unknown] = rng.randint(1 << 41, 1 << 42,
                                               int(unknown.sum()))
        step = models.make_train_step(model, train=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss, preds = step(state, b)
        torch.cuda.synchronize()
        c["first_request_ms"] = (time.perf_counter() - t0) * 1e3
        embs = {n: embedding.gather(embedding.lookup_unique(
            t, b["ids"][alias.get(n, n)], train=False)[0]
        ).double().cpu().numpy() for n, t in state.tables.items()}
        feats = b.get("features")
        ref = ctr_reference(np, model, name, state.dense, embs,
                            None if feats is None
                            else feats.astype(np.float64))
        c["preds_err_ratio"] = err_ratio(np, preds, ref)
        check(preds.shape == (BATCH,) and bool(torch.isfinite(loss))
              and c["preds_err_ratio"] <= 1,
              f"{name}: serving differs from the float64 reference: {c}")
        paths = read_launches()
        launches = paths if launches is None else {
            k: launches[k] + paths[k] for k in launches}
        print(f"{name} checks:", json.dumps(c), flush=True)
        out[name] = c
        del state, init
    check(launches["gather_rows"] > 0 and launches["scatter_rows"] > 0,
          f"CTR models: the row kernels were not launched: {launches}")
    out["launches"] = launches
    out["peak_gib"] = peak_memory(torch, "DeepFM, Wide&Deep, NCF")
    return launches, out


def kernel_entry(name, src, replaces, launches, errs, cases, main, keys):
    """A row kernel's entry at the main case, with the earlier kernel on the
    same inputs as the earlier one, and per case and key (``gather``;
    ``scatter``, ``scatter_add``) its time, the earlier kernel's, the
    bound, the library call's and the plan's word bytes, lanes per row,
    words per lane and rows in flight."""
    case = cases[main]
    key = keys[0]
    plan_of = {"gather": "gather", "scatter": "set", "scatter_add": "add"}
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs),
            "ms": case[f"{key}_ms"], "plain_ms": case[f"{key}_plain_ms"],
            "bound_ms": case[f"{key}_bound_ms"], "bound_by": "bytes",
            "library_ms": case[f"{key}_library_ms"],
            "earlier_source": CSRC + "rowops_earlier.cu",
            "earlier_ms": case[f"{key}_earlier_ms"],
            "cases": {n: {k: [c[f"{k}_ms"], c[f"{k}_earlier_ms"],
                              c[f"{k}_bound_ms"], c[f"{k}_library_ms"],
                              [c["plan"][plan_of[k]][p] for p in (
                                  "word_bytes", "lanes_per_row",
                                  "words_per_lane", "rows_in_flight")]]
                          for k in keys}
                      for n, c in cases.items()},
            "cases_columns": ["ms", "earlier_ms", "bound_ms", "library_ms",
                              "plan: word_bytes, lanes_per_row, "
                              "words_per_lane, rows_in_flight"]}


CSRC = "tfplus_tpu_torch/ops/csrc/"


def routes_entry(name, launches, main, f32_case, f32_ms):
    """The keys a routed kernel adds to its entry: the main case is the
    tensor-core route's; the CUDA-core route keeps its source, its launches
    and its time at an f32 case and, on the main case's bf16 inputs, the
    earlier route's time."""
    return {"launches_by_route": {r: launches[f"{name}.{r}"] for r in ROUTES},
            "cuda_core_source": CSRC + ("flash_fwd.cu" if name == "flash_fwd"
                                        else "flash_bwd.cu"),
            "cuda_core_case": f32_case, "cuda_core_ms": f32_ms,
            "cuda_core_ms_on_main_case": main["cuda_core_ms"]}


def attention_entry(name, replaces, launches, cases, main_case,
                    f32_case=None):
    """A forward kernel's entry; the single-pass kernel's adds the earlier
    single-pass kernel's time on its main case's inputs and, per
    single-pass case, its time beside the earlier kernel's, the bound and
    (bf16 at D 64/128) the tensor-core route's."""
    c = cases[main_case]
    routed = name in ROUTED
    e = {"name": name, "route": "cuda",
         "source": CSRC + ("flash_fwd_tc.cu" if routed else f"{name}.cu"),
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": max(x["max_abs_err"] for x in cases.values()
                            if x["kernel"] == name),
         "ms": c["ms"], "plain_ms": c["plain_ms"],
         "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
         "library_ms": c["library_ms"]}
    if routed:
        e.update(routes_entry(name, launches, c, f32_case,
                              cases[f32_case]["ms"]))
    else:
        e["earlier_source"] = CSRC + "flash_fwd.cu"
        e["earlier_ms"] = c["earlier_ms"]
        e["cases"] = {n: {k: x.get(k) for k in ("ms", "earlier_ms", "tc_ms",
                                                  "bound_ms", "library_ms")}
                      for n, x in cases.items() if x["kernel"] == name}
    return e


def backward_entry(name, replaces, launches, cases, main_case,
                   f32_case=None):
    """A backward kernel's entry; the single-pass kernel's adds the
    CUDA-core dk/dv and dq kernels' time on its main case's inputs."""
    c = cases[main_case][name]
    routed = name in ROUTED
    e = {"name": name, "route": "cuda",
         "source": CSRC + ("flash_bwd_tc.cu" if routed else f"{name}.cu"),
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": max(x[name]["max_abs_err"] for x in cases.values()
                            if name in x),
         "ms": c["ms"], "plain_ms": c["plain_ms"],
         "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
         "library_ms": cases[main_case]["library_ms"]}
    if routed:
        e.update(routes_entry(name, launches, c, f32_case,
                              cases[f32_case][name]["ms"]))
    else:
        e["cuda_core_pair_ms_on_main_case"] = (c["cuda_core_dkv_ms"]
                                               + c["cuda_core_dq_ms"])
    return e


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
                                      models, ops, serving, train)
        from tfplus_tpu_torch.kv import quant
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
    for name in ("flash_fwd_tc", "flash_bwd_tc", "flash_fwd_single",
                 "flash_bwd_single"):
        print(f"ptxas {name}: " + " | ".join(_build.ptxas_report(name)),
              flush=True)

    cases = kernel_phase(torch, rowops)
    attn_cases, bench = attention_phase(torch, np, fa)
    bwd_cases, bench_grads = attention_backward_phase(torch, np, fa, bench)
    head_dim_phase(torch, np, fa)
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
    dlrm_launches, dlrm = dlrm_serving_api_phase(
        torch, np, kv, quant, models, train, serving, checkpoint, tbundle)
    int8_launches, ops_launches, int8_ops = int8_lookup_and_table_ops_phase(
        torch, np, kv, quant, embedding, convert)
    ctr_launches, ctr = ctr_models_phase(torch, np, kv, embedding, models,
                                         train, convert)

    errs = {k: [c[f"{k}_err"] for c in cases.values()]
            for k in ("gather", "scatter_set", "scatter_add")}
    check(max(max(v) for v in errs.values()) == 0.0,
          "a kernel differs from its plain version")
    paths = [emb_launches, dcn_launches, flash_launches,
             seq["fill_launches"], seq["BST"][0], seq["DIN"][0],
             grad_launches, dcn_train[0], bst_train[0], comp_launches,
             grow_launches, rep_launches, ref_launches, dlrm_launches,
             int8_launches, ops_launches, ctr_launches]
    launches = {k: sum(p[k] for p in paths) for k in paths[0]}
    src = CSRC + "rowops.cu"
    main_case = f"float32_w128_n{N_IDS}"            # the serving-leg shape
    kernels = [
        kernel_entry("gather_rows", src, "tfplus_tpu/ops/rowops.py:76",
                     launches["gather_rows"], errs["gather"], cases,
                     main_case, ("gather",)),
        kernel_entry("scatter_rows", src, "tfplus_tpu/ops/rowops.py:122",
                     launches["scatter_rows"],
                     errs["scatter_set"] + errs["scatter_add"], cases,
                     main_case, ("scatter", "scatter_add")),
        attention_entry("flash_fwd", "tfplus_tpu/ops/flash_attention.py:328",
                        launches, attn_cases, "bench_causal_bf16",
                        "s1000_dropout_causal_float32"),
        attention_entry("flash_fwd_single",
                        "tfplus_tpu/ops/flash_attention.py:267",
                        launches, attn_cases, "bst_f32"),
        backward_entry("flash_bwd_dkv",
                       "tfplus_tpu/ops/flash_attention.py:589",
                       launches, bwd_cases, "a_bench_causal_bf16",
                       "c_s1000_dropout_causal_float32"),
        backward_entry("flash_bwd_dq",
                       "tfplus_tpu/ops/flash_attention.py:636",
                       launches, bwd_cases, "a_bench_causal_bf16",
                       "c_s1000_dropout_causal_float32"),
        backward_entry("flash_bwd_single",
                       "tfplus_tpu/ops/flash_attention.py:589 and :636",
                       launches, bwd_cases, "b_bst_f32"),
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
    print(json.dumps({"serving_api": {
        "dlrm": dlrm, "int8_leg_and_table_ops": int8_ops,
        "ctr_models": ctr}}))
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
