#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (tfplus_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and nvcc. It
imports neither JAX nor the JAX package. It checks every path of the port
and times each hand-written kernel alone, beside its bound, its plain
version and one library call; it times no path (``benchmarks/run.py``
measures the paths). Phases, each of which raises on a failed check:

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
   4·D), rerun bit for bit, and timed beside it and beside one PyTorch
   call that computes the same function; each case prints the launch plan (``rowops.plan``) that gather, set and add took.
   Then the claim-insert kernel (``ops/csrc/claim.cu``) against the
   table's Python claim rounds (``kv.table._claim_rounds``) on copies of
   one header, at the benchmark's shapes: a DCN table's training lookup
   (2,048 ids, 5 % fresh, into 2^20 rows holding 2^18 keys), BST's item
   table's (12,288 ids, 5 % fresh, 2^23 rows holding 2^21) and a table's
   load (2^18 keys into an empty 2^20-row table): header, ``placed`` and
   the four insert counters bit for bit, and at the lookups the payload a
   card ``lookup_or_insert`` leaves equal to its rows before with the
   misses' initial rows scattered by the plain scatter; each timed beside
   the rounds and its byte bound. Then the probe kernel
   (``ops/csrc/probe.cu``) against the table's plain find
   (``kv.table._find_plain``) at a DCN table's lookup (2,048 ids into 2^20
   rows holding 2^18 keys) and BST's item table's (12,288 ids into 2^23
   rows holding 2^21), 5 % fresh: every output and the ``probed`` and
   ``found`` counts bit for bit, with and without ``valid`` and the pad
   plane, one launch a call; timed beside the plain version and its byte
   bound.
3. Embedding serving (the bench's serving-leg shape): a 1M-row dim-128
   table filled by ``lookup_or_insert`` of 32,768 ids, then
   ``lookup_or_zeros`` of those ids and of their reversal.
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
   the dispatch sends to the tensor cores; forced here);
   ``flash_attention_with_lse``'s residuals and its -inf on padding rows.
   Each case records the route it took; the single-pass kernel is also
   rerun bit for bit.
6. Flash entry points: ``flash_attention(causal=True)`` and
   ``flash_attention_with_lse`` at the bench's shape, once each, equal to
   the checked kernel's output, every forward launch on the tensor-core
   route.
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
   cases and the CUDA-core one on the f32 ones. Then head dims the
   kernels take only padded (12, 60) or in 128-column chunks (136, 256):
   B1 H2 S200, causal with segments and non-causal, f32 and bf16, each
   forward (the route ``flash_attention`` takes) and the backward that
   ``_bwd_dispatch`` takes (single-pass at D 12 non-causal) held against
   the plain versions at the caller's D, with the routes recorded.
9. ``flash_attention(causal=True)`` forward and backward once at the
   bench's shape, the gradients equal to the checked kernels', the
   forward, dk/dv and dq launches on the tensor-core route.
10. Training checks at the reference DCN's and BST's widths with tables of
   2^14 rows: three steps from one state on the card and on the CPU (headers
   and slots bit for bit, the rest within the stated tolerances), two runs
   from cloned states bit for bit on the card, and a loss that falls over
   ten steps on one batch.
11. DCN training at the reference width: 26 tables of 2^20 rows with
   GroupAdam's slot columns (payload 4·D), each filled with 2^19 keys, then
   batch-2048 steps with 5 % unseen ids (GroupAdam 1e-3, dense Adam 1e-3):
   finite losses, and the kernels' launches per step.
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
   deleted, each checked row for row.
17. The serving API on DLRM at its Criteo Kaggle widths
   (facebookresearch/dlrm ``bench/dlrm_s_criteo_kaggle.sh``: 26 tables of
   dim 16, bottom MLP 13-512-256-64-16, top 512-256-1; cut to 2^20 rows
   per table holding 2^18 keys): batch-2048 requests (5 % unknown ids)
   against a float64 forward; ``export_for_serving``; ``load_for_serving``
   with no templates (predictions bit for bit) and as int8 tables (lookups
   bit for bit against the CPU on the same int8 table, within max|row|/254
   of the f32 rows); three Adam steps of the live tables and a delta save;
   ``refresh_from_delta`` of both (f32 rows per key bit for bit with the
   trainer's and no slot columns; int8 within the bound).
18. The int8 lookup at the bench's serving-leg shape (a 2^20-row dim-128
   table filled with 32,768 ids): ``quantize_table`` bit for bit against
   the CPU, ``quant.lookup_or_zeros`` of the ids bit for bit against the
   CPU and within the bound of ``kv.lookup_or_zeros``. Then on that table
   each
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
20. Criteo data to DCN training: a 2^18-line Criteo Kaggle-layout TSV made
   from the seed (Zipf-skewed hex categoricals, empty fields) is parsed by
   the native helper library (built with g++ into
   ``tfplus_tpu_torch/_build/native/``; the script fails if it does not
   build) and by the pure-Python parser, bit for bit, and read through
   ``build_binary_cache``, ``BinaryCriteoCache.batches(2048)`` and
   ``CriteoLoader(threads=8)`` (every row read). The reference DCN of
   phase 11 (2^20-row GroupAdam tables, empty at the start) trains 16
   batch-2048 steps from the cache four times from equal states: through
   the per-leaf feed (28 pageable copies), through ``data.make_packed_feed``
   (one pinned buffer, one non-blocking copy, unpacked on the card) twice,
   and per leaf again; losses and tables bit for bit.
21. The multi-table step (``models.make_train_step_multi``) at the
   reference DCN's widths: three steps on 2^14-row groups on the card
   against the CPU as in phase 10, and two runs from cloned states bit
   for bit; then one GroupAdam table per dim (dim 64: 18 logical tables in
   2^23 rows; dim 128: 8 in 2^22) with 2^18 tagged keys per logical table,
   serving requests checked against a host-side map and a float64
   forward, then 10 requests and 10 training steps (batch 2048, 5 %
   unseen ids) beside the per-table step on 26 tables of 2^19 rows holding
   the same keys and rows (built after the groups are freed; its
   predictions equal the multi-table step's bit for bit): row-kernel
   launches per request and the kernels' launches per step.
22. The host-DRAM tier (``kv.storage.HybridTable``): a dim-128 Adam table
   of 2^21 rows under a 2^19-row budget, 64 batches of the unique ids of
   32,768 Zipf(1.05) draws from 2^22; each step prefetches the batch,
   looks it up, applies Adam to ``rows * 0.1``, prefetches the next batch
   on the worker thread while the step runs, promotes it and spills to
   the budget. After every spill the device holds at most the budget; the
   logical size is every id seen; the hybrid export equals a 2^23-row
   table's that never spilled, per key bit for bit, and
   ``restore_hybrid_split`` gives the same rows again. Rows moved each
   way per step, host-tier bytes.
23. The distributed tier in a world of 1 over NCCL (this process; a gloo
   subgroup for the CPU): phase 17's DLRM over sharded tables
   (``parallel.sharded_lookup(defer_meta=True)``, the loss, the dense
   gradients all-reduced, ``sharded_apply_grads``; GroupAdam 1e-3, dense
   Adam 1e-3). At 2^14-row shards, three steps on the card against the
   same sharded steps on the CPU as in phase 10, two runs bit for bit and
   a loss that falls over ten steps on one batch; then 26 shards of 2^20
   rows holding 2^18 keys, 10 counted batch-2048 steps (5 % unseen ids, no
   overflow flag set): row-kernel launches and the bytes of the tensors
   handed to the collectives per step (in a world of 1 none crosses a
   link); 10 f32 and 10 int8 requests through
   ``sharded_serving_lookup``, whose rows equal the table's per key (int8
   bit for bit against ``quant.lookup_or_zeros``, within max|row|/254).
   Its launches are read after the steps and requests, before the checks.
24. Two ranks on the one card over gloo, this script started twice with
   ``--rank-worker`` and a 480 s limit, each leg with the launch counts
   reset before it and its references, checks and set-up taken off them
   (``not_path``): ring flash attention at the bench's shape (causal bf16
   B4 H8 S2048 D128, S 1024 per rank; tensor-core kernels) and non-causal
   f32 B2 H4 S256 D32 (128-key blocks on the single-pass kernels), forward
   and backward against one ``flash_attention`` over the whole sequence
   (bf16 output within ATTN_TOL plus the p-rounding allowance of
   ``ring_allowance``, gradients within BWD_F64_TOL of scale); DLRM at
   its widths on 2^11-row shards through collective growth, with a full
   and a delta ``save_multihost`` restored equal per key; route-overflow
   recovery from a 4-deep bucket; ``ShardedHybridTable`` under a 48-row
   budget against an uncapped run, per key bit for bit; sharded serving
   load (f32, int8) and delta refresh; 2D at 1 x 2 with GroupAdam's l21
   norm across the column ranks against one full-width table.
25. Remote storage: the port's OSS, S3 and DFS emulators on 127.0.0.1 in
   this process. (a) ``oss://`` with a single-PUT cap at the client's 16 MB
   part size, so the bundle files go up in parts: ``export_for_serving``
   of phase 17's DLRM (26 tables of 2^20 rows holding 2^18 keys, dim 16),
   then ``load_for_serving`` in f32 (rows per key bit for bit with the
   source) and int8 (within max|row|/254). (b) three Adam steps and a delta
   ``checkpoint.save`` to ``s3://``; ``refresh_from_delta`` from there
   equals the same refresh from local disk, per key bit for bit. (c) phase
   14's growing DCN for 8 steps through ``CheckpointManager`` on
   ``dfs://``, full at step 4 and delta at 8, the first request of the full
   save failed once by the emulator (retried); the restore equals the live
   tables per key. One more step from both states: grown by
   ``grow_if_needed``, each side's unplaced ids of the batch are listed,
   and the losses must be equal where both sides leave the same ids
   unplaced (a restore that leaves others is reported as a known fault);
   grown to one capacity, twice the larger, the losses must be equal. Each
   leg prints its payload bytes and its row-kernel launches.
26. Profiling: ``utils.profiling.trace`` over three serving requests and
   three training steps of the reference-width DCN (2^16-row tables
   holding 2^14 keys), with ``annotate`` ranges around each lookup, the
   towers and each sparse apply; the TensorBoard trace must hold those
   ranges and as many ``rows_kernel`` CUDA events as the row wrappers
   counted; ``StepMeter``'s rate over ten steps within half of their
   CUDA events' rate.
27. The examples' twins (``tfplus_tpu_torch/examples``), each in its own
   process (this script with ``--twin``), six at a time on the one card,
   the longest first: ``train_dcn`` (GroupAdam, 20 batches),
   ``train_deepfm`` (DeepFM and Wide&Deep, 10 batches), ``train_din`` (DIN and
   BST; BST must launch the single-pass flash kernels), ``train_ncf`` (the
   loss must fall), ``serving_demo`` (f32 and ``--quantize``; its
   self-test), ``checkpoint_resume``, ``migrate_from_tfplus`` (a TFPlus
   checkpoint written by the port's own TensorBundle writer, imported 2
   shards into 3, three GroupAdam steps, a native save and an export back
   to TFPlus format) and ``train_dlrm_sharded`` under ``torchrun
   --nproc-per-node 1`` (NCCL); each must exit 0 and pass its checks.
28. The TFPlus bridge: phase 17's DLRM after three Adam steps, 64 keys per
   table then blacklisted. (a) ``tf_export.export_checkpoint`` with uint16
   frequencies and with ``freq_use_uint32``, each twice: the same bytes.
   (b) ``tf_import.import_checkpoint`` into fresh templates on the card:
   per key the rows, the frequency, day (uint32) and blacklist bits of the
   meta words, and the init pools equal the source's bit for bit; ten
   batch-2048 requests give the source's predictions. (c) one table into 4
   shards on the card: each key in shard ``key % 4``, the union the
   source's. (d) one table's Adam ``m`` written by ``write_bundle`` as a
   slot KvVariable and ``attach_slot_rows``: the source's slot rows. (e)
   ``export_for_serving(format="tfplus")`` then ``import_checkpoint``: the
   native export's ``load_for_serving`` predictions. (f) the CRC32C helper
   against its table loop on the export's data file.

Each path (the serving and training paths, the flash entry points, the
compactor entry point, the growth, checkpoint and repartition paths, and
the serving-API, int8, table-op and CTR-model paths, the Criteo-fed DCN, the
multi-table and per-table steps, the hybrid tier, the sharded DLRM, the
two ranks' legs, the remote-storage legs, the traced window, the twins and
the TFPlus bridge's legs) runs with the kernels' launch counts set to 0
just before it and read just after it, and each phase prints its checks'
outcomes and its launches where it runs. Each phase frees its tables before the next and prints the peak
device memory it reached. The line before the last is the
``{"kernels": [...]}`` JSON: per kernel its time, bound, plain version's
and library call's times at its main case, its launches on all the paths
above, and ``launches_phases_23_24``, ``launches_phases_25_27`` and
``launches_phase_28``, its launches on those phases' paths. The last line
is ``{"ok": true, "device": {...}}``. Without a card, or without the port
beside it, the script exits non-zero and prints no result.
"""
import argparse
import contextlib
import copy
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
TRAIN_STEPS = 10                 # counted training steps, after 2 others
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
    at one shape and rerun them bit for bit; time kernel, plain version and
    the one-call library yardstick, and record the launch plan each took.
    Bounds count each index read once, each distinct source row read once
    and each output row written once."""
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
    # the kernel and the library call take turns
    times = time_turns(torch, {
        "gather": lambda: rowops.gather_rows(values, gidx),
        "gather_library": lambda: torch.index_select(
            values, 0, gidx.clamp(0, C_ROWS - 1))})
    out["gather_plain_ms"] = time_ms(
        torch, lambda: rowops.gather_rows_plain(values, gidx))
    out["gather_bound_ms"] = bound_ms(n * 4 + n_rows_read * row_bytes
                                      + n * row_bytes)
    target = values.clone()
    times.update(time_turns(torch, {
        "scatter": lambda: rowops.scatter_rows(target, sidx, rows),
        "scatter_library": lambda: target.index_copy_(0, kept_idx,
                                                      kept_rows)}))
    out["scatter_plain_ms"] = time_ms(
        torch, lambda: rowops.scatter_rows_plain(target, sidx, rows))
    out["scatter_bound_ms"] = bound_ms(n * 4 + 2 * n_kept * row_bytes)
    times.update(time_turns(torch, {
        "scatter_add": lambda: rowops.scatter_rows(target, sidx, rows,
                                                   add=True),
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


# the claim phase's shapes: (capacity, resident keys, ids, fresh share)
CLAIM_SHAPES = {"dcn_lookup": (1 << 20, 1 << 18, BATCH, 0.05),
                "bst_item_lookup": (1 << 23, 1 << 21, 6 * BATCH, 0.05),
                "dcn_load": (1 << 20, 0, 1 << 18, 1.0)}
CLAIM_DIM = 64


def claim_case(torch, np, kv, name, capacity, resident, n, fresh, reps=9):
    """One claim-phase shape: the kernel and the Python rounds on copies
    of one header (header, ``placed`` and counters bit for bit), both
    timed from a cold L2 on the header as it was, the kernel as the path
    calls it (at a lookup with the init pool and staging rows, at a load
    without), and at a lookup the payload a card ``lookup_or_insert``
    leaves."""
    from tfplus_tpu_torch.kv import hashing
    from tfplus_tpu_torch.kv import table as kt
    from tfplus_tpu_torch.ops import claim, rowops
    from tfplus_tpu_torch.utils import profiling
    rng = np.random.RandomState(sorted(CLAIM_SHAPES).index(name) + 1)
    t = kv.create(CLAIM_DIM, capacity, init_pool_rows=10000, seed=1,
                  device=DEV)
    keys = rng.permutation(np.unique(rng.randint(
        1, 1 << 62, resident + n + 64, dtype=np.int64)))
    old, new = keys[:resident], keys[resident:]
    if resident:
        kv.insert(t, hashing.encode_ids(old, device=DEV),
                  torch.zeros((resident, CLAIM_DIM), device=DEV))
    n_new = int(round(n * fresh))
    q = hashing.encode_ids(np.concatenate([old[:n - n_new], new[:n_new]]),
                           device=DEV)
    need = ~kv.find(t, q).found
    header = t.header.clone()

    def rounds(h):
        misses = kt._miss_gate(need)
        return (kt._claim_rounds(h, q, need, misses, 32) if misses
                else torch.full((n,), -1, dtype=torch.int32, device=DEV))

    lookup = resident > 0
    staging = t.payload.new_empty((n, t.payload.shape[1]))

    def kernel(h):
        if lookup:
            return claim.claim_insert(h, q, need, 32, pool=t.init_pool,
                                      rows=staging)
        return claim.claim_insert(h, q, need, 32)

    runs = {}
    for key, fn in (("plain", rounds), ("kernel", kernel)):
        h = header.clone()
        profiling.reset_counters()
        placed = fn(h)
        torch.cuda.synchronize()
        c = profiling.counters()
        runs[key] = (h, placed, [c[k] for k in profiling.DEVICE_COUNTERS])
    (h0, p0, c0), (h1, p1, c1) = runs["plain"], runs["kernel"]
    check(torch.equal(h0, h1), f"claim {name}: the kernel's header differs")
    check(torch.equal(p0, p1), f"claim {name}: the kernel's placed differs")
    check(c0 == c1 and c1[0] == c1[2] + c1[3],
          f"claim {name}: counters differ: {c0} {c1}")
    out = {"ids": n, "listed": c1[0], "rounds": c1[1], "unplaced": c1[3]}
    # each call on the header as it was, restored outside the events
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEV)
    h = header.clone()
    times = {"plain": [], "kernel": []}
    for rep in range(reps):
        turns = [("plain", rounds), ("kernel", kernel)]
        for key, fn in (turns[::-1] if rep % 2 else turns):
            h.copy_(header)
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(h)
            b.record()
            torch.cuda.synchronize()
            times[key].append(a.elapsed_time(b))
    out["ms"] = statistics.median(times["kernel"])
    out["plain_ms"] = statistics.median(times["plain"])
    # the ids, need and placed; each listed key's two header lanes read
    # and written once; at a lookup each placed key's two pool rows read
    # and its staging row written
    row_bytes = (3 * CLAIM_DIM * t.payload.element_size()) if lookup else 0
    out["bound_ms"] = bound_ms(n * (8 + 1 + 4) + c1[0] * 16
                               + c1[2] * row_bytes)
    if lookup:
        # the card's lookup_or_insert: the same placement, and its payload
        # the rows before with the misses' initial rows scattered plainly
        before = t.payload.clone()
        res = kv.lookup_or_insert(t, q)
        torch.cuda.synchronize()
        check(torch.equal(torch.where(need, res.slot, -1), p1),
              f"claim {name}: lookup_or_insert placed otherwise")
        newly = need & (p1 >= 0)
        rowops.scatter_rows_plain(before, torch.where(newly, p1, -1),
                                  kt._init_rows_for(t, q))
        check(torch.equal(before, t.payload),
              f"claim {name}: lookup_or_insert's payload differs")
        out["payload_rows_checked"] = int(newly.sum())
    return out


def claim_phase(torch, np, kv):
    cases = {}
    for name, shape in CLAIM_SHAPES.items():
        cases[name] = c = claim_case(torch, np, kv, name, *shape)
        print("claim case", name, json.dumps(c), flush=True)
        torch.cuda.empty_cache()
    return cases


# the probe phase's shapes: (capacity, resident keys, ids, fresh share)
PROBE_SHAPES = {"dcn_lookup": (1 << 20, 1 << 18, BATCH, 0.05),
                "bst_item_lookup": (1 << 23, 1 << 21, 6 * BATCH, 0.05)}


def probe_case(torch, np, kv, name, capacity, resident, n, fresh):
    """One probe-phase shape: ``find`` on the card (the probe kernel)
    against the plain find on the same card tensors (every output and the
    ``probed``/``found`` counts bit for bit, with and without the pad
    plane), both timed from a cold L2 (the plain version with its two
    count reads)."""
    from tfplus_tpu_torch.kv import hashing
    from tfplus_tpu_torch.kv import table as kt
    from tfplus_tpu_torch.ops import probe
    from tfplus_tpu_torch.utils import profiling
    rng = np.random.RandomState(sorted(PROBE_SHAPES).index(name) + 11)
    t = kv.create(CLAIM_DIM, capacity, init_pool_rows=10000, seed=1,
                  device=DEV)
    keys = rng.permutation(np.unique(rng.randint(
        1, 1 << 62, resident + n + 64, dtype=np.int64)))
    old, new = keys[:resident], keys[resident:]
    kv.insert(t, hashing.encode_ids(old, device=DEV),
              torch.zeros((resident, CLAIM_DIM), device=DEV))
    n_new = int(round(n * fresh))
    q = hashing.encode_ids(np.concatenate([old[:n - n_new], new[:n_new]]),
                           device=DEV)
    valid = torch.from_numpy(rng.rand(n) < 0.95).to(DEV)
    for args in ((None, False), (valid, True)):
        runs = {}
        for key, fn in (("plain", kt._find_plain), ("kernel", kv.find)):
            profiling.reset_counters()
            before = probe.probe.launches
            fr = fn(t, q, args[0], want_pad=args[1])
            torch.cuda.synchronize()
            c = profiling.counters()
            runs[key] = (fr, (c["probed"], c["found"]),
                         probe.probe.launches - before)
        (f0, c0, l0), (f1, c1, l1) = runs["plain"], runs["kernel"]
        check(l0 == 0 and l1 == 1,
              f"probe {name}: launches plain {l0}, kernel {l1}")
        for field, a, b in zip(kt.FindResult._fields, f0, f1):
            check((a is None and b is None) or (
                a.dtype == b.dtype and torch.equal(a, b)),
                f"probe {name}: the kernel's {field} differs")
        check(c0 == c1 and c1[1] <= c1[0],
              f"probe {name}: counts differ: {c0} {c1}")
        if args[0] is None:
            probed, found = c1
    times = time_turns(torch, {"kernel": lambda: kv.find(t, q),
                               "plain": lambda: kt._find_plain(t, q)})
    # each key's words, its two buckets' key and meta planes read once,
    # slot, found, insert slot and meta written once
    nbytes = n * (8 + 2 * 3 * 64 + 4 + 1 + 4 + 8)
    out = {"ids": n, "capacity": capacity, "probed": probed, "found": found,
           "ms": times["kernel"], "plain_ms": times["plain"],
           "bound_ms": bound_ms(nbytes)}
    del t
    return out


def probe_phase(torch, np, kv):
    cases = {}
    for name, shape in PROBE_SHAPES.items():
        cases[name] = c = probe_case(torch, np, kv, name, *shape)
        print("probe case", name, json.dumps(c), flush=True)
        torch.cuda.empty_cache()
    return cases


def _wrappers():
    from tfplus_tpu_torch.ops import claim, compactor, probe, rowops
    from tfplus_tpu_torch.ops import flash_attention as fa
    return {"gather_rows": rowops.gather_rows,
            "scatter_rows": rowops.scatter_rows,
            "claim_insert": claim.claim_insert,
            "probe": probe.probe,
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


@contextlib.contextmanager
def not_path(tally):
    """Add the launches made inside the block to ``tally``: a leg's
    references, checks and their set-up, which :func:`leg` takes off the
    leg's count."""
    before = read_launches()
    try:
        yield
    finally:
        after = read_launches()
        for k in after:
            tally[k] = tally.get(k, 0) + after[k] - before[k]


@contextlib.contextmanager
def collective_bytes(tally):
    """Add to ``tally['bytes']`` the size of every tensor this process hands
    to ``all_to_all_single``, ``all_reduce`` and ``all_gather`` inside the
    block (the tensor it sends; in a world of 1 no byte crosses a link)."""
    import torch.distributed as dist
    sent = {"all_to_all_single": 1, "all_reduce": 0, "all_gather": 1}
    saved = {n: getattr(dist, n) for n in sent}

    def counted(name):
        def call(*args, **kw):
            x = args[sent[name]]
            tally["bytes"] = tally.get("bytes", 0) + x.numel() \
                * x.element_size()
            return saved[name](*args, **kw)
        return call
    for n in sent:
        setattr(dist, n, counted(n))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def route_of(fn, call):
    """Run ``call`` and return the route ``fn`` (a routed wrapper) took."""
    before = [getattr(fn, f"{r}_launches") for r in ROUTES]
    out = call()
    taken = [r for r, b in zip(ROUTES, before)
             if getattr(fn, f"{r}_launches") > b]
    check(len(taken) == 1, f"{fn.__name__}: expected one routed launch")
    return taken[0], out


def embedding_serving_phase(torch, np, kv, hashing):
    """The bench's serving-leg shape: dim 128, 1M rows, 32k ids."""
    rng = np.random.RandomState(SEED)
    ids = rng.permutation(np.unique(rng.randint(0, 1 << 40, N_IDS + 4096,
                                                dtype=np.int64)))[:N_IDS]
    reset_launches()
    t = kv.create(128, C_ROWS, max_probes=16, seed=SEED, device=DEV)
    q = kv.encode_ids(ids, device=DEV)
    res = kv.lookup_or_insert(t, q)
    t = res.table
    a = kv.lookup_or_zeros(t, q)
    b = kv.lookup_or_zeros(t, q.flip(0))
    torch.cuda.synchronize()
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
    print(f"embedding serving: lookup_or_insert and two lookup_or_zeros of "
          f"{N_IDS} ids, dim 128, {C_ROWS} rows; launches "
          f"{json.dumps(launches)}", flush=True)
    del t, res
    torch.cuda.empty_cache()
    return launches


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


def dcn_serving_phase(torch, np, kv, embedding, models, rowops):
    """Reference-width DCN: fill 26 tables, then serve batch-2048 requests."""
    model = models.DCN(capacity=C_ROWS)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    rng = np.random.RandomState(SEED + 1)
    tables_keys = {
        f"C{i + 1}": rng.permutation(np.unique(rng.randint(
            0, 1 << 40, FILL + FILL // 8, dtype=np.int64)))[:FILL]
        for i in range(len(model.embedding_dims))}

    reset_launches()
    state = models.init_state(model, seed=SEED, device=DEV)
    rows_in = {}
    for name in sorted(state.tables):
        t = state.tables[name]
        rows_in[name] = torch.randn(FILL, t.dim, device=DEV, generator=gen)
        kv.insert(t, kv.encode_ids(tables_keys[name], device=DEV),
                  rows_in[name], day=1)
    torch.cuda.synchronize()
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
    step(state, batches[0])            # the first request, not counted
    torch.cuda.synchronize()
    gather1 = rowops.gather_rows.launches
    outs = [step(state, b)[1:] for b in batches[1:]]
    torch.cuda.synchronize()
    launches = read_launches()
    per_request = (launches["gather_rows"] - gather1) / REQUESTS

    payload_gb = sum(t.payload.numel() * t.payload.element_size()
                     for t in state.tables.values()) / 1e9
    print(f"DCN fill: {len(state.tables)} tables x {C_ROWS} rows "
          f"({payload_gb:.3f} GB payload), {FILL} keys each; launches "
          f"{json.dumps(fill_launches)}", flush=True)
    check(launches["gather_rows"] > 0 and launches["scatter_rows"] > 0,
          f"DCN path did not launch both kernels: {launches}")
    for loss, preds in outs:
        check(preds.shape == (BATCH,) and bool(torch.isfinite(preds).all())
              and bool(torch.isfinite(loss)), "DCN: non-finite output")

    # the second request against a host-side map of what was inserted
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
    print(f"DCN serving: {REQUESTS} requests of batch {BATCH}, "
          f"{per_request:.1f} gathers per request; launches "
          f"{json.dumps(launches)}", flush=True)
    return launches


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
    bit."""
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
    # the dispatch takes the tensor cores; forced here)
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


def flash_path_phase(torch, fa, bench):
    """The public entry points at the bench's shape (causal bf16 B4 H8
    S2048 D128): ``flash_attention`` and ``flash_attention_with_lse``."""
    q, k, v, kernel_out = bench
    reset_launches()
    out = fa.flash_attention(q, k, v, causal=True)
    out2, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches["flash_fwd"] == 2 and launches["flash_fwd.tc"] == 2
          and launches["flash_fwd_single"] == 0,
          f"flash entry points did not launch the tensor-core tiled kernel: "
          f"{launches}")
    check(torch.equal(out, kernel_out) and torch.equal(out2, kernel_out)
          and bool(torch.isfinite(lse).all()),
          "flash entry points differ from the checked kernel output")
    print(f"flash entry points: flash_attention and "
          f"flash_attention_with_lse, causal bf16 B4 H8 S2048 D128; launches "
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
                         ref_fn, embs, tf32_control):
    """Serve the requests with the launch counts reset just before, then
    check the second request against the float64 reference."""
    reset_launches()
    outs = [step(state, b)[1:] for b in batches][1:]
    torch.cuda.synchronize()
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
    per_request = {k: v / len(batches) for k, v in launches.items()}
    print(f"{name} serving: {len(batches)} requests of batch {BATCH}; "
          f"kernel launches per request {json.dumps(per_request)}",
          flush=True)
    return launches


def sequence_serving_phase(torch, np, kv, embedding, models):
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
    state = models.init_state(bst, seed=SEED, device=DEV)
    rows_in = {}
    for name in sorted(state.tables):
        t = state.tables[name]
        rows_in[name] = torch.randn(fills[name], t.dim, device=DEV,
                                    generator=gen)
        kv.insert(t, kv.encode_ids(keys[name], device=DEV), rows_in[name],
                  day=1)
    torch.cuda.synchronize()
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
          f"header); launches "
          f"{json.dumps(fill_launches)}", flush=True)
    batches = [sequence_batch(np, models, rng, keys, resident)
               for _ in range(SEQ_REQUESTS + 1)]

    # the second request's rows against the host-side map
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

    bst_step = models.make_train_step(bst, train=False)
    bst_launches = launches = serve_sequence_model(
        torch, np, "BST", bst, bst_step, state, batches, bst_reference, embs,
        tf32_control=True)
    check(launches["flash_fwd_single"] >= len(batches)
          and launches["flash_fwd"] == 0 and launches["gather_rows"] > 0,
          f"BST path: expected flash_fwd_single on every request, no "
          f"flash_fwd, and row gathers: {launches}")
    din_state = models.TrainState(
        tables=state.tables, opt_state=None, step=state.step,
        dense=din.init_dense(torch.Generator().manual_seed(SEED), DEV))
    din_step = models.make_train_step(din, train=False)
    launches = serve_sequence_model(torch, np, "DIN", din, din_step,
                                    din_state, batches, din_reference, embs,
                                    tf32_control=False)
    check(launches["gather_rows"] > 0 and launches["flash_fwd"] == 0
          and launches["flash_fwd_single"] == 0,
          f"DIN path: expected row gathers and no attention: {launches}")
    del state, din_state, rows_in
    torch.cuda.empty_cache()
    return [fill_launches, bst_launches, launches]


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
    backward. ``seg`` is one id array for q and kv, or a ``(q_seg, kv_seg)``
    pair."""
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


def flash_grad_path_phase(torch, fa, bench, bench_grads):
    """``flash_attention(causal=True)`` forward and backward at the bench's
    shape."""
    do, dq, dk, dv = bench_grads
    leaves = [t.detach().clone().requires_grad_() for t in bench[:3]]
    reset_launches()
    out = fa.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    launches = read_launches()
    check(all(launches[k] == 1 for k in (
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd.tc",
        "flash_bwd_dkv.tc", "flash_bwd_dq.tc")),
          f"flash gradients did not launch the tensor-core kernels: "
          f"{launches}")
    check(all(torch.equal(g, w) for g, w in zip(grads, (dq, dk, dv))),
          "flash_attention's gradients differ from the checked kernels'")
    print(f"flash gradients: flash_attention forward and backward, causal "
          f"bf16 B4 H8 S2048 D128; launches {json.dumps(launches)}",
          flush=True)
    return launches


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


def train_path(torch, name, step, state, batches, per_step):
    """Two first steps, then the counted ones; the launch counts are reset
    by the caller before the tables were filled."""
    for b in batches[:2]:
        state, loss, _ = step(state, b)
    torch.cuda.synchronize()
    before = read_launches()
    losses = []
    for b in batches[2:]:
        state, loss, preds = step(state, b)
        losses.append(loss)
    torch.cuda.synchronize()
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
    print(f"{name} training: {n} steps of batch {BATCH}, loss "
          f"{float(losses[0]):.6f} -> {float(losses[-1]):.6f}; kernel "
          f"launches per step {json.dumps(steps)}", flush=True)
    return state, after


def dcn_training_phase(torch, np, kv, models, train):
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
    state = models.init_state(model, opt,
                              functools.partial(torch.optim.Adam, lr=1e-3),
                              seed=SEED, device=DEV)
    resident = fill_tables(torch, np, kv, state, keys, gen)
    payload_gib = sum(t.payload.numel() * t.payload.element_size()
                      for t in state.tables.values()) / 2 ** 30
    print(f"DCN training fill: 26 tables x {C_ROWS} rows x 4·D "
          f"({payload_gib:.3f} GiB payload), {FILL} keys each",
          flush=True)
    batches = [dcn_batch(np, rng, keys, resident, BATCH)
               for _ in range(TRAIN_STEPS + 2)]
    step = models.make_train_step(model, opt, sparse_lr=1e-3)
    state, launches = train_path(torch, "DCN", step, state, batches,
                                 {"flash_fwd": 0})
    del state
    peak_memory(torch, "DCN training")
    return launches


def bst_training_phase(torch, np, kv, models, train):
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
    state, launches = train_path(
        torch, "BST", step, state, batches,
        {"flash_fwd_single": blocks, "flash_bwd_single": blocks,
         "flash_bwd_dkv": 0, "flash_bwd_dq": 0, "flash_fwd": 0})
    del state
    peak_memory(torch, "BST training")
    return launches


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


def run_steps(models, model, opt, lr, state, batches, multi=False):
    """Train on ``batches`` (the multi-table step with ``multi``):
    ``(state, losses, the dense gradients of the first step)``."""
    make = models.make_train_step_multi if multi else models.make_train_step
    step = make(model, opt, sparse_lr=lr)
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


def batch_keys(torch, np, kv, model, batches, name, dev):
    """The encoded keys ``batches`` looked up in table ``name``: a group's
    tagged keys, logical table by logical table, for a multi-table
    state's ``__group_<dim>``."""
    alias = getattr(model, "id_alias", {})

    def ids(n):
        return np.concatenate([b["ids"][alias.get(n, n)] for b in batches])
    if not name.startswith("__group_"):
        return kv.encode_ids(ids(name), device=dev)
    return torch.cat([kv.tag_ids(kv.encode_ids(ids(n), device=dev), j)
                      for j, n in enumerate(group_names(model)[name])])


def group_names(model):
    """{group table name: its logical tables in order} of a multi-table
    state for ``model``."""
    from tfplus_tpu_torch.models import common
    return {f"__group_{dim}": names
            for dim, names in common._dim_groups(model).items()}


def card_against_cpu(torch, np, kv, models, convert, model, opt, lr,
                     dense_lr, init, tx, batches, multi=False, runner=None):
    """``batches`` of training steps from ``init`` (a CPU state) on the CPU
    and on the card (the multi-table step with ``multi``): headers and the
    batches' slots bit for bit, losses and step 1's dense gradients within
    ``TRAIN_TOL``, the placed rows and the dense parameters within its
    tight limits on all but a share of elements and within a step's
    learning rate per step everywhere. ``runner`` takes ``run_steps``'s
    place (the sharded step's). Returns the comparison and raises if it
    fails."""
    states, losses, grads = {}, {}, {}
    for dev in ("cpu", DEV):
        states[dev], losses[dev], grads[dev] = (runner or run_steps)(
            models, model, opt, lr,
            copy_state(torch, convert, models, init, dev, tx), batches,
            multi)
    (tc, pc), (tg, pg) = (state_arrays(torch, states[d])
                          for d in ("cpu", DEV))

    def slots(dev, n):
        return kv.find(states[dev].tables[n], batch_keys(
            torch, np, kv, model, batches, n, dev)).slot.cpu()

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
    peak_memory(torch, "compactor")
    return launches, cases, timing


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
                            tbundle, rowops):
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
        for i in range(1, GROW_STEPS + 1):
            caps = {n: t.capacity for n, t in state.tables.items()}
            state = models.grow_if_needed(state, BATCH)
            out["grows"] += sum(state.tables[n].capacity != c
                                for n, c in caps.items())
            state, loss, _ = step(state, batches[i - 1])
            if i in GROW_SAVES:
                full = i == GROW_SAVES[0]
                tables = mgr.save(state.tables, state.dense, step=i,
                                  full=full)
                state = state._replace(tables=tables)
                kind = "full" if full else "delta"
                out["saves"][f"{kind}@{i}"] = payload_bytes(
                    tbundle, os.path.join(workdir, "ckpts",
                                          f"ckpt-{kind}-{i}"))
        caps = {n: t.capacity for n, t in state.tables.items()}
        # "crash": a second manager restores into fresh 2^14-row templates
        dense = model.init_dense(torch.Generator().manual_seed(SEED + 31),
                                 DEV)
        templates = model.init_tables(opt, seed=SEED + 32, device=DEV)
        restored, dense, at = checkpoint.CheckpointManager(
            os.path.join(workdir, "ckpts")).restore(templates, dense)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    out.update({
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
    del state, resumed, restored, templates
    peak_memory(torch, "growth/checkpoint/resume")
    return launches


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
    return launches


def reference_growth_phase(torch, np, kv, train, packing, rowops):
    """One dim-128 GroupAdam table (payload 4·128 f32) at 2^20 rows holding
    2^19 keys, with random values, slot columns and meta words written by
    ``insert_raw``: ``grow`` to 2^21, then ``compact`` after deleting a
    third of the keys. Each is checked to keep every row (size, and each
    key's full payload row and meta word)."""
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
    out = {"rows": n0, "row_bytes": w * 4}
    torch.cuda.synchronize()
    reset_launches()
    g = kv.grow(t, 2 * C_ROWS)
    torch.cuda.synchronize()
    out["grow_launches"] = read_launches()
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
    c = kv.compact(g)
    torch.cuda.synchronize()
    out["compact_launches"] = read_launches()
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
    peak_memory(torch, "reference-size growth")
    return launches


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
        state = models.init_state(model, seed=SEED, device=DEV)
        rows_in = {}
        for name in sorted(state.tables):
            rows_in[name] = torch.randn(DLRM_FILL, 16, device=DEV,
                                        generator=gen)
            kv.insert(state.tables[name],
                      kv.encode_ids(keys[name], device=DEV), rows_in[name],
                      day=1)
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
        outs = [step(state, b)[1:] for b in batches][1:]
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
        prefix = serving.export_for_serving(export_dir, state.tables, md)
        out["export_payload_bytes"] = payload_bytes(tbundle, prefix)
        loaded, _ = serving.load_for_serving(export_dir, device=DEV)
        loaded_q, _ = serving.load_for_serving(export_dir, quantize=True,
                                               device=DEV)
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
        checkpoint.save(delta, state.tables, delta=True)
        # a refresh reads the delta's values, not its slot columns
        out["delta_values_bytes"] = payload_bytes(tbundle, delta, slots=False)
        loaded = serving.refresh_from_delta(loaded, delta)
        loaded_q = serving.refresh_from_delta(loaded_q, delta, quantize=True)
        torch.cuda.synchronize()
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
    print(f"DLRM serving API: {json.dumps(out)}", flush=True)
    peak_memory(torch, "DLRM serving API")
    return out["launches"]


def int8_lookup_and_table_ops_phase(torch, np, kv, quant, embedding,
                                    convert):
    """(b) The JAX bench's serving-leg shape: a 2^20-row dim-128 table
    filled with 32,768 ids, quantized, and ``quant.lookup_or_zeros`` of the
    ids against the CPU's and within the bound of ``kv.lookup_or_zeros``
    on the same table. (c) On that table, each of the 7 scatter
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
    out = {}
    reset_launches()
    t = kv.create(128, C_ROWS, max_probes=16, seed=SEED, device=DEV)
    q = kv.encode_ids(ids, device=DEV)
    check(not bool(kv.lookup_or_insert(t, q, day=100).overflow),
          "int8 leg: the fill overflowed")
    cpu = dataclasses.replace(t, **{f: getattr(t, f).to("cpu", copy=True)
                                    for f in convert.TABLE_FIELDS})
    qt = quant.quantize_table(t)
    qt_cpu = quant.quantize_table(cpu)
    check(torch.equal(qt.header.cpu(), qt_cpu.header)
          and torch.equal(qt.payload.cpu(), qt_cpu.payload),
          "int8 leg: quantize_table on the card differs from the CPU's")
    full = kv.lookup_or_zeros(t, q)
    got = quant.lookup_or_zeros(qt, q)
    torch.cuda.synchronize()
    out["int8_leg_launches"] = read_launches()
    check(torch.equal(got.cpu(), quant.lookup_or_zeros(qt_cpu, q.cpu())),
          "int8 leg: the card's int8 lookup differs from the CPU's")
    check(bool(((got - full).abs() <= quant_bound(torch, full)).all()),
          "int8 leg: int8 rows past max|row|/254")
    out["int8_payload_bytes"] = qt.payload.numel()
    out["f32_payload_bytes"] = t.payload.numel() * 4
    del qt, qt_cpu
    print(f"int8 lookup leg: {json.dumps(out)}", flush=True)

    # (c) the table ops, on the card and on the CPU copy
    gen = torch.Generator().manual_seed(SEED + 61)
    present = ids[:N_IDS // 2]
    reset_launches()
    for k, op in enumerate(("update", "add", "sub", "mul", "div", "min",
                            "max")):
        # fresh ids for every op: disjoint ranges
        new = rng.randint(1 << (41 + k), 1 << (42 + k), N_IDS // 2,
                          dtype=np.int64)
        qq = np.concatenate([present, new])
        upd = torch.randn(N_IDS, 128, generator=gen)
        kv.scatter(t, kv.encode_ids(qq, device=DEV), upd.to(DEV), op, day=110)
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
    _, evicted = kv.delete_with_timestamp(t, 5, 110)
    _, evicted_cpu = kv.delete_with_timestamp(cpu, 5, 110)
    check(int(evicted.sum()) == N_IDS // 2
          and int(kv.size(t)) == size_before - N_IDS // 2,
          "table ops: the eviction missed its share")
    check(all(torch.equal(getattr(t, f).cpu(), getattr(cpu, f))
              for f in convert.TABLE_FIELDS) and torch.equal(evicted.cpu(),
                                                     evicted_cpu),
          "table ops: the card's table differs from the CPU's")
    out_ops = {"rows": size_before,
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
            a = run(DEV, t)
            b = run(DEV, t)
            c = run("cpu", cpu)
            scale = float(c.abs().max())
            err = float((a.cpu() - c).abs().max())
            name = f"{combiner}{'_weighted' if weighted else ''}"
            sparse[name] = {"max_abs_err": err, "scale": scale}
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
    peak_memory(torch, "int8 leg, table ops, sparse")
    return out["int8_leg_launches"], out_ops["launches"]


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
    launches = None
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
        _, loss, preds = step(state, b)
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
        del state, init
    check(launches["gather_rows"] > 0 and launches["scatter_rows"] > 0,
          f"CTR models: the row kernels were not launched: {launches}")
    peak_memory(torch, "DeepFM, Wide&Deep, NCF")
    return launches


# ---------------------------------------------------------------------------
# the data feed, the multi-table step and the host-DRAM storage tier
# ---------------------------------------------------------------------------

CRITEO_ROWS = 1 << 18            # lines of the generated Criteo TSV
CRITEO_STEPS = 16                # batch-2048 DCN steps per feed
MULTI_ROWS = {64: 1 << 23, 128: 1 << 22}   # rows of each dim's group
MULTI_FILL = 1 << 18             # keys per logical table
PER_TABLE_ROWS = 1 << 19         # the per-table step's tables, same keys
MULTI_STEPS = 10                 # counted steps and requests of each step
# The hybrid table's device rows: twice its max_live below. At 2^20 rows
# (load 0.5 after each spill) its lookups left 2-24 ids a step unplaced
# from step 30 on, on the card and the CPU alike: the placement (first
# fit over two 16-slot buckets, the JAX package's bit for bit) fills
# single buckets long before the load factor.
HYBRID_ROWS = 1 << 21
HYBRID_BUDGET = 1 << 19          # its max_live
HYBRID_TWIN_ROWS = 1 << 23       # the table that never spills
HYBRID_BATCHES = 64
HYBRID_IDS = 1 << 15             # ids drawn per batch
HYBRID_UNIVERSE = 1 << 22
HYBRID_ZIPF = 1.05


def criteo_tsv(np, rng, rows):
    """A Criteo Kaggle-layout TSV of ``rows`` lines: a 0/1 label, 13 integer
    columns (log-normal counts up to 99,999, the second column -1 to -3 in
    5 % of rows, 10-40 % empty) and 26 categorical columns of 8 hex digits
    (Zipf-skewed per column over vocabularies of 10 to 10^7, 4 % empty).
    Built without a loop over rows: every field right-aligned in a fixed
    width of a byte matrix, padded with 0 bytes, which one mask drops."""
    m = np.zeros((rows, 2 + 13 * 7 + 26 * 9), np.uint8)
    m[:, 0] = ord("0") + rng.randint(0, 2, rows)
    col = 1
    for j in range(13):
        m[:, col] = ord("\t")
        v = np.minimum(np.floor(rng.lognormal(1.0, 1.6, rows)),
                       99999).astype(np.int64)
        neg = (rng.rand(rows) < 0.05) if j == 1 else np.zeros(rows, bool)
        v = np.where(neg, rng.randint(1, 4, rows), v)
        empty = rng.rand(rows) < 0.1 + 0.3 * rng.rand()
        m[:, col + 1] = np.where(neg & ~empty, ord("-"), 0)
        for k in range(5):                   # 10^4 .. 10^0
            p = 10 ** (4 - k)
            pad = empty | ((v < p) & (k < 4))
            m[:, col + 2 + k] = np.where(pad, 0, ord("0") + (v // p) % 10)
        col += 7
    hexd = np.frombuffer(b"0123456789abcdef", np.uint8)
    for j in range(26):
        m[:, col] = ord("\t")
        vocab = int(10 ** rng.uniform(1, 7))
        rank = (rng.zipf(1.05 + 0.5 * rng.rand(), rows) - 1) % vocab
        v = (rank * 0x9E3779B1 + rng.randint(0, 2 ** 31)) & 0xFFFFFFFF
        empty = rng.rand(rows) < 0.04
        for k in range(8):
            m[:, col + 1 + k] = np.where(empty, 0,
                                         hexd[(v >> (4 * (7 - k))) & 15])
        col += 9
    m[:, col] = ord("\n")
    return m[m != 0].tobytes()


def criteo_training_phase(torch, np, kv, models, train, native, criteo,
                          feed):
    """Phase 20: a generated Criteo file through the native and the Python
    parsers, the binary cache and the threaded loader, then the reference
    DCN trained from empty tables on the cache's batches through the
    per-leaf feed and through the packed one, from equal states."""
    check(native.available(), "the native helper library did not build")
    rng = np.random.RandomState(SEED + 90)
    buf = criteo_tsv(np, rng, CRITEO_ROWS)
    out = {"rows": CRITEO_ROWS, "mb": len(buf) / 1e6}
    lib = native.parse_criteo_batch(buf, CRITEO_ROWS + 1)
    py = native.parse_criteo_batch_py(buf, CRITEO_ROWS + 1)
    check(len(lib[2]) == CRITEO_ROWS and lib[3] == len(buf)
          and lib[3] == py[3]
          and all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                  for a, b in zip(lib[:3], py[:3])),
          "Criteo: the library's parse differs from the Python parser's")
    names = [f"C{i + 1}" for i in range(26)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.txt")
        with open(path, "wb") as f:
            f.write(buf)
        cache = criteo.BinaryCriteoCache(
            criteo.build_binary_cache(path, os.path.join(tmp, "c")))
        check(cache.rows == CRITEO_ROWS
              and np.array_equal(cache.categorical[:], lib[1])
              and np.array_equal(cache.numeric[:].view(np.int32),
                                 lib[0].view(np.int32))
              and np.array_equal(cache.label[:], lib[2]),
              "Criteo: the cache differs from the library's parse")
        with native.CriteoLoader(path, BATCH, threads=8) as ld:
            check(sum(len(b[2]) for b in ld) == CRITEO_ROWS,
                  "Criteo: the threaded loader lost rows")

        def host_batch(b):
            pairs = np.asarray(b["categorical"]).view(np.int32).reshape(
                -1, 26, 2)
            return {"ids": {n: pairs[:, j] for j, n in enumerate(names)},
                    "features": b["numeric"], "labels": b["label"]}
        first = next(cache.batches(BATCH))
        pack, unpack = feed.make_packed_feed(host_batch(first), device=DEV)

        def leaves(b):            # 26 id columns, features, labels
            hb = host_batch(b)
            return [np.array(v) for v in
                    [hb["ids"][n] for n in names]
                    + [hb["features"], hb["labels"]]]

        def leaf_feed(b):         # one pageable copy per leaf
            out = [torch.from_numpy(x).to(DEV) for x in leaves(b)]
            return {"ids": dict(zip(names, out[:26])), "features": out[26],
                    "labels": out[27]}

        def packed_feed(b):       # one pinned buffer, one async copy
            return unpack(pack(host_batch(b)).to(DEV, non_blocking=True))

        batches = list(cache.batches(BATCH, max_batches=CRITEO_STEPS))
        model = models.DCN(capacity=C_ROWS)
        opt = train.GroupAdamOptimizer()
        tx = functools.partial(torch.optim.Adam, lr=1e-3)
        feeds = {"per_leaf": leaf_feed, "packed": packed_feed}
        ref = None
        reset_launches()
        # per-leaf, packed, packed, per-leaf, all from equal (empty)
        # states; every run must give the first run's bits
        for name in ("per_leaf", "packed", "packed", "per_leaf"):
            fn = feeds[name]
            state = models.init_state(model, opt, tx, seed=SEED + 91,
                                      device=DEV)
            step = models.make_train_step(model, opt, sparse_lr=1e-3)
            losses = []
            for b in batches:
                state, loss, _ = step(state, fn(b))
                losses.append(loss)
            run = (torch.stack(losses).cpu(),
                   {n: (t.header.clone(), t.payload[kv.occupied_mask(t)])
                    for n, t in state.tables.items()})
            if ref is None:
                ref = run
                out["loss_first_last"] = [float(losses[0]),
                                          float(losses[-1])]
                out["rows_per_table"] = int(run[1]["C1"][1].shape[0])
            out.setdefault("losses_bit_identical", True)
            out.setdefault("tables_bit_identical", True)
            out["losses_bit_identical"] &= torch.equal(run[0], ref[0])
            out["tables_bit_identical"] &= all(
                torch.equal(x, y) for n in ref[1]
                for x, y in zip(run[1][n], ref[1][n]))
            del state, step, losses, run
            torch.cuda.empty_cache()
    launches = read_launches()
    out["row_kernel_launches"] = {k: launches[k] for k in
                                  ("gather_rows", "scatter_rows")}
    del ref
    print("Criteo to DCN:", json.dumps(out), flush=True)
    peak_memory(torch, "Criteo to DCN training")
    check(out["losses_bit_identical"] and out["tables_bit_identical"],
          f"Criteo: the two feeds trained differently: {out}")
    check(launches["gather_rows"] > 0 and launches["scatter_rows"] > 0,
          f"Criteo: the row kernels were not launched: {launches}")
    return launches


def multi_table_phase(torch, np, kv, models, train, convert):
    """Phase 21: the multi-table step at the reference DCN's widths: card
    against CPU and a rerun on 2^14-row groups; then groups of 2^23 (dim
    64) and 2^22 (dim 128) rows, each logical table filled with 2^18 keys,
    serving and training beside the per-table step on 2^19-row tables
    holding the same keys and rows."""
    model = models.DCN(capacity=PER_TABLE_ROWS)
    opt = train.GroupAdamOptimizer()
    tx = functools.partial(torch.optim.Adam, lr=1e-3)
    rng = np.random.RandomState(SEED + 100)
    out = {}
    reset_launches()
    universe = {n: rng.randint(0, 1 << 40, 4000, dtype=np.int64)
                for n in model.table_specs}

    def check_batch(b):
        return dcn_batch(np, rng, universe,
                         {n: np.arange(4000) for n in universe}, b,
                         unseen=0.0)
    init = models.init_state_multi(model, opt, tx, seed=SEED + 100,
                                   capacity_per_group=CHECK_ROWS,
                                   device="cpu")
    c = card_against_cpu(torch, np, kv, models, convert, model, opt, 1e-3,
                         1e-3, init, tx, [check_batch(CHECK_BATCH)
                                          for _ in range(CHECK_STEPS)],
                         multi=True)
    batches = [check_batch(BATCH) for _ in range(CHECK_STEPS)]
    reruns = [state_arrays(torch, run_steps(
        models, model, opt, 1e-3,
        copy_state(torch, convert, models, init, DEV, tx), batches,
        multi=True)[0]) for _ in range(2)]
    c["rerun_bit_identical"] = (
        all(torch.equal(x, y) for n in reruns[0][0]
            for x, y in zip(reruns[0][0][n], reruns[1][0][n]))
        and all(torch.equal(reruns[0][1][k], reruns[1][1][k])
                for k in reruns[0][1]))
    del reruns, init
    print("multi-table checks:", json.dumps(c), flush=True)
    check(c["rerun_bit_identical"],
          "multi-table: two runs of the same steps differ on the card")
    out["checks"] = c

    keys = {n: rng.permutation(np.unique(rng.randint(
        0, 1 << 40, MULTI_FILL + MULTI_FILL // 8, dtype=np.int64)))[
            :MULTI_FILL] for n in model.table_specs}
    gen = torch.Generator(device=DEV).manual_seed(SEED + 101)
    rows_in = {n: torch.randn(MULTI_FILL, spec["dim"], device=DEV,
                              generator=gen)
               for n, spec in sorted(model.table_specs.items())}
    groups = group_names(model)
    state = models.init_state_multi(model, opt, tx, seed=SEED + 101,
                                    capacity_per_group=MULTI_ROWS[128],
                                    device=DEV)
    state.tables["__group_64"] = kv.grow(state.tables["__group_64"],
                                         MULTI_ROWS[64])
    resident = {}
    for g, names in groups.items():
        for j, n in enumerate(names):
            q = kv.tag_ids(kv.encode_ids(keys[n], device=DEV), j)
            kv.insert(state.tables[g], q, rows_in[n], day=1)
            found = kv.find(state.tables[g], q).found.cpu().numpy()
            check(found.mean() > 0.999, f"multi fill: {n} placed too few")
            resident[n] = np.nonzero(found)[0]
    out["payload_gb"] = sum(t.payload.numel() * t.payload.element_size()
                            for t in state.tables.values()) / 1e9
    out["group_rows"] = {g: t.capacity for g, t in state.tables.items()}
    print(f"multi-table fill: {out['payload_gb']:.3f} GB of payload in "
          f"{json.dumps(out['group_rows'])} rows, {MULTI_FILL} keys per "
          f"logical table", flush=True)
    requests = [dcn_batch(np, rng, keys, resident, BATCH)
                for _ in range(MULTI_STEPS + 1)]
    steps = [dcn_batch(np, rng, keys, resident, BATCH)
             for _ in range(MULTI_STEPS + 2)]

    def measure(name, state, serve, step):
        """The requests and then the steps (``train_path``): the row
        kernels' launches per request, and the second request's
        predictions."""
        serve(state, requests[0])
        torch.cuda.synchronize()
        before = read_launches()
        preds = [serve(state, b)[2] for b in requests[1:]]
        torch.cuda.synchronize()
        after = read_launches()
        per_request = {k: (after[k] - before[k]) / MULTI_STEPS
                       for k in ("gather_rows", "scatter_rows")}
        train_path(torch, name, step, state, steps, {"flash_fwd": 0})
        return per_request, preds[0]

    serve = models.make_train_step_multi(model, train=False)
    # the first request against a host-side map of what was inserted
    b = requests[1]
    embs = {}
    for g, names in groups.items():
        for j, n in enumerate(names):
            order = resident[n][np.argsort(keys[n][resident[n]])]
            ref = host_rows(torch, np, keys[n], order, rows_in[n],
                            b["ids"][n])
            got = kv.lookup_or_zeros(state.tables[g], kv.tag_ids(
                kv.encode_ids(b["ids"][n], device=DEV), j))
            check(torch.equal(got, ref),
                  f"multi-table: {n} rows differ from the inserted rows")
            embs[n] = ref.cpu().numpy()
    _, loss, preds = serve(state, b)
    ref_logits, _, ref_loss = dcn_reference(np, state.dense, embs,
                                            b["features"], b["labels"])
    out["preds_err_ratio"] = err_ratio(np, preds, ref_logits)
    check(out["preds_err_ratio"] <= 1
          and abs(float(loss) - float(ref_loss))
          <= F32_RTOL * max(1.0, abs(float(ref_loss))),
          f"multi-table: serving differs from the float64 reference: {out}")
    out["multi_row_launches_per_request"], multi_preds = measure(
        "DCN_multi", state, serve,
        models.make_train_step_multi(model, opt, sparse_lr=1e-3))
    launches = read_launches()
    # the groups' headers, to compare placement with the per-table fill
    multi_tables = {g: dataclasses.replace(t, payload=t.payload[:1].clone())
                    for g, t in state.tables.items()}
    del state
    peak_memory(torch, "multi-table step")

    state = models.init_state(model, opt, tx, seed=SEED + 101, device=DEV)
    both = np.ones(BATCH, bool)    # rows whose ids both fills placed alike
    for g, names in groups.items():
        for j, n in enumerate(names):
            t = state.tables[n]
            q = kv.encode_ids(keys[n], device=DEV)
            kv.insert(t, q, rows_in[n], day=1)
            check(kv.find(t, q).found.float().mean() > 0.999,
                  f"per-table fill: {n} placed too few rows")
            ids = kv.encode_ids(b["ids"][n], device=DEV)
            both &= (kv.find(t, ids).found == kv.find(
                multi_tables[g], kv.tag_ids(ids, j)).found).cpu().numpy()
    del multi_tables
    reset_launches()
    out["per_table_row_launches_per_request"], per_table_preds = measure(
        "DCN_per_table", state, models.make_train_step(model, train=False),
        models.make_train_step(model, opt, sparse_lr=1e-3))
    per_table = read_launches()
    launches = {k: launches[k] + per_table[k] for k in launches}
    # the same rows and dense weights: the same predictions wherever both
    # fills placed the request's ids alike (an insert may drop a key whose
    # two buckets are full, a handful per table at these loads)
    keep = torch.from_numpy(both).to(DEV)
    out["serving_rows_compared"] = int(both.sum())
    out["serving_preds_equal_per_table"] = torch.equal(
        multi_preds[keep], per_table_preds[keep])
    del state, rows_in
    out["row_kernel_launches"] = {k: launches[k] for k in
                                  ("gather_rows", "scatter_rows")}
    print("multi-table step:", json.dumps(out), flush=True)
    peak_memory(torch, "per-table step beside it")
    check(out["serving_preds_equal_per_table"],
          "multi-table: serving predictions differ from the per-table step's")
    check(launches["gather_rows"] > 0 and launches["scatter_rows"] > 0,
          f"multi-table: the row kernels were not launched: {launches}")
    return launches


def hybrid_tier_phase(torch, np, kv, train, storage):
    """Phase 22: a dim-128 Adam table of 2^21 rows under a 2^19-row device
    budget with its host tier, fed 64 batches of Zipf(1.05) ids from 2^22,
    against a 2^23-row table that never spills."""
    opt = train.AdamOptimizer()
    rng = np.random.RandomState(SEED + 110)
    perm = rng.permutation(HYBRID_UNIVERSE).astype(np.int64)
    stream = [np.unique(perm[(rng.zipf(HYBRID_ZIPF, HYBRID_IDS) - 1)
                             % HYBRID_UNIVERSE])
              for _ in range(HYBRID_BATCHES)]

    def table(rows):
        return opt.init(kv.create(128, rows, seed=SEED + 111, device=DEV))

    def train_step(t, ids, s):
        res = kv.lookup_or_insert(t, kv.encode_ids(ids, device=DEV), day=1)
        check(not bool(res.overflow),
              f"hybrid: step {s}: {int((res.slot < 0).sum())} of "
              f"{len(ids)} ids not placed in a table of {t.capacity} rows "
              f"holding {int(kv.size(t))}")
        opt.apply(t, res.slot, res.rows * 0.1, lr=0.01, step=s)

    reset_launches()
    ht = storage.HybridTable(table(HYBRID_ROWS), max_live=HYBRID_BUDGET)
    moved = {"prefetch": [], "apply_prefetch": [], "spill": []}
    most_live = 0
    for s, ids in enumerate(stream, start=1):
        moved["prefetch"].append(ht.prefetch(ids))
        train_step(ht.table, ids, s)
        if s < len(stream):
            ht.prefetch_async(stream[s])   # overlaps the step's device work
        moved["apply_prefetch"].append(ht.apply_prefetch())
        moved["spill"].append(ht.maybe_spill())
        live = int(kv.size(ht.table))
        most_live = max(most_live, live)
        check(live <= HYBRID_BUDGET,
              f"hybrid: {live} rows on the device after a spill")
    seen = np.unique(np.concatenate(stream))
    out = {"batches": len(stream),
           "unique_ids_per_batch": float(np.mean([len(x) for x in stream])),
           "distinct_ids": int(seen.size), "logical_size": ht.logical_size,
           "most_device_rows_after_spill": most_live,
           "device_capacity": ht.table.capacity,
           "host_tier_rows": ht.tier.size,
           "host_tier_bytes": ht.tier.nbytes,
           "rows_moved_per_step": moved}
    check(out["logical_size"] == out["distinct_ids"],
          f"hybrid: logical size is not the ids seen: {out}")
    check(sum(moved["spill"]) > 0 and sum(moved["prefetch"]) > 0,
          f"hybrid: the stream did not move rows both ways: {out}")
    launches = read_launches()
    out["row_kernel_launches"] = {k: launches[k] for k in
                                  ("gather_rows", "scatter_rows")}

    twin = table(HYBRID_TWIN_ROWS)
    for s, ids in enumerate(stream, start=1):
        train_step(twin, ids, s)
    slot = opt.slot_name
    names = ("keys", "values", "freq_values", f"slot-{slot}")

    def by_key(ex):
        order = np.argsort(ex["keys"])
        return {k: np.asarray(ex[k])[order] for k in names}
    hyb = storage.export_hybrid_arrays(ht.table, ht.tier)
    want = kv.export_arrays(twin)
    fr = kv.find(twin, kv.encode_ids(want["keys"], device=DEV))
    want[f"slot-{slot}"] = kv.get_slot(twin, slot)[fr.slot.long()].cpu(
        ).numpy()
    del twin, fr
    got, want = by_key(hyb), by_key(want)
    out["hybrid_equals_resident"] = all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
        for k in names)
    del want
    tier2 = storage.HostStorageTier(128, 128)
    back = storage.restore_hybrid_split(
        table(HYBRID_ROWS), tier2, hyb, max_live=HYBRID_BUDGET,
        slots={slot: hyb[f"slot-{slot}"]})
    again = by_key(storage.export_hybrid_arrays(back, tier2))
    out["restore_split_equal"] = (
        int(kv.size(back)) == min(seen.size, HYBRID_BUDGET)
        and all(np.array_equal(again[k], got[k]) for k in names))
    del ht, back, tier2, hyb, got, again
    print("hybrid tier:", json.dumps(out), flush=True)
    peak_memory(torch, "host-DRAM tier")
    check(out["hybrid_equals_resident"],
          "hybrid: the spilled table's rows differ from the resident twin's")
    check(out["restore_split_equal"],
          "hybrid: restore_hybrid_split changed rows")
    check(launches["gather_rows"] > 0 and launches["scatter_rows"] > 0,
          f"hybrid: the row kernels were not launched: {launches}")
    return launches


# ---------------------------------------------------------------------------
# the distributed tier (parallel/): phase 23 in this process over NCCL,
# phase 24 in two spawned ranks on the one card over gloo
# ---------------------------------------------------------------------------

SHARD_STEPS = 10                 # counted sharded steps and requests
PAR_TIMEOUT = 480                # seconds for phase 24's two ranks
PAR_ROWS = 1 << 11               # phase 24's DLRM shards, grown past
PAR_BATCH = 256                  # ids per rank and step in phase 24
PAR_STEPS = 10
RING_SHAPE = (4, 8, 2048, 128)   # the bench's flash shape: S 1024 per rank
RING_F32_SHAPE = (2, 4, 256, 32)  # 128-key f32 blocks: single-pass kernels


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_dlrm_step(torch, kv, par, model, opt, lr, state, batch, group):
    """One data-parallel DLRM step over sharded tables: per table (sorted)
    ``sharded_lookup(defer_meta=True)``, the loss, one backward, the dense
    gradients all-reduced (their mean over the group) into the dense
    optimizer's step, then ``sharded_apply_grads`` with the 1-indexed step.
    Returns ``(state, loss, preds, flags)``: flags sums every table's
    route and table overflow flags."""
    import torch.distributed as dist
    dev = state.step.device
    rows, looks = {}, {}
    for name in sorted(state.tables):
        r, st, state.tables[name] = par.sharded_lookup(
            state.tables[name], kv.encode_ids(batch["ids"][name], device=dev),
            group=group, defer_meta=True, day=1)
        rows[name] = r.requires_grad_()
        looks[name] = st
    preds = model.apply(state.dense, rows,
                        torch.as_tensor(batch["features"], device=dev))
    loss = model.loss(preds, torch.as_tensor(batch["labels"], device=dev))
    params = list(state.dense.parameters())
    names = sorted(rows)
    grads = torch.autograd.grad(loss, params + [rows[n] for n in names],
                                allow_unused=True)
    world = dist.get_world_size(group)
    for p, g in zip(params, grads):
        g = torch.zeros_like(p) if g is None else g
        dist.all_reduce(g, group=group)
        p.grad = g / world
    state.opt_state.step()
    step = state.step + 1
    flags = torch.zeros((), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for n, g in zip(names, grads[len(params):]):
            st = looks[n]
            par.sharded_apply_grads(opt, state.tables[n], st, g, group=group,
                                    lr=lr, step=step)
            flags = flags + st.route_overflow.int() + st.table_overflow.int()
    return state._replace(step=step), loss.detach(), preds.detach(), flags


def sharded_runner(torch, kv, par, groups):
    """``run_steps``' counterpart for :func:`card_against_cpu`: the sharded
    step over ``groups[device type]``; checks that no id was dropped."""
    def run(models, model, opt, lr, state, batches, multi=False):
        group = groups[state.step.device.type]
        losses, first = [], None
        for b in batches:
            state, loss, _, flags = sharded_dlrm_step(
                torch, kv, par, model, opt, lr, state, b, group)
            check(int(flags) == 0, "sharded step: an overflow flag is set")
            losses.append(float(loss))
            if first is None:
                first = [p.grad.detach().cpu().clone()
                         for p in state.dense.parameters()]
        return state, losses, first
    return run


def sharded_state(torch, models, par, model, opt, tx, rows, seed, group,
                  device):
    """A DLRM state whose tables are this rank's shards
    (``par.create_sharded`` with the optimizer's slots)."""
    tables = {n: par.init_optimizer_sharded(opt, par.create_sharded(
        spec["dim"], rows, group, device=device, seed=seed + i))
        for i, (n, spec) in enumerate(sorted(model.table_specs.items()))}
    dense = model.init_dense(torch.Generator().manual_seed(seed), "cpu")
    dense = dense.to(device)
    return models.TrainState(tables=tables, dense=dense,
                             opt_state=tx(dense.parameters()),
                             step=torch.zeros((), dtype=torch.int32,
                                              device=device))


def sharded_dlrm_phase(torch, np, kv, quant, models, train, convert):
    """Phase 23: DLRM at the Criteo Kaggle widths over sharded tables in a
    world of 1 over NCCL (this process): the checks at 2^14-row shards
    (card against the same sharded steps on the CPU in a gloo subgroup,
    reruns, a falling loss), then 26 shards of 2^20 rows holding 2^18 keys
    each, 10 counted steps and 10 f32 and int8 requests through
    ``sharded_serving_lookup``."""
    import torch.distributed as dist
    from tfplus_tpu_torch import parallel as par
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    out = {}
    try:
        nccl = dist.group.WORLD
        gloo = dist.new_group(backend="gloo")
        out["backend"] = dist.get_backend(nccl)
        out["check_backend"] = dist.get_backend(gloo)
        check(out["backend"] == "nccl", "phase 23 must run over NCCL")
        model = models.DLRM(**DLRM_CONFIG, capacity=CHECK_ROWS)
        opt = train.GroupAdamOptimizer()
        tx = functools.partial(torch.optim.Adam, lr=1e-3)
        rng = np.random.RandomState(SEED + 230)
        universe = {n: rng.randint(0, 1 << 40, 4000, dtype=np.int64)
                    for n in model.table_specs}

        def check_batch(b):
            return dcn_batch(np, rng, universe,
                             {n: np.arange(4000) for n in universe}, b,
                             unseen=0.0)
        run = sharded_runner(torch, kv, par, {"cpu": gloo, "cuda": nccl})
        init = sharded_state(torch, models, par, model, opt, tx, CHECK_ROWS,
                             SEED + 230, gloo, "cpu")
        c = card_against_cpu(torch, np, kv, models, convert, model, opt,
                             1e-3, 1e-3, init, tx,
                             [check_batch(CHECK_BATCH)
                              for _ in range(CHECK_STEPS)], runner=run)
        batches = [check_batch(BATCH) for _ in range(CHECK_STEPS)]
        reruns = [state_arrays(torch, run(
            models, model, opt, 1e-3,
            copy_state(torch, convert, models, init, DEV, tx),
            batches)[0]) for _ in range(2)]
        c["rerun_bit_identical"] = (
            all(torch.equal(x, y) for n in reruns[0][0]
                for x, y in zip(reruns[0][0][n], reruns[1][0][n]))
            and all(torch.equal(reruns[0][1][k], reruns[1][1][k])
                    for k in reruns[0][1]))
        one = check_batch(BATCH)
        c["loss_on_one_batch"] = run(
            models, model, opt, 1e-3,
            copy_state(torch, convert, models, init, DEV, tx),
            [one] * 10)[1]
        del reruns, init
        print("sharded DLRM checks:", json.dumps(c), flush=True)
        check(c["rerun_bit_identical"],
              "sharded DLRM: two runs of the same steps differ on the card")
        check(c["loss_on_one_batch"][-1] < c["loss_on_one_batch"][0],
              f"sharded DLRM: the loss does not fall: {c}")
        out["checks"] = c

        # full width: 26 shards of 2^20 rows, 2^18 keys each
        model = models.DLRM(**DLRM_CONFIG, capacity=DLRM_ROWS)
        keys = {n: rng.permutation(np.unique(rng.randint(
            0, 1 << 40, DLRM_FILL + DLRM_FILL // 8, dtype=np.int64)))[
                :DLRM_FILL] for n in model.table_specs}
        gen = torch.Generator(device=DEV).manual_seed(SEED + 231)
        state = sharded_state(torch, models, par, model, opt, tx, DLRM_ROWS,
                              SEED + 231, nccl, DEV)
        resident = fill_tables(torch, np, kv, state, keys, gen)
        steps = [dcn_batch(np, rng, keys, resident, BATCH)
                 for _ in range(SHARD_STEPS + 2)]
        reset_launches()
        flags, losses = 0, []
        for b in steps[:2]:
            state, loss, _, f = sharded_dlrm_step(
                torch, kv, par, model, opt, 1e-3, state, b, nccl)
            flags += int(f)
        torch.cuda.synchronize()
        before = read_launches()
        sent = {}
        with collective_bytes(sent):
            for b in steps[2:]:
                state, loss, _, f = sharded_dlrm_step(
                    torch, kv, par, model, opt, 1e-3, state, b, nccl)
                flags = flags + f
                losses.append(loss)
            torch.cuda.synchronize()
        after = read_launches()
        out["flags"] = int(flags)
        check(out["flags"] == 0,
              "sharded DLRM: a route or table overflow flag is set")
        check(all(bool(torch.isfinite(x)) for x in losses),
              "sharded DLRM: non-finite loss")
        out["training"] = {
            "row_kernel_launches_per_step": {
                k: (after[k] - before[k]) / SHARD_STEPS
                for k in ("gather_rows", "scatter_rows")},
            "collective_bytes_sent_per_step": sent["bytes"] / SHARD_STEPS}

        # serving: the trained shards, f32 and int8
        def request(tables, b):
            with torch.no_grad():
                embs = {}
                for n in sorted(tables):
                    embs[n], ovf, _ = par.serving.sharded_serving_lookup(
                        tables[n], kv.encode_ids(b["ids"][n], device=DEV),
                        group=nccl)
                    check(not bool(ovf), "sharded serving: a bucket overflow")
                return model.apply(state.dense, embs, torch.as_tensor(
                    b["features"], device=DEV))

        requests = [dcn_batch(np, rng, keys, resident, BATCH)
                    for _ in range(SHARD_STEPS + 1)]
        qtables = {n: quant.quantize_table(t)
                   for n, t in state.tables.items()}
        for tag, tables in (("f32", state.tables), ("int8", qtables)):
            preds = [request(tables, b) for b in requests]
            check(all(bool(torch.isfinite(p).all()) for p in preds),
                  f"sharded serving ({tag}): non-finite predictions")
        # the path's launches: the steps and the requests, read before the
        # checks below launch row kernels
        out["launches"] = read_launches()
        # served rows equal the trained rows per key
        b = requests[1]
        worst = 0.0
        for n, t in state.tables.items():
            q = kv.encode_ids(b["ids"][n], device=DEV)
            got, _, _ = par.serving.sharded_serving_lookup(t, q, group=nccl)
            check(torch.equal(got, kv.lookup_or_zeros(t, q)),
                  f"sharded serving: {n}'s f32 rows differ from the table's")
            gq, _, _ = par.serving.sharded_serving_lookup(qtables[n], q,
                                                          group=nccl)
            check(torch.equal(gq, quant.lookup_or_zeros(qtables[n], q)),
                  f"sharded serving: {n}'s int8 rows differ from the "
                  "int8 table's")
            full = kv.lookup_or_zeros(t, q)
            err = (gq - full).abs()
            check(bool((err <= quant_bound(torch, full)).all()),
                  f"sharded serving: {n}'s int8 rows past max|row|/254")
            worst = max(worst, float((err / quant_bound(torch, full)
                                      .clamp(min=1e-30)).max()))
        out["serving_int8_err_over_bound"] = worst
        del state, qtables
    finally:
        dist.destroy_process_group()
    print(f"sharded DLRM (NCCL, world 1): {json.dumps(out)}", flush=True)
    peak_memory(torch, "sharded DLRM")
    check(out["launches"]["gather_rows"] > 0
          and out["launches"]["scatter_rows"] > 0,
          f"sharded DLRM: the row kernels were not launched: "
          f"{out['launches']}")
    return out["launches"]


def two_rank_phase(torch):
    """Phase 24: two ranks on the one card over gloo, spawned from this
    script (``--rank-worker``) with a time limit; each runs
    :func:`rank_worker`'s legs and writes its results, which this process
    checks and sums. Two ranks sharing one card time nothing that users
    of several cards see: the legs are checked, not timed."""
    import shutil
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    port = free_port()
    env = dict(os.environ, LOCAL_RANK="0", OMP_NUM_THREADS="4")
    logs = [os.path.join(workdir, f"rank{r}.log") for r in range(2)]
    procs = []
    try:
        for r in range(2):
            with open(logs[r], "wb") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--rank-worker", str(r), "--world", "2", "--dir",
                     workdir, "--port", str(port)],
                    env=env, stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + PAR_TIMEOUT
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, path in enumerate(logs):
        with open(path, errors="replace") as f:
            text = f.read()
        print(f"--- phase 24 rank {r} (rc {procs[r].returncode}) ---\n"
              + text[-6000:], flush=True)
    check(all(p.returncode == 0 for p in procs),
          f"two ranks over gloo: rc {[p.returncode for p in procs]} "
          f"(limit {PAR_TIMEOUT} s)")
    res = []
    for r in range(2):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    shutil.rmtree(workdir, ignore_errors=True)
    launches = {k: sum(x["launches"][k] for x in res)
                for k in res[0]["launches"]}
    out = {"ranks": res, "launches": launches}
    print(f"two ranks over gloo: {json.dumps(out)}", flush=True)
    return launches


def leg(res, name, fn, *args):
    """Run one leg of :func:`rank_worker` with the launch counts set to 0
    before it and read after it (summed into ``res['launches']``); a leg
    returns its results and the launches that were not its path (its
    references, checks and their set-up, tallied by :func:`not_path`),
    which are taken off."""
    reset_launches()
    out, checks = fn(*args)
    after = read_launches()
    res["launches"] = {k: res["launches"].get(k, 0) + after[k]
                       - checks.get(k, 0) for k in after}
    res[name] = out
    print(f"rank leg {name}: {json.dumps(out)}", flush=True)


def ring_allowance(torch, fa, q, k, v, rank, world, sm_scale, causal):
    """How far bf16 roundings may move the ring's output (this rank's rows)
    from one flash_attention over the whole sequence. Both round every p
    to bf16 before its product with v, each at its own running max: half a
    bf16 ulp (2^-8) of p on each side, so 2^-7·Σ p|v|/l between them
    (``reference_attention`` over |v| gives that sum). The ring also rounds
    every block's output to bf16 before the combine: 2^-8 of |out_i|,
    weighted by the block's share l_i·exp(m_i - m)/l of the row. Launches
    made here are checks."""
    n = k.shape[2] // world
    sl = slice(rank * n, (rank + 1) * n)
    pv = fa.reference_attention(q.float(), k.float(), v.float().abs(),
                                causal=causal, sm_scale=sm_scale)[:, :, sl]
    qr = q[:, :, sl].contiguous()
    blocks = []
    for j in range(world):
        if causal and j > rank:
            continue
        kj, vj = (x[:, :, j * n:(j + 1) * n].contiguous() for x in (k, v))
        o, l, m = fa._fwd_dispatch(qr, kj, vj, None, None, 0,
                                   causal and j == rank, sm_scale, 0.0, True)
        blocks.append((o.float().abs(), l, m))
    m_g = torch.stack([m for _, _, m in blocks]).amax(dim=0)
    w = [l * torch.exp(m - m_g) for _, l, m in blocks]
    l_g = sum(w)
    return 2.0 ** -7 * pv + 2.0 ** -8 * sum(
        a * (wi / l_g)[..., None] for (a, _, _), wi in zip(blocks, w))


def ring_leg(torch, np, fa, rank, world):
    """ring_flash_attention at the bench's shape (causal bf16 B4 H8 S2048
    D128, S 1024 per rank) and non-causal f32 B2 H4 S256 D32 (128-key
    blocks: the single-pass kernels), forward and backward, against one
    flash_attention over the whole sequence on this card."""
    from tfplus_tpu_torch.parallel import ring_attention as ra
    out, checks = {}, {}
    for name, shape, dtype, causal in (
            ("bench_causal_bf16", RING_SHAPE, torch.bfloat16, True),
            ("noncausal_f32", RING_F32_SHAPE, torch.float32, False)):
        b, h, s, d = shape
        gen = torch.Generator(device=DEV).manual_seed(SEED + 240)
        q, k, v, do = (torch.randn(b, h, s, d, device=DEV, generator=gen)
                       .to(dtype) for _ in range(4))
        n = s // world
        sl = slice(rank * n, (rank + 1) * n)
        mine = [x[:, :, sl].contiguous().requires_grad_()
                for x in (q, k, v)]
        before = read_launches()
        o = ra.ring_flash_attention(*mine, causal=causal)
        o.backward(do[:, :, sl].contiguous())
        torch.cuda.synchronize()
        after = read_launches()
        path = {kk: after[kk] - before[kk] for kk in after}
        with not_path(checks):
            full = [x.clone().requires_grad_() for x in (q, k, v)]
            of = fa.flash_attention(*full, causal=causal)
            of.backward(do)
            key = _dtype_name(dtype)
            atol, rtol = ATTN_TOL[key]
            ref = of.detach()[:, :, sl].float()
            allow = 0.0
            if dtype == torch.bfloat16:
                allow = ring_allowance(torch, fa, q, k, v, rank, world,
                                       1.0 / float(np.sqrt(d)), causal)
        err = (o.detach().float() - ref).abs()
        ratio = float((err / (atol + rtol * ref.abs() + allow)).max())
        grads = {}
        for t, mine_t, full_t in zip("qkv", mine, full):
            g_ref = full_t.grad[:, :, sl].float()
            grads[f"d{t}"] = float((mine_t.grad.float() - g_ref).abs().max()
                                   / g_ref.abs().max()) / BWD_F64_TOL[key]
        out[name] = {"out_err_ratio": ratio, "grad_err_ratio": grads,
                     "launches": path,
                     "strict_ratio": float((err / (atol + rtol * ref.abs()))
                                           .max())}
        check(ratio <= 1 and max(grads.values()) <= 1,
              f"ring flash attention {name} differs from flash_attention: "
              f"{out[name]}")
    routes = out["bench_causal_bf16"]["launches"]
    check(routes["flash_fwd.tc"] > 0 and routes["flash_bwd_dkv.tc"] > 0
          and routes["flash_bwd_dq.tc"] > 0,
          f"ring bench shape: not on the tensor-core route: {routes}")
    single = out["noncausal_f32"]["launches"]
    check(single["flash_fwd_single"] > 0 and single["flash_bwd_single"] > 0,
          f"ring f32 blocks: not on the single-pass kernels: {single}")
    return out, checks


def growth_checkpoint_leg(torch, np, kv, models, train, checkpoint, rank,
                          world, workdir):
    """The reference DLRM's widths on 2^11-row shards: 10 steps of mostly
    fresh ids (PAR_BATCH per rank) with ``grow_sharded_if_needed`` before
    each; a full ``save_multihost`` at step 5 and a delta at step 10; both
    restored into fresh shards and compared per key with the live ones
    (the restore and the comparison are checks)."""
    from tfplus_tpu_torch import parallel as par
    import torch.distributed as dist
    model = models.DLRM(**DLRM_CONFIG, capacity=PAR_ROWS)
    opt = train.GroupAdamOptimizer()
    tx = functools.partial(torch.optim.Adam, lr=1e-3)
    state = sharded_state(torch, models, par, model, opt, tx, PAR_ROWS,
                          SEED + 241, None, DEV)
    rng = np.random.RandomState(SEED + 241)
    feats = rng.randn(PAR_BATCH, 13).astype(np.float32)
    labels = rng.randint(0, 2, PAR_BATCH).astype(np.float32)
    grew, caps = [], []
    full = os.path.join(workdir, "full")
    delta = os.path.join(workdir, "delta")
    for s in range(1, PAR_STEPS + 1):
        base = (s * world + rank) * PAR_BATCH
        ids = np.arange(base, base + PAR_BATCH, dtype=np.int64)
        ids[:16] = np.arange(16)                  # a few revisits
        batch = {"ids": {n: ids * 7 + i for i, n in
                         enumerate(sorted(model.table_specs))},
                 "features": feats, "labels": labels}
        tables, g = par.grow_sharded_if_needed(
            state.tables, incoming_per_shard=2 * PAR_BATCH)
        state = state._replace(tables=tables)
        if g:
            grew.append(s)
        state, loss, _, flags = sharded_dlrm_step(
            torch, kv, par, model, opt, 1e-3, state, batch, None)
        check(int(flags) == 0, "growth leg: an overflow flag is set")
        caps.append(next(iter(state.tables.values())).capacity)
        if s in (5, PAR_STEPS):
            state = state._replace(tables=checkpoint.save_multihost(
                full if s == 5 else delta, state.tables, state.dense,
                process_id=rank, num_processes=world, delta=s != 5))
    check(grew and caps[-1] > PAR_ROWS, f"growth leg never grew: {caps}")
    dist.barrier()
    checks, compared = {}, 0
    with not_path(checks):
        # restore: every rank reads the union of both ranks' bundles
        tmpl = {n: [kv.create(16, PAR_ROWS, device=DEV)
                    for _ in range(world)] for n in state.tables}
        restored, _ = checkpoint.restore_multihost(full, tmpl)
        restored, _ = checkpoint.restore_multihost(delta, restored,
                                                   delta=True)
        for n, t in state.tables.items():
            k, want = per_key(np, kv, t)
            got = kv.lookup_or_zeros(restored[n][rank], k)
            check(torch.equal(got.cpu(), torch.from_numpy(want)),
                  f"growth leg: {n} restored rows differ from the live "
                  "shard")
            compared += k.shape[0]
    return {"grew_at": grew, "capacities": caps, "rows_compared": compared,
            "loss": float(loss)}, checks


def route_leg(torch, np, kv, train, rank, world):
    """A hot batch (16 ids per rank, every one owned by shard 0) trips a
    4-deep bucket; one retry at ``needed_bucket_capacity`` of exactly the
    dropped positions leaves every id inserted with freq 1."""
    from tfplus_tpu_torch import parallel as par
    opt = train.GroupAdamOptimizer()
    t = par.init_optimizer_sharded(opt, par.create_sharded(
        16, 1024, device=DEV, seed=3))
    hot = np.concatenate([(np.arange(1, 17, dtype=np.int64) + d * 100)
                          * world for d in range(world)])
    ids = kv.encode_ids(hot[rank * 16:(rank + 1) * 16], device=DEV)
    valid = torch.ones((16,), dtype=torch.bool, device=DEV)
    stats = []
    cap = 4
    for _ in range(2):
        rows, st, t = par.sharded_lookup(t, ids, valid=valid,
                                         defer_meta=True, bucket_capacity=cap)
        t = par.sharded_apply_grads(opt, t, st, rows * 0.1, lr=0.05, step=1)
        stats.append(par.route_stats(st))
        valid = par.dropped_positions(st)
        cap = stats[-1]["needed_bucket_capacity"]
    check(stats[0]["route_dropped"] > 0 and stats[1]["route_dropped"] == 0
          and not bool(valid.any()), f"route leg: not recovered: {stats}")
    mine = hot[hot % world == rank]
    checks = {}
    with not_path(checks):
        counts = kv.get_count(t, kv.encode_ids(mine, device=DEV)).cpu() \
            .numpy()
    check(mine.size == 0 or (counts == 1).all(),
          f"route leg: ids lost or counted twice: {counts}")
    return {"stats": stats, "owned": int(mine.size)}, checks


def hybrid_leg(torch, np, kv, train, rank, world):
    """``ShardedHybridTable`` under a 48-row budget per shard against an
    uncapped run of the same steps: the same rows and counts per key, bit
    for bit."""
    from tfplus_tpu_torch import parallel as par
    opt = train.AdagradOptimizer()

    def build(rows):
        return par.init_optimizer_sharded(opt, par.create_sharded(
            16, rows, device=DEV, seed=5))
    rng = np.random.RandomState(SEED + 242)
    work = np.arange(1, 801, dtype=np.int64) * 7 + 1
    batches = [rng.choice(work, 64 * world, replace=False)
               for _ in range(6)]
    batches[4][:16] = batches[0][:16]
    checks = {}
    hyb = par.ShardedHybridTable(build(256), max_live_per_shard=48)
    with not_path(checks):
        big = build(2048)
    spilled = 0

    def step(t, b, s):
        ids = kv.encode_ids(b[rank * 64:(rank + 1) * 64], device=DEV)
        y = torch.as_tensor((b[rank * 64:(rank + 1) * 64] % 5)
                            .astype(np.float32), device=DEV)
        rows, st, t = par.sharded_lookup(t, ids, defer_meta=True)
        r = rows.clone().requires_grad_()
        torch.mean((r.sum(-1) - y) ** 2).backward()
        t = par.sharded_apply_grads(opt, t, st, r.grad, lr=0.05, step=s)
        check(not bool(st.overflow), "hybrid leg: an id was dropped")
        return t
    for s, b in enumerate(batches, start=1):
        hyb.prefetch(b)
        hyb.table = step(hyb.table, b, s)
        spilled += hyb.maybe_spill()
        with not_path(checks):
            big = step(big, b, s)
    st = hyb.stats()
    check(spilled > 0 and st["device_rows_per_shard"][0] <= 48,
          f"hybrid leg: the budget never forced a spill: {st}")
    touched = np.unique(np.concatenate(batches))
    with not_path(checks):
        hyb.prefetch(touched)
        mine = kv.encode_ids(touched[touched % world == rank], device=DEV)
        same = (torch.equal(kv.lookup_or_zeros(hyb.table, mine),
                            kv.lookup_or_zeros(big, mine))
                and torch.equal(kv.get_count(hyb.table, mine),
                                kv.get_count(big, mine)))
    check(same, "hybrid leg: rows or counts differ from the uncapped run")
    return {"spilled": spilled, "stats": st,
            "tier_bytes": hyb.tier.nbytes}, checks


def serving_leg(torch, np, kv, quant, serving, checkpoint, rank, world,
                workdir):
    """Rank 0 exports a dim-16 table of 4,000 keys and writes a 2-shard
    delta that rewrites half of them and adds 500; every rank loads its
    shard (f32 and int8), serves, refreshes from the delta and serves
    again: f32 rows bit for bit, int8 within max|row|/254."""
    import torch.distributed as dist
    from tfplus_tpu_torch import parallel as par
    rng = np.random.RandomState(SEED + 243)
    keys = rng.permutation(np.unique(rng.randint(0, 1 << 40, 4500,
                                                 dtype=np.int64)))[:4000]
    new = rng.randint(1 << 41, 1 << 42, 500, dtype=np.int64)
    rows = torch.from_numpy(rng.randn(4000, 16).astype(np.float32))
    upd = torch.from_numpy(rng.randn(2500, 16).astype(np.float32))
    checks = {}
    # the reference table, rank 0's export and delta: set-up and checks
    with not_path(checks):
        ref = kv.create(16, 1 << 14, device=DEV)
        kv.insert(ref, kv.encode_ids(keys, device=DEV), rows.to(DEV))
        export = os.path.join(workdir, "export")
        delta = os.path.join(workdir, "serve_delta")
        if rank == 0:
            md = serving.RankingMetadata()
            md.add_embedding_column(column_name="emb", var_name="emb",
                                    embedding_dim=16)
            serving.export_for_serving(export, {"emb": ref}, md)
            dk = np.concatenate([keys[:2000], new])
            parts = []
            for i in range(world):
                m = dk % world == i
                p = kv.create(16, 1 << 13, device=DEV)
                kv.insert(p, kv.encode_ids(dk[m], device=DEV),
                          upd[torch.from_numpy(m)].to(DEV))
                parts.append(p)
            checkpoint.save(delta, {"emb": parts},
                            first_n=checkpoint.FIRST_N_INFERENCE)
        dist.barrier()
        kv.insert(ref, kv.encode_ids(np.concatenate([keys[:2000], new]),
                                     device=DEV), upd.to(DEV))
        probe = np.concatenate([keys[rank::world][:300],
                                new[rank::world][:100],
                                rng.randint(1 << 43, 1 << 44, 50,
                                            dtype=np.int64)])
        q = kv.encode_ids(probe, device=DEV)
        want = kv.lookup_or_zeros(ref, q)
    out = {}
    for quantize in (False, True):
        tag = "int8" if quantize else "f32"
        tables, _ = par.serving.load_for_serving_sharded(
            export, quantize=quantize, device=DEV)
        tables = par.serving.refresh_sharded_from_delta(
            tables, delta, quantize=quantize)
        got = par.serving.make_serving_lookup(tables["emb"])(q)
        if quantize:
            ok = bool(((got - want).abs() <= quant_bound(torch, want)).all())
        else:
            ok = torch.equal(got, want)
        check(ok, f"serving leg ({tag}): refreshed rows differ")
        out[tag] = {"capacity": tables["emb"].capacity}
    return out, checks


def leg_2d(torch, np, kv, train, rank, world):
    """2D at 1 x 2 (one row shard, the 16 columns over the two ranks) with
    GroupAdam's l21 norm all-reduced across the column ranks: 3 steps, then
    ``combine_col_shards`` against a single full-width table trained on
    the same global batches (header bit for bit, rows within 1e-5)."""
    from tfplus_tpu_torch import embedding as emb
    from tfplus_tpu_torch.parallel import sharded2d as s2
    mesh = s2.make_mesh_2d(1, world, device_type=torch.device(DEV).type)
    # l21 5e-4 blacklists about half the rows after 3 steps: the decisions
    # read the norm across both column ranks
    gopt = train.GroupAdamOptimizer(l21_regularization_strength=5e-4)
    opt = s2.for_col_axis(gopt, mesh)
    pool = torch.from_numpy(np.random.RandomState(3).rand(10000, 16)
                            .astype(np.float32) - 0.5) * 0.1
    t = s2.init_optimizer_sharded_2d(opt, s2.create_sharded_2d(
        16, 1024, mesh, initializer=pool, device=DEV))
    checks = {}
    with not_path(checks):
        ref = gopt.init(kv.create(16, 1024, initializer=pool, device=DEV))
    rng = np.random.RandomState(SEED + 244)
    for s in range(1, 4):
        ids = rng.randint(0, 300, 64 * world).astype(np.int64)
        mine = kv.encode_ids(ids[rank * 64:(rank + 1) * 64], device=DEV)
        rows, st, t = s2.sharded_lookup_2d(t, mine, mesh=mesh,
                                           defer_meta=True)
        t = s2.sharded_apply_grads_2d(opt, t, st, rows * 0.5 + 0.01,
                                      mesh=mesh, lr=0.1, step=s)
        with not_path(checks):
            u = kv.unique_with_counts(kv.encode_ids(ids, device=DEV))
            res = kv.lookup_or_insert(ref, u.unique_keys, counts=u.counts,
                                      defer_meta=True)
            g = (res.rows[u.inverse.long()] * 0.5 + 0.01)
            ug = emb._segment_sum(g, u.inverse.long(), ids.shape[0])
            gopt.apply(ref, res.slot, ug, lr=0.1, step=s,
                       payload_rows=res.payload_rows,
                       meta_rows=res.meta_rows)
    full = s2.combine_col_shards(t, mesh)
    with not_path(checks):
        occ = kv.occupied_mask(ref)
        err = float((full.payload[occ] - ref.payload[occ]).abs().max())
        black = int(((ref.meta & kv.FLAG_BLACKLIST) != 0).sum())
    check(torch.equal(full.header, ref.header) and err <= 1e-5
          and 0 < black < int(occ.sum()),
          f"2D leg: the combined columns differ from one table (max err "
          f"{err})")
    return {"max_abs_err": err, "blacklisted": black,
            "rows": int(occ.sum())}, checks


def rank_worker(args) -> int:
    """One rank of phase 24 (``--rank-worker``): join the gloo group on
    cuda:0, run the legs, write ``rank<r>.json``."""
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    from tfplus_tpu_torch import (checkpoint, kv, models, serving, train)
    from tfplus_tpu_torch.kv import quant
    from tfplus_tpu_torch.ops import flash_attention as fa
    torch.cuda.set_device(0)
    rank, world = args.rank_worker, args.world
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{args.port}", world_size=world, rank=rank,
                            timeout=timedelta(seconds=120))
    res = {"rank": rank, "launches": {}}
    try:
        leg(res, "ring", ring_leg, torch, np, fa, rank, world)
        leg(res, "growth_checkpoint", growth_checkpoint_leg, torch, np, kv,
            models, train, checkpoint, rank, world, args.dir)
        leg(res, "route_recovery", route_leg, torch, np, kv, train, rank,
            world)
        leg(res, "hybrid", hybrid_leg, torch, np, kv, train, rank, world)
        leg(res, "serving", serving_leg, torch, np, kv, quant, serving,
            checkpoint, rank, world, args.dir)
        leg(res, "2d_1x2", leg_2d, torch, np, kv, train, rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(args.dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


# ---------------------------------------------------------------------------
# phases 25-27: remote storage, profiling, the examples' twins
# ---------------------------------------------------------------------------

REMOTE_USER, REMOTE_SECRET = "chip-smoke", "chip-smoke-secret"
REMOTE_GROW_STEPS = 8            # phase 25 (c): phase 14's 12 steps cut
REMOTE_GROW_SAVES = (4, 8)       # a full save, then a delta
PROFILE_ROWS = 1 << 16           # phase 26's DCN tables (phase 11's: 2^20)
PROFILE_FILL = 1 << 14
PROFILE_STEPS = 3                # traced requests and steps
METER_STEPS = 10
TWIN_TIMEOUT = 480               # seconds for phase 27's twins together
TWIN_LANES = 6                   # twins running at once
# phase 27: each twin with short arguments (the twin's own flags), the
# longest first so that the lanes end together
TWIN_RUNS = (
    ("train_deepfm", ["--model", "deepfm", "--train-batches", "10",
                      "--eval-batches", "2"]),
    ("train_deepfm", ["--model", "widedeep", "--train-batches", "10",
                      "--eval-batches", "2"]),
    ("train_dlrm_sharded", ["--batches", "20"]),      # under torchrun
    ("train_dcn", ["--optimizer", "group_adam", "--train-batches", "20",
                   "--eval-batches", "5"]),
    ("train_ncf", ["--epochs", "3", "--examples", "20000"]),
    ("train_din", ["--model", "bst", "--train-batches", "100",
                   "--eval-batches", "5"]),
    ("train_din", ["--model", "din", "--train-batches", "100",
                   "--eval-batches", "5"]),
    ("checkpoint_resume", []),
    ("serving_demo", ["--port", "PORT", "--quantize"]),
    ("serving_demo", ["--port", "PORT"]),
    ("migrate_from_tfplus", []),
)


def remote_uri(scheme, host, path):
    """A credential-embedded ``oss://`` / ``s3://`` URI, or ``dfs://``
    with the WebHDFS user."""
    if scheme == "dfs":
        return f"dfs://{REMOTE_USER}@{host}/{path}"
    return (f"{scheme}://bkt\x01id={REMOTE_USER}\x02key={REMOTE_SECRET}"
            f"\x02host={host}/{path}")


@contextlib.contextmanager
def counted(obj, attr, tally):
    """Count the calls of ``obj.attr`` inside the block in
    ``tally[attr]``."""
    inner = getattr(obj, attr)

    def call(*a, **kw):
        tally[attr] = tally.get(attr, 0) + 1
        return inner(*a, **kw)
    setattr(obj, attr, call)
    try:
        yield
    finally:
        setattr(obj, attr, inner)


def same_by_key(torch, np, kv, a, b):
    """Two tables hold the same keys with the same rows, bit for bit."""
    ka, ra = per_key(np, kv, a)
    kb, rb = per_key(np, kv, b)
    return torch.equal(ka, kb) and np.array_equal(ra.view(np.int32),
                                                  rb.view(np.int32))


def remote_serving_legs(torch, np, kv, quant, models, train, serving,
                        checkpoint, tbundle, io, oss_emu, s3_emu, workdir):
    """Phase 25 (a) and (b) on phase 17's DLRM (26 tables of 2^20 rows
    holding 2^18 keys, dim 16). (a) ``export_for_serving`` to ``oss://``
    (the emulator's single-PUT cap at the client's part size, so every
    bundle file past 16 MB goes up in parts), ``load_for_serving`` from
    there in f32 (rows per key bit for bit with the source) and int8
    (within max|row|/254); the export and the f32 load on local disk too.
    (b) three Adam steps, a delta ``checkpoint.save`` to ``s3://``
    and to local disk (the local save first, then the tables' delta bits
    put back so that both saves hold the same rows), ``refresh_from_delta``
    of the f32 tables loaded in (a) from each: equal per key bit for bit.
    The launch counts of each leg cover its remote calls only."""
    from tfplus_tpu_torch.io import object_store
    model = models.DLRM(**DLRM_CONFIG, capacity=DLRM_ROWS)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 250)
    rng = np.random.RandomState(SEED + 250)
    keys = {n: rng.permutation(np.unique(rng.randint(
        0, 1 << 40, DLRM_FILL + DLRM_FILL // 8, dtype=np.int64)))[:DLRM_FILL]
        for n in model.table_specs}
    state = models.init_state(model, seed=SEED, device=DEV)
    resident = {}
    for name in sorted(state.tables):
        q = kv.encode_ids(keys[name], device=DEV)
        kv.insert(state.tables[name], q, torch.randn(
            DLRM_FILL, 16, device=DEV, generator=gen), day=1)
        resident[name] = np.nonzero(
            kv.find(state.tables[name], q).found.cpu().numpy())[0]
    md = serving.RankingMetadata()
    for name in sorted(keys):
        md.add_embedding_column(column_name=name, var_name=name,
                                embedding_dim=16)
    out = {"oss": {}, "s3": {}}
    a = out["oss"]
    local = os.path.join(workdir, "export")
    tally = {}
    with oss_emu.OSSEmulator({REMOTE_USER: REMOTE_SECRET},
                             max_put_size=object_store._PART_SIZE) as host:
        io.register_oss()
        remote = remote_uri("oss", host, "export")
        torch.cuda.synchronize()
        reset_launches()
        with counted(object_store.ObjectStoreClient, "initiate_multipart",
                     tally):
            prefix = serving.export_for_serving(remote, state.tables, md)
            loaded, _ = serving.load_for_serving(remote, device=DEV)
            loaded_q, _ = serving.load_for_serving(remote, quantize=True,
                                                   device=DEV)
            torch.cuda.synchronize()
        a["launches"] = read_launches()
        a["multipart_uploads"] = tally.get("initiate_multipart", 0)
        a["payload_bytes"] = payload_bytes(tbundle, prefix)
    serving.export_for_serving(local, state.tables, md)
    loaded_local, _ = serving.load_for_serving(local, device=DEV)
    check(a["multipart_uploads"] > 0, "OSS export: no multipart upload")
    worst = 0.0
    for name, t in state.tables.items():
        k, want = per_key(np, kv, t)
        want = torch.from_numpy(want).to(DEV)
        fr = kv.find(loaded[name], k)
        check(bool(fr.found.all())
              and int(kv.size(loaded[name])) == k.shape[0]
              and torch.equal(loaded[name].payload[fr.slot.long()], want),
              f"OSS load: {name}'s f32 rows differ from the source's")
        got = quant.lookup_or_zeros(loaded_q[name], k)
        bound = quant_bound(torch, want)
        check(bool(((got - want).abs() <= bound).all()),
              f"OSS load: {name}'s int8 rows past max|row|/254")
        worst = max(worst, float(((got - want).abs()
                                  / bound.clamp(min=1e-30)).max()))
    a["int8_err_over_bound"] = worst
    del loaded_q
    print(f"remote storage (a) oss: {json.dumps(a)}", flush=True)

    # (b) the trainer's delta through s3://
    b = out["s3"]
    opt = train.AdamOptimizer()
    tables = {}
    for name, t in state.tables.items():
        kv.clear_deltalist(t, "train")
        tables[name] = opt.init(t)
    state = models.TrainState(
        tables=tables, dense=state.dense, step=state.step,
        opt_state=torch.optim.Adam(state.dense.parameters(), lr=0.01))
    del tables
    tstep = models.make_train_step(model, opt, sparse_lr=0.01)
    for _ in range(3):
        state, loss, _ = tstep(state, dcn_batch(np, rng, keys, resident,
                                                BATCH))
    check(bool(torch.isfinite(loss)), "S3 leg: non-finite training loss")
    headers = {n: t.header.clone() for n, t in state.tables.items()}
    local_delta = os.path.join(workdir, "delta-1")
    checkpoint.save(local_delta, state.tables, delta=True)
    for n, t in state.tables.items():
        t.header.copy_(headers[n])         # the delta bits, for the S3 save
    del headers
    with s3_emu.S3Emulator({REMOTE_USER: REMOTE_SECRET}) as host:
        io.register_s3()
        remote_delta = remote_uri("s3", host, "deltas/delta-1")
        torch.cuda.synchronize()
        reset_launches()
        checkpoint.save(remote_delta, state.tables, delta=True)
        loaded = serving.refresh_from_delta(loaded, remote_delta)
        torch.cuda.synchronize()
        b["launches"] = read_launches()
        b["delta_payload_bytes"] = payload_bytes(tbundle, remote_delta)
        b["delta_values_bytes"] = payload_bytes(tbundle, remote_delta,
                                                slots=False)
    loaded_local = serving.refresh_from_delta(loaded_local, local_delta)
    for name in state.tables:
        check(same_by_key(torch, np, kv, loaded[name], loaded_local[name]),
              f"S3 refresh: {name} differs from the local refresh")
        check(same_by_key(torch, np, kv, loaded[name], state.tables[name]),
              f"S3 refresh: {name} differs from the trainer's rows")
    del state, loaded, loaded_local
    print(f"remote storage (b) s3: {json.dumps(b)}", flush=True)
    return out


def unplaced_ids(torch, np, embedding, t, ids):
    """The ids of one batch that a training lookup into ``t`` leaves
    unplaced (every slot of the id's bucket pair taken), found on a copy of
    ``t`` by the train step's own lookup."""
    copy_t = dataclasses.replace(t, **{
        f.name: getattr(t, f.name).clone() for f in dataclasses.fields(t)
        if isinstance(getattr(t, f.name), torch.Tensor)})
    look, _ = embedding.lookup_unique(copy_t, ids, train=True,
                                      defer_meta=True)
    return np.unique(ids[(look.slot[look.inverse] < 0).cpu().numpy()])


def resume_probe(torch, np, embedding, live, back, ids):
    """Per table, the capacities of the live and the restored tables and
    the ids of the next batch each leaves unplaced; ``same`` is whether
    every table leaves the same ids unplaced on both sides."""
    out = {"tables": {}, "same": True}
    for n in sorted(live):
        a = unplaced_ids(torch, np, embedding, live[n], ids[n])
        b = unplaced_ids(torch, np, embedding, back[n], ids[n])
        same = np.array_equal(a, b)
        out["same"] &= bool(same)
        if len(a) or len(b) or live[n].capacity != back[n].capacity:
            out["tables"][n] = {
                "capacity": [live[n].capacity, back[n].capacity],
                "unplaced": [len(a), len(b)], "same_ids": bool(same)}
    out["unplaced"] = [sum(v["unplaced"][i] for v in out["tables"].values())
                       for i in (0, 1)]
    return out


def remote_growth_leg(torch, np, kv, models, train, checkpoint, tbundle,
                      rowops, io, dfs_emu):
    """Phase 25 (c): phase 14's growing DCN (every table from 2^14 rows,
    2,048 fresh ids per table and step) for 8 steps, a full
    ``CheckpointManager`` save at step 4 and a delta at 8 on ``dfs://``,
    the emulator failing the first request of the full save (a namenode
    leg, retried). A second manager restores from
    ``dfs://`` into fresh 2^14-row templates: every table equal to the
    live one per key, and the dense tower bit for bit. Then one more step
    from both states on one batch, the loss coming before any update:
    (1) each state grown by ``grow_if_needed`` as phase 14 grows it. The
    restore fills its tables in the bundle's order where the live job
    filled them batch by batch, so near the growth threshold the two may
    leave other ids of the batch unplaced (a full bucket pair): the leg
    lists each side's unplaced ids, requires equal losses when they are
    the same ids, and reports the case where they are not as the known
    fault it is. (2) Both states grown to one capacity, twice the larger,
    where neither leaves an id unplaced: the losses must be equal. The
    launch counts are the saves, the restore and step (1); they leave out
    the probes, step (2) and the checks."""
    from tfplus_tpu_torch import embedding
    model = models.DCN(capacity=GROW_START_ROWS)
    opt = train.GroupAdamOptimizer()
    tx = functools.partial(torch.optim.Adam, lr=1e-3)
    rng = np.random.RandomState(SEED + 260)
    batches = [fresh_batch(np, rng, model, BATCH)
               for _ in range(REMOTE_GROW_STEPS + 1)]
    state = models.init_state(model, opt, tx, seed=SEED, device=DEV)
    step = models.make_train_step(model, opt, sparse_lr=1e-3)
    out = {"saves": {}, "grows": 0}
    srv = dfs_emu.DfsEmulator(users={REMOTE_USER})
    with srv as host:
        io.register_dfs()
        remote = remote_uri("dfs", host, "ckpts")
        mgr = checkpoint.CheckpointManager(remote)
        torch.cuda.synchronize()
        reset_launches()
        for i in range(1, REMOTE_GROW_STEPS + 1):
            caps = {n: t.capacity for n, t in state.tables.items()}
            state = models.grow_if_needed(state, BATCH)
            out["grows"] += sum(state.tables[n].capacity != c
                                for n, c in caps.items())
            state, loss, _ = step(state, batches[i - 1])
            if i not in REMOTE_GROW_SAVES:
                continue
            full = i == REMOTE_GROW_SAVES[0]
            kind = "full" if full else "delta"
            if full:
                srv.fail_next(1)        # the save's first (namenode) leg
            tables = mgr.save(state.tables, state.dense, step=i, full=full)
            state = state._replace(tables=tables)
            out["saves"][f"{kind}@{i}"] = payload_bytes(
                tbundle, f"{remote}/ckpt-{kind}-{i}")
        check(srv._handler.faults["n"] == 0, "DFS leg: the fault never hit")
        caps = {n: t.capacity for n, t in state.tables.items()}
        dense = model.init_dense(torch.Generator().manual_seed(SEED + 261),
                                 DEV)
        templates = model.init_tables(opt, seed=SEED + 262, device=DEV)
        restored, dense, at = checkpoint.CheckpointManager(remote).restore(
            templates, dense)
        torch.cuda.synchronize()
    launches = read_launches()
    check(at == REMOTE_GROW_STEPS, f"DFS leg: restored step {at}")
    check(out["grows"] > 0 and all(c > GROW_START_ROWS
                                   for c in caps.values()),
          f"DFS leg: the tables did not grow: {caps}")
    day = 20000
    for n in sorted(state.tables):
        x = table_by_key(np, kv, rowops, state.tables[n], day)
        y = table_by_key(np, kv, rowops, restored[n], day)
        check(np.array_equal(x[0], y[0]) and torch.equal(x[1], y[1])
              and np.array_equal(x[2], y[2]) and np.array_equal(x[3], y[3]),
              f"DFS leg: restored table {n} differs from the live one")
    live_dense = state.dense.state_dict()
    check(all(torch.equal(v, live_dense[k])
              for k, v in dense.state_dict().items()),
          "DFS leg: restored dense tower differs")
    ids = batches[-1]["ids"]
    resumed = models.TrainState(tables=dict(restored), dense=dense,
                                opt_state=tx(dense.parameters()),
                                step=state.step.clone())
    state = models.grow_if_needed(state, BATCH)
    resumed = models.grow_if_needed(resumed, BATCH)
    out["resume"] = resume_probe(torch, np, embedding, state.tables,
                                 resumed.tables, ids)
    # (2)'s states, made before (1) updates the tables and towers in place
    wide = {}
    for side, st in (("live", state), ("resumed", resumed)):
        d = copy.deepcopy(st.dense)
        wide[side] = models.TrainState(
            tables={n: kv.grow(t, 2 * max(state.tables[n].capacity,
                                          resumed.tables[n].capacity))
                    for n, t in st.tables.items()},
            dense=d, opt_state=tx(d.parameters()), step=st.step.clone())
    probe = resume_probe(torch, np, embedding, wide["live"].tables,
                         wide["resumed"].tables, ids)
    check(probe["unplaced"] == [0, 0],
          f"DFS leg: ids unplaced at twice the capacity: {probe}")
    before = read_launches()
    state, loss_live, _ = step(state, batches[-1])
    resumed, loss_resumed, _ = step(resumed, batches[-1])
    torch.cuda.synchronize()
    after = read_launches()
    out["launches"] = {k: launches[k] + after[k] - before[k]
                       for k in launches}
    res = out["resume"]
    res["loss_live"], res["loss_resumed"] = float(loss_live), float(
        loss_resumed)
    res["equal"] = bool(torch.equal(loss_live, loss_resumed))
    if res["same"]:
        check(res["equal"],
              f"DFS leg: both sides place the same ids, yet the resumed "
              f"loss {res['loss_resumed']} != live {res['loss_live']}")
    elif not res["equal"]:
        print(f"remote storage (c) dfs: KNOWN FAULT: after grow_if_needed "
              f"the restored job leaves {res['unplaced'][1]} ids of the "
              f"next batch unplaced where the live one leaves "
              f"{res['unplaced'][0]}, so the resumed loss "
              f"{res['loss_resumed']} != live {res['loss_live']}",
              flush=True)
    _, loss_live, _ = step(wide["live"], batches[-1])
    _, loss_resumed, _ = step(wide["resumed"], batches[-1])
    out["loss_live"] = float(loss_live)
    out["loss_resumed"] = float(loss_resumed)
    check(torch.equal(loss_live, loss_resumed),
          f"DFS leg: at one capacity the resumed loss "
          f"{out['loss_resumed']} != live {out['loss_live']}")
    del state, resumed, restored, templates, wide
    print(f"remote storage (c) dfs: {json.dumps(out)}", flush=True)
    return out


def remote_storage_phase(torch, np, kv, quant, models, train, serving,
                         checkpoint, tbundle, rowops):
    """Phase 25: the port's OSS, S3 and DFS clients against their
    emulators on 127.0.0.1 in this process (legs (a)-(c) above)."""
    import shutil
    from tfplus_tpu_torch import io
    from tfplus_tpu_torch.io import dfs_emulator, oss_emulator, s3_emulator
    workdir = tempfile.mkdtemp(prefix="chip_smoke_remote_")
    try:
        out = remote_serving_legs(torch, np, kv, quant, models, train,
                                  serving, checkpoint, tbundle, io,
                                  oss_emulator, s3_emulator, workdir)
        out["dfs"] = remote_growth_leg(torch, np, kv, models, train,
                                       checkpoint, tbundle, rowops, io,
                                       dfs_emulator)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    legs = [out[s]["launches"] for s in ("oss", "s3", "dfs")]
    launches = {k: sum(x[k] for x in legs) for k in legs[0]}
    for s in ("oss", "s3", "dfs"):
        check(out[s]["launches"]["gather_rows"] > 0
              or out[s]["launches"]["scatter_rows"] > 0,
              f"remote {s}: no row kernel launched: {out[s]['launches']}")
    check(launches["gather_rows"] > 0 and launches["scatter_rows"] > 0,
          f"remote storage: the row kernels were not launched: {launches}")
    peak_memory(torch, "remote storage")
    return launches


def trace_events(path):
    import glob
    files = glob.glob(os.path.join(path, "*.pt.trace.json"))
    check(len(files) == 1, f"profiling: expected one trace file: {files}")
    with open(files[0]) as f:
        return json.load(f)["traceEvents"], files[0]


def profiling_phase(torch, np, kv, models, train):
    """Phase 26: ``utils.profiling.trace`` over three DCN serving requests
    and three training steps at the reference DCN's widths (26 tables cut
    to 2^16 rows holding 2^14 keys; GroupAdam, dense Adam); the trace must
    hold the program's own spans (``tfp::lookup`` a table and request or
    step, ``tfp::forward`` a request or step, ``tfp::sparse_opt`` a table
    and step) and as many ``rows_kernel`` CUDA events as the row wrappers
    counted in the traced window. Then ``StepMeter`` over ten steps beside
    the CUDA events' rate of the same steps."""
    import shutil
    from tfplus_tpu_torch.utils import profiling
    model = models.DCN(capacity=PROFILE_ROWS)
    opt = train.GroupAdamOptimizer()
    tx = functools.partial(torch.optim.Adam, lr=1e-3)
    rng = np.random.RandomState(SEED + 270)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 270)
    keys = {n: np.unique(rng.randint(1, 1 << 40, PROFILE_FILL + 64,
                                     dtype=np.int64))[:PROFILE_FILL]
            for n in model.table_specs}
    state = models.init_state(model, opt, tx, seed=SEED, device=DEV)
    resident = fill_tables(torch, np, kv, state, keys, gen)
    batches = [dcn_batch(np, rng, keys, resident, BATCH)
               for _ in range(2 * PROFILE_STEPS + METER_STEPS + 2)]
    serve = models.make_train_step(model, train=False)
    step = models.make_train_step(model, opt, sparse_lr=1e-3)
    serve(state, batches[0])                                  # warm-up
    state, _, _ = step(state, batches[1])
    out = {}
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        torch.cuda.synchronize()
        reset_launches()
        with profiling.trace(log_dir):
            for b in batches[2:2 + PROFILE_STEPS]:
                serve(state, b)
            for b in batches[2 + PROFILE_STEPS:2 + 2 * PROFILE_STEPS]:
                state, loss, _ = step(state, b)
            torch.cuda.synchronize()
        launches = read_launches()
        events, path = trace_events(log_dir)
        out["trace_bytes"] = os.path.getsize(path)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    names = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in (
                "tfp::lookup", "tfp::forward", "tfp::sparse_opt"):
            names[e["name"]] = names.get(e["name"], 0) + 1
    rows = sum(1 for e in events if e.get("cat") == "kernel"
               and "rows_kernel" in e.get("name", ""))
    counted_rows = launches["gather_rows"] + launches["scatter_rows"]
    out.update({"annotations": names, "rows_kernel_events": rows,
                "row_wrapper_launches": counted_rows,
                "kernel_events": sum(1 for e in events
                                     if e.get("cat") == "kernel")})
    tables = len(model.table_specs)
    check(names.get("tfp::lookup") == 2 * PROFILE_STEPS * tables
          and names.get("tfp::forward") == 2 * PROFILE_STEPS
          and names.get("tfp::sparse_opt") == PROFILE_STEPS * tables,
          f"profiling: the trace lacks the program's spans: {names}")
    check(rows == counted_rows and rows > 0,
          f"profiling: {rows} rows_kernel events in the trace against "
          f"{counted_rows} counted launches")
    check(bool(torch.isfinite(loss)), "profiling: non-finite loss")

    # StepMeter against CUDA events over the same ten steps
    meter = profiling.StepMeter()
    evs = []
    torch.cuda.synchronize()
    meter.step(0)                                  # marks the start
    for b in batches[2 + 2 * PROFILE_STEPS:]:
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        state, loss, _ = step(state, b)
        e.record()
        torch.cuda.synchronize()
        meter.step(BATCH)
        evs.append((a, e))
    snap = meter.snapshot()
    ev_s = sum(a.elapsed_time(e) for a, e in evs) / 1e3
    out["step_meter_steps"] = snap["steps"]
    out["step_meter_over_cuda_events"] = (snap["examples_per_s"] * ev_s
                                          / (METER_STEPS * BATCH))
    check(snap["steps"] == METER_STEPS + 1
          and abs(out["step_meter_over_cuda_events"] - 1) < 0.5,
          f"profiling: StepMeter far from the CUDA events' rate: {out}")
    out["launches"] = launches
    del state
    print(f"profiling: {json.dumps(out)}", flush=True)
    peak_memory(torch, "profiling")
    return launches


def twin_worker(args) -> int:
    """One twin of phase 27 (``--twin NAME --twin-args JSON``): reset the
    launch counts, run the twin's ``main`` and print its metrics and the
    launches as one ``twin result`` JSON line."""
    import importlib
    argv = json.loads(args.twin_args)
    mod = importlib.import_module(f"tfplus_tpu_torch.examples.{args.twin}")
    reset_launches()
    metrics = mod.main(argv)
    res = {"name": args.twin, "argv": argv, "metrics": metrics,
           "launches": read_launches()}
    if int(os.environ.get("RANK", "0")) == 0:
        print("twin result " + json.dumps(res, default=float), flush=True)
    return 0


def twin_check(res):
    """A twin's own checks on its returned metrics."""
    name, m, argv = res["name"], res["metrics"], res["argv"]
    if name in ("train_dcn", "train_deepfm"):
        check(np_finite(m["losses"]) and 0.0 <= m["auc"] <= 1.0
              and m["total_rows"] > 0, f"{name}: {m}")
    elif name == "train_din":
        check(np_finite(m["losses"]) and 0.0 <= m["auc"] <= 1.0, f"{name}")
        if "bst" in argv:
            check(res["launches"]["flash_fwd_single"] > 0
                  and res["launches"]["flash_bwd_single"] > 0,
                  f"BST twin: the flash kernels were not launched: "
                  f"{res['launches']}")
    elif name == "train_ncf":
        check(m["losses"][-1] < m["losses"][0],
              f"NCF twin: the loss did not fall: {m['losses']}")
    elif name == "serving_demo":
        check(m["max_abs_err"] <= m["tolerance"], f"serving twin: {m}")
    elif name == "train_dlrm_sharded":
        check(np_finite(m["losses"]) and all(
            v > 0 for v in m["rows_per_table"].values()), f"{name}: {m}")
    elif name == "migrate_from_tfplus":
        check(m["discovered_shards"] == {"user_emb": 2}
              and m["imported_rows"] == 2000
              and len(m["exported_tensors"]) == 19, f"{name}: {m}")


def np_finite(xs):
    import math
    return len(xs) > 0 and all(math.isfinite(x) for x in xs)


def twins_phase(torch):
    """Phase 27: every example twin in its own process (``--twin``), at
    most ``TWIN_LANES`` at once on the one card, ``train_dlrm_sharded``
    under ``torchrun --nproc-per-node 1`` (NCCL); each must exit 0 and
    pass its own checks."""
    import shutil
    workdir = tempfile.mkdtemp(prefix="chip_smoke_twins_")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    runs = []
    for i, (name, argv) in enumerate(TWIN_RUNS):
        argv = [str(free_port()) if a == "PORT" else a for a in argv]
        cmd = [sys.executable]
        if name == "train_dlrm_sharded":
            cmd += ["-m", "torch.distributed.run", "--nproc-per-node", "1",
                    "--master-port", str(free_port())]
        cmd += [os.path.abspath(__file__), "--twin", name, "--twin-args",
                json.dumps(argv)]
        runs.append({"name": name, "argv": argv, "cmd": cmd,
                     "log": os.path.join(workdir, f"twin{i}.log")})
    deadline = time.monotonic() + TWIN_TIMEOUT
    pending, live = list(runs), []
    try:
        while pending or live:
            while pending and len(live) < TWIN_LANES:
                r = pending.pop(0)
                with open(r["log"], "wb") as f:
                    r["proc"] = subprocess.Popen(r["cmd"], env=env, stdout=f,
                                                 stderr=subprocess.STDOUT)
                live.append(r)
            time.sleep(0.2)
            for r in [r for r in live if r["proc"].poll() is not None]:
                live.remove(r)
            check(time.monotonic() < deadline,
                  f"twins: past {TWIN_TIMEOUT} s with "
                  f"{[r['name'] for r in live + pending]} unfinished")
    finally:
        for r in runs:
            p = r.get("proc")
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r in runs:
        with open(r["log"], errors="replace") as f:
            text = f.read()
        print(f"--- phase 27 twin {r['name']} {' '.join(r['argv'])} "
              f"(rc {r['proc'].returncode}) ---\n" + text[-3000:],
              flush=True)
        check(r["proc"].returncode == 0,
              f"twin {r['name']} {r['argv']}: rc {r['proc'].returncode}")
        line = [x for x in text.splitlines() if x.startswith("twin result ")]
        check(len(line) == 1, f"twin {r['name']}: no result line")
        res = json.loads(line[0][len("twin result "):])
        twin_check(res)
        results.append(res)
    shutil.rmtree(workdir, ignore_errors=True)
    launches = {k: sum(x["launches"][k] for x in results)
                for k in results[0]["launches"]}
    out = {"launches": launches,
           "twins": [{"name": x["name"], "argv": x["argv"],
                      "launches": {k: v for k, v in x["launches"].items()
                                   if v}} for x in results]}
    print(f"twins: {json.dumps(out)}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 28: the TFPlus bridge (TensorFlow TensorBundles) on the card
# ---------------------------------------------------------------------------

TF_AS_OF_DAY = 20100             # the exports' as_of_unix_day
TF_BLACKLISTED = 64              # keys per table re-inserted blacklisted
TF_REQUESTS = 10                 # batch-2048 requests per prediction check
TF_SHARDS = 4                    # leg (c): one table into this many shards


def file_bytes(prefix):
    """The bytes of a TensorBundle's or a native bundle's files."""
    import glob
    return {os.path.basename(p): os.path.getsize(p)
            for p in sorted(glob.glob(glob.escape(prefix) + ".*"))}


def same_files(a, b):
    """Two bundles' files (index and data) hold the same bytes."""
    for pa, pb in ((a + ".index", b + ".index"),
                   (a + ".data-00000-of-00001", b + ".data-00000-of-00001")):
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            if fa.read() != fb.read():
                return False
    return True


def key_state(torch, kv, t, q):
    """Per key of ``q`` (all in ``t``): the embedding columns' bits and
    the meta words."""
    fr = kv.find(t, q)
    check(bool(fr.found.all()), f"{t.config.name}: a key is missing")
    rows = t.payload[fr.slot.long(), :t.dim].contiguous()
    return rows.view(torch.int32), fr.meta


def tf_bridge_phase(torch, np, kv, models, train, serving, packing):
    """Phase 28: the TFPlus bridge on phase 17's DLRM (26 tables of 2^20
    rows holding 2^18 keys, dim 16), after three Adam steps so that
    frequencies and slots exist, then 64 keys per table blacklisted. (a)
    ``tf_export.export_checkpoint`` (first_n 6) with uint16 frequencies and
    with ``freq_use_uint32``, each written twice: the two writes' files are
    the same bytes. (b) ``tf_import.import_checkpoint`` of the uint32
    export into fresh templates on the card: per key the rows, the meta
    words' frequency, day and blacklist bit, and each init pool equal the
    source's bit for bit (the uint16 export's import too, frequency and
    blacklist: it carries no day); ten requests give the source's
    predictions. (c) one table into 4 shards on the card: each key in shard
    ``key % 4``, the union the source's per key. (d) one table's Adam ``m``
    written as a slot KvVariable (k=1) by ``tf_bundle.write_bundle`` and
    ``attach_slot_rows`` into the table of (b): the slot rows equal the
    source's. (e) ``export_for_serving(format="tfplus")`` then
    ``import_checkpoint`` of its prefix: ten requests give the predictions
    of the native export's ``load_for_serving``. (f) the CRC32C helper
    against its table loop on the uint32 export's data file. Each leg runs
    with the launch counts set to 0 before it and read after it; its
    checks and references are taken off (:func:`not_path`)."""
    import shutil
    from tfplus_tpu_torch.checkpoint import (crc32c, tf_bundle, tf_export,
                                             tf_import)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tf_bridge_")
    out = {"legs": {}}
    total = {}

    def run_leg(name, fn):
        checks = {}
        reset_launches()
        res = fn(checks)
        after = read_launches()
        path = {k: after[k] - checks.get(k, 0) for k in after}
        res["launches"] = {k: v for k, v in path.items() if v}
        for k, v in path.items():
            total[k] = total.get(k, 0) + v
        out["legs"][name] = res
        print(f"tf bridge ({name}): {json.dumps(res)}", flush=True)
        return res

    try:
        model = models.DLRM(**DLRM_CONFIG, capacity=DLRM_ROWS)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 280)
        rng = np.random.RandomState(SEED + 280)
        keys = {n: rng.permutation(np.unique(rng.randint(
            0, 1 << 40, DLRM_FILL + DLRM_FILL // 8,
            dtype=np.int64)))[:DLRM_FILL] for n in model.table_specs}
        state = models.init_state(model, seed=SEED, device=DEV)
        resident = {}
        for name in sorted(state.tables):
            t = state.tables[name]
            q = kv.encode_ids(keys[name], device=DEV)
            rows = torch.randn(DLRM_FILL, 16, device=DEV, generator=gen)
            kv.insert(t, q, rows, day=1)
            resident[name] = np.nonzero(kv.find(t, q).found.cpu().numpy())[0]
        opt = train.AdamOptimizer()
        state = models.TrainState(
            tables={n: opt.init(t) for n, t in state.tables.items()},
            dense=state.dense, step=state.step,
            opt_state=torch.optim.Adam(state.dense.parameters(), lr=0.01))
        tstep = models.make_train_step(model, opt, sparse_lr=0.01)
        for _ in range(3):
            state, loss, _ = tstep(state, dcn_batch(np, rng, keys, resident,
                                                    BATCH))
        check(bool(torch.isfinite(loss)), "TF bridge: non-finite loss")
        # blacklist keys after training (a step that touches a blacklisted
        # key clears its bit): each table's row, frequency and day kept
        for name, t in state.tables.items():
            q = kv.encode_ids(keys[name][resident[name][:TF_BLACKLISTED]],
                              device=DEV)
            fr = kv.find(t, q)
            kv.insert(t, q, t.payload[fr.slot.long(), :16],
                      blacklist=torch.ones(q.shape[0], dtype=torch.bool,
                                           device=DEV))
        serve = models.make_train_step(model, train=False)
        requests = [dcn_batch(np, rng, keys, resident, BATCH)
                    for _ in range(TF_REQUESTS)]
        want_preds = [serve(state, b)[2] for b in requests]
        source = {}          # per table: (uint64 keys, on the card, rows, meta)
        for name, t in state.tables.items():
            u64 = np.sort(np.asarray(kv.export_arrays(t)["keys"], np.uint64))
            q = kv.encode_ids_np_to_device(u64, device=DEV)
            source[name] = (u64, q) + key_state(torch, kv, t, q)
        check(all(int((s[3] & packing.FLAG_BLACKLIST).ne(0).sum())
                  == TF_BLACKLISTED for s in source.values()),
              "TF bridge: the blacklisted keys are not set")
        prefixes = {}

        def leg_a(checks):
            res = {}
            for kind, u32 in (("uint16", False), ("uint32", True)):
                p = [os.path.join(workdir, f"a_{kind}_{i}", "model.ckpt-3")
                     for i in range(2)]
                tf_export.export_checkpoint(p[0], state.tables,
                                            freq_use_uint32=u32,
                                            as_of_unix_day=TF_AS_OF_DAY)
                tf_export.export_checkpoint(p[1], state.tables,
                                            freq_use_uint32=u32,
                                            as_of_unix_day=TF_AS_OF_DAY)
                check(same_files(p[0], p[1]),
                      f"TF export ({kind}): two writes differ")
                res[f"{kind}_bytes"] = sum(file_bytes(p[0]).values())
                prefixes[kind] = p[0]
            reader = tf_bundle.TFBundleReader(prefixes["uint32"])
            res["tensors"] = len(reader.get_variable_to_shape_map())
            check(res["tensors"] == 6 * len(state.tables),
                  f"TF export: {res['tensors']} tensors")
            return res

        def compare(name, got, kind, checks):
            """``got`` (a table or shards) holds the source's keys: rows bit
            for bit, meta in the fields the export carries."""
            u64, q, rows, meta = source[name]
            mask = packing.FREQ_MASK | packing.FLAG_BLACKLIST
            if kind == "uint32":
                mask |= packing.DAY_MASK << 16
            with not_path(checks):
                shards = got if isinstance(got, list) else [got]
                n = sum(int(kv.size(s)) for s in shards)
                check(n == q.shape[0], f"{name} ({kind}): {n} rows, "
                      f"the source {q.shape[0]}")
                if len(shards) == 1:
                    g_rows, g_meta = key_state(torch, kv, shards[0], q)
                else:
                    home = torch.from_numpy(
                        (u64 % np.uint64(len(shards))).astype(np.int64)
                    ).to(DEV)
                    g_rows = torch.empty_like(rows)
                    g_meta = torch.empty_like(meta)
                    for i, s in enumerate(shards):
                        sel = home == i
                        r, m = key_state(torch, kv, s, q[sel])
                        g_rows[sel], g_meta[sel] = r, m
                check(torch.equal(g_rows, rows),
                      f"{name} ({kind}): rows differ from the source's")
                check(torch.equal(g_meta & mask, meta & mask),
                      f"{name} ({kind}): meta words differ from the "
                      "source's")
                src = state.tables[name]
                check(all(torch.equal(s.init_pool, src.init_pool)
                          for s in shards),
                      f"{name} ({kind}): init pool differs")

        def fresh():
            return {n: kv.create(16, DLRM_ROWS, name=n, device=DEV)
                    for n in state.tables}

        imported = {}

        def leg_b(checks):
            for kind in ("uint16", "uint32"):
                with not_path(checks):
                    templates = fresh()
                got = tf_import.import_checkpoint(prefixes[kind], templates)
                for name in state.tables:
                    compare(name, got[name], kind, checks)
                imported[kind] = got
            del imported["uint16"]
            with not_path(checks):
                served = state._replace(tables=imported["uint32"])
                check(all(torch.equal(serve(served, b)[2], p)
                          for b, p in zip(requests, want_preds)),
                      "TF import: predictions differ from the source's")
            return {}

        elastic = "T1"

        def leg_c(checks):
            shards = tf_import.import_kv_variable(
                prefixes["uint32"], elastic, num_shards=TF_SHARDS,
                capacity=DLRM_ROWS // 2, device=DEV)
            res = {"rows_per_shard": [int(kv.size(s)) for s in shards]}
            check(all(s.device.type == torch.device(DEV).type
                      for s in shards),
                  "elastic import: a shard is not on the card")
            compare(elastic, shards, "uint32", checks)
            return res

        slot_table = "T0"

        def leg_d(checks):
            u64, q, _, _ = source[slot_table]
            src = state.tables[slot_table]
            with not_path(checks):
                fr = kv.find(src, q)
                m = kv.get_slot(src, opt.slot_name)[fr.slot.long(), :16] \
                    .contiguous()
                p = os.path.join(workdir, "d_slot", "model.ckpt-3")
                tf_bundle.write_bundle(p, [f"{slot_table}/m-keys",
                                           f"{slot_table}/m-values"],
                                       [u64.view(np.int64), m])
            t = imported["uint32"][slot_table]
            t = tf_import.attach_slot_rows(t, p, f"{slot_table}/m", "m")
            res = {"slot_layout": [list(x) for x in t.config.slot_layout]}
            with not_path(checks):
                fr = kv.find(t, q)
                got = kv.get_slot(t, "m")[fr.slot.long()]
                check(bool(fr.found.all()) and torch.equal(
                    got.view(torch.int32), m.view(torch.int32)),
                      "attach_slot_rows: slot rows differ from the source's")
            return res

        def leg_e(checks):
            md = serving.RankingMetadata()
            for name in sorted(state.tables):
                md.add_embedding_column(column_name=name, var_name=name,
                                        embedding_dim=16)
            d = os.path.join(workdir, "e_tfplus")
            prefix = serving.export_for_serving(d, state.tables, md,
                                                format="tfplus")
            with not_path(checks):
                templates = fresh()
            got = tf_import.import_checkpoint(prefix, templates)
            res = {"bytes": sum(file_bytes(prefix).values())}
            with not_path(checks):
                nd = os.path.join(workdir, "e_native")
                serving.export_for_serving(nd, state.tables, md)
                native, _ = serving.load_for_serving(nd, device=DEV)
                a = state._replace(tables=got)
                b = state._replace(tables=native)
                check(all(torch.equal(serve(a, r)[2], serve(b, r)[2])
                          for r in requests),
                      "TF serving export: predictions differ from the "
                      "native export's")
            return res

        run_leg("a", leg_a)
        run_leg("b", leg_b)
        run_leg("c", leg_c)
        run_leg("d", leg_d)
        del imported
        run_leg("e", leg_e)

        # (f) the CRC32C helper against its table loop
        data = np.fromfile(prefixes["uint32"] + ".data-00000-of-00001",
                           dtype=np.uint8)
        f = {"crc32c_hardware": crc32c.hardware(),
             "crc32c_bytes": int(data.nbytes)}
        check(crc32c.extend_table_loop(0, data) == crc32c.value(data),
              "CRC32C: the table loop and the helper differ")
        del data
        print(f"tf bridge (f): {json.dumps(f)}", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out["launches"] = total
    check(total["gather_rows"] > 0 and total["scatter_rows"] > 0,
          f"TF bridge: the row kernels were not launched: {total}")
    del state, source
    print(f"tf bridge: {json.dumps(out)}", flush=True)
    peak_memory(torch, "TF bridge")
    return total


def kernel_entry(name, src, replaces, launches, errs, cases, main, keys):
    """A row kernel's entry at the main case, and per case and key
    (``gather``; ``scatter``, ``scatter_add``) its time, the bound, the
    library call's and the plan's word bytes, lanes per row, words per lane
    and rows in flight."""
    case = cases[main]
    key = keys[0]
    plan_of = {"gather": "gather", "scatter": "set", "scatter_add": "add"}
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs),
            "ms": case[f"{key}_ms"], "plain_ms": case[f"{key}_plain_ms"],
            "bound_ms": case[f"{key}_bound_ms"], "bound_by": "bytes",
            "library_ms": case[f"{key}_library_ms"],
            "cases": {n: {k: [c[f"{k}_ms"], c[f"{k}_bound_ms"],
                              c[f"{k}_library_ms"],
                              [c["plan"][plan_of[k]][p] for p in (
                                  "word_bytes", "lanes_per_row",
                                  "words_per_lane", "rows_in_flight")]]
                          for k in keys}
                      for n, c in cases.items()},
            "cases_columns": ["ms", "bound_ms", "library_ms",
                              "plan: word_bytes, lanes_per_row, "
                              "words_per_lane, rows_in_flight"]}


CSRC = "tfplus_tpu_torch/ops/csrc/"


def routes_entry(name, launches, f32_case, f32_ms):
    """The keys a routed kernel adds to its entry: the main case is the
    tensor-core route's; the CUDA-core route keeps its source, its launches
    and its time at an f32 case."""
    return {"launches_by_route": {r: launches[f"{name}.{r}"] for r in ROUTES},
            "cuda_core_source": CSRC + ("flash_fwd.cu" if name == "flash_fwd"
                                        else "flash_bwd.cu"),
            "cuda_core_case": f32_case, "cuda_core_ms": f32_ms}


def attention_entry(name, replaces, launches, cases, main_case,
                    f32_case=None):
    """A forward kernel's entry; the single-pass kernel's adds, per
    single-pass case, its time, the bound and the library call's."""
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
        e.update(routes_entry(name, launches, f32_case,
                              cases[f32_case]["ms"]))
    else:
        e["cases"] = {n: {k: x[k] for k in ("ms", "bound_ms", "library_ms")}
                      for n, x in cases.items() if x["kernel"] == name}
    return e


def backward_entry(name, replaces, launches, cases, main_case,
                   f32_case=None):
    """A backward kernel's entry."""
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
        e.update(routes_entry(name, launches, f32_case,
                              cases[f32_case][name]["ms"]))
    return e


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # phase 24 starts this script again as its two ranks
    for flag in ("--rank-worker", "--world", "--port"):
        ap.add_argument(flag, type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    # phase 27 starts this script again for each example twin
    ap.add_argument("--twin", help=argparse.SUPPRESS)
    ap.add_argument("--twin-args", default="[]", help=argparse.SUPPRESS)
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
        from tfplus_tpu_torch.data import criteo, feed
        from tfplus_tpu_torch.io import native
        from tfplus_tpu_torch.kv import storage
        from tfplus_tpu_torch import parallel  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1
    if args.rank_worker is not None:
        return rank_worker(args)
    if args.twin is not None:
        return twin_worker(args)
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
    claim_cases = claim_phase(torch, np, kv)
    peak_memory(torch, "claim kernel")
    probe_cases = probe_phase(torch, np, kv)
    peak_memory(torch, "probe kernel")
    attn_cases, bench = attention_phase(torch, np, fa)
    bwd_cases, bench_grads = attention_backward_phase(torch, np, fa, bench)
    head_dim_phase(torch, np, fa)
    peak_memory(torch, "attention kernels")
    paths = [embedding_serving_phase(torch, np, kv, hashing)]
    peak_memory(torch, "embedding serving")
    paths.append(dcn_serving_phase(torch, np, kv, embedding, models, rowops))
    peak_memory(torch, "DCN serving")
    paths.append(flash_path_phase(torch, fa, bench))
    paths.append(flash_grad_path_phase(torch, fa, bench, bench_grads))
    del bench, bench_grads
    peak_memory(torch, "flash entry points")
    paths += sequence_serving_phase(torch, np, kv, embedding, models)
    peak_memory(torch, "BST/DIN serving")
    training_checks_phase(torch, np, kv, models, train, convert)
    dcn_train = dcn_training_phase(torch, np, kv, models, train)
    bst_train = bst_training_phase(torch, np, kv, models, train)
    comp_launches, comp_cases, comp_time = compactor_phase(torch, ops,
                                                           compactor)
    paths += [
        dcn_train, bst_train, comp_launches,
        growth_checkpoint_phase(torch, np, kv, models, train, checkpoint,
                                tbundle, rowops),
        repartition_phase(torch, np, kv, train, checkpoint),
        reference_growth_phase(torch, np, kv, train, packing, rowops),
        dlrm_serving_api_phase(torch, np, kv, quant, models, train, serving,
                               checkpoint, tbundle),
        *int8_lookup_and_table_ops_phase(torch, np, kv, quant, embedding,
                                         convert),
        ctr_models_phase(torch, np, kv, embedding, models, train, convert),
        criteo_training_phase(torch, np, kv, models, train, native, criteo,
                              feed),
        multi_table_phase(torch, np, kv, models, train, convert),
        hybrid_tier_phase(torch, np, kv, train, storage)]
    shard_launches = sharded_dlrm_phase(torch, np, kv, quant, models, train,
                                        convert)
    rank_launches = two_rank_phase(torch)
    remote_launches = remote_storage_phase(
        torch, np, kv, quant, models, train, serving, checkpoint, tbundle,
        rowops)
    prof_launches = profiling_phase(torch, np, kv, models, train)
    twin_launches = twins_phase(torch)
    tf_launches = tf_bridge_phase(torch, np, kv, models, train, serving,
                                  packing)
    paths += [shard_launches, rank_launches, remote_launches, prof_launches,
              twin_launches, tf_launches]

    errs = {k: [c[f"{k}_err"] for c in cases.values()]
            for k in ("gather", "scatter_set", "scatter_add")}
    check(max(max(v) for v in errs.values()) == 0.0,
          "a kernel differs from its plain version")
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
    check(dcn_train["claim_insert"] > 0
          and bst_train["claim_insert"] > 0,
          f"a training path did not launch the claim kernel: "
          f"{dcn_train} {bst_train}")
    kernels.append({
        "name": "claim_insert", "route": "cuda", "source": CSRC + "claim.cu",
        "replaces": "none: the lax.while_loop of tfplus_tpu/kv/table.py "
                    "_claim_insert (XLA code)",
        "launches": launches["claim_insert"],
        "launches_dcn_training": dcn_train["claim_insert"],
        "launches_bst_training": bst_train["claim_insert"],
        "max_abs_err": 0.0, "ms": claim_cases["dcn_lookup"]["ms"],
        "plain_ms": claim_cases["dcn_lookup"]["plain_ms"],
        "bound_ms": claim_cases["dcn_lookup"]["bound_ms"],
        "bound_by": "bytes",
        "cases": {n: [c["ms"], c["plain_ms"], c["bound_ms"], c["rounds"],
                      c["listed"]] for n, c in claim_cases.items()},
        "cases_columns": ["ms", "plain_ms", "bound_ms", "rounds", "listed"]})
    check(dcn_train["probe"] > 0 and bst_train["probe"] > 0,
          f"a training path did not launch the probe kernel: "
          f"{dcn_train} {bst_train}")
    kernels.append({
        "name": "probe", "route": "cuda", "source": CSRC + "probe.cu",
        "replaces": "none: find of tfplus_tpu/kv/table.py (XLA code)",
        "launches": launches["probe"],
        "launches_dcn_training": dcn_train["probe"],
        "launches_bst_training": bst_train["probe"],
        "max_abs_err": 0.0, "ms": probe_cases["dcn_lookup"]["ms"],
        "plain_ms": probe_cases["dcn_lookup"]["plain_ms"],
        "bound_ms": probe_cases["dcn_lookup"]["bound_ms"],
        "bound_by": "bytes",
        "cases": {n: [c["ms"], c["plain_ms"], c["bound_ms"], c["probed"],
                      c["found"]] for n, c in probe_cases.items()},
        "cases_columns": ["ms", "plain_ms", "bound_ms", "probed", "found"]})
    check(all(e["launches"] > 0 for e in kernels),
          f"a kernel was not launched on its path: {kernels}")
    # the distributed tier's paths (phases 23-24) launch rows 1-6
    slice_launches = {k: shard_launches[k] + rank_launches[k]
                      for k in shard_launches}
    check(all(slice_launches[e["name"]] > 0 for e in kernels
              if e["name"] != "compact"),
          f"phases 23-24 did not launch every kernel of their paths: "
          f"{slice_launches}")
    for e in kernels:
        e["launches_phases_23_24"] = slice_launches[e["name"]]
    # remote storage, profiling and the twins (phases 25-27) launch the row
    # kernels and, through the BST twin, the single-pass flash kernels
    slice_launches = {k: remote_launches[k] + prof_launches[k]
                      + twin_launches[k] for k in remote_launches}
    check(all(slice_launches[k] > 0 for k in (
        "gather_rows", "scatter_rows", "flash_fwd_single",
        "flash_bwd_single")),
          f"phases 25-27 did not launch every kernel of their paths: "
          f"{slice_launches}")
    for e in kernels:
        e["launches_phases_25_27"] = slice_launches[e["name"]]
    # the TFPlus bridge (phase 28): the row kernels of export and import
    check(tf_launches["gather_rows"] > 0 and tf_launches["scatter_rows"] > 0,
          f"phase 28 did not launch the row kernels: {tf_launches}")
    for e in kernels:
        e["launches_phase_28"] = tf_launches[e["name"]]
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
