#!/usr/bin/env python3
"""Time the port's flash kernels on one CUDA card, at the shapes its paths
give them.

    python3 scripts/flash_kernel_times.py [--label NAME] [--reps N] [--sweep]

Run from the root of a checkout: the script times that checkout's
``tfplus_tpu_torch``. Two checkouts run in turns on one machine (A, B, B, A)
therefore compare two versions of the kernels on one card. Its one output
line is a JSON object: the card's name and power limit, and per case and
wrapper the median of ``--reps`` CUDA-event timings, each from a cold L2.
It calls the public wrappers (``flash_fwd``, ``flash_fwd_single``,
``flash_bwd_dkv``, ``flash_bwd_dq`` and, at BST's heads, where the
checkout has it, ``flash_bwd_single``), so each version takes its own
routes.

Cases: BST's heads (f32 B2048 H8 S128 D8, histories of 1-21 tokens, the
single-pass forward); f32 B16 H8 D32 at Sq 1000 against Skv 128, with q
and kv segments that differ and a q segment that meets no key (single
pass); the bench's causal B4 H8 S2048 D128 in bf16 (the tensor-core route)
and in f32 (the CUDA-core one); causal f32 B2 H8 S1000 D64 with dropout
0.2.

``--sweep`` also times, on the two single-pass cases, the single-pass
forward kernel of ``csrc/flash_fwd_single.cu`` at each block shape it
takes (``rows/heads``: query rows and heads per block) and the earlier
single-pass kernel of ``csrc/flash_fwd.cu`` on the same inputs, and adds
them to the line under ``"sweep"``.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.getcwd())

L2_FLUSH_BYTES = 256 << 20       # > the H100's 50 MB L2


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def sweep(torch, fa, q, k, v, qs, ks, sm, reps):
    """ms of the single-pass forward (no residuals) at each block shape
    ``rows/heads``, and of the earlier single-pass kernel."""
    times = {"earlier": time_ms(torch, lambda: fa._launch(
        fa._flash_lib(), "tfp_flash_fwd_single", q, k, v, qs, ks, 0, sm, 0.0,
        False), reps)}
    lib = fa._flash_fwd_single_lib()
    tile = fa.single_fwd_tile(q.shape[3], qs is not None)
    for rows in range(tile, 129, tile):
        for heads in (1, 2, 4, 8):
            times[f"{rows}/{heads}"] = time_ms(
                torch, lambda: fa._launch(
                    lib, "tfp_flash_fwd_single_skip", q, k, v, qs, ks, 0, sm,
                    0.0, False, mid=(rows, heads)), reps)
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from tfplus_tpu_torch.ops import flash_attention as fa
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    lengths = torch.randint(1, 22, (2048,), device="cuda", generator=gen)
    bst_seg = fa.make_segment_ids_from_lengths(lengths, 128)
    # kv ids from lengths in 1-128; q ids 0 up to a length in 1-1000, then
    # 50 rows of segment 1, which meets no key, then padding
    kv_cross = fa.make_segment_ids_from_lengths(
        torch.randint(1, 129, (16,), device="cuda", generator=gen), 128)
    pos = torch.arange(1000, device="cuda")[None, :]
    n = torch.randint(1, 1001, (16, 1), device="cuda", generator=gen)
    q_cross = torch.where(pos < n, 0, torch.where(pos < n + 50, 1, -1)).to(
        torch.int32)
    cases = [("bst_f32", 2048, 8, 128, 8, torch.float32, False, bst_seg, 0.0),
             ("sq1000_skv128_f32_d32", 16, 8, (1000, 128), 32, torch.float32,
              False, (q_cross, kv_cross), 0.0),
             ("bench_causal_bf16", 4, 8, 2048, 128, torch.bfloat16, True,
              None, 0.0),
             ("bench_causal_f32", 4, 8, 2048, 128, torch.float32, True,
              None, 0.0),
             ("s1000_dropout_causal_f32", 2, 8, 1000, 64, torch.float32,
              True, None, 0.2)]
    out = {"label": args.label, "card": smi, "ms": {}}
    if args.sweep:
        out["sweep"] = {}
    for name, b, h, s, d, dtype, causal, seg, p in cases:
        sq, skv = s if isinstance(s, tuple) else (s, s)
        qs, ks = seg if isinstance(seg, tuple) else (seg, seg)
        q, do = (torch.randn(b, h, sq, d, device="cuda", generator=gen)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(b, h, skv, d, device="cuda", generator=gen)
                .to(dtype) for _ in range(2))
        sm = d ** -0.5
        if causal:
            def fwd():
                return fa.flash_fwd(q, k, v, qs, ks, 0, causal=True,
                                    sm_scale=sm, p_dropout=p)
        else:
            def fwd():
                return fa.flash_fwd_single(q, k, v, qs, ks, 0, sm_scale=sm,
                                           p_dropout=p)
        o, l, m = fwd()
        if args.sweep and not causal:
            out["sweep"][name] = sweep(torch, fa, q, k, v, qs, ks, sm,
                                       args.reps)
        bwd = (q, k, v, qs, ks, 0, do, l, m, fa._delta(do, o))
        kw = dict(causal=causal, sm_scale=sm, p_dropout=p)
        out["ms"][name] = {
            "flash_fwd" if causal else "flash_fwd_single":
                time_ms(torch, fwd, args.reps),
            "flash_bwd_dkv": time_ms(
                torch, lambda: fa.flash_bwd_dkv(*bwd, **kw), args.reps),
            "flash_bwd_dq": time_ms(
                torch, lambda: fa.flash_bwd_dq(*bwd, **kw), args.reps)}
        if not causal and hasattr(fa, "flash_bwd_single"):
            out["ms"][name]["flash_bwd_single"] = time_ms(
                torch, lambda: fa.flash_bwd_single(*bwd, sm_scale=sm,
                                                   p_dropout=p), args.reps)
        del q, k, v, do, o, l, m, bwd
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
