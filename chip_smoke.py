#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

from the repository root, on a machine with an NVIDIA Hopper card, PyTorch
built for CUDA and the CUDA toolkit. It imports nothing of JAX or of the
JAX package. It drives both serving KV layouts (the paged pool and the
per-slot contiguous caches with rolling windows), the training path, and
the paper's demonstrations (the quickstart and the Table I study).
Phases (a failing check raises, and the script exits non-zero):

1. print the card's name and power limit; build the kernels from
   ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
2. hold each CUDA kernel against its plain PyTorch version on the card:
   {exact, expmul} x {bf16 values, int8 codes} x {float32, bfloat16 q} x
   head dims {16, 64}, with dyadic inputs (exact scores) and random
   N(0,1) inputs. Paged: shuffled, fragmented block tables with NaN in
   every unreferenced page, ragged lengths and an idle row. Contiguous:
   ragged lengths, an idle row, a length of exactly S and large finite
   stale rows past each length; prefill on fresh caches and on rolling
   buffers (wrapped, shorter than the span, a chunk longer than the span,
   a window narrower than the span, n_valid = 0). Then the edges of the
   redesigned contiguous kernels: decode at S = 2048 over lengths 0, 1,
   255, 256, 257 and 2048 (0 to 8 tiles of a thread-block cluster, so
   idle ranks too) for GQA groups 1, 7 and 32, and at S = 32768 (up to 16
   rounds of the cluster, the last one partly idle) for group 7 over
   float32 values and int8 codes; and prefill chunks of C in
   {1, 15, 100, 256} rows (not multiples of the 32-row query block),
   float32 and bfloat16 q over fp32 caches and int8 codes, n_valid 0 on
   one row. And the edges of the redesigned paged kernels: decode over
   lengths 0, 1, ps - 1, ps, ps + 1 and the table's full width, and a row
   with a sentinel inside its length, for GQA groups 1, 7 and 32 at pages
   of 16 and 32 over float32 values and int8 codes, and over a
   32,768-token context (2,048 pages of 16) for group 7; prefill chunks of
   C in {1, 15, 100, 256} over 0, 1 page and 1,000 tokens of history,
   float32 and bfloat16 q. Kernel and plain version walk the same tiles
   and sum both products in the same order
   (``kernels/flash/tile.py:fma_chain``), so each is held at
   ``checks.kernel_tol``: 1e-5 of the output's magnitude, or one bf16 ulp
   for the exact variant's bfloat16 output.
   The full-sequence flash forward likewise, over {exact, expmul} x
   {float32, bfloat16} x D {64, 128} x block_k {128, 512} x {dyadic,
   random}, B 2, 14 / 2 heads: Sq = Sk in {1024, 1000} causal, with and
   without a 256-token window, and non-causal 200 queries over 1000 keys;
   and at head dim 32 (the fidelity model's) its shape and a ragged
   causal 1000; and the edges of its register-tiled layout
   (``checks.flash_edge_cases``): Sq = Sk in {1, 31, 33, 65, 1000}, causal,
   with a window ending inside a 64-row sub-tile, and over keys past
   kv_len (causal and not), GQA groups 1 and 7, D {16, 32, 64, 128} x
   {float32, bfloat16} x {dyadic, random}; then the standalone ExpMul
   kernel bit for bit against its
   plain version and the frexp/ldexp oracle (raw bits), over the
   reference's sweep and (114688, 65), float32 and bfloat16, with the
   contract's edge values, and the merged [l, o] update through it; and
   for NaN and inf x, outside the contract, kernel bits equal to the plain
   version's on the card and on the host, a NaN x leaving v unchanged (as
   the reference's L_hat 0 does);
3. qwen2-0.5b at full width in float32 (TF32 off), through the kernels and
   through the plain versions: on each layout one prefill tick, a second
   prefill tick over that history and one decode tick; then a windowed
   pair of prefill ticks (window 256, two 256-token chunks, so the
   contiguous rolling buffer wraps). Logits within 1e-3 of their
   magnitude for exact, the gap printed for ExpMul;
4. serving at full width: ``ServeEngine`` with 8 slots, 16 requests of
   128-1024 prompt tokens and 32 new tokens each, ExpMul, temperature 0,
   three times: a paged int8 pool, then contiguous caches at kv_dtype
   fp32 (the CLI's default) and int8. The kernel launch counts are set to
   0 just before each run and read just after: the run's two kernels must
   have launched, and no other kernel or plain version. Tokens/s and TTFT
   are printed beside their values before the paged kernels' redesign;
5. per-kernel times at the serving shapes (int8 codes, ExpMul, 8
   sequences of 1024 tokens, 256-token chunks, bf16 q) and, for the flash
   forward, at the training shapes (8 x 1024 tokens, float32, causal,
   ExpMul, 512-wide tiles) and, for ExpMul, at the flash recurrence's
   state of the training shapes ((114688, 64) float32 and bfloat16,
   (114688, 65) float32): the median of 25 runs timed with CUDA events
   after warm-up, L2 flushed before each, beside the plain version's time,
   the least time the card could take and each kernel's time at commits
   d4109f5 (before the contiguous kernels' redesign), 35522df (before
   the paged kernels') and 1f2c920 (before the flash kernel's); flash's
   achieved rate beside the float32 CUDA-core rate and its TF32 bound;
   with the compiler's registers and spills of the four serving kernels'
   serving instantiations and flash's training one, and the shared memory
   a CTA of each is given, as the kernel's source reports it (the paged
   decode's at 1,024 and 32,768 tokens of context, gated equal);
6. training at full width: qwen2-0.5b in float32 (TF32 off) with random
   weights, ExpMul, synthetic batches of 8 x 1024 tokens, AdamW on a
   cosine schedule. One train step through the flash kernel and one
   through its plain version from the same weights: the loss within 1e-5
   and the grad norm within 1e-4 of their values. Then 6 steps through
   ``repro_torch.launch.train.main`` with the launch counts set to 0 just
   before and read just after: every loss finite, the flash kernel
   launched 48 times a step (24 layers, twice under remat), and no other
   kernel or plain version. Then the step time (p50 of 4 steps), tokens/s,
   peak memory, and a one-step profiler window with flash's device time
   and share of the step's busy time;
7. ``python -m repro_torch.launch.quickstart`` and then ``python -m
   repro_torch.launch.fidelity`` on the card, the launch counts set to 0
   just before each and read just after: the quickstart must launch the
   ExpMul and flash kernels and no plain version, its outputs agreeing
   with the plain versions; the study (200 training steps, the four-row
   grid, the raw attention error) must launch flash only, with every
   perplexity finite; its table is printed, not gated;
8. one JSON line of kernels, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when no CUDA device is available
or when the package is not beside it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 tensor cores (float32 in)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
KERNELS = {
    "paged_decode": ("src/repro_torch/csrc/paged_decode.cu",
                     "src/repro/kernels/decode/decode.py:285"),
    "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                      "src/repro/kernels/flash/prefill.py:433"),
    "decode": ("src/repro_torch/csrc/decode.cu",
               "src/repro/kernels/decode/decode.py:144"),
    "prefill": ("src/repro_torch/csrc/prefill.cu",
                "src/repro/kernels/flash/prefill.py:245"),
    "flash": ("src/repro_torch/csrc/flash.cu",
              "src/repro/kernels/flash/flash.py:143"),
    "expmul": ("src/repro_torch/csrc/expmul.cu",
               "src/repro/kernels/expmul/expmul.py:57"),
}
PAGED, CONTIGUOUS = ("paged_decode", "paged_prefill"), ("decode", "prefill")
B, H, HKV, D, PS, MAX_LEN, CHUNK, CTX = 8, 14, 2, 64, 16, 2048, 256, 1024
TRAIN_SEQ, TRAIN_STEPS = 1024, 6
FLASH_EDGE_SEQS = (1, 31, 33, 65, 1000)
# the reference's ExpMul sweep, and the flash recurrence's merged [l, o]
# rows at the training shapes (8 sequences x 14 heads x 1024 rows)
EXPMUL_SHAPES = [(1, 1), (3, 7), (8, 16), (32, 64), (128, 256), (257, 130),
                 (64, 1024), (114688, 65)]
EXPMUL_ROWS = B * H * TRAIN_SEQ
# each kernel's phase-5 time at commit d4109f5, before the contiguous
# kernels' redesign, at 35522df, before the paged kernels', and at 1f2c920,
# before the flash kernel's (as PERF.md records them; H100 80GB HBM3, 700
# W), ms
BEFORE_MS = {
    "d4109f5": {"paged_decode": 0.2399, "paged_prefill": 1.5433,
                "decode": 0.2962, "prefill": 1.2032, "flash": 1.7984,
                "expmul": 0.0272},
    "35522df": {"paged_decode": 0.2327, "paged_prefill": 1.5343,
                "decode": 0.0210, "prefill": 0.4999, "flash": 1.8059,
                "expmul": 0.0270},
    "1f2c920": {"paged_decode": 0.0279, "paged_prefill": 0.5774,
                "decode": 0.0213, "prefill": 0.5079, "flash": 1.8068,
                "expmul": 0.0272},
}
# the serving runs at 35522df, as PERF.md records them: tokens/s of the
# final tree's run, TTFT p50 (ms) of an earlier run of that change
BEFORE_SERVE = {"paged/int8": (254.2, 988.6), "contiguous/fp32": (273.4, 1089.4),
                "contiguous/int8": (227.3, 1202.2)}


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, flush, n=25, warmup=3, hide_host=True):
    """Median over ``n`` runs of ``fn`` between two CUDA events, the L2
    flushed before each. With ``hide_host`` a ~3 ms spin kernel runs
    first, so the host has enqueued ``fn``'s launches before the start
    event fires: the interval is then device time, launch overhead
    excluded, unless ``fn`` itself waits on the host (a plain version)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(5_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build(build):
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"[build] {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        lines = build.build_log(name).splitlines()
        regs = [int(l.split("Used ")[1].split()[0]) for l in lines
                if "Used " in l and "registers" in l]
        spills = [l.strip() for l in lines if "spill stores" in l
                  and not l.strip().startswith("0 bytes stack frame, 0 bytes")]
        log(f"[build] {name}: {len(regs)} instantiations, registers "
            f"{min(regs)}-{max(regs)}, spilling instantiations {len(spills)}")


def _hold(torch, checks, name, run, case, variant, q_dtype, idle, label,
          worst):
    """The kernel against its plain version on one case: within
    ``checks.kernel_tol``, and exactly 0 on the ``idle`` rows."""
    got = run(case, variant)
    ref = run(case, variant, plain=True)
    torch.cuda.synchronize()
    err = checks.rel_err(got, ref)
    tol = checks.kernel_tol(variant, q_dtype)
    idle_max = max([float(got[i].abs().max()) for i in idle], default=0.0)
    qn = str(q_dtype).split(".")[-1]
    log(f"[check] {name} {label} q {qn} {variant}: rel err {err:.3e} "
        f"(tol {tol:g}), idle rows max {idle_max}")
    if not err <= tol or idle_max != 0.0:
        raise AssertionError(f"{name} disagrees with its plain version")
    key = f"{name} {label.split()[-1]} q {qn} {variant}"
    worst[key] = max(worst.get(key, 0.0), err)


def phase_kernel_checks(torch, checks):
    shapes = [
        dict(D=16, H=4, Hkv=2, B=4, max_blocks=24, lengths=[37, 0, 200, 16],
             pf_lengths=[40, 0, 0, 129], n_valid=[70, 0, 33, 64], chunk=70),
        dict(D=16, H=4, Hkv=2, B=4, max_blocks=24, lengths=[37, 0, 200, 16],
             pf_lengths=[40, 0, 0, 129], n_valid=[70, 0, 33, 64], chunk=70,
             window=21),
        dict(D=64, H=H, Hkv=HKV, B=B, max_blocks=MAX_LEN // PS,
             lengths=[1024, 0, 517, 1, 800, 96, 1023, 333],
             pf_lengths=[768, 0, 0, 1000, 17, 512, 64, 250],
             n_valid=[256, 0, 100, 256, 17, 256, 1, 200], chunk=CHUNK),
    ]
    worst = {}
    rng = np.random.default_rng(0)
    for sh in shapes:
        for q_dtype in (torch.float32, torch.bfloat16):
            common = dict(B=sh["B"], H=sh["H"], Hkv=sh["Hkv"], D=sh["D"],
                          page_size=PS, max_blocks=sh["max_blocks"],
                          window=sh.get("window"), q_dtype=q_dtype,
                          device="cuda")
            for kv in ("bf16", "int8"):
                for dyadic in (True, False):
                    dec = checks.paged_case(rng, lengths=sh["lengths"],
                                            kv=kv, dyadic=dyadic, **common)
                    pre = checks.paged_case(rng, lengths=sh["pf_lengths"],
                                            n_valid=sh["n_valid"],
                                            chunk=sh["chunk"], kv=kv,
                                            dyadic=dyadic, **common)
                    kind = "dyadic" if dyadic else "random"
                    label = (f"D={sh['D']} {kv} window={sh.get('window')} "
                             f"{kind}")
                    for variant in ("exact", "expmul"):
                        for name, run, case in (
                                ("paged_decode", checks.run_decode, dec),
                                ("paged_prefill", checks.run_prefill, pre)):
                            _hold(torch, checks, name, run, case, variant,
                                  q_dtype, [1], label, worst)
    # contiguous caches: decode over S slots, then prefill on a fresh cache
    # and on rolling buffers (one wrapped, one shorter than its span, one
    # full, chunks longer than the span, a window narrower than the span,
    # and n_valid = 0); a fresh cache with a window skips whole tiles
    contiguous = [
        dict(D=16, H=4, Hkv=2, B=4, S=400, lengths=[37, 0, 400, 300],
             prefill=[
                 dict(S=600, lengths=[530, 0, 17, 600],
                      n_valid=[70, 0, 33, 64], chunk=70),
                 dict(S=600, lengths=[530, 0, 17, 200],
                      n_valid=[70, 0, 33, 64], chunk=70, window=21),
                 dict(S=64, lengths=[200, 0, 30, 64], n_valid=[70, 0, 7, 70],
                      chunk=70, window=64, rolling=True),
                 dict(S=64, lengths=[200, 0, 30, 64], n_valid=[70, 0, 7, 70],
                      chunk=70, window=21, rolling=True)]),
        dict(D=64, H=H, Hkv=HKV, B=B, S=MAX_LEN,
             lengths=[1024, 0, 517, 1, 800, 96, MAX_LEN, 333],
             prefill=[
                 dict(S=MAX_LEN, lengths=[768, 0, 0, 1000, 17, 512, 64, 1792],
                      n_valid=[256, 0, 100, 256, 17, 256, 1, 200],
                      chunk=CHUNK),
                 dict(S=256, lengths=[1000, 0, 100, 256, 255, 3, 700, 512],
                      n_valid=[300, 0, 256, 300, 1, 100, 300, 0], chunk=300,
                      window=256, rolling=True),
                 dict(S=256, lengths=[1000, 0, 100, 256, 255, 3, 700, 512],
                      n_valid=[300, 0, 256, 300, 1, 100, 300, 0], chunk=300,
                      window=100, rolling=True)]),
    ]
    for sh in contiguous:
        for q_dtype in (torch.float32, torch.bfloat16):
            common = dict(B=sh["B"], H=sh["H"], Hkv=sh["Hkv"], D=sh["D"],
                          q_dtype=q_dtype, device="cuda")
            for kv in ("bf16", "int8"):
                for dyadic in (True, False):
                    kind = "dyadic" if dyadic else "random"
                    dec = checks.contiguous_case(
                        rng, S=sh["S"], lengths=sh["lengths"], kv=kv,
                        dyadic=dyadic, **common)
                    cases = [("decode", checks.run_contiguous_decode, dec,
                              f"D={sh['D']} S={sh['S']} {kv} {kind}",
                              [i for i, n in enumerate(sh["lengths"])
                               if n == 0])]
                    for pf in sh["prefill"]:
                        cases.append((
                            "prefill", checks.run_contiguous_prefill,
                            checks.contiguous_case(
                                rng, dyadic=dyadic, kv=kv, **pf, **common),
                            f"D={sh['D']} S={pf['S']} rolling="
                            f"{pf.get('rolling', False)} window="
                            f"{pf.get('window')} {kv} {kind}",
                            [i for i, (n, m) in enumerate(
                                zip(pf["lengths"], pf["n_valid"]))
                             if n == 0 and m == 0]))
                    for variant in ("exact", "expmul"):
                        for name, run, case, label, idle in cases:
                            _hold(torch, checks, name, run, case, variant,
                                  q_dtype, idle, label, worst)
    # the redesign's edges: decode over 0-8 tiles of one cluster for GQA
    # groups 1, 7 and 32, and over up to 16 rounds of a cluster at S =
    # 32768 (Qwen2-0.5B's context); prefill chunks not a multiple of the
    # 32-row query block, float32 q over fp32 caches and int8 codes
    edges = [1, 255, 256, 257, MAX_LEN, 0]
    long_ctx = 32768
    decode_edges = [(group, kv, MAX_LEN, edges)
                    for group in (1, 7) for kv in ("f32", "bf16", "int8")]
    decode_edges += [(32, kv, MAX_LEN, edges) for kv in ("f32", "int8")]
    decode_edges += [(7, kv, long_ctx, [long_ctx, 2305, 20001, 0])
                     for kv in ("f32", "int8")]
    for group, kv, S, lengths in decode_edges:
        for q_dtype in (torch.float32, torch.bfloat16):
            dec = checks.contiguous_case(
                rng, B=len(lengths), H=HKV * group, Hkv=HKV, D=D, S=S,
                lengths=lengths, kv=kv, q_dtype=q_dtype, dyadic=False,
                device="cuda")
            for variant in ("exact", "expmul"):
                _hold(torch, checks, "decode", checks.run_contiguous_decode,
                      dec, variant, q_dtype, [len(lengths) - 1],
                      f"D={D} S={S} group={group} lengths {lengths} {kv} "
                      f"random", worst)
            del dec
    for C in (1, 15, 100, CHUNK):
        nv = [C, 0, max(1, C // 3), C]
        for kv in ("f32", "int8"):
            for q_dtype in (torch.float32, torch.bfloat16):
                pre = checks.contiguous_case(
                    rng, B=4, H=H, Hkv=HKV, D=D, S=MAX_LEN,
                    lengths=[700, 0, 1500, 64], n_valid=nv, chunk=C, kv=kv,
                    q_dtype=q_dtype, dyadic=False, device="cuda")
                for variant in ("exact", "expmul"):
                    _hold(torch, checks, "prefill",
                          checks.run_contiguous_prefill, pre, variant,
                          q_dtype, [1], f"D={D} S={MAX_LEN} C={C} "
                          f"n_valid={nv} {kv} random", worst)
    _paged_edges(torch, checks, rng, worst)
    # the training path's full-sequence forward
    flash = [dict(Sq=1024, Sk=1024, causal=True, window=None),
             dict(Sq=1024, Sk=1024, causal=True, window=256),
             dict(Sq=1000, Sk=1000, causal=True, window=None),
             dict(Sq=1000, Sk=1000, causal=True, window=256),
             dict(Sq=200, Sk=1000, causal=False, window=None)]
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            for sh in flash:
                for dyadic in (True, False):
                    case = checks.flash_case(
                        rng, B=2, H=H, Hkv=HKV, D=hd, dtype=dtype,
                        dyadic=dyadic, device="cuda", **sh)
                    for block_k in (128, 512):
                        case["block_k"] = block_k
                        label = (f"D={hd} Sq={sh['Sq']} Sk={sh['Sk']} "
                                 f"causal={sh['causal']} "
                                 f"window={sh['window']} bk={block_k} "
                                 f"{'dyadic' if dyadic else 'random'}")
                        for variant in ("exact", "expmul"):
                            _hold(torch, checks, "flash", checks.run_flash,
                                  case, variant, dtype, [], label, worst)
    # head dim 32, the fidelity study's: its shape (8 x 64 tokens, 4 / 2
    # heads, one 64-wide tile) and a ragged causal 1000 over 512-wide tiles
    for dtype in (torch.float32, torch.bfloat16):
        for b, hq, s, bk in ((8, 4, 64, 64), (2, H, 1000, 512)):
            for dyadic in (True, False):
                case = checks.flash_case(
                    rng, B=b, H=hq, Hkv=HKV, D=32, Sq=s, Sk=s, dtype=dtype,
                    dyadic=dyadic, causal=True, block_k=bk, device="cuda")
                label = (f"D=32 B={b} Sq={s} Sk={s} causal=True bk={bk} "
                         f"{'dyadic' if dyadic else 'random'}")
                for variant in ("exact", "expmul"):
                    _hold(torch, checks, "flash", checks.run_flash, case,
                          variant, dtype, [], label, worst)
    # the register-tiled layout's edges: Sq = Sk off the 32-row query block
    # and the 64-row sub-tile, a window ending inside a sub-tile, keys past
    # kv_len, GQA groups 1 and 7, every head dim
    for S in FLASH_EDGE_SEQS:
        for hd in (16, 32, 64, 128):
            for group in (1, 7):
                for dtype in (torch.float32, torch.bfloat16):
                    for dyadic in (True, False):
                        kind = "dyadic" if dyadic else "random"
                        for label, case in checks.flash_edge_cases(
                                rng, S=S, D=hd, group=group, dtype=dtype,
                                dyadic=dyadic, device="cuda"):
                            for variant in ("exact", "expmul"):
                                _hold(torch, checks, "flash", checks.run_flash,
                                      case, variant, dtype, [],
                                      f"D={hd} S={S} group={group} {label} "
                                      f"{kind}", worst)
    log(f"[check] worst rel err: {json.dumps(worst)}")


def _paged_edges(torch, checks, rng, worst):
    """The paged redesign's edges: decode over lengths 0, 1, ps - 1, ps,
    ps + 1 and the table's full width (2,048 tokens), and a row whose table
    holds a sentinel inside its length (clamped to the last pool block),
    for GQA groups 1, 7 and 32 at pages of 16 and 32 (one round of a
    cluster to 2,048 / (8 x 128) = 2 rounds, idle ranks), over float32
    values and int8 codes; a 32,768-token context (2,048 pages of 16: 32
    rounds) for group 7 over both; prefill chunks of C in {1, 15, 100,
    256} rows over 0, 1 page and 1,000 tokens of history, float32 and
    bfloat16 q, one row idle."""
    for ps in (PS, 2 * PS):
        mb = MAX_LEN // ps
        lengths = [0, 1, ps - 1, ps, ps + 1, mb * ps, 5 * ps + 3]
        for group in (1, 7, 32):
            for kv in ("f32", "int8"):
                for q_dtype in (torch.float32, torch.bfloat16):
                    dec = checks.paged_case(
                        rng, B=len(lengths), H=HKV * group, Hkv=HKV, D=D,
                        page_size=ps, max_blocks=mb, lengths=lengths, kv=kv,
                        q_dtype=q_dtype, dyadic=False, device="cuda")
                    checks.sentinel_within(dec, len(lengths) - 1, 2)
                    for variant in ("exact", "expmul"):
                        _hold(torch, checks, "paged_decode", checks.run_decode,
                              dec, variant, q_dtype, [0],
                              f"D={D} ps={ps} group={group} lengths {lengths} "
                              f"(a sentinel in the last) {kv} random", worst)
                    del dec
    long_ctx = 32768
    lengths = [long_ctx, 2305, 20001, 0]
    for kv in ("f32", "int8"):
        dec = checks.paged_case(
            rng, B=len(lengths), H=HKV * 7, Hkv=HKV, D=D, page_size=PS,
            max_blocks=long_ctx // PS, lengths=lengths, kv=kv,
            q_dtype=torch.bfloat16, dyadic=False, device="cuda")
        for variant in ("exact", "expmul"):
            _hold(torch, checks, "paged_decode", checks.run_decode, dec,
                  variant, torch.bfloat16, [3], f"D={D} ps={PS} group=7 "
                  f"lengths {lengths} {kv} random", worst)
        del dec
    for C in (1, 15, 100, CHUNK):
        nv = [C, C, max(1, C // 3), 0]
        for kv in ("f32", "int8"):
            for q_dtype in (torch.float32, torch.bfloat16):
                pre = checks.paged_case(
                    rng, B=4, H=H, Hkv=HKV, D=D, page_size=PS,
                    max_blocks=MAX_LEN // PS, lengths=[0, PS, 1000, 0],
                    n_valid=nv, chunk=C, kv=kv, q_dtype=q_dtype,
                    dyadic=False, device="cuda")
                for variant in ("exact", "expmul"):
                    _hold(torch, checks, "paged_prefill", checks.run_prefill,
                          pre, variant, q_dtype, [3], f"D={D} C={C} history "
                          f"[0, {PS}, 1000, 0] n_valid={nv} {kv} random",
                          worst)


def _bits_repr(torch, t):
    w = torch.int32 if t.dtype == torch.float32 else torch.int16
    mask = 0xFFFFFFFF if t.dtype == torch.float32 else 0xFFFF
    return [f"{float(a):g}/0x{int(b) & mask:x}" for a, b in
            zip(t.float().flatten().tolist(), t.view(w).flatten().tolist())]


def phase_expmul_checks(torch, checks, build, ops):
    """The ExpMul kernel bit for bit against its plain version and the
    frexp/ldexp oracle, on the card, over the reference's sweep and the
    merged [l, o] rows of the training shapes, in both dtypes, with the
    contract's edge values (``checks.expmul_case``); the merged update
    through the kernel against the bit path (two launches, logged and
    gated here; no entry point calls it); then NaN and inf x, outside the
    contract: kernel bits equal to the plain version's on the card and on
    the host, a NaN x leaving v unchanged (L_hat 0, as the reference)."""
    from repro_torch.kernels.expmul.expmul import expmul_fwd_plain
    from repro_torch.numerics.log2exp import expmul as expmul_bits

    rng = np.random.default_rng(10)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in EXPMUL_SHAPES:
            x, v = checks.expmul_case(rng, *shape, dtype=dtype)
            views = [("", v)]
            if shape == (257, 130):      # a misaligned, strided view
                views.append((" view[:, 1:]", v[:, 1:]))
            for label, vv in views:
                got, plain, oracle = checks.run_expmul(x, vv)
                torch.cuda.synchronize()
                ok = (checks.same_bits(got, plain)
                      and checks.same_bits(got, oracle))
                log(f"[expmul] {shape}{label} "
                    f"{str(dtype).split('.')[-1]}: kernel == plain == "
                    f"oracle bit for bit: {ok}")
                if not ok:
                    raise AssertionError("the ExpMul kernel disagrees")
    rows, d1 = EXPMUL_ROWS, D + 1
    o_star, v_star = (torch.randn(rows, d1, device="cuda") for _ in range(2))
    m_prev = torch.rand(rows, device="cuda") * 4 - 3
    m_cur = torch.maximum(m_prev, torch.rand(rows, device="cuda") * 4 - 3)
    s = m_cur - torch.rand(rows, device="cuda") * 18
    before = build.COUNTS["expmul"]
    got = ops.merged_output_update(o_star, v_star, m_prev, m_cur, s)
    per_update = build.COUNTS["expmul"] - before
    want = (expmul_bits((m_prev - m_cur)[:, None], o_star)
            + expmul_bits((s - m_cur)[:, None], v_star))
    torch.cuda.synchronize()
    ok = checks.same_bits(got, want)
    log(f"[expmul] merged [l, o] update ({rows}, {d1}): {per_update} "
        f"kernel launches, equal to the bit path bit for bit: {ok}")
    if not ok or per_update != 2:
        raise AssertionError("the merged update through the kernel")
    nan, inf = float("nan"), float("inf")
    x = torch.tensor([nan, inf, -inf, 0.0], device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        v = torch.tensor([[nan, inf, -inf, 1.0, -1.0]] * 4,
                         device="cuda").to(dtype)
        got, plain, _ = checks.run_expmul(x, v)
        host = expmul_fwd_plain(x.cpu(), v.cpu())
        for i, xi in enumerate(x.tolist()):
            ok = (checks.same_bits(got[i], plain[i])
                  and checks.same_bits(got[i].cpu(), host[i])
                  and (xi == xi or checks.same_bits(got[i], v[i])))
            log(f"[expmul] out of contract, {str(dtype).split('.')[-1]} "
                f"x={xi}: v {_bits_repr(torch, v[i])} -> kernel "
                f"{_bits_repr(torch, got[i])}; kernel == plain on the card "
                f"== plain on the host{', v unchanged' if xi != xi else ''}: "
                f"{ok}")
            if not ok:
                raise AssertionError("ExpMul out of contract: the kernel "
                                     "disagrees with its plain version")


def _ticks(torch, api, params, cfg, layout, bt, toks, chunks, tok1):
    """Logits of prefill ticks over ``chunks`` (then one decode tick when
    ``tok1`` is given) on a fresh state of ``layout``, with the rows each
    tick's logits are defined for."""
    if layout == "paged":
        state = api.init_paged_state(cfg, B, bt.numel(), PS, device="cuda")
    else:
        state = api.init_decode_state(cfg, B, MAX_LEN, device="cuda")
    lens = torch.zeros(B, dtype=torch.int32, device="cuda")
    out = []
    for tk, nv in zip(toks, chunks):
        nv = torch.tensor(nv, dtype=torch.int32, device="cuda")
        if layout == "paged":
            lg, state = api.prefill_paged(params, state, tk, lens, nv, bt,
                                          cfg, page_size=PS)
        else:
            lg, state = api.prefill(params, state, tk, lens, nv, cfg)
        out.append((lg, nv > 0))
        lens = lens + nv
    if tok1 is not None:
        if layout == "paged":
            lg, state = api.decode_step_paged(params, state, tok1, lens, bt,
                                              cfg, page_size=PS)
        else:
            lg, state = api.decode_step(params, state, tok1, lens, cfg)
        out.append((lg, torch.ones(B, dtype=torch.bool, device="cuda")))
    torch.cuda.synchronize()
    return out


def phase_model_ticks(torch, cfg_mod, api):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = cfg_mod.get_config("qwen2-0.5b", dtype="float32",
                              param_dtype="float32", kv_dtype="int8")
    params = api.init_model(base, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    rng = np.random.default_rng(1)
    mb = MAX_LEN // PS
    bt = torch.from_numpy(rng.permutation(B * mb).astype(np.int32)
                          .reshape(B, mb)).cuda()
    chunks = [[256, 0, 100, 256, 17, 256, 1, 200],
              [256, 0, 40, 256, 256, 10, 0, 256]]
    toks = [torch.from_numpy(rng.integers(1, base.vocab_size, (B, CHUNK))
                             .astype(np.int32)).cuda() for _ in chunks]
    tok1 = torch.from_numpy(rng.integers(1, base.vocab_size, B)
                            .astype(np.int32)).cuda()
    # the windowed pair: a 256-slot rolling buffer that the second chunk
    # wraps (rows of 356-512 tokens)
    runs = [("paged", None, chunks, tok1), ("contiguous", None, chunks, tok1),
            ("contiguous", 256, [chunks[0], [256, 0, 256, 256, 256, 10, 0,
                                             256]], None)]
    for layout, window, chs, t1 in runs:
        for variant in ("exact", "expmul"):
            logits = {}
            for impl in ("kernel", "plain"):
                cfg = base.replace(attention_variant=variant,
                                   attention_impl=impl, window=window)
                t0 = time.perf_counter()
                logits[impl] = _ticks(torch, api, params, cfg, layout, bt,
                                      toks, chs, t1)
                log(f"[model] {layout} window={window} {variant} {impl}: "
                    f"{len(logits[impl])} ticks in "
                    f"{time.perf_counter() - t0:.2f} s")
            for i, ((a, rows), (b, _)) in enumerate(zip(logits["kernel"],
                                                        logits["plain"])):
                a, b = a[rows].double(), b[rows].double()
                if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                    raise AssertionError("non-finite logits")
                gap = float((a - b).abs().max() / b.abs().max())
                tick = ["prefill", "prefill over history", "decode"][i]
                log(f"[model] {layout} window={window} {variant} {tick}: "
                    f"max|dlogits| / max|logits| = {gap:.3e} "
                    f"(max|logits| {float(b.abs().max()):.3f})")
                if variant == "exact" and not gap <= 1e-3:
                    raise AssertionError("kernel logits disagree with plain")
    del params
    torch.cuda.empty_cache()


def _serve_run(torch, build, ServeEngine, params, cfg, prompts, kw, pair):
    """Serve ``prompts`` (32 new tokens each) on a fresh engine with the
    launch counts set to 0 just before and read just after: the ``pair``
    of kernels of the layout must have launched, and nothing else (no
    other kernel, no plain version). Returns (counts, per-step launches,
    the streams)."""
    label = f"{kw['kv_layout']}/{kw['kv_dtype']}"
    warm = ServeEngine(params, cfg, **kw)              # cuBLAS, allocator
    for p in prompts[:2]:
        warm.submit(p[:300], 2)
    warm.run()
    del warm
    eng = ServeEngine(params, cfg, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, 32) for p in prompts]
    tick_ms = {"prefill": [], "decode": []}
    while True:           # eng.run(), with each tick timed by its kind
        before = eng.prefill_steps
        t = time.perf_counter()
        busy = eng.tick()
        torch.cuda.synchronize()
        if eng.ticks and busy:
            kind = "prefill" if eng.prefill_steps > before else "decode"
            tick_ms[kind].append((time.perf_counter() - t) * 1e3)
        if not (busy or eng.queue):
            break
    wall = time.perf_counter() - t0
    counts = dict(build.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    if not all(r.done and r.finish_reason == "length" and len(r.out) == 32
               for r in reqs):
        raise AssertionError(f"{label}: a request did not finish with "
                             f"'length'")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out):
        raise AssertionError(f"{label}: a sampled token is out of the "
                             f"vocabulary")
    if not all(counts.get(name, 0) > 0 for name in pair):
        raise AssertionError(f"{label}: the serving run missed a kernel: "
                             f"{counts}")
    if any(n for name, n in counts.items() if name not in pair):
        raise AssertionError(f"{label}: another kernel or a plain version "
                             f"ran while serving: {counts}")
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in reqs]
    gen = eng.tokens_generated
    log(f"[serve] {label}: 16 requests, prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens ({eng.prompt_tokens} in all), "
        f"32 new each: {eng.ticks} steps ({eng.prefill_steps} prefill, "
        f"{eng.decode_steps} decode), {gen} tokens generated in {wall:.3f} s "
        f"= {gen / wall:.1f} tokens/s; TTFT from submit p50 "
        f"{statistics.median(ttft):.1f} ms, max {max(ttft):.1f} ms; peak "
        f"memory {peak / 2**30:.2f} GiB; preemptions {eng.preemptions}")
    tps0, ttft0 = BEFORE_SERVE[label]
    log(f"[serve] {label}: at 35522df {tps0} tokens/s, TTFT p50 {ttft0} ms "
        f"(not gated)")
    log(f"[serve] {label}: launches {json.dumps(counts)}")
    log(f"[serve] {label}: tick wall time, ms: prefill p50 "
        f"{statistics.median(tick_ms['prefill']):.2f} (sum "
        f"{sum(tick_ms['prefill']):.1f}), decode p50 "
        f"{statistics.median(tick_ms['decode']):.2f} (sum "
        f"{sum(tick_ms['decode']):.1f})")
    dec, pre = pair
    per_step = {dec: counts[dec] / eng.decode_steps,
                pre: counts[pre] / eng.prefill_steps}
    return counts, per_step, [r.out for r in reqs]


def phase_serve(torch, cfg_mod, api, build, ServeEngine):
    cfg = cfg_mod.get_config("qwen2-0.5b")          # bf16, ExpMul
    assert cfg.attention_variant == "expmul" and cfg.dtype == "bfloat16"
    params = api.init_model(cfg, torch.Generator(device="cuda").manual_seed(2),
                            device="cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(128, 1025, size=16)]
    kw = dict(kv_layout="paged", page_size=PS, kv_dtype="int8", slots=B,
              max_len=MAX_LEN, chunk_size=CHUNK, temperature=0.0,
              attention_impl="kernel", device="cuda")
    counts, per_step, paged = _serve_run(torch, build, ServeEngine, params,
                                         cfg, prompts, kw, PAGED)
    phase_profile(torch, ServeEngine, params, cfg, kw, prompts)
    # the contiguous kernels' launches are those of the int8 run, which
    # the timings of phase 5 match; the fp32 run's are kept beside them
    launches = {name: dict(launches=counts[name],
                           launches_per_step=per_step[name])
                for name in PAGED}
    streams = {}
    for kv_dtype in ("fp32", "int8"):
        ckw = dict(kw, kv_layout="contiguous", kv_dtype=kv_dtype)
        del ckw["page_size"]
        counts, per_step, streams[kv_dtype] = _serve_run(
            torch, build, ServeEngine, params, cfg, prompts, ckw, CONTIGUOUS)
        for name in CONTIGUOUS:
            launches.setdefault(name, {}).update(
                {"launches": counts[name],
                 "launches_per_step": per_step[name]} if kv_dtype == "int8"
                else {"launches_fp32": counts[name]})
    phase_profile(torch, ServeEngine, params, cfg, ckw, prompts)
    same = sum(a == b for x, y in zip(paged, streams["int8"])
               for a, b in zip(x, y))
    first = sum(x[0] == y[0] for x, y in zip(paged, streams["int8"]))
    log(f"[serve] temp-0 agreement, paged int8 vs contiguous int8 (ExpMul "
        f"results depend on the tile width, so no gate): {same} of "
        f"{sum(map(len, paged))} tokens at the same position, first "
        f"tokens {first} of {len(paged)}")
    del params
    torch.cuda.empty_cache()
    return launches


def _profile_window(torch, fn, label):
    """Wall time, device busy time, idle share and the top six device
    kernels of one call of ``fn``, from torch.profiler. Returns the busy
    time and {kernel name: (us, launches)}, both empty when the profiler
    reported no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = sum(us for us, _ in kernels.values())
    if not busy:
        log(f"[profile] {label}: the profiler reported no device time")
        return 0.0, {}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    log(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}; top "
        f"kernels (ms): " + "; ".join(f"{name[:60]} {us / 1e3:.3f}"
                                      for name, (us, _) in top))
    return busy, kernels


def phase_profile(torch, ServeEngine, params, cfg, kw, prompts):
    """Device busy share and the top device kernels over one prefill tick
    and four decode ticks of a serving path, from torch.profiler."""
    eng = ServeEngine(params, cfg, **kw)
    for p in prompts[:8]:
        eng.submit(p[:200], 8)
    for kind, n in (("prefill", 1), ("decode", 4)):
        if kind == "decode":
            while eng.prefill_steps == 0 or any(
                    r is not None and r.pos < len(r.prefill_toks)
                    for r in eng.requests):
                eng.tick()
        _profile_window(torch, lambda: [eng.tick() for _ in range(n)],
                        f"{kw['kv_layout']}/{kw['kv_dtype']} {kind} x{n}")
    eng.run()


def phase_train(torch, cfg_mod, api, build):
    """Full-width training: the kernel against the plain version on one
    step, the launcher's 6 steps gated on the launch counts, then step
    time, memory and a profile. Returns the flash kernel's launches."""
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.launch import train as launch
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train.step import build_train_step, make_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = cfg_mod.get_config("qwen2-0.5b", dtype="float32",
                              param_dtype="float32",
                              attention_variant="expmul")
    assert base.remat and base.attention_block_k == 512 \
        and base.kv_dtype == "fp32"
    data = SyntheticLMDataset(base.vocab_size, TRAIN_SEQ, seed=0)
    batch = {"tokens": torch.from_numpy(data.batch(0, B)).cuda()}
    params = api.init_model(base, torch.Generator(device="cuda").manual_seed(5),
                            device="cuda")
    opt = adamw(cosine_schedule(3e-3, 20, TRAIN_STEPS))

    # 1. one step through the kernel and one through the plain version
    metrics = {}
    for impl in ("kernel", "plain"):
        step = build_train_step(base.replace(attention_impl=impl), opt)
        t0 = time.perf_counter()
        _, m = step(make_train_state(params, opt), batch)
        metrics[impl] = {k: float(v) for k, v in m.items()}
        log(f"[train] one step, attention {impl}: loss "
            f"{metrics[impl]['loss']:.7f}, grad norm "
            f"{metrics[impl]['grad_norm']:.7f} "
            f"({time.perf_counter() - t0:.2f} s)")
        del m
        torch.cuda.empty_cache()
    (lk, gk), (lp, gp) = ((metrics[i]["loss"], metrics[i]["grad_norm"])
                          for i in ("kernel", "plain"))
    dl, dg = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
    log(f"[train] kernel vs plain: loss {dl:.3e} (limit 1e-5), grad norm "
        f"{dg:.3e} (limit 1e-4) of their values")
    if not (dl <= 1e-5 and dg <= 1e-4):
        raise AssertionError("the train step through the flash kernel "
                             "disagrees with the plain version")

    # 2. the launcher, 6 steps, with the launch counts gated
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    losses = launch.main(["--steps", str(TRAIN_STEPS), "--batch", str(B),
                          "--seq", str(TRAIN_SEQ), "--variant", "expmul",
                          "--log-every", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.COUNTS)
    log(f"[train] launcher: {len(losses)} steps of {B} x {TRAIN_SEQ} "
        f"tokens in {wall:.2f} s (init included); losses "
        f"{json.dumps([round(x, 5) for x in losses])}; launches "
        f"{json.dumps(counts)}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"the launcher's losses: {losses}")
    per_step = 2 * base.num_layers
    if counts.get("flash", 0) != per_step * TRAIN_STEPS:
        raise AssertionError(f"flash launched {counts.get('flash', 0)} "
                             f"times, not {per_step} a step")
    if any(n for name, n in counts.items() if name != "flash"):
        raise AssertionError(f"another kernel or a plain version ran while "
                             f"training: {counts}")

    # 3. step time, tokens/s, peak memory, one profiled step
    params = api.init_model(base, torch.Generator(device="cuda").manual_seed(5),
                            device="cuda")
    state = make_train_state(params, opt)
    del params
    step = build_train_step(base, opt)
    state, _ = step(state, batch)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(4):
        tb = {"tokens": torch.from_numpy(data.batch(i + 1, B)).cuda()}
        t = time.perf_counter()
        state, m = step(state, tb)
        float(m["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    p50 = statistics.median(times)
    log(f"[train] step time, ms: p50 {p50:.1f} (steps "
        f"{', '.join(f'{x:.1f}' for x in times)}); {B * TRAIN_SEQ / p50 * 1e3:.1f} "
        f"tokens/s; peak memory {peak / 2**30:.2f} GiB")

    def one_step():
        nonlocal state
        state, m = step(state, batch)
        float(m["loss"])

    busy, kernels = _profile_window(torch, one_step, "train step x1")
    flash = [(us, n) for name, (us, n) in kernels.items()
             if "flash_kernel" in name]
    if busy:
        us, n = sum(u for u, _ in flash), sum(c for _, c in flash)
        log(f"[train] flash in the profiled step: {us / 1e3:.3f} ms of "
            f"{busy / 1e3:.2f} ms device busy ({us / busy:.1%}), {n} "
            f"launches")
    del state
    torch.cuda.empty_cache()
    return {"flash": dict(launches=counts["flash"],
                          launches_per_step=per_step)}


def _bounds(name, lengths, n_valid=None):
    """(bytes, flops) the function needs at these lengths: each input read
    once (q, the resident codes and scale rows, the chunk, the block
    tables of a paged kernel, the lengths), each output written once; 4*D
    flops per (query, key) pair."""
    L = np.asarray(lengths, np.int64)
    decode = name.endswith("decode")
    q_out = 2 * 2 * B * H * D * (1 if decode else CHUNK)
    cache = int((HKV * L * (2 * D + 2 * 4)).sum())          # codes + scales
    if name.startswith("paged"):
        meta = int((-(-L // PS) * 4).sum()) + 4 * B * 2
    else:
        meta = 4 * B * (1 if decode else 2)
    if decode:
        pairs = int((H * L).sum())
        return q_out + cache + meta, 4 * D * pairs
    nv = np.asarray(n_valid, np.int64)
    chunk = B * HKV * CHUNK * (2 * D + 2 * 4)
    pairs = int((H * (CHUNK * L + nv * (nv + 1) // 2)).sum())
    return q_out + cache + chunk + meta, 4 * D * pairs


def phase_times(torch, checks, F):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(4)
    common = dict(B=B, H=H, Hkv=HKV, D=D, q_dtype=torch.bfloat16,
                  dyadic=False, device="cuda")
    paged = dict(common, page_size=PS, max_blocks=MAX_LEN // PS)
    lens, nv = [CTX] * B, [CHUNK] * B
    pf = dict(lengths=lens, n_valid=nv, chunk=CHUNK)
    out = {}
    for name, run, make in (
            ("paged_decode", checks.run_decode,
             lambda kv: checks.paged_case(rng, kv=kv, lengths=lens, **paged)),
            ("paged_prefill", checks.run_prefill,
             lambda kv: checks.paged_case(rng, kv=kv, **pf, **paged)),
            ("decode", checks.run_contiguous_decode,
             lambda kv: checks.contiguous_case(rng, kv=kv, S=MAX_LEN,
                                               lengths=lens, **common)),
            ("prefill", checks.run_contiguous_prefill,
             lambda kv: checks.contiguous_case(rng, kv=kv, S=MAX_LEN, **pf,
                                               **common))):
        case = make("int8")
        got = run(case, "expmul")
        ref = run(case, "expmul", plain=True)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        rel = checks.rel_err(got, ref)
        if not rel <= checks.kernel_tol("expmul", torch.bfloat16):
            raise AssertionError(f"{name} disagrees at the serving shapes")
        ms = median_ms(torch, lambda: run(case, "expmul"), flush)
        host_ms = median_ms(torch, lambda: run(case, "expmul"), flush,
                            hide_host=False)
        plain_ms = median_ms(torch, lambda: run(case, "expmul", plain=True),
                             flush)
        nbytes, flops = _bounds(name, lens, nv)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        # the yardstick: the exact variant on bf16 values, and SDPA over a
        # dense bf16 copy of the same history (no paging, no quantization)
        case16 = make("bf16")
        exact_ms = median_ms(torch, lambda: run(case16, "exact"), flush)
        C = 1 if name.endswith("decode") else CHUNK
        q = torch.randn(B, H, C, D, device="cuda", dtype=torch.bfloat16)
        k = torch.randn(B, HKV, CTX + C - (C == 1), D, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn_like(k)
        mask = None
        if C > 1:    # chunk rows see the history and the chunk causally
            mask = (torch.arange(CTX + C, device="cuda")[None, :]
                    <= CTX + torch.arange(C, device="cuda")[:, None])
        sdpa_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), flush)
        del case, case16
        out[name] = dict(
            max_abs_err=err, ms=ms, ms_with_launch=host_ms,
            plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None,
            yardstick={"what": "exact variant, bf16 values vs SDPA over a "
                       "dense bf16 copy", "kernel_ms": exact_ms,
                       "library_ms": sdpa_ms})
        log(f"[time] {name} (int8 codes, ExpMul, B={B}, ctx {CTX}"
            f"{', chunk %d' % CHUNK if C > 1 else ''}): kernel {ms:.4f} ms "
            f"on the device, {host_ms:.4f} ms with its launch, "
            f"plain {plain_ms:.4f} ms, bound {max(t_bytes, t_ops) * 1e3:.4f} "
            f"ms ({out[name]['bound_by']}: {nbytes} B, {flops} flop), "
            f"max abs err {err:.3e} (rel {rel:.3e}); yardstick exact bf16 "
            f"kernel {exact_ms:.4f} ms vs SDPA dense {sdpa_ms:.4f} ms")
    out["flash"] = _time_flash(torch, checks, F, flush, rng)
    out["expmul"] = _time_expmul(torch, checks, flush, rng)
    for name, r in out.items():
        log(f"[time] {name}: {r['ms']:.4f} ms; " + ", ".join(
            f"at {commit} {ms[name]:.4f} ms ({ms[name] / r['ms']:.2f}x)"
            for commit, ms in BEFORE_MS.items()))
    return out


# the main-path instantiations of the kernels, as the compiler names them:
# the serving kernels' (int8 codes, D 64, ExpMul) and flash's training one
# (float32, D 64, ExpMul)
MAIN_ENTRY = {"decode": "decode_kernelIaLi64ELb1EE",
              "prefill": "prefill_kernelIaLi64ELb1EE",
              "paged_decode": "paged_decode_kernelIaLi64ELb1EE",
              "paged_prefill": "paged_prefill_kernelIaLi64ELb1EE",
              "flash": "flash_kernelIfLi64ELb1EE"}


def phase_resources(build, decode, prefill, flash):
    """Registers and spills of the kernels' main-path instantiations
    (nvcc -Xptxas -v), and the shared memory each gives a CTA, as the
    kernel's own source computes it (its C query). The paged decode's must
    be the same at 1,024 and at 32,768 tokens of context. Returns flash's
    registers, spills and shared memory at the training shapes."""
    import ctypes

    import torch
    smem = {}
    lib = build.load("decode", decode._CONTIGUOUS_SIGNATURE)
    fn = lib.contiguous_decode_smem
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 4
    for group, dtype in ((H // HKV, torch.int8), (H // HKV, torch.float32),
                         (32, torch.float32)):
        smem[f"decode group {group} {dtype}"] = fn(
            group, D, 256, decode.KV_DTYPES[dtype])
    lib = build.load("prefill", prefill._CONTIGUOUS_SIGNATURE)
    fn = lib.contiguous_prefill_smem
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 2
    smem["prefill bk 512"] = fn(D, 512)
    lib = build.load("paged_decode", decode._SIGNATURE)
    fn = lib.paged_decode_smem
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 5
    for group, dtype in ((H // HKV, torch.int8), (H // HKV, torch.float32),
                         (32, torch.float32)):
        at = {ctx: fn(group, D, PS, ctx // PS, decode.KV_DTYPES[dtype])
              for ctx in (CTX, 32768)}
        if len(set(at.values())) != 1 or min(at.values()) <= 0:
            raise AssertionError(f"paged_decode's shared memory grows with "
                                 f"the context: {at}")
        smem[f"paged_decode group {group} {dtype} (ctx {CTX} and 32768)"] = \
            at[CTX]
    lib = build.load("paged_prefill", prefill._SIGNATURE)
    fn = lib.paged_prefill_smem
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int]
    smem["paged_prefill (static)"] = fn(D)
    for hd in flash.HEAD_DIMS:
        smem[f"flash D {hd} bk 512"] = flash.smem_bytes(hd, 512)
    info = {}
    for name, entry in MAIN_ENTRY.items():
        lines = build.build_log(name).splitlines()
        at = [i for i, l in enumerate(lines)
              if "Compiling entry function" in l and entry in l]
        if not at:
            raise AssertionError(f"no compiler report for {entry}")
        info[name] = " | ".join(l.split(":", 1)[-1].strip()
                                if "ptxas" in l else l.strip()
                                for l in lines[at[0] + 1:at[0] + 5]
                                if "registers" in l or "spill" in l)
        log(f"[resources] {name} ({entry}): {info[name]}")
    log(f"[resources] shared memory a CTA, B (any S or context): "
        f"{json.dumps(smem)}")
    return {"flash": {"ptxas": info["flash"],
                      "smem_bytes": smem[f"flash D {D} bk 512"]}}


def _time_expmul(torch, checks, flush, rng):
    """The ExpMul kernel at the flash recurrence's state of the training
    shapes, rows = 8 x 14 x 1024: (rows, 64) float32 and bfloat16 and the
    merged (rows, 65) float32; bytes once each (x, v in, out) at the HBM
    rate; the yardstick is ``exact_expmul``, the paper's unfused baseline
    (``torch.exp``, then a broadcast multiply), a different function: no
    PyTorch call computes the quantized one."""
    from repro_torch.kernels.expmul.expmul import expmul_fwd, expmul_fwd_plain
    from repro_torch.numerics.log2exp import exact_expmul

    shapes = []
    for d, dtype in ((D, torch.float32), (D, torch.bfloat16),
                     (D + 1, torch.float32)):
        x, v = checks.expmul_case(rng, EXPMUL_ROWS, d, dtype=dtype)
        got, plain = expmul_fwd(x, v), expmul_fwd_plain(x, v)
        torch.cuda.synchronize()
        if not checks.same_bits(got, plain):
            raise AssertionError("expmul disagrees at the timing shapes")
        err = float((got.float() - plain.float()).abs().max())
        ms = median_ms(torch, lambda: expmul_fwd(x, v), flush)
        host_ms = median_ms(torch, lambda: expmul_fwd(x, v), flush,
                            hide_host=False)
        plain_ms = median_ms(torch, lambda: expmul_fwd_plain(x, v), flush)
        x2 = x[:, None]
        exact_ms = median_ms(torch, lambda: exact_expmul(x2, v), flush)
        nbytes = 4 * EXPMUL_ROWS + 2 * v.numel() * v.element_size()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        dt = str(dtype).split(".")[-1]
        shapes.append(dict(shape=[EXPMUL_ROWS, d], dtype=dt, max_abs_err=err,
                           ms=ms, ms_with_launch=host_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bytes=nbytes,
                           exact_expmul_ms=exact_ms))
        log(f"[time] expmul ({EXPMUL_ROWS}, {d}) {dt}: kernel {ms:.4f} ms on "
            f"the device ({nbytes / ms / 1e6:.0f} GB/s, "
            f"{bound_ms / ms:.1%} of the HBM bound), {host_ms:.4f} ms with "
            f"its launch, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"(bytes: {nbytes} B), max abs err {err:g}; yardstick "
            f"exact_expmul {exact_ms:.4f} ms")
        del x, v, got, plain
    first = shapes[0]
    return dict(max_abs_err=first["max_abs_err"], ms=first["ms"],
                ms_with_launch=first["ms_with_launch"],
                plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                bound_by="bytes", library_ms=None,
                yardstick={"what": "exact_expmul: torch.exp then a "
                           "broadcast multiply (the unfused baseline, not "
                           "the same function)",
                           "ms": first["exact_expmul_ms"]},
                shapes=shapes)


def _time_flash(torch, checks, F, flush, rng):
    """The flash forward at the training shapes: 8 x 1024 tokens, 14 / 2
    heads of 64, float32, causal, ExpMul, 512-wide tiles (the training
    path's min(512, S)); the library yardstick is SDPA on the same float32
    q, k, v (the exact variant's function)."""
    S = TRAIN_SEQ
    case = checks.flash_case(rng, B=B, H=H, Hkv=HKV, Sq=S, Sk=S, D=D,
                             dtype=torch.float32, dyadic=False, causal=True,
                             block_k=512, device="cuda")
    got = checks.run_flash(case, "expmul")
    ref = checks.run_flash(case, "expmul", plain=True)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = checks.rel_err(got, ref)
    if not rel <= checks.kernel_tol("expmul", torch.float32):
        raise AssertionError("flash disagrees at the training shapes")
    ms = median_ms(torch, lambda: checks.run_flash(case, "expmul"), flush)
    host_ms = median_ms(torch, lambda: checks.run_flash(case, "expmul"),
                        flush, hide_host=False)
    plain_ms = median_ms(torch, lambda: checks.run_flash(case, "expmul",
                                                         plain=True), flush)
    exact_ms = median_ms(torch, lambda: checks.run_flash(case, "exact"),
                         flush)
    q, k, v = case["q"], case["k"], case["v"]
    sdpa_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), flush)
    # each input read once, the output written once; 4 * D operations per
    # causal (query, key) pair, at the card's peak for float32 inputs (TF32
    # tensor cores); the CUDA-core float32 rate the kernel runs at is a
    # yardstick only
    nbytes = 4 * (2 * B * H * S * D + 2 * B * HKV * S * D)
    flops = 4 * D * B * H * (S * (S + 1) // 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / TF32_FLOPS_PER_S
    f32_core_ms = flops / F32_FLOPS_PER_S * 1e3
    rate = flops / (ms * 1e-3)
    out = dict(max_abs_err=err, ms=ms, ms_with_launch=host_ms,
               plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=sdpa_ms, achieved_flop_per_s=rate,
               yardstick={"what": "exact variant vs SDPA, float32",
                          "kernel_ms": exact_ms, "library_ms": sdpa_ms,
                          "ops_ms_at_f32_cuda_core_rate": f32_core_ms})
    log(f"[time] flash (float32, ExpMul, B={B}, S={S}, causal, 512-wide "
        f"tiles): kernel {ms:.4f} ms on the device, {host_ms:.4f} ms with "
        f"its launch, plain {plain_ms:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}: {nbytes} B, {flops} "
        f"flop at the TF32 tensor-core rate; {f32_core_ms:.4f} ms at the "
        f"float32 CUDA-core rate, a yardstick), max abs err {err:.3e} (rel "
        f"{rel:.3e}); exact variant {exact_ms:.4f} ms, library SDPA "
        f"{sdpa_ms:.4f} ms")
    log(f"[time] flash achieved {rate / 1e12:.2f} TFLOP/s: "
        f"{rate / F32_FLOPS_PER_S:.1%} of the float32 CUDA-core rate "
        f"({F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s; {f32_core_ms:.4f} ms), "
        f"{out['bound_ms'] / ms:.2%} of the TF32 bound "
        f"({out['bound_ms']:.4f} ms)")
    return out


def phase_quickstart(torch, build):
    """``python -m repro_torch.launch.quickstart`` on the card, with the
    launch counts set to 0 just before and read just after: ExpMul and
    flash must have launched, and no plain version. Then its outputs: the
    operator's exact powers of two, and each flash output against the plain
    version on the same inputs."""
    from repro_torch.kernels.checks import kernel_tol, rel_err
    from repro_torch.kernels.flash.ops import flash_attention_fwd
    from repro_torch.launch import quickstart

    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    out = quickstart.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.COUNTS)
    log(f"[quickstart] {wall:.2f} s; launches {json.dumps(counts)}")
    if not (counts.get("expmul", 0) > 0 and counts.get("flash", 0) > 0):
        raise AssertionError(f"the quickstart missed a kernel: {counts}")
    if any(n for name, n in counts.items() if name not in ("expmul", "flash")):
        raise AssertionError(f"a plain version ran in the quickstart: "
                             f"{counts}")
    if out["expmul"][:, 0].tolist() != [0.75, 0.25, 0.0029296875]:
        raise AssertionError(f"ExpMul values {out['expmul'][:, 0]}")
    q, k, v = out["q"], out["k"], out["vv"]
    for name, variant, bk in (("o_exact", "exact", 128),
                              ("o_expmul", "expmul", 128),
                              ("o_api", "expmul", 256)):
        ref = flash_attention_fwd(q, k, v, causal=True, variant=variant,
                                  block_k=bk, plain=True)
        err = rel_err(out[name], ref)
        log(f"[quickstart] {name} against the plain version: rel err "
            f"{err:.3e}")
        if not (out[name].shape == (1, 4, 256, 64)
                and err <= kernel_tol(variant, torch.float32)):
            raise AssertionError(f"quickstart {name} disagrees")
    return counts


def phase_fidelity(torch, build):
    """``python -m repro_torch.launch.fidelity`` on the card (Table I:
    train table1-lm 200 steps, evaluate the grid), with the launch counts
    set to 0 just before and read just after: only the flash kernel may
    have launched, and every perplexity must be finite. The paper's claim
    (flat quality) is printed, not gated."""
    from repro_torch.launch import fidelity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    rows, attn_err = fidelity.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.COUNTS)
    log(f"[fidelity] {wall:.2f} s; launches {json.dumps(counts)}; rows "
        f"{json.dumps(rows)}; raw attention |err| mean {attn_err!r}")
    if set(counts) != {"flash"} or not counts["flash"] > 0:
        raise AssertionError(f"the fidelity study ran another kernel or a "
                             f"plain version: {counts}")
    if len(rows) != 4 or not all(np.isfinite(r["perplexity"]) for r in rows):
        raise AssertionError(f"the fidelity study's rows: {rows}")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch import configs as cfg_mod
    from repro_torch.kernels import build, checks
    from repro_torch.kernels.expmul import ops as expmul_ops
    from repro_torch.kernels.decode import decode
    from repro_torch.kernels.flash import flash, prefill
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeEngine

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    phases = (
        ("build", lambda: phase_build(build)),
        ("kernel checks", lambda: phase_kernel_checks(torch, checks)),
        ("expmul checks", lambda: phase_expmul_checks(torch, checks, build,
                                                      expmul_ops)),
        ("model ticks", lambda: phase_model_ticks(torch, cfg_mod, api)),
        ("serve", lambda: phase_serve(torch, cfg_mod, api, build,
                                      ServeEngine)),
        ("times", lambda: phase_times(torch, checks, F)),
        ("resources", lambda: phase_resources(build, decode, prefill,
                                              flash)),
        ("train", lambda: phase_train(torch, cfg_mod, api, build)),
        ("quickstart", lambda: phase_quickstart(torch, build)),
        ("fidelity", lambda: phase_fidelity(torch, build)),
    )
    results = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        results[name] = fn()
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    kernels = []
    launches = {**results["serve"], **results["train"]}
    launches["flash"].update(
        launches_quickstart=results["quickstart"]["flash"],
        launches_fidelity=results["fidelity"]["flash"])
    launches["expmul"] = dict(launches=results["quickstart"]["expmul"])
    for name, (source, replaces) in KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, **launches[name],
                            **results["times"][name],
                            **results["resources"].get(name, {})))
    log(json.dumps({"kernels": kernels}))
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
