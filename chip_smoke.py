#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

from the repository root, on a machine with an NVIDIA Hopper card, PyTorch
built for CUDA and the CUDA toolkit. It imports nothing of JAX or of the
JAX package. Phases (a failing check raises, and the script exits
non-zero):

1. print the card's name and power limit; build the kernels from
   ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
2. hold each CUDA kernel against its plain PyTorch version on the card:
   {exact, expmul} x {bf16 pool, int8 codes} x {float32, bfloat16 q} x
   head dims {16, 64}, on shuffled, fragmented block tables with NaN in
   every unreferenced page, ragged lengths and an idle row, with dyadic
   inputs (exact scores) and random N(0,1) inputs. Both walk the same
   tiles, so each is held at ``checks.kernel_tol``: 1e-5 of the output's
   magnitude, or one bf16 ulp for the exact variant's bfloat16 output;
3. one prefill tick, a second prefill tick over that history and one
   decode tick of qwen2-0.5b at full width in float32 (TF32 off), through
   the kernels and through the plain versions: logits within 1e-3 of
   their magnitude for exact, the gap printed for ExpMul;
4. serving at full width: ``ServeEngine`` with a paged int8 pool, ExpMul,
   8 slots, 16 requests of 128-1024 prompt tokens and 32 new tokens each,
   temperature 0. The kernel launch counts are set to 0 just before the
   run and read just after: both kernels must have launched and the plain
   versions must not have run;
5. per-kernel times at the serving shapes (int8 codes, ExpMul, 8 sequences
   of 1024 tokens, 256-token chunks, bf16 q): the median of 25 runs timed
   with CUDA events after warm-up, L2 flushed before each, beside the
   plain version's time and the least time the card could take;
6. one JSON line of kernels, the card line, and as the last line
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
KERNELS = {
    "paged_decode": ("src/repro_torch/csrc/paged_decode.cu",
                     "src/repro/kernels/decode/decode.py:285"),
    "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                      "src/repro/kernels/flash/prefill.py:433"),
}
B, H, HKV, D, PS, MAX_LEN, CHUNK, CTX = 8, 14, 2, 64, 16, 2048, 256, 1024


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
                    for variant in ("exact", "expmul"):
                        for name, run, case in (
                                ("paged_decode", checks.run_decode, dec),
                                ("paged_prefill", checks.run_prefill, pre)):
                            got = run(case, variant)
                            ref = run(case, variant, plain=True)
                            torch.cuda.synchronize()
                            err = checks.rel_err(got, ref)
                            tol = checks.kernel_tol(variant, q_dtype)
                            idle = float(got[1].abs().max())
                            qn = str(q_dtype).split(".")[-1]
                            kind = "dyadic" if dyadic else "random"
                            log(f"[check] {name} D={sh['D']} {kv} q {qn} "
                                f"{variant} window={sh.get('window')} "
                                f"{kind}: rel err {err:.3e} (tol {tol:g}), "
                                f"idle row max {idle}")
                            if not err <= tol or idle != 0.0:
                                raise AssertionError(
                                    f"{name} disagrees with its plain "
                                    f"version")
                            key = f"{name} {kind} q {qn} {variant}"
                            worst[key] = max(worst.get(key, 0.0), err)
    log(f"[check] worst rel err: {json.dumps(worst)}")


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
    for variant in ("exact", "expmul"):
        logits = {}
        for impl in ("kernel", "plain"):
            cfg = base.replace(attention_variant=variant, attention_impl=impl)
            state = api.init_paged_state(cfg, B, B * mb, PS, device="cuda")
            lens = torch.zeros(B, dtype=torch.int32, device="cuda")
            out = []
            t0 = time.perf_counter()
            for tk, nv in zip(toks, chunks):
                nv = torch.tensor(nv, dtype=torch.int32, device="cuda")
                lg, state = api.prefill_paged(params, state, tk, lens, nv, bt,
                                              cfg, page_size=PS)
                out.append((lg, nv > 0))
                lens = lens + nv
            lg, state = api.decode_step_paged(params, state, tok1, lens, bt,
                                              cfg, page_size=PS)
            out.append((lg, torch.ones(B, dtype=torch.bool, device="cuda")))
            torch.cuda.synchronize()
            logits[impl] = out
            log(f"[model] {variant} {impl}: 3 ticks in "
                f"{time.perf_counter() - t0:.2f} s")
        for i, ((a, rows), (b, _)) in enumerate(zip(logits["kernel"],
                                                    logits["plain"])):
            a, b = a[rows].double(), b[rows].double()
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError("non-finite logits")
            gap = float((a - b).abs().max() / b.abs().max())
            tick = ["prefill", "prefill over history", "decode"][i]
            log(f"[model] {variant} {tick}: max|dlogits| / max|logits| = "
                f"{gap:.3e} (max|logits| {float(b.abs().max()):.3f})")
            if variant == "exact" and not gap <= 1e-3:
                raise AssertionError("kernel logits disagree with plain")
    del params
    torch.cuda.empty_cache()


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
        raise AssertionError("a request did not finish with 'length'")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out):
        raise AssertionError("a sampled token is out of the vocabulary")
    if not (counts.get("paged_decode", 0) > 0
            and counts.get("paged_prefill", 0) > 0):
        raise AssertionError(f"the serving run missed a kernel: {counts}")
    if counts.get("paged_decode_plain", 0) or counts.get(
            "paged_prefill_plain", 0):
        raise AssertionError(f"a plain version ran while serving: {counts}")
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in reqs]
    gen = eng.tokens_generated
    log(f"[serve] 16 requests, prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens ({eng.prompt_tokens} in all), "
        f"32 new each: {eng.ticks} steps ({eng.prefill_steps} prefill, "
        f"{eng.decode_steps} decode), {gen} tokens generated in {wall:.3f} s "
        f"= {gen / wall:.1f} tokens/s; TTFT from submit p50 "
        f"{statistics.median(ttft):.1f} ms, max {max(ttft):.1f} ms; peak "
        f"memory {peak / 2**30:.2f} GiB; preemptions {eng.preemptions}")
    log(f"[serve] launches {json.dumps(counts)}")
    log(f"[serve] tick wall time, ms: prefill p50 "
        f"{statistics.median(tick_ms['prefill']):.2f} (sum "
        f"{sum(tick_ms['prefill']):.1f}), decode p50 "
        f"{statistics.median(tick_ms['decode']):.2f} (sum "
        f"{sum(tick_ms['decode']):.1f})")
    per_step = {"paged_decode": counts["paged_decode"] / eng.decode_steps,
                "paged_prefill": counts["paged_prefill"] / eng.prefill_steps}
    phase_profile(torch, ServeEngine, params, cfg, kw, prompts)
    del eng, params
    torch.cuda.empty_cache()
    return counts, per_step


def phase_profile(torch, ServeEngine, params, cfg, kw, prompts):
    """Device busy share and the top device kernels over one prefill tick
    and four decode ticks of the serving path, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    eng = ServeEngine(params, cfg, **kw)
    for p in prompts[:8]:
        eng.submit(p[:200], 8)
    for kind, n in (("prefill", 1), ("decode", 4)):
        if kind == "decode":
            while eng.prefill_steps == 0 or any(
                    r is not None and r.pos < len(r.prefill_toks)
                    for r in eng.requests):
                eng.tick()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                eng.tick()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = {}
        for e in prof.events():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                dur = e.time_range.elapsed_us()
                kernels[e.name] = kernels.get(e.name, 0.0) + dur
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        if not busy:
            log(f"[profile] {kind}: the profiler reported no device time")
            continue
        log(f"[profile] {kind} x{n}: wall {wall_us / 1e3:.2f} ms, device "
            f"busy {busy / 1e3:.2f} ms, idle share "
            f"{1 - busy / wall_us:.3f}; top kernels (ms): " + "; ".join(
                f"{name[:60]} {us / 1e3:.3f}" for name, us in top))
    eng.run()


def _bounds(kind, lengths, n_valid=None):
    """(bytes, flops) the function needs at these lengths: each input read
    once, each output written once; 4*D flops per (query, key) pair."""
    L = np.asarray(lengths, np.int64)
    q_out = 2 * 2 * B * H * D * (1 if kind == "decode" else CHUNK)
    pool = int((HKV * L * (2 * D + 2 * 4)).sum())           # codes + scales
    tables = int((-(-L // PS) * 4).sum()) + 4 * B * 2
    if kind == "decode":
        pairs = int((H * L).sum())
        return q_out + pool + tables, 4 * D * pairs
    nv = np.asarray(n_valid, np.int64)
    chunk = B * HKV * CHUNK * (2 * D + 2 * 4)
    pairs = int((H * (CHUNK * L + nv * (nv + 1) // 2)).sum())
    return q_out + pool + chunk + tables, 4 * D * pairs


def phase_times(torch, checks, F):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(4)
    common = dict(B=B, H=H, Hkv=HKV, D=D, page_size=PS,
                  max_blocks=MAX_LEN // PS, q_dtype=torch.bfloat16,
                  dyadic=False, device="cuda")
    lens, nv = [CTX] * B, [CHUNK] * B
    out = {}
    for name, run, extra in (
            ("paged_decode", checks.run_decode, dict(lengths=lens)),
            ("paged_prefill", checks.run_prefill,
             dict(lengths=lens, n_valid=nv, chunk=CHUNK))):
        case = checks.paged_case(rng, kv="int8", **extra, **common)
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
        nbytes, flops = _bounds("decode" if name == "paged_decode"
                                else "prefill", lens, nv)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        # the yardstick: the exact variant on a bf16 pool, and SDPA over a
        # dense bf16 copy of the same history (no paging, no quantization)
        case16 = checks.paged_case(rng, kv="bf16", **extra, **common)
        exact_ms = median_ms(torch, lambda: run(case16, "exact"), flush)
        C = 1 if name == "paged_decode" else CHUNK
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
        out[name] = dict(
            max_abs_err=err, ms=ms, ms_with_launch=host_ms,
            plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None,
            yardstick={"what": "exact variant, bf16 pool vs SDPA over a "
                       "dense bf16 copy", "kernel_ms": exact_ms,
                       "library_ms": sdpa_ms})
        log(f"[time] {name} (int8 codes, ExpMul, B={B}, ctx {CTX}"
            f"{', chunk %d' % CHUNK if C > 1 else ''}): kernel {ms:.4f} ms "
            f"on the device, {host_ms:.4f} ms with its launch, "
            f"plain {plain_ms:.4f} ms, bound {max(t_bytes, t_ops) * 1e3:.4f} "
            f"ms ({out[name]['bound_by']}: {nbytes} B, {flops} flop), "
            f"max abs err {err:.3e} (rel {rel:.3e}); yardstick exact bf16 "
            f"kernel {exact_ms:.4f} ms vs SDPA dense {sdpa_ms:.4f} ms")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch import configs as cfg_mod
    from repro_torch.kernels import build, checks
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeEngine

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    phases = (
        ("build", lambda: phase_build(build)),
        ("kernel checks", lambda: phase_kernel_checks(torch, checks)),
        ("model ticks", lambda: phase_model_ticks(torch, cfg_mod, api)),
        ("serve", lambda: phase_serve(torch, cfg_mod, api, build,
                                      ServeEngine)),
        ("times", lambda: phase_times(torch, checks, F)),
    )
    results = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        results[name] = fn()
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    counts, per_step = results["serve"]
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=counts[name],
                            launches_per_step=per_step[name],
                            **results["times"][name]))
    log(json.dumps({"kernels": kernels}))
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
