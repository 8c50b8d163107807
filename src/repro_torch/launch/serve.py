"""Serving launcher: chunked prefill + continuous decode batching.

  python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \
      --requests 8 --max-new 32 --chunk 32 [--variant expmul] \
      [--kv-layout paged --page-size 16 --pool-blocks 0] [--kv-dtype int8] \
      [--attention-impl kernel|plain|pallas|flash_jnp|ref] \
      [--device cuda|cpu] \
      [--prefix-cache|--no-prefix-cache] [--metrics-json PATH] \
      [--trace-out PATH] [--log-metrics-every N] \
      [--deadline-steps N] [--deadline-s S] \
      [--chaos "preempt=0.2,logits=0.2" --chaos-seed N] \
      [--snapshot-path PATH | --restore-path PATH]

(with ``src`` on ``PYTHONPATH``). The flags and their defaults are those
of ``repro.launch.serve`` that the port supports: a float32 model with
random weights from seed 0, the contiguous layout, unquantized KV, ExpMul.
The shared-prefix cache is on by default for the paged layout
(``--no-prefix-cache`` turns it off; ``--prefix-cache`` with the
contiguous layout is an error). ``--metrics-json`` writes
``metrics_snapshot()`` after the run, ``--trace-out`` turns on span
tracing and writes a Chrome-trace/Perfetto JSON of the request
lifecycles, ``--log-metrics-every N`` prints a progress line every N
engine steps.
Fault tolerance (DESIGN.md §13): ``--deadline-steps`` / ``--deadline-s``
give every request a budget (engine steps from admission, seconds from
submit); ``--chaos`` installs a seeded ``ChaosInjector`` over the points
``pool_alloc``, ``admission``, ``preempt``, ``logits`` and ``kv_corrupt``
(each capped at 4 fires) and prints the finish reasons, the fire report
and the pool's consistency check; ``--snapshot-path`` writes an engine
snapshot after the run and ``--restore-path`` starts from one (the engine's
shape then comes from the snapshot, not from the flags).
``--attention-impl kernel`` (the config's default) runs the attention
ticks on the CUDA kernels, each tick captured in a CUDA graph on the card
(``serve/graphs.py``), ``plain`` on their plain PyTorch versions, in eager
ticks (the plain versions read lengths on the host, which a graph cannot
capture), ``flash_jnp`` on the reference's one-pass routes (masked_xla,
xla, gather_xla: no kernel, captured too); see ``kernels/registry.py``.
``--device`` defaults to ``cuda`` and fails without a card; ``--device
cpu`` runs the plain versions on the CPU (use ``--smoke`` there).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ATTENTION_IMPLS
from repro_torch.models.api import init_model, resolve_device
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import ChaosInjector, install_fault_injector
from repro_torch.serve.snapshot import restore_engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=32,
                    help="prefill chunk size (1 = legacy teacher-forcing)")
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="fixed prompt length (0 = random 4..11)")
    ap.add_argument("--variant", default="expmul", choices=["exact", "expmul"])
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-layout", default="contiguous",
                    choices=["contiguous", "paged"])
    ap.add_argument("--page-size", type=int, default=0,
                    help="tokens per KV block (0 = cfg.page_size)")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="paged pool size as an unquantized-equivalent "
                         "byte budget (0 = fully provisioned; quantized "
                         "dtypes fit proportionally more blocks)")
    ap.add_argument("--kv-dtype", default="fp32",
                    choices=["fp32", "int8", "fp8"],
                    help="KV-cache storage dtype (int8/fp8: quantize on "
                         "write, dequantize inside the kernels)")
    ap.add_argument("--attention-impl", default=None,
                    choices=list(ATTENTION_IMPLS),
                    help="the registry's full-sequence name, which picks "
                         "every table's route: the CUDA kernels "
                         "('kernel', the config's default; 'pallas' runs "
                         "them too), their plain PyTorch versions "
                         "('plain'), or the reference's one-pass XLA "
                         "routes ('flash_jnp', 'ref')")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--prefix-cache", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="shared-prefix KV caching (default: on for the "
                         "paged layout; with --kv-layout contiguous it is an "
                         "error)")
    ap.add_argument("--metrics-json", default=None,
                    help="write ServeEngine.metrics_snapshot() as JSON here "
                         "after the run")
    ap.add_argument("--trace-out", default=None,
                    help="enable span tracing and write the Chrome-trace/"
                         "Perfetto JSON timeline here")
    ap.add_argument("--log-metrics-every", type=int, default=0,
                    help="print a metrics line every N engine steps "
                         "(0 = off)")
    ap.add_argument("--deadline-steps", type=int, default=0,
                    help="per-request engine-step budget from first "
                         "admission (0 = none); expired requests finish "
                         "with finish_reason='deadline'")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request wall-clock budget from submit in "
                         "seconds (0 = none)")
    ap.add_argument("--chaos", default=None,
                    help="deterministic fault injection for this run: "
                         "'point=rate,...' over {pool_alloc, admission, "
                         "preempt, logits, kv_corrupt}; each point is "
                         "capped at 4 fires")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--snapshot-path", default=None,
                    help="write a crash-consistent engine snapshot here "
                         "after the run (restore with --restore-path)")
    ap.add_argument("--restore-path", default=None,
                    help="start from a snapshot instead of a fresh engine "
                         "(same --arch/--smoke checkpoint; the engine's "
                         "shape comes from the snapshot)")
    args = ap.parse_args(argv)
    if args.prefix_cache and args.kv_layout != "paged":
        ap.error("--prefix-cache requires --kv-layout paged: the contiguous "
                 "layout has no shared physical blocks to dedupe")

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"{e} (--device cpu)")
    cfg = get_config(args.arch, smoke=args.smoke, dtype="float32",
                     param_dtype="float32", attention_variant=args.variant)
    params = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                        device=device)
    eager = args.attention_impl == "plain"
    if args.restore_path:
        eng = restore_engine(args.restore_path, params, cfg,
                             trace=bool(args.trace_out), eager_ticks=eager,
                             device=device)
        carried = sum(r is not None for r in eng.requests) + len(eng.queue)
        print(f"restored engine from {args.restore_path} "
              f"(step {eng.ticks}, {carried} in-flight requests carried)")
    else:
        eng = ServeEngine(params, cfg, slots=args.slots,
                          max_len=args.max_len, chunk_size=args.chunk,
                          temperature=args.temperature,
                          kv_layout=args.kv_layout,
                          page_size=args.page_size or None,
                          pool_blocks=args.pool_blocks or None,
                          kv_dtype=args.kv_dtype,
                          attention_impl=args.attention_impl,
                          prefix_cache=args.prefix_cache,
                          deadline_steps=args.deadline_steps or None,
                          deadline_s=args.deadline_s or None,
                          trace=bool(args.trace_out), eager_ticks=eager,
                          device=device)
    injector = None
    if args.chaos:
        injector = ChaosInjector.from_spec(args.chaos, seed=args.chaos_seed)
        install_fault_injector(injector)
    rng = np.random.default_rng(0)
    reqs = [      # auto rids: never collide with restored ones
        eng.submit(list(rng.integers(
            1, cfg.vocab_size,
            size=args.prompt_len or rng.integers(4, 12))), args.max_new)
        for _ in range(args.requests)
    ]
    t0 = time.perf_counter()
    if args.log_metrics_every > 0:
        # the run's tick loop, reporting progress every N steps
        while eng.tick() or eng.queue:
            if eng.ticks % args.log_metrics_every == 0:
                snap = eng.metrics_snapshot()
                print(f"  [step {eng.ticks}] generated="
                      f"{eng.tokens_generated} queue={len(eng.queue)} "
                      f"preempt={eng.preemptions} "
                      f"ttft_p50={snap['ttft_steps_p50']:.0f} "
                      f"tpot_p50={snap['tpot_steps_p50']:.0f} steps")
    else:
        eng.run()
    if injector is not None:
        install_fault_injector(None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    # layout and dtype come from the engine: under --restore-path they are
    # the snapshot's, not the flags'
    print(f"variant={args.variant} impl={eng.cfg.attention_impl} "
          f"kv={eng.kv_layout}/{eng.cfg.kv_dtype} requests={len(reqs)} "
          f"chunk={args.chunk} steps={eng.ticks} (prefill "
          f"{eng.prefill_steps} / decode {eng.decode_steps}) "
          f"generated={eng.tokens_generated} tokens in {dt:.3f} s on "
          f"{where} ({eng.tokens_generated / dt:.1f} tok/s, "
          f"{'eager' if eng.eager_ticks else 'graph'} ticks)")
    st = eng.memory_stats()
    if eng.paged:
        print(f"  KV pool: {eng.pool.pool_blocks} blocks of "
              f"{eng.page_size} tokens, {eng.preemptions} preemptions")
        if st["prefix_cache"]:
            print(f"  prefix cache: {st['cache_hits']}/{st['cache_lookups']} "
                  f"hits, {st['prefix_hit_tokens']} prompt tokens skipped "
                  f"({st['prefill_flops_skipped']:.3g} FLOPs), "
                  f"{st['cow_copies']} COW copies, "
                  f"{st['kv_cached_blocks']} blocks cached")
    snap = eng.metrics_snapshot()
    print(f"  TTFT p50/p99 {snap['ttft_steps_p50']:.0f}/"
          f"{snap['ttft_steps_p99']:.0f} steps, TPOT p50/p99 "
          f"{snap['tpot_steps_p50']:.0f}/{snap['tpot_steps_p99']:.0f} steps")
    reasons = {k: v for k, v in snap["finish_reasons"].items() if v}
    print(f"  finish reasons: {reasons} (quarantined: "
          f"{snap['quarantined']})")
    if injector is not None:
        fires = {p: injector.fired(p) for p in injector.POINTS
                 if injector.fired(p)}
        print(f"  chaos: injected {fires} over "
              f"{ {p: injector.opportunities(p) for p in fires} } "
              f"opportunities")
    if eng.paged:
        eng.pool.check_consistency()
        print("  pool accounting consistent (used+cached+free == "
              "pool_blocks, no dangling keys)")
    if args.snapshot_path:
        meta = eng.save_snapshot(args.snapshot_path)
        print(f"  wrote snapshot {args.snapshot_path} "
              f"({meta['n_leaves']} state leaves, "
              f"{len(meta['requests']) + len(meta['queue'])} in-flight "
              f"requests, cached prefix tier included)")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(snap, f, indent=2)
            f.write("\n")
        print(f"  wrote {args.metrics_json}")
    if args.trace_out:
        eng.metrics.write_chrome_trace(args.trace_out)
        print(f"  wrote {args.trace_out} "
              f"({len(eng.metrics.events)} trace events)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4]} -> out[:8]={r.out[:8]}")
    return reqs


if __name__ == "__main__":
    main()
