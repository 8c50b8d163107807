"""Serving launcher: chunked prefill + continuous decode batching.

  python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \
      --requests 8 --max-new 32 --chunk 32 [--variant expmul] \
      [--kv-layout paged --page-size 16 --pool-blocks 0] [--kv-dtype int8] \
      [--attention-impl kernel|plain] [--device cuda|cpu]

(with ``src`` on ``PYTHONPATH``). The flags and their defaults are those
of ``repro.launch.serve`` that the port supports: a float32 model with
random weights from seed 0, the contiguous layout, unquantized KV, ExpMul.
``--attention-impl kernel`` (the config's default) runs the attention
ticks on the CUDA kernels, ``plain`` on their plain PyTorch versions.
``--device`` defaults to ``cuda`` and fails without a card; ``--device
cpu`` runs the plain versions on the CPU (use ``--smoke`` there).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ATTENTION_IMPLS
from repro_torch.models.api import init_model, resolve_device
from repro_torch.serve.engine import ServeEngine


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
                    help="attention ticks on the CUDA kernels ('kernel', "
                         "the config's default) or on their plain PyTorch "
                         "versions ('plain')")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"{e} (--device cpu)")
    cfg = get_config(args.arch, smoke=args.smoke, dtype="float32",
                     param_dtype="float32", attention_variant=args.variant)
    params = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                        device=device)
    eng = ServeEngine(params, cfg, slots=args.slots, max_len=args.max_len,
                      chunk_size=args.chunk, temperature=args.temperature,
                      kv_layout=args.kv_layout,
                      page_size=args.page_size or None,
                      pool_blocks=args.pool_blocks or None,
                      kv_dtype=args.kv_dtype,
                      attention_impl=args.attention_impl, device=device)
    rng = np.random.default_rng(0)
    reqs = [
        eng.submit(list(rng.integers(
            1, cfg.vocab_size,
            size=args.prompt_len or rng.integers(4, 12))), args.max_new)
        for _ in range(args.requests)
    ]
    t0 = time.perf_counter()
    eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"variant={args.variant} impl={eng.cfg.attention_impl} "
          f"kv={eng.kv_layout}/{eng.cfg.kv_dtype} requests={len(reqs)} "
          f"chunk={args.chunk} steps={eng.ticks} (prefill "
          f"{eng.prefill_steps} / decode {eng.decode_steps}) "
          f"generated={eng.tokens_generated} tokens in {dt:.3f} s on "
          f"{where} ({eng.tokens_generated / dt:.1f} tok/s)")
    if eng.paged:
        print(f"  KV pool: {eng.pool.pool_blocks} blocks of "
              f"{eng.page_size} tokens, {eng.preemptions} preemptions")
    reasons = sorted({r.finish_reason for r in reqs})
    print(f"  finish reasons: {reasons}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4]} -> out[:8]={r.out[:8]}")
    return reqs


if __name__ == "__main__":
    main()
