#!/usr/bin/env python3
"""Which side moves where the contiguous prefill kernel and its plain
version would disagree at a chunk of 15 rows: a witness on the card.

    python3 tools/ragged_chunk_witness.py [--src DIR]

from the repository root, on a machine with an NVIDIA Hopper card and the
CUDA toolkit. It rebuilds the inputs of
``tests/test_torch_cuda.py::test_contiguous_prefill_ragged_chunks_match_plain``
with bf16 q and ExpMul (chunks of C in {1, 15, 100} rows over float32
values, bf16 values and int8 codes) and prints, for each, the relative
error of

* the kernel against the plain version (its products ``fma_chain``s, in
  the kernel's order; ``torch.matmul`` in an earlier checkout, in
  whatever order cuBLAS picks),
* the kernel against the plain version with both products summed in
  float64 and rounded once (``tools/order_sensitivity.py``'s tile step),
* the plain version against that,

beside the checks' limit (``checks.kernel_tol``). ``--src DIR`` imports
``repro_torch`` from another checkout's ``src`` (an earlier commit's), so
its kernels are built from that checkout's ``csrc``. It prints the card's
name and power limit first.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("ragged_chunk_witness: no CUDA device available",
              file=sys.stderr)
        return 1
    # repro_torch from --src first; the tools below then find it loaded
    from repro_torch.kernels import build, checks
    from repro_torch.kernels.flash import prefill
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke
    import order_sensitivity

    print(chip_smoke.card_line(), flush=True)
    print(f"repro_torch from {Path(prefill.__file__).parents[2]}, kernels "
          f"from {build.CSRC}", flush=True)
    step = prefill.online_softmax_tile
    run = checks.run_contiguous_prefill
    tol = checks.kernel_tol("expmul", torch.bfloat16)
    for C in (1, 15, 100):
        for kv in ("f32", "bf16", "int8"):
            case = checks.contiguous_case(
                np.random.default_rng(C), B=3, H=14, Hkv=2, D=64, S=1100,
                lengths=[1100, 0, 700], n_valid=[C, 0, max(1, C // 3)],
                chunk=C, kv=kv, q_dtype=torch.bfloat16, dyadic=False,
                device="cuda")
            got = run(case, "expmul")
            plain = run(case, "expmul", plain=True)
            prefill.online_softmax_tile = (
                lambda *a, **kw: order_sensitivity.tile_step(
                    *a, f64=("scores", "values"), **kw))
            try:
                plain64 = run(case, "expmul", plain=True)
            finally:
                prefill.online_softmax_tile = step
            torch.cuda.synchronize()
            print(f"C={C} {kv}: kernel vs plain "
                  f"{checks.rel_err(got, plain):.3e}, kernel vs float64 "
                  f"plain {checks.rel_err(got, plain64):.3e}, plain vs "
                  f"float64 plain {checks.rel_err(plain, plain64):.3e} "
                  f"(limit {tol:g})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
