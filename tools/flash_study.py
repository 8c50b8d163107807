#!/usr/bin/env python3
"""Whether a wider score block makes the flash forward faster, and whether
the order of the weight sum l alone moves the Table I study: a study on
the card.

    python3 tools/flash_study.py [--turns 2]

from the repository root, on a machine with an NVIDIA Hopper card and the
CUDA toolkit. It builds four kernels into a temporary directory, which it
removes, and swaps each in for the port's ``flash`` library:

* ``port``: ``csrc/flash.cu`` as the port builds it (K and V staged in
  64-row sub-tiles, a 4 x 4 block of (rows, columns) of the scores a
  thread, two CTAs an SM at head dim 64);
* ``4x8``: ``tools/flash_study.cu``, a copy of it with 128-row sub-tiles
  and a 4 x 8 block a thread (one CTA an SM);
* ``copy``: the study copy at the port's 64-row sub-tiles
  (``STUDY_SUB_ROWS=64``);
* ``warp l-sum``: that copy with each row's weight sum l of a tile in the
  order of the kernel ``csrc/flash.cu`` replaced (``STUDY_WARP_LSUM``),
  and nothing else changed.

Each output's chains keep their depth and column order, so every build
must give the plain version's numbers. For each build it prints the
compiler's registers and spills of the training instantiation (float32,
D 64, ExpMul) and the shared memory a CTA, and holds it against the plain
version at the training shapes of ``chip_smoke.py`` phase 5 (8 x 1024
tokens, 14 / 2 heads of 64, float32, causal, 512-wide tiles; ExpMul and
exact) and on the layout's edges at S = 1000 (``checks.flash_edge_cases``,
GQA group 7, float32).

Bits: at the Table I study's attention shapes (8 x 64 tokens, 4 / 2 heads
of 32, causal, 512-wide tiles; float32 and bf16, exact and ExpMul) the
outputs of ``copy`` and ``warp l-sum`` that differ from ``port``'s, bit
for bit.

Table I: ``repro_torch.launch.fidelity``'s study (200 training steps, then
the grid) on ``port`` and on ``warp l-sum``; with only the order of l
changed back, the second must print the replaced kernel's perplexities.

Time: ``port`` and ``4x8``, the ExpMul forward at the training shapes, the
median of 25 runs between CUDA events with L2 flushed, in turns A B B A
... (``--turns`` pairs).

It prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

STUDY = Path("tools/flash_study.cu")
# build name: (source, macros)
BUILDS = {
    "port": (Path("src/repro_torch/csrc/flash.cu"), ()),
    "4x8": (STUDY, ()),
    "copy": (STUDY, ("STUDY_SUB_ROWS=64",)),
    "warp l-sum": (STUDY, ("STUDY_SUB_ROWS=64", "STUDY_WARP_LSUM=1")),
}
TIMED = ("port", "4x8")
ENTRY = "flash_kernelIfLi64ELb1EE"


def _build(build, flash, out_dir: Path) -> dict:
    """{name: (library, the compiler's report of ENTRY)}."""
    procs = {}
    for name, (src, macros) in BUILDS.items():
        so = out_dir / f"flash-{name.replace(' ', '-')}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               *(f"-D{m}" for m in macros), "-o", str(so), str(ROOT / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        lines = log.splitlines()
        at = [i for i, l in enumerate(lines)
              if "Compiling entry function" in l and ENTRY in l]
        report = " | ".join(l.split(":", 1)[-1].strip()
                            for l in lines[at[0] + 1:at[0] + 5]
                            if "registers" in l or "spill" in l)
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in flash._SIGNATURE.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = (lib, report)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_study: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import build, checks
    from repro_torch.kernels.flash import flash
    from repro_torch.launch import fidelity

    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel = build.load("flash", flash._SIGNATURE)
    B, H, Hkv, S, D = (chip_smoke.B, chip_smoke.H, chip_smoke.HKV,
                       chip_smoke.TRAIN_SEQ, chip_smoke.D)
    case = checks.flash_case(np.random.default_rng(4), B=B, H=H, Hkv=Hkv,
                             Sq=S, Sk=S, D=D, dtype=torch.float32,
                             dyadic=False, causal=True, block_k=512,
                             device="cuda")
    cfg = fidelity.CFG
    hd = cfg.d_model // cfg.num_heads
    table1 = {
        (dtype, variant): checks.flash_case(
            np.random.default_rng(5), B=8, H=cfg.num_heads,
            Hkv=cfg.num_kv_heads, Sq=64, Sk=64, D=hd, dtype=dtype,
            dyadic=False, causal=True, block_k=cfg.attention_block_k,
            device="cuda")
        for dtype in (torch.float32, torch.bfloat16)
        for variant in ("exact", "expmul")}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def use(name):
        build._LIBS["flash"] = libs[name][0]

    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(build, flash, Path(tmp))
        try:
            for name, (lib, report) in libs.items():
                use(name)
                print(f"[build] {name}: {report}; shared memory a CTA "
                      f"{lib.flash_smem(D, 512)} B", flush=True)
                fails, worst = 0, 0.0
                cases = [("training shapes", case)] + checks.flash_edge_cases(
                    np.random.default_rng(7), S=1000, D=D, group=7,
                    dtype=torch.float32, dyadic=False)
                for label, c in cases:
                    for variant in ("expmul", "exact"):
                        err = checks.rel_err(
                            checks.run_flash(c, variant),
                            checks.run_flash(c, variant, plain=True))
                        fails += not err <= checks.kernel_tol(variant,
                                                              torch.float32)
                        worst = max(worst, err)
                print(f"[exact] {name}: {fails} of {2 * len(cases)} cases "
                      f"over kernel_tol, worst rel err {worst:.3e}",
                      flush=True)
            for (dtype, variant), c in table1.items():
                outs = {}
                for name in ("port", "copy", "warp l-sum"):
                    use(name)
                    outs[name] = checks.run_flash(c, variant)
                ref = outs["port"]
                diff = {name: int((outs[name] != ref).sum())
                        for name in ("copy", "warp l-sum")}
                print(f"[bits] Table I shapes, {dtype}, {variant}: outputs "
                      f"differing from port's of {ref.numel()}: {diff}",
                      flush=True)
            for name in ("port", "warp l-sum"):
                use(name)
                rows, _, dt = fidelity.run(device="cuda")
                print(f"[table1] {name} ({dt:.0f} s): " + ", ".join(
                    f"{r['config']} {r['perplexity']:.3f} "
                    f"({r['perplexity']!r})" for r in rows), flush=True)
            times = {name: [] for name in TIMED}
            for _ in range(args.turns):
                for turn in (TIMED, TIMED[::-1]):
                    for name in turn:
                        use(name)
                        times[name].append(chip_smoke.median_ms(
                            torch, lambda: checks.run_flash(case, "expmul"),
                            flush))
        finally:
            build._LIBS["flash"] = kernel
    for name in TIMED:
        print(f"[time] {name}: "
              f"{', '.join(f'{t:.4f}' for t in times[name])} ms (min "
              f"{min(times[name]):.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
