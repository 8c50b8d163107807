#!/usr/bin/env python3
"""What the contiguous prefill kernel would gain and lose on the tensor
cores, and where its time goes: a study on the card.

    python3 tools/prefill_study.py [--seeds 4]

from the repository root, on a machine with an NVIDIA Hopper card and the
CUDA toolkit. It builds ``tools/prefill_study.cu`` (a copy of
``csrc/prefill.cu`` whose macros put one product on the tensor cores or
knock one phase out) several times into a temporary directory, which it
removes, and swaps each build in for the port's ``prefill`` library:

* exactness: at the serving shapes of ``chip_smoke.py`` phase 5 (8
  sequences x 1024 resident tokens, 256-token chunks, 14 / 2 heads of 64,
  bf16 q) over int8 codes, fp8 codes, bf16 values and float32 values, for
  ``--seeds`` random inputs each and both variants, how many cases exceed
  ``checks.kernel_tol`` against the plain version, and the worst error;
  the port's own build and the study copy without macros first;
* time: each build at the serving case (int8 codes, ExpMul), the median
  of 25 runs between CUDA events with L2 flushed, in two turns (the builds
  in order, then in reverse). A knocked-out phase's cost is the copy's
  time less the build without it.

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

# build name: the macros it sets
EXACTNESS = {"copy": (), "tc scores": ("STUDY_TC_SCORES",),
             "tc values": ("STUDY_TC_VALUES",),
             "tc both": ("STUDY_TC_SCORES", "STUDY_TC_VALUES")}
KNOCKOUTS = {"no scores": ("STUDY_KO_SCORES",),
             "no weights": ("STUDY_KO_WEIGHTS",),
             "no values": ("STUDY_KO_VALUES",),
             "no phase": ("STUDY_KO_SCORES", "STUDY_KO_WEIGHTS",
                          "STUDY_KO_VALUES")}


def _build(build, prefill, out_dir: Path) -> dict:
    procs = {}
    for name, macros in {**EXACTNESS, **KNOCKOUTS}.items():
        so = out_dir / f"prefill-{name.replace(' ', '-')}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               *(f"-D{m}=1" for m in macros), "-o", str(so),
               str(ROOT / "tools" / "prefill_study.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in prefill._CONTIGUOUS_SIGNATURE.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("prefill_study: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import build, checks
    from repro_torch.kernels.flash import prefill

    print(chip_smoke.card_line(), flush=True)
    kernel = build.load("prefill", prefill._CONTIGUOUS_SIGNATURE)
    shape = dict(B=8, H=14, Hkv=2, D=64, S=2048, lengths=[1024] * 8,
                 n_valid=[256] * 8, chunk=256, q_dtype=torch.bfloat16,
                 dyadic=False, device="cuda")
    run = checks.run_contiguous_prefill
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"kernel": kernel, **_build(build, prefill, Path(tmp))}
        try:
            for name in ("kernel", *EXACTNESS):
                build._LIBS["prefill"] = libs[name]
                for kv in ("int8", "fp8", "bf16", "f32"):
                    for variant in ("expmul", "exact"):
                        errs = []
                        for seed in range(args.seeds):
                            case = checks.contiguous_case(
                                np.random.default_rng(seed), kv=kv, **shape)
                            errs.append(checks.rel_err(
                                run(case, variant),
                                run(case, variant, plain=True)))
                        tol = checks.kernel_tol(variant, torch.bfloat16)
                        print(f"[exact] {name}, {kv}, {variant}: "
                              f"{sum(e > tol for e in errs)} of {len(errs)} "
                              f"cases over {tol:g}, worst rel err "
                              f"{max(errs):.3e}", flush=True)
            case = checks.contiguous_case(np.random.default_rng(0),
                                          kv="int8", **shape)
            order = list(libs)
            times = {name: [] for name in order}
            for turn in (order, order[::-1]):
                for name in turn:
                    build._LIBS["prefill"] = libs[name]
                    times[name].append(chip_smoke.median_ms(
                        torch, lambda: run(case, "expmul"), flush))
        finally:
            build._LIBS["prefill"] = kernel
    copy = min(times["copy"])
    for name in order:
        extra = (f"; the phase {copy - min(times[name]):.4f} ms"
                 if name in KNOCKOUTS else "")
        print(f"[time] {name}: "
              f"{', '.join(f'{t:.4f}' for t in times[name])} ms{extra}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
