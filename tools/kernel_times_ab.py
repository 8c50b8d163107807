#!/usr/bin/env python3
"""The attention kernels' times of several checkouts, read within one
call on one card: an A/B of a kernel change.

    python3 tools/kernel_times_ab.py DIR [DIR ...]

from the repository root, on a machine with an NVIDIA Hopper card and the
CUDA toolkit. Each DIR is a checkout (an unpacked ``git archive``); they
run in the order given, each in a process of its own, so list them
alternating (parent, change, change, parent). A run builds the checkout's
kernels from its ``src/repro_torch/csrc`` and times them through its own
``chip_smoke.py`` phase 5 (the serving kernels at the serving shapes,
flash at the training shapes, ExpMul at the flash recurrence's; the median
of 25 runs between CUDA events, L2 flushed before each; a checkout whose
paged kernels have two walks also gives their forced general walk's, as
"<name> general"). It prints the card's name and power limit first, then
each build's nvcc seconds (by library, and by part where a checkout's
build has parts), every run's times and each checkout's median over its
runs, in ms.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ONE = """
import json, os, sys
sys.path[:0] = [{src!r}, {root!r}]
import torch
import torch.nn.functional as F
import chip_smoke
from repro_torch.kernels import build, checks
secs = build.build_all()
if any(secs.values()):
    print("BUILD " + json.dumps(dict(
        seconds=secs, cores=os.cpu_count(),
        parts=getattr(build, "part_seconds", dict)(),
        wall=getattr(build, "wall_seconds", lambda: max(secs.values()))())))
times = chip_smoke.phase_times(torch, checks, F)
ms = {{k: v["ms"] for k, v in times.items()}}
ms.update({{k + " general": v["ms_general"] for k, v in times.items()
           if "ms_general" in v}})
print("AB " + json.dumps(ms))
"""


def main(argv=None) -> int:
    dirs = [Path(d).resolve() for d in (argv or sys.argv[1:])]
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    runs = []
    for d in dirs:
        out = subprocess.run(
            [sys.executable, "-c", ONE.format(src=str(d / "src"),
                                              root=str(d))],
            capture_output=True, text=True, cwd=d)
        line = [l for l in out.stdout.splitlines() if l.startswith("AB ")]
        if out.returncode or not line:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        for l in out.stdout.splitlines():
            if l.startswith("BUILD "):
                print(f"{d.name}: build, nvcc seconds {l[6:]}", flush=True)
        runs.append((d, json.loads(line[0][3:])))
        print(f"{d.name}: " + json.dumps(runs[-1][1]), flush=True)
    for d in dict.fromkeys(d for d, _ in runs):
        mine = [t for e, t in runs if e == d]
        print(f"median {d.name} ({len(mine)} runs): " + json.dumps(
            {k: statistics.median(t[k] for t in mine) for k in mine[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
