"""Sweep every (arch x shape x mesh) dry-run cell, one fresh subprocess a
cell (the port of ``repro/launch/dryrun_all.py``; a process of its own
keeps each cell's fake process group and DTensor caches apart).
Artifacts land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json,
with the failing cell's output in <tag>.json.err.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--mesh both]
      [--arch A] [--skip-existing]

It prints [OK] or [FAIL] with each cell's seconds and exits non-zero if
any cell fails. It runs ``JOBS`` cells at once: one a CPU core, at most
six (each cell holds a few GiB of DTensor caches at its peak).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.configs import ARCH_IDS, cells_for

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))
OUT_DIR = os.path.join(ROOT, "experiments", "dryrun_torch")
JOBS = min(6, os.cpu_count() or 1)


def run_cell(arch, shape, multi_pod, out_dir, *, variant=None, timeout=1500,
             overrides=()):
    mesh = "2x16x16" if multi_pod else "16x16"
    tag = f"{arch}__{shape}__{mesh}" + (f"__{variant}" if variant else "")
    out = os.path.join(out_dir, tag + ".json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out]
    if multi_pod:
        cmd.append("--multi-pod")
    if variant:
        cmd += ["--variant", variant]
    for ov in overrides:
        cmd += ["--override", ov]
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       env={**os.environ, "PYTHONPATH": "src"}, cwd=ROOT)
    dt = time.time() - t0
    ok = r.returncode == 0
    print(f"[{'OK' if ok else 'FAIL'}] {tag} ({dt:.0f}s)", flush=True)
    if not ok:
        tail = (r.stdout + r.stderr).splitlines()[-12:]
        print("      " + "\n      ".join(tail), flush=True)
        with open(out + ".err", "w") as f:
            f.write(r.stdout + r.stderr)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(OUT_DIR, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    todo = []
    for arch in archs:
        for shape in cells_for(arch):
            for mp in meshes:
                tag = f"{arch}__{shape.name}__{'2x16x16' if mp else '16x16'}"
                if args.skip_existing and os.path.exists(
                        os.path.join(OUT_DIR, tag + ".json")):
                    print(f"[SKIP] {tag}")
                    continue
                todo.append((arch, shape.name, mp))
    with ThreadPoolExecutor(JOBS) as pool:
        results = list(pool.map(
            lambda c: run_cell(c[0], c[1], c[2], OUT_DIR), todo))
    n_ok = sum(results)
    print(f"\n{n_ok}/{len(results)} cells ran")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
