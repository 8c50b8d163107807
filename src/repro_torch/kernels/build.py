"""Build and load the hand-written Hopper kernels of ``csrc/``.

Each ``csrc/*.cu`` compiles on its own, with ``nvcc`` for ``sm_90a``, into
a shared library with a plain C interface, loaded with ``ctypes``. The
libraries go to ``build/`` beside this package (listed in ``.gitignore``)
under a name that carries a hash of the sources, so an edited source is
never served by a stale build. ``build_all()`` starts one ``nvcc`` per
source at once and waits for all of them.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.

``COUNTS`` records, per kernel, the launches of the CUDA kernel
(``"<name>"``) and the calls of its plain PyTorch version
(``"<name>_plain"``); ``chip_smoke.py`` reads it to show that the serving
and training paths went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("paged_decode", "paged_prefill", "decode", "prefill", "flash",
           "expmul")
HEADERS = ("tile.cuh", "tile_sm90.cuh")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

COUNTS: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_counts():
    COUNTS.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library in parallel; returns {name: seconds}
    (0.0 for a library that was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        msgs = "\n".join(
            f"--- {n} ---\n{_lib_path(n).with_suffix('.log').read_text()}"
            for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return seconds


def build_log(name: str) -> str:
    """The compiler's output for ``name`` (registers, spills, smem)."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str, signature: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``signature`` = {function: (restype, argtypes)} declared."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in signature.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib


def check(err: int, what: str):
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
