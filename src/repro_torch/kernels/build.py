"""Build and load the hand-written Hopper kernels of ``csrc/``.

Each ``csrc/*.cu`` compiles on its own, with ``nvcc`` for ``sm_90a``, into
a shared library with a plain C interface, loaded with ``ctypes``. The
libraries go to ``build/`` beside this package (listed in ``.gitignore``)
under a name that carries a hash of the sources, so an edited source is
never served by a stale build. ``build_all()`` starts one ``nvcc`` per
source at once and waits for all of them; ``start_all()`` starts them and
returns, and ``load()`` of a library then waits for its build alone.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.

``COUNTS`` records, per kernel, the launches of the CUDA kernel
(``"<name>"``) and the calls of its plain PyTorch version
(``"<name>_plain"``); ``chip_smoke.py`` reads it to show that the serving
and training paths went through the kernels.

``DISPATCH_SINK`` is the one process-global observer of the attention
wrappers (``kernels/flash/ops.py``, ``kernels/decode/ops.py``): when set
(``set_dispatch_sink``, or ``serve.metrics.install_dispatch_counters``)
each wrapper call reports its kind and shapes to it once.

Both fire in Python, so under a CUDA graph they fire when the graph is
captured, not when it is replayed: ``recording()`` takes what fires
during a capture into a ``Recording``, whose ``replay()`` re-applies it
once per replay of the graph (``serve/graphs.py``). The counts and the
sink then read the same under graphs as under eager calls.
"""
from __future__ import annotations

import collections
import contextlib
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
DISPATCH_SINK = None

_LIBS: dict[str, ctypes.CDLL] = {}
_PENDING: dict = {}   # name -> (nvcc process, tmp path, lib path, log, start)
_SECONDS: dict = {}   # name -> its nvcc's seconds, once collected


def reset_counts():
    COUNTS.clear()


def set_dispatch_sink(sink) -> None:
    """Install (or with ``None`` remove) the attention wrappers' observer."""
    global DISPATCH_SINK
    DISPATCH_SINK = sink


class Recording:
    """The launches (``COUNTS`` increments) and dispatch-sink calls that
    fired inside one ``recording()`` block."""

    def __init__(self):
        self.counts: collections.Counter = collections.Counter()
        self.sink_calls: list = []

    def replay(self):
        """Apply them once more: add the counts, and repeat each sink call
        into the sink installed now (none: nothing to report)."""
        COUNTS.update(self.counts)
        if DISPATCH_SINK is not None:
            for args, kwargs in self.sink_calls:
                DISPATCH_SINK(*args, **kwargs)


@contextlib.contextmanager
def recording():
    """Divert ``COUNTS`` and ``DISPATCH_SINK`` into a fresh ``Recording``
    for the block; after it both read as they did before it."""
    global DISPATCH_SINK
    rec = Recording()
    counts, sink = COUNTS.copy(), DISPATCH_SINK
    DISPATCH_SINK = lambda *a, **k: rec.sink_calls.append((a, k))  # noqa: E731
    try:
        yield rec
    finally:
        rec.counts = COUNTS - counts
        COUNTS.clear()
        COUNTS.update(counts)
        DISPATCH_SINK = sink


def kv_label(codes, scale) -> str:
    """The ``kv_dtype`` label of a cache or pool: "fp32" when it has no
    scale rows (unquantized, whatever its float type), else its codes'."""
    if scale is None:
        return "fp32"
    return "int8" if str(codes.dtype) == "torch.int8" else "fp8"


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


def start_all(names=SOURCES) -> None:
    """Start one nvcc for every missing library of ``names``, all at once,
    and return without waiting: ``load`` of a library waits for its own
    build only, so work on a library that is ready runs while the others
    compile. ``wait`` collects them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in names:
        out = _lib_path(name)
        if name in _PENDING or out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        _PENDING[name] = (subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT),
                          tmp, out, log, time.perf_counter())


def wait(names=SOURCES) -> dict:
    """Wait for the builds of ``names`` that ``start_all`` started; returns
    {name: seconds}, each its own nvcc's from its start (0.0 for a library
    built by an earlier process); raises if an nvcc failed."""
    procs = {name: _PENDING[name] for name in names if name in _PENDING}
    failed = []
    while procs:
        for name, (proc, tmp, out, log, t0) in list(procs.items()):
            rc = proc.poll()
            if rc is None:
                continue
            log.close()
            _SECONDS[name] = time.perf_counter() - t0
            del procs[name], _PENDING[name]
            if rc != 0:
                failed.append(name)
                continue
            os.replace(tmp, out)
        time.sleep(0.05)
    if failed:
        msgs = "\n".join(
            f"--- {n} ---\n{_lib_path(n).with_suffix('.log').read_text()}"
            for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return {name: _SECONDS.get(name, 0.0) for name in names}


def build_all(names=SOURCES) -> dict:
    """Compile every missing library in parallel and wait for them;
    returns {name: seconds} (0.0 for a library that was already built)."""
    start_all(names)
    return wait(names)


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
        if not path.exists():   # waits for a build start_all began
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
