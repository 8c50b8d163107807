"""Build and load the hand-written Hopper kernels of ``csrc/``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, loaded with ``ctypes``. A library is compiled in parts, each
with ``nvcc -c`` for ``sm_90a`` into an object: one a KV dtype for the
four serving kernels (``PARTS``: the same source with
``-DREPRO_PART=<the dtype's code>``, keeping only that dtype's
instantiations), one for flash and ExpMul, and linked by one
``nvcc -shared``. The libraries go to
``build/`` beside this package (listed in ``.gitignore``) under a name that
carries a hash of the sources, the headers and every part's flags, so an
edited source is never served by a stale build.

``start_all()`` submits every part of every missing library to a pool
of ``jobs()`` threads (the host's cores), each running one nvcc at a time,
and returns; the thread that ends a library's last part links it.
``load()`` of a library waits for its build alone, ``wait()`` for the
named ones, and ``build_all()`` is both. A failed part fails its
library's build with that part's log; no kernel falls back to its plain
version. A process that exits while parts compile waits for them (the
pool's threads are joined at exit), so no nvcc outlives it.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.

``COUNTS`` records, per kernel, the launches of the CUDA kernel
(``"<name>"``) and the calls of its plain PyTorch version
(``"<name>_plain"``); the paged kernels also count their launches on the
whole-row walk (``"<name>_whole"``, a part of ``"<name>"``; ``WALKS``).
``chip_smoke.py`` reads it to show that the serving and training paths
went through the kernels.

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
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
# in the order their builds start: ExpMul and flash first (the first
# phases of chip_smoke.py load them), then the serving kernels' parts
SOURCES = ("expmul", "flash", "paged_prefill", "paged_decode", "prefill",
           "decode")
HEADERS = ("tile.cuh", "tile_sm90.cuh")
# the parts of a library compiled apart: one a KV dtype, numbered by
# csrc/tile.cuh's dtype codes (tile_sm90.cuh: REPRO_PART); a source not
# named here is one part
KV_PARTS = ("f32", "bf16", "int8", "fp8")
PARTS = {name: KV_PARTS for name in ("paged_decode", "paged_prefill",
                                     "decode", "prefill")}

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

# the paged kernels' walks (csrc/tile_sm90.cuh: kWalkAuto, kWalkGeneral,
# kWalkWhole) and the suffix of a kernel's whole-row launch count
WALKS = {"auto": -1, "general": 0, "whole": 1}
WHOLE = "_whole"

COUNTS: collections.Counter = collections.Counter()
DISPATCH_SINK = None

_LIBS: dict[str, ctypes.CDLL] = {}
_BUILDS: dict = {}    # name -> _Build, while it builds and after
_POOL: ThreadPoolExecutor | None = None
_WALK = WALKS["auto"]


def reset_counts():
    COUNTS.clear()


def launch_counts(counts=None) -> dict:
    """``counts`` (default ``COUNTS``) without the walk counts: each
    kernel's launches and each plain version's calls."""
    counts = COUNTS if counts is None else counts
    return {k: n for k, n in counts.items() if not k.endswith(WHOLE)}


def walk_code() -> int:
    """The walk the paged kernels' wrappers ask for now (``forced_walk``)."""
    return _WALK


@contextlib.contextmanager
def forced_walk(walk: str):
    """Inside the block, every paged kernel launch asks for ``walk``
    ("general", "whole" or "auto", as outside any block). A forced
    "whole" on a call that does not qualify raises in the wrapper: the
    kernel refuses it and nothing launches."""
    global _WALK
    before, _WALK = _WALK, WALKS[walk]
    try:
        yield
    finally:
        _WALK = before


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


def jobs() -> int:
    """How many nvcc processes run at once: the host's cores."""
    return os.cpu_count() or 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit (set CUDA_HOME)")
    return found


def parts(name: str) -> tuple:
    """The parts of library ``name``: its KV dtypes, or ("",), the whole
    source."""
    return PARTS.get(name, ("",))


def part_flags(name: str, part: str) -> tuple:
    """The flags that make ``part`` of ``name`` (none for a whole source)."""
    return (f"-DREPRO_PART={KV_PARTS.index(part)}",) if part else ()


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for part in parts(name):
        h.update(f"|{part}:{' '.join(part_flags(name, part))}".encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _log_path(name: str, part: str) -> Path:
    out = _lib_path(name)
    return out.with_name(f"{out.stem}.{part or 'all'}.log")


class _Build:
    """One library's build: its parts' objects, then the link."""

    def __init__(self, name):
        self.name, self.out = name, _lib_path(name)
        tag = f"{os.getpid()}"
        self.tmp = self.out.with_suffix(f".{tag}.tmp")
        self.objs = {p: self.out.with_name(f"{self.out.stem}.{p or 'all'}"
                                           f".{tag}.o") for p in parts(name)}
        self.left = len(self.objs)        # parts not yet ended
        self.seconds: dict = {}            # part (or "link") -> seconds
        self.start = self.end = None
        self.errors: list = []
        self.futures: list = []
        self.lock = threading.Lock()

    def run(self, part, cmd) -> bool:
        """Run one nvcc (a part's compile, or the link) into its log; False,
        with the error noted, if it failed."""
        log = _log_path(self.name, part)
        t0 = time.perf_counter()
        with open(log, "w") as f:
            rc = subprocess.run(cmd, stdout=f,
                                stderr=subprocess.STDOUT).returncode
        self.seconds[part] = time.perf_counter() - t0
        if rc != 0:
            self.errors.append(
                f"nvcc failed for {self.name}"
                + (f" part {part}" if part else "")
                + f" (log {log}):\n{log.read_text()}")
        return rc == 0

    def compile(self, part, cmd):
        """A pool thread's job: compile ``part``; the thread that ends the
        last part links the library, or with a failed part drops it."""
        with self.lock:
            if self.start is None:
                self.start = time.perf_counter()
        try:
            self.run(part, cmd)
        finally:
            with self.lock:
                self.left -= 1
                last = self.left == 0
        if not last:
            return
        if not self.errors and self.run("link", [
                _nvcc(), *LINK_FLAGS, "-o", str(self.tmp),
                *map(str, self.objs.values())]):
            os.replace(self.tmp, self.out)
        for path in [*self.objs.values(), self.tmp]:
            path.unlink(missing_ok=True)
        self.end = time.perf_counter()


def start_all(names=SOURCES) -> None:
    """Submit every part of every missing library of ``names``, in order,
    to the pool and return without waiting. ``load`` of a library waits
    for its own build only, so work on a library that is ready runs while
    others compile; ``wait`` collects them."""
    global _POOL
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if _POOL is None:
        _POOL = ThreadPoolExecutor(jobs(), thread_name_prefix="nvcc")
    for name in names:
        b = _BUILDS.get(name)
        if (b is not None and not all(f.done() for f in b.futures)) or (
                _lib_path(name).exists()):
            continue
        b = _BUILDS[name] = _Build(name)
        src = str(CSRC / f"{name}.cu")
        b.futures = [_POOL.submit(b.compile, p, [
            _nvcc(), *NVCC_FLAGS, *part_flags(name, p), "-c", "-o", str(o),
            src]) for p, o in b.objs.items()]


def wait(names=SOURCES) -> dict:
    """Wait for the builds of ``names`` that ``start_all`` started; returns
    {name: seconds}, each its build's from its first part's start to its
    link's end (0.0 for a library built by an earlier process); raises if
    a part failed, naming it, with its log."""
    failed = []
    for name in names:
        b = _BUILDS.get(name)
        if b is None:
            continue
        for f in b.futures:
            f.result()          # an nvcc that could not start raises here
        failed += b.errors
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: (b.end - b.start if (b := _BUILDS.get(name)) else 0.0)
            for name in names}


def part_seconds(names=SOURCES) -> dict:
    """{name: {part: seconds}}: each nvcc process's seconds ("" the whole
    source, "link" the link) of the builds this process ran."""
    return {name: dict(_BUILDS[name].seconds) for name in names
            if name in _BUILDS}


def wall_seconds(names=SOURCES) -> float:
    """Seconds from the first part's start to the last link's end of the
    builds of ``names`` this process ran (0.0 if none)."""
    runs = [_BUILDS[n] for n in names if n in _BUILDS and _BUILDS[n].end]
    if not runs:
        return 0.0
    return max(b.end for b in runs) - min(b.start for b in runs)


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, its parts in parallel, and wait for
    them; returns {name: seconds} (0.0 for a library already built)."""
    start_all(names)
    return wait(names)


def build_log(name: str) -> str:
    """The compiler's output for ``name``, part by part (registers,
    spills, shared memory), then the link's."""
    logs = [(p, _log_path(name, p)) for p in (*parts(name), "link")]
    return "".join(f"# part {p or 'all'}\n{path.read_text()}"
                   for p, path in logs if path.exists())


def load(name: str, signature: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``signature`` = {function: (restype, argtypes)} declared."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():   # waits for a build start_all began
            start_all((name,))
            wait((name,))
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
