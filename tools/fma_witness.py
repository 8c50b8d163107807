#!/usr/bin/env python3
"""Whether the plain tile step's products sum as the kernels do: a witness
on the card.

    python3 tools/fma_witness.py

from the repository root, on a machine with an NVIDIA Hopper card and the
CUDA toolkit. It builds a ten-line CUDA kernel (into a temporary directory
it removes) that sums ``a @ b`` as the attention kernels do, one ``fmaf``
chain per output over k = 0, 1, ..., K - 1 from 0, and holds against it,
bit for bit:

* ``kernels/flash/tile.py:fma_chain`` on the card and on the host;
* a chain of ``torch.addcmul`` in float32 on the card and on the host
  (rounded once only if ``addcmul`` compiles to a fused multiply-add);
* ``torch.matmul`` (the plain tile step's products before ``fma_chain``).

The inputs are chosen so that fused and unfused rounding differ: float32
operands over a wide spread of exponents, and one output whose fused
result differs both from the unfused one and from a float64 sum rounded
to float32 (rounding twice). It prints the
count of outputs that differ from the kernel's for each, and the time of
one ``fma_chain`` step on the card at the serving shapes' tile sizes. It
prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

KERNEL = r"""
extern "C" __global__ void chain(const float* a, const float* b, float* out,
                                 int M, int K, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  const int m = i / N, n = i % N;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) acc = fmaf(a[m * K + k], b[k * N + n], acc);
  out[i] = acc;
}
extern "C" int fmaf_chain(const float* a, const float* b, float* out, int M,
                          int K, int N, void* stream) {
  chain<<<(M * N + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a, b, out, M, K, N);
  return (int)cudaGetLastError();
}
"""


def operands(rng, M, K, N):
    """float32 a (M, K), b (K, N) over exponents 2^-24..2^24; the last row
    of a and column of b give the output 1 + 2^-24 (1 + x) (1 - x + x^2)
    at x = 2^-11, exactly 1 + 2^-24 + 2^-57: fused, it rounds to
    1 + 2^-23; with the product rounded first, or in float64 and then to
    float32, it lands on the midpoint 1 + 2^-24 and rounds to 1."""
    a = (rng.standard_normal((M, K))
         * 2.0 ** rng.integers(-24, 25, (M, K))).astype(np.float32)
    b = (rng.standard_normal((K, N))
         * 2.0 ** rng.integers(-24, 25, (K, N))).astype(np.float32)
    x = 2.0 ** -11
    a[-1] = 0.0
    b[:, -1] = 0.0
    a[-1, :2] = (1.0, 2.0 ** -24 * (1 + x))
    b[:2, -1] = (1.0, 1 - x + x * x)
    return a, b


def fmaf_chain_kernel(directory):
    """Build KERNEL into ``directory``; returns ``run(a, b)``: float32
    a (M, K) @ b (K, N) on the card, one ``fmaf`` chain per output."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    src, lib_path = Path(directory) / "chain.cu", Path(directory) / "libchain.so"
    src.write_text(KERNEL)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.fmaf_chain.restype = ctypes.c_int
    lib.fmaf_chain.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]

    def run(a, b):
        a, b = a.contiguous(), b.contiguous()
        (M, K), N = a.shape, b.shape[1]
        out = torch.empty(M, N, device=a.device)
        err = lib.fmaf_chain(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K,
                             N, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fmaf_chain launch failed: {err}")
        return out
    return run


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("fma_witness: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.flash.tile import fma_chain

    print(chip_smoke.card_line(), flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="fma_witness_"))
    try:
        kernel = fmaf_chain_kernel(tmp)
        rng = np.random.default_rng(0)
        total = {}
        for M, K, N in ((64, 64, 64), (33, 256, 65), (7, 16, 64)):
            a_h, b_h = operands(rng, M, K, N)
            a, b = torch.from_numpy(a_h).cuda(), torch.from_numpy(b_h).cuda()
            want = kernel(a, b)

            def addcmul_chain(a, b):
                acc = torch.zeros(M, N, device=a.device)
                for k in range(K):
                    acc = torch.addcmul(acc, a[:, k, None], b[None, k, :])
                return acc

            got = {
                "fma_chain, card": fma_chain(a, b),
                "fma_chain, host": fma_chain(a.cpu(), b.cpu()).cuda(),
                "addcmul chain, card": addcmul_chain(a, b),
                "addcmul chain, host": addcmul_chain(a.cpu(), b.cpu()).cuda(),
                "torch.matmul, card": torch.matmul(a, b),
            }
            torch.cuda.synchronize()
            w = want.view(torch.int32)
            for name, g in got.items():
                n = int((g.view(torch.int32) != w).sum())
                total[name] = total.get(name, 0) + n
                row = "exact" if bool(g[-1, -1] == want[-1, -1]) else "WRONG"
                print(f"({M}, {K}) @ ({K}, {N}): {name}: {n} of {M * N} "
                      f"outputs differ from the fmaf kernel's bits; the "
                      f"double-rounding output {row}", flush=True)
        print(f"in all: {total}", flush=True)
        # one fma_chain step at the paged tiles' sizes: scores (16 x 7 rows
        # by 16 columns, depth 64) and values (16 x 7 rows by 64 features,
        # 16 columns)
        for what, shape_a, shape_b in (
                ("scores", (16, 7, 64), (16, 64, 16)),
                ("values", (16, 7, 16), (16, 16, 64))):
            x = torch.randn(shape_a, device="cuda")
            y = torch.randn(shape_b, device="cuda")
            fma_chain(x, y)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fma_chain(x, y)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 10 * 1e3
            print(f"fma_chain on the card, {what} {shape_a} @ {shape_b}: "
                  f"{ms:.3f} ms a chain, {ms / shape_a[-1] * 1e3:.1f} us a "
                  f"step", flush=True)
        bad = total["fma_chain, card"] + total["fma_chain, host"]
        return 0 if bad == 0 else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
