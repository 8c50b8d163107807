"""ExpMul kernel package: the paper's fused exp-and-multiply operator.

Its implementations share one numerics contract
(``repro_torch/numerics/log2exp.py``; the fixed-point format, the clip
range [-15, 0], the 1.4375 ~= log2 e shift-add identity, the flush rules):

  * ``expmul_fwd``   -- the CUDA kernel (``csrc/expmul.cu``; integer and
                        bit operations only), its plain version for CPU
                        tensors;
  * ``expmul_ref``   -- the frexp/ldexp "textbook" oracle (``ref.py``),
                        structurally independent cross-check;
  * ``expmul_rows``  -- the shape-agnostic public entry point (``ops.py``),
                        flattening to the kernel's (rows, d);
  * ``expmul_bcast`` -- the general broadcasting bit path
                        (``numerics.log2exp.expmul``), plain PyTorch.

``expmul_exact_ref`` computes the exact ``e^x * v`` baseline for error
measurements.
"""
from repro_torch.kernels.expmul.ops import expmul_fwd, expmul_rows
from repro_torch.kernels.expmul.ref import expmul_exact_ref, expmul_ref
from repro_torch.numerics.log2exp import expmul as expmul_bcast

__all__ = ["expmul_fwd", "expmul_rows", "expmul_bcast", "expmul_ref",
           "expmul_exact_ref"]
