"""Quickstart: the paper's ExpMul operator and the FlashAttention-2 forward
with its ExpMul variant, in three short sections (the port of
``examples/quickstart.py``):

  python -m repro_torch.launch.quickstart [--device cuda|cpu]

(with ``src`` on ``PYTHONPATH``). ``--device`` defaults to ``cuda`` and
fails without a card; there the operator and the attention forward run on
the hand-written kernels (``csrc/expmul.cu``, ``csrc/flash.cu``).
``--device cpu`` runs their plain versions. ``main`` returns the tensors
it printed, for the tests.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import attention, flash_ref
from repro_torch.kernels.expmul.ops import expmul_rows
from repro_torch.kernels.flash.ops import flash_attention_fwd
from repro_torch.models.api import resolve_device
from repro_torch.numerics.log2exp import log2exp_lhat

B, H, S, D = 1, 4, 256, 64


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"{e} (--device cpu)")

    print("=== 1. The ExpMul operator: e^x * V by exponent-field arithmetic ===")
    x = torch.tensor([-0.5, -2.0, -7.3], device=device)
    v = (torch.ones((3, 4), device=device)
         * torch.tensor([1.5, 2.0, 3.0], device=device)[:, None])
    lhat = log2exp_lhat(x)
    out = expmul_rows(x, v)
    exact = torch.exp(x)[:, None] * v
    print("L_hat = round(-x * 1.4375):", lhat.cpu().numpy())
    print("ExpMul(x, V)   =", out[:, 0].cpu().numpy())
    print("exact e^x * V  =", exact[:, 0].cpu().numpy())
    print("-> each weight is the nearest power of two; no exp, no FP multiply")

    print("\n=== 2. FlashAttention-2 kernel: exact vs ExpMul variant ===")
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, vv = (torch.randn((B, H, S, D), generator=gen, device=device)
                for _ in range(3))
    o_exact = flash_attention_fwd(q, k, vv, causal=True)
    o_expmul = flash_attention_fwd(q, k, vv, causal=True, variant="expmul")
    err = (o_exact - o_expmul).abs()
    print(f"max |exact - expmul| = {float(err.max()):.4f}, "
          f"mean = {float(err.mean()):.5f}")
    print("(power-of-two softmax weights; numerator and denominator quantize")
    print(" together, so normalized outputs stay close — the paper's Table I)")

    print("\n=== 3. The same thing through the composable attention API ===")
    o_ref = flash_ref(q, k, vv, variant="expmul")
    print("flash_ref(..., variant='expmul') ->", tuple(o_ref.shape), o_ref.dtype)
    cfg = ModelConfig(attention_variant="expmul", attention_impl="kernel")
    o_api = attention(q, k, vv, cfg)
    print("attention(..., cfg: kernel, expmul) ->", tuple(o_api.shape),
          o_api.dtype)
    return dict(x=x, v=v, lhat=lhat, expmul=out, exact=exact, q=q, k=k,
                vv=vv, o_exact=o_exact, o_expmul=o_expmul, o_ref=o_ref,
                o_api=o_api)


if __name__ == "__main__":
    main()
