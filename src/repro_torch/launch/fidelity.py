"""The paper's Table I fidelity study (the port of
``benchmarks/table1_fidelity.py``): train a small LM with exact attention,
then evaluate the SAME weights on the paper's grid {FP32, BF16} x {exact,
ExpMul}: perplexity, greedy-token agreement with FP32-exact, and the raw
attention-output error. The paper's claim reproduces as: quality metrics
stay flat across the grid while per-element attention outputs differ.

  python -m repro_torch.launch.fidelity [--device cuda|cpu]

(with ``src`` on ``PYTHONPATH``). The model is ``table1-lm`` (4 layers,
d_model 128 over 4 query / 2 KV heads of 32, d_ff 512, vocab 2048,
float32), trained 200 steps of 8 x 64 tokens of ``SyntheticLMDataset(2048,
64, seed=0)`` with ``adamw(1e-3)``, by the study's own update: value and
gradient, ``opt.update``, ``p + u``, no clipping (``train/step.py`` clips
at 1.0 and is not used). Evaluation runs batches 1000-1007 of 8, with the
parameters cast to bfloat16 for the BF16 rows. The attention forward is
the flash kernel's (``csrc/flash.cu``) on the card, its plain version
with ``--device cpu``; ``--device`` defaults to ``cuda`` and fails
without a card. The raw attention error is taken on (2, 4, 128, 64) with
``flash_ref``, the twin of the reference's ``flash_jnp``. Weights and
attention inputs come from seeded ``torch.Generator``s, so the numbers
differ from the reference's (JAX's generator draws other numbers).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import flash_ref
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.models.api import forward, init_model, resolve_device
from repro_torch.optim.adamw import adamw
from repro_torch.train.step import value_and_grad
from repro_torch.tree import tree_leaves, tree_map

CFG = ModelConfig(
    name="table1-lm", num_layers=4, d_model=128, num_heads=4,
    num_kv_heads=2, d_ff=512, vocab_size=2048, dtype="float32",
    param_dtype="float32", attention_variant="exact",
)
EVAL_STEPS = range(1000, 1008)


def train(steps=200, batch=8, seq=64, device="cuda", params=None):
    """``steps`` updates from ``params`` (random weights from seed 0 when
    None); returns (params, the dataset)."""
    device = resolve_device(device)
    data = SyntheticLMDataset(CFG.vocab_size, seq, seed=0)
    if params is None:
        params = init_model(CFG, torch.Generator(device=device).manual_seed(0),
                            device=device)
    opt = adamw(1e-3)
    st = opt.init(params)
    for i in range(steps):
        tokens = torch.from_numpy(data.batch(i, batch)).to(device)
        _, grads = value_and_grad(params, {"tokens": tokens}, CFG)
        upd, st = opt.update(grads, st, params)
        params = tree_map(lambda p, u: p + u, params, upd)
    return params, data


@torch.no_grad()
def evaluate(params, data, variant, dtype, *, steps=EVAL_STEPS, batch=8):
    """(perplexity, greedy argmax (len(steps) * batch, seq)) of ``params``
    over ``data``'s batches ``steps`` under ``variant`` in ``dtype``."""
    cfg = CFG.replace(attention_variant=variant, dtype=dtype)
    p = params if dtype == "float32" else tree_map(
        lambda t: t.to(torch.bfloat16), params)
    device = tree_leaves(params)[0].device
    nll, ams = [], []
    for i in steps:
        toks = torch.from_numpy(data.batch(i, batch)).to(device)
        logits = forward(p, {"tokens": toks}, cfg).to(torch.float32)
        lp = torch.log_softmax(logits[:, :-1], -1)
        tgt = toks[:, 1:, None].to(torch.int64)
        nll.append(-float(torch.gather(lp, -1, tgt).mean()))
        ams.append(torch.argmax(logits, -1).cpu().numpy())
    return float(np.exp(np.mean(nll))), np.concatenate(ams)


@torch.no_grad()
def attention_error(device):
    """Mean |exact - ExpMul| of ``flash_ref`` on (2, 4, 128, 64) normals."""
    gen = torch.Generator(device=device).manual_seed(3)
    q, k, v = (torch.randn((2, 4, 128, 64), generator=gen, device=device)
               for _ in range(3))
    oe = flash_ref(q, k, v, variant="exact")
    oq = flash_ref(q, k, v, variant="expmul")
    return float((oe - oq).abs().mean())


def run(steps=200, batch=8, seq=64, device="cuda", params=None,
        eval_steps=EVAL_STEPS):
    """(the grid's rows, the raw attention error, seconds)."""
    t0 = time.time()
    params, data = train(steps, batch, seq, device, params)
    rows = []
    base_argmax = None
    for dtype in ("float32", "bfloat16"):
        for variant in ("exact", "expmul"):
            ppl, am = evaluate(params, data, variant, dtype, steps=eval_steps)
            if base_argmax is None:
                base_argmax = am
            rows.append({
                "config": f"{'FP32' if dtype == 'float32' else 'BF16'}"
                          f"{'-ExpMul' if variant == 'expmul' else ''}",
                "perplexity": ppl,
                "greedy_agree": float(np.mean(am == base_argmax)),
            })
    attn_err = attention_error(tree_leaves(params)[0].device)
    return rows, attn_err, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "attention kernel's plain version)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"{e} (--device cpu)")
    rows, attn_err, dt = run(device=device)
    print(f"# table1_fidelity ({dt:.0f}s)")
    print(f"{'config':14s} {'ppl':>9s} {'greedy-agree':>13s}")
    for r in rows:
        print(f"{r['config']:14s} {r['perplexity']:9.3f} "
              f"{r['greedy_agree']:12.2%}")
    print(f"raw attention |err| mean: {attn_err:.4f} "
          "(element-level error exists; task metrics are flat = paper's claim)")
    return rows, attn_err


if __name__ == "__main__":
    main()
