"""The dense zoo archs the port serves beside qwen2-0.5b: gemma-7b (GeGLU,
embeddings scaled by sqrt(d_model), head dim 32 in its smoke config, 256
at full width) and qwen1.5-0.5b (MHA with QKV bias), each held against
``repro`` on converted weights.

The layers: gemma's scaled embedding bit for bit in float32 and bfloat16
(``repro`` multiplies by a numpy float32 scalar, so a bfloat16 row becomes
a float32 product before the cast to the compute dtype), and the GeGLU
MLP within 1e-6 of its output's magnitude in float32 (the tanh GELU of
XLA and of PyTorch differ in the last bits; in bfloat16 XLA on the CPU
rounds each step of it, PyTorch once, so parity is held in float32).
The slice: the prefill and decode ticks' logits (``test_torch_model.py``'s
walks at its ``SAME_WALK_TOL``) and the temp-0 engine streams
(``test_torch_engine.py``'s), each against ``repro`` at
``attention_impl="pallas"``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.costs import attn_kv_geometry as jax_geometry  # noqa: E402
from repro.layers import embedding as jembedding  # noqa: E402
from repro.layers import mlp as jmlp  # noqa: E402
from repro.serve.engine import analytic_prefill_flops as jax_flops  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels.costs import attn_kv_geometry  # noqa: E402
from repro_torch.layers import embedding, mlp  # noqa: E402
from repro_torch.layers.common import activation_fn  # noqa: E402
from repro_torch.serve.engine import analytic_prefill_flops  # noqa: E402
from test_torch_engine import contiguous_streams, paged_streams  # noqa: E402
from test_torch_model import contiguous_ticks, paged_ticks  # noqa: E402

GEMMA, QWEN15 = "gemma-7b", "qwen1.5-0.5b"


@pytest.mark.parametrize("arch", [GEMMA, QWEN15])
def test_config_matches_repro(arch):
    assert arch in ARCH_IDS
    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(arch,
                                                                  smoke=smoke)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "activation", "qkv_bias",
                  "tie_embeddings", "scale_embeddings", "rope_base"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert cfg.resolved_head_dim() == jcfg.resolved_head_dim()
        assert cfg.param_count() == jcfg.param_count()
        assert (analytic_prefill_flops(cfg, 100, 356)
                == jax_flops(jcfg, 100, 356))
        assert attn_kv_geometry(cfg) == jax_geometry(jcfg)
    if arch == GEMMA:
        assert get_config(arch).param_count() == 8_537_680_896
        assert get_config(arch).resolved_head_dim() == 256


@pytest.mark.parametrize("d_model", [64, 3072])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scaled_embedding_matches_repro_bit_for_bit(dtype, d_model):
    """At the smoke width (sqrt(64) = 8, a power of two) and at gemma's
    (sqrt(3072) = 55.43..., where a bfloat16 product rounds otherwise)."""
    over = dict(dtype=dtype, param_dtype=dtype, d_model=d_model)
    cfg = get_config(GEMMA, smoke=True, **over)
    jcfg = jax_get_config(GEMMA, smoke=True, **over)
    rng = np.random.default_rng(0)
    table = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (3, 7)).astype(np.int32)
    jdt = jnp.dtype(dtype)
    ref = jembedding.embed_apply({"table": jnp.asarray(table, jdt)},
                                 jnp.asarray(toks), jcfg)
    assert ref.dtype == jnp.float32          # promoted by the float32 scalar
    ref = np.asarray(ref.astype(jdt).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = embedding.embed_apply(
        {"table": torch.from_numpy(table).to(tdt)}, torch.from_numpy(toks),
        cfg)
    assert got.dtype == torch.float32
    got = got.to(tdt).to(torch.float32).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    # not the unscaled rows, and not a bfloat16 product
    assert not np.array_equal(got, table[toks])
    if dtype == "bfloat16" and d_model == 3072:
        bf_row = (torch.from_numpy(table).to(tdt)[torch.from_numpy(toks)]
                  * torch.tensor(math.sqrt(cfg.d_model), dtype=tdt))
        assert not torch.equal(bf_row.to(torch.float32),
                               torch.from_numpy(got))


def test_geglu_mlp_matches_repro():
    cfg = get_config(GEMMA, smoke=True)
    rng = np.random.default_rng(1)
    d, f = cfg.d_model, cfg.d_ff
    p = {k: (rng.standard_normal(s) / math.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_up", (d, f)), ("w_gate", (d, f)),
                      ("w_down", (f, d)))}
    x = rng.standard_normal((5, 9, d)).astype(np.float32) * 2.0
    ref = np.asarray(jmlp.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x), "geglu"))
    got = mlp.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), "geglu").numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    # the swiglu MLP of the same weights is another function
    other = mlp.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), "swiglu").numpy()
    assert np.abs(other - ref).max() > 1e-2 * np.abs(ref).max()
    # the non-gated GELU MLP (seamless-m4t-medium) has no gate
    plain = mlp.mlp_init(d, f, "gelu", torch.float32, torch.Generator(),
                         "cpu")
    assert set(plain) == {"w_up", "w_down"}


def test_geglu_rounds_once_in_bfloat16():
    """The port's bfloat16 tanh GELU is the float32 one rounded once (the
    difference from XLA's stepwise rounding on the CPU is recorded in
    ROADMAP C, not imitated)."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(4096)
                         .astype(np.float32) * 4).to(torch.bfloat16)
    got = activation_fn("geglu")(x)
    want = F.gelu(x.to(torch.float32), approximate="tanh").to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch,layout,variant,kv_dtype", [
    (GEMMA, "paged", "exact", "fp32"), (GEMMA, "paged", "exact", "int8"),
    (GEMMA, "paged", "expmul", "fp32"), (GEMMA, "paged", "expmul", "int8"),
    (GEMMA, "contiguous", "exact", "fp32"),
    (GEMMA, "contiguous", "expmul", "fp32"),
    (QWEN15, "paged", "expmul", "int8")])
def test_ticks_match_repro(arch, layout, variant, kv_dtype):
    if layout == "paged":
        paged_ticks(variant, kv_dtype, arch=arch)
    else:
        contiguous_ticks(variant, kv_dtype, None, 24, ([5, 0, 3], [4, 0, 2]),
                         arch=arch)


@pytest.mark.parametrize("arch,layout,variant,kv_dtype", [
    (GEMMA, "paged", "exact", "int8"), (GEMMA, "paged", "expmul", "int8"),
    (GEMMA, "contiguous", "exact", "fp32"),
    (GEMMA, "contiguous", "expmul", "fp32"),
    (QWEN15, "contiguous", "expmul", "fp32")])
def test_temp0_streams_match_repro_engine(arch, layout, variant, kv_dtype):
    if layout == "paged":
        paged_streams(variant, kv_dtype, arch=arch)
    else:
        contiguous_streams(variant, kv_dtype, arch=arch)
