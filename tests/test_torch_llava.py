"""llava-next-34b in the port: a GQA decoder (56 / 8 heads of 128 at full
width, RoPE base 5e6, an untied head) behind a stub vision frontend whose
projected patch embeddings are prepended to the text, held against
``repro`` on converted weights in float32.

``repro`` runs at ``attention_impl="pallas"`` (its Pallas kernels in
interpret mode on the CPU), the port on its kernels' plain versions: the
config and its parameter count; ``forward`` with ``frontend_embeds``
(positions counting the patches) and without, exact and ExpMul; the
``loss_fn`` value over the text positions alone; ``token_count`` and
``make_batch``; temp-0 engine streams on a paged int8 pool (the engine
serves text, as ``repro``'s does); the serving CLI.

Tolerance, relative to the reference's largest magnitude: 1e-5 (measured:
under 6e-7; the matmuls sum in another order than XLA's); the loss
within 1e-5 of its value; streams equal.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import inputs as jinputs  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import inputs  # noqa: E402
from test_torch_engine import paged_streams  # noqa: E402

ARCH = "llava-next-34b"
F32 = dict(dtype="float32", param_dtype="float32")
TOL = 1e-5


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@functools.lru_cache(maxsize=None)
def _models(variant):
    jcfg = jax_get_config(ARCH, smoke=True, attention_impl="pallas",
                          attention_variant=variant, **F32)
    params = japi.init_model(jax.random.PRNGKey(0), jcfg)
    cfg = get_config(ARCH, smoke=True, attention_variant=variant, **F32)
    return jcfg, params, cfg, params_from_jax(
        jax.tree.map(np.asarray, params), cfg, device="cpu")


def _batch(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "frontend_embeds": rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                    np.float32)}


def test_config_matches_repro():
    assert ARCH in ARCH_IDS
    for smoke in (False, True):
        cfg, jcfg = get_config(ARCH, smoke=smoke), jax_get_config(
            ARCH, smoke=smoke)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "activation", "norm",
                  "tie_embeddings", "rope_base", "frontend",
                  "frontend_tokens", "frontend_dim", "encoder_layers"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert cfg.resolved_head_dim() == jcfg.resolved_head_dim()
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
    full = get_config(ARCH)
    assert full.param_count() == 34_396_257_280
    assert full.resolved_head_dim() == 128 and full.frontend_tokens == 576
    # the frontend projection is counted (frontend_dim x d_model)
    assert (full.param_count() - full.replace(frontend=None).param_count()
            == 1024 * 7168)


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_forward_with_frontend_matches_repro(variant):
    jcfg, params, cfg, tparams = _models(variant)
    batch = _batch(cfg)
    ref = japi.forward(params, jax.tree.map(jnp.asarray, batch), jcfg)
    before = build.COUNTS["flash_plain"]
    got = tapi.forward(tparams, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, cfg)
    assert build.COUNTS["flash_plain"] == before + cfg.num_layers
    T = cfg.frontend_tokens
    assert got.shape == (2, T + 12, cfg.vocab_size)
    assert _rel(got.detach().numpy(), ref) <= TOL
    # the patches reach the text: the text alone gives other logits
    text = {"tokens": batch["tokens"]}
    alone = tapi.forward(tparams, {"tokens": torch.from_numpy(
        batch["tokens"])}, cfg).detach().numpy()
    assert _rel(alone, japi.forward(params, jax.tree.map(jnp.asarray, text),
                                    jcfg)) <= TOL
    assert _rel(got.detach().numpy()[:, T:], alone) > 1e-3


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_loss_drops_the_frontend_positions(variant):
    jcfg, params, cfg, tparams = _models(variant)
    batch = _batch(cfg, seed=1)
    batch["loss_mask"] = (np.arange(12)[None, :] < np.array([[12], [7]])
                          ).astype(np.float32)
    ref = float(japi.loss_fn(params, jax.tree.map(jnp.asarray, batch),
                             jcfg))
    got = float(tapi.loss_fn(tparams, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}, cfg))
    assert abs(got - ref) <= TOL * abs(ref)


def test_token_count_and_make_batch():
    cfg, jcfg = get_config(ARCH, smoke=True), jax_get_config(ARCH,
                                                             smoke=True)
    for S in (16, 40):
        assert inputs.token_count(cfg, S) == jinputs.token_count(jcfg, S)
    gen = torch.Generator().manual_seed(0)
    for kind in ("train", "prefill", "decode"):
        got = inputs.make_batch(gen, cfg, seq_len=40, global_batch=3,
                                kind=kind, device="cpu")
        ref = jinputs.make_batch(jax.random.PRNGKey(0), jcfg, seq_len=40,
                                 global_batch=3, kind=kind)
        assert set(got) == set(ref)
        for name, t in got.items():
            assert tuple(t.shape) == ref[name].shape, name
            assert str(t.dtype).split(".")[-1] == str(ref[name].dtype), name
        for name in ("tokens", "tokens1"):
            if name in got:
                assert 0 <= int(got[name].min())
                assert int(got[name].max()) < cfg.vocab_size
    # an encoder-decoder's text is all of seq_len
    enc = get_config("seamless-m4t-medium", smoke=True)
    assert inputs.token_count(enc, 40) == 40
    with pytest.raises(ValueError):
        inputs.make_batch(gen, cfg, seq_len=40, global_batch=3, kind="x",
                          device="cpu")


def test_temp0_streams_match_repro_engine():
    """Paged int8, ExpMul: the engine serves the text backbone."""
    paged_streams("expmul", "int8", arch=ARCH)


def test_serve_cli_smoke_on_cpu(capsys):
    reqs = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--requests", "3", "--max-new", "4", "--chunk",
                           "8", "--kv-layout", "paged", "--kv-dtype",
                           "int8"])
    assert [len(r.out) for r in reqs] == [4, 4, 4]
    assert all(r.finish_reason == "length" for r in reqs)
    assert "kv=paged/int8" in capsys.readouterr().out
