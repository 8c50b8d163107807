"""seamless-m4t-medium in the port: an encoder-decoder (12 + 12 layers,
LayerNorm, a non-gated GELU FFN, QKV bias, cross-attention) over a stub
speech frontend, held against ``repro`` on converted weights in float32.

``repro`` runs at ``attention_impl="pallas"`` (its Pallas kernels in
interpret mode on the CPU), the port on its kernels' plain versions. The
config and its parameter count; ``layernorm`` and the GELU MLP; the
cross-attention layer, full-sequence and one-token (``enc_len`` shorter
than the encoder's rows); ``forward``; ``encode_for_decode`` and a greedy
``decode_step`` loop, exact and ExpMul; the decode loop teacher-forced
against the port's own ``forward`` (exact only: ``forward``'s
cross-attention walks KV tiles, the decode's is one pass, so their ExpMul
weights differ); and every refusal of ``repro`` for an encoder-decoder:
quantized decode state, paged state, chunked and paged ticks,
``ServeEngine`` on both layouts, the serving CLI.

Tolerances, relative to the reference's largest magnitude: 1e-5 for
every output against ``repro`` (measured: under 7e-7; the matmuls sum in
another order than XLA's), 1e-4 for the teacher-forced decode against
``forward`` (tile walk against one pass in exact float32 arithmetic);
greedy tokens equal.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.layers import attention_layer as jattn  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.layers import mlp as jmlp  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.layers import attention_layer, common, mlp  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "seamless-m4t-medium"
F32 = dict(dtype="float32", param_dtype="float32")
TOL = 1e-5
SELF_TOL = 1e-4
B, MAX_LEN = 3, 32
ENC_LEN = np.array([16, 9, 12], np.int32)   # valid frames of 16


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@functools.lru_cache(maxsize=None)
def _models(variant):
    """(repro cfg, repro params, port cfg, port params): the same weights,
    with random norm gains and biases so that LayerNorm's bias shows."""
    jcfg = jax_get_config(ARCH, smoke=True, attention_impl="pallas",
                          attention_variant=variant, **F32)
    params = japi.init_model(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(7)

    def jitter(tree):   # every norm's scale and bias made nonzero
        if isinstance(tree, dict):
            return {k: (jnp.asarray(0.1 * rng.standard_normal(v.shape),
                                    v.dtype)
                        if k in ("scale", "bias") else jitter(v))
                    for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(jitter(t) for t in tree)
        return tree

    params = jitter(params)
    cfg = get_config(ARCH, smoke=True, attention_variant=variant, **F32)
    return jcfg, params, cfg, params_from_jax(
        jax.tree.map(np.asarray, params), cfg, device="cpu")


def _frames(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.frontend_tokens, cfg.frontend_dim)
                               ).astype(np.float32)


def test_config_matches_repro():
    assert ARCH in ARCH_IDS
    for smoke in (False, True):
        cfg, jcfg = get_config(ARCH, smoke=smoke), jax_get_config(
            ARCH, smoke=smoke)
        for f in ("num_layers", "encoder_layers", "decoder_layers",
                  "d_model", "num_heads", "num_kv_heads", "d_ff",
                  "vocab_size", "activation", "norm", "qkv_bias",
                  "tie_embeddings", "rope_base", "frontend",
                  "frontend_tokens", "frontend_dim"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert cfg.resolved_head_dim() == jcfg.resolved_head_dim()
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
    assert get_config(ARCH).param_count() == 614_849_536


def test_convert_keeps_every_leaf():
    jcfg, params, cfg, tparams = _models("exact")
    assert len(tparams["enc_layers"]) == cfg.encoder_layers
    assert len(tparams["dec_layers"]) == cfg.decoder_layers
    assert "layers" not in tparams
    layer = tparams["dec_layers"][1]
    assert set(layer) == {"norm_mix", "mix", "norm_cross", "cross",
                          "norm_ffn", "ffn"}
    assert set(layer["ffn"]) == {"w_up", "w_down"}          # no gate
    assert set(layer["cross"]) == {"wq", "wk", "wv", "wo"}   # no bias
    assert {"bq", "bk", "bv"} <= set(layer["mix"])
    np.testing.assert_array_equal(
        layer["norm_cross"]["bias"].numpy(),
        np.asarray(params["dec_units"][0]["norm_cross"]["bias"][1]))
    np.testing.assert_array_equal(
        tparams["final_norm"]["bias"].numpy(),
        np.asarray(params["final_norm"]["bias"]))
    np.testing.assert_array_equal(
        tparams["enc_final_norm"]["scale"].numpy(),
        np.asarray(params["enc_final_norm"]["scale"]))
    # the port's own init has repro's layout
    own = tapi.init_model(cfg, device="cpu")
    assert set(own) == set(tparams)
    for a, b in zip(jax.tree_util.tree_leaves(tparams),
                    jax.tree_util.tree_leaves(own)):
        assert a.shape == b.shape


def test_layernorm_and_gelu_mlp_match_repro():
    rng = np.random.default_rng(1)
    d, f = 64, 128
    x = (rng.standard_normal((4, 9, d)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(d).astype(np.float32) * 0.1,
         "bias": rng.standard_normal(d).astype(np.float32) * 0.1}
    ref = np.asarray(jcommon.layernorm({k: jnp.asarray(v)
                                        for k, v in p.items()},
                                       jnp.asarray(x)))
    got = common.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x)).numpy()
    assert _rel(got, ref) <= TOL
    init, apply = common.make_norm("layernorm")
    assert apply is common.layernorm
    assert set(init(d, torch.float32, "cpu")) == {"scale", "bias"}
    with pytest.raises(ValueError):
        common.make_norm("batchnorm")
    w = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_up", (d, f)), ("w_down", (f, d)))}
    ref = np.asarray(jmlp.mlp_apply({k: jnp.asarray(v) for k, v in w.items()},
                                    jnp.asarray(x), "gelu"))
    got = mlp.mlp_apply({k: torch.from_numpy(v) for k, v in w.items()},
                        torch.from_numpy(x), "gelu").numpy()
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_cross_attention_matches_repro(variant):
    jcfg, params, cfg, tparams = _models(variant)
    jp = jax.tree.map(lambda a: a[0], params["dec_units"][0]["cross"])
    tp = tparams["dec_layers"][0]["cross"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    before = build.COUNTS["flash_plain"]
    ref = jattn.cross_attn_apply(jp, jnp.asarray(x), jnp.asarray(enc), jcfg)
    got = attention_layer.cross_attn_apply(tp, torch.from_numpy(x),
                                           torch.from_numpy(enc), cfg)
    assert build.COUNTS["flash_plain"] == before + 1   # the flash forward
    assert _rel(got.numpy(), ref) <= TOL
    kv = jattn.cross_attn_kv(jp, jnp.asarray(enc))
    tkv = attention_layer.cross_attn_kv(tp, torch.from_numpy(enc))
    ref = jattn.cross_attn_decode(jp, jnp.asarray(x[:, 0]), kv,
                                  jnp.asarray(ENC_LEN), jcfg)
    got = attention_layer.cross_attn_decode(
        tp, torch.from_numpy(x[:, 0]), tkv, torch.from_numpy(ENC_LEN), cfg)
    assert _rel(got.numpy(), ref) <= TOL
    # the rows past enc_len are masked: changing them changes nothing
    k, v = (t.clone() for t in tkv)
    k[1, :, 9:] = 1e3
    v[1, :, 9:] = -1e3
    again = attention_layer.cross_attn_decode(
        tp, torch.from_numpy(x[:, 0]), (k, v), torch.from_numpy(ENC_LEN),
        cfg)
    assert torch.equal(again, got)


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_forward_matches_repro(variant):
    jcfg, params, cfg, tparams = _models(variant)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, (B, 11)).astype(np.int32)
    fe = _frames(cfg)
    ref = japi.forward(params, {"tokens": jnp.asarray(toks),
                                "frontend_embeds": jnp.asarray(fe)}, jcfg)
    before = build.COUNTS["flash_plain"]
    got = tapi.forward(tparams, {"tokens": torch.from_numpy(toks),
                                 "frontend_embeds": torch.from_numpy(fe)},
                       cfg)
    # the encoder's layers, then each decoder layer's self and cross
    assert (build.COUNTS["flash_plain"]
            == before + cfg.encoder_layers + 2 * cfg.decoder_layers)
    assert got.shape == (B, 11, cfg.vocab_size)
    assert _rel(got.detach().numpy(), ref) <= TOL
    jl = japi.loss_fn(params, {"tokens": jnp.asarray(toks),
                               "frontend_embeds": jnp.asarray(fe)}, jcfg)
    tl = tapi.loss_fn(tparams, {"tokens": torch.from_numpy(toks),
                                "frontend_embeds": torch.from_numpy(fe)},
                      cfg)
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))


def _decode_loop(variant, prompt, n_new, enc_len=ENC_LEN, with_repro=True):
    """Both sides (the port alone without ``with_repro``): encode with
    ``enc_len`` valid frames a row, teacher-force ``prompt`` (B, P), then
    ``n_new`` greedy tokens; every step's logits compared. Returns the
    port's logits by step and the tokens fed."""
    jcfg, params, cfg, tparams = _models(variant)
    fe = _frames(cfg)
    Se = cfg.frontend_tokens
    js = japi.init_decode_state(jcfg, B, MAX_LEN, enc_len=Se)
    ts = tapi.init_decode_state(cfg, B, MAX_LEN, enc_len=Se, device="cpu")
    ts = tapi.encode_for_decode(tparams, ts, torch.from_numpy(fe),
                                torch.from_numpy(enc_len), cfg)
    if with_repro:
        js = japi.encode_for_decode(params, js, jnp.asarray(fe),
                                    jnp.asarray(enc_len), jcfg)
        for (jk, jv), (tk, tv) in zip(zip(*js["cross_kv"]),
                                      ts["cross_kv"]):
            assert _rel(tk.numpy(), jk) <= TOL
            assert _rel(tv.numpy(), jv) <= TOL
    P = prompt.shape[1]
    tok = prompt[:, 0]
    fed, logits = [], []
    before = dict(build.COUNTS)
    for step in range(P + n_new - 1):
        lens = np.full(B, step, np.int32)
        tl, ts = tapi.decode_step(tparams, ts, torch.from_numpy(tok),
                                  torch.from_numpy(lens), cfg)
        fed.append(tok)
        logits.append(tl.numpy())
        greedy = tl.numpy().argmax(-1).astype(np.int32)
        if with_repro:
            jl, js = japi.decode_step(params, js, jnp.asarray(tok),
                                      jnp.asarray(lens), jcfg)
            assert _rel(tl.numpy(), jl) <= TOL, step
            assert np.array_equal(np.asarray(jl).argmax(-1), greedy), step
        tok = prompt[:, step + 1] if step + 1 < P else greedy
    # self-attention on the contiguous decode kernel's plain version, one
    # a step and decoder layer; cross-attention on no kernel
    steps = P + n_new - 1
    assert (build.COUNTS["decode_plain"] - before.get("decode_plain", 0)
            == steps * cfg.decoder_layers)
    assert build.COUNTS["flash_plain"] - before.get("flash_plain", 0) == 0
    return np.stack(logits, 1), np.stack(fed, 1)


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_encode_and_decode_steps_match_repro(variant):
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, 256, (B, 3)).astype(np.int32)
    _decode_loop(variant, prompt, 4)


def test_teacher_forced_decode_matches_forward():
    """Exact variant, float32: the decode loop over a sequence gives
    ``forward``'s logits (ExpMul would differ: forward's cross-attention
    walks KV tiles). All frames valid, as ``forward`` attends to them
    all."""
    _, _, cfg, tparams = _models("exact")
    rng = np.random.default_rng(5)
    seq = rng.integers(1, 256, (B, 7)).astype(np.int32)
    logits, fed = _decode_loop(
        "exact", seq, 1, enc_len=np.full(B, cfg.frontend_tokens, np.int32),
        with_repro=False)
    assert np.array_equal(fed, seq)
    ref = tapi.forward(tparams, {"tokens": torch.from_numpy(seq),
                                 "frontend_embeds": torch.from_numpy(
                                     _frames(cfg))}, cfg)
    assert _rel(logits, ref.detach().numpy()) <= SELF_TOL


def test_refusals_match_repro():
    jcfg, params, cfg, tparams = _models("expmul")
    q8, jq8 = cfg.replace(kv_dtype="int8"), jcfg.replace(kv_dtype="int8")
    with pytest.raises(NotImplementedError):
        japi.init_decode_state(jq8, B, MAX_LEN, enc_len=16)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tapi.init_decode_state(q8, B, MAX_LEN, enc_len=16, device="cpu")
    with pytest.raises(TypeError):
        japi.init_decode_state(jcfg, B, MAX_LEN)
    with pytest.raises(TypeError, match="enc_len"):
        tapi.init_decode_state(cfg, B, MAX_LEN, device="cpu")
    with pytest.raises(NotImplementedError):
        japi.init_paged_state(jcfg, B, 8, 4)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tapi.init_paged_state(cfg, B, 8, 4, device="cpu")
    state = tapi.init_decode_state(cfg, B, MAX_LEN, enc_len=16, device="cpu")
    toks = torch.ones((B, 4), dtype=torch.int32)
    zeros = torch.zeros(B, dtype=torch.int32)
    tables = torch.zeros((B, 2), dtype=torch.int32)
    for jfn, tfn in (
            (lambda: japi.prefill(params, {}, jnp.asarray(toks.numpy()),
                                  jnp.zeros(B, jnp.int32),
                                  jnp.zeros(B, jnp.int32), jcfg),
             lambda: tapi.prefill(tparams, state, toks, zeros, zeros, cfg)),
            (lambda: japi.prefill_paged(
                params, {}, jnp.asarray(toks.numpy()),
                jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32),
                jnp.zeros((B, 2), jnp.int32), jcfg, page_size=4),
             lambda: tapi.prefill_paged(tparams, state, toks, zeros, zeros,
                                        tables, cfg, page_size=4)),
            (lambda: japi.decode_step_paged(
                params, {}, jnp.zeros(B, jnp.int32),
                jnp.zeros(B, jnp.int32), jnp.zeros((B, 2), jnp.int32),
                jcfg, page_size=4),
             lambda: tapi.decode_step_paged(tparams, state, zeros, zeros,
                                            tables, cfg, page_size=4))):
        with pytest.raises(NotImplementedError):
            jfn()
        with pytest.raises(NotImplementedError, match="decoder-only"):
            tfn()
    # the engine: int8 refused by validate_kv_dtype, in repro's words; at
    # fp32 repro's engine cannot build its state on either layout, and
    # the port's refuses the config
    with pytest.raises(ValueError, match="encoder-decoder") as jerr:
        JaxServeEngine(params, jcfg, kv_dtype="int8")
    with pytest.raises(ValueError, match="encoder-decoder") as terr:
        ServeEngine(tparams, cfg, kv_dtype="int8", device="cpu")
    assert str(terr.value) == str(jerr.value)
    for layout in ("contiguous", "paged"):
        with pytest.raises((TypeError, NotImplementedError)):
            JaxServeEngine(params, jcfg, kv_layout=layout, slots=2,
                           max_len=16)
        with pytest.raises(NotImplementedError, match="encode_for_decode"):
            ServeEngine(tparams, cfg, kv_layout=layout, slots=2, max_len=16,
                        device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "2", "--max-new", "2"])
