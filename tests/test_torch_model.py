"""Port model parity: ``repro_torch`` prefill and decode ticks against
``repro`` (its fused Pallas kernels in interpret mode) on the same
converted weights, at smoke size in float32, over paged pools and
per-slot (contiguous) caches (windows: ``tests/test_torch_windows.py``).

Both sides walk the same KV tiles in the same order, so each tick's
logits are held at a limit set from that same-walk gap (about 5e-7 of the
logits' magnitude measured in every cell), not at the ``tests/cells.py``
tolerances, which bound a variant against the exact float32 reference:
running the other variant on the port's side moves the logits by over
0.1 of their magnitude, which both limits catch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402

PS, NBLK, MB = 4, 14, 6
# port vs repro, relative to max |logits|: float32 pools, and int8 pools,
# where a projection that rounds differently can move a code by one step
SAME_WALK_TOL = {"fp32": 1e-4, "int8": 1e-3}


def _models(variant, kv_dtype, window=None, arch="qwen2-0.5b"):
    """Both sides' configs and weights; ``window`` None keeps the arch's."""
    over = dict(dtype="float32", param_dtype="float32",
                attention_variant=variant, kv_dtype=kv_dtype)
    if window is not None:
        over["window"] = window
    jcfg = jax_get_config(arch, smoke=True, attention_impl="pallas", **over)
    params = japi.init_model(jax.random.PRNGKey(0), jcfg)
    tcfg = get_config(arch, smoke=True, attention_impl="kernel", **over)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return jcfg, params, tcfg, tparams


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref))
                 / np.max(np.abs(ref)))


def layer_caches(jstate, tstate, tcfg):
    """(kind, repro's cache of the layer, the port's) for every layer in
    layer order: ``repro`` stacks unit position ``pos`` over the units, so
    layer ``u * len(unit) + pos`` is ``caches[pos]`` at ``u``."""
    unit = tcfg.block_pattern
    for layer, (kind, tc) in enumerate(zip(tcfg.pattern_for(),
                                           tstate["caches"])):
        u, pos = divmod(layer, len(unit))
        yield kind, {k: np.asarray(v[u])
                     for k, v in jstate["caches"][pos].items()}, tc


def hold_caches(jstate, tstate, tcfg, kv_dtype):
    """The KV caches hold what repro wrote (int8 codes may differ by one
    step where a projection rounds differently, so dequantized rows are
    compared), and an RG-LRU layer's state (``h``, ``conv``) its state
    within 1e-5 of its magnitude (XLA's exp, logistic and tanh differ from
    PyTorch's in the last bit, and so do the inputs of every later layer)."""
    for kind, jc, tc in layer_caches(jstate, tstate, tcfg):
        if kind == "rglru":
            for name in ("h", "conv"):
                assert _rel(tc[name].numpy(), jc[name]) <= 1e-5, name
            continue
        k = jc["k"].astype(np.float32)
        tk = tc["k"].to(torch.float32).numpy()
        if kv_dtype != "fp32":
            k = k * jc["k_scale"][..., None]
            tk = tk * tc["k_scale"].numpy()[..., None]
        assert tk.shape == k.shape
        np.testing.assert_allclose(tk, k, atol=5e-2 if kv_dtype != "fp32"
                                   else 1e-5)


def test_convert_keeps_layouts_and_values():
    _, params, tcfg, tparams = _models("exact", "fp32")
    assert len(tparams["layers"]) == tcfg.num_layers
    mix = tparams["layers"][1]["mix"]
    hd = tcfg.resolved_head_dim()
    assert tuple(mix["wq"].shape) == (tcfg.d_model, tcfg.num_heads, hd)
    assert tuple(mix["wo"].shape) == (tcfg.num_heads, hd, tcfg.d_model)
    np.testing.assert_array_equal(
        mix["wk"].numpy(), np.asarray(params["units"][0]["mix"]["wk"][1]))
    np.testing.assert_array_equal(
        tparams["layers"][0]["ffn"]["w_gate"].numpy(),
        np.asarray(params["units"][0]["ffn"]["w_gate"][0]))


def paged_ticks(variant, kv_dtype, arch="qwen2-0.5b"):
    """Two prefill chunks (the second starts mid-page), then two decodes,
    over shuffled block tables on both sides; every tick's logits are
    compared on the active rows, then the pools."""
    jcfg, params, tcfg, tparams = _models(variant, kv_dtype, arch=arch)
    rng = np.random.default_rng(0)
    B = 3
    # shuffled tables; row 1 is an idle slot (all sentinel)
    perm = list(rng.permutation(NBLK))
    bt = np.full((B, MB), NBLK, np.int32)
    for b, n in ((0, 4), (2, 3)):
        for i in range(n):
            bt[b, i] = perm.pop()
    jstate = japi.init_paged_state(jcfg, B, NBLK, PS)
    tstate = tapi.init_paged_state(tcfg, B, NBLK, PS, device="cpu")
    tol = SAME_WALK_TOL[kv_dtype]
    lens = np.zeros(B, np.int32)
    C = 5
    before = dict(build.COUNTS)
    # two prefill chunks (the second starts mid-page), then two decodes
    for nv in ([5, 0, 3], [4, 0, 2]):
        toks = rng.integers(1, tcfg.vocab_size, (B, C)).astype(np.int32)
        nv = np.asarray(nv, np.int32)
        jl, jstate = japi.prefill_paged(
            params, jstate, jnp.asarray(toks), jnp.asarray(lens),
            jnp.asarray(nv), jnp.asarray(bt), jcfg, page_size=PS)
        tl, tstate = tapi.prefill_paged(
            tparams, tstate, torch.from_numpy(toks), torch.from_numpy(lens),
            torch.from_numpy(nv), torch.from_numpy(bt), tcfg, page_size=PS)
        assert tl.shape == (B, tcfg.vocab_size)
        assert _rel(tl.numpy(), jl) <= tol
        lens = lens + nv
    for _ in range(2):
        tok = rng.integers(1, tcfg.vocab_size, (B,)).astype(np.int32)
        jl, jstate = japi.decode_step_paged(
            params, jstate, jnp.asarray(tok), jnp.asarray(lens),
            jnp.asarray(bt), jcfg, page_size=PS)
        tl, tstate = tapi.decode_step_paged(
            tparams, tstate, torch.from_numpy(tok), torch.from_numpy(lens),
            torch.from_numpy(bt), tcfg, page_size=PS)
        assert _rel(tl.numpy()[[0, 2]], np.asarray(jl)[[0, 2]]) <= tol
        lens = lens + np.array([1, 0, 1], np.int32)
    hold_caches(jstate, tstate, tcfg, kv_dtype)
    # on the CPU the kernels' plain versions ran, never a launch
    assert build.COUNTS["paged_prefill"] == before.get("paged_prefill", 0)
    assert build.COUNTS["paged_decode"] == before.get("paged_decode", 0)
    n_attn = tcfg.pattern_for().count("attn")
    assert (build.COUNTS["paged_prefill_plain"]
            == before.get("paged_prefill_plain", 0) + 2 * n_attn)


@pytest.mark.parametrize("variant,kv_dtype", [
    ("exact", "fp32"), ("exact", "int8"), ("expmul", "fp32"),
    ("expmul", "int8")])
def test_prefill_and_decode_ticks_match_repro(variant, kv_dtype):
    paged_ticks(variant, kv_dtype)


def contiguous_ticks(variant, kv_dtype, window, max_len, chunks,
                     arch="qwen2-0.5b"):
    """Prefill ``chunks`` (n_valid per row, C = 5), then two decodes, on
    both sides; every tick's logits are compared on the active rows."""
    jcfg, params, tcfg, tparams = _models(variant, kv_dtype, window, arch)
    rng = np.random.default_rng(1)
    B, C = 3, 5
    jstate = japi.init_decode_state(jcfg, B, max_len)
    tstate = tapi.init_decode_state(tcfg, B, max_len, device="cpu")
    tol = SAME_WALK_TOL[kv_dtype]
    lens = np.zeros(B, np.int32)
    before = dict(build.COUNTS)
    for nv in chunks:
        toks = rng.integers(1, tcfg.vocab_size, (B, C)).astype(np.int32)
        nv = np.asarray(nv, np.int32)
        jl, jstate = japi.prefill(params, jstate, jnp.asarray(toks),
                                  jnp.asarray(lens), jnp.asarray(nv), jcfg)
        tl, tstate = tapi.prefill(tparams, tstate, torch.from_numpy(toks),
                                  torch.from_numpy(lens),
                                  torch.from_numpy(nv), tcfg)
        rows = nv > 0
        assert _rel(tl.numpy()[rows], np.asarray(jl)[rows]) <= tol
        lens = lens + nv
    live = lens > 0
    for _ in range(2):
        tok = rng.integers(1, tcfg.vocab_size, (B,)).astype(np.int32)
        jl, jstate = japi.decode_step(params, jstate, jnp.asarray(tok),
                                      jnp.asarray(lens), jcfg)
        tl, tstate = tapi.decode_step(tparams, tstate, torch.from_numpy(tok),
                                      torch.from_numpy(lens), tcfg)
        assert _rel(tl.numpy()[live], np.asarray(jl)[live]) <= tol
        lens = lens + 1
    # the caches hold what repro wrote, slot for slot
    hold_caches(jstate, tstate, tcfg, kv_dtype)
    # on the CPU the kernels' plain versions ran, never a launch
    assert build.COUNTS["prefill"] == before.get("prefill", 0)
    assert build.COUNTS["decode"] == before.get("decode", 0)
    n_attn = tcfg.pattern_for().count("attn")
    assert (build.COUNTS["prefill_plain"]
            == before.get("prefill_plain", 0) + len(chunks) * n_attn)
    assert (build.COUNTS["decode_plain"]
            == before.get("decode_plain", 0) + 2 * n_attn)


@pytest.mark.parametrize("variant,kv_dtype", [
    ("exact", "fp32"), ("exact", "int8"), ("expmul", "fp32"),
    ("expmul", "int8")])
def test_contiguous_ticks_match_repro(variant, kv_dtype):
    # two prefill chunks (row 1 idle, rows 0 and 2 ragged), then decodes
    contiguous_ticks(variant, kv_dtype, None, 24, ([5, 0, 3], [4, 0, 2]))


def test_convert_bfloat16_keeps_bits():
    jcfg = jax_get_config("qwen2-0.5b", smoke=True)           # bf16 params
    params = japi.init_model(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, params),
                              get_config("qwen2-0.5b", smoke=True),
                              device="cpu")
    wq = tparams["layers"][0]["mix"]["wq"]
    assert wq.dtype == torch.bfloat16
    ref = np.asarray(params["units"][0]["mix"]["wq"][0])
    np.testing.assert_array_equal(wq.view(torch.int16).numpy(),
                                  ref.view(np.int16))


def test_entry_points_default_to_cuda():
    cfg = get_config("qwen2-0.5b", smoke=True)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.init_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.init_paged_state(cfg, 2, 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.init_decode_state(cfg, 2, 16)


def test_init_model_is_seeded_and_shaped():
    cfg = get_config("qwen2-0.5b", smoke=True, param_dtype="float32")
    a = tapi.init_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tapi.init_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    n = sum(t.numel() for t in [a["embed"]["table"], a["final_norm"]["scale"]]
            + [t for layer in a["layers"] for g in layer.values()
               for t in g.values()])
    assert n == cfg.param_count()
    torch.testing.assert_close(a["layers"][1]["mix"]["wq"],
                               b["layers"][1]["mix"]["wq"], rtol=0, atol=0)
    std = a["layers"][0]["ffn"]["w_up"].std().item()
    assert abs(std - 0.88 / cfg.d_model ** 0.5) < 0.02   # trunc-normal(2)
