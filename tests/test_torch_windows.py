"""Local windows in the port, against ``repro``, on both layouts.

A window of 4 tokens over prompts of 9-14 (smoke size, float32, the same
converted weights): on the contiguous layout each layer keeps a rolling
buffer of ``min(max_len, window)`` slots that wraps several times, and
chunked prefill reads it with the rolling mask before overwriting slots
its own earlier queries still read; on the paged layout positions stay
absolute and the kernels mask by the window. Per-tick logits are held at
the same-walk limits of ``tests/test_torch_model.py``, and temp-0 engine
streams must equal ``repro``'s engine with ``attention_impl="pallas"``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import api as japi  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from test_torch_model import (  # noqa: E402
    MB,
    NBLK,
    PS,
    SAME_WALK_TOL,
    _models,
    _rel,
    contiguous_ticks,
)

WINDOW = 4


@pytest.mark.parametrize("variant,kv_dtype", [("exact", "fp32"),
                                              ("expmul", "int8")])
def test_windowed_contiguous_ticks_match_repro(variant, kv_dtype):
    """A window of 4 over prompts of 9-14 tokens: the 4-slot rolling
    buffer wraps, chunks of 5 are longer than its span, and a row's first
    chunk (3 tokens) is shorter than it."""
    contiguous_ticks(variant, kv_dtype, WINDOW, 24, ([5, 3, 5], [5, 0, 4],
                                                 [4, 5, 0]))


@pytest.mark.parametrize("variant,kv_dtype", [("exact", "fp32"),
                                              ("expmul", "int8")])
def test_windowed_paged_ticks_match_repro(variant, kv_dtype):
    """The same window on the paged layout: absolute positions, masked."""
    jcfg, params, tcfg, tparams = _models(variant, kv_dtype, window=WINDOW)
    rng = np.random.default_rng(2)
    B, C = 2, 5
    bt = rng.permutation(NBLK)[:B * MB].astype(np.int32).reshape(B, MB)
    jstate = japi.init_paged_state(jcfg, B, NBLK, PS)
    tstate = tapi.init_paged_state(tcfg, B, NBLK, PS, device="cpu")
    lens = np.zeros(B, np.int32)
    for step in range(4):
        if step < 3:
            toks = rng.integers(1, tcfg.vocab_size, (B, C)).astype(np.int32)
            nv = np.array([5, 4], np.int32)
            args = [(jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(nv)),
                    (torch.from_numpy(toks), torch.from_numpy(lens),
                     torch.from_numpy(nv))]
            jl, jstate = japi.prefill_paged(params, jstate, *args[0],
                                            jnp.asarray(bt), jcfg,
                                            page_size=PS)
            tl, tstate = tapi.prefill_paged(tparams, tstate, *args[1],
                                            torch.from_numpy(bt), tcfg,
                                            page_size=PS)
            lens = lens + nv
        else:
            tok = rng.integers(1, tcfg.vocab_size, (B,)).astype(np.int32)
            jl, jstate = japi.decode_step_paged(
                params, jstate, jnp.asarray(tok), jnp.asarray(lens),
                jnp.asarray(bt), jcfg, page_size=PS)
            tl, tstate = tapi.decode_step_paged(
                tparams, tstate, torch.from_numpy(tok),
                torch.from_numpy(lens), torch.from_numpy(bt), tcfg,
                page_size=PS)
        assert _rel(tl.numpy(), jl) <= SAME_WALK_TOL[kv_dtype]


@pytest.mark.parametrize("kv_layout", ["contiguous", "paged"])
def test_windowed_temp0_streams_match_repro_engine(kv_layout):
    jcfg, params, tcfg, tparams = _models("expmul", "int8", window=WINDOW)
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(1, 256, size=n)) for n in (13, 5, 11)]
    kw = dict(slots=2, max_len=32, chunk_size=4, kv_layout=kv_layout,
              kv_dtype="int8")
    if kv_layout == "paged":
        kw["page_size"] = 4
    jeng = JaxServeEngine(params, jcfg, attention_impl="pallas",
                          prefix_cache=False, **kw)
    jreqs = [jeng.submit(p, 6, rid=i) for i, p in enumerate(prompts)]
    jeng.run()
    eng = ServeEngine(tparams, tcfg, device="cpu", **kw)
    reqs = [eng.submit(p, 6, rid=i) for i, p in enumerate(prompts)]
    eng.run()
    assert all(r.finish_reason == "length" for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    if kv_layout == "contiguous":
        assert eng.state["caches"][0]["k"].shape[2] == WINDOW
