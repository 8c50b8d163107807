"""The port's ``ServeEngine`` on the registry's non-kernel routes, against
``repro``'s engine on the same converted weights (qwen2-0.5b smoke,
float32, ExpMul, the config default):

* at ``repro``'s default ``attention_impl="flash_jnp"`` (the one-pass
  routes: ``gather_xla`` on the paged layout, ``masked_xla`` / ``xla`` on
  the contiguous one), paged fp32, paged int8 and contiguous fp32;
* at ``attention_paged_impl="gather_pallas"`` (the paged history gathered,
  then the contiguous kernels: their plain versions on the CPU; ``repro``
  runs its contiguous Pallas kernels in interpret mode), paged int8 (the
  fp32 route's entries are held against ``repro``'s by
  ``tests/test_torch_registry.py``).

The temp-0 streams must be equal. Each run also checks the labels it
expects on the ``attention_exec_*`` ledger (the route of each tick kind
and its datapath) and that the dispatch counters saw one call a layer a
tick under that label.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.api import init_model as jax_init_model  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

PAGED = dict(slots=3, max_len=40, chunk_size=8, kv_layout="paged",
             page_size=4, prefix_cache=False)
CONTIGUOUS = dict(slots=3, max_len=40, chunk_size=8)


@pytest.fixture(scope="module")
def models():
    over = dict(dtype="float32", param_dtype="float32",
                attention_variant="expmul")
    jcfg = jax_get_config("qwen2-0.5b", smoke=True, **over)
    # jitted: one compilation (the same values as eager calls)
    params = jax.jit(jax_init_model, static_argnums=1)(jax.random.PRNGKey(0),
                                                        jcfg)
    tcfg = get_config("qwen2-0.5b", smoke=True, **over)
    return jcfg, params, tcfg, params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, device="cpu")


def _prompts():
    rng = np.random.default_rng(0)
    return [list(rng.integers(1, 256, size=n)) for n in (13, 5, 19)]


def _serve(engine, prompts, max_new=6):
    reqs = [engine.submit(p, max_new, rid=i) for i, p in enumerate(prompts)]
    engine.run()
    assert all(r.done and r.finish_reason == "length" for r in reqs)
    return [r.out for r in reqs]


CASES = {
    # id: (config fields, engine kwargs, kv_dtype, {tick kind: label},
    #      the kernels' plain versions each run must reach)
    "flash_jnp-paged-fp32": (dict(attention_impl="flash_jnp"), PAGED, "fp32",
                             {"prefill": "gather_xla", "decode": "gather_xla"},
                             set()),
    "flash_jnp-paged-int8": (dict(attention_impl="flash_jnp"), PAGED, "int8",
                             {"prefill": "gather_xla", "decode": "gather_xla"},
                             set()),
    "flash_jnp-contiguous-fp32": (dict(attention_impl="flash_jnp"),
                                  CONTIGUOUS, "fp32",
                                  {"prefill": "masked_xla", "decode": "xla"},
                                  set()),
    "gather_pallas-paged-int8": (dict(attention_paged_impl="gather_pallas"),
                                 PAGED, "int8",
                                 {"prefill": "gather_pallas",
                                  "decode": "gather_pallas"},
                                 {"prefill_plain", "decode_plain"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_streams_match_repro_on_route(models, case):
    jcfg, params, tcfg, tparams = models
    fields, kw, kv_dtype, labels, plain = CASES[case]
    prompts = _prompts()
    # repro's config defaults to "flash_jnp"; the port's to "kernel"
    ref = _serve(JaxServeEngine(params, jcfg.replace(**fields),
                                kv_dtype=kv_dtype, **kw), prompts)
    build.reset_counts()
    eng = ServeEngine(tparams, tcfg.replace(**fields), kv_dtype=kv_dtype,
                      device="cpu", **kw)
    assert _serve(eng, prompts) == ref
    assert eng.prefill_steps > 0 and eng.decode_steps > 0
    assert {k for k, v in build.COUNTS.items() if v} == plain
    led = eng.attention_ledger()
    for kind, impl in labels.items():
        assert led[kind]["impl"] == impl
        assert led[kind]["path"] == "gather"
        assert led[kind]["steps"] == getattr(eng, f"{kind}_steps")
    counters = eng.metrics.snapshot()["counters"]
    dispatched = {k: v for k, v in counters.items()
                  if k.startswith("attention_dispatch_total")}
    assert sum(dispatched.values()) == eng.ticks * tcfg.num_layers
    assert all(f'impl="{labels["decode"]}"' in k or
               f'impl="{labels["prefill"]}"' in k for k in dispatched)
