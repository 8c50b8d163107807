"""Shared set-up of the port's fault-tolerance tests
(``test_torch_fault_serving.py``, ``test_torch_chaos.py``,
``test_torch_snapshot.py``): the smoke qwen2-0.5b in float32 on both
engines from one set of weights, a chaos schedule installed in both, and
what a run leaves behind, for comparing the two engines.

``repro``'s engine runs at ``attention_impl="pallas"`` (the Pallas kernels
in interpret mode), whose tiles the port's plain versions walk, so temp-0
ExpMul streams are equal, not only close.
"""
import dataclasses

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models.api import init_model as jax_init_model
from repro.serve import faults as jax_faults
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.api import init_model
from repro_torch.serve import faults
from repro_torch.serve.engine import ServeEngine


@dataclasses.dataclass
class Models:
    jcfg: object
    jparams: object
    cfg: object
    params: dict


def models(variant="expmul") -> Models:
    over = dict(dtype="float32", param_dtype="float32",
                attention_variant=variant)
    jcfg = jax_get_config("qwen2-0.5b", smoke=True, **over)
    jparams = jax_init_model(jax.random.PRNGKey(0), jcfg)
    cfg = get_config("qwen2-0.5b", smoke=True, **over)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return Models(jcfg, jparams, cfg, params)


def torch_models():
    """(params, cfg) of the port alone, from its own seed-0 init."""
    import torch
    cfg = get_config("qwen2-0.5b", smoke=True, dtype="float32",
                     param_dtype="float32")
    return init_model(cfg, torch.Generator().manual_seed(0),
                      device="cpu"), cfg


def engine(m: Models, jax_side=False, **kw):
    if jax_side:
        return JaxServeEngine(m.jparams, m.jcfg, attention_impl="pallas",
                              **kw)
    return ServeEngine(m.params, m.cfg, device="cpu", **kw)


def install(injector_kw, jax_side=False):
    """Install a ``ChaosInjector`` built from ``injector_kw`` (None
    uninstalls) in the engine's own fault module; returns it."""
    mod = jax_faults if jax_side else faults
    inj = None if injector_kw is None else mod.ChaosInjector(**injector_kw)
    mod.install_fault_injector(inj)
    return inj


def uninstall():
    faults.install_fault_injector(None)
    jax_faults.install_fault_injector(None)


def outcome(eng, reqs, inj=None) -> dict:
    """What a run leaves behind: each request's (rid, finish reason,
    tokens), the terminal-state counts, the pool's dump and the injector's
    fires and opportunities."""
    snap = eng.metrics_snapshot()
    return {
        "requests": [(r.rid, r.finish_reason, [int(t) for t in r.out])
                     for r in reqs],
        "finish_reasons": snap["finish_reasons"],
        "quarantined": snap["quarantined"],
        "preemptions": eng.preemptions,
        "ticks": eng.ticks,
        "pool": eng.pool.dump_state() if eng.paged else None,
        "chaos": None if inj is None else {
            p: (inj.fired(p), inj.opportunities(p)) for p in inj.POINTS},
    }
