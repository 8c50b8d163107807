"""Shared set-up of the port's training-parity tests
(``test_torch_train_*.py``): the smoke config of any registered arch in
float32 on both packages from one set of weights (``repro``'s PRNGKey(0)
draw, converted), seeded batches, and the comparisons.

``repro`` runs ``attention_impl="pallas"``: the Pallas flash forward in
interpret mode with the recompute-and-STE backward, the twin of the
port's training path. Blocks of 16 query rows and 32 KV columns over 40
tokens make the forward pad K to 64 columns and the backward take 20-wide
blocks. MLA's V (``v_head_dim``) is narrower than its qk width and the
Pallas kernel takes Dq == Dv only, so an MLA config runs
``"pallas_vpad"``, registered here: the same Pallas call over V
zero-padded to the qk width, the padding's output columns dropped, which
is what the port's ``mla_apply`` does around its flash call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.registry import (
    dispatch_attention,
    register_attention,
)
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.tree import tree_leaves_with_path

SEQ, BATCH = 40, 2


@register_attention("pallas_vpad")
def _pallas_vpad(q, k, v, *, spec, causal, scale):
    pad = k.shape[-1] - v.shape[-1]
    o = dispatch_attention(spec.replace(impl="pallas"), q, k,
                           jnp.pad(v, [(0, 0)] * 3 + [(0, pad)]),
                           causal=causal, scale=scale)
    return o[..., :v.shape[-1]]


def models(arch, variant="expmul", **over):
    """(jcfg, jparams, cfg, params): ``arch``'s smoke config in float32 on
    both packages, ``repro``'s PRNGKey(0) weights and their conversion."""
    over = dict(dtype="float32", param_dtype="float32",
                attention_variant=variant, attention_block_k=32, **over)
    cfg = get_config(arch, smoke=True, **over)
    impl = "pallas_vpad" if cfg.mla else "pallas"
    jcfg = jax_get_config(arch, smoke=True, attention_impl=impl,
                          attention_block_q=16, **over)
    jparams = japi.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg, convert(jparams, cfg)


def convert(jtree, cfg):
    """A ``repro`` parameter tree (or its gradient) in the port's layout,
    on the CPU."""
    return params_from_jax(jax.tree.map(np.asarray, jtree), cfg,
                           device="cpu")


def batches(cfg, seed, *, frontend=None):
    """(repro's batch, the port's) of BATCH x SEQ tokens drawn from
    ``seed``, with ``frontend_embeds`` for a frontend config: N(0, 1) from
    the same draw, or zeros with ``frontend="zeros"``, as the launchers
    give them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    out = {"tokens": toks}
    if cfg.frontend:
        shape = (BATCH, cfg.frontend_tokens, cfg.frontend_dim)
        out["frontend_embeds"] = (np.zeros(shape, np.float32)
                                  if frontend == "zeros" else
                                  rng.standard_normal(shape).astype(
                                      np.float32))
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def leaf_errors(got, want):
    """{path: (max |got - want|, max |want|)} over two port trees."""
    return {path: (float((a.float() - b.float()).abs().max()),
                   float(b.float().abs().max()))
            for (path, a), (_, b) in zip(tree_leaves_with_path(got),
                                         tree_leaves_with_path(want))}


def zero_in_exact_arithmetic(path, cfg) -> bool:
    """A leaf whose gradient is 0 in exact arithmetic, so that both
    packages return rounding alone: the input-gate bias ``b_i`` of an
    mLSTM or sLSTM block. It shifts every input-gate pre-activation of a
    head by one amount, which moves the stabilizer ``m`` by the same
    amount: an mLSTM's weights ``exp(i_s - cum_s - m_t)`` stay as they
    were, and an sLSTM's ``c`` and ``n`` scale together while its
    stabilized ``n`` stays at or above 1, so ``c / max(n, 1)`` does too."""
    kinds = cfg.pattern_for()
    return (len(path) == 4 and path[0] == "layers"
            and kinds[path[1]] in ("mlstm", "slstm")
            and path[2:] == ("mix", "b_i"))


def assert_grads_match(got, want, cfg, rtol=1e-4):
    """Every gradient leaf within ``rtol`` of its own largest magnitude;
    a leaf that is 0 in exact arithmetic within 1e-6 of the largest
    magnitude of any leaf, on both sides. At a quantized ``kv_dtype`` a
    leaf may instead be within 1e-6 of the largest magnitude of any leaf:
    a K or V element whose last bit differs between the packages can
    round to the neighbouring int8 code (one flip among 5,120 codes of
    qwen2-0.5b's second layer at 2 x 80 tokens), which moves the small
    gradients of the layers before it (its biases', 4e-4) by up to 2e-4
    of their size."""
    errs = leaf_errors(got, want)
    top = max(mag for _, mag in errs.values())
    floor = 1e-6 * top if cfg.kv_dtype != "fp32" else 0.0
    for path, (err, mag) in errs.items():
        if zero_in_exact_arithmetic(path, cfg):
            assert mag <= 1e-6 * top and err <= 1e-6 * top, path
        else:
            assert err <= max(rtol * mag, floor), (path, err, mag, top)


def check_loss_and_grads(arch, variant):
    """The port's ``value_and_grad`` against ``jax.value_and_grad`` of
    ``repro``'s ``loss_fn`` (an MoE config at ``scatter``, a frontend
    config with seeded ``frontend_embeds``): the loss within 1e-5 of its
    value, every gradient leaf within 1e-4 of its leaf's magnitude."""
    from repro_torch.train.step import value_and_grad

    jcfg, jparams, cfg, params = models(arch, variant)
    jb, tb = batches(cfg, 0)
    jl, jg = jax.value_and_grad(japi.loss_fn)(jparams, jb, jcfg,
                                              moe_impl="scatter")
    tl, tg = value_and_grad(params, tb, cfg, moe_impl="scatter")
    assert np.isfinite(float(jl))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert_grads_match(tg, convert(jg, cfg), cfg)
