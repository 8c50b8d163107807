"""Port parity of the full-sequence path at a quantized ``kv_dtype``:
``forward`` and the loss's gradients at int8 and fp8 KV against
``repro``'s, whose ``*_q`` attention impls fake-quantize fresh K (after
RoPE) and V with the cache's codec and attend at full precision
(``repro/kernels/kvquant.py:_full_q``), and whose MLA fake-quantizes its
latents before the expansion. The port does the same
(``layers/attention_layer.py:attn_apply``, ``layers/mla.py:mla_apply``,
``numerics/quant.py:fake_quant_kv``), so the logits are held within 1e-5
of their magnitude, and the loss and every gradient leaf at
``tests/torch_training.py``'s bounds; a gradient flows through the row
scales' ``amax`` (and through the e4m3 cast of fp8 codes), as
``jax.grad``'s does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import api as japi  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from torch_training import (  # noqa: E402
    assert_grads_match,
    batches,
    convert,
    models,
)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "minicpm3-4b"])
def test_quantized_kv_forward_and_grads_match_repro(arch, kv_dtype):
    jcfg, jparams, cfg, params = models(arch, kv_dtype=kv_dtype)
    jb, tb = batches(cfg, 1)
    want = np.asarray(japi.forward(jparams, jb, jcfg))
    with torch.no_grad():
        got = tapi.forward(params, tb, cfg).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the codec changes the logits: the quantized run is not the fp32 one
    fcfg = cfg.replace(kv_dtype="fp32")
    with torch.no_grad():
        assert not np.array_equal(tapi.forward(params, tb, fcfg).numpy(), got)
    jl, jg = jax.value_and_grad(japi.loss_fn)(jparams, jb, jcfg)
    tl, tg = value_and_grad(params, tb, cfg)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert_grads_match(tg, convert(jg, cfg), cfg)
