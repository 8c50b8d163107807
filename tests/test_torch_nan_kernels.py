"""The plain versions of the four serving kernels against ``repro``'s
Pallas kernels (in interpret mode on the CPU, as ``repro``'s own tests run
them) on poisoned KV (``kernels/checks.py:poisoned_case``): NaN values, or
int8 codes of -128 with NaN scales, in the first, a middle or the last
page sequence 0 reads, or in its rows past the length. The reference's
maxima propagate NaN and its value products weigh the rows past the length
0 (0 * NaN = NaN), so the non-finite output rows are the contract: the
port's must be exactly the reference's (``checks.rows_rel_err``), and the
finite rows within 1e-6 (dyadic inputs: every score is exact). The CUDA
kernels are held to these plain versions on the same cases on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode.ops import (  # noqa: E402
    decode_attention_pallas,
    fused_paged_decode_attention_pallas,
    quant_decode_attention_pallas,
    quant_fused_paged_decode_attention_pallas,
)
from repro.kernels.flash.ops import (  # noqa: E402
    fused_paged_prefill_attention_pallas,
    prefill_attention_pallas,
    quant_fused_paged_prefill_attention_pallas,
    quant_prefill_attention_pallas,
)
from repro_torch.kernels.checks import (  # noqa: E402
    POISON_SPOTS,
    SERVING_KERNELS,
    poisoned_case,
    rows_rel_err,
)

SMALL = dict(length=27, chunk=8, D=16, H=4, Hkv=2, page_size=4,
             device="cpu")


def _pallas(kernel, case, variant):
    """``repro``'s Pallas kernel on the case's operands."""
    J = (lambda name: jnp.asarray(case[name].numpy()))
    quant = case["quant"]
    if kernel == "paged_decode":
        kw = dict(page_size=case["page_size"], variant=variant,
                  window=case["window"])
        if quant:
            return quant_fused_paged_decode_attention_pallas(
                J("q"), J("k_pool"), J("v_pool"), J("ks_pool"),
                J("vs_pool"), J("block_tables"), J("lengths"), **kw)
        return fused_paged_decode_attention_pallas(
            J("q"), J("k_pool"), J("v_pool"), J("block_tables"),
            J("lengths"), **kw)
    if kernel == "paged_prefill":
        kw = dict(page_size=case["page_size"], variant=variant,
                  window=case["window"])
        if quant:
            return quant_fused_paged_prefill_attention_pallas(
                J("q"), J("kn"), J("vn"), J("ksn"), J("vsn"), J("k_pool"),
                J("v_pool"), J("ks_pool"), J("vs_pool"), J("block_tables"),
                J("lengths"), J("n_valid"), **kw)
        return fused_paged_prefill_attention_pallas(
            J("q"), J("kn"), J("vn"), J("k_pool"), J("v_pool"),
            J("block_tables"), J("lengths"), J("n_valid"), **kw)
    if kernel == "decode":
        if quant:
            return quant_decode_attention_pallas(
                J("q"), J("k"), J("v"), J("ks"), J("vs"), J("lengths"),
                variant=variant)
        return decode_attention_pallas(J("q"), J("k"), J("v"), J("lengths"),
                                       variant=variant)
    kw = dict(variant=variant, window=case["window"],
              rolling=case["rolling"], block_q=128, block_k=512)
    if quant:
        return quant_prefill_attention_pallas(
            J("q"), J("k"), J("v"), J("ks"), J("vs"), J("kn"), J("vn"),
            J("ksn"), J("vsn"), J("lengths"), J("n_valid"), **kw)
    return prefill_attention_pallas(J("q"), J("k"), J("v"), J("kn"),
                                    J("vn"), J("lengths"), J("n_valid"),
                                    **kw)


@pytest.mark.parametrize("kernel", SERVING_KERNELS)
@pytest.mark.parametrize("spot", POISON_SPOTS)
@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_plain_nonfinite_rows_match_pallas(kernel, spot, kv, variant):
    case, run = poisoned_case(np.random.default_rng(2), kernel, spot, kv=kv,
                              **SMALL)
    got = run(case, variant, plain=True)
    ref = torch.from_numpy(np.array(_pallas(kernel, case, variant)))
    assert not bool(torch.isfinite(ref[0]).all())     # the fault shows
    assert bool(torch.isfinite(ref[1:]).all())        # only in its row
    assert rows_rel_err(got, ref) <= 1e-6
