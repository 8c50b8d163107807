"""The quantized-KV entries of the backend registry (the ``<name>_q``
entries of ``repro/kernels/kvquant.py``, DESIGN.md §8).

``AttentionSpec.kv_dtype`` "int8" or "fp8" resolves every table to its
``_q`` entry. Their cache-side K/V operands are ``numerics.quant.QuantKV``
(codes plus one float32 scale a row):

* full sequence (``ref_q``, ``flash_jnp_q``, ``kernel_q``, ``plain_q``,
  ``pallas_q``): K and V are fresh activations, fake-quantized with the
  cache's codec (``fake_quant_kv``) and attended at full precision by the
  float entry, so a forward equals a round trip through a quantized
  cache;
* ``masked_xla_q``, ``xla_q``, ``gather_xla_q`` and ``gather_pallas_q``:
  the float entries themselves, which dequantize a ``QuantKV`` operand to
  float32 (``numerics.quant.kv_values``; the paged history gathered into
  logical order by ``kernels.paged.gather_history``), then run the
  one-pass math or the contiguous kernel (``gather_pallas_q`` decode with
  a window: ``gather_xla_q``);
* ``kernel_q`` / ``plain_q`` / ``pallas_q``: the quantized wrappers, which
  dequantize in the tile. The paged ones read the block tables in the
  kernel; called with ``rows`` only, the prefill takes the
  ``gather_pallas_q`` form and the decode the ``gather_xla_q`` form, as
  the reference's do.
"""
from __future__ import annotations

from repro_torch.core.attention import (
    _decode_xla,
    _paged_decode_gather_pallas,
    _paged_decode_gather_xla,
    _paged_prefill_gather_pallas,
    _paged_prefill_gather_xla,
    _prefill_masked_xla,
    chunk_operands,
)
from repro_torch.kernels.decode.ops import (
    quant_decode_attention,
    quant_fused_paged_decode_attention,
)
from repro_torch.kernels.flash.ops import (
    quant_fused_paged_prefill_attention,
    quant_prefill_attention,
)
from repro_torch.kernels.registry import (
    dispatch_attention,
    register_attention,
    register_decode,
    register_kernel_family,
    register_paged_decode,
    register_paged_prefill,
    register_prefill,
)
from repro_torch.numerics.quant import fake_quant_kv


# ---------------------------------------------------------------------------
# full sequence: fake quantization, then the float entry
# ---------------------------------------------------------------------------
def _register_full_q(base, fallback_of=None):
    @register_attention(base + "_q", fallback_of=fallback_of)
    def _full_q(q, k, v, *, spec, causal, scale):
        k = fake_quant_kv(k, spec.kv_dtype)
        v = fake_quant_kv(v, spec.kv_dtype)
        return dispatch_attention(spec.replace(kv_dtype="fp32"), q, k, v,
                                  causal=causal, scale=scale)
    return _full_q


for _base in ("ref", "flash_jnp", "kernel", "plain"):
    _register_full_q(_base)
_register_full_q("pallas", fallback_of="kernel_q")


# ---------------------------------------------------------------------------
# contiguous prefill and decode
# ---------------------------------------------------------------------------
# the XLA routes dequantize their operands themselves
# (``numerics.quant.kv_values``)
register_prefill("masked_xla_q")(_prefill_masked_xla)


def _prefill_q_entry(plain):
    def entry(q, k_cache, v_cache, k_chunk, v_chunk, *, spec, scale,
              lengths, n_valid, rolling):
        return quant_prefill_attention(
            q, k_cache.codes, v_cache.codes, k_cache.scale, v_cache.scale,
            k_chunk.codes, v_chunk.codes, k_chunk.scale, v_chunk.scale,
            lengths, n_valid, scale=scale, variant=spec.variant,
            window=spec.window, rolling=rolling, plain=plain,
            block_q=spec.block_q, block_k=spec.block_k)
    return entry


register_kernel_family(register_prefill, _prefill_q_entry, "_q")


register_decode("xla_q")(_decode_xla)


def _decode_q_entry(plain):
    def entry(q, k_cache, v_cache, lengths, *, spec, scale):
        return quant_decode_attention(
            q, k_cache.codes, v_cache.codes, k_cache.scale, v_cache.scale,
            lengths, scale=scale, variant=spec.variant, plain=plain,
            block_k=spec.decode_block_k)
    return entry


register_kernel_family(register_decode, _decode_q_entry, "_q")


# ---------------------------------------------------------------------------
# paged prefill and decode
# ---------------------------------------------------------------------------
# the gather routes dequantize the gathered copy and the chunk themselves
# (``kernels.paged.gather_history``)
register_paged_prefill("gather_xla_q")(_paged_prefill_gather_xla)
register_paged_prefill("gather_pallas_q")(_paged_prefill_gather_pallas)


def _paged_prefill_q_entry(plain):
    def entry(q, k_chunk, v_chunk, k_pool, v_pool, rows, *, spec, scale,
              q_positions=None, chunk_valid=None, lengths, n_valid=None,
              block_tables=None, page_size=0):
        if block_tables is None:
            return _paged_prefill_gather_pallas(
                q, k_chunk, v_chunk, k_pool, v_pool, rows, spec=spec,
                scale=scale, q_positions=q_positions,
                chunk_valid=chunk_valid, lengths=lengths, n_valid=n_valid,
                plain=plain)
        _, _, n_valid = chunk_operands(q, lengths, q_positions, chunk_valid,
                                       n_valid)
        return quant_fused_paged_prefill_attention(
            q, k_chunk.codes, v_chunk.codes, k_chunk.scale, v_chunk.scale,
            k_pool.codes, v_pool.codes, k_pool.scale, v_pool.scale,
            block_tables, lengths, n_valid, page_size=page_size, scale=scale,
            variant=spec.variant, window=spec.window, plain=plain,
            block_q=spec.block_q)
    return entry


register_kernel_family(register_paged_prefill, _paged_prefill_q_entry,
                       "_q")


register_paged_decode("gather_xla_q")(_paged_decode_gather_xla)
register_paged_decode("gather_pallas_q")(_paged_decode_gather_pallas)


def _paged_decode_q_entry(plain):
    def entry(q, k_pool, v_pool, rows, lengths, *, spec, scale,
              block_tables=None, page_size=0):
        if block_tables is None:
            return _paged_decode_gather_xla(q, k_pool, v_pool, rows,
                                            lengths, spec=spec, scale=scale)
        return quant_fused_paged_decode_attention(
            q, k_pool.codes, v_pool.codes, k_pool.scale, v_pool.scale,
            block_tables, lengths, page_size=page_size, scale=scale,
            variant=spec.variant, window=spec.window, plain=plain)
    return entry


register_kernel_family(register_paged_decode, _paged_decode_q_entry, "_q")
